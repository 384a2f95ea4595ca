"""models/layers.py: the functional dense / conv layers and the parameter
scope the models are built on (the goldens in test_parity.py hold the
outputs of the Flax modules these layers replaced)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deepfluids_tpu.models.layers import Module, Scope, conv, dense


def _np_conv_same(x, k, stride=1):
    """Direct SAME-padded NHWC/HWIO conv (cross-correlation) in numpy."""
    kh, kw = k.shape[:2]
    b, h, w, _ = x.shape
    oh, ow = -(-h // stride), -(-w // stride)
    ph = max((oh - 1) * stride + kh - h, 0)
    pw = max((ow - 1) * stride + kw - w, 0)
    xp = np.pad(x, ((0, 0), (ph // 2, ph - ph // 2), (pw // 2, pw - pw // 2),
                    (0, 0)))
    out = np.zeros((b, oh, ow, k.shape[-1]))
    for i in range(oh):
        for j in range(ow):
            patch = xp[:, i * stride:i * stride + kh, j * stride:j * stride + kw]
            out[:, i, j] = np.einsum("bhwc,hwco->bo", patch, k)
    return out


class TestLayers:
    @pytest.mark.parametrize("stride", [1, 2])
    def test_conv_matches_direct_sum(self, stride):
        x = np.random.default_rng(0).normal(size=(2, 7, 6, 3))
        params = {}
        y = conv(Scope(params, jax.random.key(0)), jnp.asarray(x, jnp.float32),
                 4, (3, 3), jnp.float32, strides=(stride, stride))
        k = np.asarray(params["kernel"], np.float64)
        assert params["kernel"].shape == (3, 3, 3, 4)
        assert params["bias"].shape == (4,)
        np.testing.assert_allclose(np.asarray(y), _np_conv_same(x, k, stride),
                                   atol=1e-5)

    def test_dense_and_init_statistics(self):
        params = {}
        x = jnp.ones((5, 256))
        y = dense(Scope(params, jax.random.key(1)), x, 512, jnp.float32)
        k = np.asarray(params["kernel"])
        assert k.shape == (256, 512) and y.shape == (5, 512)
        np.testing.assert_array_equal(np.asarray(params["bias"]), 0.0)
        # Flax's default kernel init: LeCun normal, variance 1 / fan_in.
        assert abs(k.std() * np.sqrt(256) - 1.0) < 0.05
        np.testing.assert_allclose(np.asarray(y), np.ones((5, 256)) @ k,
                                   rtol=1e-5, atol=1e-5)

    def test_compute_dtype_casts_inputs_and_params(self):
        params = {}
        s = Scope(params, jax.random.key(2))
        y = conv(s, jnp.ones((1, 4, 4, 2)), 3, (3, 3), jnp.bfloat16)
        assert y.dtype == jnp.bfloat16
        assert params["kernel"].dtype == jnp.float32   # params stay f32

    def test_apply_reads_and_never_creates(self):
        class Two(Module):
            def __call__(self, s, x):
                h = dense(s.child("a"), x, 3, jnp.float32)
                return dense(s.child("b"), h, 2, jnp.float32)

        m = Two()
        v = m.init(jax.random.key(3), jnp.ones((1, 4)))
        assert list(v["params"]) == ["a", "b"]        # call order
        out = m.apply(v, jnp.ones((1, 4)))
        assert out.shape == (1, 2)
        with pytest.raises(KeyError):
            m.apply({"params": {"a": v["params"]["a"]}}, jnp.ones((1, 4)))

    def test_init_keys_depend_on_names_not_order(self):
        p1, p2 = {}, {}
        s1, s2 = Scope(p1, jax.random.key(4)), Scope(p2, jax.random.key(4))
        dense(s1.child("x"), jnp.ones((1, 3)), 2, jnp.float32)
        dense(s2.child("y"), jnp.ones((1, 3)), 2, jnp.float32)
        dense(s2.child("x"), jnp.ones((1, 3)), 2, jnp.float32)
        np.testing.assert_array_equal(np.asarray(p1["x"]["kernel"]),
                                      np.asarray(p2["x"]["kernel"]))
