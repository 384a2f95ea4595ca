"""Model family tests: shapes, stage structure, divergence-free wiring,
latent layout, scan rollout determinism (SURVEY.md §4 test plan)."""

import jax
import jax.numpy as jnp
import numpy as np

from deepfluids_tpu import ops
from deepfluids_tpu.models import (
    Autoencoder,
    Encoder,
    GeneratorBE,
    LatentIntegrator,
    default_repeat,
    rollout,
)
from deepfluids_tpu.models.generator import upscale_nearest


class TestUpscale:
    def test_nearest_2d(self):
        x = jnp.arange(4.0).reshape(1, 2, 2, 1)
        y = np.asarray(upscale_nearest(x))
        assert y.shape == (1, 4, 4, 1)
        np.testing.assert_allclose(y[0, :2, :2, 0], x[0, 0, 0, 0])
        np.testing.assert_allclose(y[0, 2:, 2:, 0], x[0, 1, 1, 0])

    def test_nearest_3d(self):
        x = jnp.arange(8.0).reshape(1, 2, 2, 2, 1)
        y = upscale_nearest(x)
        assert y.shape == (1, 4, 4, 4, 1)


class TestGenerator2D:
    def test_repeat_derivation(self):
        assert default_repeat((128, 96, 1)) == 5
        assert default_repeat((32, 64, 112, 3)) == 4

    def test_output_shape_and_divfree(self):
        model = GeneratorBE(output_shape=(64, 48, 1), filters=16, num_conv=2)
        z = jnp.ones((2, 3))
        params = model.init(jax.random.key(0), z)
        psi = model.apply(params, z)
        assert psi.shape == (2, 64, 48, 1)
        u = ops.curl2d(psi)
        div = np.asarray(ops.divergence2d(u))[:, :-2, :-2]
        np.testing.assert_allclose(div, 0.0, atol=1e-4)

    def test_batch_independence(self):
        model = GeneratorBE(output_shape=(32, 32, 1), filters=8, num_conv=1)
        z = jax.random.normal(jax.random.key(1), (4, 3))
        params = model.init(jax.random.key(0), z)
        full = model.apply(params, z)
        one = model.apply(params, z[:1])
        np.testing.assert_allclose(
            np.asarray(full[:1]), np.asarray(one), atol=1e-5
        )


class TestGenerator3D:
    def test_output_shape(self):
        model = GeneratorBE(output_shape=(16, 16, 16, 3), filters=8,
                            num_conv=1)
        z = jnp.ones((1, 4))
        params = model.init(jax.random.key(0), z)
        psi = model.apply(params, z)
        assert psi.shape == (1, 16, 16, 16, 3)
        u = ops.curl3d(psi)
        div = np.asarray(ops.divergence3d(u))[:, :-2, :-2, :-2]
        np.testing.assert_allclose(div, 0.0, atol=1e-4)


class TestAutoencoder:
    def test_roundtrip_shapes(self):
        model = Autoencoder(output_shape=(32, 32, 2), z_num=8, filters=8,
                            num_conv=1)
        x = jax.random.normal(jax.random.key(0), (2, 32, 32, 2))
        params = model.init(jax.random.key(1), x)
        psi, z = model.apply(params, x)
        assert z.shape == (2, 8)
        assert psi.shape == (2, 32, 32, 2)  # out_ch = output_shape[-1]

    def test_encoder_shape(self):
        enc = Encoder(z_num=8, filters=8, num_conv=1)
        x = jnp.ones((3, 32, 32, 2))
        params = enc.init(jax.random.key(0), x)
        z = enc.apply(params, x)
        assert z.shape == (3, 8)


def _randomize_head(params):
    """The integrator head is zero-init by design (see LatentIntegrator);
    tests probing input->output dependence need a live head."""
    p = dict(params["params"])
    k = p["fc_out"]["kernel"]
    p["fc_out"] = dict(p["fc_out"], kernel=0.1 * jax.random.normal(
        jax.random.key(99), k.shape, k.dtype))
    return {"params": p}


class TestLatentIntegrator:
    def test_residual_shapes(self):
        m = LatentIntegrator(z_num=8, num_param=2, hidden=32, depth=2)
        z = jnp.ones((4, 8))   # FULL latent code (params + free block)
        dp = jnp.zeros((4, 2))
        params = m.init(jax.random.key(0), z, dp)
        dz = m.apply(params, z, dp)
        assert dz.shape == (4, 6)  # residual only for the free block

    def test_rollout_deterministic_and_param_pinning(self):
        m = LatentIntegrator(z_num=8, num_param=2, hidden=16, depth=1)
        zf = jnp.ones((2, 6))
        dp = jnp.zeros((2, 2))
        params = m.init(jax.random.key(0), jnp.ones((2, 8)), dp)
        apply_fn = lambda p, z, d: m.apply(p, z, d)

        T = 10
        p_seq = jnp.linspace(0.0, 1.0, T)[:, None, None] * jnp.ones((T, 2, 2))
        z0 = jnp.concatenate([p_seq[0], zf], axis=-1)
        traj1 = rollout(apply_fn, params, z0, p_seq, num_param=2)
        traj2 = rollout(apply_fn, params, z0, p_seq, num_param=2)
        assert traj1.shape == (T, 2, 8)
        # determinism
        np.testing.assert_array_equal(np.asarray(traj1), np.asarray(traj2))
        # supervised block pinned to the known parameter trajectory
        np.testing.assert_allclose(
            np.asarray(traj1[:, :, :2]), np.asarray(p_seq), atol=1e-6
        )
        # step 0 is exactly z0
        np.testing.assert_allclose(np.asarray(traj1[0]), np.asarray(z0),
                                   atol=1e-6)

    def test_rollout_history1_window_path_matches_first_order(self):
        # A [1, B, z] seed routes through the history window path; with
        # H=1 its math must be BIT-identical to the first-order path
        # (same model: the flattened 1-window is exactly [z_t]).
        m = LatentIntegrator(z_num=8, num_param=2, hidden=16, depth=1)
        dp = jnp.zeros((2, 2))
        params = _randomize_head(m.init(jax.random.key(1),
                                        jnp.ones((2, 8)), dp))
        apply_fn = lambda p, z, d: m.apply(p, z, d)
        T = 8
        p_seq = jnp.linspace(0.0, 1.0, T)[:, None, None] * jnp.ones((T, 2, 2))
        z0 = jnp.concatenate([p_seq[0], jnp.ones((2, 6))], axis=-1)
        ref = rollout(apply_fn, params, z0, p_seq, num_param=2)
        win = rollout(apply_fn, params, z0[None], p_seq, num_param=2)
        np.testing.assert_array_equal(np.asarray(ref), np.asarray(win))
        # noise streams coincide too (same rng draw shapes)
        rng = jax.random.key(7)
        ref_n = rollout(apply_fn, params, z0, p_seq, num_param=2,
                        noise_std=0.1, rng=rng)
        win_n = rollout(apply_fn, params, z0[None], p_seq, num_param=2,
                        noise_std=0.1, rng=rng)
        np.testing.assert_array_equal(np.asarray(ref_n), np.asarray(win_n))

    def test_rollout_history_seeds_shapes_and_lag_dependence(self):
        # H=3: fc_0 widens to 3*z_num + num_param; the first H outputs are
        # the (param-pinned) seed codes; the oldest lag must actually
        # influence predictions (the non-Markovian fix's whole point).
        H, B, Z, P, T = 3, 2, 8, 2, 10
        m = LatentIntegrator(z_num=Z, num_param=P, hidden=16, depth=1)
        dp = jnp.zeros((B, P))
        params = _randomize_head(m.init(jax.random.key(2),
                                        jnp.ones((B, H * Z)), dp))
        apply_fn = lambda p, z, d: m.apply(p, z, d)
        p_seq = jnp.linspace(0.0, 1.0, T)[:, None, None] * jnp.ones((T, B, P))
        z0 = jnp.concatenate(
            [p_seq[:H], jax.random.normal(jax.random.key(3), (H, B, Z - P))],
            axis=-1)
        traj = rollout(apply_fn, params, z0, p_seq, num_param=P, history=H)
        assert traj.shape == (T, B, Z)
        np.testing.assert_allclose(np.asarray(traj[:H, :, P:]),
                                   np.asarray(z0[:, :, P:]), atol=1e-6)
        np.testing.assert_allclose(np.asarray(traj[:, :, :P]),
                                   np.asarray(p_seq), atol=1e-6)
        # Perturb ONLY the oldest seed: predictions must change.
        z0b = z0.at[0, :, P:].add(1.0)
        trajb = rollout(apply_fn, params, z0b, p_seq, num_param=P, history=H)
        assert float(jnp.abs(trajb[H:] - traj[H:]).max()) > 1e-6
        # Gradients flow through the windowed scan.
        g = jax.jit(jax.grad(lambda pr: jnp.sum(
            rollout(apply_fn, pr, z0, p_seq, num_param=P, history=H) ** 2)))(
            params)
        assert all(np.isfinite(np.asarray(l)).all()
                   for l in jax.tree.leaves(g))

    def test_rollout_jit_and_grad(self):
        m = LatentIntegrator(z_num=6, num_param=2, hidden=8, depth=1)
        zf = jnp.ones((1, 4))
        dp = jnp.zeros((1, 2))
        params = m.init(jax.random.key(0), jnp.ones((1, 6)), dp)
        apply_fn = lambda p, z, d: m.apply(p, z, d)
        p_seq = jnp.zeros((5, 1, 2))
        z0 = jnp.concatenate([p_seq[0], zf], axis=-1)

        def loss(p):
            traj = rollout(apply_fn, p, z0, p_seq, num_param=2)
            return jnp.sum(traj**2)

        g = jax.jit(jax.grad(loss))(params)
        leaves = jax.tree.leaves(g)
        assert all(np.isfinite(np.asarray(l)).all() for l in leaves)


class TestAutoencoder3D:
    def test_3d_roundtrip(self):
        model = Autoencoder(output_shape=(8, 16, 16, 3), z_num=8, filters=8,
                            num_conv=1)
        x = jax.random.normal(jax.random.key(0), (2, 8, 16, 16, 3))
        params = model.init(jax.random.key(1), x)
        psi, z = model.apply(params, x)
        assert z.shape == (2, 8)
        assert psi.shape == (2, 8, 16, 16, 3)
        u = ops.curl3d(psi)
        div = np.asarray(ops.divergence3d(u))[:, :-2, :-2, :-2]
        np.testing.assert_allclose(div, 0.0, atol=1e-4)


class TestRolloutRemat:
    def test_remat_matches_plain(self):
        m = LatentIntegrator(z_num=8, num_param=2, hidden=16, depth=1)
        zf = jnp.ones((2, 6))
        dp = jnp.zeros((2, 2))
        params = m.init(jax.random.key(0), jnp.ones((2, 8)), dp)
        apply_fn = lambda p, z, d: m.apply(p, z, d)
        p_seq = jnp.linspace(0, 1, 8)[:, None, None] * jnp.ones((8, 2, 2))
        z0 = jnp.concatenate([p_seq[0], zf], axis=-1)

        plain = rollout(apply_fn, params, z0, p_seq, 2)
        rm = rollout(apply_fn, params, z0, p_seq, 2, remat=True)
        np.testing.assert_allclose(np.asarray(plain), np.asarray(rm),
                                   atol=1e-6)
        # gradients flow through the remat path
        g = jax.grad(lambda p: jnp.sum(
            rollout(apply_fn, p, z0, p_seq, 2, remat=True) ** 2))(params)
        assert all(np.isfinite(np.asarray(l)).all()
                   for l in jax.tree.leaves(g))


class TestFourierEmbed:
    def test_shape_and_identity_band0(self):
        from deepfluids_tpu.models.generator import fourier_embed

        z = jnp.asarray(np.random.default_rng(0).uniform(-1, 1, (4, 3)),
                        jnp.float32)
        np.testing.assert_array_equal(np.asarray(fourier_embed(z, 0)),
                                      np.asarray(z))
        e = fourier_embed(z, 5)
        assert e.shape == (4, 3 * (2 * 5 + 1))
        # first P columns are the raw params
        np.testing.assert_array_equal(np.asarray(e[:, :3]), np.asarray(z))

    def test_band_frequencies(self):
        from deepfluids_tpu.models.generator import fourier_embed

        z = jnp.asarray([[0.5]], jnp.float32)
        e = np.asarray(fourier_embed(z, 2))[0]
        # layout: [z, sin(pi z), sin(2 pi z), cos(pi z), cos(2 pi z)]
        np.testing.assert_allclose(
            e, [0.5, np.sin(np.pi * 0.5), np.sin(np.pi),
                np.cos(np.pi * 0.5), np.cos(np.pi)], atol=1e-6)

    def test_generator_with_embedding_trains(self):
        m = GeneratorBE(output_shape=(16, 16, 1), filters=8, num_conv=2,
                        embed_bands=4)
        p = m.init(jax.random.PRNGKey(0), jnp.zeros((2, 3)))["params"]
        # fc_in widened to P*(2B+1) inputs; output shape unchanged
        assert p["fc_in"]["kernel"].shape[0] == 3 * 9
        out = m.apply({"params": p}, jnp.ones((2, 3)))
        assert out.shape == (2, 16, 16, 1)
        g = jax.grad(lambda pp: jnp.sum(
            m.apply({"params": pp}, jnp.ones((2, 3))) ** 2))(p)
        assert np.isfinite(np.asarray(g["fc_in"]["kernel"])).all()


class TestSpectralResidual:
    def test_identity_at_init(self):
        from deepfluids_tpu.models.generator import SpectralResidual

        m = SpectralResidual(modes=4)
        x = jnp.asarray(np.random.default_rng(0).normal(size=(2, 16, 12, 8)),
                        jnp.float32)
        v = m.init(jax.random.PRNGKey(0), x)
        np.testing.assert_allclose(np.asarray(m.apply(v, x)), np.asarray(x),
                                   atol=1e-6)

    def test_filter_acts_and_differentiates(self):
        from deepfluids_tpu.models.generator import SpectralResidual

        m = SpectralResidual(modes=3)
        x = jnp.asarray(np.random.default_rng(1).normal(size=(1, 8, 8, 4)),
                        jnp.float32)
        v = jax.tree.map(lambda a: a + 0.2, m.init(jax.random.PRNGKey(0), x))
        y = m.apply(v, x)
        assert float(jnp.abs(y - x).max()) > 1e-3
        g = jax.grad(lambda p: jnp.sum(m.apply(p, x) ** 2))(v)
        assert all(np.isfinite(np.asarray(l)).all() and
                   float(jnp.abs(l).max()) > 0 for l in jax.tree.leaves(g))

    def test_generator_spectral_2d_3d(self):
        for shape in [(32, 24, 1), (16, 16, 8, 3)]:
            m = GeneratorBE(output_shape=shape, filters=8, num_conv=2,
                            spectral_modes=4)
            z = jnp.ones((2, 3))
            p = m.init(jax.random.PRNGKey(0), z)["params"]
            assert any(k.startswith("spectral_") for k in p)
            out = m.apply({"params": p}, z)
            assert out.shape == (2,) + shape
            assert np.isfinite(np.asarray(out)).all()
