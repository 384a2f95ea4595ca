"""Golden-field regression tests — the normalized-L2 < 1e-3 parity gate
(SURVEY.md §4 "golden-field regression tests"; BASELINE.json north star).

Goldens are committed under tests/golden/ and regenerated only via
tools/make_goldens.py after INTENTIONAL semantic changes."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deepfluids_tpu import ops
from deepfluids_tpu.utils.parity import check_fields, normalized_l2

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
TOL = 1e-3


def _load(name):
    path = os.path.join(GOLDEN, name)
    if not os.path.exists(path):
        pytest.skip(f"golden {name} missing — run tools/make_goldens.py")
    return np.load(path)


class TestParityMetric:
    def test_normalized_l2(self):
        b = np.ones((4, 4))
        assert normalized_l2(b, b) == 0.0
        a = b + 1e-4
        assert 0 < normalized_l2(a, b) < 1e-3

    def test_check_fields(self):
        b = np.random.default_rng(0).normal(size=(3, 8, 8, 2))
        res = check_fields(b + 1e-6, b)
        assert res["passed"] and res["num_failed"] == 0
        res2 = check_fields(b + 1.0, b, tol=1e-3)
        assert not res2["passed"]


class TestGoldenFD:
    def test_fd2d(self):
        g = _load("fd2d.npz")
        u = np.asarray(ops.curl2d(jnp.asarray(g["psi"])))
        assert check_fields(u, g["u"], TOL)["passed"]
        j, w = ops.jacobian2d(jnp.asarray(g["u"]))
        assert check_fields(np.asarray(j), g["j"], TOL)["passed"]
        assert check_fields(np.asarray(w), g["w"], TOL)["passed"]

    def test_fd3d(self):
        g = _load("fd3d.npz")
        u = np.asarray(ops.curl3d(jnp.asarray(g["psi"])))
        assert check_fields(u, g["u"], TOL)["passed"]
        j, w = ops.jacobian3d(jnp.asarray(g["u"]))
        assert check_fields(np.asarray(j), g["j"], TOL)["passed"]
        assert check_fields(np.asarray(w), g["w"], TOL)["passed"]


class TestGoldenSolver:
    def test_smoke2d_trajectory(self):
        from deepfluids_tpu.datagen.smoke2d import (Smoke2DConfig,
                                                    simulate_smoke2d)

        g = _load("smoke2d.npz")
        cfg = Smoke2DConfig(height=32, width=24, num_frames=6,
                            project_iters=20)
        vt, rt = simulate_smoke2d(jnp.float32(0.5), jnp.float32(0.1), cfg)
        assert check_fields(np.asarray(vt), g["v"], TOL)["passed"]
        assert check_fields(np.asarray(rt)[..., None], g["r"][..., None],
                            TOL)["passed"]


def _golden_params(g):
    """The ``params/...`` arrays of a model golden as a nested dict (the
    goldens hold Flax-initialised weights and Flax forward outputs)."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "tools"))
    import weights_io

    return weights_io.unflatten_params(
        {k[len("params/"):]: g[k] for k in g.files if k.startswith("params/")})


def _same_structure(model, g, *x):
    """Our init creates exactly the golden's parameter paths and shapes."""
    ours = jax.tree_util.tree_flatten_with_path(
        model.init(jax.random.PRNGKey(0), *x)["params"])[0]
    theirs = {k: g[k].shape for k in g.files if k.startswith("params/")}
    assert {"params/" + "/".join(p.key for p in path): v.shape
            for path, v in ours} == theirs


class TestGoldenGenerator:
    def test_generator_forward(self):
        from deepfluids_tpu.models import GeneratorBE

        g = _load("generator2d.npz")
        model = GeneratorBE(output_shape=(32, 24, 1), filters=8, num_conv=2)
        _same_structure(model, g, jnp.asarray(g["p"]))
        out = np.asarray(ops.curl2d(model.apply(
            {"params": _golden_params(g)}, jnp.asarray(g["p"]))))
        assert check_fields(out, g["u"], TOL)["passed"]

    def test_autoencoder_forward(self):
        from deepfluids_tpu.models import Autoencoder

        g = _load("autoencoder2d.npz")
        model = Autoencoder(output_shape=(16, 16, 1), z_num=8, filters=8,
                            num_conv=1, num_param=3, pred_hidden=16)
        _same_structure(model, g, jnp.asarray(g["x"]))
        v = {"params": _golden_params(g)}
        psi, z = model.apply(v, jnp.asarray(g["x"]))
        dz = model.apply(v, z, jnp.asarray(g["dp"]), method=model.predict)
        assert check_fields(np.asarray(psi), g["psi"], TOL)["passed"]
        assert normalized_l2(np.asarray(z), g["z"]) < TOL
        assert normalized_l2(np.asarray(dz), g["dz"]) < TOL

    def test_integrator_forward(self):
        from deepfluids_tpu.models import LatentIntegrator

        g = _load("integrator.npz")
        model = LatentIntegrator(z_num=8, num_param=2, hidden=16, depth=2)
        _same_structure(model, g, jnp.asarray(g["z"]), jnp.asarray(g["dp"]))
        dz = model.apply({"params": _golden_params(g)}, jnp.asarray(g["z"]),
                         jnp.asarray(g["dp"]))
        assert normalized_l2(np.asarray(dz), g["dz"]) < TOL


class TestWeightsIO:
    def test_export_import_roundtrip(self, tmp_path):
        import sys
        sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                        "tools"))
        import weights_io
        from deepfluids_tpu.models import GeneratorBE

        model = GeneratorBE(output_shape=(16, 16, 1), filters=8, num_conv=1)
        params = model.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, 3)))["params"]
        p = str(tmp_path / "w.npz")
        weights_io.export_npz(params, p)
        # exact-key import
        back = weights_io.import_npz(p, params, mode="exact")
        jax.tree.map(
            lambda a, b: np.testing.assert_array_equal(np.asarray(a), b),
            params, back)
        # shape-ordered import with foreign key names
        flat = weights_io.flatten_params(params)
        renamed = {f"tf_var_{i}": v for i, (_, v) in enumerate(flat.items())}
        p2 = str(tmp_path / "w2.npz")
        np.savez_compressed(p2, **renamed)
        back2 = weights_io.import_npz(p2, params, mode="by_shape")
        out1 = model.apply({"params": params}, jnp.ones((1, 3)))
        out2 = model.apply({"params": back2}, jnp.ones((1, 3)))
        # by_shape can permute same-shape convs; outputs may differ, but
        # the tree structure and shapes must match exactly
        jax.tree.map(lambda a, b: np.testing.assert_array_equal(
            np.asarray(a).shape, np.asarray(b).shape), params, back2)
        assert out1.shape == out2.shape

    def test_by_shape_flagship_order_preserving(self, tmp_path):
        """Flagship-scale (2.98M params) by_shape import: GeneratorBE at
        128x96/filters=128/num_conv=4 has ~21 IDENTICALLY-SHAPED
        3x3x128x128 conv kernels — the real same-shape degeneracy of a TF1
        export.  The import contract is: TF1 enumerates variables in graph
        CREATION order, Flax's param dict iterates in module-call order —
        the same architectural order — so order-within-shape-group matching
        resolves every tensor to the right layer.  Each fixture tensor is
        tagged with a unique fill value so misassignment is detected
        exactly."""
        import sys
        sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                        "tools"))
        import weights_io
        from deepfluids_tpu.models import GeneratorBE

        model = GeneratorBE(output_shape=(128, 96, 1), filters=128,
                            num_conv=4)
        params = model.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, 3)))["params"]
        n = sum(int(np.prod(v.shape)) for v in jax.tree.leaves(params))
        assert n > 2_900_000, f"not flagship scale: {n} params"

        flat = weights_io.flatten_params(params)
        fixture, expected = {}, {}
        for i, (our_key, v) in enumerate(flat.items()):
            kind = "weights" if v.ndim > 1 else "biases"
            tf_name = f"G/var_{i:02d}/{kind}"  # TF1-ish foreign names
            fixture[tf_name] = np.full(v.shape, float(i), np.float32)
            expected[our_key] = float(i)
        p = str(tmp_path / "tf1_flagship.npz")
        np.savez_compressed(p, **fixture)

        back = weights_io.import_npz(p, params, mode="by_shape")
        back_flat = weights_io.flatten_params(back)
        assert set(back_flat) == set(flat)
        for k, tag in expected.items():
            got = float(back_flat[k].ravel()[0])
            assert got == tag, (f"{k} got tensor tagged {got}, wanted {tag} "
                                "(order not preserved within shape group)")
