"""Sharded-stencil + advection tests on the 8-device CPU mesh
(SURVEY.md §4: multi-device tests without several accelerators)."""

import jax
import jax.numpy as jnp
import numpy as np

from deepfluids_tpu import ops
from deepfluids_tpu.infer.advect import advect_density, render_density_sweep
from deepfluids_tpu.parallel import make_mesh
from deepfluids_tpu.parallel.halo import (
    curl2d_sharded,
    divergence2d_sharded,
    jacobian2d_sharded,
)


class TestHaloStencils:
    def test_curl_matches_oracle(self):
        mesh = make_mesh()
        rng = np.random.default_rng(0)
        psi = jnp.asarray(rng.standard_normal((2, 32, 24, 1)), jnp.float32)
        got = np.asarray(curl2d_sharded(psi, mesh))
        want = np.asarray(ops.curl2d(psi))
        np.testing.assert_allclose(got, want, atol=1e-6)

    def test_jacobian_matches_oracle(self):
        mesh = make_mesh()
        rng = np.random.default_rng(1)
        x = jnp.asarray(rng.standard_normal((1, 64, 16, 2)), jnp.float32)
        gj, gw = jacobian2d_sharded(x, mesh)
        wj, ww = ops.jacobian2d(x)
        np.testing.assert_allclose(np.asarray(gj), np.asarray(wj), atol=1e-6)
        np.testing.assert_allclose(np.asarray(gw), np.asarray(ww),
                                   atol=1e-6)

    def test_divfree_through_sharded_path(self):
        mesh = make_mesh()
        rng = np.random.default_rng(2)
        psi = jnp.asarray(rng.standard_normal((1, 32, 32, 1)), jnp.float32)
        u = curl2d_sharded(psi, mesh)
        div = np.asarray(divergence2d_sharded(u, mesh))[:, :-2, :-2]
        np.testing.assert_allclose(div, 0.0, atol=1e-5)

    def test_output_stays_sharded(self):
        mesh = make_mesh()
        psi = jnp.zeros((1, 32, 8, 1))
        u = curl2d_sharded(psi, mesh)
        assert u.sharding.num_devices == 8


class TestShardedFusedStencils:
    """The XLA-fused loss stencils on a batch-sharded data mesh: GSPMD
    partitions the plain ops.fd stencils over the batch axis, and loss and
    grads must equal the single-device result (the data-parallel path)."""

    def _check(self, psi, x):
        from deepfluids_tpu.parallel import shard_batch
        from deepfluids_tpu.train import losses

        mesh = make_mesh()

        def loss(p, x):
            return losses.generator_loss(p, x, True, 1.0, 1.0)[0]

        vg = jax.jit(jax.value_and_grad(loss))
        ls, gs = vg(*shard_batch(mesh, psi, x))
        one = jax.devices()[0]
        l1, g1 = vg(jax.device_put(psi, one), jax.device_put(x, one))
        np.testing.assert_allclose(float(ls), float(l1), rtol=1e-6)
        np.testing.assert_allclose(np.asarray(gs), np.asarray(g1), atol=1e-6)
        assert gs.sharding.num_devices == 8  # stayed sharded end-to-end

    def test_generator_loss_and_grads_match_oracle(self):
        rng = np.random.default_rng(7)
        self._check(rng.standard_normal((8, 16, 16, 1)).astype(np.float32),
                    rng.standard_normal((8, 16, 16, 2)).astype(np.float32))

    def test_3d_loss_and_grads_match_oracle(self):
        rng = np.random.default_rng(8)
        self._check(
            rng.standard_normal((8, 6, 8, 8, 3)).astype(np.float32),
            rng.standard_normal((8, 6, 8, 8, 3)).astype(np.float32))


class TestRealisticResolutionSharded:
    """Full 128x96 reference-resolution train steps on the 8-device mesh
    (narrow filters keep CPU time sane) — catches sharding-induced layout
    surprises that tiny-grid tests can't (r1 VERDICT weak #7)."""

    def _step(self, mesh, model, state, x_sh, y_sh, rep, bsh):
        from deepfluids_tpu.train import generator_loss

        def step(state, x, y):
            def loss_fn(p):
                out = state.apply_fn({"params": p}, y)
                return generator_loss(out, x, True, 1.0, 1.0)[0]

            l, g = jax.value_and_grad(loss_fn)(state.params)
            return state.apply_gradients(grads=g), l

        js = jax.jit(step, in_shardings=(rep, x_sh, y_sh),
                     out_shardings=(rep, rep), donate_argnums=(0,))
        return js

    def test_dp_and_spatial_full_resolution(self):
        from jax.sharding import NamedSharding, PartitionSpec as P

        from deepfluids_tpu.models import GeneratorBE
        from deepfluids_tpu.parallel import (batch_sharding,
                                             replicated_sharding,
                                             shard_batch)
        from deepfluids_tpu.train.state import (create_train_state,
                                                make_optimizer)

        mesh = make_mesh()
        rep = replicated_sharding(mesh)
        rng = np.random.default_rng(0)
        x = rng.normal(size=(16, 128, 96, 2)).astype(np.float32)
        y = rng.normal(size=(16, 3)).astype(np.float32)
        tx = make_optimizer(1e-4, 1e-5, 100)

        # DP: batch over 8 devices at reference resolution.
        model = GeneratorBE(output_shape=(128, 96, 1), filters=32,
                            num_conv=4)
        state = jax.device_put(create_train_state(
            jax.random.PRNGKey(0), model, (jnp.zeros((1, 3)),), tx), rep)
        js = self._step(mesh, model, state, batch_sharding(mesh),
                        batch_sharding(mesh), rep, batch_sharding(mesh))
        _, l_dp = js(state, shard_batch(mesh, x), shard_batch(mesh, y))
        assert np.isfinite(float(l_dp))

        # Spatial: H=128 sharded 8 ways (16 rows/shard) with constrained
        # conv stages + halo-stencil loss.
        from deepfluids_tpu.train import losses

        model_sp = GeneratorBE(output_shape=(128, 96, 1), filters=32,
                               num_conv=4, spatial_mesh=mesh)
        state_sp = jax.device_put(create_train_state(
            jax.random.PRNGKey(0), model_sp, (jnp.zeros((1, 3)),), tx), rep)
        sp_sh = NamedSharding(mesh, P(None, "data"))

        def step_sp(state, x, y):
            def loss_fn(p):
                out = state.apply_fn({"params": p}, y)
                out = jax.lax.with_sharding_constraint(out, sp_sh)
                return losses.generator_loss_spatial(
                    out, x, True, 1.0, 1.0, mesh)[0]

            l, g = jax.value_and_grad(loss_fn)(state.params)
            return state.apply_gradients(grads=g), l

        js_sp = jax.jit(step_sp, in_shardings=(rep, sp_sh, rep),
                        out_shardings=(rep, rep), donate_argnums=(0,))
        _, l_sp = js_sp(state_sp, jax.device_put(jnp.asarray(x), sp_sh),
                        jnp.asarray(y))
        assert np.isfinite(float(l_sp))
        # same data, same init -> same loss irrespective of layout
        np.testing.assert_allclose(float(l_sp), float(l_dp), rtol=1e-5)


class TestAdvection:
    def test_constant_velocity_transport(self):
        # Uniform rightward velocity moves a blob right by dt*u per step.
        h, w = 16, 32
        vel = jnp.zeros((4, h, w, 2)).at[..., 0].set(2.0)
        rho0 = jnp.zeros((h, w)).at[:, 4:8].set(1.0)
        frames = np.asarray(advect_density(vel, rho0, None, dt=1.0,
                                           inject=False))
        assert frames.shape == (4, h, w)
        # after 2 steps the blob has moved 4 cells right
        np.testing.assert_allclose(frames[1][:, 8:12], 1.0, atol=1e-4)
        assert frames[1][:, 4:6].max() < 0.1

    def test_render_density_sweep_batched(self):
        from deepfluids_tpu.data.manifest import Manifest

        m = Manifest(
            param_names=["pos", "size", "frame"],
            param_ranges=[[0.2, 0.8], [0.05, 0.1], [0.0, 5.0]],
            num_scenes=1, num_frames=6, resolution=[16, 16],
            num_channels=2, v_range=[-1.0, 1.0])

        def gen(p_norm):  # fake generator: constant upward velocity
            t = p_norm.shape[0]
            return jnp.zeros((t, 16, 16, 2)).at[..., 1].set(0.5)

        scenes = np.array([[0.3, 0.08], [0.7, 0.08]], np.float32)
        rho = render_density_sweep(gen, m, scenes, num_frames=6)
        assert rho.shape == (2, 6, 16, 16)
        assert rho.max() > 0  # source injected and transported
        assert np.isfinite(rho).all()


class TestHalo3D:
    def test_curl3d_matches_oracle(self):
        from deepfluids_tpu.parallel.halo import curl3d_sharded

        mesh = make_mesh()
        rng = np.random.default_rng(3)
        psi = jnp.asarray(rng.standard_normal((2, 16, 8, 12, 3)),
                          jnp.float32)
        got = np.asarray(curl3d_sharded(psi, mesh))
        want = np.asarray(ops.curl3d(psi))
        np.testing.assert_allclose(got, want, atol=1e-6)

    def test_divfree_through_sharded_3d(self):
        from deepfluids_tpu.parallel.halo import (curl3d_sharded,
                                                  divergence3d_sharded)

        mesh = make_mesh()
        rng = np.random.default_rng(4)
        psi = jnp.asarray(rng.standard_normal((1, 16, 12, 8, 3)),
                          jnp.float32)
        u = curl3d_sharded(psi, mesh)
        div = np.asarray(divergence3d_sharded(u, mesh))[:, :-2, :-2, :-2]
        np.testing.assert_allclose(div, 0.0, atol=1e-5)

    def test_jacobian3d_matches_oracle(self):
        from deepfluids_tpu.parallel.halo import jacobian3d_sharded

        mesh = make_mesh()
        rng = np.random.default_rng(6)
        x = jnp.asarray(rng.standard_normal((2, 16, 8, 12, 3)), jnp.float32)
        gj, gv = jacobian3d_sharded(x, mesh)
        wj, wv = ops.jacobian3d(x)
        np.testing.assert_allclose(np.asarray(gj), np.asarray(wj), atol=1e-6)
        np.testing.assert_allclose(np.asarray(gv), np.asarray(wv), atol=1e-6)

    def test_grad_scalar_sharded_matches_oracle(self):
        from deepfluids_tpu.parallel.halo import grad_scalar_sharded
        from deepfluids_tpu.train.losses import _grad_scalar

        mesh = make_mesh()
        rng = np.random.default_rng(9)
        for shape in [(2, 16, 12, 1), (2, 8, 6, 12, 1)]:
            s = jnp.asarray(rng.standard_normal(shape), jnp.float32)
            got = np.asarray(grad_scalar_sharded(s, mesh))
            want = np.asarray(_grad_scalar(s))
            np.testing.assert_allclose(got, want, atol=1e-6)

    def test_single_row_shards(self):
        # H == number of shards: each shard holds ONE row — the hardest
        # halo case (regression for the roll-based edge fixup bug).
        from deepfluids_tpu.parallel.halo import curl2d_sharded

        mesh = make_mesh()
        rng = np.random.default_rng(5)
        psi = jnp.asarray(rng.standard_normal((2, 8, 16, 1)), jnp.float32)
        got = np.asarray(curl2d_sharded(psi, mesh))
        want = np.asarray(ops.curl2d(psi))
        np.testing.assert_allclose(got, want, atol=1e-6)


class TestSpatialLossKnobs:
    def test_spatial_matches_replicated_relative_l2(self):
        """The spatial loss path honors relative/loss_norm identically to
        the replicated path (they were silently dropped before round 2's
        review fix)."""
        from deepfluids_tpu.train import losses

        mesh = make_mesh()
        rng = np.random.default_rng(0)
        psi = jnp.asarray(rng.normal(size=(4, 16, 12, 1)), jnp.float32)
        x = jnp.asarray(rng.normal(size=(4, 16, 12, 2)), jnp.float32)
        for relative in (False, True):
            for norm in ("l1", "l2"):
                ref, _ = losses.generator_loss(
                    psi, x, True, 1.0, 1.0,
                    relative=relative, norm=norm)
                sp, _ = losses.generator_loss_spatial(
                    psi, x, True, 1.0, 1.0, mesh,
                    relative=relative, norm=norm)
                np.testing.assert_allclose(float(sp), float(ref), rtol=1e-5,
                                           err_msg=f"{relative=} {norm=}")


class TestMultihostPlacement:
    def test_local_rows_dedup_on_data_model_mesh(self):
        """shard_batch_multihost on a data x model mesh: P("data")
        replicates rows over the model axis, so several local devices map
        to the SAME row slice — the local gather must deduplicate or
        make_array_from_process_local_data sees a 2x-too-large local
        array (single-process here, but the index map logic is shared)."""
        from deepfluids_tpu.parallel.mesh import shard_batch_multihost

        mesh = make_mesh(num_data=4, num_model=2)
        a = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
        out = shard_batch_multihost(mesh, a)
        np.testing.assert_array_equal(np.asarray(out), a)
        # and on the pure-data mesh it still round-trips
        mesh1 = make_mesh(num_data=8, num_model=1)
        out1 = shard_batch_multihost(mesh1, a)
        np.testing.assert_array_equal(np.asarray(out1), a)
