"""Training-runtime tests: schedule, losses, per-arch train steps on the
8-device CPU mesh, checkpoint/resume (SURVEY.md §4 test plan)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deepfluids_tpu.config import Config, load_config, save_config
from deepfluids_tpu.datagen import scenes
from deepfluids_tpu.parallel import make_mesh, shard_batch
from deepfluids_tpu.train import (
    cosine_lr_schedule,
    field_loss,
    generator_loss,
    latent_window_loss,
)
from deepfluids_tpu.train.trainer import Trainer


@pytest.fixture(scope="module")
def tiny_dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    scenes.smoke_pos21_size5(
        str(root), num_pos=2, num_size=2, num_frames=4, height=32, width=32,
        name="tiny_smoke",
    )
    return str(root)


def tiny_config(data_dir, log_dir, **kw) -> Config:
    base = dict(
        arch="de", filters=8, num_conv=1, z_num=8, batch_size=8,
        data_dir=data_dir, dataset="tiny_smoke", log_dir=log_dir,
        max_step=50, lr_max=2e-3, lr_min=1e-4, log_step=10,
        test_step=10_000, save_step=10_000, compute_dtype="float32",
        num_worker=2, seed=0,
    )
    base.update(kw)
    return Config(**base)


class TestSchedule:
    def test_cosine_endpoints(self):
        f = cosine_lr_schedule(1e-4, 1e-6, 1000)
        np.testing.assert_allclose(float(f(0)), 1e-4, rtol=1e-6)
        np.testing.assert_allclose(float(f(1000)), 1e-6, rtol=1e-5)
        mid = float(f(500))
        np.testing.assert_allclose(mid, (1e-4 + 1e-6) / 2, rtol=1e-5)
        # clamped past max_step
        np.testing.assert_allclose(float(f(5000)), 1e-6, rtol=1e-5)


class TestLosses:
    def test_field_loss_zero_at_identity(self):
        x = jnp.ones((2, 8, 8, 2))
        loss, aux = field_loss(x, x, 1.0, 1.0)
        assert float(loss) == 0.0

    def test_generator_loss_curl_path_grads(self):
        psi = jax.random.normal(jax.random.key(0), (2, 8, 8, 1))
        x = jax.random.normal(jax.random.key(1), (2, 8, 8, 2))

        def f(p):
            loss, _ = generator_loss(p, x, True, 1.0, 1.0)
            return loss

        g = jax.grad(f)(psi)
        assert np.isfinite(np.asarray(g)).all()
        assert np.abs(np.asarray(g)).max() > 0

    def test_latent_window_loss(self):
        z = jax.random.normal(jax.random.key(0), (5, 3, 8))
        loss, _ = latent_window_loss(z, z, 2)
        assert float(loss) == 0.0


class TestRelativeLoss:
    def test_weights_emphasize_small_frames(self):
        from deepfluids_tpu.train.losses import _sample_weights

        big = np.full((1, 8, 8, 2), 1.0, np.float32)
        tiny = np.full((1, 8, 8, 2), 0.01, np.float32)
        target = jnp.asarray(np.concatenate([big, tiny]))
        w = np.asarray(_sample_weights(target)).ravel()
        assert w[1] > 5 * w[0]          # near-empty frame upweighted
        np.testing.assert_allclose(w.mean(), 1.0, rtol=1e-5)

    def test_relative_generator_loss_trains(self, tiny_dataset, tmp_path):
        c = tiny_config(tiny_dataset, str(tmp_path), tag="rel",
                        relative_loss=True)
        t = Trainer(c)
        first = t.train(num_steps=2)
        later = t.train(num_steps=30)
        assert later["loss"] < first["loss"]


class TestLossNorm:
    def test_l2_norm_squares_residuals(self):
        from deepfluids_tpu.train.losses import field_loss

        x = jnp.zeros((2, 8, 8, 2))
        p = jnp.full((2, 8, 8, 2), 0.5)
        l1_loss, _ = field_loss(p, x, 1.0, 0.0)
        l2_loss, _ = field_loss(p, x, 1.0, 0.0, norm="l2")
        np.testing.assert_allclose(float(l1_loss), 0.5, rtol=1e-6)
        np.testing.assert_allclose(float(l2_loss), 0.25, rtol=1e-6)

    def test_relative_l2_uses_squared_weights(self):
        """relative + norm=l2 optimizes the true per-frame relative L2^2:
        weights are squared (then mean-normalized) vs the l1 path."""
        from deepfluids_tpu.train.losses import _sample_weights, field_loss

        rng = np.random.default_rng(0)
        x = jnp.asarray(rng.normal(size=(4, 8, 8, 2)) *
                        np.array([1.0, 0.3, 0.05, 0.01])[:, None, None, None],
                        dtype=jnp.float32)
        p = x + jnp.asarray(rng.normal(size=x.shape), dtype=jnp.float32) * 0.1
        loss, _ = field_loss(p, x, 1.0, 0.0, relative=True, norm="l2")
        wb = np.square(np.asarray(_sample_weights(x)).ravel())
        wb = wb / wb.mean()
        per_sample_mse = np.mean(np.square(np.asarray(p - x)), axis=(1, 2, 3))
        np.testing.assert_allclose(float(loss),
                                   np.mean(wb * per_sample_mse), rtol=1e-5)

    def test_l2_norm_trains(self, tiny_dataset, tmp_path):
        c = tiny_config(tiny_dataset, str(tmp_path), tag="l2n",
                        loss_norm="l2")
        t = Trainer(c)
        first = t.train(num_steps=2)
        later = t.train(num_steps=30)
        assert later["loss"] < first["loss"]


class TestParamEmbed:
    def test_embed_bands_trains_and_evaluates(self, tiny_dataset, tmp_path):
        c = tiny_config(tiny_dataset, str(tmp_path), tag="emb",
                        embed_bands=6)
        t = Trainer(c)
        # fc_in widened to P*(2B+1) = 3*13 inputs
        assert t.state.params["fc_in"]["kernel"].shape[0] == 3 * 13
        first = t.train(num_steps=2)
        later = t.train(num_steps=30)
        assert later["loss"] < first["loss"]
        ev = t.evaluate(num_samples=8)   # generate() path embeds too
        assert np.isfinite(ev["l2_median"])


class TestMesh:
    def test_make_mesh_and_shard(self):
        mesh = make_mesh()
        assert mesh.shape["data"] == 8
        x = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
        xs = shard_batch(mesh, x)
        assert xs.sharding.num_devices == 8
        np.testing.assert_array_equal(np.asarray(xs), x)

    def test_indivisible_batch_raises(self):
        mesh = make_mesh()
        with pytest.raises(ValueError):
            shard_batch(mesh, np.zeros((3, 2)))


class TestConfig:
    def test_flag_parse_reference_names(self):
        from deepfluids_tpu.config import get_config

        c = get_config([
            "--arch", "ae", "--is_train", "False", "--w1", "2.0",
            "--use_curl", "false", "--res_x", "96", "--is_3d", "true",
            "--batch_size", "4", "--load_path", "/tmp/x",
        ])
        assert c.arch == "ae" and not c.is_train and c.w1 == 2.0
        assert not c.use_curl and c.res_x == 96 and c.is_3d
        assert c.batch_size == 4 and c.load_path == "/tmp/x"

    def test_save_load_roundtrip(self, tmp_path):
        c = Config(arch="nn", w2=3.5)
        save_config(c, str(tmp_path))
        c2 = load_config(str(tmp_path))
        assert c2 == c

    def test_merge_applies_default_valued_explicit_override(self, tmp_path):
        # A TP-trained run saves num_model_shards=2; testing it on one
        # chip needs --num_model_shards 1 to STICK even though 1 equals
        # the dataclass default (get_config records explicit flags).
        from deepfluids_tpu.config import get_config, merge_test_config

        save_config(Config(num_model_shards=2, filters=7), str(tmp_path))
        cli = get_config(["--is_train", "false",
                          "--load_path", str(tmp_path),
                          "--num_model_shards", "1"])
        merged = merge_test_config(cli, str(tmp_path))
        assert merged.num_model_shards == 1   # explicit CLI wins
        assert merged.filters == 7            # untouched flags from the run
        assert not merged.is_train

    def test_merge_keeps_saved_flags_without_explicit_cli(self, tmp_path):
        from deepfluids_tpu.config import get_config, merge_test_config

        save_config(Config(num_model_shards=2, filters=7), str(tmp_path))
        cli = get_config(["--is_train", "false",
                          "--load_path", str(tmp_path)])
        merged = merge_test_config(cli, str(tmp_path))
        assert merged.num_model_shards == 2 and merged.filters == 7


class TestTrainerDE:
    def test_loss_decreases_and_metrics(self, tiny_dataset, tmp_path):
        c = tiny_config(tiny_dataset, str(tmp_path))
        t = Trainer(c)
        first = t.train(num_steps=2)
        later = t.train(num_steps=40)
        assert later["loss"] < first["loss"]
        assert os.path.exists(os.path.join(t.run_dir, "metrics.jsonl"))
        assert os.path.exists(os.path.join(t.run_dir, "params.json"))
        # generate: correct shape, finite
        p = np.zeros((4, 3), np.float32)
        fields = t.generate(p)
        assert fields.shape == (4, 32, 32, 2)
        assert np.isfinite(fields).all()

    def test_checkpoint_roundtrip(self, tiny_dataset, tmp_path):
        c = tiny_config(tiny_dataset, str(tmp_path), tag="ckpt")
        t = Trainer(c)
        t.train(num_steps=3)
        t.save_checkpoint()
        params_before = jax.device_get(t.state.params)

        t2 = Trainer(c, run_dir=t.run_dir)
        step = t2.restore_checkpoint()
        assert step == 3
        params_after = jax.device_get(t2.state.params)
        jax.tree.map(np.testing.assert_array_equal, params_before,
                     params_after)
        assert int(t2.state.step) == 3


class TestTrainerAE:
    def test_ae_step_and_latent_supervision(self, tiny_dataset, tmp_path):
        c = tiny_config(tiny_dataset, str(tmp_path), arch="ae", tag="ae")
        t = Trainer(c)
        aux = t.train(num_steps=5)
        assert "loss_param" in aux and np.isfinite(aux["loss"])
        x, _ = t.bm.sample_batch()
        recon = t.reconstruct(x[:2])
        assert recon.shape == x[:2].shape
        z = t.encode(x[:2])
        assert z.shape == (2, c.z_num)


class TestTrainerNN:
    def test_nn_arch_end_to_end(self, tiny_dataset, tmp_path):
        # AE first (needed for the code set), then the integrator.
        c_ae = tiny_config(tiny_dataset, str(tmp_path), arch="ae", tag="ae2")
        t_ae = Trainer(c_ae)
        t_ae.train(num_steps=2)

        from deepfluids_tpu.infer import encode_dataset

        code_dir = encode_dataset(t_ae.encode, c_ae.dataset_dir, c_ae.z_num,
                                  batch_size=8)
        assert len(os.listdir(code_dir)) == 4  # 2x2 scenes

        c_nn = tiny_config(tiny_dataset, str(tmp_path), arch="nn", tag="nn",
                           w_num=3, batch_size=8)
        t_nn = Trainer(c_nn)
        aux = t_nn.train(num_steps=5)
        assert np.isfinite(aux["loss"])

    def test_nn_history_trains_and_evaluates(self, tiny_dataset, tmp_path):
        # --nn_history 2: second-order integrator (r5 mechanism fix for
        # the mov non-Markovian latent dynamics, BENCHMARKS.md).  The MLP
        # input widens to H*z_num + num_param; training windows and eval
        # rollouts seed with H true codes.
        c_ae = tiny_config(tiny_dataset, str(tmp_path), arch="ae",
                           tag="aeh")
        t_ae = Trainer(c_ae)
        t_ae.train(num_steps=2)
        from deepfluids_tpu.infer import encode_dataset

        encode_dataset(t_ae.encode, c_ae.dataset_dir, c_ae.z_num,
                       batch_size=8, suffix="h")

        c_nn = tiny_config(tiny_dataset, str(tmp_path), arch="nn",
                           tag="nnh", w_num=3, batch_size=8,
                           code_suffix="h", nn_history=2, nn_noise=0.05)
        t_nn = Trainer(c_nn)
        aux = t_nn.train(num_steps=4)
        assert np.isfinite(aux["loss"])
        fc0 = t_nn.state.params["fc_0"]["kernel"]
        assert fc0.shape[0] == 2 * c_nn.z_num + t_nn.num_param
        r = t_nn.evaluate(num_samples=4)
        assert np.isfinite(r["z_mae"]) and r["rollout_steps"] >= 3
        # window shorter than the seed history fails loudly
        c_bad = tiny_config(tiny_dataset, str(tmp_path), arch="nn",
                            tag="nnhbad", w_num=2, batch_size=8,
                            code_suffix="h", nn_history=2)
        with pytest.raises(ValueError, match="nn_history"):
            Trainer(c_bad)

    def test_nn_field_space_loss(self, tiny_dataset, tmp_path):
        # --nn_field_w: integrator trained through the frozen AE decoder.
        c_ae = tiny_config(tiny_dataset, str(tmp_path), arch="ae",
                           tag="aefs")
        t_ae = Trainer(c_ae)
        t_ae.train(num_steps=2)
        t_ae.save_checkpoint()
        from deepfluids_tpu.infer import encode_dataset

        encode_dataset(t_ae.encode, c_ae.dataset_dir, c_ae.z_num,
                       batch_size=8, suffix="fs")

        c_nn = tiny_config(tiny_dataset, str(tmp_path), arch="nn",
                           tag="nnfs", w_num=3, batch_size=8,
                           code_suffix="fs", nn_field_w=1.0,
                           nn_field_frames=2,
                           ae_load_path=t_ae.run_dir)
        t_nn = Trainer(c_nn)
        aux = t_nn.train(num_steps=3)
        assert np.isfinite(aux["loss"])
        assert "loss_nnfield" in aux and np.isfinite(aux["loss_nnfield"])
        # field term contributes to the total beyond the latent term
        assert float(aux["loss"]) >= float(aux["loss_z"])
        # without a decoder the flag fails loudly
        c_bad = tiny_config(tiny_dataset, str(tmp_path), arch="nn",
                            tag="nnfsbad", w_num=3, batch_size=8,
                            code_suffix="fs", nn_field_w=1.0)
        with pytest.raises(ValueError, match="ae_load_path"):
            Trainer(c_bad).train(num_steps=1)


class TestTrainer3D:
    def test_3d_generator_training(self, tmp_path):
        # Tiny 3D dataset (config #5 path: 3D curl of a vector potential).
        scenes.smoke3_vel5_buo3(
            str(tmp_path / "data"), num_vel=1, num_buo=1, num_frames=4,
            depth=8, height=16, width=16, name="tiny3d")
        c = tiny_config(str(tmp_path / "data"), str(tmp_path / "logs"),
                        dataset="tiny3d", tag="3d", batch_size=8)
        t = Trainer(c)
        assert t.manifest.is_3d
        aux = t.train(num_steps=3)
        assert np.isfinite(aux["loss"])
        fields = t.generate(np.zeros((2, 3), np.float32))
        assert fields.shape == (2, 8, 16, 16, 3)
        # divergence-free by construction (3D curl applied)
        from deepfluids_tpu.ops import divergence3d

        div = np.asarray(divergence3d(jnp.asarray(fields)))
        assert np.abs(div[:, :-2, :-2, :-2]).max() < 1e-3


class TestTrainerLevelset:
    def test_liquid_levelset_training(self, tmp_path):
        # Config #3 path: scalar levelset fields, no curl, gradient loss.
        scenes.liquid_pos10_size4(
            str(tmp_path / "data"), num_pos=2, num_size=1, num_frames=4,
            height=32, width=32, name="tinyliq")
        c = tiny_config(str(tmp_path / "data"), str(tmp_path / "logs"),
                        dataset="tinyliq", tag="liq", data_type="levelset")
        t = Trainer(c)
        assert not t.curl_active  # scalar field: curl bypassed
        aux = t.train(num_steps=3)
        assert np.isfinite(aux["loss"])
        fields = t.generate(np.zeros((2, 3), np.float32))
        assert fields.shape == (2, 32, 32, 1)


class TestMultiStep:
    def test_steps_per_call_matches_single(self, tiny_dataset, tmp_path):
        # Same seed -> same batch sequence; k=2 scanned steps must land on
        # (numerically) the same params as two single steps.
        c1 = tiny_config(tiny_dataset, str(tmp_path), tag="s1")
        t1 = Trainer(c1)
        t1.train(num_steps=4)

        c2 = tiny_config(tiny_dataset, str(tmp_path), tag="s2",
                         steps_per_call=2)
        t2 = Trainer(c2)
        aux = t2.train(num_steps=4)
        assert int(t2.state.step) == 4
        assert np.isfinite(aux["loss"])
        p1 = jax.device_get(t1.state.params)
        p2 = jax.device_get(t2.state.params)
        jax.tree.map(
            lambda a, b: np.testing.assert_allclose(a, b, atol=1e-5), p1, p2)

    def test_remainder_rounds_up(self, tiny_dataset, tmp_path):
        # A partial last chunk would force a second program compile; train()
        # rounds num_steps up to a multiple of steps_per_call instead.
        c = tiny_config(tiny_dataset, str(tmp_path), tag="s3",
                        steps_per_call=4)
        t = Trainer(c)
        t.train(num_steps=6)
        assert int(t.state.step) == 8


class TestDeviceDataCache:
    def test_cached_training_runs_and_learns(self, tiny_dataset, tmp_path):
        c = tiny_config(tiny_dataset, str(tmp_path), tag="cache",
                        device_data_cache=True, steps_per_call=4)
        t = Trainer(c)
        first = t.train(num_steps=4)
        later = t.train(num_steps=40)
        assert later["loss"] < first["loss"]
        assert int(t.state.step) == 44
        # cache staged once, replicated; gather sharded over 8 devices
        assert t._device_cache is not None
        assert t._device_cache[0].shape[0] == 16  # 2x2 scenes x 4 frames

    def test_streaming_to_accelerator_warns(self, tiny_dataset, tmp_path,
                                            monkeypatch):
        # Streaming per-step batches to a non-CPU backend ties every step
        # to a host->device batch copy — the trainer must say so.  Backend
        # monkeypatched: tests run on CPU.
        # (The package logger has propagate=False, so capture log.warning
        # directly instead of via caplog.)
        import deepfluids_tpu.train.trainer as trmod

        warned: list[str] = []
        monkeypatch.setattr(trmod, "_default_backend", lambda: "gpu")
        monkeypatch.setattr(trmod.log, "warning",
                            lambda msg, *a: warned.append(msg % a))
        c = tiny_config(tiny_dataset, str(tmp_path), tag="warn")
        t = Trainer(c)
        t.train(num_steps=2)
        assert any("device_data_cache" in m for m in warned)
        # ... and stays quiet when the cache is on
        warned.clear()
        c2 = tiny_config(tiny_dataset, str(tmp_path), tag="warn2",
                         device_data_cache=True)
        t2 = Trainer(c2)
        t2.train(num_steps=2)
        assert not any("device_data_cache" in m for m in warned)


class TestAugmentFlipX:
    """--augment_flip_x: the x-mirror is a symmetry of every scene family
    (train/augment.py); the flip must be exact, physical, resume-safe."""

    def _manifest(self, ranges=None):
        class M:
            num_channels = 2
            data_type = "velocity"
            num_param = 3
            param_names = ["src_x_pos", "src_radius", "frame"]
            param_ranges = ranges or [[0.2, 0.8], [0.04, 0.12], [0.0, 3.0]]
        return M()

    def test_signs_and_symmetry_validation(self):
        from deepfluids_tpu.train.augment import flip_signs

        chan, psign = flip_signs(self._manifest())
        np.testing.assert_array_equal(np.asarray(chan), [-1.0, 1.0])
        np.testing.assert_array_equal(np.asarray(psign), [-1.0, 1.0, 1.0])
        # an x-position range NOT symmetric about the domain center makes
        # the mirror a non-symmetry -> loud error, not silent corruption
        with pytest.raises(ValueError, match="not symmetric"):
            flip_signs(self._manifest(
                ranges=[[0.1, 0.8], [0.04, 0.12], [0.0, 3.0]]))

    def test_double_flip_is_identity(self):
        from deepfluids_tpu.train.augment import flip_signs, flip_x_batch

        chan, psign = flip_signs(self._manifest())
        k = jax.random.key(3)
        x = jax.random.normal(jax.random.key(0), (8, 6, 5, 2))
        y = jax.random.normal(jax.random.key(1), (8, 3))
        x1, y1 = flip_x_batch(x, y, k, chan, psign)
        assert np.abs(np.asarray(x1 - x)).max() > 0   # mask mixed: some flip
        x2, y2 = flip_x_batch(x1, y1, k, chan, psign)  # same rng, same mask
        np.testing.assert_array_equal(np.asarray(x2), np.asarray(x))
        np.testing.assert_array_equal(np.asarray(y2), np.asarray(y))

    def test_mirror_preserves_divergence_free(self):
        from deepfluids_tpu.ops import fd

        # Smooth stream function (real frames are smooth; white noise
        # would make the O(h) forward<->backward difference gap as large
        # as the field itself).
        hh, ww = np.meshgrid(np.arange(64), np.arange(64), indexing="ij")
        psi = jnp.asarray(np.sin(2 * np.pi * ww / 64)
                          * np.sin(2 * np.pi * hh / 64),
                          jnp.float32)[None, :, :, None]
        v = fd.curl2d(psi)                           # discrete div-free
        vf = jnp.flip(v, axis=-2) * jnp.asarray([-1.0, 1.0])
        div = np.asarray(fd.divergence2d(vf))[:, 1:-1, 1:-1]
        scale = float(np.abs(np.asarray(v)).mean())
        # forward-diff becomes backward-diff under the mirror: equality is
        # O(h) not exact, but a mirrored stream function is still the
        # potential -> interior divergence stays at discretization noise
        assert float(np.abs(div).mean()) < 0.2 * scale

    def test_trains_and_resumes_bitwise(self, tiny_dataset, tmp_path):
        kw = dict(augment_flip_x=True, device_data_cache=True,
                  steps_per_call=2)
        ca = tiny_config(tiny_dataset, str(tmp_path), tag="augfull", **kw)
        ta = Trainer(ca)
        aux = ta.train(num_steps=12)
        assert np.isfinite(aux["loss"])
        pa = jax.device_get(ta.state.params)

        cb = tiny_config(tiny_dataset, str(tmp_path), tag="augint", **kw)
        tb = Trainer(cb)
        tb.train(num_steps=6)
        tb.save_checkpoint()
        tc = Trainer(cb, run_dir=tb.run_dir, save_cfg=False)
        assert tc.restore_checkpoint() == 6
        tc.train(num_steps=6)
        pc = jax.device_get(tc.state.params)
        jax.tree.map(np.testing.assert_array_equal, pa, pc)

    def test_changes_training_but_not_eval(self, tiny_dataset, tmp_path):
        # The augmented stream must differ from the unaugmented one (it
        # actually flips), while evaluate() stays augmentation-free and
        # comparable across runs.
        c0 = tiny_config(tiny_dataset, str(tmp_path), tag="noaug")
        c1 = tiny_config(tiny_dataset, str(tmp_path), tag="aug",
                         augment_flip_x=True)
        t0, t1 = Trainer(c0), Trainer(c1)
        t0.train(num_steps=4)
        t1.train(num_steps=4)
        d = [float(np.abs(a - b).max()) for a, b in zip(
            jax.tree.leaves(jax.device_get(t0.state.params)),
            jax.tree.leaves(jax.device_get(t1.state.params)))]
        assert max(d) > 0

    def test_grid_family_holdout_leakage_warns(self, tiny_dataset,
                                               tmp_path, monkeypatch):
        # tiny_smoke is grid-sampled (param_counts set) with an x_pos
        # param: augment + holdout -> mirror-twin leakage warning.
        import deepfluids_tpu.train.trainer as trmod

        warned: list[str] = []
        monkeypatch.setattr(trmod.log, "warning",
                            lambda msg, *a: warned.append(msg % a))
        c = tiny_config(tiny_dataset, str(tmp_path), tag="augleak",
                        augment_flip_x=True, eval_holdout_scenes=1)
        Trainer(c)
        assert any("mirror-twin" in m for m in warned)
        # no holdout -> no warning
        warned.clear()
        c2 = tiny_config(tiny_dataset, str(tmp_path), tag="augleak2",
                         augment_flip_x=True)
        Trainer(c2)
        assert not any("mirror-twin" in m for m in warned)

    def test_nn_arch_rejected(self, tiny_dataset, tmp_path):
        c = tiny_config(tiny_dataset, str(tmp_path), tag="augnn",
                        arch="nn", augment_flip_x=True)
        with pytest.raises(ValueError, match="augment_flip_x"):
            Trainer(c)


class TestGeometryValidation:
    def test_res_flag_mismatch_raises(self, tiny_dataset, tmp_path):
        c = tiny_config(tiny_dataset, str(tmp_path), tag="geo", res_x=64)
        with pytest.raises(ValueError, match="res_x"):
            Trainer(c)

    def test_res_flag_match_ok(self, tiny_dataset, tmp_path):
        c = tiny_config(tiny_dataset, str(tmp_path), tag="geo2",
                        res_x=32, res_y=32)
        Trainer(c)  # matches the 32x32 tiny dataset

    def test_is_3d_on_2d_raises(self, tiny_dataset, tmp_path):
        c = tiny_config(tiny_dataset, str(tmp_path), tag="geo3", is_3d=True)
        with pytest.raises(ValueError, match="2D"):
            Trainer(c)


class TestNoCurlPath:
    def test_use_curl_false_trains_velocity_directly(self, tiny_dataset,
                                                     tmp_path):
        c = tiny_config(tiny_dataset, str(tmp_path), tag="nocurl",
                        use_curl=False)
        t = Trainer(c)
        assert not t.curl_active
        aux = t.train(num_steps=3)
        assert np.isfinite(aux["loss"])
        f = t.generate(np.zeros((2, 3), np.float32))
        assert f.shape == (2, 32, 32, 2)  # velocity emitted directly


class TestSpatialShard:
    """--spatial_shard: the grid's H (2D) / D (3D) axis sharded over the
    8-device mesh; loss via halo-exchange stencils, convs GSPMD-partitioned.
    Params after K steps must match the replicated-oracle run (the grads-
    match requirement of the SP/CP analogue, SURVEY §2)."""

    @staticmethod
    def _loss_and_grads(t, x, y):
        f = jax.jit(jax.value_and_grad(
            lambda p: t._loss_fn(p, jnp.asarray(x), jnp.asarray(y))[0]))
        loss, grads = f(t.state.params)
        return float(loss), jax.device_get(grads)

    def test_2d_spatial_grads_match_replicated(self, tiny_dataset, tmp_path):
        c1 = tiny_config(tiny_dataset, str(tmp_path), tag="sp2d",
                         spatial_shard=True)
        t1 = Trainer(c1)
        c2 = tiny_config(tiny_dataset, str(tmp_path), tag="sp2dref")
        t2 = Trainer(c2)
        x, y = t2.bm.step_batch(1)
        l1_, g1 = self._loss_and_grads(t1, x, y)  # same init (same seed)
        l2_, g2 = self._loss_and_grads(t2, x, y)
        np.testing.assert_allclose(l1_, l2_, rtol=1e-5)
        jax.tree.map(
            lambda a, b: np.testing.assert_allclose(a, b, atol=1e-5), g1, g2)
        # and the sharded path trains end-to-end
        aux = t1.train(num_steps=2)
        assert np.isfinite(aux["loss"])

    def test_3d_spatial_single_slice_shards(self, tmp_path):
        # depth 8 over 8 devices -> one z-slice per shard (hardest halo
        # case) through a full 3D train step including the jacobian term.
        scenes.smoke3_vel5_buo3(
            str(tmp_path / "data"), num_vel=1, num_buo=1, num_frames=4,
            depth=8, height=16, width=16, name="tiny3dsp")
        kw = dict(dataset="tiny3dsp", batch_size=4)
        c1 = tiny_config(str(tmp_path / "data"), str(tmp_path / "logs"),
                         tag="sp3d", spatial_shard=True, **kw)
        t1 = Trainer(c1)
        c2 = tiny_config(str(tmp_path / "data"), str(tmp_path / "logs"),
                         tag="sp3dref", **kw)
        t2 = Trainer(c2)
        x, y = t2.bm.step_batch(1)
        l1_, g1 = self._loss_and_grads(t1, x, y)
        l2_, g2 = self._loss_and_grads(t2, x, y)
        np.testing.assert_allclose(l1_, l2_, rtol=1e-5)
        jax.tree.map(
            lambda a, b: np.testing.assert_allclose(a, b, atol=1e-5), g1, g2)
        aux = t1.train(num_steps=2)
        assert np.isfinite(aux["loss"])

    def test_spatial_shard_rejects_nn(self, tiny_dataset, tmp_path):
        c = tiny_config(tiny_dataset, str(tmp_path), tag="spnn", arch="nn",
                        spatial_shard=True)
        with pytest.raises((ValueError, FileNotFoundError)):
            Trainer(c)

    def test_spatial_shard_indivisible_raises(self, tmp_path):
        scenes.smoke_pos21_size5(
            str(tmp_path / "data"), num_pos=1, num_size=1, num_frames=2,
            height=36, width=32, name="odd")
        c = tiny_config(str(tmp_path / "data"), str(tmp_path / "logs"),
                        dataset="odd", tag="spodd", spatial_shard=True)
        with pytest.raises(ValueError, match="divisible"):
            Trainer(c)


class TestTensorParallel:
    """num_model_shards > 1: conv/dense output channels (+ Adam state)
    sharded over the model mesh axis, activations partitioned by XLA
    (SURVEY §2 TP row).  Verified on a 2 (data) x 4 (model) CPU mesh."""

    def test_tp_grads_match_replicated(self, tiny_dataset, tmp_path):
        c1 = tiny_config(tiny_dataset, str(tmp_path), tag="tp",
                         num_data_shards=2, num_model_shards=4)
        t1 = Trainer(c1)
        assert dict(t1.mesh.shape) == {"data": 2, "model": 4}
        # weights actually sharded over the model axis
        k = t1.state.params["conv_0_0"]["kernel"]
        assert "model" in str(k.sharding.spec)

        c2 = tiny_config(tiny_dataset, str(tmp_path), tag="tpref")
        t2 = Trainer(c2)
        x, y = t2.bm.step_batch(1)

        def lag(t):
            f = jax.jit(jax.value_and_grad(
                lambda p: t._loss_fn(p, jnp.asarray(x), jnp.asarray(y))[0]))
            loss, grads = f(t.state.params)
            return float(loss), jax.device_get(grads)

        l1_, g1 = lag(t1)
        l2_, g2 = lag(t2)
        np.testing.assert_allclose(l1_, l2_, rtol=1e-5)
        jax.tree.map(
            lambda a, b: np.testing.assert_allclose(a, b, atol=1e-5), g1, g2)
        # trains + checkpoints end-to-end with the sharded layout
        aux = t1.train(num_steps=2)
        assert np.isfinite(aux["loss"])
        t1.save_checkpoint()
        t3 = Trainer(c1, run_dir=t1.run_dir, save_cfg=False)
        assert t3.restore_checkpoint() == 2


class TestExactResume:
    """SURVEY §5 checkpoint contract incl. RNG: a crash-resumed run must
    replay the identical batch stream (data order is a pure function of
    (seed, step) — data.dataset.step_rng) and land on bitwise-equal params."""

    def test_resume_bitwise_identical(self, tiny_dataset, tmp_path):
        ca = tiny_config(tiny_dataset, str(tmp_path), tag="uninterrupted")
        ta = Trainer(ca)
        ta.train(num_steps=20)
        pa = jax.device_get(ta.state.params)

        cb = tiny_config(tiny_dataset, str(tmp_path), tag="interrupted")
        tb = Trainer(cb)
        tb.train(num_steps=10)
        tb.save_checkpoint()
        tc = Trainer(cb, run_dir=tb.run_dir, save_cfg=False)
        assert tc.restore_checkpoint() == 10
        tc.train(num_steps=10)
        pc = jax.device_get(tc.state.params)
        jax.tree.map(np.testing.assert_array_equal, pa, pc)

    def test_resume_across_optimizer_structure_change(self, tiny_dataset,
                                                      tmp_path):
        # Resuming with --grad_clip after an unclipped run changes the
        # optax chain's pytree structure; the full TrainState restore
        # fails structurally and must fall back to params-only + fresh
        # opt state instead of crashing (r4: a supervised cfg5 restart
        # looped restore-crash for 3h on exactly this).
        ca = tiny_config(tiny_dataset, str(tmp_path), tag="noclip")
        ta = Trainer(ca)
        ta.train(num_steps=4)
        ta.save_checkpoint()
        pa = jax.device_get(ta.state.params)

        cb = tiny_config(tiny_dataset, str(tmp_path), tag="clip",
                         grad_clip=1.0)
        tb = Trainer(cb, run_dir=ta.run_dir, save_cfg=False)
        assert tb.restore_checkpoint() == 4          # params-only fallback
        pb = jax.device_get(tb.state.params)
        jax.tree.map(np.testing.assert_array_equal, pa, pb)
        # The fresh optimizer must NOT restart the cosine LR schedule:
        # optax.adam's schedule position is its `count`, not state.step, so
        # every count leaf must be seeded with the restored step (r4 ADVICE:
        # an 80k-of-100k fallback resume otherwise trains at ~lr_max).
        counts = [leaf for path, leaf in
                  jax.tree_util.tree_flatten_with_path(tb.state.opt_state)[0]
                  if path and getattr(path[-1], "name", None) == "count"]
        assert counts, "no count leaves found in opt_state"
        for cnt in counts:
            assert int(cnt) == 4
        aux = tb.train(num_steps=2)                  # trains on clean opt
        assert np.isfinite(aux["loss"])
        assert int(tb.state.step) == 6

    def test_resume_device_cache_scanned(self, tiny_dataset, tmp_path):
        # Same contract on the HBM-cache + fused-steps path (the production
        # configuration): identical chunking, identical programs.
        kw = dict(device_data_cache=True, steps_per_call=2)
        ca = tiny_config(tiny_dataset, str(tmp_path), tag="cfull", **kw)
        ta = Trainer(ca)
        ta.train(num_steps=20)
        pa = jax.device_get(ta.state.params)

        cb = tiny_config(tiny_dataset, str(tmp_path), tag="cint", **kw)
        tb = Trainer(cb)
        tb.train(num_steps=10)
        tb.save_checkpoint()
        tc = Trainer(cb, run_dir=tb.run_dir, save_cfg=False)
        assert tc.restore_checkpoint() == 10
        tc.train(num_steps=10)
        pc = jax.device_get(tc.state.params)
        jax.tree.map(np.testing.assert_array_equal, pa, pc)


class TestEvaluate:
    def test_evaluate_returns_l2_stats(self, tiny_dataset, tmp_path):
        c = tiny_config(tiny_dataset, str(tmp_path), tag="eval")
        t = Trainer(c)
        t.train(num_steps=2)
        r = t.evaluate(num_samples=8)
        assert set(r) == {"l2_mean", "l2_median", "l2_max", "rmse",
                          "num_samples", "holdout", "per_scene_l2_median"}
        assert r["num_samples"] == 8 and np.isfinite(r["l2_mean"])
        assert r["holdout"] is False  # no --eval_holdout_scenes set

    def test_evaluate_ae_recon_and_param(self, tiny_dataset, tmp_path):
        c = tiny_config(tiny_dataset, str(tmp_path), tag="evalae", arch="ae")
        t = Trainer(c)
        t.train(num_steps=2)
        r = t.evaluate(num_samples=8)
        assert "param_mse" in r and np.isfinite(r["rmse"])
        assert np.isfinite(r["param_mse"]) and r["num_samples"] == 8

    def test_evaluate_nn_rollout(self, tiny_dataset, tmp_path):
        c_ae = tiny_config(tiny_dataset, str(tmp_path), arch="ae",
                           tag="evae2")
        t_ae = Trainer(c_ae)
        t_ae.train(num_steps=2)
        from deepfluids_tpu.infer import encode_dataset

        encode_dataset(t_ae.encode, c_ae.dataset_dir, c_ae.z_num,
                       batch_size=8)
        c_nn = tiny_config(tiny_dataset, str(tmp_path), arch="nn",
                           tag="evnn", w_num=3)
        t_nn = Trainer(c_nn)
        t_nn.train(num_steps=2)
        r = t_nn.evaluate(num_samples=2, decode_fn=t_ae.decode)
        assert {"z_mae", "z_mae_final", "field_rmse"} <= set(r)
        assert np.isfinite(r["z_mae"]) and r["rollout_steps"] == 4
        # Unified field-space drift profile (same code path as
        # tools/rollout_eval.py) rides along whenever a decoder is known.
        prof = r["rollout_field_l2"]
        assert prof["rollout_steps"] == 4
        assert prof["scene"] == t_nn.codes.scenes[0]
        assert np.isfinite(prof["l2_median"]) and prof["l2_median"] > 0
        # The AE-only floor profile rides along too: decoding the
        # ground-truth codes of the same scene bounds any rollout score.
        floor = r["ae_floor_field_l2"]
        assert floor["scene"] == prof["scene"]
        assert np.isfinite(floor["l2_median"]) and floor["l2_median"] > 0

        # Multi-scene profiling aggregates medians over the scene pool.
        rm = t_nn.evaluate(num_samples=2, decode_fn=t_ae.decode,
                           profile_scenes=2)
        assert len(rm["rollout_field_l2_scenes"]) == 2
        assert (rm["rollout_field_l2_scenes"][0]["scene"]
                != rm["rollout_field_l2_scenes"][1]["scene"])
        agg = rm["rollout_field_l2_agg"]
        assert agg["num_scenes"] == 2
        assert np.isfinite(agg["l2_median"])
        assert np.isfinite(agg["floor_l2_median"])

        # --ae_load_path alone must wire the same decoder (VERDICT r3 #8:
        # no hand-built AE needed for routine field-space nn evals).
        # (train() already checkpointed t_ae at its final step.)
        c_nn2 = tiny_config(tiny_dataset, str(tmp_path), arch="nn",
                            tag="evnn2", w_num=3,
                            ae_load_path=t_ae.run_dir)
        t_nn2 = Trainer(c_nn2)
        t_nn2.train(num_steps=2)
        r2 = t_nn2.evaluate(num_samples=2)
        assert {"field_rmse", "rollout_field_l2"} <= set(r2)


class TestWatchdog:
    def test_fires_on_stalled_deadline(self, tiny_dataset, tmp_path):
        import threading
        import time as _time

        c = tiny_config(tiny_dataset, str(tmp_path), tag="wd")
        t = Trainer(c)
        fired = threading.Event()
        t._wd_abort = fired.set          # don't os._exit the test runner
        t._wd_start(timeout=0.2)
        t._wd_deadline = _time.monotonic() - 1.0   # armed + already expired
        assert fired.wait(timeout=3.0), "watchdog did not fire"

    def test_disarmed_does_not_fire(self, tiny_dataset, tmp_path):
        import threading

        c = tiny_config(tiny_dataset, str(tmp_path), tag="wd2")
        t = Trainer(c)
        fired = threading.Event()
        t._wd_abort = fired.set
        t._wd_start(timeout=0.2)
        t._wd_deadline = None
        assert not fired.wait(timeout=0.8)

    def test_init_arms_and_disarms(self, tiny_dataset, tmp_path):
        # Trainer __init__ runs the first real device work (state init /
        # device_put); with watchdog_secs > 0 the watcher must be LIVE
        # during init (a runtime outage there would otherwise hang the
        # child outside the train loop's arming, unrecoverable by a
        # supervisor) and disarmed once init completes.
        c = tiny_config(tiny_dataset, str(tmp_path), tag="wd4",
                        watchdog_secs=60.0)
        t = Trainer(c)
        assert t._wd_thread is not None and t._wd_thread.is_alive()
        assert t._wd_deadline is None    # init done -> disarmed

    def test_training_with_watchdog_completes(self, tiny_dataset, tmp_path):
        c = tiny_config(tiny_dataset, str(tmp_path), tag="wd3",
                        watchdog_secs=60.0)
        t = Trainer(c)
        out = t.train(num_steps=4)
        assert np.isfinite(out["loss"])
        assert t._wd_deadline is None    # disarmed between chunks


class TestLossNormValidation:
    def test_unknown_norm_raises(self):
        a = jnp.zeros((2, 8, 8, 2))
        with pytest.raises(ValueError, match="loss_norm"):
            field_loss(a, a, 1.0, 1.0, norm="L1")

    def test_parser_rejects_bad_choice(self):
        from deepfluids_tpu.config import get_config

        with pytest.raises(SystemExit):
            get_config(["--loss_norm", "L1"])
        with pytest.raises(SystemExit):
            get_config(["--arch", "DE"])


class TestEvalHoldout:
    """--eval_holdout_scenes: the last N scenes never enter training draws;
    evaluate() samples ONLY them (a true held-out quality number)."""

    def test_holdout_partition_and_stream(self, tiny_dataset, tmp_path):
        from deepfluids_tpu.data.dataset import BatchManager

        bm = BatchManager(os.path.join(tiny_dataset, "tiny_smoke"), 8,
                          seed=0, holdout_scenes=1)
        keys = bm.ds.scene_keys
        held_key = sorted(set(keys))[-1]
        held = {i for i, k in enumerate(keys) if k == held_key}
        assert set(bm.eval_indices) == held
        assert set(bm.train_indices).isdisjoint(held)
        assert len(bm.train_indices) + len(bm.eval_indices) == len(bm.ds)
        for step in range(1, 20):
            x, y = bm.step_batch(step)  # draws stay in the train subset
        # the holdout=0 stream is bit-identical to the historical one
        bm0 = BatchManager(os.path.join(tiny_dataset, "tiny_smoke"), 8,
                           seed=0)
        from deepfluids_tpu.data.dataset import step_batch_indices

        idx_old = step_batch_indices(0, 3, len(bm0.ds), 8)
        x_new, _ = bm0.step_batch(3)
        x_old, _ = bm0._gather(idx_old)
        np.testing.assert_array_equal(x_new, x_old)

    def test_holdout_too_large_raises(self, tiny_dataset, tmp_path):
        from deepfluids_tpu.data.dataset import BatchManager

        with pytest.raises(ValueError, match="holdout"):
            BatchManager(os.path.join(tiny_dataset, "tiny_smoke"), 8,
                         holdout_scenes=4)

    def test_holdout_negative_raises(self, tiny_dataset, tmp_path):
        # -1 would otherwise silently hold out all-but-one scene via the
        # distinct[-N:] slice and train on a single scene.
        from deepfluids_tpu.data.dataset import BatchManager

        with pytest.raises(ValueError, match="holdout"):
            BatchManager(os.path.join(tiny_dataset, "tiny_smoke"), 8,
                         holdout_scenes=-1)

    def test_select_holdout_keys_modes(self):
        from deepfluids_tpu.data.dataset import select_holdout_keys

        keys = [f"{p}_{s}" for p in range(5) for s in range(4)]
        # edge: lexically-last N (historical behavior, bit-compat)
        assert select_holdout_keys(keys, 2) == set(sorted(keys)[-2:])
        assert select_holdout_keys(keys, 0, "interior") == set()
        # interior: never touches a grid boundary in ANY dimension
        held = select_holdout_keys(keys, 3, "interior")
        assert len(held) == 3
        for k in held:
            p, s = map(int, k.split("_"))
            assert 0 < p < 4 and 0 < s < 3
        # deterministic
        assert held == select_holdout_keys(list(reversed(keys)), 3,
                                           "interior")
        # interior pool for 5x4 grid is 3x2=6; asking for more raises
        with pytest.raises(ValueError, match="interior"):
            select_holdout_keys(keys, 7, "interior")
        with pytest.raises(ValueError, match="holdout_mode"):
            select_holdout_keys(keys, 2, "middle")
        # non-grid keys (random-trajectory families): evenly spaced
        # non-endpoint fallback
        rkeys = [f"scene{i:03d}" for i in range(10)]
        held = select_holdout_keys(rkeys, 2, "interior")
        assert len(held) == 2
        assert rkeys[0] not in held and rkeys[-1] not in held

    def test_interior_holdout_partitions(self, tmp_path):
        # 4x3 grid -> interior pool is 2x1 (pos in {1,2}, size=1).
        root = tmp_path / "data"
        scenes.smoke_pos21_size5(str(root), num_pos=4, num_size=3,
                                 num_frames=3, height=16, width=16,
                                 name="grid43")
        from deepfluids_tpu.data.dataset import BatchManager

        bm = BatchManager(os.path.join(str(root), "grid43"), 4, seed=0,
                          holdout_scenes=2, holdout_mode="interior")
        keys = bm.ds.scene_keys
        held_keys = {keys[i] for i in bm.eval_indices}
        assert held_keys == {"1_1", "2_1"}
        assert set(bm.train_indices).isdisjoint(set(bm.eval_indices))
        for step in range(1, 10):    # training draws avoid held scenes
            idx = bm.train_indices[
                np.arange(len(bm.train_indices))]  # all train frames
            assert held_keys.isdisjoint({keys[i] for i in idx})

    def test_code_dataset_interior_holdout(self, tmp_path):
        # CodeDataset with interior holdout: held scenes never sampled by
        # window_batch; edge mode keeps the historical identity mapping.
        from deepfluids_tpu.data.dataset import CodeDataset
        from deepfluids_tpu.data.manifest import Manifest, save_manifest

        root = tmp_path / "codes_ds"
        code_dir = root / "code4"
        code_dir.mkdir(parents=True)
        save_manifest(Manifest(
            param_names=["p", "frame"],
            param_ranges=[[0.0, 3.0], [0.0, 5.0]],
            num_scenes=12, num_frames=6, resolution=[4, 4],
            num_channels=2, v_range=[-1.0, 1.0]), str(root))
        rng = np.random.default_rng(0)
        for p in range(4):
            for s in range(3):
                np.savez(code_dir / f"{p}_{s}.npz",
                         z=rng.normal(size=(6, 4)).astype(np.float32),
                         p=np.stack([np.full(6, float(p)),
                                     np.arange(6, dtype=np.float32)], 1))
        cd = CodeDataset(str(root), 4, seed=0, holdout_scenes=2,
                         holdout_mode="interior")
        held = {cd.scenes[i] for i in cd.eval_scene_indices}
        assert held == {"1_1", "2_1"}
        assert cd.num_train_scenes == 10
        # sampled scene indices stay in train_scene_indices (the draw
        # inside window_batch maps through it — replicate step 3's stream)
        rng = np.random.default_rng((0, 3))
        for _ in range(50):
            s = int(cd.train_scene_indices[
                rng.integers(0, cd.num_train_scenes)])
            assert cd.scenes[s] not in held
        # edge mode on the same set: train_scene_indices is the identity
        cd_e = CodeDataset(str(root), 4, seed=0, holdout_scenes=2,
                           holdout_mode="edge")
        np.testing.assert_array_equal(
            cd_e.train_scene_indices, np.arange(cd_e.num_train_scenes))

    def test_trainer_evaluates_holdout(self, tiny_dataset, tmp_path):
        c = tiny_config(tiny_dataset, str(tmp_path), tag="hold",
                        eval_holdout_scenes=1, device_data_cache=True,
                        steps_per_call=2)
        t = Trainer(c)
        t.train(num_steps=4)
        r = t.evaluate(num_samples=8)
        assert r["holdout"] is True
        # every evaluated frame comes from the held-out scene set
        assert r["num_samples"] <= len(t.bm.eval_indices)
        assert np.isfinite(r["l2_mean"])
        # per-scene spread: exactly the held-out scene keys appear
        held_keys = {t.bm.ds.scene_keys[int(i)] for i in t.bm.eval_indices}
        assert set(r["per_scene_l2_median"]) == held_keys
        # pool="train" must sample STRICTLY the training subset — the old
        # eval_holdout_scenes=0 override sampled the full pool, so
        # "train-pool" gap diagnostics were contaminated by holdout
        # scenes (r4 ADVICE).  Record which dataset indices get fetched.
        fetched = []
        orig = t.bm.ds.get_normalized
        t.bm.ds.get_normalized = lambda i: (fetched.append(int(i)),
                                            orig(i))[1]
        try:
            rt = t.evaluate(num_samples=8, pool="train")
        finally:
            t.bm.ds.get_normalized = orig
        assert rt["holdout"] is False
        held = set(int(i) for i in t.bm.eval_indices)
        assert fetched and held.isdisjoint(fetched)
        assert np.isfinite(rt["l2_mean"])

    def test_nn_holdout_partitions_pipeline(self, tiny_dataset, tmp_path):
        # AE (holdout 1) -> encode ALL scenes -> integrator with the SAME
        # holdout flag: the held-out scene's windows never enter training
        # draws, and evaluate() rolls out ONLY held-out scenes (a true
        # held-out rollout number for the cfg-4 pipeline).
        c_ae = tiny_config(tiny_dataset, str(tmp_path), arch="ae",
                           tag="aehold", eval_holdout_scenes=1)
        t_ae = Trainer(c_ae)
        t_ae.train(num_steps=2)
        from deepfluids_tpu.infer import encode_dataset

        encode_dataset(t_ae.encode, c_ae.dataset_dir, c_ae.z_num,
                       batch_size=8)

        c_nn = tiny_config(tiny_dataset, str(tmp_path), arch="nn",
                           tag="nnhold", w_num=3, batch_size=8,
                           eval_holdout_scenes=1)
        t_nn = Trainer(c_nn)
        n = t_nn.codes.num_scenes
        assert t_nn.codes.num_train_scenes == n - 1
        assert list(t_nn.codes.eval_scene_indices) == [n - 1]
        # Training windows never come from the held-out scene: its param
        # vector (pos,size — constant over the trajectory) must not show
        # up in any sampled window.
        held_p = tuple(np.round(t_nn.codes.p[n - 1][0][:2], 5))
        for step in range(1, 12):
            _, p_seq = t_nn.codes.window_batch(8, 3, step=step)
            for b in range(p_seq.shape[1]):
                assert tuple(np.round(p_seq[0, b, :2], 5)) != held_p
        aux = t_nn.train(num_steps=3)
        assert np.isfinite(aux["loss"])
        r = t_nn.evaluate(num_samples=4)
        assert r["holdout"] is True
        assert r["num_samples"] == 1  # exactly the held-out scene pool
        assert np.isfinite(r["z_mae"])
        # train-pool counterpart: only the n-1 training scenes
        rt = t_nn.evaluate(num_samples=n, pool="train")
        assert rt["holdout"] is False
        assert rt["num_samples"] == n - 1
        assert np.isfinite(rt["z_mae"])

        # negative / too-large holdouts reject cleanly (same guard as
        # BatchManager; codes exist here from the encode pass above)
        from deepfluids_tpu.data.dataset import CodeDataset

        ds_dir = os.path.join(tiny_dataset, "tiny_smoke")
        with pytest.raises(ValueError, match="holdout"):
            CodeDataset(ds_dir, 8, holdout_scenes=-1)
        with pytest.raises(ValueError, match="holdout"):
            CodeDataset(ds_dir, 8, holdout_scenes=n)


class TestGrainPipeline:
    """--input_pipeline grain: the grain DataLoader wired into the Trainer
    (SURVEY §2 DP row 'sharded grain loader feeding training')."""

    def test_grain_trains(self, tiny_dataset, tmp_path):
        c = tiny_config(tiny_dataset, str(tmp_path), tag="grain",
                        input_pipeline="grain")
        t = Trainer(c)
        aux = t.train(num_steps=3)
        assert np.isfinite(aux["loss"])

    def test_grain_stream_deterministic(self, tiny_dataset, tmp_path):
        c = tiny_config(tiny_dataset, str(tmp_path), tag="graind",
                        input_pipeline="grain")
        t = Trainer(c)
        a = [x.sum() for x, _ in t._batches(3)]
        b = [x.sum() for x, _ in t._batches(3)]
        np.testing.assert_allclose(a, b)
        # resume position k yields the suffix of the stream from 0
        full = [float(x.sum()) for x, _ in t._batches(4, start_step=0)]
        tail = [float(x.sum()) for x, _ in t._batches(2, start_step=2)]
        np.testing.assert_allclose(full[2:], tail)

    def test_grain_respects_holdout(self, tiny_dataset, tmp_path):
        c = tiny_config(tiny_dataset, str(tmp_path), tag="grainh",
                        input_pipeline="grain", eval_holdout_scenes=1)
        t = Trainer(c)
        held = {tuple(np.round(y, 5)) for i in t.bm.eval_indices
                for y in [t.bm.ds.get_normalized(int(i))[1]]}
        for x, y in t._batches(4):
            for row in y:
                assert tuple(np.round(row, 5)) not in held

    def test_grain_incompatible_flags_raise(self, tiny_dataset, tmp_path):
        with pytest.raises(ValueError, match="grain"):
            Trainer(tiny_config(tiny_dataset, str(tmp_path), tag="gbad",
                                input_pipeline="grain",
                                device_data_cache=True))
        with pytest.raises((ValueError, FileNotFoundError)):
            Trainer(tiny_config(tiny_dataset, str(tmp_path), tag="gbad2",
                                input_pipeline="grain", arch="nn"))


class TestTPFlagshipShape:
    """TP at the FLAGSHIP shape (128x96, filters=128 — VERDICT r2 weak #3):
    layout surprises at 128-filter shapes (lane-width-aligned channel
    splits) only show up at real sizes, so this compiles + steps + grad-
    checks + checkpoints the real model on a 4 (data) x 2 (model) mesh."""

    @pytest.fixture(scope="class")
    def flagship_dataset(self, tmp_path_factory):
        root = tmp_path_factory.mktemp("flag")
        scenes.smoke_pos21_size5(
            str(root), num_pos=1, num_size=1, num_frames=2,
            height=128, width=96, name="flag")
        return str(root)

    def test_tp_flagship_step_grads_checkpoint(self, flagship_dataset,
                                               tmp_path):
        kw = dict(dataset="flag", filters=128, num_conv=4, batch_size=4,
                  compute_dtype="float32")
        c1 = tiny_config(flagship_dataset, str(tmp_path), tag="tpflag",
                         num_data_shards=4, num_model_shards=2, **kw)
        t1 = Trainer(c1)
        assert dict(t1.mesh.shape) == {"data": 4, "model": 2}
        k = t1.state.params["conv_0_0"]["kernel"]
        assert k.shape == (3, 3, 128, 128)
        assert "model" in str(k.sharding.spec)

        c2 = tiny_config(flagship_dataset, str(tmp_path), tag="tpflagref",
                         **kw)
        t2 = Trainer(c2)
        x, y = t2.bm.step_batch(1)

        def lag(t):
            f = jax.jit(jax.value_and_grad(
                lambda p: t._loss_fn(p, jnp.asarray(x), jnp.asarray(y))[0]))
            loss, grads = f(t.state.params)
            return float(loss), jax.device_get(grads)

        l1_, g1 = lag(t1)
        l2_, g2 = lag(t2)
        np.testing.assert_allclose(l1_, l2_, rtol=1e-5)
        jax.tree.map(
            lambda a, b: np.testing.assert_allclose(
                a, b, atol=5e-4, rtol=1e-3), g1, g2)
        # one real train step + checkpoint save/restore with the TP layout
        aux = t1.train(num_steps=1)
        assert np.isfinite(aux["loss"])
        t1.save_checkpoint()
        t3 = Trainer(c1, run_dir=t1.run_dir, save_cfg=False)
        assert t3.restore_checkpoint() == 1
        jax.tree.map(lambda a, b: np.testing.assert_array_equal(
            np.asarray(a), np.asarray(b)),
            jax.device_get(t1.state.params), jax.device_get(t3.state.params))


class TestGridDecoder:
    """--decoder grid (beyond-reference family): multi-res param grids +
    per-stage low-rank spatial basis injection; must start on the BE trunk
    (zero injection) and train."""

    def test_grid_decoder_trains_and_evaluates(self, tiny_dataset, tmp_path):
        c = tiny_config(tiny_dataset, str(tmp_path), tag="grid",
                        decoder="grid", grid_levels=3, grid_features=4,
                        grid_rank=4)
        t = Trainer(c)
        p = t.state.params
        assert "param_grid" in p and "basis_0" in p and "coef_0" in p
        # basis zero-init -> injection exactly 0 at step 0
        assert float(np.abs(np.asarray(p["basis_0"])).max()) == 0.0
        first = t.train(num_steps=2)
        later = t.train(num_steps=40)
        assert later["loss"] < first["loss"]
        # the basis actually moved (gradient path is live)
        assert float(np.abs(np.asarray(t.state.params["basis_0"])).max()) > 0
        ev = t.evaluate(num_samples=8)
        assert np.isfinite(ev["l2_median"])

    def test_grid_interpolates_raw_params_under_embed_bands(self):
        # The grid tables are (knots,)**P — they must see the RAW P-dim
        # parameter vector, not the fourier-embedded one, or embed_bands>0
        # exponentiates the table size (P=3, bands=2 -> (knots,)**15).
        from deepfluids_tpu.models.generator import GeneratorBE

        m = GeneratorBE(output_shape=(16, 16, 1), filters=4, num_conv=1,
                        repeat=2, embed_bands=2, grid_levels=2,
                        grid_features=2, grid_rank=2)
        p = m.init(jax.random.PRNGKey(0), jnp.zeros((1, 3)))["params"]
        for lvl in range(2):
            t = p["param_grid"][f"grid_{lvl}"]
            assert t.ndim == 4 and t.shape[:-1] == (2 * 2 ** lvl + 1,) * 3

    def test_grid_decoder_rejected_for_ae(self, tiny_dataset, tmp_path):
        c = tiny_config(tiny_dataset, str(tmp_path), tag="gridae",
                        arch="ae", decoder="grid")
        with pytest.raises(ValueError, match="decoder"):
            Trainer(c)

    def test_param_grid_interp_matches_corners(self):
        from deepfluids_tpu.models.generator import _interp_grid

        table = jnp.asarray(np.random.default_rng(0).normal(
            size=(3, 5, 4)).astype(np.float32))
        # exact knot queries reproduce table entries
        p = jnp.asarray([[-1.0, -1.0], [1.0, 1.0], [0.0, 0.0]])
        out = np.asarray(_interp_grid(table, p))
        np.testing.assert_allclose(out[0], np.asarray(table[0, 0]), rtol=1e-6)
        np.testing.assert_allclose(out[1], np.asarray(table[2, 4]), rtol=1e-6)
        np.testing.assert_allclose(out[2], np.asarray(table[1, 2]), rtol=1e-6)
        # midpoint between two knots = average
        pm = jnp.asarray([[0.0, 0.75]])   # y: knot 3 & 4 midpoint... 0.75 -> t=3.5
        mid = np.asarray(_interp_grid(table, pm))[0]
        np.testing.assert_allclose(
            mid, np.asarray(0.5 * (table[1, 3] + table[1, 4])), rtol=1e-5)


class TestRolloutNoise:
    """--nn_noise: training-noise drift stabilizer for the integrator."""

    def test_noise_rollout_deterministic_and_trains(self, tiny_dataset,
                                                    tmp_path):
        c_ae = tiny_config(tiny_dataset, str(tmp_path), arch="ae",
                           tag="nzae")
        t_ae = Trainer(c_ae)
        t_ae.train(num_steps=2)
        from deepfluids_tpu.infer import encode_dataset

        encode_dataset(t_ae.encode, c_ae.dataset_dir, c_ae.z_num,
                       batch_size=8)
        c = tiny_config(tiny_dataset, str(tmp_path), arch="nn", tag="nz",
                        w_num=3, nn_noise=0.02)
        t = Trainer(c)
        aux = t.train(num_steps=5)
        assert np.isfinite(aux["loss"])
        # same (params, batch, step) -> same loss: the noise stream is a
        # pure function of (seed, step), preserving exact resume
        z, p = t.codes.window_batch(4, 3, step=1)
        l1_ = float(t._loss_fn(t.state.params, jnp.asarray(z),
                               jnp.asarray(p), 7)[0])
        l2_ = float(t._loss_fn(t.state.params, jnp.asarray(z),
                               jnp.asarray(p), 7)[0])
        assert l1_ == l2_
        l3_ = float(t._loss_fn(t.state.params, jnp.asarray(z),
                               jnp.asarray(p), 8)[0])
        assert l1_ != l3_   # different step -> different noise

    def test_inference_rollout_noise_free(self):
        from deepfluids_tpu.models import LatentIntegrator
        from deepfluids_tpu.models.latent import rollout

        m = LatentIntegrator(z_num=6, num_param=2, hidden=16, depth=1)
        z0 = jnp.ones((3, 6))
        p_seq = jnp.zeros((4, 3, 2))
        params = m.init(jax.random.PRNGKey(0), jnp.zeros((3, 6)),
                        jnp.zeros((3, 2)))
        ap = lambda pr, zf, dp: m.apply(pr, zf, dp)
        a = rollout(ap, params, z0, p_seq, 2)
        b = rollout(ap, params, z0, p_seq, 2)  # no rng, no noise: pure
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        with pytest.raises(ValueError, match="rng"):
            rollout(ap, params, z0, p_seq, 2, noise_std=0.1)


class TestPredictionAwareAE:
    """--ae_pred_w: (t, t+1) pair batches + co-trained latent predictor
    (the r5 non-Markovian-latent mechanism fix; models/autoencoder.py)."""

    def test_successor_map_non_lexical_frames(self):
        # Frame filenames are NOT zero-padded: lexical order puts 10 after
        # 1, so succ(i) != i+1 in file order — the map must go through
        # (scene, frame+1).
        from deepfluids_tpu.data.dataset import FieldDataset

        ds = FieldDataset.__new__(FieldDataset)
        ds.files = sorted(
            [f"/x/0_0_{t}.npz" for t in range(12)]
            + [f"/x/0_1_{t}.npz" for t in range(3)])
        ds._succ = None
        succ = ds.successor
        names = [os.path.basename(f)[:-4] for f in ds.files]
        for i, n in enumerate(names):
            scene, frame = n.rsplit("_", 1)
            j = int(succ[i])
            if j < 0:  # last frame of its scene
                assert int(frame) in (11, 2)
            else:
                s2, f2 = names[j].rsplit("_", 1)
                assert s2 == scene and int(f2) == int(frame) + 1

    def test_pair_batches_are_consecutive_frames(self, tiny_dataset):
        from deepfluids_tpu.data.dataset import BatchManager

        bm = BatchManager(os.path.join(tiny_dataset, "tiny_smoke"), 4,
                          seed=0, holdout_scenes=1, pair=True)
        # pair pool: train frames that have a same-scene successor
        succ = bm.ds.successor
        assert set(bm.train_pair_indices) <= set(bm.train_indices)
        assert (succ[bm.train_pair_indices] >= 0).all()
        x, y = bm.step_batch(5)
        assert x.shape[0] == 8 and y.shape[0] == 8  # [2B]
        # halves differ only by one frame step: same scene params, frame
        # time advanced by one normalized tick (last param is frame time)
        p_t, p_t1 = y[:4], y[4:]
        np.testing.assert_allclose(p_t[:, :-1], p_t1[:, :-1], atol=1e-6)
        frames = sorted({int(os.path.basename(f)[:-4].rsplit("_", 1)[1])
                         for f in bm.ds.files})
        tick = 2.0 / (len(frames) - 1)  # time param normalized to [-1, 1]
        np.testing.assert_allclose(p_t1[:, -1] - p_t[:, -1], tick,
                                   atol=1e-5)
        # deterministic (exact-resume contract)
        x2, y2 = bm.step_batch(5)
        np.testing.assert_array_equal(x, x2)

    def test_train_step_and_cache_streaming_agree(self, tiny_dataset,
                                                  tmp_path):
        cfgs = {}
        for cache in (False, True):
            cfg = tiny_config(
                tiny_dataset, str(tmp_path / f"log{cache}"), arch="ae",
                ae_pred_w=0.5, max_step=4, log_step=2, batch_size=4,
                device_data_cache=cache, steps_per_call=2)
            t = Trainer(cfg, run_dir=str(tmp_path / f"run{cache}"))
            aux = t.train(cfg.max_step)
            assert "loss_pred" in aux and np.isfinite(aux["loss_pred"])
            cfgs[cache] = jax.device_get(t.state.params)
        # the HBM-cache gather and the streaming path see the SAME
        # (seed, step) pair stream -> bitwise-identical training
        jax.tree.map(np.testing.assert_array_equal, cfgs[False],
                     cfgs[True])

    def test_pred_loss_shapes_encoder_gradients(self, tiny_dataset,
                                                tmp_path):
        # The predictor term must backprop into the ENCODER (that is the
        # whole point: shape z to be predictable), not only the predictor.
        cfg = tiny_config(tiny_dataset, str(tmp_path / "g"), arch="ae",
                          ae_pred_w=1.0, batch_size=4)
        t = Trainer(cfg, run_dir=str(tmp_path / "rg"))
        x, y = t.bm.step_batch(1)

        def pred_term(params):
            loss, aux = t._loss_fn(params, jnp.asarray(x), jnp.asarray(y))
            return aux["loss_pred"]

        g = jax.grad(pred_term)(t.state.params)
        enc_norm = sum(
            float(jnp.sum(jnp.abs(v))) for v in
            jax.tree_util.tree_leaves(g["encoder"]))
        pred_norm = sum(
            float(jnp.sum(jnp.abs(v))) for v in
            jax.tree_util.tree_leaves(g["predictor"]))
        assert enc_norm > 0 and pred_norm > 0

    def test_validation_errors(self, tiny_dataset, tmp_path):
        with pytest.raises(ValueError, match="ae_pred_w"):
            Trainer(tiny_config(tiny_dataset, str(tmp_path / "e1"),
                                arch="de", ae_pred_w=1.0),
                    run_dir=str(tmp_path / "e1r"))
        with pytest.raises(ValueError, match="augment"):
            Trainer(tiny_config(tiny_dataset, str(tmp_path / "e2"),
                                arch="ae", ae_pred_w=1.0,
                                augment_flip_x=True),
                    run_dir=str(tmp_path / "e2r"))
