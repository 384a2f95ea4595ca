"""The Trainer: per-arch model build, pjit train step, loop, checkpoints.

Reference parity target: ``trainer.py`` of byungsook/deep-fluids (SURVEY.md
§2 "Trainer", call stacks §3.1/3.3/3.4 [M][B]).  Differences are the point:

  * graph build + Supervisor session  →  pure functional train step,
    jit-compiled once with explicit shardings over a device mesh;
  * TF FIFOQueue input                →  host prefetching BatchManager +
    `jax.device_put` onto the data mesh axis (grads all-reduced by XLA
    automatically, SURVEY §2 parallelism table);
  * TF Saver checkpoints              →  one .npz per step (params, opt
    state, step; train/checkpoint.py);
  * TensorBoard summaries             →  metrics.jsonl + optional
    tensorboardX, plus the reference's periodic sample-image dumps.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Iterator

import jax
import jax.numpy as jnp
import numpy as np

from deepfluids_tpu.config import Config, save_config
from deepfluids_tpu.data.dataset import BatchManager, CodeDataset
from deepfluids_tpu.models import (
    Autoencoder,
    GeneratorBE,
    LatentIntegrator,
    rollout,
)
from deepfluids_tpu.parallel import (
    batch_sharding,
    make_mesh,
    replicated_sharding,
)
from deepfluids_tpu.train import checkpoint, losses
from deepfluids_tpu.train.state import (
    create_train_state,
    make_optimizer,
    param_count,
)
from deepfluids_tpu.utils import (
    get_logger,
    prepare_run_dir,
    save_image_grid,
)

log = get_logger()


def _default_backend() -> str:
    """Indirection over jax.default_backend so tests can simulate an
    accelerator backend."""
    return jax.default_backend()


class Trainer:
    """Owns model + state + data for one run; dispatches on config.arch."""

    def __init__(self, config: Config, run_dir: str | None = None,
                 mesh=None, save_cfg: bool = True):
        self.c = config
        self.mesh = mesh if mesh is not None else make_mesh(
            num_data=config.num_data_shards or None,
            num_model=config.num_model_shards or 1)
        self.run_dir = run_dir or prepare_run_dir(
            config.log_dir, config.dataset, config.tag, config.load_path)
        if save_cfg:
            save_config(config, self.run_dir)
        self.dtype = jnp.dtype(config.compute_dtype)
        if config.augment_flip_x and config.arch == "nn":
            raise ValueError("--augment_flip_x applies to arch de/ae "
                             "(field-space training); the latent "
                             "integrator trains on encoded codes")
        if config.nn_history < 1:
            raise ValueError("--nn_history must be >= 1")
        if config.ae_pred_w > 0:
            if config.arch != "ae":
                raise ValueError("--ae_pred_w trains the autoencoder's "
                                 "co-trained latent predictor (arch ae)")
            if config.augment_flip_x:
                # flip_x_batch mirrors a random HALF of the batch; on a
                # [2B] pair batch the t and t+1 halves would draw
                # different masks, mirroring one frame of a pair only.
                raise ValueError("--ae_pred_w with --augment_flip_x is "
                                 "unsupported (pair batches)")
            if config.input_pipeline == "grain":
                raise ValueError("--ae_pred_w needs (t, t+1) pair batches; "
                                 "the grain pipeline serves single frames")
        if config.arch == "nn" and config.nn_history >= config.w_num:
            raise ValueError(
                f"--nn_history {config.nn_history} must be < --w_num "
                f"{config.w_num}: the first H window positions are true "
                "seed codes, so the window needs predicted steps to train "
                "on")

        # --- data ---
        if config.arch in ("de", "ae"):
            field_key = "l" if config.data_type == "levelset" else "v"
            self.bm = BatchManager(
                config.dataset_dir, config.batch_size, seed=config.seed,
                cache=config.cache_data, num_workers=config.num_worker,
                field_key=field_key,
                holdout_scenes=config.eval_holdout_scenes,
                holdout_mode=config.holdout_mode,
                pair=config.arch == "ae" and config.ae_pred_w > 0)
            self.manifest = self.bm.manifest
        else:  # nn
            # Scene-level holdout mirrors BatchManager's (same
            # select_holdout_keys rule — the SAME set the AE held out when
            # trained with the same flags), so the whole cfg-4 pipeline
            # partitions consistently: held-out scenes' windows never enter
            # integrator training, and _evaluate_nn rolls out only
            # held-out scenes.
            self.codes = CodeDataset(config.dataset_dir, config.z_num,
                                     seed=config.seed,
                                     holdout_scenes=config.eval_holdout_scenes,
                                     suffix=config.code_suffix,
                                     holdout_mode=config.holdout_mode)
            self.manifest = self.codes.manifest
        if config.input_pipeline == "grain":
            if config.arch not in ("de", "ae"):
                raise ValueError("--input_pipeline grain serves field "
                                 "batches (arch de/ae only)")
            if config.device_data_cache:
                raise ValueError(
                    "--input_pipeline grain streams batches; it cannot "
                    "feed --device_data_cache (which gathers on device)")
            if jax.process_count() > 1:
                raise ValueError(
                    "--input_pipeline grain is single-host only: its "
                    "per-host sharded stream yields host-LOCAL batches, "
                    "but the multi-host train step consumes the "
                    "globally-identical (seed, step) stream placed by "
                    "shard_batch_multihost.  Use the native pipeline "
                    "for multi-host runs.  (Design rationale: "
                    "DESIGN.md §8 'Multi-host input sharding'.)")
        if config.decoder == "grid" and config.arch != "de":
            raise ValueError("--decoder grid applies to arch de (the "
                             "parameterized generator)")
        self.num_param = self.manifest.num_param
        self._check_geometry_flags()

        # Arm the hang watchdog across INIT too: create_train_state /
        # device_put below are the first real device work, and a device
        # that stops answering here would block the process outside the
        # train loop, where the per-chunk arming never engages.  Same 10x
        # compile allowance as the first train chunk.
        self._wd_deadline: float | None = None   # armed hang-watchdog
        self._wd_thread = None
        if config.watchdog_secs > 0:
            self._wd_start(float(config.watchdog_secs))
            self._wd_deadline = (time.monotonic()
                                 + 10 * float(config.watchdog_secs))

        # --- model ---
        self.model = self._build_model()

        # --- state ---
        tx = make_optimizer(config.lr_max, config.lr_min, config.max_step,
                            config.beta1, config.beta2, config.grad_clip)
        rng = jax.random.PRNGKey(config.seed)
        self.state = create_train_state(
            rng, self.model, self._example_inputs(), tx)
        # Weights/opt-state layout: replicated on a pure-data mesh; output-
        # channel-sharded over the model axis under TP (num_model_shards>1).
        from deepfluids_tpu.parallel.mesh import model_sharded_state
        self._state_sharding = model_sharded_state(self.state, self.mesh)
        self.state = jax.device_put(self.state, self._state_sharding)
        log.info("arch=%s params=%.2fM mesh=%s", config.arch,
                 param_count(self.state.params) / 1e6,
                 dict(self.mesh.shape))

        self._dump_rng = np.random.default_rng(config.seed + 7919)
        self._wd_deadline = None   # init device work done — disarm
        self._train_step = self._make_train_step()
        self._metrics_path = os.path.join(self.run_dir, "metrics.jsonl")
        self._tb = None

        # --- aux subsystems (SURVEY.md §5): NaN debugging, profiler window,
        # TensorBoard scalars ---
        if config.debug_nans:
            jax.config.update("jax_debug_nans", True)
        self._profile_range: tuple[int, int] | None = None
        if config.profile_steps:
            lo, hi = (int(s) for s in config.profile_steps.split(","))
            self._profile_range = (lo, hi)
        if config.use_tensorboard:
            try:
                from tensorboardX import SummaryWriter

                self._tb = SummaryWriter(self.run_dir)
            except Exception as e:
                log.warning("tensorboardX unavailable: %s", e)

    # ------------------------------------------------------------------
    # model / inputs per arch
    # ------------------------------------------------------------------

    def _check_geometry_flags(self) -> None:
        """--res_x/y/z and --is_3d are VALIDATED against the manifest (the
        dataset's args.txt is the source of truth for geometry); a mismatch
        errors loudly rather than being silently ignored."""
        c, m = self.c, self.manifest
        if m.is_3d:
            want = {"res_z": m.resolution[0], "res_y": m.resolution[1],
                    "res_x": m.resolution[2]}
        else:
            want = {"res_y": m.resolution[0], "res_x": m.resolution[1]}
        for flag, actual in want.items():
            given = getattr(c, flag)
            if given and given != actual:
                raise ValueError(
                    f"--{flag}={given} but dataset {c.dataset} has "
                    f"{flag}={actual} (geometry comes from args.txt)")
        if (c.res_z or c.is_3d) and not m.is_3d:
            raise ValueError(f"--is_3d/--res_z given but {c.dataset} is 2D")
        if c.spatial_shard:
            n = self.mesh.shape["data"]
            axis = m.resolution[0]  # H (2D) / D (3D) — the sharded axis
            if axis % n:
                raise ValueError(
                    f"--spatial_shard needs the grid's first axis ({axis}) "
                    f"divisible by the data-axis size ({n})")

    def _field_shape(self) -> tuple[int, ...]:
        return self.manifest.field_shape

    def _potential_channels(self) -> int:
        """Channels the network emits: psi (1) / Psi (3) under curl, else the
        field channels directly (levelset or use_curl=False)."""
        if not self.c.use_curl or self.manifest.num_channels == 1:
            return self.manifest.num_channels
        return 1 if not self.manifest.is_3d else 3

    @property
    def curl_active(self) -> bool:
        return self.c.use_curl and self.manifest.num_channels > 1

    def _build_model(self):
        c = self.c
        res = tuple(self.manifest.resolution)
        out_shape = res + (self._potential_channels(),)
        smesh = self.mesh if c.spatial_shard else None
        if c.arch == "de":
            grid = c.decoder == "grid"
            return GeneratorBE(output_shape=out_shape, filters=c.filters,
                               num_conv=c.num_conv, repeat=c.repeat,
                               dtype=self.dtype, spatial_mesh=smesh,
                               embed_bands=c.embed_bands,
                               spectral_modes=c.spectral_modes,
                               grid_levels=c.grid_levels if grid else 0,
                               grid_features=c.grid_features if grid else 0,
                               grid_rank=c.grid_rank if grid else 0)
        if c.arch == "ae":
            return Autoencoder(output_shape=out_shape, z_num=c.z_num,
                               filters=c.filters, num_conv=c.num_conv,
                               repeat=c.repeat, dtype=self.dtype,
                               spatial_mesh=smesh,
                               num_param=self.num_param,
                               pred_hidden=(c.ae_pred_hidden
                                            if c.ae_pred_w > 0 else 0))
        if c.arch == "nn":
            return LatentIntegrator(z_num=c.z_num, num_param=self.num_param,
                                    hidden=c.nn_hidden, depth=c.nn_depth)
        raise ValueError(f"unknown arch {c.arch!r}")

    def _example_inputs(self) -> tuple:
        c = self.c
        if c.arch == "de":
            return (jnp.zeros((1, self.num_param)),)
        if c.arch == "ae":
            return (jnp.zeros((1,) + self._field_shape()),)
        # nn: fc_0's width follows the history window (H * z_num + dp).
        return (jnp.zeros((1, c.z_num * c.nn_history)),
                jnp.zeros((1, self.num_param)))

    # ------------------------------------------------------------------
    # train step (jit once, runs for the whole loop)
    # ------------------------------------------------------------------

    def _make_train_step(self):
        c = self.c
        num_param = self.num_param
        use_curl = self.curl_active
        rep = replicated_sharding(self.mesh)
        bsh = batch_sharding(self.mesh)
        from jax.sharding import NamedSharding, PartitionSpec as P

        spatial = c.spatial_shard
        if spatial and c.arch not in ("de", "ae"):
            raise ValueError("--spatial_shard applies to arch de/ae only")
        # Spatial sharding (SURVEY §2 SP/CP analogue): the grid's H (2D) /
        # D (3D) axis — axis 1 of both field layouts — is sharded over the
        # data axis, batch + params replicated.  The loss runs halo-exchange
        # stencils (parallel/halo.py); the conv layers are partitioned by
        # GSPMD (XLA inserts conv halos automatically).
        spatial_sh = NamedSharding(self.mesh, P(None, "data"))
        bsh_a, bsh_b = (spatial_sh, rep) if spatial else (bsh, bsh)

        if c.arch == "de":
            def loss_fn(params, x, y):
                out = self.state.apply_fn({"params": params}, y)
                if spatial:
                    out = jax.lax.with_sharding_constraint(out, spatial_sh)
                    loss, aux = losses.generator_loss_spatial(
                        out, x, use_curl, c.w1, c.w2, self.mesh,
                        c.relative_loss, c.loss_norm)
                else:
                    loss, aux = losses.generator_loss(
                        out, x, use_curl, c.w1, c.w2, c.relative_loss,
                        c.loss_norm)
                del aux["pred"]
                return loss, aux
        elif c.arch == "ae":
            ae_model = self.model

            def loss_fn(params, x, y):
                out, z = self.state.apply_fn({"params": params}, x)
                if spatial:
                    out = jax.lax.with_sharding_constraint(out, spatial_sh)
                    loss, aux = losses.autoencoder_loss_spatial(
                        out, z, x, y, use_curl, num_param, c.w1, c.w2,
                        c.w3, self.mesh, c.relative_loss, c.loss_norm)
                else:
                    loss, aux = losses.autoencoder_loss(
                        out, z, x, y, use_curl, num_param, c.w1, c.w2,
                        c.w3, c.relative_loss, c.loss_norm)
                del aux["pred"]
                if c.ae_pred_w > 0:
                    # Pair batch [2B] = [x_t ; x_{t+1}] (BatchManager pair
                    # mode).  The recon/param terms above already cover
                    # both halves; here the co-trained predictor's
                    # one-step error flows into the ENCODER through z_t
                    # AND z_{t+1} — shaping the latent to carry the state
                    # its own dynamics need (models/autoencoder.py).
                    nb = z.shape[0] // 2
                    zt, zt1 = z[:nb], z[nb:]
                    pt, pt1 = y[:nb], y[nb:]
                    # Param block pinned to the TRUE trajectory — the
                    # contract downstream rollouts use (models/latent.py).
                    z_in = jnp.concatenate([pt, zt[:, num_param:]], -1)
                    dz = ae_model.apply({"params": params}, z_in, pt1 - pt,
                                        method=ae_model.predict)
                    pl = jnp.mean(
                        (zt[:, num_param:] + dz - zt1[:, num_param:]) ** 2)
                    loss = loss + c.ae_pred_w * pl
                    aux = dict(aux, loss_pred=pl)
                return loss, aux
        else:  # nn — batch is (z_seq [W,B,z], p_seq [W,B,P])
            decode_field = None
            if c.nn_field_w > 0:
                # --nn_field_w: train the integrator through the FROZEN AE
                # decoder — field_loss(D(z_pred), D(z_true)) on a subsample
                # of window positions.  The decoder params are captured as
                # compile-time constants (~7M f32, well under the lowering
                # limits CLAUDE.md warns about for multi-GB datasets) so
                # value_and_grad never differentiates them.
                ae = self._ae_trainer()
                if ae is None:
                    raise ValueError("--nn_field_w needs --ae_load_path "
                                     "(the frozen decoder to train through)")
                ae_model, ae_curl = ae.model, ae.curl_active
                dec_params = jax.tree_util.tree_map(
                    jnp.asarray, jax.device_get(ae.state.params))

                def decode_field(z):
                    out = ae_model.apply({"params": dec_params}, z,
                                         method=ae_model.decode)
                    return losses.apply_curl(out) if ae_curl else out

            def loss_fn(params, z_seq, p_seq, step_num=0):
                apply = lambda p, zf, dp: self.state.apply_fn(
                    {"params": p}, zf, dp)
                # --nn_noise: per-step state corruption during the training
                # window (drift stabilizer; models/latent.rollout).  The
                # noise stream is a pure function of (seed, global step) —
                # same exact-resume contract as the batch order.
                rng = (jax.random.fold_in(
                    jax.random.PRNGKey(c.seed ^ 0x6E01), step_num)
                    if c.nn_noise > 0 else None)
                # --nn_history H>1: seed with the window's first H TRUE
                # codes (second-order integrator; models/latent.rollout).
                z_start = (z_seq[:c.nn_history] if c.nn_history > 1
                           else z_seq[0])
                z_pred = rollout(apply, params, z_start, p_seq, num_param,
                                 remat=c.remat_rollout,
                                 noise_std=c.nn_noise, rng=rng,
                                 history=c.nn_history)
                loss, aux = losses.latent_window_loss(z_pred, z_seq,
                                                      num_param)
                if decode_field is not None:
                    # Decode nn_field_frames evenly spaced window positions
                    # (position 0 is the shared start state — excluded).
                    w = z_pred.shape[0]
                    k = int(min(max(1, c.nn_field_frames),
                                w - c.nn_history))
                    t_idx = np.linspace(c.nn_history, w - 1, k).astype(int)
                    zp = z_pred[t_idx].reshape(-1, z_pred.shape[-1])
                    zt = z_seq[t_idx].reshape(-1, z_seq.shape[-1])
                    fl, _ = losses.field_loss(
                        decode_field(zp), decode_field(zt), c.w1, c.w2,
                        c.relative_loss, c.loss_norm)
                    loss = loss + c.nn_field_w * fl
                    aux = dict(aux, loss_nnfield=fl)
                return loss, aux

        aug_signs = None
        if c.augment_flip_x:  # arch de/ae only (validated in __init__)
            from deepfluids_tpu.train import augment

            aug_signs = augment.flip_signs(self.manifest)
            aug_key = jax.random.PRNGKey(c.seed ^ 0xF11B)
            if (c.eval_holdout_scenes
                    and self.manifest.param_counts
                    and float(np.min(np.asarray(aug_signs[1]))) < 0):
                # Grid-sampled x-position family: the mirror of a training
                # scene IS the dataset's scene at the reflected position
                # (deterministic x-symmetric solver), which may be a
                # held-out scene -> the holdout stops measuring
                # generalization (train/augment.py "Holdout caveat").
                log.warning(
                    "--augment_flip_x on a GRID-sampled x-position family "
                    "with --eval_holdout_scenes: mirrored training scenes "
                    "can coincide with held-out scenes (mirror-twin "
                    "leakage); holdout numbers for this run measure "
                    "coverage, not generalization")

        def step(state, a, b):
            if aug_signs is not None:
                # Mirror a random half of the batch across x (train-time
                # only; pure fn of (seed, step) -> exact-resume safe).
                a, b = augment.flip_x_batch(
                    a, b, jax.random.fold_in(aug_key, state.step),
                    *aug_signs)
            extra = (state.step,) if c.arch == "nn" else ()
            (loss, aux), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(state.params, a, b, *extra)
            new_state = state.apply_gradients(grads=grads)
            aux["loss"] = loss
            return new_state, aux

        # nn batches are [W, B, ...]: shard the batch dim (axis 1).
        if c.arch == "nn":
            bsh_a = bsh_b = NamedSharding(self.mesh, P(None, "data"))

        self._raw_step = step
        self._loss_fn = loss_fn  # exposed for grad-parity tests
        self._batch_shardings = (bsh_a, bsh_b)
        self._train_multi = None
        self._cached_multi = None
        self._device_cache = None
        return jax.jit(
            step,
            in_shardings=(self._state_sharding, bsh_a, bsh_b),
            out_shardings=(self._state_sharding, rep),
            donate_argnums=(0,),
        )

    # ------------------------------------------------------------------
    # HBM-resident dataset (zero host->device bytes per step)
    # ------------------------------------------------------------------

    @staticmethod
    def _staged_device_put(x: np.ndarray, sharding, max_bytes=256 << 20):
        """Host->device transfer in bounded chunks.

        Bounds the size of any single transfer (and the pinned host staging
        it needs).  Rows are written into a donated device buffer via
        dynamic_update_slice, so peak device memory is buffer + one chunk
        (not 2x the array as a device concat would be)."""
        if x.nbytes <= max_bytes:
            return jax.device_put(jnp.asarray(x), sharding)
        row_bytes = max(x.nbytes // max(x.shape[0], 1), 1)
        rows = max(1, int(max_bytes // row_bytes))
        buf = jax.device_put(jnp.zeros(x.shape, x.dtype), sharding)
        upd = jax.jit(
            lambda b, c, s: jax.lax.dynamic_update_slice(
                b, c, (s,) + (0,) * (b.ndim - 1)),
            donate_argnums=(0,))
        for i in range(0, x.shape[0], rows):
            chunk = jax.device_put(jnp.asarray(x[i:i + rows]), sharding)
            buf = upd(buf, chunk, i)
        return buf

    def _load_device_cache(self):
        """Stage the whole normalized dataset in HBM once.

        The 2D reference dataset is ~2 GB f32 — small next to device
        memory, but streaming batches from the host ties each step to a
        host->device copy.  With the cache, the train step gathers (x, y)
        by int32 index ON DEVICE and per-step host traffic is just the
        index array.  de/ae archs only.
        """
        if self._device_cache is not None:
            return self._device_cache
        from deepfluids_tpu.data.native_npz import load_npz_batch

        m = self.manifest
        files = self.bm.ds.files
        x = load_npz_batch(files, "x", m.field_shape,
                           num_threads=self.c.num_worker)
        y = load_npz_batch(files, "y", (m.num_param,),
                           num_threads=self.c.num_worker)
        x = m.normalize_field(x).astype(self.c.cache_dtype)
        y = m.normalize_params(y).astype(np.float32)
        rep = replicated_sharding(self.mesh)
        log.info("staging %d fields (%.2f GB, %s) into device memory",
                 x.shape[0], x.nbytes / 1e9, x.dtype)
        self._device_cache = (self._staged_device_put(x, rep),
                              jax.device_put(jnp.asarray(y), rep))
        return self._device_cache

    def _get_cached_multi(self):
        """K fused train steps gathering batches from the HBM cache.

        The cache arrays are passed as ARGUMENTS (already device-resident,
        zero-copy) — closing over them would bake 2 GB of constants into
        the lowered program."""
        if self._cached_multi is None:
            rep = replicated_sharding(self.mesh)
            raw = self._raw_step

            from jax.sharding import NamedSharding, PartitionSpec as P

            # idx [K, B]: batch dim sharded for DP; replicated when the
            # grid (not the batch) is the sharded axis.
            idx_sharding = (rep if self.c.spatial_shard
                            else NamedSharding(self.mesh, P(None, "data")))

            def multi(state, idx, cache_x, cache_y):  # idx [K, B] int32
                def body(st, ix):
                    # Gathered batch back to f32 (cache may be f16 to halve
                    # HBM); XLA fuses the cast into the gather.
                    st, aux = raw(st, cache_x[ix].astype(jnp.float32),
                                  cache_y[ix])
                    return st, aux
                state, auxs = jax.lax.scan(body, state, idx)
                return state, jax.tree.map(lambda v: v[-1], auxs)

            self._cached_multi = jax.jit(
                multi,
                in_shardings=(self._state_sharding, idx_sharding, rep, rep),
                out_shardings=(self._state_sharding, rep),
                donate_argnums=(0,),
            )
        return self._cached_multi

    def _get_train_multi(self):
        """K fused train steps per device program: lax.scan over a stacked
        chunk of prefetched batches.  One runtime dispatch per K steps
        amortizes per-call launch and host overhead at small batch."""
        if self._train_multi is None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            rep = replicated_sharding(self.mesh)
            bsh_a, bsh_b = self._batch_shardings
            stacked_a = NamedSharding(self.mesh, P(None, *bsh_a.spec))
            stacked_b = NamedSharding(self.mesh, P(None, *bsh_b.spec))
            raw = self._raw_step

            def multi(state, a_stack, b_stack):
                def body(st, ab):
                    st, aux = raw(st, *ab)
                    return st, aux
                state, auxs = jax.lax.scan(body, state, (a_stack, b_stack))
                return state, jax.tree.map(lambda x: x[-1], auxs)

            self._train_multi = jax.jit(
                multi,
                in_shardings=(self._state_sharding, stacked_a, stacked_b),
                out_shardings=(self._state_sharding, rep),
                donate_argnums=(0,),
            )
        return self._train_multi

    def _batches(self, num_steps: int, start_step: int = 0) -> Iterator[tuple]:
        """Batches for global steps start_step+1 .. start_step+num_steps.

        Content is a pure function of (seed, step) — the exact-resume
        contract (data.dataset.step_rng).  The grain pipeline's stream is
        deterministic per seed too; resume replays (skips) the first
        start_step batches to reach the same position."""
        if self.c.arch not in ("de", "ae"):
            for k in range(num_steps):
                yield self.codes.window_batch(self.c.batch_size,
                                              self.c.w_num,
                                              step=start_step + k + 1)
        elif self.c.input_pipeline == "grain":
            yield from self._grain_batches(num_steps, start_step)
        else:
            yield from self.bm.batches(num_steps, start_step=start_step)

    def _grain_batches(self, num_steps: int, start_step: int = 0
                       ) -> Iterator[tuple]:
        """Grain-backed batch stream (SURVEY §2 DP row: "sharded grain
        loader"): worker-process prefetch + per-host sharding — each host
        reads only its slice of the dataset (jax.process_index/count)."""
        import itertools

        from deepfluids_tpu.data.grain_loader import make_grain_loader

        if start_step:
            log.info("grain resume: sampler-state skip of %d batches "
                     "(decode-free)", start_step)
        field_key = "l" if self.c.data_type == "levelset" else "v"
        it = make_grain_loader(
            self.c.dataset_dir, self.c.batch_size, seed=self.c.seed,
            field_key=field_key,
            worker_count=min(self.c.num_worker, 4),
            shard_index=jax.process_index(),
            shard_count=jax.process_count(),
            indices=(self.bm.train_indices
                     if self.c.eval_holdout_scenes else None),
            skip_batches=start_step)
        yield from itertools.islice(it, num_steps)

    # ------------------------------------------------------------------
    # hang watchdog (SURVEY.md §5 "failure detection": a device call that
    # never completes would otherwise block the process forever)
    # ------------------------------------------------------------------

    def _wd_abort(self) -> None:  # overridable in tests
        os._exit(17)

    def _wd_start(self, timeout: float) -> None:
        """Start the daemon watcher.  The train loop arms ``_wd_deadline``
        before device work and clears it after; if the deadline passes
        while armed, the process aborts with exit code 17 so a supervisor
        (tools/supervise.py) can relaunch with ``--load_path`` (resume is
        exact — same batch sequence, bitwise-identical trajectory).

        The timeout lives on ``self`` (not in the closure) so a second
        train() call with a different ``watchdog_secs`` retunes the
        already-running watcher's cadence and message."""
        import threading

        self._wd_timeout = timeout
        if self._wd_thread is not None:
            return

        def watch():
            while True:
                time.sleep(min(5.0, self._wd_timeout / 4))
                d = self._wd_deadline
                if d is not None and time.monotonic() > d:
                    log.error("watchdog: no device-call progress in %.0fs "
                              "— aborting for supervised resume (exit 17)",
                              self._wd_timeout)
                    self._wd_deadline = None   # fire once
                    self._wd_abort()
                    return

        self._wd_thread = threading.Thread(target=watch, daemon=True,
                                           name="hang-watchdog")
        self._wd_thread.start()

    # ------------------------------------------------------------------
    # loop
    # ------------------------------------------------------------------

    def train(self, num_steps: int | None = None) -> dict:
        c = self.c
        num_steps = num_steps if num_steps is not None else c.max_step
        start_step = int(self.state.step)
        last_aux: dict[str, Any] = {}
        t0 = time.time()
        seen = 0
        profiling = False
        k = max(1, c.steps_per_call)
        if k > 1 and num_steps % k:
            # A partial last chunk would compile a second program shape
            # (minutes for the 3D backward pass); round up instead — the
            # cosine schedule clamps past max_step, so a few extra steps
            # are benign.
            rounded = ((num_steps + k - 1) // k) * k
            log.info("rounding num_steps %d -> %d (multiple of "
                     "steps_per_call=%d)", num_steps, rounded, k)
            num_steps = rounded
        use_cache = c.device_data_cache and c.arch in ("de", "ae")
        pair_mode = c.arch == "ae" and c.ae_pred_w > 0
        if use_cache:
            # Draw positions over the TRAIN subset; the full dataset sits
            # in the HBM cache, the index map keeps holdout frames out.
            # Pair mode (--ae_pred_w) draws t over frames with a
            # same-scene successor and gathers [t-rows ; (t+1)-rows].
            cache_pool = (self.bm.train_pair_indices if pair_mode
                          else self.bm.train_indices)
            cache_n = len(cache_pool)
        else:
            if c.arch in ("de", "ae") and _default_backend() != "cpu":
                # Streaming per-step batches to an accelerator ties every
                # step to a host->device copy of the batch.  The device
                # cache ships the dataset ONCE and sends only int32
                # indices per call.
                per_call = (self.bm.ds.get_normalized(0)[0].nbytes
                            * c.batch_size * k)
                log.warning(
                    "streaming batches to the %s backend (~%.1f MB/call "
                    "host->device): strongly prefer --device_data_cache "
                    "true (+ --cache_dtype float16 if HBM-tight) for any "
                    "long run", _default_backend(), per_call / 1e6)
            it = self._batches(num_steps, start_step=start_step)

        def crossed(period: int, step: int, take: int) -> bool:
            return step // period > (step - take) // period

        wd = float(c.watchdog_secs)
        if wd > 0:
            self._wd_start(wd)
        first_call = True

        try:
          with open(self._metrics_path, "a") as mf:
            while seen < num_steps:
                if wd > 0:
                    # First chunk compiles the program (minutes through slow
                    # runtimes) — give it a 10x allowance.
                    self._wd_deadline = time.monotonic() + (
                        wd * 10 if first_call else wd)
                take = min(k, num_steps - seen)
                if not use_cache:
                    pairs = [next(it) for _ in range(take)]
                seen += take
                step = start_step + seen
                if self._profile_range:
                    lo, hi = self._profile_range
                    if not profiling and step >= lo and step - take < hi:
                        pdir = c.profile_dir or os.path.join(
                            self.run_dir, "profile")
                        jax.profiler.start_trace(pdir)
                        profiling = True
                    elif profiling and step > hi:
                        jax.profiler.stop_trace()
                        profiling = False
                if use_cache:
                    from deepfluids_tpu.data.dataset import step_batch_indices
                    idx = cache_pool[np.stack([
                        step_batch_indices(c.seed, s, cache_n, c.batch_size)
                        for s in range(step - take + 1, step + 1)])]
                    if pair_mode:
                        idx = np.concatenate(
                            [idx, self.bm.ds.successor[idx]], axis=1)
                    cx, cy = self._load_device_cache()
                    self.state, aux = self._get_cached_multi()(
                        self.state, idx, cx, cy)
                elif take == 1:
                    self.state, aux = self._train_step(self.state, *pairs[0])
                else:
                    a = np.stack([p[0] for p in pairs])
                    b = np.stack([p[1] for p in pairs])
                    self.state, aux = self._get_train_multi()(
                        self.state, a, b)
                if crossed(c.log_step, step, take) or seen == num_steps:
                    aux = jax.device_get(aux)
                    last_aux = {k2: float(v) for k2, v in aux.items()}
                    rate = seen / (time.time() - t0)
                    rec = {"step": step, "steps_per_sec": round(rate, 3),
                           **last_aux}
                    mf.write(json.dumps(rec) + "\n")
                    mf.flush()
                    if self._tb is not None:
                        for k2, v in last_aux.items():
                            self._tb.add_scalar(k2, v, step)
                    log.info("step %d loss %.5f (%.2f it/s)", step,
                             last_aux["loss"], rate)
                # Host-only work below (sample renders, checkpoint
                # serialization) can legitimately take longer than
                # watchdog_secs — disarm first so the watchdog only times
                # DEVICE calls.
                self._wd_deadline = None
                if c.die_at_step and step >= c.die_at_step:
                    sentinel = os.path.join(self.run_dir, ".fault_injected")
                    if not os.path.exists(sentinel):
                        open(sentinel, "w").close()
                        log.error("fault injection: dying at step %d "
                                  "without checkpointing (exit 17)", step)
                        os._exit(17)  # hard kill — no checkpoint, no flush
                if crossed(c.test_step, step, take):
                    self._dump_samples(step)
                if crossed(c.save_step, step, take) or seen == num_steps:
                    self.save_checkpoint()
                first_call = False
        finally:
            # An exception escaping the loop (debug_nans, KeyboardInterrupt,
            # runtime error) must not leave the deadline armed — the daemon
            # would exit(17) a still-responsive process mid-handling.
            self._wd_deadline = None
        if profiling:
            jax.profiler.stop_trace()
        if self._tb is not None:
            self._tb.flush()
        return last_aux

    def evaluate(self, num_samples: int = 64, decode_fn=None,
                 profile_scenes: int = 1, pool: str = "auto") -> dict:
        """Model-quality metrics, repeatable per arch (the [B] parity
        metric applied to the MODEL, not the discretization):

          de: generated-vs-dataset field L2/rmse over a uniform frame sample;
          ae: reconstruction L2/rmse + latent param-supervision MSE;
          nn: full-trajectory latent rollout error vs ground-truth codes
              (z MAE / final-step MAE); with ``decode_fn`` (z -> field,
              e.g. a trained AE's Trainer.decode) also field-space rmse.

        ``pool``: "auto" (holdout scenes when --eval_holdout_scenes is set,
        else the full dataset) or "train" (strictly the training subset —
        the generalization-gap counterpart; with a holdout configured this
        EXCLUDES the held-out scenes, unlike the old eval_holdout_scenes=0
        override which contaminated "train-pool" numbers with them).
        """
        from deepfluids_tpu.utils.parity import normalized_l2

        if self.c.arch == "nn":
            return self._evaluate_nn(num_samples, decode_fn, profile_scenes,
                                     pool)
        # With --eval_holdout_scenes the eval pool is scenes the training
        # draws NEVER see (a true held-out number); otherwise it is a
        # uniform sample of the training set, and says so.
        holdout = bool(self.c.eval_holdout_scenes) and pool != "train"
        pool = (self.bm.train_indices if pool == "train"
                else self.bm.eval_indices if holdout
                else np.arange(len(self.bm.ds)))
        n = len(pool)
        idx = pool[np.linspace(0, n - 1, min(num_samples, n)).astype(int)]
        xs, ys = zip(*[self.bm.ds.get_normalized(int(i)) for i in idx])
        xs = np.stack(xs)
        out = {"num_samples": int(len(idx)), "holdout": holdout}

        def chunked(fn, arr):
            # Fixed-size (padded) chunks: ONE compile shape no matter what
            # num_samples is, and bounded device memory for 3D fields.
            bs = max(1, self.c.test_batch_size)
            pad = (-len(arr)) % bs
            a = (np.concatenate([arr, np.repeat(arr[-1:], pad, 0)])
                 if pad else arr)
            o = np.concatenate([fn(a[i:i + bs])
                                for i in range(0, len(a), bs)])
            return o[:len(arr)]

        if self.c.arch == "de":
            gen = chunked(self.generate, np.stack(ys))
        else:  # ae: reconstruction quality + latent supervision error
            gen = chunked(self.reconstruct, xs)
            z = chunked(self.encode, xs)
            p = np.stack(ys)[:, :self.num_param]
            out["param_mse"] = float(
                np.mean((z[:, :self.num_param] - p) ** 2))
        l2s = np.array([normalized_l2(g, x) for g, x in zip(gen, xs)])
        # Per-frame normalized L2 is harsh on near-empty frames (tiny
        # ||x|| denominators); rmse is in normalized field units and
        # reflects perceptual quality better.
        out.update({"l2_mean": float(l2s.mean()),
                    "l2_median": float(np.median(l2s)),
                    "l2_max": float(l2s.max()),
                    "rmse": float(np.sqrt(np.mean((gen - xs) ** 2)))})
        # Per-scene medians: small holdout pools (2-5 scenes) hide their
        # spread behind one aggregate — e.g. cfg5's r4 holdout mean was
        # skewed 1.7x by its hardest corner scene (r4 VERDICT weak #4).
        keys = self.bm.ds.scene_keys
        by_scene: dict[str, list[float]] = {}
        for i, l2 in zip(idx, l2s):
            by_scene.setdefault(keys[int(i)], []).append(float(l2))
        out["per_scene_l2_median"] = {
            k: round(float(np.median(v)), 4)
            for k, v in sorted(by_scene.items())}
        return out

    def _ae_trainer(self):
        """Build (once) the restored AE Trainer behind ``--ae_load_path``
        (the frozen decoder for nn field-space eval/training)."""
        if not self.c.ae_load_path:
            return None
        if getattr(self, "_eval_ae", None) is None:
            from deepfluids_tpu.config import load_config

            ae_cfg = load_config(self.c.ae_load_path)
            ae = Trainer(ae_cfg, run_dir=self.c.ae_load_path,
                         save_cfg=False)
            ae.restore_checkpoint()
            self._eval_ae = ae
        return self._eval_ae

    def _ae_decode_fn(self):
        """Latent->field decoder from ``--ae_load_path``.

        Gives arch-"nn" evals their field-space numbers without the caller
        hand-constructing an AE (round-3 VERDICT weak #5 / next #8): the
        flag every nn test invocation already carries is enough."""
        ae = self._ae_trainer()
        return None if ae is None else ae.decode

    def _evaluate_nn(self, num_samples: int, decode_fn=None,
                     profile_scenes: int = 1, pool: str = "auto") -> dict:
        """Latent-rollout fidelity: advance each sampled scene's code from
        z_0 over its FULL trajectory (not just the training window w) and
        compare to the AE-encoded ground truth.  With
        --eval_holdout_scenes only the held-out scenes (never seen by the
        integrator's window sampler) are rolled out.

        With a decoder (explicit ``decode_fn`` or ``--ae_load_path``) also
        reports field space: ``field_rmse`` (decoded pred vs decoded truth)
        and the ``rollout_field_l2`` drift profile vs the SIMULATED frames
        — computed by the same infer.score code path as
        tools/rollout_eval.py (one metric, one implementation)."""
        holdout = bool(self.c.eval_holdout_scenes) and pool != "train"
        pool = (self.codes.train_scene_indices if pool == "train"
                else self.codes.eval_scene_indices if holdout
                else np.arange(self.codes.num_scenes))
        idx = pool[np.linspace(0, len(pool) - 1,
                               min(num_samples, len(pool))).astype(int)]
        # Scenes may have unequal lengths (CodeDataset supports that);
        # evaluate over the shortest common trajectory.
        t_min = min(self.codes.z[i].shape[0] for i in idx)
        z_true = np.stack([self.codes.z[i][:t_min] for i in idx], 1)
        p_seq = np.stack([self.codes.p[i][:t_min] for i in idx], 1)
        # --nn_history H>1 seeds the rollout with the first H true codes
        # (a second-order integrator needs two+ initial states, like any
        # multi-step scheme; at test time these come from encoding the
        # first H frames).
        H = self.c.nn_history
        z0 = z_true[:H] if H > 1 else z_true[0]
        apply = lambda p, zf, dp: self.state.apply_fn({"params": p}, zf, dp)
        traj = np.asarray(self._jitted("rollout_eval", lambda pr, z, ps:
                                       rollout(apply, pr, z, ps,
                                               self.num_param, history=H))(
            self.state.params, jnp.asarray(z0), jnp.asarray(p_seq)))
        err = np.abs(traj - z_true)
        out = {"num_samples": int(len(idx)), "holdout": holdout,
               "z_mae": float(err.mean()),
               "z_mae_final": float(err[-1].mean()),
               "rollout_steps": int(traj.shape[0])}
        if decode_fn is None:
            decode_fn = self._ae_decode_fn()
        if decode_fn is not None:
            # Field-space: decode a uniform subsample of rollout steps.
            t_idx = np.linspace(0, traj.shape[0] - 1, 8).astype(int)
            f_pred = decode_fn(traj[t_idx].reshape(-1, traj.shape[-1]))
            f_true = decode_fn(z_true[t_idx].reshape(-1, traj.shape[-1]))
            out["field_rmse"] = float(
                np.sqrt(np.mean((f_pred - f_true) ** 2)))
            # Drift vs the SIMULATED trajectory (the number that matters
            # for the paper's headline capability), same implementation
            # as tools/rollout_eval.py.  Batch position 0 of `traj` is
            # codes scene idx[0]; decode its full rollout in fixed-size
            # chunks (one compile shape) and compare in RAW units.
            from deepfluids_tpu.infer.score import score_rollout_vs_sim

            fk = ("l" if self.manifest.data_type == "levelset" else "v")
            bs = max(1, self.c.test_batch_size)

            def decode_profile(zs, scene):      # [T, z] -> drift profile
                pad = (-len(zs)) % bs
                zp = (np.concatenate([zs, np.repeat(zs[-1:], pad, 0)])
                      if pad else zs)
                dec = np.concatenate(
                    [decode_fn(zp[i:i + bs])
                     for i in range(0, len(zp), bs)])[:len(zs)]
                return score_rollout_vs_sim(
                    self.manifest.denormalize_field(dec),
                    self.c.dataset_dir, scene, field_key=fk)

            # Profile up to `profile_scenes` rolled-out scenes (the
            # default 1 keeps routine evals cheap; the final record
            # should aggregate over the whole holdout pool).  Each
            # scene also gets its AE-only floor — decoding the
            # ground-truth codes separates how much of the rollout
            # error is the integrator drifting vs the AE's own
            # reconstruction limit at each horizon.  The
            # FileNotFoundError guard is PER SCENE: a code set whose
            # later scenes lack raw frames on disk must not discard the
            # profiles already computed (r4 ADVICE).
            profs, floors = [], []
            for k in range(min(max(1, profile_scenes), len(idx))):
                scene = self.codes.scenes[int(idx[k])]
                try:
                    prof = decode_profile(traj[:, k], scene)
                    floor = decode_profile(z_true[:, k], scene)
                except FileNotFoundError:
                    continue  # scene without raw frames: latent-only
                profs.append(prof)
                floors.append(floor)
            if profs:
                out["rollout_field_l2"] = profs[0]
                out["ae_floor_field_l2"] = floors[0]
                if len(profs) > 1:
                    out["rollout_field_l2_scenes"] = profs
                    out["ae_floor_field_l2_scenes"] = floors
                    agg = lambda ps, key: float(np.median(
                        [p[key] for p in ps]))
                    out["rollout_field_l2_agg"] = {
                        "num_scenes": len(profs),
                        "l2_median": agg(profs, "l2_median"),
                        "l2_firstq_median": agg(profs, "l2_firstq_median"),
                        "l2_lastq_median": agg(profs, "l2_lastq_median"),
                        "floor_l2_median": agg(floors, "l2_median"),
                        "floor_l2_firstq_median": agg(
                            floors, "l2_firstq_median"),
                        "floor_l2_lastq_median": agg(
                            floors, "l2_lastq_median"),
                    }
        return out

    def maybe_resume(self) -> int:
        """Auto-resume from the latest checkpoint if one exists (SURVEY §5
        checkpoint/resume: keep the --load_path UX, recover after crashes).

        Returns the restored step, or 0 when starting fresh."""
        try:
            return self.restore_checkpoint()
        except FileNotFoundError:
            return 0

    # ------------------------------------------------------------------
    # checkpoints (train/checkpoint.py: one .npz per step, newest 3 kept)
    # ------------------------------------------------------------------

    @property
    def ckpt_dir(self) -> str:
        return os.path.abspath(os.path.join(self.run_dir, "checkpoint"))

    def _ckpt_tree(self) -> dict:
        return {"params": self.state.params,
                "opt_state": self.state.opt_state,
                "step": self.state.step}

    def save_checkpoint(self) -> None:
        """Write the current (params, opt state, step) synchronously.

        SURVEY §5's checkpoint contract is (params, opt state, step, RNG).
        The RNG needs no stored state here: the data order is a pure
        function of (config.seed, global step) — see data.dataset.step_rng
        — so restoring ``step`` restores the exact batch stream and a
        resumed run is bitwise-identical to an uninterrupted one
        (pinned by tests/test_train.py exact-resume test)."""
        checkpoint.save(self.ckpt_dir, int(self.state.step),
                        jax.device_get(self._ckpt_tree()))

    def restore_checkpoint(self, step: int | None = None) -> int:
        """Restore latest (or given) step; returns the restored step."""
        if step is None:
            saved = checkpoint.steps(self.ckpt_dir)
            if not saved:
                raise FileNotFoundError(
                    f"no checkpoint under {self.ckpt_dir}")
            step = saved[-1]
        try:
            restored = checkpoint.restore(self.ckpt_dir, step,
                                          self._ckpt_tree())
            self.state = self.state.replace(
                params=restored["params"], opt_state=restored["opt_state"],
                step=restored["step"])
        except ValueError as e:
            # Optimizer hyper-structure changed since the checkpoint was
            # written (e.g. resuming with --grad_clip after an unclipped
            # run wraps the optax chain, so the opt_state pytree no longer
            # matches the on-disk one).  Params are what carry the run:
            # restore params + step and re-init the optimizer fresh.
            # Without this fallback a supervised run loops restore-crash
            # forever.
            log.warning("full TrainState restore failed (%s); falling back "
                        "to params-only restore with FRESH Adam moments "
                        "(mu/nu reset; LR-schedule position is preserved by "
                        "seeding the optimizer step counts from the restored "
                        "step)", str(e).splitlines()[0])
            flat = checkpoint.load_flat(self.ckpt_dir, step)
            params = jax.tree.map(
                lambda t, a: jnp.asarray(a, dtype=t.dtype), self.state.params,
                checkpoint.unflatten(flat, self.state.params, "params/"))
            restored_step = int(flat["step"])
            # tx.init gives count=0 everywhere, and the cosine LR schedule
            # is driven by the optimizer's count (optax.adam(learning_rate=
            # schedule)), NOT by state.step — so without this a late-run
            # fallback resume would silently restart the schedule at lr_max
            # and train the remaining steps at ~100x the intended LR.
            # Seed every `count` leaf (ScaleByAdamState / ScaleByScheduleState)
            # with the restored step instead.
            def _seed_count(path, leaf):
                if path and getattr(path[-1], "name", None) == "count":
                    return jnp.asarray(restored_step, dtype=leaf.dtype)
                return leaf
            opt_state = jax.tree_util.tree_map_with_path(
                _seed_count, self.state.tx.init(params))
            self.state = self.state.replace(
                params=params, opt_state=opt_state, step=restored_step)
        self.state = jax.device_put(self.state, self._state_sharding)
        return int(step)

    # ------------------------------------------------------------------
    # sample dumps (reference test_step image grids, SURVEY §3.1)
    # ------------------------------------------------------------------

    def _dump_samples(self, step: int) -> None:
        try:
            c = self.c
            out = os.path.join(self.run_dir, "sample", f"{step:07d}.png")
            if c.arch == "de":
                n = 8
                p = np.stack([
                    self.manifest.normalize_params(
                        [np.interp(i, [0, n - 1], r)
                         for r in self.manifest.param_ranges])
                    for i in range(n)])
                fields = self.generate(p)
                mode = ("levelset" if self.manifest.num_channels == 1
                        else "vorticity")
                save_image_grid(out, list(fields), mode=mode)
            elif c.arch == "ae":
                # Own RNG stream: the prefetch worker may concurrently call
                # sample_batch with the training Generator (not thread-safe).
                x, _ = self.bm.sample_batch(rng=self._dump_rng)
                x = x[:4]
                recon = self.reconstruct(x)
                mode = ("levelset" if self.manifest.num_channels == 1
                        else "vorticity")
                save_image_grid(out, list(x) + list(recon), ncol=4,
                                mode=mode)
        except Exception as e:  # sample dumps must never kill training
            log.warning("sample dump failed at step %d: %s", step, e)

    # ------------------------------------------------------------------
    # forward passes (used by sample dumps, tests, and infer/)
    # ------------------------------------------------------------------

    # All four are jitted once per input shape — eager apply would dispatch
    # op-by-op and make the AE encode pass / rollout decode slow.

    def _jitted(self, name, fn):
        cache = self.__dict__.setdefault("_jit_cache", {})
        if name not in cache:
            cache[name] = jax.jit(fn)
        return cache[name]

    def generate(self, p_norm: np.ndarray) -> np.ndarray:
        """Params [B, P] (normalized) -> fields [B, *res, C] (normalized)."""
        def f(params, p):
            out = self.state.apply_fn({"params": params}, p)
            return losses.apply_curl(out) if self.curl_active else out
        return np.asarray(self._jitted("gen", f)(
            self.state.params, jnp.asarray(p_norm)))

    def reconstruct(self, x: np.ndarray) -> np.ndarray:
        def f(params, x):
            out, _ = self.state.apply_fn({"params": params}, x)
            return losses.apply_curl(out) if self.curl_active else out
        return np.asarray(self._jitted("recon", f)(
            self.state.params, jnp.asarray(x)))

    def encode(self, x: np.ndarray) -> np.ndarray:
        def f(params, x):
            return self.model.apply({"params": params}, x,
                                    method=self.model.encode)
        return np.asarray(self._jitted("enc", f)(
            self.state.params, jnp.asarray(x)))

    def decode(self, z: np.ndarray) -> np.ndarray:
        def f(params, z):
            out = self.model.apply({"params": params}, z,
                                   method=self.model.decode)
            return losses.apply_curl(out) if self.curl_active else out
        return np.asarray(self._jitted("dec", f)(
            self.state.params, jnp.asarray(z)))
