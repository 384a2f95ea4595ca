"""CLI entry: ``python -m deepfluids_tpu.main --flags…``.

Reference parity target: ``main.py`` of byungsook/deep-fluids (SURVEY.md §2
"CLI entry", §3.1 [M]): seed RNGs, build config + run dir, construct the
data pipeline and Trainer, dispatch train() vs test() on ``--is_train``.
"""

from __future__ import annotations

import os
import sys

import jax.numpy as jnp
import numpy as np

from deepfluids_tpu.config import Config, get_config
from deepfluids_tpu.utils import get_logger

log = get_logger()


def main(config: Config) -> dict:
    np.random.seed(config.seed)
    from deepfluids_tpu.parallel.mesh import init_distributed
    from deepfluids_tpu.train.trainer import Trainer
    from deepfluids_tpu.utils.compile_cache import enable_compile_cache

    if init_distributed():
        log.info("multi-host initialized")
    enable_compile_cache()

    if not config.is_train and config.load_path:
        # Rebuild the TRAINED architecture from the run's own params.json
        # (explicit CLI flags still override); never clobber the run's
        # saved config with test-invocation flags.
        from deepfluids_tpu.config import merge_test_config

        config = merge_test_config(config, config.load_path)
        trainer = Trainer(config, run_dir=config.load_path, save_cfg=False)
    else:
        trainer = Trainer(config)
    if config.is_train:
        # Resume semantics (SURVEY §5): --load_path on a train run restores
        # the latest checkpoint and continues toward max_step.
        done = trainer.maybe_resume() if config.load_path else 0
        if done:
            log.info("resuming from step %d", done)
        if done >= config.max_step:
            log.info("already at max_step %d; nothing to do",
                     config.max_step)
            return {"step": done}
        result = trainer.train(num_steps=config.max_step - done)
        log.info("training done: %s", result)
        return result
    # --- test / inference (SURVEY §3.2 / §3.4) ---
    if not config.load_path:
        # Without a checkpoint the sweep would silently write plausible-
        # looking garbage from randomly initialized weights (for arch nn
        # the zero-init head even yields a frozen identity rollout).
        raise SystemExit("--is_train=false needs --load_path "
                         "(a trained run directory)")
    step = trainer.restore_checkpoint()
    log.info("restored checkpoint step %d from %s", step,
             trainer.ckpt_dir)
    out_dir = os.path.join(trainer.run_dir, "test")
    if config.arch == "de":
        from deepfluids_tpu.infer import run_test_sweep

        def apply_fn(params, p_norm):
            # Weights come in as an explicit jit argument — closing over
            # trainer.state.params would bake them into the compiled
            # program as constants.
            from deepfluids_tpu.train import losses

            out = trainer.state.apply_fn({"params": params}, p_norm)
            return losses.apply_curl(out) if trainer.curl_active else out

        # Sweep grid: --test_counts, else the dataset's own generation grid
        # (the reference swept its full 21x5 grid, SURVEY §3.2), else 5/axis.
        if config.test_counts:
            counts = [int(s) for s in config.test_counts.split(",")]
        elif trainer.manifest.param_counts:
            counts = list(trainer.manifest.param_counts)
        else:
            counts = [5] * (trainer.manifest.num_param - 1)
        result = run_test_sweep(
            apply_fn, trainer.manifest, out_dir, counts=counts,
            num_frames=config.test_frames or None,
            batch_size=config.test_batch_size, save_png_every=20,
            params=trainer.state.params)
        # Quality metrics ride along with every sweep (repeatable eval,
        # not a notebook fact): generated-vs-dataset L2/rmse.
        result["eval"] = trainer.evaluate(num_samples=128)
        log.info("sweep done: %s", result)
        return result
    if config.arch == "ae":
        from deepfluids_tpu.infer import encode_dataset

        code_dir = encode_dataset(trainer.encode, config.dataset_dir,
                                  config.z_num,
                                  batch_size=config.test_batch_size,
                                  suffix=config.code_suffix)
        log.info("encoded dataset -> %s", code_dir)
        return {"code_dir": code_dir}
    # --- arch nn: latent rollout + AE decode (SURVEY §3.4 test path) ---
    if not config.ae_load_path:
        raise SystemExit("arch 'nn' test needs --ae_load_path "
                         "(the trained autoencoder's run dir)")
    from deepfluids_tpu.config import load_config
    from deepfluids_tpu.infer import rollout_trajectory
    from deepfluids_tpu.utils import save_gif

    # Rebuild the AE from ITS OWN saved config (filters/z_num/etc. may
    # differ from this invocation's flags) and don't clobber its params.json.
    ae_config = load_config(config.ae_load_path)
    ae = Trainer(ae_config, run_dir=config.ae_load_path, save_cfg=False)
    ae.restore_checkpoint()

    # Roll the first code sequence forward from its initial latent.
    z_seq = trainer.codes.z[0]                      # [T, z_num]
    p_raw_first = trainer.codes.manifest.denormalize_params(
        trainer.codes.p[0])                         # [T, P] raw
    T = config.test_frames or z_seq.shape[0]
    apply_fn = lambda p, zf, dp: trainer.state.apply_fn({"params": p},
                                                        zf, dp)
    # --nn_history H>1: seed with the first H encoded codes ([H, 1, z] —
    # a second-order integrator needs H initial states).
    H = trainer.c.nn_history
    z_start = z_seq[:H][:, None] if H > 1 else z_seq[:1]
    z_traj, fields = rollout_trajectory(
        apply_fn, trainer.state.params,
        lambda z: jnp.asarray(ae.decode(np.asarray(z))),
        z_start, p_raw_first[:T], trainer.manifest,
        decode_batch=config.test_batch_size)
    np.savez_compressed(os.path.join(out_dir, "rollout.npz"),
                        z=z_traj, x=fields[:, 0])
    mode = ("levelset" if trainer.manifest.num_channels == 1
            else "vorticity")
    save_gif(os.path.join(out_dir, "rollout.gif"),
             [f for f in fields[:, 0]], mode)
    log.info("rollout of %d steps -> %s", T, out_dir)
    result = {"rollout_steps": int(T), "out_dir": out_dir}
    # Field-space drift profile vs the simulated trajectory — the same
    # infer.score code path Trainer.evaluate and tools/rollout_eval.py use
    # (one metric, one implementation; VERDICT r3 next #8).
    from deepfluids_tpu.infer.score import score_rollout_vs_sim

    try:
        result["rollout_field_l2"] = score_rollout_vs_sim(
            fields[:, 0], config.dataset_dir, trainer.codes.scenes[0],
            field_key="l" if trainer.manifest.data_type == "levelset"
            else "v")
        log.info("rollout drift vs sim: %s", result["rollout_field_l2"])
    except FileNotFoundError:
        pass  # codes without raw frames on disk: latent-only artifacts
    return result


if __name__ == "__main__":
    main(get_config(sys.argv[1:]))
