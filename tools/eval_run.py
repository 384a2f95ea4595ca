"""Evaluate a trained run directory and append the result to BENCHMARKS.jsonl.

Rebuilds the Trainer from the run's own persisted params.json, restores the
latest checkpoint, and runs ``Trainer.evaluate()`` (per-arch quality metrics:
de = generated-vs-dataset field L2/rmse, ae = reconstruction + param MSE,
nn = latent rollout error).  One process per run.

Usage: python tools/eval_run.py <run_dir> [num_samples] [note]
           [--pool train] [--profile_scenes N]

``--profile_scenes N`` (arch nn): decode + score the rollout drift
profile (and its AE floor) for the first N evaluated scenes instead of
just one, with medians-of-medians aggregated under
``rollout_field_l2_agg``.

``--pool train`` scores the run on its TRAINING pool (the
generalization-gap diagnostic: train-vs-holdout on the same checkpoint).
The run's --eval_holdout_scenes stays in force: held-out scenes are
EXCLUDED from the pool (the old implementation zeroed the holdout, which
contaminated "train-pool" numbers with the holdout scenes — r4 ADVICE).
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser(
        description="Evaluate a run dir; append record to BENCHMARKS.jsonl")
    ap.add_argument("run_dir")
    ap.add_argument("num_samples", nargs="?", type=int, default=128)
    ap.add_argument("note", nargs="?", default="")
    ap.add_argument("--pool", choices=["auto", "train"], default="auto",
                    help="'train' scores the training subset (holdout "
                         "scenes excluded); default is the run's holdout "
                         "pool when configured, else the full dataset")
    ap.add_argument("--profile_scenes", type=int, default=1)
    a = ap.parse_args()

    import jax

    from deepfluids_tpu.config import load_config
    from deepfluids_tpu.train.trainer import Trainer

    cfg = load_config(a.run_dir)
    t = Trainer(cfg, run_dir=a.run_dir, save_cfg=False)
    step = t.restore_checkpoint()
    r = t.evaluate(num_samples=a.num_samples,
                   profile_scenes=a.profile_scenes, pool=a.pool)
    rec = {"metric": f"eval_{cfg.arch}", "run": os.path.basename(a.run_dir),
           "step": int(step), **r, "note": a.note,
           "backend": jax.default_backend(),
           "ts": time.strftime("%Y-%m-%d %H:%M:%S")}
    with open(os.path.join(ROOT, "BENCHMARKS.jsonl"), "a") as f:
        f.write(json.dumps(rec) + "\n")
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
