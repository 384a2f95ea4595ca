"""Supervisor kill/resume test (SURVEY.md §5 failure detection/recovery).

A supervised training run is KILLED mid-run by the fault injector
(--die_at_step: exit 17 with no checkpoint flush — the watchdog's code
path), relaunched by tools/supervise.py with --load_path, and must finish
with params BITWISE-identical to an uninterrupted run (exact resume: batch
order is a pure function of (seed, step)).
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from deepfluids_tpu.datagen import scenes
from deepfluids_tpu.train.trainer import Trainer

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    root = tmp_path_factory.mktemp("sup")
    scenes.smoke_pos21_size5(str(root / "data"), num_pos=2, num_size=1,
                             num_frames=3, height=32, width=32, name="sup")
    return root


def _flags(root, tag, **extra):
    base = dict(arch="de", filters=8, num_conv=1, batch_size=4,
                data_dir=str(root / "data"), dataset="sup",
                log_dir=str(root / "logs"), tag=tag, max_step=10,
                lr_max=2e-3, lr_min=1e-4, log_step=5, test_step=10_000,
                save_step=5, compute_dtype="float32", num_worker=2, seed=0)
    base.update(extra)
    return [f"--{k}={v}" for k, v in base.items()]


def test_supervised_run_survives_kill_and_matches(tiny):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)  # children don't need 8 virtual devices

    # Supervised run: dies at step 6 (after the step-5 checkpoint window),
    # supervise.py relaunches with --load_path, child completes to step 10.
    out = subprocess.run(
        [sys.executable, os.path.join(_REPO, "tools", "supervise.py"),
         "--max_restarts", "2", "--",
         *_flags(tiny, "killed", die_at_step=6)],
        capture_output=True, text=True, timeout=600, cwd=_REPO, env=env)
    assert out.returncode == 0, f"supervise failed:\n{out.stdout[-2000:]}"
    assert "relaunch #1" in out.stdout, out.stdout
    run_dir = str(tiny / "logs" / "sup_killed")
    assert os.path.exists(os.path.join(run_dir, ".fault_injected"))

    # Uninterrupted oracle: same subprocess environment (1 CPU device) so
    # gradient-reduction order is identical and the comparison can be
    # BITWISE, not approximate.
    out = subprocess.run(
        [sys.executable, "-m", "deepfluids_tpu.main",
         *_flags(tiny, "oracle")],
        capture_output=True, text=True, timeout=600, cwd=_REPO, env=env)
    assert out.returncode == 0, f"oracle run failed:\n{out.stderr[-2000:]}"
    oracle_dir = str(tiny / "logs" / "sup_oracle")

    # Restore both checkpoints (value comparison — the parent's 8-device
    # mesh only affects placement) and compare bitwise.
    from deepfluids_tpu.config import load_config

    def final_params(d):
        t = Trainer(load_config(d), run_dir=d, save_cfg=False)
        assert t.restore_checkpoint() == 10
        return jax.device_get(t.state.params)

    jax.tree.map(np.testing.assert_array_equal,
                 final_params(oracle_dir), final_params(run_dir))

    # The supervised run logged a metrics stream reaching step 10.
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        steps = [json.loads(line)["step"] for line in f]
    assert max(steps) == 10


def test_outage_retries_do_not_consume_restart_budget(tiny):
    # A child that dies WITHOUT making progress (here: nonexistent
    # dataset, standing in for a device that fails at backend init) must
    # be retried with backoff WITHOUT touching --max_restarts, then give
    # up once the continuous no-progress window exceeds --max_outage_secs.
    # A long outage would otherwise burn the whole budget.
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)

    out = subprocess.run(
        [sys.executable, os.path.join(_REPO, "tools", "supervise.py"),
         "--max_restarts", "0", "--restart_on", "any",
         "--backoff", "0.1", "--max_outage_secs", "20", "--",
         *_flags(tiny, "outage", dataset="does_not_exist")],
        capture_output=True, text=True, timeout=600, cwd=_REPO, env=env)
    assert out.returncode != 0
    # Retried at least twice despite a zero restart budget...
    assert "outage retry #2" in out.stdout, out.stdout
    assert "budget intact, 0/0 restarts used" in out.stdout, out.stdout
    # ...and gave up on the outage window, not the budget.
    assert "no progress for" in out.stdout, out.stdout
