"""Multi-host execution test (SURVEY.md §5 "Distributed comm backend").

Spawns TWO real OS processes, each with 4 virtual CPU devices, wired by
``jax.distributed.initialize`` through ``parallel.mesh.init_distributed``
(gloo collectives standing in for the network between hosts), runs data-parallel train steps of
the real model stack over the 2x4-device GLOBAL mesh, and asserts the
per-step losses (a) agree across processes and (b) equal a single-process
run on the same 8 devices, batches, and init.

The launch recipe itself is ``tools/launch_multihost.py`` — this test runs
it exactly as the README documents.
"""

import os
import subprocess
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_two_process_dp_matches_single_process():
    out = subprocess.run(
        [sys.executable, os.path.join(_REPO, "tools", "launch_multihost.py"),
         "--num_processes", "2", "--devices_per_process", "4",
         "--port", "12961"],
        capture_output=True, text=True, timeout=600, cwd=_REPO,
        env={k: v for k, v in os.environ.items() if k != "XLA_FLAGS"},
    )
    assert out.returncode == 0, f"launcher failed:\n{out.stdout}\n{out.stderr}"
    assert "single-process oracle agrees" in out.stdout, out.stdout
