"""Checks that need an NVIDIA GPU: the same functions chip_smoke.py runs.

Run on a machine with the card:  python -m pytest tests/test_gpu.py -m gpu

The test process itself stays on the CPU (conftest.py pins it there); each
check runs in one child process that owns the card.  Elsewhere every test
here skips.
"""

import os
import shutil
import subprocess
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def gpu_env():
    smi = shutil.which("nvidia-smi")
    if smi is None or subprocess.run([smi, "-L"], capture_output=True,
                                     timeout=60).returncode != 0:
        pytest.skip("needs an NVIDIA GPU")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    return env


def _run(env, code):
    out = subprocess.run([sys.executable, "-c", "import chip_smoke as cs; "
                          + code], capture_output=True, text=True,
                         timeout=1200, cwd=_REPO, env=env)
    assert out.returncode == 0, (out.stdout[-3000:], out.stderr[-3000:])
    assert "FAIL" not in out.stdout
    return out.stdout


@pytest.mark.gpu
def test_stencils_match_cpu_oracle(gpu_env):
    _run(gpu_env, "cs.check_stencils(cs.REAL)")


@pytest.mark.gpu
def test_goldens_on_card(gpu_env):
    _run(gpu_env, "cs.check_goldens()")


@pytest.mark.gpu
def test_chip_smoke_one_card(gpu_env):
    lines = _run(gpu_env, "import sys; sys.exit(cs.main([]))").splitlines()
    assert lines[-1].startswith('{"ok": true, "device": {"platform": "gpu"')
