"""What the program needs from its installation and environment: the
compile-cache location, the main path with only jax/optax/numpy present,
and chip_smoke.py's refusal to run without a GPU."""

import os
import subprocess
import sys
import textwrap

import jax
import pytest

from deepfluids_tpu.utils import compile_cache

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cpu_env(**kw):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **kw)
    env.pop("XLA_FLAGS", None)
    return env


class TestCompileCache:
    def test_fixed_repo_path_without_env(self, monkeypatch):
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        old = jax.config.jax_compilation_cache_dir
        try:
            d = compile_cache.enable_compile_cache()
            assert d == os.path.join(_REPO, ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == d
        finally:
            jax.config.update("jax_compilation_cache_dir", old)

    def test_env_var_is_left_to_jax(self, monkeypatch, tmp_path):
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        old = jax.config.jax_compilation_cache_dir
        assert compile_cache.enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == old   # nothing set


_BLOCKED_MAIN = textwrap.dedent("""
    import importlib.abc, os, sys
    BLOCKED = {"flax", "orbax", "PIL", "imageio"}

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError("blocked: " + name)

    sys.meta_path.insert(0, Block())
    from deepfluids_tpu.config import get_config
    from deepfluids_tpu.datagen import scenes
    from deepfluids_tpu.main import main

    data, logs = sys.argv[1], sys.argv[2]
    scenes.smoke_pos21_size5(data, num_pos=2, num_size=2, num_frames=4,
                             height=32, width=32, name="tiny")
    res = main(get_config([
        "--arch", "de", "--data_dir", data, "--dataset", "tiny",
        "--log_dir", logs, "--tag", "b", "--filters", "8", "--num_conv", "1",
        "--batch_size", "8", "--max_step", "3", "--save_step", "3",
        "--compute_dtype", "bfloat16", "--device_data_cache", "true",
        "--num_data_shards", "1", "--num_worker", "2"]))
    run = os.path.join(logs, "tiny_b")
    ckpt = sorted(os.listdir(os.path.join(run, "checkpoint")))
    sweep = main(get_config(["--is_train", "false", "--load_path", run,
                             "--test_frames", "4", "--test_batch_size", "8"]))
    out = os.listdir(sweep["out_dir"])
    print("RESULT", res["loss"], ckpt, sweep["num_fields"],
          sum(n.endswith(".png") for n in out),
          sum(n.endswith(".gif") for n in out),
          sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED))
""")


def test_main_path_without_flax_orbax_pil_imageio(tmp_path):
    """cfg2-style train from the device cache, checkpoint, restore and
    sweep with artifacts, with the four packages unimportable."""
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED_MAIN, str(tmp_path / "data"),
         str(tmp_path / "logs")],
        capture_output=True, text=True, timeout=600, cwd=_REPO,
        env=_cpu_env(JAX_COMPILATION_CACHE_DIR=str(tmp_path / "cache")))
    assert out.returncode == 0, out.stderr[-3000:]
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("RESULT")]
    assert line, out.stdout[-2000:]
    _, loss, *rest = line[0].split(" ", 2)
    assert float(loss) == float(loss)                    # finite, not NaN
    assert "['step_00000003.npz'] 16 " in rest[0]         # 2x2 scenes x 4
    assert rest[0].endswith("[]")                         # nothing blocked


def test_chip_smoke_refuses_cpu():
    out = subprocess.run([sys.executable, "chip_smoke.py"],
                         capture_output=True, text=True, timeout=300,
                         cwd=_REPO, env=_cpu_env())
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "needs a GPU" in out.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo."""
    with open(os.path.join(_REPO, "chip_smoke.py")) as f:
        (tmp_path / "chip_smoke.py").write_text(f.read())
    env = _cpu_env()
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "chip_smoke.py"],
                         capture_output=True, text=True, timeout=300,
                         cwd=tmp_path, env=env)
    assert out.returncode != 0 and '"ok"' not in out.stdout


@pytest.mark.parametrize("flag", ["--chips", "--bogus"])
def test_chip_smoke_rejects_bad_arguments(flag):
    out = subprocess.run([sys.executable, "chip_smoke.py", flag, "3"],
                         capture_output=True, text=True, timeout=300,
                         cwd=_REPO, env=_cpu_env())
    assert out.returncode == 2 and '"ok"' not in out.stdout
