"""Multi-host launch recipe — executed, not hypothetical.

SURVEY.md §2 "Comm backend" / §5 "Distributed comm backend" name
`jax.distributed.initialize` for multi-host runs.  This script is the
runnable proof on one machine: it spawns N worker PROCESSES, each owning
``--devices_per_process`` virtual CPU devices, wires them together through
``deepfluids_tpu.parallel.mesh.init_distributed()`` (coordinator on
localhost; gloo CPU collectives standing in for the network between
hosts), and runs a
data-parallel training step of the real model stack (GeneratorBE +
curl/jacobian loss + Adam) over the GLOBAL mesh — gradients all-reduced
across process boundaries.

Every worker prints its loss after each step; the launcher asserts all
processes agree AND (``--check_single``) that the 2-process result equals a
single-process run on the same total device count, batch, and init.

Usage (the recipe; tests/test_multihost.py runs exactly this)::

    python tools/launch_multihost.py --num_processes 2 --devices_per_process 4

On a real multi-host cluster the same code path is: set
JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID per host (or
let the cluster scheduler's autodetection do it), run ``python -m deepfluids_tpu.main`` — main() calls
init_distributed() unconditionally.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_worker(steps: int = 2) -> list[float]:
    """One worker process: init multi-host jax, run DP train steps on the
    global mesh, return per-step losses.  Also runs single-process (no
    coordinator env) — the oracle path."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, _REPO)
    from deepfluids_tpu.parallel.mesh import init_distributed

    multi = init_distributed()

    import jax.numpy as jnp
    import numpy as np

    from deepfluids_tpu.models import GeneratorBE
    from deepfluids_tpu.parallel import (
        batch_sharding,
        make_mesh,
        replicated_sharding,
    )
    from deepfluids_tpu.parallel.mesh import shard_batch_multihost
    from deepfluids_tpu.train import generator_loss
    from deepfluids_tpu.train.state import create_train_state, make_optimizer

    mesh = make_mesh()  # ALL global devices on the data axis
    n = len(jax.devices())
    if multi:
        print(f"worker {jax.process_index()}/{jax.process_count()}: "
              f"{n} global devices, {len(jax.local_devices())} local",
              flush=True)

    model = GeneratorBE(output_shape=(32, 32, 1), filters=16, num_conv=2,
                        dtype=jnp.float32)
    tx = make_optimizer(1e-3, 1e-5, 100)
    state = create_train_state(jax.random.PRNGKey(0), model,
                               (jnp.zeros((1, 3)),), tx)
    state = jax.device_put(state, replicated_sharding(mesh))

    def step(state, x, y):
        def loss_fn(params):
            out = state.apply_fn({"params": params}, y)
            loss, _ = generator_loss(out, x, True, 1.0, 1.0)
            return loss

        loss, grads = jax.value_and_grad(loss_fn)(state.params)
        return state.apply_gradients(grads=grads), loss

    jstep = jax.jit(
        step,
        in_shardings=(replicated_sharding(mesh), batch_sharding(mesh),
                      batch_sharding(mesh)),
        out_shardings=(replicated_sharding(mesh),
                       replicated_sharding(mesh)),
    )
    rng = np.random.default_rng(0)  # same stream on every host
    losses = []
    for k in range(steps):
        x = shard_batch_multihost(
            mesh, rng.normal(size=(2 * n, 32, 32, 2)).astype(np.float32))
        y = shard_batch_multihost(
            mesh, rng.normal(size=(2 * n, 3)).astype(np.float32))
        state, loss = jstep(state, x, y)
        losses.append(float(loss))  # replicated -> addressable everywhere
    print("MHLOSSES", " ".join(f"{v:.8f}" for v in losses), flush=True)
    return losses


def _spawn(num_processes: int, devices_per_process: int, steps: int,
           port: int) -> list[list[float]]:
    env_base = {k: v for k, v in os.environ.items()
                if k not in ("XLA_FLAGS",)}
    procs = []
    for pid in range(num_processes):
        env = dict(
            env_base,
            JAX_PLATFORMS="cpu",
            XLA_FLAGS=(f"--xla_force_host_platform_device_count="
                       f"{devices_per_process}"),
        )
        if num_processes > 1:
            env.update(JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                       JAX_NUM_PROCESSES=str(num_processes),
                       JAX_PROCESS_ID=str(pid))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker",
             "--steps", str(steps)],
            env=env, cwd=_REPO, stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, text=True))
    results = []
    for pid, pr in enumerate(procs):
        out, _ = pr.communicate(timeout=600)
        if pr.returncode != 0:
            raise RuntimeError(f"worker {pid} failed (exit {pr.returncode})")
        for line in out.splitlines():
            if line.startswith("MHLOSSES"):
                results.append([float(v) for v in line.split()[1:]])
                break
        else:
            raise RuntimeError(f"worker {pid} printed no losses:\n{out}")
    return results


def launch(num_processes: int = 2, devices_per_process: int = 4,
           steps: int = 2, port: int = 12788,
           check_single: bool = True) -> list[float]:
    """Run the multi-process demo; return the agreed per-step losses."""
    multi = _spawn(num_processes, devices_per_process, steps, port)
    for pid, losses in enumerate(multi[1:], 1):
        assert losses == multi[0], (
            f"process {pid} diverged: {losses} != {multi[0]}")
    print(f"{num_processes}x{devices_per_process} devices: "
          f"losses {multi[0]}")
    if check_single:
        # Oracle: ONE process owning the same total device count, same
        # batches, same init — the global computation must match (gloo
        # reduction order may differ from XLA's single-process all-reduce;
        # f32 tolerance).
        single = _spawn(1, num_processes * devices_per_process, steps,
                        port + 1)[0]
        for a, b in zip(multi[0], single):
            assert abs(a - b) < 1e-5, (
                f"multi-host {multi[0]} != single-process {single}")
        print(f"single-process oracle agrees: {single}")
    return multi[0]


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser("launch_multihost")
    p.add_argument("--num_processes", type=int, default=2)
    p.add_argument("--devices_per_process", type=int, default=4)
    p.add_argument("--steps", type=int, default=2)
    p.add_argument("--port", type=int, default=12788)
    p.add_argument("--no_check_single", action="store_true")
    p.add_argument("--worker", action="store_true",
                   help="internal: run as a spawned worker")
    a = p.parse_args(argv)
    if a.worker:
        run_worker(a.steps)
        return 0
    launch(a.num_processes, a.devices_per_process, a.steps, a.port,
           check_single=not a.no_check_single)
    return 0


if __name__ == "__main__":
    sys.exit(main())
