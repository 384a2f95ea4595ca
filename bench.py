"""Benchmark harness — prints ONE JSON line for the driver.

Metric (BASELINE.json [B]): velocity fields/sec/chip for the 2D smoke
generator at the reference's 128x96 resolution (the inference-sweep hot
loop, SURVEY.md §3.2).  `vs_baseline` is measured against a live proxy of
the reference's TF1-CPU setting: the SAME decoder run at batch 1 on CPU in
a subprocess (the reference swept parameters one sess.run at a time on
host, SURVEY §3.2 [M]); the [B] north-star target is ≥50x.

Usage: python bench.py          (needs a GPU; fails on any other backend)
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

BATCH = 512    # chunk width of the device-side scanned sweep
CHUNKS = 16    # scan length: one call covers CHUNKS*BATCH fields
WARMUP = 2
ITERS = 5
CPU_ITERS = 8      # batch-1 forwards per CPU measurement window
CPU_WINDOWS = 5    # windows; the MEDIAN window rate is the baseline (a
                   # single window can be slowed by another process
                   # time-sharing the host CPU)


def _measure(fn, args, iters, warmup):
    """Wall time per call: ``iters`` calls after ``warmup``, ended by
    ``block_until_ready`` so the device work is inside the window."""
    import jax

    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def run_device_bench() -> float:
    """Device-side scanned-sweep inference fields/sec (the production path:
    infer.sweep.sweep_on_device — whole parameter grid in one program)."""
    import jax
    import jax.numpy as jnp

    import __graft_entry__ as ge

    fn, (params, _) = ge.entry()

    @jax.jit
    def jfn(params, chunks):
        def step(c, p):
            return c + jnp.sum(fn(params, p)), None
        s, _ = jax.lax.scan(step, jnp.float32(0), chunks)
        return s

    chunks = jnp.asarray(np.random.default_rng(0).uniform(
        -1, 1, size=(CHUNKS, BATCH, 3)).astype(np.float32))
    dt = _measure(jfn, (params, chunks), ITERS, WARMUP)
    return CHUNKS * BATCH / dt


def run_cpu_baseline() -> list[float]:
    """Batch-1 CPU fields/sec (TF1-CPU reference proxy) in a subprocess.

    Returns CPU_WINDOWS per-window rates from one subprocess (compile paid
    once); callers take the median, which is robust to another process
    time-sharing the machine during individual windows."""
    code = (
        "import json,time,numpy as np,jax,jax.numpy as jnp;"
        "import __graft_entry__ as ge;"
        "fn,(params,_)=ge.entry();"
        "jfn=jax.jit(lambda pa,p: jnp.sum(fn(pa,p)));"
        "p=jnp.zeros((1,3));"
        "[float(jfn(params,p)) for _ in range(2)];"
        f"n={CPU_ITERS};rates=[]\n"
        f"for _ in range({CPU_WINDOWS}):\n"
        "    t0=time.perf_counter()\n"
        "    [float(jfn(params,p)) for _ in range(n)]\n"
        "    rates.append(n/(time.perf_counter()-t0))\n"
        "print('CPURATES', json.dumps(rates))"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env=env, cwd=os.path.dirname(os.path.abspath(__file__)),
        timeout=900,
    )
    for line in out.stdout.splitlines():
        if line.startswith("CPURATES"):
            return json.loads(line.split(None, 1)[1])
    raise RuntimeError(f"cpu baseline failed: {out.stderr[-800:]}")


def main():
    import jax

    from deepfluids_tpu.utils.compile_cache import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: needs a GPU; JAX's default device is {dev.platform}",
              file=sys.stderr)
        raise SystemExit(2)
    enable_compile_cache()
    fields_per_sec = run_device_bench()
    try:
        cpu_rates = sorted(run_cpu_baseline())
        cpu_rate = float(np.median(cpu_rates))
        vs = fields_per_sec / cpu_rate
    except Exception:
        cpu_rates, cpu_rate, vs = [], None, float("nan")
    try:
        load1 = round(os.getloadavg()[0], 1)  # contention context for the
    except OSError:                           # CPU-proxy number
        load1 = None
    print(json.dumps({
        "metric": "2d_velocity_fields_per_sec_per_chip",
        "value": round(fields_per_sec, 1),
        "unit": "fields/s (128x96, scanned sweep 16x512, curl applied)",
        "vs_baseline": round(vs, 1) if vs == vs else None,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "cpu_rate_median": round(cpu_rate, 2) if cpu_rate else None,
        "cpu_rates": [round(r, 2) for r in cpu_rates],
        "loadavg_1m": load1,
    }))


if __name__ == "__main__":
    main()
