"""Extended benchmark suite — one surface per invocation, each in its own
process.

Usage: python tools/bench_suite.py <name>
  infer2d    scanned-sweep generator inference, 128x96 (the bench.py metric)
  infer3d    3D generator inference, 112x64x32 vector potential + curl3
  train2d    full-size 2D train step (curl + jacobian loss), batch 8
  train3d    full-size 3D train step (config #5 geometry), batch 4
  rollout    latent integrator lax.scan rollout, z_num=16, batch 100
  rollout_decode  rollout + per-step field decode (the ae+nn test workload)
  e2e_sweep2d  full 21x5x200 sweep INCLUDING npz/png/gif artifact writes

Appends one JSON line per run to BENCHMARKS.jsonl at the repo root.
All timings end in ``block_until_ready`` (see bench.py `_measure`).
Needs a GPU.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def timeit(f, *args, iters=5, warmup=2):
    """Wall time per call — delegates to bench._measure so the timing
    discipline lives in ONE place."""
    from bench import _measure

    return _measure(f, args, iters, warmup)


def _flops(jfn, *args):
    """HLO flop count of the compiled program (XLA cost analysis).  None
    when the backend can't report it."""
    try:
        ca = jfn.lower(*args).compile().cost_analysis()
        if isinstance(ca, (list, tuple)):
            ca = ca[0]
        f = float(ca.get("flops", 0.0))
        return f if f > 0 else None
    except Exception:
        return None


def _tflops(rec, flops_body, dt_call, scan_trips=1):
    """Attach the achieved TFLOP/s of the compiled program.

    Counts the HLO's own flops (incl. FD stencils and optimizer elementwise
    work).  ``scan_trips``: XLA cost analysis counts a while-loop BODY
    once, not trip_count times, so a scanned bench must pass its scan
    length here or under-report by exactly that factor."""
    if flops_body:
        rec["tflops_per_sec"] = round(flops_body * scan_trips / dt_call
                                      / 1e12, 1)
    return rec


def bench_infer2d():
    import __graft_entry__ as ge

    fn, (params, _) = ge.entry()

    @jax.jit
    def jfn(params, chunks):
        def step(c, p):
            return c + jnp.sum(fn(params, p)), None
        return jax.lax.scan(step, jnp.float32(0), chunks)[0]

    chunks = jnp.asarray(np.random.default_rng(0).uniform(
        -1, 1, (16, 512, 3)).astype(np.float32))
    dt = timeit(jfn, params, chunks)
    n = 16 * 512
    return _tflops({"metric": "2d_fields_per_sec", "value": round(n / dt, 1),
                 "detail": "128x96 scanned sweep 16x512"},
                _flops(jfn, params, chunks), dt, scan_trips=16)


def bench_infer3d():
    from deepfluids_tpu.models import GeneratorBE
    from deepfluids_tpu.ops import curl3d

    model = GeneratorBE(output_shape=(32, 64, 112, 3), filters=128,
                        num_conv=4, dtype=jnp.bfloat16)
    p0 = jnp.zeros((1, 3))
    params = model.init(jax.random.PRNGKey(0), p0)["params"]

    B, K = 32, 4

    @jax.jit
    def jfn(params, chunks):
        def step(c, p):
            u = curl3d(model.apply({"params": params}, p))
            return c + jnp.sum(u), None
        return jax.lax.scan(step, jnp.float32(0), chunks)[0]

    chunks = jnp.asarray(np.random.default_rng(0).uniform(
        -1, 1, (K, B, 3)).astype(np.float32))
    dt = timeit(jfn, params, chunks, iters=3)
    return _tflops({"metric": "3d_fields_per_sec",
                 "value": round(K * B / dt, 1),
                 "detail": "112x64x32 vector potential + curl3, scan 4x32"},
                _flops(jfn, params, chunks), dt, scan_trips=K)


def bench_train2d():
    """Full-size 2D train step, K=16 scan-fused steps per dispatch."""
    from deepfluids_tpu.models import GeneratorBE
    from deepfluids_tpu.train import generator_loss
    from deepfluids_tpu.train.state import create_train_state, make_optimizer

    B, K = 8, 16
    model = GeneratorBE(output_shape=(128, 96, 1), filters=128, num_conv=4,
                        dtype=jnp.bfloat16)
    tx = make_optimizer(1e-4, 1e-5, 1000)
    state = create_train_state(jax.random.PRNGKey(0), model,
                               (jnp.zeros((1, 3)),), tx)

    def step(state, x, y):
        def loss_fn(p):
            out = state.apply_fn({"params": p}, y)
            return generator_loss(out, x, True, 1.0, 1.0)[0]
        l, g = jax.value_and_grad(loss_fn)(state.params)
        return state.apply_gradients(grads=g), l

    def multi(state, xs, ys):
        def body(st, xy):
            st, l = step(st, *xy)
            return st, l
        return jax.lax.scan(body, state, (xs, ys))

    jmulti = jax.jit(multi, donate_argnums=(0,))
    rng = np.random.default_rng(0)
    xs = jnp.asarray(rng.normal(size=(K, B, 128, 96, 2)), jnp.float32)
    ys = jnp.asarray(rng.normal(size=(K, B, 3)), jnp.float32)
    s, ls = jmulti(state, xs, ys)
    s, ls = jmulti(s, xs, ys)
    jax.block_until_ready(ls)
    N = 10
    t0 = time.perf_counter()
    for _ in range(N):
        s, ls = jmulti(s, xs, ys)
    jax.block_until_ready((s, ls))
    dt = (time.perf_counter() - t0) / (N * K)
    return _tflops({"metric": "2d_train_steps_per_sec",
                 "value": round(1 / dt, 1),
                 "detail": f"batch {B}, curl+jacobian loss, Adam, "
                           f"steps_per_call={K} (synthetic batches)"},
                _flops(jmulti, s, xs, ys), dt * K, scan_trips=K)


def bench_train3d():
    """Full-size 3D train step (config #5 geometry), synthetic batches,
    curl3+jacobian3 loss, K=4 scan-fused steps per dispatch."""
    from deepfluids_tpu.models import GeneratorBE
    from deepfluids_tpu.train import generator_loss
    from deepfluids_tpu.train.state import create_train_state, make_optimizer

    B, K = 4, 4
    model = GeneratorBE(output_shape=(32, 64, 112, 3), filters=128,
                        num_conv=4, dtype=jnp.bfloat16)
    tx = make_optimizer(1e-4, 1e-5, 1000)
    state = create_train_state(jax.random.PRNGKey(0), model,
                               (jnp.zeros((1, 3)),), tx)

    def step(state, x, y):
        def loss_fn(p):
            out = state.apply_fn({"params": p}, y)
            return generator_loss(out, x, True, 1.0, 1.0)[0]
        l, g = jax.value_and_grad(loss_fn)(state.params)
        return state.apply_gradients(grads=g), l

    def multi(state, xs, ys):
        def body(st, xy):
            st, l = step(st, *xy)
            return st, l
        return jax.lax.scan(body, state, (xs, ys))

    jmulti = jax.jit(multi, donate_argnums=(0,))
    rng = np.random.default_rng(0)
    xs = jnp.asarray(rng.normal(size=(K, B, 32, 64, 112, 3)), jnp.float32)
    ys = jnp.asarray(rng.normal(size=(K, B, 3)), jnp.float32)
    s, ls = jmulti(state, xs, ys)
    jax.block_until_ready(ls)
    N = 5
    t0 = time.perf_counter()
    for _ in range(N):
        s, ls = jmulti(s, xs, ys)
    jax.block_until_ready((s, ls))
    dt = (time.perf_counter() - t0) / (N * K)
    return _tflops({"metric": "3d_train_steps_per_sec",
                 "value": round(1 / dt, 1),
                 "detail": f"112x64x32 batch {B}, curl3+jacobian3 "
                           f"loss, steps_per_call={K} (synthetic batches)"},
                _flops(jmulti, s, xs, ys), dt * K, scan_trips=K)


def bench_rollout():
    from deepfluids_tpu.models import LatentIntegrator
    from deepfluids_tpu.models.latent import rollout

    T, B, Z, P = 200, 100, 16, 2
    m = LatentIntegrator(z_num=Z, num_param=P, hidden=512, depth=2)
    zf = jnp.zeros((B, Z - P))
    dp = jnp.zeros((B, P))
    params = m.init(jax.random.PRNGKey(0), jnp.zeros((B, Z)), dp)
    apply_fn = lambda p, z, d: m.apply(p, z, d)
    p_seq = jnp.asarray(np.random.default_rng(0).uniform(
        -1, 1, (T, B, P)).astype(np.float32))
    z0 = jnp.concatenate([p_seq[0], zf], axis=-1)

    @jax.jit
    def jfn(params, z0, p_seq):
        return jnp.sum(rollout(apply_fn, params, z0, p_seq, P))

    dt = timeit(jfn, params, z0, p_seq)
    return {"metric": "rollout_steps_per_sec",
            "value": round((T - 1) * B / dt, 1),
            "detail": f"T={T} scan x batch {B}, z_num={Z}, MLP 512x2"}


def bench_rollout_decode():
    from deepfluids_tpu.models import GeneratorBE, LatentIntegrator
    from deepfluids_tpu.models.latent import rollout
    from deepfluids_tpu.ops import curl2d

    T, B, Z, P = 200, 5, 16, 2
    m = LatentIntegrator(z_num=Z, num_param=P, hidden=512, depth=2)
    dec = GeneratorBE(output_shape=(128, 96, 1), filters=128, num_conv=4,
                      dtype=jnp.bfloat16)
    zf = jnp.zeros((B, Z - P))
    dp = jnp.zeros((B, P))
    params = m.init(jax.random.PRNGKey(0), jnp.zeros((B, Z)), dp)
    dparams = dec.init(jax.random.PRNGKey(1), jnp.zeros((1, Z)))["params"]
    apply_fn = lambda p, z, d: m.apply(p, z, d)
    p_seq = jnp.asarray(np.random.default_rng(0).uniform(
        -1, 1, (T, B, P)).astype(np.float32))
    z0 = jnp.concatenate([p_seq[0], zf], axis=-1)

    @jax.jit
    def jfn(params, dparams, z0, p_seq):
        traj = rollout(apply_fn, params, z0, p_seq, P)  # [T, B, Z]

        def step(c, z):
            u = curl2d(dec.apply({"params": dparams}, z))
            return c + jnp.sum(u), None
        return jax.lax.scan(step, jnp.float32(0), traj)[0]

    dt = timeit(jfn, params, dparams, z0, p_seq, iters=3)
    return {"metric": "rollout_decode_steps_per_sec",
            "value": round((T - 1) * B / dt, 1),
            "detail": f"T={T} x batch {B}: integrate + decode 128x96 + curl"}


def bench_e2e_sweep2d():
    """END-TO-END sweep: the reference's full 21x5x200 test grid INCLUDING
    .npz compression, PNG renders and GIF assembly (not compute-only —
    the honest artifact-writing fields/s)."""
    import tempfile

    from deepfluids_tpu.data.manifest import Manifest
    from deepfluids_tpu.infer import run_test_sweep
    from deepfluids_tpu.models import GeneratorBE
    from deepfluids_tpu.ops import curl2d

    m = Manifest(param_names=["src_x_pos", "src_radius", "frame"],
                 param_ranges=[[0.2, 0.8], [0.04, 0.12], [0.0, 199.0]],
                 num_scenes=105, num_frames=200, resolution=[128, 96],
                 num_channels=2, v_range=[-5, 5], param_counts=[21, 5])
    model = GeneratorBE(output_shape=(128, 96, 1), filters=128, num_conv=4,
                        dtype=jnp.bfloat16)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 3)))["params"]

    def apply_fn(prm, p):
        return curl2d(model.apply({"params": prm}, p))

    from deepfluids_tpu.infer import sweep_generator

    # Warm the jit outside the timed region (every sibling bench excludes
    # compilation via warmup).
    next(sweep_generator(apply_fn, m,
                         np.zeros((128, 3), np.float32), 128,
                         params=params))
    with tempfile.TemporaryDirectory() as td:
        t0 = time.perf_counter()
        res = run_test_sweep(apply_fn, m, td, counts=(21, 5),
                             batch_size=128, save_png_every=20,
                             params=params)
        dt = time.perf_counter() - t0
    return {"metric": "e2e_sweep_fields_per_sec",
            "value": round(res["num_fields"] / dt, 1),
            "detail": "21x5x200 grid incl. npz+png+gif artifact writes"}


BENCHES = {
    "infer2d": bench_infer2d,
    "infer3d": bench_infer3d,
    "train2d": bench_train2d,
    "train3d": bench_train3d,
    "rollout": bench_rollout,
    "rollout_decode": bench_rollout_decode,
    "e2e_sweep2d": bench_e2e_sweep2d,
}


def main():
    if len(sys.argv) < 2 or sys.argv[1] not in BENCHES:
        print(f"usage: bench_suite.py {{{','.join(sorted(BENCHES))}}}",
              file=sys.stderr)
        raise SystemExit(2)
    name = sys.argv[1]
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench_suite: needs a GPU; JAX's default device is "
              f"{dev.platform}", file=sys.stderr)
        raise SystemExit(2)
    from deepfluids_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    rec = BENCHES[name]()
    rec["device"] = {"platform": dev.platform, "kind": dev.device_kind,
                     "count": len(jax.devices())}
    rec["ts"] = time.strftime("%Y-%m-%d %H:%M:%S")
    with open(os.path.join(ROOT, "BENCHMARKS.jsonl"), "a") as f:
        f.write(json.dumps(rec) + "\n")
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
