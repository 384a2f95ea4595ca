"""Per-layer profile of the cfg2 and cfg5 train steps on the GPU.

    python chip_smoke.py                      # writes smoke_out/data
    python tools/profile_step.py --data_dir smoke_out/data \
        [--out chiprun_out/profile] [--steps 50]

For each configuration the tool builds the Trainer exactly as ``main()``
does (device-cache train program, bf16 compute) and reports:

* the steady step time: ``--steps`` calls timed around ``block_until_ready``
  after a warm-up, compilation excluded;
* from a profiler trace of a few steps: device busy time per step, device
  time per layer (convolutions, matrix products, stencils, the rest), and
  the time of the finite-difference stencil kernels (forward and VJP),
  found by the named scopes ``train.losses.CURL_SCOPE`` / ``JACOBIAN_SCOPE``
  in the optimized HLO;
* the bytes the stencil work must move (:func:`stencil_bytes`) over the
  stencil kernels' time, against the card's HBM bandwidth from
  ``HBM_BYTES_PER_S``.  A device kind the table lacks gets no share.

The process runs with XLA's command buffers off (``XLA_FLAGS`` gains
``--xla_gpu_enable_command_buffer=``), so every kernel is its own trace
event; its step time is therefore not the default configuration's.  The
trace, the optimized HLO and one JSON summary per configuration go to
``--out``.  Fails when JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import numpy as np  # noqa: E402

# Peak HBM bandwidth by jax device_kind (NVIDIA data sheets).
HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,   # H100 SXM
    "NVIDIA H100 PCIe": 2.0e12,
}

_COMP = re.compile(r"^(?:ENTRY )?%?([\w.\-]+) .*\{\s*$")  # column 0
_INSTR = re.compile(r"^\s*(?:ROOT )?%?([\w.\-]+) = (.*)$")


def stencil_ops(hlo: str, scopes: tuple[str, ...]) -> dict[str, bool]:
    """Top-level HLO instructions (fusions and plain ops) that compute a
    stencil term, from the optimized HLO text.

    An instruction counts when its own metadata, or that of any op in the
    computation it calls, names one of ``scopes``.  Returns name -> whether
    it belongs to the VJP (a transposed op)."""
    comps: dict[str, list[str]] = {}
    cur = None
    for line in hlo.splitlines():
        m = _COMP.match(line)
        if m:
            cur = comps.setdefault(m.group(1), [])
        elif cur is not None:
            cur.append(line)

    def scoped(lines):
        hits = [ln for ln in lines if any(s in ln for s in scopes)]
        return bool(hits), any("transpose(" in ln for ln in hits)

    fused = {name for lines in comps.values() for ln in lines
             for name in re.findall(r"calls=%?([\w.\-]+)", ln)
             if " fusion(" in ln}
    out = {}
    for cname, lines in comps.items():
        if cname in fused:
            continue
        for ln in lines:
            m = _INSTR.match(ln)
            if not m or " parameter(" in ln or "get-tuple-element(" in ln:
                continue
            name, rhs = m.groups()
            hit, vjp = scoped([ln])
            for c in re.findall(r"calls=%?([\w.\-]+)", rhs):
                h, v = scoped(comps.get(c, []))
                hit, vjp = hit or h, vjp or v
            if hit and not re.match(r"\S+ (while|call|conditional)\(", rhs):
                out[name] = vjp
    return out


def stencil_bytes(field_shape: tuple[int, ...]) -> int:
    """Bytes the stencil work of one train step must move at least, from
    the velocity field's shape [B, *spatial, C] (f32 throughout):

    curl forward reads psi and writes u; the jacobian-L1 loss reads pred
    and target; its VJP reads both and writes d pred; the curl VJP reads
    d u and writes d psi.  psi has 1 channel in 2D and 3 in 3D."""
    n = int(np.prod(field_shape[:-1]))
    cu = field_shape[-1]
    cp = 1 if len(field_shape) == 4 else 3
    return 4 * n * (2 * cp + 7 * cu)


def device_events(trace_dir: str) -> list[dict]:
    """Kernel events of the GPU device planes of the newest trace."""
    path = sorted(glob.glob(os.path.join(
        trace_dir, "plugins", "profile", "*", "*.xplane.pb")))[-1]
    pd = jax.profiler.ProfileData.from_file(path)
    events = []
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                stats = {k: v for k, v in ev.stats}
                events.append({"line": line.name, "name": ev.name,
                               "start": ev.start_ns, "dur": ev.duration_ns,
                               "hlo_op": str(stats.get("hlo_op", ""))})
    return events


def busy_ns(events: list[dict]) -> float:
    """Union of the events' intervals on the device."""
    total, end = 0.0, -1.0
    for s, e in sorted((ev["start"], ev["start"] + ev["dur"])
                       for ev in events):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def category(key: str, ops: dict[str, bool]) -> str:
    """Layer of one device op: the stencils, cuDNN convolutions, matrix
    products, or the rest (optimizer update, gathers, elementwise)."""
    if key in ops:
        return "stencil_vjp" if ops[key] else "stencil_fwd"
    if key.startswith("cudnn"):
        return "conv"
    if "gemm" in key or "cublas" in key or "dot" in key:
        return "matmul"
    return "other"


def reduce_trace(events: list[dict], ops: dict[str, bool], steps: int,
                 kind: str, nbytes: int) -> dict:
    """Per-step device metrics of a traced window of ``steps`` steps;
    ``nbytes`` is :func:`stencil_bytes` of one step."""
    per_cat: dict[str, float] = {}
    per_op: dict[str, float] = {}
    for ev in events:
        key = ev["hlo_op"] or ev["name"]
        per_op[key] = per_op.get(key, 0.0) + ev["dur"]
        cat = category(key, ops)
        per_cat[cat] = per_cat.get(cat, 0.0) + ev["dur"]
    busy = busy_ns(events)
    sten = per_cat.get("stencil_fwd", 0.0) + per_cat.get("stencil_vjp", 0.0)
    rate = nbytes * steps / (sten / 1e9) if sten else None
    peak = HBM_BYTES_PER_S.get(kind)
    return {
        "device_busy_ms_per_step": busy / steps / 1e6,
        "ms_per_step_by_layer": {k: v / steps / 1e6
                                 for k, v in sorted(per_cat.items())},
        "stencil_share_of_busy": sten / busy if busy else None,
        "stencil_bytes_per_step": nbytes,
        "stencil_bytes_per_s": rate,
        "hbm_peak_bytes_per_s": peak,
        "stencil_share_of_hbm_peak": rate / peak if peak and rate else None,
        "top_ops_ms_per_step": {k: v / steps / 1e6 for k, v in sorted(
            per_op.items(), key=lambda kv: -kv[1])[:12]},
    }


def build(flags: list[str]):
    """(trainer, jitted device-cache program, its arguments)."""
    from deepfluids_tpu.config import get_config
    from deepfluids_tpu.train.trainer import Trainer

    t = Trainer(get_config(flags))
    cx, cy = t._load_device_cache()
    idx = np.zeros((max(1, t.c.steps_per_call), t.c.batch_size), np.int32)
    return t, t._get_cached_multi(), (idx, cx, cy)


def time_steps(t, step, args, n: int) -> float:
    """Seconds per train step over ``n`` calls (block_until_ready)."""
    jax.block_until_ready(t.state)
    t0 = time.perf_counter()
    for _ in range(n):
        t.state, aux = step(t.state, *args)
    jax.block_until_ready((t.state, aux))
    return (time.perf_counter() - t0) / (n * args[0].shape[0])


def profile(name: str, flags: list[str], out: str, steps: int) -> dict:
    from deepfluids_tpu.train import losses

    t, step, args = build(flags)
    hlo = step.lower(t.state, *args).compile().as_text()
    with open(os.path.join(out, f"{name}.hlo.txt"), "w") as f:
        f.write(hlo)
    ops = stencil_ops(hlo, (losses.CURL_SCOPE, losses.JACOBIAN_SCOPE))
    time_steps(t, step, args, 3)                      # warm-up
    dt = time_steps(t, step, args, steps)
    traced = 5
    tdir = os.path.join(out, f"{name}_trace")
    with jax.profiler.trace(tdir):
        time_steps(t, step, args, traced)
    kind = jax.devices()[0].device_kind
    cx = args[1]
    field = (t.c.batch_size,) + tuple(cx.shape[1:])
    res = {"config": name, "device_kind": kind, "step_ms": dt * 1e3,
           "xla_flags": os.environ.get("XLA_FLAGS", ""),
           "stencil_ops": len(ops),
           **reduce_trace(device_events(tdir), ops,
                          traced * args[0].shape[0], kind,
                          stencil_bytes(field))}
    with open(os.path.join(out, f"{name}.json"), "w") as f:
        json.dump(res, f, indent=1)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data_dir", required=True)
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "profile"))
    ap.add_argument("--steps", type=int, default=50)
    a = ap.parse_args(argv)
    # Command buffers replay many kernels as one trace event; off, every
    # kernel is its own event and can be attributed.  Set before the
    # backend starts.
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                               " --xla_gpu_enable_command_buffer=").strip()
    if jax.devices()[0].platform != "gpu":
        print("profile_step: needs a GPU", file=sys.stderr)
        return 2
    import chip_smoke
    from deepfluids_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    os.makedirs(a.out, exist_ok=True)
    work = os.path.join(ROOT, "smoke_out", "profile_work")
    for name, three_d in (("cfg2", False), ("cfg5", True)):
        flags = chip_smoke.cfg_flags(
            work, a.data_dir, chip_smoke.REAL, three_d, f"prof_{name}",
            "--compute_dtype", "bfloat16", "--num_data_shards", "1")
        print(json.dumps(profile(name, flags, a.out, a.steps)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
