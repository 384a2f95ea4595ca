"""Smoke run of the main path on an NVIDIA GPU, checked against references.

    python chip_smoke.py              # one card: datagen, cfg2 train +
                                      # checkpoint + sweep, cfg5 train,
                                      # stencils, goldens, exact resume
    python chip_smoke.py --chips 4    # four cards: data-parallel cfg2 steps,
                                      # cfg5 --spatial_shard loss and grads,
                                      # halo stencils, each against one card

Every phase prints its largest error, the tolerance it is held to and the
precision it ran at.  The last line is one JSON object naming the device;
it is printed only when every phase passed.  Without a GPU the script
exits non-zero at once.  Work files go to ``smoke_out/`` beside this file.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time
import traceback

# The stencil phase compares against the CPU backend in the same process.
_plat = os.environ.get("JAX_PLATFORMS")
if _plat and "cpu" not in _plat.split(","):
    os.environ["JAX_PLATFORMS"] = _plat + ",cpu"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden")


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Shapes of one smoke run.  ``REAL`` is what the card runs: cfg2 and
    cfg5 at full width; only scene and frame counts are cut."""

    grid2: tuple = (128, 96)
    grid3: tuple = (32, 64, 112)
    filters: int = 128
    num_conv: int = 4
    batch2: int = 8
    batch3: int = 4
    scenes2: tuple = (2, 2)       # positions x sizes
    frames2: int = 32
    scenes3: tuple = (2, 1)       # velocities x buoyancies
    frames3: int = 8
    steps: int = 4                # train steps per run (even: resume halves)


REAL = Sizes()

# Tolerances, each with its reason.
TOL_STENCIL = 1e-6   # f32, one subtraction per element: no accumulation
TOL_GOLDEN = 1e-3    # the repo's normalized-L2 parity gate
# bf16 (8-bit mantissa) through ~21 width-128 convs, against f32 "highest".
# Measured on an H100: 5.6e-4 for the first-step loss and 1.6e-2 for the
# sweep fields of the 4-step run; the bounds are about 2x the loss error,
# and the starting bound for the fields, which that measurement reaches.
TOL_BF16_LOSS = 1e-3
TOL_BF16_FIELDS = 2e-2
TOL_DP = 1e-5        # f32 "highest": only the all-reduce order differs
TOL_SPATIAL = 1e-4   # f32 "highest": GSPMD halo convs reorder conv sums


class PhaseError(AssertionError):
    pass


def report(phase: str, what: str, err: float, tol: float,
           precision: str) -> None:
    ok = bool(np.isfinite(err)) and err <= tol
    print(f"[{phase}] {what}: max_err={err:.3e} tol={tol:.0e} "
          f"precision={precision} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise PhaseError(f"{phase}/{what}: {err} > {tol}")


def scaled_err(a, b) -> float:
    """max|a - b| / max(1, max|b|): absolute error at unit scale."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))


def rel_err(a, b) -> float:
    """max|a - b| / max|b| over whole pytrees."""
    la = [np.asarray(x, np.float64) for x in jax.tree.leaves(a)]
    lb = [np.asarray(x, np.float64) for x in jax.tree.leaves(b)]
    num = max(float(np.abs(x - y).max()) for x, y in zip(la, lb))
    return num / max(float(np.abs(y).max()) for y in lb)


def norm_l2(a, b) -> float:
    from deepfluids_tpu.utils.parity import normalized_l2

    return normalized_l2(a, b)


# ---------------------------------------------------------------------------
# entry points and configurations
# ---------------------------------------------------------------------------

def datasets(work: str, sz: Sizes) -> str:
    """cfg2 and cfg5 datasets from the in-process scene API (fixed seeds
    inside the solvers), full grids, few scenes and frames."""
    from deepfluids_tpu.datagen.scenes import SCENES

    data = os.path.join(work, "data")
    t0 = time.perf_counter()
    SCENES["smoke_pos21_size5"](
        data, num_pos=sz.scenes2[0], num_size=sz.scenes2[1],
        num_frames=sz.frames2, height=sz.grid2[0], width=sz.grid2[1],
        name="smoke_pos21_size5")
    SCENES["smoke3_vel5_buo3"](
        data, num_vel=sz.scenes3[0], num_buo=sz.scenes3[1],
        num_frames=sz.frames3, depth=sz.grid3[0], height=sz.grid3[1],
        width=sz.grid3[2], name="smoke3_vel5_buo3")
    for name in ("smoke_pos21_size5", "smoke3_vel5_buo3"):
        d = os.path.join(data, name, "v")
        files = sorted(os.listdir(d))
        with np.load(os.path.join(d, files[-1])) as f:
            if not np.isfinite(f["x"]).all():
                raise PhaseError(f"datagen: non-finite field in {name}")
        print(f"[datagen] {name}: {len(files)} fields", flush=True)
    print(f"[datagen] {time.perf_counter() - t0:.1f}s", flush=True)
    return data


def cfg_flags(work: str, data: str, sz: Sizes, three_d: bool, tag: str,
              *extra: str) -> list[str]:
    dataset = "smoke3_vel5_buo3" if three_d else "smoke_pos21_size5"
    return ["--arch", "de", "--data_dir", data, "--dataset", dataset,
            "--log_dir", os.path.join(work, "logs"), "--tag", tag,
            "--filters", str(sz.filters), "--num_conv", str(sz.num_conv),
            "--batch_size", str(sz.batch3 if three_d else sz.batch2),
            "--device_data_cache", "true", "--max_step", str(sz.steps),
            "--save_step", str(sz.steps), "--log_step", "1",
            "--test_step", "100000", "--seed", "0", "--num_worker", "4",
            *extra]


def run_dir(flags: list[str]) -> str:
    from deepfluids_tpu.config import get_config

    c = get_config(flags)
    return os.path.join(c.log_dir, f"{c.dataset}_{c.tag}")


def memory(trainer, phase: str) -> None:
    """memory_analysis() of the trainer's device-cache train program, at
    the shapes train() runs it."""
    cx, cy = trainer._load_device_cache()
    k = max(1, trainer.c.steps_per_call)
    idx = np.zeros((k, trainer.c.batch_size), np.int32)
    m = trainer._get_cached_multi().lower(
        trainer.state, idx, cx, cy).compile().memory_analysis()
    print(f"[{phase}] memory_analysis: {m}", flush=True)


def a_batch(trainer, n: int):
    xs, ys = zip(*[trainer.bm.ds.get_normalized(i) for i in range(n)])
    return np.stack(xs), np.stack(ys)


# ---------------------------------------------------------------------------
# one-card phases
# ---------------------------------------------------------------------------

def check_stencils(sz: Sizes) -> None:
    """Curl, jacobian and their gradients on the default device against
    the ops.fd oracle on the CPU backend, at the real widths."""
    from deepfluids_tpu import ops

    cpu = jax.devices("cpu")[0]
    cases = {
        "curl2d": (ops.curl2d, (sz.batch2, *sz.grid2, 1)),
        "jacobian2d": (lambda x: jnp.concatenate(ops.jacobian2d(x), -1),
                       (sz.batch2, *sz.grid2, 2)),
        "curl3d": (ops.curl3d, (sz.batch3, *sz.grid3, 3)),
        "jacobian3d": (lambda x: jnp.concatenate(ops.jacobian3d(x), -1),
                       (sz.batch3, *sz.grid3, 3)),
    }
    rng = np.random.default_rng(0)
    for name, (f, shape) in cases.items():
        x = rng.uniform(-1, 1, shape).astype(np.float32)
        g = rng.uniform(-1, 1, jax.eval_shape(f, x).shape).astype(np.float32)
        fwd = jax.jit(f)
        grad = jax.jit(jax.grad(lambda v, c: jnp.sum(f(v) * c)))
        ref = fwd(jax.device_put(x, cpu))
        ref_g = grad(jax.device_put(x, cpu), jax.device_put(g, cpu))
        report("stencils", f"{name} {shape}", scaled_err(fwd(x), ref),
               TOL_STENCIL, "f32")
        report("stencils", f"{name} grad", scaled_err(grad(x, g), ref_g),
               TOL_STENCIL, "f32")


def check_goldens() -> None:
    """FD, solver and model goldens on the card."""
    from deepfluids_tpu import ops
    from deepfluids_tpu.datagen.smoke2d import Smoke2DConfig, simulate_smoke2d
    from deepfluids_tpu.models import (Autoencoder, GeneratorBE,
                                       LatentIntegrator)
    from deepfluids_tpu.utils.parity import check_fields
    from tools.weights_io import unflatten_params

    def load(name):
        with np.load(os.path.join(GOLDEN, name)) as g:
            return {k: g[k] for k in g.files}

    def params(g):
        return {"params": unflatten_params(
            {k[len("params/"):]: v for k, v in g.items()
             if k.startswith("params/")})}

    def gate(what, ours, ref):
        report("goldens", what, check_fields(np.asarray(ours), ref,
                                              TOL_GOLDEN)["max_l2"],
               TOL_GOLDEN, "f32 (highest)")

    with jax.default_matmul_precision("highest"):
        for nd, (curl, jac) in {2: (ops.curl2d, ops.jacobian2d),
                                3: (ops.curl3d, ops.jacobian3d)}.items():
            g = load(f"fd{nd}d.npz")
            gate(f"fd{nd}d curl", curl(g["psi"]), g["u"])
            j, w = jac(g["u"])
            gate(f"fd{nd}d jacobian", j, g["j"])
            gate(f"fd{nd}d vorticity", w, g["w"])
        g = load("smoke2d.npz")
        vt, rt = simulate_smoke2d(jnp.float32(0.5), jnp.float32(0.1),
                                  Smoke2DConfig(height=32, width=24,
                                                num_frames=6,
                                                project_iters=20))
        gate("smoke2d velocity", vt, g["v"])
        gate("smoke2d density", np.asarray(rt)[..., None],
             g["r"][..., None])
        g = load("generator2d.npz")
        gen = GeneratorBE(output_shape=(32, 24, 1), filters=8, num_conv=2)
        gate("generator2d", ops.curl2d(gen.apply(params(g), g["p"])), g["u"])
        g = load("autoencoder2d.npz")
        ae = Autoencoder(output_shape=(16, 16, 1), z_num=8, filters=8,
                         num_conv=1, num_param=3, pred_hidden=16)
        psi, z = ae.apply(params(g), g["x"])
        gate("autoencoder2d", psi, g["psi"])
        report("goldens", "autoencoder2d z", norm_l2(z, g["z"]), TOL_GOLDEN,
               "f32 (highest)")
        g = load("integrator.npz")
        li = LatentIntegrator(z_num=8, num_param=2, hidden=16, depth=2)
        report("goldens", "integrator",
               norm_l2(li.apply(params(g), g["z"], g["dp"]), g["dz"]),
               TOL_GOLDEN, "f32 (highest)")


def train_cfg2(work: str, data: str, sz: Sizes) -> str:
    """cfg2 through main(): train from the device cache, checkpoint."""
    from deepfluids_tpu.config import get_config
    from deepfluids_tpu.main import main
    from deepfluids_tpu.train import checkpoint

    flags = cfg_flags(work, data, sz, False, "cfg2",
                      "--compute_dtype", "bfloat16", "--num_data_shards", "1")
    t0 = time.perf_counter()
    res = main(get_config(flags))
    rd = run_dir(flags)
    saved = checkpoint.steps(os.path.join(rd, "checkpoint"))
    print(f"[train2d] loss={res['loss']:.5f} checkpoints={saved} "
          f"({time.perf_counter() - t0:.1f}s incl. compile)", flush=True)
    if not np.isfinite(res["loss"]) or saved != [sz.steps]:
        raise PhaseError("train2d: non-finite loss or missing checkpoint")
    return rd


def sweep_cfg2(rd: str, data: str, sz: Sizes) -> None:
    """--is_train false through main(): run_test_sweep with npz, PNG and
    GIF artifacts; the swept fields against the f32 forward of the same
    trained weights."""
    from deepfluids_tpu.config import get_config, load_config
    from deepfluids_tpu.main import main
    from deepfluids_tpu.train.trainer import Trainer

    counts = f"{sz.scenes2[0]},{sz.scenes2[1]}"
    res = main(get_config(["--is_train", "false", "--load_path", rd,
                           "--test_counts", counts,
                           "--test_batch_size", "32"]))
    out = res["out_dir"]
    names = os.listdir(out)
    npz = sorted(n for n in names if n.endswith(".npz"))
    pngs = [n for n in names if n.endswith(".png")]
    gifs = [n for n in names if n.endswith(".gif")]
    print(f"[sweep] {res['num_fields']} fields: {len(npz)} npz, "
          f"{len(pngs)} png, {len(gifs)} gif; eval l2_mean="
          f"{res['eval']['l2_mean']:.4f}", flush=True)
    with open(os.path.join(out, pngs[0]), "rb") as f:
        png_ok = f.read(8) == b"\x89PNG\r\n\x1a\n"
    with open(os.path.join(out, gifs[0]), "rb") as f:
        gif_ok = f.read(6) == b"GIF89a"
    if len(npz) != res["num_fields"] or not (png_ok and gif_ok):
        raise PhaseError("sweep: artifacts missing or malformed")

    xs, ys = [], []
    for n in npz:
        with np.load(os.path.join(out, n)) as f:
            xs.append(f["x"])
            ys.append(f["y"])
    c32 = load_config(rd)
    c32.compute_dtype = "float32"
    ref = Trainer(c32, run_dir=rd, save_cfg=False)
    ref.restore_checkpoint()
    with jax.default_matmul_precision("highest"):
        gen = ref.generate(ref.manifest.normalize_params(np.stack(ys)))
    report("sweep", "bf16 sweep fields vs f32",
           norm_l2(np.stack(xs), ref.manifest.denormalize_field(gen)),
           TOL_BF16_FIELDS, "bf16 vs f32 (highest)")


def loss_cfg2(work: str, data: str, sz: Sizes) -> None:
    """cfg2 first-step loss: bf16 compute against f32 under "highest",
    same initial weights; prints the 2D train program's memory."""
    from deepfluids_tpu.config import get_config
    from deepfluids_tpu.train.trainer import Trainer

    t16 = Trainer(get_config(cfg_flags(
        work, data, sz, False, "loss16", "--compute_dtype", "bfloat16",
        "--num_data_shards", "1")))
    t32 = Trainer(get_config(cfg_flags(
        work, data, sz, False, "loss32", "--compute_dtype", "float32",
        "--num_data_shards", "1")))
    x, y = a_batch(t16, sz.batch2)
    l16 = float(jax.jit(t16._loss_fn)(t16.state.params, x, y)[0])
    with jax.default_matmul_precision("highest"):
        l32 = float(jax.jit(t32._loss_fn)(t32.state.params, x, y)[0])
    print(f"[loss2d] first-step loss bf16={l16:.6f} f32={l32:.6f}",
          flush=True)
    report("loss2d", "first-step loss", abs(l16 - l32) / abs(l32),
           TOL_BF16_LOSS, "bf16 vs f32 (highest)")
    memory(t16, "train2d")


def step_time(trainer, n: int = 20) -> float:
    """Steady seconds per device-cache train step (block_until_ready)."""
    step = trainer._get_cached_multi()
    cx, cy = trainer._load_device_cache()
    idx = np.zeros((1, trainer.c.batch_size), np.int32)
    for _ in range(2):
        trainer.state, aux = step(trainer.state, idx, cx, cy)
    jax.block_until_ready(aux)
    t0 = time.perf_counter()
    for _ in range(n):
        trainer.state, aux = step(trainer.state, idx, cx, cy)
    jax.block_until_ready((trainer.state, aux))
    return (time.perf_counter() - t0) / n


def resume(work: str, data: str, sz: Sizes, three_d: bool) -> None:
    """Exact resume on the card: K steps straight against K/2 steps, save,
    restore into a fresh Trainer, K/2 more.  Bitwise."""
    from deepfluids_tpu.config import get_config
    from deepfluids_tpu.train.trainer import Trainer

    k, name = sz.steps, "cfg5" if three_d else "cfg2"
    extra = ("--compute_dtype", "bfloat16", "--num_data_shards", "1",
             "--max_step", "1000")
    ta = Trainer(get_config(cfg_flags(work, data, sz, three_d,
                                      f"resA_{name}", *extra)))
    ta.train(num_steps=k)
    cb = get_config(cfg_flags(work, data, sz, three_d, f"resB_{name}",
                              *extra))
    tb = Trainer(cb)
    tb.train(num_steps=k // 2)
    tb.save_checkpoint()
    tc = Trainer(cb, run_dir=tb.run_dir, save_cfg=False)
    tc.restore_checkpoint()
    tc.train(num_steps=k - k // 2)
    pa = jax.device_get(ta.state.params)
    pc = jax.device_get(tc.state.params)
    diff = [float(np.abs(a - c).max()) for a, c in
            zip(jax.tree.leaves(pa), jax.tree.leaves(pc))]
    print(f"[resume] {name}: {sum(d > 0 for d in diff)}/{len(diff)} leaves "
          f"differ; XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}; steady "
          f"step {1e3 * step_time(ta):.3f} ms", flush=True)
    report("resume", f"{name} {k} straight vs {k // 2}+save+restore+"
           f"{k - k // 2}", max(diff), 0.0, "bf16 (bitwise)")


def train_cfg5(work: str, data: str, sz: Sizes) -> None:
    """cfg5 (3D generator) through main() from the device cache."""
    from deepfluids_tpu.config import get_config
    from deepfluids_tpu.main import main
    from deepfluids_tpu.train.trainer import Trainer

    flags = cfg_flags(work, data, sz, True, "cfg5",
                      "--compute_dtype", "bfloat16", "--num_data_shards", "1")
    t0 = time.perf_counter()
    res = main(get_config(flags))
    print(f"[train3d] loss={res['loss']:.5f} "
          f"({time.perf_counter() - t0:.1f}s incl. compile)", flush=True)
    if not np.isfinite(res["loss"]):
        raise PhaseError("train3d: non-finite loss")
    memory(Trainer(get_config(cfg_flags(
        work, data, sz, True, "cfg5mem", "--compute_dtype", "bfloat16",
        "--num_data_shards", "1"))), "train3d")


# ---------------------------------------------------------------------------
# four-card phases
# ---------------------------------------------------------------------------

def check_dp(work: str, data: str, sz: Sizes, n: int) -> None:
    """cfg2 data-parallel train steps on an n-card data mesh at the global
    batch, against the same steps on one card (f32, "highest")."""
    from deepfluids_tpu.config import get_config
    from deepfluids_tpu.parallel import batch_sharding
    from deepfluids_tpu.train.trainer import Trainer

    tr = {m: Trainer(get_config(cfg_flags(
        work, data, sz, False, f"dp{m}", "--compute_dtype", "float32",
        "--num_data_shards", str(m)))) for m in (n, 1)}
    with jax.default_matmul_precision("highest"):
        x, y = a_batch(tr[1], sz.batch2)
        grads = {}
        for m, t in tr.items():
            sh = batch_sharding(t.mesh)
            vg = jax.jit(jax.value_and_grad(t._loss_fn, has_aux=True))
            grads[m] = jax.device_get(vg(
                t.state.params, jax.device_put(x, sh),
                jax.device_put(y, sh))[1])
        report("dp", f"first-step grads {n} cards vs 1",
               rel_err(grads[n], grads[1]), TOL_DP, "f32 (highest)")
        losses = {m: [] for m in tr}
        for s, (bx, by) in enumerate(tr[1].bm.batches(sz.steps)):
            for m, t in tr.items():
                t.state, aux = t._train_step(t.state, bx, by)
                losses[m].append(float(aux["loss"]))
    print(f"[dp] losses {n} cards {losses[n]} / 1 card {losses[1]}",
          flush=True)
    report("dp", f"{sz.steps} step losses", rel_err(losses[n], losses[1]),
           TOL_DP, "f32 (highest)")


def check_spatial(work: str, data: str, sz: Sizes, n: int) -> None:
    """cfg5 --spatial_shard loss and grads with D split over n cards,
    against the replicated step on one card (f32, "highest")."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from deepfluids_tpu.config import get_config
    from deepfluids_tpu.train.trainer import Trainer

    sp = Trainer(get_config(cfg_flags(
        work, data, sz, True, "sp", "--compute_dtype", "float32",
        "--num_data_shards", str(n), "--spatial_shard", "true")))
    rep = Trainer(get_config(cfg_flags(
        work, data, sz, True, "rep", "--compute_dtype", "float32",
        "--num_data_shards", "1")))
    x, y = a_batch(rep, sz.batch3)
    with jax.default_matmul_precision("highest"):
        vg = jax.value_and_grad(sp._loss_fn, has_aux=True)
        (l_sp, _), g_sp = jax.jit(vg)(
            sp.state.params,
            jax.device_put(x, NamedSharding(sp.mesh, P(None, "data"))),
            jax.device_put(y, NamedSharding(sp.mesh, P())))
        (l_rep, _), g_rep = jax.jit(jax.value_and_grad(
            rep._loss_fn, has_aux=True))(rep.state.params, x, y)
    report("spatial", f"cfg5 loss D/{n} vs replicated",
           abs(float(l_sp) - float(l_rep)) / abs(float(l_rep)), TOL_DP,
           "f32 (highest)")
    report("spatial", f"cfg5 grads D/{n} vs replicated",
           rel_err(jax.device_get(g_sp), jax.device_get(g_rep)),
           TOL_SPATIAL, "f32 (highest)")


def check_halo(sz: Sizes, n: int) -> None:
    """parallel/halo.py stencils on an n-card mesh against ops.fd on one."""
    from deepfluids_tpu import ops
    from deepfluids_tpu.parallel import halo, make_mesh

    mesh = make_mesh(num_data=n)
    one = jax.devices()[0]
    rng = np.random.default_rng(1)
    x2 = rng.uniform(-1, 1, (sz.batch2, *sz.grid2, 2)).astype(np.float32)
    x3 = rng.uniform(-1, 1, (sz.batch3, *sz.grid3, 3)).astype(np.float32)
    cases = [
        ("curl2d", halo.curl2d_sharded, ops.curl2d, x2[..., :1]),
        ("jacobian2d", halo.jacobian2d_sharded, ops.jacobian2d, x2),
        ("curl3d", halo.curl3d_sharded, ops.curl3d, x3),
        ("jacobian3d", halo.jacobian3d_sharded, ops.jacobian3d, x3),
    ]
    for name, sharded, oracle, x in cases:
        got = jax.device_get(sharded(jnp.asarray(x), mesh))
        want = jax.device_get(oracle(jax.device_put(x, one)))
        report("halo", f"{name} {x.shape} over {n}",
               rel_err(got, want) if isinstance(got, tuple)
               else scaled_err(got, want), TOL_STENCIL, "f32")


# ---------------------------------------------------------------------------

def run(phases, failures: list) -> None:
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:
            traceback.print_exc()
            failures.append(name)
            print(f"[{name}] FAILED", flush=True)
        print(f"[{name}] {time.perf_counter() - t0:.1f}s", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4),
                    help="4: run only the multi-card paths and their "
                         "one-card references")
    args = ap.parse_args(argv)

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX's default device is "
              f"{dev.platform}", file=sys.stderr)
        return 2
    if len(jax.devices()) < args.chips:
        print(f"chip_smoke: --chips {args.chips} but JAX sees "
              f"{len(jax.devices())} device(s)", file=sys.stderr)
        return 2

    from deepfluids_tpu.utils.compile_cache import enable_compile_cache

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"nvidia-smi: {smi}")
    print(f"jax {jax.__version__}; devices {jax.devices()}")
    print(f"compile cache: {enable_compile_cache()}", flush=True)

    work = os.path.join(ROOT, "smoke_out")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    sz, failures, st = REAL, [], {}
    if args.chips == 4:
        small = dataclasses.replace(sz, scenes2=(2, 1), frames2=8,
                                    scenes3=(1, 1), frames3=4)
        run([("datagen", lambda: st.update(data=datasets(work, small))),
             ("halo", lambda: check_halo(small, 4)),
             ("dp", lambda: check_dp(work, st["data"], small, 4)),
             ("spatial", lambda: check_spatial(work, st["data"], small, 4))],
            failures)
    else:
        run([("stencils", lambda: check_stencils(sz)),
             ("goldens", check_goldens),
             ("datagen", lambda: st.update(data=datasets(work, sz))),
             ("train2d", lambda: st.update(
                 run=train_cfg2(work, st["data"], sz))),
             ("sweep", lambda: sweep_cfg2(st["run"], st["data"], sz)),
             ("loss2d", lambda: loss_cfg2(work, st["data"], sz)),
             ("train3d", lambda: train_cfg5(work, st["data"], sz)),
             ("resume", lambda: [resume(work, st["data"], sz, d)
                                 for d in (False, True)])],
            failures)
    if failures:
        print(f"chip_smoke: failed phases {failures}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
