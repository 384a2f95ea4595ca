"""Regenerate + verify the full dataset fleet in ONE command.

The reference's user can always re-run ``manta scene/*.py``; this is the
equivalent entry point for all four SURVEY §2 scene datasets (round-3
VERDICT "Next #3"):

    python tools/regen_all.py                 # full fleet (hours; see table)
    python tools/regen_all.py --only smoke3_vel5_buo3_m
    python tools/regen_all.py --verify_only   # check what's on disk

Each dataset is generated in its OWN subprocess (one process = one solver
shape = one compile — the 3D matched multigrid compile is the longest
and must not be paid more than once), then
verified structurally (manifest fields, per-key frame-file counts, sampled
frame shapes/finiteness/range-vs-manifest) and recorded in
BENCHMARKS.jsonl (metric=datagen_fleet) with wall time and a content
statistic, so "the fleet exists and is intact" is a checkable, repeatable
fact rather than a disk accident.

Fleet (smoke scenes use projection=matched — the round-3 quality fix;
liquid is FLIP, no pressure projection choice):

    name                  scenes x frames   wall time on the GPU
    smoke3_vel5_buo3_m        15 x 250      not measured
    smoke_pos21_size5_m      105 x 200      not measured
    liquid_pos10_size4        40 x 200      not measured
    smoke_mov200_f400_m      200 x 400      not measured

Order: 3D first — it gates the longest downstream training (config #5,
~3.5 h), so the fleet's critical path wants its dataset available
earliest.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from deepfluids_tpu.data.manifest import load_manifest  # noqa: E402


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str                   # on-disk dataset dir name
    scene: str                  # datagen --scene
    num_a: int                  # first param count (scenes for smoke_mov)
    num_b: int | None           # second param count (None for smoke_mov)
    num_frames: int
    field_keys: tuple[str, ...]  # subdirs holding one .npz per frame
    resolution: tuple[int, ...]
    num_channels: int
    data_type: str
    projection: str | None      # matched | jacobi | None (liquid)

    @property
    def num_scenes(self) -> int:
        return self.num_a * (self.num_b or 1)


FLEET = (
    DatasetSpec("smoke3_vel5_buo3_m", "smoke3_vel5_buo3", 5, 3, 250,
                ("v", "d"), (32, 64, 112), 3, "velocity", "matched"),
    DatasetSpec("smoke_pos21_size5_m", "smoke_pos21_size5", 21, 5, 200,
                ("v", "d"), (128, 96), 2, "velocity", "matched"),
    DatasetSpec("liquid_pos10_size4", "liquid_pos10_size4", 10, 4, 200,
                ("l", "v"), (128, 96), 1, "levelset", None),
    DatasetSpec("smoke_mov200_f400_m", "smoke_mov", 200, None, 400,
                ("v", "d"), (128, 96), 2, "velocity", "matched"),
)


def generate(spec: DatasetSpec, data_dir: str, log_dir: str) -> float:
    """Run one dataset's generation in a subprocess; return wall seconds."""
    cmd = [sys.executable, "-m", "deepfluids_tpu.datagen",
           "--scene", spec.scene, "--out", data_dir, "--name", spec.name,
           "--num-frames", str(spec.num_frames),
           "--num-a", str(spec.num_a)]
    if spec.num_b is not None:
        cmd += ["--num-b", str(spec.num_b)]
    if spec.projection is not None:
        cmd += ["--projection", spec.projection]
    os.makedirs(log_dir, exist_ok=True)
    log_path = os.path.join(log_dir, f"datagen_{spec.name}.log")
    print(f"[regen_all] {spec.name}: {' '.join(cmd)}  (log: {log_path})",
          flush=True)
    t0 = time.time()
    with open(log_path, "w") as log:
        # Solver logs go to the file, off the tty.
        subprocess.run(cmd, cwd=ROOT, stdout=log, stderr=log, check=True)
    return time.time() - t0


def verify(spec: DatasetSpec, data_dir: str,
           sample_frames: int = 8) -> dict:
    """Structural + content verification; raises on any mismatch.

    Checks: manifest fields match the spec, every field key has exactly
    num_scenes*num_frames files, a deterministic sample of frames parses
    with the manifest shape, is finite, and respects v_range.  Returns the
    stats dict recorded in BENCHMARKS.jsonl.
    """
    ds_dir = os.path.join(data_dir, spec.name)
    m = load_manifest(ds_dir)
    if (m.num_scenes, m.num_frames) != (spec.num_scenes, spec.num_frames):
        raise ValueError(
            f"{spec.name}: manifest scenes/frames "
            f"{(m.num_scenes, m.num_frames)} != spec "
            f"{(spec.num_scenes, spec.num_frames)}")
    if tuple(m.resolution) != spec.resolution:
        raise ValueError(f"{spec.name}: resolution {m.resolution} != "
                         f"{spec.resolution}")
    if (m.num_channels, m.data_type) != (spec.num_channels, spec.data_type):
        raise ValueError(f"{spec.name}: channels/type mismatch")

    counts, files = {}, None
    expected = spec.num_scenes * spec.num_frames
    for key in spec.field_keys:
        fs = sorted(glob.glob(os.path.join(ds_dir, key, "*.npz")))
        counts[key] = len(fs)
        if len(fs) != expected:
            raise ValueError(f"{spec.name}/{key}: {len(fs)} files, "
                             f"expected {expected}")
        if files is None:
            files = fs
    # Deterministic spread over the primary key's files.
    idx = np.linspace(0, len(files) - 1, sample_frames).astype(int)
    abs_means, abs_max = [], 0.0
    for i in idx:
        with np.load(files[i]) as z:
            x, y = z["x"], z["y"]
        if x.shape != m.field_shape:
            raise ValueError(f"{files[i]}: field shape {x.shape} != "
                             f"manifest {m.field_shape}")
        if y.shape != (m.num_param,):
            raise ValueError(f"{files[i]}: param shape {y.shape}")
        if not np.isfinite(x).all():
            raise ValueError(f"{files[i]}: non-finite values")
        abs_means.append(float(np.abs(x).mean()))
        abs_max = max(abs_max, float(np.abs(x).max()))
    if abs_max > m.v_scale * (1 + 1e-5):
        raise ValueError(f"{spec.name}: sampled |x| max {abs_max} exceeds "
                         f"manifest v_scale {m.v_scale}")
    return {"files": counts, "sample_mean_abs": float(np.mean(abs_means)),
            "sample_max_abs": abs_max, "v_range": list(m.v_range)}


def record(row: dict) -> None:
    row["ts"] = time.strftime("%Y-%m-%d %H:%M:%S")
    with open(os.path.join(ROOT, "BENCHMARKS.jsonl"), "a") as f:
        f.write(json.dumps(row) + "\n")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--only", action="append", default=None,
                    choices=[s.name for s in FLEET],
                    help="regenerate only these datasets (repeatable)")
    ap.add_argument("--data_dir", default=os.path.join(ROOT, "data"))
    ap.add_argument("--log_dir", default=os.path.join(ROOT, "logs"))
    ap.add_argument("--verify_only", action="store_true",
                    help="verify what's on disk; generate nothing")
    ap.add_argument("--skip_existing", action="store_true",
                    help="skip generation when the dataset already "
                         "verifies clean (resume a partial fleet regen)")
    args = ap.parse_args()

    todo = [s for s in FLEET if args.only is None or s.name in args.only]
    failures = []
    for spec in todo:
        try:
            wall = None
            if not args.verify_only:
                if args.skip_existing:
                    try:
                        verify(spec, args.data_dir)
                        print(f"[regen_all] {spec.name}: already verified "
                              "clean, skipping", flush=True)
                        continue
                    except Exception:
                        pass
                wall = generate(spec, args.data_dir, args.log_dir)
            stats = verify(spec, args.data_dir)
            row = {"metric": "datagen_fleet", "dataset": spec.name,
                   "scenes": spec.num_scenes, "frames": spec.num_frames,
                   "projection": spec.projection, "ok": True, **stats}
            if wall is not None:
                row["wall_s"] = round(wall, 1)
            record(row)
            print(f"[regen_all] {spec.name}: OK {stats['files']} "
                  f"wall={wall and round(wall)}s", flush=True)
        except Exception as e:
            failures.append((spec.name, str(e)))
            print(f"[regen_all] {spec.name}: FAILED — {e}", flush=True)
    if failures:
        sys.exit(f"regen_all: {len(failures)} dataset(s) failed: {failures}")
    print("[regen_all] fleet complete", flush=True)


if __name__ == "__main__":
    main()
