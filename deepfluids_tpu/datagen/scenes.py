"""Scene configs — dataset writers mirroring the reference's four scenes.

Each function sweeps its parameter grid, runs the JAX solver per scene, and
writes the reference's on-disk contract (SURVEY.md §2 "Scene:*", §3.5):

    data/<name>/v/<i0>_<i1>_<frame>.npz   (x = field, y = raw params)
    data/<name>/d/...                     (density, smoke scenes)
    data/<name>/args.txt                  (JSON manifest)

Parameter vectors follow the reference convention: last param is frame time.
Count overrides exist so tests can generate tiny datasets in seconds; the
full-size defaults match SURVEY §6's benchmark configs.
"""

from __future__ import annotations

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np

from deepfluids_tpu.data.manifest import Manifest, save_manifest
from deepfluids_tpu.datagen.liquid2d import (Liquid2DConfig,
                                             simulate_liquid2d,
                                             simulate_liquid2d_batch)
from deepfluids_tpu.datagen.smoke2d import (Smoke2DConfig, simulate_smoke2d,
                                            simulate_smoke2d_batch)
from deepfluids_tpu.datagen.smoke3d import (Smoke3DConfig, simulate_smoke3d,
                                            simulate_smoke3d_batch)


def _fresh_field_dirs(out_dir: str, keys: tuple[str, ...]) -> None:
    """Clear stale field dirs before (re)generation: leftover .npz from a
    previous, larger/different-resolution run would silently mix into the
    new dataset (glob picks up every file under v/)."""
    for k in keys:
        d = os.path.join(out_dir, k)
        if os.path.isdir(d):
            shutil.rmtree(d)


def _save_frames(out_dir, key, scene_idx, fields, params_per_frame,
                 frame_offset: int = 0):
    os.makedirs(os.path.join(out_dir, key), exist_ok=True)
    t = fields.shape[0]
    for f in range(t):
        name = "_".join(str(i) for i in scene_idx) + f"_{frame_offset + f}.npz"
        np.savez_compressed(
            os.path.join(out_dir, key, name),
            x=np.asarray(fields[f], np.float32),
            y=np.asarray(params_per_frame[f], np.float32),
        )


def _auto_scene_batch(accel_default: int) -> int:
    """Scenes solved per device program: mantaflow ran one C++ scene at a
    time; on an accelerator we vmap a chunk of scenes through one compiled
    solver (jit-compile once, amortize dispatch). 1 on CPU keeps tests
    light."""
    return accel_default if jax.default_backend() != "cpu" else 1


_FETCH_BYTES = 256 << 20  # max bytes per device->host fetch


def _fetch_scene(traj, n: int) -> np.ndarray:
    """Fetch one scene's trajectory ``traj[n]`` ([T, ...]) to host in frame
    chunks of <= _FETCH_BYTES.

    A whole 3D grid sweep is ~2 GB per device array; chunked slices keep
    every transfer (and its host staging buffer) bounded.
    """
    t = traj.shape[1]
    frame_bytes = traj.dtype.itemsize * int(np.prod(traj.shape[2:]))
    step = max(1, int(_FETCH_BYTES // max(frame_bytes, 1)))
    if step >= t:
        return np.asarray(traj[n])
    return np.concatenate(
        [np.asarray(traj[n, f:f + step]) for f in range(0, t, step)], axis=0)


def _run_grid_sweep(out_dir, sim_batch_fn, axis_a, axis_b, num_frames,
                    field_keys, scene_batch):
    """Shared chunked sweep over a 2-param grid of scenes.

    Args:
      sim_batch_fn: ``(a_vec [S], b_vec [S]) -> tuple of [S, T, ...]``
        trajectories, one per entry of ``field_keys``.
      axis_a/axis_b: the two raw parameter axes (np arrays).
      field_keys: output subdir per returned trajectory ("v", "d", "l"...).
    Returns:
      (min, max) over the FIRST returned trajectory (the manifest v_range).
    """
    _fresh_field_dirs(out_dir, field_keys)
    sb = scene_batch
    scene_list = [(i, j, float(a), float(b))
                  for i, a in enumerate(axis_a)
                  for j, b in enumerate(axis_b)]
    v_min, v_max = np.inf, -np.inf
    for k in range(0, len(scene_list), sb):
        chunk = scene_list[k:k + sb]
        pad = sb - len(chunk)  # pad to one shape -> ONE solver compile
        padded = chunk + [chunk[-1]] * pad
        avec = jnp.asarray([c[2] for c in padded], jnp.float32)
        bvec = jnp.asarray([c[3] for c in padded], jnp.float32)
        trajs = sim_batch_fn(avec, bvec)  # device arrays [S, T, ...]
        for n, (i, j, a, b) in enumerate(chunk):
            params = np.stack(
                [np.full(num_frames, a), np.full(num_frames, b),
                 np.arange(num_frames, dtype=np.float64)], axis=1)
            for ki, (key, traj) in enumerate(zip(field_keys, trajs)):
                arr = _fetch_scene(traj, n)
                if ki == 0:
                    v_min = min(v_min, float(arr.min()))
                    v_max = max(v_max, float(arr.max()))
                _save_frames(out_dir, key, (i, j), arr, params)
    return v_min, v_max


def smoke_pos21_size5(out_root: str, num_pos: int = 21, num_size: int = 5,
                      num_frames: int = 200, height: int = 128,
                      width: int = 96, name: str | None = None,
                      scene_batch: int = 0,
                      projection: str = "jacobi") -> str:
    """2D smoke plume: source x-position x source radius grid.

    Reference scene smoke_pos21_size5 (SURVEY §2): 21 x 5 x 200 frames on a
    128x96 grid; params p = [pos_x, radius, frame].

    projection="matched" generates frames ON the generator's manifold
    (discrete Leray projection, datagen/projection.py) — the round-3 fix
    for the solver-noise quality floor; "jacobi" reproduces the legacy
    datasets.
    """
    name = name or f"smoke_pos{num_pos}_size{num_size}"
    out_dir = os.path.join(out_root, name)
    cfg = Smoke2DConfig(height=height, width=width, num_frames=num_frames,
                        projection=projection)
    positions = np.linspace(0.2, 0.8, num_pos)
    radii = np.linspace(0.04, 0.12, num_size)

    def sim(pv, rv):
        vt, rt = simulate_smoke2d_batch(pv, rv, cfg)
        return vt, rt[..., None]

    v_min, v_max = _run_grid_sweep(
        out_dir, sim, positions, radii, num_frames, ("v", "d"),
        scene_batch or _auto_scene_batch(15))

    save_manifest(Manifest(
        param_names=["src_x_pos", "src_radius", "frame"],
        param_ranges=[[float(positions[0]), float(positions[-1])],
                      [float(radii[0]), float(radii[-1])],
                      [0.0, float(num_frames - 1)]],
        num_scenes=num_pos * num_size,
        num_frames=num_frames,
        resolution=[height, width],
        num_channels=2,
        v_range=[v_min, v_max],
        data_type="velocity",
        param_counts=[num_pos, num_size],
    ), out_dir)
    return out_dir


def smoke_mov(out_root: str, num_scenes: int = 200, num_frames: int = 400,
              height: int = 128, width: int = 96, seed: int = 0,
              name: str | None = None, projection: str = "jacobi") -> str:
    """2D moving-source smoke (reference smoke_mov200_f400, SURVEY §2).

    Source x-position follows a smooth random walk per scene; params
    p = [pos_x(t), frame] — the temporal dataset for AE + latent integration.
    """
    name = name or f"smoke_mov{num_scenes}_f{num_frames}"
    out_dir = os.path.join(out_root, name)
    _fresh_field_dirs(out_dir, ("v", "d"))
    cfg = Smoke2DConfig(height=height, width=width, num_frames=num_frames,
                        projection=projection)
    rng = np.random.default_rng(seed)
    radius = 0.08
    sb = _auto_scene_batch(10)

    # Smooth random source trajectories in [0.2, 0.8], one per scene.
    n_knots = max(num_frames // 40, 2)
    all_xs = np.stack([
        np.interp(np.linspace(0, n_knots - 1, num_frames),
                  np.arange(n_knots), rng.uniform(0.2, 0.8, size=n_knots))
        for _ in range(num_scenes)]).astype(np.float32)

    sim_batch = jax.jit(
        jax.vmap(lambda xs: simulate_smoke2d(
            xs[0], jnp.float32(radius), cfg, pos_x_per_frame=xs,
            moving=True)))

    v_min, v_max = np.inf, -np.inf
    for k in range(0, num_scenes, sb):
        chunk = list(range(k, min(k + sb, num_scenes)))
        pad = sb - len(chunk)
        xs_chunk = jnp.asarray(
            np.stack([all_xs[s] for s in chunk + [chunk[-1]] * pad]))
        vts, rts = sim_batch(xs_chunk)
        vts, rts = np.asarray(vts), np.asarray(rts)
        for o, s in enumerate(chunk):
            vt = vts[o]
            v_min = min(v_min, float(vt.min()))
            v_max = max(v_max, float(vt.max()))
            params = np.stack(
                [all_xs[s], np.arange(num_frames, dtype=np.float64)], axis=1
            )
            _save_frames(out_dir, "v", (s,), vt, params)
            _save_frames(out_dir, "d", (s,), rts[o][..., None], params)

    save_manifest(Manifest(
        param_names=["src_x_pos", "frame"],
        param_ranges=[[0.2, 0.8], [0.0, float(num_frames - 1)]],
        num_scenes=num_scenes,
        num_frames=num_frames,
        resolution=[height, width],
        num_channels=2,
        v_range=[v_min, v_max],
        data_type="velocity",
    ), out_dir)
    return out_dir


def liquid_pos10_size4(out_root: str, num_pos: int = 10, num_size: int = 4,
                       num_frames: int = 200, height: int = 128,
                       width: int = 96, name: str | None = None) -> str:
    """2D liquid drop: drop x-position x drop radius; levelset fields.

    Reference scene liquid_pos10_size4 (SURVEY §2) — the
    ``--data_type=levelset`` path; also dumps velocity under ``v/``.
    """
    name = name or f"liquid_pos{num_pos}_size{num_size}"
    out_dir = os.path.join(out_root, name)
    cfg = Liquid2DConfig(height=height, width=width, num_frames=num_frames)
    positions = np.linspace(0.25, 0.75, num_pos)
    radii = np.linspace(0.06, 0.15, num_size)

    def sim(pv, rv):
        phit, velt = simulate_liquid2d_batch(pv, rv, cfg)
        return phit, velt

    l_min, l_max = _run_grid_sweep(
        out_dir, sim, positions, radii, num_frames, ("l", "v"),
        _auto_scene_batch(10))

    save_manifest(Manifest(
        param_names=["drop_x_pos", "drop_radius", "frame"],
        param_ranges=[[float(positions[0]), float(positions[-1])],
                      [float(radii[0]), float(radii[-1])],
                      [0.0, float(num_frames - 1)]],
        num_scenes=num_pos * num_size,
        num_frames=num_frames,
        resolution=[height, width],
        num_channels=1,
        v_range=[l_min, l_max],
        data_type="levelset",
        param_counts=[num_pos, num_size],
    ), out_dir)
    return out_dir


def smoke3_vel5_buo3(out_root: str, num_vel: int = 5, num_buo: int = 3,
                     num_frames: int = 250, depth: int = 32, height: int = 64,
                     width: int = 112, name: str | None = None,
                     projection: str = "jacobi") -> str:
    """3D smoke: inflow velocity x buoyancy grid (reference
    smoke3_vel5_buo3_f250, SURVEY §2); grid [D,H,W] = [32,64,112].

    projection="matched" generates frames ON the 3D generator's manifold
    (datagen/projection.py) — the round-3 data-quality fix.
    """
    name = name or f"smoke3_vel{num_vel}_buo{num_buo}"
    out_dir = os.path.join(out_root, name)
    cfg = Smoke3DConfig(depth=depth, height=height, width=width,
                        num_frames=num_frames, projection=projection)
    vels = np.linspace(0.5, 1.5, num_vel)
    buos = np.linspace(0.04, 0.12, num_buo)

    # 3D trajectories are big (250 frames x 112x64x32x3 f32 ~= 690 MB per
    # scene) and a 250-frame scan is one long device program — run the
    # solver in SEGMENTS (state carried across calls, numerically identical
    # to one scan), fetching and writing each segment before the next.
    from deepfluids_tpu.datagen.smoke3d import simulate_smoke3d_segment_batch

    _fresh_field_dirs(out_dir, ("v", "d"))
    sb = _auto_scene_batch(3)
    seg = min(50, num_frames)
    scene_list = [(i, j, float(a), float(b))
                  for i, a in enumerate(vels)
                  for j, b in enumerate(buos)]
    v_min, v_max = np.inf, -np.inf
    for k in range(0, len(scene_list), sb):
        chunk = scene_list[k:k + sb]
        pad = sb - len(chunk)  # pad to one shape -> ONE solver compile
        padded = chunk + [chunk[-1]] * pad
        avec = jnp.asarray([c[2] for c in padded], jnp.float32)
        bvec = jnp.asarray([c[3] for c in padded], jnp.float32)
        vel = jnp.zeros((sb, depth, height, width, 3), jnp.float32)
        rho = jnp.zeros((sb, depth, height, width), jnp.float32)
        for f0 in range(0, num_frames, seg):
            # Full segments only (one compiled shape); surplus frames of the
            # final segment are computed and discarded.
            vel, rho, vt, rt = simulate_smoke3d_segment_batch(
                vel, rho, avec, bvec, cfg, seg)
            keep = min(seg, num_frames - f0)
            for n, (i, j, a, b) in enumerate(chunk):
                frames = np.arange(f0, f0 + keep, dtype=np.float64)
                params = np.stack(
                    [np.full(keep, a), np.full(keep, b), frames], axis=1)
                varr = _fetch_scene(vt, n)[:keep]
                v_min = min(v_min, float(varr.min()))
                v_max = max(v_max, float(varr.max()))
                _save_frames(out_dir, "v", (i, j), varr, params,
                             frame_offset=f0)
                _save_frames(out_dir, "d", (i, j),
                             _fetch_scene(rt, n)[:keep, ..., None], params,
                             frame_offset=f0)

    save_manifest(Manifest(
        param_names=["inflow_vel", "buoyancy", "frame"],
        param_ranges=[[float(vels[0]), float(vels[-1])],
                      [float(buos[0]), float(buos[-1])],
                      [0.0, float(num_frames - 1)]],
        num_scenes=num_vel * num_buo,
        num_frames=num_frames,
        resolution=[depth, height, width],
        num_channels=3,
        v_range=[v_min, v_max],
        data_type="velocity",
        param_counts=[num_vel, num_buo],
    ), out_dir)
    return out_dir


SCENES = {
    "smoke_pos21_size5": smoke_pos21_size5,
    "smoke_mov": smoke_mov,
    "liquid_pos10_size4": liquid_pos10_size4,
    "smoke3_vel5_buo3": smoke3_vel5_buo3,
}
