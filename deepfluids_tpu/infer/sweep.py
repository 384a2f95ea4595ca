"""Batched parameter-grid sweeps for the generator (arch "de").

Reference: SURVEY.md §3.2 — the reference swept the grid one sess.run per
frame; this sweeps in jit-compiled batches (the benchmark surface:
"velocity fields/sec" [B]) and writes the same artifacts: per-frame ``.npz``
fields plus vorticity/magnitude PNGs and GIFs.
"""

from __future__ import annotations

import os
from typing import Callable, Iterator, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from deepfluids_tpu.data.manifest import Manifest
from deepfluids_tpu.utils import save_field_image, save_gif


def param_grid(manifest: Manifest, counts: Sequence[int],
               num_frames: int | None = None) -> np.ndarray:
    """Full parameter grid in RAW units, frame param last.

    Args:
      manifest: dataset manifest (param ranges; last param = frame).
      counts: grid size per non-frame parameter (e.g. (21, 5)).
      num_frames: frames per scene (default manifest.num_frames).
    Returns:
      [prod(counts) * num_frames, num_param] raw params, frame-major within
      each scene (scene-by-scene contiguous, matching the reference's dump
      order).
    """
    t = num_frames or manifest.num_frames
    if len(counts) != manifest.num_param - 1:
        raise ValueError(
            f"counts has {len(counts)} entries but dataset has "
            f"{manifest.num_param - 1} non-frame parameters "
            f"({manifest.param_names[:-1]})")
    # n == 1 means "the range midpoint", not np.linspace's range minimum.
    axes = [np.array([(r[0] + r[1]) / 2.0]) if n == 1
            else np.linspace(r[0], r[1], n)
            for r, n in zip(manifest.param_ranges[:-1], counts)]
    frames = np.arange(t, dtype=np.float64)
    mesh = np.meshgrid(*axes, indexing="ij")
    scene_params = np.stack([m.ravel() for m in mesh], axis=1)
    out = np.concatenate(
        [np.concatenate(
            [np.repeat(sp[None], t, axis=0), frames[:, None]], axis=1)
         for sp in scene_params], axis=0)
    return out.astype(np.float32)


def sweep_generator(
    apply_fn: Callable[..., jnp.ndarray],
    manifest: Manifest,
    raw_params: np.ndarray,
    batch_size: int = 32,
    denormalize: bool = True,
    params=None,
) -> Iterator[np.ndarray]:
    """Yield generated fields for a raw-parameter list, in jitted batches.

    Args:
      apply_fn: jittable ``p_norm [B, P] -> field [B, *res, C]`` (curl
        already applied; normalized units).  The last partial batch is padded
        to ``batch_size`` so ONE compiled program serves the whole sweep.
      params: optional weight pytree; when given, ``apply_fn(params,
        p_norm)`` is called with the weights as an EXPLICIT jit argument.
        Closing over a big device pytree instead bakes it into the
        compiled program as constants — always pass weights here.
    """
    fn = jax.jit(apply_fn)
    n = raw_params.shape[0]
    p_norm = manifest.normalize_params(raw_params)
    for i in range(0, n, batch_size):
        chunk = p_norm[i:i + batch_size]
        pad = batch_size - chunk.shape[0]
        if pad:
            chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad, 0)])
        out = np.asarray(fn(jnp.asarray(chunk)) if params is None
                         else fn(params, jnp.asarray(chunk)))
        if pad:
            out = out[:-pad]
        if denormalize:
            out = manifest.denormalize_field(out)
        yield out


def sweep_on_device(
    apply_fn: Callable[..., jnp.ndarray],
    manifest: Manifest,
    raw_params: np.ndarray,
    batch_size: int = 512,
    max_out_bytes: int = 1 << 30,
    params=None,
) -> np.ndarray:
    """Whole parameter sweep as few scanned device programs.

    The host-loop sweep pays one dispatch and fetch per batch; this scans
    the grid in at most ceil(total_bytes / max_out_bytes) compiled calls
    (ONE call for anything under 1 GB; fields stay on device until one
    fetch per segment).

    Sweeps bigger than ``max_out_bytes`` (the full 3D grid is ~10 GB) are
    AUTOMATICALLY segmented: every segment has the same shape (one compile;
    the last is padded), and each fetch stays bounded while device memory
    holds one segment, not the sweep.

    Returns fields [N, *res, C] in RAW units (padding rows stripped).
    """
    n = raw_params.shape[0]
    p_norm = np.asarray(manifest.normalize_params(raw_params))
    field_bytes = 4 * int(np.prod(manifest.field_shape))
    seg_chunks = max(1, int(max_out_bytes // (field_bytes * batch_size)))
    fields_per_seg = min(seg_chunks * batch_size,
                         ((n + batch_size - 1) // batch_size) * batch_size)
    pad = (-n) % fields_per_seg
    if pad:
        p_norm = np.concatenate([p_norm, np.repeat(p_norm[-1:], pad, 0)])
    segs = p_norm.reshape(-1, fields_per_seg // batch_size, batch_size,
                          p_norm.shape[-1])

    @jax.jit
    def sweep(prm, chunks):
        def step(_, p):
            return None, (apply_fn(p) if params is None else apply_fn(prm, p))
        _, out = jax.lax.scan(step, None, chunks)
        return out

    # Fetch each segment in bounded slices so every transfer stays under
    # max_out_bytes even when a SINGLE batch exceeds it (huge batch_size x
    # 3D fields): slicing a device array fetches only the slice.
    rows_per_fetch = int(max_out_bytes // (field_bytes * batch_size))
    parts = []
    for seg in segs:
        dev = sweep(params, jnp.asarray(seg))          # [chunks, batch, *res, C]
        if rows_per_fetch >= 1:
            for i in range(0, dev.shape[0], rows_per_fetch):
                parts.append(np.asarray(dev[i:i + rows_per_fetch]).reshape(
                    (-1,) + manifest.field_shape))
        else:
            spf = max(1, int(max_out_bytes // field_bytes))
            for i in range(dev.shape[0]):      # one batch is itself > cap
                for j in range(0, batch_size, spf):
                    parts.append(np.asarray(dev[i, j:j + spf]))
    out = np.concatenate(parts).reshape((-1,) + manifest.field_shape)
    if pad:
        out = out[:-pad]
    return manifest.denormalize_field(out)


def _write_npz(path: str, level: int = 1, **arrays) -> None:
    """np.savez_compressed-compatible writer with a CHOSEN deflate level.

    numpy pins zlib's default level (~6); the reference-format artifact
    stream is write-bound on it.  Level 1 is ~4x faster within a few
    percent of the size on float fields, and np.load reads it identically.
    """
    import io
    import zipfile

    from numpy.lib import format as npfmt

    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED,
                         compresslevel=level) as zf:
        for name, arr in arrays.items():
            buf = io.BytesIO()
            npfmt.write_array(buf, np.asarray(arr), allow_pickle=False)
            zf.writestr(f"{name}.npy", buf.getvalue())


def run_test_sweep(
    apply_fn: Callable[..., jnp.ndarray],
    manifest: Manifest,
    out_dir: str,
    counts: Sequence[int] | None = None,
    num_frames: int | None = None,
    batch_size: int = 32,
    save_npz: bool = True,
    save_png_every: int = 0,
    gif_scenes: int = 1,
    params=None,
    write_workers: int = 16,
) -> dict:
    """Full parameter-grid sweep writing .npz fields (+ optional PNG/GIFs).

    Mirrors the reference's test() artifact layout: ``<out_dir>/<scene>_<frame>
    .npz`` with key ``x`` (raw-unit field) and ``y`` (raw params), vorticity
    PNGs every ``save_png_every`` frames, and a GIF for the first
    ``gif_scenes`` scenes.

    Artifact encoding runs on a ``write_workers``-thread pool (zlib/PNG
    release the GIL) overlapped with the device sweep — the end-to-end rate
    tracks the generator instead of serial host writes.  A bounded
    in-flight queue caps RAM at a few hundred frames.
    """
    import concurrent.futures as cf
    from collections import deque

    os.makedirs(out_dir, exist_ok=True)
    if counts is None:
        # Default: one value per non-frame param at range midpoint.
        counts = [1] * (manifest.num_param - 1)
    t = num_frames or manifest.num_frames
    raw = param_grid(manifest, counts, t)
    n = raw.shape[0]
    gif_scenes = min(gif_scenes, n // t)  # can't gif more scenes than swept
    mode = "levelset" if manifest.num_channels == 1 else "vorticity"

    pool = cf.ThreadPoolExecutor(max_workers=max(1, write_workers))
    pending: deque = deque()

    def submit(fn, *a, **kw):
        pending.append(pool.submit(fn, *a, **kw))
        while len(pending) > 8 * write_workers:  # bound in-flight frames
            pending.popleft().result()

    gif_frames: list[np.ndarray] = []
    idx = 0
    try:
        for batch in sweep_generator(apply_fn, manifest, raw, batch_size,
                                     params=params):
            for f in batch:
                scene, frame = divmod(idx, t)
                if save_npz:
                    submit(_write_npz,
                           os.path.join(out_dir, f"{scene}_{frame}.npz"),
                           x=f.astype(np.float32), y=raw[idx])
                if save_png_every and frame % save_png_every == 0:
                    submit(save_field_image,
                           os.path.join(out_dir, f"{scene}_{frame}.png"),
                           f, mode)
                if scene < gif_scenes:
                    gif_frames.append(f)
                idx += 1
        for s in range(gif_scenes):
            submit(save_gif, os.path.join(out_dir, f"scene{s}.gif"),
                   gif_frames[s * t:(s + 1) * t], mode)
        while pending:
            pending.popleft().result()
    finally:
        pool.shutdown(wait=True)
    return {"num_fields": n, "out_dir": out_dir}
