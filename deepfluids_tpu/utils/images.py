"""Field visualization: vorticity/magnitude PNGs, montages, GIFs.

Reference: deep-fluids ``util.py`` ``save_image`` + trainer test dumps
(SURVEY.md §2 "Util", L5 visualization layer [M]) — velocity fields rendered
as vorticity (diverging colormap) or magnitude images, tiled into grids
during training, assembled into GIFs for parameter/time sweeps.

Colorization is pure numpy (no matplotlib dependency in the hot path).
PNGs are written with the standard library's zlib; GIFs with a fixed
256-colour palette (3-3-2 bits of R, G, B).
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Sequence

import numpy as np

from deepfluids_tpu.ops import fd


def _colorize_diverging(x: np.ndarray, vmax: float | None = None) -> np.ndarray:
    """Signed scalar [H, W] -> uint8 RGB, blue-white-red diverging map."""
    vmax = vmax or (np.abs(x).max() + 1e-8)
    t = np.clip(x / vmax, -1.0, 1.0)
    r = np.where(t >= 0, 1.0, 1.0 + t)
    g = 1.0 - np.abs(t)
    b = np.where(t <= 0, 1.0, 1.0 - t)
    return (np.stack([r, g, b], axis=-1) * 255).astype(np.uint8)


def _colorize_magnitude(x: np.ndarray, vmax: float | None = None) -> np.ndarray:
    """Nonnegative scalar [H, W] -> uint8 RGB, black-body-style ramp."""
    vmax = vmax or (x.max() + 1e-8)
    t = np.clip(x / vmax, 0.0, 1.0)
    r = np.clip(3.0 * t, 0, 1)
    g = np.clip(3.0 * t - 1.0, 0, 1)
    b = np.clip(3.0 * t - 2.0, 0, 1)
    return (np.stack([r, g, b], axis=-1) * 255).astype(np.uint8)


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data)))


def write_png(path: str, rgb: np.ndarray) -> str:
    """Write an [H, W, 3] uint8 image as an 8-bit RGB PNG."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w, _ = rgb.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),   # filter type 0
                           rgb.reshape(h, w * 3)], axis=1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2,
                                                0, 0, 0)))
        f.write(_png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_png_chunk(b"IEND", b""))
    return path


# GIF palette: index = RRRGGGBB, each level mapped to the middle of its bin.
_GIF_PALETTE = np.stack(np.meshgrid(
    np.arange(8) * 32 + 16, np.arange(8) * 32 + 16, np.arange(4) * 64 + 32,
    indexing="ij"), -1).reshape(256, 3).astype(np.uint8)
_GIF_RUN = 250   # literal codes between LZW clears (keeps codes 9 bits)


def _gif_quantize(rgb: np.ndarray) -> np.ndarray:
    r, g, b = (rgb[..., i].astype(np.uint16) for i in range(3))
    return ((r >> 5) << 5 | (g >> 5) << 2 | (b >> 6)).astype(np.uint16)


def _gif_lzw(indices: np.ndarray) -> bytes:
    """LZW-coded image data at a fixed 9-bit code size.

    Every pixel is sent as its own literal code and a clear code follows
    each ``_GIF_RUN`` literals, before the decoder's table could outgrow 9
    bits.  That trades compression for a vectorised encoder; any GIF
    decoder reads the result."""
    clear, eoi = 256, 257
    px = indices.ravel()
    n_runs = -(-px.size // _GIF_RUN)
    codes = np.full(n_runs * (_GIF_RUN + 1), eoi, np.uint16)
    body = codes.reshape(n_runs, _GIF_RUN + 1)
    body[:, 0] = clear
    flat = np.full(n_runs * _GIF_RUN, eoi, np.uint16)
    flat[:px.size] = px
    body[:, 1:] = flat.reshape(n_runs, _GIF_RUN)
    codes = np.concatenate([codes[codes != eoi], [eoi]]).astype(np.uint16)
    bits = ((codes[:, None] >> np.arange(9)) & 1).astype(np.uint8).ravel()
    data = np.packbits(bits, bitorder="little").tobytes()
    # Sub-blocks of at most 255 bytes, then a zero-length terminator.
    blocks = b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                      for i in range(0, len(data), 255))
    return bytes([8]) + blocks + b"\x00"


def write_gif(path: str, frames: Sequence[np.ndarray], fps: int = 24) -> str:
    """Write [H, W, 3] uint8 frames as a looping GIF89a animation."""
    h, w, _ = frames[0].shape
    delay = max(1, round(100 / fps))   # hundredths of a second
    with open(path, "wb") as f:
        f.write(b"GIF89a" + struct.pack("<HHBBB", w, h, 0xF7, 0, 0))
        f.write(_GIF_PALETTE.tobytes())
        f.write(b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00")  # loop
        for fr in frames:
            f.write(b"\x21\xf9\x04\x04" + struct.pack("<H", delay)
                    + b"\x00\x00")
            f.write(b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0))
            f.write(_gif_lzw(_gif_quantize(np.asarray(fr, np.uint8))))
        f.write(b"\x3b")
    return path


def _np_fdiff(x: np.ndarray, axis: int) -> np.ndarray:
    """numpy twin of ops.fd._fdiff (forward diff, last-derivative edge
    replication) — bit-identical values with zero device dispatches, so
    threaded artifact writers never wait on the device."""
    d = np.diff(x, axis=axis)
    idx = [slice(None)] * x.ndim
    idx[axis] = slice(-1, None)
    return np.concatenate([d, d[tuple(idx)]], axis=axis)


def _np_vorticity2d(field: np.ndarray) -> np.ndarray:
    """dvdx - dudy of [H, W, 2] (matches ops.fd.vorticity2d exactly)."""
    return (_np_fdiff(field[..., 1], axis=-1)
            - _np_fdiff(field[..., 0], axis=-2))


def _render_scalar(field: np.ndarray, mode: str,
                   projection: str) -> tuple[np.ndarray, bool]:
    """The 2D scalar a field renders as, pre-colorization.

    Returns (scalar [H, W], diverging?) — diverging scalars colorize
    blue-white-red by |max|, magnitudes black-body by max.  Shared by
    :func:`field_to_image` and :func:`save_gif`'s global-scale pass so
    ``vmax`` always lives in the RENDERED quantity's units.
    """
    field = np.asarray(field, np.float32)
    if field.ndim == 4:  # 3D volume -> 2D plane
        if projection == "max":
            if mode == "vorticity" and field.shape[-1] == 3:
                # |vorticity| per voxel, max over depth; signed look kept
                # by projecting the in-plane component with largest |w|.
                vort = np.asarray(fd.vorticity3d(field[None])[0])
                wmag = np.linalg.norm(vort, axis=-1)     # [D, H, W]
                d_idx = wmag.argmax(axis=0)              # [H, W]
                hh, ww = np.indices(d_idx.shape)
                return vort[..., 2][d_idx, hh, ww], True
            return np.linalg.norm(field, axis=-1).max(axis=0), False
        field = field[field.shape[0] // 2]  # mid-depth slice
    if mode == "vorticity" and field.shape[-1] >= 2:
        return _np_vorticity2d(field[..., :2]), True
    if mode == "magnitude":
        return np.linalg.norm(field, axis=-1), False
    return field[..., 0], True  # levelset / generic scalar


def field_to_image(field: np.ndarray, mode: str = "vorticity",
                   vmax: float | None = None,
                   projection: str = "slice") -> np.ndarray:
    """Render one field to an RGB uint8 image (origin flipped so +y is up).

    Args:
      field: [H, W, C] (2D) or [D, H, W, C] (3D).
      mode: "vorticity" | "magnitude" | "levelset" | "scalar".
      projection: 3D-to-2D reduction — "slice" (mid-depth plane, the
        cheap default) or "max" (volume rendering via maximum-intensity
        projection of |vorticity| / magnitude along depth — the qualitative
        3D render surface the reference's paper figures used).
    """
    scalar, diverging = _render_scalar(field, mode, projection)
    img = (_colorize_diverging(scalar, vmax) if diverging
           else _colorize_magnitude(scalar, vmax))
    return img[::-1]  # flip y so the plume rises upward in the PNG


def save_field_image(path: str, field: np.ndarray, mode: str = "vorticity",
                     vmax: float | None = None,
                     projection: str = "slice") -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    return write_png(path, field_to_image(field, mode, vmax, projection))


def save_image_grid(path: str, fields: Sequence[np.ndarray], ncol: int = 0,
                    mode: str = "vorticity", vmax: float | None = None,
                    projection: str = "slice") -> str:
    """Tile several fields into one PNG montage (reference save_image)."""
    imgs = [field_to_image(f, mode, vmax, projection) for f in fields]
    n = len(imgs)
    ncol = ncol or int(np.ceil(np.sqrt(n)))
    nrow = int(np.ceil(n / ncol))
    h, w, _ = imgs[0].shape
    grid = np.zeros((nrow * h, ncol * w, 3), np.uint8)
    for i, im in enumerate(imgs):
        r, c = divmod(i, ncol)
        grid[r * h:(r + 1) * h, c * w:(c + 1) * w] = im
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    return write_png(path, grid)


def save_gif(path: str, fields: Sequence[np.ndarray], mode: str = "vorticity",
             vmax: float | None = None, fps: int = 24,
             projection: str = "slice") -> str:
    """Assemble a field sequence into a GIF (reference test-time sweeps).

    ``vmax=None`` computes ONE shared scale over the whole sequence —
    per-frame auto-normalization would recenter the colors every frame
    (a decaying plume renders at constant full saturation and the
    temporal evolution the GIF exists to show is erased)."""
    if vmax is None:
        vmax = max((float(np.abs(_render_scalar(f, mode, projection)[0])
                          .max()) for f in fields), default=0.0) or None
    frames = [field_to_image(f, mode, vmax, projection) for f in fields]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    return write_gif(path, frames, fps)
