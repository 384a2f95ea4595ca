"""GeneratorBE — the parameterized field decoder (arch "de").

Reference: deep-fluids ``model.py:GeneratorBE`` (SURVEY.md §2 [M][B]): a
BEGAN-style decoder mapping a parameter/latent vector to a stream function
(2D, 1 channel) or vector potential (3D, 3 channels):

    z -> linear -> reshape to coarse grid [H0, W0, filters]
      -> repeat x { num_conv 3x3 convs (lrelu) + skip from stage input
                    + 2x nearest-neighbor upsample (except last stage) }
      -> final 3x3 conv to out_channels (no activation)

The curl that turns the emitted potential into a divergence-free velocity is
applied OUTSIDE the network (by the loss/inference wrapper), matching the
reference's ``use_curl`` wiring (SURVEY.md §3.1).

Convolutions are lowered by XLA (cuDNN on the GPU); channel counts default
to 128.  The module is shape-static and jit/vmap/pjit friendly; works for 2D
([B, H, W, C]) and 3D ([B, D, H, W, C]) via ``output_shape``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from deepfluids_tpu.models.layers import (Module, Scope, conv, dense,
                                          leaky_relu, normal, zeros)


def spatial_constraint(x: jnp.ndarray, mesh) -> jnp.ndarray:
    """Pin a feature map's sharding under --spatial_shard training.

    Axis 1 (H in 2D, D in 3D) is sharded over the mesh's data axis when
    cleanly divisible; otherwise the map is REPLICATED.  Replication of the
    indivisible coarse stages is load-bearing, not just tidy: GSPMD pads
    indivisible shards, and the padded conv grad-filter computation
    double-counts halo rows (observed: exact-2x kernel gradients on the
    coarse decoder stage of a depth-4 grid over 8 devices).  Coarse grids
    are tiny, so replicating them costs nothing.
    """
    if mesh is None:
        return x
    from jax.sharding import NamedSharding, PartitionSpec as P

    n = mesh.shape["data"]
    spec = (P(None, "data")
            if x.ndim >= 3 and x.shape[1] % n == 0 else P())
    return jax.lax.with_sharding_constraint(x, NamedSharding(mesh, spec))


def default_repeat(output_shape: Sequence[int]) -> int:
    """Number of conv stages for a given output shape (spatial dims + channel).

    Matches the reference's derivation (SURVEY.md §2): repeat = log2(max
    spatial extent) - 2, so the coarse grid is max_extent / 2**(repeat-1)
    (e.g. 128x96 -> repeat 5, coarse 8x6; 112x64x32 -> repeat 4, coarse
    14x8x4).
    """
    return int(math.log2(max(output_shape[:-1]))) - 2


def fourier_embed(z: jnp.ndarray, bands: int) -> jnp.ndarray:
    """Fourier-feature embedding of a parameter vector (additive capability).

    [B, P] -> [B, P*(2*bands+1)]: z concatenated with sin/cos(2^k pi z) for
    k = 0..bands-1.  The reference feeds raw params through a single linear
    layer (SURVEY.md §2 "Generator"), which caps how much high-frequency
    temporal detail the decoder can express along the ``frame`` axis — the
    measured error profile concentrates on the fast-evolving plume frames.
    Params are normalized to [-1, 1], so band k spans 2^k half-periods over
    an axis's range.  Off (bands=0) by default for reference parity.
    """
    if bands <= 0:
        return z
    k = 2.0 ** jnp.arange(bands, dtype=z.dtype) * jnp.pi
    ang = z[..., None] * k                      # [B, P, bands]
    feats = jnp.concatenate(
        [jnp.sin(ang), jnp.cos(ang)], axis=-1)  # [B, P, 2*bands]
    return jnp.concatenate(
        [z, feats.reshape(z.shape[:-1] + (-1,))], axis=-1)


@dataclasses.dataclass(frozen=True)
class SpectralResidual(Module):
    """Learned global filter over the lowest Fourier modes, as a residual.

    Additive capability (no reference analogue; off by default).  The
    config #2 error analysis (BENCHMARKS.md "quality plateau, diagnosed")
    localized the architecture floor to interior, LOW-frequency residuals:
    the conv pyramid's 3x3 receptive fields refine global structure slowly.
    This layer multiplies the lowest modes ``|k| < modes`` of each channel
    by learned complex gains — a learned global convolution, the
    channel-diagonal (parameter-cheap) core of an FNO spectral layer — and
    adds the result back.  Zero-init: starts as identity, so training
    dynamics match the baseline until the filter learns (same rationale as
    the latent head zero-init).

    With only K = 2*modes-1 retained modes per axis, the truncated DFT is a
    [N, K] matmul per spatial axis (separable einsums against precomputed
    cos/sin bases) rather than an FFT — it needs no complex dtype and costs
    O(N·K) instead of O(N log N) with K << N.  Complex arithmetic is carried
    as explicit (re, im) pairs; computed in f32, residual cast back to the
    compute dtype.
    """

    modes: int = 8

    def __call__(self, s: Scope, x: jnp.ndarray) -> jnp.ndarray:
        spatial = x.shape[1:-1]
        ch = x.shape[-1]
        ndim = len(spatial)
        xr = x.astype(jnp.float32)
        xi = jnp.zeros_like(xr)

        # Per-axis truncated-DFT bases over the symmetric low-mode set
        # {-(modes-1), ..., 0, ..., modes-1} (clipped to the axis size).
        fw, inv, ks = [], [], []
        for n in spatial:
            m = min(self.modes, (n + 1) // 2)
            freqs = np.concatenate([np.arange(m), np.arange(-(m - 1), 0)])
            ang = 2.0 * np.pi * np.outer(np.arange(n), freqs) / n  # [N, K]
            e_c = jnp.asarray(np.cos(ang), jnp.float32)
            e_s = jnp.asarray(np.sin(ang), jnp.float32)
            fw.append((e_c, -e_s))                # [N, K], exp(-i ang)
            inv.append((e_c.T / n, e_s.T / n))    # [K, N], exp(+i ang)/N
            ks.append(len(freqs))

        def contract(re, im, basis, axis):
            bc, bs = basis
            # einsum over the given spatial axis: [.., N, ..] x [N, K]
            sub = "abcde"[:re.ndim]
            eq = f"{sub},{sub[axis]}z->{sub.replace(sub[axis], 'z')}"
            rr, ri = jnp.einsum(eq, re, bc), jnp.einsum(eq, re, bs)
            ir, ii = jnp.einsum(eq, im, bc), jnp.einsum(eq, im, bs)
            return rr - ii, ri + ir           # (a+ib)(c+is)

        for ax in range(ndim):
            xr, xi = contract(xr, xi, fw[ax], 1 + ax)

        gr = s.param("gain_re", zeros, tuple(ks) + (ch,))
        gi = s.param("gain_im", zeros, tuple(ks) + (ch,))
        xr, xi = xr * gr - xi * gi, xr * gi + xi * gr

        for ax in range(ndim):
            xr, xi = contract(xr, xi, inv[ax], 1 + ax)
        return x + xr.astype(x.dtype)


def _interp_grid(table: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
    """Multilinear interpolation of a dense feature table at query points.

    table: [k_0, ..., k_{P-1}, F] knots over the normalized param domain
    [-1, 1]^P; p: [B, P] queries (clipped to the domain).  2^P corner
    gathers + a weighted sum — static shapes, XLA-friendly (each corner is
    one gather, the weights are elementwise) — a lookup, not a matmul.
    """
    import itertools

    num_p = p.shape[-1]
    sizes = jnp.asarray(table.shape[:-1], jnp.float32)
    t = jnp.clip((p + 1.0) * 0.5, 0.0, 1.0) * (sizes - 1.0)   # [B, P]
    i0 = jnp.clip(jnp.floor(t).astype(jnp.int32), 0,
                  jnp.asarray(table.shape[:-1], jnp.int32) - 2)
    w = t - i0                                                # [B, P]
    out = jnp.zeros(p.shape[:-1] + (table.shape[-1],), table.dtype)
    for corner in itertools.product((0, 1), repeat=num_p):
        idx = tuple(i0[..., d] + corner[d] for d in range(num_p))
        weight = jnp.prod(
            jnp.stack([w[..., d] if corner[d] else 1.0 - w[..., d]
                       for d in range(num_p)], axis=-1), axis=-1)
        out = out + table[idx] * weight[..., None]
    return out


@dataclasses.dataclass(frozen=True)
class MultiResParamGrid(Module):
    """Multi-resolution learned feature grids over the PARAMETER domain.

    Beyond-reference capability (no deep-fluids analogue): level ``l`` is a
    dense table with ``base * 2**l + 1`` knots per param axis, multilinearly
    interpolated at the (normalized) parameter vector; level outputs are
    concatenated.  Coarse levels carve the smooth global structure of the
    (position, size, frame) -> field map, fine levels give the decoder a
    piecewise-linear handle on fast frame-axis dynamics that a single
    linear fc_in cannot express (the measured error concentrates there —
    BENCHMARKS.md "quality plateau, diagnosed").
    """

    levels: int = 4
    features: int = 4
    base: int = 2

    def __call__(self, s: Scope, p: jnp.ndarray) -> jnp.ndarray:
        num_p = p.shape[-1]
        feats = []
        for lvl in range(self.levels):
            knots = self.base * 2 ** lvl + 1
            table = s.param(f"grid_{lvl}", normal(1e-2),
                            (knots,) * num_p + (self.features,))
            feats.append(_interp_grid(table, p.astype(jnp.float32)))
        return jnp.concatenate(feats, axis=-1)


def upscale_nearest(x: jnp.ndarray, factor: int = 2) -> jnp.ndarray:
    """Nearest-neighbor spatial upsampling for NHWC / NDHWC tensors.

    Implemented as reshape+broadcast (each cell repeated ``factor`` times per
    spatial axis) — identical semantics to TF1 ``resize_nearest_neighbor`` at
    integer factors, and cheaper than a gather for XLA to fuse.
    """
    spatial = x.shape[1:-1]
    out = x
    # Insert a broadcast axis after each spatial dim, then collapse.
    for ax in range(1, 1 + len(spatial)):
        out = jnp.repeat(out, factor, axis=ax)
    return out


@dataclasses.dataclass(frozen=True)
class GeneratorBE(Module):
    """Parameter/latent vector -> stream function / vector potential field.

    Attributes:
      output_shape: spatial dims + output channels, e.g. (128, 96, 1) for 2D
        stream function or (32, 64, 112, 3) for a 3D vector potential.
      filters: conv width (reference default 128).
      num_conv: convs per stage (reference default 4).
      repeat: number of stages; 0 -> derived via :func:`default_repeat`.
      act_slope: LeakyReLU negative slope.
      dtype: compute dtype (bf16 for speed; params stay f32).
      spatial_mesh: when set (--spatial_shard), stage activations are
        sharding-constrained via :func:`spatial_constraint`.
      embed_bands: >0 applies :func:`fourier_embed` to the input vector
        (widens fc_in only; 0 = reference-parity).
      spectral_modes: >0 appends a zero-init :class:`SpectralResidual`
        global filter to each stage's conv stack (0 = reference-parity).
      grid_levels/grid_features: >0 activates the "grid" decoder family
        (--decoder grid): a :class:`MultiResParamGrid` embedding widens
        fc_in, and every stage receives a parameter-conditioned LOW-RANK
        SPATIAL BASIS injection (see below).  0 = reference-parity.
      grid_rank: rank of the per-stage spatial basis (grid decoder).

    Grid decoder family (beyond-reference; targets the ~0.215 overfit
    floor of the BE conv pyramid, BENCHMARKS.md "quality plateau,
    diagnosed"): the BE family must synthesize ALL spatial detail from an
    8x6 seed through 3x3 convs + nearest upsampling — interior
    low-frequency residuals converge slowly.  Here each stage k of
    resolution (H_k, W_k) additionally gets

        inject_k = zero-init 1x1 conv( a_k(p) . B_k )

    where B_k is a LEARNED basis of ``grid_rank`` spatial feature maps at
    the stage's own resolution and a_k(p) = Dense(grid_rank) of the
    grid-embedded params — i.e. parameter-modulated global basis fields
    at every scale, the low-rank core of a multi-resolution feature-grid
    decoder.  Zero-init keeps the forward pass equal to the BE trunk at
    step 0, so optimization starts from the known-good family.
    """

    output_shape: tuple[int, ...] = (128, 96, 1)
    filters: int = 128
    num_conv: int = 4
    repeat: int = 0
    act_slope: float = 0.2
    dtype: jnp.dtype = jnp.float32
    spatial_mesh: Any = None
    embed_bands: int = 0
    spectral_modes: int = 0
    grid_levels: int = 0
    grid_features: int = 0
    grid_rank: int = 0

    def __call__(self, s: Scope, z: jnp.ndarray) -> jnp.ndarray:
        spatial = self.output_shape[:-1]
        out_ch = self.output_shape[-1]
        rep = self.repeat or default_repeat(self.output_shape)
        ndim = len(spatial)
        kernel = (3,) * ndim
        coarse = tuple(int(s) // 2 ** (rep - 1) for s in spatial)
        assert all(c * 2 ** (rep - 1) == s for c, s in zip(coarse, spatial)), (
            f"spatial dims {spatial} must be divisible by 2**(repeat-1)="
            f"{2 ** (rep - 1)}"
        )

        act = lambda v: leaky_relu(v, negative_slope=self.act_slope)

        z_raw = z   # the grid interpolates the RAW parameter vector: its
        # table is (knots,)**P, so feeding the fourier-EMBEDDED vector
        # would exponentiate the table size by (2*bands+1) — with
        # embed_bands=0 (the default) raw and embedded coincide.
        z = fourier_embed(z, self.embed_bands)
        grid_on = self.grid_levels > 0 and self.grid_features > 0
        if grid_on:
            z = jnp.concatenate(
                [z, MultiResParamGrid(self.grid_levels, self.grid_features)(
                    s.child("param_grid"), z_raw)], axis=-1)
        x = dense(s.child("fc_in"), z, int(np.prod(coarse)) * self.filters,
                  self.dtype)
        x = x.reshape((-1,) + coarse + (self.filters,))
        x = spatial_constraint(x, self.spatial_mesh)
        x0 = x
        for stage in range(rep):
            if grid_on and self.grid_rank > 0:
                x = x + self._basis_inject(s, z, x.shape[1:-1], ndim, stage)
                x = spatial_constraint(x, self.spatial_mesh)
            for c in range(self.num_conv):
                x = act(conv(s.child(f"conv_{stage}_{c}"), x, self.filters,
                             kernel, self.dtype))
                x = spatial_constraint(x, self.spatial_mesh)
            if self.spectral_modes > 0:
                x = SpectralResidual(self.spectral_modes)(
                    s.child(f"spectral_{stage}"), x)
                x = spatial_constraint(x, self.spatial_mesh)
            if stage < rep - 1:
                x = upscale_nearest(x + x0, 2)
                x = spatial_constraint(x, self.spatial_mesh)
                x0 = x
            else:
                x = x + x0
        out = conv(s.child("conv_out"), x, out_ch, kernel, self.dtype)
        return spatial_constraint(out, self.spatial_mesh).astype(jnp.float32)

    def _basis_inject(self, s: Scope, z: jnp.ndarray, res: tuple[int, ...],
                      ndim: int, stage: int) -> jnp.ndarray:
        """Parameter-modulated spatial basis for one stage (grid decoder):
        a_k(p) [B, R] contracted with basis B_k [R, *res, F], projected to
        ``filters`` by a 1x1 conv.  The BASIS is zero-init (injection = 0
        at step 0, so the forward pass starts exactly on the BE trunk)
        while the projection is normally-init — gradients reach the basis
        through the live projection immediately, instead of stalling
        behind a zero layer (the reverse placement measurably starves the
        basis: its grads are exactly 0 until the projection moves)."""
        a = dense(s.child(f"coef_{stage}"), z, self.grid_rank, jnp.float32)
        basis = s.param(
            f"basis_{stage}", zeros,
            (self.grid_rank,) + tuple(res) + (self.grid_features,))
        sub = "dhw"[3 - ndim:]
        inj = jnp.einsum(f"br,r{sub}f->b{sub}f", a, basis)
        return conv(s.child(f"inj_{stage}"), inj, self.filters, (1,) * ndim,
                    self.dtype, use_bias=False)
