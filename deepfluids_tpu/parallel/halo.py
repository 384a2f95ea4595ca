"""Spatially-sharded finite-difference stencils with halo exchange.

SURVEY.md §2's parallelism table maps the reference's (absent) sequence/
context parallelism to **spatial sharding of grids with halo exchange** —
the capability that matters once fields outgrow one device's memory (large
3D grids), even though the reference resolutions don't need it.

Scheme: the grid's H (y) axis is sharded over the mesh's data axis.  The
forward difference ``d[i] = x[i+1] - x[i]`` needs each shard's successor's
FIRST row — one `ppermute` neighbor shift per field.  The global last row keeps the oracle's edge replication.  Everything
is `shard_map`-ped, so XLA overlaps the halo transfer with local compute.

The jnp oracle (`ops.fd`) remains the semantic reference: for any
replicated input, gathering the sharded result must equal the oracle's
(pinned by tests/test_parallel.py on the 8-device CPU mesh).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from deepfluids_tpu.ops.fd import _fdiff as _fdiff_local
from deepfluids_tpu.parallel.mesh import DATA_AXIS


def _fdiff_h_sharded(x_local: jnp.ndarray, axis_name: str) -> jnp.ndarray:
    """Forward diff along sharded axis 1 with edge replication at the
    global end.

    Two-sided halo: one ppermute brings the successor's FIRST row (for the
    forward diff) and one brings the predecessor's LAST row (for the
    backward diff used at the global last row).  The backward diff comes
    from the extended buffer — NOT from rolling the local diffs — so the
    result stays correct when the local shard holds a single row
    (axis size == number of shards)."""
    idx = jax.lax.axis_index(axis_name)
    n = jax.lax.axis_size(axis_name)
    h_loc = x_local.shape[1]
    fwd_perm = [(i, (i - 1) % n) for i in range(n)]
    nxt = jax.lax.ppermute(x_local[:, :1], axis_name, fwd_perm)
    if h_loc >= 2:
        # The backward diff at the global last row only needs LOCAL rows
        # when the shard holds >= 2 of them — skip the predecessor
        # transfer entirely (one less collective per stencil call).
        ext = jnp.concatenate([x_local, nxt], axis=1)   # [B, H_loc+1, ...]
        fwd = ext[:, 1:] - ext[:, :-1]                  # x[j+1] - x[j]
        bwd = jnp.concatenate([fwd[:, :1],              # row 0 never "last"
                               ext[:, 1:-1] - ext[:, :-2]], axis=1)
    else:
        bwd_perm = [(i, (i + 1) % n) for i in range(n)]
        prv = jax.lax.ppermute(x_local[:, -1:], axis_name, bwd_perm)
        ext = jnp.concatenate([prv, x_local, nxt], axis=1)
        fwd = ext[:, 2:] - ext[:, 1:-1]                 # x[j+1] - x[j]
        bwd = ext[:, 1:-1] - ext[:, :-2]                # x[j] - x[j-1]
    row = jax.lax.broadcasted_iota(jnp.int32, fwd.shape, 1)
    is_global_last = (idx == n - 1) & (row == h_loc - 1)
    return jnp.where(is_global_last, bwd, fwd)


def _fdiff_w(x_local: jnp.ndarray) -> jnp.ndarray:
    """Forward diff along (unsharded) W with edge replication — the
    oracle scheme, axis 2 (see ops.fd._fdiff)."""
    return _fdiff_local(x_local, 2)


_SPEC = P(None, DATA_AXIS)


def curl2d_sharded(psi: jnp.ndarray, mesh: Mesh) -> jnp.ndarray:
    """H-sharded :func:`deepfluids_tpu.ops.fd.curl2d`.

    Args:
      psi: ``[B, H, W, 1]`` with H divisible by the data-axis size.
    Returns:
      ``[B, H, W, 2]`` velocity, sharded the same way.
    """
    def f(p):
        u = _fdiff_h_sharded(p[..., 0:1], DATA_AXIS)
        v = -_fdiff_w(p[..., 0:1])
        return jnp.concatenate([u, v], axis=-1)

    return shard_map(f, mesh=mesh, in_specs=(_SPEC,), out_specs=_SPEC)(psi)


def jacobian2d_sharded(x: jnp.ndarray, mesh: Mesh
                       ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """H-sharded :func:`deepfluids_tpu.ops.fd.jacobian2d` ([B,H,W,2] input)."""
    def f(v):
        dudx = _fdiff_w(v[..., 0:1])
        dudy = _fdiff_h_sharded(v[..., 0:1], DATA_AXIS)
        dvdx = _fdiff_w(v[..., 1:2])
        dvdy = _fdiff_h_sharded(v[..., 1:2], DATA_AXIS)
        j = jnp.concatenate([dudx, dudy, dvdx, dvdy], axis=-1)
        w = dvdx - dudy
        return j, w

    return shard_map(f, mesh=mesh, in_specs=(_SPEC,),
                     out_specs=(_SPEC, _SPEC))(x)


def divergence2d_sharded(x: jnp.ndarray, mesh: Mesh) -> jnp.ndarray:
    """H-sharded forward-difference divergence (matched to curl2d_sharded)."""
    def f(v):
        return (_fdiff_w(v[..., 0:1])
                + _fdiff_h_sharded(v[..., 1:2], DATA_AXIS))

    return shard_map(f, mesh=mesh, in_specs=(_SPEC,), out_specs=_SPEC)(x)


# ---------------------------------------------------------------------------
# 3D: depth-sharded stencils (SURVEY.md §7 "3D halo exchange for sharded
# 112x64x32 grids").  D (z) is the sharded axis — one ppermute halo
# slice per z-derivative; in-plane derivatives stay local.
# ---------------------------------------------------------------------------


def _fdiff_d_sharded(x_local: jnp.ndarray, axis_name: str) -> jnp.ndarray:
    """Forward diff along sharded D of [B, D_loc, H, W, C] — identical
    scheme to :func:`_fdiff_h_sharded` (both act on axis 1)."""
    return _fdiff_h_sharded(x_local, axis_name)


def curl3d_sharded(psi: jnp.ndarray, mesh: Mesh) -> jnp.ndarray:
    """D-sharded :func:`deepfluids_tpu.ops.fd.curl3d`.

    Args:
      psi: ``[B, D, H, W, 3]`` with D divisible by the data-axis size.
    Returns:
      ``[B, D, H, W, 3]`` velocity, sharded the same way.
    """
    def f(p):
        a, b, c = p[..., 0:1], p[..., 1:2], p[..., 2:3]
        dady = _fdiff_local(a, 2)
        dadz = _fdiff_d_sharded(a, DATA_AXIS)
        dbdx = _fdiff_local(b, 3)
        dbdz = _fdiff_d_sharded(b, DATA_AXIS)
        dcdx = _fdiff_local(c, 3)
        dcdy = _fdiff_local(c, 2)
        return jnp.concatenate(
            [dcdy - dbdz, dadz - dcdx, dbdx - dady], axis=-1)

    return shard_map(f, mesh=mesh, in_specs=(_SPEC,), out_specs=_SPEC)(psi)


def jacobian3d_sharded(x: jnp.ndarray, mesh: Mesh
                       ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """D-sharded :func:`deepfluids_tpu.ops.fd.jacobian3d`.

    Args:
      x: ``[B, D, H, W, 3]`` velocity with D divisible by the data-axis size.
    Returns:
      (J ``[B, D, H, W, 9]`` in the oracle's source-channel-major order,
      vort ``[B, D, H, W, 3]``), sharded the same way.  Completes the
      stencil set a spatially-sharded 3D training LOSS needs (the jacobian
      term of SURVEY §3.1): z-derivatives ride one ppermute halo, in-plane
      derivatives stay local.
    """
    def f(v):
        u, vv, w = v[..., 0:1], v[..., 1:2], v[..., 2:3]
        dudx = _fdiff_local(u, 3)
        dudy = _fdiff_local(u, 2)
        dudz = _fdiff_d_sharded(u, DATA_AXIS)
        dvdx = _fdiff_local(vv, 3)
        dvdy = _fdiff_local(vv, 2)
        dvdz = _fdiff_d_sharded(vv, DATA_AXIS)
        dwdx = _fdiff_local(w, 3)
        dwdy = _fdiff_local(w, 2)
        dwdz = _fdiff_d_sharded(w, DATA_AXIS)
        j = jnp.concatenate(
            [dudx, dudy, dudz, dvdx, dvdy, dvdz, dwdx, dwdy, dwdz], axis=-1)
        vort = jnp.concatenate(
            [dwdy - dvdz, dudz - dwdx, dvdx - dudy], axis=-1)
        return j, vort

    return shard_map(f, mesh=mesh, in_specs=(_SPEC,),
                     out_specs=(_SPEC, _SPEC))(x)


def grad_scalar_sharded(x: jnp.ndarray, mesh: Mesh) -> jnp.ndarray:
    """Spatially-sharded spatial gradient of a scalar field (levelset path).

    2D ``[B, H, W, 1]`` (H sharded) -> ``[B, H, W, 2]`` (d/dx, d/dy);
    3D ``[B, D, H, W, 1]`` (D sharded) -> ``[B, D, H, W, 3]`` (x, y, z) —
    matching losses._grad_scalar's component order.
    """
    if x.ndim == 4:
        def f2(s):
            return jnp.concatenate(
                [_fdiff_w(s), _fdiff_h_sharded(s, DATA_AXIS)], axis=-1)

        return shard_map(f2, mesh=mesh, in_specs=(_SPEC,),
                         out_specs=_SPEC)(x)

    def f3(s):
        return jnp.concatenate(
            [_fdiff_local(s, 3), _fdiff_local(s, 2),
             _fdiff_d_sharded(s, DATA_AXIS)], axis=-1)

    return shard_map(f3, mesh=mesh, in_specs=(_SPEC,), out_specs=_SPEC)(x)


def curl_sharded(psi: jnp.ndarray, mesh: Mesh) -> jnp.ndarray:
    """Rank-dispatching sharded curl (2D psi / 3D Psi)."""
    return (curl2d_sharded if psi.ndim == 4 else curl3d_sharded)(psi, mesh)


def jacobian_sharded(x: jnp.ndarray, mesh: Mesh
                     ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Rank-dispatching sharded jacobian (+ vorticity)."""
    return (jacobian2d_sharded if x.ndim == 4 else jacobian3d_sharded)(
        x, mesh)


def divergence3d_sharded(x: jnp.ndarray, mesh: Mesh) -> jnp.ndarray:
    """D-sharded forward-difference divergence (matched to curl3d_sharded)."""
    def f(v):
        return (_fdiff_local(v[..., 0:1], 3)
                + _fdiff_local(v[..., 1:2], 2)
                + _fdiff_d_sharded(v[..., 2:3], DATA_AXIS))

    return shard_map(f, mesh=mesh, in_specs=(_SPEC,), out_specs=_SPEC)(x)
