"""3D smoke plume solver (JAX; mantaflow smoke3 scene equivalent).

Scene family smoke3_vel5_buo3_f250 (SURVEY.md §2 [B]): parameters are source
inflow velocity and buoyancy strength; grid 112x64x32 (W x H x D) -> arrays
[D, H, W] = [32, 64, 112].
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from deepfluids_tpu.datagen import grids


@dataclasses.dataclass(frozen=True)
class Smoke3DConfig:
    depth: int = 32             # D (z)
    height: int = 64            # H (y)
    width: int = 112            # W (x)
    num_frames: int = 250
    dt: float = 1.0
    source_rate: float = 1.0
    project_iters: int = 40
    projection: str = "jacobi"  # "jacobi" (legacy) | "cg" (converged
                                # reference, solver-consistency study) |
                                # "matched" (discrete Leray projection
                                # onto range(curl3d) —
                                # datagen/projection.py; the round-3 data-
                                # quality fix, median frame distance to the
                                # generator manifold 0.16 -> ~1e-2)
    cg_tol: float = 1e-6
    mg_cycles: int = 16         # V-cycles for projection="matched" (the 3D
                                # curl normal operator is semidefinite —
                                # gauge modes — and converges ~0.7x/cycle
                                # vs 0.15x in 2D, so it needs more cycles)

    def __post_init__(self):
        # Reject typos loudly instead of silently generating off-manifold
        # frames with the legacy Jacobi branch (see Smoke2DConfig).
        if self.projection not in ("jacobi", "cg", "matched"):
            raise ValueError(
                f"projection={self.projection!r}: expected one of "
                "'jacobi', 'cg', 'matched'")


def _source_mask3(d, h, w):
    """Soft spherical source near the bottom center."""
    zz = jnp.arange(d, dtype=jnp.float32)[:, None, None]
    yy = jnp.arange(h, dtype=jnp.float32)[None, :, None]
    xx = jnp.arange(w, dtype=jnp.float32)[None, None, :]
    cz, cy, cx = (d - 1) / 2.0, 0.1 * (h - 1), (w - 1) / 2.0
    r = 0.12 * w
    d2 = (zz - cz) ** 2 + (yy - cy) ** 2 + (xx - cx) ** 2
    return jnp.clip(1.0 - jnp.sqrt(d2) / r, 0.0, 1.0)


def _step3(state, inflow_vel, buoyancy, mask, cfg: Smoke3DConfig):
    """One solver step (source -> buoyancy -> advect -> project)."""
    vel, rho = state
    rho = jnp.clip(rho + cfg.source_rate * mask, 0.0, 1.0)
    # Source inflow: set vertical velocity inside the source.
    vel = vel.at[..., 1].set(
        vel[..., 1] * (1 - mask) + inflow_vel * mask
    )
    vel = vel.at[..., 1].add(cfg.dt * buoyancy * rho)
    vel = grids.wall_bc3d(vel)
    rho = grids.advect3d(rho, vel, cfg.dt)
    vel = grids.advect3d(vel, vel, cfg.dt)
    vel = grids.wall_bc3d(vel)
    if cfg.projection == "matched":
        # Leray projection onto range(curl3d): zero wall through-flow by
        # construction, so no trailing wall_bc (it would knock the frame
        # off the generator manifold — the error this mode removes).
        from deepfluids_tpu.datagen import projection
        vel = projection.project_curl3d(vel, cycles=cfg.mg_cycles)
    elif cfg.projection == "cg":
        vel = grids.pressure_project3d_cg(vel, tol=cfg.cg_tol)
        vel = grids.wall_bc3d(vel)
    else:
        vel = grids.pressure_project3d(vel, cfg.project_iters)
        vel = grids.wall_bc3d(vel)
    return (vel, rho), (vel, rho)


@functools.partial(jax.jit, static_argnames=("cfg",))
def simulate_smoke3d(inflow_vel, buoyancy, cfg: Smoke3DConfig):
    """One scene; returns (vel_traj [T,D,H,W,3], rho_traj [T,D,H,W]).

    Args:
      inflow_vel: upward source velocity injected inside the source mask.
      buoyancy: buoyancy coefficient (force per unit density).
    """
    d, h, w = cfg.depth, cfg.height, cfg.width
    vel0 = jnp.zeros((d, h, w, 3), jnp.float32)
    rho0 = jnp.zeros((d, h, w), jnp.float32)
    mask = _source_mask3(d, h, w)

    def body(state, _):
        return _step3(state, inflow_vel, buoyancy, mask, cfg)

    _, (vt, rt) = jax.lax.scan(
        body, (vel0, rho0), None, length=cfg.num_frames
    )
    return vt, rt


@functools.partial(jax.jit, static_argnames=("cfg", "num_frames"))
def simulate_smoke3d_segment(vel, rho, inflow_vel, buoyancy,
                             cfg: Smoke3DConfig, num_frames: int):
    """Advance ``num_frames`` steps from (vel, rho) — the SEGMENTED driver.

    Long 3D trajectories (250 frames at 112x64x32) would hold the whole
    ~GB trajectory in device memory as one program; callers scan segments,
    carrying (vel, rho) across calls — numerically identical to one long
    scan.  Returns (vel, rho, vel_traj [T,...], rho_traj [T,...]).
    """
    mask = _source_mask3(cfg.depth, cfg.height, cfg.width)

    def body(state, _):
        return _step3(state, inflow_vel, buoyancy, mask, cfg)

    (vel, rho), (vt, rt) = jax.lax.scan(
        body, (vel, rho), None, length=num_frames)
    return vel, rho, vt, rt


@functools.partial(jax.jit, static_argnames=("cfg", "num_frames"))
def simulate_smoke3d_segment_batch(vel, rho, inflow_vel, buoyancy,
                                   cfg: Smoke3DConfig, num_frames: int):
    """Vmapped :func:`simulate_smoke3d_segment` (leading scene dim)."""
    return jax.vmap(
        lambda v, r, iv, b: simulate_smoke3d_segment(
            v, r, iv, b, cfg, num_frames)
    )(vel, rho, inflow_vel, buoyancy)


@functools.partial(jax.jit, static_argnames=("cfg",))
def simulate_smoke3d_batch(inflow_vel, buoyancy, cfg: Smoke3DConfig):
    """Vectorized 3D scene sweep (see smoke2d.simulate_smoke2d_batch)."""
    return jax.vmap(lambda v, b: simulate_smoke3d(v, b, cfg))(inflow_vel,
                                                              buoyancy)
