"""2D buoyant smoke plume solver (JAX; mantaflow smoke scene equivalent).

Per-frame loop (SURVEY.md §3.5 [M]): apply source -> add buoyancy ->
advect (semi-Lagrangian) -> wall BCs -> pressure projection.  The whole
trajectory is one jit-compiled ``lax.scan``; a parameter sweep over scenes is
a ``vmap`` over (source position, source radius).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from deepfluids_tpu.datagen import grids


@dataclasses.dataclass(frozen=True)
class Smoke2DConfig:
    height: int = 128           # H (y)
    width: int = 96             # W (x)
    num_frames: int = 200
    dt: float = 1.0
    buoyancy: float = 0.08      # upward force per unit density
    source_rate: float = 1.0    # density injected per step inside source
    project_iters: int = 50
    projection: str = "jacobi"  # "jacobi" (legacy default, project_iters
                                # central-difference sweeps)
                                # | "cg" (converged central solve — the
                                # solver-consistency oracle; see
                                # tools/solver_consistency.py)
                                # | "matched" (discrete Leray projection
                                # onto the GENERATOR'S manifold,
                                # projection.project_curl2d — frames are
                                # exactly curl(ψ), zero wall through-flow;
                                # the round-3 data-quality fix)
    cg_tol: float = 1e-6
    mg_cycles: int = 8          # V-cycles for projection="matched"

    def __post_init__(self):
        # A typo like projection='Matched' would otherwise silently fall
        # through to the Jacobi branch and regenerate hours of frames
        # off-manifold (the exact silent-default class _str2bool guards).
        if self.projection not in ("jacobi", "cg", "matched"):
            raise ValueError(
                f"projection={self.projection!r}: expected one of "
                "'jacobi', 'cg', 'matched'")


def _source_mask(h: int, w: int, pos_x: jnp.ndarray, radius: jnp.ndarray,
                 pos_y: jnp.ndarray) -> jnp.ndarray:
    """Soft circular source mask.  pos_x/pos_y in [0,1] (fractions), radius
    as a fraction of width."""
    yy = jnp.arange(h, dtype=jnp.float32)[:, None]
    xx = jnp.arange(w, dtype=jnp.float32)[None, :]
    cy = pos_y * (h - 1)
    cx = pos_x * (w - 1)
    r = radius * w
    d2 = (yy - cy) ** 2 + (xx - cx) ** 2
    return jnp.clip(1.0 - jnp.sqrt(d2) / jnp.maximum(r, 1e-6), 0.0, 1.0)


def step(state, src_mask, cfg: Smoke2DConfig):
    """One solver step.  state = (vel [H,W,2], rho [H,W])."""
    vel, rho = state
    rho = jnp.clip(rho + cfg.source_rate * src_mask, 0.0, 1.0)
    # Buoyancy: upward (+y) force proportional to density.
    vel = vel.at[..., 1].add(cfg.dt * cfg.buoyancy * rho)
    vel = grids.wall_bc2d(vel)
    rho = grids.advect2d(rho, vel, cfg.dt)
    vel = grids.advect2d(vel, vel, cfg.dt)
    vel = grids.wall_bc2d(vel)
    if cfg.projection == "matched":
        # Leray projection onto the generator's manifold: the result is
        # exactly curl(ψ) with zero wall through-flow, so NO trailing
        # wall_bc — it would push the frame off-manifold again (the ~25%
        # irreducible-error mechanism this mode exists to remove).
        from deepfluids_tpu.datagen import projection
        vel = projection.project_curl2d(vel, cycles=cfg.mg_cycles)
    elif cfg.projection == "cg":
        vel = grids.pressure_project2d_cg(vel, tol=cfg.cg_tol)
        vel = grids.wall_bc2d(vel)
    else:
        vel = grids.pressure_project2d(vel, cfg.project_iters)
        vel = grids.wall_bc2d(vel)
    return vel, rho


@functools.partial(jax.jit, static_argnames=("cfg", "moving"))
def simulate_smoke2d(pos_x, radius, cfg: Smoke2DConfig,
                     pos_x_per_frame=None, moving: bool = False):
    """Run one scene; returns (vel_traj [T,H,W,2], rho_traj [T,H,W]).

    Args:
      pos_x: static source x-position (fraction of width, in [0, 1]).
      radius: source radius (fraction of width).
      cfg: solver config (static).
      pos_x_per_frame: ``[T]`` per-frame source positions; used when
        ``moving`` (the smoke_mov scene family).
    """
    h, w = cfg.height, cfg.width
    vel0 = jnp.zeros((h, w, 2), jnp.float32)
    rho0 = jnp.zeros((h, w), jnp.float32)
    pos_y = jnp.float32(0.08)  # source near the bottom

    if moving:
        xs = pos_x_per_frame

        def body(state, px):
            mask = _source_mask(h, w, px, radius, pos_y)
            vel, rho = step(state, mask, cfg)
            return (vel, rho), (vel, rho)

        _, (vt, rt) = jax.lax.scan(body, (vel0, rho0), xs)
    else:
        mask = _source_mask(h, w, pos_x, radius, pos_y)

        def body(state, _):
            vel, rho = step(state, mask, cfg)
            return (vel, rho), (vel, rho)

        _, (vt, rt) = jax.lax.scan(
            body, (vel0, rho0), None, length=cfg.num_frames
        )
    return vt, rt


@functools.partial(jax.jit, static_argnames=("cfg",))
def simulate_smoke2d_batch(pos_x, radius, cfg: Smoke2DConfig):
    """Vectorized scene sweep: S solver instances in one device program.

    mantaflow ran one C++ scene at a time (SURVEY.md §3.5); here the whole
    parameter sweep vmaps over (pos_x [S], radius [S]) so the device solves
    every scene simultaneously — the datagen analogue of batched inference.

    Returns (vel [S,T,H,W,2], rho [S,T,H,W]).
    """
    return jax.vmap(lambda p, r: simulate_smoke2d(p, r, cfg))(pos_x, radius)
