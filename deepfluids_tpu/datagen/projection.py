"""Model-matched pressure projection via variational geometric multigrid.

Why this exists (the round-3 quality discovery, BENCHMARKS.md "the 0.25
floor, explained"): the generator emits velocity through ``ops.fd.curl2d/3d``
(forward differences, edge replication), so its output manifold is exactly
``range(curl)``.  The production Jacobi sweep projects with
CENTRAL-difference operators, whose kernel differs — and whose
under-converged iterates leave ~25% of each frame's L2 norm outside the
model's manifold: the median distance of real smoke_pos21_size5 frames to
``range(curl2d)`` is 0.247, equal to the measured 0.250 full-data training
floor.  No decoder in the curl family can beat that floor; the error is in
the data.  Projecting the solver's velocity onto the model's own manifold
removes it at the source.

Two projections are provided, both solved by the same multigrid core:

* :func:`project_curl` — the production one.  Solves the ψ-space least
  squares  min_ψ ||curl(ψ) - v||²  with ψ ≡ 0 on the boundary ring:
  the discrete Leray projector of the closed box.  The output is literally
  ``curl(ψ)`` — on-manifold to machine precision — AND has exactly zero
  wall-normal flow (ψ constant on the connected boundary ⇒ no through-flow,
  so the trailing ``wall_bc`` that used to knock frames off-manifold is
  unnecessary).  The Dirichlet ring also makes the normal operator
  E Jᵀ J E nonsingular (curl(ψ)=0 ⇒ ψ constant ⇒ ψ=0 on the ring ⇒ ψ=0).
* :func:`project_matched` — orthogonal projection onto ker(div_f) via
  (D Dᵀ) p = D v, v' = v - Dᵀ p with D the model's forward-difference
  divergence.  Used by the solver-consistency study; keeps wall handling
  outside.  A = D Dᵀ has a rank-1 null space (an alternating 2^ndim corner
  block where the replicated edges meet — annihilated by Dᵀ, so it never
  touches v', but it must be deflated from the RHS).

Solver: f32 CG on these systems plateaus at ~3e-4 then DIVERGES past ~700
iterations (measured at 128×96 — conjugacy loss; f64 is slow on accelerators).
Geometric multigrid is a stationary iteration — no divergence risk in f32.
The boundary closures here are unusual enough that a rediscretized coarse
operator is a poor Galerkin match (75% relative operator error measured at
16×12→8×6) and the textbook V-cycle diverges, so the hierarchy is built
EXACTLY variationally: P = linear prolongation (`jax.image.resize`),
R = Pᵀ (`jax.linear_transpose` — exact by construction), A_c = Pᵀ A P
composed functionally down to the fine grid, and the coarsest level solved
exactly with a pseudo-inverse probed out of the composed operator (the
pinv cutoff also absorbs near-null modes).  Coarse applications chain
through the fine operator, costing O(N_fine) each — a V(2,2) cycle is ~15
fine stencil applications, ~50× cheaper than the ~650 CG iterations the
plain system needs — and every piece is statically shaped, jit-friendly,
and vmappable over a batch of scenes, which is exactly how the datagen
scan uses it.  Measured convergence: ~0.3× residual per cycle down to the
f32 floor (~8e-4 relative) at 128×96.
"""

from __future__ import annotations

import contextlib
import functools

import jax
import jax.numpy as jnp

from deepfluids_tpu.ops import fd


# ---------------------------------------------------------------------------
# Matched operators: D (the model's forward-difference divergence) and Dᵀ
# ---------------------------------------------------------------------------

def _fdiff_adj(y: jnp.ndarray, axis: int) -> jnp.ndarray:
    """Adjoint of ``ops.fd._fdiff`` (forward diff, last slice replicated).

    For the 1D operator T with d[i] = x[i+1]-x[i] (i < n-1) and
    d[n-1] = x[n-1]-x[n-2]:
      (Tᵀy)[0]    = -y[0]
      (Tᵀy)[k]    = y[k-1] - y[k]          1 <= k <= n-3
      (Tᵀy)[n-2]  = y[n-3] - y[n-2] - y[n-1]
      (Tᵀy)[n-1]  = y[n-2] + y[n-1]
    i.e. a backward difference with two boundary corrections from the
    replicated last slice.  Verified against jax.vjp in tests.
    """
    y = jnp.moveaxis(y, axis, -1)
    n = y.shape[-1]
    prev = jnp.concatenate([jnp.zeros_like(y[..., :1]), y[..., :-1]], axis=-1)
    out = prev - y                       # y[k-1] - y[k], with y[-1] := 0
    out = out.at[..., n - 2].add(-y[..., n - 1])
    out = out.at[..., n - 1].add(2.0 * y[..., n - 1])
    return jnp.moveaxis(out, -1, axis)


def div_f(vel: jnp.ndarray) -> jnp.ndarray:
    """Forward-difference divergence, [*S, C] -> [*S] (C = ndim).

    Dispatches to the EXACT operators the models train against
    (``ops.fd.divergence2d/3d``) so ker(D) is the generator's manifold.
    """
    if vel.shape[-1] == 2:
        return fd.divergence2d(vel)[..., 0]
    return fd.divergence3d(vel)[..., 0]


def div_f_adj(p: jnp.ndarray, ndim: int) -> jnp.ndarray:
    """Dᵀ: [*S] -> [*S, ndim]. Axis convention: channels are (u, v[, w]) =
    d/dx, d/dy[, d/dz] with x = last spatial axis, y = second-to-last,
    z = third-to-last (matches ops.fd)."""
    comps = [_fdiff_adj(p, axis=-1), _fdiff_adj(p, axis=-2)]
    if ndim == 3:
        comps.append(_fdiff_adj(p, axis=-3))
    return jnp.stack(comps, axis=-1)


def matched_laplacian(p: jnp.ndarray, ndim: int) -> jnp.ndarray:
    """A = D Dᵀ — symmetric PSD, reach-2 stencil (the replicated-edge
    closure couples indices two apart near the boundary)."""
    return div_f(div_f_adj(p, ndim))


# --- curl least-squares operator (ψ-space, Dirichlet ring) -----------------

def _curl(psi: jnp.ndarray) -> jnp.ndarray:
    """[*S] stream function / vector-potential scalar -> [*S, ndim] velocity
    via the model's own curl.  2D: psi is the scalar stream function.
    3D: the solve is done per vector-potential component (see
    :func:`project_curl`)."""
    return fd.curl2d(psi[..., None])


def _curl_adj(v: jnp.ndarray) -> jnp.ndarray:
    """Jᵀ for the 2D curl: u = T_y ψ, v = -T_x ψ  ⇒  Jᵀw = T_yᵀ w_u - T_xᵀ w_v."""
    return _fdiff_adj(v[..., 0], axis=-2) - _fdiff_adj(v[..., 1], axis=-1)


def _ring_mask(shape: tuple[int, ...], dtype) -> jnp.ndarray:
    """1 in the interior, 0 on the boundary ring (Dirichlet DOF mask)."""
    m = jnp.ones(shape, dtype)
    for ax in range(len(shape)):
        idx = [slice(None)] * len(shape)
        idx[ax] = 0
        m = m.at[tuple(idx)].set(0)
        idx[ax] = -1
        m = m.at[tuple(idx)].set(0)
    return m


def curl_ls_operator(shape: tuple[int, ...], dtype):
    """B ψ = M JᵀJ (M ψ) + (1-M) ψ  —  the normal operator of the
    Dirichlet-ring curl least squares, extended with identity on the ring
    so the full-grid system is SPD and nonsingular (MG-friendly shapes)."""
    m = _ring_mask(shape, dtype)

    def B(psi):
        return m * _curl_adj(_curl(m * psi)) + (1.0 - m) * psi
    return B


def _curl3_adj(v: jnp.ndarray) -> jnp.ndarray:
    """Jᵀ for the 3D curl (u = T_y c - T_z b, v = T_z a - T_x c,
    w = T_x b - T_y a):  a ← T_zᵀu_v - T_yᵀw;  b ← T_xᵀw - T_zᵀu;
    c ← T_yᵀu - T_xᵀv.  Verified against jax.vjp in tests."""
    u, vv, w = v[..., 0], v[..., 1], v[..., 2]
    a = _fdiff_adj(vv, axis=-3) - _fdiff_adj(w, axis=-2)
    b = _fdiff_adj(w, axis=-1) - _fdiff_adj(u, axis=-3)
    c = _fdiff_adj(u, axis=-2) - _fdiff_adj(vv, axis=-1)
    return jnp.stack([a, b, c], axis=-1)


def curl3_ls_operator(shape: tuple[int, ...], dtype):
    """3D analogue of :func:`curl_ls_operator` on Ψ [D, H, W, 3] with a
    zero-Dirichlet SHELL on all three vector-potential components (⇒ zero
    wall-normal flow: tangential derivatives of a vanishing face are zero).
    Unlike 2D the normal operator is only semidefinite — gauge fields
    Ψ = ∇φ are invisible to the curl — but the RHS JᵀV is always
    compatible, the smoother's null drift is bounded, the coarsest pinv
    cuts the null space off, and any residual null component is annihilated
    by the final curl anyway (only curl(Ψ) is returned)."""
    m = _ring_mask(shape[:-1], dtype)[..., None]

    def B(psi):
        return m * _curl3_adj(fd.curl3d(m * psi)) + (1.0 - m) * psi
    return B


# ---------------------------------------------------------------------------
# Variational geometric multigrid core
# ---------------------------------------------------------------------------

def _op_diag(Afn, shape: tuple[int, ...], dtype,
             strides: tuple[int, ...] | None = None) -> jnp.ndarray:
    """Exact diagonal of a short-reach linear operator by stride-color
    probing: sum_c A(chi_c) * chi_c is exact when same-color cells are
    never coupled.  The fine operators have reach 2 along spatial axes;
    Galerkin coarse operators reach ~3.  Plain red/black 2-coloring
    silently corrupts boundary diagonals here and blows up the smoother
    (measured 4.7×/cycle divergence); spatial stride 4 covers every level,
    dense-verified in tests.  A channel axis (the 3D vector potential)
    couples any-to-any, so its stride must equal its size — pass per-axis
    ``strides`` for that."""
    ndim = len(shape)
    strides = strides or (4,) * ndim
    grids_idx = jnp.meshgrid(*[jnp.arange(n) for n in shape], indexing="ij")
    ncolors = 1
    for st in strides:
        ncolors *= st
    diag = jnp.zeros(shape, dtype)
    for color in range(ncolors):
        mask = jnp.ones(shape, bool)
        c = color
        for d in range(ndim):
            mask = mask & ((grids_idx[d] % strides[d]) == (c % strides[d]))
            c //= strides[d]
        e = mask.astype(dtype)
        diag = diag + Afn(e) * e
    return diag


def _null_vector(shape: tuple[int, ...], dtype) -> jnp.ndarray:
    """The one null vector of A = D Dᵀ: a 2^ndim alternating-sign block at
    the far corner, where the replicated last slices of every axis meet
    (T's rows n-1 and n-2 coincide, so Tᵀ annihilates their alternating
    combination).  A is otherwise nonsingular.  Dᵀ maps this to zero, so it
    never touches the projected velocity; it is deflated from the RHS and
    absorbed by the coarsest level's pinv cutoff."""
    z = jnp.zeros(shape, dtype)
    ndim = len(shape)
    for corner in range(2 ** ndim):
        idx, sign = [], 1.0
        for d in range(ndim):
            bit = (corner >> d) & 1
            idx.append(shape[d] - 2 + bit)
            sign *= -1.0 if bit else 1.0
        z = z.at[tuple(idx)].set(sign)
    return z / jnp.linalg.norm(z)


def _deflate(q: jnp.ndarray, z: jnp.ndarray | None) -> jnp.ndarray:
    return q if z is None else q - jnp.vdot(z, q) * z


def _coarsenable(shape: tuple[int, ...], min_cells: int) -> bool:
    cells = 1
    for n in shape:
        cells *= n // 2
    return all(n % 2 == 0 and n >= 6 for n in shape) and cells >= min_cells


def _chunked_probe(Afn, shape, dtype, chunk: int = 64) -> jnp.ndarray:
    """Dense matrix of a linear operator on ``shape`` (column probing,
    vmapped in chunks to bound the transient batch footprint)."""
    import numpy as np
    n = 1
    for s_ in shape:
        n *= s_
    eye = jnp.eye(n, dtype=dtype)
    cols = []
    batched = jax.vmap(lambda e: Afn(e.reshape(shape)).reshape(n))
    for i in range(0, n, chunk):
        cols.append(np.asarray(batched(eye[i:i + chunk])))
    return jnp.asarray(np.concatenate(cols, axis=0).T)


# Registered fine-grid operators the MG core can solve.
# name -> (factory(shape, dtype) -> A_fn, has_corner_null, has_channel_axis)
# has_channel_axis: the last axis is a component axis (3D vector
# potential) — never coarsened, colored densely in the diag probe.
_OPERATORS = {
    "div_lap": (lambda shape, dtype:
                (lambda p: matched_laplacian(p, len(shape))), True, False),
    "curl_ls": (curl_ls_operator, False, False),
    "curl3_ls": (curl3_ls_operator, False, True),
}


@functools.cache
def _mg_setup(op_name: str, shape: tuple[int, ...], dtype_name: str,
              min_coarse_cells: int = 128) -> dict:
    """Build the variational hierarchy for a registered operator on
    ``shape``.  Host-side, cached per (op, shape, dtype); the produced
    arrays (per-level diagonals, the coarsest pinv, the null vector) are
    small constants folded into the jitted datagen program."""
    dtype = jnp.dtype(dtype_name)
    factory, has_null, has_chan = _OPERATORS[op_name]
    # The first call may come from inside a jit trace (the datagen scan);
    # run the WHOLE build — including the operator factory, whose closures
    # capture mask/constant arrays — under compile-time eval so the cache
    # holds concrete arrays, not tracers.  Pin the eager build to the host
    # CPU backend when one is available: the 3D build (192-color diag
    # probes x 4 levels + power iterations + the dense coarse probe) is
    # thousands of small eager ops, each a device dispatch otherwise.  The
    # produced constants fold into the device program at lowering
    # regardless.
    try:
        cpu = jax.devices("cpu")[0]
        dev_ctx = jax.default_device(cpu)
    except RuntimeError:
        dev_ctx = contextlib.nullcontext()
    with jax.ensure_compile_time_eval(), dev_ctx:
        A0 = factory(shape, dtype)

        def coarsen(sh):
            sp = sh[:-1] if has_chan else sh
            if not _coarsenable(sp, min_coarse_cells):
                return None
            sp = tuple(n // 2 for n in sp)
            return sp + (sh[-1],) if has_chan else sp

        shapes = [shape]
        while (nxt := coarsen(shapes[-1])) is not None:
            shapes.append(nxt)

        return _mg_build(op_name, shape, dtype, has_null, has_chan, A0,
                         shapes)


def _mg_build(op_name, shape, dtype, has_null, has_chan, A0, shapes):
    def make_A(level):
        def A(e):
            # prolong through every finer level, apply the fine operator,
            # restrict back down: A_k = P₁ᵀ…P_kᵀ A P_k…P₁  (exact Galerkin)
            for lv in range(level, 0, -1):
                e = jax.image.resize(e, shapes[lv - 1], method="linear")
            e = A0(e)
            for lv in range(1, level + 1):
                e = jax.linear_transpose(
                    lambda q: jax.image.resize(q, shapes[lv - 1],
                                               method="linear"),
                    jnp.zeros(shapes[lv], dtype))(e)[0]
            return e
        return A

    A_fns = [make_A(lv) for lv in range(len(shapes))]

    def strides_for(sh):
        if not has_chan:
            return (4,) * len(sh)
        return (4,) * (len(sh) - 1) + (sh[-1],)

    diags = [_op_diag(A_fns[lv], shapes[lv], dtype, strides_for(shapes[lv]))
             for lv in range(len(shapes) - 1)]
    # Per-level damping from a measured lambda_max of diag^-1 A: the safe
    # bound is omega < 2/lambda_max, and lambda_max is operator- and
    # dimension-dependent (2.41 for the 2D operators, 2.96 for the 3D curl
    # normal operator — a fixed 0.7/0.8 diverges there).
    import numpy as _np

    def _lambda_max(Afn, diag, sh):
        x = jnp.asarray(_np.random.default_rng(0).standard_normal(sh), dtype)
        for _ in range(60):
            x = Afn(x) / diag
            x = x / jnp.linalg.norm(x)
        return float(jnp.vdot(x, Afn(x) / diag))

    omegas = [min(0.9, 1.5 / _lambda_max(A_fns[lv], diags[lv], shapes[lv]))
              for lv in range(len(shapes) - 1)]
    fine_cells = 1
    for n in shape:
        fine_cells *= n
    # bound the probe batch's fine-grid transient to ~128 MB
    chunk = int(min(64, max(8, (32 * 1024 * 1024) // max(fine_cells, 1))))
    dense = _chunked_probe(A_fns[-1], shapes[-1], dtype, chunk=chunk)
    pinv = jnp.asarray(
        jnp.linalg.pinv(dense.astype(jnp.float64)
                        if jax.config.jax_enable_x64 else dense,
                        rtol=1e-6), dtype)
    return {"shapes": shapes, "A_fns": A_fns, "diags": diags, "pinv": pinv,
            "omegas": omegas,
            "null": _null_vector(shape, dtype) if has_null else None}


def _vcycle(b: jnp.ndarray, x: jnp.ndarray, setup: dict, level: int,
            nu: int = 2) -> jnp.ndarray:
    """One V(nu,nu)-cycle on the variational hierarchy (recursion unrolled
    at trace time; coarsest level solved exactly via the probed pinv)."""
    shapes, A_fns = setup["shapes"], setup["A_fns"]
    A = A_fns[level]

    if level == len(shapes) - 1:
        e = (setup["pinv"] @ b.reshape(-1)).reshape(shapes[level])
        return x + e

    diag = setup["diags"][level]
    omega = setup["omegas"][level]

    def smooth(x, n):
        for _ in range(n):
            x = x + omega * (b - A(x)) / diag
        return x

    x = smooth(x, nu)
    r = b - A(x)
    rc = jax.linear_transpose(
        lambda q: jax.image.resize(q, shapes[level], method="linear"),
        jnp.zeros(shapes[level + 1], b.dtype))(r)[0]
    ec = _vcycle(rc, jnp.zeros_like(rc), setup, level + 1, nu)
    x = x + jax.image.resize(ec, shapes[level], method="linear")
    return smooth(x, nu)


def _mg_solve(op_name: str, b: jnp.ndarray, cycles: int) -> jnp.ndarray:
    setup = _mg_setup(op_name, tuple(b.shape), jnp.result_type(b).name)
    b = _deflate(b, setup["null"])
    x = jnp.zeros_like(b)
    for _ in range(cycles):
        x = _vcycle(b, x, setup, 0)
    return x


# ---------------------------------------------------------------------------
# Public projections
# ---------------------------------------------------------------------------

def solve_matched(b: jnp.ndarray, cycles: int = 10) -> jnp.ndarray:
    """Approximately solve (D Dᵀ) p = b with ``cycles`` V-cycles."""
    return _mg_solve("div_lap", b, cycles)


def project_matched(vel: jnp.ndarray, cycles: int = 10) -> jnp.ndarray:
    """Orthogonal projection of vel [*S, ndim] onto ker(div_f).  Does NOT
    constrain wall-normal flow — pair with external wall BCs (which knock
    the result slightly off-manifold); prefer :func:`project_curl` for
    dataset generation."""
    ndim = vel.shape[-1]
    p = solve_matched(div_f(vel), cycles=cycles)
    return vel - div_f_adj(p, ndim)


def project_curl3d(vel: jnp.ndarray, cycles: int = 10,
                   return_psi: bool = False):
    """3D discrete Leray projection of vel [D, H, W, 3]: least-squares fit
    of a vector potential with Ψ ≡ 0 on the boundary shell, returning
    curl3d(Ψ) — exactly on the 3D generator's manifold with zero wall
    through-flow (see :func:`curl3_ls_operator` for the gauge story)."""
    spatial = vel.shape[:-1]
    m = _ring_mask(spatial, vel.dtype)[..., None]
    b = m * _curl3_adj(vel)
    psi = m * _mg_solve("curl3_ls", b, cycles)
    out = fd.curl3d(psi)
    return (out, psi) if return_psi else out


def project_curl2d(vel: jnp.ndarray, cycles: int = 10,
                   return_psi: bool = False):
    """Discrete Leray projection of vel [H, W, 2] for the closed box:
    least-squares fit of a stream function with ψ ≡ 0 on the boundary,
    returning curl(ψ) — EXACTLY on the generator's manifold (range of
    ``ops.fd.curl2d``) and with exactly zero wall through-flow, so no
    trailing wall BC is needed (or wanted: it would leave the manifold)."""
    shape = vel.shape[:-1]
    m = _ring_mask(shape, vel.dtype)
    b = m * _curl_adj(vel)
    psi = m * _mg_solve("curl_ls", b, cycles)
    out = _curl(psi)
    return (out, psi) if return_psi else out
