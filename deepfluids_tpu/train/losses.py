"""Loss functions for all three archs (de / ae / nn).

Reference: deep-fluids ``trainer.py`` loss wiring (SURVEY.md §3.1/3.3/3.4
[M][B]):

  de:  G = curl(psi);        loss = w1·L1(G, x) + w2·L1(J(G), J(x))
  ae:  x̂ = curl(dec(enc x)); loss = w1·L1(x̂,x) + w2·L1(∇x̂,∇x) + w3·L2(z_p, y)
  nn:  ẑ advanced w steps;    loss = mean_t L2(ẑ_t, z_t)

The jacobian term uses the same forward-difference scheme as the curl
(:mod:`deepfluids_tpu.ops.fd`), so the gradient penalty and the
divergence-free construction share one discretization.  For scalar (levelset)
fields — the liquid configs, where no curl applies — the "jacobian" term is
the L1 distance of the spatial gradient of the scalar field.

All functions are pure, statically shaped, and dispatch 2D vs 3D on rank
(4D = [B,H,W,C], 5D = [B,D,H,W,C]).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from deepfluids_tpu.ops import fd

# Named scopes on the stencil terms: tools/profile_step.py finds the fused
# kernels that compute them (forward and VJP) by these names.
CURL_SCOPE = "fd_curl"
JACOBIAN_SCOPE = "fd_jacobian"


def _dist(norm: str):
    """Per-element distance for the field/jacobian terms; unknown values
    raise (a typo like "L1" must not silently train with squared error)."""
    if norm == "l1":
        return jnp.abs
    if norm == "l2":
        return jnp.square
    raise ValueError(f"loss_norm must be 'l1' or 'l2', got {norm!r}")


def l1(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.mean(jnp.abs(a - b))


def l2(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.mean(jnp.square(a - b))


def _grad_scalar(x: jnp.ndarray) -> jnp.ndarray:
    """Spatial gradient of a scalar field [B, *spatial, 1] -> [B, *spatial, nd]."""
    s = x[..., 0]
    nd = x.ndim - 2
    comps = [fd._fdiff(s, axis=-(k + 1)) for k in range(nd)]  # x, y[, z]
    return jnp.stack(comps, axis=-1)


def jacobian_of(x: jnp.ndarray) -> jnp.ndarray:
    """Full first-derivative stack of a field; dispatches on rank/channels.

    [B,H,W,2] -> [B,H,W,4]; [B,D,H,W,3] -> [B,D,H,W,9]; scalar [...,1] ->
    spatial gradient.  Plain ``ops.fd`` stencils: XLA fuses them with the
    distance and the mean into one pass over each field, and GSPMD
    partitions them over a batch-sharded data mesh.
    """
    if x.shape[-1] == 1:
        return _grad_scalar(x)
    if x.ndim == 4:
        return fd.jacobian2d(x)[0]
    if x.ndim == 5:
        return fd.jacobian3d(x)[0]
    raise ValueError(f"unsupported field shape {x.shape}")


def _sample_weights(target: jnp.ndarray, eps: float = 0.05) -> jnp.ndarray:
    """Per-sample weights ~ 1 / mean|target| for relative-error training.

    The benchmark quality metric (normalized per-frame L2) divides by
    ||x||, so near-empty early frames — tiny in absolute units — dominate
    it while contributing almost nothing to a plain L1 loss.  Weighting
    each sample by the inverse of its mean magnitude optimizes the metric
    directly; ``eps`` (normalized units) bounds the weight on genuinely
    empty frames.  Weights are mean-normalized so the loss scale (and lr
    tuning) stays comparable to the unweighted loss.
    """
    axes = tuple(range(1, target.ndim))
    w = 1.0 / (jnp.mean(jnp.abs(target), axis=axes) + eps)
    w = w / jnp.mean(w)
    return w.reshape((-1,) + (1,) * (target.ndim - 1))


def field_loss(pred: jnp.ndarray, target: jnp.ndarray,
               w1: float, w2: float,
               relative: bool = False,
               norm: str = "l1") -> tuple[jnp.ndarray, dict]:
    """w1·dist(field) + w2·dist(jacobian) — the core reconstruction loss.

    ``relative=True`` weights every sample by 1/mean|target| (see
    :func:`_sample_weights`) — relative-error training.  ``norm`` selects
    the per-element distance: "l1" (reference, SURVEY §3.1) or "l2"
    (squared error; smooth gradients refine small residuals faster under
    Adam than L1's constant-magnitude sign gradient)."""
    dist = _dist(norm)
    ef = dist(pred - target)
    with jax.named_scope(JACOBIAN_SCOPE):
        ej = dist(jacobian_of(pred) - jacobian_of(target))
    if relative:
        wb = _sample_weights(target)
        if norm == "l2":
            # Squared weights make the weighted MSE the true (eps-bounded)
            # per-frame relative L2^2: mean_b[ MSE_b / (mean|x|_b + eps)^2 ].
            wb = jnp.square(wb)
            wb = wb / jnp.mean(wb)
        loss_f = jnp.mean(wb * ef)
        loss_j = jnp.mean(wb * ej)
    else:
        loss_f = jnp.mean(ef)
        loss_j = jnp.mean(ej)
    return w1 * loss_f + w2 * loss_j, {"loss_field": loss_f, "loss_jac": loss_j}


def apply_curl(out: jnp.ndarray) -> jnp.ndarray:
    """psi/Psi -> velocity via the matched curl; dispatches on rank."""
    with jax.named_scope(CURL_SCOPE):
        if out.ndim == 4:
            return fd.curl2d(out)
        if out.ndim == 5:
            return fd.curl3d(out)
    raise ValueError(f"unsupported potential shape {out.shape}")


def generator_loss(net_out: jnp.ndarray, x: jnp.ndarray, use_curl: bool,
                   w1: float, w2: float,
                   relative: bool = False,
                   norm: str = "l1") -> tuple[jnp.ndarray, dict]:
    """Arch "de" loss.  net_out is psi (use_curl) or the field directly."""
    pred = apply_curl(net_out) if use_curl else net_out
    loss, aux = field_loss(pred, x, w1, w2, relative, norm)
    aux["pred"] = pred
    return loss, aux


def autoencoder_loss(net_out: jnp.ndarray, z: jnp.ndarray, x: jnp.ndarray,
                     y: jnp.ndarray, use_curl: bool, num_param: int,
                     w1: float, w2: float, w3: float,
                     relative: bool = False,
                     norm: str = "l1") -> tuple[jnp.ndarray, dict]:
    """Arch "ae" loss: reconstruction + latent-parameter supervision.

    z[:, :num_param] is driven to equal the normalized sim params y so the
    latent space is steerable (SURVEY.md §3.3).  ``relative``/``norm`` are
    the same quality knobs as :func:`generator_loss`.
    """
    pred = apply_curl(net_out) if use_curl else net_out
    rec, aux = field_loss(pred, x, w1, w2, relative, norm)
    loss_p = l2(z[:, :num_param], y[:, :num_param])
    aux.update({"loss_param": loss_p, "pred": pred})
    return rec + w3 * loss_p, aux


def jacobian_of_spatial(x: jnp.ndarray, mesh) -> jnp.ndarray:
    """Spatially-sharded :func:`jacobian_of` (halo-exchange stencils).

    For fields whose spatial axis 1 (H in 2D, D in 3D) is sharded over the
    mesh's data axis — the SP/CP-analogue layout (SURVEY §2 parallelism
    table) for grids too large to replicate per chip."""
    from deepfluids_tpu.parallel import halo

    if x.shape[-1] == 1:
        return halo.grad_scalar_sharded(x, mesh)
    j, _ = halo.jacobian_sharded(x, mesh)
    return j


def field_loss_spatial(pred: jnp.ndarray, target: jnp.ndarray,
                       w1: float, w2: float, mesh,
                       relative: bool = False,
                       norm: str = "l1") -> tuple[jnp.ndarray, dict]:
    """Spatially-sharded :func:`field_loss` (same math, halo stencils).

    ``relative``/``norm`` mirror :func:`field_loss` exactly — the reduction
    runs under GSPMD (outside the halo shard_maps), so per-sample weights
    and squared distances partition the same way the plain means do."""
    dist = _dist(norm)
    ef = dist(pred - target)
    ej = dist(jacobian_of_spatial(pred, mesh) -
              jacobian_of_spatial(target, mesh))
    if relative:
        wb = _sample_weights(target)
        if norm == "l2":
            wb = jnp.square(wb)
            wb = wb / jnp.mean(wb)
        loss_f = jnp.mean(wb * ef)
        loss_j = jnp.mean(wb * ej)
    else:
        loss_f = jnp.mean(ef)
        loss_j = jnp.mean(ej)
    return (w1 * loss_f + w2 * loss_j,
            {"loss_field": loss_f, "loss_jac": loss_j})


def generator_loss_spatial(net_out: jnp.ndarray, x: jnp.ndarray,
                           use_curl: bool, w1: float, w2: float,
                           mesh, relative: bool = False,
                           norm: str = "l1") -> tuple[jnp.ndarray, dict]:
    """Arch "de" loss with the grid's H (2D) / D (3D) axis sharded."""
    from deepfluids_tpu.parallel import halo

    pred = halo.curl_sharded(net_out, mesh) if use_curl else net_out
    loss, aux = field_loss_spatial(pred, x, w1, w2, mesh, relative, norm)
    aux["pred"] = pred
    return loss, aux


def autoencoder_loss_spatial(net_out: jnp.ndarray, z: jnp.ndarray,
                             x: jnp.ndarray, y: jnp.ndarray, use_curl: bool,
                             num_param: int, w1: float, w2: float, w3: float,
                             mesh, relative: bool = False,
                             norm: str = "l1") -> tuple[jnp.ndarray, dict]:
    """Arch "ae" loss with the grid's spatial axis sharded."""
    from deepfluids_tpu.parallel import halo

    pred = halo.curl_sharded(net_out, mesh) if use_curl else net_out
    rec, aux = field_loss_spatial(pred, x, w1, w2, mesh, relative, norm)
    loss_p = l2(z[:, :num_param], y[:, :num_param])
    aux.update({"loss_param": loss_p, "pred": pred})
    return rec + w3 * loss_p, aux


def latent_window_loss(z_pred: jnp.ndarray, z_true: jnp.ndarray,
                       num_param: int) -> tuple[jnp.ndarray, dict]:
    """Arch "nn" loss over a rollout window.

    Args:
      z_pred/z_true: [W, B, z_num] latent trajectories (step 0 identical by
        construction).  Only the free block is integrated, but the loss spans
        the full code as in the reference (the param block matches exactly).
    """
    loss = l2(z_pred[1:], z_true[1:])
    return loss, {"loss_z": loss}
