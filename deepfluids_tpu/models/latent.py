"""Latent integration network (arch "nn") and lax.scan temporal rollout.

Reference: deep-fluids ``model.py`` NN MLP + trainer window unroll
(SURVEY.md §2 "Latent integration net", §3.4 [M][B]).  The latent code from
the autoencoder is split as ``z = [p (num_param, supervised) ; z_free]``.
A small MLP T predicts the residual update of the free part:

    dz_free_t = T([z_free_t ; dp_t])         (dp_t = p_{t+1} - p_t)
    z_{t+1}   = [p_{t+1} ; z_free_t + dz_free_t]

During training the window (w ~= 30 steps [B]) is advanced recurrently from
z_0; the reference unrolled this in-graph — here it is a ``lax.scan``, which
keeps whole trajectories on device with O(1) compiled program size
(BASELINE.json north_star [B]).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from deepfluids_tpu.models.layers import Module, Scope, dense, elu, zeros


@dataclasses.dataclass(frozen=True)
class LatentIntegrator(Module):
    """MLP: [z_t ; dp_t] -> dz_free_t (residual update of the free block).

    The input is the FULL latent code (supervised parameter block included —
    the dynamics depend on absolute parameter values like source position,
    which the AE stores in the supervised dims, per SURVEY.md §3.4's
    "[z_t ; Δp] → Δz"); only the free block receives the residual update,
    since the parameter block is pinned to the known trajectory.

    Attributes:
      z_num: full latent size (supervised params + free dims).
      num_param: number of supervised parameter dims at the front of z.
      hidden: width of each hidden layer.
      depth: number of hidden layers.
    """

    z_num: int = 16
    num_param: int = 2
    hidden: int = 512
    depth: int = 2
    dtype: jnp.dtype = jnp.float32

    @property
    def free_dim(self) -> int:
        return self.z_num - self.num_param

    def __call__(self, s: Scope, z: jnp.ndarray,
                 dp: jnp.ndarray) -> jnp.ndarray:
        h = jnp.concatenate([z, dp], axis=-1).astype(self.dtype)
        for i in range(self.depth):
            h = elu(dense(s.child(f"fc_{i}"), h, self.hidden, self.dtype))
        # Zero-init the head: the initial rollout is then the identity map
        # (dz = 0), so the w-step recurrent unroll starts from the natural
        # variance of z instead of compounding random residuals (a random
        # head makes the initial 30-step loss explode ~120x and slows
        # convergence badly — measured on smoke_mov).
        out = dense(s.child("fc_out"), h, self.free_dim, self.dtype,
                    kernel_init=zeros)
        return out.astype(jnp.float32)


def rollout(
    apply_fn,
    params,
    z0: jnp.ndarray,
    p_seq: jnp.ndarray,
    num_param: int,
    remat: bool = False,
    noise_std: float = 0.0,
    rng: jnp.ndarray | None = None,
    history: int = 1,
) -> jnp.ndarray:
    """Advance a latent code through time with the integrator via lax.scan.

    Args:
      apply_fn: bound ``LatentIntegrator.apply``-style callable
        ``(params, z_full, dp) -> dz_free``.
      params: integrator parameters.
      z0: ``[B, z_num]`` initial latent codes (front dims = normalized params
        at t=0).
      p_seq: ``[T, B, num_param]`` known normalized parameter trajectory,
        with ``p_seq[0]`` matching ``z0[:, :num_param]``.
      num_param: size of the supervised front block of z.
      remat: rematerialize each step under grad — O(1) activation memory
        for long training windows (SURVEY.md §7 "Hard parts": watch
        rematerialization cost for w=30) at the price of a second forward.
      noise_std: >0 adds zero-mean Gaussian noise to the carried free block
        BEFORE each integrator call (training-noise / scheduled-sampling
        analogue): the MLP learns to step from slightly-wrong states back
        toward the true trajectory, which is exactly the regime a long
        test-time rollout puts it in — the drift stabilizer for horizons
        far past the training window w.  Inference keeps noise_std=0.
      rng: PRNGKey for the noise (required when noise_std > 0); fold in
        the global step for a deterministic, exactly-resumable stream.
      history: H>1 makes the integrator SECOND(+)-ORDER: its input is the
        concatenated window ``[z_t ; z_{t-1} ; .. ; z_{t-H+1} ; dp_t]`` and
        ``z0`` must be the ``[H, B, z_num]`` TRUE codes of steps 0..H-1
        (aligned with ``p_seq[:H]``).  Motivation (r5 mechanism probe,
        BENCHMARKS.md): the mov family's latent dynamics are strongly
        non-Markovian in z — one step of history lifts one-step holdout
        R² from 0.26 to 0.76 (h=4: 0.86), so the reference's first-order
        [z_t ; dp] family structurally cannot track them.  H=1 is the
        reference-parity path, bit-identical to the pre-history code.

    Returns:
      ``[T, B, z_num]`` latent trajectory (z_0 included as step 0; with
      history H the first H entries are the true seed codes).
    """
    if history > 1 or z0.ndim == 3:
        return _rollout_history(apply_fn, params, z0, p_seq, num_param,
                                history, remat, noise_std, rng)
    z_free0 = z0[:, num_param:]
    dp_seq = p_seq[1:] - p_seq[:-1]  # [T-1, B, num_param]

    if noise_std > 0.0:
        if rng is None:
            raise ValueError("rollout(noise_std>0) needs an rng key")
        eps_seq = noise_std * jax.random.normal(
            rng, dp_seq.shape[:2] + (z_free0.shape[-1],), z_free0.dtype)
    else:
        eps_seq = jnp.zeros((dp_seq.shape[0], 1, 1), z_free0.dtype)

    def step(carry, inp):
        z_free, p_cur = carry
        dp, p_next, eps = inp
        z_free = z_free + eps     # corrupt the carried state (train only)
        z_full = jnp.concatenate([p_cur, z_free], axis=-1)
        z_free = z_free + apply_fn(params, z_full, dp)
        z = jnp.concatenate([p_next, z_free], axis=-1)
        return (z_free, p_next), z

    if remat:
        step = jax.checkpoint(step)
    _, traj = jax.lax.scan(step, (z_free0, p_seq[0]),
                           (dp_seq, p_seq[1:], eps_seq))
    z_first = jnp.concatenate([p_seq[0], z_free0], axis=-1)[None]
    return jnp.concatenate([z_first, traj], axis=0)


def _rollout_history(apply_fn, params, z0, p_seq, num_param,
                     history, remat, noise_std, rng):
    """History-H rollout (see :func:`rollout` ``history``).

    Carries the last H full codes as a ``[H, B, z_num]`` window; each step
    feeds the integrator ``[z_t ; z_{t-1} ; .. ; z_{t-H+1}]`` (current
    first — the H=1 column layout extended leftward, so the same
    LatentIntegrator module works at any H, its fc_0 simply widening) and
    advances the free block residually exactly as the first-order path.
    """
    if z0.ndim != 3:
        raise ValueError("rollout(history>1) needs z0 of shape "
                         f"[history, B, z_num]; got {z0.shape}")
    H = int(z0.shape[0])
    if history not in (1, H):
        raise ValueError(f"z0 leading dim {H} != history {history}")
    # Pin the seed codes' param blocks to the known trajectory (the free
    # blocks are the data; param blocks must match p_seq by contract).
    zwin0 = jnp.concatenate([p_seq[:H], z0[:, :, num_param:]], axis=-1)

    dp_seq = p_seq[H:] - p_seq[H - 1:-1]        # dp_t for t=H-1..T-2
    n_free = z0.shape[-1] - num_param
    if noise_std > 0.0:
        if rng is None:
            raise ValueError("rollout(noise_std>0) needs an rng key")
        eps_seq = noise_std * jax.random.normal(
            rng, dp_seq.shape[:2] + (n_free,), z0.dtype)
    else:
        eps_seq = jnp.zeros((dp_seq.shape[0], 1, 1), z0.dtype)

    def step(zwin, inp):
        dp, p_next, eps = inp
        z_free = zwin[-1][:, num_param:] + eps   # corrupt carried state
        z_cur = jnp.concatenate([zwin[-1][:, :num_param], z_free], -1)
        zwin = zwin.at[-1].set(z_cur)
        # [z_t ; z_{t-1} ; ..] — reverse the window then flatten to [B, H*z].
        z_cat = jnp.swapaxes(zwin[::-1], 0, 1).reshape(zwin.shape[1], -1)
        z_next_free = z_free + apply_fn(params, z_cat, dp)
        z_next = jnp.concatenate([p_next, z_next_free], -1)
        zwin = jnp.concatenate([zwin[1:], z_next[None]], axis=0)
        return zwin, z_next

    if remat:
        step = jax.checkpoint(step)
    _, traj = jax.lax.scan(step, zwin0, (dp_seq, p_seq[H:], eps_seq))
    return jnp.concatenate([zwin0, traj], axis=0)
