"""Encoder + Autoencoder (arch "ae").

Reference: deep-fluids ``model.py`` encoder + AE wiring (SURVEY.md §2, §3.3
[M][B]): a stride-2 conv encoder mirroring the generator compresses a field to
a latent code ``z``; the FIRST ``num_param`` dims of ``z`` are supervised to
equal the (normalized) simulation parameters, making the latent steerable; the
decoder is the GeneratorBE body emitting a stream function / vector potential
whose curl reconstructs the velocity.

Latent layout convention (used by the latent integrator, SURVEY.md §3.4):
    z = [ p_hat (num_param dims, supervised) ; z_free (z_num - num_param) ]
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax.numpy as jnp

from deepfluids_tpu.models.generator import (GeneratorBE, default_repeat,
                                             spatial_constraint)
from deepfluids_tpu.models.latent import LatentIntegrator
from deepfluids_tpu.models.layers import (Module, Scope, conv, dense,
                                          leaky_relu)


@dataclasses.dataclass(frozen=True)
class Encoder(Module):
    """Velocity/levelset field -> latent code z.

    Mirror of :class:`GeneratorBE`: ``repeat`` stages of {num_conv 3x3 convs
    (lrelu) + skip} with stride-2 conv downsampling between stages, then a
    dense head to ``z_num``.
    """

    z_num: int = 16
    filters: int = 128
    num_conv: int = 4
    repeat: int = 0
    act_slope: float = 0.2
    dtype: jnp.dtype = jnp.float32
    spatial_mesh: Any = None

    def __call__(self, s: Scope, x: jnp.ndarray) -> jnp.ndarray:
        spatial = x.shape[1:-1]
        rep = self.repeat or default_repeat(tuple(spatial) + (0,))
        ndim = len(spatial)
        kernel = (3,) * ndim
        act = lambda v: leaky_relu(v, negative_slope=self.act_slope)

        h = conv(s.child("conv_in"), x, self.filters, kernel, self.dtype)
        h = spatial_constraint(h, self.spatial_mesh)
        h0 = h
        for stage in range(rep):
            for c in range(self.num_conv):
                h = act(conv(s.child(f"conv_{stage}_{c}"), h, self.filters,
                             kernel, self.dtype))
                h = spatial_constraint(h, self.spatial_mesh)
            h = h + h0
            if stage < rep - 1:
                h = act(conv(s.child(f"down_{stage}"), h, self.filters,
                             kernel, self.dtype, strides=(2,) * ndim))
                h = spatial_constraint(h, self.spatial_mesh)
                h0 = h
        h = h.reshape((h.shape[0], -1))
        z = dense(s.child("fc_out"), h, self.z_num, self.dtype)
        return z.astype(jnp.float32)


@dataclasses.dataclass(frozen=True)
class Autoencoder(Module):
    """Encoder + GeneratorBE decoder; returns (psi_hat, z).

    The caller applies curl to psi_hat (same contract as the generator) and
    supervises ``z[:, :num_param]`` against the sim parameters.

    ``pred_hidden > 0`` adds a CO-TRAINED latent one-step predictor (a
    :class:`LatentIntegrator` head) used by the ``--ae_pred_w`` training
    objective: the encoder is then optimized to produce codes whose
    dynamics are Markovian — motivated by the r5 mechanism finding
    (BENCHMARKS.md "non-Markovian latent dynamics") that a
    reconstruction-only AE discards per-frame field state the latent
    dynamics need, capping every downstream integrator.  The per-frame
    FIELD is Markovian given the parameters; z need not be unless the
    encoder is asked to make it so.  Inactive (reference-parity, no extra
    params) at pred_hidden=0.
    """

    output_shape: tuple[int, ...] = (128, 96, 1)
    z_num: int = 16
    filters: int = 128
    num_conv: int = 4
    repeat: int = 0
    act_slope: float = 0.2
    dtype: jnp.dtype = jnp.float32
    spatial_mesh: Any = None
    num_param: int = 1
    pred_hidden: int = 0
    pred_depth: int = 2

    def __call__(self, s: Scope,
                 x: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
        z = self.encode(s, x)
        psi = self.decode(s, z)
        if self.pred_hidden > 0 and s.initializing:
            # Touch the predictor during init so its params are created
            # (the training loss applies it via method=predict).
            self.predict(s, z, jnp.zeros((z.shape[0], self.num_param)))
        return psi, z

    def encode(self, s: Scope, x: jnp.ndarray) -> jnp.ndarray:
        return Encoder(
            z_num=self.z_num, filters=self.filters, num_conv=self.num_conv,
            repeat=self.repeat, act_slope=self.act_slope, dtype=self.dtype,
            spatial_mesh=self.spatial_mesh,
        )(s.child("encoder"), x)

    def decode(self, s: Scope, z: jnp.ndarray) -> jnp.ndarray:
        return GeneratorBE(
            output_shape=self.output_shape, filters=self.filters,
            num_conv=self.num_conv, repeat=self.repeat,
            act_slope=self.act_slope, dtype=self.dtype,
            spatial_mesh=self.spatial_mesh,
        )(s.child("decoder"), z)

    def predict(self, s: Scope, z: jnp.ndarray,
                dp: jnp.ndarray) -> jnp.ndarray:
        """Co-trained one-step latent predictor: ``dz_free`` from
        ``[z_t ; dp_t]`` (same contract as the standalone integrator)."""
        if self.pred_hidden <= 0:
            raise ValueError("predict() needs pred_hidden > 0")
        return LatentIntegrator(
            z_num=self.z_num, num_param=self.num_param,
            hidden=self.pred_hidden, depth=self.pred_depth,
        )(s.child("predictor"), z, dp)
