"""Functional layers: a parameter scope, dense, SAME-padded conv, activations.

Each model is a frozen dataclass deriving from :class:`Module`:

    variables = model.init(rng, *x)            # {"params": nested dict}
    y = model.apply(variables, *x, method=...)

Its forward pass takes a :class:`Scope` as first argument.  At init the
scope creates every parameter it is asked for (with the initializer named at
the call site, so shapes come from the forward pass itself); at apply it
reads them.  Parameter trees are plain nested dicts keyed by layer name
(``fc_in``, ``conv_{stage}_{c}``, ``conv_out`` ... each holding ``kernel`` /
``bias``), in call order, with HWIO / DHWIO conv kernels and (in, out) dense
kernels — the layout ``tools/weights_io.py`` and the tensor-parallel rule in
``parallel/mesh.py`` rely on.

Numerics follow Flax's ``nn.Dense`` / ``nn.Conv``: inputs, kernels and
biases are cast to the layer's ``dtype`` before the product (params stay
f32), kernels default to LeCun-normal and biases to zeros.
"""

from __future__ import annotations

import zlib

import jax
import jax.numpy as jnp
from jax import lax

lecun_normal = jax.nn.initializers.lecun_normal()
zeros = jax.nn.initializers.zeros
normal = jax.nn.initializers.normal

leaky_relu = jax.nn.leaky_relu
elu = jax.nn.elu


class Scope:
    """One node of a parameter tree.

    With ``rng`` set (init) a missing parameter or child is created; without
    it (apply) every lookup must hit.  Keys for new parameters are derived
    from the node's key and the parameter's NAME, so a parameter's initial
    value does not depend on how many others were created before it.
    """

    def __init__(self, params: dict, rng: jax.Array | None = None):
        self.params = params
        self.rng = rng

    @property
    def initializing(self) -> bool:
        return self.rng is not None

    def _key(self, name: str) -> jax.Array:
        return jax.random.fold_in(self.rng, zlib.crc32(name.encode()))

    def param(self, name: str, init, shape, dtype=jnp.float32) -> jax.Array:
        if self.rng is not None and name not in self.params:
            self.params[name] = init(self._key(name), tuple(shape), dtype)
        return self.params[name]

    def child(self, name: str) -> "Scope":
        if self.rng is None:
            return Scope(self.params[name])
        return Scope(self.params.setdefault(name, {}), self._key(name))


class Module:
    """Base of the model dataclasses: ``init`` / ``apply`` over a Scope.

    Subclasses are ``@dataclasses.dataclass(frozen=True)``, so instances and
    their bound ``apply`` are hashable static fields of a jitted pytree."""

    def init(self, rng: jax.Array, *args, method=None) -> dict:
        params: dict = {}
        (method or self.__call__)(Scope(params, rng), *args)
        return {"params": params}

    def apply(self, variables: dict, *args, method=None):
        return (method or self.__call__)(Scope(variables["params"]), *args)


def dense(s: Scope, x: jax.Array, features: int, dtype,
          kernel_init=lecun_normal, use_bias: bool = True) -> jax.Array:
    """``x @ kernel + bias`` over the last axis, computed in ``dtype``."""
    kernel = s.param("kernel", kernel_init, (x.shape[-1], features))
    y = lax.dot_general(x.astype(dtype), kernel.astype(dtype),
                        (((x.ndim - 1,), (0,)), ((), ())))
    if use_bias:
        y = y + s.param("bias", zeros, (features,)).astype(dtype)
    return y


def conv(s: Scope, x: jax.Array, features: int, kernel_size: tuple, dtype,
         strides: tuple | None = None, use_bias: bool = True) -> jax.Array:
    """SAME-padded channels-last conv (NHWC/HWIO or NDHWC/DHWIO)."""
    nd = len(kernel_size)
    kernel = s.param("kernel", lecun_normal,
                     tuple(kernel_size) + (x.shape[-1], features))
    dn = lax.ConvDimensionNumbers(
        lhs_spec=(0, nd + 1) + tuple(range(1, nd + 1)),
        rhs_spec=(nd + 1, nd) + tuple(range(nd)),
        out_spec=(0, nd + 1) + tuple(range(1, nd + 1)))
    y = lax.conv_general_dilated(
        x.astype(dtype), kernel.astype(dtype), strides or (1,) * nd, "SAME",
        dimension_numbers=dn)
    if use_bias:
        y = y + s.param("bias", zeros, (features,)).astype(dtype)
    return y
