"""Parallelism layer: device mesh, sharding specs, distributed init.

The reference is single-process / single-GPU (SURVEY.md §2 "Parallelism /
comm backend": NONE) — everything here is an *additive* component: SPMD
data parallelism over a `jax.sharding.Mesh` with XLA's collectives, per
SURVEY.md §2's parallelism-mapping table.
"""

from deepfluids_tpu.parallel.mesh import (
    make_mesh,
    batch_sharding,
    replicated_sharding,
    shard_batch,
    DATA_AXIS,
)
from deepfluids_tpu.parallel.halo import (
    curl2d_sharded,
    jacobian2d_sharded,
    divergence2d_sharded,
)

__all__ = [
    "make_mesh",
    "batch_sharding",
    "replicated_sharding",
    "shard_batch",
    "DATA_AXIS",
    "curl2d_sharded",
    "jacobian2d_sharded",
    "divergence2d_sharded",
]
