"""Differential-operator core (the physics layer).

Reference parity target: ``ops.py`` of byungsook/deep-fluids (SURVEY.md §2
"Differential ops" [M]) — forward finite differences with edge replication so
outputs keep the grid shape.  ``fd`` holds the stencils in plain jnp; XLA
fuses them into the surrounding loss or inference program.
"""

from deepfluids_tpu.ops.fd import (
    curl2d,
    curl3d,
    jacobian2d,
    jacobian3d,
    divergence2d,
    divergence3d,
    vorticity2d,
    vorticity3d,
)

__all__ = [
    "curl2d",
    "curl3d",
    "jacobian2d",
    "jacobian3d",
    "divergence2d",
    "divergence3d",
    "vorticity2d",
    "vorticity3d",
]
