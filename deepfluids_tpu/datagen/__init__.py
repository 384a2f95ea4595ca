"""JAX-native fluid solvers + scene scripts (the data-generation layer, L0).

Replaces the reference's external mantaflow C++ solver (SURVEY.md §2
"Languages", §3.5 [M]): the same role — produce ``data/<name>/v/*.npz`` +
``args.txt`` training datasets — but implemented as jit-compiled,
``lax.scan``-stepped JAX programs that run on GPU/CPU with no external
dependency.  Scene configs mirror the reference's four scripts
(smoke_pos21_size5, smoke_mov200_f400, liquid_pos10_size4,
smoke3_vel5_buo3_f250).
"""

from deepfluids_tpu.datagen.smoke2d import Smoke2DConfig, simulate_smoke2d
from deepfluids_tpu.datagen.smoke3d import Smoke3DConfig, simulate_smoke3d
from deepfluids_tpu.datagen.liquid2d import Liquid2DConfig, simulate_liquid2d
from deepfluids_tpu.datagen import scenes

__all__ = [
    "Smoke2DConfig",
    "simulate_smoke2d",
    "Smoke3DConfig",
    "simulate_smoke3d",
    "Liquid2DConfig",
    "simulate_liquid2d",
    "scenes",
]
