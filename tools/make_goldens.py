"""Regenerate the committed golden fields under tests/golden/.

Run on CPU (`python tools/make_goldens.py`) after any INTENTIONAL change to
discretization semantics; tests/test_parity.py compares fresh computations
against these dumps with the [B] normalized-L2 < 1e-3 gate, so accidental
drift in the FD scheme, boundary handling, model wiring, or solver stepping
fails CI loudly.

The model goldens (generator2d, autoencoder2d, integrator) hold weights that
were initialised by the Flax implementation this package replaced, beside
that implementation's outputs.  This script keeps those weights and
recomputes only the generator's outputs.
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from deepfluids_tpu import ops
from deepfluids_tpu.datagen.smoke2d import Smoke2DConfig, simulate_smoke2d
from deepfluids_tpu.models import GeneratorBE
from weights_io import unflatten_params

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tests", "golden")


def main():
    os.makedirs(GOLDEN_DIR, exist_ok=True)
    rng = np.random.default_rng(20260816)

    # 1) FD operators on a fixed random field.
    psi = rng.standard_normal((2, 32, 24, 1)).astype(np.float32)
    u = np.asarray(ops.curl2d(jnp.asarray(psi)))
    j, w = ops.jacobian2d(jnp.asarray(u))
    np.savez_compressed(os.path.join(GOLDEN_DIR, "fd2d.npz"),
                        psi=psi, u=u, j=np.asarray(j), w=np.asarray(w))

    psi3 = rng.standard_normal((1, 8, 12, 16, 3)).astype(np.float32)
    u3 = np.asarray(ops.curl3d(jnp.asarray(psi3)))
    j3, w3 = ops.jacobian3d(jnp.asarray(u3))
    np.savez_compressed(os.path.join(GOLDEN_DIR, "fd3d.npz"),
                        psi=psi3, u=u3, j=np.asarray(j3), w=np.asarray(w3))

    # 2) Datagen solver: 6 frames of the 2D smoke scene at fixed params.
    cfg = Smoke2DConfig(height=32, width=24, num_frames=6, project_iters=20)
    vt, rt = simulate_smoke2d(jnp.float32(0.5), jnp.float32(0.1), cfg)
    np.savez_compressed(os.path.join(GOLDEN_DIR, "smoke2d.npz"),
                        v=np.asarray(vt), r=np.asarray(rt))

    # 3) Generator forward with the committed weights.
    path = os.path.join(GOLDEN_DIR, "generator2d.npz")
    with np.load(path) as g:
        weights = {k: g[k] for k in g.files if k.startswith("params/")}
        p = g["p"]
    params = unflatten_params({k[len("params/"):]: v
                               for k, v in weights.items()})
    model = GeneratorBE(output_shape=(32, 24, 1), filters=8, num_conv=2)
    out = np.asarray(ops.curl2d(model.apply({"params": params},
                                            jnp.asarray(p))))
    np.savez_compressed(path, p=p, u=out, **weights)

    print(f"goldens written to {GOLDEN_DIR}")


if __name__ == "__main__":
    main()
