"""deepfluids_tpu — a JAX (XLA/pjit) rebuild of Deep Fluids.

Re-implements the full capability surface of the reference repo
``byungsook/deep-fluids`` (see /root/repo/SURVEY.md for the structural analysis;
the reference mount was empty this session so citations are to SURVEY.md
sections rather than file:line):

- ``ops``      — finite-difference physics core: curl (p -> psi -> u = curl(psi),
                 divergence-free by construction), jacobian/vorticity losses;
                 plain jnp stencils fused by XLA.  [SURVEY §2 "ops.py"]
- ``models``   — GeneratorBE decoder, Encoder/Autoencoder, latent-integration
                 MLP.  [SURVEY §2 "model.py"]
- ``data``     — args.txt manifest + .npz field contract, normalization,
                 host-sharded batch pipeline.  [SURVEY §2 "data.py"]
- ``train``    — jit/pjit train step, Adam + cosine LR, L1 + jacobian loss,
                 .npz checkpointing, metrics.  [SURVEY §2 "trainer.py"]
- ``infer``    — batched parameter sweeps (vmap over the param grid) and
                 lax.scan latent rollouts.  [SURVEY §3.2, §3.4]
- ``datagen``  — JAX-native smoke/liquid solvers replacing the mantaflow
                 dependency, reproducing the scene/args.txt/.npz contract.
                 [SURVEY §2 "scene/*", §3.5]
- ``parallel`` — device-mesh sharding (dp/model axes), halo-exchange stencils
                 for spatially sharded grids.  [SURVEY §2 parallelism table]
- ``utils``    — run dirs, config snapshot, image/GIF export.  [SURVEY §2 "util.py"]
"""

__version__ = "0.1.0"
