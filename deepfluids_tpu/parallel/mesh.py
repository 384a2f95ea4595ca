"""Device mesh + sharding helpers (the DP/TP backbone).

Design (SURVEY.md §2 parallelism table, §7 "Hard parts"): Deep-Fluids fields
are small (2D 128x96x2 ≈ 100 KB, 3D 112x64x32x3 ≈ 2.7 MB) — far below the
point where spatially sharding one grid pays for halo traffic.  The winning
layout is therefore:

  * **data axis**: shard the BATCH (training) or the PARAMETER SWEEP
    (inference) across devices; weights replicated.  Gradients are combined
    by XLA's automatic all-reduce — no hand-written collectives needed.
  * weights/optimizer state: replicated (model is ~30 MB of f32 params).

The mesh is 1-axis ("data") by default; `make_mesh` accepts an explicit
(data, model) shape for experiments with channel-sharded convs, and all
helpers degrade gracefully to a 1-device mesh (CPU dev loop, single chip).
"""

from __future__ import annotations

from typing import Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(
    num_data: int | None = None,
    num_model: int = 1,
    devices: Sequence[jax.Device] | None = None,
) -> Mesh:
    """Build a (data, model) mesh over the available devices.

    Args:
      num_data: size of the data axis; default = all devices / num_model.
      num_model: size of the model axis (default 1 — weights replicated).
      devices: explicit device list (tests pass virtual CPU devices).
    """
    devices = list(devices if devices is not None else jax.devices())
    if num_data is None:
        num_data = len(devices) // num_model
    n = num_data * num_model
    if n > len(devices):
        raise ValueError(
            f"mesh {num_data}x{num_model} needs {n} devices, "
            f"have {len(devices)}"
        )
    dev_array = np.asarray(devices[:n]).reshape(num_data, num_model)
    return Mesh(dev_array, (DATA_AXIS, MODEL_AXIS))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for batched arrays: leading dim split over the data axis."""
    return NamedSharding(mesh, P(DATA_AXIS))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    """Fully-replicated sharding (weights, optimizer state, scalars)."""
    return NamedSharding(mesh, P())


def shard_batch(mesh: Mesh, *arrays):
    """Place host numpy batches onto the mesh, batch dim over the data axis.

    Pads nothing: callers must keep batch_size divisible by the data-axis
    size (asserted here so failures are loud, not silently misplaced).
    """
    ndata = mesh.shape[DATA_AXIS]
    out = []
    sh = batch_sharding(mesh)
    for a in arrays:
        if a.shape[0] % ndata != 0:
            raise ValueError(
                f"batch dim {a.shape[0]} not divisible by data-axis size "
                f"{ndata}"
            )
        out.append(jax.device_put(a, sh))
    return out[0] if len(out) == 1 else tuple(out)


def model_sharded_state(state, mesh: Mesh):
    """Sharding pytree for a TrainState under tensor parallelism (TP).

    Rule (SURVEY §2 parallelism table "TP: shard conv channels over a model
    axis"): CONV kernels (ndim >= 3, HWIO/DHWIO) whose output-channel dim
    is divisible by the model-axis size are split on that dim; Adam's mu/nu
    mirror params automatically (same shapes).  Dense kernels stay
    replicated on purpose: the generator's fc_in output is reshaped to
    (spatial x channels), so sharding its flattened dim becomes a tiny
    SPATIAL sharding after the reshape — which trips an XLA conv-grad-
    filter halo double-count (observed exact-2x kernel grads) and is the
    wrong layout anyway.  Biases are tiny; replicated.  XLA inserts the
    activation collectives.

    Returns a pytree of NamedShardings matching ``state``; with a 1-sized
    model axis this degrades to fully-replicated.
    """
    m = mesh.shape[MODEL_AXIS]

    def rule(x):
        shape = getattr(x, "shape", ())
        if m > 1 and len(shape) >= 3 and shape[-1] % m == 0:
            return NamedSharding(
                mesh, P(*([None] * (len(shape) - 1) + [MODEL_AXIS])))
        return NamedSharding(mesh, P())

    import jax as _jax

    return _jax.tree.map(rule, state)


def shard_batch_multihost(mesh: Mesh, *arrays):
    """Multi-host :func:`shard_batch`: place a GLOBALLY-IDENTICAL host batch
    onto a mesh spanning several processes.

    Every host computes the same global batch (the batch stream is a pure
    function of (seed, step) on all hosts — data.dataset.step_rng), hands
    its local row-slice to ``jax.make_array_from_process_local_data``, and
    gets back a global jax.Array sharded over the data axis.  Works in
    single-process runs too (degenerates to the plain placement).
    """
    sh = batch_sharding(mesh)
    out = []
    for a in arrays:
        if a.shape[0] % mesh.shape[DATA_AXIS] != 0:
            raise ValueError(
                f"batch dim {a.shape[0]} not divisible by data-axis size "
                f"{mesh.shape[DATA_AXIS]}")
        out.append(jax.make_array_from_process_local_data(
            sh, _local_rows(sh, np.asarray(a)), a.shape))
    return out[0] if len(out) == 1 else tuple(out)


def _local_rows(sharding: NamedSharding, a: np.ndarray) -> np.ndarray:
    """This process's contiguous row-slice of a global batch array.

    ``jax.devices()`` orders devices by process, so under P("data") each
    process owns a contiguous block of rows; gather exactly those (in
    device order) from the replicated host copy.  When the sharding also
    REPLICATES over another mesh axis (a data x model mesh), several
    local devices map to the SAME row-slice — deduplicate, because
    make_array_from_process_local_data wants each local shard once."""
    idx_map = sharding.addressable_devices_indices_map(a.shape)
    rows, seen = [], set()
    for _, idx in sorted(idx_map.items(), key=lambda kv: kv[0].id):
        key = tuple((s.start, s.stop, s.step) for s in idx)
        if key in seen:
            continue
        seen.add(key)
        rows.append(a[idx])
    return np.concatenate(rows) if rows else a[:0]


def init_distributed() -> bool:
    """Initialize multi-host JAX (SURVEY.md §5 "Distributed comm backend").

    `jax.distributed.initialize` wires hosts together so `jax.devices()`
    spans every process and the mesh helpers above shard over all devices
    (NCCL between GPUs; gloo on the CPU backend — exercised by
    tests/test_multihost.py and tools/launch_multihost.py).

    Configuration comes from the environment: ``JAX_COORDINATOR_ADDRESS``
    (+ ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID`` for manual launches like
    tools/launch_multihost.py; cluster schedulers that set only the
    coordinator address use jax's own cluster autodetection).  No-ops
    (returns False) in single-process runs — safe to call unconditionally
    from main().
    """
    import os

    addr = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if not addr:
        return False
    # Cross-process collectives on the CPU backend need gloo (no-op for
    # GPUs, where XLA runs the collectives through NCCL).
    try:
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    except Exception:
        pass  # option absent/renamed: the GPU path works regardless
    nproc = os.environ.get("JAX_NUM_PROCESSES")
    pid = os.environ.get("JAX_PROCESS_ID")
    if nproc is not None and pid is not None:
        jax.distributed.initialize(coordinator_address=addr,
                                   num_processes=int(nproc),
                                   process_id=int(pid))
    else:
        jax.distributed.initialize()
    return True
