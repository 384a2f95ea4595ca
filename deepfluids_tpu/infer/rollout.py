"""AE dataset encoding + latent-space temporal rollout (archs "ae"+"nn").

Reference: SURVEY.md §3.3 (post-AE encode pass dumps the dataset's latent
codes, the 'code' set consumed by arch 'nn') and §3.4 (test-time rollout:
encode a start frame, advance z with the integrator, decode each step).
Here the rollout is one ``lax.scan`` and decode is vmapped over time, so a
whole trajectory is produced in two compiled calls with no host round-trips
(whole trajectories stay on the device).
"""

from __future__ import annotations

import glob
import os
import re
from collections import defaultdict
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from deepfluids_tpu.data.manifest import Manifest, load_manifest
from deepfluids_tpu.models.latent import rollout as latent_rollout


def encode_dataset(
    encode_fn: Callable[[np.ndarray], np.ndarray],
    dataset_dir: str,
    z_num: int,
    batch_size: int = 32,
    field_key: str = "v",
    suffix: str = "",
) -> str:
    """Encode every frame of a dataset into per-scene latent sequences.

    Writes ``<dataset_dir>/code<z_num><suffix>/<scene>.npz`` with keys ``z``
    ([T, z_num], the AE latent with front dims ≈ normalized params) and
    ``p`` ([T, num_param], RAW params) — the contract CodeDataset reads
    (SURVEY.md §3.3 'code' set).

    Args:
      encode_fn: ``x [B, *res, C] (normalized) -> z [B, z_num]``.
    """
    manifest = load_manifest(dataset_dir)
    files = sorted(glob.glob(os.path.join(dataset_dir, field_key, "*.npz")))
    if not files:
        raise FileNotFoundError(f"no fields under {dataset_dir}/{field_key}")

    # Group frames by scene prefix: "<i>_<j>_..._<frame>.npz".
    scenes: dict[str, list[tuple[int, str]]] = defaultdict(list)
    for fp in files:
        stem = os.path.basename(fp)[:-4]
        m = re.match(r"^(.*)_(\d+)$", stem)
        if m is None:
            import warnings

            warnings.warn(
                f"skipping {fp}: name does not match the dataset contract "
                "'<scene>_<frame>.npz'")
            continue
        scenes[m.group(1)].append((int(m.group(2)), fp))

    out_dir = os.path.join(dataset_dir, f"code{z_num}{suffix}")
    os.makedirs(out_dir, exist_ok=True)
    for scene, frames in scenes.items():
        frames.sort()
        xs, ps = [], []
        for _, fp in frames:
            with np.load(fp) as d:
                xs.append(manifest.normalize_field(
                    d["x"].astype(np.float32)))
                ps.append(d["y"].astype(np.float32))
        zs = []
        for i in range(0, len(xs), batch_size):
            chunk = np.stack(xs[i:i + batch_size])
            pad = batch_size - chunk.shape[0]
            if pad:  # pad the trailing batch: ONE compiled shape per run
                chunk = np.concatenate(
                    [chunk, np.repeat(chunk[-1:], pad, 0)])
            z = encode_fn(chunk)
            zs.append(z[:z.shape[0] - pad] if pad else z)
        np.savez_compressed(
            os.path.join(out_dir, f"{scene}.npz"),
            z=np.concatenate(zs).astype(np.float32),
            p=np.stack(ps).astype(np.float32))
    return out_dir


def rollout_trajectory(
    integrator_apply: Callable,
    integrator_params,
    decode_fn: Callable[[jnp.ndarray], jnp.ndarray],
    z0: np.ndarray,
    raw_p_seq: np.ndarray,
    manifest: Manifest,
    decode_batch: int = 32,
) -> tuple[np.ndarray, np.ndarray]:
    """Advance z0 through a parameter trajectory and decode every step.

    Args:
      integrator_apply: ``(params, z_full, dp) -> dz_free`` (batched) —
        z_full is the FULL latent (pinned param block + free block, see
        models.latent.rollout); only the free block's update is returned.
      decode_fn: ``z [B, z_num] -> field [B, *res, C]`` (normalized units,
        curl applied).
      z0: [B, z_num] start codes (front dims = normalized params at t=0),
        or [H, B, z_num] for a history-H integrator (--nn_history: the
        first H encoded codes seed the second-order rollout).
      raw_p_seq: [T, num_param] raw parameter trajectory (shared across the
        batch) or [T, B, num_param].
    Returns:
      (z_traj [T, B, z_num], fields [T, B, *res, C] in RAW units).
    """
    num_param = manifest.num_param
    batch = z0.shape[1] if z0.ndim == 3 else z0.shape[0]
    p_norm = manifest.normalize_params(raw_p_seq)
    if p_norm.ndim == 2:
        p_norm = np.repeat(p_norm[:, None], batch, axis=1)
    z_traj = latent_rollout(integrator_apply, integrator_params,
                            jnp.asarray(z0), jnp.asarray(p_norm), num_param,
                            history=z0.shape[0] if z0.ndim == 3 else 1)
    z_traj = np.asarray(z_traj)
    t, b = z_traj.shape[:2]
    flat = z_traj.reshape(t * b, -1)
    outs = []
    for i in range(0, flat.shape[0], decode_batch):
        outs.append(np.asarray(decode_fn(jnp.asarray(
            flat[i:i + decode_batch]))))
    fields = np.concatenate(outs).reshape((t, b) + outs[0].shape[1:])
    return z_traj, manifest.denormalize_field(fields)
