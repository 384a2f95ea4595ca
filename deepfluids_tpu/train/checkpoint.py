"""Checkpoints as one ``.npz`` per step.

Layout: ``<ckpt_dir>/step_<NNNNNNNN>.npz``, one array per pytree leaf keyed
by its tree path (``params/conv_0_0/kernel``, ``opt_state/0/mu/fc_in/bias``,
``step``).  A save writes a temporary file and renames it into place, so a
crash mid-write never leaves a truncated checkpoint under the final name;
the newest ``keep`` checkpoints are kept.
"""

from __future__ import annotations

import os
import re
from typing import Any

import jax
import numpy as np

_NAME = re.compile(r"^step_(\d+)\.npz$")


def _key_name(k) -> str:
    for attr in ("key", "name", "idx"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    raise TypeError(f"unsupported tree path element {k!r}")


def _names(tree: Any):
    leaves, treedef = jax.tree_util.tree_flatten_with_path(tree)
    names = ["/".join(_key_name(k) for k in p) for p, _ in leaves]
    return names, [v for _, v in leaves], treedef


def flatten(tree: Any) -> dict[str, np.ndarray]:
    """Pytree -> {"a/b/c": host array} keyed by tree path."""
    names, leaves, _ = _names(tree)
    return {n: np.asarray(v) for n, v in zip(names, leaves)}


def unflatten(flat: dict[str, np.ndarray], target: Any,
              prefix: str = "") -> Any:
    """Rebuild ``target``'s structure from ``flat[prefix + path]``.

    Raises ValueError when a path is missing or a leaf's shape differs."""
    names, leaves, treedef = _names(target)
    out = []
    for n, v in zip(names, leaves):
        a = flat.get(prefix + n)
        if a is None or a.shape != np.shape(v):
            raise ValueError(
                f"checkpoint leaf {prefix + n}: saved "
                f"{None if a is None else a.shape}, target {np.shape(v)}")
        out.append(a)
    return jax.tree_util.tree_unflatten(treedef, out)


def path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}.npz")


def steps(ckpt_dir: str) -> list[int]:
    """Saved steps, ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for m in map(_NAME.match,
                                               os.listdir(ckpt_dir)) if m)


def save(ckpt_dir: str, step: int, tree: Any, keep: int = 3) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    final = path(ckpt_dir, step)
    tmp = final + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **flatten(tree))
    os.replace(tmp, final)
    for old in steps(ckpt_dir)[:-keep]:
        os.remove(path(ckpt_dir, old))
    return final


def load_flat(ckpt_dir: str, step: int) -> dict[str, np.ndarray]:
    with np.load(path(ckpt_dir, step), allow_pickle=False) as d:
        return {k: d[k] for k in d.files}


def restore(ckpt_dir: str, step: int, target: Any) -> Any:
    """Load ``step`` into the structure of ``target``.

    Raises ValueError when the saved tree differs from ``target`` in its
    paths or leaf shapes (e.g. another optimizer chain)."""
    flat = load_flat(ckpt_dir, step)
    extra = sorted(set(flat) - set(_names(target)[0]))
    if extra:
        raise ValueError(f"checkpoint {step} has {len(extra)} leaves the "
                         f"target lacks, e.g. {extra[:3]}")
    return unflatten(flat, target)
