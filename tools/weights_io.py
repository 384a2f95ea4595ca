"""Framework-agnostic weight interchange (.npz <-> nested param tree).

SURVEY.md §7 step 2 requires the model family to be weight-convertible with
the reference's TF1 checkpoints (same layer counts / filter sizes).  TF1
isn't importable here, so the interchange contract is a flat .npz:

    { "<slash/joined/param/path>": array, ... }

Export a TF1 checkpoint to that form with any TF tool
(`{v.name: sess.run(v)}`), then import here.  Two matching modes:

  * exact    — npz keys equal our flattened param paths;
  * by_shape — keys are matched to our parameters in declaration order
               among same-shape tensors (enough for a 1:1 architecture
               like GeneratorBE, where every conv has a distinct stage
               shape or a stable ordering); ambiguities are reported.

Conv kernels are expected HWIO (TF and models/layers.py agree for 2D/3D
convs);
dense kernels (in, out) — also agreeing — so no transposition is needed
for reference-shaped weights.
"""

from __future__ import annotations

import sys
from typing import Any

import numpy as np


def flatten_params(tree: Any, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested param dict -> {'a/b/kernel': array} (declaration order)."""
    out: dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_params(v, f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def unflatten_params(flat: dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for path, arr in flat.items():
        node = tree
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return tree


def export_npz(params: Any, path: str) -> str:
    np.savez_compressed(path, **flatten_params(params))
    return path


def import_npz(path: str, params_template: Any,
               mode: str = "exact") -> dict:
    """Load weights from a flat .npz into our param-tree structure.

    Args:
      params_template: our model's init params (shapes + paths).
      mode: "exact" (keys match) or "by_shape" (order-within-shape match).
    Returns the populated tree; raises on unmatched/leftover tensors.
    """
    ours = flatten_params(params_template)
    with np.load(path) as d:
        theirs = {k: d[k] for k in d.files}

    if mode == "exact":
        missing = sorted(set(ours) - set(theirs))
        if missing:
            raise KeyError(f"npz missing {len(missing)} params, e.g. "
                           f"{missing[:3]}")
        extra = sorted(set(theirs) - set(ours))
        if extra:
            # A typo'd/stale tensor name in the export would otherwise be
            # dropped silently (mirrors by_shape's leftover check).
            raise KeyError(f"npz has {len(extra)} keys with no matching "
                           f"param, e.g. {extra[:3]}")
        bad = [(k, theirs[k].shape, ours[k].shape) for k in ours
               if tuple(theirs[k].shape) != tuple(ours[k].shape)]
        if bad:
            k, got, want = bad[0]
            raise ValueError(
                f"{len(bad)} shape mismatches, e.g. {k}: npz has {got}, "
                f"model wants {want} (a transposed dense kernel would "
                f"import silently without this check)")
        flat = {k: theirs[k].astype(ours[k].dtype) for k in ours}
        return unflatten_params(flat)

    if mode != "by_shape":
        raise ValueError(f"unknown mode {mode!r}")
    # Group both sides by shape; match in insertion order within groups.
    from collections import defaultdict

    by_shape: dict[tuple, list[str]] = defaultdict(list)
    for k, v in theirs.items():
        by_shape[tuple(v.shape)].append(k)
    # Report ambiguity up front: same-shape groups with >1 member are
    # matched by insertion order, which is only correct if both sides
    # enumerate in the same order — the caller must confirm.
    ambiguous = {shp: ks for shp, ks in by_shape.items() if len(ks) > 1}
    if ambiguous:
        ex_shp = next(iter(ambiguous))
        print(f"weights_io: by_shape matching {len(ambiguous)} ambiguous "
              f"shape groups by insertion order (e.g. {ex_shp}: "
              f"{len(ambiguous[ex_shp])} tensors {ambiguous[ex_shp][:3]}...) "
              f"— verify source enumeration order matches the model's",
              file=sys.stderr)
    flat = {}
    for k, v in ours.items():
        pool = by_shape.get(tuple(v.shape))
        if not pool:
            raise KeyError(f"no tensor of shape {v.shape} left for {k}")
        src = pool.pop(0)
        flat[k] = theirs[src].astype(v.dtype)
    leftover = [k for pool in by_shape.values() for k in pool]
    if leftover:
        raise KeyError(f"{len(leftover)} unmatched source tensors, e.g. "
                       f"{leftover[:3]}")
    return unflatten_params(flat)


if __name__ == "__main__":
    print(__doc__)
    sys.exit(0)
