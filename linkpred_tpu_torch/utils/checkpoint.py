"""Checkpointing of parameter trees — the counterpart of
`linkpred_tpu/utils/checkpoint.py`, in its format: one `.npz` of the leaves
(`leaf_0`, `leaf_1`, ...) plus a `.tree.json` that describes the structure.

A tree is nested dicts, lists, tuples and named tuples of tensors (or
arrays). The leaves are numbered as `jax.tree_util.tree_flatten` numbers
them, dict keys in sorted order and sequences in their own, so a checkpoint
written by either package restores in the other. `latest_checkpoint` follows the
`<name>-<step>` suffix convention.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Optional

import numpy as np
import torch


def _is_namedtuple(tree: Any) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def _flatten(tree: Any) -> tuple[list, str]:
    """(leaves in jax's order, the structure written as jax prints a
    `PyTreeDef`)."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [_flatten(tree[k]) for k in keys]
        spec = ", ".join(f"{k!r}: {s}" for k, (_, s) in zip(keys, parts))
        return [leaf for leaves, _ in parts for leaf in leaves], f"{{{spec}}}"
    if isinstance(tree, (list, tuple)):
        parts = [_flatten(t) for t in tree]
        spec = ", ".join(s for _, s in parts)
        if _is_namedtuple(tree):
            spec = (f"CustomNode(namedtuple[{type(tree).__name__}], "
                    f"[{spec}])")
        elif isinstance(tree, tuple):
            spec = f"({spec}{',' if len(parts) == 1 else ''})"
        else:
            spec = f"[{spec}]"
        return [leaf for leaves, _ in parts for leaf in leaves], spec
    return [tree], "*"


def _unflatten(like: Any, leaves) -> Any:
    """`like`'s structure filled from the iterator `leaves` in `_flatten`'s
    order."""
    if isinstance(like, dict):
        filled = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: filled[k] for k in like}
    if _is_namedtuple(like):
        return type(like)(*(_unflatten(t, leaves) for t in like))
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(t, leaves) for t in like)
    return next(leaves)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_pytree(path: str, tree: Any, step: Optional[int] = None) -> str:
    """Save a tree to `<path>[-<step>].npz` (+ `.tree.json`)."""
    if step is not None:
        path = f"{path}-{step}"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    leaves, spec = _flatten(tree)
    np.savez(path + ".npz",
             **{f"leaf_{i}": _to_numpy(l) for i, l in enumerate(leaves)})
    with open(path + ".tree.json", "w") as f:
        json.dump({"treedef": f"PyTreeDef({spec})",
                   "num_leaves": len(leaves)}, f)
    return path + ".npz"


def restore_pytree(path: str, like: Any) -> Any:
    """Restore into the structure of `like` (leaf count and shapes are
    checked). A leaf comes back as `like`'s leaf is: a tensor of its dtype
    on its device (requiring grad if it does), or an array of its dtype."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    data = np.load(path)
    leaves, _ = _flatten(like)
    if len(leaves) != len(data.files):
        raise ValueError(
            f"checkpoint has {len(data.files)} leaves, expected {len(leaves)}")
    new_leaves = []
    for i, leaf in enumerate(leaves):
        arr = data[f"leaf_{i}"]
        if arr.shape != tuple(leaf.shape):
            raise ValueError(f"leaf {i}: checkpoint shape {arr.shape} != "
                             f"model {tuple(leaf.shape)}")
        if isinstance(leaf, torch.Tensor):
            new = torch.as_tensor(arr).to(device=leaf.device, dtype=leaf.dtype)
            new_leaves.append(new.requires_grad_(leaf.requires_grad))
        else:
            new_leaves.append(arr.astype(np.asarray(leaf).dtype))
    return _unflatten(like, iter(new_leaves))


def latest_checkpoint(directory: str, prefix: str) -> Optional[str]:
    """Highest-step `<prefix>-<step>.npz` in `directory`."""
    if not os.path.isdir(directory):
        return None
    best, best_step = None, -1
    pat = re.compile(re.escape(prefix) + r"-(\d+)\.npz$")
    for name in os.listdir(directory):
        m = pat.match(name)
        if m and int(m.group(1)) > best_step:
            best_step = int(m.group(1))
            best = os.path.join(directory, name)
    return best
