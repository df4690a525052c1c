"""Model checkpoint save/load.

Counterpart of ``mixed_radix_fast_fourier_transform_tpu/models/checkpoint.py``
and the same file format: one ``.npz`` with the flattened parameter tree
(keys = '/'-joined paths of dict keys and list indices), so a checkpoint
written by either package loads into the other, and is portable, diffable
and free of pickle hazards.  Works for every model family and any other
dict/list tree of tensors or arrays.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..utils.numerics import resolve_device
from ..utils.tree import tree_map_with_path


def _to_numpy(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix.rstrip("/")] = _to_numpy(tree)
    return out


def save_checkpoint(path: str, params: Any) -> int:
    """Write a parameter tree to ``path`` (.npz).  Returns the leaf count."""
    flat = _flatten(params)
    np.savez_compressed(path, **flat)
    return len(flat)


def load_checkpoint(path: str, like: Any = None, device=None) -> Any:
    """Read a checkpoint.  With ``like`` (a template tree of matching
    structure) the arrays are restored into that structure as tensors on
    ``device`` (default: the card) in the template leaves' dtypes; without
    it, returns the nested dict of numpy arrays implied by the '/'-separated
    keys (list indices come back as string keys)."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    if like is None:
        nested: Dict[str, Any] = {}
        for key, val in flat.items():
            parts = key.split("/")
            cur = nested
            for p in parts[:-1]:
                cur = cur.setdefault(p, {})
            cur[parts[-1]] = val
        return nested
    template = _flatten(like)
    if set(template) != set(flat):
        missing = set(template) ^ set(flat)
        raise ValueError(f"checkpoint/template key mismatch: {sorted(missing)[:5]}")
    device = resolve_device(device)

    def restore(key: str, leaf: Any):
        dtype = leaf.dtype if isinstance(leaf, torch.Tensor) else torch.from_numpy(
            np.asarray(leaf)).dtype
        return torch.tensor(flat[key], dtype=dtype, device=device)

    return tree_map_with_path(restore, like)
