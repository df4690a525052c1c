"""Parameter trees: nested dicts and lists whose leaves are tensors.

The JAX package keeps a model's parameters in a pytree and steps them with
``jax.tree_util.tree_map``; these few functions do the same for the port's
functional models, and carry the one SGD step they all share.
"""

from __future__ import annotations

from typing import Callable, List

import numpy as np
import torch

from .config import DTYPE
from .numerics import resolve_device

Tensor = torch.Tensor


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and of ``rest``, trees of the same
    structure), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(
            tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_map_with_path(fn: Callable, tree, prefix: str = ""):
    """``fn(path, leaf)`` over the leaves of ``tree``, keeping the structure;
    a leaf's path joins its dict keys and list indices with '/'
    (``layers/0/w``)."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(
            tree_map_with_path(fn, v, f"{prefix}{i}/") for i, v in enumerate(tree))
    return fn(prefix.rstrip("/"), tree)


def tree_leaves(tree) -> List:
    """The leaves of ``tree`` in :func:`tree_map`'s order."""
    out: List = []
    tree_map(out.append, tree)
    return out


def tree_from_numpy(tree, device=None):
    """A tree of numpy arrays (the JAX package's parameters) as fp32 tensors
    on ``device`` (default: the card, see resolve_device)."""
    device = resolve_device(device)
    return tree_map(
        lambda v: torch.tensor(np.asarray(v), dtype=DTYPE, device=device), tree)


def sgd_step(loss_fn: Callable, params, *args, lr: float, **kwargs):
    """One functional SGD step on ``loss_fn(params, *args, **kwargs)``:
    returns (params − lr·grads as a new tree, the loss).  Gradients are taken
    for the parameters only, so no work is spent on the inputs' gradients."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss = loss_fn(leaves, *args, **kwargs)
    flat = tree_leaves(leaves)
    grads = iter(torch.autograd.grad(loss, flat))
    with torch.no_grad():
        stepped = tree_map(lambda p: p - lr * next(grads), leaves)
    return stepped, loss.detach()
