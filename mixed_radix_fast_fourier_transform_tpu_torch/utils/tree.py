"""Parameter trees: nested dicts and lists whose leaves are tensors.

The JAX package keeps a model's parameters in a pytree and steps them with
``jax.tree_util.tree_map``; these few functions do the same for the port's
functional models, and carry the one SGD step they all share, eager
(:func:`sgd_step`) or compiled (:func:`compile_sgd_step`, the counterpart
of ``jax.jit`` of a model's ``train_step``).
"""

from __future__ import annotations

from typing import Callable, List, Sequence

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


def tree_from_numpy(tree, device=None, dtype=DTYPE):
    """A tree of numpy arrays (the JAX package's parameters) as ``dtype``
    tensors (fp32 by default) on ``device`` (default: the card, see
    resolve_device)."""
    device = resolve_device(device)
    return tree_map(
        lambda v: torch.tensor(np.asarray(v), dtype=dtype, device=device), tree)


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


def _sgd_update(leaves: Sequence[Tensor], grads: Sequence[Tensor], lr) -> List[Tensor]:
    return [p - lr * g for p, g in zip(leaves, grads)]


def compile_sgd_step(loss_fn: Callable, **options) -> Callable:
    """:func:`sgd_step` on ``loss_fn`` compiled, as ``jax.jit`` compiles a
    model's ``train_step``: returns ``step(params, *args, lr, **kwargs)`` with
    :func:`sgd_step`'s arguments and results.

    The loss is compiled whole (``torch.compile(loss_fn, fullgraph=True,
    dynamic=False, **options)``; AOTAutograd compiles its backward with it,
    the fused kernel's backward as its operator at the opposite sign), the
    gradients are taken by ``torch.autograd.grad`` outside the traced region
    (dynamo cannot trace it under ``fullgraph``), and the update ``p − lr·g``
    over all leaves is compiled too.  ``options`` go to both
    ``torch.compile`` calls (``backend="aot_eager"`` for a CPU without a
    compiler; Inductor by default).  Each new argument shape compiles once,
    as under ``jax.jit``; hold on to the returned function."""
    opts = dict(fullgraph=True, dynamic=False, **options)
    loss_c = torch.compile(loss_fn, **opts)
    update_c = torch.compile(_sgd_update, **opts)

    def step(params, *args, lr: float, **kwargs):
        leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
        flat = tree_leaves(leaves)
        loss = loss_c(leaves, *args, **kwargs)
        grads = torch.autograd.grad(loss, flat)
        with torch.no_grad():
            stepped = iter(update_c([p.detach() for p in flat], grads, lr))
        return tree_map(lambda _: next(stepped), leaves), loss.detach()

    return step
