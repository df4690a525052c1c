"""Sharded arrays on ``torch.distributed``: DTensor primitives, the sums over
ranks, and the JAX meaning of a sharded argument to an op.

The port's own module (the JAX package has no counterpart: there a sharded
``jax.Array`` runs through any op under ``jax.jit`` and GSPMD's partitioner
places the work).  Here the placement is made explicit:

* :func:`batch_sharded` makes a public op take a DTensor.  Axes that the op
  treats as batch keep their sharding, and the op runs on each rank's local
  block with no collective; an axis the op transforms is replicated first
  (``redistribute``, as the partitioner gathers it).  The outputs are
  DTensors on the same mesh with the same placements, equal to the
  single-device call.
* :func:`global_mean` is the one loss core on a batch-sharded batch with
  plain tensor parameters, as ``jit`` partitions it: the global mean of any
  per-element or per-example term (each counted once), held by every rank,
  the parameters' gradients summed over the ranks (:func:`replicated`).
  :func:`data_parallel_loss` runs a model on the local blocks and takes
  it; :func:`data_parallel_mse` and :func:`mean_squared_error` are its
  squared error.
* The sums are functional collectives (``torch.distributed.
  _functional_collectives``), one code path eagerly and under
  ``torch.compile``: gloo on the CPU, NCCL on the card.  No complex tensor
  goes through a collective (gloo's complex support is not to be relied
  on): a complex value moves through its real view.
"""

from __future__ import annotations

import functools
import inspect
from typing import Callable, Optional, Sequence

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from .numerics import as_tensor

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# DTensors: a local block as the global array, moving between placements.
# ---------------------------------------------------------------------------


def dtensor(local: Tensor, mesh: DeviceMesh, placements, shape) -> DTensor:
    """``local`` (this rank's block) as the DTensor of the global ``shape``
    (contiguous strides) under ``placements``; no collective."""
    shape = torch.Size(shape)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, mesh, placements, shape=shape, stride=stride)


def redistribute(x: DTensor, placements) -> DTensor:
    """``x`` in ``placements``; a complex DTensor moves through its real view."""
    placements = tuple(placements)
    if tuple(x.placements) == placements:
        return x
    mesh = x.device_mesh
    if not x.is_complex():
        return x.redistribute(mesh, placements)
    re = dtensor(torch.view_as_real(x.to_local()), mesh, x.placements, x.shape + (2,))
    local = re.redistribute(mesh, placements).to_local()
    return dtensor(torch.view_as_complex(local.contiguous()), mesh, placements, x.shape)


def global_input(x, mesh: DeviceMesh):
    """A DTensor as it is; anything else as the global tensor on the mesh's
    device type (a tensor elsewhere is moved: NCCL exchanges card memory,
    gloo host memory)."""
    if isinstance(x, DTensor):
        return x
    x = as_tensor(x, mesh.device_type)
    return x if x.device.type == mesh.device_type else x.to(mesh.device_type)


def local_placed(x, mesh: DeviceMesh, placements) -> Tensor:
    """This rank's block of ``x`` in ``placements``: a DTensor is
    redistributed (a no-op where it has them already); a plain tensor is the
    global array and is sliced."""
    x = global_input(x, mesh)
    if isinstance(x, DTensor):
        return redistribute(x, placements).to_local()
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            parts = mesh.shape[i]
            if x.shape[p.dim] % parts:
                raise ValueError(
                    f"axis {p.dim} of shape {tuple(x.shape)} must divide by mesh axis "
                    f"{mesh.mesh_dim_names[i]!r} ({parts})")
            size = x.shape[p.dim] // parts
            x = x.narrow(p.dim, mesh.get_local_rank(i) * size, size)
    return x


# ---------------------------------------------------------------------------
# Sums over ranks.
# ---------------------------------------------------------------------------


def all_reduce(x: Tensor, groups) -> Tensor:
    """The sum of ``x`` over the ranks of each of ``groups`` in turn (a
    complex tensor through its real view): functional all-reduces, one code
    path eagerly and under a tracer."""
    view = torch.view_as_real(x) if x.is_complex() else x
    for group in groups:
        view = funcol.wait_tensor(funcol.all_reduce(view.contiguous(), "sum", group))
    return torch.view_as_complex(view) if x.is_complex() else view


def mesh_groups(mesh: DeviceMesh) -> list:
    """The process group of every mesh dimension: a sum over all of them
    in turn is a sum over every rank of the mesh."""
    return [mesh.get_group(i) for i in range(mesh.ndim)]


class Sum(torch.autograd.Function):
    """Sum over the ranks of ``groups`` whose result every rank holds, as
    ``psum`` under ``shard_map``: the backward passes the cotangent through,
    since each rank's cotangent of the replicated result is that of the one
    global value."""

    @staticmethod
    def forward(ctx, x: Tensor, groups):
        return all_reduce(x.detach(), groups)

    @staticmethod
    def backward(ctx, g: Tensor):
        return g, None


class Replicated(torch.autograd.Function):
    """A parameter every rank holds, used by a sharded computation: the
    forward is the identity; the backward sums the ranks' gradients over
    ``groups`` with an all-reduce, so every rank gets the gradient of the
    global loss (what jit's partitioner does for a replicated parameter)."""

    @staticmethod
    def forward(ctx, p: Tensor, groups):
        ctx.groups = groups
        return p.view_as(p)

    @staticmethod
    def backward(ctx, g: Tensor):
        return all_reduce(g, ctx.groups), None


def replicated(params, mesh: DeviceMesh):
    """A parameter tree of plain tensors, each marked as held by every rank
    of ``mesh`` (see :class:`Replicated`)."""
    from .tree import tree_map

    groups = mesh_groups(mesh)
    return tree_map(lambda p: Replicated.apply(p, groups), params)


def global_mean(term: Tensor, like: DTensor) -> Tensor:
    """The mean of a loss term over the global batch, held by every rank.

    ``term`` is this rank's block of a per-element or per-example term,
    computed from the local blocks of ``like`` (a batch-sharded DTensor): it
    is sharded as ``like`` along ``like``'s sharded axes, of the global
    sizes ``like`` has there, and its other axes are whole.  Each rank sums
    its block; a block that several ranks hold (a mesh axis the layout
    replicates) is weighted by one over their number, so that the sum over
    the mesh counts every element once, and so does the sum of the ranks'
    gradients of a replicated parameter (:func:`replicated`).  One
    :class:`Sum` over every mesh axis gives the total."""
    mesh = like.device_mesh
    count, copies = term.numel(), 1
    for i, p in enumerate(like.placements):
        if p.is_replicate():
            copies *= mesh.shape[i]
    for d in {p.dim % like.ndim for p in like.placements if p.is_shard()}:
        count = count // term.shape[d] * like.shape[d]
    return Sum.apply(torch.sum(term) / (count * copies), mesh_groups(mesh))


def squared_error(y: Tensor, target: Tensor) -> Tensor:
    """(y − target)², elementwise: the term of a mean squared error."""
    d = y - target.to(y.dtype)
    return d * d


def mean_squared_error(y: DTensor, target) -> Tensor:
    """mean((y − target)²) over the global array, held by every rank
    (:func:`global_mean`); ``target`` a DTensor or the global tensor."""
    t = local_placed(target, y.device_mesh, y.placements)
    return global_mean(squared_error(y.to_local(), t), y)


def data_parallel_loss(term: Callable, apply: Callable, params, x: DTensor, target) -> Tensor:
    """``mean(term(apply(params, x), target))`` for a batch-sharded DTensor
    ``x`` and a tree of plain-tensor ``params``, data-parallel as ``jit``
    partitions it: ``apply`` (an op that takes the DTensor, see
    :func:`batch_sharded`) runs on the local blocks, ``term`` on the local
    blocks of its output and of ``target`` (a DTensor or the global tensor,
    laid out as the output along its batch axes: the same shape, or
    per-example labels), the loss is the :func:`global_mean` held by every
    rank, and each parameter's gradient is summed over the ranks, so a step
    leaves plain parameters equal on every rank."""
    y = apply(replicated(params, x.device_mesh), x)
    t = local_placed(target, y.device_mesh, y.placements)
    return global_mean(term(y.to_local(), t), y)


def data_parallel_mse(apply: Callable, params, x: DTensor, target) -> Tensor:
    """:func:`data_parallel_loss` of the squared error: the global
    ``mean((apply(params, x) − target)²)``."""
    return data_parallel_loss(squared_error, apply, params, x, target)


# ---------------------------------------------------------------------------
# A public op on a batch-sharded DTensor.
# ---------------------------------------------------------------------------


def last_axis(x, *args, **kwargs) -> Sequence[int]:
    """The ``axes`` of an op that transforms the last axis of ``x`` (of a
    method too: the argument after ``self`` is never read)."""
    return (-1,)


def last_two(x, *args, **kwargs) -> Sequence[int]:
    """The ``axes`` of an op that transforms the last two axes of ``x`` (a
    spectrogram's frames and bins, an image)."""
    return (-2, -1)


def non_batch(params, x, *args, **kwargs) -> Sequence[int]:
    """The ``axes`` of a model's ``apply(params, x, ...)`` (``arg=1``):
    every axis of ``x`` but the first, the batch."""
    return range(1, x.ndim)


def _named(fn: Callable, names: Sequence[str]) -> Callable:
    """``axes`` read from ``fn``'s parameters ``names`` as a call binds them
    (given by position or keyword, else their defaults): where each name
    sits is found once, so a call under a tracer reads plain Python."""
    params = inspect.signature(fn).parameters
    positional = [n for n, p in params.items()
                  if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
    spots = [(n, positional.index(n) if n in positional else None, params[n].default)
             for n in names]

    def axes(*args, **kwargs):
        return tuple(args[i] if i is not None and i < len(args) else kwargs.get(n, default)
                     for n, i, default in spots)

    return axes


def batch_sharded(axes, *, arg: int = 0, carries: Optional[Sequence[bool]] = None,
                  lead=0) -> Callable:
    """Decorator: the op takes a DTensor as its positional argument ``arg``
    (``arg=1`` for a model's ``apply(params, x)`` or a method's ``x`` after
    ``self``).

    ``axes`` names the axes of that argument which the op transforms or
    mixes (negative counts from the end): a callable ``axes(*args,
    **kwargs)``, or the name of the op's parameter that holds the axis (a
    tuple of names for several), read as the call binds it.  Every other
    axis is a batch axis.  A plain-tensor call goes straight through.
    Given a DTensor, an axis the op transforms that is sharded (or a
    pending sum) is replicated first, the op runs on the local blocks, and
    each tensor output becomes a DTensor on the same mesh: sharded as the
    input along the batch axes it keeps, or replicated where ``carries``
    (one flag an output of a tuple) says the output holds no batch axis.
    Another DTensor argument is laid out alike along each axis where its
    size is the input's (a second signal, per-example labels or delays of
    the leading batch axes) and replicated along the others; the same
    DTensor given twice is one local block.  No collective runs where the
    transformed axes are whole already.

    An output's batch axis sits at the input's index, plus ``lead`` (an
    int, or a callable of the call's arguments): the number of axes the op
    puts in front of the input's (``koopman_rollout``'s steps, the
    (envelope, residual) pair of ``envelope``).  An op that moves an axis
    to the end names every axis from it on, so that the batch axes it keeps
    lie before it, in place."""

    def wrap(fn: Callable) -> Callable:
        names = (axes,) if isinstance(axes, str) else axes
        moved = _named(fn, names) if isinstance(names, tuple) else axes

        @functools.wraps(fn)
        def op(*args, **kwargs):
            if len(args) <= arg or not isinstance(args[arg], DTensor):
                return fn(*args, **kwargs)
            shift = lead(*args, **kwargs) if callable(lead) else lead
            return _on_local_blocks(fn, moved, arg, carries, shift, args, kwargs)

        return op

    return wrap


def _on_local_blocks(fn, axes, arg, carries, lead, args, kwargs):
    x = args[arg]
    mesh, ndim = x.device_mesh, x.ndim
    moved = {a % ndim for a in axes(*args, **kwargs)}
    placements = tuple(
        Replicate() if p.is_partial() or (p.is_shard() and p.dim % ndim in moved) else p
        for p in x.placements)
    blocks = []   # (DTensor, its local block): the same DTensor given twice is one block

    def local(v):
        if not isinstance(v, DTensor):
            return v
        for u, block in blocks:
            if u is v:
                return block
        alike = tuple(p if p.is_shard() and p.dim % ndim < v.ndim
                      and v.shape[p.dim % ndim] == x.shape[p.dim % ndim] else Replicate()
                      for p in placements)
        blocks.append((v, redistribute(v, alike).to_local()))
        return blocks[-1][1]

    out = fn(*(local(v) for v in args), **{k: local(v) for k, v in kwargs.items()})

    def sharded(o, carry: bool):
        if not isinstance(o, Tensor):
            return o
        pl, shape = [], list(o.shape)
        for p in placements:
            d = p.dim % ndim + lead if p.is_shard() else o.ndim
            if carry and d < o.ndim:
                pl.append(Shard(d))
                shape[d] = x.shape[d - lead]
            else:
                pl.append(Replicate())
        return dtensor(o, mesh, tuple(pl), shape)

    if isinstance(out, tuple):
        flags = carries if carries is not None else (True,) * len(out)
        return tuple(sharded(o, c) for o, c in zip(out, flags))
    return sharded(out, True)
