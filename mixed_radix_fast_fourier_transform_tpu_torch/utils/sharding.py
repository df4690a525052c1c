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
* :func:`data_parallel_mse` is a loss on a batch-sharded batch with plain
  tensor parameters, as ``jit`` partitions it: the global mean (each element
  counted once), the parameters' gradients summed over the ranks.
* The sums are functional collectives (``torch.distributed.
  _functional_collectives``), one code path eagerly and under
  ``torch.compile``: gloo on the CPU, NCCL on the card.  No complex tensor
  goes through a collective (gloo's complex support is not to be relied
  on): a complex value moves through its real view.
"""

from __future__ import annotations

import functools
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


def mean_squared_error(y: DTensor, target) -> Tensor:
    """mean((y − target)²) over the global array, held by every rank.

    Each rank sums its block; a block that several ranks hold (a mesh axis
    the layout replicates) is weighted by one over their number, so that the
    sum over the mesh counts every element once, and so does the sum of the
    ranks' gradients of a replicated parameter."""
    mesh = y.device_mesh
    d = y.to_local() - local_placed(target, mesh, y.placements).to(y.dtype)
    copies = 1
    for i, p in enumerate(y.placements):
        if p.is_replicate():
            copies *= mesh.shape[i]
    return Sum.apply(torch.sum(d * d) / (y.numel() * copies), mesh_groups(mesh))


def data_parallel_mse(apply: Callable, params, x: DTensor, target) -> Tensor:
    """``mean((apply(params, x) − target)²)`` for a batch-sharded DTensor
    ``x`` and a tree of plain-tensor ``params``, data-parallel as ``jit``
    partitions it: ``apply`` (an op that takes the DTensor, see
    :func:`batch_sharded`) runs on the local blocks, the loss is the global
    mean held by every rank, and each parameter's gradient is summed over
    the ranks, so a step leaves plain parameters equal on every rank."""
    return mean_squared_error(apply(replicated(params, x.device_mesh), x), target)


# ---------------------------------------------------------------------------
# A public op on a batch-sharded DTensor.
# ---------------------------------------------------------------------------


def last_axis(x, *args, **kwargs) -> Sequence[int]:
    """The ``axes`` of an op that transforms the last axis of ``x``."""
    return (-1,)


def axis_arg(x, *args, axis: int = -1, **kwargs) -> Sequence[int]:
    """The ``axes`` of an op that transforms the axis named by its ``axis``
    keyword (default the last)."""
    return (axis,)


def batch_sharded(axes: Callable, *, arg: int = 0,
                  carries: Optional[Sequence[bool]] = None) -> Callable:
    """Decorator: the op takes a DTensor as its positional argument ``arg``.

    ``axes(*args, **kwargs)`` names the axes of that argument which the op
    transforms (negative counts from the end); every other axis is a batch
    axis.  A plain-tensor call goes straight through.  Given a DTensor, an
    axis the op transforms that is sharded (or a pending sum) is replicated
    first, the op runs on the local blocks (another DTensor argument of the
    same rank is laid out alike, one of another rank replicated), and each
    tensor output becomes a DTensor on the same mesh: sharded as the input
    along the batch axes it keeps, or replicated where ``carries`` (one flag
    an output of a tuple) says the output holds no batch axis.  No
    collective runs where the transformed axes are whole already."""

    def wrap(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def op(*args, **kwargs):
            if len(args) <= arg or not isinstance(args[arg], DTensor):
                return fn(*args, **kwargs)
            return _on_local_blocks(fn, axes, arg, carries, args, kwargs)

        return op

    return wrap


def _on_local_blocks(fn, axes, arg, carries, args, kwargs):
    x = args[arg]
    mesh, ndim = x.device_mesh, x.ndim
    moved = {a % ndim for a in axes(*args, **kwargs)}
    placements = tuple(
        Replicate() if p.is_partial() or (p.is_shard() and p.dim % ndim in moved) else p
        for p in x.placements)
    whole = tuple(Replicate() for _ in placements)

    def local(v):
        if not isinstance(v, DTensor):
            return v
        alike = v.ndim == ndim and v.shape == x.shape
        return redistribute(v, placements if alike else whole).to_local()

    out = fn(*(local(v) for v in args), **{k: local(v) for k, v in kwargs.items()})

    def sharded(o, carry: bool):
        if not isinstance(o, Tensor):
            return o
        pl = tuple(p if carry and p.is_shard() and p.dim % ndim < o.ndim else Replicate()
                   for p in placements)
        shape = list(o.shape)
        for p in pl:
            if p.is_shard():
                shape[p.dim % ndim] = x.shape[p.dim % ndim]
        return dtensor(o, mesh, pl, shape)

    if isinstance(out, tuple):
        flags = carries if carries is not None else (True,) * len(out)
        return tuple(sharded(o, c) for o, c in zip(out, flags))
    return sharded(out, True)
