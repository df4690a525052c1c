"""Device meshes and joining a multi-process run, on ``torch.distributed``.

Counterpart of ``mixed_radix_fast_fourier_transform_tpu/parallel/mesh.py``.
A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` whose named
dimensions are the two forms of spectral parallelism:

* ``data`` — batch sharding: independent transforms on different ranks;
* ``seq``  — transform sharding: one long transform split across ranks by
  the four-step transpose decomposition (see :mod:`.distributed`).

Collectives run on NCCL between cards and on gloo between CPU processes.
Where the JAX package hands out ``NamedSharding``s, this module hands out
DTensor placement lists (one placement per mesh dimension).
"""

from __future__ import annotations

import math
import os
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor.placement_types import Placement

from ..utils.numerics import resolve_device

DATA_AXIS = "data"
SEQ_AXIS = "seq"


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def make_mesh(
    shape: Optional[Sequence[int]] = None,
    axis_names: Sequence[str] = (DATA_AXIS, SEQ_AXIS),
    device=None,
) -> DeviceMesh:
    """Build a mesh over every rank of the process group.

    ``shape=None`` puts every rank on the first axis (pure batch
    parallelism) and size 1 on the rest.  Pass e.g. ``shape=(2, 4)`` for a
    2-way-data x 4-way-sequence layout on 8 ranks.  ``device``: the card
    ("cuda", NCCL) unless the caller asks for the CPU ("cpu", gloo).  With
    no process group yet, :func:`initialize_multihost` starts one first (a
    world of one outside ``torchrun``)."""
    device = resolve_device(device)
    if not dist.is_initialized():
        initialize_multihost(device=device)
    n = dist.get_world_size()
    axis_names = tuple(axis_names)
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    if math.prod(shape) != n:
        raise ValueError(f"mesh shape {shape} != device count {n}")
    return init_device_mesh(device.type, shape, mesh_dim_names=axis_names)


def batch_sharding(mesh: DeviceMesh, axis_name: str = DATA_AXIS,
                   ndim: int = 2) -> List[Placement]:
    """Placements that shard the leading (batch) axis over ``axis_name`` and
    replicate over every other mesh axis.  ``ndim`` (the array's rank, which
    a JAX PartitionSpec spells out) does not enter a placement list; it is
    kept so that calls read the same in both packages."""
    del ndim
    return [Shard(0) if name == axis_name else Replicate() for name in mesh.mesh_dim_names]


def replicated(mesh: DeviceMesh) -> List[Placement]:
    """Fully replicated placements on ``mesh`` (for parameters and constants)."""
    return [Replicate()] * mesh.ndim


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device=None,
) -> Tuple[int, int]:
    """Join a multi-process run; returns (rank, world size).

    ``coordinator_address`` is "host:port" of rank 0 (or any
    ``init_process_group`` URL, e.g. ``file:///shared/store``), with
    ``num_processes`` and ``process_id``.  Without an address the
    environment of ``torchrun`` is used where it is set (``MASTER_ADDR``,
    ``WORLD_SIZE``, ``RANK``); otherwise a world of one is started through
    an in-memory store (no port).  A process that is already in a group
    keeps it.  ``device`` picks the backend: NCCL for the card (the
    default), gloo for "cpu"."""
    if not dist.is_initialized():
        backend = _backend(resolve_device(device))
        if coordinator_address is not None:
            url = (coordinator_address if "://" in coordinator_address
                   else f"tcp://{coordinator_address}")
            dist.init_process_group(backend, init_method=url, world_size=num_processes,
                                    rank=process_id)
        elif "MASTER_ADDR" in os.environ and "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend, init_method="env://")
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    return dist.get_rank(), dist.get_world_size()
