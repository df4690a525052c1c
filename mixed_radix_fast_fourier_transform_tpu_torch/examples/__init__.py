"""User programs on the port, one module per example of the JAX package's
``examples/``: each ``main(*, device=None, ...)`` runs on the card unless
given ``device="cpu"``, asserts its invariants and returns the quantities
the JAX script prints.  Run one as
``python -m mixed_radix_fast_fourier_transform_tpu_torch.examples.<name>``."""

from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=None)
def _compiled(step):
    # one wrapper for the process: each torch.compile wrapper would trace anew
    return torch.compile(step, fullgraph=True, dynamic=False)


def jitted(step, compile: bool):
    """``step`` as the JAX examples jit their steps: ``torch.compile(step,
    fullgraph=True, dynamic=False)`` (Inductor) when ``compile``, else
    ``step`` itself.  An example resolves its ``compile=None`` argument to
    ``device.type == "cuda"`` before it calls this."""
    return _compiled(step) if compile else step
