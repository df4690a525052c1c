"""Complex-as-planes helpers.

Counterpart of ``mixed_radix_fast_fourier_transform_tpu/utils/numerics.py``
(the plane helpers; the error-free transforms come with the ops that use
them).  The engine works on separate contiguous fp32 (re, im) planes.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .config import DTYPE

Tensor = torch.Tensor


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; None means the card ("cuda").  There is
    no fallback to the CPU: without a card, using the result raises."""
    return torch.device("cuda" if device is None else device)


def as_tensor(x, device=None) -> Tensor:
    """The one place where the package turns a caller's data into a tensor.
    A ``torch.Tensor`` stays as it is, on its own device; a numpy array, a
    list or a scalar becomes a tensor on ``device`` (default: the card, see
    :func:`resolve_device`).  To compute on the CPU, pass a CPU tensor."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(x, device=resolve_device(device))


def constant(values, like: Tensor, dtype=DTYPE) -> Tensor:
    """A table computed on the host (a numpy array, float64 as a rule) as a
    ``dtype`` tensor on the device of ``like``."""
    return torch.from_numpy(np.ascontiguousarray(values)).to(device=like.device, dtype=dtype)


def as_tensors(*xs) -> Tuple[Tensor, ...]:
    """:func:`as_tensor` for the operands of one call: data that is no
    tensor yet joins the device of the first operand that is one."""
    device = next((x.device for x in xs if isinstance(x, torch.Tensor)), None)
    return tuple(as_tensor(x, device) for x in xs)


def to_planes(x) -> Tuple[Tensor, Tensor]:
    """Split a complex (or real) tensor into contiguous fp32 (re, im) planes
    on its own device (array-likes go through :func:`as_tensor`); float64
    and complex128 are cast down to the working precision here."""
    x = as_tensor(x)
    if x.is_complex():
        return (
            x.real.to(DTYPE).contiguous(),
            x.imag.to(DTYPE).contiguous(),
        )
    x = x.to(DTYPE).contiguous()
    return x, torch.zeros_like(x)


def from_planes(re: Tensor, im: Tensor) -> Tensor:
    """Combine fp32 (re, im) planes into a complex64 tensor."""
    return torch.complex(re, im)


def cmul(ar: Tensor, ai: Tensor, br: Tensor, bi: Tensor) -> Tuple[Tensor, Tensor]:
    """Elementwise complex multiply on planes."""
    return ar * br - ai * bi, ar * bi + ai * br


def conj_planes(re: Tensor, im: Tensor) -> Tuple[Tensor, Tensor]:
    return re, -im
