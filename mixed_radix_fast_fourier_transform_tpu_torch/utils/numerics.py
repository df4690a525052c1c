"""Complex-as-planes helpers.

Counterpart of ``mixed_radix_fast_fourier_transform_tpu/utils/numerics.py``
(the plane helpers; the error-free transforms come with the ops that use
them).  The engine works on separate contiguous fp32 (re, im) planes.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .config import DTYPE

Tensor = torch.Tensor


def to_planes(x) -> Tuple[Tensor, Tensor]:
    """Split a complex (or real) tensor into contiguous fp32 (re, im) planes
    on its own device.  numpy input becomes a CPU tensor; float64 and
    complex128 are cast down to the working precision here."""
    x = torch.as_tensor(x)
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
