"""FFT-based convolution: fft_convolve.

Counterpart of ``fft_convolve`` in
``mixed_radix_fast_fourier_transform_tpu/ops/convolve.py``: rfft →
pointwise product → irfft (complex inputs through fft/ifft), with the
output modes

    full : start 0,            length n1+n2-1
    same : start (L-max)/2,    length max(n1,n2)
    valid: start min-1,        length max-min+1

and true circular convolution at period max(n1, n2).  Leading dimensions
broadcast.
"""

from __future__ import annotations

import torch

from ..utils.config import DEFAULT_CONFIG, SpectralConfig
from ..utils.factorize import next_fast_len, next_pow2
from .fft import fft, ifft
from .rfft import irfft, rfft

Tensor = torch.Tensor

_MODES = ("full", "same", "valid")


def _padded_len(n: int, config: SpectralConfig) -> int:
    if config.pad_mode == "fast":
        return next_fast_len(n)
    if config.pad_mode == "pow23":
        return min(next_pow2(n), 3 * next_pow2(-(-n // 3)))
    return next_pow2(n)


def fft_convolve(
    in1,
    in2,
    mode: str = "full",
    *,
    circular: bool = False,
    axis: int = -1,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """Convolve two signals along ``axis`` via the FFT.

    mode: "full" | "same" | "valid" (linear); ignored for circular, which
    returns the period-max(n1,n2) circular convolution.
    """
    in1 = torch.as_tensor(in1)
    in2 = torch.as_tensor(in2)
    axis = axis % max(in1.ndim, 1)
    n1 = in1.shape[axis]
    n2 = in2.shape[axis]
    if n1 < 1 or n2 < 1:
        raise ValueError("inputs must be non-empty along the convolution axis")
    if not circular and mode not in _MODES:
        raise ValueError(f"mode must be one of {_MODES}, got {mode!r}")

    m = max(n1, n2) if circular else _padded_len(n1 + n2 - 1, config)
    if in1.is_complex() or in2.is_complex():
        f1 = fft(in1, n=m, axis=axis, config=config)
        f2 = fft(in2, n=m, axis=axis, config=config)
        out = ifft(f1 * f2, axis=axis, config=config)
    else:
        f1 = rfft(in1, n=m, axis=axis, config=config)
        f2 = rfft(in2, n=m, axis=axis, config=config)
        out = irfft(f1 * f2, n=m, axis=axis, config=config)

    if circular:
        return out

    conv_length = n1 + n2 - 1
    if mode == "full":
        start, length = 0, conv_length
    elif mode == "same":
        larger = max(n1, n2)
        start, length = (conv_length - larger) // 2, larger
    else:  # valid
        smaller = min(n1, n2)
        start, length = smaller - 1, max(n1, n2) - smaller + 1
    return out.narrow(axis, start, length)
