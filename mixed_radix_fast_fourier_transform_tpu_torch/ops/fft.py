"""Public complex FFT API: fft / ifft / fft2 / ifft2 / fftn / ifftn.

Counterpart of ``mixed_radix_fast_fourier_transform_tpu/ops/fft.py``: a
numpy.fft-style surface over the plan-based engine, for every length
n >= 1 and any batch shape.  Functions take a tensor (or array-like, which
becomes a CPU tensor) and compute on the tensor's own device; results are
complex64.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..utils.config import DEFAULT_CONFIG, SpectralConfig
from ..utils.numerics import from_planes, to_planes
from .stockham import exec_len

Tensor = torch.Tensor

_NORMS = ("backward", "ortho", "forward")


def _norm_scale(n: int, sign: int, norm: Optional[str]) -> float:
    """Scale factor applied after an unnormalized transform.

    forward transform (sign=-1): backward→1, ortho→1/√n, forward→1/n
    inverse transform (sign=+1): backward→1/n, ortho→1/√n, forward→1
    """
    norm = norm or "backward"
    if norm not in _NORMS:
        raise ValueError(f"norm must be one of {_NORMS}, got {norm!r}")
    if norm == "ortho":
        return 1.0 / math.sqrt(n)
    if (norm == "backward" and sign == 1) or (norm == "forward" and sign == -1):
        return 1.0 / n
    return 1.0


def _resize_last(x: Tensor, n: int) -> Tensor:
    """Crop or zero-pad the last axis to length n (numpy fft `n=` semantics)."""
    cur = x.shape[-1]
    if cur == n:
        return x
    if cur > n:
        return x[..., :n]
    return F.pad(x, (0, n - cur))


def _fft_1d(
    x,
    n: Optional[int],
    axis: int,
    sign: int,
    norm: Optional[str],
    config: SpectralConfig,
) -> Tensor:
    x = torch.as_tensor(x)
    if x.ndim == 0:
        raise ValueError("fft requires at least a 1-D input")
    axis = axis % x.ndim
    x = torch.movedim(x, axis, -1)
    n = int(n) if n is not None else x.shape[-1]
    if n < 1:
        raise ValueError(f"transform length must be >= 1, got {n}")
    x = _resize_last(x, n)
    xr, xi = to_planes(x)
    zr, zi = exec_len(config, n, sign, xr, xi)
    scale = _norm_scale(n, sign, norm)
    if scale != 1.0:
        zr, zi = zr * scale, zi * scale
    return torch.movedim(from_planes(zr, zi), -1, axis)


def fft(
    x,
    n: Optional[int] = None,
    axis: int = -1,
    norm: Optional[str] = "backward",
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """Forward 1-D complex FFT along ``axis`` (any length, any batch shape)."""
    return _fft_1d(x, n, axis, -1, norm, config)


def ifft(
    x,
    n: Optional[int] = None,
    axis: int = -1,
    norm: Optional[str] = "backward",
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """Inverse 1-D complex FFT along ``axis``."""
    return _fft_1d(x, n, axis, 1, norm, config)


def _axes_shape(
    x: Tensor, s: Optional[Sequence[int]], axes: Optional[Sequence[int]]
) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    if axes is None:
        axes = tuple(range(x.ndim)) if s is None else tuple(
            range(x.ndim - len(s), x.ndim)
        )
    axes = tuple(a % x.ndim for a in axes)
    if s is None:
        s = tuple(x.shape[a] for a in axes)
    if len(s) != len(axes):
        raise ValueError("s and axes must have the same length")
    return tuple(int(v) for v in s), axes


def fftn(
    x,
    s: Optional[Sequence[int]] = None,
    axes: Optional[Sequence[int]] = None,
    norm: Optional[str] = "backward",
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """N-D FFT as separable 1-D transforms."""
    x = torch.as_tensor(x)
    s, axes = _axes_shape(x, s, axes)
    for n_i, a in zip(s, axes):
        x = fft(x, n=n_i, axis=a, norm=norm, config=config)
    return x


def ifftn(
    x,
    s: Optional[Sequence[int]] = None,
    axes: Optional[Sequence[int]] = None,
    norm: Optional[str] = "backward",
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """Inverse N-D FFT (numpy.fft.ifftn semantics)."""
    x = torch.as_tensor(x)
    s, axes = _axes_shape(x, s, axes)
    for n_i, a in zip(s, axes):
        x = ifft(x, n=n_i, axis=a, norm=norm, config=config)
    return x


def fft2(x, s=None, axes=(-2, -1), norm="backward", *, config=DEFAULT_CONFIG):
    """2-D FFT over ``axes`` (numpy.fft.fft2 semantics)."""
    return fftn(x, s=s, axes=axes, norm=norm, config=config)


def ifft2(x, s=None, axes=(-2, -1), norm="backward", *, config=DEFAULT_CONFIG):
    """Inverse 2-D FFT over ``axes`` (numpy.fft.ifft2 semantics)."""
    return ifftn(x, s=s, axes=axes, norm=norm, config=config)
