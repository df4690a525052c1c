"""Public complex FFT API: fft / ifft / fft2 / ifft2 / fftn / ifftn, the
frequency and shift helpers, and the Hartley transform.

Counterpart of ``mixed_radix_fast_fourier_transform_tpu/ops/fft.py``: a
numpy.fft-style surface over the plan-based engine, for every length
n >= 1 and any batch shape.  Functions take a tensor and compute on the
tensor's own device; an array-like (numpy array, list, scalar) goes to the
card, as do the arrays that ``fftfreq``/``rfftfreq`` create unless given a
``device``.  Results are complex at the config's working dtype, complex64
by default (real for the Hartley transform of real input).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..utils.config import DEFAULT_CONFIG, SpectralConfig
from ..utils.numerics import as_tensor, from_planes, resolve_device, to_planes
from ..utils.sharding import batch_sharded
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
    x = as_tensor(x)
    if x.ndim == 0:
        raise ValueError("fft requires at least a 1-D input")
    axis = axis % x.ndim
    x = torch.movedim(x, axis, -1)
    n = int(n) if n is not None else x.shape[-1]
    if n < 1:
        raise ValueError(f"transform length must be >= 1, got {n}")
    x = _resize_last(x, n)
    xr, xi = to_planes(x, config.dtype)
    zr, zi = exec_len(config, n, sign, xr, xi)
    scale = _norm_scale(n, sign, norm)
    if scale != 1.0:
        zr, zi = zr * scale, zi * scale
    return torch.movedim(from_planes(zr, zi), -1, axis)


def _axes_of(x, s=None, axes=None, *args, **kwargs):
    """The axes an N-D transform's call transforms, as :func:`_axes_shape`
    reads them."""
    if axes is not None:
        return axes
    return range(x.ndim) if s is None else range(x.ndim - len(s), x.ndim)


def _axes2_of(x, s=None, axes=(-2, -1), *args, **kwargs):
    return _axes_of(x, s, axes)


@batch_sharded("axis")
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


@batch_sharded("axis")
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


@batch_sharded(_axes_of)
def fftn(
    x,
    s: Optional[Sequence[int]] = None,
    axes: Optional[Sequence[int]] = None,
    norm: Optional[str] = "backward",
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """N-D FFT as separable 1-D transforms."""
    x = as_tensor(x)
    s, axes = _axes_shape(x, s, axes)
    for n_i, a in zip(s, axes):
        x = fft(x, n=n_i, axis=a, norm=norm, config=config)
    return x


@batch_sharded(_axes_of)
def ifftn(
    x,
    s: Optional[Sequence[int]] = None,
    axes: Optional[Sequence[int]] = None,
    norm: Optional[str] = "backward",
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """Inverse N-D FFT (numpy.fft.ifftn semantics)."""
    x = as_tensor(x)
    s, axes = _axes_shape(x, s, axes)
    for n_i, a in zip(s, axes):
        x = ifft(x, n=n_i, axis=a, norm=norm, config=config)
    return x


@batch_sharded(_axes2_of)
def fft2(x, s=None, axes=(-2, -1), norm="backward", *, config=DEFAULT_CONFIG):
    """2-D FFT over ``axes`` (numpy.fft.fft2 semantics)."""
    return fftn(x, s=s, axes=axes, norm=norm, config=config)


@batch_sharded(_axes2_of)
def ifft2(x, s=None, axes=(-2, -1), norm="backward", *, config=DEFAULT_CONFIG):
    """Inverse 2-D FFT over ``axes`` (numpy.fft.ifft2 semantics)."""
    return ifftn(x, s=s, axes=axes, norm=norm, config=config)


# ---------------------------------------------------------------------------
# Frequency-axis helpers (numpy.fft parity)
# ---------------------------------------------------------------------------

def fftfreq(n: int, d: float = 1.0, *, dtype=torch.float32, device=None) -> Tensor:
    """DFT sample frequencies for length ``n``, spacing ``d``
    (numpy.fft.fftfreq), on ``device`` (default: the card)."""
    k = torch.arange(n, device=resolve_device(device))
    k = torch.where(k < (n + 1) // 2, k, k - n)
    return (k / (n * d)).to(dtype)


def rfftfreq(n: int, d: float = 1.0, *, dtype=torch.float32, device=None) -> Tensor:
    """Non-negative DFT frequencies for a length-``n`` real transform
    (numpy.fft.rfftfreq), on ``device`` (default: the card)."""
    k = torch.arange(n // 2 + 1, device=resolve_device(device))
    return (k / (n * d)).to(dtype)


def _shift_axes(x: Tensor, axes) -> Tuple[int, ...]:
    if axes is None:
        return tuple(range(x.ndim))
    return (axes,) if isinstance(axes, int) else tuple(axes)


def fftshift(x, axes=None) -> Tensor:
    """Roll the zero-frequency bin to the center (numpy.fft.fftshift)."""
    x = as_tensor(x)
    axes = _shift_axes(x, axes)
    return torch.roll(x, [x.shape[a] // 2 for a in axes], axes)


def ifftshift(x, axes=None) -> Tensor:
    """Undo :func:`fftshift` (numpy.fft.ifftshift)."""
    x = as_tensor(x)
    axes = _shift_axes(x, axes)
    return torch.roll(x, [-(x.shape[a] // 2) for a in axes], axes)


def dht(x, n: Optional[int] = None, axis: int = -1, *, config=DEFAULT_CONFIG) -> Tensor:
    """Discrete Hartley transform H[k] = Σ x[m]·cas(2πmk/N), cas = cos + sin:
    Re(F) − Im(F) of the forward FFT, so ``dht(dht(x)) == N·x``.  Complex
    input transforms each plane independently."""
    x = as_tensor(x)
    if x.is_complex():
        # with F the forward DFT and F~[k] = F[(−k) mod N]: Σ z·cos = (F + F~)/2
        # and Σ z·sin = i(F − F~)/2, so one FFT plus a bin reversal
        f = torch.movedim(fft(x, n=n, axis=axis, config=config), axis, -1)
        ft = torch.cat([f[..., :1], torch.flip(f[..., 1:], (-1,))], dim=-1)
        return torch.movedim((f + ft) / 2 + 1j * (f - ft) / 2, -1, axis)
    from .rfft import rfft  # rfft imports this module

    # real input: the half spectrum suffices (H[k] = Re − Im, H[N−k] = Re + Im)
    spec = torch.movedim(rfft(x, n=n, axis=axis, config=config), axis, -1)
    nn = n if n is not None else x.shape[axis]
    head = spec.real - spec.imag                     # bins 0..nn//2
    mid = spec[..., 1 : (nn - 1) // 2 + 1]
    tail = torch.flip(mid.real + mid.imag, (-1,))    # bins nn//2+1..nn-1
    return torch.movedim(torch.cat([head, tail], dim=-1), -1, axis)


def idht(x, n: Optional[int] = None, axis: int = -1, *, config=DEFAULT_CONFIG) -> Tensor:
    """Inverse DHT: the DHT is self-inverse up to 1/N."""
    x = as_tensor(x)
    nn = int(n) if n is not None else x.shape[axis]
    return dht(x, n=n, axis=axis, config=config) / nn
