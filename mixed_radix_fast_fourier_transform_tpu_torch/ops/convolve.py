"""FFT-based and direct convolution.

Counterpart of ``mixed_radix_fast_fourier_transform_tpu/ops/convolve.py``.
:func:`fft_convolve` is rfft → pointwise product → irfft (complex inputs
through fft/ifft), with the output modes

    full : start 0,            length n1+n2-1
    same : start (L-max)/2,    length max(n1,n2)
    valid: start min-1,        length max-min+1

and true circular convolution at period max(n1, n2).  Leading dimensions
broadcast.  Around it: overlap-add for a long signal against a short kernel,
2-D and N-D FFT convolution, correlation, and the scipy.signal-named surface
(``convolve``, ``correlate``, ``fftconvolve``, ``oaconvolve``, ``convolve2d``,
``correlate2d``, ``choose_conv_method``), whose direct method is the
framework's convolution op in full fp32.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.config import DEFAULT_CONFIG, DTYPE, SpectralConfig
from ..utils.factorize import next_fast_len, next_pow2
from ..utils.numerics import as_tensors, convolution
from ..utils.sharding import batch_sharded
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


def _window(mode: str, n1: int, n2: int, scipy_same: bool = False):
    """(start, length) of ``mode`` inside the full convolution of lengths
    n1 and n2.  ``same`` is centred on the larger input, or on the first
    input with ``scipy_same`` (scipy.signal's rule)."""
    full = n1 + n2 - 1
    if mode == "full":
        return 0, full
    if mode == "same":
        keep = n1 if scipy_same else max(n1, n2)
        return (full - keep) // 2, keep
    if mode == "valid":
        return min(n1, n2) - 1, abs(n1 - n2) + 1
    raise ValueError(f"mode must be one of {_MODES}, got {mode!r}")


def _check_valid(mode: str, shape1, shape2, axes) -> None:
    if mode != "valid":
        return
    if not (all(shape1[a] >= shape2[a] for a in axes)
            or all(shape2[a] >= shape1[a] for a in axes)):
        raise ValueError(
            "valid mode needs one input at least as large as the other "
            "on every transform axis"
        )


@batch_sharded("axis")
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
    in1, in2 = as_tensors(in1, in2)
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

    return out.narrow(axis, *_window(mode, n1, n2))


def fft_oaconvolve(
    in1,
    in2,
    mode: str = "full",
    *,
    axis: int = -1,
    block: Optional[int] = None,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """Overlap-add FFT convolution of a long signal with a short kernel.

    Splits ``in1`` into frames, convolves all of them in one batched rfft
    pipeline (frames become the batch axis) and overlap-adds.  Use when
    len(in1) >> len(in2): work drops from O(N log N) at the padded full
    length to O(N log n2)."""
    in1, in2 = as_tensors(in1, in2)
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {_MODES}, got {mode!r}")
    axis = axis % max(in1.ndim, 1)
    in1 = torch.movedim(in1, axis, -1)
    in2 = in2.reshape(-1)
    n1, n2 = in1.shape[-1], in2.shape[0]
    if n1 < 1 or n2 < 1:
        raise ValueError("inputs must be non-empty")
    if n2 > n1:
        # overlap-add needs the short side as the kernel
        out = fft_convolve(in1, in2.reshape((1,) * (in1.ndim - 1) + (-1,)),
                           mode=mode, config=config)
        return torch.movedim(out, -1, axis)
    if block is None:
        block = max(8 * next_pow2(n2), 256)  # the usual 8x-kernel block size
    m = _padded_len(block + n2 - 1, config)
    n_blocks = -(-n1 // block)
    x = F.pad(in1, (0, n_blocks * block - n1))
    frames = x.reshape(*x.shape[:-1], n_blocks, block)

    kf = rfft(in2, n=m, config=config)
    ff = rfft(frames, n=m, config=config)
    conv = irfft(ff * kf, n=m, axis=-1, config=config)  # (..., n_blocks, m)

    # overlap-add: block b contributes to [b*block, b*block + m)
    total = (n_blocks - 1) * block + m
    idx = (torch.arange(n_blocks, device=conv.device)[:, None] * block
           + torch.arange(m, device=conv.device)[None, :]).reshape(-1)
    out = conv.new_zeros(*conv.shape[:-2], total)
    out = out.index_add(-1, idx, conv.reshape(*conv.shape[:-2], n_blocks * m))

    start, length = _window(mode, n1, n2)
    return torch.movedim(out[..., start : start + length], -1, axis)


def fft_convolve2(
    in1,
    in2,
    mode: str = "full",
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """2-D FFT convolution over the last two axes, modes full/same/valid per
    axis, batched over leading axes: rfft over the last axis, complex fft
    over the second-to-last, pointwise product, inverse."""
    in1, in2 = as_tensors(in1, in2)
    if in1.ndim < 2 or in2.ndim < 2:
        raise ValueError("fft_convolve2 needs >= 2-D inputs")
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {_MODES}, got {mode!r}")
    s1 = in1.shape[-2:]
    s2 = in2.shape[-2:]
    if min(*s1, *s2) < 1:
        raise ValueError("inputs must be non-empty")
    m = tuple(_padded_len(a + b - 1, config) for a, b in zip(s1, s2))
    if in1.is_complex() or in2.is_complex():
        f1 = fft(fft(in1, n=m[1], axis=-1, config=config), n=m[0], axis=-2, config=config)
        f2 = fft(fft(in2, n=m[1], axis=-1, config=config), n=m[0], axis=-2, config=config)
        out = ifft(ifft(f1 * f2, axis=-1, config=config), axis=-2, config=config)
    else:
        f1 = fft(rfft(in1, n=m[1], axis=-1, config=config), n=m[0], axis=-2, config=config)
        f2 = fft(rfft(in2, n=m[1], axis=-1, config=config), n=m[0], axis=-2, config=config)
        out = irfft(ifft(f1 * f2, axis=-2, config=config), n=m[1], axis=-1, config=config)
    out = out.narrow(-2, *_window(mode, s1[0], s2[0]))
    return out.narrow(-1, *_window(mode, s1[1], s2[1]))


def fft_convolven(
    in1,
    in2,
    mode: str = "full",
    *,
    axes=None,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """N-D FFT convolution over ``axes`` (scipy.signal.fftconvolve semantics).

    Unlike :func:`fft_convolve`, this follows scipy exactly: ``same``
    returns the shape of ``in1`` per transform axis; ``valid`` requires one
    input to be at least as large as the other on every transform axis.
    Non-transform axes broadcast.  Real inputs use one rfft axis plus complex
    transforms on the rest."""
    in1, in2 = as_tensors(in1, in2)
    ndim = max(in1.ndim, in2.ndim)
    in1 = in1.reshape((1,) * (ndim - in1.ndim) + tuple(in1.shape))
    in2 = in2.reshape((1,) * (ndim - in2.ndim) + tuple(in2.shape))
    if axes is None:
        axes = tuple(range(ndim))
    else:
        axes = tuple(sorted({a % ndim for a in (
            axes if isinstance(axes, (tuple, list)) else (axes,))}))
    if not axes:
        raise ValueError("axes must be non-empty")
    for a in axes:
        if in1.shape[a] < 1 or in2.shape[a] < 1:
            raise ValueError("inputs must be non-empty along every transform axis")
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {_MODES}, got {mode!r}")
    _check_valid(mode, in1.shape, in2.shape, axes)

    complex_input = in1.is_complex() or in2.is_complex()
    ms = {a: _padded_len(in1.shape[a] + in2.shape[a] - 1, config) for a in axes}
    last = axes[-1]

    def fwd(x):
        if complex_input:
            for a in axes:
                x = fft(x, n=ms[a], axis=a, config=config)
        else:
            x = rfft(x, n=ms[last], axis=last, config=config)
            for a in axes[:-1]:
                x = fft(x, n=ms[a], axis=a, config=config)
        return x

    out = fwd(in1) * fwd(in2)
    for a in axes if complex_input else axes[:-1]:
        out = ifft(out, axis=a, config=config)
    if not complex_input:
        out = irfft(out, n=ms[last], axis=last, config=config)
    for a in axes:
        out = out.narrow(a, *_window(mode, in1.shape[a], in2.shape[a], scipy_same=True))
    return out


def fft_correlate(
    in1,
    in2,
    mode: str = "full",
    *,
    axis: int = -1,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """Cross-correlation via FFT: convolution with the reversed, conjugated
    second input."""
    in1, in2 = as_tensors(in1, in2)
    rev = torch.flip(in2, (axis,))
    if in2.is_complex():
        rev = torch.conj(rev)
    return fft_convolve(in1, rev, mode=mode, axis=axis, config=config)


def _conv_real(x: Tensor, k: Tensor, nd: int) -> Tensor:
    """Full-mode real convolution of x (B, *spatial) with k (1 or B,
    *taps) over the last ``nd`` axes: the framework's convolution op, which
    computes cross-correlation, so the kernel is flipped; per-row kernels
    run as one grouped convolution."""
    b, kb = x.shape[0], k.shape[0]
    spatial = tuple(range(1, 1 + nd))
    weight = torch.flip(k, spatial)[:, None]             # (kb, 1, *taps)
    x = x[:, None] if kb == 1 else x[None]               # (B, 1, …) or (1, B, …)
    out = convolution(x, weight, padding=[t - 1 for t in k.shape[1:]], groups=kb)
    return out.reshape(b, *out.shape[2:])


def _direct_convolve_nd(in1: Tensor, in2: Tensor, axes, dtype=DTYPE) -> Tensor:
    """Full-mode direct convolution over ``axes`` (1 to 3 of them) at the
    working ``dtype``; complex inputs expand into real-part convolutions.
    Batch dims of ``in2`` must match those of ``in1`` or be of size 1."""
    ax = tuple(a % in1.ndim for a in axes)
    nd = len(ax)
    if nd > 3:
        raise ValueError("direct method supports at most 3 transform axes")
    # move transform axes last, collapse the rest into a batch dim
    rest = [d for d in range(in1.ndim) if d not in ax]
    order = rest + list(ax)
    x = in1.permute(order)
    k = in2.permute(order)
    bshape = tuple(x.shape[:-nd])
    if any(s != 1 for s in k.shape[:-nd]) and tuple(k.shape[:-nd]) != bshape:
        raise ValueError("direct method needs matching or size-1 batch dims")
    x = x.reshape(-1, *x.shape[-nd:])
    k = k.reshape(-1, *k.shape[-nd:])
    if x.is_complex() or k.is_complex():
        xr, xi = (x.real, x.imag) if x.is_complex() else (x, torch.zeros_like(x))
        kr, ki = (k.real, k.imag) if k.is_complex() else (k, torch.zeros_like(k))
        xr, xi, kr, ki = (t.to(dtype) for t in (xr, xi, kr, ki))
        out = torch.complex(
            _conv_real(xr, kr, nd) - _conv_real(xi, ki, nd),
            _conv_real(xr, ki, nd) + _conv_real(xi, kr, nd))
    else:
        out = _conv_real(x.to(dtype), k.to(dtype), nd)
    out = out.reshape(bshape + tuple(out.shape[1:]))
    inverse = [0] * len(order)
    for i, d in enumerate(order):
        inverse[d] = i
    return out.permute(inverse)


def convolve(
    in1,
    in2,
    mode: str = "full",
    method: str = "auto",
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """N-D convolution with scipy.signal.convolve semantics (``same`` returns
    the shape of ``in1``; ``valid`` needs one input at least as large on every
    axis).  ``method``: "auto" | "fft" | "direct"; direct runs the
    framework's convolution op (≤ 3-D) in full precision, fft the engine's
    padded transforms.  Output is real or complex at ``config.dtype``."""
    in1, in2 = as_tensors(in1, in2)
    if method not in ("auto", "fft", "direct"):
        raise ValueError(f"method must be auto/fft/direct, got {method!r}")
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {_MODES}, got {mode!r}")
    if in1.ndim != in2.ndim:
        raise ValueError("in1 and in2 must have the same dimensionality")
    if method == "auto":
        method = "fft" if in1.ndim > 3 else choose_conv_method(in1, in2, mode)
    if method == "direct" and in1.ndim > 3:
        raise ValueError("method='direct' supports at most 3 dimensions; "
                         "use method='fft'")
    if method == "fft":
        return fft_convolven(in1, in2, mode=mode, config=config)
    axes = tuple(range(in1.ndim))
    _check_valid(mode, in1.shape, in2.shape, axes)
    out = _direct_convolve_nd(in1, in2, axes, config.dtype)
    for a in axes:
        out = out.narrow(a, *_window(mode, in1.shape[a], in2.shape[a], scipy_same=True))
    return out


def correlate(
    in1,
    in2,
    mode: str = "full",
    method: str = "auto",
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """N-D cross-correlation, scipy.signal.correlate semantics: convolution of
    ``in1`` with the fully reversed, conjugated ``in2``."""
    in1, in2 = as_tensors(in1, in2)
    rev = torch.flip(torch.conj(in2), tuple(range(in2.ndim)))
    return convolve(in1, rev, mode=mode, method=method, config=config)


def fftconvolve(in1, in2, mode: str = "full", axes=None, *,
                config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    """scipy.signal.fftconvolve: alias of :func:`fft_convolven`."""
    return fft_convolven(in1, in2, mode=mode, axes=axes, config=config)


def oaconvolve(in1, in2, mode: str = "full", axes=None, *,
               config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    """scipy.signal.oaconvolve.  The 1-D case runs the batched overlap-add
    pipeline (:func:`fft_oaconvolve`); multi-axis cases return the identical
    result via the padded full-length transforms (the block decomposition
    only pays along one long axis)."""
    in1, in2 = as_tensors(in1, in2)
    one_axis = (axes is not None and np.ndim(axes) == 0) or (
        axes is None and in1.ndim == 1 and in2.ndim == 1)
    if one_axis:
        axis = -1 if axes is None else int(axes)
        if in2.ndim == 1 or all(s == 1 for i, s in enumerate(in2.shape)
                                if i != axis % in2.ndim):
            return fft_oaconvolve(in1, in2, mode=mode, axis=axis, config=config)
    return fft_convolven(in1, in2, mode=mode, axes=axes, config=config)


def _pad_2d(x: Tensor, p0: int, p1: int, boundary: str, fillvalue) -> Tensor:
    """``x`` with p0/p1 more rows/columns on each side of its last two axes,
    filled per scipy.signal.convolve2d's ``boundary``."""
    n0, n1 = x.shape[-2:]
    if boundary == "fill":
        out = x.new_full((*x.shape[:-2], n0 + 2 * p0, n1 + 2 * p1), fillvalue)
        out[..., p0 : p0 + n0, p1 : p1 + n1] = x
        return out
    if boundary not in ("wrap", "symm"):
        raise ValueError(f"boundary must be fill/wrap/symm, got {boundary!r}")
    np_mode = "wrap" if boundary == "wrap" else "symmetric"
    for axis, n, p in ((-2, n0, p0), (-1, n1, p1)):
        idx = np.pad(np.arange(n), (p, p), mode=np_mode)
        x = x.index_select(axis, torch.from_numpy(idx).to(x.device))
    return x


def convolve2d(
    in1,
    in2,
    mode: str = "full",
    boundary: str = "fill",
    fillvalue=0,
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """2-D convolution with scipy.signal.convolve2d's boundary semantics
    (fill/wrap/symm), batched over leading axes.  The boundary becomes an
    explicit pad of ``in2.shape − 1`` per side, then the padded full-mode FFT
    convolution is sliced."""
    in1, in2 = as_tensors(in1, in2)
    if in1.ndim < 2 or in2.ndim != 2:
        raise ValueError("convolve2d needs a >=2-D in1 and a 2-D kernel")
    k0, k1 = in2.shape
    n0, n1 = in1.shape[-2:]
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {_MODES}, got {mode!r}")
    _check_valid(mode, (n0, n1), (k0, k1), (0, 1))
    trivial_fill = False
    if boundary == "fill":
        try:
            trivial_fill = complex(fillvalue) == 0
        except (TypeError, ValueError):
            raise ValueError(f"fillvalue must be a scalar, got {fillvalue!r}")
    kern = in2[(None,) * (in1.ndim - 2)]
    if trivial_fill:
        full = fft_convolve2(in1, kern, mode="full", config=config)
    else:
        p0, p1 = k0 - 1, k1 - 1
        xp = _pad_2d(in1, p0, p1, boundary, fillvalue)
        fullp = fft_convolve2(xp, kern, mode="full", config=config)
        # interior full-mode window of the padded result
        full = fullp[..., p0 : p0 + n0 + k0 - 1, p1 : p1 + n1 + k1 - 1]
    full = full.narrow(-2, *_window(mode, n0, k0, scipy_same=True))
    return full.narrow(-1, *_window(mode, n1, k1, scipy_same=True))


def correlate2d(
    in1,
    in2,
    mode: str = "full",
    boundary: str = "fill",
    fillvalue=0,
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """2-D cross-correlation with boundary handling
    (scipy.signal.correlate2d)."""
    in1, in2 = as_tensors(in1, in2)
    rev = torch.flip(torch.conj(in2), (0, 1))
    return convolve2d(in1, rev, mode=mode, boundary=boundary,
                      fillvalue=fillvalue, config=config)


def _last_len(a) -> int:
    """The length of the last axis of an array or tensor (1 for a scalar),
    read without numpy so that a traced tensor gives its static shape."""
    shape = a.shape if isinstance(a, torch.Tensor) else np.shape(a)
    return shape[-1] if len(shape) else 1


def choose_conv_method(in1, in2, mode: str = "full") -> str:
    """'fft' or 'direct' (scipy.signal.choose_conv_method semantics, sans
    timing): direct convolution scales as n·k and the padded-FFT path as
    n·log n, so direct is chosen for small tap counts only.  The crossover
    is the JAX package's; it has not been measured on a GPU."""
    s1, s2 = _last_len(in1), _last_len(in2)
    if mode not in _MODES:
        raise ValueError(f"mode must be full/same/valid, got {mode!r}")
    return "direct" if min(s1, s2) <= 16 else "fft"
