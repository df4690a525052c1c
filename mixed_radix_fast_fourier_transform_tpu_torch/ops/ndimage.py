"""Fourier-domain image filters (scipy.ndimage parity) and the adaptive
Wiener filter.

Counterpart of ``mixed_radix_fast_fourier_transform_tpu/ops/ndimage.py``.
``fourier_gaussian`` / ``fourier_uniform`` / ``fourier_ellipsoid`` multiply
an ALREADY-TRANSFORMED array by the closed-form transfer function of the
corresponding real-space kernel — the scipy.ndimage convention: every axis
of the input is a frequency axis, ``n < 0`` means a full complex FFT
layout, ``n >= 0`` means axis ``axis`` holds a real-transform (rfft) of
original length ``n``.

The separable filters (gaussian, uniform) apply as ndim broadcast
multiplies by host float64 1-D tables; the ellipsoid's radial transfer
function is a host float64 grid (J1 by the Abramowitz-Stegun rational fits)
evaluated once per (shape, size) and kept on the card.  ``wiener``'s box
statistics are one cumulative-sum difference per axis.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.config import DEFAULT_CONFIG, SpectralConfig
from ..utils.numerics import as_tensor, constant

Tensor = torch.Tensor


def _axis_freqs(shape, n: int, axis: int):
    """Per-axis frequency vectors matching scipy.ndimage's layout."""
    nd = len(shape)
    axis = axis % nd
    freqs = []
    for i, s in enumerate(shape):
        if i == axis and n >= 0:
            expect = n // 2 + 1
            if s != expect:
                raise ValueError(
                    f"axis {i} has {s} bins; a real transform of length "
                    f"n={n} has {expect}"
                )
            freqs.append(np.fft.rfftfreq(n))
        else:
            freqs.append(np.fft.fftfreq(s))
    return freqs


def _per_axis(param, ndim: int, name: str) -> np.ndarray:
    p = np.atleast_1d(np.asarray(param, np.float64))
    if p.ndim != 1 or (p.size not in (1, ndim)):
        raise ValueError(f"{name} must be a scalar or one value per axis")
    return np.broadcast_to(p, (ndim,))


def _real_dtype(x: Tensor):
    if x.is_complex():
        return x.real.dtype
    return x.dtype if x.is_floating_point() else torch.float32


def _apply_separable(x: Tensor, factors, key) -> Tensor:
    out = x
    nd = out.ndim
    rdtype = _real_dtype(out)
    for i, f in enumerate(factors):
        shape = [1] * nd
        shape[i] = len(f)
        out = out * constant(f.astype(np.float64), out, rdtype, key=key + (i,)).reshape(shape)
    return out


def fourier_gaussian(x, sigma, n: int = -1, axis: int = -1,
                     *, config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    """Multiply a Fourier-domain array by a Gaussian transfer function
    exp(−2π²σ²f²) per axis (scipy.ndimage.fourier_gaussian parity).

    ``sigma`` is the real-space standard deviation in samples, scalar or
    per-axis.  ``n``/``axis`` flag one axis as an rfft of original length
    ``n`` (``n < 0``: all axes are full complex-FFT axes)."""
    x = as_tensor(x)
    sig = _per_axis(sigma, x.ndim, "sigma")
    freqs = _axis_freqs(x.shape, n, axis)
    facs = [np.exp(-2.0 * (np.pi * s * f) ** 2) for s, f in zip(sig, freqs)]
    return _apply_separable(x, facs, ("fourier_gaussian", tuple(x.shape), n, axis,
                                      tuple(sig.tolist())))


def fourier_uniform(x, size, n: int = -1, axis: int = -1,
                    *, config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    """Multiply a Fourier-domain array by a box-filter transfer function
    sinc(size·f) per axis (scipy.ndimage.fourier_uniform parity);
    ``size`` is the real-space box width in samples."""
    x = as_tensor(x)
    sz = _per_axis(size, x.ndim, "size")
    freqs = _axis_freqs(x.shape, n, axis)
    facs = [np.sinc(s * f) for s, f in zip(sz, freqs)]
    return _apply_separable(x, facs, ("fourier_uniform", tuple(x.shape), n, axis,
                                      tuple(sz.tolist())))


def _j1(u: np.ndarray) -> np.ndarray:
    """Bessel J1, Abramowitz-Stegun 9.4.4/9.4.6 rational fits (fp64 host,
    abs err < 4e-8 over the real line)."""
    u = np.asarray(u, np.float64)
    au = np.abs(u)
    small = au < 3.0
    # |u| < 3: J1(u)/u polynomial in (u/3)^2
    y = (u / 3.0) ** 2
    p_small = u * (
        0.5
        + y * (-0.56249985
        + y * (0.21093573
        + y * (-0.03954289
        + y * (0.00443319
        + y * (-0.00031761
        + y * 0.00001109))))))
    # |u| >= 3: modulus/phase form
    ys = np.where(small, 3.0, au)
    z = 3.0 / ys
    f1 = (0.79788456
          + z * (0.00000156
          + z * (0.01659667
          + z * (0.00017105
          + z * (-0.00249511
          + z * (0.00113653
          + z * (-0.00020033)))))))
    t1 = (ys - 2.35619449
          + z * (0.12499612
          + z * (0.00005650
          + z * (-0.00637879
          + z * (0.00074348
          + z * (0.00079824
          + z * (-0.00029166)))))))
    p_big = np.sign(u) * f1 * np.cos(t1) / np.sqrt(ys)
    return np.where(small, p_small, p_big)


def fourier_ellipsoid(x, size, n: int = -1, axis: int = -1,
                      *, config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    """Multiply a Fourier-domain array by the transfer function of a
    uniform ellipsoid of diameters ``size`` (scipy.ndimage parity,
    1 <= ndim <= 3): sinc in 1-D, the disk jinc 2·J1(u)/u in 2-D,
    3·(sin u − u·cos u)/u³ in 3-D, with u = π·|size∘f|."""
    x = as_tensor(x)
    nd = x.ndim
    if not 1 <= nd <= 3:
        raise ValueError("fourier_ellipsoid supports 1-D, 2-D and 3-D only")
    sz = _per_axis(size, nd, "size")
    freqs = _axis_freqs(x.shape, n, axis)

    def kernel():
        grids = np.meshgrid(*[s * f for s, f in zip(sz, freqs)], indexing="ij")
        u = np.pi * np.sqrt(sum(g * g for g in grids))
        with np.errstate(invalid="ignore", divide="ignore"):
            if nd == 1:
                return np.where(u == 0.0, 1.0, np.sin(u) / u)
            if nd == 2:
                return np.where(u == 0.0, 1.0, 2.0 * _j1(u) / u)
            return np.where(u == 0.0, 1.0, 3.0 * (np.sin(u) - u * np.cos(u)) / u**3)

    ker = constant(kernel, x, _real_dtype(x),
                   key=("fourier_ellipsoid", tuple(x.shape), n, axis, tuple(sz.tolist())))
    return x * ker


def _box_sum_valid(x: Tensor, size: int, axis: int) -> Tensor:
    """Valid-mode sliding-window sum via one cumsum (length n−size+1)."""
    xm = torch.movedim(x, axis, -1)
    cs = torch.cumsum(F.pad(xm, (1, 0)), dim=-1)
    return torch.movedim(cs[..., size:] - cs[..., :-size], -1, axis)


def wiener(x, mysize=3, noise=None,
           *, config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    """Adaptive local Wiener filter (scipy.signal.wiener semantics, n-D):
    out = μ + max(σ²−ν, 0)/max(σ², ν)·(x−μ) with μ/σ² the local window
    statistics and ν the noise power (mean local variance when None).
    The box statistics are one cumsum-difference per axis — no gather
    windows, no sorting."""
    x = as_tensor(x)
    if x.ndim < 1:
        raise ValueError("x must have at least one dimension")
    if np.ndim(mysize) == 0:
        sizes = (int(mysize),) * x.ndim
    else:
        sizes = tuple(int(s) for s in mysize)
    if len(sizes) != x.ndim or any(s < 1 or s % 2 == 0 for s in sizes):
        raise ValueError("mysize must be odd and match the input rank")
    xw = x.to(_real_dtype(x))
    cnt = float(np.prod(sizes))
    # center on the global mean before the box sums: E[x²]−μ² cancels
    # catastrophically in fp32 for offset data, and zero-mean values keep
    # the long cumsums' partial sums (hence their rounding) O(√n).
    # scipy's zero edge padding is applied to the RAW signal first, so
    # the pads become exactly −mean in centered space.
    gmean = torch.mean(xw)
    pads = []
    for s in sizes[::-1]:  # F.pad lists the last axis first
        pads += [s // 2, s // 2]
    xc = F.pad(xw, pads) - gmean
    s1 = xc
    s2 = xc * xc
    for ax, sz in enumerate(sizes):
        s1 = _box_sum_valid(s1, sz, ax)
        s2 = _box_sum_valid(s2, sz, ax)
    mu_c = s1 / cnt
    var = s2 / cnt - mu_c * mu_c
    mu = mu_c + gmean
    nu = torch.mean(var) if noise is None else torch.full((), float(noise), dtype=xw.dtype,
                                                           device=xw.device)
    out = mu + torch.clamp(var - nu, min=0.0) / torch.maximum(var, nu) * (xw - mu)
    return out.to(x.dtype) if x.is_floating_point() else out
