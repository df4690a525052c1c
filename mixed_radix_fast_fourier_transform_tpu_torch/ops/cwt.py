"""Continuous wavelet transform via batched FFT convolution.

Counterpart of ``mixed_radix_fast_fourier_transform_tpu/ops/cwt.py``: the
scipy.signal ``cwt`` surface, convolution of a signal with scaled wavelets,
one row per width:

    out[i] = convolve(data, conj(wavelet(min(10*widths[i], N), widths[i]))[::-1],
                      mode='same')

scipy loops N_widths separate direct convolutions with per-scale kernel
lengths; here every kernel is centre-embedded into one common length
(padding both sides by amounts that keep 'same' alignment exact) and the
whole bank runs as ONE batched FFT convolution through the engine: (W, M)
kernels against (1, N) data, three transforms in all.  Wavelets are sampled
on the host in fp64, like twiddles.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..utils.config import DEFAULT_CONFIG, DTYPE, SpectralConfig
from ..utils.numerics import (
    as_tensor, as_tensors, constant, content_key, host_table, key_array, on_host, product,
)
from .convolve import fft_convolve
from .fft import fft, ifft

Tensor = torch.Tensor


def ricker(points: int, a: float) -> np.ndarray:
    """Ricker ("Mexican hat") wavelet, scipy.signal.ricker-compatible:
    A (1 - (t/a)^2) exp(-t^2 / (2 a^2)), A = 2 / (sqrt(3a) pi^(1/4))."""
    if points < 1:
        raise ValueError(f"points must be >= 1, got {points}")
    amp = 2.0 / (np.sqrt(3.0 * a) * np.pi**0.25)
    t = np.arange(points, dtype=np.float64) - (points - 1) / 2.0
    mod = 1.0 - (t / a) ** 2
    return amp * mod * np.exp(-(t**2) / (2.0 * a**2))


def morlet2(points: int, s: float, w: float = 5.0) -> np.ndarray:
    """Complex Morlet wavelet, scipy.signal.morlet2-compatible:
    pi^(-1/4) sqrt(1/s) exp(i w t/s) exp(-t^2/(2 s^2))."""
    if points < 1:
        raise ValueError(f"points must be >= 1, got {points}")
    t = (np.arange(points, dtype=np.float64) - (points - 1) / 2.0) / s
    return np.pi**-0.25 * np.sqrt(1.0 / s) * np.exp(1j * w * t - t**2 / 2.0)


def cwt(
    data,
    wavelet: Callable[..., np.ndarray],
    widths: Sequence[float],
    *,
    dtype=None,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """Continuous wavelet transform, scipy.signal.cwt-compatible.

    ``wavelet(points, width)`` is sampled on host for each width with
    ``points = min(10*width, len(data))`` and correlated with ``data``
    ('same' mode, conjugate-reversed kernel, matching scipy).  Returns
    (len(widths), …, N) with the width axis leading and any batch axes of
    ``data`` preserved.  Complex wavelets (morlet2) yield complex output.
    The bank comes from the caller's function, so it is uploaded on every
    call.
    """
    x = as_tensor(data)
    n = x.shape[-1]
    if n < 1:
        raise ValueError("data must be non-empty")
    widths = list(widths)
    if not widths:
        raise ValueError("widths must be non-empty")
    kernels = []
    for wd in widths:
        points = min(10 * wd, n)  # scipy convention (float ok: arange rounds up)
        kernels.append(np.conj(np.asarray(wavelet(points, wd))[::-1]))
    m = max(k.shape[0] for k in kernels)
    bank = np.zeros(
        (len(kernels), m),
        dtype=np.complex128 if any(np.iscomplexobj(k) for k in kernels)
        else np.float64,
    )
    for i, k in enumerate(kernels):
        # centre-embed so 'same' alignment matches the unpadded kernel:
        # full-conv shifts by lo, 'same' centre moves by (m-1)//2 - (L-1)//2
        lo = (m - 1) // 2 - (k.shape[0] - 1) // 2
        bank[i, lo : lo + k.shape[0]] = k
    if dtype is None:
        dtype = torch.complex64 if np.iscomplexobj(bank) or x.is_complex() else DTYPE
    if not dtype.is_complex:
        bank = bank.real
    bankd = constant(bank, x.real if x.is_complex() else x, dtype)
    # broadcast: kernels (W, 1…, M) against data (1, …, N)
    bankd = bankd.reshape((len(kernels),) + (1,) * max(x.ndim - 1, 0) + (m,))
    return fft_convolve(x[None].to(dtype), bankd, mode="same", config=config).to(dtype)


# ---------------------------------------------------------------------------
# Torrence & Compo frequency-domain Morlet CWT + cross-wavelet analysis
# (the pycwt-class xwt/wct surface)
# ---------------------------------------------------------------------------


def tc_scales(n: int, dt: float = 1.0, dj: float = 1.0 / 12.0,
              s0: Optional[float] = None, J: Optional[int] = None
              ) -> np.ndarray:
    """Torrence & Compo (1998) dyadic scale ladder: s_j = s0·2^{j·dj},
    j = 0..J with default s0 = 2·dt and J = log2(n·dt/s0)/dj."""
    if s0 is None:
        s0 = 2.0 * dt
    if J is None:
        J = int(np.floor(np.log2(n * dt / s0) / dj))
    if J < 0:
        raise ValueError("signal too short for the requested s0/dj")
    return s0 * 2.0 ** (dj * np.arange(J + 1))


def _tc_plan(scales) -> tuple:
    """Host prologue of :func:`cwt_tc` (``utils.numerics.on_host``): the
    caller's scale ladder checked, as its content key."""
    scales = np.asarray(scales, np.float64)
    if scales.ndim != 1 or scales.size < 1 or np.any(scales <= 0):
        raise ValueError("scales must be a non-empty positive 1-D array")
    return content_key("cwt_tc.scales", scales)


def _morlet_windows(n: int, dt: float, w0: float, skey: tuple) -> np.ndarray:
    """(S, T) analytic Morlet windows of the scales ``skey`` names (host
    fp64)."""
    scales = key_array(skey)
    w = 2.0 * np.pi * np.fft.fftfreq(n, dt)  # angular frequencies
    return (
        np.pi ** -0.25
        * np.sqrt(2.0 * np.pi * scales[:, None] / dt)
        * (w[None, :] > 0)
        * np.exp(-0.5 * (scales[:, None] * w[None, :] - w0) ** 2
                 * (w[None, :] > 0))
    )


def cwt_tc(
    x,
    scales,
    dt: float = 1.0,
    w0: float = 6.0,
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """Frequency-domain Morlet CWT (Torrence & Compo 1998 normalization):
    (…, T) -> (…, n_scales, T) complex,
    W(s, t) = Σ_ω x̂(ω)·√(2πs/dt)·π^{-1/4}·H(ω)·e^{-(sω−w0)²/2}·e^{iωt}.

    ONE forward FFT of the signal, a broadcast (n_scales, T) spectral
    window multiply (host fp64 constants, kept on the device per length
    and scale ladder, also while ``torch.compile`` traces), ONE inverse
    FFT over the stacked scale axis: no per-scale kernels or convolutions.
    The equivalent Fourier period is λ = 4πs/(w0 + √(2+w0²))."""
    x = as_tensor(x)
    skey = on_host(_tc_plan, scales)
    if x.ndim < 1 or x.shape[-1] < 2:
        raise ValueError("x must have a time axis of length >= 2")
    n = x.shape[-1]
    X = fft(x.to(torch.complex64), config=config)  # (…, T)
    psi = host_table("cwt_tc.psi", _morlet_windows, n, float(dt), float(w0), skey, like=X.real)
    return ifft(X[..., None, :] * psi, config=config)


def _tc_smooth(P: Tensor, scales: np.ndarray, dt: float, dj: float, config) -> Tensor:
    """Torrence & Compo smoothing operator for coherence: per-scale
    Gaussian in time (Fourier multiply, width s) then a 0.6/dj-bin boxcar
    across scales (one small banded matmul at ``config.op_precision``)."""
    n = P.shape[-1]
    ns = len(scales)
    key = content_key(f"{n}/{float(dt)}/{float(dj)}", scales)

    def gaussians() -> np.ndarray:
        k = 2.0 * np.pi * np.fft.fftfreq(n, dt)
        return np.exp(-0.5 * (scales[:, None] * k[None, :]) ** 2)  # (S, T)

    def boxcar() -> np.ndarray:
        # width 0.6 decades of the dyadic ladder
        m = max(1, int(round(0.6 / dj)))
        box = np.zeros((ns, ns))
        for i in range(ns):
            lo, hi = max(0, i - m // 2), min(ns, i - m // 2 + m)
            box[i, lo:hi] = 1.0 / (hi - lo)
        return box

    like = P.real if P.is_complex() else P
    sm = ifft(fft(P.to(torch.complex64), config=config)
              * constant(gaussians, like, key=("tc_smooth.filt",) + key), config=config)
    box = constant(boxcar, like, key=("tc_smooth.box",) + key)
    p = config.op_precision
    return torch.complex(product(box, sm.real, p), product(box, sm.imag, p))


def _tc_pair(x, y, dt, dj, s0, J, w0, config):
    x, y = as_tensors(x, y)
    if x.shape[-1] != y.shape[-1]:
        raise ValueError("x and y must share the time-axis length")
    scales = tc_scales(x.shape[-1], dt, dj, s0, J)
    wx = cwt_tc(x, scales, dt, w0, config=config)
    wy = cwt_tc(y, scales, dt, w0, config=config)
    freqs = (w0 + np.sqrt(2.0 + w0 * w0)) / (4.0 * np.pi * scales)
    return wx, wy, scales, freqs


def xwt(
    x,
    y,
    dt: float = 1.0,
    dj: float = 1.0 / 12.0,
    s0: Optional[float] = None,
    J: Optional[int] = None,
    w0: float = 6.0,
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
):
    """Cross-wavelet transform W_xy = W_x · conj(W_y) on the Torrence &
    Compo Morlet ladder: returns ``(W_xy, scales, freqs)`` with W_xy
    (…, n_scales, T) complex: |W_xy| is common power, arg(W_xy) the
    relative phase (pycwt.xwt surface)."""
    wx, wy, scales, freqs = _tc_pair(x, y, dt, dj, s0, J, w0, config)
    return wx * torch.conj(wy), scales, freqs


def wct(
    x,
    y,
    dt: float = 1.0,
    dj: float = 1.0 / 12.0,
    s0: Optional[float] = None,
    J: Optional[int] = None,
    w0: float = 6.0,
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
):
    """Wavelet coherence (Torrence & Webster; pycwt.wct surface):
    R²(s, t) = |S(W_xy/s)|² / (S(|W_x|²/s)·S(|W_y|²/s)) with the standard
    Morlet smoothing S (Gaussian in time, 0.6-decade boxcar in scale).
    Returns ``(R2, scales, freqs)`` with R² in [0, 1], the local,
    time-resolved analogue of :func:`coherence`."""
    wx, wy, scales, freqs = _tc_pair(x, y, dt, dj, s0, J, w0, config)
    # divide by s BEFORE smoothing in all three terms: the scale boxcar
    # mixes neighbouring scales, so S(P/s) != S(P)/s; doing them
    # inconsistently breaks the algebraic self-coherence R²(x, x) = 1
    inv_s = constant(lambda: 1.0 / scales[:, None], wx.real,
                     key=content_key("wct.inv_s", scales))
    sxx = _tc_smooth((wx.real ** 2 + wx.imag ** 2) * inv_s, scales, dt, dj, config).real
    syy = _tc_smooth((wy.real ** 2 + wy.imag ** 2) * inv_s, scales, dt, dj, config).real
    sxy = _tc_smooth(wx * torch.conj(wy) * inv_s, scales, dt, dj, config)
    num = sxy.real ** 2 + sxy.imag ** 2
    den = torch.clamp(sxx * syy, min=1e-30)
    return torch.clamp(num / den, 0.0, 1.0), scales, freqs
