"""Autoregressive spectral estimation: Yule-Walker, Burg, Levinson-Durbin.

Counterpart of ``mixed_radix_fast_fourier_transform_tpu/ops/ar.py``:
parametric PSD estimation (MATLAB pyulear/pburg class) — fit an all-pole
model x[k] = −Σ aᵢ x[k−i] + e and read the spectrum off the model.

Estimation runs on the host in float64, as in the JAX module (order ≲ 64
recursions — design-time numerics, like filter fitting; a tensor is
brought from its device); :func:`ar_psd` evaluates the model spectrum on
the card as one float64 product of the coefficients with a host table of
the unit-circle powers.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..utils.numerics import as_tensor, constant, to_host

Tensor = torch.Tensor

__all__ = ["levinson", "aryule", "arburg", "ar_psd"]


def levinson(r, order: Optional[int] = None
             ) -> Tuple[np.ndarray, float, np.ndarray]:
    """Levinson-Durbin recursion on an autocorrelation sequence
    ``r = [r0, r1, …]``: returns (a, sigma2, reflection) with ``a`` the
    monic AR polynomial [1, a1, …, a_p], ``sigma2`` the prediction-error
    variance, and the reflection (PARCOR) coefficients."""
    r = to_host(r, np.float64)
    if r.ndim != 1 or len(r) < 2:
        raise ValueError("need a 1-D autocorrelation with r0 and r1")
    p = len(r) - 1 if order is None else int(order)
    if not 1 <= p <= len(r) - 1:
        raise ValueError(f"need 1 <= order <= {len(r) - 1}, got {p}")
    if r[0] <= 0:
        raise ValueError("r[0] must be positive")
    a = np.zeros(p + 1)
    a[0] = 1.0
    e = r[0]
    k_hist = np.zeros(p)
    for m in range(1, p + 1):
        acc = r[m] + a[1:m] @ r[1:m][::-1]
        k = -acc / e
        k_hist[m - 1] = k
        a[1:m] = a[1:m] + k * a[1:m][::-1]
        a[m] = k
        e *= (1.0 - k * k)
        if e <= 0:
            raise ValueError("autocorrelation is not positive definite")
    return a, float(e), k_hist


def aryule(x, order: int) -> Tuple[np.ndarray, float, np.ndarray]:
    """Yule-Walker AR fit (MATLAB aryule): biased autocorrelation estimate
    + Levinson-Durbin.  Returns (a, sigma2, reflection)."""
    x = to_host(x, np.float64)
    if x.ndim != 1:
        raise ValueError("aryule expects a 1-D signal")
    n = len(x)
    if not 1 <= order < n:
        raise ValueError(f"need 1 <= order < len(x), got {order}")
    x = x - x.mean()
    r = np.array([x[: n - k] @ x[k:] for k in range(order + 1)]) / n
    return levinson(r, order)


def arburg(x, order: int) -> Tuple[np.ndarray, float, np.ndarray]:
    """Burg's method (MATLAB arburg): minimizes forward+backward prediction
    error without windowing the data — sharper peaks than Yule-Walker on
    short records, guaranteed-stable model.  Returns (a, sigma2,
    reflection)."""
    x = to_host(x, np.float64)
    if x.ndim != 1:
        raise ValueError("arburg expects a 1-D signal")
    n = len(x)
    if not 1 <= order < n:
        raise ValueError(f"need 1 <= order < len(x), got {order}")
    x = x - x.mean()  # same convention as aryule: don't burn a pole on DC
    f = x.copy()  # forward errors
    b = x.copy()  # backward errors
    a = np.array([1.0])
    e = float(x @ x) / n
    k_hist = np.zeros(order)
    for m in range(order):
        fm = f[m + 1:]
        bm = b[m: n - 1]
        denom = fm @ fm + bm @ bm
        if denom <= 0:
            raise ValueError("signal energy exhausted before reaching order")
        k = -2.0 * (bm @ fm) / denom
        k_hist[m] = k
        a = np.concatenate([a, [0.0]])
        a = a + k * a[::-1]
        f_new = fm + k * bm
        b_new = bm + k * fm
        f, b = np.concatenate([f[: m + 1], f_new]), \
            np.concatenate([b[: m + 1], b_new])
        e *= (1.0 - k * k)
    return a, float(e), k_hist


def ar_psd(a, sigma2: float, nfreq: int = 512, *, fs: float = 1.0
           ) -> Tuple[np.ndarray, Tensor]:
    """One-sided PSD of the fitted AR model: (freqs, P) with
    P(f) = σ²/fs / |A(e^{2πif/fs})|², matching scipy.signal.welch's
    density scaling so parametric and non-parametric estimates overlay.
    ``freqs`` is a host array; ``P`` is computed on the device of ``a``
    (the card for a host array, as the fits return) as one product of the
    coefficients with the (p+1, nfreq) table of e^{-2πifk/fs}, in float64
    as the JAX module evaluates it: near a pole |A| is a small difference
    of terms of order one, which fp32 would resolve to ~1e-5 only."""
    a = as_tensor(a)
    if a.is_complex() or a.ndim != 1:
        raise ValueError("a must be a real 1-D AR polynomial")
    a = a.to(torch.float64)
    p1 = a.shape[0]
    freqs = np.linspace(0.0, 0.5, nfreq) * fs

    def table():
        ang = -2.0 * np.pi * np.linspace(0.0, 0.5, nfreq)[None, :] * np.arange(p1)[:, None]
        return np.concatenate([np.cos(ang), np.sin(ang)], axis=1)  # (p+1, 2·nfreq)

    A = torch.matmul(a, constant(table, a, torch.float64, key=("ar_psd", p1, nfreq)))
    mag2 = A[:nfreq] ** 2 + A[nfreq:] ** 2
    # one-sided: double everything except DC and Nyquist
    scale = constant(lambda: np.concatenate([[1.0], np.full(nfreq - 2, 2.0), [1.0]])
                     if nfreq > 1 else np.ones(1), a, torch.float64, key=("ar_psd.onesided", nfreq))
    return freqs, (sigma2 / fs) * scale / mag2
