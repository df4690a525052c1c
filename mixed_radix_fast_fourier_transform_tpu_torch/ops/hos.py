"""Higher-order spectra: bispectrum and bicoherence.

Counterpart of ``mixed_radix_fast_fourier_transform_tpu/ops/hos.py``.  The
direct (frame-averaged) estimators of Nikias & Raghuveer 1987: segment the
signal, FFT each frame with the engine (one batched transform), and average
the frequency-domain triple products

    B(f1, f2) = E[ X(f1) · X(f2) · conj(X(f1 + f2)) ]

over frames.  The triple product is an outer product plus one host-computed
index map for X(f1+f2): no data-dependent control flow.  Quadratic phase
coupling (three tones at f1, f2, f1+f2 with phases φ1, φ2, φ1+φ2) shows up
as |bicoherence| → 1 at (f1, f2); independent phases average to 0, the
classic nonlinearity test a power spectrum cannot perform, since it
discards phase.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utils.config import DEFAULT_CONFIG, DTYPE, SpectralConfig
from ..utils.numerics import as_tensor, constant
from .rfft import rfft
from .stft import _frame, _window_on

Tensor = torch.Tensor

__all__ = ["bispectrum", "bicoherence"]


def _frame_ffts(x, nperseg: int, noverlap: Optional[int],
                window, detrend: bool,
                config: SpectralConfig) -> Tensor:
    """(..., frames, nperseg//2+1) windowed frame spectra via one batched
    rfft (frames carry no mean, per the HOS convention: third-order
    cumulants require zero-mean segments)."""
    x = as_tensor(x).to(DTYPE)
    if noverlap is None:
        noverlap = nperseg // 2
    if not 0 <= noverlap < nperseg:
        raise ValueError(f"need 0 <= noverlap < nperseg, got {noverlap}")
    if x.shape[-1] < nperseg:
        raise ValueError(f"signal length {x.shape[-1]} < nperseg {nperseg}")
    frames = _frame(x, nperseg, nperseg - noverlap)
    if detrend:
        frames = frames - torch.mean(frames, dim=-1, keepdim=True)
    return rfft(frames * _window_on(window, nperseg, x), axis=-1, config=config)


def _principal_domain(X: Tensor, nfreq: Optional[int]):
    """(X1, Xs, valid): the truncated spectra, the sum-frequency gather
    X(f1+f2), and the principal-domain mask 0 <= f2 <= f1,
    f1+f2 <= Nyquist (fp32, on the device), shared by both triple-product
    estimators."""
    n_bins = X.shape[-1]
    F = n_bins if nfreq is None else min(int(nfreq), n_bins)

    def domain():
        f1 = np.arange(F)[:, None]
        f2 = np.arange(F)[None, :]
        valid = (f2 <= f1) & (f1 + f2 <= n_bins - 1)
        return valid, np.where(valid, f1 + f2, 0).reshape(-1)

    like = X.real
    fsum = constant(lambda: domain()[1], like, torch.long, key=("hos.fsum", n_bins, F))
    valid = constant(lambda: domain()[0], like, key=("hos.valid", n_bins, F))
    X1 = X[..., :F]
    Xs = X[..., fsum].reshape(*X.shape[:-1], F, F)
    return X1, Xs, valid


def bispectrum(x, nperseg: int = 128, noverlap: Optional[int] = None,
               window="hann", *, nfreq: Optional[int] = None,
               detrend: bool = True, return_freqs: bool = False,
               config: SpectralConfig = DEFAULT_CONFIG):
    """Direct bispectrum estimate over the principal domain
    0 <= f2 <= f1, f1 + f2 <= Nyquist.

    Returns a complex (..., F, F) tensor (F = nfreq or nperseg//2 + 1) with
    B[f1, f2] the frame-averaged triple product; entries outside the
    principal domain are zero.  ``return_freqs=True`` additionally returns
    the bin frequencies (cycles/sample, host array).
    """
    X1, Xs, valid = _principal_domain(
        _frame_ffts(x, nperseg, noverlap, window, detrend, config), nfreq)
    # triple product, frames averaged: (..., frames, F, F) -> (..., F, F)
    prod = (X1[..., :, None] * X1[..., None, :]) * torch.conj(Xs)
    B = torch.mean(prod, dim=-3) * valid
    if return_freqs:
        return B, np.arange(X1.shape[-1]) / nperseg
    return B


def bicoherence(x, nperseg: int = 128, noverlap: Optional[int] = None,
                window="hann", *, nfreq: Optional[int] = None,
                detrend: bool = True, return_freqs: bool = False,
                config: SpectralConfig = DEFAULT_CONFIG):
    """Squared bicoherence b²(f1, f2) ∈ [0, 1]: the bispectrum normalized
    by its Cauchy-Schwarz bound (Kim & Powers 1979):

        b² = |E[X1·X2·conj(Xs)]|² / (E[|X1·X2|²] · E[|Xs|²])

    → 1 for perfect quadratic phase coupling at (f1, f2), → 0 for
    independent phases.  Same principal-domain layout as :func:`bispectrum`.
    """
    X1, Xs, valid = _principal_domain(
        _frame_ffts(x, nperseg, noverlap, window, detrend, config), nfreq)
    pair = X1[..., :, None] * X1[..., None, :]
    num = torch.abs(torch.mean(pair * torch.conj(Xs), dim=-3)) ** 2
    den = (torch.mean(torch.abs(pair) ** 2, dim=-3)
           * torch.mean(torch.abs(Xs) ** 2, dim=-3))
    b2 = torch.where(den > 0, num / torch.clamp(den, min=1e-30), torch.zeros_like(num))
    b2 = b2 * valid
    if return_freqs:
        return b2, np.arange(X1.shape[-1]) / nperseg
    return b2
