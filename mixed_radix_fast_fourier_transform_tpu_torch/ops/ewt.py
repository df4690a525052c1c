"""Empirical wavelet transform (Gilles 2013).

Counterpart of ``mixed_radix_fast_fourier_transform_tpu/ops/ewt.py``:
segment the signal's spectrum at data-adaptive boundaries, then extract one
band per segment with a smooth filterbank.  Boundary detection runs on the
host in float64 (data-dependent peak analysis, as in ops/peaks.py); the
filtering is one batched rFFT → bank multiply → irFFT on the card, the
bank a host float64 table.

Design note: instead of Gilles' Meyer tight frame, the bank is an
AMPLITUDE partition of unity — raised-cosine crossfades with Σᵢ φᵢ(ω) = 1
exactly — so the bands sum to the input to rounding by construction.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..utils.config import DEFAULT_CONFIG, SpectralConfig
from ..utils.numerics import as_tensor, content_key, host_table, key_array, on_host, to_host
from .rfft import irfft, rfft

Tensor = torch.Tensor

__all__ = ["ewt_boundaries", "ewt"]


def ewt_boundaries(x, n_bands: int, *, smooth: int = 5) -> np.ndarray:
    """Data-adaptive spectral segment boundaries (cycles/sample, length
    n_bands−1): the deepest spectral minima between the ``n_bands`` largest
    peaks of the (lightly smoothed) magnitude spectrum — Gilles'
    "lowest minima" rule.  Host float64 (a tensor is brought from its
    device)."""
    x = to_host(x, np.float64)
    if x.ndim != 1:
        raise ValueError("ewt_boundaries expects a 1-D signal")
    if n_bands < 2:
        raise ValueError("n_bands must be >= 2")
    spec = np.abs(np.fft.rfft(x - x.mean()))
    if smooth > 1:
        kern = np.ones(smooth) / smooth
        spec = np.convolve(spec, kern, mode="same")
    n_bins = len(spec)
    interior = spec[1:-1]
    peaks = np.where((interior > spec[:-2]) & (interior >= spec[2:]))[0] + 1
    if len(peaks) < n_bands:
        raise ValueError(f"only {len(peaks)} spectral peaks found; cannot "
                         f"cut {n_bands} bands")
    top = np.sort(peaks[np.argsort(spec[peaks])[-n_bands:]])
    n = len(x)
    bounds = []
    for a, b in zip(top[:-1], top[1:]):
        valley = a + int(np.argmin(spec[a: b + 1]))
        bounds.append(valley / n)  # bin k ↔ k/n cycles/sample exactly
    return np.asarray(bounds)


def _partition_bank(n_bins: int, bounds: np.ndarray,
                    gamma: float, T: int) -> np.ndarray:
    """(n_bands, n_bins) raised-cosine amplitude partition of unity with
    transition half-width γ·ωᵢ around each boundary (exact k/T bin grid —
    linspace(0, 0.5) is off by one part in T for odd lengths)."""
    freqs = np.arange(n_bins) / T
    edges = np.concatenate([[0.0], bounds, [0.5]])
    K = len(edges) - 1

    def rise(f, w0, tw):
        """0→1 raised-cosine step centered at w0 with half-width tw."""
        if tw <= 0:
            return (f >= w0).astype(np.float64)
        t = np.clip((f - (w0 - tw)) / (2 * tw), 0.0, 1.0)
        return 0.5 * (1.0 - np.cos(np.pi * t))

    bank = np.zeros((K, n_bins))
    for i in range(K):
        lo, hi = edges[i], edges[i + 1]
        up = rise(freqs, lo, gamma * lo) if i > 0 else np.ones(n_bins)
        down = 1.0 - rise(freqs, hi, gamma * hi) if i < K - 1 else \
            np.ones(n_bins)
        bank[i] = up * down
    # complementary crossfades sum to 1 exactly; enforce against rounding
    bank /= np.maximum(bank.sum(axis=0, keepdims=True), 1e-300)
    return bank


def _ewt_boundaries(boundaries) -> tuple:
    """Host prologue of :func:`ewt` (``utils.numerics.on_host``): the
    caller's boundaries checked, as their content key."""
    boundaries = np.atleast_1d(np.asarray(boundaries, np.float64))
    if np.any(np.diff(boundaries) <= 0) or np.any(
            (boundaries <= 0) | (boundaries >= 0.5)):
        raise ValueError("boundaries must be ascending within (0, 0.5)")
    return content_key("ewt.boundaries", boundaries)


def _bank_of(n_bins: int, bkey: tuple, gamma: float, T: int) -> np.ndarray:
    """:func:`_partition_bank` of the boundaries ``bkey`` names."""
    return _partition_bank(n_bins, key_array(bkey), gamma, T)


def _refuse_adaptive() -> None:
    raise ValueError(
        "ewt(n_bands=...) cannot be compiled: its boundaries are found on the "
        "host from a concrete 1-D signal; pass boundaries= or call ewt eagerly")


def ewt(x, n_bands: Optional[int] = None,
        boundaries: Optional[np.ndarray] = None, gamma: float = 0.2, *,
        config: SpectralConfig = DEFAULT_CONFIG) -> Tuple[Tensor, np.ndarray]:
    """Empirical wavelet transform → (bands (..., n_bands, T), boundaries).

    Pass ``n_bands`` to detect boundaries from the data (1-D input, on the
    host; eager only: ValueError under ``torch.compile``), or
    ``boundaries`` (cycles/sample, ascending, in (0, 0.5)) explicitly —
    the latter keeps the whole transform on the card and batched, and
    compiles (the bank is a host table kept per length, gamma and
    boundaries).  The bands sum to ``x`` exactly (amplitude partition of
    unity)."""
    x = as_tensor(x)
    T = x.shape[-1]
    if T < 8:
        raise ValueError("ewt needs a signal of length >= 8")
    if boundaries is None:
        if n_bands is None:
            raise ValueError("give n_bands (adaptive) or boundaries")
        if torch.compiler.is_compiling():
            on_host(_refuse_adaptive)
        boundaries = ewt_boundaries(x, n_bands)
    bkey = on_host(_ewt_boundaries, boundaries)
    n_bins = T // 2 + 1
    X = rfft(x, axis=-1, config=config)
    bank = host_table("ewt.bank", _bank_of, n_bins, bkey, float(gamma), T, like=X,
                      dtype=X.real.dtype)
    bands = irfft(X[..., None, :] * bank, n=T, axis=-1, config=config)
    if torch.compiler.is_dynamo_compiling():
        # the kept host copy, which the graph hands back as it is
        return bands, host_table("ewt.boundaries", key_array, bkey, like=torch.device("cpu"),
                                 dtype=torch.float64).numpy()
    return bands, key_array(bkey)
