"""Empirical mode decomposition and the Hilbert-Huang transform.

Counterpart of ``mixed_radix_fast_fourier_transform_tpu/ops/emd.py``:
Huang et al. 1998 sifting decomposes a signal into intrinsic mode
functions (IMFs) plus a monotone residue; :func:`hilbert_huang` then runs
the engine's analytic-signal path over the IMF stack to produce
instantaneous amplitude and frequency.

Split of labor, the JAX module's own: sifting is data-dependent (extrema
counts change per iteration), so ``emd``/``eemd`` run on the host in
float64 (the JAX module's code, scipy's ``CubicSpline``; ``eemd`` draws its
noise from numpy's generator exactly as the JAX module does, so the host
stage equals it); the Hilbert stage is the device path — one batched FFT
pair over the IMF stack (``ops.signal.hilbert``).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..utils.config import DEFAULT_CONFIG, SpectralConfig
from ..utils.numerics import as_tensor, to_host

Tensor = torch.Tensor

__all__ = ["emd", "eemd", "hilbert_huang"]


def _extrema(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Indices of strict local maxima and minima (plateaus take the center)."""
    dx = np.diff(x)
    # sign of slope, with zeros inheriting the previous nonzero sign so flat
    # plateau interiors don't spawn spurious extrema
    s = np.sign(dx)
    for i in range(1, len(s)):
        if s[i] == 0:
            s[i] = s[i - 1]
    flips = np.diff(s)
    maxima = np.where(flips < 0)[0] + 1
    minima = np.where(flips > 0)[0] + 1
    return maxima, minima


def _mirrored_envelope(x: np.ndarray, idx: np.ndarray, n: int) -> np.ndarray:
    """Cubic-spline envelope through the extrema at ``idx``, with two extrema
    mirrored past each boundary (the standard edge treatment — without it the
    spline swings wildly at the ends and corrupts the first/last IMF cycles).
    """
    from scipy.interpolate import CubicSpline  # host design-time dependency

    if len(idx) == 0:
        return np.zeros(n)
    if len(idx) == 1:
        return np.full(n, x[idx[0]])
    # mirror up to two extrema around each end
    k = min(2, len(idx))
    left_t = -idx[:k][::-1]
    left_v = x[idx[:k]][::-1]
    right_t = 2 * (n - 1) - idx[-k:][::-1]
    right_v = x[idx[-k:]][::-1]
    t = np.concatenate([left_t, idx, right_t]).astype(np.float64)
    v = np.concatenate([left_v, x[idx], right_v])
    # mirroring can duplicate the boundary sample itself; dedup keeps the
    # spline knots strictly increasing
    t, keep = np.unique(t, return_index=True)
    v = v[keep]
    if len(t) < 2:
        return np.full(n, v[0])
    if len(t) < 4:  # CubicSpline needs >= 2 pts; linear for tiny knot sets
        return np.interp(np.arange(n), t, v)
    return CubicSpline(t, v)(np.arange(n))


def _sift(x: np.ndarray, max_siftings: int, sd_thresh: float) -> np.ndarray:
    """One IMF: subtract the extrema-envelope mean until the Cauchy SD
    criterion (Huang eq. 5.5) or the sifting cap stops it."""
    h = x.copy()
    n = len(h)
    for _ in range(max_siftings):
        maxima, minima = _extrema(h)
        if len(maxima) + len(minima) < 3:
            break
        upper = _mirrored_envelope(h, maxima, n)
        lower = _mirrored_envelope(h, minima, n)
        mean = 0.5 * (upper + lower)
        h_new = h - mean
        denom = float(np.sum(h * h)) + 1e-300
        sd = float(np.sum((h - h_new) ** 2)) / denom
        h = h_new
        if sd < sd_thresh:
            break
    return h


def _is_monotone_residue(r: np.ndarray) -> bool:
    maxima, minima = _extrema(r)
    return len(maxima) + len(minima) < 3


def emd(x, max_imf: Optional[int] = None, *, max_siftings: int = 100,
        sd_thresh: float = 0.2) -> np.ndarray:
    """Empirical mode decomposition → (n_imfs + 1, n) fp64 array: the IMFs
    in decreasing frequency order, with the residue as the last row.

    The decomposition is exactly additive: ``out.sum(axis=0) == x`` to
    machine precision (each IMF is literally subtracted from the running
    residue).  ``max_imf`` caps the number of IMFs (residue then absorbs the
    remainder); ``sd_thresh`` is Huang's Cauchy stopping threshold (0.2-0.3
    standard).  Host-side float64; 1-D input (a tensor is brought from its
    device).
    """
    x = to_host(x, np.float64)
    if x.ndim != 1:
        raise ValueError("emd expects a 1-D signal (batch via eemd/vstack)")
    if len(x) < 8:
        raise ValueError("signal too short for sifting (need >= 8 samples)")
    if max_imf is not None and max_imf < 1:
        raise ValueError("max_imf must be >= 1")
    imfs = []
    residue = x.copy()
    cap = max_imf if max_imf is not None else int(np.log2(len(x))) + 1
    while len(imfs) < cap and not _is_monotone_residue(residue):
        imf = _sift(residue, max_siftings, sd_thresh)
        if np.allclose(imf, 0.0, atol=1e-12 * max(1.0, np.abs(x).max())):
            break
        imfs.append(imf)
        residue = residue - imf
    return np.vstack(imfs + [residue]) if imfs else residue[None, :]


def eemd(x, n_ensembles: int = 100, noise_std: float = 0.2,
         max_imf: Optional[int] = None, *, seed: int = 0,
         max_siftings: int = 100, sd_thresh: float = 0.2) -> np.ndarray:
    """Ensemble EMD (Wu & Huang 2009): average the IMFs of ``n_ensembles``
    noise-perturbed copies, fixing EMD's mode-mixing at scale boundaries.
    ``noise_std`` is relative to std(x).  Rows whose count differs between
    ensemble members are zero-padded to the maximum IMF count."""
    x = to_host(x, np.float64)
    if x.ndim != 1:
        raise ValueError("eemd expects a 1-D signal")
    rng = np.random.default_rng(seed)
    sigma = noise_std * float(np.std(x))
    stacks = []
    for _ in range(n_ensembles):
        noisy = x + rng.standard_normal(len(x)) * sigma
        stacks.append(emd(noisy, max_imf=max_imf,
                          max_siftings=max_siftings, sd_thresh=sd_thresh))
    rows = max(s.shape[0] for s in stacks)
    acc = np.zeros((rows, len(x)))
    for s in stacks:
        # keep the residue in the LAST row when padding shorter stacks
        acc[: s.shape[0] - 1] += s[:-1]
        acc[rows - 1] += s[-1]
    return acc / n_ensembles


def _gradient(p: Tensor) -> Tensor:
    """numpy.gradient along the last axis (unit spacing): centered
    differences inside, one-sided at the ends."""
    inner = (p[..., 2:] - p[..., :-2]) * 0.5
    return torch.cat([p[..., 1:2] - p[..., :1], inner, p[..., -1:] - p[..., -2:-1]], dim=-1)


def hilbert_huang(x, max_imf: Optional[int] = None, fs: float = 1.0, *,
                  max_siftings: int = 100, sd_thresh: float = 0.2,
                  config: SpectralConfig = DEFAULT_CONFIG):
    """Hilbert-Huang transform: (imfs, inst_amplitude, inst_frequency).

    EMD on the host (numpy float64 ``imfs``), then ONE batched
    analytic-signal FFT pair over the IMF stack on the device of ``x``
    (the card for numpy input; ops/signal.hilbert); instantaneous
    frequency is the centered phase derivative in Hz.  Shapes: (n_rows, n)
    each, where the last row is the residue (its frequency row is
    meaningful only where amplitude is non-negligible).
    """
    from .signal import _unwrap, hilbert

    device = x.device if isinstance(x, Tensor) else None
    imfs = emd(x, max_imf=max_imf, max_siftings=max_siftings,
               sd_thresh=sd_thresh)
    analytic = hilbert(as_tensor(imfs.astype(np.float32), device), config=config)
    amp = torch.abs(analytic)
    phase = _unwrap(torch.angle(analytic))
    freq = _gradient(phase) * (fs / (2.0 * math.pi))
    return imfs, amp, freq
