"""Polyphase filterbank channelizer (weighted overlap-add spectrometer).

Counterpart of ``mixed_radix_fast_fourier_transform_tpu/ops/pfb.py``: the
critically-sampled K-channel analysis PFB of SDR and radio-astronomy
spectrometers — a P-tap-per-branch windowed-sinc prototype filter applied
as a polyphase weighting, then one length-K FFT per frame:

    y[m, k_out] = FFT_K( Σ_p h[p·K + k] · x[m·K + p·K + k] )

The signal is viewed as (frames, P, K) windows by ``unfold`` (no copy), the
weighting is P multiply-adds over those views, and the channel transform
is the engine's batched length-K FFT (the fused kernel for 7-smooth
K ≤ 16,384).  The prototype filter and the synthesis's branch spectra are
host float64 constants.
"""

from __future__ import annotations

from math import gcd
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.config import DEFAULT_CONFIG, SpectralConfig
from ..utils.numerics import as_tensor, content_key, host_table, key_array, on_host
from .fft import fft, ifft
from .stft import get_window

Tensor = torch.Tensor


def pfb_prototype(n_channels: int, taps_per_branch: int = 8,
                  window: str = "hamming") -> np.ndarray:
    """Windowed-sinc prototype lowpass for a K-channel PFB, length P·K,
    cutoff at the channel half-width (1/(2K) cycles/sample), peak-normalized
    so a unit-amplitude in-band tone keeps unit channel gain."""
    K, P = int(n_channels), int(taps_per_branch)
    if K < 2:
        raise ValueError(f"n_channels must be >= 2, got {K}")
    if P < 1:
        raise ValueError(f"taps_per_branch must be >= 1, got {P}")
    n = np.arange(P * K, dtype=np.float64)
    t = (n - (P * K - 1) / 2.0) / K
    h = np.sinc(t) * np.asarray(get_window(window, P * K), np.float64)
    # DC gain 1: each branch carries ~1/K of the weight and the channel FFT
    # sums K branches coherently, so a unit complex tone at a channel
    # center gives |y| = 1 (a real cosine splits to 1/2 at ±k0)
    return h / h.sum()


def _check_prototype(h, K: int, P: int, window: str) -> np.ndarray:
    if h is None:
        return pfb_prototype(K, P, window)
    h = np.asarray(h, np.float64)
    if h.ndim != 1 or h.size % K:
        raise ValueError(
            f"prototype filter length {h.size} must be a multiple of "
            f"n_channels {K}"
        )
    return h


def _prototype_key(h, K: int, P: int, window: str) -> tuple:
    """Host prologue: the content key of the prototype (the caller's ``h``,
    checked, or :func:`pfb_prototype`'s), made on the host also while dynamo
    traces (``utils.numerics.on_host``)."""
    return content_key("pfb.h", _check_prototype(h, K, P, window))


def _branch_taps(hkey: tuple, K: int) -> np.ndarray:
    """The prototype as (P, K) branch taps."""
    return key_array(hkey).reshape(-1, K)


def _baseband_ramp(K: int, M: int) -> np.ndarray:
    """e^{-2πi k (m·hop mod K)/K} over one period K/gcd(M, K) of frames."""
    period = K // gcd(M, K)
    mM = (np.arange(period, dtype=np.int64) * M) % K
    return np.exp(-2j * np.pi * np.outer(mM, np.arange(K)) / K)


def _branch_inverse(hkey: tuple, K: int, Fr: int, eps: float) -> np.ndarray:
    """The Tikhonov-floored inverse of the flipped branch filters' length-F
    spectra, (F, K)."""
    P = key_array(hkey).size // K
    hb = key_array(hkey).reshape(P, K)[::-1]  # h̃_r[p] = h_r[P−1−p]
    Hf = np.fft.fft(np.concatenate([hb, np.zeros((Fr - P, K))]), axis=0)
    mag2 = np.abs(Hf) ** 2
    return np.conj(Hf) / (mag2 + eps * mag2.max(axis=0, keepdims=True))


def pfb_analysis(
    x,
    n_channels: int,
    taps_per_branch: int = 8,
    window: str = "hamming",
    h: Optional[np.ndarray] = None,
    hop: Optional[int] = None,
    mode: str = "valid",
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """K-channel analysis PFB: (…, T) -> (…, frames, K) complex with
    frames = (T − P·K)//hop + 1 (``mode="valid"``: no zero-padded
    warm-up), channel k centered on frequency k/K cycles/sample (FFT bin
    order; real inputs give Hermitian channels).

    ``mode="full"`` first right-pads the signal to a multiple of K, then
    zero-pads (P−1)·K samples at both ends so every window position
    overlapping the data is kept — per polyphase residue the frames then
    hold the COMPLETE linear convolution with the branch filter, which is
    what makes :func:`pfb_synthesis` an exact inverse (of the padded length
    ⌈T/K⌉·K; the trailing pad reconstructs as ~0).

    ``hop`` defaults to K (critically sampled).  ``hop < K`` gives the
    oversampled WOLA channelizer; each channel is then a true baseband
    (derotated) sequence at rate fs/hop, so critically-sampled and
    oversampled outputs agree on coincident frames.

    Pass ``h`` (length P·K) to override the :func:`pfb_prototype` filter.
    """
    x = as_tensor(x)
    K, P = int(n_channels), int(taps_per_branch)
    hkey = on_host(_prototype_key, h, K, P, window)
    P = hkey[2][0] // K
    M = K if hop is None else int(hop)
    if not 1 <= M <= P * K:
        raise ValueError(f"hop must be in [1, {P * K}], got {M}")
    if mode not in ("valid", "full"):
        raise ValueError(f"mode must be 'valid' or 'full', got {mode!r}")
    if not (x.is_complex() or x.is_floating_point()):
        x = x.to(torch.float32)
    if mode == "full":
        tail = (-x.shape[-1]) % K  # complete the last block
        x = F.pad(x, ((P - 1) * K, (P - 1) * K + tail))
    if x.shape[-1] < P * K + M:
        raise ValueError(
            f"signal length {x.shape[-1]} too short for {P} taps of "
            f"{K} channels at hop {M} (need >= {P * K + M})"
        )
    n_frames = (x.shape[-1] - P * K) // M + 1
    # frame m, tap p, branch k reads x[m·hop + p·K + k]: an overlapping view
    frames = x.unfold(-1, P * K, M)  # (…, frames, P·K), no copy
    frames = frames.reshape(frames.shape[:-1] + (P, K))
    real_dtype = x.real.dtype if x.is_complex() else x.dtype
    hw = host_table("pfb.h", _branch_taps, hkey, K, like=x, dtype=real_dtype)
    v = frames[..., 0, :] * hw[0]
    for p in range(1, P):
        v = v + frames[..., p, :] * hw[p]
    y = fft(v, config=config)
    if M != K:
        # the FFT phase-references each frame to its own start m·hop; a
        # baseband channel sequence needs e^{-2πi k (m·hop mod K)/K}.  The
        # ramp cycles with period K/g along m, so only the (period, K)
        # table goes to the device; full frame blocks broadcast against it
        # and a remainder slice covers the tail.
        period = K // gcd(M, K)
        tab = host_table("pfb.ramp", _baseband_ramp, K, M, like=y, dtype=y.dtype)
        q, r = divmod(n_frames, period)
        parts = []
        if q:
            head = y[..., : q * period, :].reshape(y.shape[:-2] + (q, period, K)) * tab
            parts.append(head.reshape(y.shape[:-2] + (q * period, K)))
        if r:
            parts.append(y[..., q * period:, :] * tab[:r])
        y = parts[0] if len(parts) == 1 else torch.cat(parts, dim=-2)
    return y


def pfb_synthesis(
    y,
    taps_per_branch: int = 8,
    window: str = "hamming",
    h: Optional[np.ndarray] = None,
    eps: float = 1e-8,
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """Inverse of the critically-sampled ``pfb_analysis(..., mode="full")``:
    (…, frames, K) channels -> (…, (frames−P+1)·K) time samples.

    Per residue r = n mod K the analysis is a linear convolution of the
    polyphase component x_r[q] = x[qK+r] with the flipped branch filter
    h̃_r[p] = h[(P−1−p)K+r]; full-mode frames hold that convolution
    COMPLETELY (length F = Q+P−1 for Q signal blocks), so a circular
    length-F deconvolution inverts it exactly.  The synthesis undoes the
    channel FFT (one batched engine IFFT over K), then divides by the branch
    spectra along the FRAME axis with Tikhonov floor ``eps``
    (H̄/(|H|²+eps·max|H|²)) — all K branch deconvolutions ride ONE batched
    engine FFT pair of length F (the fused kernel where F is 7-smooth and
    ≤ 16,384, else the stage pipeline); branch spectra are host float64
    constants.

    The fractional-delay branches dip to ~0.04 of peak gain at block-
    Nyquist, so reconstruction amplifies round-off there ~25×.  Valid-mode
    frames lack the P−1 warm-up/tail frames and deconvolve with a boundary
    transient — analyze with ``mode="full"`` when inversion is the goal.
    Oversampled (hop < K) analyses are not invertible by this routine.
    """
    y = as_tensor(y)
    if y.ndim < 2:
        raise ValueError("pfb_synthesis needs (…, frames, K) channels")
    K = y.shape[-1]
    P = int(taps_per_branch)
    hkey = on_host(_prototype_key, h, K, P, window)
    P = hkey[2][0] // K
    Fr = y.shape[-2]
    if Fr < P:
        raise ValueError(f"need at least P={P} frames, got {Fr}")
    v = ifft(y, config=config)  # (…, F, K) branch outputs
    Vf = fft(v, axis=-2, config=config)
    Hinv = host_table("pfb.inv", _branch_inverse, hkey, K, Fr, float(eps), like=Vf, dtype=Vf.dtype)
    xr = ifft(Vf * Hinv, axis=-2, config=config)
    # x_r occupies blocks 0..F−P; the last P−1 blocks are the pad tail
    xr = xr[..., : Fr - P + 1, :]
    return xr.reshape(xr.shape[:-2] + ((Fr - P + 1) * K,))


def pfb_frequencies(n_channels: int, fs: float = 1.0) -> np.ndarray:
    """Center frequency of each PFB channel (FFT bin order)."""
    return np.fft.fftfreq(int(n_channels)) * fs
