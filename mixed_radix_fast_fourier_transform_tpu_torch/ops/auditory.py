"""Auditory-model analysis: ERB scale, gammatonegram, modulation spectrum.

Counterpart of ``mixed_radix_fast_fourier_transform_tpu/ops/auditory.py``.
The cochlear front-end stack on top of the existing pieces: the
Glasberg-Moore ERB-rate scale, a gammatone FIR bank (ops/signal.gammatone
per band) applied as ONE batched FFT convolution (the filterbank's band
axis rides the rfft batch dimension, so the whole cochleagram is three
engine transforms regardless of band count) and the amplitude-modulation
spectrum (envelope rFFT per band) that auditory/speech-intelligibility
models (e.g. the speech transmission index family) read their 2-16 Hz
syllable-rate energy from.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..utils.config import DEFAULT_CONFIG, SpectralConfig
from ..utils.numerics import constant, working
from .convolve import fft_convolve
from .rfft import rfft
from .signal import gammatone, hilbert

Tensor = torch.Tensor

__all__ = ["erb_space", "gammatone_filterbank", "gammatonegram",
           "modulation_spectrum"]

_EAR_Q = 9.26449      # Glasberg & Moore 1990 constants
_MIN_BW = 24.7


def _as_float(x) -> Tensor:
    """The signal in the working precision (integer PCM input would
    truncate the sub-unity filter taps to zero)."""
    return working(x)


def erb_space(fmin: float, fmax: float, n: int) -> np.ndarray:
    """``n`` center frequencies equally spaced on the ERB-rate scale
    between ``fmin`` and ``fmax`` (returned ascending)."""
    if not 0 < fmin < fmax:
        raise ValueError("need 0 < fmin < fmax")
    if n < 1:
        raise ValueError("n must be >= 1")
    c = _EAR_Q * _MIN_BW
    lo = np.log(fmin + c)
    hi = np.log(fmax + c)
    return np.exp(np.linspace(lo, hi, n)) - c


def gammatone_filterbank(n_filters: int, fs: float, fmin: float = 50.0,
                         fmax: Optional[float] = None,
                         numtaps: Optional[int] = None) -> Tuple[np.ndarray,
                                                                 np.ndarray]:
    """(impulse responses (n_filters, numtaps), center frequencies): a bank
    of 4th-order FIR gammatones on the ERB-rate ladder (host design
    constants, like any filter taps)."""
    if fmax is None:
        fmax = 0.45 * fs
    freqs = erb_space(fmin, fmax, n_filters)
    bank = np.stack([gammatone(f, "fir", numtaps=numtaps, fs=fs)[0]
                     for f in freqs])  # numtaps default lives in gammatone
    return bank.astype(np.float64), freqs


def _band_signals(x: Tensor, fs: float, n_filters: int, fmin: float,
                  fmax: Optional[float], config: SpectralConfig):
    """(every band of the bank applied to x: (..., bands, T); center freqs)."""
    bank, freqs = gammatone_filterbank(n_filters, fs, fmin, fmax)
    if x.shape[-1] < bank.shape[1]:
        raise ValueError(f"signal length {x.shape[-1]} shorter than the "
                         f"gammatone filters ({bank.shape[1]} taps)")
    bankd = constant(bank, x.real if x.is_complex() else x, x.dtype, key=(
        "auditory.bank", n_filters, float(fs), float(fmin), fmax and float(fmax)))
    # (..., 1, T) conv (..1.., bands, taps) -> (..., bands, T)
    bank_b = bankd.reshape((1,) * (x.ndim - 1) + bank.shape)
    return fft_convolve(x[..., None, :], bank_b, mode="same", config=config), freqs


def gammatonegram(x, fs: float, n_filters: int = 64, hop: Optional[int] = None,
                  fmin: float = 50.0, fmax: Optional[float] = None,
                  *, power: float = 2.0,
                  config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    """Cochleagram: (..., n_filters, frames) band energies.

    One batched FFT convolution applies every gammatone at once (bands
    broadcast against the signal), then per-band energies are averaged over
    ``hop``-sized frames (default 10 ms).  ``power``=2 gives energy, 1
    gives magnitude."""
    x = _as_float(x)
    if hop is None:
        hop = max(int(0.010 * fs), 1)
    y, _ = _band_signals(x, fs, n_filters, fmin, fmax, config)
    env = torch.abs(y) ** power
    T = env.shape[-1]
    n_frames = T // hop
    env = env[..., : n_frames * hop]
    env = env.reshape(*env.shape[:-1], n_frames, hop)
    return torch.mean(env, dim=-1)


def modulation_spectrum(x, fs: float, n_filters: int = 32,
                        fmin: float = 50.0, fmax: Optional[float] = None,
                        *, config: SpectralConfig = DEFAULT_CONFIG
                        ) -> Tuple[Tensor, np.ndarray, np.ndarray]:
    """Amplitude-modulation spectrum: (S, carrier_freqs, mod_freqs) with
    S (..., n_filters, n_mod_bins) = |rFFT of each band's mean-removed
    Hilbert envelope|², the syllable-rate (2-16 Hz) energy map of auditory
    and intelligibility models.  Band mean levels are REMOVED before the
    transform (the DC bin is ~0); normalize modulation depth against the
    band energies from :func:`gammatonegram` if needed."""
    x = _as_float(x)
    y, freqs = _band_signals(x, fs, n_filters, fmin, fmax, config)
    env = torch.abs(hilbert(y, config=config))
    env = env - torch.mean(env, dim=-1, keepdim=True)
    spec = torch.abs(rfft(env, axis=-1, config=config)) ** 2
    mod_freqs = np.fft.rfftfreq(int(env.shape[-1]), 1.0 / fs)
    return spec, freqs, mod_freqs
