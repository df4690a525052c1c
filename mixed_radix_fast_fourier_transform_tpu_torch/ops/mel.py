"""Mel-scale audio features: filterbank, mel spectrogram, MFCC and their
inverses, harmonic-percussive separation, YIN / probabilistic YIN pitch
tracking, PCEN.

Counterpart of ``mixed_radix_fast_fourier_transform_tpu/ops/mel.py``.  The
standard speech/audio front end, built on the engine's STFT and DCT: a
host-generated (n_mels, n_fft//2+1) triangular filterbank applied as one
matmul at the config's ``op_precision`` over the power spectrogram, then a log and a type-II
DCT for cepstral coefficients.  Conventions follow librosa's defaults
(Slaney-style mel scale and filter normalization, HTK formula available) so
feature pipelines port directly; the filterbank is an lru-cached host
constant, the JAX module's line for line, and is kept on the device once
uploaded.

``pcen``'s one-pole smoother is a linear recurrence over frames and runs as
the blocked scan of ``utils/scan.py`` (a few device kernels whatever the
number of frames).  ``pyin``'s Viterbi decoder is a max-plus recursion, not
a linear one: a loop in the order of the JAX module's scan, a few small
device operations per frame.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.config import DEFAULT_CONFIG, DTYPE, SpectralConfig
from ..utils.numerics import (
    as_tensor, host_table, median, on_host, pad_last, product, working,
)
from ..utils.scan import linear_recurrence
from ..utils.sharding import batch_sharded, last_axis
from .dct import dct as _dct, idct as _idct
from .rfft import irfft as _irfft, rfft as _rfft
from .stft import _frame, griffinlim as _griffinlim, stft as _stft

Tensor = torch.Tensor


def hz_to_mel(f, htk: bool = False) -> np.ndarray:
    """Hz -> mel.  Slaney (librosa default): linear below 1 kHz, log above;
    ``htk=True``: 2595·log10(1 + f/700)."""
    f = np.asarray(f, np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    f_sp = 200.0 / 3.0
    min_log_hz = 1000.0
    logstep = np.log(6.4) / 27.0
    mel = f / f_sp
    above = f >= min_log_hz
    return np.where(
        above,
        min_log_hz / f_sp + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
        mel,
    )


def mel_to_hz(m, htk: bool = False) -> np.ndarray:
    """Inverse of :func:`hz_to_mel`."""
    m = np.asarray(m, np.float64)
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_sp = 200.0 / 3.0
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    above = m >= min_log_mel
    return np.where(above, min_log_hz * np.exp(logstep * (m - min_log_mel)),
                    f_sp * m)


def mel_frequencies(
    n_mels: int, fmin: float = 0.0, fmax: float = 11025.0, htk: bool = False
) -> np.ndarray:
    """``n_mels`` frequencies evenly spaced on the mel scale in [fmin, fmax]."""
    if n_mels < 1:
        raise ValueError(f"n_mels must be >= 1, got {n_mels}")
    mels = np.linspace(hz_to_mel(fmin, htk), hz_to_mel(fmax, htk), n_mels)
    return mel_to_hz(mels, htk)


@functools.lru_cache(maxsize=16)
def _mel_filterbank_cached(
    sr: float, n_fft: int, n_mels: int, fmin: float, fmax: float,
    htk: bool, norm,
):
    freqs = np.fft.rfftfreq(n_fft, 1.0 / sr)  # (n_fft//2 + 1,)
    edges = mel_frequencies(n_mels + 2, fmin, fmax, htk)  # band edges
    fb = np.zeros((n_mels, freqs.size))
    for i in range(n_mels):
        lo, ctr, hi = edges[i], edges[i + 1], edges[i + 2]
        up = (freqs - lo) / max(ctr - lo, 1e-10)
        down = (hi - freqs) / max(hi - ctr, 1e-10)
        fb[i] = np.maximum(0.0, np.minimum(up, down))
    if norm == "slaney":
        # equal-area normalization: each filter integrates to ~1
        enorm = 2.0 / (edges[2:] - edges[:-2])
        fb *= enorm[:, None]
    elif norm is not None:
        raise ValueError(f"norm must be 'slaney' or None, got {norm!r}")
    return fb


def mel_filterbank(
    sr: float,
    n_fft: int,
    n_mels: int = 128,
    fmin: float = 0.0,
    fmax: Optional[float] = None,
    htk: bool = False,
    norm="slaney",
    dtype=np.float32,
) -> np.ndarray:
    """Triangular mel filterbank (n_mels, n_fft//2 + 1): librosa
    ``filters.mel`` conventions (Slaney scale + equal-area norm by
    default)."""
    if n_fft < 2:
        raise ValueError(f"n_fft must be >= 2, got {n_fft}")
    if n_mels < 1:
        raise ValueError(f"n_mels must be >= 1, got {n_mels}")
    fmax = sr / 2.0 if fmax is None else float(fmax)
    if not 0.0 <= fmin < fmax:
        raise ValueError(f"need 0 <= fmin < fmax, got {fmin}, {fmax}")
    if fmax > sr / 2.0:
        raise ValueError(
            f"fmax={fmax} exceeds Nyquist ({sr / 2.0}): bands above Nyquist "
            "would be silently empty"
        )
    fb = _mel_filterbank_cached(
        float(sr), int(n_fft), int(n_mels), float(fmin), fmax, bool(htk), norm
    )
    return fb.astype(dtype)


def _filterbank64(sr, n_fft, n_mels, fmin, fmax, htk, norm) -> np.ndarray:
    return mel_filterbank(sr, n_fft, n_mels, fmin, fmax, htk, norm, dtype=np.float64)


def _filterbank_on(like: Tensor, sr, n_fft, n_mels, fmin, fmax, htk, norm) -> Tensor:
    """The (n_mels, bins) filterbank beside ``like``, uploaded once (built
    on the host also while dynamo traces)."""
    fmax_key = None if fmax is None else float(fmax)
    return host_table("mel.filterbank", _filterbank64, float(sr), int(n_fft), int(n_mels),
                      float(fmin), fmax_key, bool(htk), norm, like=like)


@batch_sharded(last_axis)
def melspectrogram(
    x,
    sr: float = 22050.0,
    n_fft: int = 2048,
    hop: Optional[int] = None,
    window="hann",
    n_mels: int = 128,
    fmin: float = 0.0,
    fmax: Optional[float] = None,
    power: float = 2.0,
    htk: bool = False,
    norm="slaney",
    center: bool = True,
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """Mel-scaled spectrogram: (…, T) -> (…, n_frames, n_mels).

    |STFT|^power contracted against the mel filterbank: one batched frame
    rfft (the engine) plus one (bins, n_mels) matmul at ``op_precision``."""
    x = as_tensor(x)
    if x.is_complex():
        raise ValueError("melspectrogram expects a real signal")
    hop = n_fft // 4 if hop is None else int(hop)
    if hop < 1:
        raise ValueError(f"hop must be >= 1, got {hop}")
    spec = _stft(
        x, nperseg=n_fft, noverlap=n_fft - hop, window=window, center=center,
        config=config,
    )  # (…, frames, bins)
    p = spec.real ** 2 + spec.imag ** 2
    if power != 2.0:
        p = torch.pow(torch.clamp(p, min=0.0), power / 2.0)
    fb = _filterbank_on(p, sr, n_fft, n_mels, fmin, fmax, htk, norm)
    return product(p, fb.T, config.op_precision)


def _lifter(n_mfcc: int, lifter: float, inverse: bool) -> np.ndarray:
    lif = 1.0 + (lifter / 2.0) * np.sin(np.pi * np.arange(1, n_mfcc + 1) / lifter)
    # librosa adds tiny() so an exactly-zero lifter entry (which zeroed
    # the forward coefficient) inverts to 0 instead of NaN
    return lif + np.sign(lif + 1e-300) * 1e-30 if inverse else lif


def _lifter_on(like: Tensor, n_mfcc: int, lifter: float, inverse: bool) -> Tensor:
    return host_table("mel.lifter", _lifter, n_mfcc, float(lifter), inverse, like=like)


def mfcc(
    x,
    sr: float = 22050.0,
    n_mfcc: int = 20,
    n_fft: int = 2048,
    hop: Optional[int] = None,
    n_mels: int = 128,
    fmin: float = 0.0,
    fmax: Optional[float] = None,
    top_db: float = 80.0,
    lifter: float = 0.0,
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """Mel-frequency cepstral coefficients: (…, T) -> (…, frames, n_mfcc).

    log-power mel spectrogram (dB, floored ``top_db`` below the per-signal
    peak like librosa's power_to_db) followed by an orthonormal type-II DCT
    over the mel axis.  ``lifter`` > 0 applies librosa's sinusoidal
    cepstral liftering 1 + (L/2)·sin(π(k+1)/L)."""
    if n_mfcc < 1:
        raise ValueError(f"n_mfcc must be >= 1, got {n_mfcc}")
    if n_mfcc > n_mels:
        raise ValueError(f"n_mfcc={n_mfcc} > n_mels={n_mels}")
    if lifter < 0:
        raise ValueError(f"lifter must be >= 0, got {lifter}")
    m = melspectrogram(
        x, sr, n_fft, hop, n_mels=n_mels, fmin=fmin, fmax=fmax, config=config
    )
    db = 10.0 * torch.log10(torch.clamp(m, min=1e-10))
    if top_db is not None:
        peak = torch.amax(db, dim=(-2, -1), keepdim=True)
        db = torch.maximum(db, peak - top_db)
    C = _dct(db, type=2, norm="ortho", config=config)[..., :n_mfcc]
    if lifter > 0:
        C = C * _lifter_on(C, n_mfcc, lifter, inverse=False)
    return C


def mfcc_to_mel(
    C,
    n_mels: int = 128,
    lifter: float = 0.0,
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """Invert MFCCs to a mel POWER spectrogram
    (librosa.feature.inverse.mfcc_to_mel): unlifter, zero-pad the cepstrum
    to ``n_mels``, inverse orthonormal DCT-II, and undo the dB scaling.
    Exact when n_mfcc == n_mels and no floor was hit; a smoothed (cepstral
    low-pass) estimate otherwise."""
    C = as_tensor(C).to(DTYPE)
    if C.ndim < 2:
        raise ValueError("C must be (…, frames, n_mfcc)")
    n_mfcc = C.shape[-1]
    if n_mfcc > n_mels:
        raise ValueError(f"n_mfcc={n_mfcc} > n_mels={n_mels}")
    if lifter < 0:
        raise ValueError(f"lifter must be >= 0, got {lifter}")
    if lifter > 0:
        C = C / _lifter_on(C, n_mfcc, lifter, inverse=True)
    full = F.pad(C, (0, n_mels - n_mfcc))
    db = _idct(full, type=2, norm="ortho", config=config)
    return torch.pow(10.0, db / 10.0)


def mfcc_to_audio(
    C,
    sr: float = 22050.0,
    n_fft: int = 2048,
    hop: Optional[int] = None,
    n_mels: int = 128,
    n_iter_nnls: int = 32,
    n_iter_gl: int = 32,
    lifter: float = 0.0,
    fmin: float = 0.0,
    fmax: Optional[float] = None,
    length: Optional[int] = None,
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """MFCCs all the way back to a waveform: :func:`mfcc_to_mel` ->
    :func:`mel_to_audio` (NNLS + Griffin-Lim), librosa
    feature.inverse.mfcc_to_audio.  Pass the SAME ``fmin``/``fmax`` used at
    :func:`mfcc` time so the NNLS inverts the matching filterbank."""
    M = mfcc_to_mel(C, n_mels=n_mels, lifter=lifter, config=config)
    return mel_to_audio(
        M, sr, n_fft, hop, n_iter_nnls=n_iter_nnls, n_iter_gl=n_iter_gl,
        fmin=fmin, fmax=fmax, length=length, config=config,
    )


@functools.lru_cache(maxsize=16)
def _nnls_constants(sr, n_fft, n_mels, fmin, fmax, htk, norm):
    """(pseudo-inverse (bins, n_mels), Lipschitz step 1/||F Fᵀ||₂) of the
    filterbank, host fp64."""
    fb = mel_filterbank(sr, n_fft, n_mels, fmin, fmax, htk, norm, dtype=np.float64)
    return np.linalg.pinv(fb), 1.0 / max(float(np.linalg.norm(fb @ fb.T, 2)), 1e-12)


def _nnls_part(i: int, *key):
    """Item ``i`` of :func:`_nnls_constants` of ``key``, for ``host_table``
    (0, the pseudo-inverse) and ``on_host`` (1, the step)."""
    return _nnls_constants(*key)[i]


def mel_to_stft(
    M,
    sr: float = 22050.0,
    n_fft: int = 2048,
    power: float = 2.0,
    n_iter: int = 32,
    fmin: float = 0.0,
    fmax: Optional[float] = None,
    htk: bool = False,
    norm="slaney",
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """Approximate-invert a mel spectrogram to STFT MAGNITUDES:
    (…, frames, n_mels) -> (…, frames, n_fft//2+1), librosa
    ``feature.inverse.mel_to_stft`` semantics (its NNLS step).

    NNLS per frame: initialize at the clipped pseudo-inverse solution (one
    host pinv of the small (n_mels, bins) filterbank, one matmul) and refine
    with ``n_iter`` projected-gradient steps at the exact Lipschitz rate
    1/||F Fᵀ||₂, two matmuls per step at ``op_precision``."""
    M = as_tensor(M)
    if M.is_complex():
        raise ValueError("mel_to_stft takes a real mel spectrogram")
    if M.ndim < 2:
        raise ValueError("M must be (…, frames, n_mels)")
    if n_iter < 0:
        raise ValueError(f"n_iter must be >= 0, got {n_iter}")
    M = M.to(DTYPE)
    n_mels = M.shape[-1]
    key = (float(sr), int(n_fft), int(n_mels), float(fmin),
           None if fmax is None else float(fmax), bool(htk), norm)
    lam = on_host(_nnls_part, 1, *key)
    pinv = host_table("mel.pinv", _nnls_part, 0, *key, like=M)
    fbd = _filterbank_on(M, sr, n_fft, n_mels, fmin, fmax, htk, norm)  # (n_mels, bins)
    prec = config.op_precision
    s = torch.clamp(product(M, pinv.T, prec), min=0.0)
    for _ in range(n_iter):
        resid = product(s, fbd.T, prec) - M
        s = torch.clamp(s - lam * product(resid, fbd, prec), min=0.0)
    # mel power -> linear magnitude
    return torch.pow(torch.clamp(s, min=0.0), 1.0 / power)


def mel_to_audio(
    M,
    sr: float = 22050.0,
    n_fft: int = 2048,
    hop: Optional[int] = None,
    window="hann",
    power: float = 2.0,
    n_iter_nnls: int = 32,
    n_iter_gl: int = 32,
    fmin: float = 0.0,
    fmax: Optional[float] = None,
    length: Optional[int] = None,
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """Invert a mel spectrogram to a waveform: NNLS filterbank inversion
    (:func:`mel_to_stft`) followed by Griffin-Lim phase retrieval, librosa
    ``feature.inverse.mel_to_audio`` semantics: one pipeline of engine
    rfft/irfft rounds."""
    hop = n_fft // 4 if hop is None else int(hop)
    mag = mel_to_stft(
        M, sr, n_fft, power, n_iter_nnls, fmin, fmax, config=config
    )
    return _griffinlim(
        mag, n_iter=n_iter_gl, nperseg=n_fft, noverlap=n_fft - hop,
        window=window, length=length, config=config,
    )


def _median_filter_axis(x: Tensor, size: int, axis: int) -> Tensor:
    """Sliding median along ``axis`` (reflect edges): one strided window
    view of the reflect-padded axis and one median over the window axis
    (numpy's: the mean of the two middle values of an even count)."""
    half = size // 2
    xm = torch.movedim(x, axis, -1)
    win = pad_last(xm, half, size - 1 - half, "reflect").unfold(-1, size, 1)  # (…, n, size)
    return torch.movedim(median(win, dim=-1), -1, axis)


def _softmask(x: Tensor, ref: Tensor, power: float) -> Tensor:
    """librosa.util.softmask: x^p / (x^p + ref^p), scale-invariant and
    zero-safe; power=inf gives the hard mask x > ref."""
    if np.isinf(power):
        return (x > ref).to(x.dtype)
    z = torch.clamp(torch.maximum(x, ref), min=1e-30)
    xp = (x / z) ** power
    rp = (ref / z) ** power
    return xp / (xp + rp)


def hpss(
    S,
    kernel_size=31,
    power: float = 2.0,
    margin=1.0,
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
):
    """Harmonic-percussive source separation on a spectrogram
    (…, frames, bins), librosa.decompose.hpss (Fitzgerald 2010 /
    Driedger 2014 margins): harmonic enhancement is a median filter
    ALONG TIME, percussive along FREQUENCY; soft Wiener-style masks of
    exponent ``power`` (inf = hard) recombine the input.

    ``kernel_size`` and ``margin`` take scalars or (harmonic,
    percussive) pairs.  Returns ``(S_harmonic, S_percussive)`` with the
    dtype of ``S`` (complex in, complex out: run istft after to get the
    separated signals)."""
    S = as_tensor(S)
    if S.ndim < 2:
        raise ValueError("S must be (…, frames, bins)")
    kh, kp = (kernel_size if np.ndim(kernel_size) else (kernel_size,) * 2)
    mh, mp = (margin if np.ndim(margin) else (margin,) * 2)
    if kh < 1 or kp < 1 or kh % 2 == 0 or kp % 2 == 0:
        raise ValueError("kernel sizes must be odd and >= 1")
    if mh < 1.0 or mp < 1.0:
        raise ValueError("margins must be >= 1")
    if min(S.shape[-2], S.shape[-1]) < 2:
        raise ValueError("spectrogram too small to separate")
    S = working(S)
    mag = torch.abs(S) if S.is_complex() else S
    harm = _median_filter_axis(mag, min(kh, 2 * S.shape[-2] - 1), -2)
    perc = _median_filter_axis(mag, min(kp, 2 * S.shape[-1] - 1), -1)
    mask_h = _softmask(harm, perc * mh, power)
    mask_p = _softmask(perc, harm * mp, power)
    return S * mask_h, S * mask_p


def _taus(tau_max: int) -> np.ndarray:
    return np.arange(1, tau_max + 1)


def _in_band(n_lag: int, tau_min: int, tau_max: int) -> np.ndarray:
    lag_idx = np.arange(1, n_lag - 1)
    return (lag_idx >= tau_min) & (lag_idx <= tau_max - 1)


def _yin_cmnd(x, fmin, fmax, sr, frame_length, win_length, hop, center,
              config):
    """Cumulative-mean-normalized difference frames shared by yin/pyin:
    (…, T) -> (cmnd (…, F, tau_max+1), tau_min, tau_max, frame energy)."""
    x = as_tensor(x)
    if x.is_complex():
        raise ValueError("pitch estimators take real signals")
    if not 0 < fmin < fmax <= sr / 2:
        raise ValueError(f"need 0 < fmin < fmax <= sr/2, got {fmin}, {fmax}")
    win_length = frame_length // 2 if win_length is None else int(win_length)
    hop = frame_length // 4 if hop is None else int(hop)
    if not 0 < win_length < frame_length:
        raise ValueError("need 0 < win_length < frame_length")
    if hop < 1:
        raise ValueError(f"hop must be >= 1, got {hop}")
    tau_max = min(frame_length - win_length, int(np.ceil(sr / fmin)))
    tau_min = max(1, int(np.floor(sr / fmax)))
    if tau_min + 2 > tau_max:
        raise ValueError(
            f"frequency range [{fmin}, {fmax}] needs lags in "
            f"[{tau_min}, {tau_max}]: enlarge frame_length or the range"
        )
    xw = x.to(config.dtype)
    if center:
        xw = F.pad(xw, (frame_length // 2, frame_length // 2))
    frames = _frame(xw, frame_length, hop)  # (…, F, frame_length)
    W = win_length
    # d(τ) = e0 + e(τ) − 2c(τ): sliding energy + one FFT correlation
    csum = F.pad(torch.cumsum(frames * frames, dim=-1), (1, 0))  # (…, F, fl+1)
    e0 = csum[..., W] - csum[..., 0]
    e_tau = csum[..., W: W + tau_max + 1] - csum[..., : tau_max + 1]
    nfft = int(2 ** np.ceil(np.log2(frame_length + W)))
    spec = _rfft(frames, n=nfft, config=config) * torch.conj(
        _rfft(frames[..., :W], n=nfft, config=config)
    )
    corr = _irfft(spec, n=nfft, config=config)[..., : tau_max + 1]
    d = e0[..., None] + e_tau - 2.0 * corr  # (…, F, tau_max+1)
    # cumulative mean normalized difference
    tau_f = host_table("yin.taus", _taus, tau_max, like=d, dtype=d.dtype)
    run = torch.cumsum(d[..., 1:], dim=-1)
    cmnd = torch.cat(
        [torch.ones_like(d[..., :1]),
         d[..., 1:] * tau_f / torch.clamp(run, min=1e-12)], -1
    )
    return cmnd, tau_min, tau_max, e0


def _cmnd_troughs(cmnd: Tensor, tau_min: int, tau_max: int):
    """Shared yin/pyin trough detection: (lo, trough_mask, in_band) over
    the interior lag axis 1..tau_max-1."""
    lo = cmnd[..., 1:-1]
    is_trough = (lo <= cmnd[..., :-2]) & (lo <= cmnd[..., 2:])
    in_band = host_table("yin.in_band", _in_band, cmnd.shape[-1], tau_min, tau_max, like=cmnd,
                         dtype=torch.bool)
    return lo, is_trough & in_band, in_band


def _parabolic_lag(cmnd: Tensor, pick: Tensor) -> Tensor:
    """Sub-sample lag: parabolic minimum of cmnd around integer ``pick``."""
    p0 = torch.take_along_dim(cmnd, pick[..., None] - 1, dim=-1)[..., 0]
    p1 = torch.take_along_dim(cmnd, pick[..., None], dim=-1)[..., 0]
    p2 = torch.take_along_dim(cmnd, pick[..., None] + 1, dim=-1)[..., 0]
    denom = p0 + p2 - 2.0 * p1
    ok = torch.abs(denom) > 1e-12
    shift = torch.where(ok, 0.5 * (p0 - p2) / torch.where(ok, denom, torch.ones_like(denom)),
                        torch.zeros_like(denom))
    return pick.to(cmnd.dtype) + torch.clamp(shift, -0.5, 0.5)


def _first_true(mask: Tensor) -> Tensor:
    """Index of the first True along the last axis (0 where there is none)."""
    return torch.argmax(mask.to(torch.uint8), dim=-1)


def yin(
    x,
    fmin: float,
    fmax: float,
    sr: float = 22050.0,
    frame_length: int = 2048,
    win_length: Optional[int] = None,
    hop: Optional[int] = None,
    trough_threshold: float = 0.1,
    center: bool = True,
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """YIN fundamental-frequency estimation (de Cheveigné & Kawahara
    2002; librosa.yin conventions): (…, T) -> f0 in Hz per frame
    (…, n_frames), frame m centered on sample m·hop.

    The difference function d(τ) = Σ_j (x_j − x_{j+τ})² evaluates per
    frame as sliding energies (one cumsum) plus a cross term computed with
    ONE batched engine rfft/irfft correlation, no lag loop; the
    cumulative-mean normalization is a cumsum; the "first trough under
    threshold, else global minimum" pick and the parabolic refinement are
    argmax/gather compositions with no data-dependent control flow."""
    cmnd, tau_min, tau_max, _ = _yin_cmnd(
        x, fmin, fmax, sr, frame_length, win_length, hop, center, config
    )
    lo, trough, in_band = _cmnd_troughs(cmnd, tau_min, tau_max)
    below = trough & (lo < trough_threshold)
    # first below-threshold trough, else the global in-band minimum of the
    # normalized difference
    any_below = torch.any(below, dim=-1)
    first = _first_true(below)
    masked = torch.where(in_band, lo, torch.full_like(lo, math.inf))
    fallback = torch.argmin(masked, dim=-1)
    pick = torch.where(any_below, first, fallback) + 1  # back to lag units
    tau_hat = _parabolic_lag(cmnd, pick)
    return sr / tau_hat


@functools.lru_cache(maxsize=16)
def _pyin_tables(fmin, fmax, sr, tau_max, resolution, switch_prob, max_semitones_per_frame):
    """Host constants of pyin's decoder: (n_bins, bin frequencies, the
    lag -> log-pitch-bin one-hot (lags, bins), log transition matrix)."""
    lag_idx = np.arange(1, tau_max)
    n_bins = int(np.ceil(12.0 * np.log2(fmax / fmin) / resolution)) + 1
    bin_f = fmin * 2.0 ** (resolution * np.arange(n_bins) / 12.0)
    lag_f = sr / lag_idx.astype(np.float64)
    bin_of = np.clip(np.round(
        12.0 * np.log2(np.maximum(lag_f, 1e-10) / fmin) / resolution
    ), 0, n_bins - 1).astype(np.int64)
    onehot = (bin_of[:, None] == np.arange(n_bins)[None, :]).astype(np.float64)
    # transition matrix: triangular pitch window + voicing switch
    width = max(int(round(max_semitones_per_frame / resolution)), 1)
    db = np.abs(np.arange(n_bins)[:, None] - np.arange(n_bins)[None, :])
    tri = np.maximum(1.0 - db / (width + 1.0), 0.0)
    tri /= np.maximum(tri.sum(1, keepdims=True), 1e-30)
    T = np.zeros((n_bins + 1, n_bins + 1))
    T[:n_bins, :n_bins] = (1.0 - switch_prob) * tri
    T[:n_bins, n_bins] = switch_prob
    T[n_bins, :n_bins] = switch_prob / n_bins
    T[n_bins, n_bins] = 1.0 - switch_prob
    return n_bins, bin_f, onehot, np.log(T + 1e-30)


def _pyin_table(i: int, *key):
    """Item ``i`` of :func:`_pyin_tables` of ``key``, for ``on_host`` (0,
    the bin count) and ``host_table`` (1, 2, 3)."""
    return _pyin_tables(*key)[i]


def pyin(
    x,
    fmin: float,
    fmax: float,
    sr: float = 22050.0,
    frame_length: int = 2048,
    win_length: Optional[int] = None,
    hop: Optional[int] = None,
    resolution: float = 0.1,
    switch_prob: float = 0.01,
    max_semitones_per_frame: float = 12.0,
    center: bool = True,
    fill_unvoiced: float = np.nan,
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
):
    """Probabilistic YIN (Mauch & Dixon 2014 style): (…, T) ->
    ``(f0, voiced_flag, voiced_prob)``, each (…, n_frames); unvoiced
    frames carry ``fill_unvoiced`` in f0.

    Per frame, EVERY trough of the cumulative-mean-normalized difference
    becomes a pitch candidate weighted by the Beta(2, 18) threshold prior
    of the original pYIN (P[threshold > depth] has the closed form
    (1−d)¹⁹ + 19·d·(1−d)¹⁸, no incomplete-beta calls); candidates spread
    onto a log-pitch grid of ``resolution`` semitones through a host-made
    lag→bin one-hot matmul.  A single-unvoiced-state HMM (triangular
    pitch transitions capped at ``max_semitones_per_frame``,
    ``switch_prob`` voicing switches) is decoded by max-product Viterbi:
    one loop forward over frames with int32 backpointers and one loop
    back.  Simplification vs librosa.pyin: one unvoiced state instead of
    per-pitch unvoiced states (pitch memory resets across unvoiced
    gaps)."""
    cmnd, tau_min, tau_max, e0 = _yin_cmnd(
        x, fmin, fmax, sr, frame_length, win_length, hop, center, config
    )
    if not 0.0 < switch_prob < 1.0:
        raise ValueError(f"switch_prob must be in (0, 1), got {switch_prob}")
    if resolution <= 0:
        raise ValueError(f"resolution must be > 0, got {resolution}")
    rdt = cmnd.dtype
    lo, trough, _ = _cmnd_troughs(cmnd, tau_min, tau_max)
    d = torch.clamp(lo, 0.0, 1.0)
    # P[Beta(2,18) threshold > depth] = (1-d)^19 + 19 d (1-d)^18
    w = torch.where(
        trough, (1.0 - d) ** 19 + 19.0 * d * (1.0 - d) ** 18, torch.zeros_like(d)
    )  # (…, F, tau_max-1)
    # pYIN's Boltzmann prior over trough RANK (parameter 2): earlier
    # (shorter-lag) troughs dominate by e² per rank, which both suppresses
    # octave-below errors and outweighs the +log2/frame self-transition
    # bonus the truncated triangular HMM kernel gives the edge pitch bins
    tr = trough.to(rdt)
    rank = torch.cumsum(tr, dim=-1) - tr
    w = w * torch.exp(-2.0 * rank)
    # silence gate: zero-energy frames carry no pitch evidence (the CMND
    # of an all-zero frame is 0/0 -> 0, which would read as deep troughs)
    emax = torch.amax(e0, dim=-1, keepdim=True)
    live = e0 > 1e-10 * torch.clamp(emax, min=1e-30)
    w = w * live[..., None].to(rdt)
    total = torch.sum(w, -1)
    # frame voicing = min(total, 1); candidates split that mass in
    # proportion to w (normalize by total ALWAYS: normalizing only when
    # total > 1 would square the voicing probability into the voiced
    # observations and bias the decoder unvoiced on moderate evidence)
    p_voiced = torch.clamp(total, max=1.0)
    cand = w / torch.clamp(total, min=1e-12)[..., None]
    key = (float(fmin), float(fmax), float(sr), int(tau_max), float(resolution),
           float(switch_prob), float(max_semitones_per_frame))
    n_bins = on_host(_pyin_table, 0, *key)
    onehot = host_table("pyin.onehot", _pyin_table, 2, *key, like=cmnd)  # (lags, bins)
    logT = host_table("pyin.logT", _pyin_table, 3, *key, like=cmnd)      # (S, S)
    obs_v = product(cand, onehot, config.op_precision) * p_voiced[..., None]
    obs_u = (1.0 - p_voiced)[..., None]
    obs = torch.log(torch.cat([obs_v, obs_u], -1) + 1e-12)  # (…,F,S)

    # Viterbi: forward max-product with backpointers, then backtrace
    obs_steps = torch.movedim(obs, -2, 0)  # (F, …, S)
    v = obs_steps[0]
    bps = []
    for ob in obs_steps[1:]:
        best, arg = torch.max(v[..., :, None] + logT, dim=-2)  # over S_prev
        bps.append(arg)
        v = best + ob
    state = torch.argmax(v, dim=-1)
    path = [state]
    for bp in reversed(bps):
        # bp[t] maps state_{t+1} -> state_t
        state = torch.take_along_dim(bp, state[..., None], dim=-1)[..., 0]
        path.append(state)
    path = torch.stack(path[::-1], dim=-1)  # (…, F) states 0..F-1
    voiced = path < n_bins
    bsel = torch.clamp(path, max=n_bins - 1)
    # refine the decoded bin to sub-sample pitch: among the troughs that
    # map to the selected bin, take the strongest and interpolate the
    # CMND parabolically (yin's refinement); near fmax adjacent integer
    # lags are several bin-widths apart, so the bin center alone would be
    # far coarser than `resolution` promises
    colsel = torch.movedim(onehot[:, bsel], 0, -1)  # (…,F,l)
    wsel = w * colsel
    has_lag = torch.any(wsel > 0, dim=-1)
    pick = torch.argmax(wsel, dim=-1) + 1  # lag units
    tau_hat = _parabolic_lag(cmnd, pick)
    f0_fine = sr / tau_hat
    f0_bin = host_table("pyin.bin_f", _pyin_table, 1, *key, like=cmnd)[bsel]
    f0 = torch.where(has_lag, f0_fine, f0_bin)
    f0 = torch.where(voiced, f0, torch.full_like(f0, fill_unvoiced))
    return f0, voiced, p_voiced


def _coef(v, like: Tensor):
    """A PCEN coefficient: a tensor (learned, per band) in the dtype of
    ``like``, or the scalar as it is."""
    return v.to(like.dtype) if isinstance(v, torch.Tensor) else v


def pcen(
    S,
    sr: float = 22050.0,
    hop: int = 512,
    gain=0.98,
    bias=2.0,
    power=0.5,
    time_constant: float = 0.4,
    eps: float = 1e-6,
    b=None,
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """Per-channel energy normalization (Wang et al. 2017;
    librosa.pcen defaults): (…, frames, bands) -> same shape,

        PCEN = (S / (eps + M)^gain + bias)^power − bias^power,

    with M the per-band IIR-smoothed energy (one-pole, coefficient ``b``
    from ``time_constant`` seconds at the given frame rate, or passed
    directly), the learnable-frontend alternative to log-mel.  The
    smoother is ``utils.scan.linear_recurrence``, a blocked scan over
    frames: M[0] starts from S[0] and also consumes it.  ``gain``/``bias``/``power``/``b`` accept scalars OR
    per-band tensors that may need gradients, so the trainable frontend
    (models/audio_frontend) calls this same function with learned
    coefficients."""
    S = as_tensor(S)
    if S.ndim < 2:
        raise ValueError("S must be (…, frames, bands)")
    if S.is_complex():
        raise ValueError("pcen takes a magnitude/power spectrogram")
    S = S.to(DTYPE)
    if b is None:
        if time_constant <= 0 or hop < 1:
            raise ValueError("need time_constant > 0 and hop >= 1")
        t_frames = time_constant * sr / float(hop)
        # librosa: b from the equivalent-width of the one-pole smoother
        b = (math.sqrt(1.0 + 4.0 * t_frames**2) - 1.0) / (2.0 * t_frames**2)
    # a Python number stays one (no numpy), so a traced call's smoother is a
    # host coefficient whose tables the host builds
    per_band = isinstance(b, torch.Tensor) or (
        not isinstance(b, (int, float)) and np.ndim(b) > 0)
    bd = as_tensor(b, S.device).to(S.dtype) if per_band else float(b)
    steps = torch.movedim(S, -2, 0)
    # m <- (1 − b)·m + b·s over frames: a blocked scan, a few kernels per
    # level instead of one per frame; the carry starts at S[0]
    M = linear_recurrence(1.0 - bd, (bd * steps)[..., None], steps[0][..., None])
    M = torch.movedim(M[..., 0], 0, -2)
    gain, bias, power = _coef(gain, S), _coef(bias, S), _coef(power, S)
    smooth_gain = torch.exp(-gain * torch.log(eps + M))
    return (S * smooth_gain + bias) ** power - bias**power


def A_weighting(frequencies) -> np.ndarray:
    """IEC 61672 A-weighting in dB at the given frequencies (host fp64,
    librosa.A_weighting conventions: 0 dB at 1 kHz)."""
    f = np.atleast_1d(np.asarray(frequencies, np.float64))
    f2 = np.maximum(f, 1e-10) ** 2
    c1, c2, c3, c4 = 12194.217**2, 20.598997**2, 107.65265**2, 737.86223**2
    num = c1 * f2**2
    den = (f2 + c2) * np.sqrt((f2 + c3) * (f2 + c4)) * (f2 + c1)
    ra = num / den
    return 2.0 + 20.0 * np.log10(np.maximum(ra, 1e-30))
