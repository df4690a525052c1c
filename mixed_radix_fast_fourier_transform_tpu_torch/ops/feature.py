"""Spectral descriptors (librosa.feature conventions, batched).

Counterpart of ``mixed_radix_fast_fourier_transform_tpu/ops/feature.py``.
All features run off ONE shared engine STFT magnitude (computed here or
passed in as ``S``) and reduce with dense products (fp32, TF32 off) and
weighted-moment arithmetic.  Frames follow the library's stft: frame m
centered on sample m·hop, (…, frames, bins).  Host tables (frequency grids,
the chroma filterbank, prior weights) are kept on the device.

Random draws (``specaugment``'s masks, ``decompose``'s initialisation) take
a ``torch.Generator`` where the JAX module takes a PRNG key; each public
function draws and then calls a private helper that takes the draws
(``_specaugment_masks``, ``_decompose_from``).  ``beat_track``'s dynamic
programme is a max-plus recursion, not a linear one: a forward loop over
frames in the order of the JAX module's scan, then a walk back along the
backpointers.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from ..utils.config import DEFAULT_CONFIG, DTYPE, SpectralConfig
from ..utils.numerics import as_tensor, as_tensors, constant, fp32_matmul, pad_last
from .stft import stft as _stft

Tensor = torch.Tensor


def _magspec(x, S, nperseg, hop, window, power, config) -> Tensor:
    if S is not None:
        S = as_tensor(S)
        if S.ndim < 2:
            raise ValueError("S must be (…, frames, bins)")
        mag = torch.abs(S) if S.is_complex() else S.to(DTYPE)
        return mag ** power if power != 1.0 else mag
    x = as_tensor(x)
    if x.is_complex():
        raise ValueError("features take real signals")
    spec = _stft(x, nperseg, nperseg - hop, window, center=True,
                 config=config)
    mag = torch.abs(spec)
    return mag ** power if power != 1.0 else mag


def _bin_freqs(mag: Tensor, sr: float) -> Tensor:
    """The rfft bin frequencies in Hz of a (…, bins) magnitude, on its device."""
    nb = mag.shape[-1]
    return constant(lambda: np.fft.rfftfreq(2 * (nb - 1)) * sr, mag, mag.dtype,
                    key=("feature.freqs", nb, float(sr)))


def spectral_centroid(
    x=None, sr: float = 22050.0, nperseg: int = 2048,
    hop: Optional[int] = None, window="hann", S=None,
    *, config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """First moment of the magnitude spectrum per frame, in Hz:
    (…, T) -> (…, frames)."""
    hop = nperseg // 4 if hop is None else int(hop)
    mag = _magspec(x, S, nperseg, hop, window, 1.0, config)
    freqs = _bin_freqs(mag, sr)
    norm = torch.clamp(torch.sum(mag, -1), min=1e-30)
    return torch.sum(mag * freqs, -1) / norm


def spectral_bandwidth(
    x=None, sr: float = 22050.0, nperseg: int = 2048,
    hop: Optional[int] = None, window="hann", S=None, p: float = 2.0,
    *, config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """p-th-order spread about the centroid per frame, in Hz
    (librosa.feature.spectral_bandwidth)."""
    hop = nperseg // 4 if hop is None else int(hop)
    mag = _magspec(x, S, nperseg, hop, window, 1.0, config)
    freqs = _bin_freqs(mag, sr)
    norm = torch.clamp(torch.sum(mag, -1), min=1e-30)
    cent = (torch.sum(mag * freqs, -1) / norm)[..., None]
    dev = torch.abs(freqs - cent) ** p
    return (torch.sum(mag * dev, -1) / norm) ** (1.0 / p)


def spectral_rolloff(
    x=None, sr: float = 22050.0, nperseg: int = 2048,
    hop: Optional[int] = None, window="hann", S=None,
    roll_percent: float = 0.85,
    *, config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """Frequency below which ``roll_percent`` of the spectral energy
    lies, per frame, in Hz (first bin crossing the threshold — an argmax
    over a cumulative-sum mask, no data-dependent control flow)."""
    if not 0.0 < roll_percent < 1.0:
        raise ValueError(f"roll_percent must be in (0, 1), got {roll_percent}")
    hop = nperseg // 4 if hop is None else int(hop)
    mag = _magspec(x, S, nperseg, hop, window, 1.0, config)
    freqs = _bin_freqs(mag, sr)
    csum = torch.cumsum(mag, -1)
    thresh = roll_percent * csum[..., -1:]
    idx = torch.argmax((csum >= thresh).to(torch.uint8), dim=-1)
    return freqs[idx]


def spectral_flatness(
    x=None, nperseg: int = 2048, hop: Optional[int] = None, window="hann",
    S=None, power: float = 2.0, amin: float = 1e-10,
    *, config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """Wiener entropy per frame: geometric / arithmetic mean of the power
    spectrum — 1 for white noise, →0 for pure tones."""
    hop = nperseg // 4 if hop is None else int(hop)
    p = _magspec(x, S, nperseg, hop, window, power, config)
    p = torch.clamp(p, min=amin)
    gmean = torch.exp(torch.mean(torch.log(p), -1))
    return gmean / torch.mean(p, -1)


def spectral_contrast(
    x=None, sr: float = 22050.0, nperseg: int = 2048,
    hop: Optional[int] = None, window="hann", S=None,
    n_bands: int = 6, fmin: float = 200.0, quantile: float = 0.02,
    *, config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """Peak-to-valley contrast (dB) in octave-spaced bands
    (Jiang et al. 2002; librosa.feature.spectral_contrast):
    (…, T) -> (…, frames, n_bands+1).  Band quantiles are means over the
    sorted bins of each band."""
    if n_bands < 1:
        raise ValueError(f"n_bands must be >= 1, got {n_bands}")
    if not 0.0 < quantile < 1.0:
        raise ValueError(f"quantile must be in (0, 1), got {quantile}")
    hop = nperseg // 4 if hop is None else int(hop)
    mag = _magspec(x, S, nperseg, hop, window, 1.0, config)
    nb = mag.shape[-1]
    freqs = np.fft.rfftfreq(2 * (nb - 1)) * sr
    edges = fmin * (2.0 ** np.arange(n_bands + 1))
    if np.any(edges[:-1] >= sr / 2):
        raise ValueError(
            f"octave band edges exceed Nyquist ({edges[-2]} >= {sr / 2}); "
            "reduce n_bands or fmin"
        )
    edges[-1] = min(edges[-1], sr / 2)  # top band clamps at Nyquist
    bounds = np.concatenate([[0.0], edges])
    out = []
    for b in range(n_bands + 1):
        lo, hi = bounds[b], bounds[b + 1]
        sel = (freqs >= lo) & (freqs < hi) if b < n_bands else (
            (freqs >= lo) & (freqs <= sr / 2)
        )
        k = max(int(sel.sum()), 1)
        band = mag[..., int(np.where(sel)[0][0]): int(np.where(sel)[0][-1]) + 1] \
            if sel.any() else mag[..., :1]
        srt = torch.sort(band, dim=-1).values
        q = max(int(np.ceil(quantile * k)), 1)
        valley = torch.mean(srt[..., :q], -1)
        peak = torch.mean(srt[..., -q:], -1)
        out.append(torch.log10(torch.clamp(peak, min=1e-30))
                   - torch.log10(torch.clamp(valley, min=1e-30)))
    # librosa convention: power_to_db on the MAGNITUDE quantiles -> 10·log10
    return 10.0 * torch.stack(out, dim=-1)


def _centered_frames(x, frame_length: int, hop: int, what: str) -> Tensor:
    """Zero-padded centered frames of a real signal: (…, frames, frame_length)."""
    from .stft import _frame

    x = as_tensor(x)
    if x.is_complex():
        raise ValueError(f"{what} takes real signals")
    xp = pad_last(x.to(DTYPE), frame_length // 2, frame_length // 2)
    return _frame(xp, frame_length, hop)


def zero_crossing_rate(
    x, frame_length: int = 2048, hop: Optional[int] = None,
    *, config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """Fraction of sign changes per frame: (…, T) -> (…, frames)
    (librosa conventions, center-padded frames)."""
    hop = frame_length // 4 if hop is None else int(hop)
    frames = _centered_frames(x, frame_length, hop, "zero_crossing_rate")
    sign = frames >= 0
    flips = sign[..., 1:] != sign[..., :-1]
    return torch.mean(flips.to(DTYPE), -1)


def rms(
    x=None, frame_length: int = 2048, hop: Optional[int] = None, S=None,
    *, config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """Root-mean-square energy per frame, from the waveform or (Parseval)
    from a spectrogram magnitude."""
    hop = frame_length // 4 if hop is None else int(hop)
    if S is not None:
        S = as_tensor(S)
        if S.ndim < 2:
            raise ValueError("S must be (…, frames, bins)")
        mag2 = (torch.abs(S) if S.is_complex() else S.to(DTYPE)) ** 2
        n = 2 * (S.shape[-1] - 1)
        # Parseval: undo the one-sided fold, normalize by n²
        full = 2.0 * torch.sum(mag2, -1) - mag2[..., 0] - mag2[..., -1]
        return torch.sqrt(torch.clamp(full, min=0.0) / (n * n))
    frames = _centered_frames(x, frame_length, hop, "rms")
    return torch.sqrt(torch.mean(frames * frames, -1))


def _specaugment_masks(w: Tensor, s: Tensor, size: int) -> Tensor:
    """The keep-mask (…, size) of ``n_masks`` bands along one axis: band i
    covers [s_i, s_i + w_i); ``w``, ``s`` integer (…, n_masks, 1)."""
    grid = torch.arange(size, device=w.device)
    hit = (grid >= s) & (grid < s + w)  # (…, n_masks, size)
    return ~torch.any(hit, dim=-2)


def specaugment(
    S,
    generator: Optional[torch.Generator] = None,
    n_freq_masks: int = 2,
    freq_mask_width: int = 16,
    n_time_masks: int = 2,
    time_mask_width: int = 32,
    mask_value: float = 0.0,
):
    """SpecAugment masking (Park et al. 2019) on a spectrogram
    (…, frames, bins): ``n_freq_masks`` random bands of width up to
    ``freq_mask_width`` set to ``mask_value`` along frequency,
    ``n_time_masks`` along time.  ``generator`` (a ``torch.Generator`` on
    the spectrogram's device; default: a fresh one seeded 0) takes the JAX
    module's PRNG key's place; leading batch dims get independent masks.
    The widths are uniform integers in [0, width], the starts uniform in
    [0, size − width)."""
    S = as_tensor(S)
    if S.ndim < 2:
        raise ValueError("S must be (…, frames, bins)")
    if n_freq_masks < 0 or n_time_masks < 0:
        raise ValueError("mask counts must be >= 0")
    if freq_mask_width < 0 or time_mask_width < 0:
        raise ValueError("mask widths must be >= 0")
    if generator is None:
        generator = torch.Generator(device=S.device).manual_seed(0)
    T, F = S.shape[-2], S.shape[-1]
    batch = tuple(S.shape[:-2])

    def axis_mask(n_masks, width, size):
        if n_masks == 0 or width == 0:
            return torch.ones(batch + (size,), dtype=torch.bool, device=S.device)
        w = torch.randint(0, width + 1, batch + (n_masks, 1), generator=generator,
                          device=S.device)
        u = torch.rand(batch + (n_masks, 1), generator=generator, device=S.device)
        s = (u * torch.clamp(size - w, min=1).to(DTYPE)).to(torch.int64)
        return _specaugment_masks(w, s, size)

    fmask = axis_mask(n_freq_masks, freq_mask_width, F)
    tmask = axis_mask(n_time_masks, time_mask_width, T)
    keep = fmask[..., None, :] & tmask[..., :, None]
    return torch.where(keep, S, torch.full((), mask_value, dtype=S.dtype, device=S.device))


def chroma_filterbank(sr: float, n_fft: int, n_chroma: int = 12,
                      tuning: float = 0.0, ctroct: float = 5.0,
                      octwidth: float = 2.0) -> np.ndarray:
    """Chroma filterbank (n_chroma, n_fft//2+1) — librosa.filters.chroma
    conventions: Gaussian pitch-class bins on the log-frequency axis with
    a soft octave-centering envelope; lru-cached host fp64 constant (same
    pattern as the mel filterbank)."""
    if n_chroma < 2:
        raise ValueError(f"n_chroma must be >= 2, got {n_chroma}")
    return _chroma_filterbank_cached(
        float(sr), int(n_fft), int(n_chroma), float(tuning), float(ctroct),
        float(octwidth),
    )


@functools.lru_cache(maxsize=16)
def _chroma_filterbank_cached(sr: float, n_fft: int, n_chroma: int,
                              tuning: float, ctroct: float,
                              octwidth: float) -> np.ndarray:
    nb = n_fft // 2 + 1
    freqs = np.fft.rfftfreq(n_fft) * sr
    freqs = freqs[1:]  # DC has no pitch
    # fractional chroma bin of each frequency (A440 reference, C-based)
    frqbins = n_chroma * (np.log2(freqs / (440.0 / 16.0)) - tuning / n_chroma)
    # width: half a semitone in chroma-bin units (librosa binwidthbins)
    wts = np.zeros((n_chroma, nb))
    binwidth = np.concatenate([
        np.maximum(frqbins[1:] - frqbins[:-1], 1.0), [1.0]
    ])
    d = frqbins[None, :] - np.arange(n_chroma)[:, None]
    nc2 = round(n_chroma / 2)
    d = np.remainder(d + nc2 + 10 * n_chroma, n_chroma) - nc2
    w = np.exp(-0.5 * (2 * d / np.tile(binwidth, (n_chroma, 1))) ** 2)
    # normalize columns then apply the octave-weighting envelope
    w = w / np.maximum(np.sqrt(np.sum(w * w, axis=0, keepdims=True)), 1e-30)
    if octwidth:
        w *= np.exp(-0.5 * ((frqbins / n_chroma - ctroct) / octwidth) ** 2)
    wts[:, 1:] = w
    # the A440/16 reference puts A at row 0; roll 3 semitones so row 0 = C
    return np.roll(wts, -3 * (n_chroma // 12), axis=0)


def _max_normalized(c: Tensor) -> Tensor:
    peak = torch.amax(c, dim=-1, keepdim=True)
    return c / torch.clamp(peak, min=1e-30)


def chroma_stft(
    x=None, sr: float = 22050.0, nperseg: int = 2048,
    hop: Optional[int] = None, window="hann", S=None, n_chroma: int = 12,
    tuning: float = 0.0, power: float = 2.0,
    *, config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """Chromagram: (…, T) -> (…, frames, n_chroma), energy folded onto
    pitch classes (librosa.feature.chroma_stft shape conventions, max-
    normalized per frame) — one filterbank product on the power
    spectrogram."""
    hop = nperseg // 4 if hop is None else int(hop)
    p = _magspec(x, S, nperseg, hop, window, power, config)
    n_fft = 2 * (p.shape[-1] - 1)
    fbT = constant(lambda: chroma_filterbank(sr, n_fft, n_chroma, tuning).T, p, p.dtype,
                   key=("feature.chroma", float(sr), n_fft, int(n_chroma), float(tuning)))
    with fp32_matmul():
        c = p @ fbT
    return _max_normalized(c)


def onset_strength(
    x=None, sr: float = 22050.0, nperseg: int = 2048,
    hop: Optional[int] = None, n_mels: int = 128, S=None,
    *, config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """Spectral-flux onset envelope: (…, T) -> (…, frames) — positive
    first difference of the log-mel spectrogram, averaged over bands
    (librosa.onset.onset_strength's default recipe)."""
    from .mel import melspectrogram

    hop = nperseg // 4 if hop is None else int(hop)
    if S is None:
        S = melspectrogram(x, sr, n_fft=nperseg, hop=hop, n_mels=n_mels,
                           config=config)
    else:
        S = as_tensor(S)
        if S.ndim < 2:
            raise ValueError("S must be (…, frames, bands)")
    db = 10.0 * torch.log10(torch.clamp(S, min=1e-10))
    flux = torch.clamp(db[..., 1:, :] - db[..., :-1, :], min=0.0)
    env = torch.mean(flux, dim=-1)
    return pad_last(env, 1, 0)


def tempo(
    x=None, sr: float = 22050.0, nperseg: int = 2048,
    hop: Optional[int] = None, onset_env=None,
    start_bpm: float = 120.0, std_bpm: float = 1.0,
    max_bpm: float = 320.0, min_bpm: float = 24.0,
    *, config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """Global tempo estimate in BPM: (…, T) -> (…,) scalar per signal —
    the log-normal-weighted peak of the onset-envelope autocorrelation
    (librosa.beat.tempo's autocorrelation recipe), computed with one
    engine rfft/irfft round."""
    from .rfft import irfft as _irfft, rfft as _rfft

    hop = nperseg // 4 if hop is None else int(hop)
    env = (onset_strength(x, sr, nperseg, hop, config=config)
           if onset_env is None else as_tensor(onset_env).to(DTYPE))
    n = env.shape[-1]
    if n < 8:
        raise ValueError("onset envelope too short for a tempo estimate")
    env = env - torch.mean(env, dim=-1, keepdim=True)
    nfft = int(2 ** np.ceil(np.log2(2 * n)))
    spec = _rfft(pad_last(env, 0, nfft - n), config=config)
    ac = _irfft(spec * torch.conj(spec), n=nfft, config=config)[..., :n]
    # lag -> bpm grid (host): bpm = 60 / (lag · hop / sr)
    lags = np.arange(1, n)
    bpms = 60.0 * sr / (hop * lags)
    keep = (bpms >= min_bpm) & (bpms <= max_bpm)
    lags = lags[keep]
    bpms = bpms[keep]
    if lags.size == 0:
        raise ValueError("BPM window excludes every lag; widen the range")
    prior = np.exp(-0.5 * ((np.log2(bpms / start_bpm)) / std_bpm) ** 2)
    key = ("feature.tempo", n, float(sr), hop, float(start_bpm), float(std_bpm),
           float(min_bpm), float(max_bpm))
    lags_d = constant(lags, ac, torch.int64, key=key + ("lags",))
    score = ac[..., lags_d] * constant(prior, ac, ac.dtype, key=key + ("prior",))
    best = torch.argmax(score, dim=-1)
    return constant(bpms, ac, ac.dtype, key=key + ("bpms",))[best]


def delta(
    data,
    width: int = 9,
    order: int = 1,
    axis: int = -2,
    *, config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """Local-slope delta features (librosa.feature.delta semantics: a
    Savitzky-Golay derivative of the feature track along ``axis``,
    'interp' edges) — one static tap contraction via
    :func:`~..ops.signal.savgol_filter`."""
    from .signal import savgol_filter

    if width < 3 or width % 2 == 0:
        raise ValueError(f"width must be odd and >= 3, got {width}")
    if order < 1:
        raise ValueError(f"order must be >= 1, got {order}")
    # librosa: polyorder == deriv order (the least-squares local slope)
    return savgol_filter(
        data, width, polyorder=order, deriv=order, axis=axis, config=config,
    )


def beat_track(
    x=None, sr: float = 22050.0, nperseg: int = 2048,
    hop: Optional[int] = None, onset_env=None, bpm=None,
    tightness: float = 100.0, min_bpm: float = 24.0, max_bpm: float = 320.0,
    *, config: SpectralConfig = DEFAULT_CONFIG,
) -> tuple:
    """Dynamic-programming beat tracker (Ellis 2007;
    librosa.beat.beat_track's recipe): (…, T) -> (bpm, beat_mask) with
    ``beat_mask`` boolean per frame (frame m centered on sample m·hop).

    Score C[t] = O[t] + max_Δ [ C[t−Δ] − tightness·log²(Δ/p) ] runs as a
    forward loop over frames with a Δ-window buffer (the window covers
    2·p_max, so the tempo may be a tensor); the beat sequence follows the
    backpointers back from the best-scoring frame."""
    hop = nperseg // 4 if hop is None else int(hop)
    env = (onset_strength(x, sr, nperseg, hop, config=config)
           if onset_env is None else as_tensor(onset_env).to(DTYPE))
    if env.ndim != 1:
        raise ValueError("beat_track takes a single signal/envelope")
    n = env.shape[-1]
    if n < 8:
        raise ValueError("onset envelope too short to track beats")
    if bpm is None:
        bpm = tempo(onset_env=env, sr=sr, nperseg=nperseg, hop=hop,
                    start_bpm=120.0, min_bpm=min_bpm, max_bpm=max_bpm,
                    config=config)
    bpm = as_tensor(bpm, env.device)
    period = 60.0 * sr / (hop * torch.clamp(bpm, min=1e-3))  # frames
    env = env / torch.clamp(torch.std(env, correction=0), min=1e-10)
    D = int(min(np.ceil(2.0 * 60.0 * sr / (hop * min_bpm)), n - 1))
    deltas = torch.arange(1, D + 1, dtype=env.dtype, device=env.device)
    # transition penalty (a tensor in period, host-fixed in Δ)
    pen = -tightness * torch.log(deltas / period) ** 2  # (D,)
    neg = torch.full((), -1e9, dtype=env.dtype, device=env.device)
    zero = torch.zeros((), dtype=env.dtype, device=env.device)
    # buf[k] = C[t-1-k], k = 0..D-1; only scores from real frames count
    buf = torch.full((D,), -1e9, dtype=env.dtype, device=env.device)
    seen = torch.arange(D, device=env.device)
    scores, bps = [], []
    for t in range(n):
        cand = torch.where(seen < t, buf + pen, neg) if t < D else buf + pen
        best, arg = torch.max(cand, dim=0)
        score = env[t] + torch.maximum(best, zero)  # allow fresh starts
        bps.append(torch.where(best > 0.0, arg + 1, 0))  # Δ, 0 = start
        buf = torch.cat([score[None], buf[:-1]])
        scores.append(score)
    scores = torch.stack(scores)
    # walk back from the best frame: each beat's backpointer names the one
    # before it, and a 0 starts the sequence
    back = torch.stack(bps).cpu().numpy()
    cur = int(torch.argmax(scores))
    beats = []
    while cur >= 0:
        beats.append(cur)
        cur = cur - int(back[cur]) if back[cur] > 0 else -1
    mask = torch.zeros(n, dtype=torch.bool, device=env.device)
    mask[torch.tensor(beats, device=env.device)] = True
    # silence gate: with a flat-zero envelope every DP score is 0 and the
    # backtrace would emit a phantom beat at frame 0
    return bpm, mask & (torch.max(scores) > 1e-6)


def _decompose_from(S: Tensor, A: Tensor, C: Tensor, n_iter: int, eps: float):
    """Lee-Seung multiplicative updates from the initial factors (A, C)."""
    with fp32_matmul():
        for _ in range(n_iter):
            A = A * (S @ C.T) / (A @ (C @ C.T) + eps)
            C = C * (A.T @ S) / ((A.T @ A) @ C + eps)
    return A, C


def decompose(
    S,
    n_components: int = 8,
    n_iter: int = 200,
    generator: Optional[torch.Generator] = None,
    eps: float = 1e-10,
    *, config: SpectralConfig = DEFAULT_CONFIG,
):
    """Nonnegative matrix factorization of a spectrogram
    (librosa.decompose.decompose's role): S (frames, bins) ≈
    activations (frames, k) @ components (k, bins), both nonnegative.

    Lee-Seung multiplicative updates for the Euclidean objective — a loop
    of six fp32 products per iteration (TF32 off).  ``generator`` (a
    ``torch.Generator`` on S's device; default: a fresh one seeded 0) seeds
    the nonnegative initialisation, uniform in [0.1, 1) times
    sqrt(mean(S)/k + eps)."""
    S = as_tensor(S)
    if S.ndim != 2:
        raise ValueError("decompose takes a single (frames, bins) matrix")
    if S.is_complex():
        raise ValueError("decompose takes a magnitude/power spectrogram")
    if n_components < 1 or n_iter < 0:
        raise ValueError("need n_components >= 1 and n_iter >= 0")
    S = S.to(DTYPE)
    F, B = S.shape
    k = n_components
    if generator is None:
        generator = torch.Generator(device=S.device).manual_seed(0)
    scale = torch.sqrt(torch.mean(S) / k + eps)
    draw = lambda *shape: 0.1 + 0.9 * torch.rand(shape, generator=generator, device=S.device)
    A = scale * draw(F, k)
    C = scale * draw(k, B)
    return _decompose_from(S, A, C, n_iter, eps)


def _frame_loud(x: np.ndarray, top_db: float, frame_length: int,
                hop: int) -> np.ndarray:
    """Host per-frame loudness mask: frame RMS STRICTLY above the
    peak-relative threshold (so an all-zero signal is all-silent, the
    librosa convention)."""
    x = np.asarray(x, np.float64)
    n = x.shape[-1]
    if n < frame_length:
        x = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, frame_length - n)])
        n = frame_length
    n_frames = 1 + (n - frame_length) // hop
    idx = np.arange(n_frames)[:, None] * hop + np.arange(frame_length)
    frames = x[..., idx]
    rms_ = np.sqrt(np.mean(frames * frames, axis=-1))
    return rms_ > rms_.max() * 10.0 ** (-top_db / 20.0)


def trim(x, top_db: float = 60.0, frame_length: int = 2048,
         hop: int = 512):
    """Trim leading/trailing silence (librosa.effects.trim): returns
    ``(trimmed, (start, end))`` sample indices.  HOST function (numpy in,
    numpy out) — the output length is data-dependent; use it in the input
    pipeline."""
    x = np.asarray(x)
    if x.ndim != 1:
        raise ValueError("trim takes a single 1-D signal")
    if top_db <= 0:
        raise ValueError(f"top_db must be > 0, got {top_db}")
    loud = np.where(_frame_loud(x, top_db, frame_length, hop))[0]
    if loud.size == 0:
        return x[:0], (0, 0)
    start = int(loud[0] * hop)
    # the last loud frame covers [loud[-1]·hop, loud[-1]·hop + frame_length)
    end = int(min(loud[-1] * hop + frame_length, x.shape[-1]))
    return x[start:end], (start, end)


def split(x, top_db: float = 60.0, frame_length: int = 2048,
          hop: int = 512) -> np.ndarray:
    """Split on silence (librosa.effects.split): (n_intervals, 2) array of
    non-overlapping [start, end) sample indices of non-silent runs.
    HOST function — see :func:`trim`."""
    x = np.asarray(x)
    if x.ndim != 1:
        raise ValueError("split takes a single 1-D signal")
    if top_db <= 0:
        raise ValueError(f"top_db must be > 0, got {top_db}")
    loud = _frame_loud(x, top_db, frame_length, hop)
    padded = np.concatenate([[False], loud, [False]])
    d = np.diff(padded.astype(np.int8))
    run_starts = np.flatnonzero(d == 1)
    run_ends = np.flatnonzero(d == -1)  # one past the last loud frame
    out = []
    for i, (s, e) in enumerate(zip(run_starts, run_ends)):
        end = min((e - 1) * hop + frame_length, x.shape[-1])
        if i + 1 < len(run_starts):  # short gaps must not overlap the next run
            end = min(end, run_starts[i + 1] * hop)
        out.append([int(s * hop), int(end)])
    return np.asarray(out, np.int64).reshape(-1, 2)


def mu_law_encode(x, quantization_channels: int = 256) -> Tensor:
    """μ-law companding to integer classes (the conventions of PyTorch's
    audio package):
    float in [−1, 1] -> int32 in [0, Q−1]."""
    q = int(quantization_channels)
    if q < 2:
        raise ValueError(f"quantization_channels must be >= 2, got {q}")
    x = torch.clamp(as_tensor(x).to(DTYPE), -1.0, 1.0)
    mu = q - 1.0
    y = torch.sign(x) * torch.log1p(mu * torch.abs(x)) / np.log1p(mu)
    return ((y + 1.0) / 2.0 * mu + 0.5).to(torch.int32)


def mu_law_decode(y, quantization_channels: int = 256) -> Tensor:
    """Inverse of :func:`mu_law_encode`: classes -> float in [−1, 1]."""
    q = int(quantization_channels)
    if q < 2:
        raise ValueError(f"quantization_channels must be >= 2, got {q}")
    mu = q - 1.0
    yf = as_tensor(y).to(DTYPE) * 2.0 / mu - 1.0
    return torch.sign(yf) * (torch.expm1(torch.abs(yf) * np.log1p(mu))) / mu


def power_to_db(S, ref=1.0, amin: float = 1e-10,
                top_db: Optional[float] = 80.0) -> Tensor:
    """Power -> decibels, 10·log10(S/ref), floored ``top_db`` below the
    per-array peak (librosa.power_to_db; ``ref`` a scalar or 'max')."""
    S = as_tensor(S)
    if amin <= 0:
        raise ValueError(f"amin must be > 0, got {amin}")
    if top_db is not None and top_db < 0:
        raise ValueError(f"top_db must be >= 0, got {top_db}")
    # librosa warns and proceeds on |S| for complex input
    S = torch.abs(S) if S.is_complex() else S.to(DTYPE)
    mag = torch.clamp(S, min=amin)
    if isinstance(ref, str):
        if ref != "max":
            raise ValueError(f"ref must be a scalar or 'max', got {ref!r}")
        refv = torch.clamp(torch.max(mag), min=amin)
    else:
        refv = torch.clamp(torch.full((), abs(ref), dtype=mag.dtype, device=mag.device), min=amin)
    db = 10.0 * (torch.log10(mag) - torch.log10(refv))
    if top_db is not None:
        db = torch.maximum(db, torch.max(db) - top_db)
    return db


def db_to_power(db, ref: float = 1.0) -> Tensor:
    """Inverse of :func:`power_to_db`: ref·10^(db/10)."""
    db = as_tensor(db).to(DTYPE)
    return ref * torch.pow(10.0, db / 10.0)


def amplitude_to_db(S, ref=1.0, amin: float = 1e-5,
                    top_db: Optional[float] = 80.0) -> Tensor:
    """Amplitude -> decibels: power_to_db on |S|² with matched refs
    (librosa.amplitude_to_db)."""
    S = as_tensor(S)
    mag = torch.abs(S) if S.is_complex() else S.to(DTYPE)
    refv = ref if isinstance(ref, str) else abs(ref) ** 2
    return power_to_db(mag * mag, ref=refv, amin=amin * amin, top_db=top_db)


def db_to_amplitude(db, ref: float = 1.0) -> Tensor:
    """Inverse of :func:`amplitude_to_db`: ref·10^(db/20)."""
    db = as_tensor(db).to(DTYPE)
    return ref * torch.pow(10.0, db / 20.0)


def lpc(y, order: int, axis: int = -1) -> Tensor:
    """Linear prediction coefficients via Burg's method (librosa.lpc
    conventions): (…, N) -> (…, order+1) with ``a[0] = 1``, minimizing the
    summed forward+backward prediction error.  The all-pole spectral
    envelope is ``1/|A(e^{jw})|²`` (evaluate with :func:`freqz`).

    ``order`` is a host integer and small, so the Burg recursion is a
    Python loop of batched elementwise work over the signal axis (two
    AXPYs + three reductions a step); there is no per-sample sequential
    scan.  A zero signal returns a[1:] = 0 instead of raising (librosa
    propagates a FloatingPointError from the 0/0)."""
    y = as_tensor(y)
    if y.is_complex():
        raise ValueError("lpc takes real signals")
    order = int(order)
    if order < 1:
        raise ValueError(f"order must be >= 1, got {order}")
    y = torch.movedim(y, axis, -1).to(DTYPE)
    n = y.shape[-1]
    if n <= order:
        raise ValueError(f"signal length {n} must exceed order {order}")
    tiny = float(np.finfo(np.float32).tiny)
    fwd = y[..., 1:]
    bwd = y[..., :-1]
    den = torch.sum(fwd * fwd, -1) + torch.sum(bwd * bwd, -1)
    ar = torch.cat([torch.ones_like(y[..., :1]), y.new_zeros(y.shape[:-1] + (order,))], -1)
    for i in range(order):
        reflect = -2.0 * torch.sum(bwd * fwd, -1) / torch.clamp(den, min=tiny)
        # a_new[j] = a[j] + k·a[i+1−j] over the active head j = 0..i+1
        # (a[0] stays 1 because a[i+1] is still 0 on entry)
        head = ar[..., : i + 2]
        ar = torch.cat(
            [head + reflect[..., None] * torch.flip(head, (-1,)), ar[..., i + 2:]],
            dim=-1,
        )
        fwd_prev = fwd
        fwd = fwd + reflect[..., None] * bwd
        bwd = bwd + reflect[..., None] * fwd_prev
        den = (1.0 - reflect * reflect) * den \
            - fwd[..., 0] ** 2 - bwd[..., -1] ** 2
        fwd = fwd[..., 1:]
        bwd = bwd[..., :-1]
    return ar


def chroma_cqt(
    x, sr: float = 22050.0, hop: int = 512, n_chroma: int = 12,
    n_octaves: int = 6, fmin: float = 32.703195662574764,
    bins_per_octave: int = 36,
    *, config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """Constant-Q chromagram (librosa.feature.chroma_cqt's recipe):
    (…, T) -> (…, frames, n_chroma) — CQT magnitudes folded onto pitch
    classes (bin k of B-per-octave maps to class (k·n_chroma/B) mod
    n_chroma; with B a multiple of n_chroma the fold is an exact one-hot
    product).  Sharper pitch-class profiles than the STFT chroma at low
    frequencies (the CQT ladder is log-spaced)."""
    from .cqt import cqt as _cqt

    if n_chroma < 2 or n_octaves < 1:
        raise ValueError("need n_chroma >= 2 and n_octaves >= 1")
    if bins_per_octave % n_chroma:
        raise ValueError(
            f"bins_per_octave ({bins_per_octave}) must be a multiple of "
            f"n_chroma ({n_chroma})"
        )
    n_bins = n_octaves * bins_per_octave
    C = torch.abs(_cqt(x, fs=sr, fmin=fmin, n_bins=n_bins,
                       bins_per_octave=bins_per_octave, hop=hop,
                       config=config))

    def fold() -> np.ndarray:
        cls = (np.arange(n_bins) * n_chroma // bins_per_octave) % n_chroma
        # librosa cq_to_chroma (base_c): roll so class 0 is always C, whatever
        # pitch class fmin sits on — midi(f) = 12·log2(f/440) + 69
        midi_fmin = 12.0 * np.log2(fmin / 440.0) + 69.0
        cls = (cls + int(round((midi_fmin % 12.0) * n_chroma / 12.0))) % n_chroma
        return cls[:, None] == np.arange(n_chroma)[None, :]

    onehot = constant(fold, C, C.dtype,
                      key=("feature.chroma_cqt", n_bins, int(n_chroma), int(bins_per_octave), float(fmin)))
    with fp32_matmul():
        ch = C @ onehot
    return _max_normalized(ch)


def tonnetz(
    x=None, sr: float = 22050.0, chroma=None,
    *, config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """Tonal centroid features (Harte et al. 2006;
    librosa.feature.tonnetz): project an L1-normalized chromagram onto
    the 6-D circle-of-fifths / minor-third / major-third basis —
    (…, frames, 12) -> (…, frames, 6), one product."""
    if chroma is None:
        chroma = chroma_cqt(x, sr, config=config)
    c = as_tensor(chroma).to(DTYPE)
    if c.ndim < 2 or c.shape[-1] != 12:
        raise ValueError("chroma must be (…, frames, 12)")

    def basis() -> np.ndarray:
        d = np.arange(12)
        # Harte et al. 2006 radii R = [1, 1, 1, 1, 0.5, 0.5]: fifths and minor
        # thirds at radius 1, the major-third circle at radius 0.5
        r = np.array([1.0, 1.0, 0.5])
        return np.stack([
            r[0] * np.sin(d * 7 * np.pi / 6), r[0] * np.cos(d * 7 * np.pi / 6),
            r[1] * np.sin(d * 3 * np.pi / 2), r[1] * np.cos(d * 3 * np.pi / 2),
            r[2] * np.sin(d * 2 * np.pi / 3), r[2] * np.cos(d * 2 * np.pi / 3),
        ]).T  # (12, 6)

    norm = torch.clamp(torch.sum(torch.abs(c), -1, keepdim=True), min=1e-30)
    with fp32_matmul():
        return (c / norm) @ constant(basis, c, c.dtype, key=("feature.tonnetz",))


def gcc_phat(
    x, y, max_lag: Optional[int] = None, interp: bool = True,
    *, config: SpectralConfig = DEFAULT_CONFIG,
):
    """Generalized cross-correlation with phase transform (GCC-PHAT):
    estimate the delay of ``y`` relative to ``x`` in (fractional)
    samples — the standard TDOA estimator, robust to reverberation
    because only PHASE information survives the |X·Y*| whitening.

    Returns ``(lag, cc)``: the (…,) delay estimate and the whitened
    cross-correlation (…, 2·max_lag+1) on the lag grid
    −max_lag..max_lag.  One engine rfft/irfft round; the peak pick and
    parabolic refinement are argmax/gather on the device."""
    from .rfft import irfft as _irfft, rfft as _rfft

    x, y = as_tensors(x, y)
    if x.shape[-1] != y.shape[-1]:
        raise ValueError("x and y must share the last-axis length")
    if x.is_complex() or y.is_complex():
        raise ValueError("gcc_phat takes real signals")
    n = x.shape[-1]
    if max_lag is None:
        max_lag = n // 2 - 1
    max_lag = int(max_lag)
    if not 1 <= max_lag < n:
        raise ValueError(f"need 1 <= max_lag < {n}, got {max_lag}")
    nfft = int(2 ** np.ceil(np.log2(2 * n)))
    X = _rfft(pad_last(x.to(DTYPE), 0, nfft - n), config=config)
    Y = _rfft(pad_last(y.to(DTYPE), 0, nfft - n), config=config)
    S = Y * torch.conj(X)
    S = S / torch.clamp(torch.abs(S), min=1e-12)
    cc_full = _irfft(S, n=nfft, config=config)
    # lags -max_lag..max_lag via the circular layout
    cc = torch.cat([cc_full[..., nfft - max_lag:], cc_full[..., : max_lag + 1]], dim=-1)
    k = torch.argmax(cc, dim=-1)
    if not interp:
        return k.to(cc.dtype) - max_lag, cc
    km = torch.clamp(k, 1, 2 * max_lag - 1)
    p0 = torch.take_along_dim(cc, km[..., None] - 1, -1)[..., 0]
    p1 = torch.take_along_dim(cc, km[..., None], -1)[..., 0]
    p2 = torch.take_along_dim(cc, km[..., None] + 1, -1)[..., 0]
    denom = p0 + p2 - 2.0 * p1
    shift = torch.where(torch.abs(denom) > 1e-12, 0.5 * (p0 - p2) / denom,
                        torch.zeros_like(denom))
    # a peak AT ±max_lag has no valid 3-point neighborhood: the fit
    # around the clipped center biases the lag, so return the integer
    shift = torch.where(k == km, torch.clamp(shift, -0.5, 0.5), torch.zeros_like(shift))
    return k.to(cc.dtype) + shift - max_lag, cc
