"""Signal-analysis ops on top of the engine: spectral estimation (hilbert,
periodogram, welch, csd, multitaper, Lomb-Scargle, cepstra, envelope), FIR
filter design on the host, and resampling (upfirdn, resample_poly,
resample, decimate).

Counterpart of ``mixed_radix_fast_fourier_transform_tpu/ops/signal.py``, the
scipy.signal family: batched, built on the plan-based FFT/rFFT/STFT
machinery.  Every transform goes through the engine.  The filter designs
(``firwin``, ``firwin2``, ``firls``, ``remez``, ``savgol_coeffs``,
``gammatone``, ``max_len_seq``, …) are numpy float64 on the host, the JAX
module's line for line, so their taps are bit-equal.  Dense products (the
polyphase taps of ``upfirdn``, ``goertzel``, ``lombscargle``,
``freqz`` at given frequencies) are fp32 matmuls with TF32 off.  Host tables
that depend only on hashable arguments are kept on the device
(``utils.numerics.constant``).
"""

from __future__ import annotations

import math

from typing import Optional, Tuple

import numpy as np
import torch

from ..utils.config import DEFAULT_CONFIG, DTYPE, SpectralConfig
from ..utils.numerics import (
    as_tensor, as_tensors, constant, content_key, fp32_matmul, median, pad_last, resolve_device,
    working,
)
from .fft import fft, fft2, fftshift, ifft, ifft2, rfftfreq
from .rfft import irfft, rfft
from .stft import _frame, _window_on, dpss, get_window

Tensor = torch.Tensor
_CDTYPE = torch.complex64


def _real_last(x, axis: int, what: str):
    """(x with ``axis`` moved last as fp32, axis >= 0); complex input raises."""
    x = as_tensor(x)
    if x.is_complex():
        raise ValueError(what)
    axis = axis % x.ndim
    return torch.movedim(x, axis, -1).to(DTYPE), axis


def spectral_diff(
    x,
    order: int = 1,
    period: float = 2.0 * np.pi,
    axis: int = -1,
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """Spectral derivative of a periodic real signal: d^order/dz^order via
    (i·k)^order multiplication in frequency space, the PDE-toolbox primitive
    (exponentially accurate for smooth periodic data).  ``period`` is the
    domain length the samples cover."""
    if order < 1:
        raise ValueError(f"order must be >= 1, got {order}")
    xm, axis = _real_last(x, axis, "spectral_diff expects a real signal")
    n = xm.shape[-1]
    spec = rfft(xm, config=config)

    def mult() -> np.ndarray:
        k = 2.0 * np.pi * np.arange(n // 2 + 1, dtype=np.float64) / period
        m = (1j * k) ** order
        if order % 2 == 1 and n % 2 == 0:
            m[-1] = 0.0  # odd derivative of the Nyquist mode is ill-defined
        return m

    multd = constant(mult, xm, _CDTYPE, key=("spectral_diff", n, order, float(period)))
    out = irfft(spec * multd, n=n, config=config)
    return torch.movedim(out, -1, axis)


def _analytic_step(m: int, nyquist: bool) -> np.ndarray:
    """One-sided spectral step: DC kept, positive bins doubled, the Nyquist
    bin of an even length kept (1-D hilbert) or zeroed (hilbert2)."""
    h = np.zeros(m)
    h[0] = 1.0
    h[1: (m + 1) // 2] = 2.0
    if nyquist and m % 2 == 0:
        h[m // 2] = 1.0
    return h


def hilbert(x, n: Optional[int] = None, axis: int = -1,
            *, config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    """Analytic signal via the Hilbert transform: real (..., N) -> complex
    whose real part is x and imaginary part its Hilbert transform
    (scipy.signal.hilbert semantics)."""
    xm, axis = _real_last(x, axis, "hilbert requires a real signal")
    n = int(n) if n is not None else xm.shape[-1]
    spec = fft(xm, n=n, config=config)
    h = constant(lambda: _analytic_step(n, True), xm, key=("hilbert", n))
    out = ifft(spec * h, config=config)
    return torch.movedim(out, -1, axis)


def hilbert2(x, n=None, *, config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    """2-D analytic signal over the LAST TWO axes
    (scipy.signal.hilbert2 semantics, batched): real (…, H, W) -> complex,
    single-orthant spectrum (Hahn 1992): per axis, DC kept, strictly
    positive bins doubled, negative AND Nyquist bins zeroed, matching
    scipy >= 1.17 exactly.  Note Re(result) ≠ x in general (unlike 1-D
    :func:`hilbert`); that is a property of the single-orthant
    definition, not an error."""
    x = as_tensor(x)
    if x.is_complex():
        raise ValueError("hilbert2 requires a real signal")
    if x.ndim < 2:
        raise ValueError("hilbert2 needs at least 2 dimensions")
    if n is None:
        ns = (x.shape[-2], x.shape[-1])
    else:
        ns = (int(n), int(n)) if np.ndim(n) == 0 else tuple(int(v) for v in n)
        if len(ns) != 2 or min(ns) < 1:
            raise ValueError(f"n must be a positive int or pair, got {n}")
    spec = fft2(x.to(DTYPE), s=ns, config=config)
    h2d = constant(
        lambda: np.outer(_analytic_step(ns[0], False), _analytic_step(ns[1], False)),
        x, key=("hilbert2", ns))
    return ifft2(spec * h2d, config=config)


def _onesided_doubling(nfft: int, like: Tensor) -> Tensor:
    """One-sided PSD factor: 2 everywhere but DC (and Nyquist for even nfft)."""
    def mult() -> np.ndarray:
        m = np.full(nfft // 2 + 1, 2.0)
        m[0] = 1.0
        if nfft % 2 == 0:
            m[-1] = 1.0
        return m

    return constant(mult, like, key=("onesided2", nfft))


def periodogram(
    x,
    fs: float = 1.0,
    window: str = "boxcar",
    nfft: Optional[int] = None,
    detrend="constant",
    scaling: str = "density",
    axis: int = -1,
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tuple[Tensor, Tensor]:
    """(freqs, PSD) of a real signal: scipy.signal.periodogram semantics.
    ``detrend``: 'constant' (default; True is accepted as an alias),
    'linear', or False."""
    x = as_tensor(x)
    axis = axis % x.ndim
    xm = torch.movedim(x, axis, -1).to(DTYPE)
    n = xm.shape[-1]
    xm = _detrend_frames(xm, detrend)
    w_host = get_window(window, n, np.float64)  # host copy: scalar sums
    xm = xm * _window_on(window, n, xm)
    nfft = int(nfft) if nfft is not None else n
    spec = rfft(xm, n=nfft, config=config)
    p = spec.real ** 2 + spec.imag ** 2
    wsum2 = float(np.sum(w_host ** 2))
    wsum = float(np.sum(w_host))
    if scaling == "density":
        p = p / (fs * wsum2)
    elif scaling == "spectrum":
        p = p / (wsum ** 2)
    else:
        raise ValueError(f"scaling must be 'density' or 'spectrum', got {scaling!r}")
    p = p * _onesided_doubling(nfft, p)
    freqs = rfftfreq(nfft, 1.0 / fs, device=p.device)
    return freqs, torch.movedim(p, -1, axis)


def _cap_nperseg(t: int, nperseg: int, noverlap: Optional[int]):
    """scipy.signal semantics: nperseg longer than the signal is capped to
    the signal length (scipy warns; here the metrics logger notes it), and
    the default noverlap tracks the capped value."""
    if nperseg > t:
        from ..utils.metrics import logger

        logger.info("nperseg=%d > signal length %d; capping", nperseg, t)
        nperseg = t
        if noverlap is not None and noverlap >= nperseg:
            noverlap = nperseg // 2
    if noverlap is None:
        noverlap = nperseg // 2
    return nperseg, noverlap


def _detrend_frames(frames: Tensor, detrend) -> Tensor:
    """Per-segment detrend (scipy conventions): 'constant' removes the
    mean, 'linear' the least-squares line, False/None nothing."""
    if detrend in (False, None):
        return frames
    mean = torch.mean(frames, dim=-1, keepdim=True)
    if detrend == "constant" or detrend is True:
        return frames - mean
    if detrend == "linear":
        n = frames.shape[-1]
        tt = np.arange(n, dtype=np.float64) - (n - 1) / 2.0  # centered
        ttd = constant(tt, frames, key=("signal.centered_ramp", n))
        denom = float(np.sum(tt * tt)) or 1.0
        slope = torch.sum(frames * ttd, dim=-1, keepdim=True) / denom
        return frames - mean - slope * ttd
    raise ValueError(
        f"detrend must be 'constant', 'linear', or False; got {detrend!r}"
    )


def _welch_spectra(x: Tensor, nperseg, noverlap, window, config, detrend="constant"):
    """Windowed segment spectra with scipy's Welch conventions: a partial
    tail frame is DROPPED (never zero-padded: padding biases the averaged
    PSD low) and the detrend is applied PER SEGMENT, not to the whole
    signal (scipy.signal.welch's detrend= semantics)."""
    t = x.shape[-1]
    if not 0 <= noverlap < nperseg:
        raise ValueError(f"need 0 <= noverlap < nperseg, got {noverlap}")
    if t < nperseg:
        raise ValueError(f"signal length {t} < nperseg {nperseg}")
    hop = nperseg - noverlap
    n_frames = 1 + (t - nperseg) // hop
    frames = _frame(x[..., : nperseg + (n_frames - 1) * hop], nperseg, hop)
    frames = _detrend_frames(frames, detrend)
    return rfft(frames * _window_on(window, nperseg, x), config=config)


def _median_bias(n: int) -> float:
    """Bias of the median of n periodogram samples relative to the mean
    (scipy.signal._spectral_py._median_bias)."""
    ii_2 = 2.0 * np.arange(1.0, (n - 1) // 2 + 1)
    return float(1.0 + np.sum(1.0 / (ii_2 + 1.0) - 1.0 / ii_2))


def _onesided_scale(nperseg: int, fs: float, window, scaling: str) -> np.ndarray:
    w = np.asarray(get_window(window, nperseg, np.float64))
    if scaling == "density":
        base = 1.0 / (fs * float(np.sum(w ** 2)))
    elif scaling == "spectrum":
        base = 1.0 / (float(np.sum(w)) ** 2)
    else:
        raise ValueError(f"scaling must be 'density' or 'spectrum', got {scaling!r}")
    mult = np.full(nperseg // 2 + 1, 2.0 * base)
    mult[0] = base
    if nperseg % 2 == 0:
        mult[-1] = base
    return mult


def csd(
    x,
    y,
    fs: float = 1.0,
    window: str = "hann",
    nperseg: int = 256,
    noverlap: Optional[int] = None,
    scaling: str = "density",
    detrend="constant",
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tuple[Tensor, Tensor]:
    """Cross spectral density P_xy via Welch averaging
    (scipy.signal.csd semantics: conj(X)·Y, mean over segments)."""
    x, y = as_tensors(x, y)
    nperseg, noverlap = _cap_nperseg(min(x.shape[-1], y.shape[-1]), nperseg, noverlap)
    sx = _welch_spectra(x.to(DTYPE), nperseg, noverlap, window, config, detrend)
    sy = _welch_spectra(y.to(DTYPE), nperseg, noverlap, window, config, detrend)
    pxy = torch.mean(torch.conj(sx) * sy, dim=-2)
    named = isinstance(window, (str, tuple))
    mult = constant(lambda: _onesided_scale(nperseg, fs, window, scaling), x, key=(
        "signal.onesided_scale", nperseg, float(fs), window, scaling) if named else None)
    freqs = rfftfreq(nperseg, 1.0 / fs, device=pxy.device)
    return freqs, pxy * mult


def coherence(
    x,
    y,
    fs: float = 1.0,
    window: str = "hann",
    nperseg: int = 256,
    noverlap: Optional[int] = None,
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tuple[Tensor, Tensor]:
    """Magnitude-squared coherence C_xy = |P_xy|² / (P_xx · P_yy)."""
    x, y = as_tensors(x, y)
    f, pxy = csd(x, y, fs, window, nperseg, noverlap, config=config)
    _, pxx = welch(x, fs, window, nperseg, noverlap, config=config)
    _, pyy = welch(y, fs, window, nperseg, noverlap, config=config)
    mag2 = pxy.real ** 2 + pxy.imag ** 2
    denom = torch.clamp(pxx * pyy, min=1e-30)
    return f, mag2 / denom


def tfestimate(
    x,
    y,
    fs: float = 1.0,
    window: str = "hann",
    nperseg: int = 256,
    noverlap: Optional[int] = None,
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tuple[Tensor, Tensor]:
    """H1 transfer-function estimate (MATLAB ``tfestimate``):
    ``H(f) = P_xy / P_xx`` with P_xy this library's :func:`csd` convention
    (conjugate on x), so for y = h * x + noise the estimate converges to
    the frequency response of ``h``.  Welch-averaged; returns
    ``(freqs, H)`` with H complex at the one-sided welch bins."""
    x, y = as_tensors(x, y)
    f, pxy = csd(x, y, fs, window, nperseg, noverlap, config=config)
    _, pxx = welch(x, fs, window, nperseg, noverlap, config=config)
    return f, pxy / torch.clamp(pxx, min=1e-30)


def welch(
    x,
    fs: float = 1.0,
    window: str = "hann",
    nperseg: int = 256,
    noverlap: Optional[int] = None,
    scaling: str = "density",
    axis: int = -1,
    detrend="constant",
    average: str = "mean",
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tuple[Tensor, Tensor]:
    """Welch PSD estimate: averaged modified periodograms over overlapping
    segments (scipy.signal.welch semantics).  ``average``: 'mean' or
    'median' (bias-corrected, robust to burst interference);
    ``detrend``: 'constant', 'linear', or False, applied per segment."""
    x = as_tensor(x)
    if average not in ("mean", "median"):
        raise ValueError(f"average must be 'mean' or 'median', got {average!r}")
    axis = axis % x.ndim
    xm = torch.movedim(x, axis, -1).to(DTYPE)
    nperseg, noverlap = _cap_nperseg(xm.shape[-1], nperseg, noverlap)
    spec = _welch_spectra(xm, nperseg, noverlap, window, config,
                          detrend)  # (..., frames, bins)
    p = spec.real ** 2 + spec.imag ** 2
    w = np.asarray(get_window(window, nperseg, np.float64))
    if scaling == "density":
        p = p / (fs * float(np.sum(w ** 2)))
    elif scaling == "spectrum":
        p = p / (float(np.sum(w)) ** 2)
    else:
        raise ValueError(f"scaling must be 'density' or 'spectrum', got {scaling!r}")
    if average == "median":
        # the mean of the two middle periodograms for an even count
        p = median(p, dim=-2) / _median_bias(p.shape[-2])
    else:
        p = torch.mean(p, dim=-2)
    p = p * _onesided_doubling(nperseg, p)
    freqs = rfftfreq(nperseg, 1.0 / fs, device=p.device)
    return freqs, torch.movedim(p, -1, axis)


def _resample_window(window, n_x: int) -> np.ndarray:
    """Spectral window for resample, in fftfreq bin order (host numpy)."""
    if callable(window):
        return np.asarray(window(np.fft.fftfreq(n_x)), dtype=np.float64)
    if hasattr(window, "shape") or isinstance(window, (list, tuple)) and all(
        isinstance(v, (int, float)) for v in window
    ):
        w = np.asarray(window, dtype=np.float64)
        if w.shape != (n_x,):
            raise ValueError(
                f"window length {w.shape} != number of frequency bins ({n_x},)"
            )
        return w
    return np.fft.fftshift(np.asarray(get_window(window, n_x, np.float64)))


def resample(
    x,
    num: int,
    axis: int = -1,
    window=None,
    domain: str = "time",
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """Fourier-method resampling to ``num`` samples along ``axis``
    (scipy.signal.resample semantics: ideal low-pass via spectrum
    truncation / zero-padding, with the unpaired Nyquist bin united on
    down-sampling and split on up-sampling).

    ``window`` is an optional spectral window: a string/tuple for
    :func:`get_window`, an array of length ``x.shape[axis]`` in fftfreq bin
    order, or a callable of the fftfreq grid.  ``domain='freq'`` treats ``x``
    as an already-computed two-sided spectrum.  All bin bookkeeping is host
    numpy.
    """
    if domain not in ("time", "freq"):
        raise ValueError(f"domain must be 'time' or 'freq', got {domain!r}")
    x = as_tensor(x)
    num = int(num)
    if num < 1:
        raise ValueError(f"num must be >= 1, got {num}")
    axis = axis % x.ndim
    xm = torch.movedim(x, axis, -1)
    n_x = xm.shape[-1]
    s_fac = n_x / num
    m = min(num, n_x)
    m2 = m // 2 + 1
    w = None if window is None else _resample_window(window, n_x)
    named = window is None or isinstance(window, (str, tuple))

    if domain == "time" and not x.is_complex():
        spec = rfft(xm.to(DTYPE), config=config)
        n_bins = n_x // 2 + 1

        def mult() -> np.ndarray:
            # one-sided multiplier: folded window, Nyquist pairing, 1/s_fac
            mu = np.ones(m2, np.float64)
            if w is not None:
                folded = w[:n_bins].copy()
                folded[1:] = (folded[1:] + w[:-n_bins:-1]) / 2.0
                mu *= folded[:m2]
            if m % 2 == 0 and num != n_x:
                mu[m // 2] *= 2.0 if num < n_x else 0.5
            return mu / s_fac

        spec = spec[..., :m2] * constant(
            mult, xm, key=("resample.mult", n_x, num, window) if named else None)
        out = irfft(spec, n=num, config=config)
    else:
        spec = xm.to(_CDTYPE) if domain == "freq" else fft(xm.to(_CDTYPE), config=config)
        if w is not None:
            spec = spec * constant(
                w, spec.real, key=("resample.window", n_x, window) if named else None)
        spec = spec / float(s_fac)
        pos = spec[..., :m2]
        n_neg = m - m2  # negative-frequency bins to keep
        neg = spec[..., n_x - n_neg:] if n_neg else spec[..., :0]
        zshape = pos.shape[:-1]
        if m % 2 == 0 and num < n_x:
            # down-sampling: unite the Nyquist pair into one unpaired bin
            pos = torch.cat(
                [pos[..., :-1], pos[..., -1:] + spec[..., n_x - m // 2: n_x - m // 2 + 1]],
                dim=-1)
        if m % 2 == 0 and n_x < num:
            # up-sampling: split the unpaired bin into a conjugate pair
            half = pos[..., -1:] / 2.0
            zeros = spec.new_zeros(*zshape, num - m - 1)
            y = torch.cat([pos[..., :-1], half, zeros, half, neg], dim=-1)
        else:
            zeros = spec.new_zeros(*zshape, num - m)
            y = torch.cat([pos, zeros, neg], dim=-1)
        out = ifft(y, config=config)
    return torch.movedim(out, -1, axis)


def multitaper(
    x,
    fs: float = 1.0,
    nw: float = 4.0,
    k: Optional[int] = None,
    nfft: Optional[int] = None,
    detrend="constant",
    scaling: str = "density",
    weighting: str = "eigen",
    axis: int = -1,
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tuple[Tensor, Tensor]:
    """(freqs, PSD) by Thomson's multitaper method: average the
    eigenspectra of the ``k`` best-concentrated DPSS tapers
    (time-halfbandwidth ``nw``; default k = 2·nw − 1).  Low-variance,
    low-leakage PSD from a SINGLE record, the standard alternative to
    Welch when the signal cannot be segmented.

    ``weighting``: 'eigen' weights each eigenspectrum by its concentration
    ratio λ_k (Percival & Walden eq. 370a); 'unity' is the plain average.
    Scaling/one-sided conventions match :func:`periodogram`.  The taper
    bank applies as one broadcast multiply and the k spectra ride one
    batched rfft: the taper axis is just another batch axis."""
    xm, axis = _real_last(x, axis, "multitaper expects a real signal")
    n = xm.shape[-1]
    if n < 2:
        raise ValueError("multitaper needs a signal of length >= 2")
    if k is None:
        k = max(int(2 * nw) - 1, 1)
    if weighting not in ("eigen", "unity"):
        raise ValueError(
            f"weighting must be 'eigen' or 'unity', got {weighting!r}"
        )
    xm = _detrend_frames(xm, detrend)
    tapers, ratios = dpss(n, float(nw), int(k), return_ratios=True,
                          dtype=np.float64)
    nfft = int(nfft) if nfft is not None else n
    if nfft < n:
        raise ValueError(
            f"nfft={nfft} < signal length {n}: truncating tapered records "
            "breaks the tapers' orthonormality (zero-padding nfft > n is fine)"
        )
    key = (n, float(nw), int(k))
    tap = constant(tapers, xm, key=("multitaper.tapers",) + key)  # (k, n)
    spec = rfft(xm[..., None, :] * tap, n=nfft, config=config)  # (…, k, bins)
    p = spec.real ** 2 + spec.imag ** 2
    if weighting == "eigen":
        wk = ratios / ratios.sum()
    else:
        wk = np.full(k, 1.0 / k)
    with fp32_matmul():
        p = torch.einsum("...kf,k->...f", p,
                         constant(wk, p, key=("multitaper.weights", weighting) + key))
    # tapers are unit-energy: density scale is 1/fs
    if scaling != "density":
        raise ValueError(
            "multitaper supports scaling='density' only (amplitude spectra "
            f"are not defined for orthonormal taper banks), got {scaling!r}"
        )
    p = p * _onesided_doubling(nfft, p) * (1.0 / fs)
    freqs = rfftfreq(nfft, 1.0 / fs, device=p.device)
    return freqs, torch.movedim(p, -1, axis)


def lombscargle(
    x,
    y,
    freqs,
    *,
    weights=None,
    floating_mean: bool = False,
    normalize=False,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """Lomb-Scargle periodogram of irregularly sampled data
    (scipy.signal.lombscargle semantics, including ``weights``,
    ``floating_mean``, and the three ``normalize`` modes: False/'power'
    (legacy A²·N/4 units), True/'normalize' ([0, 1] fraction of total
    power), 'amplitude' (complex best-fit a + i·b, tau-corrected)).

    ``x`` (sample times) and ``freqs`` (angular frequencies) are 1-D;
    ``y`` may carry leading batch axes over shared times (an extension:
    scipy is 1-D only).  Every reduction is a (N,)·(N, F) contraction over
    the dense trig matrix, in full fp32 whatever the caller's TF32 setting.
    Weights must be non-negative."""
    x, y, freqs = as_tensors(x, y, freqs)
    if x.ndim != 1 or x.shape[0] < 1:
        raise ValueError("x must be a non-empty 1-D array of sample times")
    if y.ndim < 1 or y.shape[-1] != x.shape[0]:
        raise ValueError(
            f"y's last axis ({y.shape[-1] if y.ndim else None}) must match "
            f"x ({x.shape[0]})"
        )
    if freqs.ndim != 1 or freqs.shape[0] < 1:
        raise ValueError("freqs must be a non-empty 1-D array")
    if isinstance(normalize, bool):
        normalize = "normalize" if normalize else "power"
    if normalize not in ("power", "normalize", "amplitude"):
        raise ValueError(
            "normalize must be False/'power', True/'normalize', or "
            f"'amplitude'; got {normalize!r}"
        )
    x, y, freqs = x.to(DTYPE), y.to(DTYPE), freqs.to(DTYPE)
    n = x.shape[0]
    if weights is None:
        w = torch.full((n,), 1.0 / n, dtype=DTYPE, device=x.device)
    else:
        w = as_tensor(weights, x.device).to(DTYPE)
        if w.shape != (n,):
            raise ValueError(f"weights must have shape ({n},), got {tuple(w.shape)}")
        w = w / torch.sum(w)

    with fp32_matmul():
        wt = x[:, None] * freqs[None, :]  # (N, F)
        c, s = torch.cos(wt), torch.sin(wt)
        CC = w @ (c * c)
        SS = 1.0 - CC
        CS = w @ (c * s)
        if floating_mean:
            C, S = w @ c, w @ s
            CC = CC - C * C
            SS = SS - S * S
            CS = CS - C * S
        tau = 0.5 * torch.atan2(2.0 * CS, CC - SS)

        wtt = wt - tau[None, :]
        ct, st = torch.cos(wtt), torch.sin(wtt)
        wy = w * y  # (…, N)
        Y = torch.sum(wy, dim=-1)  # (…,)
        YC = wy @ ct
        YS = wy @ st
        CC = w @ (ct * ct)
        SS = 1.0 - CC
        if floating_mean:
            C, S = w @ ct, w @ st
            YC = YC - Y[..., None] * C
            YS = YS - Y[..., None] * S
            CC = CC - C * C
            SS = SS - S * S
    eps = float(np.finfo(np.float32).epsneg)
    CC = torch.clamp(CC, min=eps)
    SS = torch.clamp(SS, min=eps)
    a = YC / CC
    b = YS / SS

    if normalize == "amplitude":
        # complex best-fit amplitude, rotated back by tau
        ph_r, ph_i = torch.cos(tau), torch.sin(tau)
        return torch.complex(a * ph_r - b * ph_i, a * ph_i + b * ph_r)
    pgram = 2.0 * (a * YC + b * YS)
    if normalize == "power":
        return pgram * (n / 4.0)
    YY = torch.sum(wy * y, dim=-1)
    if floating_mean:
        YY = YY - Y * Y
    return pgram * (0.5 / YY[..., None])


def _upfirdn_len(len_h: int, n_in: int, up: int, down: int) -> int:
    """Output length of upfirdn (scipy's _output_len)."""
    return ((n_in - 1) * up + len_h - 1) // down + 1


def _firwin_lowpass(numtaps: int, cutoff: float, window) -> np.ndarray:
    """Linear-phase windowed-sinc low-pass FIR design (scipy.signal.firwin
    semantics for a single passband containing DC): ``cutoff`` relative to
    Nyquist, symmetric window, unit DC gain.  Host numpy: filter design is
    plan-time work."""
    if numtaps < 2 or numtaps % 2 == 0:
        raise ValueError(f"numtaps must be odd and >= 3, got {numtaps}")
    if not 0.0 < cutoff < 1.0:
        raise ValueError(f"cutoff must be in (0, 1) of Nyquist, got {cutoff}")
    return firwin(numtaps, cutoff, window=window)


def kaiser_atten(numtaps: int, width: float) -> float:
    """Kaiser-window attenuation for a given transition width (fraction of
    Nyquist) — scipy.signal.kaiser_atten."""
    return 2.285 * (numtaps - 1) * np.pi * width + 7.95


def kaiser_beta(a: float) -> float:
    """Kaiser beta for ``a`` dB of stopband attenuation —
    scipy.signal.kaiser_beta's piecewise fit."""
    if a > 50:
        return 0.1102 * (a - 8.7)
    if a > 21:
        return 0.5842 * (a - 21) ** 0.4 + 0.07886 * (a - 21)
    return 0.0


def firwin(
    numtaps: int,
    cutoff,
    width: Optional[float] = None,
    window="hamming",
    pass_zero=True,
    scale: bool = True,
    fs: float = 2.0,
) -> np.ndarray:
    """Windowed-sinc linear-phase FIR design — scipy.signal.firwin parity
    (multi-band ``cutoff``, ``pass_zero`` bool or 'lowpass'/'highpass'/
    'bandpass'/'bandstop', Kaiser design via ``width``, response pinned to
    unity at the first passband center when ``scale``).

    Returns a host fp64 tap array (filter design is plan-time work); apply
    it with :func:`upfirdn`, :func:`resample_poly` or
    :func:`fft_convolve`."""
    if numtaps < 2:
        raise ValueError(f"numtaps must be >= 2, got {numtaps}")
    nyq = 0.5 * fs
    cut = np.atleast_1d(np.asarray(cutoff, np.float64)) / nyq
    if cut.ndim != 1 or cut.size == 0:
        raise ValueError("cutoff must be a scalar or a 1-D sequence")
    if np.any(cut <= 0) or np.any(cut >= 1):
        raise ValueError("cutoff must lie strictly inside (0, fs/2)")
    if cut.size > 1 and np.any(np.diff(cut) <= 0):
        raise ValueError("cutoff must be strictly increasing")
    if isinstance(pass_zero, str):
        if pass_zero in ("bandstop", "lowpass"):
            if pass_zero == "lowpass" and cut.size != 1:
                raise ValueError("lowpass takes exactly one cutoff")
            pass_zero = True
        elif pass_zero in ("bandpass", "highpass"):
            if pass_zero == "highpass" and cut.size != 1:
                raise ValueError("highpass takes exactly one cutoff")
            pass_zero = False
        else:
            raise ValueError(f"unknown pass_zero {pass_zero!r}")
    pass_nyquist = bool(cut.size & 1) ^ bool(pass_zero)
    if pass_nyquist and numtaps % 2 == 0:
        raise ValueError(
            "even numtaps (type II) cannot pass Nyquist; use odd numtaps"
        )
    if width is not None:
        window = ("kaiser", kaiser_beta(kaiser_atten(numtaps, width / nyq)))
    # band edges in [0, 1]-of-Nyquist, alternating stop/pass from pass_zero
    bands = np.concatenate([
        [0.0] if pass_zero else [], cut, [1.0] if pass_nyquist else []
    ]).reshape(-1, 2)
    win = get_window(window, numtaps, np.float64, sym=True)
    m = np.arange(numtaps, dtype=np.float64) - (numtaps - 1) / 2.0
    h = np.zeros(numtaps, np.float64)
    for left, right in bands:
        h += right * np.sinc(right * m) - left * np.sinc(left * m)
    h *= win
    if scale:
        left, right = bands[0]
        fr = 0.0 if left == 0.0 else (1.0 if right == 1.0 else (left + right) / 2)
        c = np.cos(np.pi * m * fr)
        h /= np.sum(h * c)
    return h


def remez(
    numtaps: int,
    bands,
    desired,
    weight=None,
    type: str = "bandpass",
    maxiter: int = 50,
    grid_density: int = 16,
    fs: float = 1.0,
) -> np.ndarray:
    """Parks-McClellan optimal equiripple FIR design — scipy.signal.remez
    semantics (``bands`` as 2·nbands edges in units of ``fs``, ``desired``
    per band, ``type`` in {'bandpass', 'differentiator', 'hilbert'}).

    Host fp64 Remez exchange (filter design is plan-time work): the
    linear-phase response factors G(ω) = Q(ω)·P(ω) with Q fixed by the
    parity/symmetry case (1, cos ω/2, sin ω, sin ω/2) and P a degree-M
    polynomial in x = cos ω handled in BARYCENTRIC Lagrange form (the
    (M+2)-node alternation step has the classical closed form for δ; a
    cosine-coefficient linear solve is rank-deficient past M≈25).  Each
    iteration re-selects alternating extrema of the weighted error on a
    dense multi-band grid (candidates = local maxima ∪ band edges ∪
    previous nodes; same-sign runs keep their largest; excess trimmed by
    weakest adjacent pair, then weakest endpoint).  Taps are recovered by
    sampling the converged G at the N DFT frequencies and one inverse
    real DFT with the linear-phase (and, for the antisymmetric types,
    quadrature) factor — no coefficient back-conversion tables.  The
    equiripple solution is unique (Chebyshev alternation), so results
    agree with scipy's independent implementation to grid accuracy
    (~1e-5 taps; verified in tests)."""
    if numtaps < 3:
        raise ValueError(f"numtaps must be >= 3, got {numtaps}")
    bands = np.asarray(bands, np.float64).ravel() / fs
    desired = np.asarray(desired, np.float64).ravel()
    if bands.size % 2 or bands.size == 0:
        raise ValueError("bands must have an even number of edges")
    if np.any(np.diff(bands) < 0) or bands[0] < 0 or bands[-1] > 0.5:
        raise ValueError("bands must be nondecreasing within [0, fs/2]")
    nb = bands.size // 2
    if desired.size != nb:
        raise ValueError(f"desired must have {nb} entries (one per band)")
    if weight is None:
        weight = np.ones(nb)
    weight = np.asarray(weight, np.float64).ravel()
    if weight.size != nb or np.any(weight <= 0):
        raise ValueError(f"weight must be {nb} positive entries")
    if type not in ("bandpass", "differentiator", "hilbert"):
        raise ValueError(f"unknown type {type!r}")
    antisym = type in ("differentiator", "hilbert")
    even = numtaps % 2 == 0
    # case selection: Q(ω) and polynomial degree M (O&S conventions)
    if not antisym and not even:
        Q = lambda w: np.ones_like(w); M = (numtaps - 1) // 2
    elif not antisym and even:
        Q = lambda w: np.cos(w / 2); M = numtaps // 2 - 1
    elif antisym and not even:
        Q = lambda w: np.sin(w); M = (numtaps - 1) // 2 - 1
    else:
        Q = lambda w: np.sin(w / 2); M = numtaps // 2 - 1
    if M < 1:
        raise ValueError("numtaps too small for this type")

    # dense grid over the bands (scipy's density), avoiding Q(ω)=0 points
    npts = max(grid_density * (numtaps + 1) // 2, 4 * (M + 2))
    widths = bands[1::2] - bands[0::2]
    total = max(widths.sum(), 1e-12)
    grid, dgrid, wgrid = [], [], []
    for i in range(nb):
        n_i = max(int(round(npts * widths[i] / total)), 8)
        g = np.linspace(bands[2 * i], bands[2 * i + 1], n_i)
        d = np.full(n_i, desired[i])
        wg = np.full(n_i, weight[i])
        if type == "differentiator":
            d = desired[i] * g  # scipy: gain grows as the band fraction
            wg = wg / np.maximum(g, 1e-9)  # relative-error weighting
        grid.append(g); dgrid.append(d); wgrid.append(wg)
    w = np.concatenate(grid) * 2 * np.pi  # rad/sample
    D = np.concatenate(dgrid)
    W = np.concatenate(wgrid)
    qv = Q(w)
    keep = np.abs(qv) > 1e-9
    w, D, W, qv = w[keep], D[keep], W[keep], qv[keep]
    if w.size < M + 2:
        raise ValueError("grid too small; raise grid_density")
    Deff = D / qv
    Weff = W * np.abs(qv)
    x = np.cos(w)
    m = w.size

    def node_weights(xi: np.ndarray) -> np.ndarray:
        """Barycentric weights 1/Π(x_i−x_j), log-scaled against overflow."""
        diffs = xi[:, None] - xi[None, :]
        np.fill_diagonal(diffs, 1.0)
        logs = np.sum(np.log(np.abs(2.0 * diffs)), axis=1)
        sgns = np.prod(np.sign(diffs), axis=1)
        return sgns * np.exp(-(logs - logs.mean()))

    def bary_eval(xq: np.ndarray, xn, a, y) -> np.ndarray:
        num = np.zeros_like(xq)
        den = np.zeros_like(xq)
        exact = np.full(xq.size, -1)
        for i in range(xn.size):
            d = xq - xn[i]
            hit = np.abs(d) < 1e-13
            exact[hit] = i
            d[hit] = 1.0
            t = a[i] / d
            num += t * y[i]
            den += t
        P = num / den
        P[exact >= 0] = np.asarray(y)[exact[exact >= 0]]
        return P

    idx = np.unique(np.linspace(0, m - 1, M + 2).round().astype(int))
    last = None
    a = y = None
    for _ in range(maxiter):
        xi = x[idx]
        a = node_weights(xi)
        alt = (-1.0) ** np.arange(idx.size)
        delta = np.sum(a * Deff[idx]) / np.sum(a * alt / Weff[idx])
        y = Deff[idx] - alt * delta / Weff[idx]
        E = Weff * (Deff - bary_eval(x, xi, a, y))
        mag = np.abs(E)
        inner = np.where(
            (mag[1:-1] >= mag[:-2]) & (mag[1:-1] >= mag[2:])
        )[0] + 1
        cand = np.unique(np.concatenate([[0], inner, [m - 1], idx]))
        sel = []
        for i2 in cand:  # same-sign runs keep their largest member
            if sel and np.sign(E[i2]) == np.sign(E[sel[-1]]):
                if mag[i2] > mag[sel[-1]]:
                    sel[-1] = i2
            else:
                sel.append(i2)
        while len(sel) > M + 2:
            if len(sel) - (M + 2) >= 2:
                j = min(
                    range(len(sel) - 1),
                    key=lambda j: max(mag[sel[j]], mag[sel[j + 1]]),
                )
                del sel[j : j + 2]
            elif mag[sel[0]] <= mag[sel[-1]]:
                del sel[0]  # single excess: drop the weaker ENDPOINT
            else:
                del sel[-1]
        new = np.array(sel)
        if new.size < M + 2:
            break  # degenerate grid; keep the current solution
        if last is not None and np.array_equal(new, last):
            idx = new
            break
        last = idx = new

    # re-solve on the FINAL node set (idx may have been exchanged after
    # (a, y) were last computed — e.g. maxiter exhaustion); idempotent on
    # the converged set
    xi = x[idx]
    a = node_weights(xi)
    alt = (-1.0) ** np.arange(idx.size)
    delta = np.sum(a * Deff[idx]) / np.sum(a * alt / Weff[idx])
    y = Deff[idx] - alt * delta / Weff[idx]

    # taps via inverse real DFT of the sampled linear-phase response
    N = numtaps
    k = np.arange(N // 2 + 1)
    wk = 2 * np.pi * k / N
    Gk = Q(wk) * bary_eval(np.cos(wk), xi, a, y)
    phase = np.exp(-1j * wk * (N - 1) / 2)
    if antisym:
        phase = phase * 1j  # scipy/MATLAB quadrature sign convention
    Hk = Gk * phase
    full = np.concatenate([Hk, np.conj(Hk[1 : (N + 1) // 2][::-1])])
    return np.real(np.fft.ifft(full))


def freqz(
    b,
    a=1.0,
    worN=512,
    whole: bool = False,
    fs: float = 2.0 * np.pi,
    *,
    device=None,
    config: SpectralConfig = DEFAULT_CONFIG,
):
    """Frequency response of a digital filter, scipy.signal.freqz
    semantics: returns ``(w, h)`` with ``w`` in units of ``fs`` (host fp64)
    and ``h`` complex on the device (that of a tensor among ``b``, ``a``,
    else ``device``, default the card).

    For integer ``worN`` the response is one engine FFT of the zero-padded
    coefficient vectors (worN bins over [0, fs) when ``whole``, else
    [0, fs/2)); for an explicit frequency array it is a dense
    e^{−jωk} matrix contraction."""
    if not isinstance(b, torch.Tensor) and not isinstance(a, torch.Tensor):
        b = as_tensor(b, device)
    b, a = (torch.atleast_1d(v) for v in as_tensors(b, a))
    if b.ndim != 1 or a.ndim != 1:
        raise ValueError("b and a must be 1-D coefficient vectors")

    def _eval_fft(v, nfft):
        v = torch.cat([v.to(_CDTYPE), v.new_zeros(nfft - v.shape[0], dtype=_CDTYPE)])
        return fft(v, config=config)

    if isinstance(worN, (int, np.integer)):
        n = int(worN)
        if n < 1:
            raise ValueError(f"worN must be >= 1, got {worN}")
        nfft = n if whole else 2 * n
        if nfft < max(b.shape[0], a.shape[0]):
            # grid too coarse for an FFT evaluation: fall back to dense
            w = np.arange(n) * (fs / nfft)
            return w, _freqz_dense(b, a, w * (2.0 * np.pi / fs))
        hb = _eval_fft(b, nfft)[:n]
        ha = _eval_fft(a, nfft)[:n]
        w = np.arange(n) * (fs / nfft)
        return w, hb / ha
    w = np.asarray(worN, np.float64)
    if w.ndim != 1:
        raise ValueError("worN must be an int or a 1-D frequency array")
    return w, _freqz_dense(b, a, w * (2.0 * np.pi / fs))


def _freqz_dense(b: Tensor, a: Tensor, omega: np.ndarray) -> Tensor:
    """H(e^{jω}) at arbitrary ω via e^{−jωk} matrix contractions."""
    def resp(v: Tensor) -> Tensor:
        ang = -np.outer(omega, np.arange(v.shape[0]))  # (W, K) host fp64
        like = v.real if v.is_complex() else v
        cr = constant(np.cos(ang), like)
        ci = constant(np.sin(ang), like)
        vr = like.to(DTYPE)
        vi = v.imag.to(DTYPE) if v.is_complex() else torch.zeros_like(vr)
        with fp32_matmul():
            hr = cr @ vr - ci @ vi
            hi = cr @ vi + ci @ vr
        return torch.complex(hr, hi)
    return resp(b) / resp(a)


def upfirdn(
    h,
    x,
    up: int = 1,
    down: int = 1,
    axis: int = -1,
    mode: str = "constant",
    cval: float = 0.0,
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """Upsample by ``up`` (zero stuffing), FIR filter by ``h``, downsample by
    ``down`` along ``axis``: scipy.signal.upfirdn semantics (zero-padded
    signal edges, output length ceil(((N-1)·up + F) / down)).

    No zero-stuffed intermediate and no scatter.  Because ``m·down mod up``
    cycles with period q = up/gcd(up, down), outputs split into q polyphase
    classes with a FIXED tap vector each:
    y[c·q + s] = Σ_t x[c·(down/g) + j0(s) + t] · C[s, t].  Each class is a
    strided window view of the padded signal (``Tensor.unfold``) contracted
    with its T taps, an fp32 product with TF32 off; the product makes the
    view contiguous, so one class holds T copies of its share of the signal
    at a time."""
    x = as_tensor(x)
    h = np.asarray(h.detach().cpu() if isinstance(h, torch.Tensor) else h, np.float64)
    if h.ndim != 1 or h.size == 0:
        raise ValueError("h must be a non-empty 1-D filter")
    up, down = int(up), int(down)
    if up < 1 or down < 1:
        raise ValueError(f"up and down must be >= 1, got {up}, {down}")
    if mode != "constant":
        raise ValueError(
            f"only mode='constant' edge extension is supported, got {mode!r}"
        )
    if x.ndim < 1:
        raise ValueError("x must have at least one dimension")
    axis = axis % x.ndim
    xm = working(torch.movedim(x, axis, -1))
    n = xm.shape[-1]
    if n < 1:
        raise ValueError("upfirdn needs a non-empty signal")
    if xm.is_complex():
        re = upfirdn(h, xm.real, up, down, axis=-1,
                     cval=float(np.real(cval)), config=config)
        im = upfirdn(h, xm.imag, up, down, axis=-1,
                     cval=float(np.imag(cval)), config=config)
        return torch.movedim(torch.complex(re, im), -1, axis)
    F = h.size
    g = math.gcd(up, down)
    q = up // g
    stride = down // g
    M = _upfirdn_len(F, n, up, down)
    T = (F - 1) // up + 1
    nblocks = -(-M // q)
    # fixed per-phase taps: C[s, t] = h[(s·down) mod up + (T-1-t)·up]
    h_pad = np.zeros(up * T, np.float64)
    h_pad[:F] = h
    srange = (np.arange(q) * down) % up
    C = h_pad[srange[:, None] + (T - 1 - np.arange(T))[None, :] * up]  # (q, T)
    # window start per (block, phase): j0(s) = floor(s·down/up) - (T-1)
    j0 = (np.arange(q) * down) // up - (T - 1)
    P = T - 1  # left zero-pad makes every index non-negative
    last = (nblocks - 1) * stride + int(j0.max()) + T - 1 + P  # largest index read
    xp_ = pad_last(xm, P, max(last - (n - 1 + P), 0), "constant", float(cval))
    # the taps are small: kept on the card under their own contents
    Cd = constant(C, xp_, key=content_key(f"upfirdn.taps/{up}/{down}", h) if F <= 65536 else None)
    with fp32_matmul():
        y = torch.stack(
            [xp_[..., int(j0[s]) + P:].unfold(-1, T, stride)[..., :nblocks, :] @ Cd[s]
             for s in range(q)], dim=-1)  # (…, nblocks, q)
    y = y.reshape(*xm.shape[:-1], nblocks * q)[..., :M]
    return torch.movedim(y, -1, axis)


def resample_poly(
    x,
    up: int,
    down: int,
    axis: int = -1,
    window=("kaiser", 5.0),
    padtype: str = "constant",
    cval: Optional[float] = None,
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """Polyphase resampling by the rational factor up/down along ``axis``
    (scipy.signal.resample_poly semantics: gcd reduction, Kaiser-windowed
    sinc anti-aliasing filter of half-length 10·max(up, down), centered
    output of length ceil(N·up/down)).

    ``window`` is a :func:`get_window` spec for the FIR design, or an
    explicit (odd-length, symmetric) filter array used as-is (then scaled by
    ``up``).  ``padtype`` in {'constant', 'mean', 'median', 'minimum',
    'maximum'}: the statistics modes subtract the per-signal background
    before filtering and restore it after (scipy's edge handling);
    zero-padded edges otherwise.  Rides :func:`upfirdn`."""
    x = as_tensor(x)
    up, down = int(up), int(down)
    if up < 1 or down < 1:
        raise ValueError(f"up and down must be >= 1, got {up}, {down}")
    if cval is not None and padtype != "constant":
        raise ValueError("cval only applies to padtype='constant'")
    g_ = math.gcd(up, down)
    up //= g_
    down //= g_
    if up == down == 1:
        return x
    axis = axis % x.ndim
    n_in = x.shape[axis]
    n_out = n_in * up // down + bool((n_in * up) % down)

    if isinstance(window, (list, np.ndarray)):
        h = np.asarray(window, np.float64)
        if h.ndim != 1:
            raise ValueError("window array must be 1-D")
        half_len = (h.size - 1) // 2
    else:
        max_rate = max(up, down)
        f_c = 1.0 / max_rate  # cutoff relative to Nyquist
        half_len = 10 * max_rate
        h = _firwin_lowpass(2 * half_len + 1, f_c, window)
    h = h * up

    # zero-pad the filter so the kept samples land at window centers
    n_pre_pad = down - half_len % down
    n_post_pad = 0
    n_pre_remove = (half_len + n_pre_pad) // down
    while (
        _upfirdn_len(h.size + n_pre_pad + n_post_pad, n_in, up, down)
        < n_out + n_pre_remove
    ):
        n_post_pad += 1
    h = np.concatenate([np.zeros(n_pre_pad), h, np.zeros(n_post_pad)])

    stats = {
        "mean": lambda v: torch.mean(v, dim=axis, keepdim=True),
        "median": lambda v: median(v, dim=axis, keepdim=True),
        "minimum": lambda v: torch.amin(v, dim=axis, keepdim=True),
        "maximum": lambda v: torch.amax(v, dim=axis, keepdim=True),
    }
    background = None
    ufd_cval = 0.0
    if padtype in stats:
        x = working(x)
        background = stats[padtype](x)
        x = x - background
    elif padtype == "constant":
        ufd_cval = 0.0 if cval is None else float(cval)
    else:
        raise ValueError(
            "padtype must be one of 'constant', 'mean', 'median', "
            f"'minimum', 'maximum'; got {padtype!r}"
        )

    y = upfirdn(h, x, up, down, axis=axis, cval=ufd_cval, config=config)
    y = y.narrow(axis, n_pre_remove, n_out)
    if background is not None:
        y = y + background
    return y


def poisson_solve(
    f,
    period=2.0 * np.pi,
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """Solve the periodic Poisson equation ∇²u = f spectrally: û = −f̂/|k|²
    over every axis (exponentially accurate for smooth periodic f).

    ``period`` is the domain length per axis (scalar or one per axis).  The
    k = 0 mode is indeterminate; it is pinned to zero, i.e. the returned
    solution has zero mean (solvability requires mean(f) ≈ 0, as in any
    periodic Poisson problem).
    """
    f = as_tensor(f)
    if f.is_complex():
        raise ValueError("poisson_solve expects a real field")
    ndim = f.ndim
    periods = np.broadcast_to(np.asarray(period, np.float64), (ndim,))
    shape = tuple(f.shape)

    spec = rfft(f.to(DTYPE), config=config)
    for a in range(ndim - 1):
        spec = fft(spec, axis=a, config=config)

    def inverse_k2() -> np.ndarray:
        # −1/|k|² over the mixed full/half frequency grid
        k2 = np.zeros(tuple(spec.shape), np.float64)
        for a in range(ndim):
            n = shape[a]
            if a == ndim - 1:
                ka = 2.0 * np.pi * np.arange(n // 2 + 1, dtype=np.float64) / periods[a]
            else:
                ka = 2.0 * np.pi * np.fft.fftfreq(n, 1.0 / n) / periods[a]
            sl = [None] * ndim
            sl[a] = slice(None)
            k2 = k2 + (ka ** 2)[tuple(sl)]
        return np.where(k2 > 0, -1.0 / np.where(k2 > 0, k2, 1.0), 0.0)  # zero the DC mode

    spec = spec * constant(inverse_k2, spec.real,
                           key=("poisson", shape, tuple(float(p) for p in periods)))
    out = spec
    for a in range(ndim - 1):
        out = ifft(out, axis=a, config=config)
    return irfft(out, n=shape[-1], config=config)


def _log_floor(mag: Tensor) -> Tensor:
    return torch.log(torch.clamp(mag, min=1e-30))


def rceps(x, n: Optional[int] = None, axis: int = -1,
          *, config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    """Real cepstrum: ifft(log |fft(x)|).real, for echo/pitch detection and
    homomorphic deconvolution (an echo at lag d appears as a cepstral peak
    at quefrency d).  ``n`` optionally pads/crops the transform length."""
    xm, axis = _real_last(x, axis, "rceps expects a real signal")
    spec = fft(xm, n=n, config=config)
    mag = torch.sqrt(spec.real ** 2 + spec.imag ** 2)
    out = ifft(_log_floor(mag).to(_CDTYPE), config=config).real
    return torch.movedim(out, -1, axis)


def _unwrap(p: Tensor) -> Tensor:
    """numpy.unwrap along the last axis (period 2π)."""
    dd = p[..., 1:] - p[..., :-1]
    ddmod = torch.remainder(dd + math.pi, 2.0 * math.pi) - math.pi
    ddmod = torch.where((ddmod == -math.pi) & (dd > 0), torch.full_like(ddmod, math.pi), ddmod)
    correct = torch.where(torch.abs(dd) < math.pi, torch.zeros_like(dd), ddmod - dd)
    return torch.cat([p[..., :1], p[..., 1:] + torch.cumsum(correct, dim=-1)], dim=-1)


def _cepstral_ramp(nn: int, like: Tensor) -> Tensor:
    mid = (nn + 1) // 2  # MATLAB rcunwrap: nh = fix((n+1)/2)
    return constant(lambda: np.arange(nn, dtype=np.float64) / mid, like,
                    key=("cceps.ramp", nn))


def cceps(x, n: Optional[int] = None, axis: int = -1,
          *, config: SpectralConfig = DEFAULT_CONFIG):
    """Complex cepstrum (matlab cceps conventions): ifft(log fft(x)) with
    the phase unwrapped and its linear component removed to make log F
    continuous; returns ``(xhat, ndelay)`` where ``ndelay`` is the integer
    circular delay removed (needed by :func:`icceps` for exact
    inversion)."""
    xm, axis = _real_last(x, axis, "cceps expects a real signal")
    spec = fft(xm, n=n, config=config)
    nn = spec.shape[-1]
    mag = torch.sqrt(spec.real ** 2 + spec.imag ** 2)
    ph = _unwrap(torch.atan2(spec.imag, spec.real))
    # remove the linear phase trend (integer circular delay), matlab's
    # rcunwrap: nd = round(ph[N/2]/pi), subtracted as a pi*k*nd/(N/2) ramp
    nd = torch.round(ph[..., (nn + 1) // 2] / math.pi)
    ph = ph - math.pi * _cepstral_ramp(nn, ph) * nd[..., None]
    out = ifft(torch.complex(_log_floor(mag), ph), config=config).real
    return torch.movedim(out, -1, axis), nd


def icceps(xhat, ndelay=0, axis: int = -1,
           *, config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    """Inverse complex cepstrum: exp in the spectral domain, re-applying the
    integer circular delay removed by :func:`cceps`."""
    xhat = as_tensor(xhat)
    axis = axis % xhat.ndim
    xm = torch.movedim(xhat, axis, -1)
    nn = xm.shape[-1]
    logf = fft(xm.to(_CDTYPE), config=config)
    nd = as_tensor(ndelay, xm.device).to(DTYPE)
    while nd.ndim < xm.ndim - 1:
        nd = nd[None]
    ramp = math.pi * _cepstral_ramp(nn, logf.real) * nd[..., None]
    lr, li = logf.real, logf.imag + ramp
    ex = torch.exp(lr)
    spec = torch.complex(ex * torch.cos(li), ex * torch.sin(li))
    out = ifft(spec, config=config).real
    return torch.movedim(out, -1, axis)


def minimum_phase(
    h, n_fft: Optional[int] = None, half: bool = True,
    *, config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """Minimum-phase FIR from a linear-phase prototype by the homomorphic
    method (scipy.signal.minimum_phase(method='homomorphic') semantics:
    cepstral windowing lmin[n] = 2u[n] - delta[n] of 0.5·log|H|, Oppenheim
    & Schafer eq. 13.42b).  ``half=True`` returns the half-length root
    filter (|H_min| = sqrt(|H|)), ``half=False`` the equal-length
    minimum-phase version."""
    h = as_tensor(h)
    if h.is_complex():
        raise ValueError("minimum_phase takes a real filter")
    if h.ndim != 1 or h.shape[0] <= 2:
        raise ValueError("h must be 1-D with more than 2 taps")
    n_h = h.shape[0]
    if n_fft is None:
        n_fft = 2 ** int(math.ceil(math.log2(2 * (n_h - 1) / 0.01)))
    n_fft = int(n_fft)
    if n_fft < n_h:
        raise ValueError(f"n_fft must be >= len(h) = {n_h}")
    spec = fft(h.to(DTYPE), n=n_fft, config=config)
    mag = torch.sqrt(spec.real ** 2 + spec.imag ** 2)
    floor = 1e-7 * torch.min(torch.where(mag > 0, mag, torch.full_like(mag, math.inf)))
    logm = torch.log(mag + floor)
    if half:
        logm = logm * 0.5
    cep = ifft(logm.to(_CDTYPE), config=config).real

    def lifter() -> np.ndarray:
        win = np.zeros(n_fft)
        win[0] = 1.0
        stop = n_fft // 2
        win[1:stop] = 2.0
        if n_fft % 2:
            win[stop] = 1.0
        return win

    cep = cep * constant(lifter, cep, key=("minimum_phase.lifter", n_fft))
    eh = fft(cep.to(_CDTYPE), config=config)
    ex = torch.exp(eh.real)
    spec_min = torch.complex(ex * torch.cos(eh.imag), ex * torch.sin(eh.imag))
    h_min = ifft(spec_min, config=config).real
    n_out = (n_h // 2 + n_h % 2) if half else n_h
    return h_min[:n_out]


def detrend(data, axis: int = -1, type: str = "linear", bp=0,
            *, config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    """Remove a constant or piecewise-linear trend along ``axis``
    (scipy.signal.detrend semantics incl. breakpoints ``bp``).

    Segment boundaries are host integers, so each segment's least-squares
    line is two closed-form device reductions: no solver, no host sync."""
    x = working(data)
    if type not in ("linear", "constant", "l", "c"):
        raise ValueError(f"type must be 'linear' or 'constant', got {type!r}")
    axis = axis % x.ndim
    if type in ("constant", "c"):
        return x - torch.mean(x, dim=axis, keepdim=True)
    n = x.shape[axis]
    bp = np.sort(np.unique(np.concatenate([[0], np.atleast_1d(bp), [n]])))
    if np.any(bp < 0) or np.any(bp > n):
        raise ValueError(f"breakpoints must lie in [0, {n}]")
    xm = torch.movedim(x, axis, -1)
    pieces = []
    for lo, hi in zip(bp[:-1], bp[1:]):
        m = int(hi - lo)
        if m == 0:
            continue
        pieces.append(_detrend_frames(xm[..., int(lo):int(hi)], "linear"))
    return torch.movedim(torch.cat(pieces, -1), -1, axis)


def decimate(x, q: int, n: Optional[int] = None, ftype: str = "fir",
             axis: int = -1, zero_phase: bool = True,
             *, config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    """Downsample by an integer factor after anti-aliasing
    (scipy.signal.decimate).  ftype='fir' (default): Hamming-windowed sinc
    of order 20·q, zero-phase via the centered polyphase application.
    ftype='iir': scipy's Chebyshev-I order-8 sos (0.05 dB, 0.8/q cutoff)
    applied with ``sosfilt``/``sosfiltfilt`` of ``ops/iir.py``, whose
    recursion is a blocked scan on the device."""
    q = int(q)
    if q < 1:
        raise ValueError(f"q must be >= 1, got {q}")
    if ftype == "iir":
        from .iir import cheby1, sosfilt, sosfiltfilt

        if n is None:
            n = 8
        sos = cheby1(n, 0.05, 0.8 / q, output="sos")
        y = (sosfiltfilt(sos, x, axis=axis, config=config) if zero_phase
             else sosfilt(sos, x, axis=axis, config=config))
        sl = [slice(None)] * y.ndim
        sl[axis] = slice(None, None, q)
        return y[tuple(sl)]
    if ftype != "fir":
        raise ValueError(f"ftype must be 'fir' or 'iir', got {ftype!r}")
    if not zero_phase:
        raise ValueError("zero_phase=False is not supported for FIR")
    if n is None:
        n = 20 * q
    if n % 2:
        n += 1  # keep the filter odd-length symmetric (exact zero phase)
    if q == 1:
        return as_tensor(x)
    h = _firwin_lowpass(n + 1, 1.0 / q, "hamming")
    return resample_poly(x, 1, q, axis=axis, window=np.asarray(h),
                         config=config)


def savgol_coeffs(window_length: int, polyorder: int, deriv: int = 0,
                  delta: float = 1.0, pos: Optional[float] = None,
                  use: str = "conv") -> np.ndarray:
    """Savitzky-Golay FIR coefficients (scipy.signal.savgol_coeffs):
    least-squares polynomial smoothing/differentiation taps, host fp64
    (the min-norm lstsq solution of the underdetermined moment system)."""
    import math as _math

    if window_length < 1:
        raise ValueError(f"window_length must be >= 1, got {window_length}")
    if polyorder >= window_length:
        raise ValueError("polyorder must be < window_length")
    halflen, rem = divmod(window_length, 2)
    if pos is None:
        pos = halflen if rem else halflen - 0.5
    if not 0 <= pos <= window_length - 1:
        raise ValueError("pos must be within the window")
    if use not in ("conv", "dot"):
        raise ValueError(f"use must be 'conv' or 'dot', got {use!r}")
    if deriv > polyorder:
        return np.zeros(window_length)
    x = np.arange(-pos, window_length - pos, dtype=np.float64)
    if use == "conv":
        x = x[::-1]
    order = np.arange(polyorder + 1).reshape(-1, 1)
    A = x ** order  # (polyorder+1, window_length)
    y = np.zeros(polyorder + 1)
    y[deriv] = _math.factorial(deriv) / (delta ** deriv)
    coeffs, *_ = np.linalg.lstsq(A, y, rcond=None)
    return coeffs


def savgol_filter(x, window_length: int, polyorder: int, deriv: int = 0,
                  delta: float = 1.0, axis: int = -1, mode: str = "interp",
                  cval: float = 0.0,
                  *, config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    """Savitzky-Golay smoothing/differentiation along ``axis``
    (scipy.signal.savgol_filter semantics incl. the 'interp' edge mode).

    The interior is one strided window view contracted with the (wl,) taps;
    the 'interp' edges are (halflen, wl) matrices (evaluate-at-edge ∘
    pinv(fit) of the polynomial basis, computed on the host and kept on the
    device), so the whole filter is three small matmuls with no edge loop."""
    x = as_tensor(x)
    if mode not in ("interp", "mirror", "nearest", "wrap", "constant"):
        raise ValueError(f"unknown mode {mode!r}")
    if window_length % 2 == 0 and mode == "interp":
        raise ValueError("mode='interp' needs an odd window_length")
    wl = int(window_length)
    axis = axis % x.ndim
    xm = torch.movedim(x, axis, -1)
    n = xm.shape[-1]
    half = wl // 2
    xw = xm.to(DTYPE)
    key = (wl, int(polyorder), int(deriv), float(delta))
    cd = constant(lambda: savgol_coeffs(wl, polyorder, deriv, delta, use="dot"),
                  xw, xw.dtype, key=("savgol.taps",) + key)
    if mode == "interp":
        if n < wl:
            raise ValueError("signal shorter than window_length for 'interp'")

        def edge(ts: np.ndarray) -> np.ndarray:
            # d^deriv/dt^deriv of the lstsq polynomial Σ a_k t^k of one
            # window, evaluated at positions ts
            A = np.vander(np.arange(wl, dtype=np.float64), polyorder + 1, increasing=True)
            rows = np.zeros((len(ts), polyorder + 1))
            for k in range(deriv, polyorder + 1):
                fac = math.factorial(k) / math.factorial(k - deriv)
                rows[:, k] = fac * ts ** (k - deriv)
            return (rows / (delta ** deriv)) @ np.linalg.pinv(A)

        left = constant(lambda: edge(np.arange(half)), xw, xw.dtype,
                        key=("savgol.left",) + key)
        right = constant(lambda: edge(np.arange(wl - half, wl)), xw, xw.dtype,
                         key=("savgol.right",) + key)
        with fp32_matmul():
            interior = _frame(xw, wl, 1) @ cd  # (…, n-wl+1)
            lo = xw[..., :wl] @ left.T
            hi = xw[..., -wl:] @ right.T
        out = torch.cat([lo, interior, hi], -1)
    else:
        pad_mode = {"mirror": "reflect", "nearest": "edge", "wrap": "wrap",
                    "constant": "constant"}[mode]
        xp_ = pad_last(xw, half, half, pad_mode, cval)
        with fp32_matmul():
            out = _frame(xp_, wl, 1)[..., :n, :] @ cd
    return torch.movedim(out, -1, axis)


def group_delay(system, w: int = 512, whole: bool = False,
                fs: float = 2.0 * np.pi,
                *, device=None, config: SpectralConfig = DEFAULT_CONFIG):
    """Group delay of a digital filter (scipy.signal.group_delay):
    τ(ω) = −dφ/dω in samples, via the Shpak identity
    τ = Re[FFT(n·c)/FFT(c)] − (len(a)−1) with c = b ⊛ reverse(conj(a)):
    two engine FFT evaluations, no phase unwrapping.  The coefficients are
    host arrays; the result is on ``device`` (default: the card)."""
    b, a = system
    b = np.atleast_1d(np.asarray(b, np.float64))
    a = np.atleast_1d(np.asarray(a, np.float64))
    if b.ndim != 1 or a.ndim != 1:
        raise ValueError("b and a must be 1-D coefficient vectors")
    c = np.convolve(b, a[::-1].conj())
    cr = c * np.arange(len(c))
    device = resolve_device(device)
    wg, num = freqz(cr.astype(np.float32), worN=w, whole=whole, fs=fs,
                    device=device, config=config)
    _, den = freqz(c.astype(np.float32), worN=w, whole=whole, fs=fs,
                   device=device, config=config)
    tau = (num * torch.conj(den)).real / torch.clamp(
        torch.abs(den) ** 2, min=1e-30) - (len(a) - 1)
    return wg, tau


def deconvolve(signal, divisor):
    """Polynomial deconvolution (scipy.signal.deconvolve): quotient and
    remainder of ``signal = conv(divisor, quotient) + remainder`` — host
    fp64 long division (deconvolution is plan-time small-vector work)."""
    num = np.atleast_1d(np.asarray(signal, np.float64))
    den = np.atleast_1d(np.asarray(divisor, np.float64))
    if den.ndim != 1 or num.ndim != 1:
        raise ValueError("signal and divisor must be 1-D")
    if den.size == 0 or den[0] == 0:
        raise ValueError("divisor must have a nonzero leading coefficient")
    n = num.size - den.size + 1
    if n <= 0:
        return np.zeros(1), num.copy()
    quot = np.zeros(n)
    rem = num.copy()
    for i in range(n):
        quot[i] = rem[i] / den[0]
        rem[i : i + den.size] -= quot[i] * den
    return quot, rem


def kaiserord(ripple: float, width: float) -> Tuple[int, float]:
    """Kaiser-window FIR order estimate (scipy.signal.kaiserord):
    ``ripple`` dB of allowed deviation, ``width`` transition width as a
    fraction of Nyquist.  Returns (numtaps, beta) for ``firwin``."""
    A = abs(ripple)
    if A < 8:
        raise ValueError(
            "ripple attenuation too small for the Kaiser formula (need >= 8 dB)"
        )
    beta = kaiser_beta(A)
    numtaps = (A - 7.95) / 2.285 / (np.pi * width) + 1
    return int(math.ceil(numtaps)), beta


def firwin2(numtaps: int, freq, gain, nfreqs: Optional[int] = None,
            window: str = "hamming", antisymmetric: bool = False,
            fs: float = 2.0, *, config: SpectralConfig = DEFAULT_CONFIG
            ) -> np.ndarray:
    """Frequency-sampling FIR design (scipy.signal.firwin2): interpolate the
    (freq, gain) samples onto a fine grid, impose linear phase, inverse-rFFT
    (host fp64 — taps are plan constants), window, truncate."""
    freq = np.asarray(freq, np.float64)
    gain = np.asarray(gain, np.float64)
    nyq = 0.5 * fs
    if freq.ndim != 1 or freq.shape != gain.shape:
        raise ValueError("freq and gain must be 1-D arrays of equal length")
    if freq[0] != 0 or freq[-1] != nyq:
        raise ValueError(f"freq must start at 0 and end at fs/2 = {nyq}")
    if np.any(np.diff(freq) < 0):
        raise ValueError("freq must be nondecreasing")
    if numtaps % 2 == 0 and not antisymmetric and gain[-1] != 0:
        raise ValueError("even-numtaps type-II filters need zero gain at Nyquist")
    if antisymmetric:
        if numtaps % 2 == 1 and (gain[0] != 0 or gain[-1] != 0):
            raise ValueError("type-III filters need zero gain at 0 and Nyquist")
        if numtaps % 2 == 0 and gain[0] != 0:
            raise ValueError("type-IV filters need zero gain at 0")
    if nfreqs is None:
        nfreqs = 1 + 2 ** int(math.ceil(math.log2(numtaps)))
    if numtaps > nfreqs:
        raise ValueError("nfreqs must be >= numtaps")
    # break point duplicates (step edges) apart by a tiny eps so np.interp
    # keeps both sides (scipy does the same nudge)
    eps = np.finfo(np.float64).eps * nyq
    f = freq.copy()
    for i in range(1, len(f)):
        if f[i] <= f[i - 1]:
            f[i] = f[i - 1] + eps
    x = np.linspace(0.0, nyq, nfreqs)
    fx = np.interp(x, f, gain)
    shift = np.exp(-(numtaps - 1) / 2.0 * 1j * np.pi * x / nyq)
    if antisymmetric:
        shift *= 1j
    fx2 = fx * shift
    out_full = np.fft.irfft(fx2)  # host fp64 design-time transform
    win = np.asarray(get_window(window, numtaps, sym=True), np.float64) \
        if window is not None else np.ones(numtaps)
    out = out_full[:numtaps] * win
    if antisymmetric and numtaps % 2 == 1:
        out[numtaps // 2] = 0.0
    return out


def firls(numtaps: int, bands, desired, weight=None, fs: float = 2.0
          ) -> np.ndarray:
    """Least-squares linear-phase FIR design (scipy.signal.firls, type I):
    minimizes the weighted integrated squared error against a piecewise-
    linear target.  Host fp64: the normal equations are a Toeplitz+Hankel
    system of closed-form cosine integrals."""
    numtaps = int(numtaps)
    if numtaps % 2 == 0 or numtaps < 1:
        raise ValueError("firls needs an odd number of taps (type-I filter)")
    bands = np.asarray(bands, np.float64).reshape(-1, 2) * (2.0 / fs)
    desired = np.asarray(desired, np.float64).reshape(-1, 2)
    if bands.shape[0] != desired.shape[0]:
        raise ValueError("desired must give a value at each band edge")
    if np.any(bands < 0) or np.any(bands > 1) or np.any(np.diff(bands.ravel()) < 0):
        raise ValueError("bands must be nondecreasing within [0, fs/2]")
    w = np.ones(bands.shape[0]) if weight is None else np.asarray(weight, np.float64)
    if w.shape != (bands.shape[0],):
        raise ValueError("weight must have one entry per band")
    M = (numtaps - 1) // 2

    def int_cos(j: np.ndarray, w1: float, w2: float) -> np.ndarray:
        """∫_{w1}^{w2} cos(jω) dω for an integer vector j (ω in rad)."""
        j = np.asarray(j, np.float64)
        out = np.where(j == 0, w2 - w1, 0.0)
        nz = j != 0
        jn = np.where(nz, j, 1.0)
        out = np.where(nz, (np.sin(jn * w2) - np.sin(jn * w1)) / jn, out)
        return out

    def int_lin_cos(j: np.ndarray, w1: float, w2: float,
                    d1: float, d2: float) -> np.ndarray:
        """∫ (α + βω) cos(jω) dω with the line through (w1,d1)-(w2,d2)."""
        j = np.asarray(j, np.float64)
        beta = (d2 - d1) / (w2 - w1) if w2 > w1 else 0.0
        alpha = d1 - beta * w1
        out = np.where(
            j == 0, alpha * (w2 - w1) + 0.5 * beta * (w2**2 - w1**2), 0.0
        )
        nz = j != 0
        jn = np.where(nz, j, 1.0)
        s2, s1 = np.sin(jn * w2), np.sin(jn * w1)
        c2, c1 = np.cos(jn * w2), np.cos(jn * w1)
        lin = alpha * (s2 - s1) / jn + beta * (
            (c2 - c1) / jn**2 + (w2 * s2 - w1 * s1) / jn
        )
        return np.where(nz, lin, out)

    k = np.arange(M + 1)
    q_idx = np.arange(2 * M + 1)
    q = np.zeros(2 * M + 1)
    bvec = np.zeros(M + 1)
    for (f1, f2), (d1, d2), wt in zip(bands, desired, w):
        w1, w2 = f1 * np.pi, f2 * np.pi
        q += wt * int_cos(q_idx, w1, w2)
        bvec += wt * int_lin_cos(k, w1, w2, d1, d2)
    Q1 = q[np.abs(k[:, None] - k[None, :])]          # Toeplitz
    Q2 = q[k[:, None] + k[None, :]]                  # Hankel
    Q = 0.5 * (Q1 + Q2)
    c = np.linalg.solve(Q, bvec)
    # A(ω) = c0 + Σ c_k cos(kω) ⇒ h symmetric with h[M] = c0, h[M±k] = c_k/2
    h = np.concatenate([c[:0:-1] / 2.0, [c[0]], c[1:] / 2.0])
    return h


def gammatone(freq: float, ftype: str, order: Optional[int] = None,
              numtaps: Optional[int] = None, fs: Optional[float] = None):
    """Gammatone auditory filter (scipy.signal.gammatone): 'fir' samples the
    t^{n−1}e^{−2πbt}cos(2πft) envelope; 'iir' is Slaney's 4th-order cascade
    collapsed to (b, a) — the standard cochlear front-end component."""
    if fs is None:
        fs = 2.0
    fs = float(fs)
    if not 0 < freq < fs / 2:
        raise ValueError(f"freq must be in (0, fs/2), got {freq} at fs={fs}")
    if ftype == "fir":
        if order is None:
            order = 4
        if not 0 < order <= 24:
            raise ValueError(f"order must be in 1..24, got {order}")
        if numtaps is None:
            numtaps = max(int(fs * 0.015), 15)
        t = np.arange(numtaps) / fs
        bw = 1.019 * (freq / 9.26449 + 24.7)  # 1.019 ERB(f), Glasberg-Moore
        h = t ** (order - 1) * np.exp(-2 * np.pi * bw * t) * np.cos(
            2 * np.pi * freq * t
        )
        # scipy's analytic continuous-time peak-gain normalization
        scale = 2 * (2 * np.pi * bw) ** order / math.factorial(order - 1) / fs
        return h * scale, np.ones(1)
    if ftype != "iir":
        raise ValueError(f"ftype must be 'fir' or 'iir', got {ftype!r}")
    # Slaney (1993) 4th-order gammatone as a single (b, a) pair
    T = 1.0 / fs
    bw = 2 * np.pi * 1.019 * (freq / 9.26449 + 24.7)
    fr = 2 * np.pi * freq
    bwT, frT = bw * T, fr * T
    e = np.exp(bwT)
    c, s = np.cos(frT), np.sin(frT)
    sq_p = math.sqrt(3 + 2 ** 1.5)
    sq_m = math.sqrt(3 - 2 ** 1.5)
    a1 = [
        -(2 * T * c / e + 2 * sq_p * T * s / e) / 2,
        -(2 * T * c / e - 2 * sq_p * T * s / e) / 2,
        -(2 * T * c / e + 2 * sq_m * T * s / e) / 2,
        -(2 * T * c / e - 2 * sq_m * T * s / e) / 2,
    ]
    z = np.exp(1j * frT)  # e^{j2πfT}: Slaney's gain rides z and z²
    ez = np.exp(-bwT) * z
    gain = abs(
        (-2 * z * z * T + 2 * ez * T * (c - sq_m * s))
        * (-2 * z * z * T + 2 * ez * T * (c + sq_m * s))
        * (-2 * z * z * T + 2 * ez * T * (c - sq_p * s))
        * (-2 * z * z * T + 2 * ez * T * (c + sq_p * s))
        / (-2 / np.exp(2 * bwT) - 2 * z * z + 2 * (1 + z * z) / e) ** 4
    )
    b = np.array([T])
    for a1i in a1:
        b = np.convolve(b, [1.0, a1i / T])
    b = b * (T ** 3) / gain
    sect = [1.0, -2 * c / e, np.exp(-2 * bwT)]
    a = np.array([1.0])
    for _ in range(4):
        a = np.convolve(a, sect)
    return b, a


def max_len_seq(nbits: int, state=None, length: Optional[int] = None,
                taps=None):
    """Maximum-length LFSR sequence (scipy.signal.max_len_seq): returns
    (seq, final_state) of ±-balanced binary values — the standard broadband
    excitation for transfer-function measurement (host uint8)."""
    _MLS_TAPS = {
        2: [1], 3: [2], 4: [3], 5: [3], 6: [5], 7: [6], 8: [7, 6, 1],
        9: [5], 10: [7], 11: [9], 12: [11, 10, 4], 13: [12, 11, 8],
        14: [13, 12, 2], 15: [14], 16: [15, 13, 4], 17: [14], 18: [11],
        19: [18, 17, 14], 20: [17], 21: [19], 22: [21], 23: [18],
        24: [23, 22, 17], 25: [22], 26: [25, 24, 20], 27: [26, 25, 22],
        28: [25], 29: [27], 30: [29, 28, 7], 31: [28], 32: [31, 30, 10],
    }
    if taps is None:
        if nbits not in _MLS_TAPS:
            raise ValueError(f"nbits must be in 2..32 without taps, got {nbits}")
        taps = _MLS_TAPS[nbits]
    taps = sorted(set(int(t) for t in taps), reverse=True)
    if any(t >= nbits or t < 1 for t in taps):
        raise ValueError("taps must be in [1, nbits)")
    if length is None:
        length = (1 << nbits) - 1
    if state is None:
        st = np.ones(nbits, np.int8)
    else:
        st = (np.asarray(state) != 0).astype(np.int8)
        if st.shape != (nbits,) or not st.any():
            raise ValueError("state must be nbits long and not all-zero")
    # scipy's circular-buffer Fibonacci LFSR: output the current cell, XOR
    # the tap cells into it, advance
    seq = np.empty(length, np.int8)
    idx = 0
    st = st.copy()
    for i in range(length):
        fb = st[idx]
        seq[i] = fb
        for t in taps:
            fb ^= st[(t + idx) % nbits]
        st[idx] = fb
        idx = (idx + 1) % nbits
    return seq, np.roll(st, -idx)


def correlation_lags(in1_len: int, in2_len: int, mode: str = "full"
                     ) -> np.ndarray:
    """Lag axis for a cross-correlation (scipy.signal.correlation_lags)."""
    if mode == "full":
        return np.arange(-in2_len + 1, in1_len)
    if mode == "same":
        lags = np.arange(-in2_len + 1, in1_len)
        mid = lags.size // 2
        h = in1_len // 2
        if in1_len % 2 == 0:
            return lags[mid - h: mid + h]
        return lags[mid - h: mid + h + 1]
    if mode == "valid":
        bound = in1_len - in2_len
        return np.arange(bound + 1) if bound >= 0 else np.arange(bound, 1)
    raise ValueError(f"mode must be full/same/valid, got {mode!r}")


def vectorstrength(events, period):
    """Vector strength of events against periods (scipy.signal.vectorstrength):
    resultant length + angle of events mapped onto the unit circle."""
    events = np.asarray(events, np.float64)
    period = np.asarray(period, np.float64)
    scalar = period.ndim == 0
    period = np.atleast_1d(period)
    if np.any(period <= 0):
        raise ValueError("periods must be positive")
    ang = 2.0 * np.pi * events[None, :] / period[:, None]
    vec = np.exp(1j * ang).mean(axis=1)
    strength, angle = np.abs(vec), np.angle(vec)
    if scalar:
        return float(strength[0]), float(angle[0])
    return strength, angle


def envelope(z, bp_in: Tuple[Optional[int], Optional[int]] = (1, None), *,
             n_out: Optional[int] = None, squared: bool = False,
             residual: Optional[str] = "lowpass", axis: int = -1,
             config: SpectralConfig = DEFAULT_CONFIG):
    """Bandpass envelope + residual of a real/complex signal
    (scipy.signal.envelope, scipy 1.16): restrict the (analytic, for real
    input) spectrum to the fftfreq bin band ``bp_in``, take the magnitude
    of its inverse transform (one engine FFT each way), resampled to
    ``n_out`` by spectral truncation/padding."""
    z = as_tensor(z)
    axis = axis % z.ndim
    n = z.shape[axis]
    if n < 1:
        raise ValueError("envelope needs at least one sample")
    if len(bp_in) != 2 or not all(
            b is None or isinstance(b, (int, np.integer)) for b in bp_in):
        raise ValueError(f"bp_in={bp_in!r} isn't (int | None, int | None)")
    if residual not in ("lowpass", "all", None):
        raise ValueError(f"residual must be 'lowpass', 'all' or None, "
                         f"got {residual!r}")
    n_out = int(n_out) if n_out is not None else n
    if n_out < 1:
        raise ValueError(f"n_out must be positive, got {n_out}")
    fak = n_out / n
    bp0 = int(bp_in[0]) if bp_in[0] is not None else -(n // 2)
    bp1 = int(bp_in[1]) if bp_in[1] is not None else (n + 1) // 2
    if not (-(n // 2) <= bp0 < bp1 <= (n + 1) // 2):
        raise ValueError(
            f"need -n//2 <= bp_in[0] < bp_in[1] <= (n+1)//2 for n={n}, "
            f"got {bp_in}"
        )
    zm = torch.movedim(z, axis, -1)
    complex_in = zm.is_complex()
    key = (n, bp0, bp1)
    if complex_in:
        Z = fft(zm, config=config)
    else:
        zm = zm.to(DTYPE)
        X = rfft(zm, config=config)

        def pos() -> np.ndarray:
            # real input: analytic-signal spectrum (positive band doubled);
            # negative-frequency band components are ignored by construction
            p = np.ones(n // 2 + 1, np.float64)
            if bp0 > 0:
                p[bp0:bp1] = 2.0
            elif bp1 > 0:
                p[1:bp1] = 2.0
            return p

        X = X * constant(pos, zm, key=("envelope.pos",) + key)
        Z = torch.cat([X, X.new_zeros(*X.shape[:-1], n - (n // 2 + 1))], dim=-1)
    # envelope: inverse transform of the band (shift-invariant, so the band
    # is taken in place; a zero-straddling band is fftshifted first)
    if not (bp0 <= 0 < bp1):
        band = Z[..., bp0:bp1]
    else:
        band = fftshift(Z, axes=-1)[..., bp0 + n // 2: bp1 + n // 2]
    z_bb = ifft(band, n=n_out, config=config) * fak
    if squared:
        z_env = z_bb.real ** 2 + z_bb.imag ** 2
    else:
        z_env = torch.abs(z_bb)
    z_env = torch.movedim(z_env, -1, axis)
    if residual is None:
        return z_env

    def mask() -> np.ndarray:
        # residual: zero the band (and everything above it for 'lowpass')
        mk = np.ones(n, np.float64)
        if not (bp0 <= 0 < bp1):
            mk[bp0 % n if bp0 < 0 else bp0:
               (bp1 - 1) % n + 1 if bp1 <= 0 else bp1] = 0.0
        else:
            mk[:bp1] = 0.0
            mk[bp0 % n if bp0 < 0 else bp0:] = 0.0
        if residual == "lowpass":
            if bp1 > 0:
                mk[bp1:(n + 1) // 2] = 0.0
            else:
                mk[bp0 % n if bp0 < 0 else bp0:] = 0.0
                mk[0:(n + 1) // 2] = 0.0
        return mk

    Z = Z * constant(mask, Z.real, key=("envelope.mask", residual) + key)
    if complex_in:
        z_res = resample(Z, n_out, axis=-1, domain="freq", config=config)
        z_env = z_env.to(z_res.dtype)
    else:
        # unpaired Nyquist-class bin correction before the real inverse
        m = min(n, n_out)
        if n_out != n and m % 2 == 0:
            corr = 2.0 if n_out < n else 0.5
            Z = torch.cat([Z[..., : m // 2], Z[..., m // 2: m // 2 + 1] * corr,
                           Z[..., m // 2 + 1:]], dim=-1)
        z_res = irfft(Z[..., : n // 2 + 1], n=n_out, config=config) * fak
    return torch.stack((z_env, torch.movedim(z_res, -1, axis)), dim=0)


def firwin_2d(hsize, window, *, fc=None, fs: float = 2.0,
              circular: bool = False, pass_zero=True,
              scale: bool = True) -> np.ndarray:
    """2-D windowed FIR design (scipy.signal.firwin_2d): separable outer
    product of two 1-D :func:`firwin` designs, or an approximately
    circularly-symmetric kernel by radial interpolation of an 8x-
    oversampled 1-D design.  Host fp64 taps; apply with
    :func:`fft_convolve2`."""
    if len(hsize) != 2:
        raise ValueError("hsize must be a 2-element tuple or list")
    if circular:
        if fc is None:
            raise ValueError("fc is required when circular=True")
        n_r = max(hsize[0], hsize[1]) * 8  # radial profile, 8x oversampled
        win_r = firwin(n_r, fc, window=window, pass_zero=pass_zero,
                       scale=scale, fs=fs)
        f1, f2 = np.meshgrid(np.linspace(-1, 1, hsize[0]),
                             np.linspace(-1, 1, hsize[1]))
        r = np.sqrt(f1**2 + f2**2)
        return np.interp(r, np.linspace(0, 1, n_r), win_r)
    if len(window) != 2 or isinstance(window, str):
        raise ValueError("window must be a 2-element tuple or list when "
                         "circular=False")
    row = firwin(hsize[0], fc, window=window[0], pass_zero=pass_zero,
                 scale=scale, fs=fs)
    col = firwin(hsize[1], fc, window=window[1], pass_zero=pass_zero,
                 scale=scale, fs=fs)
    return np.outer(row, col)


def goertzel(x, freqs, *, fs: float = 1.0, axis: int = -1,
             config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    """DFT evaluated at arbitrary (non-bin) frequencies: the Goertzel-class
    single-bin analysis (DTMF detection, carrier probing) as one dense
    contraction instead of the textbook per-sample recurrence (which is
    serial; the contraction is exactly the same sum
    Σ x[k]·e^{−2πi f k / fs}), in full fp32 whatever the caller's TF32
    setting.

    ``freqs``: scalar or 1-D array in the units of ``fs`` (cycles/sample for
    the default fs=1).  Returns (..., len(freqs)) complex (scalar frequency
    drops the last axis), matching an rfft bin exactly when f lands on one.
    """
    x = as_tensor(x)
    axis = axis % x.ndim
    n = x.shape[axis]
    if isinstance(freqs, torch.Tensor):
        freqs = freqs.detach().cpu().numpy()
    f_arr = np.atleast_1d(np.asarray(freqs, np.float64)) / float(fs)
    if f_arr.ndim != 1:
        raise ValueError("freqs must be a scalar or 1-D array")
    # exact-as-possible phases: reduce f·k mod 1 in fp64 before the cos/sin
    phase = -2.0 * np.pi * np.mod(f_arr[:, None] * np.arange(n)[None, :], 1.0)
    xm = torch.movedim(x, axis, -1)
    like = xm.real if xm.is_complex() else xm
    tw_re = constant(np.cos(phase).T, like)     # (n, F)
    tw_im = constant(np.sin(phase).T, like)
    with fp32_matmul():
        if xm.is_complex():
            xr, xi = xm.real.to(DTYPE), xm.imag.to(DTYPE)
            re = xr @ tw_re - xi @ tw_im
            im = xr @ tw_im + xi @ tw_re
        else:
            xr = xm.to(DTYPE)
            re = xr @ tw_re
            im = xr @ tw_im
    out = torch.complex(re, im)
    if np.isscalar(freqs) or np.ndim(freqs) == 0:
        out = out[..., 0]
    return out


def _tone_bins(spec_mag: np.ndarray, f0_bin: int, width: int):
    lo = max(f0_bin - width, 0)
    hi = min(f0_bin + width + 1, len(spec_mag))
    return slice(lo, hi)


def _purity_spectrum(x, nperseg: Optional[int], config) -> np.ndarray:
    """Blackman-Harris-windowed averaged magnitude-squared half spectrum
    (host fp64 post-processing of one batched engine rfft, on the device of
    ``x`` when it is a tensor, else the card) for the distortion metrics."""
    device = x.device if isinstance(x, torch.Tensor) else None
    x = np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x, np.float64)
    if x.ndim != 1:
        raise ValueError("distortion metrics expect a 1-D signal")
    n = len(x)
    if nperseg is None:
        nperseg = n
    if not 16 <= nperseg <= n:
        raise ValueError(f"need 16 <= nperseg <= len(x), got {nperseg}")
    hop = nperseg
    frames = x[: (n // hop) * hop].reshape(-1, hop)
    frames = frames - frames.mean(axis=-1, keepdims=True)
    # 4-term Blackman-Harris: −92 dB sidelobes so leakage from off-bin
    # tones stays far below realistic noise/distortion floors (Hann's
    # −31 dB first sidelobe poisons any measurement past ~40 dB)
    kk = np.arange(nperseg) / nperseg
    win = (0.35875 - 0.48829 * np.cos(2 * np.pi * kk)
           + 0.14128 * np.cos(4 * np.pi * kk)
           - 0.01168 * np.cos(6 * np.pi * kk))
    F = rfft(as_tensor((frames * win).astype(np.float32), device), config=config)
    return np.mean(np.abs(F.cpu().numpy().astype(np.complex128)) ** 2, axis=0)


def thd(x, *, n_harmonics: int = 6, nperseg: Optional[int] = None,
        config: SpectralConfig = DEFAULT_CONFIG) -> float:
    """Total harmonic distortion in dBc (MATLAB thd convention: power of
    harmonics 2..n_harmonics+1 relative to the fundamental; negative is
    cleaner).  The fundamental is the largest non-DC spectral line."""
    P = _purity_spectrum(x, nperseg, config)
    w = 4  # Blackman-Harris main-lobe half-width in bins
    P = P.copy()
    P[: w + 1] = 0.0  # remove DC leakage
    f0 = int(np.argmax(P))
    fund = P[_tone_bins(P, f0, w)].sum()
    harm = 0.0
    for h in range(2, n_harmonics + 2):
        hb = h * f0
        if hb >= len(P):
            break
        harm += P[_tone_bins(P, hb, w)].sum()
    return 10.0 * np.log10(max(harm, 1e-300) / fund)


def sinad(x, *, nperseg: Optional[int] = None,
          config: SpectralConfig = DEFAULT_CONFIG) -> float:
    """Signal to noise-and-distortion ratio in dB (MATLAB sinad): the
    fundamental line against everything else except DC."""
    P = _purity_spectrum(x, nperseg, config)
    w = 4
    P = P.copy()
    P[: w + 1] = 0.0
    f0 = int(np.argmax(P))
    sl = _tone_bins(P, f0, w)
    fund = P[sl].sum()
    rest = P.sum() - fund
    return 10.0 * np.log10(fund / max(rest, 1e-300))


def sfdr(x, *, nperseg: Optional[int] = None,
         config: SpectralConfig = DEFAULT_CONFIG) -> float:
    """Spurious-free dynamic range in dBc: fundamental over the largest
    remaining spectral line (harmonic or not)."""
    P = _purity_spectrum(x, nperseg, config)
    w = 4
    P = P.copy()
    P[: w + 1] = 0.0
    f0 = int(np.argmax(P))
    sl = _tone_bins(P, f0, w)
    fund_peak = P[f0]
    P[sl] = 0.0
    spur = float(P.max())
    return 10.0 * np.log10(fund_peak / max(spur, 1e-300))


def enob(x, *, nperseg: Optional[int] = None,
         config: SpectralConfig = DEFAULT_CONFIG) -> float:
    """Effective number of bits from SINAD: (SINAD − 1.76)/6.02 — the ADC
    figure of merit."""
    return (sinad(x, nperseg=nperseg, config=config) - 1.76) / 6.02
