"""Quadratic and reassigned time-frequency representations: Wigner-Ville
and the Cohen class, ambiguity, synchrosqueezing (CWT and STFT), the
reassigned spectrogram and the Stockwell transform.

Counterpart of ``mixed_radix_fast_fourier_transform_tpu/ops/tfr.py``.  The
(pseudo-)Wigner-Ville distribution of the analytic signal z:

    W[n, f] = Σ_tau  h[tau] · z[n+tau] · conj(z[n−tau]) · e^{−4πi·f·tau}

— optimal time-frequency concentration for linear chirps, at the price of
cross-terms between components, tamed by the ``window`` h (pseudo-WVD).

Device shape: the lag products gather through host index tables kept on
the device (z[n+tau], z[n−tau]), and the lag axis transforms with one
batched engine FFT; no per-time-step loop.  The synchrosqueezing and
reassignment steps move each cell's value to a data-dependent bin: the JAX
module contracts with a one-hot tensor, here one ``scatter_add`` per plane
(the same sums in another order, without the (…, cells, bins) one-hot).
tftb / Matlab ``wvd`` discrete conventions (odd window, frequency bins
f_k = k·fs/(2·nfreq)).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utils.config import DEFAULT_CONFIG, SpectralConfig
from ..utils.numerics import (
    as_tensor, complex_dtype, constant, host_table, on_host, pad_last, real_dtype,
)
from .fft import fft, fftshift, ifft
from .signal import hilbert
from .stft import get_window

Tensor = torch.Tensor
_CDTYPE = torch.complex64


def _check_lag_window(x: Tensor, nperseg: Optional[int], hop: int, what: str) -> int:
    """The lag-window length (odd; default min(257, largest odd <= T))."""
    if x.ndim < 1 or x.shape[-1] < 3:
        raise ValueError(f"{what} needs a signal of length >= 3")
    T = x.shape[-1]
    if nperseg is None:
        nperseg = min(257, T if T % 2 else T - 1)
    nperseg = int(nperseg)
    if nperseg < 3 or nperseg % 2 == 0:
        raise ValueError(f"nperseg must be odd and >= 3, got {nperseg}")
    if nperseg > T:
        raise ValueError(f"nperseg={nperseg} > signal length {T}")
    if hop < 1:
        raise ValueError(f"hop must be >= 1, got {hop}")
    return nperseg


def _analytic(x: Tensor, analytic: bool, config: SpectralConfig) -> Tensor:
    if analytic and not x.is_complex():
        return hilbert(x, config=config)
    return x.to(_CDTYPE)


def wigner_ville(
    x,
    nperseg: Optional[int] = None,
    hop: int = 1,
    window="hann",
    analytic: bool = True,
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """Pseudo-Wigner-Ville distribution: (…, T) -> (…, n_times, nperseg)
    real array, times n = 0, hop, 2·hop, … and frequency bins
    f_k = k·fs/(2·nperseg) (the lag FFT sees doubled frequencies, so the
    unaliased band is [0, fs/4] for real inputs made analytic; bins above
    nperseg/2 mirror).

    ``nperseg`` (odd; default min(257, largest odd <= T)) is the lag-window
    length — shorter windows smooth cross-terms at some frequency
    resolution cost.  ``analytic=True`` takes the Hilbert analytic signal
    first (halves cross-term interference for real inputs)."""
    x = as_tensor(x)
    nperseg = _check_lag_window(x, nperseg, hop, "wigner_ville")
    T = x.shape[-1]
    z = _analytic(x, analytic, config)
    prod = _lag_products(z, T, nperseg, hop)
    return torch.real(fft(_windowed_lag_roll(prod, nperseg, window), config=config))


def _lag_tables(T: int, nperseg: int, hop: int):
    """Host (ip, im, valid) of the (times × lags −half..half) grid, times
    0, hop, …: indices clipped into the signal, valid where both are."""
    half = nperseg // 2
    times = np.arange(0, T, hop)
    tau = np.arange(-half, half + 1)  # (nperseg,)
    ip = times[:, None] + tau[None, :]
    im = times[:, None] - tau[None, :]
    valid = (ip >= 0) & (ip < T) & (im >= 0) & (im < T)
    return np.clip(ip, 0, T - 1), np.clip(im, 0, T - 1), valid.astype(np.float64)


def _lag_table(T: int, nperseg: int, hop: int, i: int, transposed: bool) -> np.ndarray:
    """Table ``i`` of :func:`_lag_tables`, as (lags × times) if ``transposed``."""
    t = _lag_tables(T, nperseg, hop)[i]
    return t.T.copy() if transposed else t


def _lag_products(z: Tensor, T: int, nperseg: int, hop: int,
                  w: Optional[Tensor] = None) -> Tensor:
    """Instantaneous (cross-)correlation R[t, τ] = z[t+τ]·conj(w[t−τ]) over
    the (times × lags −half..half) grid, zero outside the signal (``w``
    defaults to ``z`` — the auto case)."""
    if w is None:
        w = z
    ip = host_table("tfr.lags", _lag_table, T, nperseg, hop, 0, False, like=z, dtype=torch.int64)
    im = host_table("tfr.lags", _lag_table, T, nperseg, hop, 1, False, like=z, dtype=torch.int64)
    valid = host_table("tfr.lags", _lag_table, T, nperseg, hop, 2, False, like=z,
                       dtype=real_dtype(z.dtype))
    return z[..., ip] * torch.conj(w[..., im]) * valid


def _lag_window(window, nperseg: int) -> np.ndarray:
    """The symmetric lag window, centered at lag 0, with lag 0 first."""
    w = get_window(window, nperseg - 1, np.float64)
    h = np.concatenate([w, w[:1]])  # symmetric, centered at lag 0
    return np.fft.ifftshift(h)  # index 0 is lag 0 after the roll


def _windowed_lag_roll(prod: Tensor, nperseg: int, window) -> Tensor:
    """Apply the symmetric lag window and reorder lags [0..half, −half..−1]
    so the final FFT sees lag 0 first."""
    half = nperseg // 2
    h = _window_table(_lag_window, window, nperseg, "tfr.lag_window", prod,
                      real_dtype(prod.dtype))
    return torch.roll(prod, -half, dims=-1) * h


def xwigner_ville(
    x,
    y,
    nperseg: Optional[int] = None,
    hop: int = 1,
    window="hann",
    analytic: bool = True,
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """Cross-Wigner-Ville distribution of two equal-length signals:
    complex (…, n_times, nperseg), W_xy(t, f) = FFT_τ{x(t+τ)·conj(y(t−τ))}
    — time-frequency coherence/phase analysis between channels (its phase
    carries the local delay; the auto case is :func:`wigner_ville`)."""
    x = as_tensor(x)
    y = as_tensor(y, x.device)
    if x.shape != y.shape:
        raise ValueError("x and y must have the same shape")
    nperseg = _check_lag_window(x, nperseg, hop, "xwigner_ville")
    T = x.shape[-1]
    zx, zy = _analytic(x, analytic, config), _analytic(y, analytic, config)
    prod = _lag_products(zx, T, nperseg, hop, w=zy)
    return fft(_windowed_lag_roll(prod, nperseg, window), config=config)


_COHEN_KERNELS = ("wigner", "choi-williams", "born-jordan")


def _doppler_kernel(kernel: str, sigma: float, T: int, nperseg: int) -> np.ndarray:
    """The ambiguity-domain kernel Φ over (lags, doppler)."""
    half = nperseg // 2
    ell = 2.0 * np.arange(-half, half + 1)          # true lag, samples
    theta = 2.0 * np.pi * np.fft.fftfreq(T)          # doppler, rad/sample
    if kernel == "choi-williams":
        phi = np.exp(-(theta[:, None] * ell[None, :]) ** 2
                     / max(sigma, 1e-12))
    else:  # born-jordan
        arg = theta[:, None] * ell[None, :] / 2.0
        phi = np.sinc(arg / np.pi)  # sin(arg)/arg
    return phi.T


def cohen_class(
    x,
    kernel: str = "choi-williams",
    sigma: float = 1.0,
    nperseg: Optional[int] = None,
    hop: int = 1,
    window="hann",
    analytic: bool = True,
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """Cohen-class time-frequency distribution: a pseudo-Wigner-Ville with
    an ambiguity-domain kernel Φ(ν, τ) that suppresses the WVD's
    oscillatory cross-terms (…, T) → real (…, n_times, nperseg).

    Kernels: ``"wigner"`` (Φ = 1, reproduces :func:`wigner_ville`),
    ``"choi-williams"`` (exponential Φ = exp(−(2πν·ℓ)²/σ); smaller ``sigma``
    = stronger cross-term suppression, more auto-term smearing) and
    ``"born-jordan"`` (sinc Φ).  Pipeline: instantaneous autocorrelation by
    gathers → FFT over TIME to the ambiguity plane → host-precomputed
    kernel multiply → inverse time FFT → windowed lag FFT — four batched
    engine transforms, no data-dependent control flow.  Frequency bins match
    :func:`wigner_ville` (f_k = k·fs/(2·nperseg))."""
    if kernel not in _COHEN_KERNELS:
        raise ValueError(f"kernel must be one of {_COHEN_KERNELS}, "
                         f"got {kernel!r}")
    x = as_tensor(x)
    nperseg = _check_lag_window(x, nperseg, hop, "cohen_class")
    T = x.shape[-1]
    z = _analytic(x, analytic, config)
    if kernel == "wigner":
        # no doppler filtering: only the hop-decimated rows are needed
        prod = _lag_products(z, T, nperseg, hop)
        return torch.real(fft(_windowed_lag_roll(prod, nperseg, window), config=config))
    # the doppler filter needs the FULL time axis; subsample AFTER filtering
    prod = _lag_products(z, T, nperseg, 1)  # (..., T, nperseg)

    phi = host_table("tfr.cohen", _doppler_kernel, kernel, float(sigma), T, nperseg, like=prod,
                     dtype=_CDTYPE)
    A = fft(torch.movedim(prod, -1, -2), config=config)  # over time
    prod = torch.movedim(ifft(A * phi, config=config), -2, -1)
    if hop > 1:
        prod = prod[..., ::hop, :]
    C = fft(_windowed_lag_roll(prod, nperseg, window), config=config)
    return torch.real(C)


def choi_williams(x, sigma: float = 1.0, nperseg: Optional[int] = None,
                  hop: int = 1, window="hann", analytic: bool = True, *,
                  config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    """Choi-Williams exponential distribution — :func:`cohen_class` with the
    exponential kernel."""
    return cohen_class(x, kernel="choi-williams", sigma=sigma,
                       nperseg=nperseg, hop=hop, window=window,
                       analytic=analytic, config=config)


def _morlet_hat(xi: np.ndarray, w: float) -> np.ndarray:
    """Analytic Morlet in frequency: pi^{-1/4}·exp(-(xi-w)²/2) for xi > 0."""
    out = np.pi ** -0.25 * np.exp(-0.5 * (xi - w) ** 2)
    return np.where(xi > 0, out, 0.0)


def _morlet_bank(T: int, n_scales: int, fmin: float, fmax: float, w: float,
                 i: int) -> np.ndarray:
    """i·ξ (``i`` 0), the rad/sample frequencies times i, or the (S, T)
    Morlet bank in frequency (``i`` 1) on the log-spaced scale ladder."""
    xi = 2.0 * np.pi * np.fft.fftfreq(T)  # rad/sample
    if i == 0:
        return 1j * xi
    # scales: wavelet peak at a·xi = w  ->  a_j = w / (2π f_j)
    f_sc = np.exp(np.linspace(np.log(fmin), np.log(fmax), n_scales))
    scales = w / (2.0 * np.pi * f_sc)
    return np.stack([_morlet_hat(a * xi, w) for a in scales])  # (S, T) real


def _log_ladder(fmin: float, fmax: float, n_freqs: int):
    """(log fmin, the log step) of the squeeze's frequency bins."""
    return float(np.log(fmin)), float((np.log(fmax) - np.log(fmin)) / (n_freqs - 1))


def _squeeze(values: Tensor, idx: Tensor, keep: Tensor, n_bins: int, dim: int) -> Tensor:
    """Σ of ``values`` over the cells that ``idx`` sends to each of
    ``n_bins`` bins along ``dim`` (cells outside ``keep`` dropped): the JAX
    module's one-hot contraction as one scatter-add per real plane."""
    shape = list(values.shape)
    shape[dim] = n_bins
    index = idx.to(torch.int64)

    def plane(v: Tensor) -> Tensor:
        v = torch.where(keep, v, torch.zeros_like(v))
        return v.new_zeros(shape).scatter_add_(dim, index, v)

    if values.is_complex():
        return torch.complex(plane(values.real), plane(values.imag))
    return plane(values)


def ssq_cwt(
    x,
    n_scales: int = 64,
    n_freqs: Optional[int] = None,
    fmin: float = 1.0 / 512.0,
    fmax: float = 0.5,
    w: float = 6.0,
    gamma: float = 1e-4,
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
):
    """Synchrosqueezed continuous wavelet transform: (…, T) ->
    ``(S, freqs)`` with S complex (…, n_freqs, T) and ``freqs`` the
    log-spaced bin centers in cycles/sample (host numpy, float64; under
    ``torch.compile`` the same values, a view of a table the library keeps:
    read it, do not write it).

    The Morlet CWT and its exact time derivative are computed in the
    frequency domain (one batched engine FFT + 2·n_scales ifft rows); the
    phase transform ω(a, b) = Im(∂_b W / W)/2π reassigns each (scale,
    time) cell to its nearest log-frequency bin, and the squeeze sums the
    cells of each bin.  Cells with |W| <= gamma·max|W| are dropped.
    Conventions follow ssqueezepy's log-frequency ladder (S sums W over
    reassigned cells)."""
    x = as_tensor(x)
    if x.ndim < 1 or x.shape[-1] < 8:
        raise ValueError("ssq_cwt needs a signal of length >= 8")
    if not 0.0 < fmin < fmax <= 0.5:
        raise ValueError(
            f"need 0 < fmin < fmax <= 0.5 cycles/sample, got {fmin}, {fmax}"
        )
    if n_scales < 2:
        raise ValueError(f"n_scales must be >= 2, got {n_scales}")
    if n_freqs is None:
        n_freqs = n_scales
    if n_freqs < 2:
        raise ValueError(f"n_freqs must be >= 2, got {n_freqs}")
    T = x.shape[-1]
    z = x.to(_CDTYPE) if x.is_complex() else hilbert(x, config=config)
    X = fft(z, config=config)  # (…, T)

    key = (T, n_scales, float(fmin), float(fmax), float(w))
    psid = host_table("tfr.ssq_cwt", _morlet_bank, *key, 1, like=X, dtype=real_dtype(X.dtype))
    dxi = host_table("tfr.ssq_cwt", _morlet_bank, *key, 0, like=X, dtype=X.dtype)
    Wf = X[..., None, :] * psid  # (…, S, T) spectra (psi real: cheap)
    Wt = ifft(Wf, config=config)  # CWT rows
    dWt = ifft(Wf * dxi, config=config)
    wr, wi = Wt.real, Wt.imag
    dr, di = dWt.real, dWt.imag
    mag2 = wr * wr + wi * wi
    # ω = Im(dW / W) / 2π  (cycles/sample)
    omega = (di * wr - dr * wi) / (2.0 * np.pi * torch.clamp(mag2, min=1e-30))
    thresh = gamma * torch.sqrt(torch.amax(mag2, dim=(-2, -1), keepdim=True))
    alive = mag2 > thresh * thresh
    # nearest log-frequency bin
    log_fmin, dlf = on_host(_log_ladder, float(fmin), float(fmax), n_freqs)
    pos = torch.log(torch.clamp(omega, min=1e-30))
    idx = torch.round((pos - log_fmin) / dlf)
    in_range = (idx >= 0) & (idx <= n_freqs - 1) & alive & (omega > 0)
    idx = torch.clamp(idx, 0, n_freqs - 1)
    return _squeeze(Wt, idx, in_range, n_freqs, -2), _bin_centres(float(fmin), float(fmax), n_freqs)


def _log_bins(fmin: float, fmax: float, n_freqs: int) -> np.ndarray:
    """The squeeze's log-spaced bin centers in cycles/sample (host fp64)."""
    return np.exp(np.linspace(np.log(fmin), np.log(fmax), n_freqs))


def _bin_centres(fmin: float, fmax: float, n_freqs: int) -> np.ndarray:
    """:func:`_log_bins` as a new host array.  While dynamo traces, the
    kept host table of the same values on the CPU, which the graph hands
    back as it is: built in the graph, the array would need a kernel for
    the host (which Inductor could not build on every machine) and would
    round otherwise than numpy's."""
    if torch.compiler.is_dynamo_compiling():
        return host_table("tfr.ssq_cwt_bins", _log_bins, fmin, fmax, n_freqs,
                          like=torch.device("cpu"), dtype=torch.float64).numpy()
    return _log_bins(fmin, fmax, n_freqs)


def _window_derivative(w: np.ndarray) -> np.ndarray:
    """d/dj of a periodic window, exact in the DFT basis (host fp64)."""
    n = len(w)
    return np.fft.irfft(
        np.fft.rfft(w) * (2j * np.pi * np.fft.rfftfreq(n)), n=n
    )


def _centered_frames(x: Tensor, nperseg: int, hop: int, n_frames: int,
                     config: SpectralConfig) -> Tensor:
    """Frames aligned with ``stft(center=True)``: frame m's sample j is
    original sample m·hop + j − nperseg//2 (reflect-padded edges)."""
    from .stft import _frame

    xm = pad_last(x.to(config.dtype), nperseg // 2, nperseg // 2, "reflect")
    t = xm.shape[-1]
    full = nperseg + (n_frames - 1) * hop
    if full > t:
        xm = pad_last(xm, 0, full - t)
    return _frame(xm, nperseg, hop)[..., :n_frames, :]


def _center_phase(nperseg: int) -> np.ndarray:
    return np.exp(2j * np.pi * np.arange(nperseg // 2 + 1) * (nperseg // 2) / nperseg)


def _frame_center_phase(nperseg: int, like: Tensor) -> Tensor:
    """e^{2πik·c/n}, c = nperseg//2: references bins to the frame center."""
    return host_table("tfr.center_phase", _center_phase, nperseg, like=like, dtype=like.dtype)


def _window_table(build, window, nperseg: int, name: str, like: Tensor, dtype=None) -> Tensor:
    """``build(window, nperseg)`` beside ``like`` (at ``dtype``, default
    like's): kept by name for a named window (built on the host also while
    dynamo traces), uploaded per call for a caller's array."""
    dtype = like.dtype if dtype is None else dtype
    if isinstance(window, (str, tuple)):
        return host_table(name, build, window, nperseg, like=like, dtype=dtype)
    return constant(build(window, nperseg), like, dtype)


def _derivative_window(window, nperseg: int) -> np.ndarray:
    return _window_derivative(get_window(window, nperseg, np.float64))


def _time_window(window, nperseg: int) -> np.ndarray:
    return (np.arange(nperseg) - nperseg // 2) * get_window(window, nperseg, np.float64)


def _rfft_grid(nperseg: int) -> np.ndarray:
    return np.fft.rfftfreq(nperseg)


def ssq_stft(
    x,
    nperseg: int = 256,
    noverlap: Optional[int] = None,
    window="hann",
    gamma: float = 1e-4,
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
):
    """Synchrosqueezed STFT: (…, T) -> (S, freqs) with S complex
    (…, n_frames, nperseg//2+1) and ``freqs`` in cycles/sample.

    The phase transform ω(f, t) = f − Im(S_dw/S)/2π (S_dw the STFT taken
    with the window's derivative) reassigns each cell to its nearest
    LINEAR frequency bin; the squeeze sums the cells of each bin, as
    :func:`ssq_cwt` does, here over the frequency axis.

    Phase convention: bins are referenced to the FRAME CENTER (the
    modified STFT S·e^{2πik·c/n}, c = nperseg//2 — a (−1)^k sign flip for
    even nperseg).  This makes the squeezed coefficients bin-sum
    invertible: :func:`issq_stft` reconstructs the signal at the frame
    centers by a plain sum over frequency bins."""
    from .rfft import rfft as _rfft
    from .stft import stft as _stft

    x = as_tensor(x)
    if x.is_complex():
        raise ValueError("ssq_stft takes real signals")
    if noverlap is None:
        noverlap = nperseg - max(1, nperseg // 8)
    S = _stft(x, nperseg, noverlap, window, center=True, config=config)
    hop = nperseg - noverlap
    frames = _centered_frames(x, nperseg, hop, S.shape[-2], config)
    # derivative-window STFT: d/dt of the periodic window, host fp64
    wd = _window_table(_derivative_window, window, nperseg, "tfr.window_derivative", frames)
    Sd = _rfft(frames * wd, config=config)
    # reference phases to the frame center (modified STFT): bin-sum
    # reconstruction then needs no per-bin phase factor (see issq_stft)
    cmod = _frame_center_phase(nperseg, S)
    S = S * cmod
    Sd = Sd * cmod
    sr, si = S.real, S.imag
    dr, di = Sd.real, Sd.imag
    mag2 = sr * sr + si * si
    nb = S.shape[-1]
    fg = host_table("tfr.rfftfreq", _rfft_grid, nperseg, like=S, dtype=real_dtype(S.dtype))
    omega = fg - (di * sr - dr * si) / (2.0 * np.pi * torch.clamp(mag2, min=1e-30))
    thresh = gamma * torch.sqrt(torch.amax(mag2, dim=(-2, -1), keepdim=True))
    alive = mag2 > thresh * thresh
    idx = torch.round(omega / (1.0 / nperseg))       # the grid's step, rfftfreq(nperseg)[1]
    in_range = (idx >= 0) & (idx <= nb - 1) & alive
    idx = torch.clamp(idx, 0, nb - 1)
    return _squeeze(S, idx, in_range, nb, -1), np.fft.rfftfreq(nperseg)


def issq_cwt(
    S,
    n_scales: int = 64,
    fmin: float = 1.0 / 512.0,
    fmax: float = 0.5,
    w: float = 6.0,
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
):
    """Inverse synchrosqueezed CWT: Daubechies' one-integral formula.

    Because :func:`ssq_cwt` squeezes an amplitude-preserving (L1) Morlet
    CWT over a LOG-spaced scale ladder, summing the squeezed plane over
    frequency bins recovers Σ_j W(a_j, b) — and with Δln a constant,

        x(b) ≈ Re[ (Δln a / C_ψ) · Σ_k S(k, b) ],   C_ψ = ∫₀^∞ ψ̂(u) du/u,

    one dense reduction.  Pass the SAME analysis parameters (``n_scales``,
    ``fmin``, ``fmax``, ``w``) used at :func:`ssq_cwt` time; accurate for
    content whose frequencies lie in the interior of the [fmin, fmax]
    ladder (the scale integral is truncated at the ladder ends)."""
    S = as_tensor(S)
    if not 0.0 < fmin < fmax <= 0.5:
        raise ValueError(
            f"need 0 < fmin < fmax <= 0.5 cycles/sample, got {fmin}, {fmax}"
        )
    if n_scales < 2:
        raise ValueError(f"n_scales must be >= 2, got {n_scales}")
    dloga = (np.log(fmax) - np.log(fmin)) / (n_scales - 1)
    # C_ψ by host fp64 quadrature (integrand a Gaussian bump at u = w)
    u = np.linspace(1e-4, w + 15.0, 200_001)
    trapz = getattr(np, "trapezoid", None) or np.trapz  # numpy<2 compat
    c_psi = float(trapz(_morlet_hat(u, w) / u, u))
    return torch.sum(torch.real(S), dim=-2) * float(dloga / c_psi)


def issq_stft(
    S,
    nperseg: int = 256,
    window="hann",
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
):
    """Inverse synchrosqueezed STFT: (…, n_frames, nperseg//2+1) ->
    (…, n_frames), the signal sampled AT THE FRAME CENTERS t_m = m·hop
    (pass hop=1 at analysis time for a full-rate reconstruction).

    :func:`ssq_stft` coefficients are frame-center referenced, so the
    full-spectrum inversion Σ_k S_full[k] = n·x(t_m)·w[c] needs only the
    one-sided-to-full weights (2 everywhere but DC/Nyquist):

        x(t_m) = (2·Re Σ_k S[m,k] − Re S[m,0] − Re S[m,n/2]) / (n·w[c]).
    """
    S = as_tensor(S)
    nb = S.shape[-1]
    if nb != nperseg // 2 + 1:
        raise ValueError(
            f"S has {nb} bins; expected nperseg//2+1 = {nperseg // 2 + 1}"
        )
    wvals = get_window(window, nperseg, np.float64)
    wc = float(wvals[nperseg // 2])
    if abs(wc) < 1e-12:
        raise ValueError("window vanishes at the frame center; not invertible")
    sr = torch.real(S)
    total = 2.0 * torch.sum(sr, dim=-1) - sr[..., 0]
    if nperseg % 2 == 0:
        total = total - sr[..., -1]
    return total / float(nperseg * wc)


def reassigned_spectrogram(
    x,
    nperseg: int = 256,
    noverlap: Optional[int] = None,
    window="hann",
    gamma: float = 1e-4,
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
):
    """Time-frequency reassigned spectrogram (Auger-Flandrin):
    (…, T) -> (E, freqs) with E real (…, n_frames, nperseg//2+1), frame m
    centered on sample m·hop and ``freqs`` in cycles/sample.

    Each spectrogram cell's ENERGY |S|² moves to its local center of
    gravity: frequency ω̂ = f − Im(S_dw/S)/2π (derivative-window STFT) and
    time t̂ = t_m + Re(S_tw/S) (time-weighted-window STFT) — impulses
    collapse to their true frame, chirps to their instantaneous-frequency
    ridge, in BOTH axes.  Frame offsets are bounded by the window
    half-length c (|offset| <= ⌈c/hop⌉); the relocation is one scatter-add
    into the (frames, bins) plane.  Cells with |S| <= gamma·max|S| or
    targets outside the plane are dropped, as in the reassignment
    literature (librosa.reassigned_spectrogram semantics with energy
    accumulation instead of coordinate output)."""
    from .rfft import rfft as _rfft
    from .stft import stft as _stft

    x = as_tensor(x)
    if x.is_complex():
        raise ValueError("reassigned_spectrogram takes real signals")
    if noverlap is None:
        noverlap = nperseg - max(1, nperseg // 8)
    S = _stft(x, nperseg, noverlap, window, center=True, config=config)
    hop = nperseg - noverlap
    n_frames = S.shape[-2]
    nb = S.shape[-1]
    c = nperseg // 2
    frames = _centered_frames(x, nperseg, hop, n_frames, config)
    wd = _window_table(_derivative_window, window, nperseg, "tfr.window_derivative", frames)
    wt = _window_table(_time_window, window, nperseg, "tfr.window_time", frames)
    Sd = _rfft(frames * wd, config=config)
    St = _rfft(frames * wt, config=config)
    sr, si = S.real, S.imag
    dr, di = Sd.real, Sd.imag
    tr, ti = St.real, St.imag
    mag2 = sr * sr + si * si
    denom = torch.clamp(mag2, min=1e-30)
    fg = host_table("tfr.rfftfreq", _rfft_grid, nperseg, like=S, dtype=real_dtype(S.dtype))
    omega = fg - (di * sr - dr * si) / (2.0 * np.pi * denom)
    dt = (tr * sr + ti * si) / denom  # Re(St/S), samples
    thresh = gamma * torch.sqrt(torch.amax(mag2, dim=(-2, -1), keepdim=True))
    alive = mag2 > thresh * thresh
    fidx = torch.round(omega / (1.0 / nperseg))      # the grid's step
    f_ok = (fidx >= 0) & (fidx <= nb - 1) & alive
    fidx = torch.clamp(fidx, 0, nb - 1)
    off = torch.round(dt / hop)  # frame offset of the reassigned time
    max_off = -(-c // hop)
    keep = f_ok & (off.abs() <= max_off)
    # target cell in a (n_frames + 2·max_off, nb) plane, flattened
    t = torch.arange(n_frames, device=S.device, dtype=off.dtype)[:, None]
    target = (t + off.clamp(-max_off, max_off) + max_off) * nb + fidx
    lead = mag2.shape[:-2]
    flat = _squeeze(mag2.reshape(*lead, -1), target.reshape(*lead, -1),
                    keep.reshape(*lead, -1), (n_frames + 2 * max_off) * nb, -1)
    total = flat.reshape(*lead, n_frames + 2 * max_off, nb)
    return total[..., max_off: max_off + n_frames, :], np.fft.rfftfreq(nperseg)


def _voice_table(T: int, fmin: int, fmax: int, gamma: float, i: int) -> np.ndarray:
    """The voice windows in frequency, Gaussians of width k/γ (``i`` 0), or
    the spectrum rows each voice reads (``i`` 1)."""
    ks = np.arange(fmin, fmax + 1)
    idx = np.arange(T)
    j = np.where(idx < (T + 1) // 2, idx, idx - T)  # signed bin offsets
    if i == 1:
        return (j[None, :] + ks[:, None]) % T
    return np.exp(-2.0 * (np.pi * gamma * j[None, :].astype(np.float64)) ** 2
                  / np.maximum(ks[:, None], 1) ** 2)


def stockwell(
    x,
    fmin: int = 0,
    fmax: Optional[int] = None,
    gamma: float = 1.0,
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
):
    """Stockwell transform (S-transform): (…, T) -> (S, freqs) with S
    complex (…, K, T), rows the voice at each rfft bin k ∈ [fmin, fmax]
    (default the full one-sided ladder) and ``freqs`` in cycles/sample.

    The S-transform is an STFT whose Gaussian window scales with frequency
    (σ_f = f/γ — constant relative bandwidth like the CWT, but keeping the
    Fourier phase reference at t=0):

        S[k, t] = ifft_j( X[(j+k) mod T] · e^{−2π²γ²j²/k²} )[t] ,

    row k=0 carrying the mean.  Device shape: one engine FFT, a host-index
    roll gather to (K, T), a host Gaussian voice-window table, and one
    batched engine ifft over rows — no loops.  Row sums recover X[k]
    exactly (the window is 1 at j=0), so :func:`istockwell` inverts
    losslessly when all rows are kept (Stockwell 1996 Eq. 19).

    ``gamma`` > 1 widens the window in time — σ_t = γ/(2πf) — trading
    event localization for sharper frequencies."""
    x = as_tensor(x)
    if x.is_complex():
        raise ValueError("stockwell takes real signals")
    if x.ndim < 1 or x.shape[-1] < 4:
        raise ValueError("stockwell needs a signal of length >= 4")
    T = x.shape[-1]
    nb = T // 2 + 1
    if fmax is None:
        fmax = nb - 1
    if not (0 <= fmin <= fmax <= nb - 1):
        raise ValueError(
            f"need 0 <= fmin <= fmax <= {nb - 1}, got {fmin}, {fmax}"
        )
    if gamma <= 0:
        raise ValueError(f"gamma must be > 0, got {gamma}")
    z = x.to(config.dtype)
    X = fft(z.to(complex_dtype(z.dtype)), config=config)
    key = (T, int(fmin), int(fmax), float(gamma))
    G = host_table("tfr.stockwell", _voice_table, *key, 0, like=X, dtype=real_dtype(X.dtype))
    rows = host_table("tfr.stockwell", _voice_table, *key, 1, like=X, dtype=torch.int64)
    S = ifft(X[..., rows] * G, config=config)
    if fmin == 0:
        # k=0 voice: the literature keeps the plain mean, not a window
        mean_row = torch.mean(z, dim=-1, keepdim=True)[..., None, :]
        mean_row = mean_row.expand(*S.shape[:-2], 1, T).to(S.dtype)
        S = torch.cat([mean_row, S[..., 1:, :]], dim=-2)
    # the voices' frequencies k/T as rfftfreq's, which Inductor leaves to an
    # aten call: a division it would build as a C++ kernel for the host
    return S, np.fft.rfftfreq(T)[fmin: fmax + 1]


def istockwell(
    S,
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
):
    """Invert a FULL-ladder :func:`stockwell` transform: (…, T//2+1, T) ->
    (…, T) real.  Time-marginals of each voice recover the spectrum
    (Σ_t S[k, t] = X[k]); one engine irfft finishes."""
    from .rfft import irfft as _irfft

    S = as_tensor(S)
    if S.ndim < 2:
        raise ValueError("S must be (…, K, T)")
    nb, T = S.shape[-2], S.shape[-1]
    if nb != T // 2 + 1:
        raise ValueError(
            f"istockwell needs the full one-sided ladder: {T // 2 + 1} rows "
            f"for T={T}, got {nb}"
        )
    Xh = torch.sum(S, dim=-1)
    # row 0 holds the mean replicated across time: its sum is T·mean = X[0]
    return _irfft(Xh, n=T, config=config)


def ambiguity(
    x,
    max_lag: Optional[int] = None,
    analytic: bool = True,
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """Narrowband ambiguity function A[τ, ν] = Σ_t z[t+τ]·z*[t−τ]·e^{−2πiνt/T}:
    (…, T) -> complex (…, 2·max_lag+1, T), lag axis τ = −max_lag..max_lag
    (in HALF-lag units like the discrete WVD — effective delay 2τ) and
    doppler bins ν = fftfreq(T)·T cycles (fftshifted to center zero).

    The dual of :func:`wigner_ville` (they are a 2-D Fourier pair): matched
    filters and delay-doppler radar maps read straight off it.  Same device
    shape as the WVD — lag-index gathers, one batched engine FFT along TIME
    per lag row."""
    x = as_tensor(x)
    if x.ndim < 1 or x.shape[-1] < 3:
        raise ValueError("ambiguity needs a signal of length >= 3")
    T = x.shape[-1]
    if max_lag is None:
        max_lag = min(128, (T - 1) // 2)
    max_lag = int(max_lag)
    if not 1 <= max_lag <= (T - 1) // 2:
        raise ValueError(f"need 1 <= max_lag <= {(T - 1) // 2}, got {max_lag}")
    z = _analytic(x, analytic, config)
    # the (lags × times) grid is the WVD's (times × lags) one transposed
    lags = 2 * max_lag + 1
    ip = host_table("tfr.lags", _lag_table, T, lags, 1, 0, True, like=z, dtype=torch.int64)
    im = host_table("tfr.lags", _lag_table, T, lags, 1, 1, True, like=z, dtype=torch.int64)
    valid = host_table("tfr.lags", _lag_table, T, lags, 1, 2, True, like=z,
                       dtype=real_dtype(z.dtype))
    prod = z[..., ip] * torch.conj(z[..., im]) * valid
    A = fft(prod, config=config)  # doppler transform along time
    return fftshift(A, axes=-1)
