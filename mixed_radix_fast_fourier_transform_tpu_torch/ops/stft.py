"""Short-time Fourier transform family: stft / istft / spectrogram,
Griffin-Lim phase retrieval, the phase vocoder and time stretching, and the
host-side window functions.

Counterpart of ``mixed_radix_fast_fourier_transform_tpu/ops/stft.py``.
Framing is a strided view (``Tensor.unfold``) that the window product makes
contiguous, so the whole signal is one (frames, nperseg) batch of the
library's rfft; istft is a windowed overlap-add (``index_add_``, whose
atomic adds on the card are not bit-reproducible, within rounding though)
with the standard NOLA normalization.  Every transform goes through the
engine: no library FFT computes a result here.  Windows and DPSS tapers are
numpy float64 on the host, as in the JAX module.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from ..utils.config import DEFAULT_CONFIG, SpectralConfig
from ..utils.numerics import as_tensor, constant, host_table, on_host, pad_last
from ..utils.sharding import batch_sharded, dtensor, last_axis, last_two, local_placed
from .rfft import irfft, rfft

Tensor = torch.Tensor


def _sym_triang(m: int) -> np.ndarray:
    n = np.arange(1, (m + 1) // 2 + 1, dtype=np.float64)
    if m % 2 == 0:
        w = (2 * n - 1.0) / m
        return np.concatenate([w, w[::-1]])
    w = 2 * n / (m + 1.0)
    return np.concatenate([w, w[-2::-1]])


def _sym_parzen(m: int) -> np.ndarray:
    n = np.arange(-(m - 1) / 2.0, (m - 1) / 2.0 + 0.5, 1.0)
    na = np.abs(n) / (m / 2.0)
    outer = 2.0 * (1.0 - na) ** 3
    inner = 1.0 - 6.0 * na**2 + 6.0 * na**3
    return np.where(np.abs(n) <= (m - 1) / 4.0, inner, outer)


def _sym_bohman(m: int) -> np.ndarray:
    fac = np.abs(np.linspace(-1.0, 1.0, m))
    w = (1.0 - fac) * np.cos(np.pi * fac) + np.sin(np.pi * fac) / np.pi
    w[0] = w[-1] = 0.0
    return w


def _sym_cosine(m: int) -> np.ndarray:
    return np.sin(np.pi / m * (np.arange(m) + 0.5))


def _sym_barthann(m: int) -> np.ndarray:
    fac = np.abs(np.arange(m, dtype=np.float64) / (m - 1.0) - 0.5)
    return 0.62 - 0.48 * fac + 0.38 * np.cos(2 * np.pi * fac)


def _sym_lanczos(m: int) -> np.ndarray:
    return np.sinc(2 * np.arange(m, dtype=np.float64) / (m - 1.0) - 1.0)


def _sym_nuttall(m: int) -> np.ndarray:
    a = (0.3635819, 0.4891775, 0.1365995, 0.0106411)
    fac = np.linspace(-np.pi, np.pi, m)
    return sum(a[k] * np.cos(k * fac) for k in range(4))


def _sym_exponential(m: int, tau: float) -> np.ndarray:
    n = np.arange(m, dtype=np.float64)
    return np.exp(-np.abs(n - (m - 1) / 2.0) / tau)


def _sym_chebwin(m: int, at: float) -> np.ndarray:
    """Dolph-Chebyshev window of ``at`` dB sidelobe attenuation (scipy's
    frequency-sampling construction: T_{m-1} on the scaled cosine grid,
    one real DFT back, peak-normalized)."""
    if np.abs(10 ** (np.abs(at) / 20.0)) > 1e150:
        raise ValueError("chebwin attenuation too large")
    order = m - 1.0
    beta = np.cosh(1.0 / order * np.arccosh(10 ** (np.abs(at) / 20.0)))
    k = np.arange(m, dtype=np.float64)
    x = beta * np.cos(np.pi * k / m)
    p = np.zeros_like(x)
    gt = x > 1
    lt = x < -1
    mid = ~(gt | lt)
    p[gt] = np.cosh(order * np.arccosh(x[gt]))
    p[lt] = (2 * (m % 2) - 1) * np.cosh(order * np.arccosh(-x[lt]))
    p[mid] = np.cos(order * np.arccos(x[mid]))
    if m % 2:
        w = np.real(np.fft.fft(p))
        n = (m + 1) // 2
        w = w[:n]
        w = np.concatenate([w[n - 1 : 0 : -1], w])
    else:
        p = p * np.exp(1j * np.pi / m * np.arange(m))
        w = np.real(np.fft.fft(p))
        n = m // 2 + 1
        w = np.concatenate([w[n - 1 : 0 : -1], w[1:n]])
    return w / np.max(w)


_SYM_WINDOWS = {
    "triang": _sym_triang,
    "parzen": _sym_parzen,
    "bohman": _sym_bohman,
    "cosine": _sym_cosine,
    "barthann": _sym_barthann,
    "lanczos": _sym_lanczos,
    "nuttall": _sym_nuttall,
}


def get_window(window, nperseg: int, dtype=np.float32, *, sym: bool = False) -> np.ndarray:
    """Named window ('hann', 'hamming', 'blackman', 'blackmanharris',
    'bartlett', 'flattop', 'boxcar', 'triang', 'parzen', 'bohman',
    'cosine', 'barthann', 'lanczos', 'nuttall', ('kaiser', beta),
    ('tukey', alpha), ('gaussian', std), ('exponential', tau),
    ('chebwin', attenuation_dB)) or an explicit array — scipy.signal
    window set.  Periodic (DFT-even) convention by default, matching
    scipy's spectral estimators; ``sym=True`` returns the symmetric
    (filter-design) variant — a symmetric window of length n is the
    periodic window of length n-1 with its (symmetric) first sample
    appended."""
    if sym:
        if not isinstance(window, (str, tuple)):
            w = np.asarray(window, dtype=dtype)
            if w.shape != (nperseg,):
                raise ValueError(f"window shape {w.shape} != ({nperseg},)")
            return w
        if nperseg < 2:
            return np.ones(nperseg, dtype)
        wp = get_window(window, nperseg - 1, np.float64)
        return np.concatenate([wp, wp[:1]]).astype(dtype)
    if nperseg < 2 and isinstance(window, (str, tuple)):
        # scipy's length guard: every named window degenerates to ones
        # (the periodic formulas would return their left-edge sample)
        return np.ones(max(nperseg, 0), dtype)
    if isinstance(window, tuple):
        name, *params = window
        if name == "exponential":
            # ("exponential", tau) or scipy's ("exponential", None, tau);
            # custom centers are not supported (they break the periodic
            # drop-last identity)
            if len(params) == 2 and params[0] is None:
                tau = float(params[1])
            elif len(params) == 1 and params[0] is not None:
                tau = float(params[0])
            else:
                raise ValueError(f"unsupported exponential window {window!r}")
            return _sym_exponential(nperseg + 1, tau)[:nperseg].astype(dtype)
        if len(params) != 1 or name not in (
            "kaiser", "tukey", "gaussian", "chebwin"
        ):
            raise ValueError(f"unknown parameterized window {window!r}")
        if name == "chebwin":
            return _sym_chebwin(nperseg + 1, float(params[0]))[:nperseg].astype(dtype)
        n = np.arange(nperseg, dtype=np.float64)
        if name == "kaiser":
            beta = float(params[0])
            ratio = 2.0 * n / nperseg - 1.0
            w = np.i0(beta * np.sqrt(np.maximum(1.0 - ratio ** 2, 0.0))) / np.i0(beta)
        elif name == "tukey":
            # periodic = symmetric length nperseg+1 with the last point dropped
            alpha = float(params[0])
            if alpha <= 0:
                w = np.ones(nperseg)
            elif alpha >= 1:
                w = 0.5 - 0.5 * np.cos(2 * np.pi * n / nperseg)
            else:
                edge = alpha * nperseg / 2.0
                w = np.ones(nperseg)
                lo = n < edge
                w[lo] = 0.5 * (1 + np.cos(np.pi * (n[lo] / edge - 1.0)))
                hi = n > nperseg - edge
                w[hi] = 0.5 * (1 + np.cos(np.pi * ((nperseg - n[hi]) / edge - 1.0)))
        else:  # gaussian
            std = float(params[0])
            w = np.exp(-0.5 * ((n - nperseg / 2.0) / std) ** 2)
        return w.astype(dtype)
    if isinstance(window, str):
        n = np.arange(nperseg, dtype=np.float64)
        ph = 2 * np.pi * n / nperseg
        if window == "hann":
            w = 0.5 - 0.5 * np.cos(ph)
        elif window == "hamming":
            w = 0.54 - 0.46 * np.cos(ph)
        elif window == "blackman":
            w = 0.42 - 0.5 * np.cos(ph) + 0.08 * np.cos(2 * ph)
        elif window == "blackmanharris":
            w = (0.35875 - 0.48829 * np.cos(ph) + 0.14128 * np.cos(2 * ph)
                 - 0.01168 * np.cos(3 * ph))
        elif window == "flattop":
            w = (0.21557895 - 0.41663158 * np.cos(ph) + 0.277263158 * np.cos(2 * ph)
                 - 0.083578947 * np.cos(3 * ph) + 0.006947368 * np.cos(4 * ph))
        elif window == "bartlett":
            w = 1.0 - np.abs(2.0 * n / nperseg - 1.0)
        elif window == "boxcar":
            w = np.ones(nperseg)
        elif window in _SYM_WINDOWS:
            # periodic = symmetric length n+1 with the last point dropped
            w = _SYM_WINDOWS[window](nperseg + 1)[:nperseg]
        else:
            raise ValueError(f"unknown window {window!r}")
        return w.astype(dtype)
    w = np.asarray(window, dtype=dtype)
    if w.shape != (nperseg,):
        raise ValueError(f"window shape {w.shape} != ({nperseg},)")
    return w


def _as_real(x, what: str, dtype) -> Tensor:
    x = as_tensor(x)
    if x.is_complex():
        raise ValueError(f"{what} takes real signals")
    return x.to(dtype)


def _window64(window, nperseg: int) -> np.ndarray:
    return get_window(window, nperseg, np.float64)


def _window_on(window, nperseg: int, like: Tensor) -> Tensor:
    """The window at the dtype of ``like`` (the working dtype) beside it: a
    named window is kept on the device (built on the host also while dynamo
    traces), a caller's array is uploaded on every call."""
    if isinstance(window, (str, tuple)):
        return host_table("stft.window", _window64, window, nperseg, like=like, dtype=like.dtype)
    return constant(_window64(window, nperseg), like, like.dtype)


def _frame(x: Tensor, nperseg: int, hop: int) -> Tensor:
    """(..., T) -> (..., frames, nperseg): a strided view, no copy."""
    return x.unfold(-1, nperseg, hop)


@batch_sharded(last_axis)
def stft(
    x,
    nperseg: int = 256,
    noverlap: Optional[int] = None,
    window="hann",
    *,
    center: bool = True,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """STFT of a real signal: (..., T) -> (..., frames, nperseg//2 + 1).

    ``center=True`` reflect-pads by nperseg//2 so frame f is centered on
    sample f·hop (librosa/scipy convention).  This and every op of the
    module take a batch-sharded DTensor (``utils.sharding.batch_sharded``):
    the time (or frame and bin) axes are gathered, the batch stays sharded.
    """
    x = _as_real(x, "stft", config.dtype)
    if noverlap is None:
        noverlap = nperseg // 2
    if not 0 <= noverlap < nperseg:
        raise ValueError(f"need 0 <= noverlap < nperseg, got {noverlap}")
    hop = nperseg - noverlap
    if center:
        x = pad_last(x, nperseg // 2, nperseg // 2, "reflect")
    if x.shape[-1] < nperseg:
        raise ValueError(f"signal length {x.shape[-1]} < nperseg {nperseg}")
    # zero-pad the tail so every sample lands in a whole frame
    t = x.shape[-1]
    n_frames = 1 + -(-(t - nperseg) // hop)
    full = nperseg + (n_frames - 1) * hop
    if full > t:
        x = F.pad(x, (0, full - t))
    frames = _frame(x, nperseg, hop) * _window_on(window, nperseg, x)
    return rfft(frames, config=config)


def _ola_index(n_frames: int, nperseg: int, hop: int) -> np.ndarray:
    """The signal sample of every frame sample, frame by frame."""
    return (np.arange(n_frames)[:, None] * hop + np.arange(nperseg)[None, :]).reshape(-1)


def _nola(window, nperseg: int, hop: int, n_frames: int) -> np.ndarray:
    """NOLA normalization: the inverse of the sum of squared windows at each
    sample (0 where it vanishes), on the host."""
    wsq = np.zeros(nperseg + (n_frames - 1) * hop, dtype=np.float64)
    w_np = get_window(window, nperseg, np.float64) ** 2
    for s in range(0, n_frames * hop, hop):
        wsq[s : s + nperseg] += w_np
    safe = np.where(wsq > 1e-10, wsq, 1.0)
    return np.where(wsq > 1e-10, 1.0 / safe, 0.0)


@batch_sharded(last_two)
def istft(
    spec,
    nperseg: int = 256,
    noverlap: Optional[int] = None,
    window="hann",
    *,
    center: bool = True,
    length: Optional[int] = None,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """Inverse STFT with windowed overlap-add (NOLA normalization)."""
    spec = as_tensor(spec)
    if noverlap is None:
        noverlap = nperseg // 2
    hop = nperseg - noverlap
    frames = irfft(spec, n=nperseg, config=config)  # (..., n_frames, nperseg)
    n_frames = frames.shape[-2]
    t_padded = nperseg + (n_frames - 1) * hop
    frames = frames * _window_on(window, nperseg, frames)

    # overlap-add: out[f*hop + i] += frames[f, i]
    idx = host_table("stft.ola_index", _ola_index, n_frames, nperseg, hop, like=frames,
                     dtype=torch.long)
    batch = frames.shape[:-2]
    out = frames.new_zeros(*batch, t_padded)
    out = out.index_add(-1, idx, frames.reshape(*batch, n_frames * nperseg))
    if isinstance(window, (str, tuple)):
        inv = host_table("stft.nola", _nola, window, nperseg, hop, n_frames, like=out,
                         dtype=out.dtype)
    else:
        inv = constant(_nola(window, nperseg, hop, n_frames), out, out.dtype)
    out = out * inv

    if center:
        out = out[..., nperseg // 2 : t_padded - nperseg // 2]
    if length is not None:
        out = out[..., :length]
    return out


@batch_sharded(last_axis)
def spectrogram(
    x,
    nperseg: int = 256,
    noverlap: Optional[int] = None,
    window="hann",
    *,
    center: bool = True,
    power: float = 2.0,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """|STFT|^power: (..., frames, bins) real."""
    s = stft(x, nperseg, noverlap, window, center=center, config=config)
    if power == 1.0:
        return torch.abs(s)
    if power == 2.0:
        return s.real ** 2 + s.imag ** 2
    return torch.abs(s) ** power


@functools.lru_cache(maxsize=16)
def _dpss_host(M: int, NW: float, Kmax: int):
    """Host fp64 DPSS tapers + concentration ratios.

    Slepian's trick (Percival & Walden 1993 §8.3): the discrete prolate
    spheroidal sequences are eigenvectors of a symmetric TRIDIAGONAL matrix
    commuting with the concentration operator — d[t] = ((M-1-2t)/2)²cos(2πW),
    e[t] = t(M-t)/2 — so no dense kernel is ever built for the tapers.
    Concentrations come from the autocorrelation identity
    λ_k = Σ_t r_xx[t]·(4W·sinc(2W·t)) (r[0] term 2W).  scipy.signal.windows
    .dpss sign conventions: symmetric tapers positive mean, antisymmetric
    tapers positive first lobe."""
    W = NW / M
    t = np.arange(M, dtype=np.float64)
    d = ((M - 1 - 2.0 * t) / 2.0) ** 2 * np.cos(2.0 * np.pi * W)
    e = t[1:] * (M - t[1:]) / 2.0
    try:
        # O(M·Kmax)-class tridiagonal solver with index selection — the
        # only tractable route at audio lengths (dense eigh is O(M³):
        # minutes at M ~ 20k, where this is milliseconds)
        from scipy.linalg import eigh_tridiagonal

        _, V = eigh_tridiagonal(d, e, select="i",
                                select_range=(M - Kmax, M - 1))
        tapers = V[:, ::-1].T.copy()  # (Kmax, M), best-concentrated first
    except ImportError:  # pragma: no cover - scipy is normally present
        A = np.zeros((M, M))
        A[np.arange(M), np.arange(M)] = d
        A[np.arange(M - 1), np.arange(1, M)] = e
        A[np.arange(1, M), np.arange(M - 1)] = e
        _, V = np.linalg.eigh(A)
        tapers = V[:, ::-1][:, :Kmax].T.copy()
    for k in range(0, Kmax, 2):  # symmetric: positive average
        if tapers[k].sum() < 0:
            tapers[k] *= -1.0
    thresh = max(1e-7, 1.0 / M)
    for k in range(1, Kmax, 2):  # antisymmetric: positive first lobe
        w = tapers[k]
        if w[w * w > thresh][0] < 0:
            tapers[k] *= -1.0
    # concentration ratios via the autocorrelation identity
    nfft = 2 ** int(np.ceil(np.log2(2 * M - 1)))
    spec = np.abs(np.fft.rfft(tapers, n=nfft, axis=-1)) ** 2
    rxx = np.fft.irfft(spec, n=nfft, axis=-1)[:, :M]
    r = 4.0 * W * np.sinc(2.0 * W * t)
    r[0] = 2.0 * W
    ratios = rxx @ r
    return tapers, ratios


def dpss(
    M: int, NW: float, Kmax: Optional[int] = None, *,
    return_ratios: bool = False, dtype=np.float32,
):
    """Discrete prolate spheroidal (Slepian) tapers — the maximally
    band-concentrated windows (scipy.signal.windows.dpss semantics with
    norm=2: orthonormal rows).  ``NW`` is the time-halfbandwidth product;
    ``Kmax`` defaults to the ~2NW-1 well-concentrated tapers.  Returns
    (Kmax, M) host array (+ concentration ratios when requested)."""
    if M < 2:
        raise ValueError(f"M must be >= 2, got {M}")
    if not 0.0 < NW < M / 2.0:
        raise ValueError(f"need 0 < NW < M/2, got NW={NW}, M={M}")
    if Kmax is None:
        Kmax = max(int(2 * NW) - 1, 1)
    if not 0 < Kmax <= M:
        raise ValueError(f"need 0 < Kmax <= M, got {Kmax}")
    tapers, ratios = _dpss_host(int(M), float(NW), int(Kmax))
    if return_ratios:
        return tapers.astype(dtype), ratios.astype(dtype)
    return tapers.astype(dtype)


def _griffinlim_loop(mag: Tensor, spec0: Tensor, n_iter: int, momentum: float, project):
    """The alternating projections from the initial spectrum ``spec0``:
    (re-phased spectrum after ``n_iter`` rounds)."""

    def rephase(c: Tensor) -> Tensor:
        a = torch.sqrt(c.real ** 2 + c.imag ** 2)
        safe = torch.clamp(a, min=1e-16)
        return torch.complex(mag * c.real / safe, mag * c.imag / safe)

    spec, prev = spec0, spec0
    for _ in range(n_iter):
        est = project(spec)
        spec, prev = rephase(est + momentum * (est - prev)), est
    return spec


def _seeded_draws(seed: int, shape: tuple, dtype: torch.dtype) -> np.ndarray:
    """The uniform draws of a CPU generator seeded with ``seed`` (float64
    holds every draw of ``dtype`` exactly)."""
    g = torch.Generator().manual_seed(seed)
    return torch.rand(shape, generator=g, dtype=dtype).double().numpy()


def _refuse_generator() -> None:
    raise ValueError(
        "griffinlim(generator=...) cannot be compiled: a generator's state "
        "cannot enter a graph; pass seed= (its draws are a host table) or "
        "call griffinlim eagerly")


def griffinlim(
    mag,
    n_iter: int = 32,
    nperseg: int = 256,
    noverlap: Optional[int] = None,
    window="hann",
    momentum: float = 0.99,
    *,
    center: bool = True,
    length: Optional[int] = None,
    seed: int = 0,
    generator: Optional[torch.Generator] = None,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """Griffin-Lim phase retrieval: reconstruct a real signal from an STFT
    magnitude (…, n_frames, nperseg//2+1) by alternating projections
    between the magnitude constraint and the set of consistent spectrograms
    (istft -> stft), with Perraudin-style momentum (librosa's accelerated
    default).  Every round is one irfft and one rfft of the engine.

    The initial phase is uniform, drawn from ``generator`` (default: a CPU
    generator seeded with ``seed``), so a call is deterministic.  Under
    ``torch.compile`` the ``seed`` form compiles (its draws are made on the
    host and kept on the device per seed, shape and dtype, the values an
    eager call draws); ``generator=`` raises ValueError there, since a
    generator's state cannot enter a graph, and stays an eager form.  On a
    batch-sharded DTensor the draws are those of the whole batch, each rank
    taking its block's, so the result is the single-device call's.  Returns
    the time signal (length inferred from the frame count, or ``length``)."""
    mag = as_tensor(mag)
    if mag.is_complex():
        raise ValueError("griffinlim takes a magnitude (real) spectrogram")
    if mag.ndim < 2 or mag.shape[-1] != nperseg // 2 + 1:
        raise ValueError(
            f"mag must be (…, n_frames, {nperseg // 2 + 1}) for "
            f"nperseg={nperseg}, got {tuple(mag.shape)}"
        )
    if n_iter < 1:
        raise ValueError(f"n_iter must be >= 1, got {n_iter}")
    if not 0.0 <= momentum < 1.0:
        raise ValueError(f"momentum must be in [0, 1), got {momentum}")
    mag = mag.to(config.dtype)
    if noverlap is None:
        noverlap = nperseg // 2
    hop = nperseg - noverlap
    n_frames = mag.shape[-2]
    t_padded = nperseg + (n_frames - 1) * hop
    max_len = t_padded - (nperseg if center else 0)
    if max_len < 1:
        raise ValueError(
            f"n_frames={n_frames} with nperseg={nperseg}, hop={hop}, "
            f"center={center} spans no samples — need more frames"
        )
    sig_len = max_len
    if length is not None:
        sig_len = int(length)
        if not 1 <= sig_len <= max_len:
            raise ValueError(
                f"length={sig_len} not reachable from {n_frames} frames "
                f"(max {max_len}); istft can only crop"
            )
        # the projection needs stft(istft(spec)) to return at least n_frames
        # frames, or the spectrum changes shape between rounds
        t_eff = sig_len + (2 * (nperseg // 2) if center else 0)
        sig_len_frames = 1 + -(-max(t_eff - nperseg, 0) // hop)
        if sig_len_frames < n_frames:
            raise ValueError(
                f"length={sig_len} yields only {sig_len_frames} frames, mag "
                f"has {n_frames} — raise length or pass fewer frames"
            )

    def invert(spec: Tensor) -> Tensor:
        return istft(spec, nperseg, noverlap, window, center=center, length=sig_len,
                     config=config)

    def project(spec: Tensor) -> Tensor:
        """Magnitude-consistent projection: istft then stft."""
        return stft(invert(spec), nperseg, noverlap, window, center=center,
                    config=config)[..., :n_frames, :]

    if generator is None:
        draws = host_table("griffinlim.draws", _seeded_draws, int(seed), tuple(mag.shape),
                           mag.dtype, like=mag, dtype=mag.dtype)
    else:
        if torch.compiler.is_compiling():
            on_host(_refuse_generator)
        draws = torch.rand(mag.shape, generator=generator, dtype=mag.dtype,
                           device=generator.device).to(mag.device)
    if isinstance(mag, DTensor):   # each rank's block of the whole batch's draws
        mesh, placements = mag.device_mesh, mag.placements
        draws = dtensor(local_placed(draws, mesh, placements), mesh, placements, mag.shape)
    return _griffinlim_from(mag, draws, n_iter, momentum, invert, project)


@batch_sharded(last_two)
def _griffinlim_from(mag: Tensor, draws: Tensor, n_iter: int, momentum: float, invert,
                     project) -> Tensor:
    """Griffin-Lim from the initial phases ``2π·draws``."""
    ph = (2.0 * math.pi) * draws
    spec0 = torch.complex(mag * torch.cos(ph), mag * torch.sin(ph))
    return invert(_griffinlim_loop(mag, spec0, n_iter, momentum, project))


@batch_sharded(last_two)
def phase_vocoder(
    S,
    rate: float,
    hop: Optional[int] = None,
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """Phase-vocoder time stretch of a complex STFT (…, frames, bins) by
    ``rate`` (>1 speeds up): librosa.phase_vocoder (Flanagan-Golden with
    phase accumulation).

    The fractional read positions are host constants, so the two source
    frames per output step are one gather each.  The phase is accumulated
    frame after frame in a loop, the order the JAX module's scan adds in (a
    parallel cumsum would round differently in fp32); everything else is
    elementwise over all output frames at once."""
    S = as_tensor(S)
    if not S.is_complex():
        raise ValueError("phase_vocoder takes a complex STFT")
    if S.ndim < 2:
        raise ValueError("S must be (…, frames, bins)")
    if rate <= 0:
        raise ValueError(f"rate must be > 0, got {rate}")
    S = S.to(torch.complex64)
    n_frames, nb = S.shape[-2], S.shape[-1]
    nfft = 2 * (nb - 1)
    hop = nfft // 4 if hop is None else int(hop)
    steps = np.arange(0, n_frames, rate)  # host fp64
    lo = np.minimum(steps.astype(np.int64), n_frames - 1)
    hi = np.minimum(lo + 1, n_frames - 1)
    key = (n_frames, float(rate))
    frac = constant(steps - lo, S, key=("pv.frac",) + key)[:, None]
    S0 = S[..., constant(lo, S, torch.long, key=("pv.lo",) + key), :]
    S1 = S[..., constant(hi, S, torch.long, key=("pv.hi",) + key), :]
    phi_adv = constant(lambda: np.linspace(0, np.pi * hop, nb), S, key=("pv.adv", hop, nb))
    eps = 1e-30
    mag = (1.0 - frac) * torch.abs(S0) + frac * torch.abs(S1)
    ang0 = torch.angle(S0 + eps)
    dphi = torch.angle(S1 + eps) - ang0 - phi_adv
    dphi = dphi - 2.0 * math.pi * torch.round(dphi / (2.0 * math.pi))
    inc = torch.movedim(phi_adv + dphi, -2, 0)  # (steps, …, bins)
    phases = [torch.angle(S[..., 0, :] + eps)]
    for m in range(len(steps) - 1):
        phases.append(phases[-1] + inc[m])
    phase = torch.stack(phases, dim=-2)         # (…, steps, bins)
    return mag * torch.complex(torch.cos(phase), torch.sin(phase))


@batch_sharded(last_axis)
def time_stretch(
    x,
    rate: float,
    nperseg: int = 2048,
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """Time-stretch a real signal by ``rate`` without changing pitch
    (librosa.effects.time_stretch): stft -> :func:`phase_vocoder` ->
    istft at length round(T/rate)."""
    x = _as_real(x, "time_stretch", config.dtype)
    if rate <= 0:
        raise ValueError(f"rate must be > 0, got {rate}")
    hop = nperseg // 4
    S = stft(x, nperseg, nperseg - hop, "hann", center=True, config=config)
    S2 = phase_vocoder(S, rate, hop, config=config)
    n_out = int(round(x.shape[-1] / rate))
    return istft(S2, nperseg, nperseg - hop, "hann", center=True, length=n_out,
                 config=config)


@batch_sharded(last_axis)
def pitch_shift(
    x,
    sr: float,
    n_steps: float,
    bins_per_octave: int = 12,
    nperseg: int = 2048,
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """Pitch-shift a real signal by ``n_steps`` (fractional allowed) in
    ``bins_per_octave``-TET without changing duration
    (librosa.effects.pitch_shift): time-stretch by 2^{-steps/bpo}, then
    resample back to the original length with the polyphase resampler."""
    from fractions import Fraction

    from .signal import resample_poly  # signal imports this module

    x = _as_real(x, "pitch_shift", config.dtype)
    if bins_per_octave < 1:
        raise ValueError(f"bins_per_octave must be >= 1, got {bins_per_octave}")
    rate = 2.0 ** (-float(n_steps) / bins_per_octave)
    y = time_stretch(x, rate, nperseg, config=config)
    frac = Fraction(rate).limit_denominator(1000)
    z = resample_poly(y, frac.numerator, frac.denominator, config=config)
    n = x.shape[-1]
    z = z[..., :n]
    if z.shape[-1] < n:
        z = F.pad(z, (0, n - z.shape[-1]))
    return z
