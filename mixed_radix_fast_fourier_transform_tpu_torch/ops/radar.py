"""Radar signal processing: pulse compression, range–Doppler maps, CFAR.

Counterpart of ``mixed_radix_fast_fourier_transform_tpu/ops/radar.py``: the
pulse-Doppler processing chain.  Pulse compression is one batched
frequency-domain matched filter (two engine FFTs at a 2357-smooth padded
length, which the fused kernel takes where it is 7-smooth and ≤ 16,384),
the Doppler dimension one more batched FFT, and CFAR training-cell means
are box sums computed by cumulative sums (static footprints, no
data-dependent control flow).  Windows and threshold factors are host
float64 constants.

Conventions: a matched-filter output sample at delay d is
Σ_n rx[n+d]·conj(tx[n]) — peak value 1 for a unit-amplitude exact echo
when ``normalize=True`` (the sidelobe window is folded into the
normalization).  CFAR threshold factors assume square-law (exponential)
noise, the textbook Pfa calibration.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.config import DEFAULT_CONFIG, SpectralConfig
from ..utils.factorize import next_fast_len
from ..utils.numerics import as_tensor, as_tensors, constant, pad_last
from .fft import fft, fftshift, ifft
from .stft import get_window

Tensor = torch.Tensor


def _complex(x: Tensor) -> Tensor:
    return x if x.is_complex() else x.to(torch.complex64)


def _matched_spectrum(tx: Tensor, window, L: int, config):
    """FFT of the windowed, conjugated, time-reversed transmit pulse,
    padded to L — i.e. the correlation kernel's spectrum — plus the
    unit-echo peak gain for normalization."""
    if tx.ndim != 1:
        raise ValueError(f"tx pulse must be 1-D, got shape {tuple(tx.shape)}")
    nt = tx.shape[0]
    txc = _complex(tx)
    if window is not None:
        w = constant(lambda: np.asarray(get_window(window, nt), np.float64), txc,
                     txc.real.dtype, key=("radar.window", str(window), nt))
        txw = txc * w
    else:
        txw = txc
    gain = torch.sum(txw * torch.conj(txc))  # unit-echo peak Σ w·|tx|²
    # conj of the replica spectrum: ifft(R·conj(T))[d] is the circular
    # cross-correlation Σ_n rx[n+d]·conj(tx[n]) directly at lag d
    Tf = torch.conj(fft(F.pad(txw, (0, L - nt)), config=config))
    return Tf, gain


def pulse_compression(
    rx,
    tx,
    window: Optional[str] = None,
    mode: str = "valid",
    normalize: bool = True,
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """Matched-filter pulse compression of (…, N) receive data against a
    length-Nt transmit pulse: one frequency-domain correlation
    (two batched engine FFTs at a 2357-smooth padded length).

    ``mode="valid"`` returns the N−Nt+1 fully-overlapped delays (delay 0 =
    echo aligned with the start of ``rx``); ``mode="full"`` returns all
    N+Nt−1 lags starting at delay −(Nt−1).  ``window`` names a sidelobe
    taper applied to the transmit replica (e.g. "hamming", "hann" — any
    :func:`get_window` name); ``normalize=True`` scales so a unit-amplitude
    exact echo peaks at 1 regardless of taper.
    """
    rx, tx = as_tensors(rx, tx)
    if mode not in ("valid", "full"):
        raise ValueError(f"mode must be 'valid' or 'full', got {mode!r}")
    n = rx.shape[-1]
    nt = tx.shape[-1]
    if nt > n:
        raise ValueError(f"tx pulse ({nt}) longer than rx window ({n})")
    L = next_fast_len(n + nt - 1)
    Tf, gain = _matched_spectrum(tx, window, L, config)
    Rf = fft(F.pad(_complex(rx), (0, L - n)), config=config)
    # circular correlation: lag d at index d, negative lags wrap to the end
    y = ifft(Rf * Tf, config=config)
    if mode == "valid":
        y = y[..., : n - nt + 1]
    else:
        y = torch.roll(y, nt - 1, dims=-1)[..., : n + nt - 1]
    if normalize:
        y = y / gain
    return y


def range_doppler(
    rx,
    tx,
    window: Optional[str] = None,
    doppler_window: Optional[str] = "hann",
    normalize: bool = True,
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """Range–Doppler map of a coherent pulse train (…, n_pulses, N):
    pulse compression along fast time, then a tapered, fftshifted FFT
    along slow time.  Output (…, n_pulses, N−Nt+1) with Doppler bin 0
    (zero radial velocity) at row n_pulses//2 and delay 0 at column 0.

    ``doppler_window`` tapers slow time (coherent-gain normalized so a
    steady unit echo keeps unit peak); ``window``/``normalize`` pass to
    :func:`pulse_compression`.
    """
    rx, tx = as_tensors(rx, tx)
    if rx.ndim < 2:
        raise ValueError("range_doppler needs (…, n_pulses, n_samples)")
    y = pulse_compression(rx, tx, window=window, normalize=normalize, config=config)
    m = y.shape[-2]

    def taper():
        if doppler_window is not None:
            w = np.asarray(get_window(doppler_window, m), np.float64)
            return w / w.sum()  # coherent gain 1 for a DC (zero-Doppler) echo
        return np.full(m, 1.0 / m)

    w = constant(taper, y, y.real.dtype, key=("radar.doppler", str(doppler_window), m))
    Y = fft(y * w[:, None], axis=-2, config=config)
    return fftshift(Y, axes=-2)


def _win_sum(v: Tensor, axis: int, half: int) -> Tensor:
    """Centered (2·half+1)-wide sliding sum along ``axis``, zeros beyond
    the edges — zero-pad, cumulative sum, two static slices (no gathers)."""
    w = 2 * half + 1
    vm = torch.movedim(v, axis, -1)
    c = torch.cumsum(F.pad(vm, (half + 1, half)), dim=-1)  # leading zero: c0
    n = vm.shape[-1]
    return torch.movedim(c[..., w: w + n] - c[..., :n], -1, axis)


def _box_sum(p: Tensor, half: int, axes) -> Tensor:
    """Sum of p over a centered (2·half+1)-wide box along each axis in
    ``axes``."""
    for a in axes:
        p = _win_sum(p, a % p.ndim, half)
    return p


def _box_count(shape, half: int, axes) -> np.ndarray:
    """The (broadcastable, host) count of in-bounds cells of the box at
    each position."""
    cnt = np.ones((1,) * len(shape))
    for a in axes:
        a = a % len(shape)
        n = shape[a]
        i = np.arange(n)
        c1 = np.minimum(i + half, n - 1) - np.maximum(i - half, 0) + 1
        view = [1] * len(shape)
        view[a] = n
        cnt = cnt * c1.reshape(view)
    return cnt


def _os_alpha(n: int, k: int, pfa: float) -> float:
    """OS-CFAR threshold factor: the root of
    ∏_{i=0}^{k−1} (n−i)/(n−i+α) = pfa (square-law noise, Rohling 1983) —
    host-side bisection, plan-time scalar."""
    idx = np.arange(k, dtype=np.float64)

    def f(a):
        return np.sum(np.log(n - idx) - np.log(n - idx + a)) - np.log(pfa)

    lo, hi = 0.0, 4.0
    while f(hi) > 0:
        hi *= 2.0
        if hi > 1e12:  # pragma: no cover - pfa astronomically small
            break
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if f(mid) > 0:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def _pfa_go_so(T: float, n: int, method: str) -> float:
    """Exact square-law false-alarm probability of GO/SO-CFAR with two
    half-windows of ``n`` exponential cells and threshold T·Z on the half
    SUMS (Hansen 1980 / Trunk 1978):
        Pfa_SO = 2 Σ_{k=0}^{n−1} C(n−1+k, k) (2+T)^{−(n+k)}
        Pfa_GO = 2 (1+T)^{−n} − Pfa_SO
    (their sum is the identity 2·Pfa_CA,half).  Log-space binomials keep
    n up to thousands finite."""
    k = np.arange(n, dtype=np.float64)
    logc = np.zeros(n)
    if n > 1:
        logc[1:] = np.cumsum(np.log(n - 1 + k[1:]) - np.log(k[1:]))
    so = 2.0 * float(np.sum(np.exp(logc - (n + k) * np.log(2.0 + T))))
    if method == "so":
        return so
    return 2.0 * (1.0 + T) ** (-n) - so


def _goso_alpha(n: int, pfa: float, method: str) -> float:
    """GO/SO threshold factor on the half-window MEAN: the root T of
    Pfa(T) = pfa (see :func:`_pfa_go_so`; monotone decreasing), scaled by
    n — host-side bisection, plan-time scalar (same pattern as
    :func:`_os_alpha`)."""
    lo, hi = 0.0, 4.0
    while _pfa_go_so(hi, n, method) > pfa:
        hi *= 2.0
        if hi > 1e12:  # pragma: no cover - pfa astronomically small
            break
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if _pfa_go_so(mid, n, method) > pfa:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi) * n


def cfar(
    power,
    num_train: int = 8,
    num_guard: int = 2,
    pfa: float = 1e-4,
    method: str = "ca",
    axes: Optional[Tuple[int, ...]] = None,
    rank: Optional[int] = None,
) -> Tuple[Tensor, Tensor]:
    """Constant-false-alarm-rate detection on a square-law ``power`` map.

    Training cells are the ``num_train`` cells per side beyond
    ``num_guard`` guard cells around each cell under test, along the last
    axis (1-D) or the last two axes (pass ``axes=(-2, -1)`` for
    range–Doppler maps; the training region is then the box ring).
    Near edges the out-of-bounds cells are dropped and the estimate
    renormalizes over the cells that exist.

    ``method``: "ca" cell-averaging, "go" greatest-of, "so" smallest-of
    (leading/lagging split — 1-D only), or "os" order-statistic (1-D:
    the ``rank``-th smallest of the 2·num_train training cells, default
    rank = ⌈3N/4⌉; edges are reflect-padded so every cell sees a full
    window, and the device work is one static-slice stack and a sort).  The threshold factor is the exact square-law calibration
    per method — α = Nt·(pfa^(−1/Nt)−1) for "ca", the Hansen/Trunk GO/SO
    equations solved by host bisection for "go"/"so", Rohling's product
    equation for "os".  Edge cells renormalize over the in-bounds training
    cells, which keeps "ca" exact there but is approximate for "go"/"so".
    Returns ``(detections, threshold)`` — a boolean map and the per-cell
    threshold.
    """
    p = as_tensor(power)
    if p.is_complex():
        raise ValueError("cfar expects a real power map (|x|²), got complex")
    if not p.is_floating_point() or p.dtype in (torch.float16, torch.bfloat16):
        p = p.to(torch.float32)
    t, g = int(num_train), int(num_guard)
    if t < 1:
        raise ValueError(f"num_train must be >= 1, got {t}")
    if g < 0:
        raise ValueError(f"num_guard must be >= 0, got {g}")
    if not 0.0 < pfa < 1.0:
        raise ValueError(f"pfa must be in (0, 1), got {pfa}")
    if method not in ("ca", "go", "so", "os"):
        raise ValueError(
            f"method must be 'ca', 'go', 'so' or 'os', got {method!r}"
        )
    axes = (-1,) if axes is None else tuple(int(a) for a in axes)
    if len(axes) not in (1, 2):
        raise ValueError("cfar supports 1-D or 2-D training regions")
    if len(axes) == 2 and method != "ca":
        raise ValueError("go/so/os CFAR is 1-D only")
    for a in axes:
        if p.shape[a] < 2 * (t + g) + 1:
            raise ValueError(
                f"axis {a} ({p.shape[a]} cells) shorter than the CFAR "
                f"window {2 * (t + g) + 1}"
            )

    if method == "os":
        ax = axes[0] % p.ndim
        n_cells = 2 * t
        k = int(rank) if rank is not None else max(1, int(np.ceil(0.75 * n_cells)))
        if not 1 <= k <= n_cells:
            raise ValueError(f"rank must be in [1, {n_cells}], got {k}")
        pm = torch.movedim(p, ax, -1)
        pp = pad_last(pm, t + g, t + g, mode="reflect")
        offs = list(range(0, t)) + list(range(t + 2 * g + 1, 2 * t + 2 * g + 1))
        n = pm.shape[-1]
        win = torch.stack([pp[..., o: o + n] for o in offs], dim=-1)  # (…, 2t)
        noise = torch.sort(win, dim=-1).values[..., k - 1]
        thresh = torch.movedim(float(_os_alpha(n_cells, k, pfa)) * noise, -1, ax)
        return p > thresh, thresh

    if len(axes) == 1 and method in ("go", "so"):
        ax = axes[0] % p.ndim
        # leading / lagging training sums via shifted cumsums: the window
        # offsets are host-static, so the segment sums are two static slices
        # of a zero-padded cumulative sum each
        pm = torch.movedim(p, ax, -1)
        n = pm.shape[-1]
        i = np.arange(n)
        c = torch.cumsum(pm, dim=-1)
        # c0[j + t + g + 1] = Σ p[:j+1]; the right reach saturates at the end
        c0 = torch.cat([c.new_zeros(c.shape[:-1] + (t + g + 1,)), c,
                        c[..., -1:].expand(c.shape[:-1] + (t + g,))], dim=-1)

        def seg(lo_off: int, hi_off: int):
            # Σ p[i+lo_off : i+hi_off+1] for every i, edges clipped
            base = t + g  # c0 index of Σ p[:i] at i=0
            s_hi = c0[..., base + hi_off + 1: base + hi_off + 1 + n]
            s_lo = c0[..., base + lo_off: base + lo_off + n]
            cnt = lambda: (np.minimum(i + hi_off, n - 1)
                           - np.maximum(i + lo_off, 0) + 1).clip(min=0).astype(np.float64)
            return s_hi - s_lo, constant(cnt, pm, pm.dtype, key=("cfar.seg", n, lo_off, hi_off))

        s_lead, c_lead = seg(-g - t, -g - 1)
        s_lag, c_lag = seg(g + 1, g + t)
        m_lead = s_lead / torch.clamp(c_lead, min=1.0)
        m_lag = s_lag / torch.clamp(c_lag, min=1.0)
        # a side with no in-bounds cells defers to the other side
        m_lead = torch.where(c_lead > 0, m_lead, m_lag)
        m_lag = torch.where(c_lag > 0, m_lag, m_lead)
        noise = torch.maximum(m_lead, m_lag) if method == "go" else torch.minimum(m_lead, m_lag)
        thresh = torch.movedim(float(_goso_alpha(t, pfa, method)) * noise, -1, ax)
        return p > thresh, thresh

    # CA: full (train+guard) box sum minus the guard box sum; the counts are
    # host integers, and so is the per-cell threshold factor
    ring_s = _box_sum(p, t + g, axes) - (_box_sum(p, g, axes) if g > 0 else p)
    shape = tuple(p.shape)
    n_train = constant(lambda: _box_count(shape, t + g, axes)
                       - (_box_count(shape, g, axes) if g > 0 else 1.0),
                       p, p.dtype, key=("cfar.ring", shape, axes, t, g))
    noise = ring_s / torch.clamp(n_train, min=1.0)
    # square-law CFAR calibration with the per-cell true training count
    # (computed in the map's precision, as the reference computes it)
    alpha = n_train * (pfa ** (-1.0 / n_train) - 1.0)
    thresh = alpha * noise
    return p > thresh, thresh
