"""Dual-tree complex wavelet transform (1-D and 2-D, periodized).

Counterpart of ``mixed_radix_fast_fourier_transform_tpu/ops/dtcwt.py``.
Capability extension beyond the reference C library (which stops at the
FFT — see SURVEY.md §2): the near-shift-invariant, directionally selective
complex wavelet frame of Kingsbury/Selesnick — the standard fix for the
plain DWT's shift sensitivity (ops/dwt.py), at 2x (1-D) / 4x (2-D)
redundancy.

Two parallel orthonormal filter-bank trees whose wavelets form an
approximate Hilbert pair: the complex coefficients w = (d_a + j·d_b)/sqrt 2
have near-analytic spectra, so |w| barely moves under input shifts and the
six 2-D subbands select orientations ±15/±45/±75 degrees.

Filters are DERIVED at bank build, not transcribed: Selesnick's
common-factor construction (IEEE Trans. SP 50(5), 2002 — "The design of
approximate Hilbert transform pairs of wavelet bases"):

* ``D(z)``: maximally-flat (Lagrange) fractional-delay factor of degree L
  with group delay L/2 - 1/4, so the ratio z^{-L} D(1/z) / D(z) is an
  approximate half-sample delay;
* tree filters ``H_a = Q·(1+z^{-1})^K·D(z)`` and
  ``H_b = Q·(1+z^{-1})^K·z^{-L} D(1/z)`` — same magnitude, half-sample
  relative delay;
* the symmetric autocorrelation ``S = Q Q~`` solves the *linear* half-band
  system P(z) + P(-z) = 2 with P = S·(DD~)·((1+z)(1+z^{-1}))^K
  (deg Q = K + L - 1 makes it square), then Q is recovered by minimum-phase
  spectral factorization.

Each tree is verified orthonormal (CQF to ~1e-14) and the Hilbert-pair
quality is measured at build by cascading to the wavelet spectrum: at the
default (K=3, L=3) (12-tap) the negative-frequency energy ratio is ~0.14%,
comparable to Kingsbury's 14-tap q-shift-b bank.  Level 1 uses the same
bank on both trees with tree b delayed one full sample (the standard
dual-tree level-1 construction; at half the rate a one-sample input delay
is the required half-sample coefficient offset).

Device shape: identical to ops/dwt.py — one periodized analysis or
synthesis convolution per tree per level, no recursion over samples, no
scatter.  The bank is derived on the host by the JAX module's own code
(bit-equal filters); every filter constant is host numpy.
"""

from __future__ import annotations

import functools
import math
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from .dwt import periodized_astep, periodized_sstep
from ..utils.config import DEFAULT_CONFIG, SpectralConfig
from ..utils.numerics import as_tensor

Tensor = torch.Tensor


def _lagrange_delay(order: int, tau: float) -> np.ndarray:
    """Maximally-flat FIR fractional delay: Lagrange interpolation weights
    d[i] = prod_{k != i} (tau - k)/(i - k), i = 0..order."""
    d = np.ones(order + 1)
    for i in range(order + 1):
        for k in range(order + 1):
            if k != i:
                d[i] *= (tau - k) / (i - k)
    return d


def _cascade_spectrum_ratio(h_a: np.ndarray, h_b: np.ndarray) -> Tuple[float, float]:
    """(best negative/positive energy ratio, j-sign achieving it) of the
    complex wavelet psi_a + j·sign·psi_b, via the cascade algorithm."""

    def cascade(h):
        g = np.array([(-1.0) ** n * h[len(h) - 1 - n] for n in range(len(h))])
        x = np.array([1.0])
        for i in range(8):
            u = np.zeros(2 * len(x) - 1)
            u[::2] = x
            x = np.convolve(u, h if i else g) * math.sqrt(2.0)
        return x

    pa, pb = cascade(h_a), cascade(h_b)
    n = 2 * max(len(pa), len(pb))
    fa = np.fft.fft(pa, n)
    fb = np.fft.fft(pb, n)
    best = (np.inf, 1.0)
    for sgn in (1.0, -1.0):
        e = np.abs(fa + 1j * sgn * fb) ** 2
        neg, pos = e[n // 2 :].sum(), e[: n // 2].sum()
        r = min(neg, pos) / max(neg, pos)
        if r < best[0]:
            best = (float(r), sgn)
    return best


class _DTBank(NamedTuple):
    dec_a: np.ndarray  # (2, F) analysis lo/hi, tree a
    dec_b: np.ndarray  # (2, F) analysis lo/hi, tree b
    jsign: float       # sign s in w = (d_a + j·s·d_b)/sqrt2
    analyticity: float  # residual negative-frequency energy ratio


@functools.lru_cache(maxsize=16)
def _dt_bank(K: int, L: int) -> _DTBank:
    """Derive the Selesnick common-factor dual-tree bank (module docstring).

    Raises if the half-band solve, the orthonormality check (1e-10), or the
    Hilbert-pair quality gate (negative-frequency ratio < 5%) fails — a
    degenerate (K, L) cannot ship silently."""
    if K < 1 or L < 1:
        raise ValueError(f"need K >= 1 and L >= 1, got K={K}, L={L}")
    M = K + L - 1
    d = _lagrange_delay(L, L / 2.0 - 0.25)
    g = np.ones(1)
    for _ in range(K):
        g = np.convolve(g, [1.0, 1.0])
    RG = np.convolve(np.convolve(d, d[::-1]), np.convolve(g, g[::-1]))
    # P = S·RG half-band: linear system in the symmetric coeffs s[0..M]
    cols = []
    for m in range(M + 1):
        e = np.zeros(2 * M + 1)
        e[M + m] = 1.0
        if m:
            e[M - m] = 1.0
        cols.append(np.convolve(e, RG))
    A = np.array(cols).T
    c = (A.shape[0] - 1) // 2
    lags = np.arange(0, c + 1, 2)
    rows = A[c + lags]
    target = np.zeros(len(lags))
    target[0] = 1.0
    s, *_ = np.linalg.lstsq(rows, target, rcond=None)
    if np.max(np.abs(rows @ s - target)) > 1e-8:
        raise ValueError(f"half-band solve failed for (K={K}, L={L})")
    sfull = np.zeros(2 * M + 1)
    sfull[M] = s[0]
    sfull[M + 1 :] = s[1:]
    sfull[:M] = s[1:][::-1]
    q = np.array([1.0])
    for r in np.roots(sfull[::-1]):
        if abs(r) < 1.0 - 1e-10:
            q = np.convolve(q, [1.0, -r])
    q = np.real(q)
    q *= math.sqrt(abs(sfull[M] / np.convolve(q, q[::-1])[len(q) - 1]))
    f = np.convolve(q, g)
    h_a = np.convolve(f, d)
    h_b = np.convolve(f, d[::-1])
    h_a *= math.sqrt(2.0) / h_a.sum()
    h_b *= math.sqrt(2.0) / h_b.sum()
    for h in (h_a, h_b):
        acorr = np.convolve(h, h[::-1])[len(h) - 1 :]
        err = max(abs(acorr[0] - 1.0), np.max(np.abs(acorr[2::2])) if len(acorr) > 2 else 0.0)
        if err > 1e-10:
            raise ValueError(f"orthonormality failed for (K={K}, L={L}): {err:.2e}")
    ratio, jsign = _cascade_spectrum_ratio(h_a, h_b)
    if ratio > 0.05:
        raise ValueError(
            f"(K={K}, L={L}) is not a usable Hilbert pair "
            f"(negative-frequency ratio {ratio:.3f})"
        )

    def dec(h):
        hi = np.array([(-1.0) ** n * h[len(h) - 1 - n] for n in range(len(h))])
        return np.stack([h[::-1], hi[::-1]])

    return _DTBank(dec(h_a), dec(h_b), jsign, ratio)


def _astep(x: Tensor, filt: np.ndarray, config: SpectralConfig):
    """One periodized analysis level (the shared dwt step) for a stacked
    (2, F) tree bank."""
    return periodized_astep(x, filt, config)


def _sstep(a: Tensor, d: Tensor, filt: np.ndarray, config: SpectralConfig) -> Tensor:
    """Inverse of :func:`_astep` for an orthonormal bank (synthesis =
    analysis adjoint): the shared dwt polyphase step."""
    return periodized_sstep(a, d, filt[0], filt[1], config)


def _check_1d(x: Tensor, levels: int) -> Tensor:
    if x.ndim < 1 or x.shape[-1] < 2:
        raise ValueError("dtcwt needs a signal of length >= 2")
    if levels < 1:
        raise ValueError(f"levels must be >= 1, got {levels}")
    if x.shape[-1] % (1 << levels):
        raise ValueError(
            f"length {x.shape[-1]} not divisible by 2^levels = {1 << levels}"
        )
    if x.is_complex():
        raise ValueError("dtcwt takes real signals")
    if not x.is_floating_point():
        x = x.to(torch.float32)
    return x


def dtcwt(
    x,
    levels: int = 3,
    *,
    K: int = 3,
    L: int = 3,
    config: SpectralConfig = DEFAULT_CONFIG,
):
    """1-D dual-tree complex wavelet transform along the last axis.

    Returns ``(yl, yh)``: ``yl`` is the stacked final lowpass of the two
    trees, shape (2, …, N/2^levels); ``yh`` is a list of complex detail
    arrays, finest first, level j of shape (…, N/2^j).  N must divide
    2^levels (periodized trees).  ``K``/``L`` select the derived bank
    (K vanishing moments, degree-L half-delay factor; filter length
    2(K+L))."""
    x = _check_1d(as_tensor(x), levels)
    bank = _dt_bank(K, L)
    yh: List[Tensor] = []
    a_a, a_b = x, torch.roll(x, 1, dims=-1)
    scale = 1.0 / math.sqrt(2.0)
    for j in range(levels):
        fa, fb = (bank.dec_a, bank.dec_b) if j else (bank.dec_a, bank.dec_a)
        a_a, d_a = _astep(a_a, fa, config)
        a_b, d_b = _astep(a_b, fb, config)
        yh.append(torch.complex(d_a * scale, d_b * (bank.jsign * scale)))
    return torch.stack([a_a, a_b]), yh


def idtcwt(
    yl,
    yh: Sequence[Tensor],
    *,
    K: int = 3,
    L: int = 3,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """Inverse of :func:`dtcwt` (exact: each tree is orthonormal, the two
    reconstructions are averaged)."""
    yl = as_tensor(yl)
    if yl.ndim < 2 or yl.shape[0] != 2:
        raise ValueError("yl must be (2, …, N/2^levels) as returned by dtcwt")
    if not yh:
        raise ValueError("yh must contain at least one level")
    bank = _dt_bank(K, L)
    a_a, a_b = yl[0], yl[1]
    scale = math.sqrt(2.0)
    for j, w in reversed(list(enumerate(yh))):
        w = as_tensor(w, yl.device)
        d_a = w.real * scale
        d_b = w.imag * (bank.jsign * scale)
        fa, fb = (bank.dec_a, bank.dec_b) if j else (bank.dec_a, bank.dec_a)
        a_a = _sstep(a_a, d_a, fa, config)
        a_b = _sstep(a_b, d_b, fb, config)
    return (a_a + torch.roll(a_b, -1, dims=-1)) * 0.5


def _astep2(x: Tensor, fr: np.ndarray, fc: np.ndarray, config: SpectralConfig):
    """Separable 2-D analysis step over the last two axes: row tree filters
    ``fr`` on axis -2, column tree filters ``fc`` on axis -1.  Returns
    (ll, (lh, hl, hh))."""
    lo_r, hi_r = _astep(x.transpose(-1, -2), fr, config)
    ll, lh = _astep(lo_r.transpose(-1, -2), fc, config)
    hl, hh = _astep(hi_r.transpose(-1, -2), fc, config)
    return ll, (lh, hl, hh)


def _sstep2(ll, bands, fr: np.ndarray, fc: np.ndarray, config: SpectralConfig):
    lh, hl, hh = bands
    lo_r = _sstep(ll, lh, fc, config)
    hi_r = _sstep(hl, hh, fc, config)
    x = _sstep(lo_r.transpose(-1, -2), hi_r.transpose(-1, -2), fr, config)
    return x.transpose(-1, -2)


_TREES2 = ((0, 0), (0, 1), (1, 0), (1, 1))  # (row tree, col tree); 0 = a


def dtcwt2(
    x,
    levels: int = 3,
    *,
    K: int = 3,
    L: int = 3,
    config: SpectralConfig = DEFAULT_CONFIG,
):
    """2-D dual-tree complex wavelet transform over the last two axes.

    Returns ``(yl, yh)``: ``yl`` stacks the four row/col tree-combination
    lowpasses, shape (4, …, N1/2^levels, N2/2^levels); ``yh`` is a list
    (finest first) of complex arrays of shape (6, …, n1, n2) — the six
    oriented subbands (±15°, ±45°, ±75°), built per detail type t ∈
    {LH, HL, HH} from the four tree combinations t_rc as

        z⁺ = ((t_aa − t_bb) + j·s·(t_ab + t_ba)) / 2
        z⁻ = ((t_aa + t_bb) + j·s·(t_ba − t_ab)) / 2

    Band order: [LH⁺, LH⁻, HL⁺, HL⁻, HH⁺, HH⁻].  Both axes must divide
    2^levels."""
    x = as_tensor(x)
    if x.ndim < 2:
        raise ValueError("dtcwt2 needs at least a 2-D input")
    for ax in (-2, -1):
        _check_1d(torch.movedim(x, ax, -1), levels)
    x = _check_1d(x, levels)
    bank = _dt_bank(K, L)
    s = bank.jsign
    # four parallel transforms: tree-b axes enter delayed by one sample
    lows = []
    for tr, tc in _TREES2:
        u = torch.roll(x, 1, dims=-2) if tr else x
        u = torch.roll(u, 1, dims=-1) if tc else u
        lows.append(u)
    yh: List[Tensor] = []
    for j in range(levels):
        filt = (bank.dec_a, bank.dec_b) if j else (bank.dec_a, bank.dec_a)
        det = []
        nxt = []
        for (tr, tc), u in zip(_TREES2, lows):
            ll, bands = _astep2(u, filt[tr], filt[tc], config)
            nxt.append(ll)
            det.append(bands)
        lows = nxt
        level_bands = []
        for t in range(3):  # LH, HL, HH
            aa, ab, ba, bb = (det[i][t] for i in range(4))
            level_bands.append(torch.complex((aa - bb) * 0.5, (ab + ba) * (s * 0.5)))
            level_bands.append(torch.complex((aa + bb) * 0.5, (ba - ab) * (s * 0.5)))
        yh.append(torch.stack(level_bands))
    return torch.stack(lows), yh


def idtcwt2(
    yl,
    yh: Sequence[Tensor],
    *,
    K: int = 3,
    L: int = 3,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """Inverse of :func:`dtcwt2` (exact; averages the four orthonormal
    tree-combination reconstructions)."""
    yl = as_tensor(yl)
    if yl.ndim < 3 or yl.shape[0] != 4:
        raise ValueError("yl must be (4, …, n1, n2) as returned by dtcwt2")
    if not yh:
        raise ValueError("yh must contain at least one level")
    bank = _dt_bank(K, L)
    s = bank.jsign
    lows = [yl[i] for i in range(4)]
    for j, w in reversed(list(enumerate(yh))):
        w = as_tensor(w, yl.device)
        if w.shape[0] != 6:
            raise ValueError("each yh level must stack 6 oriented subbands")
        filt = (bank.dec_a, bank.dec_b) if j else (bank.dec_a, bank.dec_a)
        nxt = []
        dets = []
        for t in range(3):
            zp, zm = w[2 * t], w[2 * t + 1]
            pr, pi = zp.real, zp.imag * s
            mr, mi = zm.real, zm.imag * s
            dets.append((pr + mr, pi - mi, pi + mi, mr - pr))  # aa, ab, ba, bb
        for i, (tr, tc) in enumerate(_TREES2):
            bands = tuple(dets[t][i] for t in range(3))
            nxt.append(_sstep2(lows[i], bands, filt[tr], filt[tc], config))
        lows = nxt
    out = []
    for (tr, tc), u in zip(_TREES2, lows):
        u = torch.roll(u, -1, dims=-2) if tr else u
        u = torch.roll(u, -1, dims=-1) if tc else u
        out.append(u)
    return (out[0] + out[1] + out[2] + out[3]) * 0.25
