"""Chirp-z transform at arbitrary spiral points: czt / zoom_fft.

Counterpart of ``mixed_radix_fast_fourier_transform_tpu/ops/czt.py``, the
generalization of the engine's Bluestein path: evaluate
X[k] = Σ_n x[n] · a^(−n) · w^(n·k) for k = 0..m−1 at any complex ratio
``w`` and starting point ``a`` (scipy.signal.czt semantics).

As in :func:`ops.stockham.exec_bluestein`, the quadratic-phase identity
n·k = (n² + k² − (k−n)²)/2 turns the sum into one linear convolution with
the chirp v[j] = w^(−j²/2), executed as two padded mixed-radix FFTs of the
stage pipeline (``exec_mixed_radix``, as Bluestein's inner transforms are)
whose kernel spectrum and pre/post chirps are fp64 plan-time constants
cached per (n, m, w, a).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..plan import get_plan
from ..utils.config import DEFAULT_CONFIG, SpectralConfig
from ..utils.factorize import next_pow2
from ..utils.numerics import as_tensor, cmul, constant, from_planes, to_planes
from .stockham import exec_mixed_radix

Tensor = torch.Tensor


def _unit_chirp_powers(w: complex, exponents: np.ndarray) -> np.ndarray:
    """w**exponents in fp64 with phase-wrapped exponents when |w| = 1.

    For unit-modulus w = e^(iθ·2π/d) the naive fp64 pow loses phase accuracy
    once |exponent·θ| >> 2π; reducing the exponent's *fractional turn count*
    first keeps the error at fp64 rounding scale, which matters for the large
    j²/2 exponents the chirp uses.
    """
    mag = abs(w)
    ang = np.angle(w)  # radians per unit exponent
    turns = ang / (2.0 * np.pi)
    frac = np.mod(exponents * turns, 1.0)  # fractional turns, exact-ish in fp64
    out = np.exp(1j * (2.0 * np.pi) * frac)
    if not np.isclose(mag, 1.0):
        out = out * np.power(mag, exponents)
    return out


@functools.lru_cache(maxsize=128)
def _czt_constants(
    n: int, m: int, w: complex, a: complex, pad_mode: str
) -> Tuple[int, np.ndarray, np.ndarray, np.ndarray]:
    """(L, pre[n], kernel_spectrum[L], post[m]) fp64 plan-time constants."""
    j = np.arange(max(n, m), dtype=np.float64)
    half_sq = (j * j) / 2.0
    wq = _unit_chirp_powers(w, half_sq)  # w^(j²/2)
    an = _unit_chirp_powers(a, -j[:n])   # a^(−n)
    pre = an * wq[:n]
    post = wq[:m]
    # linear convolution with v[j] = w^(−j²/2), j = −(n−1) .. (m−1)
    need = n + m - 1
    L = next_pow2(need)
    p3 = 3 * next_pow2(-(-need // 3))
    if pad_mode in ("pow23", "fast") and p3 < L:
        L = p3
    c = np.zeros(L, dtype=np.complex128)
    # v[j] = w^(−j²/2); note conj(w^(j²/2)) would only be right for |w| = 1
    c[:m] = _unit_chirp_powers(w, -half_sq[:m])
    if n > 1:
        jn = np.arange(1, n, dtype=np.float64)
        c[L - (n - 1):] = _unit_chirp_powers(w, -(jn * jn) / 2.0)[::-1]
    spec = np.fft.fft(c) / L             # ifft normalization folded in
    return L, pre, spec, post



def _planes_on(c: np.ndarray, like: Tensor, key) -> Tuple[Tensor, Tensor]:
    """A host complex128 table as fp32 (re, im) planes beside ``like``,
    kept on the device under ``key``."""
    return (constant(lambda: c.real, like, key=key + ("re",)),
            constant(lambda: c.imag, like, key=key + ("im",)))


def czt(
    x,
    m: Optional[int] = None,
    w: Optional[complex] = None,
    a: complex = 1.0 + 0.0j,
    axis: int = -1,
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """Chirp-z transform along ``axis`` (scipy.signal.czt semantics).

    Defaults reproduce the DFT: m = n, w = e^(−2πi/m), a = 1.
    """
    x = as_tensor(x)
    axis = axis % x.ndim
    x = torch.movedim(x, axis, -1)
    n = x.shape[-1]
    if n < 1:
        raise ValueError("czt needs at least one input point")
    m = int(m) if m is not None else n
    if m < 1:
        raise ValueError(f"number of output points must be >= 1, got {m}")
    if w is None:
        w = np.exp(-2j * np.pi / m)
    w = complex(w)
    a = complex(a)
    if w == 0 or a == 0:
        raise ValueError("w and a must be nonzero")

    L, pre, spec, post = _czt_constants(n, m, w, a, config.pad_mode)
    key = ("czt", n, m, w, a, config.pad_mode)
    xr, xi = to_planes(x)
    ar, ai = cmul(xr, xi, *_planes_on(pre, xr, key + ("pre",)))
    ar, ai = F.pad(ar, (0, L - n)), F.pad(ai, (0, L - n))
    plan = get_plan(L, -1, "complex", config)
    fr, fi = exec_mixed_radix(plan, ar, ai)
    br, bi = cmul(fr, fi, *_planes_on(spec, xr, key + ("spec",)))
    # ifft_L = conj(fft_L(conj(·))) with the 1/L folded into spec
    gr, gi = exec_mixed_radix(plan, br, -bi)
    out = cmul(gr[..., :m], -gi[..., :m], *_planes_on(post, xr, key + ("post",)))
    return torch.movedim(from_planes(*out), -1, axis)


def zoom_fft(
    x,
    fn,
    m: Optional[int] = None,
    *,
    fs: float = 2.0,
    axis: int = -1,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """Zoomed DFT over the band fn = [f1, f2] (scipy.signal.zoom_fft): m
    frequency samples of the DTFT at f1 + k·(f2−f1)/m for k = 0..m−1,
    scipy's endpoint-exclusive grid (so the full band [0, fs] with m = n
    reproduces the FFT bins exactly), without computing a padded FFT."""
    x = as_tensor(x)
    n = x.shape[axis % x.ndim]
    if np.isscalar(fn):
        f1, f2 = 0.0, float(fn)
    else:
        f1, f2 = (float(v) for v in fn)
    m = int(m) if m is not None else n
    if m < 1:
        raise ValueError(f"number of output points must be >= 1, got {m}")
    step = (f2 - f1) / m
    w = np.exp(-2j * np.pi * step / fs)
    a = np.exp(2j * np.pi * f1 / fs)
    return czt(x, m=m, w=w, a=a, axis=axis, config=config)


def czt_points(m: int, w: Optional[complex] = None,
               a: complex = 1.0 + 0.0j) -> np.ndarray:
    """The z-plane points a·w^{−k}, k = 0..m−1, where :func:`czt`
    evaluates the transform (scipy.signal.czt_points parity; host
    constant)."""
    if m < 1:
        raise ValueError(f"m must be >= 1, got {m}")
    if w is None:
        # per-point phase (exact integer reduction): powering the base
        # would amplify its rounding by k
        return np.asarray(a, np.complex128) * np.exp(
            2j * np.pi * (np.arange(m) % m) / m
        )
    return np.asarray(a, np.complex128) * np.asarray(w, np.complex128) ** (
        -np.arange(m)
    )


class CZT:
    """Pre-specified chirp-z transform callable (scipy.signal.CZT parity).

    The heavy per-shape work (chirp spectrum, inner plan) is cached by the
    plan layer, so this class is API parity plus argument pinning: build
    once with (n, m, w, a), then apply to many signals."""

    def __init__(self, n: int, m: Optional[int] = None,
                 w: Optional[complex] = None, a: complex = 1.0 + 0.0j):
        if int(n) < 1:
            raise ValueError(f"n must be >= 1, got {n}")
        self.n = int(n)
        self.m = int(m) if m is not None else self.n
        if self.m < 1:
            raise ValueError(f"m must be >= 1, got {m}")
        self.w = complex(w) if w is not None else np.exp(-2j * np.pi / self.m)
        self.a = complex(a)

    def __call__(self, x, *, axis: int = -1,
                 config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
        x = as_tensor(x)
        if x.shape[axis % x.ndim] != self.n:
            raise ValueError(
                f"CZT built for n={self.n}, got length "
                f"{x.shape[axis % x.ndim]} along axis {axis}"
            )
        return czt(x, m=self.m, w=self.w, a=self.a, axis=axis, config=config)

    def points(self) -> np.ndarray:
        """The z-plane evaluation points (scipy.signal.CZT.points)."""
        return czt_points(self.m, self.w, self.a)


class ZoomFFT(CZT):
    """Pre-specified zoomed DFT over a band (scipy.signal.ZoomFFT parity)."""

    def __init__(self, n: int, fn, m: Optional[int] = None, *,
                 fs: float = 2.0):
        if np.isscalar(fn):
            f1, f2 = 0.0, float(fn)
        else:
            f1, f2 = (float(v) for v in fn)
        n = int(n)
        m = int(m) if m is not None else n
        step = (f2 - f1) / m
        super().__init__(
            n, m,
            w=np.exp(-2j * np.pi * step / fs),
            a=np.exp(2j * np.pi * f1 / fs),
        )
        self.f1, self.f2, self.fs = f1, f2, fs
