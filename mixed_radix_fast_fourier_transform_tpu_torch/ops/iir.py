"""IIR filter design and recursive filtering on the device.

Counterpart of ``mixed_radix_fast_fourier_transform_tpu/ops/iir.py``.

Design (host numpy fp64, the JAX module's code line for line, so every
coefficient is bit-equal): analog prototypes (Butterworth, Chebyshev I/II,
elliptic via Landen-recursion Jacobi elliptic functions, Bessel-Thomson),
the lowpass→{lp,hp,bp,bs} frequency transforms, the bilinear transform,
representation conversions (zpk/tf/sos with nearest-style pole-zero
pairing), order selection, and the iirnotch/iirpeak/iircomb biquad closed
forms.

Application (device): ``sosfilt``/``lfilter`` run the transposed
direct-form-II state recurrence ``s[n] = A·s[n-1] + B·x[n]`` through
``utils.scan.linear_recurrence``: a blocked scan whose blocks are one fp32
product with the table of A's powers (TF32 off), a few device kernels per
level and log(n) levels instead of one step per sample.  ``filtfilt``/
``sosfiltfilt`` add scipy's odd-extension zero-phase pass on top.  The FIR
case of ``lfilter`` is the direct convolution of ``ops/convolve.py``
(cuDNN in full fp32).  The recursion is oracle-tested against scipy fp64.
"""

from __future__ import annotations

import math

from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..utils.config import DEFAULT_CONFIG, DTYPE, SpectralConfig
from ..utils.numerics import as_tensor, constant, content_key, pad_last
from ..utils.scan import linear_recurrence

Tensor = torch.Tensor

__all__ = [
    "buttap", "cheb1ap", "cheb2ap", "ellipap", "besselap",
    "lp2lp_zpk", "lp2hp_zpk", "lp2bp_zpk", "lp2bs_zpk", "bilinear_zpk",
    "zpk2tf", "tf2zpk", "sos2zpk", "zpk2sos", "tf2sos", "sos2tf",
    "iirfilter", "butter", "cheby1", "cheby2", "ellip", "bessel",
    "buttord", "cheb1ord", "cheb2ord", "ellipord",
    "iirnotch", "iirpeak", "iircomb",
    "lfilter_zi", "sosfilt_zi",
    "freqs", "freqs_zpk", "sosfreqz",
    "lfilter", "sosfilt", "filtfilt", "sosfiltfilt",
]


# ---------------------------------------------------------------------------
# Jacobi elliptic machinery (host fp64; complex-capable where noted).
#
# Everything rides the Landen recursion: a descending sequence of moduli
# k → k₁ → … → k_M ≈ 0 (quadratic convergence), after which sn/cd collapse
# to sin/cos and the recursion is unwound.  This is the classical
# Orfanidis/Antoniou formulation of elliptic filter design.
# ---------------------------------------------------------------------------


def _landen(k: float, tol: float = 1e-18, max_iter: int = 64) -> np.ndarray:
    """Descending Landen sequence [k₁, k₂, …] from modulus k ∈ [0, 1)."""
    if not 0.0 <= k < 1.0:
        raise ValueError(f"elliptic modulus must be in [0, 1), got {k}")
    ks = []
    while k > tol and len(ks) < max_iter:
        kp = math.sqrt(max(0.0, 1.0 - k * k))
        k = (k / (1.0 + kp)) ** 2
        ks.append(k)
    return np.asarray(ks, np.float64)


def _ellipk(k: float) -> float:
    """Complete elliptic integral K(k) = π/2 · ∏(1 + kᵢ) over the Landen
    descent (modulus convention, matching scipy.special.ellipk(k²))."""
    return math.pi / 2.0 * float(np.prod(1.0 + _landen(k)))


def _sn(u, k: float):
    """Jacobi sn(u·K(k), k) for u in units of the quarter period K.

    ``u`` may be a real array or complex scalar/array; the ascending Landen
    unwind is polynomial in w, so complex arguments ride through unchanged.
    """
    ks = _landen(k)
    w = np.sin(np.multiply(u, math.pi / 2.0))
    for ki in ks[::-1]:
        w = (1.0 + ki) * w / (1.0 + ki * w * w)
    return w


def _cd(u, k: float):
    """Jacobi cd(u·K(k), k) for u in units of K (complex-capable)."""
    ks = _landen(k)
    w = np.cos(np.multiply(u, math.pi / 2.0))
    for ki in ks[::-1]:
        w = (1.0 + ki) * w / (1.0 + ki * w * w)
    return w


def _acd(w, k: float):
    """Inverse cd in units of K: u with cd(u·K, k) = w (complex-capable)."""
    ks = np.concatenate([[k], _landen(k)])
    w = np.asarray(w, np.complex128)
    for i in range(1, len(ks)):
        w = 2.0 * w / ((1.0 + ks[i]) * (1.0 + np.sqrt(1.0 - ks[i - 1] ** 2 * w * w)))
    u = 2.0 / math.pi * np.arccos(w)
    return u


def _asn(w, k: float):
    """Inverse sn in units of K: sn(u·K) = cd((1−u)·K) ⇒ asn = 1 − acd."""
    return 1.0 - _acd(w, k)


def _ellipdeg(n: int, k1: float) -> float:
    """Solve the degree equation for the selectivity modulus k given the
    discrimination modulus k1 and order n (exact Landen/Jacobi form)."""
    L = n // 2
    ui = (2.0 * np.arange(1, L + 1) - 1.0) / n
    kc = math.sqrt(max(0.0, 1.0 - k1 * k1))  # complement of k1
    prod = float(np.prod(_sn(ui, kc))) if L else 1.0
    kp = kc**n * prod**4
    return math.sqrt(max(0.0, 1.0 - kp * kp))


# ---------------------------------------------------------------------------
# Analog lowpass prototypes (cutoff 1 rad/s, host fp64)
# ---------------------------------------------------------------------------


def buttap(N: int):
    """Butterworth analog lowpass prototype: (z, p, k) with the N poles on
    the unit left-half circle (scipy.signal.buttap parity)."""
    _check_order(N)
    m = np.arange(-N + 1, N, 2)
    p = -np.exp(1j * math.pi * m / (2 * N))
    return np.array([], np.complex128), p.astype(np.complex128), 1.0


def cheb1ap(N: int, rp: float):
    """Chebyshev type-I analog prototype with ``rp`` dB passband ripple."""
    _check_order(N)
    if rp <= 0:
        raise ValueError(f"rp must be > 0 dB, got {rp}")
    eps = math.sqrt(10.0 ** (0.1 * rp) - 1.0)
    mu = math.asinh(1.0 / eps) / N
    m = np.arange(-N + 1, N, 2)
    theta = math.pi * m / (2 * N)
    p = -(np.sinh(mu) * np.cos(theta) + 1j * np.cosh(mu) * np.sin(theta))
    k = float(np.real(np.prod(-p)))
    if N % 2 == 0:
        k /= math.sqrt(1.0 + eps * eps)
    return np.array([], np.complex128), p.astype(np.complex128), k


def cheb2ap(N: int, rs: float):
    """Chebyshev type-II (inverse Chebyshev) analog prototype with ``rs`` dB
    stopband attenuation (stopband edge at 1 rad/s)."""
    _check_order(N)
    if rs <= 0:
        raise ValueError(f"rs must be > 0 dB, got {rs}")
    de = 1.0 / math.sqrt(10.0 ** (0.1 * rs) - 1.0)
    mu = math.asinh(1.0 / de) / N
    m = np.arange(-N + 1, N, 2)
    theta = math.pi * m / (2 * N)
    # type-I poles with the inverse-ripple parameter, then reciprocate
    p = -(np.sinh(mu) * np.cos(theta) + 1j * np.cosh(mu) * np.sin(theta))
    p = 1.0 / p
    # zeros on the imaginary axis at 1j/sin(πm/2N); odd N skips the m=0
    # node (the zero at infinity)
    if N % 2:
        m_z = np.concatenate([np.arange(-N + 1, 0, 2), np.arange(2, N, 2)])
    else:
        m_z = np.arange(-N + 1, N, 2)
    z = 1j / np.sin(m_z * math.pi / (2 * N))
    k = float(np.real(np.prod(-p) / np.prod(-z)))
    return z.astype(np.complex128), p.astype(np.complex128), k


def ellipap(N: int, rp: float, rs: float):
    """Elliptic (Cauer) analog lowpass prototype: equiripple in both bands.

    Zeros/poles from the Jacobi cd parameterization (Landen recursion —
    ``_sn``/``_cd``/``_asn`` above); matches scipy.signal.ellipap to fp64
    round-off (oracle-tested).
    """
    _check_order(N)
    if rp <= 0 or rs <= 0:
        raise ValueError(f"rp and rs must be > 0 dB, got rp={rp} rs={rs}")
    if rs <= rp:
        raise ValueError("stopband attenuation rs must exceed passband rp")
    if N == 1:
        # degenerates to a real pole at the Chebyshev-I location
        eps = math.sqrt(10.0 ** (0.1 * rp) - 1.0)
        p = np.array([-1.0 / eps], np.complex128)
        return np.array([], np.complex128), p, float(np.real(np.prod(-p)))
    eps_p = math.sqrt(10.0 ** (0.1 * rp) - 1.0)
    eps_s = math.sqrt(10.0 ** (0.1 * rs) - 1.0)
    k1 = eps_p / eps_s  # discrimination factor
    k = _ellipdeg(N, k1)  # selectivity from the degree equation
    L = N // 2
    ui = (2.0 * np.arange(1, L + 1) - 1.0) / N
    # transmission zeros: s = j / (k · sn(vᵢ K, k)); the zero grid sits at
    # the odd Jacobi nodes for even N but the EVEN nodes for odd N (the
    # elliptic rational function's extra x-factor shifts the lattice)
    ui_z = ui if N % 2 == 0 else 2.0 * np.arange(1, L + 1) / N
    zsn = _sn(ui_z, k)
    z = 1j / (k * zsn)
    z = np.concatenate([z, np.conj(z)]).astype(np.complex128)
    # poles: s = j · cd((uᵢ − j v₀)·K, k) with v₀ real from the k1-plane
    # (asn of a purely imaginary argument is purely imaginary, so v₀ is real)
    v0 = float(np.real(-1j * np.asarray(_asn(1j / eps_p, k1)).reshape(()) / N))
    p = 1j * _cd(np.asarray(ui, np.complex128) - 1j * v0, k)
    p = np.concatenate([p, np.conj(p)]).astype(np.complex128)
    if N % 2 == 1:
        p0 = 1j * _sn(1j * v0, k)
        p = np.concatenate([p, np.atleast_1d(np.asarray(p0, np.complex128))])
    # enforce exact left-half-plane symmetry (Landen round-off cleanup)
    p = -np.abs(np.real(p)) + 1j * np.imag(p)
    k_gain = float(np.real(np.prod(-p) / np.prod(-z)))
    if N % 2 == 0:
        k_gain /= math.sqrt(1.0 + eps_p * eps_p)
    return z, p, k_gain


def besselap(N: int, norm: str = "phase"):
    """Bessel-Thomson analog prototype: roots of the reverse Bessel
    polynomial (exact integer coefficients, np.roots in fp64).

    norm='phase' (scipy default): cutoff where the phase hits −N·π/4;
    norm='delay': unit group delay at DC; norm='mag': −3 dB at 1 rad/s.
    """
    _check_order(N)
    if N == 0:
        return np.array([], np.complex128), np.array([], np.complex128), 1.0
    # reverse Bessel polynomial θ_N(s) = Σ a_k s^k,
    # a_k = (2N−k)! / (2^{N−k} · k! · (N−k)!)  — exact in Python ints
    a = [
        math.factorial(2 * N - k)
        // (2 ** (N - k) * math.factorial(k) * math.factorial(N - k))
        for k in range(N + 1)
    ]
    coeffs = np.array(a[::-1], np.float64)  # highest power first
    p = np.roots(coeffs).astype(np.complex128)
    a0 = float(a[0])
    if norm == "delay":
        pass  # unit delay normalization is the polynomial's natural gauge
    elif norm == "phase":
        p /= a0 ** (1.0 / N)  # geometric-mean scaling puts ω_c at 1 rad/s
    elif norm == "mag":
        p /= a0 ** (1.0 / N)
        # bisect for the −3 dB point of the phase-normalized filter, then
        # rescale so that |H(j·1)| = 1/√2 exactly
        k_gain = np.real(np.prod(-p))

        def mag(w):
            return abs(k_gain / np.prod(1j * w - p))

        lo, hi = 0.1, 10.0
        for _ in range(200):
            mid = 0.5 * (lo + hi)
            if mag(mid) > 1.0 / math.sqrt(2.0):
                lo = mid
            else:
                hi = mid
        p /= 0.5 * (lo + hi)
    else:
        raise ValueError(f"norm must be 'phase', 'delay' or 'mag', got {norm!r}")
    k_gain = float(np.real(np.prod(-p)))
    return np.array([], np.complex128), p, k_gain


def _check_order(N) -> None:
    if not isinstance(N, (int, np.integer)) or N < 0:
        raise ValueError(f"filter order must be a nonnegative int, got {N!r}")


# ---------------------------------------------------------------------------
# Frequency transforms + bilinear transform (zpk form, host fp64)
# ---------------------------------------------------------------------------


def _as_zpk(z, p, k):
    return (
        np.atleast_1d(np.asarray(z, np.complex128)),
        np.atleast_1d(np.asarray(p, np.complex128)),
        float(k),
    )


def lp2lp_zpk(z, p, k, wo: float = 1.0):
    """Lowpass→lowpass: scale cutoff to ``wo`` (scipy.signal.lp2lp_zpk)."""
    z, p, k = _as_zpk(z, p, k)
    degree = len(p) - len(z)
    return z * wo, p * wo, k * wo**degree


def lp2hp_zpk(z, p, k, wo: float = 1.0):
    """Lowpass→highpass at ``wo``: s → wo/s."""
    z, p, k = _as_zpk(z, p, k)
    degree = len(p) - len(z)
    zh = wo / z if len(z) else np.array([], np.complex128)
    ph = wo / p
    zh = np.append(zh, np.zeros(degree))  # zeros at the origin fill the degree
    k = k * float(np.real(np.prod(-z) / np.prod(-p)))
    return zh, ph, k


def lp2bp_zpk(z, p, k, wo: float = 1.0, bw: float = 1.0):
    """Lowpass→bandpass: s → (s² + wo²)/(bw·s)."""
    z, p, k = _as_zpk(z, p, k)
    degree = len(p) - len(z)
    zl = z * bw / 2.0
    pl = p * bw / 2.0
    zb = np.concatenate([zl + np.sqrt(zl**2 - wo**2), zl - np.sqrt(zl**2 - wo**2)])
    pb = np.concatenate([pl + np.sqrt(pl**2 - wo**2), pl - np.sqrt(pl**2 - wo**2)])
    zb = np.append(zb, np.zeros(degree))
    return zb, pb, k * bw**degree


def lp2bs_zpk(z, p, k, wo: float = 1.0, bw: float = 1.0):
    """Lowpass→bandstop: s → (bw·s)/(s² + wo²)."""
    z, p, k = _as_zpk(z, p, k)
    degree = len(p) - len(z)
    zl = (bw / 2.0) / z if len(z) else np.array([], np.complex128)
    pl = (bw / 2.0) / p
    zb = np.concatenate([zl + np.sqrt(zl**2 - wo**2), zl - np.sqrt(zl**2 - wo**2)])
    pb = np.concatenate([pl + np.sqrt(pl**2 - wo**2), pl - np.sqrt(pl**2 - wo**2)])
    zb = np.concatenate([zb, 1j * wo * np.ones(degree), -1j * wo * np.ones(degree)])
    # np.prod over an empty array is 1.0, covering the no-finite-zeros case
    k = k * float(np.real(np.prod(-z) / np.prod(-p)))
    return zb, pb, k


def bilinear_zpk(z, p, k, fs: float):
    """Analog→digital via the bilinear transform s = 2fs·(q−1)/(q+1)."""
    z, p, k = _as_zpk(z, p, k)
    degree = len(p) - len(z)
    fs2 = 2.0 * fs
    zd = (fs2 + z) / (fs2 - z)
    pd = (fs2 + p) / (fs2 - p)
    zd = np.append(zd, -np.ones(degree))  # analog zeros at ∞ → z = −1
    k = k * float(np.real(np.prod(fs2 - z) / np.prod(fs2 - p)))
    return zd, pd, k


# ---------------------------------------------------------------------------
# Representation conversions (host fp64)
# ---------------------------------------------------------------------------


def zpk2tf(z, p, k):
    """(z, p, k) → (b, a) polynomial coefficients (real if conjugate-paired)."""
    z, p, k = _as_zpk(z, p, k)
    b = k * np.poly(z) if len(z) else np.array([k])
    a = np.poly(p) if len(p) else np.array([1.0])
    if np.allclose(np.imag(b), 0, atol=1e-12 * max(1.0, np.abs(b).max())):
        b = np.real(b)
    if np.allclose(np.imag(a), 0, atol=1e-12 * max(1.0, np.abs(a).max())):
        a = np.real(a)
    return np.atleast_1d(b), np.atleast_1d(a)


def tf2zpk(b, a):
    """(b, a) → (z, p, k) via np.roots, with a₀-normalization."""
    b = np.atleast_1d(np.asarray(b, np.float64))
    a = np.atleast_1d(np.asarray(a, np.float64))
    if a[0] == 0:
        raise ValueError("a[0] must be nonzero")
    b, a = b / a[0], a / a[0]
    b_trim = np.trim_zeros(b, "f")
    k = b_trim[0] if len(b_trim) else 0.0
    z = np.roots(b_trim / k) if len(b_trim) > 1 else np.array([], np.complex128)
    p = np.roots(a) if len(a) > 1 else np.array([], np.complex128)
    return z.astype(np.complex128), p.astype(np.complex128), float(k)


def sos2zpk(sos):
    """Cascaded biquads → (z, p, k); trivial (origin-padding) roots kept,
    matching scipy (each section contributes exactly two of each)."""
    sos = np.atleast_2d(np.asarray(sos, np.float64))
    if sos.shape[1] != 6:
        raise ValueError(f"sos must be (n_sections, 6), got {sos.shape}")
    z_all, p_all, k = [], [], 1.0
    for row in sos:
        zi, pi, ki = tf2zpk(row[:3], row[3:])
        # pad to exactly 2 per section with origin roots (trivial factors)
        z_all.append(np.append(zi, np.zeros(2 - len(zi))))
        p_all.append(np.append(pi, np.zeros(2 - len(pi))))
        k *= ki
    return np.concatenate(z_all), np.concatenate(p_all), float(k)


def sos2tf(sos):
    """Cascaded biquads → single (b, a) by polynomial convolution."""
    sos = np.atleast_2d(np.asarray(sos, np.float64))
    b, a = np.array([1.0]), np.array([1.0])
    for row in sos:
        b = np.convolve(b, row[:3])
        a = np.convolve(a, row[3:])
    return b, a


def _nearest_idx(cands: np.ndarray, target: complex) -> int:
    return int(np.argmin(np.abs(cands - target)))


def zpk2sos(z, p, k, pairing: str = "nearest"):
    """(z, p, k) → second-order sections with nearest-style pairing.

    Follows scipy's design goals (pair the poles closest to the unit circle
    with their nearest zeros; emit those sections LAST so the cascade's
    worst-conditioned section sees already-filtered data) without promising
    bit-identical section ordering; equivalence is by pole/zero multiset and
    frequency response (oracle-tested).
    """
    if pairing != "nearest":
        raise ValueError(f"only pairing='nearest' is supported, got {pairing!r}")
    z, p, k = _as_zpk(z, p, k)
    if len(z) > len(p):
        raise ValueError("zpk2sos needs len(z) <= len(p) (proper digital filter)")
    n_sections = (len(p) + 1) // 2
    # pad both to 2·n_sections with origin roots (trivial z^{-1} factors)
    z = np.append(z, np.zeros(2 * n_sections - len(z)))
    p = np.append(p, np.zeros(2 * n_sections - len(p)))

    def split_conj(vals):
        """Split into (complex-upper-half list, real list) with conj pairing."""
        vals = list(vals)
        reals = [v for v in vals if abs(v.imag) <= 1e-12 * max(1.0, abs(v))]
        upper = [v for v in vals if v.imag > 1e-12 * max(1.0, abs(v))]
        lower = [v for v in vals if v.imag < -1e-12 * max(1.0, abs(v))]
        if len(upper) != len(lower):
            raise ValueError("roots are not conjugate-symmetric (complex filter)")
        return upper, [v.real for v in reals]

    pc, pr = split_conj(p)
    zc, zr = split_conj(z)
    sections = []
    # process pole pairs worst-first (closest to the unit circle)
    while pc or pr:
        if pc and (not pr or min(abs(1 - abs(x)) for x in pc)
                   <= min(abs(1 - abs(x)) for x in pr)):
            i = int(np.argmin([abs(1 - abs(x)) for x in pc]))
            p1 = pc.pop(i)
            psec = np.array([p1, np.conj(p1)])
        else:
            i = int(np.argmin([abs(1 - abs(x)) for x in pr]))
            p1 = pr.pop(i)
            if pr:  # pair with the real pole nearest to it
                j = _nearest_idx(np.asarray(pr), p1)
                psec = np.array([p1, pr.pop(j)])
            else:
                psec = np.array([p1])
        # choose zeros matching the section's realness structure
        zsec = []
        want = len(psec)
        if len(psec) == 2 and abs(psec[0].imag) > 0:
            if zc:
                j = _nearest_idx(np.asarray(zc), psec[0])
                zz = zc.pop(j)
                zsec = [zz, np.conj(zz)]
            else:
                while len(zsec) < 2 and zr:
                    zsec.append(zr.pop(_nearest_idx(np.asarray(zr), psec[0].real)))
        else:
            while len(zsec) < want and zr:
                zsec.append(zr.pop(_nearest_idx(np.asarray(zr), psec[0].real)))
            # a conjugate zero pair only fits if the section has room for both
            if len(zsec) + 2 <= want and zc:
                j = _nearest_idx(np.asarray(zc), psec[0])
                zz = zc.pop(j)
                zsec.extend([zz, np.conj(zz)])
        b, a = zpk2tf(np.asarray(zsec, np.complex128), psec, 1.0)
        b = np.pad(np.real(b), (0, 3 - len(b)))
        a = np.pad(np.real(a), (0, 3 - len(a)))
        sections.append(np.concatenate([b, a]))
    if zc or zr:  # leftover zeros (len(z) == len(p) case consumed them above)
        raise AssertionError("internal pairing error: unconsumed zeros")
    # gain on the final (best-conditioned, emitted-first) section; order the
    # cascade so near-unit-circle sections come last
    sos = np.vstack(sections[::-1])
    sos[0, :3] *= k
    return sos


def tf2sos(b, a, pairing: str = "nearest"):
    """(b, a) → second-order sections via zpk."""
    return zpk2sos(*tf2zpk(b, a), pairing=pairing)


# ---------------------------------------------------------------------------
# Top-level design entry points
# ---------------------------------------------------------------------------

_BTYPES = {"lowpass": "lowpass", "low": "lowpass", "highpass": "highpass",
           "high": "highpass", "bandpass": "bandpass", "band": "bandpass",
           "bandstop": "bandstop", "stop": "bandstop", "bs": "bandstop",
           "bp": "bandpass"}


def _normalize_wn(Wn, btype: str, fs: Optional[float], analog: bool):
    Wn = np.atleast_1d(np.asarray(Wn, np.float64))
    if fs is not None:
        if analog:
            raise ValueError("fs cannot be given for an analog filter")
        Wn = 2.0 * Wn / fs
    if btype in ("lowpass", "highpass"):
        if Wn.size != 1:
            raise ValueError(f"{btype} needs a scalar Wn, got {Wn}")
    else:
        if Wn.size != 2 or Wn[0] >= Wn[1]:
            raise ValueError(f"{btype} needs Wn = [low, high] with low < high")
    if not analog and (np.any(Wn <= 0) or np.any(Wn >= 1)):
        raise ValueError(
            f"digital critical frequencies must be in (0, 1) (fs-normalized by "
            f"Nyquist), got {Wn}"
        )
    if analog and np.any(Wn <= 0):
        raise ValueError(f"analog critical frequencies must be > 0, got {Wn}")
    return Wn


def iirfilter(N: int, Wn, rp: Optional[float] = None, rs: Optional[float] = None,
              btype: str = "lowpass", analog: bool = False,
              ftype: str = "butter", output: str = "ba",
              fs: Optional[float] = None):
    """General IIR design (scipy.signal.iirfilter semantics): analog
    prototype → band transform → (bilinear) → requested representation.

    Digital ``Wn`` is Nyquist-normalized unless ``fs`` is given.  ``output``
    is 'ba', 'zpk' or 'sos'.
    """
    btype_l = _BTYPES.get(btype.lower())
    if btype_l is None:
        raise ValueError(f"unknown btype {btype!r}")
    ftype_l = ftype.lower()
    Wn = _normalize_wn(Wn, btype_l, fs, analog)

    if ftype_l in ("butter", "butterworth"):
        z, p, k = buttap(N)
    elif ftype_l in ("cheby1", "chebyshev1", "cheby_1"):
        if rp is None:
            raise ValueError("cheby1 needs passband ripple rp (dB)")
        z, p, k = cheb1ap(N, rp)
    elif ftype_l in ("cheby2", "chebyshev2", "cheby_2"):
        if rs is None:
            raise ValueError("cheby2 needs stopband attenuation rs (dB)")
        z, p, k = cheb2ap(N, rs)
    elif ftype_l in ("ellip", "elliptic", "cauer"):
        if rp is None or rs is None:
            raise ValueError("ellip needs both rp and rs (dB)")
        z, p, k = ellipap(N, rp, rs)
    elif ftype_l in ("bessel", "bessel_phase"):
        z, p, k = besselap(N, norm="phase")
    else:
        raise ValueError(f"unknown ftype {ftype!r}")

    if analog:
        warped = Wn
    else:
        # bilinear prewarp at the design rate fs=2: Ω = 2·fs·tan(π·Wn/fs)
        fs_design = 2.0
        warped = 2.0 * fs_design * np.tan(math.pi * Wn / fs_design)

    if btype_l == "lowpass":
        z, p, k = lp2lp_zpk(z, p, k, wo=float(warped[0]))
    elif btype_l == "highpass":
        z, p, k = lp2hp_zpk(z, p, k, wo=float(warped[0]))
    elif btype_l == "bandpass":
        wo = math.sqrt(warped[0] * warped[1])
        bw = float(warped[1] - warped[0])
        z, p, k = lp2bp_zpk(z, p, k, wo=wo, bw=bw)
    else:
        wo = math.sqrt(warped[0] * warped[1])
        bw = float(warped[1] - warped[0])
        z, p, k = lp2bs_zpk(z, p, k, wo=wo, bw=bw)

    if not analog:
        z, p, k = bilinear_zpk(z, p, k, fs=2.0)

    if output == "zpk":
        return z, p, k
    if output == "ba":
        return zpk2tf(z, p, k)
    if output == "sos":
        return zpk2sos(z, p, k)
    raise ValueError(f"output must be 'ba', 'zpk' or 'sos', got {output!r}")


def butter(N, Wn, btype="lowpass", analog=False, output="ba", fs=None):
    """Butterworth design (scipy.signal.butter parity)."""
    return iirfilter(N, Wn, btype=btype, analog=analog, ftype="butter",
                     output=output, fs=fs)


def cheby1(N, rp, Wn, btype="lowpass", analog=False, output="ba", fs=None):
    """Chebyshev type-I design (scipy.signal.cheby1 parity)."""
    return iirfilter(N, Wn, rp=rp, btype=btype, analog=analog,
                     ftype="cheby1", output=output, fs=fs)


def cheby2(N, rs, Wn, btype="lowpass", analog=False, output="ba", fs=None):
    """Chebyshev type-II design (scipy.signal.cheby2 parity)."""
    return iirfilter(N, Wn, rs=rs, btype=btype, analog=analog,
                     ftype="cheby2", output=output, fs=fs)


def ellip(N, rp, rs, Wn, btype="lowpass", analog=False, output="ba", fs=None):
    """Elliptic (Cauer) design (scipy.signal.ellip parity)."""
    return iirfilter(N, Wn, rp=rp, rs=rs, btype=btype, analog=analog,
                     ftype="ellip", output=output, fs=fs)


def bessel(N, Wn, btype="lowpass", analog=False, output="ba", fs=None,
           norm="phase"):
    """Bessel-Thomson design (scipy.signal.bessel, norm='phase' default)."""
    if norm != "phase":
        raise ValueError("only norm='phase' is supported through bessel(); "
                         "use besselap(N, norm=...) + the zpk band transforms")
    return iirfilter(N, Wn, btype=btype, analog=analog, ftype="bessel",
                     output=output, fs=fs)


# ---------------------------------------------------------------------------
# Order selection
# ---------------------------------------------------------------------------


def _band_nat(wp, ws, btype: str, analog: bool):
    """Prewarp and reduce the spec to (selectivity nat >= 1, warped edges)."""
    wp = np.atleast_1d(np.asarray(wp, np.float64))
    ws = np.atleast_1d(np.asarray(ws, np.float64))
    if analog:
        passb, stopb = wp.copy(), ws.copy()
    else:
        passb = np.tan(math.pi * wp / 2.0)
        stopb = np.tan(math.pi * ws / 2.0)
    if btype == "lowpass":
        nat = stopb / passb
    elif btype == "highpass":
        nat = passb / stopb
    elif btype == "bandpass":
        nat = np.min(np.abs(
            (stopb**2 - passb[0] * passb[1]) / (stopb * (passb[0] - passb[1]))
        ))
    else:  # bandstop: callers re-optimize the passband edges via
        # _bandstop_nudge (scipy's fminbound over band_stop_obj)
        nat = np.min(np.abs(
            (stopb * (passb[0] - passb[1])) / (stopb**2 - passb[0] * passb[1])
        ))
    return float(np.min(np.abs(nat))), passb, stopb


def band_stop_obj(wp, ind: int, passb, stopb, gpass: float, gstop: float,
                  type: str):
    """Band-stop order objective (scipy.signal.band_stop_obj): the filter
    order needed when passband edge ``ind`` is moved to ``wp`` — minimized
    over the feasible edge range to find the most selective band-stop spec."""
    passbC = np.asarray(passb, np.float64).copy()
    passbC[ind] = wp
    stopb = np.asarray(stopb, np.float64)
    nat = np.min(np.abs(stopb * (passbC[0] - passbC[1])
                        / (stopb ** 2 - passbC[0] * passbC[1])))
    GSTOP = 10.0 ** (0.1 * abs(gstop))
    GPASS = 10.0 ** (0.1 * abs(gpass))
    if type == "butter":
        return math.log10((GSTOP - 1.0) / (GPASS - 1.0)) \
            / (2.0 * math.log10(nat))
    if type == "cheby":
        return math.acosh(math.sqrt((GSTOP - 1.0) / (GPASS - 1.0))) \
            / math.acosh(nat)
    if type == "ellip":
        k = 1.0 / nat
        k1 = math.sqrt((GPASS - 1.0) / (GSTOP - 1.0))
        kp = math.sqrt(max(0.0, 1.0 - k * k))
        k1p = math.sqrt(max(0.0, 1.0 - k1 * k1))
        return _ellipk(k) * _ellipk(k1p) / (_ellipk(kp) * _ellipk(k1))
    raise ValueError(f"incorrect type: {type!r}")


def _golden_min(f, a: float, b: float, tol: float = 1e-12,
                max_iter: int = 200) -> float:
    """Bounded scalar minimization by golden-section (host design-time)."""
    invphi = (math.sqrt(5.0) - 1.0) / 2.0
    c, d = b - invphi * (b - a), a + invphi * (b - a)
    fc, fd = f(c), f(d)
    for _ in range(max_iter):
        if b - a < tol * (abs(a) + abs(b) + 1.0):
            break
        if fc < fd:
            b, d, fd = d, c, fc
            c = b - invphi * (b - a)
            fc = f(c)
        else:
            a, c, fc = c, d, fd
            d = a + invphi * (b - a)
            fd = f(d)
    return (a + b) / 2.0


def _bandstop_nudge(passb: np.ndarray, stopb: np.ndarray, gpass: float,
                    gstop: float, ftype: str):
    """scipy's band-stop edge optimization: pull each passband edge toward
    the stopband to maximize selectivity (minimize the required order);
    returns (nat, nudged passb)."""
    passb = passb.copy()
    passb[0] = _golden_min(
        lambda w: band_stop_obj(w, 0, passb, stopb, gpass, gstop, ftype),
        passb[0], stopb[0] - 1e-12)
    passb[1] = _golden_min(
        lambda w: band_stop_obj(w, 1, passb, stopb, gpass, gstop, ftype),
        stopb[1] + 1e-12, passb[1])
    nat = np.min(np.abs(stopb * (passb[0] - passb[1])
                        / (stopb ** 2 - passb[0] * passb[1])))
    return float(nat), passb


def _infer_btype(wp, ws) -> str:
    wp = np.atleast_1d(np.asarray(wp, np.float64))
    ws = np.atleast_1d(np.asarray(ws, np.float64))
    if wp.size == 1:
        return "lowpass" if wp[0] < ws[0] else "highpass"
    if wp.size == 2 and ws.size == 2:
        return "bandpass" if wp[0] > ws[0] else "bandstop"
    raise ValueError("wp and ws must both be scalars or both length-2")


def _maybe_fs(w, fs):
    w = np.atleast_1d(np.asarray(w, np.float64))
    return 2.0 * w / fs if fs is not None else w


def buttord(wp, ws, gpass: float, gstop: float, analog: bool = False,
            fs: Optional[float] = None):
    """Butterworth order selection (scipy.signal.buttord semantics, incl.
    the band-stop passband-edge optimization).  Returns (N, Wn)."""
    wp_n, ws_n = _maybe_fs(wp, fs), _maybe_fs(ws, fs)
    btype = _infer_btype(wp_n, ws_n)
    nat, passb, stopb = _band_nat(wp_n, ws_n, btype, analog)
    if btype == "bandstop":
        nat, passb = _bandstop_nudge(passb, stopb, gpass, gstop, "butter")
    GSTOP = 10.0 ** (0.1 * abs(gstop))
    GPASS = 10.0 ** (0.1 * abs(gpass))
    N = int(math.ceil(
        math.log10((GSTOP - 1.0) / (GPASS - 1.0)) / (2.0 * math.log10(nat))
    ))
    # natural frequency meeting the PASSBAND spec exactly (scipy convention),
    # in the passband-normalized lowpass domain
    W0 = (GPASS - 1.0) ** (-1.0 / (2.0 * N))
    return N, _ord_wn_back(W0, btype, passb, analog, fs)


def _ord_wn_back(W0: float, btype: str, passb: np.ndarray, analog: bool,
                 fs: Optional[float]):
    """Map a passband-normalized lowpass natural frequency W0 back to the
    digital/analog critical frequencies of the requested band type."""
    if btype == "lowpass":
        WN = np.atleast_1d(W0 * passb)
    elif btype == "highpass":
        WN = np.atleast_1d(passb / W0)
    elif btype == "bandpass":
        # invert the bandpass map W0 = (w² − w0²)/(bw·w): quadratic in w
        bw = passb[1] - passb[0]
        wo2 = passb[0] * passb[1]
        disc = np.sqrt((W0 * bw) ** 2 + 4.0 * wo2)
        WN = np.sort(np.abs(np.array([
            (W0 * bw + disc) / 2.0, (W0 * bw - disc) / 2.0,
        ])))
    else:  # bandstop: W0 = bw·w/(w0² − w²)
        bw = passb[1] - passb[0]
        wo2 = passb[0] * passb[1]
        disc = np.sqrt((bw / W0) ** 2 + 4.0 * wo2)
        WN = np.sort(np.abs(np.array([
            (bw / W0 + disc) / 2.0, (bw / W0 - disc) / 2.0,
        ])))
    return _unwarp_wn(WN, analog, fs)


def _unwarp_wn(WN, analog: bool, fs: Optional[float]):
    """Prewarped edge(s) → digital/analog critical frequency output."""
    WN = np.atleast_1d(np.asarray(WN, np.float64))
    if not analog:
        WN = 2.0 / math.pi * np.arctan(WN)
    if fs is not None:
        WN = WN * fs / 2.0
    return float(WN[0]) if WN.size == 1 else WN


def cheb1ord(wp, ws, gpass: float, gstop: float, analog: bool = False,
             fs: Optional[float] = None):
    """Chebyshev-I order selection; Wn is the (band-stop: selectivity-
    optimized) passband edge (scipy parity)."""
    wp_n, ws_n = _maybe_fs(wp, fs), _maybe_fs(ws, fs)
    btype = _infer_btype(wp_n, ws_n)
    nat, passb, stopb = _band_nat(wp_n, ws_n, btype, analog)
    if btype == "bandstop":
        nat, passb = _bandstop_nudge(passb, stopb, gpass, gstop, "cheby")
    GSTOP = 10.0 ** (0.1 * abs(gstop))
    GPASS = 10.0 ** (0.1 * abs(gpass))
    N = int(math.ceil(
        math.acosh(math.sqrt((GSTOP - 1.0) / (GPASS - 1.0))) / math.acosh(nat)
    ))
    return N, _unwarp_wn(passb, analog, fs)


def cheb2ord(wp, ws, gpass: float, gstop: float, analog: bool = False,
             fs: Optional[float] = None):
    """Chebyshev-II order selection; Wn meets the passband spec exactly."""
    wp_n, ws_n = _maybe_fs(wp, fs), _maybe_fs(ws, fs)
    btype = _infer_btype(wp_n, ws_n)
    nat, passb, stopb = _band_nat(wp_n, ws_n, btype, analog)
    if btype == "bandstop":
        nat, passb = _bandstop_nudge(passb, stopb, gpass, gstop, "cheby")
    GSTOP = 10.0 ** (0.1 * abs(gstop))
    GPASS = 10.0 ** (0.1 * abs(gpass))
    N = int(math.ceil(
        math.acosh(math.sqrt((GSTOP - 1.0) / (GPASS - 1.0))) / math.acosh(nat)
    ))
    # the type-II "Wn" (stopband-edge parameter) that meets the passband
    # spec exactly: T_N(W0) = sqrt((GSTOP−1)/(GPASS−1)) in the
    # passband-normalized lowpass domain
    W0 = math.cosh(
        (1.0 / N) * math.acosh(math.sqrt((GSTOP - 1.0) / (GPASS - 1.0)))
    )
    return N, _ord_wn_back(W0, btype, passb, analog, fs)


def ellipord(wp, ws, gpass: float, gstop: float, analog: bool = False,
             fs: Optional[float] = None):
    """Elliptic order selection via the exact degree equation
    N = ⌈K(k)·K′(k₁) / (K′(k)·K(k₁))⌉; Wn is the passband edge."""
    wp_n, ws_n = _maybe_fs(wp, fs), _maybe_fs(ws, fs)
    btype = _infer_btype(wp_n, ws_n)
    nat, passb, stopb = _band_nat(wp_n, ws_n, btype, analog)
    if btype == "bandstop":
        nat, passb = _bandstop_nudge(passb, stopb, gpass, gstop, "ellip")
    GSTOP = 10.0 ** (0.1 * abs(gstop))
    GPASS = 10.0 ** (0.1 * abs(gpass))
    k = 1.0 / nat  # selectivity
    k1 = math.sqrt((GPASS - 1.0) / (GSTOP - 1.0))  # discrimination
    kp = math.sqrt(max(0.0, 1.0 - k * k))
    k1p = math.sqrt(max(0.0, 1.0 - k1 * k1))
    N = int(math.ceil(_ellipk(k) * _ellipk(k1p) / (_ellipk(kp) * _ellipk(k1))))
    return N, _unwarp_wn(passb, analog, fs)


# ---------------------------------------------------------------------------
# Biquad closed forms
# ---------------------------------------------------------------------------


def iirnotch(w0: float, Q: float, fs: float = 2.0):
    """Second-order notch (scipy.signal.iirnotch closed form)."""
    return _notch_peak(w0, Q, fs, "notch")


def iirpeak(w0: float, Q: float, fs: float = 2.0):
    """Second-order resonant peak (scipy.signal.iirpeak closed form)."""
    return _notch_peak(w0, Q, fs, "peak")


def _notch_peak(w0: float, Q: float, fs: float, kind: str):
    w0 = 2.0 * w0 / fs
    if not 0 < w0 < 1:
        raise ValueError(f"w0 must be in (0, fs/2), got normalized {w0}")
    w0 *= math.pi
    bw = w0 / Q
    gb = 1.0 / math.sqrt(2.0)
    if kind == "notch":
        beta = gb / math.sqrt(1.0 - gb**2) * math.tan(bw / 2.0)
    else:
        beta = math.sqrt(1.0 - gb**2) / gb * math.tan(bw / 2.0)
    gain = 1.0 / (1.0 + beta)
    if kind == "notch":
        b = gain * np.array([1.0, -2.0 * math.cos(w0), 1.0])
    else:
        b = (1.0 - gain) * np.array([1.0, 0.0, -1.0])
    a = np.array([1.0, -2.0 * gain * math.cos(w0), 2.0 * gain - 1.0])
    return b, a


def iircomb(w0: float, Q: float, ftype: str = "notch", fs: float = 2.0,
            *, pass_zero: bool = False):
    """Comb notch/peak filter (scipy.signal.iircomb semantics).

    ``N = fs/w0`` teeth.  notch + pass_zero=False rejects the harmonics of
    ``w0`` (zeros at the N-th roots of unity); pass_zero=True shifts the
    teeth to the odd half-harmonics (zeros at the roots of −1).  peak swaps
    which comb is passed vs rejected.  Feedback comb H(z) with delay N:
    H(z) = g·(1 ∓ z⁻ᴺ)/(1 ∓ a·z⁻ᴺ).
    """
    if ftype not in ("notch", "peak"):
        raise ValueError(f"ftype must be 'notch' or 'peak', got {ftype!r}")
    N_f = fs / w0
    N = int(round(N_f))
    if abs(N_f - N) > 1e-9 or N < 1:
        raise ValueError(f"w0 must evenly divide fs (fs/w0 = {N_f})")
    # -3 dB bandwidth of each tooth: w0/Q (in the same units as w0/fs)
    w_delta = 2.0 * math.pi * (w0 / Q) / fs  # rad/sample
    # β = tan(N·Δω/4) at the half-power gain 1/√2 (the gb-factors cancel)
    beta = math.tan(N * w_delta / 4.0)
    gain = 1.0 / (1.0 + beta)
    # zeros at z^N = ±1: '-' rejects harmonics of w0, '+' the half-harmonics
    zero_sign = -1.0 if not pass_zero else 1.0
    if ftype == "peak":
        zero_sign = -zero_sign
    b = np.zeros(N + 1)
    a = np.zeros(N + 1)
    if ftype == "notch":
        b[0], b[N] = gain, zero_sign * gain
        a[0], a[N] = 1.0, zero_sign * (2.0 * gain - 1.0)
    else:
        # peak: zeros at z^N = ∓1, poles near the OPPOSITE roots (the comb
        # peaks between its own notches)
        b[0], b[N] = 1.0 - gain, -zero_sign * (1.0 - gain)
        a[0], a[N] = 1.0, zero_sign * (2.0 * gain - 1.0)
    return b, a


# ---------------------------------------------------------------------------
# Frequency responses
# ---------------------------------------------------------------------------


def freqs(b, a, worN=200):
    """Analog frequency response H(jω) on a host-chosen or given ω grid."""
    b = np.atleast_1d(np.asarray(b, np.float64))
    a = np.atleast_1d(np.asarray(a, np.float64))
    if isinstance(worN, (int, np.integer)):
        z, p, _ = tf2zpk(b, a)
        mags = np.abs(np.concatenate([z, p]))
        mags = mags[mags > 0]
        ref = np.exp(np.mean(np.log(mags))) if len(mags) else 1.0
        w = np.logspace(math.log10(ref) - 2, math.log10(ref) + 2, int(worN))
    else:
        w = np.asarray(worN, np.float64)
    s = 1j * w
    h = np.polyval(b, s) / np.polyval(a, s)
    return w, h


def freqs_zpk(z, p, k, worN=200):
    """Analog response from zpk factors (numerically robust at high order)."""
    z, p, k = _as_zpk(z, p, k)
    if isinstance(worN, (int, np.integer)):
        mags = np.abs(np.concatenate([z, p]))
        mags = mags[mags > 0]
        ref = np.exp(np.mean(np.log(mags))) if len(mags) else 1.0
        w = np.logspace(math.log10(ref) - 2, math.log10(ref) + 2, int(worN))
    else:
        w = np.asarray(worN, np.float64)
    s = 1j * w
    num = np.prod(s[:, None] - z[None, :], axis=1) if len(z) else 1.0
    den = np.prod(s[:, None] - p[None, :], axis=1)
    return w, k * num / den


def sosfreqz(sos, worN=512, whole: bool = False, fs: float = 2.0 * np.pi,
             *, device=None, config: SpectralConfig = DEFAULT_CONFIG):
    """Frequency response of cascaded biquads: product of per-section freqz
    (engine-FFT evaluation, ops/signal.freqz); ``h`` on ``device`` (default:
    the card)."""
    from .signal import freqz

    sos = np.atleast_2d(np.asarray(sos, np.float64))
    if sos.shape[1] != 6:
        raise ValueError(f"sos must be (n_sections, 6), got {sos.shape}")
    h = None
    w = None
    for row in sos:
        w, hi = freqz(row[:3], row[3:], worN=worN, whole=whole, fs=fs,
                      device=device, config=config)
        h = hi if h is None else h * hi
    return w, h



# ---------------------------------------------------------------------------
# Device application: the blocked linear-recurrence scan
# ---------------------------------------------------------------------------


def _recurrence_scan(A: np.ndarray, c: Tensor, s0: Tensor) -> Tensor:
    """All states of s[n] = A·s[n-1] + c[n] (``utils.scan.linear_recurrence``).

    ``A``: (p, p) host constants; ``c``: (n, ..., p) device drive terms;
    ``s0``: (..., p) initial state.  Returns (n, ..., p) states AFTER each
    step.  The powers of A are formed on the host in float64; every device
    product is fp32 with TF32 off (the JAX module measured 8.9e-3 drift in
    this scan under reduced-precision products)."""
    return linear_recurrence(np.asarray(A, np.float64), c, s0)


def _df2t_matrices(b: np.ndarray, a: np.ndarray) -> Tuple[np.ndarray, np.ndarray, float]:
    """Transposed direct-form-II state matrices for normalized (b, a):
    s[n] = A·s[n-1] + Bv·x[n],  y[n] = s[n-1][0] + b0·x[n]."""
    p = len(a) - 1
    bb = np.zeros(p + 1)
    bb[: len(b)] = b
    A = np.zeros((p, p))
    A[:, 0] = -a[1:]
    if p > 1:
        A[np.arange(p - 1), np.arange(1, p)] = 1.0
    Bv = bb[1:] - a[1:] * bb[0]
    return A, Bv, float(bb[0])


def _apply_df2t(x: Tensor, b: np.ndarray, a: np.ndarray,
                zi: Optional[Tensor]) -> Tuple[Tensor, Tensor]:
    """Run one DF2T stage over the LAST axis of ``x``; returns (y, zf)."""
    A, Bv, b0 = _df2t_matrices(b, a)
    p = A.shape[0]
    xm = torch.movedim(x, -1, 0)  # (n, ...)
    c = xm[..., None] * constant(Bv, x, x.dtype, key=content_key("df2t_B", Bv))  # (n, ..., p)
    if zi is None:
        s0 = x.new_zeros(xm.shape[1:] + (p,))
    else:
        s0 = as_tensor(zi, x.device).to(x.dtype).expand(xm.shape[1:] + (p,))
    states = _recurrence_scan(A, c, s0)
    prev = torch.cat([s0[None], states[:-1]], dim=0)
    y = torch.movedim(b0 * xm + prev[..., 0], 0, -1)
    return y, states[-1]


def _norm_ba(b, a) -> Tuple[np.ndarray, np.ndarray]:
    b = np.atleast_1d(np.asarray(b, np.float64))
    a = np.atleast_1d(np.asarray(a, np.float64))
    if b.ndim != 1 or a.ndim != 1:
        raise ValueError("b and a must be 1-D coefficient vectors")
    if a[0] == 0:
        raise ValueError("a[0] must be nonzero")
    return b / a[0], a / a[0]


def _real_signal(x) -> Tensor:
    """``x`` as a real fp32 tensor (numpy input goes to the card); integers
    and float64 are cast, as ``jnp.asarray`` does without x64."""
    x = as_tensor(x)
    if x.is_complex():
        raise ValueError("the IIR filters take real signals")
    return x.to(DTYPE)


def lfilter(b, a, x, axis: int = -1, zi: Optional[Tensor] = None,
            *, config: SpectralConfig = DEFAULT_CONFIG):
    """Causal IIR/FIR filtering, scipy.signal.lfilter semantics.

    FIR (``len(a) == 1``) runs as a direct convolution (cuDNN, full fp32);
    IIR runs the order-p transposed-DF2 recurrence as one blocked scan.
    ``zi`` (shape (..., p)) switches the return to ``(y, zf)``.  Filter
    coefficients must be concrete (host) values: they become keyed device
    tables."""
    from .convolve import _direct_convolve_nd

    b, a = _norm_ba(b, a)
    x = _real_signal(x)
    axis = axis % x.ndim
    xm = torch.movedim(x, axis, -1)
    if len(a) == 1:  # pure FIR: causal convolution, no recurrence
        if zi is not None:
            raise ValueError("zi is only supported for IIR (len(a) > 1)")
        n = xm.shape[-1]
        flat = xm.reshape(-1, n)
        taps = constant(b[None], xm, xm.dtype, key=content_key("lfilter_fir", b))
        y = _direct_convolve_nd(flat, taps, (-1,))[:, :n].reshape(xm.shape)
        return torch.movedim(y, -1, axis)
    if len(a) - 1 > 32:
        raise ValueError(
            f"direct-form order {len(a) - 1} > 32 is numerically and "
            "memory-wise hostile; convert to sos (tf2sos + sosfilt)"
        )
    y, zf = _apply_df2t(xm, b, a, zi)
    y = torch.movedim(y, -1, axis)
    return y if zi is None else (y, zf)


def _norm_sos(sos) -> np.ndarray:
    sos = np.atleast_2d(np.asarray(sos, np.float64))
    if sos.ndim != 2 or sos.shape[1] != 6:
        raise ValueError(f"sos must be (n_sections, 6), got {sos.shape}")
    if np.any(sos[:, 3] == 0):
        raise ValueError("each section needs a[0] != 0")
    return sos / sos[:, 3:4]


def sosfilt(sos, x, axis: int = -1, zi: Optional[Tensor] = None,
            *, config: SpectralConfig = DEFAULT_CONFIG):
    """Cascaded-biquad filtering (scipy.signal.sosfilt semantics), each
    section one 2-state blocked scan.  ``zi`` has shape
    (n_sections, ..., 2); providing it returns ``(y, zf)``."""
    sos = _norm_sos(sos)
    x = _real_signal(x)
    axis = axis % x.ndim
    y = torch.movedim(x, axis, -1)
    zf = []
    for i, row in enumerate(sos):
        zi_i = None if zi is None else zi[i]
        y, zf_i = _apply_df2t(y, row[:3], row[3:], zi_i)
        zf.append(zf_i)
    y = torch.movedim(y, -1, axis)
    return y if zi is None else (y, torch.stack(zf))


def lfilter_zi(b, a) -> np.ndarray:
    """Steady-state DF2T initial conditions for a unit-step input
    (scipy.signal.lfilter_zi): zi = (I − A)⁻¹·Bv scaled to the DC gain."""
    b, a = _norm_ba(b, a)
    if len(a) == 1:
        return np.zeros(max(len(b) - 1, 0))
    A, Bv, b0 = _df2t_matrices(b, a)
    p = A.shape[0]
    zi = np.linalg.solve(np.eye(p) - A, Bv)
    return zi


def sosfilt_zi(sos) -> np.ndarray:
    """Per-section steady-state initial conditions (scipy.signal.sosfilt_zi):
    section i's zi is scaled by the cumulative DC gain of sections < i."""
    sos = _norm_sos(sos)
    n_sections = sos.shape[0]
    zi = np.zeros((n_sections, 2))
    scale = 1.0
    for i, row in enumerate(sos):
        zi[i] = scale * lfilter_zi(row[:3], row[3:])
        scale *= np.sum(row[:3]) / np.sum(row[3:])  # section DC gain H(1)
    return zi


def _odd_ext(x: Tensor, n: int, axis: int = -1) -> Tensor:
    """Odd extension by ``n`` samples at both ends (scipy.signal.odd_ext)."""
    if n == 0:
        return x
    if n >= x.shape[axis]:
        raise ValueError(
            f"padlen {n} must be less than the signal length {x.shape[axis]} "
            "along the filter axis"
        )
    xm = torch.movedim(x, axis, -1)
    return torch.movedim(pad_last(xm, n, n, "odd"), -1, axis)


def _zero_phase_setup(x, n_taps: int, padtype, padlen):
    """(``x`` as a real fp32 tensor, the length of the odd extension at each
    end: 3·``n_taps`` unless ``padlen`` is given, 0 for ``padtype=None``)."""
    if padtype not in ("odd", None):
        raise ValueError("only padtype='odd' (scipy default) or None")
    edge = 3 * int(n_taps) if padlen is None else int(padlen)
    if padtype is None:
        edge = 0
    x = _real_signal(x)
    return x, edge


def filtfilt(b, a, x, axis: int = -1, padtype: Optional[str] = "odd",
             padlen: Optional[int] = None,
             *, config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    """Zero-phase forward-backward filtering (scipy.signal.filtfilt,
    method='pad' with odd extension and lfilter_zi edge matching)."""
    b_n, a_n = _norm_ba(b, a)
    x, edge = _zero_phase_setup(x, max(len(b_n), len(a_n)), padtype, padlen)
    axis = axis % x.ndim
    ext = _odd_ext(x, edge, axis=axis) if edge else x
    xm = torch.movedim(ext, axis, -1)
    zi = lfilter_zi(b_n, a_n)
    zid = constant(zi, xm, xm.dtype, key=content_key("lfilter_zi", zi))
    y, _ = _apply_df2t(xm, b_n, a_n, zid * xm[..., :1])
    y = torch.flip(y, (-1,))
    y, _ = _apply_df2t(y, b_n, a_n, zid * y[..., :1])
    y = torch.flip(y, (-1,))
    if edge:
        y = y[..., edge:-edge]
    return torch.movedim(y, -1, axis)


def sosfiltfilt(sos, x, axis: int = -1, padtype: Optional[str] = "odd",
                padlen: Optional[int] = None,
                *, config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    """Zero-phase cascaded-biquad filtering (scipy.signal.sosfiltfilt)."""
    sos_n = _norm_sos(sos)
    n_sections = sos_n.shape[0]
    ntaps = 2 * n_sections + 1
    ntaps -= min((sos_n[:, 2] == 0).sum(), (sos_n[:, 5] == 0).sum())
    x, edge = _zero_phase_setup(x, ntaps, padtype, padlen)
    axis = axis % x.ndim
    ext = _odd_ext(x, edge, axis=axis) if edge else x
    xm = torch.movedim(ext, axis, -1)
    zi = sosfilt_zi(sos_n)  # (S, 2)
    zid = constant(zi, xm, xm.dtype, key=content_key("sosfilt_zi", zi))

    def run(v):
        # every section's zi scales with the CASCADE input's first sample:
        # sosfilt_zi already carries the cumulative DC gain of the sections
        # before it (scaling by each section's own input would double-count)
        x0 = v[..., :1]
        out = v
        for i, row in enumerate(sos_n):
            out, _ = _apply_df2t(out, row[:3], row[3:], zid[i] * x0)
        return out

    y = torch.flip(run(xm), (-1,))
    y = torch.flip(run(y), (-1,))
    if edge:
        y = y[..., edge:-edge]
    return torch.movedim(y, -1, axis)


# ---------------------------------------------------------------------------
# ba-form conveniences, iirdesign, initial conditions, partial fractions
# (host fp64 — scipy.signal parity glue around the zpk core above)
# ---------------------------------------------------------------------------


class BadCoefficients(UserWarning):
    """Warning for badly conditioned filter coefficients
    (scipy.signal.BadCoefficients)."""


def normalize(b, a):
    """Normalize (b, a) so a[0] = 1, trimming leading numerator zeros with a
    :class:`BadCoefficients` warning (scipy.signal.normalize)."""
    b = np.atleast_1d(np.asarray(b, np.float64))
    a = np.atleast_1d(np.asarray(a, np.float64))
    if a[0] == 0:
        raise ValueError("a[0] must be nonzero")
    b, a = b / a[0], a / a[0]
    if len(b) > 1 and b[0] == 0.0:
        import warnings

        warnings.warn("Badly conditioned filter coefficients (numerator): "
                      "the results may be meaningless", BadCoefficients,
                      stacklevel=2)
    while len(b) > 1 and b[0] == 0.0:
        b = b[1:]
    return b, a


def bilinear(b, a, fs: float = 1.0):
    """Analog (b, a) → digital (b, a) via the bilinear transform
    (scipy.signal.bilinear), routed through the zpk core."""
    z, p, k = tf2zpk(b, a)
    return zpk2tf(*bilinear_zpk(z, p, k, fs=fs))


def lp2lp(b, a, wo: float = 1.0):
    """Lowpass→lowpass in ba form (scipy.signal.lp2lp)."""
    return zpk2tf(*lp2lp_zpk(*tf2zpk(b, a), wo=wo))


def lp2hp(b, a, wo: float = 1.0):
    """Lowpass→highpass in ba form (scipy.signal.lp2hp)."""
    return zpk2tf(*lp2hp_zpk(*tf2zpk(b, a), wo=wo))


def lp2bp(b, a, wo: float = 1.0, bw: float = 1.0):
    """Lowpass→bandpass in ba form (scipy.signal.lp2bp)."""
    return zpk2tf(*lp2bp_zpk(*tf2zpk(b, a), wo=wo, bw=bw))


def lp2bs(b, a, wo: float = 1.0, bw: float = 1.0):
    """Lowpass→bandstop in ba form (scipy.signal.lp2bs)."""
    return zpk2tf(*lp2bs_zpk(*tf2zpk(b, a), wo=wo, bw=bw))


def freqz_zpk(z, p, k, worN=512, whole: bool = False, fs: float = 2.0 * np.pi):
    """Digital frequency response from zpk factors — numerically robust for
    high orders (products of first-order factors, no polynomial blow-up)."""
    z, p, k = _as_zpk(z, p, k)
    if isinstance(worN, (int, np.integer)):
        span = fs if whole else fs / 2.0
        w = np.arange(int(worN)) * (span / int(worN))
    else:
        w = np.asarray(worN, np.float64)
    zd = np.exp(1j * 2.0 * np.pi * w / fs)
    num = np.prod(zd[:, None] - z[None, :], axis=1) if len(z) else 1.0
    den = np.prod(zd[:, None] - p[None, :], axis=1)
    return w, k * num / den


def freqz_sos(sos, worN=512, whole: bool = False, fs: float = 2.0 * np.pi,
              *, device=None, config: SpectralConfig = DEFAULT_CONFIG):
    """Alias of :func:`sosfreqz` (scipy 1.12+ name)."""
    return sosfreqz(sos, worN=worN, whole=whole, fs=fs, device=device, config=config)


_ORD_FNS = {
    "butter": (buttord, "butter"), "butterworth": (buttord, "butter"),
    "cheby1": (cheb1ord, "cheby1"), "cheby2": (cheb2ord, "cheby2"),
    "ellip": (ellipord, "ellip"), "elliptic": (ellipord, "ellip"),
    "cauer": (ellipord, "ellip"),
}


def iirdesign(wp, ws, gpass: float, gstop: float, analog: bool = False,
              ftype: str = "ellip", output: str = "ba",
              fs: Optional[float] = None):
    """Complete design from band specs (scipy.signal.iirdesign): order
    selection + filter design in one call."""
    sel = _ORD_FNS.get(ftype.lower())
    if sel is None:
        raise ValueError(f"iirdesign supports butter/cheby1/cheby2/ellip, "
                         f"got {ftype!r}")
    ordfn, design = sel
    N, Wn = ordfn(wp, ws, gpass, gstop, analog=analog, fs=fs)
    wp_arr = np.atleast_1d(np.asarray(wp, np.float64))
    btype = ("lowpass" if wp_arr.size == 1 and np.all(
        np.atleast_1d(wp) < np.atleast_1d(ws)) else
        "highpass" if wp_arr.size == 1 else
        "bandpass" if wp_arr[0] > np.atleast_1d(ws)[0] else "bandstop")
    return iirfilter(N, Wn, rp=gpass, rs=gstop, btype=btype, analog=analog,
                     ftype=design, output=output, fs=fs)


def lfiltic(b, a, y, x=None) -> np.ndarray:
    """Initial conditions ``zi`` for :func:`lfilter` given past outputs
    ``y = [y[-1], y[-2], …]`` and inputs ``x = [x[-1], …]``
    (scipy.signal.lfiltic, transposed direct-form II)."""
    b = np.atleast_1d(np.asarray(b, np.float64))
    a = np.atleast_1d(np.asarray(a, np.float64))
    n = max(len(a), len(b))
    bb = np.zeros(n)
    bb[: len(b)] = b
    aa = np.zeros(n)
    aa[: len(a)] = a
    bb, aa = bb / aa[0], aa / aa[0]
    y = np.asarray(y, np.float64)
    x = np.zeros(0) if x is None else np.asarray(x, np.float64)
    zi = np.zeros(n - 1)
    for m in range(n - 1):
        # z_m[-1] accumulates the taps the delayed samples already passed
        acc = 0.0
        for k in range(m + 1, n):
            j = k - m - 1
            if j < len(x):
                acc += bb[k] * x[j]
            if j < len(y):
                acc -= aa[k] * y[j]
        zi[m] = acc
    return zi


def unique_roots(p, tol: float = 1e-3, rtype: str = "min"):
    """Cluster near-equal roots and return (unique, multiplicity)
    (scipy.signal.unique_roots semantics)."""
    if rtype not in ("max", "min", "avg", "maximum", "minimum", "mean"):
        raise ValueError(f"unknown rtype {rtype!r}")
    p = np.atleast_1d(np.asarray(p, np.complex128))
    pool = list(p)
    uniq, mult = [], []
    while pool:
        r = pool.pop(0)
        group = [r]
        rest = []
        for q in pool:
            if abs(q - r) < tol:
                group.append(q)
            else:
                rest.append(q)
        pool = rest
        g = np.asarray(group)
        if rtype in ("max", "maximum"):
            rep = g[np.argmax(np.abs(g))]
        elif rtype in ("min", "minimum"):
            rep = g[np.argmin(np.abs(g))]
        else:
            rep = np.mean(g)
        uniq.append(rep)
        mult.append(len(group))
    return np.asarray(uniq), np.asarray(mult, np.int64)


def _poly_deriv_at(c: np.ndarray, r: complex, order: int) -> complex:
    """order-th derivative of the polynomial with coefficients c at r."""
    d = np.asarray(c, np.complex128)
    for _ in range(order):
        d = np.polyder(d)
    return np.polyval(d, r)


def residue(b, a, tol: float = 1e-3, rtype: str = "avg"):
    """Partial-fraction expansion of b(s)/a(s) (scipy.signal.residue):
    returns (r, p, k) with residues at each pole (repeated poles get
    ascending-power terms) and polynomial part k."""
    b = np.atleast_1d(np.asarray(b, np.float64))
    a = np.atleast_1d(np.asarray(a, np.float64))
    b, a = b / a[0], a / a[0]
    k = np.array([])
    if len(b) >= len(a):
        k, b = np.polydiv(b, a)
    poles = np.roots(a)
    uniq, mult = unique_roots(poles, tol=tol, rtype=rtype)
    r_out, p_out = [], []
    for i_p, (pr, m) in enumerate(zip(uniq, mult)):
        # divide out (s − pr)^m; the residues are Taylor coefficients of
        # g = b/rest around pr: term j gets r_j = g^{(m−j)}(pr)/(m−j)!
        rest = np.array([1.0 + 0j])
        for i_q, (qr, qm) in enumerate(zip(uniq, mult)):
            if i_q == i_p:
                continue
            for _ in range(qm):
                rest = np.convolve(rest, [1.0, -qr])
        for j in range(1, m + 1):
            order = m - j
            # exact Taylor coefficients of b and rest at pr, then series
            # division g = bt/rt up to the needed order
            bt = np.array([
                _poly_deriv_at(b, pr, i) / math.factorial(i)
                for i in range(order + 1)
            ])
            rt = np.array([
                _poly_deriv_at(rest, pr, i) / math.factorial(i)
                for i in range(order + 1)
            ])
            g = np.zeros(order + 1, np.complex128)
            for i in range(order + 1):
                s = bt[i] - sum(g[u] * rt[i - u] for u in range(i))
                g[i] = s / rt[0]
            r_out.append(g[order])
            p_out.append(pr)
    return np.asarray(r_out), np.asarray(p_out), np.real_if_close(k)


def residuez(b, a, tol: float = 1e-3, rtype: str = "avg"):
    """Partial fractions in z⁻¹ (scipy.signal.residuez): b(z⁻¹)/a(z⁻¹) =
    Σ r_i/(1 − p_i z⁻¹)^j + Σ k_i z⁻ⁱ."""
    b = np.atleast_1d(np.asarray(b, np.float64))
    a = np.atleast_1d(np.asarray(a, np.float64))
    b, a = b / a[0], a / a[0]
    # substitute u = z⁻¹: reverse coefficient order and reuse the s-plane
    # machinery on b(u)/a(u), whose poles are 1/p_i
    br, ar = b[::-1], a[::-1]
    k = np.array([])
    if len(br) >= len(ar):
        # polynomial part in z⁻¹ comes from deg_b >= deg_a in u
        k_u, br = np.polydiv(br, ar)
        k = k_u[::-1]
    r_u, p_u, _ = residue(br, ar, tol=tol, rtype=rtype)
    # map u-plane terms r_u/(u − u0)^j back to z⁻¹ form: with p = 1/u0,
    # (u − u0)^j = (−u0)^j·(1 − p·z⁻¹)^j, so r = r_u·(−p)^j
    r_out, p_out = [], []
    uniq, mult = unique_roots(p_u, tol=tol, rtype=rtype)
    idx = 0
    for u0, m in zip(uniq, mult):
        p = 1.0 / u0
        for j in range(1, m + 1):
            r_out.append(r_u[idx] * (-p) ** j)
            p_out.append(p)
            idx += 1
    return np.asarray(r_out), np.asarray(p_out), np.real_if_close(k)


def invres(r, p, k, tol: float = 1e-3, rtype: str = "avg"):
    """Inverse of :func:`residue`: assemble (b, a) from partial fractions."""
    r = np.atleast_1d(np.asarray(r, np.complex128))
    p = np.atleast_1d(np.asarray(p, np.complex128))
    uniq, mult = unique_roots(p, tol=tol, rtype=rtype)
    a = np.array([1.0 + 0j])
    for pr, m in zip(uniq, mult):
        for _ in range(m):
            a = np.convolve(a, [1.0, -pr])
    b = np.zeros(1, np.complex128)
    idx = 0
    for i_p, (pr, m) in enumerate(zip(uniq, mult)):
        for j in range(1, m + 1):
            # term r/(s − pr)^j: numerator = r · a(s)/(s − pr)^j
            term = np.array([1.0 + 0j])
            for i_q, (qr, qm) in enumerate(zip(uniq, mult)):
                reps = qm - (j if i_q == i_p else 0)
                for _ in range(max(0, reps)):
                    term = np.convolve(term, [1.0, -qr])
            b = np.polyadd(b, r[idx] * term)
            idx += 1
    if len(np.atleast_1d(k)) and np.any(np.atleast_1d(k) != 0):
        b = np.polyadd(b, np.convolve(np.atleast_1d(k), a))
    return np.real_if_close(b), np.real_if_close(a)


def invresz(r, p, k, tol: float = 1e-3, rtype: str = "avg"):
    """Inverse of :func:`residuez` (z⁻¹ form)."""
    r = np.atleast_1d(np.asarray(r, np.complex128))
    p = np.atleast_1d(np.asarray(p, np.complex128))
    uniq, mult = unique_roots(p, tol=tol, rtype=rtype)

    def add_asc(x, y):
        # arrays here are ASCENDING powers of z⁻¹ (index = delay), so
        # addition left-aligns at z⁰ (np.polyadd would right-align)
        n = max(len(x), len(y))
        out = np.zeros(n, np.complex128)
        out[: len(x)] += x
        out[: len(y)] += y
        return out

    a = np.array([1.0 + 0j])
    for pr, m in zip(uniq, mult):
        for _ in range(m):
            a = np.convolve(a, [1.0, -pr])  # [1, −pr] reads 1 − pr·z⁻¹
    b = np.zeros(1, np.complex128)
    idx = 0
    for i_p, (pr, m) in enumerate(zip(uniq, mult)):
        for j in range(1, m + 1):
            term = np.array([1.0 + 0j])
            for i_q, (qr, qm) in enumerate(zip(uniq, mult)):
                reps = qm - (j if i_q == i_p else 0)
                for _ in range(max(0, reps)):
                    term = np.convolve(term, [1.0, -qr])
            b = add_asc(b, r[idx] * term)
            idx += 1
    if len(np.atleast_1d(k)) and np.any(np.atleast_1d(k) != 0):
        b = add_asc(b, np.convolve(np.atleast_1d(k).astype(np.complex128), a))
    return np.real_if_close(b), np.real_if_close(a)


def findfreqs(num, den, N: int, kind: str = "ba") -> np.ndarray:
    """Log-spaced frequency grid covering a filter's interesting range
    (scipy.signal.findfreqs): decades bracketing the pole/zero magnitudes."""
    if kind == "ba":
        ep = np.atleast_1d(np.roots(np.asarray(den, np.float64)))
        tz = np.atleast_1d(np.roots(np.asarray(num, np.float64)))
    elif kind == "zp":
        ep = np.atleast_1d(np.asarray(den, np.complex128))
        tz = np.atleast_1d(np.asarray(num, np.complex128))
    else:
        raise ValueError(f"kind must be 'ba' or 'zp', got {kind!r}")
    if len(ep) == 0:
        ep = np.atleast_1d(-1000.0 + 0j)
    ez = np.r_[ep[ep.imag >= 0],
               tz[(np.abs(tz) < 1e5) & (tz.imag >= 0)]]
    integ = np.abs(ez) < 1e-10
    hfreq = np.around(
        np.log10(np.max(3 * np.abs(ez.real + integ) + 1.5 * ez.imag)) + 0.5)
    lfreq = np.around(
        np.log10(0.1 * np.min(np.abs((ez + integ).real) + 2 * ez.imag)) - 0.5)
    return np.logspace(lfreq, hfreq, int(N))
