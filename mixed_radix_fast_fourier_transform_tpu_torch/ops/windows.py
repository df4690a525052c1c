"""scipy.signal.windows-compatible named window functions.

Counterpart of ``mixed_radix_fast_fourier_transform_tpu/ops/windows.py``.
Windows are design-time constants, computed in numpy float64 on the host
and returned as numpy arrays, like twiddles and filter taps;
``ops/stft.get_window`` is the string-spec engine used inside transforms,
and this module is the scipy-style named surface with scipy's ``sym=True``
default.  Parameterized families the string spec cannot express
(general_cosine, taylor, kaiser_bessel_derived …) are implemented here
directly.
"""

from __future__ import annotations

import numpy as np

from .stft import dpss, get_window

__all__ = [
    "barthann", "bartlett", "blackman", "blackmanharris", "bohman", "boxcar",
    "chebwin", "cosine", "exponential", "flattop", "gaussian",
    "general_cosine", "general_gaussian", "general_hamming", "hamming",
    "hann", "kaiser", "kaiser_bessel_derived", "lanczos", "nuttall",
    "parzen", "taylor", "triang", "tukey", "dpss", "get_window",
]


def _named(name):
    def win(M: int, sym: bool = True) -> np.ndarray:
        return get_window(name, int(M), dtype=np.float64, sym=sym)

    win.__name__ = name
    win.__qualname__ = name
    win.__doc__ = (f"{name.capitalize()} window of length M "
                   f"(scipy.signal.windows.{name}; sym=True symmetric, "
                   "sym=False periodic/DFT-even).")
    return win


barthann = _named("barthann")
bartlett = _named("bartlett")
blackman = _named("blackman")
blackmanharris = _named("blackmanharris")
bohman = _named("bohman")
boxcar = _named("boxcar")
cosine = _named("cosine")
flattop = _named("flattop")
hamming = _named("hamming")
hann = _named("hann")
lanczos = _named("lanczos")
nuttall = _named("nuttall")
parzen = _named("parzen")
triang = _named("triang")


def kaiser(M: int, beta: float, sym: bool = True) -> np.ndarray:
    """Kaiser window (scipy.signal.windows.kaiser)."""
    return get_window(("kaiser", beta), int(M), dtype=np.float64, sym=sym)


def tukey(M: int, alpha: float = 0.5, sym: bool = True) -> np.ndarray:
    """Tukey (tapered-cosine) window (scipy.signal.windows.tukey)."""
    return get_window(("tukey", alpha), int(M), dtype=np.float64, sym=sym)


def gaussian(M: int, std: float, sym: bool = True) -> np.ndarray:
    """Gaussian window (scipy.signal.windows.gaussian)."""
    return get_window(("gaussian", std), int(M), dtype=np.float64, sym=sym)


def exponential(M: int, center=None, tau: float = 1.0,
                sym: bool = True) -> np.ndarray:
    """Exponential (Poisson) window (scipy.signal.windows.exponential).
    A non-default ``center`` needs ``sym=False`` (scipy convention)."""
    if center is not None and sym:
        raise ValueError("if sym is True, center must be None")
    if center is None:
        return get_window(("exponential", None, tau), int(M),
                          dtype=np.float64, sym=sym)
    n = np.arange(int(M), dtype=np.float64)
    return np.exp(-np.abs(n - center) / tau)


def chebwin(M: int, at: float = 100.0, sym: bool = True) -> np.ndarray:
    """Dolph-Chebyshev window (scipy.signal.windows.chebwin)."""
    return get_window(("chebwin", at), int(M), dtype=np.float64, sym=sym)


def _ext(M: int, sym: bool):
    """(design length, trim) implementing scipy's periodic convention:
    a sym=False window is the length-(M+1) symmetric window minus its
    final sample."""
    if sym:
        return int(M), False
    return int(M) + 1, True


def general_cosine(M: int, a, sym: bool = True) -> np.ndarray:
    """Generic weighted sum-of-cosines window w = Σ aₖ·cos(k·fac) on
    fac = linspace(−π, π, M) (scipy.signal.windows.general_cosine)."""
    a = np.asarray(a, np.float64)
    if int(M) <= 0:
        return np.zeros(0)
    if int(M) == 1:
        return np.ones(1)
    m, trim = _ext(M, sym)
    fac = np.linspace(-np.pi, np.pi, m)
    w = np.zeros(m)
    for k, ak in enumerate(a):
        w += ak * np.cos(k * fac)
    return w[:-1] if trim else w


def general_hamming(M: int, alpha: float, sym: bool = True) -> np.ndarray:
    """Generalized Hamming: α − (1−α)·cos-term
    (scipy.signal.windows.general_hamming)."""
    return general_cosine(M, [alpha, 1.0 - alpha], sym)


def general_gaussian(M: int, p: float, sig: float,
                     sym: bool = True) -> np.ndarray:
    """Generalized Gaussian exp(−½|n/σ|^{2p})
    (scipy.signal.windows.general_gaussian)."""
    if int(M) <= 0:
        return np.zeros(0)
    if int(M) == 1:
        return np.ones(1)
    m, trim = _ext(M, sym)
    n = np.arange(m) - (m - 1) / 2.0
    w = np.exp(-0.5 * np.abs(n / sig) ** (2 * p))
    return w[:-1] if trim else w


def taylor(M: int, nbar: int = 4, sll: float = 30.0, norm: bool = True,
           sym: bool = True) -> np.ndarray:
    """Taylor window (scipy.signal.windows.taylor): the radar/array-taper
    approximation of the Dolph-Chebyshev with ``nbar`` near-in sidelobes
    held at −``sll`` dB."""
    if int(M) <= 0:
        return np.zeros(0)
    if int(M) == 1:
        return np.ones(1)
    m_len, trim = _ext(M, sym)
    B = 10.0 ** (sll / 20.0)
    A = np.arccosh(B) / np.pi
    s2 = nbar ** 2 / (A ** 2 + (nbar - 0.5) ** 2)
    ma = np.arange(1, nbar)
    Fm = np.zeros(nbar - 1)
    signs = np.empty_like(ma, dtype=np.float64)
    signs[::2] = 1.0
    signs[1::2] = -1.0
    m2 = ma ** 2
    for mi, _ in enumerate(ma):
        numer = signs[mi] * np.prod(
            1.0 - m2[mi] / (s2 * (A ** 2 + (ma - 0.5) ** 2)))
        denom = 2.0 * np.prod(
            np.concatenate([1.0 - m2[mi] / m2[:mi],
                            1.0 - m2[mi] / m2[mi + 1:]]))
        Fm[mi] = numer / denom
    def W(n):
        return 1.0 + 2.0 * (Fm @ np.cos(
            2.0 * np.pi * ma[:, None]
            * (np.atleast_1d(n) - m_len / 2.0 + 0.5) / m_len))

    w = W(np.arange(m_len, dtype=np.float64))
    if norm:
        # evaluate the cosine series AT the (possibly half-sample) center
        w = w / W((m_len - 1) / 2.0)[0]
    return w[:-1] if trim else w


def kaiser_bessel_derived(M: int, beta: float, sym: bool = True
                          ) -> np.ndarray:
    """Kaiser-Bessel-derived (KBD) window — the MDCT/TDAC window family
    (scipy.signal.windows.kaiser_bessel_derived; even M, symmetric only)."""
    if not sym:
        raise ValueError("kaiser_bessel_derived requires sym=True")
    M = int(M)
    if M < 1:
        return np.zeros(0)
    if M % 2:
        raise ValueError("kaiser_bessel_derived requires an even M")
    half = kaiser(M // 2 + 1, beta, sym=True)
    csum = np.cumsum(half)
    w_half = np.sqrt(csum[:-1] / csum[-1])
    return np.concatenate([w_half, w_half[::-1]])
