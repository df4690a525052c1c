"""Fast Hankel transform (FFTLog) with scipy.fft.fht/ifht/fhtoffset
semantics, and the fast Walsh-Hadamard transform.

Counterpart of ``mixed_radix_fast_fourier_transform_tpu/ops/fht.py``.
Algorithm: Hamilton 2000 (FFTLog).  A Hankel transform of order mu on a
logarithmic grid is a convolution in log space, executed as rfft →
coefficient multiply → irfft on this library's real transforms.

The coefficient array u_m = (kr)^{-2πim/(n·dln)} · U_mu(q + 2πim/(n·dln))
with U_mu(x) = 2^x Γ((mu+1+x)/2)/Γ((mu+1-x)/2) is a host fp64 plan constant,
computed with a self-contained complex Lanczos log-gamma (no scipy runtime
dependency).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..utils.config import DEFAULT_CONFIG, DTYPE, SpectralConfig
from ..utils.numerics import as_tensor, host_table, product
from .rfft import irfft, rfft

Tensor = torch.Tensor

_LN2 = math.log(2.0)

# Lanczos g=7, n=9 coefficients (Numerical Recipes / Godfrey); ~1e-13 rel
# accuracy for Re(z) >= 0.5, extended below by the reflection formula.
_LANCZOS_G = 7.0
_LANCZOS_C = np.array([
    0.99999999999980993,
    676.5203681218851,
    -1259.1392167224028,
    771.32342877765313,
    -176.61502916214059,
    12.507343278686905,
    -0.13857109526572012,
    9.9843695780195716e-6,
    1.5056327351493116e-7,
])


def _loggamma(z: np.ndarray) -> np.ndarray:
    """Principal-branch log-gamma of a complex array (analytic continuation,
    matching scipy.special.loggamma for Re(z) >= 0.5; reflection below)."""
    z = np.atleast_1d(np.asarray(z, dtype=np.complex128))
    # shift each element up to Re >= 0.5 via loggamma(z) = loggamma(z+n) −
    # Σ_{k<n} log(z+k); the recurrence with principal logs tracks the
    # analytic continuation (reflection-formula variants lose 2πi multiples)
    n = np.maximum(0, np.ceil(0.5 - z.real)).astype(np.int64)
    corr = np.zeros_like(z)
    for k in range(int(n.max()) if n.size else 0):
        mask = k < n
        corr[mask] += np.log(z[mask] + k)
    zh = z + n - 1.0
    x = np.full(zh.shape, _LANCZOS_C[0], dtype=np.complex128)
    for i in range(1, len(_LANCZOS_C)):
        x = x + _LANCZOS_C[i] / (zh + i)
    t = zh + _LANCZOS_G + 0.5
    out = (
        0.5 * math.log(2.0 * np.pi)
        + (zh + 0.5) * np.log(t)
        - t
        + np.log(x)
        - corr
    )
    return out


def _gamma_ratio_at_zero(xm: float, xp_: float) -> complex:
    """2^q · Γ(xp)/Γ(xm) = 2^q · poch(xm, xp−xm) for the u_0 special case
    (either argument at a pole makes the direct exp(loggamma) form nan)."""
    q = xp_ - xm
    # poles of Γ: non-positive integers
    def is_pole(v):
        return v <= 0 and float(v) == int(v)

    if is_pole(xp_) and not is_pole(xm):
        return complex(np.inf)  # Γ(xp) pole in the numerator → singular
    if is_pole(xm) and not is_pole(xp_):
        return complex(0.0)  # 1/Γ(xm) = 0 at a pole → ratio is 0
    if is_pole(xm) and is_pole(xp_):
        # both poles: ratio of residues, Γ(xp)/Γ(xm) → limit along reals
        # Γ(-n+ε)/Γ(-m+ε) → (-1)^(n-m) m!/n! for integers n, m >= 0
        n, m_ = int(-xp_), int(-xm)
        return complex(
            2.0 ** q * (-1.0) ** (n - m_) * math.factorial(m_) / math.factorial(n)
        )
    return complex(
        2.0 ** q * np.exp(_loggamma(xp_)[0] - _loggamma(xm)[0])
    )


def fhtcoeff(
    n: int, dln: float, mu: float, offset: float = 0.0, bias: float = 0.0,
    inverse: bool = False,
) -> np.ndarray:
    """Host fp64 FFTLog coefficient array (scipy.fft semantics)."""
    lnkr, q = offset, bias
    xp_ = (mu + 1.0 + q) / 2.0
    xm = (mu + 1.0 - q) / 2.0
    y = np.linspace(0, np.pi * (n // 2) / (n * dln), n // 2 + 1)
    v = _loggamma(xm + 1j * y)
    u = _loggamma(xp_ + 1j * y)
    re = u.real - v.real + _LN2 * q
    im = u.imag + v.imag + y * 2.0 * (_LN2 - lnkr)
    u = np.exp(re + 1j * im)
    if n % 2 == 0:
        u[-1] = u[-1].real  # fix last coefficient to be real
    if not np.isfinite(u[0]):
        u[0] = _gamma_ratio_at_zero(xm, xp_)
    if np.isinf(u[0].real) and not inverse:
        import warnings

        warnings.warn("singular transform; consider changing the bias",
                      stacklevel=3)
        u = u.copy()
        u[0] = 0
    elif u[0] == 0 and inverse:
        import warnings

        warnings.warn("singular inverse transform; consider changing the bias",
                      stacklevel=3)
        u = u.copy()
        u[0] = np.inf
    return u


def fhtoffset(dln: float, mu: float, initial: float = 0.0, bias: float = 0.0) -> float:
    """Offset near ``initial`` satisfying Hamilton's low-ringing condition."""
    lnkr, q = initial, bias
    xp_ = (mu + 1.0 + q) / 2.0
    xm = (mu + 1.0 - q) / 2.0
    y = np.pi / (2.0 * dln)
    zp = _loggamma(xp_ + 1j * y)[0]
    zm = _loggamma(xm + 1j * y)[0]
    arg = (_LN2 - lnkr) / dln + (zp.imag + zm.imag) / np.pi
    return float(lnkr + (arg - np.round(arg)) * dln)


def _fht_tables(n: int, dln: float, mu: float, offset: float, bias: float,
                inverse: bool) -> np.ndarray:
    """The host float64 tables of one FFTLog call, stacked as rows: the
    coefficient's real and imaginary parts (u, or 1/conj(u) for the
    inverse; n//2 + 1 each, zero-padded to n), then, for a bias, the
    input's multiplier and the output's multiplier (its divisor for the
    inverse), n each."""
    u = fhtcoeff(n, dln, mu, offset=offset, bias=bias, inverse=inverse)
    if inverse:
        u = 1.0 / np.conj(u)
    rows = np.zeros((4 if bias != 0 else 2, n))
    rows[0, :u.size], rows[1, :u.size] = u.real, u.imag
    if bias != 0:
        j = np.arange(n, dtype=np.float64) - (n - 1) / 2.0
        if inverse:
            rows[2] = np.exp(bias * (j * dln + offset))
            rows[3] = np.exp(-bias * j * dln)  # a divisor
        else:
            rows[2] = np.exp(-bias * j * dln)
            rows[3] = np.exp(-bias * (j * dln + offset))
    return rows


def _fhtq(a: Tensor, inverse: bool, dln, mu, offset, bias, config: SpectralConfig) -> Tensor:
    """Biased FFTLog core: pre-multiply → rfft → coefficient multiply →
    irfft → flip → post-multiply, with the tables kept per (n, parameters)."""
    n = a.shape[-1]
    key = (float(dln), float(mu), float(offset), float(bias))

    def tables(like: Tensor, dtype) -> Tensor:
        return host_table("fht", _fht_tables, n, *key, inverse, like=like, dtype=dtype)

    if key[3] != 0:
        a = a * tables(a, a.dtype)[2]
    spec = rfft(a, config=config)
    rdtype = spec.real.dtype
    u = tables(spec, rdtype)[:2, :n // 2 + 1]
    out = torch.flip(irfft(spec * torch.complex(u[0], u[1]), n=n, config=config), (-1,))
    if key[3] != 0:
        post = tables(out, out.dtype)[3]
        out = out / post if inverse else out * post
    return out


def _as_real(a, what: str, dtype) -> Tensor:
    a = as_tensor(a)
    if a.is_complex():
        raise ValueError(f"{what} expects a real input array")
    return a.to(dtype)


def fht(
    a,
    dln: float,
    mu: float,
    offset: float = 0.0,
    bias: float = 0.0,
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """Fast Hankel transform of order ``mu`` on a log-spaced grid
    (scipy.fft.fht semantics), batched over leading axes.  Its coefficient
    and bias tables are built on the host and kept per length and
    parameters, also while ``torch.compile`` traces."""
    a = _as_real(a, "fht", config.dtype)
    return _fhtq(a, False, dln, mu, offset, bias, config)


def ifht(
    A,
    dln: float,
    mu: float,
    offset: float = 0.0,
    bias: float = 0.0,
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """Inverse fast Hankel transform (scipy.fft.ifht semantics)."""
    A = _as_real(A, "ifht", config.dtype)
    return _fhtq(A, True, dln, mu, offset, bias, config)


def _hadamard(n: int) -> np.ndarray:
    """The dense ±1 Hadamard matrix of order n (Sylvester construction)."""
    H = np.array([[1.0]])
    while H.shape[0] < n:
        H = np.block([[H, H], [H, -H]])
    return H


def fwht(x, axis: int = -1, *, config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    """Fast Walsh-Hadamard transform (natural/Hadamard ordering,
    unnormalized: H @ x with H the ±1 Hadamard matrix of size 2^k).

    log2(n) reshape/add passes of the 2×2 ±1 butterfly; for n <= 128 one
    dense ±1 matrix product instead, at the config's ``op_precision``.  Involution up to n:
    ``fwht(fwht(x)) == n·x`` (see :func:`ifwht`)."""
    x = as_tensor(x)
    if not (x.is_floating_point() or x.is_complex()):
        x = x.to(DTYPE)
    axis = axis % x.ndim
    n = x.shape[axis]
    if n < 1 or (n & (n - 1)) != 0:
        raise ValueError(f"fwht needs a power-of-two length, got {n}")
    xm = torch.movedim(x, axis, -1)
    if n <= 128:
        H = host_table("fwht.H", _hadamard, n, like=xm, dtype=xm.dtype)
        return torch.movedim(product(xm, H, config.op_precision), -1, axis)
    lead = xm.shape[:-1]
    y = xm
    h = 1
    while h < n:
        y = y.reshape(*lead, n // (2 * h), 2, h)
        a = y[..., 0, :]
        b = y[..., 1, :]
        y = torch.cat([a + b, a - b], dim=-1).reshape(*lead, n)
        h *= 2
    return torch.movedim(y, -1, axis)


def ifwht(x, axis: int = -1, *, config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    """Inverse WHT: H⁻¹ = H/n, so one :func:`fwht` divided by n."""
    x = as_tensor(x)
    n = x.shape[axis % x.ndim]
    return fwht(x, axis, config=config) / n
