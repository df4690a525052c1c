"""Chebyshev spectral toolbox: non-periodic spectral methods through the DCT.

Counterpart of ``mixed_radix_fast_fourier_transform_tpu/ops/chebyshev.py``.
Values on the Chebyshev-Gauss-Lobatto grid x_j = cos(pi j/(N-1)) transform
to polynomial coefficients through a DCT-I (one length-2N-2 engine FFT),
differentiation is an exact coefficient recurrence, and evaluation anywhere
is Clenshaw's algorithm, a loop of N−1 elementwise steps.

Conventions match ``numpy.polynomial.chebyshev``: coefficients c with
f(x) = sum_k c[k] T_k(x).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.config import DEFAULT_CONFIG, DTYPE, SpectralConfig
from ..utils.numerics import as_tensor, as_tensors, constant as _const
from .dct import dct

Tensor = torch.Tensor


def _as_float(x) -> Tensor:
    return as_tensor(x).to(DTYPE)


def cheb_points(n: int, dtype=np.float32) -> np.ndarray:
    """Chebyshev-Gauss-Lobatto nodes cos(pi j/(n-1)), j = 0..n-1 (host array,
    descending from +1 to -1: the grid :func:`cheb_transform` expects)."""
    if n < 2:
        raise ValueError(f"need n >= 2 points, got {n}")
    return np.cos(np.pi * np.arange(n) / (n - 1)).astype(dtype)


def cheb_transform(v, *, config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    """Values on the n-point Gauss-Lobatto grid -> Chebyshev coefficients.

    c = DCT-I(v)/(n-1) with the first/last coefficients halved; one engine
    FFT of length 2n-2.  Exact (to fp32 round-off) for polynomials of degree
    < n; spectrally accurate for smooth f."""
    v = as_tensor(v)
    n = v.shape[-1]
    if n < 2:
        raise ValueError("cheb_transform needs >= 2 grid values")
    c = dct(v, type=1, config=config) / (n - 1)
    ends = np.ones(n)
    ends[0] = ends[-1] = 0.5
    return c * _const(ends, c, key=("cheb.ends", n))


def icheb_transform(c, *, config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    """Chebyshev coefficients -> values on the Gauss-Lobatto grid (inverse of
    :func:`cheb_transform`): v = DCT-I(c with interior halved)."""
    c = _as_float(c)
    n = c.shape[-1]
    if n < 2:
        raise ValueError("icheb_transform needs >= 2 coefficients")
    mid = np.full(n, 0.5)
    mid[0] = mid[-1] = 1.0
    return dct(c * _const(mid, c, key=("cheb.mid", n)), type=1, config=config)


def cheb_diff_coef(c) -> Tensor:
    """Differentiate in coefficient space: coefficients of f' given those of f.

    Closed form of the standard recurrence b_q = b_{q+2} + 2(q+1)·c_{q+1}:
    b_q = 2 · sum over p > q with p−q odd of p·c_p, b_0 halved, i.e. the
    opposite-parity tail sum of w_p = 2p·c_p.  Two flips and a cumsum per
    parity class instead of a sequential loop.  The q = n-1 entry is
    naturally zero (no opposite-parity p ≥ n-1)."""
    c = _as_float(c)
    n = c.shape[-1]
    if n < 1:
        raise ValueError("need at least one coefficient")
    if n == 1:
        return torch.zeros_like(c)
    w = c * _const(lambda: 2.0 * np.arange(n), c, key=("cheb.2p", n))

    def tail_sum(a):  # t_q = sum_{p >= q} a_p
        return torch.flip(torch.cumsum(torch.flip(a, (-1,)), dim=-1), (-1,))

    even = np.arange(n) % 2 == 0
    te = tail_sum(w * _const(even, c, key=("cheb.even", n)))   # even-p tails
    to = tail_sum(w * _const(~even, c, key=("cheb.odd", n)))  # odd-p tails
    # opposite parity means the p = q term is masked out of its own tail,
    # so "p >= q" tails already implement "p > q"
    b = torch.where(_const(even, c, torch.bool, key=("cheb.even", n)), to, te)
    half = np.ones(n)
    half[0] = 0.5
    return b * _const(half, c, key=("cheb.half", n))


def cheb_diff(v, m: int = 1, *, config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    """m-th spectral derivative of grid values on [-1, 1]: transform,
    differentiate m times in coefficient space, transform back."""
    if m < 0:
        raise ValueError(f"derivative order must be >= 0, got {m}")
    c = cheb_transform(v, config=config)
    for _ in range(m):
        c = cheb_diff_coef(c)
    return icheb_transform(c, config=config)


def cheb_eval(c, x) -> Tensor:
    """Evaluate sum_k c[k] T_k(x) at arbitrary ``x`` by Clenshaw's recurrence
    (numerically stable; batched over leading axes of ``c`` and any shape of
    ``x``): (*c.shape[:-1], *x.shape)."""
    c, x = as_tensors(c, x)
    c, x = _as_float(c), _as_float(x)
    n = c.shape[-1]
    if n < 1:
        raise ValueError("need at least one coefficient")

    def over_x(ck: Tensor) -> Tensor:  # a coefficient broadcast over x's axes
        return ck.reshape(*ck.shape, *(1,) * x.ndim)

    out_shape = c.shape[:-1] + x.shape
    if n == 1:
        return over_x(c[..., 0]).expand(out_shape)
    xb = x.reshape((1,) * (c.ndim - 1) + x.shape)
    two_x = 2.0 * xb
    b1 = b2 = torch.zeros(out_shape, dtype=c.dtype, device=c.device)
    for k in range(n - 1, 0, -1):  # highest -> lowest
        b1, b2 = over_x(c[..., k]) + two_x * b1 - b2, b1
    return over_x(c[..., 0]) + xb * b1 - b2
