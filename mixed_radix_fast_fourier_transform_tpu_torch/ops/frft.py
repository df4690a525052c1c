"""Fractional Fourier transform (order-a rotation of the time-frequency
plane; a = 1 is the ordinary FFT).

Counterpart of ``mixed_radix_fast_fourier_transform_tpu/ops/frft.py``: the
chirp-based sampled-kernel FrFT of Ozaktas/Kutay, computed exactly (to
arithmetic) through the library's own chirp-z transform rather than by sinc
interpolation.

Discretization: samples live on the centered dimensionless grid
u_n = (n - c)/sqrt(N), c = N//2 — the unique spacing for which the
continuous kernel

    K_alpha(u, u') = sqrt(1 - i cot(alpha)) ·
                     exp(i·pi·(cot(alpha)(u² + u'²) - 2 csc(alpha) u u'))

(alpha = a·pi/2).  The quadrature runs on the 2x-oversampled grid
(spacing 1/(2·sqrt(N)), the Ozaktas refinement): the signal is first
band-limited-interpolated by a centered spectral zero-pad (exact for the
periodic grid), the kernel cross term on that grid,
exp(-2·pi·i·csc(alpha)(m-N)(k-N)/(4N)), is a chirp-z transform with ratio
w = exp(-2·pi·i·csc(alpha)/(4N)) — evaluated EXACTLY (to arithmetic) by
ops/czt.py's Bluestein machinery, with no sampling error of its own — and
the result is decimated back to the original grid.  The pipeline is

    spectral upsample -> chirp multiply -> czt -> chirp multiply -> slice,

with all chirp/ratio constants generated host-side in fp64 (plan-constant
convention).  At a = 1 the kernel degenerates to the centered unitary DFT
and the identity F_1 = shift·FFT·shift/sqrt(N) is used instead (exact).

Order handling: a is taken mod 4.  Integer orders are exact by
construction — F_0 = identity, F_1 = centered DFT, F_2 = F_1² (the
centered wrap-reversal), F_3 = F_1^{-1}.  Non-integer orders outside the
well-conditioned bands [0.5, 1.5] ∪ [2.5, 3.5] (where |csc|, |cot| <= 1.42)
are reduced by one exact DFT: F_a = F_{a-1} ∘ F_1 — the standard Ozaktas
range reduction that keeps the chirps slowly varying.

Accuracy domain: the FrFT rotates the time-frequency plane, so the
transform of a signal is representable on the same grid only if the
signal's phase-space support stays inside the ±sqrt(N)/2 square under
rotation — i.e. energy concentrated in the inscribed circle.  For such
signals the oversampled quadrature is machine-accurate (measured fp64:
Gaussian·cos roundtrip 2.5e-9 at a=1.4 where the critically-sampled form
errs 1.9e-2; order-16 Hermite-Gaussian roundtrips at 1e-15), F_{-a}
inverts F_a, and orders compose additively.  Signals occupying the full
square (e.g. white noise) have corner content that genuinely rotates off
the grid at fractional orders — irreducible at fixed N by ANY algorithm —
and only integer orders (exact DFT identities) are loss-free for them.
The exactly-unitary alternative (Hermite-eigenvector DFrFT) is a dense
O(N²) construction with its own eigenvector ambiguities and is
deliberately not the default here.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.config import DEFAULT_CONFIG, SpectralConfig
from ..utils.numerics import as_tensor, constant
from .czt import czt
from .fft import fft

Tensor = torch.Tensor


def _frft_constants(n: int, a: float) -> Tuple[np.ndarray, np.ndarray, complex, complex]:
    """Host fp64 chirp constants for the direct-regime kernel at order
    ``a`` (alpha = a·pi/2 with sin(alpha) bounded away from 0) on the
    2x-oversampled grid u_k = (k - N)/(2·sqrt(N)), k = 0..2N-1: the
    pre/post chirp vectors (2n,) and the czt (w, a) pair."""
    alpha = a * math.pi / 2.0
    s, cth = math.sin(alpha), math.cos(alpha)
    cot, csc = cth / s, 1.0 / s
    idx = np.arange(2 * n, dtype=np.float64)
    u2 = (idx - n) ** 2 / (4.0 * n)
    chirp = np.exp(1j * math.pi * cot * u2)
    # cross-term expansion (m-N)(k-N) = mk - N(m+k) + N²: the N·k part
    # rides the czt's a^{-k}, the N·m and N² parts fold into the post chirp
    pre = chirp
    amp = np.sqrt(1.0 - 1j * cot) / (2.0 * math.sqrt(n))  # A_alpha · Δu
    post = amp * chirp * np.exp(2j * math.pi * csc * (n * idx - n * n) / (4.0 * n))
    w = np.exp(-2j * math.pi * csc / (4.0 * n))
    a_czt = np.exp(-2j * math.pi * csc * n / (4.0 * n))
    return pre, post, w, a_czt



def _as_complex(x) -> Tensor:
    return as_tensor(x).to(torch.complex64)


def _cdft(x: Tensor, inverse: bool, config: SpectralConfig) -> Tensor:
    """Exact centered unitary DFT F_1 (or its inverse F_3): shift, FFT,
    shift, 1/sqrt(N)."""
    n = x.shape[-1]
    c = n // 2
    y = torch.roll(x, -c, dims=-1)
    if inverse:
        y = torch.conj(fft(torch.conj(y), config=config))
    else:
        y = fft(y, config=config)
    return torch.roll(y, c, dims=-1) * (1.0 / math.sqrt(n))


def _flip_centered(x: Tensor) -> Tensor:
    """F_2 = F_1²: x[n] -> x[(2c - n) mod N] (centered wrap-reversal)."""
    n = x.shape[-1]
    idx = (2 * (n // 2) - np.arange(n)) % n
    return x[..., constant(idx, x, torch.long, key=("frft.flip", n))]


def _upsample2(x: Tensor, config: SpectralConfig) -> Tensor:
    """Exact band-limited 2x interpolation of the centered periodic grid:
    centered spectrum, zero-pad to 2N, inverse; even samples are preserved
    up to the two unitary DFTs."""
    n = x.shape[-1]
    spec = F.pad(_cdft(x, False, config), (n - n // 2, n // 2))
    return _cdft(spec, True, config) * math.sqrt(2.0)


def _frft_direct(x: Tensor, a: float, config: SpectralConfig) -> Tensor:
    n = x.shape[-1]
    pre, post, w, a_czt = _frft_constants(n, a)
    y = _upsample2(_as_complex(x), config) * constant(pre, x, torch.complex64, key=("frft.pre", n, a))
    y = czt(y, w=w, a=a_czt, config=config)
    y = y * constant(post, x, torch.complex64, key=("frft.post", n, a))
    off = n - 2 * (n // 2)  # 0 for even N, 1 for odd: (m-N) = 2(t-c)
    return y[..., off::2]


def frft(
    x,
    a: float,
    *,
    axis: int = -1,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """Fractional Fourier transform of order ``a`` along ``axis``.

    ``a`` is in right-angle units: a = 1 is the centered unitary DFT,
    a = 2 the centered reversal, a = 4 ≡ 0 the identity; non-integer
    orders interpolate continuously (rotation of the time-frequency
    plane by a·90°).  The inverse is ``frft(y, -a)`` (see
    :func:`ifrft`).  Orders are taken mod 4."""
    x = as_tensor(x)
    if x.ndim < 1 or x.shape[axis % x.ndim] < 2:
        raise ValueError("frft needs a signal of length >= 2")
    a = float(a) % 4.0
    if axis % x.ndim != x.ndim - 1:
        return torch.movedim(
            frft(torch.movedim(x, axis, -1), a, config=config), -1, axis)
    # exact integer orders
    if a == 0.0:
        return _as_complex(x)
    if a == 1.0:
        return _cdft(x, False, config)
    if a == 2.0:
        return _as_complex(_flip_centered(x))
    if a == 3.0:
        return _cdft(x, True, config)
    if 0.5 <= a <= 1.5 or 2.5 <= a <= 3.5:
        return _frft_direct(x, a, config)
    # range reduction by one exact DFT: F_a = F_{a-1} ∘ F_1
    return _frft_direct(_cdft(x, False, config), (a - 1.0) % 4.0, config)


def ifrft(
    x,
    a: float,
    *,
    axis: int = -1,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """Inverse fractional Fourier transform: ``frft(x, -a)``."""
    return frft(x, -float(a), axis=axis, config=config)


def frft2(
    x,
    a,
    *,
    axes: Tuple[int, int] = (-2, -1),
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """Separable 2-D FrFT: order ``a`` may be a scalar or a pair
    (a_row, a_col) applied along ``axes``."""
    ar, ac = (float(a), float(a)) if np.ndim(a) == 0 else (
        float(a[0]), float(a[1])
    )
    y = frft(x, ar, axis=axes[0], config=config)
    return frft(y, ac, axis=axes[1], config=config)
