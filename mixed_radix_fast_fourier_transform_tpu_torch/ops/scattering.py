"""1-D and 2-D wavelet scattering transforms (Mallat 2012; Kymatio
conventions).

Counterpart of ``mixed_radix_fast_fourier_transform_tpu/ops/scattering.py``.
The translation-invariant, deformation-stable feature cascade:

    S0 = x ⋆ φ,   S1[λ1] = |x ⋆ ψ_{λ1}| ⋆ φ,
    S2[λ1, λ2] = ||x ⋆ ψ_{λ1}| ⋆ ψ_{λ2}| ⋆ φ   (ξ2 < ξ1 only),

with ψ an analytic Morlet bank (Q wavelets per octave over J octaves for
the first order, 1 per octave for the second) and φ a Gaussian lowpass at
scale 2^J.

Device shape: ONE signal FFT; every filter is a host fp64 spectral window
applied as a broadcast multiply; each order is a batched engine ifft; the
invariant averaging is one more spectral multiply and a stride.  The banks
are host tables built once per (length, J, Q, w) and kept on the device
(``utils.numerics.constant``), so a call can be captured in a CUDA graph.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utils.config import DEFAULT_CONFIG, DTYPE, SpectralConfig
from ..utils.numerics import as_tensor, constant
from .fft import fft, ifft
from .tfr import _morlet_hat

Tensor = torch.Tensor
_CDTYPE = torch.complex64


def _morlet_w_for_spacing(r: float) -> float:
    """Morlet center parameter whose bandwidth matches a geometric filter
    spacing r: adjacent filters cross near half power at the midpoint
    (w·(√r − 1) ≈ 1.18 ⇒ ~-3 dB at √r·ξc).  Without this, octave-spaced
    banks at w=6 leave ~-27 dB gaps between centers."""
    return max(1.18 / (np.sqrt(r) - 1.0), 2.5)


def _centers(J: int, Q: int):
    """Center frequencies (cycles/sample) of the first-order bank (Q per
    octave) and the second-order bank (one per octave), and the lowest."""
    fmax = 0.35  # below Nyquist; Morlet bandwidth needs headroom
    fmin = fmax * 2.0 ** (-float(J))
    xi1 = fmax * 2.0 ** (-np.arange(J * Q + 1) / Q)
    xi2 = fmax * 2.0 ** (-np.arange(J + 1, dtype=np.float64))
    return xi1[xi1 >= fmin * 0.999], xi2[xi2 >= fmin * 0.999], fmin


def _scattering_bank(T: int, J: int, Q: int, w):
    """Host filters: (first-order (n1, T), second-order (n2, T), φ (T,),
    center frequencies xi1 (n1,), xi2 (n2,)) — all real spectral windows."""
    xi_grid = 2.0 * np.pi * np.fft.fftfreq(T)  # rad/sample
    xi1, xi2, fmin = _centers(J, Q)
    w1 = float(w) if w is not None else _morlet_w_for_spacing(2.0 ** (1.0 / Q))
    w2 = _morlet_w_for_spacing(2.0)  # second order is octave-spaced
    psi1 = np.stack([
        _morlet_hat(w1 / (2.0 * np.pi * f) * xi_grid, w1) for f in xi1
    ])
    psi2 = np.stack([
        _morlet_hat(w2 / (2.0 * np.pi * f) * xi_grid, w2) for f in xi2
    ])
    # Gaussian lowpass at scale 2^J: cutoff ~ fmin
    sigma_f = fmin / 2.0  # std in cycles/sample
    phi = np.exp(-0.5 * (xi_grid / (2.0 * np.pi * sigma_f)) ** 2)
    return psi1, psi2, phi, xi1, xi2


def _bank_tables(bank, key: tuple, like: Tensor, n: int):
    """The first ``n`` arrays of ``bank()`` as device tables under ``key``;
    the host bank is built once, and only when a table is missing."""
    built = []

    def part(i):
        if not built:
            built.append(bank())
        return built[0][i]

    return tuple(constant(lambda i=i: part(i), like, DTYPE, key=key + (i,)) for i in range(n))


def scattering1d(
    x,
    J: int = 6,
    Q: int = 8,
    w: Optional[float] = None,
    stride: Optional[int] = None,
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
):
    """Wavelet scattering of a real signal: (…, T) ->
    ``(S0, S1, S2, meta)`` with S0 (…, T'), S1 (…, n1, T'),
    S2 (…, n_pairs, T'), T' = T/stride (stride defaults to 2^(J-1) —
    half the invariance scale, the standard anti-aliased rate) and
    ``meta = (xi1, xi2, pairs)`` the center frequencies (cycles/sample)
    and the (j1, j2) index pairs of the second order.  ``w`` (the Morlet
    center parameter) defaults to a bandwidth MATCHED to the 2^{1/Q}
    filter spacing so the bank tiles the axis without inter-filter gaps
    (the second-order octave bank always uses its own matched width)."""
    x = as_tensor(x)
    if x.is_complex():
        raise ValueError("scattering1d takes real signals")
    if x.ndim < 1:
        raise ValueError("x must be (…, T)")
    T = x.shape[-1]
    if J < 1 or Q < 1:
        raise ValueError(f"need J >= 1 and Q >= 1, got J={J}, Q={Q}")
    if T < 2 ** (J + 1):
        raise ValueError(f"signal length {T} < 2^(J+1) = {2 ** (J + 1)}")
    stride = 1 << (J - 1) if stride is None else int(stride)
    if stride < 1 or T % stride:
        raise ValueError(f"stride {stride} must divide T={T}")
    wkey = None if w is None else float(w)
    bank = lambda: _scattering_bank(T, J, Q, wkey)
    xi1, xi2, _ = _centers(J, Q)
    psi1d, psi2d, phid = _bank_tables(bank, ("scattering1d", T, J, Q, wkey), x, 3)

    X = fft(x.to(_CDTYPE), config=config)  # (…, T)
    # zeroth order: invariant average of the signal itself
    s0 = torch.real(ifft(X * phid, config=config))[..., ::stride]
    # first order: modulus envelopes of the analytic band passes
    U1 = torch.abs(ifft(X[..., None, :] * psi1d, config=config))  # (…, n1, T)
    U1f = fft(U1.to(_CDTYPE), config=config)
    s1 = torch.real(ifft(U1f * phid, config=config))[..., ::stride]
    # second order: only pairs with xi2 < xi1 (decreasing frequency path)
    pairs = [(j1, j2) for j1 in range(len(xi1)) for j2 in range(len(xi2))
             if xi2[j2] < 0.5 * xi1[j1]]
    if pairs:
        p1 = [p[0] for p in pairs]
        p2 = [p[1] for p in pairs]
        U2 = torch.abs(ifft(U1f[..., p1, :] * psi2d[p2], config=config))
        U2f = fft(U2.to(_CDTYPE), config=config)
        s2 = torch.real(ifft(U2f * phid, config=config))[..., ::stride]
    else:
        s2 = s1.new_zeros(s1.shape[:-2] + (0, s1.shape[-1]))
    return s0, s1, s2, (xi1, xi2, pairs)


def _scattering_bank_2d(H: int, W: int, J: int, L: int):
    """Host 2-D filters: oriented Gabor-Morlet bank (J·L, H, W) real
    spectral windows with zero DC, the per-scale index grids, and the
    Gaussian lowpass at scale 2^J."""
    wy = 2.0 * np.pi * np.fft.fftfreq(H)[:, None]
    wx = 2.0 * np.pi * np.fft.fftfreq(W)[None, :]
    xi0 = 3.0 * np.pi / 4.0  # standard Kymatio center frequency

    def pgauss(w, c, s_inv):
        # periodized 1-D Gaussian factor: sum over ±2π aliases so the j=0
        # tail (spectral std 1.25 rad at 3π/4) wraps instead of truncating
        # (Kymatio/Morlet construction); the 2-D window is separable, so
        # periodizing each factor periodizes the product
        return sum(
            np.exp(-0.5 * s_inv**2 * (w - c + 2.0 * np.pi * m) ** 2)
            for m in range(-2, 3)
        )

    psis = []
    meta = []
    for j in range(J):
        xi = xi0 * 2.0 ** (-j)
        sigma = 0.8 * 2.0 ** j  # spatial std; spectral std = 1/sigma
        s_inv = sigma
        for l in range(L):
            th = np.pi * l / L
            cy, cx = xi * np.sin(th), xi * np.cos(th)
            g = pgauss(wy, cy, s_inv) * pgauss(wx, cx, s_inv)
            g0 = pgauss(wy, 0.0, s_inv) * pgauss(wx, 0.0, s_inv)
            # Morlet DC correction: subtract K·gaussian so psi_hat(0) = 0
            k = g[0, 0] / g0[0, 0]
            psis.append(g - k * g0)
            meta.append((j, l))
    # lowpass at the full invariance scale: spatial std = 2^J pixels
    phi = pgauss(wy, 0.0, 2.0 ** J) * pgauss(wx, 0.0, 2.0 ** J)
    return np.stack(psis), phi, tuple(meta)


def scattering2d(
    x,
    J: int = 3,
    L: int = 6,
    stride: Optional[int] = None,
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
):
    """2-D wavelet scattering (Bruna & Mallat 2013; Kymatio layout):
    (…, H, W) -> ``(S0, S1, S2, meta)`` with S0 (…, H', W'),
    S1 (…, J·L, H', W'), S2 (…, n_pairs, H', W'),
    H' = H/stride (stride defaults to 2^(J-1)); ``meta = (meta1, pairs)``
    carries each channel's (scale j, orientation l) and the second-order
    (idx1, idx2) pairs (j2 > j1, all orientation combinations).

    The rotation-covariant, translation-invariant texture descriptor:
    oriented Gabor-Morlet bank applied as ONE broadcast spectral multiply
    per order (three fft2 rounds total), modulus between orders, Gaussian
    averaging at scale 2^J."""
    from .fft import fft2, ifft2

    x = as_tensor(x)
    if x.is_complex():
        raise ValueError("scattering2d takes real images")
    if x.ndim < 2:
        raise ValueError("x must be (…, H, W)")
    H, W = x.shape[-2], x.shape[-1]
    if J < 1 or L < 1:
        raise ValueError(f"need J >= 1 and L >= 1, got J={J}, L={L}")
    if min(H, W) < 2 ** (J + 1):
        raise ValueError(f"image {H}x{W} too small for J={J}")
    stride = 1 << (J - 1) if stride is None else int(stride)
    if stride < 1 or H % stride or W % stride:
        raise ValueError(f"stride {stride} must divide both {H} and {W}")
    bank = lambda: _scattering_bank_2d(H, W, J, L)
    meta1 = tuple((j, l) for j in range(J) for l in range(L))
    psid, phid = _bank_tables(bank, ("scattering2d", H, W, J, L), x, 2)

    X = fft2(x.to(_CDTYPE), config=config)
    s0 = torch.real(ifft2(X * phid, config=config))[..., ::stride, ::stride]
    U1 = torch.abs(ifft2(X[..., None, :, :] * psid, config=config))
    U1f = fft2(U1.to(_CDTYPE), config=config)
    s1 = torch.real(ifft2(U1f * phid, config=config))[..., ::stride, ::stride]
    pairs = [(i1, i2) for i1, (j1, _) in enumerate(meta1)
             for i2, (j2, _) in enumerate(meta1) if j2 > j1]
    if pairs:
        p1 = [p[0] for p in pairs]
        p2 = [p[1] for p in pairs]
        U2 = torch.abs(ifft2(U1f[..., p1, :, :] * psid[p2], config=config))
        U2f = fft2(U2.to(_CDTYPE), config=config)
        s2 = torch.real(ifft2(U2f * phid, config=config))[..., ::stride, ::stride]
    else:
        s2 = s1.new_zeros(s1.shape[:-3] + (0,) + s1.shape[-2:])
    return s0, s1, s2, (meta1, pairs)
