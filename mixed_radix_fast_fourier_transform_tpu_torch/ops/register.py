"""Subpixel image registration by phase cross-correlation.

Counterpart of ``mixed_radix_fast_fourier_transform_tpu/ops/register.py``:
Guizar-Sicairos, Thurman & Fienup (2008) "Efficient subpixel image
registration algorithms".  The integer shift comes from the peak of the
inverse FFT of the cross-power spectrum (engine ``fft2``/``ifft2``); the
subpixel refinement evaluates an UPSAMPLED DFT of the cross-power spectrum
only in a small neighborhood of the coarse peak — two dense matrix-DFT
products at the config's ``op_precision``, with kernels whose phases depend on the
coarse peak.  No zero-padded giant FFT is ever built.

skimage.registration.phase_cross_correlation conventions: the returned
shift moves ``moving`` onto ``reference`` (apply with torch.roll or
:func:`fourier_shift`); ``error`` is the translation-invariant RMS metric
(eq. 10).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from ..utils.config import DEFAULT_CONFIG, SpectralConfig
from ..utils.numerics import as_tensor, as_tensors, constant, matmul_precision
from .fft import fft2, ifft2

Tensor = torch.Tensor


def _freqs(n: int, like: Tensor, dtype) -> Tensor:
    return constant(lambda: np.fft.fftfreq(n), like, dtype, key=("register.freqs", n))


def _upsampled_dft(R: Tensor, nr: int, nc: int, region: int, up: int,
                   row0: Tensor, col0: Tensor, precision: str = "highest") -> Tensor:
    """region x region samples of the inverse DFT of ``R`` on a grid of
    1/up pixel spacing starting at (row0, col0) — two matrix-DFT products
    with runtime-phase kernels."""
    rdt = R.real.dtype
    steps = torch.arange(region, dtype=rdt, device=R.device) / up
    rows = row0[..., None] + steps  # (…, region) pixel offsets
    cols = col0[..., None] + steps
    # kernel_r[…, p, u] = exp(+2πi·rows[p]·fr[u]) — inverse-transform sign
    ang_r = (2.0 * math.pi) * rows[..., :, None] * _freqs(nr, R, rdt)
    ang_c = (2.0 * math.pi) * cols[..., :, None] * _freqs(nc, R, rdt)
    ker_r = torch.complex(torch.cos(ang_r), torch.sin(ang_r))  # (…, p, nr)
    ker_c = torch.complex(torch.cos(ang_c), torch.sin(ang_c))  # (…, q, nc)
    with matmul_precision(precision):
        t = torch.matmul(ker_r, R)                        # (…, p, nc)
        return torch.matmul(t, ker_c.transpose(-1, -2))   # (…, p, q)


def phase_cross_correlation(
    reference,
    moving,
    upsample_factor: int = 1,
    normalization: str = "phase",
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tuple[Tensor, Tensor]:
    """Estimate the (row, col) translation registering ``moving`` onto
    ``reference`` to 1/upsample_factor pixel precision.

    Returns ``(shift, error)``: ``shift`` (…, 2) float is the translation
    to APPLY to ``moving`` (e.g. via :func:`fourier_shift`) to align it
    with ``reference`` (the negative of moving's displacement);
    ``error`` is the translation-invariant RMS of Guizar-Sicairos eq. 10,
    evaluated on the unnormalized cross-correlation at the estimated
    shift.  ``normalization='phase'`` whitens the cross-power spectrum
    (robust to illumination); ``None`` is plain cross-correlation.  Leading
    batch axes register image pairs independently."""
    a, b = as_tensors(reference, moving)
    if a.shape != b.shape or a.ndim < 2:
        raise ValueError(
            f"reference/moving must share a (…, H, W) shape, got "
            f"{tuple(a.shape)} vs {tuple(b.shape)}"
        )
    up = int(upsample_factor)
    if up < 1:
        raise ValueError(f"upsample_factor must be >= 1, got {up}")
    if normalization not in ("phase", None):
        raise ValueError(
            f"normalization must be 'phase' or None, got {normalization!r}"
        )
    nr, nc = a.shape[-2], a.shape[-1]
    if not (a.is_floating_point() or a.is_complex()):
        a = a.to(config.dtype)
    if not (b.is_floating_point() or b.is_complex()):
        b = b.to(config.dtype)
    Fa = fft2(a, config=config)
    Fb = fft2(b, config=config)
    R0 = Fa * torch.conj(Fb)  # unnormalized: the error metric's correlation
    if normalization == "phase":
        mag = torch.sqrt(R0.real ** 2 + R0.imag ** 2)
        R = R0 / torch.clamp(mag, min=1e-20)
    else:
        R = R0
    cc = ifft2(R, config=config)
    power = cc.real ** 2 + cc.imag ** 2
    amax = torch.argmax(power.reshape(*power.shape[:-2], -1), dim=-1)
    row = torch.div(amax, nc, rounding_mode="floor").to(torch.float32)
    col = (amax % nc).to(torch.float32)
    # wrap to signed shifts
    row = torch.where(row > nr / 2, row - nr, row)
    col = torch.where(col > nc / 2, col - nc, col)

    # error metric terms (eq. 10): |CC(shift)|² / (Σ|a|²·Σ|b|²), with the
    # UNNORMALIZED cross-correlation evaluated at the estimated peak
    ab2 = torch.sum(Fa.real ** 2 + Fa.imag ** 2, dim=(-2, -1)) * torch.sum(
        Fb.real ** 2 + Fb.imag ** 2, dim=(-2, -1)) / float(nr * nc) ** 2

    def _err_at(sr, sc):
        pt = _upsampled_dft(R0, nr, nc, 1, 1, sr.to(R0.real.dtype),
                            sc.to(R0.real.dtype), config.op_precision) / float(nr * nc)
        p2 = (pt.real ** 2 + pt.imag ** 2)[..., 0, 0]
        return torch.sqrt(torch.clamp(1.0 - p2 / torch.clamp(ab2, min=1e-30), min=0.0))

    if up == 1:
        return torch.stack([row, col], dim=-1), _err_at(row, col)

    # refine: upsampled DFT over a 1.5·up window centered on the coarse peak
    region = int(np.ceil(1.5 * up))
    row0 = row - (region // 2) / up
    col0 = col - (region // 2) / up
    local = _upsampled_dft(R, nr, nc, region, up, row0.to(R.real.dtype),
                           col0.to(R.real.dtype), config.op_precision) / float(nr * nc)
    lpow = local.real ** 2 + local.imag ** 2
    lmax = torch.argmax(lpow.reshape(*lpow.shape[:-2], -1), dim=-1)
    pr = torch.div(lmax, region, rounding_mode="floor").to(torch.float32) / up
    pc = (lmax % region).to(torch.float32) / up
    shift_r = row0.to(torch.float32) + pr
    shift_c = col0.to(torch.float32) + pc
    return torch.stack([shift_r, shift_c], dim=-1), _err_at(shift_r, shift_c)


def fourier_shift(x, shift, *, config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    """Shift an image by a (possibly subpixel) (row, col) translation via
    linear phase in the frequency domain (scipy.ndimage.fourier_shift
    composed with the transforms).  Real input -> real output."""
    x, shift = as_tensors(x, shift)
    if x.ndim < 2:
        raise ValueError("x must be (…, H, W)")
    if shift.shape[-1] != 2:
        raise ValueError("shift must end in a (row, col) pair")
    nr, nc = x.shape[-2], x.shape[-1]
    real_in = not x.is_complex()
    X = fft2(x, config=config)
    rdt = X.real.dtype
    shift = shift.to(rdt)
    ang = -2.0 * math.pi * (
        shift[..., 0:1, None] * _freqs(nr, X, rdt)[:, None]
        + shift[..., 1:2, None] * _freqs(nc, X, rdt)[None, :]
    )
    out = ifft2(X * torch.complex(torch.cos(ang), torch.sin(ang)), config=config)
    return out.real if real_in else out


def unwrap_phase_2d(psi, *, config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    """Weighted-least-squares 2-D phase unwrapping (Ghiglia-Romero DCT
    algorithm): solve ∇²φ = div(wrapped gradients) with Neumann boundaries
    via one DCT-II Poisson solve (``dctn``/``idctn``, on the stage pipeline
    as the JAX package routes them).

    Input wrapped phase (…, H, W) in radians; returns the least-squares
    unwrapped surface (defined up to an additive constant, anchored to
    mean zero).  Exact for phase fields whose true gradients never exceed
    π per pixel; residue-crossed fields get the least-squares smooth
    fit."""
    from .dct import dctn, idctn

    psi = as_tensor(psi)
    if psi.ndim < 2 or psi.shape[-1] < 2 or psi.shape[-2] < 2:
        raise ValueError("psi must be (…, H, W) with H, W >= 2")
    if psi.is_complex():
        raise ValueError("psi must be a real phase field (radians)")
    psi = psi.to(config.dtype)
    H, W = psi.shape[-2], psi.shape[-1]

    def wrap(v):
        return torch.remainder(v + math.pi, 2.0 * math.pi) - math.pi

    dx = wrap(psi[..., 1:, :] - psi[..., :-1, :])  # (…, H-1, W)
    dy = wrap(psi[..., :, 1:] - psi[..., :, :-1])  # (…, H, W-1)
    z = torch.zeros_like(psi[..., :1, :])
    rho_x = torch.cat([dx, z], dim=-2) - torch.cat([z, dx], dim=-2)
    zy = torch.zeros_like(psi[..., :, :1])
    rho_y = torch.cat([dy, zy], dim=-1) - torch.cat([zy, dy], dim=-1)
    rho = rho_x + rho_y
    # Neumann-BC Poisson solve: DCT-II eigenvalues 2cos(pi k/N) - 2

    def inv_denom():
        ei = 2.0 * np.cos(np.pi * np.arange(H) / H) - 2.0
        ej = 2.0 * np.cos(np.pi * np.arange(W) / W) - 2.0
        denom = ei[:, None] + ej[None, :]
        denom[0, 0] = 1.0  # DC: gauge freedom, zeroed below
        return denom

    R = dctn(rho, axes=(-2, -1), config=config)
    R = R / constant(inv_denom, R, R.dtype, key=("register.poisson", H, W))
    R[..., 0, 0].zero_()
    phi = idctn(R, axes=(-2, -1), config=config)
    return phi - torch.mean(phi, dim=(-2, -1), keepdim=True)
