"""Tomography: Radon transform and filtered backprojection.

Counterpart of ``mixed_radix_fast_fourier_transform_tpu/ops/tomo.py``.
Built on the projection-slice theorem instead of image rotation: the 1-D
Fourier transform of the projection at angle θ is the 2-D image spectrum
sampled along the line (ω·cosθ, ω·sinθ).  :func:`radon` is one 2-D type-2
NUFFT of the image's pixel "modes" at the polar spectral points, then one
batched centered inverse FFT of the slices; :func:`iradon` is the
ramp-filtered slices' centered FFT spread back onto the Cartesian grid by
one 2-D type-1 NUFFT.  Every angle is one more row of points in a single
NUFFT call.

Conventions: the image is (…, N, N) with pixel (row, col) = (y, x) and the
center at index N//2; ``theta`` are angles in RADIANS; the projection p_θ(s)
integrates the image along x·cosθ + y·sinθ = s, s on the integer offsets
−N//2 … N//2−1 (skimage.transform.radon's geometry at circle=True).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.config import DEFAULT_CONFIG, DTYPE, SpectralConfig
from ..utils.numerics import as_tensor, content_key, host_table, key_array, on_host
from .fft import fft, fftshift, ifft, ifftshift
from .nufft import nufft1_2d, nufft2_2d

Tensor = torch.Tensor


def _polar_points(n: int, theta: np.ndarray):
    """Host polar spectral grid: ω_m·(cosθ, sinθ), ω_m = 2π·m/n."""
    m = np.arange(n) - n // 2
    omega = 2.0 * np.pi * m / n  # (n,), in [-π, π)
    xs = omega[None, :] * np.cos(theta)[:, None]  # (T, n)
    ys = omega[None, :] * np.sin(theta)[:, None]
    return omega, xs.ravel(), ys.ravel()


def _polar_axis(n: int, tkey: tuple, axis: int) -> np.ndarray:
    """ys (``axis`` 0) or xs (1) of the polar points of the angles ``tkey``
    names."""
    return _polar_points(n, key_array(tkey))[2 - axis]


def _polar_on(like: Tensor, n: int, tkey: tuple):
    """The polar points (ys, xs) as fp32 tensors kept on ``like``'s device."""
    return tuple(host_table("tomo_polar", _polar_axis, n, tkey, axis, like=like)
                 for axis in (0, 1))


def _angles(theta, default: int) -> np.ndarray:
    if theta is None:
        theta = np.linspace(0.0, np.pi, default, endpoint=False)
    return np.atleast_1d(np.asarray(theta, np.float64))


def _angle_key(theta, default: int, count) -> tuple:
    """Host prologue (``utils.numerics.on_host``): the content key of the
    angles, ``default`` of them over [0, π) for None, checked to be 1-D,
    non-empty and ``count`` long where that is given."""
    theta = _angles(theta, default)
    if count is None:
        if theta.ndim != 1 or theta.size == 0:
            raise ValueError("theta must be a non-empty 1-D angle array")
    elif theta.ndim != 1 or theta.size != count:
        raise ValueError(f"theta must be 1-D with {count} angles, got shape {theta.shape}")
    return content_key("tomo.theta", theta)


def _projection_filter(n: int, filter_name: str) -> np.ndarray:
    """The ramp |ω| of the centered slice frequencies, apodized by
    ``filter_name``."""
    omega = _polar_points(n, np.zeros(1))[0]
    absw = np.abs(omega)
    if filter_name == "ramp":
        return absw
    if filter_name == "hann":
        return absw * (0.5 + 0.5 * np.cos(omega))
    wnz = np.where(omega == 0.0, 1.0, omega)       # "shepp-logan"
    return absw * np.where(omega == 0.0, 1.0, np.sin(wnz / 2) / (wnz / 2))


def radon(image, theta=None, *, config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    """Radon transform: (…, N, N) -> sinogram (…, n_theta, N).  One 2-D
    type-2 NUFFT evaluates the image spectrum on every polar slice at once;
    one batched centered ifft turns slices into projections.  ``theta``
    defaults to 180 angles over [0, π)."""
    image = as_tensor(image)
    if image.ndim < 2 or image.shape[-1] != image.shape[-2]:
        raise ValueError("image must be (…, N, N)")
    n = image.shape[-1]
    if n < 4:
        raise ValueError(f"image too small (N={n})")
    tkey = on_host(_angle_key, theta, 180, None)
    nt = tkey[2][0]
    ys, xs = _polar_on(image, n, tkey)
    # pixel (row=y, col=x) offsets are the "mode" indices: evaluate
    # G(ω) = Σ g[y, x] e^{-i(ω_x·x + ω_y·y)} at the polar points
    g = image.to(torch.complex64) if image.is_complex() else image.to(DTYPE)
    slices = nufft2_2d(ys, xs, g, isign=-1, config=config)
    slices = slices.reshape(slices.shape[:-1] + (nt, n))
    p = fftshift(ifft(ifftshift(slices, axes=-1), config=config), axes=-1)
    return p if image.is_complex() else p.real


def iradon(sinogram, theta=None, filter_name: str = "ramp", *,
           config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    """Filtered backprojection: sinogram (…, n_theta, N) -> (…, N, N).
    Each projection's centered fft is ramp-filtered (|ω|, optionally Hann-
    or Shepp-Logan-apodized) and spread back onto the Cartesian spectral
    grid with one 2-D type-1 NUFFT.  The polar-measure weights Δθ·Δω/(4π²)
    are applied, so a disk of value 1 reconstructs to ~1."""
    sino = as_tensor(sinogram)
    if sino.ndim < 2:
        raise ValueError("sinogram must be (…, n_theta, N)")
    nt, n = sino.shape[-2], sino.shape[-1]
    tkey = on_host(_angle_key, theta, nt, nt)
    if filter_name not in ("ramp", "hann", "shepp-logan"):
        raise ValueError(f"unknown filter {filter_name!r}")
    s = sino.to(torch.complex64)
    slices = fftshift(fft(ifftshift(s, axes=-1), config=config), axes=-1)
    slices = slices * host_table("tomo_filter", _projection_filter, n, filter_name, like=sino)
    # polar quadrature: Δθ = π/n_theta, Δω = 2π/N, measure 1/(4π²)
    scale = (np.pi / nt) * (2.0 * np.pi / n) / (4.0 * np.pi**2)
    strengths = (slices * scale).reshape(slices.shape[:-2] + (nt * n,))
    ys, xs = _polar_on(sino, n, tkey)
    # adjoint synthesis: the type-1 sum with isign=+1 gives the pixel values
    out = nufft1_2d(ys, xs, strengths, (n, n), isign=+1, config=config)
    return out if sino.is_complex() else out.real
