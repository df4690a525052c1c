"""Narrowband array processing: steering vectors, Bartlett/MVDR spectra,
beamformer weights.

Counterpart of ``mixed_radix_fast_fourier_transform_tpu/ops/beamform.py``:
spatial covariance from snapshots (one batched fp32 complex product),
conventional (Bartlett) and Capon (MVDR) direction-of-arrival spectra as
dense steering-matrix products over the angle grid, MVDR weights by a
batched ``torch.linalg.solve`` on the card.  Element positions, angle grids
and steering matrices are host float64 constants.  :func:`music_doa` takes
its eigenbasis on the host in float64, as the JAX module does (design-time
numerics, like ``ops.subspace``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..utils.numerics import as_tensor, constant, content_key, matmul_precision, to_host

Tensor = torch.Tensor

__all__ = [
    "steering_vector", "spatial_covariance", "bartlett_spectrum",
    "mvdr_spectrum", "mvdr_weights", "music_doa",
]


def _positions(n_or_pos) -> np.ndarray:
    """Element positions in wavelengths, shape (n, d).  An int builds a
    standard half-wavelength ULA on the x-axis."""
    if np.isscalar(n_or_pos):
        n = int(n_or_pos)
        if n < 2:
            raise ValueError(f"need >= 2 elements, got {n}")
        return np.stack([0.5 * np.arange(n), np.zeros(n)], axis=1)
    pos = np.asarray(n_or_pos, np.float64)
    if pos.ndim == 1:
        pos = np.stack([pos, np.zeros_like(pos)], axis=1)
    if pos.ndim != 2 or pos.shape[0] < 2 or pos.shape[1] not in (1, 2, 3):
        raise ValueError(
            f"positions must be (n>=2, d<=3) in wavelengths, got {pos.shape}"
        )
    return pos


def steering_vector(array, angles_deg) -> np.ndarray:
    """Narrowband steering matrix A (n_elements × n_angles), unit-modulus
    phases exp(j·2π·pᵀu(θ)) for element positions p in WAVELENGTHS.

    ``array``: an element count (half-wavelength ULA) or an (n, d)
    position array, d ≤ 3.  ``angles_deg``: azimuth broadside angles θ
    (plane waves arriving from direction u = (sinθ, cosθ, 0)) — scalar or
    1-D.  Host float64 (a constant of the array and the grid).
    """
    pos = _positions(array)
    th = np.deg2rad(np.atleast_1d(np.asarray(angles_deg, np.float64)))
    u = np.stack([np.sin(th), np.cos(th), np.zeros_like(th)], axis=0)
    proj = pos @ u[: pos.shape[1]]  # (n, G) path lengths in wavelengths
    return np.exp(2j * np.pi * proj)


def _complex(x: Tensor) -> Tensor:
    return x if x.is_complex() else x.to(torch.complex64)


def spatial_covariance(x, forward_backward: bool = False) -> Tensor:
    """Sample spatial covariance R = (1/T)·Σ_t x_t x_tᴴ from snapshots
    x (…, n_elements, n_snapshots); one fp32 complex product.
    ``forward_backward=True`` averages with J·conj(R)·J (centro-Hermitian
    smoothing — doubles the effective snapshot count for ULAs)."""
    x = as_tensor(x)
    if x.ndim < 2:
        raise ValueError("snapshots must be (…, n_elements, n_snapshots)")
    x = _complex(x)
    with matmul_precision():
        R = torch.matmul(x, x.conj().transpose(-1, -2)) / x.shape[-1]
    if forward_backward:
        Rb = torch.flip(torch.conj(R), (-2, -1))
        R = 0.5 * (R + Rb)
    return R


def _grid(array, angles_deg):
    if angles_deg is None:
        angles_deg = np.linspace(-90.0, 90.0, 361)
    ang = np.atleast_1d(np.asarray(angles_deg, np.float64))
    return ang, steering_vector(array, ang)


def _steering_on(A: np.ndarray, like: Tensor, dtype) -> Tensor:
    return constant(A, like, dtype, key=content_key("beamform.A", A))


def _check_size(R: Tensor, n: int) -> None:
    if R.shape[-1] != n or R.shape[-2] != n:
        raise ValueError(
            f"R trailing dims {tuple(R.shape[-2:])} do not match array size {n}"
        )


def _loaded(R: Tensor, n: int, diagonal_loading: float) -> Tensor:
    if not diagonal_loading:
        return R
    tr = torch.diagonal(R, dim1=-2, dim2=-1).sum(-1).real[..., None, None]
    eye = torch.eye(n, dtype=R.dtype, device=R.device)
    return R + (diagonal_loading * tr / n) * eye


def bartlett_spectrum(R, array, angles_deg=None) -> Tuple[np.ndarray, Tensor]:
    """Conventional (delay-and-sum) spatial spectrum
    P(θ) = aᴴRa / n² over an angle grid (default −90°…90°, 0.5° steps).
    Returns ``(angles_deg, power)``; batched over leading R axes."""
    R = _complex(as_tensor(R))
    ang, A = _grid(array, angles_deg)
    n = A.shape[0]
    _check_size(R, n)
    Aj = _steering_on(A, R, R.dtype)
    with matmul_precision():
        RA = torch.matmul(R, Aj)  # (…, n, G)
    p = torch.sum(torch.conj(Aj) * RA, dim=-2)
    return ang, p.real / (n * n)


def mvdr_spectrum(R, array, angles_deg=None,
                  diagonal_loading: float = 0.0) -> Tuple[np.ndarray, Tensor]:
    """Capon/MVDR spatial spectrum P(θ) = 1 / (aᴴR⁻¹a) over an angle grid
    — sharper peaks than Bartlett at the cost of a covariance solve (a
    batched ``torch.linalg.solve`` on the card).  ``diagonal_loading`` adds
    δ·tr(R)/n·I before inversion (robustness with few snapshots).  Returns
    ``(angles_deg, power)``."""
    R = _complex(as_tensor(R))
    ang, A = _grid(array, angles_deg)
    n = A.shape[0]
    _check_size(R, n)
    R = _loaded(R, n, diagonal_loading)
    Aj = _steering_on(A, R, R.dtype)
    RiA = torch.linalg.solve(R, Aj.expand(R.shape[:-2] + Aj.shape))
    q = torch.sum(torch.conj(Aj) * RiA, dim=-2).real
    return ang, 1.0 / torch.clamp(q, min=torch.finfo(q.dtype).tiny)


def mvdr_weights(R, array, angle_deg: float, diagonal_loading: float = 0.0) -> Tensor:
    """MVDR (Capon) beamformer weights w = R⁻¹a / (aᴴR⁻¹a) steered to
    ``angle_deg``: unit gain toward the look direction, interference +
    noise power minimized.  Apply as ``wᴴ·x``:
    ``y = torch.einsum("i,...it->...t", w.conj(), snapshots)``."""
    R = _complex(as_tensor(R))
    a = steering_vector(array, float(angle_deg))[:, 0]
    n = a.shape[0]
    _check_size(R, n)
    R = _loaded(R, n, diagonal_loading)
    aj = _steering_on(a, R, R.dtype)
    Ria = torch.linalg.solve(R, aj.expand(R.shape[:-1])[..., None])[..., 0]
    denom = torch.sum(torch.conj(aj) * Ria, dim=-1)
    return Ria / denom[..., None]


def music_doa(R, array, n_sources: int, angles_deg=None) -> Tuple[np.ndarray, np.ndarray]:
    """MUSIC direction-of-arrival pseudospectrum
    P(θ) = 1 / ||E_nᴴ a(θ)||² from a covariance brought to the HOST: the
    m×m eigenbasis is design-time float64, as ``ops.subspace.music`` takes
    it.  Returns ``(angles_deg, pseudospectrum)`` as numpy."""
    Rh = to_host(R, np.complex128)
    if Rh.ndim != 2 or Rh.shape[0] != Rh.shape[1]:
        raise ValueError(f"R must be square, got {Rh.shape}")
    p = int(n_sources)
    if not 1 <= p < Rh.shape[0]:
        raise ValueError(
            f"n_sources must be in [1, {Rh.shape[0] - 1}], got {p}"
        )
    ang, A = _grid(array, angles_deg)
    if A.shape[0] != Rh.shape[0]:
        raise ValueError(
            f"R size {Rh.shape[0]} does not match array size {A.shape[0]}"
        )
    w, v = np.linalg.eigh(0.5 * (Rh + Rh.conj().T))
    En = v[:, : Rh.shape[0] - p]  # noise subspace (ascending eigenvalues)
    q = np.sum(np.abs(En.conj().T @ A) ** 2, axis=0)
    return ang, 1.0 / np.maximum(q, np.finfo(np.float64).tiny)
