"""Packed real FFT: rfft / irfft / rfftn / irfftn / rfft2 / irfft2 and the
Hermitian family hfft / ihfft / hfftn / ihfftn / hfft2 / ihfft2.

Counterpart of ``mixed_radix_fast_fourier_transform_tpu/ops/rfft.py``.  An
even length-n real transform is one length-n/2 complex transform plus a
fused split/merge pass and returns the n//2+1 half spectrum; odd lengths
pack pairs of batch rows into one complex transform.  Nothing here writes
into a caller's tensor.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..plan import device_constants, get_plan
from ..utils.config import DEFAULT_CONFIG, SpectralConfig
from ..utils.numerics import as_tensor, from_planes, to_planes
from ..utils.sharding import batch_sharded
from .fft import _axes_of, _axes_shape, _norm_scale, _resize_last, fft, ifft
from .stockham import exec_complex, exec_len

Tensor = torch.Tensor


def _extend_half(z: Tensor) -> Tensor:
    """k=0..h from a length-h array: z[k mod h] = concat([z, z[:1]])."""
    return torch.cat([z, z[..., :1]], dim=-1)


def _reflect_half(z: Tensor) -> Tensor:
    """k=0..h from a length-h array: z[(h-k) mod h] = [z0, z_{h-1}, …, z1, z0]."""
    return torch.cat([z[..., :1], torch.flip(z[..., 1:], (-1,)), z[..., :1]], -1)


def _rfft_packed(x: Tensor, n: int, config: SpectralConfig):
    """Even-n packed forward path → (re, im) planes of length n//2 + 1.

    Pack z[m] = x[2m] + i·x[2m+1]; Z = FFT_h(z); for k = 0..h with h = n/2,
    X[k] = P[k]·Z[k mod h] + Q[k]·conj(Z[(h-k) mod h]).
    """
    h = n // 2
    # the strided even/odd slices are made contiguous for the kernel
    zr = x[..., 0::2].contiguous()
    zi = x[..., 1::2].contiguous()
    fr, fi = exec_len(config, h, -1, zr, zi)
    ar, ai = _extend_half(fr), _extend_half(fi)          # A = Z[k mod h]
    br, bi = _reflect_half(fr), -_reflect_half(fi)       # B = conj(Z[(h-k) mod h])
    rp = device_constants(get_plan(n, -1, "real", config), x.device)
    xr = (ar * rp["p_re"] - ai * rp["p_im"]) + (br * rp["q_re"] - bi * rp["q_im"])
    xi = (ar * rp["p_im"] + ai * rp["p_re"]) + (br * rp["q_im"] + bi * rp["q_re"])
    return xr, xi


def _rfft_odd_two_for_one(x: Tensor, n: int, config: SpectralConfig):
    """Odd-n real forward path, batch >= 2: pack pairs of rows as
    z = x1 + i·x2, one complex FFT, then separate by Hermitian symmetry:
    X1 = (Z + conj(Z-))/2, X2 = -i·(Z - conj(Z-))/2, Z-[k] = Z[(n-k) mod n]."""
    h1 = n // 2 + 1
    batch = x.shape[:-1]
    b = math.prod(batch)
    x2 = x.reshape(b, n)
    bp = b + (b % 2)
    if bp != b:
        x2 = F.pad(x2, (0, 0, 0, 1))
    zr, zi = x2[0::2], x2[1::2]
    plan = get_plan(n, -1, "complex", config)
    fr, fi = exec_complex(plan, zr, zi)
    rr = torch.cat([fr[..., :1], torch.flip(fr[..., 1:], (-1,))], -1)[..., :h1]
    ri = torch.cat([fi[..., :1], torch.flip(fi[..., 1:], (-1,))], -1)[..., :h1]
    fr, fi = fr[..., :h1], fi[..., :h1]
    x1r, x1i = (fr + rr) * 0.5, (fi - ri) * 0.5
    x2r, x2i = (fi + ri) * 0.5, (rr - fr) * 0.5
    xr = torch.stack([x1r, x2r], dim=1).reshape(bp, h1)[:b]
    xi = torch.stack([x1i, x2i], dim=1).reshape(bp, h1)[:b]
    return xr.reshape(*batch, h1), xi.reshape(*batch, h1)


@batch_sharded("axis")
def rfft(
    x,
    n: Optional[int] = None,
    axis: int = -1,
    norm: Optional[str] = "backward",
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """Real-input FFT along ``axis`` → n//2 + 1 complex bins."""
    x = as_tensor(x)
    if x.is_complex():
        raise ValueError("rfft requires real input; use fft for complex data")
    axis = axis % x.ndim
    x = torch.movedim(x, axis, -1).to(config.dtype)
    n = int(n) if n is not None else x.shape[-1]
    x = _resize_last(x, n)
    if n % 2 == 0 and n >= 2:
        xr, xi = _rfft_packed(x, n, config)
    elif n > 1 and math.prod(x.shape[:-1]) >= 2:
        xr, xi = _rfft_odd_two_for_one(x, n, config)
    else:
        # single odd transform / one point: full complex, keep the lower half
        plan = get_plan(n, -1, "complex", config)
        fr, fi = exec_complex(plan, x, torch.zeros_like(x))
        xr, xi = fr[..., : n // 2 + 1], fi[..., : n // 2 + 1]
    scale = _norm_scale(n, -1, norm)
    if scale != 1.0:
        xr, xi = xr * scale, xi * scale
    return torch.movedim(from_planes(xr, xi), -1, axis)


def _irfft_packed(xr: Tensor, xi: Tensor, n: int, config: SpectralConfig) -> Tensor:
    """Even-n packed inverse path: Z = P⊙X[k] + Q⊙conj(X[h-k]) for
    k = 0..h-1, z = IFFT_h(Z)/h, x[2m] = Re z[m], x[2m+1] = Im z[m]."""
    h = n // 2
    br = torch.flip(xr[..., 1:], (-1,))
    bi = -torch.flip(xi[..., 1:], (-1,))
    ar, ai = xr[..., :h], xi[..., :h]
    rp = device_constants(get_plan(n, 1, "real", config), xr.device)
    pr, pi_ = rp["p_re"][:h], rp["p_im"][:h]
    qr, qi_ = rp["q_re"][:h], rp["q_im"][:h]
    zr = (ar * pr - ai * pi_) + (br * qr - bi * qi_)
    zi = (ar * pi_ + ai * pr) + (br * qi_ + bi * qr)
    gr, gi = exec_len(config, h, 1, zr, zi)
    inv_h = 1.0 / h
    gr, gi = gr * inv_h, gi * inv_h
    return torch.stack([gr, gi], dim=-1).reshape(*gr.shape[:-1], n)


@batch_sharded("axis")
def irfft(
    x,
    n: Optional[int] = None,
    axis: int = -1,
    norm: Optional[str] = "backward",
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """Inverse of :func:`rfft`: half spectrum (length n//2+1) → real length n."""
    x = as_tensor(x)
    axis = axis % x.ndim
    x = torch.movedim(x, axis, -1)
    n = int(n) if n is not None else 2 * (x.shape[-1] - 1)
    if n < 1:
        raise ValueError(f"irfft output length must be >= 1, got {n}")
    x = _resize_last(x, n // 2 + 1)
    xr, xi = to_planes(x, config.dtype)
    # numpy.fft.irfft semantics: the imaginary parts of the DC (and, for
    # even n, Nyquist) bins never enter; zero them on a copy, never on the
    # caller's tensor (to_planes may return it as is)
    # (zero_, not a Python scalar's assignment, whose host copy a CUDA graph
    # cannot capture)
    xi = xi.clone()
    xi[..., 0].zero_()
    if n % 2 == 0 and n >= 2:
        xi[..., n // 2].zero_()
        out = _irfft_packed(xr, xi, n, config)
    else:
        # odd length: rebuild the full Hermitian spectrum, then invert pairs
        # of spectra through one complex ifft (Z = F1 + i·F2 ⇒ ifft(Z) =
        # x1 + i·x2 since both inverses are real); batch 1 takes one transform
        fr = torch.cat([xr, torch.flip(xr[..., 1:], (-1,))], dim=-1)
        fi = torch.cat([xi, -torch.flip(xi[..., 1:], (-1,))], dim=-1)
        plan = get_plan(n, 1, "complex", config)
        batch = fr.shape[:-1]
        b = math.prod(batch)
        if n > 1 and b >= 2:
            bp = b + (b % 2)
            fr2 = fr.reshape(b, n)
            fi2 = fi.reshape(b, n)
            if bp != b:
                fr2 = F.pad(fr2, (0, 0, 0, 1))
                fi2 = F.pad(fi2, (0, 0, 0, 1))
            zr = fr2[0::2] - fi2[1::2]
            zi = fi2[0::2] + fr2[1::2]
            gr, gi = exec_complex(plan, zr, zi)
            out = torch.stack([gr, gi], dim=1).reshape(bp, n)[:b]
            out = out.reshape(*batch, n) / n
        else:
            gr, _ = exec_complex(plan, fr, fi)
            out = gr / n
    # both paths produce the "backward" normalization; rescale for the others
    norm = norm or "backward"
    if norm not in ("backward", "ortho", "forward"):
        raise ValueError(f"unknown norm {norm!r}")
    if norm == "ortho":
        out = out * math.sqrt(n)
    elif norm == "forward":
        out = out * float(n)
    return torch.movedim(out, -1, axis)


@batch_sharded(_axes_of)
def rfftn(x, s=None, axes=None, norm="backward", *, config=DEFAULT_CONFIG):
    """N-D real FFT: rfft over the last requested axis, complex fft over the rest."""
    x = as_tensor(x)
    s, axes = _axes_shape(x, s, axes)
    out = rfft(x, n=s[-1], axis=axes[-1], norm=norm, config=config)
    for n_i, a in zip(s[:-1], axes[:-1]):
        out = fft(out, n=n_i, axis=a, norm=norm, config=config)
    return out


@batch_sharded(_axes_of)
def irfftn(x, s=None, axes=None, norm="backward", *, config=DEFAULT_CONFIG):
    """Inverse N-D real FFT (numpy.fft.irfftn): complex ifft over the leading
    requested axes, irfft over the last."""
    x = as_tensor(x)
    if axes is None:
        axes = tuple(range(x.ndim))
    axes = tuple(a % x.ndim for a in axes)
    if s is None:
        s = tuple(
            x.shape[a] if a != axes[-1] else 2 * (x.shape[a] - 1) for a in axes
        )
    for n_i, a in zip(s[:-1], axes[:-1]):
        x = ifft(x, n=n_i, axis=a, norm=norm, config=config)
    return irfft(x, n=s[-1], axis=axes[-1], norm=norm, config=config)


def rfft2(x, s=None, axes=(-2, -1), norm="backward", *, config=DEFAULT_CONFIG):
    """2-D real FFT (numpy.fft.rfft2): rfftn over the given two axes."""
    return rfftn(x, s=s, axes=axes, norm=norm, config=config)


def irfft2(x, s=None, axes=(-2, -1), norm="backward", *, config=DEFAULT_CONFIG):
    """Inverse 2-D real FFT (numpy.fft.irfft2)."""
    return irfftn(x, s=s, axes=axes, norm=norm, config=config)


_SWAPPED_NORM = {"backward": "forward", "forward": "backward", "ortho": "ortho"}


def _swapped_norm(norm: Optional[str]) -> str:
    """The norm of the real transform that carries a Hermitian one (numpy's
    hfft 'backward' applies no scale, so the two are swapped)."""
    norm = norm or "backward"
    if norm not in _SWAPPED_NORM:
        raise ValueError(f"unknown norm {norm!r}")
    return _SWAPPED_NORM[norm]


def hfft(x, n: Optional[int] = None, axis: int = -1, norm="backward",
         *, config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    """FFT of a signal with Hermitian symmetry (real spectrum): half-spectrum
    input (length m) → real output of length n (default 2·(m−1)).
    hfft(a, n) = irfft(conj(a), n)·n (numpy.fft.hfft)."""
    x = as_tensor(x)
    axis = axis % x.ndim
    n = int(n) if n is not None else 2 * (x.shape[axis] - 1)
    return irfft(torch.conj(x), n=n, axis=axis, norm=_swapped_norm(norm), config=config)


def ihfft(x, n: Optional[int] = None, axis: int = -1, norm="backward",
          *, config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    """Inverse of :func:`hfft`: real input length n → half spectrum
    (n//2 + 1) with conjugate-inverted phase (numpy.fft.ihfft)."""
    spec = rfft(x, n=n, axis=axis, norm=_swapped_norm(norm), config=config)
    return torch.conj(spec).resolve_conj()


def hfftn(x, s=None, axes=None, norm="backward", *, config=DEFAULT_CONFIG):
    """N-D FFT of an array with Hermitian symmetry in the last transform
    axis → real output (scipy.fft.hfftn): irfftn(conj(a), s) scaled by
    prod(s)."""
    x = as_tensor(x)
    if axes is None:
        axes = tuple(range(x.ndim))
    axes = tuple(a % x.ndim for a in axes)
    if s is None:
        s = tuple(
            x.shape[a] if a != axes[-1] else 2 * (x.shape[a] - 1) for a in axes
        )
    return irfftn(torch.conj(x), s=s, axes=axes, norm=_swapped_norm(norm), config=config)


def ihfftn(x, s=None, axes=None, norm="backward", *, config=DEFAULT_CONFIG):
    """Inverse of :func:`hfftn` (scipy.fft.ihfftn): real input → conjugated
    half-spectrum over the last transform axis."""
    spec = rfftn(x, s=s, axes=axes, norm=_swapped_norm(norm), config=config)
    return torch.conj(spec).resolve_conj()


def hfft2(x, s=None, axes=(-2, -1), norm="backward", *, config=DEFAULT_CONFIG):
    """2-D Hermitian FFT (scipy.fft.hfft2)."""
    return hfftn(x, s=s, axes=axes, norm=norm, config=config)


def ihfft2(x, s=None, axes=(-2, -1), norm="backward", *, config=DEFAULT_CONFIG):
    """Inverse 2-D Hermitian FFT (scipy.fft.ihfft2)."""
    return ihfftn(x, s=s, axes=axes, norm=norm, config=config)
