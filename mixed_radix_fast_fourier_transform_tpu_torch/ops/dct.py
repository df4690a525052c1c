"""Discrete cosine/sine transforms (types I–IV) through the FFT engine.

Counterpart of ``mixed_radix_fast_fourier_transform_tpu/ops/dct.py``: the
scipy.fft dct/idct surface as batched FFTs of reordered or extended
sequences plus twiddle passes:

    DCT-I:   even extension of length 2(N−1), real part of its FFT
    DCT-II:  Makhoul's N-point method (reorder + post-twiddle, no padding)
    DCT-III: the inverse pairing of II
    DCT-IV:  N-point complex FFT with pre-twiddle e^(−iπq/N) on the
             sign-adjusted Makhoul reorder and post-twiddle e^(−iπ(2k+1)/(4N))
    DST-*:   exact flip/sign identities on the matching DCT types

The inner transforms run the plan's stage pipeline (``exec_complex``), as
the JAX module's do, not the fused kernel's dispatch.  norm=None matches
scipy's unnormalized convention; norm='ortho' makes each transform
orthonormal (and dct/idct exact inverses).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..plan import get_plan
from ..utils.config import DEFAULT_CONFIG, SpectralConfig
from ..utils.numerics import as_tensor, constant
from .stockham import exec_complex

Tensor = torch.Tensor


def _const(values, like: Tensor, *, key) -> Tensor:
    """The host float64 table ``values`` at the dtype of ``like`` (the
    working dtype), kept on its device under ``key``."""
    return constant(values, like, like.dtype, key=key)


def _phase(name: str, n: int, ang, like: Tensor):
    """(cos, sin) of the host float64 angle table ``ang()`` beside ``like``,
    kept on the device under (name, n)."""
    return (_const(lambda: np.cos(ang()), like, key=("dct.cos", name, n)),
            _const(lambda: np.sin(ang()), like, key=("dct.sin", name, n)))


def _prepare(x, n: Optional[int], axis: int, what: str, dtype):
    """The transform axis moved last, in the working ``dtype``, cropped or
    zero-padded to ``n``: (x, n, axis)."""
    x = as_tensor(x)
    axis = axis % x.ndim
    x = torch.movedim(x, axis, -1).to(dtype)
    if n is not None:
        n = int(n)
        cur = x.shape[-1]
        x = x[..., :n] if cur >= n else F.pad(x, (0, n - cur))
    n = x.shape[-1]
    if n < 1:
        raise ValueError(f"{what} needs n >= 1")
    return x, n, axis


def _makhoul_reorder(x: Tensor) -> Tensor:
    """v[m] = x[2m], v[N-1-m] = x[2m+1]: even samples forward, odds reversed."""
    return torch.cat([x[..., 0::2], torch.flip(x[..., 1::2], (-1,))], dim=-1)


def _dct2_core(x: Tensor, n: int, config: SpectralConfig) -> Tensor:
    """Unnormalized DCT-II via an n-point complex FFT of the reordered input."""
    v = _makhoul_reorder(x)
    plan = get_plan(n, -1, "complex", config)
    vr, vi = exec_complex(plan, v, torch.zeros_like(v))
    # y[k] = 2·Re( e^{-iπk/(2n)} · V[k] )
    cr, ci = _phase("post2", n, lambda: -np.pi * np.arange(n) / (2.0 * n), v)
    return 2.0 * (vr * cr - vi * ci)


def _dct1_core(x: Tensor, n: int, norm, config: SpectralConfig) -> Tensor:
    """DCT-I: y[k] = x[0] + (−1)^k x[n−1] + 2 Σ_{1<=m<=n−2} x[m] cos(πkm/(n−1)),
    computed as the real part of the FFT of the even extension (length 2n−2)."""
    if n < 2:
        raise ValueError("DCT-I needs n >= 2")
    if norm == "ortho":
        end = math.sqrt(2.0)
        x = torch.cat([x[..., :1] * end, x[..., 1:-1], x[..., -1:] * end], dim=-1)
    v = torch.cat([x, torch.flip(x[..., 1:-1], (-1,))], dim=-1)
    plan = get_plan(2 * n - 2, -1, "complex", config)
    vr, _ = exec_complex(plan, v, torch.zeros_like(v))
    y = vr[..., :n]
    if norm == "ortho":
        s = np.full(n, math.sqrt(1.0 / (2.0 * (n - 1))))
        s[0] /= math.sqrt(2.0)
        s[-1] /= math.sqrt(2.0)
        y = y * _const(s, y, key=("dct.ortho1", n))
    return y


def _dct4_core(x: Tensor, n: int, norm, config: SpectralConfig) -> Tensor:
    """DCT-IV: y[k] = 2 Σ_m x[m] cos(π(2k+1)(2m+1)/(4n)) via one n-point
    complex FFT: reorder with negated odds, pre-twiddle e^(−iπq/n),
    post-twiddle e^(−iπ(2k+1)/(4n)), 2·Re."""
    v = torch.cat([x[..., 0::2], -torch.flip(x[..., 1::2], (-1,))], dim=-1)
    q = np.arange(n)
    pr, pi_ = _phase("pre4", n, lambda: -np.pi * q / n, x)
    plan = get_plan(n, -1, "complex", config)
    vr, vi = exec_complex(plan, v * pr, v * pi_)
    cr, ci = _phase("post4", n, lambda: -np.pi * (2 * q + 1) / (4.0 * n), x)
    y = 2.0 * (vr * cr - vi * ci)
    if norm == "ortho":
        y = y * math.sqrt(1.0 / (2.0 * n))
    return y


def _dct3_core(x: Tensor, n: int, norm, config: SpectralConfig) -> Tensor:
    """DCT-III: y[m] = x[0] + 2 Σ_{k>=1} x[k] cos(πk(2m+1)/(2N))."""
    if norm == "ortho":
        # orthonormal III = exact inverse of orthonormal II: pre-scale so the
        # unnormalized core below produces it
        s = np.full(n, 1.0 / math.sqrt(2.0 * n))
        s[0] = 1.0 / math.sqrt(n)
        x = x * _const(s, x, key=("dct.ortho3", n))
    # Invert Makhoul (scaled): V[k] = e^{+iπk/(2n)}·(x[k] - i·x[n-k])
    # (x[n]≡0), v = unnormalized IFFT_n(V), y[2m] = v[m], y[2m+1] = v[n-1-m];
    # the n and 1/2 factors cancel against the unnormalized definition.
    cr, ci = _phase("pre3", n, lambda: np.pi * np.arange(n) / (2.0 * n), x)
    tail = torch.cat([torch.zeros_like(x[..., :1]), torch.flip(x[..., 1:], (-1,))], dim=-1)
    ar, ai = x, -tail
    vr = ar * cr - ai * ci
    vi = ar * ci + ai * cr
    plan = get_plan(n, 1, "complex", config)  # unnormalized inverse FFT
    wr, _ = exec_complex(plan, vr, vi)
    y = torch.empty_like(wr)
    y[..., 0::2] = wr[..., : (n + 1) // 2]
    y[..., 1::2] = torch.flip(wr[..., (n + 1) // 2 :], (-1,))
    return y


def _check(type: int, norm, what: str) -> None:
    if type not in (1, 2, 3, 4):
        raise ValueError(f"{what} type must be 1, 2, 3 or 4, got {type}")
    if norm not in (None, "ortho"):
        raise ValueError(f"norm must be None or 'ortho', got {norm!r}")


def dct(
    x,
    type: int = 2,
    n: Optional[int] = None,
    axis: int = -1,
    norm: Optional[str] = None,
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """DCT of type 1, 2, 3, or 4 along ``axis`` (scipy.fft.dct-compatible)."""
    _check(type, norm, "DCT")
    x, n, axis = _prepare(x, n, axis, "dct", config.dtype)
    if type == 1:
        y = _dct1_core(x, n, norm, config)
    elif type == 4:
        y = _dct4_core(x, n, norm, config)
    elif type == 3:
        y = _dct3_core(x, n, norm, config)
    else:
        y = _dct2_core(x, n, config)
        if norm == "ortho":
            s = np.full(n, math.sqrt(1.0 / (2.0 * n)))
            s[0] /= math.sqrt(2.0)
            y = y * _const(s, y, key=("dct.ortho2", n))
    return torch.movedim(y, -1, axis)


_INVERSE_PAIR = {1: 1, 2: 3, 3: 2, 4: 4}


def idct(
    x,
    type: int = 2,
    n: Optional[int] = None,
    axis: int = -1,
    norm: Optional[str] = None,
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """Inverse DCT (scipy pairing: type 2 ↔ 3; types 1 and 4 are involutions
    up to the unnormalized scale 2(n−1) / 2n respectively)."""
    _check(type, norm, "DCT")
    y = dct(x, type=_INVERSE_PAIR[type], n=n, axis=axis, norm=norm, config=config)
    if norm is None:
        nn = y.shape[axis]
        y = y / (2.0 * (nn - 1) if type == 1 else 2.0 * nn)
    return y


def _separable_nd(fn, x, type, axes, norm, config) -> Tensor:
    """Apply a 1-D transform over every axis in ``axes`` (default: all)."""
    x = as_tensor(x)
    if axes is None:
        axes = tuple(range(x.ndim))
    for a in axes:
        x = fn(x, type=type, axis=a, norm=norm, config=config)
    return x


def dctn(x, type: int = 2, axes=None, norm: Optional[str] = None, *,
         config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    """N-D DCT: separable 1-D DCTs over ``axes`` (scipy.fft.dctn)."""
    return _separable_nd(dct, x, type, axes, norm, config)


def idctn(x, type: int = 2, axes=None, norm: Optional[str] = None, *,
          config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    """Inverse N-D DCT (scipy.fft.idctn)."""
    return _separable_nd(idct, x, type, axes, norm, config)


def _alt_sign(n: int, like: Tensor) -> Tensor:
    return _const(lambda: (-1.0) ** np.arange(n), like, key=("dct.alt_sign", n))


def _dst1_core(x: Tensor, n: int, norm, config: SpectralConfig) -> Tensor:
    """DST-I: y[k] = 2 Σ_m x[m] sin(π(k+1)(m+1)/(n+1)), computed as
    −Im(FFT_{2n+2}(odd extension))[1:n+1]."""
    z1 = torch.zeros_like(x[..., :1])
    v = torch.cat([z1, x, z1, -torch.flip(x, (-1,))], dim=-1)
    plan = get_plan(2 * n + 2, -1, "complex", config)
    _, vi = exec_complex(plan, v, torch.zeros_like(v))
    y = -vi[..., 1 : n + 1]
    if norm == "ortho":
        y = y * math.sqrt(1.0 / (2.0 * (n + 1)))
    return y


def dst(
    x,
    type: int = 2,
    n: Optional[int] = None,
    axis: int = -1,
    norm: Optional[str] = None,
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """DST of type 1, 2, 3, or 4 (scipy.fft.dst-compatible).  Types 2/3/4 ride
    the exact flip/sign identities DST-II(x) = flip(DCT-II((−1)^m x)),
    DST-III(x) = (−1)^m · DCT-III(flip(x)), and
    DST-IV(x) = flip_k(DCT-IV((−1)^m x)), which carry the ortho scaling
    through unchanged; type 1 has its own odd-extension core."""
    if type not in (1, 2, 3, 4):
        raise ValueError(f"DST type must be 1, 2, 3 or 4, got {type}")
    xm, nn, axis = _prepare(x, n, axis, "dst", config.dtype)
    sgn = _alt_sign(nn, xm)
    if type == 1:
        y = _dst1_core(xm, nn, norm, config)
    elif type in (2, 4):
        y = torch.flip(dct(xm * sgn, type, axis=-1, norm=norm, config=config), (-1,))
    else:
        y = sgn * dct(torch.flip(xm, (-1,)), 3, axis=-1, norm=norm, config=config)
    return torch.movedim(y, -1, axis)


def idst(
    x,
    type: int = 2,
    n: Optional[int] = None,
    axis: int = -1,
    norm: Optional[str] = None,
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """Inverse DST (pairing mirrors idct; type 1 is an involution up to
    2(n+1), type 4 up to 2n)."""
    if type not in (1, 2, 3, 4):
        raise ValueError(f"DST type must be 1, 2, 3 or 4, got {type}")
    y = dst(x, type=_INVERSE_PAIR[type], n=n, axis=axis, norm=norm, config=config)
    if norm is None:
        nn = y.shape[axis]
        y = y / (2.0 * (nn + 1) if type == 1 else 2.0 * nn)
    return y


def dstn(x, type: int = 2, axes=None, norm: Optional[str] = None, *,
         config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    """N-D DST: separable 1-D DSTs over ``axes`` (scipy.fft.dstn)."""
    return _separable_nd(dst, x, type, axes, norm, config)


def idstn(x, type: int = 2, axes=None, norm: Optional[str] = None, *,
          config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    """Inverse N-D DST (scipy.fft.idstn)."""
    return _separable_nd(idst, x, type, axes, norm, config)
