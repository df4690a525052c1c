"""B-spline signal processing (scipy.signal spline family).

Counterpart of ``mixed_radix_fast_fourier_transform_tpu/ops/splines.py``.
Spline coefficient computation is recursive filtering with
mirror-symmetric boundary handling: a first- or second-order symmetric
IIR applied forward then backward.  Both passes ride the library's blocked
recurrence scan (``ops/iir._apply_df2t``), so the "recursive" spline
prefilter is a few device kernels per pass whatever the signal's length;
the boundary conditions are truncated geometric sums — host-coefficient dot
products against the signal head/tail (the truncation horizon depends only
on the pole radius and precision, never on data).

IC conventions were pinned numerically against scipy's compiled
``_spline`` kernels (unit-vector probes): forward y₀/y₁ use the causal
half-response h_c, backward use the full symmetric response h_s — exact
to the precision-truncation in all probed cases.
"""

from __future__ import annotations

import math

from typing import Tuple

import numpy as np
import torch

from ..utils.config import DEFAULT_CONFIG, DTYPE, SpectralConfig
from ..utils.numerics import as_tensor, constant, content_key, matmul_precision
from .iir import _apply_df2t

Tensor = torch.Tensor

__all__ = [
    "gauss_spline", "cubic", "quadratic",
    "symiirorder1", "symiirorder2",
    "cspline1d", "qspline1d", "cspline1d_eval", "qspline1d_eval",
    "cspline2d", "qspline2d", "sepfir2d", "spline_filter",
]


def _signal(x, dtype=DTYPE) -> Tensor:
    """``x`` as a real tensor of ``dtype``: fp32, or the config's working
    dtype in the ops that read it (numpy input goes to the card; other
    float dtypes and integers are cast)."""
    return as_tensor(x).to(dtype)


def _weights(w: np.ndarray, like: Tensor) -> Tensor:
    """Host boundary weights as a device table of ``like``'s dtype."""
    return constant(w, like, like.dtype, key=content_key("spline_weights", w))


def _dot(x: Tensor, w: np.ndarray) -> Tensor:
    """x (…, m) · w (m,): one fp32 product, TF32 off."""
    with matmul_precision():
        return x @ _weights(w, x)


def gauss_spline(x, n: int) -> Tensor:
    """Gaussian approximation of a B-spline of order n
    (scipy.signal.gauss_spline)."""
    x = _signal(x)
    sigsq = (n + 1) / 12.0
    return torch.exp(-(x ** 2) / (2.0 * sigsq)) / math.sqrt(2 * math.pi * sigsq)


def cubic(x) -> Tensor:
    """Cubic B-spline β³(x) (closed form, scipy.signal's _cubic kernel)."""
    ax = torch.abs(_signal(x))
    inner = 2.0 / 3.0 - ax * ax + 0.5 * ax ** 3
    outer = ((2.0 - ax) ** 3) / 6.0
    return torch.where(ax < 1.0, inner, torch.where(ax < 2.0, outer, torch.zeros_like(ax)))


def quadratic(x) -> Tensor:
    """Quadratic B-spline β²(x) (closed form)."""
    ax = torch.abs(_signal(x))
    inner = 0.75 - ax * ax
    outer = 0.5 * (ax - 1.5) ** 2
    return torch.where(ax < 0.5, inner, torch.where(ax < 1.5, outer, torch.zeros_like(ax)))


def _default_precision(precision: float, dtype) -> float:
    if 0.0 <= precision < 1.0:
        return precision
    return 1e-3 if torch.finfo(dtype).bits <= 32 else 1e-6


def _horizon(rho: float, precision: float, n: int, name: str) -> int:
    """Truncation horizon M with ρ^M < precision; error if it exceeds n.

    NOTE: scipy's compiled kernels stop the *backward* sums when the
    TERM SQUARED drops below precision (i.e. |term| < √precision — probed
    numerically), so at the default fp32 precision of 1e-3 its boundary
    samples carry ~3e-2-scale truncation error.  This implementation keeps
    the tighter |term| < precision horizon; comparisons against scipy
    therefore agree tightly in the interior and to ~√precision at edges.
    """
    if abs(rho) >= 1.0:
        raise ValueError(f"{name}: pole magnitude must be < 1, got {rho}")
    if rho == 0.0:
        return 1
    m = int(math.ceil(math.log(precision) / math.log(abs(rho)))) + 1
    if m >= n:
        raise ValueError(
            f"{name}: boundary-condition sum needs {m} terms but the signal "
            f"has only {n} — lower precision or provide a longer signal"
        )
    return m


def _flip(x: Tensor) -> Tensor:
    return torch.flip(x, (-1,))


def symiirorder1(signal, c0: float, z1: float, precision: float = -1.0, *,
                 config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    """Mirror-symmetric first-order IIR smoother
    H(z) = c0 / ((1 − z1·z⁻¹)(1 − z1·z)) — scipy.signal.symiirorder1
    semantics, batched over leading axes, forward+backward scans."""
    x = _signal(signal, config.dtype)
    n = x.shape[-1]
    prec = _default_precision(precision, x.dtype)
    m = _horizon(z1, prec, n, "symiirorder1")
    # y0 = x[0] + Σ_{k=0}^{M} z1^{k+1} x[k]  (pinned against _spline)
    pw = z1 ** (np.arange(m, dtype=np.float64) + 1.0)
    y0 = x[..., 0] + _dot(x[..., :m], pw)
    # forward: 1/(1 − z1 z⁻¹) over x[1:] seeded with state z1·y0
    b = np.array([1.0])
    a = np.array([1.0, -z1])
    y1_tail, _ = _apply_df2t(x[..., 1:], b, a, (z1 * y0)[..., None])
    y1 = torch.cat([y0[..., None], y1_tail], dim=-1)
    # backward: c0/(1 − z1 z) on the reversed forward output
    out_last = (-c0 / (z1 - 1.0)) * y1[..., -1]
    rev, _ = _apply_df2t(_flip(y1[..., :-1]), np.array([c0]), a,
                         (z1 * out_last)[..., None])
    return torch.cat([_flip(rev), out_last[..., None]], dim=-1)


def _hc(k: np.ndarray, cs: float, rho: float, omega: float) -> np.ndarray:
    k = np.asarray(k, np.float64)
    return cs / math.sin(omega) * rho ** k * np.sin(omega * (k + 1)) * (k > -1)


def _hs(k: np.ndarray, cs: float, rho: float, omega: float) -> np.ndarray:
    ak = np.abs(np.asarray(k, np.float64))
    c0 = (cs * cs * (1 + rho * rho) / (1 - rho * rho)
          / (1 - 2 * rho * rho * math.cos(2 * omega) + rho ** 4))
    gamma = (1 - rho * rho) / (1 + rho * rho) / math.tan(omega)
    return c0 * rho ** ak * (np.cos(omega * ak) + gamma * np.sin(omega * ak))


def _sym2_pass(x: Tensor, cs: float, a2: float, a3: float,
               ic: Tuple[Tensor, Tensor]) -> Tensor:
    """One pass of cs/(1 − a2 z⁻¹ − a3 z⁻²) seeded with outputs y0, y1."""
    b = np.array([cs, 0.0, 0.0])
    a = np.array([1.0, -a2, -a3])
    y0, y1 = ic
    # DF2T state after emitting y0 then y1 (b has only b0 = cs):
    #   z1 = a2·y1 + a3·y0,  z2 = a3·y1
    zi = torch.stack([a2 * y1 + a3 * y0, a3 * y1], dim=-1)
    tail, _ = _apply_df2t(x[..., 2:], b, a, zi)
    return torch.cat([y0[..., None], y1[..., None], tail], dim=-1)


def _sym2_both(x: Tensor, cs: float, rho: float, omega: float, w_y0, w_y1, v0, v1,
               m: int) -> Tensor:
    """The forward pass seeded from the head weights, then the backward
    pass seeded from the ORIGINAL signal's tail through the symmetric h_s."""
    a2, a3 = 2 * rho * math.cos(omega), -rho * rho
    y_fwd = _sym2_pass(x, cs, a2, a3, (_dot(x[..., :m], w_y0), _dot(x[..., :m], w_y1)))
    xr = _flip(x)
    out = _sym2_pass(_flip(y_fwd), cs, a2, a3, (_dot(xr[..., :m], v0), _dot(xr[..., :m], v1)))
    return _flip(out)


def symiirorder2(input, r: float, omega: float, precision: float = -1.0, *,
                 config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    """Mirror-symmetric second-order IIR smoother
    H(z) = cs² / ((1 − 2r·cosω·z⁻¹ + r²·z⁻²)(1 − 2r·cosω·z + r²·z²)) —
    scipy.signal.symiirorder2 semantics, forward+backward scans."""
    x = _signal(input, config.dtype)
    if r >= 1.0:
        raise ValueError(f"r must be < 1.0, got {r}")
    n = x.shape[-1]
    prec = _default_precision(precision, x.dtype)
    m = _horizon(r, prec, n - 2, "symiirorder2")
    cs = 1 - 2 * r * math.cos(omega) + r * r
    k = np.arange(m, dtype=np.float64)
    # forward ICs (pinned): y0 = hc(0)x0 + Σ hc(k+1)x[k],
    #                       y1 = hc(1)x0 + hc(0)x1 + Σ hc(k+2)x[k]
    w0 = _hc(k + 1, cs, r, omega)
    w0[0] += _hc(np.array(0.0), cs, r, omega)
    w1 = _hc(k + 2, cs, r, omega)
    w1[0] += _hc(np.array(1.0), cs, r, omega)
    w1[1] += _hc(np.array(0.0), cs, r, omega)
    # backward ICs from the ORIGINAL signal tail via the symmetric h_s
    v0 = _hs(k, cs, r, omega) + _hs(k + 1, cs, r, omega)
    v1 = _hs(k - 1, cs, r, omega) + _hs(k + 2, cs, r, omega)
    return _sym2_both(x, cs, r, omega, w0, w1, v0, v1, m)


def cspline1d(signal, lamb: float = 0.0, *,
              config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    """Cubic-spline coefficients of a mirror-symmetric signal
    (scipy.signal.cspline1d; ``lamb`` > 0 smooths)."""
    x = _signal(signal, config.dtype)
    if lamb != 0.0:
        return _cubic_smooth_coeff(x, float(lamb))
    z1 = -2.0 + math.sqrt(3.0)
    return symiirorder1(x, -z1 * 6.0, z1,
                        precision=_default_precision(-1.0, x.dtype),
                        config=config)


def qspline1d(signal, lamb: float = 0.0, *,
              config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    """Quadratic-spline coefficients (scipy.signal.qspline1d)."""
    if lamb != 0.0:
        raise ValueError("smoothing quadratic splines are not supported")
    x = _signal(signal, config.dtype)
    z1 = -3.0 + 2.0 * math.sqrt(2.0)
    return symiirorder1(x, -z1 * 8.0, z1,
                        precision=_default_precision(-1.0, x.dtype),
                        config=config)


def _cubic_smooth_coeff(x: Tensor, lamb: float) -> Tensor:
    """Smoothing cubic spline (Unser): second-order symmetric IIR with
    λ-dependent damped-cosine poles (scipy's _cubic_smooth_coeff)."""
    xi = 1 - 96 * lamb + 24 * lamb * math.sqrt(3 + 144 * lamb)
    omega = math.atan2(math.sqrt(144 * lamb - 1), math.sqrt(xi))
    rho = (24 * lamb - 1 - math.sqrt(xi)) / (24 * lamb)
    rho = rho * math.sqrt(
        (48 * lamb + 24 * lamb * math.sqrt(3 + 144 * lamb)) / xi)
    cs = 1 - 2 * rho * math.cos(omega) + rho * rho
    n = x.shape[-1]
    k = np.arange(n, dtype=np.float64)
    # untruncated boundary sums (scipy's smoothing path uses the full
    # signal, not a precision horizon)
    w_y0 = _hc(k + 1, cs, rho, omega)
    w_y0[0] += _hc(np.array(0.0), cs, rho, omega)
    w_y1 = _hc(k + 2, cs, rho, omega)
    w_y1[0] += _hc(np.array(0.0), cs, rho, omega)
    w_y1[1] += _hc(np.array(1.0), cs, rho, omega)
    v0 = _hs(k, cs, rho, omega) + _hs(k + 1, cs, rho, omega)
    v1 = _hs(k - 1, cs, rho, omega) + _hs(k + 2, cs, rho, omega)
    return _sym2_both(x, cs, rho, omega, w_y0, w_y1, v0, v1, n)


def _mirror_fold(t: Tensor, n: int) -> Tensor:
    """Reflect arbitrary sample positions into [0, n−1] with the
    whole-sample mirror symmetry x[−t] = x[t], period 2(n−1)."""
    if n == 1:
        return torch.zeros_like(t)
    period = 2.0 * (n - 1)
    t = torch.remainder(torch.abs(t), period)
    return torch.minimum(t, period - t)


def _spline_eval(cj, newx, kernel, support: int,
                 dx: float, x0: float) -> Tensor:
    cj = _signal(cj)
    t = (as_tensor(newx, cj.device).to(cj.dtype) - x0) / float(dx)
    n = cj.shape[-1]
    t = _mirror_fold(t, n)
    # first contributing knot: smallest integer j with |t − j| inside the
    # kernel support radius support/2
    jlo = torch.floor(t - support / 2.0).to(torch.int64) + 1
    out = torch.zeros(t.shape, dtype=cj.dtype, device=cj.device)
    for i in range(support):
        j = jlo + i
        jc = torch.clamp(j, 0, n - 1)
        out = out + cj[..., jc] * kernel(t - j)
    return out


def cspline1d_eval(cj, newx, dx: float = 1.0, x0: float = 0.0) -> Tensor:
    """Evaluate a cubic spline from its coefficients at ``newx``
    (scipy.signal.cspline1d_eval, mirror-symmetric extension)."""
    return _spline_eval(cj, newx, cubic, 4, dx, x0)


def qspline1d_eval(cj, newx, dx: float = 1.0, x0: float = 0.0) -> Tensor:
    """Evaluate a quadratic spline (scipy.signal.qspline1d_eval)."""
    return _spline_eval(cj, newx, quadratic, 3, dx, x0)


def _apply_last_then_first(fn, x: Tensor) -> Tensor:
    out = fn(x)
    out = torch.movedim(fn(torch.movedim(out, 0, -1)), -1, 0)
    return out


def cspline2d(signal, lamb: float = 0.0, precision: float = -1.0, *,
              config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    """2-D cubic-spline coefficients (scipy.signal.cspline2d): the 1-D
    prefilter separably along both axes."""
    x = _signal(signal, config.dtype)
    prec = _default_precision(precision, x.dtype)
    if lamb <= 1.0 / 144.0:
        z1 = -2.0 + math.sqrt(3.0)
        fn = lambda v: symiirorder1(v, -z1 * 6.0, z1, prec, config=config)
        return _apply_last_then_first(fn, x)
    tmp = math.sqrt(3 + 144 * lamb)
    xi = 1 - 96 * lamb + 24 * lamb * tmp
    omega = math.atan(math.sqrt((144 * lamb - 1.0) / xi))
    r = ((24 * lamb - 1 - math.sqrt(xi)) / (24 * lamb)
         * math.sqrt(48 * lamb + 24 * lamb * tmp) / math.sqrt(xi))
    fn = lambda v: symiirorder2(v, r, omega, prec, config=config)
    return _apply_last_then_first(fn, x)


def qspline2d(signal, lamb: float = 0.0, precision: float = -1.0, *,
              config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    """2-D quadratic-spline coefficients (scipy.signal.qspline2d)."""
    if lamb > 0:
        raise ValueError("lamb must be <= 0 for quadratic splines")
    x = _signal(signal, config.dtype)
    prec = _default_precision(precision, x.dtype)
    z1 = -3.0 + 2.0 * math.sqrt(2.0)
    fn = lambda v: symiirorder1(v, -z1 * 8.0, z1, prec, config=config)
    return _apply_last_then_first(fn, x)


def _symmetric_pad(v: Tensor, r: int) -> Tensor:
    """numpy's "symmetric" padding of the last axis by ``r`` at both ends
    (half-sample symmetry, the edge sample repeated), reflecting again off
    the grown signal when ``r`` exceeds its length."""
    left = right = r
    while left > 0 or right > 0:
        n = v.shape[-1]
        lo, hi = min(left, n), min(right, n)
        v = torch.cat([_flip(v[..., :lo]), v, _flip(v[..., n - hi:])], dim=-1)
        left, right = left - lo, right - hi
    return v


def sepfir2d(input, hrow, hcol) -> Tensor:
    """Separable 2-D FIR with mirror-symmetric boundaries
    (scipy.signal.sepfir2d); both filters must be odd-length.  Each pass is
    the direct convolution of ``ops/convolve.py`` (cuDNN, full fp32)."""
    from .convolve import _direct_convolve_nd

    x = _signal(input)
    if x.ndim != 2:
        raise ValueError("sepfir2d expects a rank-2 input")
    hrow = np.asarray(hrow, np.float64)
    hcol = np.asarray(hcol, np.float64)
    if hrow.ndim != 1 or hcol.ndim != 1 or not (hrow.size % 2 and hcol.size % 2):
        raise ValueError("hrow and hcol must be odd-length 1-D filters")

    def conv_last(v: Tensor, h: np.ndarray) -> Tensor:
        r = h.size // 2
        if r:
            # scipy's "mirror symmetric" here is HALF-sample symmetry
            # (edge repeated): x[-1] = x[0] — probed against the C kernel
            v = _symmetric_pad(v, r)
        flat = v.reshape(-1, v.shape[-1])
        taps = constant(h[None], v, v.dtype, key=content_key("sepfir2d", h))
        full = _direct_convolve_nd(flat, taps, (-1,))
        out = full[:, h.size - 1: flat.shape[-1]]       # the valid part
        return out.reshape(v.shape[:-1] + (out.shape[-1],))

    out = conv_last(x, hrow)  # along the last axis
    out = torch.movedim(conv_last(torch.movedim(out, 0, -1), hcol), -1, 0)
    return out


def spline_filter(Iin, lmbda: float = 5.0, *,
                  config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    """Smoothing-spline low-pass of a rank-2 image
    (scipy.signal.spline_filter): cspline2d then the [1,4,1]/6 synthesis."""
    x = _signal(Iin)
    ck = cspline2d(x, lmbda, config=config)
    h = np.array([1.0, 4.0, 1.0]) / 6.0
    return sepfir2d(ck, h, h)
