"""Mixed-radix complex FFT stage pipeline in PyTorch.

Counterpart of ``mixed_radix_fast_fourier_transform_tpu/ops/stockham.py``.
The same Cooley-Tukey recursion runs per stage as

    reshape → (batched sub-FFTs of the remainder) → twiddle ⊙ → f×f DFT

with each dense stage an fp32 ``torch.matmul`` (the stacked (2f, 2f) form
below ``KARATSUBA_MIN_STAGE``, the three-product Karatsuba form at or above
it) and stages of size 2/4/8/16 as elementwise butterflies when the plan
enables them.  The stage forms and their crossover mirror the JAX package so
that outputs compare stage for stage; which forms suit the GPU is for a
measurement to decide.

:func:`exec_len` is the one dispatch point of the fft/rfft layers: the fused
Stockham kernel (ops/cuda_fft.py) for the lengths it supports, else this
pipeline.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..plan import (
    BluesteinPlan,
    MixedRadixPlan,
    RaderPlan,
    device_constants,
    get_plan,
)
from ..utils.numerics import cmul
from .cuda_fft import maybe_exec_kernel

Tensor = torch.Tensor

KARATSUBA_MIN_STAGE = 128
BUTTERFLY_RADICES = (2, 4, 8, 16)


def _stacked_dft_matrix(wr: Tensor, wi: Tensor) -> Tensor:
    """(2f, 2f) real block matrix [[Wr, Wi], [−Wi, Wr]]."""
    top = torch.cat([wr, wi], dim=1)
    bot = torch.cat([-wi, wr], dim=1)
    return torch.cat([top, bot], dim=0)


def _dft_apply(
    axis: int, xr: Tensor, xi: Tensor, wr: Tensor, wi: Tensor
) -> Tuple[Tensor, Tensor]:
    """Dense complex DFT stage over ``axis`` (-1 or -2).

    axis -1: z[..., k] = Σ_n x[..., n] W[n, k];
    axis -2: z[..., m, k] = Σ_n x[..., n, k] W[n, m].
    """
    f = wr.shape[0]
    if axis == -1:
        dot = torch.matmul
    else:
        dot = lambda a, w: torch.matmul(w.transpose(0, 1), a)
    if f >= KARATSUBA_MIN_STAGE:
        m1 = dot(xr, wr)
        m2 = dot(xi, wi)
        m3 = dot(xr + xi, wr + wi)
        return m1 - m2, m3 - m1 - m2
    w2 = _stacked_dft_matrix(wr, wi)
    z2 = dot(torch.cat([xr, xi], dim=axis), w2)
    if axis == -1:
        return z2[..., :f], z2[..., f:]
    return z2[..., :f, :], z2[..., f:, :]


def _bfly4(pr, pi, sign: int):
    """Length-4 DFT of four (re, im) plane tuples; returns 4-tuples."""
    x0r, x1r, x2r, x3r = pr
    x0i, x1i, x2i, x3i = pi
    ar, ai = x0r + x2r, x0i + x2i
    br, bi = x0r - x2r, x0i - x2i
    cr, ci = x1r + x3r, x1i + x3i
    dr, di = x1r - x3r, x1i - x3i
    if sign > 0:
        edr, edi = -di, dr  # +i·d
    else:
        edr, edi = di, -dr  # −i·d
    return (
        (ar + cr, br + edr, ar - cr, br - edr),
        (ai + ci, bi + edi, ai - ci, bi - edi),
    )


_SQRT1_2 = float(np.float32(np.sqrt(0.5)))
_COS_PI_8 = float(np.float32(np.cos(np.pi / 8)))
_SIN_PI_8 = float(np.float32(np.sin(np.pi / 8)))


def _bfly8(pr, pi, sign: int):
    """Length-8 DFT: two radix-4 halves plus the W8 combine."""
    er, ei = _bfly4(pr[0::2], pi[0::2], sign)
    orr, oii = _bfly4(pr[1::2], pi[1::2], sign)
    s = float(sign)
    c = _SQRT1_2
    # W8^1 = √½·(1 + i·s), W8^2 = i·s, W8^3 = √½·(−1 + i·s)
    t1r, t1i = c * (orr[1] - s * oii[1]), c * (oii[1] + s * orr[1])
    if sign > 0:
        t2r, t2i = -oii[2], orr[2]
    else:
        t2r, t2i = oii[2], -orr[2]
    t3r, t3i = -c * (orr[3] + s * oii[3]), c * (s * orr[3] - oii[3])
    tr = (orr[0], t1r, t2r, t3r)
    ti = (oii[0], t1i, t2i, t3i)
    return (
        tuple(er[k] + tr[k] for k in range(4))
        + tuple(er[k] - tr[k] for k in range(4)),
        tuple(ei[k] + ti[k] for k in range(4))
        + tuple(ei[k] - ti[k] for k in range(4)),
    )


def _bfly16(pr, pi, sign: int):
    """Length-16 DFT: two radix-8 halves plus the W16^k combine."""
    er, ei = _bfly8(pr[0::2], pi[0::2], sign)
    orr, oii = _bfly8(pr[1::2], pi[1::2], sign)
    s = float(sign)
    c1, s1, c2 = _COS_PI_8, _SIN_PI_8, _SQRT1_2

    def tw(k, cr, sn):
        # t = (cr + i·s·sn) · O_k
        return (
            cr * orr[k] - s * sn * oii[k],
            cr * oii[k] + s * sn * orr[k],
        )

    t1r, t1i = tw(1, c1, s1)
    t2r, t2i = c2 * (orr[2] - s * oii[2]), c2 * (oii[2] + s * orr[2])
    t3r, t3i = tw(3, s1, c1)
    if sign > 0:
        t4r, t4i = -oii[4], orr[4]
    else:
        t4r, t4i = oii[4], -orr[4]
    t5r, t5i = tw(5, -s1, c1)
    t6r, t6i = -c2 * (orr[6] + s * oii[6]), c2 * (s * orr[6] - oii[6])
    t7r, t7i = tw(7, -c1, s1)
    tr = (orr[0], t1r, t2r, t3r, t4r, t5r, t6r, t7r)
    ti = (oii[0], t1i, t2i, t3i, t4i, t5i, t6i, t7i)
    return (
        tuple(er[k] + tr[k] for k in range(8))
        + tuple(er[k] - tr[k] for k in range(8)),
        tuple(ei[k] + ti[k] for k in range(8))
        + tuple(ei[k] - ti[k] for k in range(8)),
    )


_BUTTERFLIES = {4: _bfly4, 8: _bfly8, 16: _bfly16}


def _butterfly_stage(
    f: int, sign: int, axis: int, xr: Tensor, xi: Tensor
) -> Tuple[Tensor, Tensor]:
    """Radix-2/4/8/16 DFT over ``axis`` (-1 or -2) as elementwise ops."""
    pr = tuple(xr.select(axis, j) for j in range(f))
    pi = tuple(xi.select(axis, j) for j in range(f))
    if f == 2:
        outr = (pr[0] + pr[1], pr[0] - pr[1])
        outi = (pi[0] + pi[1], pi[0] - pi[1])
    else:
        outr, outi = _BUTTERFLIES[f](pr, pi, sign)
    return torch.stack(outr, dim=axis), torch.stack(outi, dim=axis)


def _exec_level(
    plan: MixedRadixPlan, consts, level: int, xr: Tensor, xi: Tensor
) -> Tuple[Tensor, Tensor]:
    """Transform of length prod(factors[level:]) over the last axis.

    Split N_cur = f · n_rem with f = factors[level] as the outer DFT; input
    index n = f·n2 + n1, output k = n_rem·k1 + k2:

        X[n_rem·k1 + k2] = Σ_{n1} W_f^{n1·k1} · T[n1,k2] · FFT_{n_rem}(x[f·:+n1])[k2]
    """
    factors = plan.factors
    f = factors[level]
    bfly = (
        plan.butterfly
        and f in BUTTERFLY_RADICES
        and f <= plan.butterfly_max
    )
    if level == len(factors) - 1:
        if bfly:
            return _butterfly_stage(f, plan.sign, -1, xr, xi)
        return _dft_apply(-1, xr, xi, consts["dft_re"][level], consts["dft_im"][level])
    n_rem = math.prod(factors[level + 1 :])
    batch = xr.shape[:-1]
    # (..., N_cur) -> (..., n2, n1) -> (..., n1, n2): sub-transform over the last axis
    xr = xr.reshape(*batch, n_rem, f).transpose(-1, -2)
    xi = xi.reshape(*batch, n_rem, f).transpose(-1, -2)
    yr, yi = _exec_level(plan, consts, level + 1, xr, xi)
    yr, yi = cmul(yr, yi, consts["tw_re"][level], consts["tw_im"][level])
    if bfly:
        zr, zi = _butterfly_stage(f, plan.sign, -2, yr, yi)
    else:
        zr, zi = _dft_apply(-2, yr, yi, consts["dft_re"][level], consts["dft_im"][level])
    return zr.reshape(*batch, f * n_rem), zi.reshape(*batch, f * n_rem)


def exec_mixed_radix(
    plan: MixedRadixPlan, xr: Tensor, xi: Tensor
) -> Tuple[Tensor, Tensor]:
    """Unnormalized transform over the last axis; normalization is applied
    by the API layer per its ``norm`` argument."""
    if plan.n == 1:
        return xr, xi
    return _exec_level(plan, device_constants(plan, xr.device), 0, xr, xi)


def exec_bluestein(plan: BluesteinPlan, xr: Tensor, xi: Tensor) -> Tuple[Tensor, Tensor]:
    """Chirp-z transform; the inverse inner FFT uses the conjugation identity,
    so one forward inner plan serves both directions."""
    n, m = plan.n, plan.m
    c = device_constants(plan, xr.device)
    # a = w ⊙ x, zero-padded to m
    ar, ai = cmul(xr, xi, c["chirp_re"], c["chirp_im"])
    ar = F.pad(ar, (0, m - n))
    ai = F.pad(ai, (0, m - n))
    # A = fft_m(a); B = A ⊙ (Ĉ/m); b = ifft_m'(B) = conj(fft_m(conj(B)))
    fr, fi = exec_mixed_radix(plan.inner, ar, ai)
    br, bi = cmul(fr, fi, c["spec_re"], c["spec_im"])
    gr, gi = exec_mixed_radix(plan.inner, br, -bi)
    # X = w ⊙ conj(b)[:n]
    return cmul(gr[..., :n], -gi[..., :n], c["chirp_re"], c["chirp_im"])


def exec_rader(plan: RaderPlan, xr: Tensor, xi: Tensor) -> Tuple[Tensor, Tensor]:
    """Prime-length transform as one length-(n−1) cyclic convolution; the
    permutations are index_select gathers with device-cached int64 indices."""
    c = device_constants(plan, xr.device)
    x0r, x0i = xr[..., 0], xi[..., 0]
    ar = torch.index_select(xr, -1, c["perm_in"])
    ai = torch.index_select(xi, -1, c["perm_in"])
    fr, fi = exec_mixed_radix(plan.inner, ar, ai)
    # DC bin: X[0] = x[0] + Σ_{j≠0} x[j] = x[0] + Â[0]
    dr, di = x0r + fr[..., 0], x0i + fi[..., 0]
    # cyclic convolution with the planned kernel spectrum (1/L folded in);
    # inverse inner FFT via the conjugation identity
    br, bi = cmul(fr, fi, c["spec_re"], c["spec_im"])
    gr, gi = exec_mixed_radix(plan.inner, br, -bi)
    tr = x0r[..., None] + gr
    ti = x0i[..., None] - gi
    outr = torch.cat(
        [dr[..., None], torch.index_select(tr, -1, c["perm_out"])], dim=-1
    )
    outi = torch.cat(
        [di[..., None], torch.index_select(ti, -1, c["perm_out"])], dim=-1
    )
    return outr, outi


def exec_complex(plan, xr: Tensor, xi: Tensor) -> Tuple[Tensor, Tensor]:
    """Dispatch on plan type."""
    if isinstance(plan, BluesteinPlan):
        return exec_bluestein(plan, xr, xi)
    if isinstance(plan, RaderPlan):
        return exec_rader(plan, xr, xi)
    return exec_mixed_radix(plan, xr, xi)


def exec_len(
    config, n: int, sign: int, xr: Tensor, xi: Tensor
) -> Tuple[Tensor, Tensor]:
    """Length-``n`` unnormalized transform over the last axis: the fused
    Stockham kernel when ``config.use_kernel`` allows it and the length
    qualifies, else the plan-based stage pipeline."""
    out = maybe_exec_kernel(config, n, sign, xr, xi)
    if out is not None:
        return out
    return exec_complex(get_plan(n, sign, "complex", config), xr, xi)
