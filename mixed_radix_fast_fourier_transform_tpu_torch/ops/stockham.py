"""Mixed-radix complex FFT stage pipeline in PyTorch.

Counterpart of ``mixed_radix_fast_fourier_transform_tpu/ops/stockham.py``.
The same Cooley-Tukey recursion runs per stage as

    reshape → (batched sub-FFTs of the remainder) → twiddle ⊙ → f×f DFT

with each dense stage one ``torch.matmul`` at the planes' dtype (the
stacked (2f, 2f) form below ``KARATSUBA_MIN_STAGE``, the three-product
Karatsuba form at or above it) and stages of size 2/4/8/16 as elementwise
butterflies when the plan enables them.  fp32 and float64 planes multiply at
their own precision; bf16 and fp16 planes multiply with fp32 accumulation
and a rounded output, as XLA's ``preferred_element_type`` does.

Each product runs at the plan's precision for its stage (see
``SpectralConfig.precision``): "highest" in IEEE fp32, "high"/"default" in
TF32 on a CUDA tensor, "split6" as :func:`_einsum_split6`.  Under
``torch.compile`` and ``torch.export`` a product carries its precision as
an operator node (``utils.numerics.product``), so every precision and
working dtype compiles at the caller's flags; the fp32 "highest" products
stay plain matmuls.  The stage forms
and their crossover mirror the JAX package so that outputs compare stage
for stage; which forms suit the GPU is for a measurement to decide.

:func:`exec_len` is the one dispatch point of the fft/rfft layers: the fused
Stockham kernel (ops/cuda_fft.py) for the lengths it supports, else this
pipeline.
"""

from __future__ import annotations

import contextlib
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
from ..utils.metrics import tracing
from ..utils.numerics import cmul, matmul_precision, product
from .cuda_fft import maybe_exec_kernel

Tensor = torch.Tensor

KARATSUBA_MIN_STAGE = 128
BUTTERFLY_RADICES = (2, 4, 8, 16)


def _stacked_dft_matrix(wr: Tensor, wi: Tensor) -> Tensor:
    """(2f, 2f) real block matrix [[Wr, Wi], [−Wi, Wr]]."""
    top = torch.cat([wr, wi], dim=1)
    bot = torch.cat([-wi, wr], dim=1)
    return torch.cat([top, bot], dim=0)


def _bf16_chunks3(v: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Three bf16 chunks of fp32 ``v``, v ≈ c1 + c2 + c3, bit-equal to the
    JAX module's: c1 and c2 are cut by clearing the low 16 bits of the fp32
    pattern (so each is exactly a bf16 value and the residuals are exact
    fp32 subtractions), c3 is the second residual rounded to bf16."""
    def cut(x: Tensor) -> Tensor:
        return (x.contiguous().view(torch.int32) & _HIGH_16).view(torch.float32)

    c1 = cut(v)
    r1 = v - c1
    c2 = cut(r1)
    r2 = r1 - c2
    return c1.to(torch.bfloat16), c2.to(torch.bfloat16), r2.to(torch.bfloat16)


# The mask that keeps the sign, the exponent and the top 7 mantissa bits of
# an fp32 pattern: a bf16 value.
_HIGH_16 = ~0xFFFF


def _einsum_split6(axis: int, x: Tensor, w: Tensor) -> Tensor:
    """An fp32 product as ONE product of depth 6K, the JAX module's
    "split6": the six leading chunk products x1w1; x1w2 + x2w1; x1w3 +
    x2w2 + x3w1 of :func:`_bf16_chunks3`, stacked on the contraction axis,
    summed in fp32, fp32 out.  Never rounded to bf16.  On the card the
    product runs in IEEE fp32 (TF32 off): both tensor-core forms of it (TF32
    products of the chunks; bf16 chunks with an fp32 output) summed the
    6K-deep product less exactly and missed split6's 5e-6 bound (PERF.md §6,
    ``tools/tune.py split6``).  Under a trace the product is the operator
    node of ``utils.numerics.product`` at "highest" whatever the caller's
    flags (``carried``)."""
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise ValueError(
            f"precision 'split6' needs fp32 planes, got dtype {x.dtype}: its "
            f"chunks are cut from the fp32 bit pattern")
    x1, x2, x3 = _bf16_chunks3(x)
    w1, w2, w3 = _bf16_chunks3(w)
    xs = torch.cat([x1, x1, x2, x1, x2, x3], dim=axis)
    ws = torch.cat([w1, w2, w1, w3, w2, w1], dim=0)
    if axis == -2:   # z[..., m, k] = Σ_n W[n, m] x[..., n, k]
        xs, ws = ws.transpose(0, 1), xs
    return product(xs.float(), ws.float(), "highest", carried=True)


def _dot(axis: int, x: Tensor, w: Tensor, precision: str) -> Tensor:
    """One dense stage product at ``precision`` over ``axis`` (see
    :func:`_dft_apply`)."""
    if precision == "split6":
        return _einsum_split6(axis, x, w)
    if axis == -1:
        return product(x, w, precision)
    return product(w.transpose(0, 1), x, precision)


def _dft_apply(
    axis: int, xr: Tensor, xi: Tensor, wr: Tensor, wi: Tensor,
    precision: str = "highest",
) -> Tuple[Tensor, Tensor]:
    """Dense complex DFT stage over ``axis`` (-1 or -2) at ``precision``.

    axis -1: z[..., k] = Σ_n x[..., n] W[n, k];
    axis -2: z[..., m, k] = Σ_n x[..., n, k] W[n, m].
    """
    f = wr.shape[0]

    def dot(a, w):
        return _dot(axis, a, w, precision)

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


# The W8/W16 constants (√½, cos π/8, sin π/8) for each working dtype,
# rounded from float64 to it: fp32 planes get the JAX package's fp32 values,
# float64 planes keep every bit, 2-byte planes the values the JAX package's
# scalar takes at their dtype.
_BFLY_CONSTS = {
    dtype: tuple(
        float(torch.tensor(v, dtype=torch.float64).to(dtype))
        for v in (np.sqrt(0.5), np.cos(np.pi / 8), np.sin(np.pi / 8))
    )
    for dtype in (torch.float32, torch.float64, torch.bfloat16, torch.float16)
}


def _bfly8(pr, pi, sign: int):
    """Length-8 DFT: two radix-4 halves plus the W8 combine."""
    er, ei = _bfly4(pr[0::2], pi[0::2], sign)
    orr, oii = _bfly4(pr[1::2], pi[1::2], sign)
    s = float(sign)
    c = _BFLY_CONSTS[pr[0].dtype][0]
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
    c2, c1, s1 = _BFLY_CONSTS[pr[0].dtype]

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
    prec = plan.precision
    if isinstance(prec, tuple):  # per-stage scheme
        prec = prec[min(level, len(prec) - 1)]
    f = factors[level]
    bfly = (
        plan.butterfly
        and f in BUTTERFLY_RADICES
        and f <= plan.butterfly_max
    )
    if level == len(factors) - 1:
        if bfly:
            return _butterfly_stage(f, plan.sign, -1, xr, xi)
        return _dft_apply(-1, xr, xi, consts["dft_re"][level], consts["dft_im"][level], prec)
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
        zr, zi = _dft_apply(-2, yr, yi, consts["dft_re"][level], consts["dft_im"][level], prec)
    return zr.reshape(*batch, f * n_rem), zi.reshape(*batch, f * n_rem)


def exec_mixed_radix(
    plan: MixedRadixPlan, xr: Tensor, xi: Tensor
) -> Tuple[Tensor, Tensor]:
    """Unnormalized transform over the last axis; normalization is applied
    by the API layer per its ``norm`` argument."""
    if plan.n == 1:
        return xr, xi
    with _flags(plan):
        return _exec_level(plan, device_constants(plan, xr.device), 0, xr, xi)


def _flags(plan):
    """The one precision block of a transform of ``plan``: torch's flags set
    once for all its products, at its first stage's precision ("highest"
    for split6, whose products run in IEEE fp32); a stage at another
    precision sets its own.  Under torch.compile no block: each product
    carries its own precision or is checked (``utils.numerics.product``)."""
    if tracing():
        return contextlib.nullcontext()
    # Bluestein and Rader run at their inner plan's precision (isinstance,
    # not getattr with a default: dynamo cannot guard a hasattr on a plan)
    prec = (plan.inner if isinstance(plan, (BluesteinPlan, RaderPlan)) else plan).precision
    prec = prec[0] if isinstance(prec, tuple) else prec
    return matmul_precision("highest" if prec == "split6" else prec, plan.dtype)


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
        with _flags(plan):
            return exec_bluestein(plan, xr, xi)
    if isinstance(plan, RaderPlan):
        with _flags(plan):
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
