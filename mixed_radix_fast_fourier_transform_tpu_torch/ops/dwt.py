"""Discrete wavelet transform — orthogonal and biorthogonal Mallat filter banks.

Counterpart of ``mixed_radix_fast_fourier_transform_tpu/ops/dwt.py``:
Daubechies / symlet / coiflet / CDF analysis-synthesis with perfect
reconstruction, the stationary and packet transforms, and wavelet
shrinkage.  The filter banks are built on the host exactly as the JAX
module builds them (the same code, so the filters are bit-equal): the
derived orders by spectral factorization, each bank verified at build
time by an exact perfect-reconstruction probe (``_check_pr``).

Device shape: where the JAX module gathers (L, F) windows and contracts
them with the filter pair in one einsum, each analysis level here is one
stride-2 ``F.conv1d`` of the periodically padded signal with the stacked
(2, F) bank, and each synthesis level one ``F.conv1d`` of the padded
(approx, detail) pair with both polyphase components of both filters —
the same sums, with the signal read once, at the config's ``op_precision``.
The stationary transform is the same convolution dilated by 2^j.  The
extension-mode synthesis keeps the JAX module's polyphase gather.

Boundary modes (``mode=``):

* ``"periodization"`` (default): periodized filter bank, length N/2 per
  band, N must be even — the most compact representation.
* ``"zero"``, ``"symmetric"``, ``"reflect"``, ``"periodic"``: pywt-style
  extension modes; coefficient length (N + F - 1)//2 (+1 boundary window
  per side for biorthogonal banks).  ``idwt`` returns the pywt-canonical
  2·La - F + 2 samples; :func:`waverec` trims the possible odd-length
  extra sample.

Wavelets: ``haar``/``db1``..``db12``, ``sym2``..``sym10``,
``coif1``..``coif5``, ``bior2.2`` (LeGall/CDF 5/3) and ``bior4.4``
(CDF 9/7, the JPEG2000 pair).
"""

from __future__ import annotations

import functools
import itertools
import math
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.config import DEFAULT_CONFIG, SpectralConfig
from ..utils.numerics import (
    as_tensor, as_tensors, content_key, convolution, host_table, key_array, median,
    on_host, pad_last, real_dtype,
)

Tensor = torch.Tensor

_MODES = ("periodization", "zero", "symmetric", "reflect", "periodic")

# Orthogonal scaling (rec_lo) filters — standard published Daubechies values.
_REC_LO = {
    "haar": [0.7071067811865476, 0.7071067811865476],
    "db2": [
        0.48296291314469025, 0.836516303737469,
        0.22414386804185735, -0.12940952255092145,
    ],
    "db3": [
        0.3326705529509569, 0.8068915093133388, 0.4598775021193313,
        -0.13501102001039084, -0.08544127388224149, 0.035226291882100656,
    ],
    "db4": [
        0.23037781330885523, 0.7148465705525415, 0.6308807679295904,
        -0.02798376941698385, -0.18703481171888114, 0.030841381835986965,
        0.032883011666982945, -0.010597401784997278,
    ],
}
_REC_LO["db1"] = _REC_LO["haar"]


def _halfband_roots(n: int) -> np.ndarray:
    """Roots (in z) of the degree-(n-1) Daubechies half-band polynomial
    B(y), y(z) = (2 - z - 1/z)/4 — the shared factorization core of the
    derived db/sym families.  np.roots conditioning caps reliable orders
    at n <= ~12 (the PR probe at bank build catches degradation)."""
    from math import comb

    by = [comb(n - 1 + k, k) for k in range(n)]
    y = np.array([-0.25, 0.5, -0.25])  # ascending Laurent coeffs
    b = np.array([float(by[0])])
    ypow = np.array([1.0])
    for c in by[1:]:
        ypow = np.convolve(ypow, y)
        b2 = np.zeros(len(ypow))
        off = (len(ypow) - len(b)) // 2
        b2[off : off + len(b)] = b
        b = b2 + c * ypow
    return np.roots(b[::-1])


def _spline_compose(n: int, chosen) -> np.ndarray:
    """((1+z)/2)^n times the chosen root factors, normalized to sum
    sqrt(2) — shared synthesis of the derived lowpass filters."""
    h = np.array([1.0])
    for _ in range(n):
        h = np.convolve(h, [0.5, 0.5])
    for r in chosen:
        h = np.convolve(h, [-r, 1.0])
    h = np.real(h)
    return h * (math.sqrt(2.0) / h.sum())


def _daubechies_lowpass(n: int):
    """rec_lo of dbN derived by spectral factorization (not transcribed):
    minimum-phase root selection.  Accurate to ~1e-12 vs the published
    db2-db4 tables."""
    roots = _halfband_roots(n)
    return _spline_compose(n, [r for r in roots if abs(r) < 1.0 - 1e-12])


for _n in range(5, 13):
    _REC_LO[f"db{_n}"] = _daubechies_lowpass(_n).tolist()


def _symlet_lowpass(n: int):
    """rec_lo of symN: same half-band factorization as dbN but selecting,
    per reciprocal root group, the inside/outside set minimizing deviation
    from linear phase (the symlet criterion) — reproduces the published
    sym4 table to ~8e-13."""
    import itertools

    roots = _halfband_roots(n)
    build = lambda chosen: _spline_compose(n, chosen)

    def phase_dev(h):
        w = np.linspace(0.05, np.pi - 0.05, 256)
        hw = np.polyval(h[::-1], np.exp(-1j * w))
        ph = np.unwrap(np.angle(hw))
        a = np.vstack([w, np.ones_like(w)]).T
        coef, *_ = np.linalg.lstsq(a, ph, rcond=None)
        return float(np.sum((ph - a @ coef) ** 2))

    used = np.zeros(len(roots), bool)
    groups = []
    for i, r in enumerate(roots):
        if used[i]:
            continue
        used[i] = True

        def take(val):
            k = int(np.argmin(
                [abs(x - val) if not used[kk] else 9e9
                 for kk, x in enumerate(roots)]
            ))
            used[k] = True
            return roots[k]

        if abs(r.imag) < 1e-9:
            groups.append(([r], [take(1.0 / r)]))
        else:
            rc = take(np.conj(r))
            ri = take(1.0 / r)
            ric = take(1.0 / np.conj(r))
            groups.append(([r, rc], [ri, ric]))
    best = None
    for bits in itertools.product((0, 1), repeat=len(groups)):
        chosen = []
        for g, bit in zip(groups, bits):
            chosen += g[bit]
        h = build(chosen)
        d = phase_dev(h)
        if best is None or d < best[0]:
            best = (d, h)
    return best[1]


_REC_LO["sym2"] = _REC_LO["db2"]
_REC_LO["sym3"] = _REC_LO["db3"]
for _n in range(4, 11):
    _REC_LO[f"sym{_n}"] = _symlet_lowpass(_n).tolist()

# Coiflets (coifL: length 6L, 2L vanishing moments for BOTH psi and — p >=
# 1 — phi), derived by tools/derive_coiflets.py: factor out the binomial
# ((1+z)/2)^2L, Levenberg-Marquardt on the remainder with Chebyshev-based
# scaling-moment rows, near-linear-phase branch selection (same criterion
# as the symlets; branches separate by >10x in phase deviation).  coif1 is
# the closed form (sqrt(2)/32)·[1−√7, 5+√7, 14+2√7, 14−2√7, 1−√7, −3+√7]
# reversed; the higher orders are frozen here because the restart search
# costs ~minutes (values verified against all defining conditions at
# derivation time, and re-verified by tests/test_dwt.py moment checks).
_REC_LO.update({
    "coif1": [-0.07273261951252646, 0.3378976624574818, 0.8525720202116004,
              0.3848648468648578, -0.07273261951252646, -0.01565572813579199],
    "coif2": [0.016387336463203707, -0.04146493678687119,
              -0.06737255472372544, 0.3861100668227614, 0.8127236354494134,
              0.41700518442324086, -0.07648859907828065,
              -0.059434418646431994, 0.02368017194684787,
              0.005611434819368951, -0.0018232088709110373,
              -0.0007205494455202785],
    "coif3": [-0.0037935128646718963, 0.007782596426165859,
              0.023452696143545976, -0.06577191128439741,
              -0.06112339000570599, 0.40517690241629367, 0.7937772226278721,
              0.42848347636808937, -0.07179982161817611,
              -0.0823019270996539, 0.034555027571057315,
              0.015880544861198678, -0.00900797613543506,
              -0.002574517687762439, 0.001117518770567916,
              0.0004662169597979529, -7.098330250693364e-05,
              -3.459977318497693e-05],
    "coif4": [0.0008923139308015434, -0.001629492473379725,
              -0.0073461681358152064, 0.01606894751033472,
              0.02668230524954951, -0.08126671154706777,
              -0.05607732045026825, 0.4153084295272933, 0.7822389349389027,
              0.43438603006516985, -0.06662747212965847,
              -0.09622042220747229, 0.03933442194575798,
              0.025082252241492325, -0.015211727683994446,
              -0.005658283503166019, 0.003751434507566242,
              0.0012665610327605129, -0.0005890201895931771,
              -0.0002599743276153757, 6.233885066321267e-05,
              3.1229858971468046e-05, -3.259647365803015e-06,
              -1.7849907767410207e-06],
    "coif5": [-0.0002120761273263406, 0.00035856802928209246,
              0.002178242366716269, -0.004159216925403358,
              -0.010131379959809728, 0.023407898905936975,
              0.028169294518125554, -0.09192048293913757,
              -0.05204609947097083, 0.4215693816685615, 0.7742932831560907,
              0.43798449846154597, -0.062037872629929325,
              -0.10556490832957977, 0.0412879514508262, 0.03267575912371168,
              -0.019758778543947586, -0.009159853950816324,
              0.006761718308198623, 0.0024316574087172634,
              -0.001661688956548616, -0.0006375749959033894,
              0.00030187032684742107, 0.00014036071573842991,
              -4.122186994463779e-05, -2.127128307499251e-05,
              3.7010093387457774e-06, 2.0613467875953164e-06,
              -1.623911144487161e-07, -9.604981534598897e-08],
})


def _cdf97_lowpass():
    """CDF 9/7 lowpass pair by spline factorization (derivation, not
    transcription): split the roots of the degree-3 half-band polynomial —
    the single real root into the 7-tap synthesis factor, the complex pair
    into the 9-tap analysis factor — compose with cos⁴(w/2), normalize each
    sum to sqrt(2).  Reproduces the published JPEG2000 filters to 1e-12."""
    roots = np.roots([20.0, 10.0, 4.0, 1.0])  # 20y³ + 10y² + 4y + 1
    yr = next(r.real for r in roots if abs(r.imag) < 1e-9)
    c1 = next(r for r in roots if r.imag > 1e-9)
    q = np.array([1.0, -1.0 / yr])  # ascending coeffs of (1 - y/yr)
    qt = -20.0 * yr * np.real(np.convolve([-c1, 1.0], [-np.conj(c1), 1.0]))
    y = np.array([-0.25, 0.5, -0.25])  # y(z) = (2 - z - 1/z)/4, centered
    cos4 = np.convolve([0.25, 0.5, 0.25], [0.25, 0.5, 0.25])

    def compose(coeffs_asc):
        res = np.array([coeffs_asc[0]])
        ypow = np.array([1.0])
        for c in coeffs_asc[1:]:
            ypow = np.convolve(ypow, y)
            r2 = np.zeros(len(ypow))
            off = (len(ypow) - len(res)) // 2
            r2[off : off + len(res)] = res
            res = r2 + c * ypow
        h = np.convolve(cos4, res)
        return h * (math.sqrt(2.0) / h.sum())

    return compose(qt), compose(q)  # (9-tap analysis, 7-tap synthesis)


def _cdf53_lowpass():
    """LeGall / CDF 5/3 lowpass pair (exact rationals x sqrt(2))."""
    s = math.sqrt(2.0)
    return (
        np.array([-0.125, 0.25, 0.75, 0.25, -0.125]) * s,
        np.array([0.25, 0.5, 0.25]) * s,
    )


_BIOR_LOWPASS = {"bior4.4": _cdf97_lowpass, "bior2.2": _cdf53_lowpass}

WAVELETS = tuple(sorted(_REC_LO)) + tuple(sorted(_BIOR_LOWPASS))


def _check_pr(dec_lo, dec_hi, syn_lo, syn_hi, n: int = 32) -> bool:
    """Exact perfect-reconstruction probe of a candidate periodized bank:
    analysis windows at even positions, synthesis out[(2k+s) mod n]."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal(n)
    h = n // 2
    ks = np.arange(h)
    a = np.array([sum(dec_lo[i] * x[(2 * k + i) % n] for i in range(len(dec_lo))) for k in ks])
    d = np.array([sum(dec_hi[i] * x[(2 * k + i) % n] for i in range(len(dec_hi))) for k in ks])
    out = np.zeros(n)
    for k in ks:
        for s in range(len(syn_lo)):
            out[(2 * k + s) % n] += syn_lo[s] * a[k] + syn_hi[s] * d[k]
    return bool(np.max(np.abs(out - x)) < 1e-8)


@functools.lru_cache(maxsize=32)
def _banks(wavelet: str):
    """(dec_lo, dec_hi, syn_lo, syn_hi, extra) for ``wavelet``.

    ``extra`` is the number of additional boundary analysis windows per
    side required for exact reconstruction under the extension modes
    (0 for orthogonal banks, 1 for biorthogonal — their dual synthesis
    support reaches one coefficient further past the edge; verified
    numerically, see module tests)."""
    if wavelet in _REC_LO:
        rec_lo = np.array(_REC_LO[wavelet])
        f = len(rec_lo)
        rec_hi = np.array([(-1.0) ** n * rec_lo[f - 1 - n] for n in range(f)])
        dec_lo, dec_hi = rec_lo[::-1].copy(), rec_hi[::-1].copy()
        # orthonormal: synthesis = analysis (adjoint = inverse)
        assert _check_pr(dec_lo, dec_hi, dec_lo, dec_hi)
        return dec_lo, dec_hi, dec_lo, dec_hi, 0
    if wavelet not in _BIOR_LOWPASS:
        raise ValueError(
            f"unknown wavelet {wavelet!r}; available: {list(WAVELETS)}"
        )
    h_dec, h_rec = _BIOR_LOWPASS[wavelet]()
    f = len(h_dec)
    syn_lo = np.zeros(f)
    syn_lo[: len(h_rec)] = h_rec  # left-aligned (the verified layout)
    # Highpass by quadrature modulation; the circular shift of the
    # modulated filter and the output shift (leading zeros, keeping the
    # synthesis length even for the polyphase split) are
    # alignment-dependent, so search the few candidates and keep the one
    # that passes the exact PR probe.
    zeros = 1 if f % 2 else 0
    for s1 in (1.0, -1.0):
        for d1 in range(-4, 5):
            dec_hi = np.array(
                [s1 * (-1.0) ** n * syn_lo[(n + d1) % f] for n in range(f)]
            )
            for s2 in (1.0, -1.0):
                for d2 in range(-4, 5):
                    syn_hi = np.array(
                        [s2 * (-1.0) ** n * h_dec[(n + d2) % f] for n in range(f)]
                    )
                    for z in (zeros, zeros + 2):
                        slo = np.concatenate([np.zeros(z), syn_lo])
                        shi = np.concatenate([np.zeros(z), syn_hi])
                        if _check_pr(h_dec, dec_hi, slo, shi):
                            return h_dec.copy(), dec_hi, slo, shi, 1
    raise AssertionError(f"no PR-satisfying highpass alignment for {wavelet}")


def _extend_idx(n: int, pad: int, mode: str) -> "np.ndarray | None":
    """Host index map realizing the extension mode (None for zero mode)."""
    if mode == "zero":
        return None
    npmode = {"symmetric": "symmetric", "reflect": "reflect",
              "periodic": "wrap"}[mode]
    return np.pad(np.arange(n), pad, mode=npmode)


# ---------------------------------------------------------------------------
# The filter-bank products.  The JAX module gathers (L, F) windows and
# contracts them with the filters in one einsum; a materialised window
# stack is F times the signal, so here each bank is one strided (analysis)
# or plain (synthesis) ``F.conv1d`` over the periodically padded signal,
# which reads the input once: the same sums, at the config's op_precision
# (cuDNN's TF32 flag set around each convolution).
# ---------------------------------------------------------------------------


def _weights(w, like: Tensor) -> Tensor:
    """A (C_out, C_in, F) filter-bank weight on ``like``'s device, kept by
    its contents (``w`` a host array or its content key)."""
    wkey = w if isinstance(w, tuple) else content_key("dwt.w", w)
    return host_table("dwt.w", key_array, wkey, like=like, dtype=real_dtype(like.dtype))


def _conv(x: Tensor, w, stride: int = 1, dilation: int = 1,
          precision: str = "highest") -> Tensor:
    """(…, C_in, L) correlated with the real bank ``w`` (C_out, C_in, F; a
    host array, or its content key, which a traced call names without
    numpy): (…, C_out, L_out), at ``precision`` (the config's
    ``op_precision``); complex data as its real and imaginary parts."""
    if x.is_complex():
        return torch.complex(_conv(x.real, w, stride, dilation, precision),
                             _conv(x.imag, w, stride, dilation, precision))
    lead = x.shape[:-2]
    xb = x.reshape((-1,) + tuple(x.shape[-2:]))
    out = convolution(xb, _weights(w, x), stride=stride, dilation=dilation, precision=precision)
    return out.reshape(lead + out.shape[-2:])


def _inexact(x: Tensor) -> Tensor:
    # int samples would truncate the filters to 0
    return x if (x.is_floating_point() or x.is_complex()) else x.to(torch.float32)


def _analysis_weight(wavelet: str):
    """Host prologue (``utils.numerics.on_host``): the content key of the
    (2, 1, F) analysis weight of ``wavelet`` (lowpass, highpass) and its
    ``extra`` boundary windows."""
    dec_lo, dec_hi, _, _, extra = _banks(wavelet)
    return content_key("dwt.w", np.stack([dec_lo, dec_hi])[:, None, :]), extra


def _synthesis_weight(wavelet: str) -> tuple:
    """Host prologue: the content key of ``wavelet``'s (2, 2, F/2)
    periodized synthesis weight (:func:`_polyphase_weight`)."""
    _, _, syn_lo, syn_hi, _ = _banks(wavelet)
    return content_key("dwt.w", _polyphase_weight(syn_lo, syn_hi))


def _dwt_linear(x: Tensor, wavelet: str, mode: str, config: SpectralConfig):
    """Extension-mode analysis: windows at odd offsets of the padded signal
    (pywt-convention lengths (n + F - 1)//2, plus ``extra`` boundary
    windows per side for biorthogonal banks)."""
    wkey, extra = on_host(_analysis_weight, wavelet)
    f = wkey[2][-1]
    n = x.shape[-1]
    pad = f - 1 + 2 * extra
    if mode == "zero":
        xe = F.pad(x, (pad, pad))
    else:
        xe = x[..., host_table("dwt.extend", _extend_idx, n, pad, mode, like=x, dtype=torch.int64)]
    out = _conv(xe[..., None, 1:], wkey, stride=2, precision=config.op_precision)
    return out[..., 0, :], out[..., 1, :]


def _idwt_geometry(wavelet: str, la: int) -> tuple:
    """Host prologue (``utils.numerics.on_host``) of the extension-mode
    synthesis of ``la`` coefficients: (n_out, t_hi, padl, padr)."""
    dec_lo, _, syn_lo, _, extra = _banks(wavelet)
    f = len(dec_lo)
    n_out = 2 * (la - 2 * extra) - f + 2
    if n_out < 1:
        raise ValueError(
            f"coefficient length {la} too short for wavelet {wavelet!r}"
        )
    c = f - 2 + 2 * extra
    u = (len(syn_lo) + 1) // 2
    k0 = [(p + c - (p + c) % 2) // 2 for p in (0, 1)]
    return n_out, (n_out + 1) // 2, u, max(k0) + 1


def _idwt_table(wavelet: str, la: int, which: int) -> np.ndarray:
    """The extension-mode synthesis tables: the (2, U) polyphase taps of the
    lowpass (``which`` 0) and highpass (1) filters, out[2t+p] =
    sum_u syn[2u + par_p]·coef[t + k0_p - u], and (2) the (2, T, U) gather
    t + k0_p - u + padl, clipped into the pad zeros."""
    dec_lo, _, syn_lo, syn_hi, extra = _banks(wavelet)
    c = len(dec_lo) - 2 + 2 * extra
    u = (len(syn_lo) + 1) // 2
    n_out, t_hi, padl, padr = _idwt_geometry(wavelet, la)
    taps = np.zeros((2, 2, u))
    k0 = [0, 0]
    for p in (0, 1):
        par = (p + c) % 2
        k0[p] = (p + c - par) // 2
        for i, syn in enumerate((syn_lo, syn_hi)):
            taps[i, p, : len(syn[par::2])] = syn[par::2]
    if which < 2:
        return taps[which]
    tt = np.arange(t_hi)[None, :, None]
    uu = np.arange(u)[None, None, :]
    kk = np.array(k0)[:, None, None]
    return np.clip(tt + kk - uu + padl, 0, la + padl + padr - 1)


def _idwt_linear(a: Tensor, d: Tensor, wavelet: str, config: SpectralConfig):
    """Extension-mode synthesis: out[m] = sum_s syn[s]·coef[(m + F - 2 +
    2·extra - s)/2] over parity-matching taps — the zero-extended polyphase
    gather; returns the pywt-canonical 2·(La - 2·extra) - F + 2 samples."""
    la = a.shape[-1]
    n_out, t_hi, padl, padr = on_host(_idwt_geometry, wavelet, la)
    ap = F.pad(a, (padl, padr))
    dp = F.pad(d, (padl, padr))
    gidx = host_table("dwt.idwt", _idwt_table, wavelet, la, 2, like=a, dtype=torch.int64)
    dtype = real_dtype(a.dtype)
    lo_t = host_table("dwt.idwt", _idwt_table, wavelet, la, 0, like=a, dtype=dtype)
    hi_t = host_table("dwt.idwt", _idwt_table, wavelet, la, 1, like=a, dtype=dtype)
    out = (ap[..., gidx] * lo_t[:, None, :]).sum(-1) + (dp[..., gidx] * hi_t[:, None, :]).sum(-1)
    out = out.transpose(-1, -2).reshape(out.shape[:-2] + (2 * t_hi,))
    return out[..., :n_out]


def dwt(
    x, wavelet: str = "db2", mode: str = "periodization", *,
    axis: int = -1,
    config: SpectralConfig = DEFAULT_CONFIG,
):
    """One analysis level: (…, N) -> (approx, detail) along ``axis``.

    ``mode="periodization"`` (default) needs even N and halves the length;
    the extension modes follow pywt length conventions (module docstring)."""
    x = as_tensor(x)
    if x.ndim < 1:
        raise ValueError("dwt needs at least a 1-D signal")
    if not -x.ndim <= axis < x.ndim:
        raise ValueError(f"axis {axis} out of range for {x.ndim}-D input")
    if axis % x.ndim != x.ndim - 1:
        a, d = dwt(torch.movedim(x, axis, -1), wavelet, mode, config=config)
        return torch.movedim(a, -1, axis), torch.movedim(d, -1, axis)
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {_MODES}, got {mode!r}")
    x = _inexact(x)
    n = x.shape[-1]
    if n < 1:
        raise ValueError("dwt needs a non-empty signal")
    if mode != "periodization":
        return _dwt_linear(x, wavelet, mode, config)
    if n < 2 or n % 2:
        raise ValueError(
            f"mode='periodization' needs an even length >= 2, got {n}"
        )
    return periodized_astep(x, on_host(_analysis_weight, wavelet)[0], config)


def periodized_astep(x, filt, config: SpectralConfig):
    """One periodized analysis level along the last axis with a stacked
    (2, F) decimating filter bank (a host array, or the content key of its
    (2, 1, F) weight): (…, N) -> ((…, N/2), (…, N/2)),
    out[c, k] = Σ_f filt[c, f]·x[(2k + f) mod N] — one stride-2 convolution
    of the periodically padded signal.  The analysis step shared by
    ``dwt(mode="periodization")`` and the dual-tree transform
    (:mod:`.dtcwt`)."""
    if not isinstance(filt, tuple):
        filt = filt[:, None, :]
    f = filt[2][-1] if isinstance(filt, tuple) else filt.shape[-1]
    out = _conv(pad_last(x, 0, f - 1, mode="wrap")[..., None, :], filt,
                stride=2, precision=config.op_precision)
    return out[..., 0, :], out[..., 1, :]


def idwt(
    a, d, wavelet: str = "db2", mode: str = "periodization", *,
    axis: int = -1,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """Inverse of :func:`dwt` (exact; synthesis filters are the orthonormal
    adjoint or the verified biorthogonal duals).

    Periodization: polyphase x[2t+p] = sum_j syn[2j+p]·coef[(t-j) mod H];
    extension modes: zero-extended polyphase gather (module docstring)."""
    a, d = as_tensors(a, d)
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {_MODES}, got {mode!r}")
    if a.ndim >= 1 and not -a.ndim <= axis < a.ndim:
        raise ValueError(f"axis {axis} out of range for {a.ndim}-D input")
    if a.ndim >= 1 and axis % a.ndim != a.ndim - 1:
        out = idwt(torch.movedim(a, axis, -1), torch.movedim(d, axis, -1),
                   wavelet, mode, config=config)
        return torch.movedim(out, -1, axis)
    if a.ndim < 1 or d.ndim < 1 or a.shape != d.shape or a.shape[-1] < 1:
        raise ValueError("approx/detail must share a non-empty >= 1-D shape")
    a, d = _inexact(a), _inexact(d)
    if mode != "periodization":
        return _idwt_linear(a, d, wavelet, config)
    return _periodized_sstep(a, d, on_host(_synthesis_weight, wavelet), config)


def _polyphase_weight(syn_lo: np.ndarray, syn_hi: np.ndarray) -> np.ndarray:
    """weight[p, c, j'] = syn_c[2(half-1-j') + p]: correlation with the
    reversed phases is the polyphase convolution."""
    return np.stack([np.stack([syn_lo[p::2][::-1], syn_hi[p::2][::-1]]) for p in (0, 1)])


def periodized_sstep(
    a, d, syn_lo: np.ndarray, syn_hi: np.ndarray, config: SpectralConfig
):
    """One periodized synthesis level (inverse of :func:`periodized_astep`):
    polyphase x[2t+p] = sum_j syn[2j+p]·coef[(t-j) mod H] — one convolution
    of the periodically padded (a, d) pair with both phases of both filters.
    Shared by ``idwt(mode="periodization")`` and the dual-tree transform."""
    return _periodized_sstep(a, d, _polyphase_weight(syn_lo, syn_hi), config)


def _periodized_sstep(a, d, w, config: SpectralConfig):
    """:func:`periodized_sstep` with the (2, 2, F/2) polyphase weight ``w``
    (a host array or its content key)."""
    h = a.shape[-1]
    half = w[2][-1] if isinstance(w, tuple) else w.shape[-1]
    ad = pad_last(torch.stack(torch.broadcast_tensors(a, d), dim=-2), half - 1, 0, mode="wrap")
    # (…, 2, H): phase p along the second-to-last axis
    out = _conv(ad, w, precision=config.op_precision)
    return out.transpose(-1, -2).reshape(out.shape[:-2] + (2 * h,))


def wavedec(
    x, wavelet: str = "db2", level: int = 1, mode: str = "periodization", *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> List[Tensor]:
    """Multilevel analysis: returns [a_L, d_L, d_{L-1}, …, d_1] (PyWavelets
    ordering).  With periodization the length must divide 2^level."""
    x = as_tensor(x)
    if level < 1:
        raise ValueError(f"level must be >= 1, got {level}")
    if mode == "periodization" and x.shape[-1] % (1 << level):
        raise ValueError(
            f"length {x.shape[-1]} not divisible by 2^level = {1 << level}"
        )
    details: List[Tensor] = []
    a = x
    for _ in range(level):
        a, dd = dwt(a, wavelet, mode, config=config)
        details.append(dd)
    return [a] + details[::-1]


def waverec(
    coeffs: Sequence[Tensor], wavelet: str = "db2",
    mode: str = "periodization", *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """Inverse of :func:`wavedec` (trims the canonical odd extra sample of
    the extension modes against the next level's expected length)."""
    if len(coeffs) < 2:
        raise ValueError("need [approx, detail, …] with at least one detail")
    a = as_tensor(coeffs[0])
    for dd in coeffs[1:]:
        dd = as_tensor(dd, a.device)
        if a.shape[-1] == dd.shape[-1] + 1:
            a = a[..., :-1]  # canonical odd-length extra sample
        a = idwt(a, dd, wavelet, mode, config=config)
    return a


def dwt2(
    x, wavelet: str = "db2", mode: str = "periodization", *,
    config: SpectralConfig = DEFAULT_CONFIG,
):
    """Separable 2-D analysis over the last two axes:
    (…, H, W) -> (LL, (LH, HL, HH)) (PyWavelets dwt2 ordering: LH =
    horizontal detail = lowpass rows / highpass columns applied along H)."""
    x = as_tensor(x)
    if x.ndim < 2:
        raise ValueError("dwt2 needs >= 2-D input")
    # rows (last axis), then columns (second-to-last)
    lo, hi = dwt(x, wavelet, mode, config=config)
    out = []
    for band in (lo, hi):
        a, d = dwt(band.transpose(-1, -2), wavelet, mode, config=config)
        out.append((a.transpose(-1, -2), d.transpose(-1, -2)))
    (ll, lh), (hl, hh) = out
    return ll, (lh, hl, hh)


def idwt2(
    ll, details, wavelet: str = "db2", mode: str = "periodization", *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """Inverse of :func:`dwt2`."""
    lh, hl, hh = details
    ll, lh, hl, hh = as_tensors(ll, lh, hl, hh)
    cols = []
    for a, d in ((ll, lh), (hl, hh)):
        out = idwt(a.transpose(-1, -2), d.transpose(-1, -2), wavelet, mode, config=config)
        cols.append(out.transpose(-1, -2))
    return idwt(cols[0], cols[1], wavelet, mode, config=config)


def _swt_axis(v: Tensor, filt: np.ndarray, up: int, precision: str) -> Tensor:
    """Undecimated analysis along the last axis with the bank upsampled by
    ``up``: (…, N) -> (…, 2, N), out[c, t] = Σ_f filt[c, f]·v[(t + up·f) mod N]."""
    f = filt.shape[-1]
    return _conv(pad_last(v, 0, up * (f - 1), mode="wrap")[..., None, :], filt[:, None, :],
                 dilation=up, precision=precision)


def _iswt_axis(lo_band: Tensor, hi_band: Tensor, syn_lo, syn_hi, up: int,
               precision: str) -> Tensor:
    """The undecimated dual-frame identity along the last axis:
    (Σ_s syn_lo[s]·lo[(t − up·s) mod N] + syn_hi[s]·hi[(t − up·s) mod N]) / 2."""
    fs = len(syn_lo)
    w = 0.5 * np.stack([syn_lo[::-1], syn_hi[::-1]])[None]  # (1, 2, FS)
    pair = torch.stack(torch.broadcast_tensors(lo_band, hi_band), dim=-2)
    return _conv(pad_last(pair, up * (fs - 1), 0, mode="wrap"), w, dilation=up,
                 precision=precision)[..., 0, :]


def swt(
    x, wavelet: str = "db2", level: int = 1, *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> list:
    """Stationary (undecimated / à trous) wavelet transform, periodic
    boundary: returns [(a_L, d_L), …, (a_1, d_1)] (PyWavelets swt ordering,
    coarsest first), every band length N.

    Level j analyzes with the filters upsampled by 2^(j-1) and NO
    decimation — a shift-invariant redundant frame (one dilated
    convolution a level).  N must be divisible by 2^level."""
    x = as_tensor(x)
    if x.ndim < 1:
        raise ValueError("swt needs at least a 1-D signal")
    x = _inexact(x)
    n = x.shape[-1]
    if level < 1:
        raise ValueError(f"level must be >= 1, got {level}")
    if n < 2 or n % (1 << level):
        raise ValueError(
            f"swt needs length divisible by 2^level = {1 << level}, got {n}"
        )
    dec_lo, dec_hi, _, _, _ = _banks(wavelet)
    filt = np.stack([dec_lo, dec_hi])
    out = []
    a = x
    for j in range(level):
        bands = _swt_axis(a, filt, 1 << j, config.op_precision)
        a = bands[..., 0, :]
        out.append((a, bands[..., 1, :]))
    return out[::-1]


def iswt(
    coeffs: Sequence, wavelet: str = "db2", *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """Inverse of :func:`swt` (exact): per level, the undecimated dual-frame
    identity x = (syn_lo ⋆ a + syn_hi ⋆ d)/2 with the synthesis filters
    upsampled."""
    if len(coeffs) < 1:
        raise ValueError("need at least one (approx, detail) level")
    _, _, syn_lo, syn_hi, _ = _banks(wavelet)
    a = as_tensor(coeffs[0][0])
    level = len(coeffs)
    for lev, (_, d) in enumerate(coeffs):
        j = level - 1 - lev  # upsampling exponent of this level's filters
        a = _iswt_axis(a, as_tensor(d, a.device), syn_lo, syn_hi, 1 << j, config.op_precision)
    return a


def swt2(
    x, wavelet: str = "db2", level: int = 1, *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> list:
    """Separable 2-D stationary wavelet transform over the last two axes:
    [(A_L, (H_L, V_L, D_L)), …, (A_1, (H_1, V_1, D_1))] (PyWavelets swt2
    ordering, coarsest first), every band the input shape.  Both axes must
    divide 2^level."""
    x = as_tensor(x)
    if x.ndim < 2:
        raise ValueError("swt2 needs >= 2-D input")
    x = _inexact(x)
    h, wlen = x.shape[-2], x.shape[-1]
    if level < 1:
        raise ValueError(f"level must be >= 1, got {level}")
    if h % (1 << level) or wlen % (1 << level):
        raise ValueError(
            f"swt2 needs both axes divisible by 2^level, got {(h, wlen)}"
        )
    dec_lo, dec_hi, _, _, _ = _banks(wavelet)
    filt = np.stack([dec_lo, dec_hi])
    out = []
    a = x
    for j in range(level):
        up = 1 << j
        # (…, h, 2, w): lowpass/highpass along w
        rows = _swt_axis(a, filt, up, config.op_precision)
        bands = []
        for r in (rows[..., 0, :], rows[..., 1, :]):
            cols = _swt_axis(r.transpose(-1, -2), filt, up, config.op_precision)  # (…, w, 2, h)
            bands.append((cols[..., 0, :].transpose(-1, -2),
                          cols[..., 1, :].transpose(-1, -2)))
        (aa, hh_), (vv, dd) = bands  # (row-lo, col-lo/hi), (row-hi, …)
        a = aa
        out.append((aa, (hh_, vv, dd)))
    return out[::-1]


def iswt2(
    coeffs: Sequence, wavelet: str = "db2", *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """Inverse of :func:`swt2` (exact, dual-frame identity per axis)."""
    if len(coeffs) < 1:
        raise ValueError("need at least one (A, (H, V, D)) level")
    _, _, syn_lo, syn_hi, _ = _banks(wavelet)
    a = as_tensor(coeffs[0][0])
    level = len(coeffs)
    for lev, (_, (hh_, vv, dd)) in enumerate(coeffs):
        up = 1 << (level - 1 - lev)
        hh_, vv, dd = as_tensors(a, hh_, vv, dd)[1:]
        # invert columns (axis -2) of each row band, then rows
        rlo = _iswt_axis(a.transpose(-1, -2), hh_.transpose(-1, -2),
                         syn_lo, syn_hi, up, config.op_precision).transpose(-1, -2)
        rhi = _iswt_axis(vv.transpose(-1, -2), dd.transpose(-1, -2),
                         syn_lo, syn_hi, up, config.op_precision).transpose(-1, -2)
        a = _iswt_axis(rlo, rhi, syn_lo, syn_hi, up, config.op_precision)
    return a


def wavedec2(
    x, wavelet: str = "db2", level: int = 1, mode: str = "periodization", *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> list:
    """Multilevel 2-D analysis: [LL_L, (LH_L, HL_L, HH_L), …, (…_1)]
    (PyWavelets wavedec2 ordering, coarsest first)."""
    x = as_tensor(x)
    if level < 1:
        raise ValueError(f"level must be >= 1, got {level}")
    if mode == "periodization" and (
        x.shape[-1] % (1 << level) or x.shape[-2] % (1 << level)
    ):
        raise ValueError(
            f"shape {tuple(x.shape[-2:])} not divisible by 2^level = {1 << level}"
        )
    details = []
    a = x
    for _ in range(level):
        a, bands = dwt2(a, wavelet, mode, config=config)
        details.append(bands)
    return [a] + details[::-1]


def waverec2(
    coeffs: Sequence, wavelet: str = "db2", mode: str = "periodization", *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """Inverse of :func:`wavedec2` (trims canonical odd extra rows/columns
    of the extension modes against each level's detail shapes)."""
    if len(coeffs) < 2:
        raise ValueError("need [LL, (LH, HL, HH), …] with at least one level")
    a = as_tensor(coeffs[0])
    for bands in coeffs[1:]:
        lh = bands[0]
        if a.shape[-2] == lh.shape[-2] + 1:
            a = a[..., :-1, :]
        if a.shape[-1] == lh.shape[-1] + 1:
            a = a[..., :-1]
        a = idwt2(a, bands, wavelet, mode, config=config)
    return a


def dwt_max_level(n: int, wavelet: str = "db2") -> int:
    """Maximum useful decomposition level (pywt.dwt_max_level): floor
    log2(n / (dec_len - 1)) with dec_len the even-padded decomposition
    filter length (pywt pads odd biorthogonal filters to even, so e.g.
    bior4.4 counts as 10 taps)."""
    f = len(_banks(wavelet)[0])
    f += f % 2  # pywt dec_len is even-padded
    if n < f - 1 or f <= 1:
        return 0
    return int(math.floor(math.log2(n / (f - 1))))


def wpdec(
    x, wavelet: str = "db2", level: int = 1, *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> list:
    """Wavelet packet decomposition (full binary tree, periodization):
    (…, N) -> list of 2^level bands, each (…, N/2^level), natural
    (Paley) order — band index's bits record the low/high path from the
    root.  2^level must divide N."""
    x = as_tensor(x)
    if level < 1:
        raise ValueError(f"level must be >= 1, got {level}")
    if x.ndim < 1 or x.shape[-1] % (1 << level):
        raise ValueError(
            f"length {x.shape[-1] if x.ndim else 0} not divisible by "
            f"2^level = {1 << level}"
        )
    bands = [x]
    for _ in range(level):
        nxt = []
        for b in bands:
            a, d = dwt(b, wavelet, config=config)
            nxt += [a, d]
        bands = nxt
    return bands


def wprec(
    bands, wavelet: str = "db2", *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """Inverse of :func:`wpdec` (bands in natural order; len power of 2)."""
    bands = list(as_tensors(*bands))
    n = len(bands)
    if n < 2 or n & (n - 1):
        raise ValueError(f"need a power-of-two number of bands, got {n}")
    while len(bands) > 1:
        bands = [
            idwt(bands[i], bands[i + 1], wavelet, config=config)
            for i in range(0, len(bands), 2)
        ]
    return bands[0]


def wpdec2(
    x, wavelet: str = "db2", level: int = 1, *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> list:
    """2-D wavelet packet decomposition (full quad tree, periodization):
    (…, H, W) -> nested list [rows][cols] of 2^level × 2^level subbands,
    each (…, H/2^level, W/2^level), natural (Paley) order per axis —
    the separable product of :func:`wpdec` over rows and columns.
    2^level must divide both H and W."""
    x = as_tensor(x)
    if x.ndim < 2:
        raise ValueError("wpdec2 needs (…, H, W)")
    if level < 1:
        raise ValueError(f"level must be >= 1, got {level}")
    if x.shape[-2] % (1 << level) or x.shape[-1] % (1 << level):
        raise ValueError(
            f"shape {tuple(x.shape[-2:])} not divisible by 2^level = {1 << level}"
        )
    # packet split along columns (last axis), then ONE batched split along
    # rows for all column bands at once (they share a shape)
    col_bands = wpdec(x, wavelet, level, config=config)
    stacked = torch.stack([cb.transpose(-1, -2) for cb in col_bands], dim=0)
    row_bands = wpdec(stacked, wavelet, level, config=config)
    return [
        [rb[j].transpose(-1, -2) for j in range(len(col_bands))]
        for rb in row_bands
    ]


def wprec2(
    bands, wavelet: str = "db2", *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """Inverse of :func:`wpdec2` (nested [rows][cols] grid of subbands)."""
    n_rows = len(bands)
    if n_rows < 2 or n_rows & (n_rows - 1):
        raise ValueError(f"need a power-of-two band grid, got {n_rows} rows")
    n_cols = len(bands[0])
    if n_cols < 2 or n_cols & (n_cols - 1) or any(
        len(row) != n_cols for row in bands
    ):
        raise ValueError(
            "bands must be a rectangular power-of-two grid; got row "
            f"lengths {[len(r) for r in bands]}"
        )
    # one batched row-merge for every column at once (cols stacked axis 0)
    stacked_rows = [
        torch.stack([as_tensor(bands[i][j]).transpose(-1, -2) for j in range(n_cols)], dim=0)
        for i in range(n_rows)
    ]
    merged = wprec(stacked_rows, wavelet, config=config)  # (n_cols, …)
    cols = [merged[j].transpose(-1, -2) for j in range(n_cols)]
    return wprec(cols, wavelet, config=config)


# ---------------------------------------------------------------------------
# Wavelet denoising
# ---------------------------------------------------------------------------


def _soft_hard(d: Tensor, t, mode: str) -> Tensor:
    if mode == "soft":
        return torch.sign(d) * torch.clamp(torch.abs(d) - t, min=0.0)
    if mode == "hard":
        return torch.where(torch.abs(d) > t, d, torch.zeros_like(d))
    raise ValueError(f"mode must be 'soft' or 'hard', got {mode!r}")


def wavelet_denoise(
    x,
    wavelet: str = "db4",
    level: Optional[int] = None,
    *,
    mode: str = "soft",
    method: str = "universal",
    sigma: Optional[float] = None,
    extension: str = "symmetric",
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """Wavelet-shrinkage denoising (MATLAB wden / skimage denoise_wavelet
    class): wavedec → per-level detail thresholding → waverec.

    ``method``: "universal" (VisuShrink, Donoho-Johnstone σ·√(2·ln n), one
    global threshold) or "bayes" (BayesShrink, per-level t = σ²/σ_x with
    σ_x² = max(var(d) − σ², 0); a level whose detail energy is all noise is
    zeroed).  ``sigma`` defaults to the MAD estimate of the finest detail
    band (median |d₁| / 0.6745).  ``mode``: soft or hard thresholding.
    Batched over leading axes.
    """
    x = as_tensor(x)
    n = x.shape[-1]
    if level is None:
        level = max(1, min(4, dwt_max_level(n, wavelet)))
        if extension == "periodization":
            while level > 1 and n % (1 << level):
                level -= 1
    coeffs = wavedec(x, wavelet, level=level, mode=extension, config=config)
    approx, details = coeffs[0], coeffs[1:]
    d_fine = details[-1]
    if sigma is None:
        sigma_v = median(torch.abs(d_fine), dim=-1, keepdim=True) / 0.6745
    else:
        sigma_v = torch.full((), float(sigma), dtype=d_fine.dtype, device=d_fine.device)
    if method == "universal":
        t = sigma_v * np.sqrt(2.0 * np.log(max(n, 2)))
        new_details = [_soft_hard(d, t, mode) for d in details]
    elif method == "bayes":
        new_details = []
        for d in details:
            var_d = torch.mean(d * d, dim=-1, keepdim=True)
            sig_x = torch.sqrt(torch.clamp(var_d - sigma_v**2, min=0.0))
            # all-noise band: threshold above the band maximum kills it
            t = torch.where(sig_x > 0, sigma_v**2 / torch.clamp(sig_x, min=1e-30),
                            torch.amax(torch.abs(d), dim=-1, keepdim=True) + 1.0)
            new_details.append(_soft_hard(d, t, mode))
    else:
        raise ValueError(f"method must be 'universal' or 'bayes', "
                         f"got {method!r}")
    out = waverec([approx] + new_details, wavelet, mode=extension, config=config)
    return out[..., :n]


def wavelet_denoise2(
    x,
    wavelet: str = "db4",
    level: Optional[int] = None,
    *,
    mode: str = "soft",
    method: str = "bayes",
    sigma: Optional[float] = None,
    extension: str = "symmetric",
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """2-D wavelet-shrinkage denoising (skimage denoise_wavelet class) over
    the last two axes, batched over the rest.

    Same estimator family as :func:`wavelet_denoise`: σ from the MAD of the
    finest diagonal band (HH₁ — the band most dominated by noise), then
    VisuShrink ("universal") or per-subband BayesShrink ("bayes", the image
    default) thresholds applied to every detail subband.
    """
    x = as_tensor(x)
    if x.ndim < 2:
        raise ValueError("wavelet_denoise2 needs a >= 2-D input")
    h, w = x.shape[-2:]
    if level is None:
        level = max(1, min(4, dwt_max_level(min(h, w), wavelet)))
        if extension == "periodization":
            while level > 1 and (h % (1 << level) or w % (1 << level)):
                level -= 1
    coeffs = wavedec2(x, wavelet, level=level, mode=extension, config=config)
    approx, detail_levels = coeffs[0], coeffs[1:]
    hh1 = detail_levels[-1][2]
    if sigma is None:
        med = median(torch.abs(hh1.reshape(*hh1.shape[:-2], -1)), dim=-1)
        sigma_v = med[..., None, None] / 0.6745
    else:
        sigma_v = torch.full((), float(sigma), dtype=hh1.dtype, device=hh1.device)
    n_pix = h * w
    new_levels = []
    for bands in detail_levels:
        new_bands = []
        for d in bands:
            if method == "universal":
                t = sigma_v * np.sqrt(2.0 * np.log(max(n_pix, 2)))
            elif method == "bayes":
                var_d = torch.mean(d * d, dim=(-2, -1), keepdim=True)
                sig_x = torch.sqrt(torch.clamp(var_d - sigma_v**2, min=0.0))
                t = torch.where(
                    sig_x > 0, sigma_v**2 / torch.clamp(sig_x, min=1e-30),
                    torch.amax(torch.abs(d), dim=(-2, -1), keepdim=True) + 1.0)
            else:
                raise ValueError(f"method must be 'universal' or 'bayes', "
                                 f"got {method!r}")
            new_bands.append(_soft_hard(d, t, mode))
        new_levels.append(tuple(new_bands))
    out = waverec2([approx] + new_levels, wavelet, mode=extension, config=config)
    return out[..., :h, :w]


def cycle_spin(
    x,
    func,
    max_shifts: int = 7,
    *,
    axes=(-1,),
) -> Tensor:
    """Translation-averaged (cycle-spun) denoising (Coifman-Donoho):
    average ``roll → func → unroll`` over all shift combinations in
    ``range(max_shifts + 1)`` per axis — removes the shift-variance
    artifacts of decimated wavelet thresholding at (max_shifts+1)^len(axes)
    times the cost, vectorized into ONE batched call of ``func`` by
    stacking the shifted copies on a new leading axis.

    ``func`` must be shift-equivariant-intended and batched over leading
    axes (e.g. :func:`wavelet_denoise` / :func:`wavelet_denoise2`).
    """
    x = as_tensor(x)
    axes = tuple(a % x.ndim for a in (axes if isinstance(axes, (tuple, list))
                                      else (axes,)))
    if len(set(axes)) != len(axes):
        raise ValueError("axes must be unique")
    if max_shifts < 0:
        raise ValueError("max_shifts must be >= 0")
    combos = list(itertools.product(range(max_shifts + 1), repeat=len(axes)))
    stack = torch.stack([torch.roll(x, shifts=s, dims=axes) for s in combos], dim=0)
    out = func(stack)
    if out.shape != stack.shape:
        raise ValueError("func must preserve shape for cycle spinning")
    parts = [torch.roll(out[i], shifts=tuple(-v for v in s), dims=axes)
             for i, s in enumerate(combos)]
    return torch.mean(torch.stack(parts, dim=0), dim=0)
