"""Non-uniform FFTs (NUFFT types 1, 2, 3).

Counterpart of ``mixed_radix_fast_fourier_transform_tpu/ops/nufft.py``:
transforms between non-equispaced sample points and regular Fourier modes
(MRI reconstruction, radio astronomy, particle codes).

Conventions (FINUFFT-style, centered modes k = -N//2 … (N-1)//2):

    type 1 (nonuniform -> modes):   f[k] = sum_j c[j] e^{isign·i·k·x[j]}
    type 2 (modes -> nonuniform):   c[j] = sum_k f[k] e^{isign·i·k·x[j]}
    type 3 (nonuniform -> arbitrary frequencies):
                                    f[i] = sum_j c[j] e^{isign·i·s[i]·x[j]}

isign defaults to -1 for types 1 and 3 and +1 for type 2.

Two strategies, selected by ``method``, as in the JAX module:

* ``"dense"``: the exact NUDFT as matrix products at ``op_precision``.  Phases
  come from an error-free fp32 reduction (a Veltkamp-split head and tail of
  x/2π, then an exact int32 k·round(u·4096) mod 4096, :func:`_unit_frac`,
  :func:`_phase_trig`), so the phase error stays at the fp32 floor for
  |k| < 2^16.
* ``"grid"``: Gaussian gridding (Dutt-Rokhlin; Greengard & Lee, SIAM Rev
  2004): spread each point onto 2·msp cells of a power-of-two oversampled
  grid, run the library's FFT (on the card the fused Stockham kernel takes
  every grid length up to 16,384), and deconvolve by the kernel's transform.

The spreading differs from the JAX module's and computes the same sums.
The JAX module spreads "scatter-free" with block one-hot products under
``lax.scan``, a TPU design; here a point's 2·msp taps (per axis) are added
into the grid with ``index_add_`` and read back with a gather, its adjoint.
Both are fp32; both are differentiable.

The dispatch thresholds (``_DENSE_MAX_ENTRIES*``) and the block constants
(``_SPREAD_BLOCK``, ``_POINT_CHUNK``, ``_MAX_BLOCKS``) keep the JAX module's
values, so that ``"auto"`` picks the same strategy in both packages.  They
were measured on a TPU v5e and are no evidence for the card; the block
constants set nothing in the scatter form.

Type 3's fast path reads the extent of concrete points; while a tracer runs
(``torch.compile``, ``torch.export``) the points are not concrete, and, as
the JAX module's ``_infer_axis`` under ``jax.jit``, "auto" without extents
falls back to dense and "fast" without extents raises ValueError.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..utils.config import DEFAULT_CONFIG, DTYPE, SpectralConfig
from ..utils.factorize import next_pow2
from ..utils.metrics import tracing
from ..utils.numerics import (
    as_tensors,
    host_table,
    on_host,
    product,
    two_sum as _twosum,
    veltkamp as _veltkamp,
)
from ..utils.scan import associative_scan
from .fft import fft, fft2, fftn, ifft, ifft2, ifftn

Tensor = torch.Tensor
_CDTYPE = torch.complex64

_TWO_PI = 2.0 * math.pi
# dense phase split: u = x/2pi rounded to 1/_SPLIT; k*_SPLIT*u exact in int32
_SPLIT = 4096
# "auto": dense products up to this many matrix entries (the JAX module's
# TPU v5e crossovers, kept so that both packages choose alike)
_DENSE_MAX_ENTRIES = 1 << 20
_DENSE_MAX_ENTRIES_2D = 1 << 27
_DENSE_MAX_ENTRIES_3D = 1 << 24
# the JAX module's block-spreading constants (TPU v5e); unused by the scatter
_SPREAD_BLOCK = 32
_POINT_CHUNK = 4096
_MAX_BLOCKS = {1: 512, 2: 128, 3: 8}

# 1/(2*pi) as three fp32 pieces (8-9 significant bits each + residual) so the
# products in _unit_frac stay exact in fp32; prepared in fp64 on the host
_INV2PI = 1.0 / _TWO_PI
_C_HI = float(np.float32(int(_INV2PI * 2**11) / 2**11))
_C_MID = float(np.float32(int((_INV2PI - _C_HI) * 2**19) / 2**19))
_C_LO = float(np.float32(_INV2PI - _C_HI - _C_MID))
_INV2PI32 = float(np.float32(_INV2PI))


def _centered_modes(n: int) -> np.ndarray:
    return np.arange(-(n // 2), (n + 1) // 2)


def _points(*xs) -> tuple:
    """Point arrays as fp32 tensors on one device (numpy goes to the card)."""
    return tuple(t.to(DTYPE) for t in as_tensors(*xs))


def _values(v: Tensor) -> Tensor:
    """Strengths or modes in the working precision (complex64 or fp32)."""
    return v.to(_CDTYPE if v.is_complex() else DTYPE)


def _planes(v: Tensor):
    """(re, im) fp32 planes of real or complex ``v``."""
    if v.is_complex():
        return v.real.to(DTYPE), v.imag.to(DTYPE)
    v = v.to(DTYPE)
    return v, torch.zeros_like(v)


def _unit_frac(x: Tensor):
    """frac(x / 2pi) as a head+tail fp32 pair accurate to ~2^-40, through
    the operator ``mixed_radix_nufft::unit_frac`` (:func:`_unit_frac_chain`)."""
    return torch.ops.mixed_radix_nufft.unit_frac(x)


def _unit_frac_chain(x: Tensor):
    """The reduction op by op: x split twice (Veltkamp) and 1/2pi in three
    host pieces make every significant product exact; a TwoSum chain keeps
    the head+tail sum error-free."""
    xh, r1 = _veltkamp(x)
    xm, xl = _veltkamp(r1)
    small = (xh * _C_LO + xm * _C_MID) + (xm * _C_LO + xl * _INV2PI32)
    s, e1 = _twosum(xh * _C_HI, xh * _C_MID)
    s, e2 = _twosum(s, xm * _C_HI)
    u_hi, u_lo = s, (e1 + e2) + small
    # drop the integer part (k is integer, frac(k·u) == frac(k·frac(u)))
    w = torch.floor(u_hi + u_lo)
    return u_hi - w, u_lo


# The phase reduction is one operator (``torch.library``, as the fused
# kernel's is): a graph that dynamo or ``torch.export`` captures holds it as
# one opaque node, whose CPU and CUDA implementations run the error-free
# chain op by op, so no compiler contracts a product and a sum of it into a
# fused multiply-add or reorders it, and a compiled NUFFT computes the
# phases bit-equal to eager.  Its gradient is the chain's: d(u_hi)/dx =
# C_HI + C_MID, d(u_lo)/dx = C_LO (the split and TwoSum tails are flat).
_LIB = torch.library.Library("mixed_radix_nufft", "DEF")
_LIB.define("unit_frac(Tensor x) -> (Tensor, Tensor)")
_LIB.impl("unit_frac", _unit_frac_chain, "CPU")
_LIB.impl("unit_frac", _unit_frac_chain, "CUDA")
torch.library.register_fake("mixed_radix_nufft::unit_frac",
                            lambda x: (torch.empty_like(x), torch.empty_like(x)), lib=_LIB)


def _unit_frac_backward(ctx, g_hi: Tensor, g_lo: Tensor):
    return g_hi * (_C_HI + _C_MID) + g_lo * _C_LO


torch.library.register_autograd("mixed_radix_nufft::unit_frac", _unit_frac_backward, lib=_LIB)


def _phase_trig(k: np.ndarray, x: Tensor, isign: int):
    """(cos, sin) of isign·k·x via exact integer phase reduction: the head
    of u = frac(x/2pi) is split at 1/4096 so k·round(u·4096) reduces exactly
    in int32 (``torch.remainder`` is floor modulo, as ``jnp.mod``) and only
    the small residual k·lo is floating.  |k| must stay below 2^16.
    Returns tensors of shape (len(k),) + x.shape."""
    if np.abs(k).max(initial=0) >= 1 << 16:
        raise ValueError("dense NUFFT phase reduction supports |k| < 65536")
    return _reduced_trig(torch.from_numpy(k.astype(np.int32)).to(x.device), x, isign)


def _modes_trig(n: int, x: Tensor, isign: int):
    """:func:`_phase_trig` of the ``n`` centered modes, whose table is kept
    on the device (and built on the host while dynamo traces)."""
    if n // 2 >= 1 << 16:
        raise ValueError("dense NUFFT phase reduction supports |k| < 65536")
    k = host_table("nufft_modes", _centered_modes, n, like=x, dtype=torch.int32)
    return _reduced_trig(k, x, isign)


def _reduced_trig(k: Tensor, x: Tensor, isign: int):
    u_hi, u_lo = _unit_frac(x)
    m = torch.round(u_hi * _SPLIT)          # half to even, as jnp.round
    lo = (u_hi - m / _SPLIT) + u_lo
    mi = m.to(torch.int32)
    kj = k.reshape((-1,) + (1,) * u_hi.ndim)
    km = torch.remainder(kj * mi[None], _SPLIT)
    theta = _TWO_PI * (km.to(u_hi.dtype) / _SPLIT + kj.to(u_hi.dtype) * lo)
    if isign < 0:
        theta = -theta
    return torch.cos(theta), torch.sin(theta)


def _dense_apply(cos: Tensor, sin: Tensor, vr: Tensor, vi: Tensor,
                 precision: str = "highest") -> Tensor:
    """Σ_m (cos + i·sin)[k, m] · (vr + i·vi)[…, m] as products at
    ``precision`` (the config's ``op_precision``)."""
    fr = product(vr, cos.T, precision) - product(vi, sin.T, precision)
    fi = product(vr, sin.T, precision) + product(vi, cos.T, precision)
    return torch.complex(fr, fi)


def nudft1(x, c, n_modes: int, *, isign: int = -1,
           config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    """Exact type-1 NUDFT as dense products at ``op_precision``: (…, M) -> (…, n_modes)."""
    x, = _points(x)
    c = _values(as_tensors(x, c)[1])
    if x.ndim != 1 or x.shape[0] < 1:
        raise ValueError("x must be a non-empty 1-D point array")
    if c.shape[-1] != x.shape[0]:
        raise ValueError(
            f"strengths last axis {c.shape[-1]} != number of points {x.shape[0]}")
    if n_modes < 1:
        raise ValueError(f"n_modes must be >= 1, got {n_modes}")
    cos, sin = _modes_trig(n_modes, x, isign)  # (N, M)
    return _dense_apply(cos, sin, *_planes(c), config.op_precision)


def nudft2(x, f, *, isign: int = +1,
           config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    """Exact type-2 NUDFT as dense products at ``op_precision``: (…, n_modes) -> (…, M)."""
    x, = _points(x)
    f = _values(as_tensors(x, f)[1])
    if x.ndim != 1 or x.shape[0] < 1:
        raise ValueError("x must be a non-empty 1-D point array")
    if f.shape[-1] < 1:
        raise ValueError("f must be non-empty along the mode axis")
    cos, sin = _modes_trig(f.shape[-1], x, isign)  # (N, M)
    return _dense_apply(cos.T, sin.T, *_planes(f), config.op_precision)


def _msp(eps: float) -> int:
    """Taps per side from the measured accuracy ladder:
    err ~ 10^-(0.91*msp + 0.5)."""
    return int(min(16, max(4, math.ceil((-math.log10(eps) - 0.5) / 0.91) + 1)))


def _grid_params(n_modes: int, eps: float):
    """(mr, tau, msp): a power-of-two oversampled grid (>= 2x), so that
    u_hi·mr is exact in fp32 and the head+tail point survives the map to
    grid coordinates; the Gaussian's tau; taps per side."""
    mr = 1 << (2 * n_modes - 1).bit_length()
    sigma = mr / n_modes
    msp = _msp(eps)
    tau = math.pi * msp / (n_modes * n_modes * sigma * (sigma - 0.5))
    return mr, tau, msp


def _anchor_weights(x: Tensor, mr: int, tau: float, msp: int):
    """Anchor cells i0 (M,, unwrapped, int64) and Gaussian tap weights
    (M, 2msp).  Grid coordinates ride the _unit_frac pair: xi_hi = u_hi·mr
    is exact (mr a power of two), the subtraction of the integer tap index
    is exact (Sterbenz), only the ~2^-40 tail is approximate."""
    u_hi, u_lo = _unit_frac(x)
    xi_hi = u_hi * mr
    xi_lo = u_lo * mr
    i0 = torch.floor(xi_hi + xi_lo).to(torch.int32)
    taps = torch.arange(-msp + 1, msp + 1, dtype=torch.int32, device=x.device)
    idx = i0[:, None] + taps[None, :]
    dist_cells = (xi_hi[:, None] - idx.to(xi_hi.dtype)) + xi_lo[:, None]
    dist = dist_cells * float(np.float32(_TWO_PI / mr))
    w = torch.exp(-(dist * dist) / float(np.float32(4.0 * tau)))
    return i0.long(), w


def _spread_geometry(x: Tensor, mr: int, tau: float, msp: int):
    """Wrapped grid indices (M, 2msp) and Gaussian weights exp(-d²/(4 tau))."""
    i0, w = _anchor_weights(x, mr, tau, msp)
    taps = torch.arange(-msp + 1, msp + 1, device=x.device)
    return torch.remainder(i0[:, None] + taps[None, :], mr), w


def _use_dense(method: str, n_entries: int, max_modes: int,
               limit: int = _DENSE_MAX_ENTRIES) -> bool:
    """Dense when asked, or under "auto" while the matrix fits the crossover
    budget and the phase reduction's |k| < 2^16 bound."""
    if method == "dense":
        return True
    return method == "auto" and n_entries <= limit and max_modes // 2 < (1 << 16)


def _use_dense_2d(method: str, n1: int, n2: int, m: int) -> bool:
    if method == "dense":
        return True
    return (
        method == "auto"
        and n1 * n2 * m <= _DENSE_MAX_ENTRIES_2D
        and max(n1, n2) * m <= _DENSE_MAX_ENTRIES_2D // 8
        and max(n1, n2) // 2 < (1 << 16)
    )


def _deconv(n_modes: int, mr: int, tau: float) -> np.ndarray:
    """Gaussian-kernel deconvolution diagonal h/(2·sqrt(pi·tau))·e^{k²tau}
    for the centered modes (host fp64)."""
    k = _centered_modes(n_modes).astype(np.float64)
    return (_TWO_PI / mr / (2.0 * math.sqrt(math.pi * tau))) * np.exp(k * k * tau)


def _deconv_grid(*axes) -> np.ndarray:
    """The outer product of the per-axis diagonals (n, mr, tau)."""
    out = np.ones(())
    for n, mr, tau in axes:
        out = np.multiply.outer(out, _deconv(n, mr, tau))
    return out


def _deconv_on(like: Tensor, *axes) -> Tensor:
    """:func:`_deconv_grid`, kept on the device of ``like``."""
    return host_table("nufft_deconv", _deconv_grid, *axes, like=like)


def _scatter(flat_idx: Tensor, vals: Tensor, size: int) -> Tensor:
    """grid[…, g] = Σ vals[…, j] over j with flat_idx[j] == g, complex,
    as two fp32 ``index_add_`` planes (atomic adds on the card)."""
    lead = vals.shape[:-1]
    out = []
    for plane in _planes(vals):
        g = plane.new_zeros(lead + (size,))
        out.append(g.index_add(-1, flat_idx, plane))
    return torch.complex(*out)


def _spread(x: Tensor, c: Tensor, mr: int, tau: float, msp: int) -> Tensor:
    """Gaussian spreading of strengths ``c`` (…, M) onto the length-mr
    oversampled grid: each point's 2·msp weighted taps added by scatter, or
    sorted-segment sums past ``_SORTED_MIN_M`` points (never, by default)."""
    if x.shape[0] >= _SORTED_MIN_M and mr >= 2 * msp:
        return _spread_sorted(x, c, mr, tau, msp)
    idx, w = _spread_geometry(x, mr, tau, msp)
    vals = w * c[..., :, None]                      # (…, M, 2msp)
    return _scatter(idx.reshape(-1), vals.reshape(vals.shape[:-2] + (-1,)), mr)


def _interp(u: Tensor, x: Tensor, mr: int, tau: float, msp: int) -> Tensor:
    """Gaussian interpolation of grid values ``u`` (…, mr) at the points:
    the linear adjoint of :func:`_spread`, a gather of each point's taps."""
    idx, w = _spread_geometry(x, mr, tau, msp)
    return torch.sum(u[..., idx] * w, dim=-1)


def _spread_2d(x, y, c, mrs, taus, msp: int) -> Tensor:
    """2-D Gaussian spreading: the separable (2msp)² taps of every point
    added by scatter into the (…, mr1, mr2) grid, one row of taps along the
    first axis at a time (bounds the live (…, M, 2msp) values)."""
    mr1, mr2 = mrs
    if (x.shape[0] >= _SORTED_MIN_M_2D and min(mr1, mr2) >= 2 * msp
            and mr1 * mr2 < 1 << 31):
        return _spread_sorted_2d(x, y, c, mrs, taus, msp)
    idx1, w1 = _spread_geometry(x, mr1, taus[0], msp)
    idx2, w2 = _spread_geometry(y, mr2, taus[1], msp)
    re, im = _planes(c)
    lead = c.shape[:-1]
    gr = re.new_zeros(lead + (mr1 * mr2,))
    gi = re.new_zeros(lead + (mr1 * mr2,))
    for t in range(2 * msp):
        flat = (idx1[:, t, None] * mr2 + idx2).reshape(-1)
        w = w1[:, t, None] * w2                          # (M, 2msp)
        gr = gr.index_add(-1, flat, (re[..., :, None] * w).reshape(lead + (-1,)))
        gi = gi.index_add(-1, flat, (im[..., :, None] * w).reshape(lead + (-1,)))
    return torch.complex(gr, gi).reshape(lead + (mr1, mr2))


def _interp_2d(u: Tensor, x, y, mrs, taus, msp: int) -> Tensor:
    """2-D Gaussian interpolation of grid values ``u`` (…, mr1, mr2) at the
    points: the gather adjoint of :func:`_spread_2d`."""
    mr1, mr2 = mrs
    idx1, w1 = _spread_geometry(x, mr1, taus[0], msp)
    idx2, w2 = _spread_geometry(y, mr2, taus[1], msp)
    uf = u.reshape(u.shape[:-2] + (mr1 * mr2,))
    out = None
    for t in range(2 * msp):
        flat = idx1[:, t, None] * mr2 + idx2             # (M, 2msp)
        part = torch.sum(uf[..., flat] * w2, dim=-1) * w1[:, t]
        out = part if out is None else out + part
    return out


def _spread_3d(x, y, z, c, mrs, taus, msp: int) -> Tensor:
    """3-D Gaussian spreading by scatter into the (…, mr1, mr2, mr3) grid,
    one (2msp)² plane of taps at a time."""
    mr1, mr2, mr3 = mrs
    idx1, w1 = _spread_geometry(x, mr1, taus[0], msp)
    idx2, w2 = _spread_geometry(y, mr2, taus[1], msp)
    idx3, w3 = _spread_geometry(z, mr3, taus[2], msp)
    re, im = _planes(c)
    lead = c.shape[:-1]
    size = mr1 * mr2 * mr3
    gr, gi = re.new_zeros(lead + (size,)), re.new_zeros(lead + (size,))
    inner = (idx2[:, :, None] * mr3 + idx3[:, None, :]).reshape(x.shape[0], -1)
    w23 = (w2[:, :, None] * w3[:, None, :]).reshape(x.shape[0], -1)
    for t in range(2 * msp):
        flat = (idx1[:, t, None] * (mr2 * mr3) + inner).reshape(-1)
        w = w1[:, t, None] * w23
        gr = gr.index_add(-1, flat, (re[..., :, None] * w).reshape(lead + (-1,)))
        gi = gi.index_add(-1, flat, (im[..., :, None] * w).reshape(lead + (-1,)))
    return torch.complex(gr, gi).reshape(lead + (mr1, mr2, mr3))


def _interp_3d(u: Tensor, x, y, z, mrs, taus, msp: int) -> Tensor:
    """3-D Gaussian interpolation: the gather adjoint of :func:`_spread_3d`."""
    mr1, mr2, mr3 = mrs
    idx1, w1 = _spread_geometry(x, mr1, taus[0], msp)
    idx2, w2 = _spread_geometry(y, mr2, taus[1], msp)
    idx3, w3 = _spread_geometry(z, mr3, taus[2], msp)
    uf = u.reshape(u.shape[:-3] + (mr1 * mr2 * mr3,))
    inner = (idx2[:, :, None] * mr3 + idx3[:, None, :]).reshape(x.shape[0], -1)
    w23 = (w2[:, :, None] * w3[:, None, :]).reshape(x.shape[0], -1)
    out = None
    for t in range(2 * msp):
        flat = idx1[:, t, None] * (mr2 * mr3) + inner
        part = torch.sum(uf[..., flat] * w23, dim=-1) * w1[:, t]
        out = part if out is None else out + part
    return out


# ---------------------------------------------------------------------------
# Sorted-segment spreading, the JAX module's alternative engine: points
# sorted by anchor cell once; for each of the 2·msp tap offsets the per-cell
# sums are segment sums of the sorted strengths, a double-word prefix sum and
# an error-free boundary difference.  "auto" never takes it (the JAX module
# measured it slower on the TPU); it stays for parity and as a second
# engine the scatter is tested against.
# ---------------------------------------------------------------------------

_SORTED_NEVER = 1 << 62
_SORTED_MIN_M = _SORTED_NEVER
_SORTED_MIN_M_2D = _SORTED_NEVER


def _seg_sum_sorted(v: Tensor, si: Tensor, ei: Tensor) -> Tensor:
    """Segment sums Σ v[…, si[g]:ei[g]] along the last axis of real ``v``
    through a compensated inclusive prefix scan: the (hi, lo) carry keeps
    prefixes to ~eps², and the boundary differences TwoSum the hi words, so
    the O(prefix) magnitudes cancel exactly."""

    def comb(a, b):
        sh, se = _twosum(a[0], b[0])
        lo = se + a[1] + b[1]
        s = sh + lo
        return s, lo - (s - sh)

    vp = torch.cat([v.new_zeros(v.shape[:-1] + (1,)), v], dim=-1)
    hi, lo = associative_scan(comb, (vp, torch.zeros_like(vp)), dim=-1)
    dh, de = _twosum(hi[..., ei], -hi[..., si])
    return dh + (de + (lo[..., ei] - lo[..., si]))


def _seg_sum_sorted_c(v: Tensor, si: Tensor, ei: Tensor) -> Tensor:
    if v.is_complex():
        return torch.complex(_seg_sum_sorted(v.real, si, ei), _seg_sum_sorted(v.imag, si, ei))
    return _seg_sum_sorted(v, si, ei)


def _sorted_cells(cells_raw: Tensor, ncell: int):
    """Sort permutation over the int anchor cells and the (ncell+1,)
    run-boundary array bnd (cell g holds sorted slots bnd[g]:bnd[g+1])."""
    perm = torch.argsort(cells_raw, stable=True)
    cells = cells_raw[perm]
    bnd = torch.searchsorted(
        cells, torch.arange(ncell + 1, dtype=cells.dtype, device=cells.device))
    return perm, bnd


def _spread_sorted(x: Tensor, c: Tensor, mr: int, tau: float, msp: int) -> Tensor:
    """1-D spreading by sorted-cell segment sums: grid[g] = Σ_t segsum over
    the points anchored at (g − t) mod mr of w_t·c; the boundaries for
    offset t are rolls of bnd."""
    i0, w = _anchor_weights(x, mr, tau, msp)
    perm, bnd = _sorted_cells(torch.remainder(i0, mr), mr)
    ws = w[perm]
    cs = c[..., perm]
    s0, e0 = bnd[:-1], bnd[1:]
    grid = None
    for k, t in enumerate(range(-msp + 1, msp + 1)):
        part = _seg_sum_sorted_c(cs * ws[:, k], torch.roll(s0, t), torch.roll(e0, t))
        grid = part if grid is None else grid + part
    return grid


def _spread_sorted_2d(x, y, c, mrs, taus, msp: int) -> Tensor:
    """2-D sorted-segment spreading over the linearized anchor cell: one
    sort, then a loop over the (2msp)² tap-offset pairs, each with the 2-D
    roll of bnd by the offset."""
    mr1, mr2 = mrs
    i1, w1 = _anchor_weights(x, mr1, taus[0], msp)
    i2, w2 = _anchor_weights(y, mr2, taus[1], msp)
    lin = torch.remainder(i1, mr1) * mr2 + torch.remainder(i2, mr2)
    perm, bnd = _sorted_cells(lin, mr1 * mr2)
    w1s, w2s = w1[perm], w2[perm]
    cs = c[..., perm]
    s0 = bnd[:-1].reshape(mr1, mr2)
    e0 = bnd[1:].reshape(mr1, mr2)
    grid = None
    taps = range(-msp + 1, msp + 1)
    for k1, t1 in enumerate(taps):
        for k2, t2 in enumerate(taps):
            sit = torch.roll(s0, (t1, t2), dims=(0, 1)).reshape(-1)
            eit = torch.roll(e0, (t1, t2), dims=(0, 1)).reshape(-1)
            part = _seg_sum_sorted_c(cs * (w1s[:, k1] * w2s[:, k2]), sit, eit)
            grid = part if grid is None else grid + part
    return grid.reshape(c.shape[:-1] + (mr1, mr2))


def _center(spec: Tensor, mr: int, n: int, axis: int = -1) -> Tensor:
    """The centered modes k = -n//2 … (n-1)//2 of a length-mr DFT along
    ``axis`` (wrap-around slice)."""
    spec = torch.movedim(spec, axis, -1)
    half = n // 2
    out = torch.cat([spec[..., mr - half:], spec[..., : n - half]], dim=-1)
    return torch.movedim(out, -1, axis)


def _wrap(fd: Tensor, mr: int, axis: int = -1) -> Tensor:
    """Inverse of :func:`_center`: centered modes onto a length-mr grid
    along ``axis``, the unused band zero."""
    fd = torch.movedim(fd, axis, -1)
    n = fd.shape[-1]
    half = n // 2
    z = fd.new_zeros(fd.shape[:-1] + (mr - n,))
    out = torch.cat([fd[..., half:], z, fd[..., :half]], dim=-1)
    return torch.movedim(out, -1, axis)


def _check_method(method: str, allowed=("auto", "dense", "grid")) -> None:
    if method not in allowed:
        raise ValueError(f"method must be {'|'.join(allowed)}, got {method!r}")


def nufft1(x, c, n_modes: int, *, isign: int = -1, eps: float = 1e-6,
           method: str = "auto", config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    """Type-1 NUFFT: strengths at points -> centered Fourier modes.
    method "dense" (exact products), "grid" (Gaussian gridding + FFT) or
    "auto" (dense while n_modes·M fits the crossover budget)."""
    _check_method(method)
    x, = _points(x)
    c = _values(as_tensors(x, c)[1])
    if x.ndim != 1 or x.shape[0] < 1:
        raise ValueError("x must be a non-empty 1-D point array")
    if c.shape[-1] != x.shape[0]:
        raise ValueError(
            f"strengths last axis {c.shape[-1]} != number of points {x.shape[0]}")
    if n_modes < 1:
        raise ValueError(f"n_modes must be >= 1, got {n_modes}")
    if _use_dense(method, n_modes * x.shape[0], n_modes):
        return nudft1(x, c, n_modes, isign=isign, config=config)
    if isign > 0:  # e^{+ikx} = e^{-ik(-x)}
        x = -x
    mr, tau, msp = _grid_params(n_modes, eps)
    spec = fft(_spread(x, c, mr, tau, msp), config=config)
    centered = _center(spec, mr, n_modes)
    return centered * _deconv_on(x, (n_modes, mr, tau))


def nufft2(x, f, *, isign: int = +1, eps: float = 1e-6, method: str = "auto",
           config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    """Type-2 NUFFT: centered Fourier modes -> values at points."""
    _check_method(method)
    x, = _points(x)
    f = _values(as_tensors(x, f)[1])
    if x.ndim != 1 or x.shape[0] < 1:
        raise ValueError("x must be a non-empty 1-D point array")
    n_modes = f.shape[-1]
    if n_modes < 1:
        raise ValueError("f must be non-empty along the mode axis")
    if _use_dense(method, n_modes * x.shape[0], n_modes):
        return nudft2(x, f, isign=isign, config=config)
    if isign < 0:
        x = -x
    mr, tau, msp = _grid_params(n_modes, eps)
    fd = f * _deconv_on(x, (n_modes, mr, tau))
    u = ifft(_wrap(fd, mr), config=config) * mr  # sum_k fd[k] e^{+i k m h}
    return _interp(u, x, mr, tau, msp)


def _infer_axis(pts: Tensor):
    """(half-width, center) of a concrete point set, read in fp32 as the
    JAX module reads them, or None while a tracer runs, as the JAX module's
    is under ``jax.jit`` (the one copy of the type-3 span inference)."""
    if tracing():
        return None
    ph = pts.detach().cpu().numpy()
    return (
        max(float((ph.max() - ph.min()) / 2.0), 1e-9),
        float((ph.max() + ph.min()) / 2.0),
    )


def _type3_extent(pts, ext):
    """One half-width for the type-3 auto dispatch: the given extent, the
    points' span, or None while a tracer runs (the caller then takes
    dense, as the JAX module does under ``jax.jit``)."""
    if ext is not None:
        return float(ext)
    inf = _infer_axis(pts)
    return None if inf is None else inf[0]


def _fast_axis_setup(pts, ext, ctr, label: tuple):
    """(half-width, center) of one axis of a type-3 fast path: the given
    values, else the points' span; while a tracer runs a missing extent
    raises the JAX module's ValueError (the fast grids need static
    sizes; ``label`` is (the call, the extents it needs))."""
    if ext is not None:
        return float(ext), float(ctr)
    inf = _infer_axis(pts)
    if inf is None:
        on_host(_refuse_traced_span, *label)
    return inf


def _refuse_traced_span(call: str, extents: str) -> None:
    raise ValueError(f"{call} under torch.compile or torch.export needs static extent "
                     f"half-widths {extents} (about the centers)")


def _type3_fast_wins(eps: float, d: int, m: int, k: int, sx) -> bool:
    """The JAX module's cost model for type-3 "auto": dense ≈ 30·K·M against
    fast ≈ 10·G·log2 G + 100·(M+K)·(2·msp)^d, G the inner grid's cells."""
    sigma = 2.0
    msp = _msp(eps)
    g = 1.0
    for p in sx:  # per-axis product S_i · X_i
        n_i = 2 * (int(math.ceil(sigma * p / math.pi)) + msp + 3) + 1
        g *= float(next_pow2(2 * n_i))
    fast = 10.0 * g * math.log2(max(g, 2.0)) + 100.0 * (m + k) * float((2 * msp) ** d)
    return fast < 30.0 * float(m) * float(k)


def _cis(phase: Tensor) -> Tensor:
    return torch.complex(torch.cos(phase), torch.sin(phase))


def _dense_type3(theta: Tensor, isign: int, c: Tensor, precision: str) -> Tensor:
    if isign < 0:
        theta = -theta
    return _dense_apply(torch.cos(theta), torch.sin(theta), *_planes(c), precision)


def _gauss_taps(freq: Tensor, h: float, rho: float, k: int, n: int, msp: int):
    """Clipped grid indices (K, 2msp) of a type-3 target's taps on the inner
    uniform grid of n = 2k+1 modes and their Gaussian weights."""
    taps = torch.arange(-msp + 1, msp + 1, dtype=torch.int32, device=freq.device)
    i0 = torch.round(freq / h).to(torch.int32)
    idx = i0[:, None] + taps[None, :]
    d = freq[:, None] - idx.to(freq.dtype) * h
    w = torch.exp(-(d * d) / (4.0 * rho)) * h
    return torch.clamp(idx + k, 0, n - 1).long(), w


def nufft3(x, c, s, *, isign: int = -1, eps: float = 1e-6, method: str = "dense",
           x_extent=None, s_extent=None, x_center: float = 0.0, s_center: float = 0.0,
           config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    """Type-3 NUFFT (arbitrary frequencies): f[i] = sum_j c[j]
    e^{isign·i·s[i]·x[j]}.  "dense" (default): the exact products, whose
    fp32 phases degrade once |s·x| >> 1e4.  "fast": the two-Gaussian
    Lee-Greengard composition over an inner type-1 NUFFT, O(S·X + M + K);
    its half-widths ``x_extent``/``s_extent`` default to the points' spans.
    "auto": the JAX module's cost model."""
    x, s = _points(x, s)
    c = _values(as_tensors(x, c)[1])
    _check_method(method, ("auto", "dense", "fast"))
    if isign not in (-1, 1):
        raise ValueError(f"isign must be +1 or -1, got {isign}")
    if method == "auto" and x.ndim == 1 and s.ndim == 1:
        ex, es = _type3_extent(x, x_extent), _type3_extent(s, s_extent)
        method = "dense" if ex is None or es is None else (  # traced without extents
            "fast" if _type3_fast_wins(eps, 1, x.shape[0], s.shape[0], (es * ex,)) else "dense")
    elif method == "auto":
        method = "dense"  # shape errors surface in the dense validation
    if method == "fast":
        return _nufft3_fast(x, c, s, isign=isign, eps=eps, x_extent=x_extent,
                            s_extent=s_extent, x_center=x_center, s_center=s_center,
                            config=config)
    if x.ndim != 1 or s.ndim != 1 or x.shape[0] < 1 or s.shape[0] < 1:
        raise ValueError("x and s must be non-empty 1-D arrays")
    if c.shape[-1] != x.shape[0]:
        raise ValueError(
            f"strengths last axis {c.shape[-1]} != number of points {x.shape[0]}")
    return _dense_type3(s[:, None] * x[None, :], isign, c, config.op_precision)


def _nufft3_fast(x, c, s, *, isign, eps, x_extent, s_extent, x_center, s_center,
                 config) -> Tensor:
    """Lee-Greengard type 3: centre both coordinate sets, pre-deconvolve by
    the frequency-side Gaussian, inner type-1 onto a uniform s-grid,
    Gaussian interpolation at the targets."""
    if x.ndim != 1 or x.shape[0] < 1:
        raise ValueError("x must be a non-empty 1-D point array")
    if c.shape[-1] != x.shape[0]:
        raise ValueError(
            f"strengths last axis {c.shape[-1]} != number of points {x.shape[0]}")
    if s.ndim != 1 or s.shape[0] < 1:
        raise ValueError("s must be a non-empty 1-D frequency array")
    if x_extent is None or s_extent is None:
        label = ("nufft3(method='fast')", "x_extent and s_extent")
        X, x0 = _fast_axis_setup(x, None, None, label)
        S, s0 = _fast_axis_setup(s, None, None, label)
    else:
        x0, s0, X, S = float(x_center), float(s_center), float(x_extent), float(s_extent)
    xc = x - x0 if x0 != 0.0 else x
    sc = s - s0 if s0 != 0.0 else s
    h_s = math.pi / (2.0 * X)
    msp = _msp(eps)
    rho = msp * h_s * h_s / (3.0 * math.pi)
    k2 = int(math.ceil((S + msp * h_s) / h_s)) + 2
    n_grid = 2 * k2 + 1
    beta = c * (torch.exp(rho * xc * xc) / (2.0 * math.sqrt(math.pi * rho)))
    if s0 != 0.0:
        beta = beta * _cis(float(isign) * s0 * xc)
    B = nufft1(h_s * xc, beta, n_grid, isign=isign, eps=eps, config=config)
    idx, w = _gauss_taps(sc, h_s, rho, k2, n_grid, msp)
    f = torch.sum(B[..., idx] * w, dim=-1)
    if x0 != 0.0:  # undo the s-centre shift: multiply by e^{isign·i·s·x0}
        f = f * _cis(float(isign) * s * x0)
    return f


# ---------------------------------------------------------------------------
# 2-D NUFFT (types 1 and 2): the MRI / imaging shape.  Dense runs as two
# chained fp32 contractions (never the (n1·n2, M) matrix); grid spreads
# separable Gaussian taps into a power-of-two oversampled 2-D grid and runs
# the library's fft2.
# ---------------------------------------------------------------------------


def _check_points_2d(x, y, c):
    if x.ndim != 1 or y.ndim != 1 or x.shape[0] < 1 or x.shape != y.shape:
        raise ValueError("x and y must be equal-length non-empty 1-D arrays")
    if c is not None and c.shape[-1] != x.shape[0]:
        raise ValueError(
            f"strengths last axis {c.shape[-1]} != number of points {x.shape[0]}")


def nudft1_2d(x, y, c, n_modes, *, isign: int = -1,
              config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    """Exact 2-D type-1 NUDFT, f[k1,k2] = sum_j c[j] e^{isign·i(k1·x_j+k2·y_j)}:
    (…, M) strengths -> (…, n1, n2) centered modes, as two chained
    contractions (peak memory O((n1+n2)·M))."""
    x, y = _points(x, y)
    c = _values(as_tensors(x, c)[1])
    _check_points_2d(x, y, c)
    n1, n2 = int(n_modes[0]), int(n_modes[1])
    if n1 < 1 or n2 < 1:
        raise ValueError(f"n_modes must be positive, got {n_modes}")
    cos1, sin1 = _modes_trig(n1, x, isign)  # (n1, M)
    cos2, sin2 = _modes_trig(n2, y, isign)  # (n2, M)
    cr, ci = _planes(c)
    # t = e^{isign·i·k2·y} * c, per mode row: (…, n2, M) planes
    tr = cos2 * cr[..., None, :] - sin2 * ci[..., None, :]
    ti = sin2 * cr[..., None, :] + cos2 * ci[..., None, :]
    p, trt, tit = config.op_precision, tr.transpose(-1, -2), ti.transpose(-1, -2)
    fr = product(cos1, trt, p) - product(sin1, tit, p)
    fi = product(sin1, trt, p) + product(cos1, tit, p)
    return torch.complex(fr, fi)


def nudft2_2d(x, y, f, *, isign: int = +1,
              config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    """Exact 2-D type-2 NUDFT: (…, n1, n2) centered modes -> (…, M) values."""
    x, y = _points(x, y)
    f = _values(as_tensors(x, f)[1])
    _check_points_2d(x, y, None)
    if f.ndim < 2 or f.shape[-1] < 1 or f.shape[-2] < 1:
        raise ValueError("f must be (…, n1, n2) with non-empty mode axes")
    n1, n2 = f.shape[-2], f.shape[-1]
    cos1, sin1 = _modes_trig(n1, x, isign)  # (n1, M)
    cos2, sin2 = _modes_trig(n2, y, isign)  # (n2, M)
    fr, fi = _planes(f)
    # k1 first: t[…, k2, m] = sum_k1 f[…, k1, k2] e^{isign·i·k1·x_m}
    p, frt, fit = config.op_precision, fr.transpose(-1, -2), fi.transpose(-1, -2)
    tr = product(frt, cos1, p) - product(fit, sin1, p)
    ti = product(frt, sin1, p) + product(fit, cos1, p)
    # then k2 with per-point phases
    cr = (cos2 * tr).sum(-2) - (sin2 * ti).sum(-2)
    ci = (sin2 * tr).sum(-2) + (cos2 * ti).sum(-2)
    return torch.complex(cr, ci)


def nufft1_2d(x, y, c, n_modes, *, isign: int = -1, eps: float = 1e-6,
              method: str = "auto", config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    """2-D type-1 NUFFT: strengths at points -> (…, n1, n2) centered modes."""
    _check_method(method)
    x, y = _points(x, y)
    c = _values(as_tensors(x, c)[1])
    _check_points_2d(x, y, c)
    n1, n2 = int(n_modes[0]), int(n_modes[1])
    if n1 < 1 or n2 < 1:
        raise ValueError(f"n_modes must be positive, got {n_modes}")
    if _use_dense_2d(method, n1, n2, x.shape[0]):
        return nudft1_2d(x, y, c, (n1, n2), isign=isign, config=config)
    if isign > 0:
        x, y = -x, -y
    mr1, tau1, msp = _grid_params(n1, eps)
    mr2, tau2, _ = _grid_params(n2, eps)
    grid = _spread_2d(x, y, c, (mr1, mr2), (tau1, tau2), msp)
    spec = fft2(grid, config=config)
    centered = _center(_center(spec, mr1, n1, axis=-2), mr2, n2)
    return centered * _deconv_on(x, (n1, mr1, tau1), (n2, mr2, tau2))


def nufft2_2d(x, y, f, *, isign: int = +1, eps: float = 1e-6, method: str = "auto",
              config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    """2-D type-2 NUFFT: (…, n1, n2) centered modes -> values at points."""
    _check_method(method)
    x, y = _points(x, y)
    f = _values(as_tensors(x, f)[1])
    _check_points_2d(x, y, None)
    if f.ndim < 2 or f.shape[-1] < 1 or f.shape[-2] < 1:
        raise ValueError("f must be (…, n1, n2) with non-empty mode axes")
    n1, n2 = f.shape[-2], f.shape[-1]
    if _use_dense_2d(method, n1, n2, x.shape[0]):
        return nudft2_2d(x, y, f, isign=isign, config=config)
    if isign < 0:
        x, y = -x, -y
    mr1, tau1, msp = _grid_params(n1, eps)
    mr2, tau2, _ = _grid_params(n2, eps)
    fd = f * _deconv_on(x, (n1, mr1, tau1), (n2, mr2, tau2))
    u = ifft2(_wrap(_wrap(fd, mr1, axis=-2), mr2), config=config) * (mr1 * mr2)
    return _interp_2d(u, x, y, (mr1, mr2), (tau1, tau2), msp)


def _cg(apply_normal, rhs: Tensor, iters: int, mode_axes: int) -> Tensor:
    """Fixed-iteration conjugate gradient (a loop of ``iters`` steps, the
    JAX module's ``lax.scan``) for the Hermitian positive-semidefinite
    normal equations, batched over the axes before the last ``mode_axes``."""
    axes = tuple(range(-mode_axes, 0))

    def vdot(a, b):
        return torch.sum(torch.real(torch.conj(a) * b), dim=axes, keepdim=True)

    f, r, p = torch.zeros_like(rhs), rhs, rhs
    rs = vdot(rhs, rhs)
    for _ in range(iters):
        ap = apply_normal(p)
        denom = vdot(p, ap)
        alpha = rs / torch.where(denom == 0, torch.ones_like(denom), denom)
        f = f + alpha * p
        r = r - alpha * ap
        rs_new = vdot(r, r)
        beta = rs_new / torch.where(rs == 0, torch.ones_like(rs), rs)
        p = r + beta * p
        rs = rs_new
    return f


def _lsq_weights(x: Tensor, b: Tensor, weights):
    """(W·b, the weights as real values) with unit weights by default."""
    if weights is None:
        return b, torch.ones(x.shape[0], dtype=DTYPE, device=x.device)
    w = as_tensors(x, weights)[1].to(DTYPE)
    if tuple(w.shape) != (x.shape[0],):
        raise ValueError("weights must have shape (len(x),)")
    return b * w, w


def _embed(tt: Tensor, n: int, axis: int) -> Tensor:
    """The Toeplitz sequence t_{-(n-1)} … t_{n-1} along ``axis`` as the
    first column of a length-2n circulant."""
    tt = torch.movedim(tt, axis, -1)
    out = torch.cat([tt[..., n - 1:], tt.new_zeros(tt.shape[:-1] + (1,)), tt[..., : n - 1]], dim=-1)
    return torch.movedim(out, -1, axis)


def _lsq_solve(t: Tensor, rhs: Tensor, ns, damp: float, iters: int, config) -> Tensor:
    """CG on the normal equations, whose (multi-level) Toeplitz operator
    with generating sequence ``t`` embeds in a (2n_i)… circulant: each
    application is one padded forward and inverse engine FFT."""
    d = len(ns)
    axes = tuple(range(-d, 0))
    for i, n in enumerate(ns):
        t = _embed(t, n, i - d)
    C = fftn(t, axes=axes, config=config)

    def apply_normal(v):
        pad = []
        for n in reversed(ns):
            pad += [0, n]
        vp = torch.nn.functional.pad(v, pad)
        out = ifftn(C * fftn(vp, axes=axes, config=config), axes=axes, config=config)
        out = out[(Ellipsis,) + tuple(slice(0, n) for n in ns)]
        if damp:
            out = out + float(damp) * v
        return out

    return _cg(apply_normal, rhs, iters, mode_axes=d)


def nufft_lsq(x, b, n_modes: int, *, weights=None, damp: float = 0.0, iters: int = 30,
              isign: int = +1, eps: float = 1e-6, method: str = "auto",
              config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    """Least-squares inverse NUFFT: Fourier modes from non-uniform samples,
    min_f sum_j w_j |sum_k f_k e^{isign·i·k·x_j} - b_j|^2 (+ damp·|f|^2).
    The normal operator A^H W A is Toeplitz and embeds in a circulant of
    length 2·n_modes; ``iters`` CG steps, batched over leading axes of ``b``;
    the set-up is two type-1 NUFFTs."""
    x, = _points(x)
    b = _values(as_tensors(x, b)[1])
    if x.ndim != 1 or x.shape[0] < 1:
        raise ValueError("x must be a non-empty 1-D point array")
    if b.shape[-1] != x.shape[0]:
        raise ValueError(
            f"samples last axis {b.shape[-1]} != number of points {x.shape[0]}")
    if n_modes < 1:
        raise ValueError(f"n_modes must be >= 1, got {n_modes}")
    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    wb, wl = _lsq_weights(x, b, weights)
    kw = dict(isign=-isign, eps=eps, method=method, config=config)
    rhs = nufft1(x, wb, n_modes, **kw)
    t = nufft1(x, wl.to(rhs.dtype), 2 * n_modes - 1, **kw)
    return _lsq_solve(t, rhs, (n_modes,), damp, iters, config)


def nufft_lsq_2d(x, y, b, n_modes, *, weights=None, damp: float = 0.0, iters: int = 30,
                 isign: int = +1, eps: float = 1e-6, method: str = "auto",
                 config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    """2-D least-squares inverse NUFFT, the MRI-reconstruction core: the
    normal operator is block-Toeplitz-Toeplitz-block and embeds in a
    (2·n1, 2·n2) circulant."""
    x, y = _points(x, y)
    b = _values(as_tensors(x, b)[1])
    _check_points_2d(x, y, b)
    n1, n2 = int(n_modes[0]), int(n_modes[1])
    if n1 < 1 or n2 < 1:
        raise ValueError(f"n_modes must be positive, got {n_modes}")
    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    wb, wl = _lsq_weights(x, b, weights)
    kw = dict(isign=-isign, eps=eps, method=method, config=config)
    rhs = nufft1_2d(x, y, wb, (n1, n2), **kw)
    t = nufft1_2d(x, y, wl.to(rhs.dtype), (2 * n1 - 1, 2 * n2 - 1), **kw)
    return _lsq_solve(t, rhs, (n1, n2), damp, iters, config)


def nufft_lsq_3d(x, y, z, b, n_modes, *, weights=None, damp: float = 0.0, iters: int = 30,
                 isign: int = +1, eps: float = 1e-6, method: str = "auto",
                 config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    """3-D least-squares inverse NUFFT, the volumetric MRI shape: a
    level-3 block-Toeplitz normal operator in a (2n1, 2n2, 2n3) circulant."""
    x, y, z = _points(x, y, z)
    b = _values(as_tensors(x, b)[1])
    _check_points_3d(x, y, z, b)
    n1, n2, n3 = (int(v) for v in n_modes)
    if min(n1, n2, n3) < 1:
        raise ValueError(f"n_modes must be positive, got {n_modes}")
    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    wb, wl = _lsq_weights(x, b, weights)
    kw = dict(isign=-isign, eps=eps, method=method, config=config)
    rhs = nufft1_3d(x, y, z, wb, (n1, n2, n3), **kw)
    t = nufft1_3d(x, y, z, wl.to(rhs.dtype), (2 * n1 - 1, 2 * n2 - 1, 2 * n3 - 1), **kw)
    return _lsq_solve(t, rhs, (n1, n2, n3), damp, iters, config)


# ---------------------------------------------------------------------------
# 3-D NUFFT (types 1 and 2): volumetric MRI / particle-mesh shape.  Dense
# materializes the (n1, n2, n3, M) complex phase tensor (small sizes and
# oracles); grid spreads separable taps into a power-of-two volume.
# ---------------------------------------------------------------------------


def _check_points_3d(x, y, z, c):
    if x.ndim != 1 or x.shape[0] < 1 or x.shape != y.shape or x.shape != z.shape:
        raise ValueError("x, y, z must be equal-length non-empty 1-D arrays")
    if c is not None and c.shape[-1] != x.shape[0]:
        raise ValueError(
            f"strengths last axis {c.shape[-1]} != number of points {x.shape[0]}")


def _phase_matrix(n: int, x: Tensor, isign: int) -> Tensor:
    return torch.complex(*_modes_trig(n, x, isign))


def _phase_tensor_3d(x, y, z, ns, isign) -> Tensor:
    n1, n2, n3 = ns
    return (_phase_matrix(n1, x, isign)[:, None, None, :]
            * _phase_matrix(n2, y, isign)[None, :, None, :]
            * _phase_matrix(n3, z, isign)[None, None, :, :])


def nudft1_3d(x, y, z, c, n_modes, *, isign: int = -1,
              config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    """Exact 3-D type-1 NUDFT (small sizes / oracle): (…, M) -> (…, n1, n2, n3)."""
    x, y, z = _points(x, y, z)
    c = _values(as_tensors(x, c)[1])
    _check_points_3d(x, y, z, c)
    ns = tuple(int(v) for v in n_modes)
    if min(ns) < 1:
        raise ValueError(f"n_modes must be positive, got {n_modes}")
    E = _phase_tensor_3d(x, y, z, ns, isign)
    out = product(c.to(_CDTYPE), E.reshape(-1, x.shape[0]).T, config.op_precision)
    return out.reshape(c.shape[:-1] + ns)


def nudft2_3d(x, y, z, f, *, isign: int = +1,
              config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    """Exact 3-D type-2 NUDFT (small sizes / oracle): (…, n1, n2, n3) -> (…, M)."""
    x, y, z = _points(x, y, z)
    f = _values(as_tensors(x, f)[1])
    _check_points_3d(x, y, z, None)
    if f.ndim < 3 or min(f.shape[-3:]) < 1:
        raise ValueError("f must be (…, n1, n2, n3) with non-empty mode axes")
    E = _phase_tensor_3d(x, y, z, tuple(f.shape[-3:]), isign)
    return product(f.to(_CDTYPE).reshape(f.shape[:-3] + (-1,)), E.reshape(-1, x.shape[0]),
                   config.op_precision)


def nufft1_3d(x, y, z, c, n_modes, *, isign: int = -1, eps: float = 1e-6,
              method: str = "auto", config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    """3-D type-1 NUFFT: strengths at points -> (…, n1, n2, n3) modes."""
    _check_method(method)
    x, y, z = _points(x, y, z)
    c = _values(as_tensors(x, c)[1])
    _check_points_3d(x, y, z, c)
    n1, n2, n3 = (int(v) for v in n_modes)
    if min(n1, n2, n3) < 1:
        raise ValueError(f"n_modes must be positive, got {n_modes}")
    if _use_dense(method, n1 * n2 * n3 * x.shape[0], max(n1, n2, n3),
                  limit=_DENSE_MAX_ENTRIES_3D):
        return nudft1_3d(x, y, z, c, (n1, n2, n3), isign=isign, config=config)
    if isign > 0:
        x, y, z = -x, -y, -z
    (mr1, tau1, msp), (mr2, tau2, _), (mr3, tau3, _) = (
        _grid_params(n, eps) for n in (n1, n2, n3))
    grid = _spread_3d(x, y, z, c, (mr1, mr2, mr3), (tau1, tau2, tau3), msp)
    spec = fftn(grid, axes=(-3, -2, -1), config=config)
    centered = _center(_center(_center(spec, mr1, n1, axis=-3), mr2, n2, axis=-2), mr3, n3)
    return centered * _deconv_on(x, (n1, mr1, tau1), (n2, mr2, tau2), (n3, mr3, tau3))


def nufft2_3d(x, y, z, f, *, isign: int = +1, eps: float = 1e-6,
              method: str = "auto", config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    """3-D type-2 NUFFT: (…, n1, n2, n3) modes -> values at points."""
    _check_method(method)
    x, y, z = _points(x, y, z)
    f = _values(as_tensors(x, f)[1])
    _check_points_3d(x, y, z, None)
    if f.ndim < 3 or min(f.shape[-3:]) < 1:
        raise ValueError("f must be (…, n1, n2, n3) with non-empty mode axes")
    n1, n2, n3 = f.shape[-3:]
    if _use_dense(method, n1 * n2 * n3 * x.shape[0], max(n1, n2, n3),
                  limit=_DENSE_MAX_ENTRIES_3D):
        return nudft2_3d(x, y, z, f, isign=isign, config=config)
    if isign < 0:
        x, y, z = -x, -y, -z
    (mr1, tau1, msp), (mr2, tau2, _), (mr3, tau3, _) = (
        _grid_params(n, eps) for n in (n1, n2, n3))
    fd = f * _deconv_on(x, (n1, mr1, tau1), (n2, mr2, tau2), (n3, mr3, tau3))
    wrapped = _wrap(_wrap(_wrap(fd, mr1, axis=-3), mr2, axis=-2), mr3)
    u = ifftn(wrapped, axes=(-3, -2, -1), config=config) * (mr1 * mr2 * mr3)
    return _interp_3d(u, x, y, z, (mr1, mr2, mr3), (tau1, tau2, tau3), msp)


def _type3_setup(pts, exts, centers, label: tuple):
    """Per-axis (half-width, centre) of a type-3 fast path and the centred
    coordinates."""
    X, C0, centred = [], [], []
    for p, e, c0 in zip(pts, exts, centers):
        half, ctr = _fast_axis_setup(p, e, c0, label)
        X.append(half)
        C0.append(ctr)
        centred.append(p - ctr if ctr != 0.0 else p)
    return X, C0, centred


def nufft3_2d(x, y, c, s, t, *, isign: int = -1, eps: float = 1e-6, method: str = "dense",
              x_extent=None, y_extent=None, s_extent=None, t_extent=None,
              centers=(0.0, 0.0, 0.0, 0.0),
              config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    """2-D type-3 NUFFT: f[i] = sum_j c[j] e^{isign·i·(s_i·x_j + t_i·y_j)}.
    "dense" (default): the exact (K, M) phase products.  "fast": the
    separable Lee-Greengard composition over an inner 2-D type-1 NUFFT and a
    separable Gaussian gather at the targets; the half-widths default to
    the points' spans (about ``centers`` = (x0, y0, s0, t0) when given)."""
    x, y, s, t = _points(x, y, s, t)
    c = _values(as_tensors(x, c)[1])
    _check_method(method, ("auto", "dense", "fast"))
    if isign not in (-1, 1):
        raise ValueError(f"isign must be +1 or -1, got {isign}")
    _check_points_2d(x, y, c)
    if s.ndim != 1 or s.shape != t.shape or s.shape[0] < 1:
        raise ValueError("s and t must be equal-length non-empty 1-D arrays")
    exts = (x_extent, y_extent, s_extent, t_extent)
    if method == "auto":
        spans = [_type3_extent(p, e) for p, e in zip((x, y, s, t), exts)]
        if any(e is None for e in spans):  # traced without extents: dense only
            method = "dense"
        else:
            x1, x2, s1, s2 = spans
            method = "fast" if _type3_fast_wins(
                eps, 2, x.shape[0], s.shape[0], (s1 * x1, s2 * x2)) else "dense"
    if method == "dense":
        return _dense_type3(s[:, None] * x[None, :] + t[:, None] * y[None, :], isign, c,
                            config.op_precision)
    (X1, X2, S1, S2), (x0, y0, s0, t0), (xc, yc, sc, tc) = _type3_setup(
        (x, y, s, t), exts, centers,
        ("nufft3_2d(method='fast')", "x_extent, y_extent, s_extent and t_extent"))
    msp = _msp(eps)
    h1, h2 = math.pi / (2.0 * X1), math.pi / (2.0 * X2)
    rho1, rho2 = msp * h1 * h1 / (3.0 * math.pi), msp * h2 * h2 / (3.0 * math.pi)
    k1 = int(math.ceil((S1 + msp * h1) / h1)) + 2
    k2 = int(math.ceil((S2 + msp * h2) / h2)) + 2
    n1, n2 = 2 * k1 + 1, 2 * k2 + 1
    beta = c * (torch.exp(rho1 * xc * xc + rho2 * yc * yc)
                / (4.0 * math.pi * math.sqrt(rho1 * rho2)))
    if s0 != 0.0 or t0 != 0.0:  # centre-shift phase on the sources
        beta = beta * _cis(float(isign) * (s0 * xc + t0 * yc))
    B = nufft1_2d(h1 * xc, h2 * yc, beta, (n1, n2), isign=isign, eps=eps, config=config)
    g1, w1 = _gauss_taps(sc, h1, rho1, k1, n1, msp)
    g2, w2 = _gauss_taps(tc, h2, rho2, k2, n2, msp)
    flat = B.reshape(B.shape[:-2] + (-1,))
    f = None
    for p in range(2 * msp):
        part = torch.sum(flat[..., g1[:, p, None] * n2 + g2] * w2, dim=-1) * w1[:, p]
        f = part if f is None else f + part
    if x0 != 0.0 or y0 != 0.0:  # undo the source-centre shift at the targets
        f = f * _cis(float(isign) * (s * x0 + t * y0))
    return f


def nufft3_3d(x, y, z, c, s, t, u, *, isign: int = -1, eps: float = 1e-6,
              method: str = "dense", extents=None, centers=(0.0,) * 6,
              config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    """3-D type-3 NUFFT, f[i] = sum_j c[j] e^{isign·i·(s_i·x_j + t_i·y_j +
    u_i·z_j)}: "dense" one exact (K, M) phase product; "fast" the separable
    Lee-Greengard composition over an inner 3-D type-1 NUFFT.  ``extents``
    is the 6-tuple of half-widths (X1, X2, X3, S1, S2, S3) about ``centers``;
    by default the points' spans."""
    x, y, z, s, t, u = _points(x, y, z, s, t, u)
    c = _values(as_tensors(x, c)[1])
    _check_method(method, ("auto", "dense", "fast"))
    if isign not in (-1, 1):
        raise ValueError(f"isign must be +1 or -1, got {isign}")
    _check_points_3d(x, y, z, c)
    if s.ndim != 1 or s.shape != t.shape or s.shape != u.shape or s.shape[0] < 1:
        raise ValueError("s, t, u must be equal-length non-empty 1-D arrays")
    exts = (None,) * 6 if extents is None else tuple(extents)
    if len(exts) != 6:
        raise ValueError("extents must be a 6-tuple")
    pts = (x, y, z, s, t, u)
    if method == "auto":
        spans = [_type3_extent(p, e) for p, e in zip(pts, exts)]
        if any(e is None for e in spans):  # traced without extents: dense only
            method = "dense"
        else:
            x1, x2, x3, s1, s2, s3 = spans
            method = "fast" if _type3_fast_wins(
                eps, 3, x.shape[0], s.shape[0], (s1 * x1, s2 * x2, s3 * x3)) else "dense"
    if method == "dense":
        theta = s[:, None] * x[None, :] + t[:, None] * y[None, :] + u[:, None] * z[None, :]
        return _dense_type3(theta, isign, c, config.op_precision)
    if len(centers) != 6:
        raise ValueError("extents and centers must be 6-tuples")
    X, C0, (xc, yc, zc, sc, tc, uc) = _type3_setup(
        pts, exts, centers, ("nufft3_3d(method='fast')", "as the 6-tuple extents"))
    x0, y0, z0, s0, t0, u0 = C0
    msp = _msp(eps)
    hs = [math.pi / (2.0 * Xi) for Xi in X[:3]]
    rhos = [msp * h * h / (3.0 * math.pi) for h in hs]
    ks = [int(math.ceil((Si + msp * h) / h)) + 2 for Si, h in zip(X[3:], hs)]
    ns = [2 * k + 1 for k in ks]
    norm = 8.0 * math.pi ** 1.5 * math.sqrt(rhos[0] * rhos[1] * rhos[2])
    beta = c * (torch.exp(rhos[0] * xc * xc + rhos[1] * yc * yc + rhos[2] * zc * zc) / norm)
    if s0 != 0.0 or t0 != 0.0 or u0 != 0.0:
        beta = beta * _cis(float(isign) * (s0 * xc + t0 * yc + u0 * zc))
    B = nufft1_3d(hs[0] * xc, hs[1] * yc, hs[2] * zc, beta, tuple(ns),
                  isign=isign, eps=eps, config=config)
    g1, w1 = _gauss_taps(sc, hs[0], rhos[0], ks[0], ns[0], msp)
    g2, w2 = _gauss_taps(tc, hs[1], rhos[1], ks[1], ns[1], msp)
    g3, w3 = _gauss_taps(uc, hs[2], rhos[2], ks[2], ns[2], msp)
    flat = B.reshape(B.shape[:-3] + (-1,))
    inner = (g2[:, :, None] * ns[2] + g3[:, None, :]).reshape(s.shape[0], -1)
    w23 = (w2[:, :, None] * w3[:, None, :]).reshape(s.shape[0], -1)
    f = None
    for p in range(2 * msp):
        part = torch.sum(flat[..., g1[:, p, None] * (ns[1] * ns[2]) + inner] * w23, dim=-1) * w1[:, p]
        f = part if f is None else f + part
    if x0 != 0.0 or y0 != 0.0 or z0 != 0.0:
        f = f * _cis(float(isign) * (s * x0 + t * y0 + u * z0))
    return f
