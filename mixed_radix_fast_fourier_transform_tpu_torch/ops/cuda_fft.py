"""Fused Stockham FFT kernel: launch geometry, wrapper, plain PyTorch version
and dispatch.

Counterpart of ``mixed_radix_fast_fourier_transform_tpu/ops/pallas_fft.py``.
The kernel (``csrc/stockham_fft.cu``) runs every radix stage of one
transform row inside one thread block's shared memory, so device memory
sees one read and one write per plane; the stage pipeline
(ops/stockham.py) makes a round trip per stage instead.

* :func:`kernel_geometry` decides, per length, everything the kernel is
  told: threads per row, rows per block, which butterflies each warp runs
  in each stage, the shared-memory swizzle of each stage's output, and the
  shared memory a block needs.  It is plain Python, so the CPU tests check
  it: every butterfly covered once, every exchange free of bank conflicts.
* :func:`exec_kernel` is the wrapper.  It calls the PyTorch operator
  ``torch.ops.mixed_radix_fft.stockham_fft`` (``torch.library.Library``),
  whose CUDA implementation launches the kernel (building it at first use)
  or raises and whose CPU implementation is :func:`exec_kernel_reference`.
  The operator's gradient is itself at the opposite sign on the cotangent
  planes, and its fake implementation gives ``torch.compile`` and
  ``torch.export`` the output planes' shapes, so a traced graph holds the
  kernel as one opaque node that Inductor neither replaces nor decomposes,
  and fuses the elementwise work around it.  Launches are counted in
  ``LAUNCHES``.
* :func:`exec_kernel_reference` is the plain PyTorch version: the same
  factor schedule, twiddle layout and index algebra, stage by stage, in
  fp32 (2-byte planes are widened on the way in and rounded on the way out,
  as the kernel loads and stores them).

The planes are fp32, bf16 or fp16 (``PLANE_DTYPES``); the kernel's shared
memory, twiddles and butterflies are fp32 for all three, so a 2-byte
transform moves half the bytes of an fp32 one and rounds once, at its
store.  float64 never takes the kernel.
* :func:`maybe_exec_kernel` is the dispatch that ``exec_len`` calls.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import math
from fractions import Fraction
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..plan import device_constants, get_plan

Tensor = torch.Tensor

MAX_STAGES = 16        # size of the kernel's by-value stage table
# Dynamic shared memory one block may use on Hopper (227 KB).
SMEM_BYTES = 232_448
WARP = 32              # lanes per warp, and banks of shared memory
# The kernel's instantiations: complex values a thread holds in one stage
# (tried in order; more only where fewer would need over 1024 threads) and
# the launch bounds built for each.
BOUNDS = {8: (256, 512, 1024), 16: (512, 1024), 32: (1024,)}
ELEMS = tuple(BOUNDS)
MAX_THREADS = 1024     # threads per block
MAX_N = 16 * 1024      # longest row: 1024 threads of 16 values (32 pads odd ones)
BLOCK_THREADS = 128    # rows are packed into a block up to this many threads
# Lane maps a stage may use: 0 = linear (lane = butterfly index mod 32),
# c > 0 = tiles of c consecutive j by 32/c consecutive q.
TILE_WIDTHS = (0, 1, 2, 4, 8, 16, 32)
# Shared-memory swizzles, (src, mask): word i lives at i ^ ((i >> src) & mask),
# which permutes the words inside each aligned group of 32.  (0, 0) is none.
SWIZZLES = ((0, 0),) + tuple(
    (src, (1 << w) - 1) for w in (5, 4, 3, 2, 1) for src in range(1, 9)
)
# Launches of the CUDA kernel since import (or since a caller reset it),
# counted by the operator's CUDA implementation: eager and compiled calls
# alike, none for a CUDA-graph replay (the host does not run then).
LAUNCHES = 0
# The plane dtypes the kernel takes, each with its code in the C entry point
# (csrc/stockham_fft.cu: the global-memory element type).
PLANE_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def kernel_factors(n: int) -> Tuple[int, ...]:
    """Radix schedule of the kernel: the 2-adic part as radix 8/4/2 (largest
    first, 4·4 preferred over 8·2), then the odd primes 7/5/3, descending.
    Raises ValueError if a prime factor exceeds 7."""
    if n < 2:
        raise ValueError("the fused kernel needs n >= 2")
    out: List[int] = []
    v = 0
    while n % 2 == 0:
        n //= 2
        v += 1
    for p in (3, 5, 7):
        while n % p == 0:
            out.append(p)
            n //= p
    if n != 1:
        raise ValueError(f"prime factor {n} > 7: not unrollable")
    out.sort(reverse=True)
    eights, rem = divmod(v, 3)
    twos: List[int] = [8] * eights
    if rem == 2:
        twos.append(4)
    elif rem == 1:
        if eights:
            twos[-1] = 4
            twos.append(4)
        else:
            twos.append(2)
    return tuple(twos + out)


# ---------------------------------------------------------------------------
# Launch geometry (mirrors the kernel's index algebra)
# ---------------------------------------------------------------------------


def smem_index(i, swizzle: Tuple[int, int]):
    """Shared-memory word of logical element ``i`` (int or int array) under
    ``swizzle``; the kernel's ``swz``.  A bijection on each aligned group of
    32 words, since it only XORs bits 0..4 with higher bits."""
    src, mask = swizzle
    return i ^ ((i >> src) & mask)


def n_tiles(l: int, mp: int, tile: int) -> int:
    """Warp-wide tiles of a stage with n/f = mp·l butterflies."""
    if tile == 0:
        return -(-mp * l // WARP)
    return -(-l // tile) * -(-mp // (WARP // tile))


def tile_butterflies(l: int, mp: int, tile: int, g, lane):
    """(q, j, valid) of lane ``lane`` of tile ``g``: the kernel's lane map."""
    g = np.asarray(g)
    lane = np.asarray(lane)
    if tile == 0:
        t = g * WARP + lane
        q = t // l
        return q, t - q * l, t < mp * l
    jb = -(-l // tile)
    qb = g // jb
    q = qb * (WARP // tile) + lane // tile
    j = (g - qb * jb) * tile + lane % tile
    return q, j, (q < mp) & (j < l)


def _tile_of(l: int, mp: int, tile: int):
    """Tile of every butterfly t = q·l + j, in t order (the inverse map)."""
    q, j = np.divmod(np.arange(mp * l), l)
    if tile == 0:
        return (q * l + j) // WARP, q, j
    return (q // (WARP // tile)) * -(-l // tile) + j // tile, q, j


def _banks_distinct(tiles: np.ndarray, addrs: np.ndarray, swizzle) -> bool:
    """Do the accesses of each (row of ``addrs``, tile) hit distinct banks?"""
    key = (np.arange(addrs.shape[0])[:, None] * (tiles.max() + 1) + tiles) * WARP
    key = key + smem_index(addrs, swizzle) % WARP
    return int(np.bincount(key.ravel()).max()) <= 1


def stage_addresses(f: int, l: int, mp: int, q, j):
    """Logical element read for input p (rows of the first array) and
    written for output k (rows of the second) by butterflies (q, j)."""
    p = np.arange(f)[:, None]
    q = np.asarray(q)[None, :]
    j = np.asarray(j)[None, :]
    return p * (mp * l) + q * l + j, (q * f + p) * l + j


@dataclasses.dataclass(frozen=True)
class StageGeometry:
    f: int
    l: int
    mp: int
    tile: int                  # lane map, see TILE_WIDTHS
    slots: int                 # tiles each warp runs (ceil(tiles / warps))
    swizzle: Tuple[int, int]   # layout this stage writes (the next reads)


@dataclasses.dataclass(frozen=True)
class KernelGeometry:
    n: int
    threads: int               # per row, a multiple of 32
    rows: int                  # rows per block
    npad: int                  # words per plane: n rounded up to 32
    smem_bytes: int            # dynamic shared memory per block
    elems: int                 # complex values a thread holds (the kernel's E)
    bound: int                 # launch bound of the kernel instantiation
    stages: Tuple[StageGeometry, ...]

    @property
    def warps(self) -> int:
        return self.threads // WARP


def _search(shapes, warps: int, elems: int, reads: Dict, writes: Dict):
    """Lane maps and swizzles for every stage with at most ``warps`` warps
    per row and no bank conflict, or None.  Depth-first over stages; the
    row enters and leaves unswizzled (the row's loads and stores are linear).
    ``reads``/``writes`` cache the bank checks across calls."""
    dead = set()

    def ok(cache, s, tile, swz, which):
        key = (s, tile, swz)
        if key not in cache:
            f, l, mp = shapes[s]
            g, q, j = _tile_of(l, mp, tile)
            cache[key] = _banks_distinct(g, stage_addresses(f, l, mp, q, j)[which], swz)
        return cache[key]

    def walk(s, swz_in):
        if s == len(shapes):
            return [] if swz_in == SWIZZLES[0] else None
        if (s, swz_in) in dead:
            return None
        f, l, mp = shapes[s]
        tiles = [c for c in TILE_WIDTHS if -(-n_tiles(l, mp, c) // warps) <= elems // f]
        tiles.sort(key=lambda c: n_tiles(l, mp, c))
        outs = SWIZZLES[:1] if s == len(shapes) - 1 else SWIZZLES
        for c in tiles:
            if not ok(reads, s, c, swz_in, 0):
                continue
            for swz in outs:
                if ok(writes, s, c, swz, 1):
                    rest = walk(s + 1, swz)
                    if rest is not None:
                        return [(c, swz)] + rest
        dead.add((s, swz_in))
        return None

    return walk(0, SWIZZLES[0])


@functools.lru_cache(maxsize=None)
def kernel_geometry(n: int) -> Optional[KernelGeometry]:
    """The kernel's launch geometry for length ``n``, or None where it cannot
    run it (a prime factor above 7, too many stages, too many threads a row
    or more shared memory than a block has).

    Threads per row are the fewest warps that hold every stage's
    butterflies in ``elems`` complex registers a thread; rows are packed
    into a block up to BLOCK_THREADS threads while shared memory allows."""
    try:
        factors = kernel_factors(n)
    except ValueError:
        return None
    if len(factors) > MAX_STAGES or n > MAX_N:
        return None
    shapes, l = [], 1
    for f in factors:
        shapes.append((f, l, n // (f * l)))
        l *= f
    npad = -(-n // WARP) * WARP
    reads: Dict = {}
    writes: Dict = {}
    for elems in ELEMS:
        least = max(-(-n // (WARP * elems)),
                    max(min(-(-n_tiles(l, mp, c) // (elems // f)) for c in TILE_WIDTHS)
                        for f, l, mp in shapes))
        for warps in range(least, MAX_THREADS // WARP + 1):
            found = _search(shapes, warps, elems, reads, writes)
            if found is not None:
                return _geometry(n, npad, warps, elems, shapes, found)
    return None


def _geometry(n, npad, warps, elems, shapes, found) -> KernelGeometry:
    threads = warps * WARP
    rows = max(1, BLOCK_THREADS // threads)
    while rows > 1 and rows * 8 * npad > SMEM_BYTES:
        rows -= 1
    stages = tuple(
        StageGeometry(f, l, mp, c, -(-n_tiles(l, mp, c) // warps), swz)
        for (f, l, mp), (c, swz) in zip(shapes, found)
    )
    return KernelGeometry(
        n=n, threads=threads, rows=rows, npad=npad,
        smem_bytes=rows * 8 * npad, elems=elems,
        bound=next(b for b in BOUNDS[elems] if b >= threads * rows),
        stages=stages,
    )


@torch.compiler.assume_constant_result
def supports(n: int, batch: int = 1) -> bool:
    """Can the fused kernel run a length-``n`` transform?

    Whatever :func:`kernel_geometry` admits: every prime factor <= 7,
    n <= 16,384, and a bank-conflict-free geometry of at most 1024 threads
    a row (every 7-smooth n up to 16,384 has one).
    Rows map to blocks, so ``batch`` does not limit it.

    While dynamo traces it runs on the host and its answer is a constant of
    the trace (``assume_constant_result``): traced, the geometry search's
    numpy would become data-dependent graph ops, and dynamo would not use
    ``kernel_geometry``'s cache."""
    return kernel_geometry(n) is not None


# ---------------------------------------------------------------------------
# Twiddles and the kernel plan
# ---------------------------------------------------------------------------


def _coeff(num: int, den: int, sign: int):
    """(re, im) of e^(sign·2πi·num/den): exact ints at quarter turns, fp64
    otherwise."""
    frac = Fraction(num % den, den) * sign % 1
    table = {
        Fraction(0): (1, 0),
        Fraction(1, 4): (0, 1),
        Fraction(1, 2): (-1, 0),
        Fraction(3, 4): (0, -1),
    }
    if frac in table:
        return table[frac]
    ang = 2.0 * math.pi * float(frac)
    return math.cos(ang), math.sin(ang)


def _scalar_cmul(wr, wi, zr: Tensor, zi: Tensor) -> Tuple[Tensor, Tensor]:
    """(wr + i·wi) · (zr + i·zi) with strength reduction for exact 0/±1."""
    if wi == 0:
        if wr == 1:
            return zr, zi
        if wr == -1:
            return -zr, -zi
        return wr * zr, wr * zi
    if wr == 0:
        if wi == 1:
            return -zi, zr
        if wi == -1:
            return zi, -zr
        return -wi * zi, wi * zr
    return wr * zr - wi * zi, wr * zi + wi * zr


def stage_twiddles(
    factors: Sequence[int], sign: int, dtype=np.float32
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Per-stage twiddle planes T[p, j] = e^(sign·2πi·p·j/(f·l)), shape (f, l),
    for every stage with l > 1 (all but the first), in stage order.  Row p
    is contiguous in j, so a warp whose lanes run along j reads one run."""
    out = []
    l = 1
    for f in factors:
        if l > 1:
            p = np.arange(f, dtype=np.int64)[:, None]
            j = np.arange(l, dtype=np.int64)[None, :]
            big = f * l
            phase = (p * j) % big
            ang = sign * 2.0 * np.pi * phase.astype(np.float64) / big
            out.append((np.cos(ang).astype(dtype), np.sin(ang).astype(dtype)))
        l *= f
    return out


class _StageParams(ctypes.Structure):
    _fields_ = [(name, ctypes.c_int) for name in (
        "f", "l", "mp", "tile", "slots", "tw", "swz_src", "swz_mask")]


class _Params(ctypes.Structure):
    """The kernel's by-value argument (``Params`` in csrc/stockham_fft.cu)."""
    _fields_ = [("tw", ctypes.c_void_p)] + [
        (name, ctypes.c_int) for name in (
            "n", "npad", "sign", "threads", "rows", "n_stages", "smem", "elems",
            "bound")
    ] + [("st", _StageParams * MAX_STAGES)]


@dataclasses.dataclass(frozen=True)
class KernelPlan:
    """The kernel's schedule for one (n, sign), cached by
    ``plan.get_plan(n, sign, "kernel")`` like every other plan, with its
    twiddle buffer uploaded once per device by ``plan.device_constants``."""

    n: int
    sign: int
    factors: Tuple[int, ...]
    offsets: Tuple[int, ...]   # per stage, into tw; -1 for the first stage
    tw: np.ndarray             # all stage twiddles: per stage re plane, im plane
    geometry: KernelGeometry = dataclasses.field(compare=False, repr=False)
    key: tuple = dataclasses.field(default=(), compare=False, repr=False)
    _device: Dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    def params(self, tw_ptr: int) -> _Params:
        """The kernel's argument with the twiddles at device address tw_ptr."""
        g = self.geometry
        p = _Params(tw_ptr, g.n, g.npad, self.sign, g.threads, g.rows,
                    len(g.stages), g.smem_bytes, g.elems, g.bound)
        for s, (st, off) in enumerate(zip(g.stages, self.offsets)):
            p.st[s] = _StageParams(st.f, st.l, st.mp, st.tile, st.slots, off,
                                   st.swizzle[0], st.swizzle[1])
        return p


def build_kernel_plan(n: int, sign: int) -> KernelPlan:
    """Schedule and concatenated stage twiddles of length ``n``.  Raises
    ValueError where :func:`supports` refuses ``n``."""
    geometry = kernel_geometry(n)
    if geometry is None:
        raise ValueError(f"the fused kernel does not support n={n}")
    factors = kernel_factors(n)
    planes, offsets, at = [], [-1], 0
    for tr, ti in stage_twiddles(factors, sign):
        offsets.append(at)
        planes += [tr.ravel(), ti.ravel()]
        at += 2 * tr.size
    return KernelPlan(
        n, sign, factors, tuple(offsets),
        np.concatenate(planes) if planes else np.zeros(0, np.float32),
        geometry,
    )


def _plan_on(n: int, sign: int, device: torch.device):
    """The cached kernel plan of (n, sign) and its twiddles on ``device``."""
    plan = get_plan(n, sign, "kernel")
    return plan, device_constants(plan, device)["tw"]


def exec_kernel_reference(
    xr: Tensor, xi: Tensor, n: int, sign: int
) -> Tuple[Tensor, Tensor]:
    """Plain PyTorch version of the kernel: per stage, reshape (b, f, m', l)
    → twiddle → radix-f combine over p → stack to (b, m', f, l), in fp32;
    2-byte planes are widened first and the result rounded back to their
    dtype, as the kernel does."""
    if xr.dtype in (torch.bfloat16, torch.float16):
        yr, yi = exec_kernel_reference(xr.float(), xi.float(), n, sign)
        return yr.to(xr.dtype), yi.to(xi.dtype)
    st, tw = _plan_on(n, sign, xr.device)
    batch = xr.shape[:-1]
    b = math.prod(batch)
    yr, yi = xr.reshape(b, n), xi.reshape(b, n)
    l, m = 1, n
    for f, off in zip(st.factors, st.offsets):
        mp = m // f
        x4r = yr.reshape(b, f, mp, l)
        x4i = yi.reshape(b, f, mp, l)
        zs = []
        for p in range(f):
            zr, zi = x4r[:, p], x4i[:, p]
            if off >= 0 and p > 0:
                tr = tw[off + p * l : off + (p + 1) * l]
                ti = tw[off + (f + p) * l : off + (f + p + 1) * l]
                zr, zi = zr * tr - zi * ti, zr * ti + zi * tr
            zs.append((zr, zi))
        outr, outi = [], []
        for k in range(f):
            accr, acci = zs[0]
            for p in range(1, f):
                wr, wi = _coeff(k * p, f, sign)
                cr, ci = _scalar_cmul(wr, wi, zs[p][0], zs[p][1])
                accr, acci = accr + cr, acci + ci
            outr.append(accr)
            outi.append(acci)
        yr = torch.stack(outr, dim=2).reshape(b, n)
        yi = torch.stack(outi, dim=2).reshape(b, n)
        l *= f
        m = mp
    return yr.reshape(*batch, n), yi.reshape(*batch, n)


# ---------------------------------------------------------------------------
# The wrapper
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _Ready:
    """Everything a launch of (n, sign) on one device needs but the data."""

    params: _Params
    address: int               # ctypes.addressof(params)
    tw: Tensor                 # keeps the twiddle buffer alive


# (n, sign, device) -> _Ready; plan.clear_plan_cache empties it with the plans.
_READY: Dict[Tuple[int, int, torch.device], _Ready] = {}


def _ready(n: int, sign: int, device: torch.device) -> _Ready:
    key = (n, sign, device)
    ready = _READY.get(key)
    if ready is None:
        plan, tw = _plan_on(n, sign, device)
        params = plan.params(tw.data_ptr())
        ready = _READY.setdefault(key, _Ready(params, ctypes.addressof(params), tw))
    return ready


def _check_cuda_planes(xr: Tensor, xi: Tensor, n: int) -> None:
    if xr.device.type != "cuda" or xi.device != xr.device:
        raise ValueError(
            f"the CUDA kernel needs both planes on one CUDA device, got "
            f"{xr.device} and {xi.device}"
        )
    if xr.dtype not in PLANE_DTYPES or xi.dtype != xr.dtype:
        raise TypeError(
            f"the kernel takes float32, bfloat16 or float16 planes of one dtype, "
            f"got {xr.dtype}, {xi.dtype}")
    if xr.shape != xi.shape or xr.ndim == 0 or xr.shape[-1] != n:
        raise ValueError(
            f"planes must share a shape ending in n={n}, got "
            f"{tuple(xr.shape)} and {tuple(xi.shape)}"
        )
    if not (xr.is_contiguous() and xi.is_contiguous()):
        raise ValueError("the kernel takes contiguous planes")


# The operator is defined through ``torch.library.Library`` with a kernel
# for each dispatch key, not ``torch.library.custom_op``: on the card the
# latter's Python layers cost more host time per call than the launch
# (``tools/tune.py dispatch``, PERF.md).  Schema: two planes in, two out,
# nothing mutated.
_LIB = torch.library.Library("mixed_radix_fft", "DEF")
_LIB.define("stockham_fft(Tensor xr, Tensor xi, int n, int sign) -> (Tensor, Tensor)")


def _stockham_fft_cuda(xr: Tensor, xi: Tensor, n: int, sign: int) -> Tuple[Tensor, Tensor]:
    """The operator's CUDA implementation: one launch of the CUDA kernel on
    the current stream, on checked CUDA planes, and the one place that
    counts into ``LAUNCHES`` (so a compiled graph's calls count too; a CUDA
    graph's replay counts none).  The ctypes build of ``_build.py`` stays
    the binding; the operator is what lets a graph hold the launch."""
    global LAUNCHES
    _check_cuda_planes(xr, xi, n)
    from . import _build

    lib = _build.library()
    device = xr.device
    ready = _ready(n, sign, device)
    yr = torch.empty_like(xr)
    yi = torch.empty_like(xi)
    rows = xr.numel() // n
    if rows == 0:
        return yr, yi
    # entering torch.cuda.device costs more than the launch; skip it when
    # the tensor's device is already current
    here = device.index == torch.cuda.current_device()
    with contextlib.nullcontext() if here else torch.cuda.device(device):
        code = lib.spectral_stockham_fft(
            xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(), rows,
            PLANE_DTYPES[xr.dtype], torch.cuda.current_stream(device).cuda_stream,
            ready.address)
    if code:
        _build.check(lib, code, f"stockham_fft launch (n={n}, rows={rows})")
    LAUNCHES += 1
    return yr, yi


def _stockham_fft_fake(xr: Tensor, xi: Tensor, n: int, sign: int) -> Tuple[Tensor, Tensor]:
    return torch.empty_like(xr), torch.empty_like(xi)


class _Gradient(torch.autograd.Function):
    """The operator's gradient.  The unnormalized sign-s DFT is linear and
    its matrix symmetric, so its vector-Jacobian product is the sign −s
    transform of the cotangent planes: the same operator at the cotangent's
    dtype, and nothing to save but ``n`` and ``sign``."""

    @staticmethod
    def forward(ctx, xr: Tensor, xi: Tensor, n: int, sign: int):
        ctx.n, ctx.sign = n, sign
        ctx.set_materialize_grads(False)
        with torch._C._AutoDispatchBelowAutograd():
            return torch.ops.mixed_radix_fft.stockham_fft(xr, xi, n, sign)

    @staticmethod
    def backward(ctx, gr: Optional[Tensor], gi: Optional[Tensor]):
        if gr is None and gi is None:
            return None, None, None, None
        # a cotangent may be missing (a plane nobody used), expanded from a
        # scalar (sum, mean) or a strided view (flip, slices): the kernel
        # takes dense planes only
        gr = torch.zeros_like(gi) if gr is None else gr.contiguous()
        gi = torch.zeros_like(gr) if gi is None else gi.contiguous()
        # through the operator with its gradient: a second derivative then
        # works the same way, and the launch is counted
        yr, yi = exec_kernel(gr, gi, ctx.n, -ctx.sign)
        need_r, need_i = ctx.needs_input_grad[:2]
        return (yr if need_r else None), (yi if need_i else None), None, None


def _stockham_fft_autograd(xr: Tensor, xi: Tensor, n: int, sign: int):
    """The operator's autograd kernel: :class:`_Gradient` where a plane needs
    a gradient, else straight to the device's implementation."""
    if torch.is_grad_enabled() and (xr.requires_grad or xi.requires_grad):
        return _Gradient.apply(xr, xi, n, sign)
    with torch._C._AutoDispatchBelowAutograd():
        return torch.ops.mixed_radix_fft.stockham_fft(xr, xi, n, sign)


_LIB.impl("stockham_fft", _stockham_fft_cuda, "CUDA")
_LIB.impl("stockham_fft", exec_kernel_reference, "CPU")
_LIB.impl("stockham_fft", _stockham_fft_autograd, "Autograd")
torch.library.register_fake("mixed_radix_fft::stockham_fft", _stockham_fft_fake, lib=_LIB)


def exec_kernel(xr: Tensor, xi: Tensor, n: int, sign: int) -> Tuple[Tensor, Tensor]:
    """Batched unnormalized FFT over the last axis through the fused kernel,
    differentiable in both planes.

    xr/xi: (..., n) planes of one dtype, fp32, bf16 or fp16; the result has
    their dtype.  A CUDA tensor launches the CUDA kernel on the current
    stream; a CPU tensor runs :func:`exec_kernel_reference`.
    Anything else raises.  The backward pass is this function at ``-sign``
    on the cotangent planes, on either device.  Under ``torch.compile`` and
    ``torch.export`` the call is the operator's node in the graph."""
    if sign not in (-1, 1):
        raise ValueError(f"sign must be -1 or +1, got {sign}")
    if xr.device.type not in ("cpu", "cuda") or xi.device.type not in ("cpu", "cuda"):
        raise ValueError(
            f"the kernel takes CPU or CUDA planes, got {xr.device} and {xi.device}")
    return torch.ops.mixed_radix_fft.stockham_fft(xr, xi, n, sign)


def uses_kernel(config, n: int, x: Tensor) -> bool:
    """Does ``exec_len`` run a length-``n`` transform of ``x`` through the
    fused kernel?  Only where :func:`supports` accepts the length, and then:
    ``use_kernel=True`` always (on a CPU tensor, the kernel's plain
    version); False never; None (the default) on a CUDA tensor, as the JAX
    package's auto route runs its kernel on its chip, and never on a CPU
    tensor, where the stage pipeline ran 3.6-45x faster than the kernel's
    plain version (``tools/tune.py kernel --device cpu`` at n = 64 to
    16,384, PERF.md).  Under ``torch.compile`` and ``torch.export`` the
    same: the graph holds the operator.  The working dtypes fp32, bf16
    and fp16 take it; float64 (``SpectralConfig(dtype=torch.float64)``)
    never does: the kernel computes in fp32, and such a config refuses
    ``use_kernel=True``."""
    if config.use_kernel is False or n <= 1:
        return False
    if config.dtype not in PLANE_DTYPES:
        return False
    if not supports(n):
        return False
    if config.use_kernel is True:
        return True
    return x.device.type == "cuda"


def maybe_exec_kernel(config, n: int, sign: int, xr: Tensor, xi: Tensor):
    """Dispatch for ``exec_len``: the fused kernel where :func:`uses_kernel`
    says so; None means "use the stage pipeline"."""
    if not uses_kernel(config, n, xr):
        return None
    return exec_kernel(xr, xi, n, sign)
