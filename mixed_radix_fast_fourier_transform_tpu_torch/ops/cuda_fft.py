"""Fused Stockham FFT kernel: wrapper, plain PyTorch version and dispatch.

Counterpart of ``mixed_radix_fast_fourier_transform_tpu/ops/pallas_fft.py``.
The kernel (``csrc/stockham_fft.cu``) runs every radix stage of one
transform row inside one thread block's shared memory, so device memory
sees one read and one write per plane; the stage pipeline
(ops/stockham.py) makes a round trip per stage instead.

* :func:`exec_kernel` is the wrapper.  On a CUDA tensor it launches the
  kernel (building it at first use) or raises; on a CPU tensor it runs
  :func:`exec_kernel_reference`.  It counts its launches in ``LAUNCHES``.
* :func:`exec_kernel_reference` is the plain PyTorch version: the same
  factor schedule, twiddle layout and index algebra, stage by stage.
* :func:`maybe_exec_kernel` is the dispatch that ``exec_len`` calls.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from fractions import Fraction
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..plan import device_constants, get_plan
from ..utils.config import DTYPE

Tensor = torch.Tensor

MAX_STAGES = 16        # size of the kernel's by-value stage table
# Dynamic shared memory one block may use on Hopper (227 KB).
SMEM_BYTES = 232_448
# Launches of the CUDA kernel since import (or since a caller reset it).
LAUNCHES = 0


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


def supports(n: int, batch: int = 1) -> bool:
    """Can the fused kernel run a length-``n`` transform?

    The radix schedule must exist (every prime factor <= 7) and one row's
    ping-pong pair of (re, im) planes, 4·n fp32 = 16·n bytes, must fit in
    one block's shared memory: 16·n <= 232,448, so n <= 14,528.  Rows map to
    blocks, so ``batch`` does not limit it."""
    try:
        factors = kernel_factors(n)
    except ValueError:
        return False
    return len(factors) <= MAX_STAGES and 16 * n <= SMEM_BYTES


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
    for every stage with l > 1 (all but the first), in stage order."""
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
    # factors and offsets as the kernel's C int tables
    radix_c: ctypes.Array = dataclasses.field(compare=False, repr=False)
    offsets_c: ctypes.Array = dataclasses.field(compare=False, repr=False)
    _device: Dict = dataclasses.field(default_factory=dict, compare=False, repr=False)


def build_kernel_plan(n: int, sign: int) -> KernelPlan:
    """Schedule and concatenated stage twiddles of length ``n``.  Raises
    ValueError where :func:`supports` refuses ``n``."""
    if not supports(n):
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
        (ctypes.c_int * MAX_STAGES)(*factors),
        (ctypes.c_int * MAX_STAGES)(*offsets),
    )


def _plan_on(n: int, sign: int, device: torch.device):
    """The cached kernel plan of (n, sign) and its twiddles on ``device``."""
    plan = get_plan(n, sign, "kernel")
    return plan, device_constants(plan, device)["tw"]


def exec_kernel_reference(
    xr: Tensor, xi: Tensor, n: int, sign: int
) -> Tuple[Tensor, Tensor]:
    """Plain PyTorch version of the kernel: per stage, reshape (b, f, m', l)
    → twiddle → radix-f combine over p → stack to (b, m', f, l)."""
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


def _check_cuda_planes(xr: Tensor, xi: Tensor, n: int) -> None:
    if xr.device.type != "cuda" or xi.device != xr.device:
        raise ValueError(
            f"the CUDA kernel needs both planes on one CUDA device, got "
            f"{xr.device} and {xi.device}"
        )
    if xr.dtype != DTYPE or xi.dtype != DTYPE:
        raise TypeError(f"the kernel takes float32 planes, got {xr.dtype}, {xi.dtype}")
    if xr.shape != xi.shape or xr.ndim == 0 or xr.shape[-1] != n:
        raise ValueError(
            f"planes must share a shape ending in n={n}, got "
            f"{tuple(xr.shape)} and {tuple(xi.shape)}"
        )
    if not (xr.is_contiguous() and xi.is_contiguous()):
        raise ValueError("the kernel takes contiguous planes")
    if torch.is_grad_enabled() and (xr.requires_grad or xi.requires_grad):
        raise NotImplementedError(
            "the fused kernel has no backward yet; run it under "
            "torch.no_grad() or set SpectralConfig(use_kernel=False)"
        )


def exec_kernel(xr: Tensor, xi: Tensor, n: int, sign: int) -> Tuple[Tensor, Tensor]:
    """Batched unnormalized FFT over the last axis through the fused kernel.

    xr/xi: (..., n) fp32 planes.  A CUDA tensor launches the CUDA kernel on
    the current stream (one block per row); a CPU tensor runs
    :func:`exec_kernel_reference`.  Anything else raises."""
    global LAUNCHES
    if xr.device.type == "cpu" and xi.device.type == "cpu":
        return exec_kernel_reference(xr, xi, n, sign)
    _check_cuda_planes(xr, xi, n)
    if sign not in (-1, 1):
        raise ValueError(f"sign must be -1 or +1, got {sign}")
    from . import _build

    lib = _build.library()
    st, tw = _plan_on(n, sign, xr.device)
    yr = torch.empty_like(xr)
    yi = torch.empty_like(xi)
    rows = xr.numel() // n
    if rows == 0:
        return yr, yi
    with torch.cuda.device(xr.device):
        stream = torch.cuda.current_stream(xr.device).cuda_stream
        code = lib.spectral_stockham_fft(
            xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(),
            tw.data_ptr(), rows, n, sign,
            ctypes.addressof(st.radix_c), ctypes.addressof(st.offsets_c),
            len(st.factors), stream,
        )
    _build.check(lib, code, f"stockham_fft launch (n={n}, rows={rows})")
    LAUNCHES += 1
    return yr, yi


def maybe_exec_kernel(config, n: int, sign: int, xr: Tensor, xi: Tensor):
    """Dispatch for ``exec_len``: run the fused kernel when the config allows
    it (``use_kernel`` None or True) and :func:`supports` accepts the length;
    None means "use the stage pipeline"."""
    if config.use_kernel is False or n <= 1:
        return None
    if not supports(n):
        return None
    return exec_kernel(xr, xi, n, sign)
