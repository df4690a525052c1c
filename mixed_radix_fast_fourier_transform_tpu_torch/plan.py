"""Plan construction and the plan cache.

Counterpart of ``mixed_radix_fast_fourier_transform_tpu/plan.py``.  Plans
are immutable and hold their constants as host numpy arrays, built in fp64
and cast to fp32 exactly as the JAX package builds them, so both packages
run the same stage factors with the same constants.

What the port adds is :func:`device_constants`: the tensors of a plan's
constants on one device, uploaded once per (plan, device) and cached on the
plan, so that a transform on the GPU does not copy its DFT matrices and
twiddles from the host on every call.
"""

from __future__ import annotations

import dataclasses
import math
import threading
from typing import Dict, Tuple

import numpy as np
import torch

from .utils.config import DEFAULT_CONFIG, SpectralConfig
from .utils.factorize import (
    is_prime,
    is_smooth,
    next_fast_len,
    next_pow2,
    plan_stages,
    primitive_root,
)
from .utils.twiddle import chirp, dft_matrix, split_twiddles, twiddle_split

_HOST_DTYPE = np.float32


def _device_cache():
    return dataclasses.field(default_factory=dict, compare=False, repr=False)


@dataclasses.dataclass(frozen=True)
class MixedRadixPlan:
    """Stage schedule for the stage pipeline.

    ``factors`` are dense DFT stage sizes (descending, product = n).
    ``tw_*[i]`` are the Cooley-Tukey split twiddles between stage i and the
    remainder, shape (f_i, prod(factors[i+1:])).  ``butterfly`` runs stages
    of size 2..``butterfly_max`` (powers of two) as elementwise butterflies.
    """

    n: int
    sign: int
    factors: Tuple[int, ...]
    butterfly: bool = False
    butterfly_max: int = 8
    dft_re: Tuple[np.ndarray, ...] = ()
    dft_im: Tuple[np.ndarray, ...] = ()
    tw_re: Tuple[np.ndarray, ...] = ()
    tw_im: Tuple[np.ndarray, ...] = ()
    _device: Dict = _device_cache()


@dataclasses.dataclass(frozen=True)
class BluesteinPlan:
    """Chirp-z plan: X = w ⊙ ifft_M(fft_M(pad(w ⊙ x)) ⊙ Ĉ), with the chirp w
    and the padded chirp spectrum Ĉ (1/m folded in) as plan constants.
    ``inner`` is a forward plan of the padded length m."""

    n: int
    sign: int
    m: int
    inner: MixedRadixPlan = None
    chirp_re: np.ndarray = None
    chirp_im: np.ndarray = None
    spec_re: np.ndarray = None
    spec_im: np.ndarray = None
    _device: Dict = _device_cache()


@dataclasses.dataclass(frozen=True)
class RaderPlan:
    """Rader plan for a prime ``n`` whose ``n−1`` is stage-smooth: the
    nonzero bins are one cyclic convolution of length n−1, computed with two
    inner forward FFTs of length n−1."""

    n: int
    sign: int
    inner: MixedRadixPlan = None  # forward plan of length n−1
    perm_in: np.ndarray = None    # q -> g^q mod n (input gather)
    perm_out: np.ndarray = None   # output bin k (1..n−1) -> conv index m
    spec_re: np.ndarray = None
    spec_im: np.ndarray = None
    _device: Dict = _device_cache()


@dataclasses.dataclass(frozen=True)
class RealPlan:
    """Packed real FFT plan: one half-length complex plan plus the fused
    split/merge coefficients X[k] = P[k]·Z[k mod h] + Q[k]·conj(Z[(h-k) mod h]).
    n must be even."""

    n: int
    sign: int
    inner: object = None
    split_re: np.ndarray = None
    split_im: np.ndarray = None
    p_re: np.ndarray = None
    p_im: np.ndarray = None
    q_re: np.ndarray = None
    q_im: np.ndarray = None
    _device: Dict = _device_cache()


_DEVICE_LOCK = threading.Lock()


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    # index arrays become int64 for torch.index_select
    if np.issubdtype(a.dtype, np.integer):
        a = a.astype(np.int64)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def device_constants(plan, device) -> Dict[str, object]:
    """The plan's array constants as tensors on ``device``, keyed by field
    name (tuples stay tuples).  Uploaded once per (plan, device)."""
    device = torch.device(device)
    with _DEVICE_LOCK:
        consts = plan._device.get(device)
    if consts is not None:
        return consts
    consts = {}
    for f in dataclasses.fields(plan):
        v = getattr(plan, f.name)
        if isinstance(v, np.ndarray):
            consts[f.name] = _upload(v, device)
        elif isinstance(v, tuple) and v and isinstance(v[0], np.ndarray):
            consts[f.name] = tuple(_upload(a, device) for a in v)
    with _DEVICE_LOCK:
        return plan._device.setdefault(device, consts)


def _host(pair) -> Tuple[np.ndarray, np.ndarray]:
    re, im = pair
    return np.asarray(re, dtype=_HOST_DTYPE), np.asarray(im, dtype=_HOST_DTYPE)


def build_mixed_radix_plan(
    n: int, sign: int, config: SpectralConfig = DEFAULT_CONFIG
) -> MixedRadixPlan:
    """Stage plan for a smooth length ``n``: stage split plus per-stage DFT
    matrices and split twiddles as fp64-generated host constants."""
    if sign not in (-1, 1):
        raise ValueError(f"sign must be -1 (forward) or +1 (inverse), got {sign}")
    if n < 1:
        raise ValueError(f"length must be >= 1, got {n}")
    if n == 1 or n <= config.direct_dft_max:
        factors: Tuple[int, ...] = (n,)
    else:
        factors = plan_stages(n, config.max_stage, config.stage_strategy)
    dft_re, dft_im, tw_re, tw_im = [], [], [], []
    for i, f in enumerate(factors):
        wr, wi = _host(dft_matrix(f, sign, np.float64))
        dft_re.append(wr)
        dft_im.append(wi)
        if i < len(factors) - 1:
            n_rem = math.prod(factors[i + 1 :])
            tr, ti = _host(twiddle_split(f, n_rem, f * n_rem, sign, np.float64))
            tw_re.append(tr)
            tw_im.append(ti)
    return MixedRadixPlan(
        n=n,
        sign=sign,
        factors=factors,
        butterfly=config.butterfly != "off",
        butterfly_max=8 if config.butterfly == "8" else 16,
        dft_re=tuple(dft_re),
        dft_im=tuple(dft_im),
        tw_re=tuple(tw_re),
        tw_im=tuple(tw_im),
    )


def _padded_length(n: int, config: SpectralConfig) -> int:
    """The Bluestein padded length, from ``config.pad_mode``."""
    need = 2 * n - 1
    if config.pad_mode == "fast":
        return next_fast_len(need)
    if config.pad_mode == "pow23":
        p2 = next_pow2(need)
        p3 = 3 * next_pow2(-(-need // 3))
        return min(p2, p3)
    return next_pow2(need)


def build_bluestein_plan(
    n: int, sign: int, config: SpectralConfig = DEFAULT_CONFIG
) -> BluesteinPlan:
    """Chirp-z plan for any length ``n``: a cached inner plan of the padded
    length plus the plan-time fp64 chirp spectrum."""
    if sign not in (-1, 1):
        raise ValueError(f"sign must be -1 or +1, got {sign}")
    m = _padded_length(n, config)
    inner = get_plan(m, -1, "complex", config)
    wr64, wi64 = chirp(n, sign, np.float64)
    c = np.zeros(m, dtype=np.complex128)
    w64 = wr64 + 1j * wi64
    c[:n] = np.conj(w64)
    c[m - n + 1 :] = np.conj(w64)[1:][::-1]
    # fp64 spectrum of the chirp kernel with the inverse inner FFT's 1/m
    spec = np.fft.fft(c) / m
    return BluesteinPlan(
        n=n,
        sign=sign,
        m=m,
        inner=inner,
        chirp_re=np.asarray(wr64, dtype=_HOST_DTYPE),
        chirp_im=np.asarray(wi64, dtype=_HOST_DTYPE),
        spec_re=np.asarray(spec.real, dtype=_HOST_DTYPE),
        spec_im=np.asarray(spec.imag, dtype=_HOST_DTYPE),
    )


def build_rader_plan(
    n: int, sign: int, config: SpectralConfig = DEFAULT_CONFIG
) -> RaderPlan:
    """Rader plan for a prime ``n`` with stage-smooth ``n−1``: exact integer
    permutations and the fp64 kernel spectrum as host constants."""
    if sign not in (-1, 1):
        raise ValueError(f"sign must be -1 or +1, got {sign}")
    if not is_prime(n):
        raise ValueError(f"Rader requires a prime length, got {n}")
    L = n - 1
    g = primitive_root(n)
    ginv = pow(g, n - 2, n)
    perm_in = np.empty(L, np.int64)
    ipow = np.empty(L, np.int64)
    cur_f, cur_i = 1, 1
    for q in range(L):
        perm_in[q] = cur_f
        ipow[q] = cur_i
        cur_f = cur_f * g % n
        cur_i = cur_i * ginv % n
    inv = np.zeros(n, np.int64)
    inv[ipow] = np.arange(L)
    perm_out = inv[1:]
    # b[r] = W^{g^{−r}}, W = e^(sign·2πi/n), exact integer phase mod n
    phase = 2.0 * np.pi * ipow.astype(np.float64) / n
    b = np.cos(phase) + 1j * (sign * np.sin(phase))
    spec = np.fft.fft(b) / L
    inner = get_plan(L, -1, "complex", config)
    if not isinstance(inner, MixedRadixPlan):
        raise ValueError(f"n-1 = {L} is not stage-smooth")
    return RaderPlan(
        n=n,
        sign=sign,
        inner=inner,
        perm_in=perm_in.astype(np.int32),
        perm_out=perm_out.astype(np.int32),
        spec_re=np.asarray(spec.real, dtype=_HOST_DTYPE),
        spec_im=np.asarray(spec.imag, dtype=_HOST_DTYPE),
    )


def build_complex_plan(n: int, sign: int, config: SpectralConfig = DEFAULT_CONFIG):
    """Mixed-radix when every prime factor fits in a stage; Rader for primes
    whose n−1 is stage-smooth (when enabled); Bluestein otherwise."""
    if n < 1:
        raise ValueError(f"length must be >= 1, got {n}")
    if n <= config.direct_dft_max or is_smooth(n, config.max_stage):
        return build_mixed_radix_plan(n, sign, config)
    if (
        config.rader == "auto"
        and is_prime(n)
        and is_smooth(n - 1, config.max_stage)
    ):
        return build_rader_plan(n, sign, config)
    return build_bluestein_plan(n, sign, config)


def build_real_plan(
    n: int, sign: int, config: SpectralConfig = DEFAULT_CONFIG
) -> RealPlan:
    """Packed real-FFT plan for even ``n``: half-length complex plan plus the
    split/merge coefficients."""
    if n % 2 != 0:
        raise ValueError(f"packed real FFT requires even length, got {n}")
    inner = build_complex_plan(n // 2, sign, config)
    c64, s64 = split_twiddles(n, sign, np.float64)
    dt = _HOST_DTYPE
    return RealPlan(
        n=n, sign=sign, inner=inner,
        split_re=c64.astype(dt), split_im=s64.astype(dt),
        p_re=((1.0 - sign * s64) / 2.0).astype(dt),
        p_im=(sign * c64 / 2.0).astype(dt),
        q_re=((1.0 + sign * s64) / 2.0).astype(dt),
        q_im=(-sign * c64 / 2.0).astype(dt),
    )


# Plan cache, keyed on everything that changes plan structure or constants.
_CACHE: dict = {}
_CACHE_LOCK = threading.Lock()


def _cfg_key(config: SpectralConfig):
    return (
        config.max_stage,
        config.direct_dft_max,
        config.pad_mode,
        config.stage_strategy,
        config.rader,
        config.butterfly,
    )


def get_plan(n: int, sign: int, kind: str = "complex",
             config: SpectralConfig = DEFAULT_CONFIG):
    """Cached plan lookup keyed on (n, sign, kind, config).  ``kind`` is
    "complex", "real", or "kernel" (the fused kernel's schedule, which no
    config field changes)."""
    from .utils.metrics import incr, logger

    key = (kind, n, sign, _cfg_key(config))
    with _CACHE_LOCK:
        plan = _CACHE.get(key)
    if plan is not None:
        incr("plan_cache_hits")
        return plan
    if kind == "complex":
        plan = build_complex_plan(n, sign, config)
    elif kind == "real":
        plan = build_real_plan(n, sign, config)
    elif kind == "kernel":
        from .ops.cuda_fft import build_kernel_plan  # ops import this module

        plan = build_kernel_plan(n, sign)
    else:
        raise ValueError(f"unknown plan kind {kind!r}")
    incr("plans_built")
    logger.info(
        "built %s plan n=%d sign=%+d (%s)", kind, n, sign,
        type(plan).__name__,
    )
    with _CACHE_LOCK:
        return _CACHE.setdefault(key, plan)


def clear_plan_cache() -> None:
    """Drop every cached plan (and with them their device copies and the
    kernel's ready launch arguments)."""
    from .ops import cuda_fft  # ops import this module

    with _CACHE_LOCK:
        _CACHE.clear()
        cuda_fft._READY.clear()
