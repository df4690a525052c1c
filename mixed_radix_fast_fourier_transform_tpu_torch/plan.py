"""Plan construction and the plan cache.

Counterpart of ``mixed_radix_fast_fourier_transform_tpu/plan.py``.  Plans
are immutable and hold their constants as host numpy arrays, built in fp64
and rounded to the config's working dtype exactly as the JAX package rounds
them, so both packages run the same stage factors with the same constants.
numpy has no bf16: a bf16 plan keeps its tables in fp32 arrays that hold
bf16 values (rounded from fp64 by torch, bit-equal to the JAX package's
ml_dtypes rounding), and the upload casts them to the plan's ``dtype``.

What the port adds is :func:`device_constants`: the tensors of a plan's
constants on one device, uploaded once per (plan, device) and cached on the
plan, so that a transform on the GPU does not copy its DFT matrices and
twiddles from the host on every call.

Under ``torch.compile`` plans are what they are under ``jax.jit``:
trace-time constants.  :func:`get_plan` and the upload run on the host
while dynamo traces (``torch.compiler.assume_constant_result``), a cold
cache included, and the graph holds the uploaded tables; the traced code
reads a plan's fields and names a plan to the upload by its cache key
(``plan.key``), because dynamo cannot hand such a host object back to a
host function.  Reads of the caches take no lock (``dict.get`` is atomic
in CPython, and dynamo cannot trace a lock); every write is one
``setdefault``, so two threads that build the same entry keep the first.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import numpy as np
import torch

from .utils.config import DEFAULT_CONFIG, SpectralConfig
# canonical lower-case name, or tuple of per-stage names, of a config's
# precision (the JAX package's function of the same name)
from .utils.config import precision_name as _precision_str
from .utils.factorize import (
    is_prime,
    is_smooth,
    next_fast_len,
    next_pow2,
    plan_stages,
    primitive_root,
)
from .utils.twiddle import chirp, dft_matrix, split_twiddles, twiddle_split


def _host_dtype(config: SpectralConfig):
    """The numpy dtype of a plan's host constants: the config's working
    dtype (fp32 for bf16, whose values the tables hold; see :func:`_round`)."""
    return {torch.float64: np.float64, torch.float16: np.float16}.get(
        config.dtype, np.float32)


def _round(a, config: SpectralConfig) -> np.ndarray:
    """fp64 host values ``a`` rounded to the config's working dtype, as a
    numpy array of :func:`_host_dtype`: one rounding from fp64 (numpy's for
    fp16, torch's for bf16), as the JAX package's ``np.asarray(a, dtype)``."""
    if config.dtype == torch.bfloat16:
        t = torch.from_numpy(np.asarray(a, np.float64)).to(torch.bfloat16)
        return t.to(torch.float32).numpy()
    return np.asarray(a, dtype=_host_dtype(config))


def _device_cache():
    return dataclasses.field(default_factory=dict, compare=False, repr=False)


def _cache_key():
    # the plan's key in the plan cache, set by get_plan; () for a plan built
    # directly (such a plan cannot be traced)
    return dataclasses.field(default=(), compare=False, repr=False)


@dataclasses.dataclass(frozen=True)
class MixedRadixPlan:
    """Stage schedule for the stage pipeline.

    ``factors`` are dense DFT stage sizes (descending, product = n).
    ``tw_*[i]`` are the Cooley-Tukey split twiddles between stage i and the
    remainder, shape (f_i, prod(factors[i+1:])).  ``precision`` is the
    stage products' precision, one name or a tuple of per-stage names
    (stage i uses precision[min(i, len-1)]).  ``butterfly`` runs stages
    of size 2..``butterfly_max`` (powers of two) as elementwise butterflies.
    ``dtype`` is the working dtype the tables are uploaded at.
    """

    n: int
    sign: int
    factors: Tuple[int, ...]
    precision: "str | Tuple[str, ...]" = "highest"
    butterfly: bool = False
    butterfly_max: int = 8
    dft_re: Tuple[np.ndarray, ...] = ()
    dft_im: Tuple[np.ndarray, ...] = ()
    tw_re: Tuple[np.ndarray, ...] = ()
    tw_im: Tuple[np.ndarray, ...] = ()
    dtype: torch.dtype = torch.float32
    key: tuple = _cache_key()
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
    dtype: torch.dtype = torch.float32
    key: tuple = _cache_key()
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
    dtype: torch.dtype = torch.float32
    key: tuple = _cache_key()
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
    dtype: torch.dtype = torch.float32
    key: tuple = _cache_key()
    _device: Dict = _device_cache()


ComplexPlan = (MixedRadixPlan, BluesteinPlan, RaderPlan)


def _upload(a: np.ndarray, device: torch.device, dtype) -> torch.Tensor:
    # index arrays become int64 for torch.index_select; float tables take
    # the plan's working dtype (``dtype`` None: as they are)
    if np.issubdtype(a.dtype, np.integer):
        a, dtype = a.astype(np.int64), None
    # the constants outlive the call that first needs them: made under
    # torch.inference_mode() they would be inference tensors, which a later
    # call under autograd could not use
    with torch.inference_mode(False):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device, dtype)


def device_constants(plan, device) -> Dict[str, object]:
    """The plan's array constants as tensors on ``device``, keyed by field
    name (tuples stay tuples).  Uploaded once per (plan, device); while a
    tracer runs (``utils.numerics.traced``) the upload is the trace's and
    is not kept."""
    from .utils.metrics import tracing

    device = torch.device(device)
    if tracing():
        if not plan.key:
            raise ValueError(
                f"{type(plan).__name__} n={plan.n} was not made by get_plan: a "
                f"traced call reaches plan constants through the plan cache")
        return _traced_constants(plan.key, device)
    return _constants(plan, device)


@torch.compiler.assume_constant_result
def _traced_constants(key: tuple, device: torch.device) -> Dict[str, object]:
    # on the host while dynamo traces: the graph holds the result
    return _constants(_CACHE[key], device)


def _constants(plan, device: torch.device) -> Dict[str, object]:
    from .utils.numerics import traced

    consts = plan._device.get(device)
    if consts is not None:
        return consts
    consts = {}
    dtype = getattr(plan, "dtype", None)
    for f in dataclasses.fields(plan):
        v = getattr(plan, f.name)
        if isinstance(v, np.ndarray):
            consts[f.name] = _upload(v, device, dtype)
        elif isinstance(v, tuple) and v and isinstance(v[0], np.ndarray):
            consts[f.name] = tuple(_upload(a, device, dtype) for a in v)
    if any(traced(t) for v in consts.values() for t in (v if isinstance(v, tuple) else (v,))):
        return consts
    return plan._device.setdefault(device, consts)


def _host(pair, config: SpectralConfig) -> Tuple[np.ndarray, np.ndarray]:
    re, im = pair
    return _round(re, config), _round(im, config)


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
        wr, wi = _host(dft_matrix(f, sign, np.float64), config)
        dft_re.append(wr)
        dft_im.append(wi)
        if i < len(factors) - 1:
            n_rem = math.prod(factors[i + 1 :])
            tr, ti = _host(twiddle_split(f, n_rem, f * n_rem, sign, np.float64), config)
            tw_re.append(tr)
            tw_im.append(ti)
    return MixedRadixPlan(
        n=n,
        sign=sign,
        factors=factors,
        precision=_precision_str(config.precision),
        butterfly=config.butterfly != "off",
        butterfly_max=8 if config.butterfly == "8" else 16,
        dft_re=tuple(dft_re),
        dft_im=tuple(dft_im),
        tw_re=tuple(tw_re),
        tw_im=tuple(tw_im),
        dtype=config.dtype,
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
        chirp_re=_round(wr64, config),
        chirp_im=_round(wi64, config),
        spec_re=_round(spec.real, config),
        spec_im=_round(spec.imag, config),
        dtype=config.dtype,
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
        spec_re=_round(spec.real, config),
        spec_im=_round(spec.imag, config),
        dtype=config.dtype,
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
    return RealPlan(
        n=n, sign=sign, inner=inner,
        split_re=_round(c64, config), split_im=_round(s64, config),
        p_re=_round((1.0 - sign * s64) / 2.0, config),
        p_im=_round(sign * c64 / 2.0, config),
        q_re=_round((1.0 + sign * s64) / 2.0, config),
        q_im=_round(-sign * c64 / 2.0, config),
        dtype=config.dtype,
    )


# Plan cache, keyed on everything that changes plan structure or constants.
_CACHE: dict = {}


def _cfg_key(config: SpectralConfig):
    return (
        config.max_stage,
        config.direct_dft_max,
        config.pad_mode,
        config.stage_strategy,
        config.rader,
        config.butterfly,
        str(config.dtype),
        str(config.precision),
    )


def get_plan(n: int, sign: int, kind: str = "complex",
             config: SpectralConfig = DEFAULT_CONFIG):
    """Cached plan lookup keyed on (n, sign, kind, config).  ``kind`` is
    "complex", "real", or "kernel" (the fused kernel's schedule, which no
    config field changes).  While dynamo traces, the lookup (and a build on
    a miss) runs on the host and the plan is a constant of the trace, as
    under ``jax.jit``."""
    # the config goes to the host as its field values: dynamo hands a host
    # function a config made inside the traced region with its defaults
    return _cached_plan(kind, n, sign, _cfg_key(config),
                        tuple(getattr(config, f) for f in _PLAN_FIELDS))


# The config fields a plan depends on (all but use_kernel).
_PLAN_FIELDS = ("max_stage", "direct_dft_max", "stage_strategy", "dtype", "precision",
                "pad_mode", "rader", "butterfly")


@torch.compiler.assume_constant_result
def _cached_plan(kind: str, n: int, sign: int, cfg_key: tuple, fields: tuple):
    from .utils.metrics import incr, logger

    key = (kind, n, sign, cfg_key)
    plan = _CACHE.get(key)
    if plan is not None:
        incr("plan_cache_hits")
        return plan
    config = SpectralConfig(**dict(zip(_PLAN_FIELDS, fields)))
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
    return _CACHE.setdefault(key, dataclasses.replace(plan, key=key))


def clear_plan_cache() -> None:
    """Drop every cached plan (and with them their device copies and the
    kernel's ready launch arguments) and every kept device table of
    ``utils.numerics.constant``."""
    from .ops import cuda_fft  # ops import this module
    from .utils.numerics import clear_constants

    _CACHE.clear()
    cuda_fft._READY.clear()
    clear_constants()
