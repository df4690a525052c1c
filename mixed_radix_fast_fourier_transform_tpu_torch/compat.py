"""Reference-compatible API surface (drop-in for highSpeedFFT callers).

Counterpart of ``mixed_radix_fast_fourier_transform_tpu/compat.py``.  Inputs
are numpy arrays, lists or tensors; anything that is no tensor yet goes to
the card in fp32 (pass a CPU tensor to compute on the CPU), and results are
tensors on the input's device.  The counterpart's host-side fp64 branch of
``fft_exec`` is not part of the port.

Mirrors the C API of the reference exactly where the reference is correct —
names, plan objects, sign conventions, unnormalized transforms, output
lengths — so a user of `Tugbars/Mixed-Radix-Fast-Fourier-Transform` can port
call sites mechanically:

    C                                      here
    ---------------------------------      ------------------------------------
    fft_object obj = fft_init(N, 1);       obj = fft_init(N, 1)
    fft_exec(obj, inp, oup);               oup = fft_exec(obj, inp)
    free_fft(obj);                         free_fft(obj)          # no-op
    fft_real_init / fft_r2c_exec / ...     same names
    fft_convolve("full","linear",...)      fft_convolve("full","linear",a,b)
    dividebyN / factors / twiddle /        same names
    longvectorN

Empirically pinned conventions (measured against the compiled reference,
gcc -O2, on sizes where it is correct — SURVEY.md §2.9):

* ``sgn=+1`` is the numpy-forward transform (e^{-2πi·nk/N}); ``sgn=-1`` is the
  **unnormalized** inverse (callers divide by N, as the reference demo does at
  src/real.c:331-335).
* ``fft_r2c_exec`` returns the **full-length mirrored** spectrum (length N):
  the reference documents N/2+1 (real.h:56) but writes N entries
  (src/real.c:128-132) and its convolution relies on the mirror
  (src/convolve.c:147-151).  We match the written behavior.
* ``fft_c2r_exec`` is unnormalized: c2r(r2c(x)) = N·x.
* Compat ``fft_convolve``'s circular mode wraps at next_pow2(max(n1,n2)) and
  returns that full padded buffer — the reference's observable behavior
  (src/convolve.c:45-49, 189-195).  The main API's ``circular=True`` does the
  mathematically-true period-max(n1,n2) wrap instead.

Deliberate non-reproductions (verified reference bugs, SURVEY.md §2.9): every
length is correct here, including N ∈ {2,6,9,12,16,36,49,…,1024,5040} (wrong
in the reference), N ∈ {13,257} (crashes), and N=1 (exit(1)).
``fft_r2c_exec`` with sgn=-1 returns the self-consistent conjugate-convention
spectrum (the reference's is internally inconsistent on that path).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from .ops.rfft import irfft as _irfft, rfft as _rfft
from .plan import get_plan
from .utils.config import DEFAULT_CONFIG, SpectralConfig
from .utils.factorize import dividebyN, next_pow2, prime_factors
from .utils.numerics import (
    as_tensor,
    as_tensors,
    from_planes,
    resolve_device,
    to_planes,
)
from .ops.stockham import exec_complex

__all__ = [
    "fft_object", "fft_real_object",
    "fft_init", "fft_exec", "free_fft",
    "fft_real_init", "fft_r2c_exec", "fft_c2r_exec", "free_real_fft",
    "fft_convolve", "find_optimal_fft_length", "next_power_of_two",
    "dividebyN", "factors", "twiddle", "longvectorN",
    "generate_signal", "generate_real_signal",
    "compute_mse", "compute_mse_real", "print_complex", "print_real",
]

# Reference planner's radix preference order (src/highSpeedFFT.c:2046-2137):
# primes descending 53..13, then 11, then composite 8 before 7, 5, 4 before 3, 2.
_REFERENCE_RADIX_ORDER = (
    53, 47, 43, 41, 37, 31, 29, 23, 19, 17, 13, 11, 8, 7, 5, 4, 3, 2,
)


@dataclasses.dataclass
class fft_object:
    """Compat plan handle mirroring `struct fft_set` (src/highspeedFFT.h:36-43):
    callers/tests poke N/sgn/factors/lf/lt directly, so those fields exist with
    the reference's meanings (lt: 0 = mixed-radix, 1 = Bluestein)."""

    N: int
    sgn: int
    factors: Tuple[int, ...]
    lf: int  # number of factors
    lt: int  # 0 = mixed radix, 1 = Bluestein
    _plan: object = dataclasses.field(repr=False, default=None)
    _config: SpectralConfig = dataclasses.field(repr=False, default=DEFAULT_CONFIG)


@dataclasses.dataclass
class fft_real_object:
    """Compat handle mirroring `struct fft_real_set` (src/real.h:23-40)."""

    N: int
    sgn: int
    cobj: fft_object
    _config: SpectralConfig = dataclasses.field(repr=False, default=DEFAULT_CONFIG)


def factors(n: int) -> List[int]:
    """Reference-order factorization (src/highSpeedFFT.c:2038-2163): divide out
    radices in the reference's preference order, residual primes ascending.
    E.g. 32 → [8, 4], 1024 → [8, 8, 8, 2], 5040 → [8, 7, 5, 3, 3, 2]."""
    if n < 1:
        raise ValueError(f"length must be >= 1, got {n}")
    out: List[int] = []
    for r in _REFERENCE_RADIX_ORDER:
        while n % r == 0:
            out.append(r)
            n //= r
    if n > 1:
        out.extend(prime_factors(n))
    return out


def twiddle(n: int, radix: int, sgn: int = 1) -> np.ndarray:
    """Single-radix twiddle table: e^(-sgn·2πi·j·k/n) for j=0..n/radix-1,
    k=1..radix-1, flattened j-major — the *correct* values for the layout the
    reference's exported `twiddle()` intends (src/highSpeedFFT.c:2186-2224,
    which is off-by-one in its table indexing and dead code internally)."""
    ls = n // radix
    j = np.arange(ls, dtype=np.int64)[:, None]
    k = np.arange(1, radix, dtype=np.int64)[None, :]
    ang = (-sgn * 2.0 * np.pi / n) * ((j * k) % n).astype(np.float64)
    return (np.cos(ang) + 1j * np.sin(ang)).reshape(-1)


def longvectorN(n: int, factor_list: List[int], sgn: int = 1) -> np.ndarray:
    """Plan-wide flat twiddle vector in the reference's telescoped layout
    (src/highSpeedFFT.c:2238-2313): factors iterated innermost-first; the stage
    with cumulative length L (radix r, Ls = L/r) occupies indices
    Ls-1 … Ls-1+Ls·(r-1), holding e^(-sgn·2πi·(k+1)·j/L) for j=0..Ls-1,
    k=0..r-2 — always the correct dynamic-path values, never the reference's
    broken table path (SURVEY.md §2.2(4))."""
    out = np.zeros(max(n - 1, 0), dtype=np.complex128)
    L = 1
    for r in reversed(list(factor_list)):
        L *= r
        ls = L // r
        j = np.arange(ls, dtype=np.int64)[:, None]
        k = np.arange(1, r, dtype=np.int64)[None, :]
        ang = (-sgn * 2.0 * np.pi / L) * ((j * k) % L).astype(np.float64)
        block = (np.cos(ang) + 1j * np.sin(ang)).reshape(-1)
        out[ls - 1 : ls - 1 + block.size] = block
    return out


def fft_init(
    n: int, sgn: int, config: SpectralConfig = DEFAULT_CONFIG
) -> Optional[fft_object]:
    """Build a plan (reference: src/highSpeedFFT.c:206-286).  sgn=+1 forward,
    sgn=-1 inverse (unnormalized).  Never segfaults/exits: N=1, N=13, N=257
    are all valid (reference crashes on each — SURVEY.md §2.9)."""
    if sgn not in (1, -1):
        raise ValueError(f"sgn must be +1 (forward) or -1 (inverse), got {sgn}")
    if n < 1:
        return None  # reference returns NULL on alloc/validation failure
    plan = get_plan(n, -sgn, "complex", config)  # internal sign = -sgn
    f = factors(n)
    lt = 0 if type(plan).__name__ == "MixedRadixPlan" else 1
    return fft_object(N=n, sgn=sgn, factors=tuple(f), lf=len(f), lt=lt,
                      _plan=plan, _config=config)


def fft_exec(obj: fft_object, inp, oup=None):
    """Execute the plan (reference: src/highSpeedFFT.c:1920-1942).  Unnormalized
    in both directions.  Returns the output tensor (batched over leading dims);
    ``oup`` is accepted for signature parity and ignored.  The plan's stage
    pipeline runs the transform, on the input's device."""
    if obj is None:
        raise ValueError("fft_exec: NULL plan")
    in_len = np.shape(inp)[-1] if np.ndim(inp) else 0
    if in_len != obj.N:
        raise ValueError(f"fft_exec: input length {in_len} != plan N {obj.N}")
    xr, xi = to_planes(inp)
    zr, zi = exec_complex(obj._plan, xr, xi)
    return from_planes(zr, zi)


def free_fft(obj) -> None:
    """No-op: plans are immutable and garbage-collected (reference:
    src/highSpeedFFT.c:2315-2318)."""


def fft_real_init(
    n: int, sgn: int, config: SpectralConfig = DEFAULT_CONFIG
) -> Optional[fft_real_object]:
    """Real-FFT plan (reference: src/real.c:26-76).  Even N, like the reference
    (src/real.c:28-32)."""
    if sgn not in (1, -1):
        raise ValueError(f"sgn must be +1 or -1, got {sgn}")
    if n < 2 or n % 2 != 0:
        return None
    return fft_real_object(N=n, sgn=sgn, cobj=fft_init(n // 2, sgn, config),
                           _config=config)


def fft_r2c_exec(robj: fft_real_object, inp):
    """Real → complex, full-length mirrored spectrum (length N, matching the
    reference's written-buffer behavior, src/real.c:128-132)."""
    if robj is None:
        raise ValueError("fft_r2c_exec: NULL plan")
    half = _rfft(inp, n=robj.N, config=robj._config)  # numpy-forward convention
    if robj.sgn == -1:
        half = torch.conj(half)
    tail = torch.conj(torch.flip(half[..., 1:-1], (-1,)))
    return torch.cat([half, tail], dim=-1).resolve_conj()


def fft_c2r_exec(robj: fft_real_object, inp):
    """Complex → real, unnormalized: c2r(r2c(x)) = N·x (the reference demo and
    convolution divide by N afterwards — src/real.c:413-416,
    src/convolve.c:157-160).  Consumes bins 0..N/2 only, like the reference
    (src/real.c:171-189)."""
    if robj is None:
        raise ValueError("fft_c2r_exec: NULL plan")
    n = robj.N
    x = as_tensor(inp)[..., : n // 2 + 1]
    if robj.sgn == 1:
        # Inverts an sgn=-1 (conjugate-convention) spectrum.
        x = torch.conj(x)
    return _irfft(x, n=n, config=robj._config) * n


def free_real_fft(robj) -> None:
    """No-op (reference: src/real.c:259-267)."""


def next_power_of_two(n: int) -> int:
    """Exact next power of two (reference's is pow/log-float based,
    src/convolve.c:20-25)."""
    return next_pow2(n)


def find_optimal_fft_length(
    min_length: int, conv_type: str, length1: int, length2: int
) -> int:
    """Reference: src/convolve.c:39-55."""
    if conv_type == "linear":
        return next_pow2(min_length)
    if conv_type == "circular":
        return next_pow2(max(length1, length2))
    raise ValueError(f"invalid convolution type {conv_type!r}")


def fft_convolve(
    type: str,  # noqa: A002 — parameter name matches the reference signature
    conv_type: str,
    input1,
    input2,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tuple[Optional[torch.Tensor], int]:
    """Reference-signature convolution (src/convolve.c:74-214): returns
    (output, length) with the reference's exact slicing, including the circular
    mode's wrap-at-next_pow2(max) full-padded-buffer behavior."""
    a, b = as_tensors(input1, input2)
    n1, n2 = a.shape[-1], b.shape[-1]
    if n1 < 1 or n2 < 1:
        return None, -1
    if conv_type == "linear":
        conv_length = n1 + n2 - 1
    elif conv_type == "circular":
        conv_length = max(n1, n2)
    else:
        return None, -1
    m = find_optimal_fft_length(conv_length, conv_type, n1, n2)
    f1 = _rfft(a, n=m, config=config)
    f2 = _rfft(b, n=m, config=config)
    full = _irfft(f1 * f2, n=m, config=config)
    if conv_type == "circular":
        return full, m
    if type in (None, "full"):
        start, length = 0, conv_length
    elif type == "same":
        larger = max(n1, n2)
        start, length = (conv_length - larger) // 2, larger
    elif type == "valid":
        smaller = min(n1, n2)
        start, length = smaller - 1, max(n1, n2) - smaller + 1
    else:
        return None, -1
    return full[..., start : start + length], length


# ---------------------------------------------------------------------------
# Demo utilities (reference L5: src/real.c:198-257) — kept for parity.
# ---------------------------------------------------------------------------

def generate_signal(n: int, freq: float = 4.0, dtype=torch.complex128,
                    device=None) -> torch.Tensor:
    """Single-sine complex test signal (reference: src/real.c:198-207), on
    ``device`` (default: the card)."""
    t = torch.arange(n, dtype=torch.float64, device=resolve_device(device)) / n
    return torch.exp(2j * np.pi * freq * t).to(dtype)


def generate_real_signal(n: int, freq: float = 4.0, dtype=torch.float64,
                         device=None) -> torch.Tensor:
    """Single-sine real test signal (reference: src/real.c:229-238), on
    ``device`` (default: the card)."""
    t = torch.arange(n, dtype=torch.float64, device=resolve_device(device)) / n
    return torch.sin(2 * np.pi * freq * t).to(dtype)


def _host(x, dtype) -> np.ndarray:
    """``x`` (a tensor on any device, or array-like) as a host numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().resolve_conj().cpu().numpy()
    return np.asarray(x, dtype=dtype)


def compute_mse(a, b) -> float:
    """Mean squared error between complex signals (reference: src/real.c:209-217)."""
    return float(np.mean(np.abs(_host(a, np.complex128) - _host(b, np.complex128)) ** 2))


def compute_mse_real(a, b) -> float:
    """Reference: src/real.c:240-247."""
    return float(np.mean((_host(a, np.float64) - _host(b, np.float64)) ** 2))


def print_complex(x, label: str = "signal") -> None:
    """Reference: src/real.c:219-227."""
    print(f"{label}:")
    for i, v in enumerate(np.ravel(_host(x, np.complex128))):
        print(f"  [{i}] {v.real:+.6f} {v.imag:+.6f}i")


def print_real(x, label: str = "signal") -> None:
    """Reference: src/real.c:249-257."""
    print(f"{label}:")
    for i, v in enumerate(np.ravel(_host(x, np.float64))):
        print(f"  [{i}] {float(v):+.6f}")
