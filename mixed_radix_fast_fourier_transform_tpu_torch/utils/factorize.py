"""Number theory and stage planning, host-side and pure Python.

Counterpart of ``mixed_radix_fast_fourier_transform_tpu/utils/factorize.py``
(its pure-Python paths; the port does not load the native planner).  The
stage rules, including the measured special cases of :func:`plan_stages`,
are copied unchanged so that both packages plan every length alike.
"""

from __future__ import annotations

import functools
import math
from typing import List, Sequence, Tuple


def prime_factors(n: int) -> List[int]:
    """Full prime factorization (ascending), trial division with a 6k±1 wheel."""
    if n < 1:
        raise ValueError(f"length must be >= 1, got {n}")
    out: List[int] = []
    for p in (2, 3):
        while n % p == 0:
            out.append(p)
            n //= p
    f = 5
    while f * f <= n:
        for p in (f, f + 2):
            while n % p == 0:
                out.append(p)
                n //= p
        f += 6
    if n > 1:
        out.append(n)
    return out


def largest_prime_factor(n: int) -> int:
    if n == 1:
        return 1
    return prime_factors(n)[-1]


# Radix primes of the C reference's planner (its compat predicate's set).
REFERENCE_PRIME_SET: Tuple[int, ...] = (
    2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53,
)


def _smooth_over(m: int, primes: Sequence[int]) -> bool:
    for p in primes:
        while m % p == 0:
            m //= p
    return m == 1


def dividebyN(n: int, primes: Tuple[int, ...] = REFERENCE_PRIME_SET) -> bool:
    """Compat predicate: is ``n`` smooth over ``primes``?  The C reference's
    ``dividebyN`` with a complete prime set and no table cap."""
    return n >= 1 and _smooth_over(n, primes)


def next_pow2(n: int) -> int:
    """Smallest power of two >= n."""
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


def next_fast_len(n: int, primes: Sequence[int] = (2, 3, 5, 7)) -> int:
    """Smallest ``m >= n`` whose prime factors are all in ``primes``."""
    if n <= 1:
        return 1
    best = next_pow2(n)
    m = n
    while m < best:
        if _smooth_over(m, primes):
            return m
        m += 1
    return best


def prev_fast_len(n: int, primes: Sequence[int] = (2, 3, 5, 7)) -> int:
    """Largest ``m <= n`` whose prime factors are all in ``primes``
    (scipy.fft.prev_fast_len)."""
    if n < 1:
        raise ValueError(f"length must be >= 1, got {n}")
    m = n
    while not _smooth_over(m, primes):
        m -= 1
    return m


def plan_stages(
    n: int, max_stage: int = 64, strategy: str = "balanced"
) -> Tuple[int, ...]:
    """Group the prime factorization of ``n`` into DFT stage sizes <= max_stage.

    ``balanced`` takes the fewest stages, then the most equal sizes (LPT
    packing), with the JAX package's special cases for n = 1024, powers of
    two >= 2048 and two-stage lengths >= 3072.  ``greedy`` packs descending
    primes toward max_stage.  Returns stage sizes in descending order whose
    product is ``n``; raises ValueError if a prime factor exceeds
    ``max_stage``.
    """
    if n == 1:
        return (1,)
    if strategy == "greedy":
        return _plan_stages_greedy(n, max_stage)
    if strategy != "balanced":
        raise ValueError(f"unknown stage strategy {strategy!r}")
    if n == 1024 and max_stage >= 128:
        return (64, 16)
    if n >= 2048 and n & (n - 1) == 0 and max_stage >= 256:
        v = n.bit_length() - 1
        stages = []
        while v >= 7:
            stages.append(128)
            v -= 7
        if v == 1 and stages:
            stages[0] = 256
            v = 0
        if v:
            stages.append(1 << v)
        return tuple(sorted(stages, reverse=True))
    primes = sorted(prime_factors(n), reverse=True)
    if primes[0] > max_stage:
        raise ValueError(
            f"prime factor {primes[0]} of {n} exceeds max_stage={max_stage}"
        )
    if n >= 3072 and max_stage >= 256:
        for a in range(128, 96, -1):
            if n % a == 0 and n // a <= 128:
                return tuple(sorted((a, n // a), reverse=True))
    s = max(1, math.ceil(math.log(n) / math.log(max_stage)))
    while True:
        stages = _lpt_pack(primes, s, max_stage)
        if stages is not None:
            return stages
        s += 1


def _plan_stages_greedy(n: int, max_stage: int) -> Tuple[int, ...]:
    primes = sorted(prime_factors(n), reverse=True)
    if primes[0] > max_stage:
        raise ValueError(
            f"prime factor {primes[0]} of {n} exceeds max_stage={max_stage}"
        )
    stages: List[int] = []
    remaining = list(primes)
    while remaining:
        stage = remaining.pop(0)
        i = 0
        while i < len(remaining):
            if stage * remaining[i] <= max_stage:
                stage *= remaining.pop(i)
            else:
                i += 1
        stages.append(stage)
    stages.sort(reverse=True)
    return tuple(stages)


def _lpt_pack(primes, s: int, max_stage: int):
    """Longest-processing-time packing of prime factors into ``s`` stages of
    product <= max_stage; None if this heuristic can't fit s stages."""
    groups = [1] * s
    for p in primes:  # descending
        groups.sort()
        for i in range(s):
            if groups[i] * p <= max_stage:
                groups[i] *= p
                break
        else:
            return None
    groups = [g for g in groups if g > 1] or [1]
    groups.sort(reverse=True)
    return tuple(groups)


def is_smooth(n: int, max_prime: int) -> bool:
    """True if every prime factor of n is <= max_prime."""
    return largest_prime_factor(n) <= max_prime


def is_prime(n: int) -> bool:
    """Deterministic primality (trial division — plan-time lengths only)."""
    return n >= 2 and prime_factors(n) == [n]


@functools.lru_cache(maxsize=256)
def primitive_root(p: int) -> int:
    """Smallest primitive root modulo prime ``p``."""
    if not is_prime(p):
        raise ValueError(f"primitive_root needs a prime, got {p}")
    if p == 2:
        return 1
    phi = p - 1
    qs = sorted(set(prime_factors(phi)))
    g = 2
    while True:
        if all(pow(g, phi // q, p) != 1 for q in qs):
            return g
        g += 1


def next_splittable_len(n: int, parts: int, max_stage: int = 256) -> int:
    """Smallest convenient m >= n that splits as m = n1·n2 with parts | n1,
    parts | n2 and both factors ``max_stage``-smooth: the padded length of
    the distributed four-step (``parallel.distributed.choose_split``).

    m = parts² · s with s the next 7-smooth integer >= ceil(n / parts²): any
    divisor pair (a, b) of s gives n1 = parts·a, n2 = parts·b, both divisible
    by parts and smooth, so ``choose_split(m, parts)`` always succeeds."""
    if parts < 1:
        raise ValueError(f"parts must be >= 1, got {parts}")
    if not is_smooth(parts, max_stage):
        raise ValueError(
            f"mesh size {parts} has a prime factor > max_stage={max_stage}"
        )
    pp = parts * parts
    return pp * next_fast_len(-(-n // pp))
