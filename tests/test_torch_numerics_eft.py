"""PyTorch port: the error-free transforms of ``utils/numerics.py``
(``two_sum``, ``fast_two_sum``, ``two_prod``, ``veltkamp``, ``dw_mul``,
``dw_add``, ``DW_SPLIT``, ``VELTKAMP_SPLIT``) bit-equal to the JAX package's
on the CPU.

A fused multiply-add or a reassociation would change the low words without
any test of accuracy noticing, so every output is compared bit for bit (the
fp32 words as integers, signed zeros distinct) on random values across the
exponent range and on the edge cases: signed zeros, subnormals, |a| < |b|
for ``two_sum``, values at and around the Veltkamp split's boundaries, and
large values whose split product nears the top of the range.  The JAX
functions run eagerly, op by op, as a chain of separate primitives.  XLA's
CPU backend flushes subnormals to zero, so against it the port runs with
``torch.set_flush_denormal(True)``; with subnormals kept (the port's own
mode, and the card's) it is held bit-equal to the same chain in numpy
float32, which keeps them too."""

import contextlib
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixed_radix_fast_fourier_transform_tpu.utils import numerics as jnum
from mixed_radix_fast_fourier_transform_tpu_torch.utils import numerics as tnum

torch.set_num_threads(1)

NAMES = ("two_sum", "fast_two_sum", "two_prod", "veltkamp", "dw_mul", "dw_add")
ARITY = {"two_sum": 2, "fast_two_sum": 2, "two_prod": 2, "veltkamp": 1, "dw_mul": 4,
         "dw_add": 4}


def _edge_values() -> np.ndarray:
    tiny = np.finfo(np.float32).tiny
    one = np.float32(1.0)
    vals = [0.0, -0.0, tiny, -tiny, tiny / 4, -tiny / 1024, 1e-45, -1e-45, 1.0, -1.0,
            1.0 + 2.0 ** -8, 1.0 + 2.0 ** -9, 1.0 - 2.0 ** -9, 1.0 + 2.0 ** -23,
            2.0 ** 16 + 1.0, 65537.0, 4097.0, 2.0 ** 12 - 1.0, 3.0 * 2.0 ** 100,
            2.0 ** 110, -(2.0 ** 111) * 1.5, 1.7e38 / 65537.0, np.pi, -np.e, 0.1, 1.0 / 3.0]
    v = np.array(vals, np.float32)
    return np.concatenate([v, np.nextafter(v, one * np.inf), np.nextafter(v, -one * np.inf)])


def _random_values(rng, n: int) -> np.ndarray:
    mant = rng.uniform(-2.0, 2.0, n)
    expo = rng.integers(-40, 40, n)
    return (mant * 2.0 ** expo).astype(np.float32)


def _operands(rng, arity: int):
    """Columns of fp32 operands: every pair of edge values (both orders, so
    |a| < |b| comes up), then random values of mixed magnitude."""
    edge = _edge_values()
    a, b = np.meshgrid(edge, edge, indexing="ij")
    base = [a.ravel(), b.ravel()]
    n = base[0].size
    ops = [np.concatenate([base[i % 2], _random_values(rng, 4096)]) for i in range(arity)]
    if arity == 4:   # double words: a low word far below its high word
        ops[1] = np.concatenate([base[1][:n] * np.float32(2.0 ** -30), ops[1][n:] * np.float32(2.0 ** -25)])
        ops[3] = np.concatenate([base[0][:n] * np.float32(2.0 ** -28), ops[3][n:] * np.float32(2.0 ** -24)])
    return [o.astype(np.float32) for o in ops]


@contextlib.contextmanager
def _flushing_subnormals():
    """XLA's CPU backend flushes subnormal inputs and results to zero; the
    port's ops keep them (IEEE gradual underflow, as on the card).  For the
    comparison with the JAX functions the port runs in the same mode."""
    assert torch.set_flush_denormal(True)
    try:
        yield
    finally:
        torch.set_flush_denormal(False)


def _bits(v) -> np.ndarray:
    v = v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    assert v.dtype == np.float32
    return v.view(np.uint32)


def test_splitter_constants_are_the_jax_packages():
    assert tnum.DW_SPLIT == jnum.DW_SPLIT == 2.0 ** 12 + 1
    assert tnum.VELTKAMP_SPLIT == jnum.VELTKAMP_SPLIT == 2.0 ** 16 + 1


@pytest.mark.parametrize("name", NAMES)
def test_bit_equal_to_the_jax_function(name):
    rng = np.random.default_rng(list(map(ord, name)))
    ops = _operands(rng, ARITY[name])
    with np.errstate(all="ignore"), _flushing_subnormals():
        got = getattr(tnum, name)(*(torch.from_numpy(o) for o in ops))
        want = getattr(jnum, name)(*(jnp.asarray(o) for o in ops))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        gb, wb = _bits(g), _bits(w)
        finite = np.isfinite(np.asarray(w))
        # NaN payloads may differ; every finite word, signed zeros included, may not
        assert np.array_equal(np.isfinite(g.numpy()), finite)
        bad = np.flatnonzero((gb != wb) & finite)
        assert bad.size == 0, [tuple(float(o[i]) for o in ops) for i in bad[:5]]


def _numpy_chain(name):
    """The JAX package's formulas on numpy float32 arrays (IEEE, subnormals
    kept, one rounding per op)."""
    f32 = np.float32

    def two_sum(a, b):
        s = a + b
        bb = s - a
        return s, (a - (s - bb)) + (b - bb)

    def fast_two_sum(a, b):
        s = a + b
        return s, b - (s - a)

    def two_prod(a, b):
        split = f32(jnum.DW_SPLIT)
        p = a * b
        ca = split * a
        ah = ca - (ca - a)
        al = a - ah
        cb = split * b
        bh = cb - (cb - b)
        bl = b - bh
        return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl

    def veltkamp(v):
        c = f32(jnum.VELTKAMP_SPLIT) * v
        hi = c - (c - v)
        return hi, v - hi

    def dw_mul(ah, al, bh, bl):
        ph, pe = two_prod(ah, bh)
        return fast_two_sum(ph, pe + (ah * bl + al * bh))

    def dw_add(ah, al, bh, bl):
        sh, se = two_sum(ah, bh)
        return fast_two_sum(sh, se + al + bl)

    return locals()[name]


@pytest.mark.parametrize("name", NAMES)
def test_bit_equal_to_a_float32_chain_with_subnormals_kept(name):
    rng = np.random.default_rng(list(map(ord, name)) + [1])
    ops = _operands(rng, ARITY[name])
    with np.errstate(all="ignore"):
        got = getattr(tnum, name)(*(torch.from_numpy(o) for o in ops))
        want = _numpy_chain(name)(*ops)
    for g, w in zip(got, want):
        finite = np.isfinite(w)
        assert np.array_equal(np.isfinite(g.numpy()), finite)
        bad = np.flatnonzero((_bits(g) != _bits(w)) & finite)
        assert bad.size == 0, [tuple(float(o[i]) for o in ops) for i in bad[:5]]
    # the edge cases do reach the subnormal range here
    assert any(np.any((np.abs(w) < np.finfo(np.float32).tiny) & (w != 0)) for w in want)


def test_two_sum_and_two_prod_are_error_free():
    """s + e == a + b and p + e == a·b exactly (rational arithmetic), on fp32
    tensors and, dtype kept, on float64 tensors."""
    rng = np.random.default_rng(5)
    for dtype in (np.float32, np.float64):
        a = (rng.standard_normal(64) * 2.0 ** rng.integers(-20, 20, 64)).astype(dtype)
        b = (rng.standard_normal(64) * 2.0 ** rng.integers(-20, 20, 64)).astype(dtype)
        s, e = tnum.two_sum(torch.from_numpy(a), torch.from_numpy(b))
        p, f = tnum.two_prod(torch.from_numpy(a), torch.from_numpy(b))
        hi, lo = tnum.veltkamp(torch.from_numpy(a))
        assert s.dtype == p.dtype == hi.dtype == torch.from_numpy(a).dtype
        for i in range(64):
            A, B = Fraction(float(a[i])), Fraction(float(b[i]))
            assert Fraction(float(s[i])) + Fraction(float(e[i])) == A + B
            assert Fraction(float(hi[i])) + Fraction(float(lo[i])) == A
            if dtype == np.float32:   # Dekker's split is for fp32 operands
                assert Fraction(float(p[i])) + Fraction(float(f[i])) == A * B


def test_veltkamp_head_has_a_short_mantissa():
    """The head keeps at most 8 significant bits, so products of heads are
    exact in fp32 (the NUFFT's phase chain relies on it)."""
    rng = np.random.default_rng(6)
    v = _random_values(rng, 2048)
    hi, lo = tnum.veltkamp(torch.from_numpy(v))
    m = np.frexp(hi.numpy().astype(np.float64))[0] * 2.0 ** 8
    assert np.array_equal(m, np.round(m))
    assert np.all(np.abs(lo.numpy()) <= np.abs(hi.numpy()) * 2.0 ** -8)
