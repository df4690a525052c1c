"""PyTorch port: ``ops/splines.py`` against the JAX package and scipy on the
same inputs.

The recursive prefilters (``symiirorder1/2``, ``cspline1d``, ``qspline1d``,
``cspline2d``, ``qspline2d``, ``spline_filter``) run both passes on
``ops/iir._apply_df2t`` (the shared scan); the evaluators, ``gauss_spline``,
``cubic``, ``quadratic`` and ``sepfir2d`` are elementwise or direct
convolutions.  Held against the JAX function (jitted, as its tests run it)
at 5e-5 of the output's maximum (the JAX package's own ``cspline1d``
tolerance against scipy, the tightest of its spline tests), and against
scipy float64 at the JAX package's test tolerances for each
(``tests/test_splines.py``; scipy truncates its boundary sums at the square
root of the precision, so the 2-D prefilters compare tightly inside and
loosely at the edges)."""

import jax
import numpy as np
import pytest
import scipy.signal as ss
import torch

import mixed_radix_fast_fourier_transform_tpu as sp

import mixed_radix_fast_fourier_transform_tpu_torch as tp

torch.set_num_threads(1)

TOL = 5e-5
SIG = np.random.default_rng(0).standard_normal(200)
IMG = np.random.default_rng(1).standard_normal((40, 50))


def _np(v):
    return v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _rel(got, want):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30)


def _abs(got, want):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.max(np.abs(got - want))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


# name: (the call on either package, scipy float64, tolerance against scipy)
CASES = {
    "symiirorder1": (lambda m, v: m.symiirorder1(v, 2.0, 0.5, 1e-7), ss.symiirorder1(SIG, 2.0, 0.5, 1e-7), 1e-4),
    "symiirorder2": (lambda m, v: m.symiirorder2(v, 0.6, 0.9, 1e-12), ss.symiirorder2(SIG, 0.6, 0.9, 1e-12), 1e-4),
    "cspline1d": (lambda m, v: m.cspline1d(v), ss.cspline1d(SIG), 5e-5),
    "cspline1d-lamb": (lambda m, v: m.cspline1d(v, 5.0), ss.cspline1d(SIG, 5.0), 5e-5),
    "qspline1d": (lambda m, v: m.qspline1d(v), ss.qspline1d(SIG), 5e-5),
}


@pytest.mark.parametrize("name", CASES)
def test_recursive_prefilters_1d(name):
    call, want, tol = CASES[name]
    got = call(tp, _t(SIG))
    assert got.dtype == torch.float32
    assert _rel(got, jax.jit(lambda v: call(sp, v))(SIG.astype(np.float32))) <= TOL
    err = _abs(got, want) if name.startswith("sym") else _rel(got, want)
    assert err <= tol


def test_batched_matches_one_by_one():
    x2 = np.stack([SIG, 2.0 * SIG])
    got = tp.symiirorder1(_t(x2), 2.0, 0.5, 1e-7)
    one = tp.symiirorder1(_t(SIG), 2.0, 0.5, 1e-7)
    assert _abs(got[0], one) <= 1e-6 and _abs(got[1], 2.0 * one) <= 1e-5
    assert _rel(tp.cspline1d(_t(x2))[1], 2.0 * tp.cspline1d(_t(SIG))) <= TOL


@pytest.mark.parametrize("kind", ["cspline", "qspline"])
def test_evaluators(kind):
    c = (ss.cspline1d if kind == "cspline" else ss.qspline1d)(SIG)
    newx = np.random.default_rng(2).uniform(-30, 230, 400)
    kw = dict() if kind == "cspline" else dict(dx=0.5, x0=-1.0)
    mine, jax_fn, ref = (getattr(m, f"{kind}1d_eval") for m in (tp, sp, ss))
    got = mine(_t(c), _t(newx), **kw)
    assert _rel(got, jax_fn(c.astype(np.float32), newx.astype(np.float32), **kw)) <= TOL
    assert _abs(got, ref(c, newx, **kw)) <= 1e-4
    # at the knots the spline reproduces the signal
    back = mine(getattr(tp, f"{kind}1d")(_t(SIG)), _t(np.arange(len(SIG))))
    assert _abs(back, SIG) <= 1e-4


def test_gauss_cubic_quadratic():
    x = np.linspace(-3, 3, 31)
    assert _abs(tp.gauss_spline(_t(x), 3), sp.gauss_spline(x.astype(np.float32), 3)) <= 1e-6
    assert _abs(tp.gauss_spline(_t(x), 3), ss.gauss_spline(x, 3)) <= 1e-6
    for fn in ("cubic", "quadratic"):
        assert _abs(getattr(tp.ops.splines, fn)(_t(x)), getattr(sp.ops.splines, fn)(x.astype(np.float32))) <= 1e-6


@pytest.mark.parametrize("name", ["cspline2d", "cspline2d-lamb", "qspline2d", "spline_filter"])
def test_recursive_prefilters_2d(name):
    fn, args, inner_tol, full_tol, edge = {
        "cspline2d": ("cspline2d", (0.0,), 2e-4, 2e-2, 4), "cspline2d-lamb": ("cspline2d", (1.0,), 2e-4, 2e-2, 4),
        "qspline2d": ("qspline2d", (), 1e-4, 1e-4, 0), "spline_filter": ("spline_filter", (5.0,), 2e-3, 6e-2, 16),
    }[name]
    got = getattr(tp, fn)(_t(IMG), *args)
    assert _rel(got, jax.jit(lambda v: getattr(sp, fn)(v, *args))(IMG.astype(np.float32))) <= TOL
    want = getattr(ss, fn)(IMG.astype(np.float32) if fn == "spline_filter" else IMG, *args)
    inner = (slice(edge, IMG.shape[0] - edge), slice(edge, IMG.shape[1] - edge))
    assert np.max(np.abs(_np(got) - want)[inner]) / np.max(np.abs(want)) <= inner_tol
    assert _rel(got, want) <= full_tol


def test_sepfir2d_and_errors():
    h1, h2 = np.array([0.25, 0.5, 0.25]), np.array([1.0, 2.0, 4.0, 2.0, 1.0]) / 10
    got = tp.sepfir2d(_t(IMG), h1, h2)
    assert _abs(got, sp.sepfir2d(IMG.astype(np.float32), h1, h2)) <= 1e-5
    assert _abs(got, ss.sepfir2d(IMG, h1, h2)) <= 1e-5
    # taps longer than the image: numpy's symmetric padding reflects again off
    # the grown image, as the JAX module's jnp.pad does
    small = IMG[:3, :4].astype(np.float32)
    assert _abs(tp.sepfir2d(_t(small), np.ones(9) / 9, h2), sp.sepfir2d(small, np.ones(9) / 9, h2)) <= 1e-6
    with pytest.raises(ValueError):
        tp.sepfir2d(_t(IMG), np.ones(4), h2)
    with pytest.raises(ValueError):
        tp.symiirorder1(_t(SIG), 1.0, 1.5)
    with pytest.raises(ValueError):
        tp.symiirorder2(_t(SIG), 1.5, 0.9)
    with pytest.raises(ValueError):
        tp.symiirorder1(torch.ones(4), 1.0, 0.9, 1e-12)
    with pytest.raises(ValueError):
        tp.qspline1d(_t(SIG), lamb=1.0)
