"""PyTorch port: the resampling part of ``ops/signal.py`` (``upfirdn``,
``resample_poly``, ``resample``, ``decimate``) against the JAX package and
scipy on the same inputs.

Tolerance: 1e-5 of the output's maximum against the JAX package (the
polyphase products are fp32 sums of a few dozen taps in either package);
5e-5 against scipy's float64."""

import jax
import numpy as np
import pytest
import scipy.signal as ss
import torch

import mixed_radix_fast_fourier_transform_tpu as sp

import mixed_radix_fast_fourier_transform_tpu_torch as tp

torch.set_num_threads(1)

TOL = 1e-5
SCIPY_TOL = 5e-5


def _np(v):
    return v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _rel(got, want):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# coprime, non-coprime, up only, down only, filters shorter than up
UPFIRDN_CASES = [(1, 1, 9), (3, 2, 21), (2, 3, 21), (4, 6, 31), (6, 4, 31), (5, 1, 17), (1, 4, 33),
                 (7, 3, 4), (10, 15, 61), (3, 3, 12)]


@pytest.mark.parametrize("up,down,taps", UPFIRDN_CASES, ids=[f"{u}-{d}-{t}" for u, d, t in UPFIRDN_CASES])
def test_upfirdn(rng, up, down, taps):
    h = rng.standard_normal(taps)
    x = rng.standard_normal((2, 97)).astype(np.float32)
    want = sp.upfirdn(h, x, up, down)
    got = tp.upfirdn(h, _t(x), up, down)
    assert got.dtype == torch.float32 and _rel(got, want) <= TOL
    assert _rel(got, ss.upfirdn(h, x.astype(np.float64), up, down)) <= SCIPY_TOL


def test_upfirdn_axis_cval_complex_and_int(rng):
    h = rng.standard_normal(13)
    x = rng.standard_normal((50, 3)).astype(np.float32)
    assert _rel(tp.upfirdn(h, _t(x), 3, 2, axis=0), sp.upfirdn(h, x, 3, 2, axis=0)) <= TOL
    assert _rel(tp.upfirdn(h, _t(x), 2, 3, axis=0, cval=1.5),
                sp.upfirdn(h, x, 2, 3, axis=0, cval=1.5)) <= TOL
    z = (x + 1j * rng.standard_normal((50, 3))).astype(np.complex64)
    got = tp.upfirdn(h, _t(z), 3, 2, axis=0)
    assert got.dtype == torch.complex64 and _rel(got, sp.upfirdn(h, z, 3, 2, axis=0)) <= TOL
    xi = np.arange(20, dtype=np.int32)
    assert _rel(tp.upfirdn(h, _t(xi), 2, 1), sp.upfirdn(h, xi, 2, 1)) <= TOL
    assert _rel(tp.upfirdn(_t(h), _t(x), 1, 2, axis=0), sp.upfirdn(h, x, 1, 2, axis=0)) <= TOL


def test_upfirdn_gradient_and_errors(rng):
    h = rng.standard_normal(9)
    x = _t(rng.standard_normal((2, 40)).astype(np.float32)).requires_grad_()
    tp.upfirdn(h, x, 3, 2).square().sum().backward()
    assert torch.isfinite(x.grad).all() and x.grad.abs().max() > 0
    for kw in (dict(h=np.ones((2, 2)), x=x), dict(h=h, x=x, up=0), dict(h=h, x=x, mode="reflect"),
               dict(h=h, x=torch.tensor(1.0)), dict(h=[], x=x)):
        with pytest.raises(ValueError):
            tp.upfirdn(**kw)


RESAMPLE_POLY_CASES = [(3, 2), (2, 3), (1, 3), (4, 1), (160, 147), (6, 4), (5, 5)]


@pytest.mark.parametrize("up,down", RESAMPLE_POLY_CASES, ids=[f"{u}-{d}" for u, d in RESAMPLE_POLY_CASES])
def test_resample_poly(rng, up, down):
    x = rng.standard_normal((2, 300)).astype(np.float32)
    want = sp.resample_poly(x, up, down)
    got = tp.resample_poly(_t(x), up, down)
    assert _rel(got, want) <= TOL
    assert _rel(got, ss.resample_poly(x.astype(np.float64), up, down, axis=-1)) <= SCIPY_TOL


@pytest.mark.parametrize("padtype", ["constant", "mean", "median", "minimum", "maximum"])
def test_resample_poly_padtypes_window_axis(rng, padtype):
    x = (rng.standard_normal((120, 2)) + 3.0).astype(np.float32)
    kw = dict(axis=0, padtype=padtype)
    assert _rel(tp.resample_poly(_t(x), 3, 4, **kw), sp.resample_poly(x, 3, 4, **kw)) <= TOL
    assert _rel(tp.resample_poly(_t(x), 3, 4, **kw),
                ss.resample_poly(x.astype(np.float64), 3, 4, **kw)) <= SCIPY_TOL
    if padtype == "constant":
        assert _rel(tp.resample_poly(_t(x), 2, 1, axis=0, cval=3.0),
                    sp.resample_poly(x, 2, 1, axis=0, cval=3.0)) <= TOL
        h = ss.firwin(41, 0.25)
        assert _rel(tp.resample_poly(_t(x), 1, 4, axis=0, window=h),
                    sp.resample_poly(x, 1, 4, axis=0, window=h)) <= TOL
        assert _rel(tp.resample_poly(_t(x), 5, 3, axis=0, window="hann"),
                    sp.resample_poly(x, 5, 3, axis=0, window="hann")) <= TOL


def test_resample_poly_errors(rng):
    x = torch.zeros(50)
    with pytest.raises(ValueError):
        tp.resample_poly(x, 0, 1)
    with pytest.raises(ValueError):
        tp.resample_poly(x, 2, 1, padtype="mean", cval=1.0)
    with pytest.raises(ValueError):
        tp.resample_poly(x, 2, 1, padtype="bogus")
    with pytest.raises(ValueError):
        tp.resample_poly(x, 2, 1, window=np.ones((2, 2)))


RESAMPLE_CASES = [(100, 64), (64, 100), (50, 50), (101, 64), (64, 101), (99, 45), (45, 99), (100, 50)]


@pytest.mark.parametrize("n_x,num", RESAMPLE_CASES, ids=[f"{a}-{b}" for a, b in RESAMPLE_CASES])
@pytest.mark.parametrize("window", [None, "hann", ("kaiser", 4.0)], ids=["none", "hann", "kaiser"])
def test_resample_real_and_complex(rng, n_x, num, window):
    x = rng.standard_normal((2, n_x)).astype(np.float32)
    got = tp.resample(_t(x), num, window=window)
    assert _rel(got, sp.resample(x, num, window=window)) <= TOL
    assert _rel(got, ss.resample(x.astype(np.float64), num, axis=-1, window=window)) <= SCIPY_TOL
    z = (x + 1j * rng.standard_normal((2, n_x))).astype(np.complex64)
    got = tp.resample(_t(z), num, window=window)
    assert got.dtype == torch.complex64 and _rel(got, sp.resample(z, num, window=window)) <= TOL


def test_resample_freq_domain_axis_windows_errors(rng):
    x = rng.standard_normal((80, 3)).astype(np.float32)
    assert _rel(tp.resample(_t(x), 60, axis=0), sp.resample(x, 60, axis=0)) <= TOL
    X = np.fft.fft(x.astype(np.float64), axis=0).astype(np.complex64)
    assert _rel(tp.resample(_t(X), 120, axis=0, domain="freq"),
                sp.resample(X, 120, axis=0, domain="freq")) <= TOL
    warr = np.linspace(1.0, 0.5, 80)
    assert _rel(tp.resample(_t(x), 50, axis=0, window=warr), sp.resample(x, 50, axis=0, window=warr)) <= TOL
    fn = lambda f: np.exp(-(4 * f) ** 2)   # noqa: E731
    assert _rel(tp.resample(_t(x), 50, axis=0, window=fn), sp.resample(x, 50, axis=0, window=fn)) <= TOL
    with pytest.raises(ValueError):
        tp.resample(_t(x), 0)
    with pytest.raises(ValueError):
        tp.resample(_t(x), 10, domain="bogus")
    with pytest.raises(ValueError):
        tp.resample(_t(x), 10, axis=0, window=np.ones(7))


@pytest.mark.parametrize("q,n", [(2, None), (4, None), (3, 30), (5, 41), (1, None)])
def test_decimate_fir(rng, q, n):
    x = rng.standard_normal((2, 400)).astype(np.float32)
    got = tp.decimate(_t(x), q, n)
    assert _rel(got, sp.decimate(x, q, n)) <= TOL
    assert _rel(tp.decimate(_t(x.T.copy()), q, n, axis=0), np.asarray(sp.decimate(x.T, q, n, axis=0))) <= TOL
    if n is None and q > 1:
        assert _rel(got, ss.decimate(x.astype(np.float64), q, ftype="fir", axis=-1)) <= SCIPY_TOL


def test_decimate_iir_waits_for_the_iir_module_and_errors():
    """``ftype='iir'`` waited for ``ops/iir.py``; now it runs scipy's
    Chebyshev-I order-8 sos zero phase, as the JAX package does (1e-3
    against scipy is the JAX package's own test tolerance for it)."""
    x = torch.zeros(100)
    assert torch.equal(tp.decimate(x, 4, ftype="iir"), torch.zeros(25))
    with pytest.raises(ValueError):
        tp.decimate(x, 0)
    with pytest.raises(ValueError):
        tp.decimate(x, 2, ftype="bogus")
    with pytest.raises(ValueError):
        tp.decimate(x, 2, zero_phase=False)


@pytest.mark.parametrize("q,n,zero_phase,axis", [(4, None, True, -1), (3, 6, False, 0)])
def test_decimate_iir(rng, q, n, zero_phase, axis):
    x = rng.standard_normal((2, 480)).astype(np.float32)
    if axis == 0:
        x = x.T.copy()
    got = tp.decimate(_t(x), q, n, ftype="iir", zero_phase=zero_phase, axis=axis)
    want = jax.jit(lambda v: sp.decimate(v, q, n, ftype="iir", zero_phase=zero_phase, axis=axis))(x)
    assert _rel(got, want) <= TOL
    want = ss.decimate(x.astype(np.float64), q, n, ftype="iir", zero_phase=zero_phase, axis=axis)
    assert _rel(got, want) <= 1e-3
