"""PyTorch port: the spectral-estimation half of ``ops/signal.py`` against the
JAX package on the same inputs.

Tolerance: 1e-5 of the output's maximum (the JAX package's fp32 budget),
except where stated: the cepstra take the logarithm of a spectrum whose small
bins amplify fp32 rounding (2e-4 of the maximum), and the distortion metrics
are dB figures compared at 1e-3 dB."""

import numpy as np
import pytest
import scipy.signal as ss
import torch

import mixed_radix_fast_fourier_transform_tpu as sp
from mixed_radix_fast_fourier_transform_tpu.ops import signal as jsig

import mixed_radix_fast_fourier_transform_tpu_torch as tp
from mixed_radix_fast_fourier_transform_tpu_torch.ops import signal as tsig

torch.set_num_threads(1)

TOL = 1e-5
CEPS_TOL = 2e-4


def _np(v):
    return v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _rel(got, want):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _sig(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _pair_ok(got, want, tol=TOL):
    """(freqs, values) results of the two packages agree."""
    assert _rel(got[0], want[0]) <= 1e-6
    assert _rel(got[1], want[1]) <= tol


@pytest.mark.parametrize("order,n,period", [(1, 64, 2 * np.pi), (2, 64, 2 * np.pi),
                                            (1, 45, 3.0), (3, 90, 1.0)])
def test_spectral_diff(rng, order, n, period):
    x = _sig(rng, 3, n)
    want = sp.spectral_diff(x, order, period)
    assert _rel(tp.spectral_diff(_t(x), order, period), want) <= TOL
    assert _rel(tp.spectral_diff(_t(x.T.copy()), order, period, axis=0), np.asarray(want).T) <= TOL
    with pytest.raises(ValueError):
        tp.spectral_diff(_t(x), 0)
    with pytest.raises(ValueError):
        tp.spectral_diff(_t(x).to(torch.complex64))


@pytest.mark.parametrize("n_in,n", [(64, None), (63, None), (64, 100), (90, 45)])
def test_hilbert(rng, n_in, n):
    x = _sig(rng, 2, n_in)
    assert _rel(tp.hilbert(_t(x), n), sp.hilbert(x, n)) <= TOL
    assert _rel(tp.hilbert(_t(x.T.copy()), n, axis=0), np.asarray(sp.hilbert(x.T, n, axis=0))) <= TOL
    assert _rel(tp.hilbert(_t(x[0].astype(np.float64))), ss.hilbert(x[0].astype(np.float64))) <= TOL
    with pytest.raises(ValueError):
        tp.hilbert(torch.zeros(8, dtype=torch.complex64))


@pytest.mark.parametrize("shape,n", [((16, 24), None), ((2, 15, 9), None), ((16, 24), 32),
                                     ((12, 10), (16, 8))])
def test_hilbert2(rng, shape, n):
    x = _sig(rng, *shape)
    assert _rel(tp.hilbert2(_t(x), n), sp.hilbert2(x, n)) <= TOL
    with pytest.raises(ValueError):
        tp.hilbert2(torch.zeros(8))
    with pytest.raises(ValueError):
        tp.hilbert2(torch.zeros(8, 8), n=(1, 2, 3))


@pytest.mark.parametrize("window,nfft,detrend,scaling", [
    ("boxcar", None, "constant", "density"), ("hann", 256, "linear", "spectrum"),
    (("kaiser", 6.0), None, False, "density"), ("hamming", 300, True, "density"),
])
def test_periodogram(rng, window, nfft, detrend, scaling):
    x = _sig(rng, 2, 200) + 0.01 * np.arange(200, dtype=np.float32)
    want = sp.periodogram(x, 100.0, window, nfft, detrend, scaling)
    _pair_ok(tp.periodogram(_t(x), 100.0, window, nfft, detrend, scaling), want)
    f, p = ss.periodogram(x.astype(np.float64), 100.0, window, nfft,
                          "constant" if detrend is True else detrend, scaling=scaling)
    assert _rel(tp.periodogram(_t(x), 100.0, window, nfft, detrend, scaling)[1], p) <= 5e-5
    with pytest.raises(ValueError):
        tp.periodogram(_t(x), scaling="bogus")
    with pytest.raises(ValueError):
        tp.periodogram(_t(x), detrend="bogus")


@pytest.mark.parametrize("average", ["mean", "median"])
@pytest.mark.parametrize("nperseg,noverlap,window,detrend,scaling,t", [
    (64, None, "hann", "constant", "density", 1000),
    (100, 80, "hamming", "linear", "spectrum", 1000),
    (128, 0, ("kaiser", 5.0), False, "density", 1024),   # an even segment count: 8
    (90, 45, "hann", "constant", "density", 777),
])
def test_welch(rng, average, nperseg, noverlap, window, detrend, scaling, t):
    x = _sig(rng, 2, t)
    kw = dict(scaling=scaling, detrend=detrend, average=average)
    want = sp.welch(x, 50.0, window, nperseg, noverlap, **kw)
    _pair_ok(tp.welch(_t(x), 50.0, window, nperseg, noverlap, **kw), want)
    _, p = ss.welch(x.astype(np.float64), 50.0, window, nperseg, noverlap, scaling=scaling,
                    detrend=detrend, average=average)
    assert _rel(tp.welch(_t(x), 50.0, window, nperseg, noverlap, **kw)[1], p) <= 5e-5


def test_welch_axis_cap_and_errors(rng, caplog):
    x = _sig(rng, 300, 2)
    _pair_ok(tp.welch(_t(x), nperseg=64, axis=0), sp.welch(x, nperseg=64, axis=0))
    short = _sig(rng, 100)
    with caplog.at_level("INFO", logger="mixed_radix_fft_torch"):
        got = tp.welch(_t(short), nperseg=256)
    assert "capping" in caplog.text
    _pair_ok(got, sp.welch(short, nperseg=256))
    _pair_ok(tp.welch(_t(short), nperseg=256, noverlap=200), sp.welch(short, nperseg=256, noverlap=200))
    with pytest.raises(ValueError):
        tp.welch(_t(short), average="bogus")
    with pytest.raises(ValueError):
        tp.welch(_t(short), scaling="bogus")
    with pytest.raises(ValueError):
        tp.welch(_t(short), nperseg=32, noverlap=32)


def test_median_bias_and_onesided_scale_bit_equal():
    for n in (1, 2, 7, 8):
        assert tsig._median_bias(n) == jsig._median_bias(n)
    for scaling in ("density", "spectrum"):
        assert np.array_equal(tsig._onesided_scale(64, 10.0, "hann", scaling),
                              jsig._onesided_scale(64, 10.0, "hann", scaling))
    with pytest.raises(ValueError):
        tsig._onesided_scale(64, 1.0, "hann", "bogus")


@pytest.mark.parametrize("scaling,detrend", [("density", "constant"), ("spectrum", False)])
def test_csd(rng, scaling, detrend):
    x, y = _sig(rng, 2, 800), _sig(rng, 2, 800)
    want = sp.csd(x, y, 10.0, "hann", 128, 96, scaling, detrend)
    got = tp.csd(_t(x), _t(y), 10.0, "hann", 128, 96, scaling, detrend)
    assert got[1].dtype == torch.complex64
    _pair_ok(got, want)


def test_coherence_and_tfestimate(rng):
    x = _sig(rng, 2, 2000)
    h = ss.firwin(21, 0.3)
    y = (ss.lfilter(h, 1.0, x.astype(np.float64)) + 0.1 * rng.standard_normal((2, 2000))).astype(np.float32)
    _pair_ok(tp.coherence(_t(x), _t(y), 1.0, "hann", 128), sp.coherence(x, y, 1.0, "hann", 128))
    got = tp.tfestimate(_t(x), _t(y), 1.0, "hann", 128, 64)
    _pair_ok(got, sp.tfestimate(x, y, 1.0, "hann", 128, 64))
    assert got[1].dtype == torch.complex64
    # numpy for y joins the tensor's device
    _pair_ok(tp.coherence(_t(x), y, nperseg=128), sp.coherence(x, y, nperseg=128))


@pytest.mark.parametrize("weighting,nfft,detrend", [("eigen", None, "constant"),
                                                    ("unity", 512, "linear")])
def test_multitaper(rng, weighting, nfft, detrend):
    x = _sig(rng, 2, 300)
    kw = dict(fs=20.0, nw=3.5, nfft=nfft, detrend=detrend, weighting=weighting)
    _pair_ok(tp.multitaper(_t(x), **kw), sp.multitaper(x, **kw))
    _pair_ok(tp.multitaper(_t(x.T.copy()), k=3, axis=0), sp.multitaper(x.T, k=3, axis=0))
    with pytest.raises(ValueError):
        tp.multitaper(_t(x), weighting="bogus")
    with pytest.raises(ValueError):
        tp.multitaper(_t(x), scaling="spectrum")
    with pytest.raises(ValueError):
        tp.multitaper(_t(x), nfft=100)
    with pytest.raises(ValueError):
        tp.multitaper(_t(x).to(torch.complex64))


@pytest.mark.parametrize("normalize", [False, True, "amplitude"])
@pytest.mark.parametrize("floating_mean,weighted", [(False, False), (True, True)])
def test_lombscargle(rng, normalize, floating_mean, weighted):
    t = np.sort(rng.uniform(0, 20, 150)).astype(np.float32)
    y = (np.sin(2.3 * t) + 0.5 + 0.1 * rng.standard_normal((2, 150))).astype(np.float32)
    freqs = np.linspace(0.5, 5.0, 40).astype(np.float32)
    w = rng.uniform(0.5, 1.5, 150).astype(np.float32) if weighted else None
    kw = dict(weights=w, floating_mean=floating_mean, normalize=normalize)
    want = sp.lombscargle(t, y, freqs, **kw)
    got = tp.lombscargle(_t(t), _t(y), _t(freqs), **{**kw, "weights": None if w is None else _t(w)})
    assert _rel(got, want) <= 2e-5   # sums of 150 fp32 products in another order
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:   # the products ask for full fp32 themselves and give the flag back
        tp.lombscargle(_t(t), _t(y), _t(freqs))
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def test_lombscargle_errors():
    t = torch.linspace(0, 1, 10)
    with pytest.raises(ValueError):
        tp.lombscargle(t[None], t, t)
    with pytest.raises(ValueError):
        tp.lombscargle(t, t[:5], t)
    with pytest.raises(ValueError):
        tp.lombscargle(t, t, t[None])
    with pytest.raises(ValueError):
        tp.lombscargle(t, t, t, normalize="bogus")
    with pytest.raises(ValueError):
        tp.lombscargle(t, t, t, weights=torch.ones(3))


@pytest.mark.parametrize("scalar", [False, True])
def test_goertzel(rng, scalar):
    x = _sig(rng, 3, 205)
    freqs = 697.0 if scalar else np.array([697.0, 770.0, 852.0, 941.0, 1209.0])
    want = sp.goertzel(x, freqs, fs=8000.0)
    assert _rel(tp.goertzel(_t(x), freqs, fs=8000.0), want) <= TOL
    z = (x + 1j * _sig(rng, 3, 205)).astype(np.complex64)
    assert _rel(tp.goertzel(_t(z), freqs, fs=8000.0), sp.goertzel(z, freqs, fs=8000.0)) <= TOL
    assert _rel(tp.goertzel(_t(x.T.copy()), freqs, fs=8000.0, axis=0), want) <= TOL
    k = 17   # an rfft bin exactly
    assert _rel(tp.goertzel(_t(x), k / 205.0), np.fft.rfft(x.astype(np.float64))[:, k]) <= TOL


@pytest.mark.parametrize("bp_in,n_out,residual,squared", [
    ((1, None), None, "lowpass", False), ((5, 30), 80, "all", True), ((-20, -3), None, "lowpass", False),
    ((-4, 6), 140, None, False), ((1, None), 60, "lowpass", False), ((None, None), None, "all", False),
])
def test_envelope_real(rng, bp_in, n_out, residual, squared):
    x = _sig(rng, 2, 101 if bp_in == (-4, 6) else 100)
    kw = dict(n_out=n_out, squared=squared, residual=residual)
    assert _rel(tp.envelope(_t(x), bp_in, **kw), sp.envelope(x, bp_in, **kw)) <= TOL


@pytest.mark.parametrize("bp_in,n_out,residual", [((1, None), None, "lowpass"), ((-10, 12), 64, "all"),
                                                  ((3, 20), 120, "lowpass")])
def test_envelope_complex_and_errors(rng, bp_in, n_out, residual):
    z = (_sig(rng, 2, 90) + 1j * _sig(rng, 2, 90)).astype(np.complex64)
    want = np.asarray(sp.envelope(z, bp_in, n_out=n_out, residual=residual))
    assert _rel(tp.envelope(_t(z), bp_in, n_out=n_out, residual=residual), want) <= TOL
    assert _rel(tp.envelope(_t(z.T.copy()), bp_in, n_out=n_out, residual=None, axis=0),
                np.asarray(sp.envelope(z.T, bp_in, n_out=n_out, residual=None, axis=0))) <= TOL
    with pytest.raises(ValueError):
        tp.envelope(_t(z), (1.5, None))
    with pytest.raises(ValueError):
        tp.envelope(_t(z), residual="bogus")
    with pytest.raises(ValueError):
        tp.envelope(_t(z), (50, 10))
    with pytest.raises(ValueError):
        tp.envelope(_t(z), n_out=0)


@pytest.mark.parametrize("n_in,n", [(128, None), (101, None), (100, 128)])
def test_rceps_cceps_icceps(rng, n_in, n):
    x = np.zeros((2, n_in), np.float32)
    x[:, 0], x[:, 9] = 1.0, 0.5           # an impulse with an echo
    x += 0.01 * _sig(rng, 2, n_in)
    assert _rel(tp.rceps(_t(x), n), sp.rceps(x, n)) <= CEPS_TOL
    want, nd_want = sp.cceps(x, n)
    got, nd = tp.cceps(_t(x), n)
    assert np.array_equal(_np(nd), np.asarray(nd_want))
    assert _rel(got, want) <= CEPS_TOL
    back = tp.icceps(_t(np.asarray(want)), _t(np.asarray(nd_want)))
    assert _rel(back, sp.icceps(want, nd_want)) <= CEPS_TOL
    assert _rel(tp.icceps(_t(np.asarray(want[0])), 0.0), sp.icceps(want[0], 0.0)) <= CEPS_TOL
    assert _rel(tp.rceps(_t(x.T.copy()), axis=0), np.asarray(sp.rceps(x.T, axis=0))) <= CEPS_TOL
    for fn in (tp.rceps, tp.cceps):
        with pytest.raises(ValueError):
            fn(torch.zeros(8, dtype=torch.complex64))


def test_unwrap_matches_numpy(rng):
    p = np.cumsum(rng.uniform(-2.5, 2.5, (3, 200))).reshape(3, 200)
    wrapped = np.angle(np.exp(1j * p)).astype(np.float32)
    assert _rel(tsig._unwrap(_t(wrapped)), np.unwrap(wrapped.astype(np.float64))) <= 1e-5


@pytest.mark.parametrize("half,n_fft", [(True, None), (False, None), (True, 1024)])
def test_minimum_phase(half, n_fft):
    h = ss.remez(31, [0, 0.2, 0.3, 0.5], [1, 0])
    want = sp.minimum_phase(h.astype(np.float32), n_fft, half)
    got = tp.minimum_phase(_t(h.astype(np.float32)), n_fft, half)
    assert _rel(got, want) <= CEPS_TOL
    assert _rel(got, ss.minimum_phase(h, method="homomorphic", n_fft=n_fft, half=half)) <= 2e-3
    with pytest.raises(ValueError):
        tp.minimum_phase(torch.zeros(2))
    with pytest.raises(ValueError):
        tp.minimum_phase(torch.zeros(8), n_fft=4)
    with pytest.raises(ValueError):
        tp.minimum_phase(torch.zeros(8, dtype=torch.complex64))


@pytest.mark.parametrize("type,bp", [("linear", 0), ("constant", 0), ("linear", [50, 120]), ("l", 100)])
def test_detrend(rng, type, bp):
    x = (_sig(rng, 3, 200) + 0.05 * np.arange(200)).astype(np.float32)
    assert _rel(tp.detrend(_t(x), type=type, bp=bp), sp.detrend(x, type=type, bp=bp)) <= TOL
    assert _rel(tp.detrend(_t(x.T.copy()), axis=0, type=type, bp=bp),
                np.asarray(sp.detrend(x.T, axis=0, type=type, bp=bp))) <= TOL
    assert _rel(tp.detrend(_t(x), type=type, bp=bp),
                ss.detrend(x.astype(np.float64), type=type[0] == "l" and "linear" or "constant", bp=bp)) <= 5e-5
    with pytest.raises(ValueError):
        tp.detrend(_t(x), type="bogus")
    with pytest.raises(ValueError):
        tp.detrend(_t(x), bp=500)


@pytest.mark.parametrize("shape,period", [((64,), 2 * np.pi), ((16, 24), (1.0, 2.0)), ((8, 6, 10), 3.0)])
def test_poisson_solve(rng, shape, period):
    f = _sig(rng, *shape)
    f -= f.mean()
    assert _rel(tp.poisson_solve(_t(f), period), sp.poisson_solve(f, period)) <= TOL
    with pytest.raises(ValueError):
        tp.poisson_solve(torch.zeros(8, dtype=torch.complex64))


def test_distortion_metrics(rng):
    n = 4096
    t = np.arange(n)
    x = (np.sin(2 * np.pi * 200.5 * t / n) + 1e-3 * np.sin(2 * np.pi * 401 * t / n)
         + 1e-4 * rng.standard_normal(n)).astype(np.float32)
    for name in ("thd", "sinad", "sfdr", "enob"):
        want = getattr(sp, name)(x)
        assert abs(getattr(tp, name)(_t(x)) - want) <= 1e-3, name
        assert abs(getattr(tp, name)(_t(x), nperseg=1024) - getattr(sp, name)(x, nperseg=1024)) <= 1e-3
    assert abs(tp.thd(_t(x), n_harmonics=3) - sp.thd(x, n_harmonics=3)) <= 1e-3
    with pytest.raises(ValueError):
        tp.thd(_t(x)[None])
    with pytest.raises(ValueError):
        tp.sinad(_t(x), nperseg=8)


def test_vectorstrength_and_correlation_lags(rng):
    events = rng.uniform(0, 10, 50)
    assert tp.vectorstrength(events, 0.7) == sp.vectorstrength(events, 0.7)
    got, want = tp.vectorstrength(events, [0.5, 1.0]), sp.vectorstrength(events, [0.5, 1.0])
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    with pytest.raises(ValueError):
        tp.vectorstrength(events, -1.0)
    for mode in ("full", "same", "valid"):
        for a, b in ((10, 4), (4, 10), (7, 7), (8, 3)):
            got = tp.correlation_lags(a, b, mode)
            assert np.array_equal(got, sp.correlation_lags(a, b, mode))
            assert np.array_equal(got, ss.correlation_lags(a, b, mode))
    with pytest.raises(ValueError):
        tp.correlation_lags(3, 3, "bogus")
