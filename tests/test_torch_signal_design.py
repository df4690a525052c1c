"""PyTorch port: the filter-design half of ``ops/signal.py`` against the JAX
package.

The designs are numpy float64 on the host in both packages, the port's a
copy of the JAX module's: their outputs are compared bit for bit.  The
functions that run on the device (``freqz``, ``group_delay``,
``savgol_filter``) compare at 1e-5 of the output's maximum; ``group_delay``
divides by a response that nearly vanishes in the stopband, where fp32
rounding of either package shows: it is held to 5e-3 of its maximum."""

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


def _np(v):
    return v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _rel(got, want):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


FIRWIN_CASES = [
    dict(numtaps=31, cutoff=0.3), dict(numtaps=32, cutoff=0.3, window="hann"),
    dict(numtaps=41, cutoff=[0.2, 0.5], pass_zero=False),
    dict(numtaps=41, cutoff=[0.2, 0.5], pass_zero="bandstop"),
    dict(numtaps=51, cutoff=0.4, pass_zero="highpass"), dict(numtaps=61, cutoff=0.25, width=0.05),
    dict(numtaps=45, cutoff=[10.0, 20.0, 30.0], fs=100.0, scale=False),
    dict(numtaps=33, cutoff=0.5, window=("kaiser", 7.0)),
]


@pytest.mark.parametrize("kw", FIRWIN_CASES, ids=[str(i) for i in range(len(FIRWIN_CASES))])
def test_firwin_bit_equal(kw):
    got = tp.firwin(**kw)
    assert _same(got, sp.firwin(**kw))
    assert np.max(np.abs(got - ss.firwin(**kw))) <= 1e-12


def test_firwin_errors():
    for kw in (dict(numtaps=1, cutoff=0.3), dict(numtaps=31, cutoff=1.5), dict(numtaps=31, cutoff=[0.5, 0.2]),
               dict(numtaps=30, cutoff=0.3, pass_zero=False), dict(numtaps=31, cutoff=0.3, pass_zero="bogus"),
               dict(numtaps=31, cutoff=[0.2, 0.3], pass_zero="lowpass")):
        with pytest.raises(ValueError):
            tp.firwin(**kw)
    with pytest.raises(ValueError):
        tsig._firwin_lowpass(30, 0.3, "hamming")
    assert _same(tsig._firwin_lowpass(31, 0.3, "hamming"), jsig._firwin_lowpass(31, 0.3, "hamming"))


def test_kaiser_helpers():
    for a in (10.0, 30.0, 60.0):
        assert tp.kaiser_beta(a) == sp.kaiser_beta(a) == ss.kaiser_beta(a)
    assert tp.kaiser_atten(65, 0.1) == sp.kaiser_atten(65, 0.1)
    assert tp.kaiserord(65.0, 0.08) == sp.kaiserord(65.0, 0.08)
    with pytest.raises(ValueError):
        tp.kaiserord(5.0, 0.1)


@pytest.mark.parametrize("kw", [
    dict(numtaps=51, freq=[0, 0.3, 0.5, 1.0], gain=[1, 1, 0, 0]),
    dict(numtaps=50, freq=[0, 0.3, 0.3, 1.0], gain=[1, 1, 0, 0], window="hann"),
    dict(numtaps=41, freq=[0, 0.2, 0.6, 1.0], gain=[0, 1, 1, 0], antisymmetric=True),
    dict(numtaps=40, freq=[0, 10, 30, 50], gain=[0, 1, 1, 1], antisymmetric=True, fs=100.0, nfreqs=129),
    dict(numtaps=31, freq=[0, 0.5, 1.0], gain=[1, 0.5, 0], window=None),
], ids=str)
def test_firwin2_bit_equal(kw):
    got = tp.firwin2(**kw)
    assert _same(got, sp.firwin2(**kw))
    assert np.max(np.abs(got - ss.firwin2(**kw))) <= 1e-7   # scipy nudges repeated edges apart otherwise


def test_firwin2_errors():
    for kw in (dict(numtaps=51, freq=[0, 0.5], gain=[1]), dict(numtaps=51, freq=[0.1, 1.0], gain=[1, 0]),
               dict(numtaps=50, freq=[0, 1.0], gain=[1, 1]), dict(numtaps=51, freq=[0, 0.6, 0.4, 1], gain=[1, 1, 0, 0]),
               dict(numtaps=51, freq=[0, 1.0], gain=[1, 0], antisymmetric=True),
               dict(numtaps=51, freq=[0, 1.0], gain=[1, 0], nfreqs=17)):
        with pytest.raises(ValueError):
            tp.firwin2(**kw)


@pytest.mark.parametrize("kw", [
    dict(numtaps=31, bands=[0, 0.3, 0.4, 1.0], desired=[1, 1, 0, 0]),
    dict(numtaps=41, bands=[0, 10, 15, 30, 35, 50], desired=[0, 0, 1, 1, 0, 0], weight=[1, 10, 1], fs=100.0),
    dict(numtaps=21, bands=[0, 0.5, 0.5, 1.0], desired=[1, 0.5, 0.5, 0]),
], ids=str)
def test_firls_bit_equal(kw):
    got = tp.firls(**kw)
    assert _same(got, sp.firls(**kw))
    assert np.max(np.abs(got - ss.firls(**kw))) <= 1e-9
    with pytest.raises(ValueError):
        tp.firls(30, kw["bands"], kw["desired"])
    with pytest.raises(ValueError):
        tp.firls(31, [0, 0.5, 0.4, 1.0], [1, 1, 0, 0])


@pytest.mark.parametrize("kw", [
    dict(numtaps=31, bands=[0, 0.1, 0.2, 0.5], desired=[1, 0]),
    dict(numtaps=32, bands=[0, 0.1, 0.2, 0.5], desired=[1, 0], weight=[1, 5]),
    dict(numtaps=45, bands=[0, 0.1, 0.15, 0.3, 0.35, 0.5], desired=[0, 1, 0]),
    dict(numtaps=31, bands=[0.05, 0.45], desired=[1], type="hilbert"),
    dict(numtaps=30, bands=[0, 0.4], desired=[1], type="differentiator"),
    dict(numtaps=41, bands=[0, 100, 150, 500], desired=[1, 0], fs=1000.0, maxiter=3),
], ids=str)
def test_remez_bit_equal(kw):
    got = tp.remez(**kw)
    assert _same(got, sp.remez(**kw))


def test_remez_errors():
    for kw in (dict(numtaps=2, bands=[0, 0.5], desired=[1]), dict(numtaps=31, bands=[0, 0.2, 0.3], desired=[1, 0]),
               dict(numtaps=31, bands=[0, 0.3, 0.2, 0.5], desired=[1, 0]), dict(numtaps=31, bands=[0, 0.2, 0.3, 0.5], desired=[1]),
               dict(numtaps=31, bands=[0, 0.2, 0.3, 0.5], desired=[1, 0], weight=[1, -1]),
               dict(numtaps=31, bands=[0, 0.2, 0.3, 0.5], desired=[1, 0], type="bogus")):
        with pytest.raises(ValueError):
            tp.remez(**kw)


@pytest.mark.parametrize("args", [(5, 2), (7, 3, 1, 0.5), (6, 2, 0, 1.0, 1.5), (9, 4, 2, 1.0, None, "dot"), (5, 2, 3)])
def test_savgol_coeffs_bit_equal(args):
    got = tp.savgol_coeffs(*args)
    assert _same(got, sp.savgol_coeffs(*args))
    with pytest.raises(ValueError):
        tp.savgol_coeffs(5, 5)
    with pytest.raises(ValueError):
        tp.savgol_coeffs(5, 2, pos=9)
    with pytest.raises(ValueError):
        tp.savgol_coeffs(5, 2, use="bogus")


@pytest.mark.parametrize("kw", [
    dict(hsize=(9, 11), window=("hamming", "hann"), fc=0.4),
    dict(hsize=(9, 9), window="hamming", fc=0.5, circular=True),
    dict(hsize=(7, 9), window=(("kaiser", 4.0), "hamming"), fc=[0.2, 0.6], pass_zero=False),
], ids=str)
def test_firwin_2d_bit_equal(kw):
    assert _same(tp.firwin_2d(**kw), sp.firwin_2d(**kw))
    with pytest.raises(ValueError):
        tp.firwin_2d((9,), "hamming", fc=0.3)
    with pytest.raises(ValueError):
        tp.firwin_2d((9, 9), "hamming", circular=True)
    with pytest.raises(ValueError):
        tp.firwin_2d((9, 9), "hamming", fc=0.3)


@pytest.mark.parametrize("kw", [dict(freq=440.0, ftype="fir", fs=16000.0),
                                dict(freq=1000.0, ftype="fir", order=3, numtaps=64, fs=8000.0),
                                dict(freq=440.0, ftype="iir", fs=16000.0), dict(freq=0.3, ftype="iir")], ids=str)
def test_gammatone_bit_equal(kw):
    got, want = tp.gammatone(**kw), sp.gammatone(**kw)
    assert _same(got[0], want[0]) and _same(got[1], want[1])
    ref = ss.gammatone(**kw)
    assert np.max(np.abs(got[0] - ref[0])) <= 1e-9 * max(1.0, np.max(np.abs(ref[0])))
    for bad in (dict(freq=9000.0, ftype="fir", fs=16000.0), dict(freq=100.0, ftype="bogus", fs=16000.0),
                dict(freq=100.0, ftype="fir", order=30, fs=16000.0)):
        with pytest.raises(ValueError):
            tp.gammatone(**bad)


@pytest.mark.parametrize("kw", [dict(nbits=5), dict(nbits=8, length=100), dict(nbits=6, state=[1, 0, 0, 1, 0, 1]),
                                dict(nbits=7, taps=[6, 1], length=50)], ids=str)
def test_max_len_seq_bit_equal(kw):
    got, want = tp.max_len_seq(**kw), sp.max_len_seq(**kw)
    assert _same(got[0], want[0]) and _same(got[1], want[1])
    if "taps" not in kw:
        ref = ss.max_len_seq(**kw)
        assert np.array_equal(got[0], ref[0]) and np.array_equal(got[1], ref[1])
    with pytest.raises(ValueError):
        tp.max_len_seq(40)
    with pytest.raises(ValueError):
        tp.max_len_seq(5, state=[0, 0, 0, 0, 0])
    with pytest.raises(ValueError):
        tp.max_len_seq(5, taps=[7])


def test_resample_window_bit_equal():
    for window in ("hann", ("kaiser", 4.0), np.linspace(0, 1, 50), lambda f: np.exp(-f ** 2)):
        assert _same(tsig._resample_window(window, 50), jsig._resample_window(window, 50))
    with pytest.raises(ValueError):
        tsig._resample_window(np.ones(10), 50)
    assert tsig._upfirdn_len(61, 100, 3, 2) == jsig._upfirdn_len(61, 100, 3, 2)


def test_deconvolve_bit_equal(rng):
    sig, div = rng.standard_normal(20), rng.standard_normal(5)
    got, want = tp.deconvolve(sig, div), sp.deconvolve(sig, div)
    assert _same(got[0], want[0]) and _same(got[1], want[1])
    ref = ss.deconvolve(sig, div)
    assert np.max(np.abs(got[0] - ref[0])) <= 1e-8 * np.max(np.abs(ref[0]))
    got, want = tp.deconvolve(div, sig), sp.deconvolve(div, sig)
    assert _same(got[0], want[0]) and _same(got[1], want[1])
    with pytest.raises(ValueError):
        tp.deconvolve(sig, [0.0, 1.0])


@pytest.mark.parametrize("worN,whole", [(512, False), (100, True), (8, False), ("grid", False)])
def test_freqz(rng, worN, whole):
    b = ss.firwin(31, 0.3).astype(np.float32)
    a = np.array([1.0, -0.5, 0.2], np.float32)
    if worN == "grid":
        worN = np.linspace(0.1, 3.0, 37)
    for den in (1.0, a):
        w_want, h_want = sp.freqz(b, den, worN, whole)
        w, h = tp.freqz(_t(b), den if np.isscalar(den) else _t(den), worN, whole)
        assert np.array_equal(w, w_want) and h.dtype == torch.complex64
        assert _rel(h, h_want) <= TOL
    w, h = tp.freqz(b, a, worN, whole, fs=100.0, device="cpu")
    assert _rel(h, ss.freqz(b.astype(np.float64), a.astype(np.float64), worN, whole, fs=100.0)[1]) <= 2e-5
    zb = (b + 0.1j * b[::-1]).astype(np.complex64)
    assert _rel(tp.freqz(_t(zb), 1.0, np.linspace(0, 3, 20))[1],
                sp.freqz(zb, 1.0, np.linspace(0, 3, 20))[1]) <= TOL
    with pytest.raises(ValueError):
        tp.freqz(_t(b)[None])
    with pytest.raises(ValueError):
        tp.freqz(_t(b), worN=0)
    with pytest.raises(ValueError):
        tp.freqz(_t(b), worN=np.ones((2, 2)))


@pytest.mark.parametrize("whole", [False, True])
def test_group_delay(whole):
    b = ss.firwin(21, 0.4)
    a = np.array([1.0, -0.3])
    w_want, want = sp.group_delay((b, a), 128, whole)
    w, got = tp.group_delay((b, a), 128, whole, device="cpu")
    assert np.array_equal(w, w_want)
    assert _rel(got, want) <= 5e-3
    _, got = tp.group_delay((b, 1.0), 64, device="cpu")
    assert _rel(got, np.full(64, 10.0)) <= 1e-3     # a linear-phase filter delays by (N-1)/2
    with pytest.raises(ValueError):
        tp.group_delay((np.ones((2, 2)), 1.0), device="cpu")


@pytest.mark.parametrize("mode", ["interp", "mirror", "nearest", "wrap", "constant"])
@pytest.mark.parametrize("wl,order,deriv", [(7, 2, 0), (11, 3, 1), (5, 4, 2)])
def test_savgol_filter(rng, mode, wl, order, deriv):
    x = rng.standard_normal((3, 80)).astype(np.float32)
    kw = dict(deriv=deriv, delta=0.5, mode=mode, cval=1.5)
    want = sp.savgol_filter(x, wl, order, **kw)
    assert _rel(tp.savgol_filter(_t(x), wl, order, **kw), want) <= TOL
    assert _rel(tp.savgol_filter(_t(x.T.copy()), wl, order, axis=0, **kw), np.asarray(want).T) <= TOL
    assert _rel(tp.savgol_filter(_t(x), wl, order, **kw),
                ss.savgol_filter(x.astype(np.float64), wl, order, **kw)) <= 1e-4


def test_savgol_filter_errors():
    x = torch.zeros(20)
    with pytest.raises(ValueError):
        tp.savgol_filter(x, 5, 2, mode="bogus")
    with pytest.raises(ValueError):
        tp.savgol_filter(x, 6, 2)
    with pytest.raises(ValueError):
        tp.savgol_filter(x[:4], 5, 2)
