"""PyTorch port: ``ops/hos.py`` (bispectrum, bicoherence), ``ops/cwt.py``
(ricker, morlet2, cwt, tc_scales, cwt_tc, xwt, wct) and ``ops/auditory.py``
(erb_space, gammatone_filterbank, gammatonegram, modulation_spectrum)
against the JAX package on the same inputs.

Tolerance: 1e-5 of the output's maximum; host tables (wavelets, scale
ladders, ERB grids, gammatone banks) bit-equal.  The bicoherence and the
wavelet coherence are ratios of averaged fp32 products in [0, 1], compared
at 1e-4 absolute."""

import numpy as np
import pytest
import torch

import mixed_radix_fast_fourier_transform_tpu as sp

import mixed_radix_fast_fourier_transform_tpu_torch as tp

torch.set_num_threads(1)

TOL = 1e-5
RATIO_TOL = 1e-4


def _np(v):
    return v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _rel(got, want):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _coupled(rng, n=4096, coupled=True):
    t = np.arange(n)
    p1, p2 = rng.uniform(0, 2 * np.pi, 2)
    p3 = p1 + p2 if coupled else rng.uniform(0, 2 * np.pi)
    x = (np.cos(2 * np.pi * 0.11 * t + p1) + np.cos(2 * np.pi * 0.17 * t + p2)
         + np.cos(2 * np.pi * 0.28 * t + p3) + 0.1 * rng.standard_normal(n))
    return x.astype(np.float32)


@pytest.mark.parametrize("kw", [dict(), dict(nperseg=64, noverlap=48, window="hamming", nfreq=20),
                                dict(nperseg=100, detrend=False)], ids=str)
def test_bispectrum(rng, kw):
    x = np.stack([_coupled(rng), _coupled(rng, coupled=False)])
    want = sp.bispectrum(x, **kw)
    got = tp.bispectrum(_t(x), **kw)
    assert got.dtype == torch.complex64 and _rel(got, want) <= TOL
    got, freqs = tp.bispectrum(_t(x), return_freqs=True, **kw)
    assert np.array_equal(freqs, sp.bispectrum(x, return_freqs=True, **kw)[1])


@pytest.mark.parametrize("kw", [dict(), dict(nperseg=64, nfreq=24)], ids=str)
def test_bicoherence(rng, kw):
    x = np.stack([_coupled(rng), _coupled(rng, coupled=False)])
    want = np.asarray(sp.bicoherence(x, **kw))
    got = tp.bicoherence(_t(x), **kw)
    assert np.max(np.abs(_np(got) - want)) <= RATIO_TOL
    assert np.array_equal(tp.bicoherence(_t(x), return_freqs=True, **kw)[1],
                          sp.bicoherence(x, return_freqs=True, **kw)[1])
    assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0 + 1e-5


def test_hos_errors():
    x = torch.zeros(100)
    with pytest.raises(ValueError):
        tp.bispectrum(x, nperseg=128)
    with pytest.raises(ValueError):
        tp.bicoherence(torch.zeros(300), nperseg=64, noverlap=64)


def test_wavelets_bit_equal():
    for points, a in ((100, 4.0), (17, 2.5), (1, 1.0)):
        assert np.array_equal(tp.ricker(points, a), sp.ricker(points, a))
        assert np.array_equal(tp.morlet2(points, a, 6.0), sp.morlet2(points, a, 6.0))
    for fn in (tp.ricker, tp.morlet2):
        with pytest.raises(ValueError):
            fn(0, 1.0)
    for args in ((256,), (300, 0.5, 0.25, 1.0, 20), (100, 1.0, 1 / 12, 4.0)):
        assert np.array_equal(tp.tc_scales(*args), sp.tc_scales(*args))
    with pytest.raises(ValueError):
        tp.tc_scales(4, s0=100.0)


@pytest.mark.parametrize("wavelet,widths", [("ricker", [1, 2, 4, 8.5]), ("morlet2", [3.0, 6.0, 12.0])])
def test_cwt(rng, wavelet, widths):
    x = rng.standard_normal((2, 200)).astype(np.float32)
    want = sp.cwt(x, getattr(sp, wavelet), widths)
    got = tp.cwt(_t(x), getattr(tp, wavelet), widths)
    assert got.shape == (len(widths), 2, 200) and _rel(got, want) <= TOL
    assert got.dtype == (torch.complex64 if wavelet == "morlet2" else torch.float32)
    assert _rel(tp.cwt(_t(x[0]), getattr(tp, wavelet), widths),
                sp.cwt(x[0], getattr(sp, wavelet), widths)) <= TOL
    z = (x[0] + 1j * x[1]).astype(np.complex64)
    assert _rel(tp.cwt(_t(z), getattr(tp, wavelet), widths),
                sp.cwt(z, getattr(sp, wavelet), widths)) <= TOL
    with pytest.raises(ValueError):
        tp.cwt(_t(x), tp.ricker, [])
    with pytest.raises(ValueError):
        tp.cwt(torch.zeros(0), tp.ricker, [1])


def test_cwt_tc_xwt_wct(rng):
    n = 256
    t = np.arange(n)
    x = (np.sin(2 * np.pi * t / 16) + 0.3 * rng.standard_normal((2, n))).astype(np.float32)
    y = (np.sin(2 * np.pi * (t - 2) / 16) + 0.3 * rng.standard_normal((2, n))).astype(np.float32)
    scales = tp.tc_scales(n, dj=0.25)
    assert _rel(tp.cwt_tc(_t(x), scales), sp.cwt_tc(x, scales)) <= TOL
    assert _rel(tp.cwt_tc(_t(x), scales[:5], dt=0.5, w0=8.0), sp.cwt_tc(x, scales[:5], dt=0.5, w0=8.0)) <= TOL
    got, want = tp.xwt(_t(x), _t(y), dj=0.25), sp.xwt(x, y, dj=0.25)
    assert _rel(got[0], want[0]) <= TOL
    assert np.array_equal(got[1], want[1]) and np.array_equal(got[2], want[2])
    got, want = tp.wct(_t(x), _t(y), dj=0.25), sp.wct(x, y, dj=0.25)
    assert np.max(np.abs(_np(got[0]) - np.asarray(want[0]))) <= RATIO_TOL
    assert np.array_equal(got[1], want[1]) and np.array_equal(got[2], want[2])
    self_coh = _np(tp.wct(_t(x), _t(x), dj=0.25)[0])
    assert np.min(self_coh) >= 1.0 - 1e-3
    with pytest.raises(ValueError):
        tp.cwt_tc(_t(x), [])
    with pytest.raises(ValueError):
        tp.cwt_tc(torch.zeros(1), [1.0])
    for fn in (tp.xwt, tp.wct):
        with pytest.raises(ValueError):
            fn(_t(x), _t(y[:, :100]))


def test_erb_space_and_filterbank_bit_equal():
    assert np.array_equal(tp.erb_space(50.0, 7000.0, 32), sp.erb_space(50.0, 7000.0, 32))
    with pytest.raises(ValueError):
        tp.erb_space(100.0, 50.0, 4)
    with pytest.raises(ValueError):
        tp.erb_space(50.0, 100.0, 0)
    for args in ((16, 16000.0), (8, 8000.0, 100.0, 3000.0, 64)):
        got, want = tp.gammatone_filterbank(*args), sp.gammatone_filterbank(*args)
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


@pytest.mark.parametrize("kw", [dict(n_filters=16), dict(n_filters=8, hop=50, fmin=100.0, fmax=3000.0, power=1.0)],
                         ids=str)
def test_gammatonegram(rng, kw):
    x = rng.standard_normal((2, 4000)).astype(np.float32)
    assert _rel(tp.gammatonegram(_t(x), 8000.0, **kw), sp.gammatonegram(x, 8000.0, **kw)) <= TOL
    pcm = (x[0] * 1000).astype(np.int16)
    assert _rel(tp.gammatonegram(_t(pcm), 8000.0, **kw), sp.gammatonegram(pcm, 8000.0, **kw)) <= TOL
    with pytest.raises(ValueError):
        tp.gammatonegram(torch.zeros(50), 8000.0)


def test_modulation_spectrum(rng):
    fs = 4000.0
    t = np.arange(4000) / fs
    x = ((1 + 0.8 * np.sin(2 * np.pi * 8 * t)) * np.sin(2 * np.pi * 500 * t)
         + 0.01 * rng.standard_normal((2, 4000))).astype(np.float32)
    got, want = tp.modulation_spectrum(_t(x), fs, 8), sp.modulation_spectrum(x, fs, 8)
    assert _rel(got[0], want[0]) <= 2e-5   # |.|^2 of an envelope spectrum: twice the relative error
    assert np.array_equal(got[1], want[1]) and np.array_equal(got[2], want[2])
    with pytest.raises(ValueError):
        tp.modulation_spectrum(torch.zeros(30), fs)
