"""PyTorch port: ``ops/scattering.py`` and ``ops/cqt.py`` against the JAX
package on the same inputs.

The filter banks and CQT kernels are host numpy float64, the JAX modules'
code line for line, kept on the device once built: held bit-equal.  The
transforms are held at 1e-5 of the output's maximum (the JAX package's own
CQT tolerance against its dense float64 oracle, ``tests/test_cqt.py``), and
the CQT also against that dense oracle, written out here."""

import jax
import numpy as np
import pytest
import scipy.signal as ss
import torch

import mixed_radix_fast_fourier_transform_tpu as sp
from mixed_radix_fast_fourier_transform_tpu.ops import cqt as jcqt, scattering as jscat

import mixed_radix_fast_fourier_transform_tpu_torch as tp
from mixed_radix_fast_fourier_transform_tpu_torch.ops import cqt as tcqt, scattering as tscat
from mixed_radix_fast_fourier_transform_tpu_torch.utils.metrics import get_metrics

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


def test_host_banks_and_kernels_bit_equal():
    for got, want in ((tscat._scattering_bank(1024, 4, 4, None), jscat._scattering_bank(1024, 4, 4, None)),
                      (tscat._scattering_bank_2d(32, 32, 2, 4), jscat._scattering_bank_2d(32, 32, 2, 4)),
                      (tcqt._cqt_spectral_kernel(8000.0, 55.0, 48, 12, "hann", 1.0, None),
                       jcqt._cqt_spectral_kernel(8000.0, 55.0, 48, 12, "hann", 1.0, None)),
                      (tcqt._icqt_dual_kernel(8000.0, 55.0, 48, 12, "hann", 1.0, None, 1e-6),
                       jcqt._icqt_dual_kernel(8000.0, 55.0, 48, 12, "hann", 1.0, None, 1e-6))):
        for g, w in zip(got, want):
            if isinstance(w, tuple):
                assert g == w
            else:
                assert np.array_equal(np.asarray(g), np.asarray(w))
    assert np.array_equal(tp.cqt_frequencies(48, 55.0, 12), sp.cqt_frequencies(48, 55.0, 12))


@pytest.mark.parametrize("kw", [dict(J=3, Q=4), dict(J=3, Q=2, stride=2, w=5.0)], ids=["J3Q4", "stride"])
def test_scattering1d(rng, kw):
    x = rng.standard_normal((2, 256)).astype(np.float32)
    got = tp.scattering1d(_t(x), **kw)
    want = jax.jit(lambda v: sp.scattering1d(v, **kw)[:3])(x)
    for g, w in zip(got[:3], want):
        assert _rel(g, w) <= TOL
    meta = jscat._scattering_bank(256, kw["J"], kw["Q"], kw.get("w"))[3:]
    assert np.array_equal(got[3][0], meta[0]) and np.array_equal(got[3][1], meta[1])
    assert got[3][2] == [(j1, j2) for j1 in range(len(meta[0])) for j2 in range(len(meta[1]))
                         if meta[1][j2] < 0.5 * meta[0][j1]]


def test_scattering2d_and_banks_stay_on_the_device(rng):
    x = rng.standard_normal((2, 8, 8)).astype(np.float32)
    got = tp.scattering2d(_t(x), J=2, L=2)
    want = jax.jit(lambda v: sp.scattering2d(v, J=2, L=2)[:3])(x)
    for g, w in zip(got[:3], want):
        assert _rel(g, w) <= TOL
    assert got[3] == (((0, 0), (0, 1), (1, 0), (1, 1)), [(0, 2), (0, 3), (1, 2), (1, 3)])
    before = get_metrics().get("constant_uploads", 0)
    tp.scattering2d(_t(x), J=2, L=2)
    assert get_metrics().get("constant_uploads", 0) == before


def _dense_cqt(x, fs, fmin, n_bins, B, hop, window="hann", filter_scale=1.0):
    """The CQT by its definition in float64: each band's window times
    e^(2πi·f·n/fs) over its length, correlated at frames t·hop."""
    freqs = fmin * 2.0 ** (np.arange(n_bins) / B)
    Q = filter_scale / (2.0 ** (1.0 / B) - 1.0)
    lengths = [max(int(round(Q * fs / f)), 1) for f in freqs]
    nf = 1 << int(np.ceil(np.log2(max(lengths))))
    xp = np.concatenate([np.zeros(nf // 2), x, np.zeros(nf // 2)])
    frames = np.lib.stride_tricks.sliding_window_view(xp, nf)[::hop]
    out = np.empty((frames.shape[0], n_bins), complex)
    for k, (f, n_k) in enumerate(zip(freqs, lengths)):
        m = np.arange(n_k) - (n_k - 1) / 2.0
        g = ss.get_window(window, n_k, fftbins=False) * np.exp(2j * np.pi * f / fs * m) / n_k
        s = (nf - n_k) // 2
        out[:, k] = frames[:, s: s + n_k] @ np.conj(g)
    return out


@pytest.mark.parametrize("kw", [dict(fs=8000.0, fmin=55.0, n_bins=48, hop=256),
                                dict(fs=8000.0, fmin=110.0, n_bins=24, hop=128, window="hamming",
                                     filter_scale=0.8)], ids=["hann", "hamming"])
def test_cqt(rng, kw):
    x = rng.standard_normal(4096)
    got = tp.cqt(_t(x.astype(np.float32)), **kw)
    assert got.dtype == torch.complex64
    assert _rel(got, jax.jit(lambda v: sp.cqt(v, **kw))(x.astype(np.float32))) <= TOL
    assert _rel(got, _dense_cqt(x, kw["fs"], kw["fmin"], kw["n_bins"], 12, kw["hop"],
                                kw.get("window", "hann"), kw.get("filter_scale", 1.0))) <= TOL


def test_cqt_batch_complex_and_array_window(rng):
    x = (rng.standard_normal((2, 2, 2048)) + 1j * rng.standard_normal((2, 2, 2048))).astype(np.complex64)
    kw = dict(fs=4000.0, fmin=60.0, n_bins=24, hop=256)
    assert _rel(tp.cqt(_t(x), **kw), jax.jit(lambda v: sp.cqt(v, **kw))(x)) <= TOL
    win = ("kaiser", 8.0)
    want = jax.jit(lambda v: sp.cqt(v, window=win, **kw))(x.real.copy())
    assert _rel(tp.cqt(_t(x.real.copy()), window=win, **kw), want) <= TOL


@pytest.mark.parametrize("n_iter", [0, 2])
def test_icqt(rng, n_iter):
    fs = 8000.0
    freqs = tp.cqt_frequencies(48, 55.0, 12)
    t = np.arange(4096) / fs
    sig = (np.cos(2 * np.pi * freqs[20] * t) + 0.5 * np.cos(2 * np.pi * freqs[35] * t)).astype(np.float32)
    kw = dict(fs=fs, fmin=55.0, hop=256)
    C = tp.cqt(_t(sig), n_bins=48, **kw)
    got = tp.icqt(C, length=4096, n_iter=n_iter, **kw)
    want = jax.jit(lambda c: sp.icqt(c, length=4096, n_iter=n_iter, **kw))(C.numpy())
    assert _rel(got, want) <= TOL
    sl = slice(1000, 3000)
    assert np.corrcoef(_np(got)[sl], sig[sl])[0, 1] > 0.9


def test_errors():
    with pytest.raises(ValueError):
        tp.cqt(torch.zeros(64), fs=100.0, fmin=40.0, n_bins=24)
    with pytest.raises(ValueError):
        tp.cqt(torch.zeros(64), hop=0)
    with pytest.raises(ValueError):
        tp.cqt(torch.zeros(4096), fs=8000.0, fmin=55.0, n_bins=12, n_fft=16)
    with pytest.raises(ValueError):
        tp.icqt(torch.zeros(4, 12, dtype=torch.complex64), n_bins=24)
    with pytest.raises(ValueError):
        tp.scattering1d(torch.zeros(1000), J=4, stride=16)
    with pytest.raises(ValueError):
        tp.scattering1d(torch.zeros(16), J=4)
    with pytest.raises(ValueError):
        tp.scattering1d(torch.zeros(64, dtype=torch.complex64), J=2)
