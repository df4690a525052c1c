"""PyTorch port: ``ops/tfr.py`` against the JAX package on the same inputs.

Tolerance: 1e-5 of the output's maximum for the quadratic distributions,
the Stockwell transform and its inverse, the ambiguity function and the
synchrosqueezed inversions.  The synchrosqueezing and reassignment steps
move each cell to a bin chosen by rounding an fp32 estimate, so two fp32
evaluations may send a cell on a bin edge to the next bin (ROADMAP F2): they
are compared on structured input (tones and chirps), by the marginals the
move keeps (the sum over bins of ``ssq_cwt``/``ssq_stft``, the total energy
of ``reassigned_spectrogram``), and cell by cell loosely (0.25 of the
maximum), as the JAX package's own tests compare its batched and single
calls.  A cell whose magnitude sits at the drop threshold (``gamma`` = 1e-4
of the largest) may be kept by one evaluation and dropped by the other, so
the marginals are held to 5·gamma.  The frequency grids are host float64 in
both packages; the jitted JAX function returns them in fp32."""

import jax
import numpy as np
import pytest
import torch

import mixed_radix_fast_fourier_transform_tpu as sp

import mixed_radix_fast_fourier_transform_tpu_torch as tp

torch.set_num_threads(1)

TOL = 1e-5
BIN_FLIP_TOL = 0.25
MARGINAL_TOL = 5e-4
GRID_TOL = 1e-7


def _np(v):
    return v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _rel(got, want, scale=None):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.max(np.abs(got - want)) / (scale or max(np.max(np.abs(want)), 1e-30))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _signals(T=256, rows=2):
    t = np.arange(T)
    chirp = np.cos(2 * np.pi * (0.03 * t + 0.5 * (0.2 / T) * t * t))
    tones = np.cos(2 * np.pi * 0.05 * t) + 0.7 * np.cos(2 * np.pi * 0.17 * t + 0.3)
    return np.stack([chirp, tones][:rows]).astype(np.float32)


@pytest.mark.parametrize("name,kw", [
    ("wigner_ville", dict()), ("wigner_ville", dict(nperseg=33, hop=4, analytic=False)),
    ("choi_williams", dict(sigma=0.5, nperseg=31)), ("cohen_class", dict(kernel="born-jordan", nperseg=31)),
    ("cohen_class", dict(kernel="wigner", nperseg=31, hop=2)), ("ambiguity", dict(max_lag=20)),
], ids=lambda v: v if isinstance(v, str) else "-".join(f"{k}={w}" for k, w in v.items()) or "default")
def test_quadratic_distributions(name, kw):
    x = _signals()
    got = getattr(tp, name)(_t(x), **kw)
    assert got.device.type == "cpu"
    assert _rel(got, jax.jit(lambda v: getattr(sp, name)(v, **kw))(x)) <= TOL


def test_cross_wigner_ville():
    x = _signals()
    got = tp.xwigner_ville(_t(x[0]), _t(x[1]), nperseg=31)
    assert _rel(got, jax.jit(lambda a, b: sp.xwigner_ville(a, b, nperseg=31))(x[0], x[1])) <= TOL


@pytest.mark.parametrize("kw", [dict(), dict(fmin=8, fmax=40, gamma=2.0)], ids=["full", "band"])
def test_stockwell_and_inverse(kw):
    x = _signals(T=255)
    S, freqs = tp.stockwell(_t(x), **kw)
    jS, jfreqs = jax.jit(lambda v: sp.stockwell(v, **kw))(x)
    assert np.max(np.abs(freqs - np.asarray(jfreqs))) <= GRID_TOL and _rel(S, jS) <= TOL
    if not kw:
        assert _rel(tp.istockwell(S), x) <= TOL
        assert _rel(tp.istockwell(S), sp.istockwell(jS)) <= TOL


def _squeezed(got, want, axis):
    """The marginal over bins, and cells loosely (a bin flip moves one
    cell's value to its neighbour)."""
    (S, f), (jS, jf) = got, want
    assert np.max(np.abs(f - np.asarray(jf)) / np.max(f)) <= GRID_TOL
    scale = max(1.0, float(np.max(np.abs(np.asarray(jS)))))
    assert _rel(S.sum(axis), np.asarray(jS).sum(axis), scale) <= MARGINAL_TOL
    assert _rel(S, jS, scale) <= BIN_FLIP_TOL


def test_ssq_cwt_and_inverse():
    x = _signals(T=256)
    kw = dict(n_scales=32, fmin=0.02, fmax=0.4)
    got = tp.ssq_cwt(_t(x), **kw)
    want = jax.jit(lambda v: sp.ssq_cwt(v, **kw))(x)
    _squeezed(got, want, -2)
    assert _rel(tp.issq_cwt(got[0], **kw), sp.issq_cwt(np.asarray(got[0].numpy()), **kw)) <= TOL


@pytest.mark.parametrize("kw", [dict(), dict(nperseg=64, noverlap=56, window="hamming")], ids=["default", "opts"])
def test_ssq_stft_and_inverse(kw):
    x = _signals(T=1024)
    got = tp.ssq_stft(_t(x), **kw)
    want = jax.jit(lambda v: sp.ssq_stft(v, **kw))(x)
    _squeezed(got, want, -1)
    inv = dict(nperseg=kw.get("nperseg", 256), window=kw.get("window", "hann"))
    assert _rel(tp.issq_stft(got[0], **inv), sp.issq_stft(got[0].numpy(), **inv)) <= TOL


def test_reassigned_spectrogram():
    x = _signals(T=1024)
    E, f = tp.reassigned_spectrogram(_t(x), nperseg=128)
    jE, jf = jax.jit(lambda v: sp.reassigned_spectrogram(v, nperseg=128))(x)
    assert np.max(np.abs(f - np.asarray(jf))) <= GRID_TOL
    assert _rel(E.sum((-2, -1)), np.asarray(jE).sum((-2, -1))) <= MARGINAL_TOL
    assert _rel(E, jE) <= BIN_FLIP_TOL


def test_errors():
    for call in (lambda: tp.wigner_ville(torch.ones(2)), lambda: tp.wigner_ville(torch.ones(64), nperseg=32),
                 lambda: tp.wigner_ville(torch.ones(64), nperseg=129),
                 lambda: tp.wigner_ville(torch.ones(64), nperseg=33, hop=0),
                 lambda: tp.issq_stft(torch.zeros(4, 12, dtype=torch.complex64), nperseg=256),
                 lambda: tp.issq_cwt(torch.zeros(4, 8, dtype=torch.complex64), fmin=0.4, fmax=0.2),
                 lambda: tp.reassigned_spectrogram(torch.zeros(64, dtype=torch.complex64)),
                 lambda: tp.stockwell(torch.ones(64), fmin=40, fmax=10),
                 lambda: tp.istockwell(torch.zeros(10, 64, dtype=torch.complex64))):
        with pytest.raises(ValueError):
            call()
