"""PyTorch port: direction finding and line spectra — ``ops/beamform.py``,
``ops/subspace.py`` and ``ops/peaks.py`` — against the JAX package and
float64 numpy/scipy.

Tolerances: the device products (covariances, Bartlett and MVDR spectra,
MVDR weights, the correlation matrix) 1e-5 of the output's maximum; the
eigen-based estimators are compared through their spectra and the
directions and frequencies they find, never through eigenvectors (whose
phase is arbitrary); the host float64 stages copied from the JAX module
(steering matrices, MUSIC on one covariance, Prony, the peak pickers) are
held to exact equality; the rank filters are selections, so exact too.
Inputs come from a generator made for each case."""

import jax
import numpy as np
import pytest
import scipy.signal as ss
import torch

from mixed_radix_fast_fourier_transform_tpu.ops import beamform as jbf
from mixed_radix_fast_fourier_transform_tpu.ops import peaks as jpk
from mixed_radix_fast_fourier_transform_tpu.ops import subspace as jsub

import mixed_radix_fast_fourier_transform_tpu_torch as tp

torch.set_num_threads(1)

TOL = 1e-5


@pytest.fixture
def case_rng(request):
    return np.random.default_rng([ord(ch) for ch in request.node.name])


def _np(v):
    return v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _rel(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


def _snapshots(rng, n_el, T, angles, snr=20.0):
    A = jbf.steering_vector(n_el, angles)
    s = (rng.standard_normal((len(angles), T)) + 1j * rng.standard_normal((len(angles), T)))
    noise = 10 ** (-snr / 20) * (rng.standard_normal((n_el, T)) + 1j * rng.standard_normal((n_el, T)))
    return (A @ s + noise).astype(np.complex64)


ANGLES = [-20.0, 35.0]


@pytest.mark.parametrize("array", [8, np.array([[0.0, 0.0], [0.5, 0.1], [1.1, 0.0], [1.4, 0.3]])])
def test_steering_vector_is_the_jax_module_s(array):
    ang = np.linspace(-90, 90, 37)
    assert np.array_equal(tp.steering_vector(array, ang), jbf.steering_vector(array, ang))


@pytest.mark.parametrize("fb", [False, True])
def test_spatial_covariance_and_spectra(case_rng, fb):
    x = np.stack([_snapshots(case_rng, 8, 200, ANGLES) for _ in range(2)])
    R = tp.spatial_covariance(torch.from_numpy(x), fb)
    jR = jax.jit(lambda v: jbf.spatial_covariance(v, fb))(x)
    assert _rel(R, jR) <= TOL
    R64 = np.einsum("...it,...jt->...ij", x.astype(np.complex128), x.conj()) / 200
    if fb:
        R64 = 0.5 * (R64 + np.conj(R64)[..., ::-1, ::-1])
    assert _rel(R, R64) <= TOL
    for name, kw in [("bartlett_spectrum", {}), ("mvdr_spectrum", {}),
                     ("mvdr_spectrum", {"diagonal_loading": 0.1})]:
        ang, p = getattr(tp, name)(R, 8, **kw)
        jang, jp = getattr(jbf, name)(jR, 8, **kw)
        assert np.array_equal(ang, jang) and _rel(p, jp) <= TOL
        for b in range(2):   # both spectra peak at the planted angles
            peaks, _ = tp.find_peaks(p[b].numpy())
            top = np.sort(ang[peaks[np.argsort(p[b].numpy()[peaks])[-2:]]])
            assert np.allclose(top, ANGLES, atol=1.0)


def test_mvdr_weights_steer_and_null(case_rng):
    x = _snapshots(case_rng, 8, 400, ANGLES)
    R = tp.spatial_covariance(torch.from_numpy(x))
    w = tp.mvdr_weights(R, 8, ANGLES[0], diagonal_loading=0.01)
    jw = jbf.mvdr_weights(np.asarray(R.numpy()), 8, ANGLES[0], diagonal_loading=0.01)
    assert _rel(w, jw) <= TOL
    A = tp.steering_vector(8, ANGLES)
    gains = np.abs(w.numpy().conj() @ A)
    assert abs(gains[0] - 1.0) < 1e-5 and gains[1] < 0.1


def test_music_doa(case_rng):
    x = _snapshots(case_rng, 10, 300, ANGLES)
    R = tp.spatial_covariance(torch.from_numpy(x))
    # one covariance, host float64 eigenbasis in both: the same spectrum
    ang, p = tp.music_doa(R, 10, 2)
    jang, jp = jbf.music_doa(R.numpy(), 10, 2)
    assert np.array_equal(ang, jang) and np.array_equal(p, jp)
    # from each package's own covariance: the same directions
    _, jp2 = jbf.music_doa(jbf.spatial_covariance(x), 10, 2)
    for spec in (p, jp2):
        pk, _ = tp.find_peaks(spec)
        assert np.allclose(np.sort(ang[pk[np.argsort(spec[pk])[-2:]]]), ANGLES, atol=0.5)


# --------------------------------------------------------------------------- subspace

def _tones(rng, n, freqs, cplx):
    k = np.arange(n)
    if cplx:
        x = sum(np.exp(2j * np.pi * f * k) for f in freqs) + 0.05 * (
            rng.standard_normal(n) + 1j * rng.standard_normal(n))
        return x.astype(np.complex64)
    x = sum(np.cos(2 * np.pi * f * k + 0.3) for f in freqs) + 0.05 * rng.standard_normal(n)
    return x.astype(np.float32)


@pytest.mark.parametrize("cplx", [False, True])
def test_corr_matrix(case_rng, cplx):
    x = _tones(case_rng, 300, [0.1, 0.27], cplx)
    got = tp.corr_matrix(torch.from_numpy(x), 12)
    want = jsub.corr_matrix(x, 12)
    assert got.dtype == np.complex128 and _rel(got, want) <= TOL
    snaps = np.lib.stride_tricks.sliding_window_view(x.astype(np.complex128), 12)
    R = snaps.T @ snaps.conj() / snaps.shape[0]
    J = np.eye(12)[::-1]
    assert _rel(got, 0.5 * (R + J @ R.conj() @ J)) <= TOL


@pytest.mark.parametrize("cplx", [False, True])
def test_line_spectrum_estimators(case_rng, cplx):
    freqs = [0.12, 0.14]           # five FFT bins apart at n = 256
    x = _tones(case_rng, 256, freqs, cplx)
    p = 2 if cplx else 4
    xt = torch.from_numpy(x)
    f, P = tp.music(xt, p, m=16)
    jf, jP = jsub.music(x, p, m=16)
    assert np.array_equal(f, jf)
    for spec in (P, jP):
        pk, _ = tp.find_peaks(spec)
        found = np.sort(f[pk[np.argsort(spec[pk])[-2:]]])
        assert np.allclose(found, freqs, atol=2e-3)
    want = np.array(sorted(freqs if cplx else [-freqs[1], -freqs[0]] + freqs))
    for name in ("root_music", "esprit"):
        got = getattr(tp, name)(xt, p, m=16)
        ref = getattr(jsub, name)(x, p, m=16)
        assert np.allclose(got, ref, atol=1e-4) and np.allclose(got, want, atol=2e-3)


def test_prony_and_pisarenko_are_the_jax_module_s(case_rng):
    k = np.arange(64)
    x = (0.9 ** k * np.cos(2 * np.pi * 0.1 * k) + 0.5 * 0.95 ** k * np.cos(2 * np.pi * 0.3 * k))
    got, want = tp.prony(torch.from_numpy(x), 4, fs=2.0), jsub.prony(x, 4, fs=2.0)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    xc = _tones(case_rng, 128, [0.2], True)
    assert np.allclose(tp.pisarenko(torch.from_numpy(xc), 1), jsub.pisarenko(xc, 1), atol=1e-4)


# --------------------------------------------------------------------------- peaks

def _bumpy(rng, n=400):
    t = np.arange(n)
    x = sum(a * np.exp(-0.5 * ((t - c) / w) ** 2) for a, c, w in
            [(1.0, 60, 5), (0.6, 130, 12), (1.4, 220, 3), (0.8, 300, 20), (0.5, 360, 4)])
    x = x + 0.02 * rng.standard_normal(n)
    x[170:175] = 0.9  # a plateau
    return x


@pytest.mark.parametrize("kw", [
    {}, {"height": 0.5}, {"threshold": (0.001, None)}, {"distance": 30},
    {"prominence": 0.3}, {"width": (4, 30)}, {"plateau_size": 2},
    {"prominence": (0.2, 1.2), "wlen": 51, "width": 3, "rel_height": 0.7},
])
def test_find_peaks_is_the_jax_module_s(case_rng, kw):
    x = _bumpy(case_rng)
    got, props = tp.find_peaks(torch.from_numpy(x), **kw)
    want, jprops = jpk.find_peaks(x, **kw)
    assert np.array_equal(got, want) and props.keys() == jprops.keys()
    assert all(np.array_equal(props[k], jprops[k]) for k in props)
    ref, _ = ss.find_peaks(x, **kw)
    assert np.array_equal(got, ref)


def test_prominences_widths_and_relative_extrema(case_rng):
    x = _bumpy(case_rng)
    pk, _ = tp.find_peaks(x)
    for got, want in [(tp.peak_prominences(torch.from_numpy(x), pk, 41), jpk.peak_prominences(x, pk, 41)),
                      (tp.peak_widths(x, pk, 0.8), jpk.peak_widths(x, pk, 0.8))]:
        assert all(np.array_equal(g, w) for g, w in zip(got, want))
    y = case_rng.standard_normal((5, 40))
    for name in ("argrelmax", "argrelmin"):
        for kw in ({"order": 2}, {"axis": 1, "mode": "wrap"}):
            got = getattr(tp, name)(torch.from_numpy(y), **kw)
            assert all(np.array_equal(g, w) for g, w in zip(got, getattr(jpk, name)(y, **kw)))
    assert all(np.array_equal(g, w) for g, w in zip(
        tp.argrelextrema(y, np.greater_equal), jpk.argrelextrema(y, np.greater_equal)))


def test_find_peaks_cwt_is_the_jax_module_s(case_rng):
    x = _bumpy(case_rng, 500)
    widths = np.arange(2, 24)
    got = tp.find_peaks_cwt(torch.from_numpy(x), widths)
    assert np.array_equal(got, jpk.find_peaks_cwt(x, widths))
    assert len(got) >= 4


@pytest.mark.parametrize("kind", ["medfilt1", "medfilt2", "medfilt2d", "order"])
def test_rank_filters(case_rng, kind):
    x = case_rng.standard_normal((20, 31)).astype(np.float32)
    xt = torch.from_numpy(x)
    if kind == "medfilt1":
        got, want, ref = tp.medfilt(xt[0], 7), jpk.medfilt(x[0], 7), ss.medfilt(x[0], 7)
    elif kind == "medfilt2":
        got, want, ref = tp.medfilt(xt, (3, 5)), jpk.medfilt(x, (3, 5)), ss.medfilt(x, (3, 5))
    elif kind == "medfilt2d":
        got, want, ref = tp.medfilt2d(xt, 5), jpk.medfilt2d(x, 5), ss.medfilt2d(x, 5)
    else:
        dom = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]])
        got, want, ref = tp.order_filter(xt, dom, 3), jpk.order_filter(x, dom, 3), ss.order_filter(x, dom, 3)
    assert np.array_equal(got.numpy(), np.asarray(want)) and np.array_equal(got.numpy(), ref)
