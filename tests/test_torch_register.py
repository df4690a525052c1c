"""PyTorch port: images — ``ops/register.py`` and ``ops/ndimage.py`` —
against the JAX package and float64 numpy/scipy.

Tolerances: transforms 1e-5 of the output's maximum; registration
shifts equal to the JAX function's (both pick the same peak of the
cross-correlation and of its upsampled neighbourhood) and to the planted
shift within 1/upsample_factor; the translation-invariant error metric
err = sqrt(1 − q) through err² = 1 − q, to 1e-5 absolute (q sits near 1
for well-registered pairs, so the square root amplifies fp32's rounding of
q by 1/(2·err)); the Fourier filters' transfer
functions are host float64 tables in both packages, so their products
agree to rounding.  Inputs come from a generator made for each case."""

import jax
import numpy as np
import pytest
import scipy.ndimage as nd
import scipy.signal as ss
import torch

from mixed_radix_fast_fourier_transform_tpu.ops import ndimage as jnd
from mixed_radix_fast_fourier_transform_tpu.ops import register as jreg

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


def _pair(rng, shape, shifts):
    """A smooth random image and copies moved by the given sub-pixel shifts."""
    img = nd.gaussian_filter(rng.standard_normal(shape), 2.0)
    moved = np.stack([np.fft.ifftn(nd.fourier_shift(np.fft.fftn(img), s)).real for s in shifts])
    ref = np.broadcast_to(img, moved.shape)
    return ref.astype(np.float32), moved.astype(np.float32)


@pytest.mark.parametrize("up,norm", [(1, "phase"), (20, "phase"), (10, None)])
def test_phase_cross_correlation(case_rng, up, norm):
    shifts = [(3.35, -2.6), (-7.15, 4.05)]
    ref, mov = _pair(case_rng, (64, 48), shifts)
    shift, err = tp.phase_cross_correlation(torch.from_numpy(ref), torch.from_numpy(mov), up, norm)
    jshift, jerr = jax.jit(lambda a, b: jreg.phase_cross_correlation(a, b, up, norm))(ref, mov)
    assert np.array_equal(shift.numpy(), np.asarray(jshift))
    assert np.max(np.abs(err.numpy() ** 2 - np.asarray(jerr) ** 2)) <= 1e-5
    assert np.max(np.abs(shift.numpy() + np.array(shifts))) <= (0.5 if up == 1 else 1.0 / up) + 1e-6


def test_fourier_shift(case_rng):
    x = case_rng.standard_normal((2, 32, 20)).astype(np.float32)
    s = np.array([[1.5, -2.25], [0.3, 4.0]], np.float32)
    got = tp.fourier_shift(torch.from_numpy(x), torch.from_numpy(s))
    assert _rel(got, jreg.fourier_shift(x, s)) <= TOL
    ref = np.stack([np.fft.ifftn(nd.fourier_shift(np.fft.fftn(x[i].astype(np.float64)), s[i])).real
                    for i in range(2)])
    assert _rel(got, ref) <= TOL
    xc = (x + 1j * x[:, ::-1]).astype(np.complex64)
    assert _rel(tp.fourier_shift(torch.from_numpy(xc), torch.from_numpy(s)), jreg.fourier_shift(xc, s)) <= TOL


def test_unwrap_phase_2d(case_rng):
    yy, xx = np.mgrid[:48, :40]
    phase = 0.004 * (yy - 20.0) ** 2 + 0.11 * xx + 0.3 * np.sin(yy / 7.0)
    wrapped = np.angle(np.exp(1j * phase)).astype(np.float32)
    got = tp.unwrap_phase_2d(torch.from_numpy(wrapped))
    assert _rel(got, jax.jit(jreg.unwrap_phase_2d)(wrapped)) <= TOL
    assert _rel(got, phase - phase.mean()) <= 1e-4


@pytest.mark.parametrize("name,arg", [("fourier_gaussian", 2.5), ("fourier_uniform", (3.0, 5.0)),
                                      ("fourier_ellipsoid", (4.0, 6.0))])
@pytest.mark.parametrize("real", [False, True])
def test_fourier_filters(case_rng, name, arg, real):
    img = case_rng.standard_normal((40, 30))
    X = (np.fft.rfft2(img) if real else np.fft.fft2(img)).astype(np.complex64)
    n = 30 if real else -1
    got = getattr(tp, name)(torch.from_numpy(X), arg, n=n)
    assert _rel(got, getattr(jnd, name)(X, arg, n=n)) <= 1e-6
    assert _rel(got, getattr(nd, name)(X.astype(np.complex128), arg, n=n)) <= TOL


def test_fourier_ellipsoid_1d_3d(case_rng):
    for shape, size in [((64,), 5.0), ((8, 10, 12), (2.0, 3.0, 4.0))]:
        X = np.fft.fftn(case_rng.standard_normal(shape)).astype(np.complex64)
        got = tp.fourier_ellipsoid(torch.from_numpy(X), size)
        assert _rel(got, jnd.fourier_ellipsoid(X, size)) <= 1e-6
        assert _rel(got, nd.fourier_ellipsoid(X.astype(np.complex128), size)) <= TOL


@pytest.mark.parametrize("size,noise", [(3, None), ((5, 3), None), ((3, 7), 0.5)])
def test_wiener(case_rng, size, noise):
    x = (case_rng.standard_normal((50, 40)) + 3.0).astype(np.float32)
    got = tp.wiener(torch.from_numpy(x), size, noise)
    assert _rel(got, jax.jit(lambda v: jnd.wiener(v, size, noise))(x)) <= TOL
    assert _rel(got, ss.wiener(x.astype(np.float64), size, noise)) <= TOL
