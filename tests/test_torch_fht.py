"""PyTorch port: the fast Hankel transform (FFTLog) and the Walsh-Hadamard
transform against the JAX package and scipy.fft on the same inputs, on both
``use_kernel`` routes.  Tolerance: 1e-5 of the output's maximum; the host
coefficient tables are bit-equal to the JAX module's."""

import warnings

import numpy as np
import pytest
import scipy.fft
import scipy.linalg
import scipy.special
import torch

import mixed_radix_fast_fourier_transform_tpu as sp
from mixed_radix_fast_fourier_transform_tpu.ops import fht as jfht

import mixed_radix_fast_fourier_transform_tpu_torch as tp
from mixed_radix_fast_fourier_transform_tpu_torch.ops import fht as tfht

torch.set_num_threads(1)

TOL = 1e-5
ROUTES = {"kernel": tp.DEFAULT_CONFIG, "pipeline": tp.SpectralConfig(use_kernel=False)}
# (n, dln, mu, offset, bias)
CASES = [(128, 0.1, 0.0, 0.0, 0.0), (128, 0.1, 1.0, 0.1, 0.3), (64, 0.05, 2.5, -0.2, -0.4),
         (90, 0.2, 0.5, 0.0, 0.0), (45, 0.1, 1.0, 0.0, 0.2)]
IDS = [f"n{c[0]}-mu{c[2]}-q{c[4]}" for c in CASES]


def _rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


def test_loggamma_is_bit_equal_and_matches_scipy(rng):
    z = rng.uniform(-3, 6, 200) + 1j * rng.uniform(-8, 8, 200)
    got = tfht._loggamma(z)
    assert got.dtype == np.complex128 and np.array_equal(got, jfht._loggamma(z))
    want = scipy.special.loggamma(z)
    diff = got - want
    diff = diff.real + 1j * ((diff.imag + np.pi) % (2 * np.pi) - np.pi)   # same branch mod 2πi
    assert np.max(np.abs(diff) / np.maximum(1.0, np.abs(want))) <= 1e-11


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n,dln,mu,offset,bias", CASES, ids=IDS)
def test_fhtcoeff_and_offset_are_bit_equal(n, dln, mu, offset, bias, inverse):
    got = tfht.fhtcoeff(n, dln, mu, offset, bias, inverse)
    assert np.array_equal(got, jfht.fhtcoeff(n, dln, mu, offset, bias, inverse))
    assert tp.fhtoffset(dln, mu, offset, bias) == jfht.fhtoffset(dln, mu, offset, bias)
    assert abs(tp.fhtoffset(dln, mu, offset, bias)
               - scipy.fft.fhtoffset(dln, mu, offset, bias)) <= 1e-12


def test_singular_transform_warns_like_jax():
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        got = tfht.fhtcoeff(16, 0.1, 0.0, bias=-1.0)
        want = jfht.fhtcoeff(16, 0.1, 0.0, bias=-1.0)
    singular = [w for w in seen if "singular transform" in str(w.message)]
    assert len(singular) == 2 and np.array_equal(got, want) and got[0] == 0


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("n,dln,mu,offset,bias", CASES, ids=IDS)
def test_fht_and_ifht_match_jax_and_scipy(rng, route, n, dln, mu, offset, bias):
    a = np.abs(rng.standard_normal((3, n))).astype(np.float32)
    kw = dict(offset=offset, bias=bias)
    got = tp.fht(torch.from_numpy(a), dln, mu, config=ROUTES[route], **kw)
    assert got.dtype == torch.float32 and _rel(got, sp.fht(a, dln, mu, **kw)) <= TOL
    assert _rel(got, scipy.fft.fht(a.astype(np.float64), dln, mu, **kw)) <= TOL
    inv = tp.ifht(torch.from_numpy(a), dln, mu, config=ROUTES[route], **kw)
    assert _rel(inv, sp.ifht(a, dln, mu, **kw)) <= TOL
    assert _rel(inv, scipy.fft.ifht(a.astype(np.float64), dln, mu, **kw)) <= TOL
    assert _rel(tp.ifht(got, dln, mu, config=ROUTES[route], **kw), a) <= 5 * TOL


def test_fht_rejects_complex():
    z = torch.zeros(8, dtype=torch.complex64)
    with pytest.raises(ValueError):
        tp.fht(z, 0.1, 0.0)
    with pytest.raises(ValueError):
        tp.ifht(z, 0.1, 0.0)


@pytest.mark.parametrize("n", [1, 2, 64, 128, 256, 1024])
def test_fwht_is_the_hadamard_matrix(rng, n):
    x = rng.standard_normal((3, n)).astype(np.float32)
    got = tp.fwht(torch.from_numpy(x))
    assert _rel(got, x.astype(np.float64) @ scipy.linalg.hadamard(n)) <= TOL
    assert _rel(got, sp.fwht(x)) <= TOL
    assert _rel(tp.ifwht(got), x) <= TOL


def test_fwht_axis_complex_integers_and_errors(rng):
    x = rng.standard_normal((8, 5)).astype(np.float32)
    assert _rel(tp.fwht(torch.from_numpy(x), axis=0), scipy.linalg.hadamard(8) @ x) <= TOL
    z = (rng.standard_normal((2, 256)) + 1j * rng.standard_normal((2, 256))).astype(np.complex64)
    for zz in (z, z[:, :16]):
        n = zz.shape[-1]
        assert _rel(tp.fwht(torch.from_numpy(zz)), zz @ scipy.linalg.hadamard(n)) <= TOL
    assert tp.fwht(torch.arange(8)).tolist() == (np.arange(8) @ scipy.linalg.hadamard(8)).tolist()
    with pytest.raises(ValueError):
        tp.fwht(torch.ones(12))
