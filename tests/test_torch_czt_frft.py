"""PyTorch port: the chirp-z transform, the zoom FFT and the fractional
Fourier transform against the JAX package, scipy.signal and the direct sums.
Tolerance: 1e-5 of the output's maximum against the JAX package (the same
algorithm in fp32) and 2e-5 against the float64 oracles, unless stated.  The inner transforms
of czt run the stage pipeline on either ``use_kernel`` setting, as
Bluestein's do; frft's own centered DFTs go through the kernel's dispatch."""

import numpy as np
import pytest
import scipy.signal
import torch

import mixed_radix_fast_fourier_transform_tpu as sp
from mixed_radix_fast_fourier_transform_tpu.ops import czt as jczt

import mixed_radix_fast_fourier_transform_tpu_torch as tp
from mixed_radix_fast_fourier_transform_tpu_torch.ops import cuda_fft
from mixed_radix_fast_fourier_transform_tpu_torch.ops import czt as tczt

torch.set_num_threads(1)

TOL = 1e-5
ORACLE_TOL = 2e-5
ROUTES = {"kernel": tp.SpectralConfig(use_kernel=True), "pipeline": tp.SpectralConfig(use_kernel=False)}


def _rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


def _complex(rng, *shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


# (n, m, w, a): the DFT default, a spiral, a zoom on the unit circle, m > n
CZT_CASES = [
    (64, None, None, 1.0), (100, 77, np.exp(-0.01j) * 0.999, 1.1),
    (50, 120, np.exp(-2j * np.pi / 400), np.exp(0.3j)), (17, 5, np.exp(-0.2j), 0.9 + 0.1j),
    (1, 4, None, 1.0),
]


@pytest.fixture
def case_rng(request):
    """A generator made for one test case from its id: its draws do not
    depend on which tests ran before on the worker, as the session ``rng``'s
    do."""
    return np.random.default_rng([ord(ch) for ch in request.node.name])


@pytest.mark.parametrize("n,m,w,a", CZT_CASES, ids=[f"n{c[0]}-m{c[1]}" for c in CZT_CASES])
def test_czt_matches_jax_scipy_and_the_direct_sum(case_rng, n, m, w, a):
    """The port against the JAX function at TOL, and against scipy and the
    direct sum in float64 at ORACLE_TOL wherever the JAX function itself
    holds ORACLE_TOL on the draw.  Where it does not (the fp32 algorithm on
    the |w| = 0.999 spiral exceeds 2e-5 on ~5% of draws in both packages),
    the port is held to the JAX function's own error plus TOL (the triangle
    bound)."""
    x = _complex(case_rng, 2, n)
    got = tp.czt(torch.from_numpy(x), m, w, a)
    assert got.dtype == torch.complex64
    ref = np.asarray(sp.czt(x, m, w, a))
    assert _rel(got, ref) <= TOL
    x64 = x.astype(np.complex128)
    mm = m or n
    ww = np.exp(-2j * np.pi / mm) if w is None else w
    k, j = np.arange(mm)[None, :], np.arange(n)[:, None]
    direct = x64 @ (complex(a) ** (-j) * complex(ww) ** (j * k))
    for oracle in (scipy.signal.czt(x64, m, w, a), direct):
        jax_err = _rel(ref, oracle)
        bound = ORACLE_TOL if jax_err <= ORACLE_TOL else jax_err + TOL
        assert _rel(got, oracle) <= bound


def test_czt_constants_are_bit_equal():
    for n, m, w, a in ((64, 64, np.exp(-2j * np.pi / 64), 1.0), (100, 77, 0.999 * np.exp(-0.01j), 1.1)):
        got = tczt._czt_constants(n, m, complex(w), complex(a), "pow23")
        want = jczt._czt_constants(n, m, complex(w), complex(a), "pow23")
        assert got[0] == want[0] and all(np.array_equal(g, h) for g, h in zip(got[1:], want[1:]))


@pytest.mark.parametrize("m,w,a", [(8, None, 1.0), (12, np.exp(-0.3j), 2.0), (5, 0.9, 1j)])
def test_czt_points_are_bit_equal(m, w, a):
    got = tp.czt_points(m, w, a)
    assert got.dtype == np.complex128 and np.array_equal(got, sp.czt_points(m, w, a))
    assert np.max(np.abs(got - scipy.signal.czt_points(m, w, a))) <= 1e-12


def test_czt_axis_real_input_and_errors(rng):
    x = rng.standard_normal((16, 3))
    assert _rel(tp.czt(torch.from_numpy(x), axis=0), np.fft.fft(x, axis=0)) <= TOL
    with pytest.raises(ValueError):
        tp.czt(torch.ones(8), m=0)
    with pytest.raises(ValueError):
        tp.czt(torch.ones(8), w=0)
    with pytest.raises(ValueError):
        tp.czt(torch.ones(8), a=0)
    with pytest.raises(ValueError):
        tp.czt(torch.ones(3, 0))
    with pytest.raises(ValueError):
        tp.czt_points(0)
    with pytest.raises(ValueError):
        tp.zoom_fft(torch.ones(8), 0.5, m=0)


@pytest.mark.parametrize("fn,m", [([0.1, 0.6], 50), (0.5, None), ([0.0, 2.0], 64)])
def test_zoom_fft_matches_jax_and_scipy(rng, fn, m):
    x = _complex(rng, 2, 64)
    got = tp.zoom_fft(torch.from_numpy(x), fn, m)
    assert _rel(got, sp.zoom_fft(x, fn, m)) <= TOL
    assert _rel(got, scipy.signal.zoom_fft(x.astype(np.complex128), fn, m, endpoint=False)) <= TOL
    if m == 64:   # the full band is the FFT
        assert _rel(got, np.fft.fft(x.astype(np.complex128))) <= TOL


def test_czt_classes(rng):
    x = _complex(rng, 3, 40)
    t = tp.CZT(40, 25, w=np.exp(-0.05j), a=1.02)
    assert _rel(t(torch.from_numpy(x)), sp.CZT(40, 25, w=np.exp(-0.05j), a=1.02)(x)) <= TOL
    assert np.array_equal(t.points(), sp.CZT(40, 25, w=np.exp(-0.05j), a=1.02).points())
    z = tp.ZoomFFT(40, [0.2, 0.7], 30, fs=2.0)
    assert (z.f1, z.f2, z.fs, z.m) == (0.2, 0.7, 2.0, 30)
    assert _rel(z(torch.from_numpy(x)), tp.zoom_fft(torch.from_numpy(x), [0.2, 0.7], 30)) == 0.0
    assert _rel(tp.CZT(40)(torch.from_numpy(x)), np.fft.fft(x.astype(np.complex128))) <= TOL
    with pytest.raises(ValueError):
        t(torch.ones(39))
    for bad in ((0,), (8, 0)):
        with pytest.raises(ValueError):
            tp.CZT(*bad)


def test_czt_never_reaches_the_kernel(rng):
    x = torch.from_numpy(_complex(rng, 2, 100))
    seen = []
    real = cuda_fft.exec_kernel
    cuda_fft.exec_kernel = lambda *a: seen.append(a) or real(*a)
    try:
        a = tp.czt(x, 77, config=ROUTES["kernel"])
        b = tp.czt(x, 77, config=ROUTES["pipeline"])
    finally:
        cuda_fft.exec_kernel = real
    assert not seen and torch.equal(a, b)


def _gauss(n, batch=2):
    t = np.linspace(-4, 4, n)
    g = np.exp(-t ** 2) * np.cos(3 * t)
    return np.stack([g, np.roll(g, 5)][:batch]).astype(np.float32)


ORDERS = [0.0, 0.3, 0.7, 1.0, 1.4, 2.0, 2.2, 3.0, 3.6, -0.5, 4.0, 5.3]


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("a", ORDERS)
def test_frft_matches_jax(route, a):
    for n in (128, 45):
        x = _gauss(n)
        got = tp.frft(torch.from_numpy(x), a, config=ROUTES[route])
        assert got.dtype == torch.complex64 and got.shape == x.shape
        assert _rel(got, sp.frft(x, a)) <= TOL, n


def test_frft_integer_orders_are_exact_identities(rng):
    x = _complex(rng, 2, 64)
    xt = torch.from_numpy(x)
    c = 32
    want = np.roll(np.fft.fft(np.roll(x.astype(np.complex128), -c, -1)), c, -1) / 8.0
    assert _rel(tp.frft(xt, 1.0), want) <= TOL
    assert torch.equal(tp.frft(xt, 0.0), xt) and torch.equal(tp.frft(xt, 4.0), xt)
    assert np.array_equal(tp.frft(xt, 2.0).numpy(), x[:, (2 * c - np.arange(64)) % 64])
    assert _rel(tp.frft(tp.frft(xt, 1.0), 3.0), x) <= TOL
    assert tp.frft(torch.from_numpy(x.real.copy()), 2.0).dtype == torch.complex64


@pytest.mark.parametrize("a,b", [(0.3, 0.7), (0.6, 0.9), (1.2, -0.4)])
def test_frft_orders_add_and_invert(a, b):
    """On a signal concentrated inside the grid's inscribed circle, orders
    compose (0.3 then 0.7 is the centered unitary DFT) and ifrft inverts;
    the sampled kernel's own accuracy in fp32 sets the tolerance, 2e-4."""
    x = _gauss(256, 1)
    xt = torch.from_numpy(x)
    assert _rel(tp.frft(tp.frft(xt, a), b), tp.frft(xt, a + b).numpy()) <= 2e-4
    assert _rel(tp.ifrft(tp.frft(xt, a), a), x.astype(np.complex64)) <= 2e-4
    assert _rel(tp.ifrft(xt, a), sp.ifrft(x, a)) <= TOL


def test_frft_axis_frft2_and_errors():
    g = _gauss(64)
    img = (g[0][:, None] * g[1][None, :]).astype(np.float32)
    it = torch.from_numpy(img)
    assert _rel(tp.frft(it, 0.6, axis=0), sp.frft(img, 0.6, axis=0)) <= TOL
    assert _rel(tp.frft2(it, (0.4, 1.2)), sp.frft2(img, (0.4, 1.2))) <= TOL
    assert _rel(tp.frft2(it, 0.8), tp.frft(tp.frft(it, 0.8, axis=0), 0.8, axis=1).numpy()) == 0.0
    with pytest.raises(ValueError):
        tp.frft(torch.ones(1), 0.5)
    with pytest.raises(ValueError):
        tp.frft(torch.tensor(1.0), 0.5)
