"""PyTorch port: the host-side window functions (``ops/stft.get_window``,
``dpss``, ``ops/windows``) against the JAX package's and scipy's.  They are
numpy float64 design constants in both packages: held bit-equal, or within
1e-12 where stated."""

import importlib

import numpy as np
import pytest
import scipy.signal.windows as sw

from mixed_radix_fast_fourier_transform_tpu.ops import stft as jstft
from mixed_radix_fast_fourier_transform_tpu.ops import windows as jwin

import mixed_radix_fast_fourier_transform_tpu_torch as tp
from mixed_radix_fast_fourier_transform_tpu_torch.ops import windows as twin

tstft = importlib.import_module("mixed_radix_fast_fourier_transform_tpu_torch.ops.stft")

NAMED = ["hann", "hamming", "blackman", "blackmanharris", "bartlett", "flattop", "boxcar",
         "triang", "parzen", "bohman", "cosine", "barthann", "lanczos", "nuttall"]
PARAMETERIZED = [("kaiser", 8.6), ("tukey", 0.25), ("tukey", 0.0), ("tukey", 1.0),
                 ("gaussian", 7.0), ("exponential", 3.0), ("exponential", None, 2.0),
                 ("chebwin", 60.0)]


@pytest.mark.parametrize("sym", [False, True])
@pytest.mark.parametrize("window", NAMED + PARAMETERIZED, ids=str)
def test_get_window_is_bit_equal(window, sym):
    for m in (1, 2, 51, 64):
        got = tp.get_window(window, m, np.float64, sym=sym)
        want = jstft.get_window(window, m, np.float64, sym=sym)
        assert got.dtype == np.float64 and np.array_equal(got, want), (window, m)
    assert tp.get_window(window, 32).dtype == np.float32


def test_get_window_arrays_and_errors():
    w = np.linspace(0, 1, 16)
    assert np.array_equal(tp.get_window(w, 16, np.float64), w)
    assert np.array_equal(tp.get_window(w, 16, np.float64, sym=True), w)
    for bad in ("nope", ("kaiser",), ("nope", 1.0), ("exponential", 1.0, 2.0)):
        with pytest.raises(ValueError):
            tp.get_window(bad, 16)
    with pytest.raises(ValueError):
        tp.get_window(w, 8)
    with pytest.raises(ValueError):
        tstft._sym_chebwin(16, 1e4)
    assert tp.get_window is tstft.get_window is twin.get_window


@pytest.mark.parametrize("m,nw,kmax", [(64, 2.5, 4), (128, 4.0, None), (33, 3.0, 5)])
def test_dpss_matches_jax_and_scipy(m, nw, kmax):
    got, ratios = tp.dpss(m, nw, kmax, return_ratios=True, dtype=np.float64)
    want, jratios = jstft.dpss(m, nw, kmax, return_ratios=True, dtype=np.float64)
    assert np.max(np.abs(got - want)) <= 1e-12 and np.max(np.abs(ratios - jratios)) <= 1e-12
    k = got.shape[0]
    ref, ref_ratios = sw.dpss(m, nw, k, return_ratios=True)
    assert np.max(np.abs(got - ref)) <= 1e-8 and np.max(np.abs(ratios - ref_ratios)) <= 1e-8
    assert np.allclose(got @ got.T, np.eye(k), atol=1e-10)   # orthonormal rows
    assert tp.dpss(m, nw, kmax).dtype == np.float32


def test_dpss_errors():
    for args in ((1, 0.5), (64, 0.0), (64, 32.0), (64, 2.5, 0), (64, 2.5, 65)):
        with pytest.raises(ValueError):
            tp.dpss(*args)


SCIPY_CALLS = [
    ("general_cosine", ([0.5, 0.3, 0.2],)), ("general_hamming", (0.6,)),
    ("general_gaussian", (1.5, 5.0)), ("taylor", ()), ("taylor", (6, 40.0, False)),
    ("kaiser", (8.6,)), ("tukey", (0.3,)), ("gaussian", (4.0,)), ("chebwin", (80.0,)),
    ("exponential", ()),
] + [(name, ()) for name in NAMED]


@pytest.mark.parametrize("sym", [True, False])
@pytest.mark.parametrize("name,args", SCIPY_CALLS, ids=[f"{n}{a}" for n, a in SCIPY_CALLS])
def test_named_windows_match_jax_and_scipy(name, args, sym):
    for m in (0, 1, 16, 33):
        got = getattr(twin, name)(m, *args, sym=sym)
        assert got.dtype == np.float64
        assert np.array_equal(got, getattr(jwin, name)(m, *args, sym=sym)), (name, m)
        if m > 1:
            assert np.max(np.abs(got - getattr(sw, name)(m, *args, sym=sym))) <= 1e-9, (name, m)


def test_kaiser_bessel_derived_and_exponential_center():
    got = twin.kaiser_bessel_derived(32, 5.0)
    assert np.array_equal(got, jwin.kaiser_bessel_derived(32, 5.0))
    assert np.max(np.abs(got - sw.kaiser_bessel_derived(32, 5.0))) <= 1e-12
    assert np.allclose(got[:16] ** 2 + got[16:] ** 2, 1.0)   # Princen-Bradley
    for args, kw in (((31, 5.0), {}), ((32, 5.0), {"sym": False})):
        with pytest.raises(ValueError):
            twin.kaiser_bessel_derived(*args, **kw)
    assert np.array_equal(twin.exponential(16, center=3.0, tau=2.0, sym=False),
                          sw.exponential(16, center=3.0, tau=2.0, sym=False))
    with pytest.raises(ValueError):
        twin.exponential(16, center=3.0)
    assert set(twin.__all__) == set(jwin.__all__) and tp.windows is twin
