"""PyTorch port: ``ops/adaptive.py``, ``ops/ar.py`` and ``ops/datadriven.py``
against the JAX package and float64 numpy.

The adaptive filters are recursions over every sample whose fp32 rounding
accumulates: each is held to the same recursion in a float64 numpy loop,
and to the JAX function (its ``lax.scan``) by the triangle bound — the
port's error against float64 plus the JAX result's own; y and e relative
to max |d|, the weights to the largest true tap.  AR estimation and SSA/DMD are the JAX module's
host float64 code, held to exact equality; ``ar_psd``'s float64 evaluation
on the device to 1e-12 of each value.  Inputs come from a generator made for each case."""

import jax
import numpy as np
import pytest
import scipy.signal as ss
import torch

from mixed_radix_fast_fourier_transform_tpu.ops import adaptive as jad
from mixed_radix_fast_fourier_transform_tpu.ops import ar as jar
from mixed_radix_fast_fourier_transform_tpu.ops import datadriven as jdd

import mixed_radix_fast_fourier_transform_tpu_torch as tp

torch.set_num_threads(1)

TOL = 1e-5


@pytest.fixture
def case_rng(request):
    return np.random.default_rng([ord(ch) for ch in request.node.name])


def _loop64(kind, x, d, m, **kw):
    """The JAX module's recursions in float64 numpy."""
    x, d = x.astype(np.float64), d.astype(np.float64)
    U = np.lib.stride_tricks.sliding_window_view(np.concatenate([np.zeros(m - 1), x]), m)[:, ::-1]
    w = np.zeros(m)
    P = kw.get("delta", 100.0) * np.eye(m)
    ys, es = [], []
    for u, dk in zip(U, d):
        y = u @ w
        e = dk - y
        if kind == "lms_filter":
            w = w + kw["mu"] * e * u
        elif kind == "nlms_filter":
            w = w + kw["mu"] / (u @ u + 1e-6) * e * u
        else:
            Pu = P @ u
            k = Pu / (kw["lam"] + u @ Pu)
            w = w + k * e
            P = (P - np.outer(k, Pu)) / kw["lam"]
        ys.append(y)
        es.append(e)
    return np.array(ys), np.array(es), w


@pytest.mark.parametrize("kind,kw", [
    ("lms_filter", {"mu": 0.01}),
    ("nlms_filter", {"mu": 0.5}),
    ("rls_filter", {"lam": 0.999}),
])
def test_adaptive_filters(case_rng, kind, kw):
    """y and e (= d − y) relative to max |d|, w to max |w|."""
    n, m = 1500, 12
    x = case_rng.standard_normal(n).astype(np.float32)
    h = case_rng.standard_normal(m) * np.exp(-0.3 * np.arange(m))
    d = (np.convolve(x, h)[:n] + 0.01 * case_rng.standard_normal(n)).astype(np.float32)
    got = getattr(tp, kind)(torch.from_numpy(x), torch.from_numpy(d), m, **kw)
    ref = jax.jit(lambda a, b: getattr(jad, kind)(a, b, m, **kw))(x, d)
    want = _loop64(kind, x, d, m, **kw)
    for g, r, w, scale in zip(got, ref, want, (np.max(np.abs(d)),) * 2 + (np.max(np.abs(h)),)):
        port_err = np.max(np.abs(g.numpy() - w)) / scale
        jax_err = np.max(np.abs(np.asarray(r) - w)) / scale
        assert port_err <= TOL and jax_err <= TOL
        assert np.max(np.abs(g.numpy() - np.asarray(r))) / scale <= TOL + jax_err
    assert np.allclose(got[2].numpy(), h, atol=0.02)   # the system is identified


def test_adaptive_warm_start_and_validation(case_rng):
    x = case_rng.standard_normal(200).astype(np.float32)
    d = np.convolve(x, [0.5, -0.3])[:200].astype(np.float32)
    w0 = np.array([0.5, -0.3], np.float32)
    _, e, w = tp.lms_filter(torch.from_numpy(x), torch.from_numpy(d), 2, w0=torch.from_numpy(w0))
    assert np.allclose(w.numpy(), w0, atol=1e-6) and np.max(np.abs(e.numpy())) < 1e-5
    with pytest.raises(ValueError):
        tp.rls_filter(torch.from_numpy(x), torch.from_numpy(d), 2, lam=0.0)
    with pytest.raises(ValueError):
        tp.nlms_filter(torch.from_numpy(x), torch.from_numpy(d[:-1]), 2)


def _ar_signal(rng, n=2000):
    return ss.lfilter([1.0], [1.0, -1.5, 0.9, -0.2], rng.standard_normal(n)) + 0.1 * rng.standard_normal(n)


@pytest.mark.parametrize("name", ["aryule", "arburg"])
def test_ar_fits_and_psd(case_rng, name):
    x = _ar_signal(case_rng)
    a, s2, k = getattr(tp, name)(torch.from_numpy(x), 8)
    ja, js2, jk = getattr(jar, name)(x, 8)
    assert np.array_equal(a, ja) and s2 == js2 and np.array_equal(k, jk)
    f, P = tp.ar_psd(torch.from_numpy(a), s2, 300, fs=8.0)
    jf, jP = jar.ar_psd(ja, js2, 300, fs=8.0)
    assert np.array_equal(f, jf) and P.device.type == "cpu"
    assert P.dtype == torch.float64 and np.max(np.abs(P.numpy() / jP - 1.0)) <= 1e-12


def test_levinson_is_the_jax_module_s(case_rng):
    x = _ar_signal(case_rng, 500)
    r = np.array([x[: 500 - k] @ x[k:] for k in range(6)]) / 500
    got, want = tp.levinson(torch.from_numpy(r), 4), jar.levinson(r, 4)
    assert np.array_equal(got[0], want[0]) and got[1] == want[1] and np.array_equal(got[2], want[2])


def test_ssa_is_the_jax_module_s(case_rng):
    k = np.arange(300)
    x = 0.01 * k + np.sin(2 * np.pi * k / 25) + 0.1 * case_rng.standard_normal(300)
    for kw in ({}, {"groups": [[0], [1, 2]]}, {"n_components": 3}):
        got, want = tp.ssa(torch.from_numpy(x), 40, **kw), jdd.ssa(x, 40, **kw)
        assert all(np.array_equal(g, w) for g, w in zip(got, want))
    assert np.allclose(got[0].sum(0), x)


def test_dmd_is_the_jax_module_s(case_rng):
    t = np.arange(60) * 0.1
    modes = case_rng.standard_normal((20, 2))
    X = modes[:, :1] * np.cos(2.0 * t) + modes[:, 1:] * np.exp(-0.3 * t) + 1e-3 * case_rng.standard_normal((20, 60))
    got, want = tp.dmd(torch.from_numpy(X), 4, dt=0.1), jdd.dmd(X, 4, dt=0.1)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    rec = tp.dmd_reconstruct(*got[:3], 60)
    assert np.array_equal(rec, jdd.dmd_reconstruct(*want[:3], 60))
