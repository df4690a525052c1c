"""PyTorch port: ``ops/dwt.py`` and ``ops/dtcwt.py`` against the JAX package
(its functions under ``jax.jit`` on the CPU) and float64 numpy.

The filter banks are built by the JAX module's own host code, so they are
held bit-equal; every transform to 1e-5 of its output's maximum (the port
convolves where the JAX module gathers windows and contracts them: the
same fp32 sums); perfect reconstruction to 1e-5 of the input's maximum.
Inputs come from a generator made for each case."""

import functools

import jax
import numpy as np
import pytest
import torch

from mixed_radix_fast_fourier_transform_tpu.ops import dtcwt as jdt
from mixed_radix_fast_fourier_transform_tpu.ops import dwt as jdwt

import mixed_radix_fast_fourier_transform_tpu_torch as tp
from mixed_radix_fast_fourier_transform_tpu_torch.ops import dtcwt as tdt
from mixed_radix_fast_fourier_transform_tpu_torch.ops import dwt as tdwt

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


def _flat(tree):
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in _flat(t)]
    return [tree]


def _close_trees(got, want, tol=TOL):
    g, w = _flat(got), _flat(want)
    assert len(g) == len(w)
    return max(_rel(a, b) for a, b in zip(g, w)) <= tol


def _jit(fn, **kw):
    return jax.jit(functools.partial(fn, **kw))


def test_every_bank_is_the_jax_module_s():
    assert tp.ops.dwt.WAVELETS == jdwt.WAVELETS
    for w in jdwt.WAVELETS:
        got, want = tdwt._banks(w), jdwt._banks(w)
        assert all(np.array_equal(a, b) for a, b in zip(got[:4], want[:4])) and got[4] == want[4]
        assert tp.dwt_max_level(1000, w) == jdwt.dwt_max_level(1000, w)
    for K, L in [(3, 3), (2, 2), (4, 3)]:
        got, want = tdt._dt_bank(K, L), jdt._dt_bank(K, L)
        assert np.array_equal(got.dec_a, want.dec_a) and np.array_equal(got.dec_b, want.dec_b)
        assert (got.jsign, got.analyticity) == (want.jsign, want.analyticity)


MODES = ["periodization", "zero", "symmetric", "reflect", "periodic"]


@pytest.mark.parametrize("wavelet", ["haar", "db4", "sym6", "coif2", "bior2.2", "bior4.4"])
@pytest.mark.parametrize("mode", MODES)
def test_wavedec_waverec(case_rng, wavelet, mode):
    x = case_rng.standard_normal((3, 96)).astype(np.float32)
    got = tp.wavedec(torch.from_numpy(x), wavelet, 3, mode)
    want = _jit(jdwt.wavedec, wavelet=wavelet, level=3, mode=mode)(x)
    assert _close_trees(got, want)
    rec = tp.waverec(got, wavelet, mode)
    assert _rel(rec, _jit(jdwt.waverec, wavelet=wavelet, mode=mode)(want)) <= TOL
    assert _rel(rec[..., :96], x) <= TOL


def _periodized_dwt64(x, wavelet):
    """float64: a[k] = Σ_f lo[f]·x[(2k+f) mod N], the same for the detail."""
    lo, hi = jdwt._banks(wavelet)[:2]
    n = x.shape[-1]
    idx = (2 * np.arange(n // 2)[:, None] + np.arange(len(lo))[None, :]) % n
    w = x.astype(np.float64)[..., idx]
    return w @ lo, w @ hi


@pytest.mark.parametrize("wavelet", ["db2", "db12", "sym10", "bior4.4"])
def test_dwt_against_float64_and_along_an_axis(case_rng, wavelet):
    x = case_rng.standard_normal((4, 128)).astype(np.float32)
    a, d = tp.dwt(torch.from_numpy(x), wavelet)
    a64, d64 = _periodized_dwt64(x, wavelet)
    assert _rel(a, a64) <= TOL and _rel(d, d64) <= TOL
    a0, d0 = tp.dwt(torch.from_numpy(x.T.copy()), wavelet, axis=0)
    assert _rel(a0, a64.T) <= TOL and _rel(d0, d64.T) <= TOL
    assert _rel(tp.idwt(a0, d0, wavelet, axis=0), x.T) <= TOL
    xc = (x + 1j * x[::-1]).astype(np.complex64)
    ac, dc = tp.dwt(torch.from_numpy(xc), wavelet)
    assert _rel(ac, _periodized_dwt64(xc.real, wavelet)[0] + 1j * _periodized_dwt64(xc.imag, wavelet)[0]) <= TOL


@pytest.mark.parametrize("wavelet,mode", [("db3", "periodization"), ("bior4.4", "symmetric"), ("sym4", "zero")])
def test_dwt2_wavedec2_waverec2(case_rng, wavelet, mode):
    x = case_rng.standard_normal((2, 48, 40)).astype(np.float32)
    got = tp.wavedec2(torch.from_numpy(x), wavelet, 2, mode)
    want = _jit(jdwt.wavedec2, wavelet=wavelet, level=2, mode=mode)(x)
    assert _close_trees(got, want)
    rec = tp.waverec2(got, wavelet, mode)
    assert _rel(rec[..., :48, :40], x) <= TOL


@pytest.mark.parametrize("wavelet", ["haar", "db2", "bior2.2", "coif1"])
def test_swt_iswt(case_rng, wavelet):
    x = case_rng.standard_normal((2, 64)).astype(np.float32)
    got = tp.swt(torch.from_numpy(x), wavelet, 3)
    want = _jit(jdwt.swt, wavelet=wavelet, level=3)(x)
    assert _close_trees(got, want)
    assert _rel(tp.iswt(got, wavelet), x) <= TOL


@pytest.mark.parametrize("wavelet", ["db2", "bior4.4"])
def test_swt2_iswt2(case_rng, wavelet):
    x = case_rng.standard_normal((2, 32, 16)).astype(np.float32)
    got = tp.swt2(torch.from_numpy(x), wavelet, 2)
    want = _jit(jdwt.swt2, wavelet=wavelet, level=2)(x)
    assert _close_trees(got, want)
    assert _rel(tp.iswt2(got, wavelet), x) <= TOL


def test_packets(case_rng):
    x = case_rng.standard_normal((2, 64)).astype(np.float32)
    got = tp.wpdec(torch.from_numpy(x), "db3", 3)
    assert _close_trees(got, _jit(jdwt.wpdec, wavelet="db3", level=3)(x))
    assert _rel(tp.wprec(got, "db3"), x) <= TOL
    x2 = case_rng.standard_normal((2, 32, 16)).astype(np.float32)
    got = tp.wpdec2(torch.from_numpy(x2), "db2", 2)
    assert _close_trees(got, _jit(jdwt.wpdec2, wavelet="db2", level=2)(x2))
    assert _rel(tp.wprec2(got, "db2"), x2) <= TOL


@pytest.mark.parametrize("method,mode,ext", [("universal", "soft", "symmetric"),
                                             ("bayes", "hard", "periodization"),
                                             ("bayes", "soft", "zero")])
def test_wavelet_denoise(case_rng, method, mode, ext):
    t = np.linspace(0, 1, 256)
    x = (np.sin(2 * np.pi * 5 * t)[None] + 0.2 * case_rng.standard_normal((3, 256))).astype(np.float32)
    kw = dict(method=method, mode=mode, extension=ext)
    got = tp.wavelet_denoise(torch.from_numpy(x), "db4", **kw)
    assert _rel(got, _jit(jdwt.wavelet_denoise, wavelet="db4", **kw)(x)) <= TOL
    img = case_rng.standard_normal((2, 32, 32)).astype(np.float32)
    got = tp.wavelet_denoise2(torch.from_numpy(img), "db2", **kw)
    assert _rel(got, _jit(jdwt.wavelet_denoise2, wavelet="db2", **kw)(img)) <= TOL
    got = tp.wavelet_denoise(torch.from_numpy(x), "db4", sigma=0.2, **kw)
    assert _rel(got, _jit(jdwt.wavelet_denoise, wavelet="db4", sigma=0.2, **kw)(x)) <= TOL


def test_cycle_spin(case_rng):
    x = case_rng.standard_normal((2, 128)).astype(np.float32)
    got = tp.cycle_spin(torch.from_numpy(x), functools.partial(tp.wavelet_denoise, wavelet="db2"), 3)
    want = jax.jit(lambda v: jdwt.cycle_spin(v, functools.partial(jdwt.wavelet_denoise, wavelet="db2"), 3))(x)
    assert _rel(got, want) <= TOL
    with pytest.raises(ValueError):
        tp.cycle_spin(torch.from_numpy(x), lambda v: v[..., :3], 1)


@pytest.mark.parametrize("K,L", [(3, 3), (2, 2)])
def test_dtcwt_idtcwt(case_rng, K, L):
    x = case_rng.standard_normal((3, 128)).astype(np.float32)
    yl, yh = tp.dtcwt(torch.from_numpy(x), 4, K=K, L=L)
    jl, jh = _jit(jdt.dtcwt, levels=4, K=K, L=L)(x)
    assert _rel(yl, jl) <= TOL and _close_trees(yh, jh)
    assert _rel(tp.idtcwt(yl, yh, K=K, L=L), x) <= TOL


def test_dtcwt2_idtcwt2(case_rng):
    x = case_rng.standard_normal((2, 32, 48)).astype(np.float32)
    yl, yh = tp.dtcwt2(torch.from_numpy(x), 3)
    jl, jh = _jit(jdt.dtcwt2, levels=3)(x)
    assert _rel(yl, jl) <= TOL and _close_trees(yh, jh)
    assert _rel(tp.idtcwt2(yl, yh), x) <= TOL
    with pytest.raises(ValueError):
        tp.dtcwt(torch.ones(2, 24), 4)
