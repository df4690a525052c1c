"""PyTorch port: the public API and the spectral filter against the JAX package."""

import jax
import numpy as np
import pytest
import torch

import mixed_radix_fast_fourier_transform_tpu as jsp
from mixed_radix_fast_fourier_transform_tpu import models as jmodels

import mixed_radix_fast_fourier_transform_tpu_torch as tp
from mixed_radix_fast_fourier_transform_tpu_torch import models as tmodels
from mixed_radix_fast_fourier_transform_tpu_torch.models import spectral_filter

torch.set_num_threads(1)

TOL = 1e-5  # max |got − want| / max |want|: the library's error budget


def _rel(got, want):
    got = np.asarray(got)
    want = np.asarray(want)
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


def _complex(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.mark.parametrize("n", [360, 1024, 1009])
@pytest.mark.parametrize("norm", ["backward", "ortho", "forward"])
def test_fft_ifft_fftn_match_jax(n, norm):
    x = _complex((3, n), n)
    xt = torch.from_numpy(x)
    for jf, tf in ((jsp.fft, tp.fft), (jsp.ifft, tp.ifft)):
        got = tf(xt, norm=norm)
        assert got.dtype == torch.complex64 and got.shape == (3, n)
        assert _rel(got.numpy(), jf(x, norm=norm)) <= TOL
    assert _rel(tp.fftn(xt, norm=norm).numpy(), jsp.fftn(x, norm=norm)) <= TOL
    assert _rel(tp.ifftn(xt, norm=norm).numpy(), jsp.ifftn(x, norm=norm)) <= TOL


def test_fft_axis_n_and_2d():
    x = _complex((5, 6, 7), 3)
    xt = torch.from_numpy(x)
    assert _rel(tp.fft(xt, n=9, axis=1).numpy(), jsp.fft(x, n=9, axis=1)) <= TOL
    assert _rel(tp.fft(xt, n=4, axis=0).numpy(), jsp.fft(x, n=4, axis=0)) <= TOL
    assert _rel(tp.fft2(xt).numpy(), jsp.fft2(x)) <= TOL
    assert _rel(tp.ifft2(xt, s=(8, 8)).numpy(), jsp.ifft2(x, s=(8, 8))) <= TOL
    # float64 numpy input is cast to fp32 at the boundary
    assert tp.fft(np.ones(8)).dtype == torch.complex64
    with pytest.raises(ValueError):
        tp.fft(xt, norm="bad")
    with pytest.raises(ValueError):
        tp.fft(torch.zeros(()))


@pytest.mark.parametrize("n", [4096, 999])
@pytest.mark.parametrize("use_kernel", [None, False])
def test_rfft_irfft_match_jax(n, use_kernel):
    rng = np.random.default_rng(n)
    x = rng.standard_normal((3, n)).astype(np.float32)
    cfg = tp.SpectralConfig(use_kernel=use_kernel)
    xt = torch.from_numpy(x)
    spec = tp.rfft(xt, config=cfg)
    want = jsp.rfft(x)
    assert spec.shape == (3, n // 2 + 1)
    assert _rel(spec.numpy(), want) <= TOL
    assert _rel(spec.numpy(), np.fft.rfft(x.astype(np.float64))) <= TOL
    snap = spec.clone()
    back = tp.irfft(spec, n=n, config=cfg)
    assert torch.equal(spec, snap)  # the caller's spectrum is not edited
    assert _rel(back.numpy(), jsp.irfft(np.asarray(want), n=n)) <= TOL
    assert _rel(back.numpy(), x) <= TOL
    for norm in ("ortho", "forward"):
        s2 = tp.rfft(xt, norm=norm, config=cfg)
        assert _rel(s2.numpy(), jsp.rfft(x, norm=norm)) <= TOL
        assert _rel(tp.irfft(s2, n=n, norm=norm, config=cfg).numpy(), x) <= TOL


def test_rfftn_irfftn_and_single_odd_row():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((6, 10)).astype(np.float32)
    xt = torch.from_numpy(x)
    spec = tp.rfftn(xt)
    assert _rel(spec.numpy(), jsp.rfftn(x)) <= TOL
    assert _rel(tp.irfftn(spec, s=x.shape).numpy(), x) <= TOL
    one = x[0, :9]
    assert _rel(tp.rfft(torch.from_numpy(one)).numpy(), jsp.rfft(one)) <= TOL
    # irfft ignores Im of the DC and Nyquist bins, as numpy does
    z = _complex((2, 6), 8)
    assert _rel(tp.irfft(torch.from_numpy(z)).numpy(), np.fft.irfft(z)) <= TOL


@pytest.mark.parametrize("mode", ["full", "same", "valid", "circular"])
@pytest.mark.parametrize("complex_input", [False, True])
def test_fft_convolve_matches_jax(mode, complex_input):
    rng = np.random.default_rng(11)
    a = rng.standard_normal((3, 400)).astype(np.float32)
    b = rng.standard_normal((1, 29)).astype(np.float32)
    if complex_input:
        a = a + 1j * rng.standard_normal(a.shape).astype(np.float32)
    kw = dict(circular=True) if mode == "circular" else dict(mode=mode)
    got = tp.fft_convolve(torch.from_numpy(a), torch.from_numpy(b), **kw)
    want = np.asarray(jsp.fft_convolve(a, b, **kw))
    assert got.shape == want.shape
    assert _rel(got.numpy(), want) <= TOL
    if mode != "circular":
        ref = np.stack([np.convolve(row, b[0], mode=mode) for row in a])
        assert _rel(got.numpy(), ref) <= TOL


def test_fft_convolve_bad_mode():
    with pytest.raises(ValueError):
        tp.fft_convolve(torch.ones(4), torch.ones(3), mode="bad")


def test_spectral_filter_matches_jax():
    n, batch = 4096, 8
    jparams = jmodels.init_params(jax.random.PRNGKey(0), n)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (batch, n)))
    want = np.asarray(jmodels.apply(jparams, x))
    params = tmodels.params_from_jax({k: np.asarray(v) for k, v in jparams.items()}, "cpu")
    xt = torch.from_numpy(x)
    got = tmodels.apply(params, xt)
    assert got.shape == (batch, n) and got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= TOL
    module = tmodels.SpectralFilter(n, device="cpu")
    module.load_state_dict(params)
    with torch.no_grad():
        assert torch.equal(module(xt), got)
    pipe = tmodels.apply(params, xt, config=tp.SpectralConfig(use_kernel=False))
    assert _rel(pipe.numpy(), want) <= TOL


def test_spectral_filter_init_params():
    g = torch.Generator().manual_seed(0)
    p = tmodels.init_params(64, g, device="cpu")
    assert p["gain_re"].shape == p["gain_im"].shape == (33,)
    assert p["bias"].shape == () and float(p["bias"]) == 0.0
    assert torch.allclose(p["gain_re"], torch.ones(33), atol=0.1)
    q = tmodels.init_params(64, torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(p[k], q[k]) for k in p)


def test_spectral_filter_defaults_to_the_card():
    # the device is resolved before any tensor is made, so this needs no card
    assert spectral_filter.resolve_device(None) == torch.device("cuda")
    assert spectral_filter.resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        # no fallback to the CPU: asking for the card without one raises
        with pytest.raises((RuntimeError, AssertionError)):
            tmodels.init_params(64)
        with pytest.raises((RuntimeError, AssertionError)):
            tmodels.params_from_jax({"bias": np.zeros(())})
        with pytest.raises((RuntimeError, AssertionError)):
            tmodels.SpectralFilter(64)
