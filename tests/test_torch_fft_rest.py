"""PyTorch port: the frequency/shift helpers, the Hartley transform and the
rfft2/hfft family against the JAX package (and numpy/scipy float64)."""

import numpy as np
import pytest
import scipy.fft
import torch

import mixed_radix_fast_fourier_transform_tpu as jsp

import mixed_radix_fast_fourier_transform_tpu_torch as tp

torch.set_num_threads(1)

TOL = 1e-5  # max |got − want| / max |want|


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


def _real(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _complex(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.mark.parametrize("n", [1, 8, 9, 360])
@pytest.mark.parametrize("d", [1.0, 0.25])
def test_fftfreq_rfftfreq(n, d):
    got = tp.fftfreq(n, d, device="cpu")
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), np.asarray(jsp.fftfreq(n, d)))
    assert np.allclose(got.numpy(), np.fft.fftfreq(n, d), rtol=1e-6)
    got = tp.rfftfreq(n, d, device="cpu")
    assert np.array_equal(got.numpy(), np.asarray(jsp.rfftfreq(n, d)))
    assert tp.fftfreq(n, dtype=torch.float64, device="cpu").dtype == torch.float64


@pytest.mark.parametrize("axes", [None, 0, (1,), (0, 2)])
def test_fftshift_ifftshift(axes):
    x = _real((4, 5, 6), 1)
    xt = torch.from_numpy(x)
    assert np.array_equal(tp.fftshift(xt, axes).numpy(), np.asarray(jsp.fftshift(x, axes)))
    assert np.array_equal(tp.ifftshift(xt, axes).numpy(), np.asarray(jsp.ifftshift(x, axes)))
    assert torch.equal(tp.ifftshift(tp.fftshift(xt, axes), axes), xt)


@pytest.mark.parametrize("n", [16, 45, 360, 1009])
@pytest.mark.parametrize("complex_input", [False, True])
def test_dht_idht(n, complex_input):
    x = _complex((3, n), n) if complex_input else _real((3, n), n)
    xt = torch.from_numpy(x)
    got = tp.dht(xt)
    assert _rel(got.numpy(), jsp.dht(x)) <= TOL
    f = np.fft.fft(x.astype(np.complex128))
    if not complex_input:
        assert got.dtype == torch.float32
        assert _rel(got.numpy(), f.real - f.imag) <= TOL
    assert _rel(tp.idht(got).numpy(), x) <= TOL
    assert _rel(tp.idht(xt).numpy(), jsp.idht(x)) <= TOL


def test_dht_axis_and_n():
    x = _real((5, 12, 3), 4)
    xt = torch.from_numpy(x)
    assert _rel(tp.dht(xt, axis=1).numpy(), jsp.dht(x, axis=1)) <= TOL
    assert _rel(tp.dht(xt, n=16, axis=1).numpy(), jsp.dht(x, n=16, axis=1)) <= TOL
    assert _rel(tp.idht(xt, n=9, axis=0).numpy(), jsp.idht(x, n=9, axis=0)) <= TOL


@pytest.mark.parametrize("shape", [(6, 10), (5, 9), (4, 7, 12)])
@pytest.mark.parametrize("norm", ["backward", "ortho", "forward"])
def test_rfft2_irfft2(shape, norm):
    x = _real(shape, sum(shape))
    xt = torch.from_numpy(x)
    spec = tp.rfft2(xt, norm=norm)
    assert _rel(spec.numpy(), jsp.rfft2(x, norm=norm)) <= TOL
    assert _rel(spec.numpy(), np.fft.rfft2(x.astype(np.float64), norm=norm)) <= TOL
    back = tp.irfft2(spec, s=shape[-2:], norm=norm)
    assert _rel(back.numpy(), jsp.irfft2(np.asarray(spec), s=shape[-2:], norm=norm)) <= TOL
    assert _rel(back.numpy(), x) <= TOL


@pytest.mark.parametrize("n", [16, 15, 360, 45])
@pytest.mark.parametrize("norm", ["backward", "ortho", "forward"])
def test_hfft_ihfft(n, norm):
    z = _complex((3, n // 2 + 1), n)
    zt = torch.from_numpy(z)
    got = tp.hfft(zt, n=n, norm=norm)
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), jsp.hfft(z, n=n, norm=norm)) <= TOL
    assert _rel(got.numpy(), np.fft.hfft(z.astype(np.complex128), n=n, norm=norm)) <= TOL
    x = _real((3, n), n + 1)
    got = tp.ihfft(torch.from_numpy(x), norm=norm)
    assert _rel(got.numpy(), jsp.ihfft(x, norm=norm)) <= TOL
    assert _rel(got.numpy(), np.fft.ihfft(x.astype(np.float64), norm=norm)) <= TOL


def test_hfft_default_length_and_bad_norm():
    z = _complex((2, 9), 3)
    assert tp.hfft(torch.from_numpy(z)).shape == (2, 16)
    with pytest.raises(ValueError):
        tp.hfft(torch.from_numpy(z), norm="bad")
    with pytest.raises(ValueError):
        tp.ihfftn(torch.ones(4, 4), norm="bad")


@pytest.mark.parametrize("shape", [(6, 10), (5, 9)])
@pytest.mark.parametrize("norm", ["backward", "ortho"])
def test_hfftn_ihfftn_hfft2_ihfft2(shape, norm):
    x = _real(shape, 11)
    xt = torch.from_numpy(x)
    half = tp.ihfftn(xt, norm=norm)
    assert _rel(half.numpy(), jsp.ihfftn(x, norm=norm)) <= TOL
    assert _rel(half.numpy(), scipy.fft.ihfftn(x.astype(np.float64), norm=norm)) <= TOL
    assert _rel(tp.ihfft2(xt, norm=norm).numpy(), jsp.ihfft2(x, norm=norm)) <= TOL
    back = tp.hfftn(half, s=shape, norm=norm)
    assert _rel(back.numpy(), jsp.hfftn(np.asarray(half), s=shape, norm=norm)) <= TOL
    assert _rel(back.numpy(), x) <= TOL
    assert _rel(tp.hfft2(half, s=shape, norm=norm).numpy(), x) <= TOL


@pytest.mark.parametrize("n", [1, 2, 11, 97, 1000, 1009, 5041, 65537])
def test_prev_fast_len_matches_jax(n):
    from mixed_radix_fast_fourier_transform_tpu.utils.factorize import prev_fast_len

    assert tp.prev_fast_len(n) == prev_fast_len(n)
    assert tp.prev_fast_len(n, (2, 3)) == prev_fast_len(n, (2, 3))
    with pytest.raises(ValueError):
        tp.prev_fast_len(0)
