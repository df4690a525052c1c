"""PyTorch port: the convolution surface beyond ``fft_convolve`` against the
JAX package (and scipy.signal in float64)."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal
import torch

import mixed_radix_fast_fourier_transform_tpu as jsp
import mixed_radix_fast_fourier_transform_tpu.ops.convolve as jconv

import mixed_radix_fast_fourier_transform_tpu_torch as tp
import mixed_radix_fast_fourier_transform_tpu_torch.ops.convolve as tconv

torch.set_num_threads(1)

TOL = 1e-5  # max |got − want| / max |want|; summation order differs within it
MODES = ["full", "same", "valid"]


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


def _real(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _complex(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("block", [None, 64])
def test_fft_oaconvolve(mode, block):
    a, k = _real((3, 1000), 1), _real(17, 2)
    got = tp.fft_oaconvolve(*_t(a, k), mode=mode, block=block)
    assert _rel(got.numpy(), jsp.fft_oaconvolve(a, k, mode=mode, block=block)) <= TOL
    ref = np.stack([np.convolve(r.astype(np.float64), k, mode=mode) for r in a])
    assert _rel(got.numpy(), ref) <= TOL


def test_fft_oaconvolve_axis_and_long_kernel():
    a, k = _real((300, 2), 3), _real(9, 4)
    got = tp.fft_oaconvolve(*_t(a, k), axis=0, block=32)
    assert _rel(got.numpy(), jsp.fft_oaconvolve(a, k, axis=0, block=32)) <= TOL
    a, k = _real((2, 20), 5), _real(50, 6)   # kernel longer than the signal
    got = tp.fft_oaconvolve(*_t(a, k), mode="same")
    assert _rel(got.numpy(), jsp.fft_oaconvolve(a, k, mode="same")) <= TOL
    with pytest.raises(ValueError):
        tp.fft_oaconvolve(*_t(a, k), mode="bad")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("complex_input", [False, True])
def test_fft_convolve2(mode, complex_input):
    a = _complex((2, 20, 17), 7) if complex_input else _real((2, 20, 17), 7)
    k = _real((1, 5, 4), 8)
    got = tp.fft_convolve2(*_t(a, k), mode=mode)
    assert _rel(got.numpy(), jsp.fft_convolve2(a, k, mode=mode)) <= TOL
    if mode != "same":  # fft_convolve2's "same" centres on the larger input
        ref = np.stack([scipy.signal.convolve2d(p, k[0], mode=mode) for p in a])
        assert _rel(got.numpy(), ref) <= TOL


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("axes", [None, (1, 2), 2])
def test_fft_convolven_and_fftconvolve(mode, axes):
    a = _real((3, 12, 10), 9)
    k = _real((3, 4, 5), 10) if axes is None else _real((1, 4, 5), 10)
    if axes == 2:
        k = _real((1, 12, 5), 10)
    got = tp.fft_convolven(*_t(a, k), mode=mode, axes=axes)
    assert _rel(got.numpy(), jsp.fft_convolven(a, k, mode=mode, axes=axes)) <= TOL
    ref = scipy.signal.fftconvolve(a.astype(np.float64), k.astype(np.float64), mode, axes)
    assert _rel(got.numpy(), ref) <= TOL
    assert torch.equal(tp.fftconvolve(*_t(a, k), mode=mode, axes=axes), got)


def test_fft_convolven_complex_and_errors():
    a, k = _complex((6, 7), 11), _complex((3, 2), 12)
    got = tp.fft_convolven(*_t(a, k))
    assert _rel(got.numpy(), jsp.fft_convolven(a, k)) <= TOL
    with pytest.raises(ValueError):
        tp.fft_convolven(torch.ones(4, 2), torch.ones(2, 4), mode="valid")
    with pytest.raises(ValueError):
        tp.fft_convolven(torch.ones(4), torch.ones(2), mode="bad")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("complex_input", [False, True])
def test_fft_correlate(mode, complex_input):
    a = _real((2, 100), 13)
    k = _complex((1, 9), 14) if complex_input else _real((1, 9), 14)
    got = tp.fft_correlate(*_t(a, k), mode=mode)
    assert _rel(got.numpy(), jsp.fft_correlate(a, k, mode=mode)) <= TOL
    ref = np.stack([np.correlate(r, k[0], mode=mode) for r in a.astype(np.complex128)])
    assert _rel(got.numpy(), ref) <= TOL


@pytest.mark.parametrize("shapes", [((50,), (7,)), ((9, 11), (3, 4)), ((5, 6, 7), (2, 3, 2))])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("method", ["direct", "fft", "auto"])
def test_convolve_and_correlate(shapes, mode, method):
    a, k = _real(shapes[0], 15), _real(shapes[1], 16)
    got = tp.convolve(*_t(a, k), mode=mode, method=method)
    assert _rel(got.numpy(), jsp.convolve(a, k, mode=mode, method=method)) <= TOL
    assert _rel(got.numpy(), scipy.signal.convolve(a.astype(np.float64), k, mode)) <= TOL
    got = tp.correlate(*_t(a, k), mode=mode, method=method)
    assert _rel(got.numpy(), jsp.correlate(a, k, mode=mode, method=method)) <= TOL
    assert _rel(got.numpy(), scipy.signal.correlate(a.astype(np.float64), k, mode)) <= TOL


def test_direct_convolve_complex_and_per_row_kernels():
    a, k = _complex((4, 30), 17), _complex((4, 5), 18)
    got = tconv._direct_convolve_nd(*_t(a, k), (1,))      # one kernel per row
    want = np.asarray(jconv._direct_convolve_nd(jnp.asarray(a), jnp.asarray(k), (1,)))
    assert _rel(got.numpy(), want) <= TOL
    ref = np.stack([np.convolve(r, t) for r, t in zip(a.astype(np.complex128), k)])
    assert _rel(got.numpy(), ref) <= TOL
    got = tp.convolve(*_t(a, k[:1]), method="direct")     # one shared kernel
    assert _rel(got.numpy(), scipy.signal.convolve(a.astype(np.complex128), k[:1])) <= TOL


@pytest.mark.parametrize("shapes", [((50,), (7,)), ((9, 11), (3, 4)), ((5, 6, 7), (2, 3, 2))])
def test_direct_convolve_runs_the_convolution_op_with_tf32_off(shapes, monkeypatch):
    """cuDNN's TF32 flag, on by default, is off at the moment the direct
    method calls the convolution op, and is the caller's again afterwards;
    cuDNN's other switches are left alone."""
    name = f"conv{len(shapes[0])}d"
    conv = getattr(torch.nn.functional, name)
    seen = []

    def noting(*args, **kwargs):
        seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cudnn.enabled))
        return conv(*args, **kwargs)

    monkeypatch.setattr(torch.nn.functional, name, noting)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    enabled = torch.backends.cudnn.enabled
    a, k = _real(shapes[0], 23), _real(shapes[1], 24)
    got = tp.convolve(*_t(a, k), method="direct")
    assert seen == [(False, enabled)]
    assert torch.backends.cudnn.allow_tf32 is True
    assert _rel(got.numpy(), scipy.signal.convolve(a.astype(np.float64), k)) <= TOL


def test_convolve_errors_and_choose_conv_method():
    with pytest.raises(ValueError):
        tp.convolve(torch.ones(4), torch.ones(2), method="bad")
    with pytest.raises(ValueError):
        tp.convolve(torch.ones(4), torch.ones(2, 2))
    with pytest.raises(ValueError):
        tp.convolve(torch.ones(2, 2, 2, 2), torch.ones(1, 1, 1, 1), method="direct")
    with pytest.raises(ValueError):
        tp.convolve(torch.ones(4, 2), torch.ones(2, 4), mode="valid", method="direct")
    for n2 in (5, 16, 17, 400):
        a, k = np.ones(1000), np.ones(n2)
        assert tp.choose_conv_method(*_t(a, k)) == jsp.choose_conv_method(a, k)


@pytest.mark.parametrize("mode", MODES)
def test_oaconvolve(mode):
    a, k = _real(700, 19), _real(11, 20)
    got = tp.oaconvolve(*_t(a, k), mode=mode)
    assert _rel(got.numpy(), jsp.oaconvolve(a, k, mode=mode)) <= TOL
    assert _rel(got.numpy(), scipy.signal.oaconvolve(a.astype(np.float64), k, mode)) <= TOL
    a2, k2 = _real((3, 200), 21), _real((1, 9), 22)
    got = tp.oaconvolve(*_t(a2, k2), mode=mode, axes=-1)
    assert _rel(got.numpy(), jsp.oaconvolve(a2, k2, mode=mode, axes=-1)) <= TOL
    a3, k3 = _real((12, 14), 23), _real((3, 5), 24)
    got = tp.oaconvolve(*_t(a3, k3), mode=mode)
    assert _rel(got.numpy(), jsp.oaconvolve(a3, k3, mode=mode)) <= TOL


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("boundary", ["fill", "wrap", "symm"])
def test_convolve2d_correlate2d(mode, boundary):
    a, k = _real((2, 9, 11), 25), _real((3, 4), 26)
    for fill in (0, 1.5):
        got = tp.convolve2d(*_t(a, k), mode=mode, boundary=boundary, fillvalue=fill)
        want = jsp.convolve2d(a, k, mode=mode, boundary=boundary, fillvalue=fill)
        assert _rel(got.numpy(), want) <= TOL
        ref = np.stack([scipy.signal.convolve2d(p.astype(np.float64), k, mode, boundary, fill)
                        for p in a])
        assert _rel(got.numpy(), ref) <= TOL
    got = tp.correlate2d(*_t(a, k), mode=mode, boundary=boundary)
    assert _rel(got.numpy(), jsp.correlate2d(a, k, mode=mode, boundary=boundary)) <= TOL


def test_convolve2d_errors():
    with pytest.raises(ValueError):
        tp.convolve2d(torch.ones(4, 4), torch.ones(2, 2), boundary="bad")
    with pytest.raises(ValueError):
        tp.convolve2d(torch.ones(4, 4), torch.ones(2, 2), fillvalue="x")
    with pytest.raises(ValueError):
        tp.convolve2d(torch.ones(4), torch.ones(2, 2))
    with pytest.raises(ValueError):
        tp.convolve2d(torch.ones(4, 2), torch.ones(2, 4), mode="valid")
