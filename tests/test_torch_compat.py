"""PyTorch port: the C-reference API surface against the JAX package's."""

import numpy as np
import pytest
import torch

from mixed_radix_fast_fourier_transform_tpu import compat as jcompat

from mixed_radix_fast_fourier_transform_tpu_torch import compat

torch.set_num_threads(1)

TOL = 1e-5  # max |got − want| / max |want|


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


def _complex(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _jax_exec(obj, x):
    """The JAX package's fft_exec on its device pipeline (a jax array skips
    its host-side float64 branch, which the port does not have)."""
    import jax.numpy as jnp

    return np.asarray(jcompat.fft_exec(obj, jnp.asarray(x)))


@pytest.mark.parametrize("n", [1, 13, 360, 1024, 1009])
@pytest.mark.parametrize("sgn", [1, -1])
def test_fft_init_exec(n, sgn):
    obj, jobj = compat.fft_init(n, sgn), jcompat.fft_init(n, sgn)
    assert (obj.N, obj.sgn, obj.factors, obj.lf, obj.lt) == (
        jobj.N, jobj.sgn, jobj.factors, jobj.lf, jobj.lt)
    x = _complex((2, n), n)
    got = compat.fft_exec(obj, torch.from_numpy(x))
    assert got.dtype == torch.complex64
    assert _rel(got.numpy(), _jax_exec(jobj, x)) <= TOL
    # sgn=+1 is numpy-forward; sgn=-1 the unnormalized inverse
    x64 = x.astype(np.complex128)
    want = np.fft.fft(x64) if sgn == 1 else np.fft.ifft(x64) * n
    assert _rel(got.numpy(), want) <= TOL
    compat.free_fft(obj)


def test_fft_init_exec_invalid():
    assert compat.fft_init(0, 1) is None
    with pytest.raises(ValueError):
        compat.fft_init(8, 0)
    with pytest.raises(ValueError):
        compat.fft_exec(None, torch.ones(8))
    with pytest.raises(ValueError):
        compat.fft_exec(compat.fft_init(8, 1), torch.ones(9))


@pytest.mark.parametrize("n", [2, 16, 360, 2018])
@pytest.mark.parametrize("sgn", [1, -1])
def test_real_r2c_c2r(n, sgn):
    rng = np.random.default_rng(n)
    x = rng.standard_normal((2, n)).astype(np.float32)
    robj, jrobj = compat.fft_real_init(n, sgn), jcompat.fft_real_init(n, sgn)
    spec = compat.fft_r2c_exec(robj, torch.from_numpy(x))
    assert spec.shape == (2, n)  # the full mirrored spectrum
    assert _rel(spec.numpy(), jcompat.fft_r2c_exec(jrobj, x)) <= TOL
    full = np.fft.fft(x.astype(np.float64))
    assert _rel(spec.numpy(), full if sgn == 1 else np.conj(full)) <= TOL
    # c2r inverts an r2c of the opposite sgn, unnormalized: N·x
    inv = compat.fft_real_init(n, -sgn)
    back = compat.fft_c2r_exec(inv, spec)
    assert _rel(back.numpy(), jcompat.fft_c2r_exec(
        jcompat.fft_real_init(n, -sgn), np.asarray(spec))) <= TOL
    assert _rel(back.numpy(), n * x) <= TOL
    compat.free_real_fft(robj)


def test_real_init_invalid():
    assert compat.fft_real_init(7, 1) is None
    assert compat.fft_real_init(0, 1) is None
    with pytest.raises(ValueError):
        compat.fft_real_init(8, 2)
    with pytest.raises(ValueError):
        compat.fft_r2c_exec(None, torch.ones(8))
    with pytest.raises(ValueError):
        compat.fft_c2r_exec(None, torch.ones(8))


@pytest.mark.parametrize("type_", ["full", "same", "valid", None])
@pytest.mark.parametrize("conv_type", ["linear", "circular"])
def test_fft_convolve(type_, conv_type):
    rng = np.random.default_rng(5)
    a = rng.standard_normal(100).astype(np.float32)
    b = rng.standard_normal(9).astype(np.float32)
    got, length = compat.fft_convolve(type_, conv_type, torch.from_numpy(a), torch.from_numpy(b))
    want, jlength = jcompat.fft_convolve(type_, conv_type, a, b)
    assert length == jlength and got.shape[-1] == length
    assert _rel(got.numpy(), want) <= TOL
    if conv_type == "circular":
        assert length == 128  # the padded buffer, wrapped at next_pow2(max)


def test_fft_convolve_invalid_and_lengths():
    a = torch.ones(4)
    assert compat.fft_convolve("full", "bad", a, a) == (None, -1)
    assert compat.fft_convolve("bad", "linear", a, a) == (None, -1)
    assert compat.fft_convolve("full", "linear", a, torch.ones(0)) == (None, -1)
    assert compat.next_power_of_two(100) == jcompat.next_power_of_two(100) == 128
    for kind in ("linear", "circular"):
        assert compat.find_optimal_fft_length(108, kind, 100, 9) == \
            jcompat.find_optimal_fft_length(108, kind, 100, 9)
    with pytest.raises(ValueError):
        compat.find_optimal_fft_length(8, "bad", 4, 4)


@pytest.mark.parametrize("n", [1, 32, 1024, 5040, 1009, 38])
def test_factors_twiddle_longvector_dividebyN(n):
    f = compat.factors(n)
    assert f == jcompat.factors(n)
    assert compat.dividebyN(n) == jcompat.dividebyN(n)
    assert np.array_equal(compat.longvectorN(n, f), jcompat.longvectorN(n, f))
    assert np.array_equal(compat.longvectorN(n, f, -1), jcompat.longvectorN(n, f, -1))
    if n > 1:
        r = f[0]
        assert np.array_equal(compat.twiddle(n, r), jcompat.twiddle(n, r))
    with pytest.raises(ValueError):
        compat.factors(0)


def test_demo_utilities(capsys):
    sig = compat.generate_signal(64, 3.0, device="cpu")
    assert sig.dtype == torch.complex128
    assert np.allclose(sig.numpy(), jcompat.generate_signal(64, 3.0), atol=1e-14)
    real = compat.generate_real_signal(64, 3.0, device="cpu")
    assert real.dtype == torch.float64
    assert np.allclose(real.numpy(), jcompat.generate_real_signal(64, 3.0), atol=1e-14)
    other = sig.numpy() + 0.5
    assert compat.compute_mse(sig, other) == pytest.approx(jcompat.compute_mse(sig.numpy(), other))
    assert compat.compute_mse_real(real, real.numpy() + 2.0) == pytest.approx(4.0)
    compat.print_complex(sig[:2], "s")
    compat.print_real(real[:2], "r")
    out = capsys.readouterr().out
    assert out.splitlines()[0] == "s:" and "[1]" in out and "r:" in out
    assert set(compat.__all__) == set(jcompat.__all__)
