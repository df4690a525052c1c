"""PyTorch port: ``ops/tomo.py`` (``radon``, ``iradon``) against the JAX
package and against the same definitions summed directly in float64 numpy
(the image spectrum on the polar points, its centered inverse FFT; the
ramp-filtered slices spread back onto the pixels).  Inputs from a generator
made for each case; 1e-5 of the output's maximum throughout: at these sizes
the NUFFTs take their exact dense path (the polar points include negative
frequencies, whose phase error, ROADMAP's F7, is 2π·(N/2)·2^-25 ≈ 3e-6 at
N = 32)."""

import jax
import numpy as np
import pytest
import torch

from mixed_radix_fast_fourier_transform_tpu.ops import tomo as jtomo

import mixed_radix_fast_fourier_transform_tpu_torch as tp
from mixed_radix_fast_fourier_transform_tpu_torch.ops import tomo as ttomo

torch.set_num_threads(1)

TOL = 1e-5
N = 32


@pytest.fixture
def case_rng(request):
    return np.random.default_rng([ord(ch) for ch in request.node.name])


def _rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


def _offsets(n):
    return np.arange(n) - n // 2


def radon64(img, theta):
    """G(ω_m·(cosθ, sinθ)) = Σ g[y, x] e^{-i(ω_x·x + ω_y·y)}, then the
    centered inverse DFT of each slice."""
    n = img.shape[-1]
    _, xs, ys = ttomo._polar_points(n, theta)
    off = _offsets(n)
    phase = ys[:, None, None] * off[None, :, None] + xs[:, None, None] * off[None, None, :]
    slices = np.einsum("pyx,...yx->...p", np.exp(-1j * phase),
                       img.astype(np.complex128 if np.iscomplexobj(img) else np.float64))
    slices = slices.reshape(img.shape[:-2] + (theta.size, n))
    return np.fft.fftshift(np.fft.ifft(np.fft.ifftshift(slices, axes=-1)), axes=-1)


def iradon64(sino, theta, filt):
    nt, n = sino.shape[-2:]
    _, xs, ys = ttomo._polar_points(n, theta)
    slices = np.fft.fftshift(np.fft.fft(np.fft.ifftshift(sino.astype(np.float64), axes=-1)), axes=-1)
    slices = slices * filt
    scale = (np.pi / nt) * (2.0 * np.pi / n) / (4.0 * np.pi ** 2)
    strengths = (slices * scale).reshape(sino.shape[:-2] + (nt * n,))
    off = _offsets(n)
    phase = ys[:, None, None] * off[None, :, None] + xs[:, None, None] * off[None, None, :]
    return np.einsum("pyx,...p->...yx", np.exp(1j * phase), strengths)


def test_radon_against_jax_and_float64(case_rng):
    img = case_rng.standard_normal((2, N, N)).astype(np.float32)
    theta = np.linspace(0.0, np.pi, 12, endpoint=False)
    got = tp.radon(torch.from_numpy(img), theta)
    assert got.dtype == torch.float32 and got.shape == (2, 12, N)
    assert _rel(got, jax.jit(lambda v: jtomo.radon(v, theta))(img)) <= TOL
    assert _rel(got, radon64(img, theta).real) <= TOL
    imgc = (img[0] + 1j * img[1]).astype(np.complex64)
    got = tp.radon(torch.from_numpy(imgc), theta)
    assert got.is_complex() and _rel(got, radon64(imgc, theta)) <= TOL


@pytest.mark.parametrize("filter_name", ["ramp", "hann", "shepp-logan"])
def test_iradon_against_jax_and_float64(case_rng, filter_name):
    sino = case_rng.standard_normal((10, N)).astype(np.float32)
    theta = np.linspace(0.0, np.pi, 10, endpoint=False)
    got = tp.iradon(torch.from_numpy(sino), filter_name=filter_name)
    assert got.dtype == torch.float32 and got.shape == (N, N)
    assert _rel(got, jax.jit(lambda v: jtomo.iradon(v, filter_name=filter_name))(sino)) <= TOL
    omega = 2.0 * np.pi * _offsets(N) / N
    filt = {"ramp": np.abs(omega), "hann": np.abs(omega) * (0.5 + 0.5 * np.cos(omega)),
            "shepp-logan": np.abs(omega) * np.sinc(omega / (2 * np.pi))}[filter_name]
    assert _rel(got, iradon64(sino, theta, filt).real) <= TOL


def test_default_angles_round_trip_and_errors(case_rng):
    """A disk of value 1 reconstructs to ~1 in its interior (the polar
    quadrature weights are applied; 0.89 at N = 32 in both packages)."""
    yy, xx = np.mgrid[:N, :N] - N // 2
    disk = (xx ** 2 + yy ** 2 <= (N // 4) ** 2).astype(np.float32)
    sino = tp.radon(torch.from_numpy(disk))
    assert sino.shape == (180, N)
    back = tp.iradon(sino)
    assert _rel(back, jax.jit(lambda v: jtomo.iradon(jtomo.radon(v)))(disk)) <= TOL
    inner = xx ** 2 + yy ** 2 <= (N // 8) ** 2
    assert abs(float(back.numpy()[inner].mean()) - 1.0) < 0.15
    with pytest.raises(ValueError):
        tp.radon(torch.zeros(3, 3))
    with pytest.raises(ValueError):
        tp.iradon(torch.zeros(4, 8), theta=np.zeros(3))
    with pytest.raises(ValueError):
        tp.iradon(torch.zeros(4, 8), filter_name="cosine")
