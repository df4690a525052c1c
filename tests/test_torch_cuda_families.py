"""PyTorch port, on the card only: the fused kernel at the shapes the model
families hand it, and its backward on their non-contiguous cotangents.

    python -m pytest tests/test_torch_cuda_families.py -m cuda --noconftest -p no:cacheprovider

Every test is marked ``cuda`` and skips where there is no CUDA device.
Imports neither JAX nor the JAX package."""

import pytest
import torch

import mixed_radix_fast_fourier_transform_tpu_torch as tp
from mixed_radix_fast_fourier_transform_tpu_torch.models import fnet
from mixed_radix_fast_fourier_transform_tpu_torch.ops import cuda_fft

KERNEL_TOL = 2e-5   # kernel vs its plain version
ROUTES_TOL = 2e-5   # kernel route vs stage pipeline
PIPELINE = tp.SpectralConfig(use_kernel=False)


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("n,rows", [(768, 4096), (512, 6144), (90, 69120), (90, 69888)])
def test_kernel_at_the_families_shapes(n, rows):
    """FNet-Base's two axes and the FourCastNet token grid: 69,120 rows of
    360 bytes, not 16-byte aligned."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(n)
    xr, xi = (torch.randn(rows, n, device="cuda", generator=gen) for _ in range(2))
    for sign in (-1, 1):
        kr, ki = cuda_fft.exec_kernel(xr, xi, n, sign)
        rr, ri = cuda_fft.exec_kernel_reference(xr, xi, n, sign)
        assert _rel(torch.complex(kr, ki), torch.complex(rr, ri)) <= KERNEL_TOL


def _input_gradients(fn, x, weight):
    """d/dx of Σ weight ⊙ fn(x) on the kernel route and on the stage
    pipeline, and the kernel's launches of the first."""
    out = []
    for config in (tp.DEFAULT_CONFIG, PIPELINE):
        xg = x.clone().requires_grad_(True)
        cuda_fft.LAUNCHES = 0
        (fn(xg, config) * weight).sum().backward()
        out.append(xg.grad)
        if config is tp.DEFAULT_CONFIG:
            launches = cuda_fft.LAUNCHES
    return out[0], out[1], launches


@pytest.mark.cuda
def test_fnet_layer_cotangents():
    """The sequence-axis transform runs on a moved-axis view: its cotangent
    reaches the kernel's backward strided and is made dense there."""
    _need_card()
    gen = torch.Generator().manual_seed(0)
    layer = fnet.init_layer(768, 3072, generator=gen, device="cuda")
    x = torch.randn(8, 512, 768, generator=gen).cuda()
    w = torch.randn(8, 512, 768, generator=gen).cuda()

    def encoder(xg, config):
        return fnet._encoder_layer(layer, xg, fnet.fourier_mix(xg, config=config))

    kernel, pipeline, launches = _input_gradients(encoder, x, w)
    assert launches == 4   # two transforms forward, two backward
    assert _rel(kernel, pipeline) <= ROUTES_TOL


@pytest.mark.cuda
def test_afno_transform_cotangents():
    """rfft2/irfft2 over the token grid of a channels-last tensor: 69,120 and
    69,888 rows of 90, forward and cotangent, from non-contiguous views.  The
    filter between them is linear here (a fixed complex multiplier): the
    AFNO's own ReLU and soft shrinkage make a gradient entry jump by ~1.6%
    wherever one spectral element's mask differs between two fp32 routes."""
    _need_card()
    gen = torch.Generator().manual_seed(0)
    m = torch.complex(*(torch.randn(1, 768, 90, 91, generator=gen).cuda() for _ in range(2)))
    x = torch.randn(1, 90, 180, 768, generator=gen).cuda()
    w = torch.randn(1, 90, 180, 768, generator=gen).cuda()

    def mixer(xg, config):
        spec = tp.rfft2(torch.movedim(xg, -1, 1), config=config)
        return torch.movedim(tp.irfft2(spec * m, s=(90, 180), config=config), 1, -1)

    kernel, pipeline, launches = _input_gradients(mixer, x, w)
    assert launches == 8   # rfft, fft, ifft, irfft forward, and each backward
    assert _rel(kernel, pipeline) <= ROUTES_TOL
