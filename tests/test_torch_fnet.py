"""PyTorch port: FNet's Fourier mixing and encoder layer against the JAX
package and numpy on both ``use_kernel`` routes, and the helpers the model
families share (layer norm, GELU) against the JAX functions they replace.

Tolerance of every comparison: 1e-5 of the output's maximum."""

import jax
import numpy as np
import pytest
import torch

from mixed_radix_fast_fourier_transform_tpu.models import afno as jafno
from mixed_radix_fast_fourier_transform_tpu.models import fnet as jfnet
from mixed_radix_fast_fourier_transform_tpu.models import s4d as js4d

import mixed_radix_fast_fourier_transform_tpu_torch as tp
from mixed_radix_fast_fourier_transform_tpu_torch.models import _common, fnet
from mixed_radix_fast_fourier_transform_tpu_torch.utils.tree import tree_leaves, tree_map

torch.set_num_threads(1)

TOL = 1e-5
ROUTES = {"kernel": tp.DEFAULT_CONFIG, "pipeline": tp.SpectralConfig(use_kernel=False)}


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


# (seq, hidden): powers of two, 7-smooth mixes, an odd and a prime length
SHAPES = [(8, 16), (12, 16), (18, 24), (15, 10), (13, 8)]


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("seq,hidden", SHAPES)
def test_fourier_mix_matches_jax_and_numpy(rng, route, seq, hidden):
    x = rng.standard_normal((3, seq, hidden)).astype(np.float32)
    got = fnet.fourier_mix(torch.from_numpy(x), config=ROUTES[route])
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), jfnet.fourier_mix(x)) <= TOL
    assert _rel(got.numpy(), np.fft.fft2(x.astype(np.float64)).real) <= TOL


def test_mix_is_linear(rng):
    a, b = (torch.from_numpy(rng.standard_normal((2, 8, 16)).astype(np.float32))
            for _ in range(2))
    lhs = fnet.fourier_mix(2.0 * a + b)
    rhs = 2.0 * fnet.fourier_mix(a) + fnet.fourier_mix(b)
    assert _rel(lhs.numpy(), rhs.numpy()) <= TOL


@pytest.mark.parametrize("route", ROUTES)
def test_gradient_flows_through_both_transforms(rng, route):
    """d/dx of Σ w ⊙ mix(x) is the real part of the 2-D FFT of w (the DFT
    matrix is symmetric): the kernel's backward runs on cotangents of a
    moved-axis view."""
    x = torch.from_numpy(rng.standard_normal((2, 12, 16)).astype(np.float32))
    w = rng.standard_normal((2, 12, 16)).astype(np.float32)
    x.requires_grad_(True)
    (fnet.fourier_mix(x, config=ROUTES[route]) * torch.from_numpy(w)).sum().backward()
    assert _rel(x.grad.numpy(), np.fft.fft2(w.astype(np.float64)).real) <= TOL


def test_encoder_layer_matches_jax(rng):
    jp = jfnet.init_layer(jax.random.PRNGKey(1), 16, 32)
    p = fnet.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    x, mix = (rng.standard_normal((2, 12, 16)).astype(np.float32) for _ in range(2))
    got = fnet._encoder_layer(p, torch.from_numpy(x), torch.from_numpy(mix))
    assert _rel(got.numpy(), jfnet._encoder_layer(jp, x, mix)) <= TOL


@pytest.mark.parametrize("jnorm", [js4d._layer_norm, jfnet._layer_norm, jafno._layer_norm],
                         ids=["s4d", "fnet", "afno"])
@pytest.mark.parametrize("width", [4, 16, 768])
def test_layer_norm_is_the_jax_packages(rng, jnorm, width):
    """One helper for the three hand-written copies: biased variance, eps 1e-6."""
    x = (3.0 * rng.standard_normal((5, width)) + 1.0).astype(np.float32)
    scale, bias = (rng.standard_normal(width).astype(np.float32) for _ in range(2))
    got = _common.layer_norm(*map(torch.from_numpy, (x, scale, bias)))
    assert _rel(got.numpy(), jnorm(x, scale, bias)) <= TOL


def test_gelu_is_the_tanh_approximation(rng):
    x = np.linspace(-6, 6, 1001).astype(np.float32)
    got = _common.gelu(torch.from_numpy(x)).numpy()
    assert _rel(got, jax.nn.gelu(x)) <= 1e-6
    erf = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.max(np.abs(got - erf)) > 1e-4  # torch's default is another function


def test_forward_shape_and_default_ff_dim():
    params = fnet.init_fnet(16, n_layers=3, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    assert len(params["layers"]) == 3 and params["layers"][0]["w1"].shape == (16, 64)
    y = fnet.apply(params, torch.ones(2, 8, 16))
    assert y.shape == (2, 8, 16) and bool(torch.isfinite(y).all())
    assert set(fnet.init_layer(8, 16, device="cpu")) == set(params["layers"][0])


def test_no_distributed_names_yet():
    """The sequence-parallel variant comes with ``parallel/``."""
    for name in ("fourier_mix_distributed", "apply_distributed", "loss_distributed",
                 "train_step_distributed"):
        assert hasattr(jfnet, name) and not hasattr(fnet, name)


def test_training_reduces_loss(rng):
    params = fnet.init_fnet(16, n_layers=1, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    x = torch.from_numpy(rng.standard_normal((4, 8, 16)).astype(np.float32))
    target = torch.roll(x, 1, dims=1)
    _, first = fnet.train_step(params, x, target, lr=5e-2)
    for _ in range(20):
        params, loss = fnet.train_step(params, x, target, lr=5e-2)
    assert float(loss) < float(first)
    assert all(not p.requires_grad for p in tree_leaves(params))
    assert tree_map(lambda p: p.shape, params)["layers"][0]["b1"] == (64,)
