"""PyTorch port: the S4D layer against the JAX package (same weights, same
inputs) on both ``use_kernel`` routes, and the layer's own oracle pairing:
the FFT long convolution against the streaming recurrence.

Tolerance of every comparison with the JAX package: 1e-5 of the output's
maximum."""

import jax
import numpy as np
import pytest
import torch

from mixed_radix_fast_fourier_transform_tpu.models import s4d as js4d

import mixed_radix_fast_fourier_transform_tpu_torch as tp
from mixed_radix_fast_fourier_transform_tpu_torch.models import s4d
from mixed_radix_fast_fourier_transform_tpu_torch.ops import cuda_fft

torch.set_num_threads(1)

TOL = 1e-5
ROUTES = {"kernel": tp.SpectralConfig(use_kernel=True), "pipeline": tp.SpectralConfig(use_kernel=False)}


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


@pytest.fixture(scope="module")
def layers():
    jlayer = js4d.init_s4d_layer(jax.random.PRNGKey(0), hidden=4, state=8)
    return jlayer, s4d.params_from_jax(jax.tree_util.tree_map(np.asarray, jlayer), "cpu")


@pytest.mark.parametrize("length", [16, 96, 256])
def test_kernel_matches_jax_and_decays(layers, length):
    jlayer, layer = layers
    k = s4d.s4d_kernel(layer, length).numpy()
    assert k.shape == (4, length) and _rel(k, js4d.s4d_kernel(jlayer, length)) <= TOL
    if length == 256:  # Re(A) < 0 by construction
        assert np.max(np.abs(k[:, -16:])) < np.max(np.abs(k[:, :16]))


def test_discretize_matches_jax(layers):
    jlayer, layer = layers
    for got, want in zip(s4d._discretize(layer), js4d._discretize(jlayer)):
        assert _rel(got.numpy(), want) <= TOL


@pytest.mark.parametrize("length", [1, 7, 64, 96, 100, 1024])
def test_conv_len_matches_jax(length):
    assert s4d._conv_len(length) == js4d._conv_len(length)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("length", [64, 96, 45])
def test_conv_matches_jax(layers, rng, route, length):
    jlayer, layer = layers
    u = rng.standard_normal((2, length, 4)).astype(np.float32)
    before = cuda_fft.LAUNCHES
    got = s4d.s4d_conv(layer, torch.from_numpy(u), config=ROUTES[route])
    assert cuda_fft.LAUNCHES == before  # a CPU tensor never launches
    assert _rel(got.numpy(), js4d.s4d_conv(jlayer, u)) <= TOL


@pytest.mark.parametrize("route", ROUTES)
def test_conv_matches_recurrence(layers, rng, route):
    """The FFT long convolution and the streaming recurrence are the same
    operator (the JAX package's own oracle pairing, at its tolerance)."""
    _, layer = layers
    B, L, H, N2 = 2, 96, 4, 4
    u = torch.from_numpy(rng.standard_normal((B, L, H)).astype(np.float32))
    y_conv = s4d.s4d_conv(layer, u, config=ROUTES[route]).numpy()
    state = (torch.zeros(B, H, N2), torch.zeros(B, H, N2))
    ys = []
    for t in range(L):
        state, y = s4d.s4d_step(layer, *state, u[:, t])
        ys.append(y)
    y_rec = torch.stack(ys, dim=1).numpy()
    assert np.max(np.abs(y_conv - y_rec)) / max(1.0, np.max(np.abs(y_rec))) < 1e-4


def test_step_matches_jax(layers, rng):
    jlayer, layer = layers
    s_re, s_im = (rng.standard_normal((2, 4, 4)).astype(np.float32) for _ in range(2))
    u = rng.standard_normal((2, 4)).astype(np.float32)
    (jr, ji), jy = js4d.s4d_step(jlayer, s_re, s_im, u)
    (tr, ti), ty = s4d.s4d_step(layer, *map(torch.from_numpy, (s_re, s_im, u)))
    for got, want in ((tr, jr), (ti, ji), (ty, jy)):
        assert _rel(got.numpy(), want) <= TOL


def test_causality(layers, rng):
    _, layer = layers
    u = rng.standard_normal((1, 64, 4)).astype(np.float32)
    u2 = u.copy()
    u2[:, 40:] += 1.0
    y1 = s4d.s4d_conv(layer, torch.from_numpy(u)).numpy()
    y2 = s4d.s4d_conv(layer, torch.from_numpy(u2)).numpy()
    assert np.max(np.abs(y1[:, :40] - y2[:, :40])) < 1e-5
    assert np.max(np.abs(y1[:, 40:] - y2[:, 40:])) > 1e-3


def test_block_matches_jax(layers, rng):
    jlayer, layer = layers
    x = rng.standard_normal((2, 32, 4)).astype(np.float32)
    assert _rel(s4d.block_apply(layer, torch.from_numpy(x)).numpy(),
                js4d.block_apply(jlayer, x)) <= TOL


def test_odd_state_rejected():
    with pytest.raises(ValueError):
        s4d.init_s4d_layer(hidden=4, state=7, device="cpu")


def test_shapes_pooled_and_per_step(rng):
    params = s4d.init_s4d_model(8, n_layers=2, state=8, in_dim=3, out_dim=5,
                                generator=torch.Generator().manual_seed(1), device="cpu")
    u = torch.from_numpy(rng.standard_normal((2, 64, 3)).astype(np.float32))
    assert s4d.apply_s4d(params, u).shape == (2, 5)
    assert s4d.apply_s4d(params, u, pool=False).shape == (2, 64, 5)
    # float64 input is computed in fp32, as the JAX package does
    assert s4d.apply_s4d(params, u.double()).dtype == torch.float32


def test_training_reduces_loss(rng):
    """Learn a delayed echo, target[t] = u[t-8], as the JAX package's test does."""
    params = s4d.init_s4d_model(8, n_layers=1, state=16, in_dim=1, out_dim=1,
                                generator=torch.Generator().manual_seed(2), device="cpu")
    u = rng.standard_normal((4, 128, 1)).astype(np.float32)
    tgt = np.roll(u, 8, axis=1)
    tgt[:, :8] = 0.0
    ut, tt = torch.from_numpy(u), torch.from_numpy(tgt)
    _, loss0 = s4d.train_step(params, ut, tt, lr=2e-2)
    for _ in range(30):
        params, loss = s4d.train_step(params, ut, tt, lr=2e-2)
    assert float(loss) < float(loss0)
