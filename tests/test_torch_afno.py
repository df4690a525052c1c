"""PyTorch port: AFNO's spectral filter and block against the JAX package
(same weights, same inputs) on both ``use_kernel`` routes, with and without
the hard mode fraction.

Tolerance: 1e-5 of the output's maximum, by max-abs error (an element within
rounding of the soft-shrink threshold may be zero on one side and not on the
other; the error that causes is bounded by the rounding itself)."""

import jax
import numpy as np
import pytest
import torch

from mixed_radix_fast_fourier_transform_tpu.models import afno as jafno
from mixed_radix_fast_fourier_transform_tpu.utils.config import SpectralConfig as JaxConfig

import mixed_radix_fast_fourier_transform_tpu_torch as tp
from mixed_radix_fast_fourier_transform_tpu_torch.models import afno
from mixed_radix_fast_fourier_transform_tpu_torch.utils.tree import tree_map

torch.set_num_threads(1)

TOL = 1e-5
ROUTES = {"kernel": tp.SpectralConfig(use_kernel=True), "pipeline": tp.SpectralConfig(use_kernel=False)}


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


@pytest.fixture(scope="module")
def blocks():
    """A block of dim 16 in 4 groups with weights large enough that the
    soft shrinkage passes a good part of the spectrum."""
    jblk = jafno.init_block(jax.random.PRNGKey(0), 16, 4)
    jblk = {k: (v * 10.0 if k.startswith("w") else v) for k, v in jblk.items()}
    return jblk, afno.params_from_jax(jax.tree_util.tree_map(np.asarray, jblk), "cpu")


# token grids: even and odd widths (odd: the two-for-one rfft), a 7-smooth mix
GRIDS = [(8, 12), (6, 9), (10, 18)]


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("hard_fraction", [1.0, 0.5, 0.1])
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_filter_matches_jax(blocks, rng, route, hard_fraction, grid):
    jblk, blk = blocks
    x = rng.standard_normal((2, *grid, 16)).astype(np.float32)
    want = np.asarray(jafno.afno_filter(jblk, x, 4, hard_fraction=hard_fraction))
    got = afno.afno_filter(blk, torch.from_numpy(x), 4, hard_fraction=hard_fraction,
                           config=ROUTES[route])
    assert got.shape == x.shape and np.max(np.abs(want)) > 0
    assert _rel(got.numpy(), want) <= TOL


@pytest.mark.parametrize("sparsity", [0.0, 0.01, 0.5])
def test_soft_shrinkage_matches_jax(blocks, rng, sparsity):
    jblk, blk = blocks
    x = rng.standard_normal((1, 8, 12, 16)).astype(np.float32)
    want = np.asarray(jafno.afno_filter(jblk, x, 4, sparsity=sparsity))
    got = afno.afno_filter(blk, torch.from_numpy(x), 4, sparsity=sparsity)
    assert _rel(got.numpy(), want) <= TOL


@pytest.mark.parametrize("route", ROUTES)
def test_block_matches_jax(blocks, rng, route):
    jblk, blk = blocks
    x = rng.standard_normal((2, 8, 12, 16)).astype(np.float32)
    got = afno.afno_block(blk, torch.from_numpy(x), 4, config=ROUTES[route])
    assert _rel(got.numpy(), jafno.afno_block(jblk, x, 4)) <= TOL


def test_filter_zero_weights_zero_output(blocks, rng):
    """With zero spectral weights and biases the filter contributes nothing."""
    _, blk = blocks
    zero = tree_map(torch.zeros_like, blk)
    x = torch.from_numpy(rng.standard_normal((2, 8, 12, 16)).astype(np.float32))
    assert float(afno.afno_filter(zero, x, 4).abs().max()) == 0.0


def test_forward_shape_and_hard_fraction():
    params = afno.init_afno(2, 32, 1, patch=4, n_layers=2, n_blocks=4,
                            generator=torch.Generator().manual_seed(0), device="cpu")
    x = torch.randn(2, 16, 16, 2, generator=torch.Generator().manual_seed(1))
    y = afno.apply(params, x, patch=4)
    assert y.shape == (2, 16, 16, 1) and y.dtype == torch.float32
    yh = afno.apply(params, x, patch=4, hard_fraction=0.5)
    assert yh.shape == y.shape and not torch.allclose(yh, y)


def test_gradients_flow_through_the_spectral_mlp():
    params = afno.init_afno(2, 32, 1, patch=4, n_layers=2, n_blocks=4,
                            generator=torch.Generator().manual_seed(0), device="cpu")
    gen = torch.Generator().manual_seed(1)
    x, tgt = torch.randn(2, 16, 16, 2, generator=gen), torch.randn(2, 16, 16, 1, generator=gen)
    leaves = tree_map(lambda p: p.requires_grad_(True), params)
    afno.loss_fn(leaves, x, tgt, patch=4).backward()
    assert float(leaves["blocks"][0]["w1_re"].grad.abs().max()) > 0.0
    assert float(leaves["blocks"][1]["w2_im"].grad.abs().max()) > 0.0


def test_patch_and_block_divisibility_errors():
    params = afno.init_afno(2, 8, 1, patch=4, n_layers=1, n_blocks=4, device="cpu")
    with pytest.raises(ValueError):
        afno.apply(params, torch.zeros(1, 15, 16, 2), patch=4)
    with pytest.raises(ValueError):
        afno.init_block(30, 4, device="cpu")


def test_no_precision_lever():
    """The AFNO's spectral products read ``config.op_precision``, which
    resolves as the JAX package's: "highest" by default, a lower-cased
    name as it is, and the stage-only schemes (a per-stage tuple,
    "split6") to "highest"."""
    assert tp.DEFAULT_CONFIG.op_precision == "highest"
    for prec in ("highest", "High", "default", "split6", ("highest", "high")):
        want = JaxConfig(precision=prec).op_precision
        assert tp.SpectralConfig(precision=prec).op_precision == (
            want.lower() if isinstance(want, str) else want)
