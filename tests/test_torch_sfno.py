"""PyTorch port: ``models/sfno.py`` against the JAX package from the same
parameters (``params_from_jax``) and inputs: the forward, the loss and every
gradient leaf at 1e-5 of their maximum (the spectral weights' imaginary
parts, whose exact gradient is zero for a real field, at 1e-5 of the real
parts'), on the kernel route (the fused
Stockham kernel's plain version on the CPU) and on the stage pipeline; two
SGD steps; the module; checkpoints across the two packages.  An SFNO of
hidden width 8, 2 layers, L = 16 (the 16 × 32 Gauss grid), batch 2, inputs
from a local generator.  The spectral path's equivariance is checked too: a
field rotated by whole longitude cells gives the output rotated alike."""

import jax
import numpy as np
import pytest
import torch

from mixed_radix_fast_fourier_transform_tpu import models as jmodels
from mixed_radix_fast_fourier_transform_tpu.models import sfno as jsfno

import mixed_radix_fast_fourier_transform_tpu_torch as tp
from mixed_radix_fast_fourier_transform_tpu_torch import models
from mixed_radix_fast_fourier_transform_tpu_torch.models import sfno
from mixed_radix_fast_fourier_transform_tpu_torch.utils.tree import (
    tree_leaves, tree_map, tree_map_with_path,
)

torch.set_num_threads(1)

TOL = 1e-5
PIPELINE = tp.SpectralConfig(use_kernel=False)
L, HIDDEN, LAYERS, BATCH = 16, 8, 2, 2


def _rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


def _sorted(tree):
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_sorted(v) for v in tree]
    return tree


def _case(seed=0):
    jparams = jsfno.init_sfno(jax.random.PRNGKey(seed), 3, HIDDEN, 3, L - 1, n_layers=LAYERS)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((BATCH, 3, L, 2 * L)).astype(np.float32)
    target = rng.standard_normal((BATCH, 3, L, 2 * L)).astype(np.float32)
    params = sfno.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    return jparams, params, x, target


@pytest.mark.parametrize("config", [tp.SpectralConfig(use_kernel=True), PIPELINE], ids=["kernel", "pipeline"])
def test_forward_loss_and_every_gradient_leaf_match_jax(config):
    jparams, params, x, target = _case()
    xt, tt = torch.from_numpy(x), torch.from_numpy(target)
    with torch.no_grad():
        got = sfno.apply(params, xt, config=config)
    assert got.dtype == torch.float32 and got.shape == x.shape
    assert _rel(got, jax.jit(jsfno.apply)(jparams, x)) <= TOL
    jloss, jgrads = jax.jit(jax.value_and_grad(jsfno.loss_fn))(jparams, x, target)
    leaves = tree_map(lambda p: p.clone().requires_grad_(True), params)
    loss = sfno.loss_fn(leaves, xt, tt, config=config)
    assert abs(float(loss.detach()) - float(jloss)) <= TOL * abs(float(jloss))
    grads = torch.autograd.grad(loss, tree_leaves(leaves))
    by_id = {id(p): g for p, g in zip(tree_leaves(leaves), grads)}
    paths = []
    tree_map_with_path(lambda path, p: paths.append((path, p)), _sorted(leaves))
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(paths) == len(jleaves) == 2 + 4 * LAYERS + 2
    got = {path: by_id[id(p)].numpy() for path, p in paths}
    want = {path: np.asarray(jg) for (path, _), jg in zip(paths, jleaves)}
    for path in got:
        if path.endswith("r_im"):
            # Re isht(a·i·s_l) = 0 for the Hermitian a of a real field: the
            # exact gradient is zero, and both packages' leaves are rounding
            # noise, held to 1e-5 of the layer's r_re gradient
            scale = np.max(np.abs(want[path[:-2] + "re"]))
            assert np.max(np.abs(got[path])) <= TOL * scale
            assert np.max(np.abs(want[path])) <= TOL * scale
        else:
            assert _rel(got[path], want[path]) <= TOL, path


def test_two_train_steps_match_jax():
    jparams, params, x, target = _case(seed=1)
    xt, tt = torch.from_numpy(x), torch.from_numpy(target)
    jstep = jax.jit(jsfno.train_step)
    for _ in range(2):
        jparams, jloss = jstep(jparams, x, target, 0.05)
        params, loss = sfno.train_step(params, xt, tt, 0.05)
        assert abs(float(loss) - float(jloss)) <= TOL * abs(float(jloss))
    for got, want in zip(tree_leaves(_sorted(params)), jax.tree_util.tree_leaves(jparams)):
        assert not got.requires_grad and _rel(got, want) <= TOL


def test_module_init_and_equivariance():
    _, params, x, _ = _case(seed=2)
    xt = torch.from_numpy(x)
    module = sfno.SFNO(3, HIDDEN, 3, L - 1, n_layers=LAYERS,
                       generator=torch.Generator().manual_seed(0), device="cpu")
    assert set(module.state_dict()) >= {"lift/w", "layers/1/r_re", "proj/b"}
    module.load_param_tree(params)
    with torch.no_grad():
        y = module(xt)
        assert torch.equal(y, sfno.apply(params, xt))
        # rotating by whole longitude cells commutes with every layer
        y_rot = module(torch.roll(xt, 5, dims=-1))
    assert _rel(y_rot, torch.roll(y, 5, dims=-1).numpy()) <= TOL
    p = sfno.init_sfno(2, 4, 1, 7, n_layers=3, device="cpu")
    jp = jsfno.init_sfno(jax.random.PRNGKey(0), 2, 4, 1, 7, n_layers=3)
    assert [tuple(a.shape) for a in tree_leaves(_sorted(p))] == [
        a.shape for a in jax.tree_util.tree_leaves(jp)]
    assert set(sfno.init_layer(4, 8, device="cpu")) == {"r_re", "r_im", "w", "b"}
    assert models.sfno is sfno


def test_checkpoints_load_across_packages(tmp_path):
    jparams, params, x, _ = _case(seed=3)
    want = np.asarray(jax.jit(jsfno.apply)(jparams, x))
    path = str(tmp_path / "from_jax.npz")
    n = jmodels.save_checkpoint(path, jparams)
    template = sfno.init_sfno(3, HIDDEN, 3, L - 1, n_layers=LAYERS, device="cpu")
    loaded = models.load_checkpoint(path, like=template, device="cpu")
    assert n == len(tree_leaves(template))
    with torch.no_grad():
        assert _rel(sfno.apply(loaded, torch.from_numpy(x)), want) <= TOL
    path = str(tmp_path / "from_port.npz")
    assert models.save_checkpoint(path, params) == n
    back = jmodels.load_checkpoint(path, like=jparams)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jparams)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
