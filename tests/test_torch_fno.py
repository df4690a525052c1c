"""PyTorch port: the 1-D, 2-D and 3-D Fourier neural operators against the
JAX package: forward, gradients and SGD steps from the same parameters."""

import jax
import numpy as np
import pytest
import torch

from mixed_radix_fast_fourier_transform_tpu.models import fno as jfno

import mixed_radix_fast_fourier_transform_tpu_torch as tp
from mixed_radix_fast_fourier_transform_tpu_torch.models import fno
from mixed_radix_fast_fourier_transform_tpu_torch.utils.tree import tree_leaves, tree_map

torch.set_num_threads(1)

TOL = 1e-5  # max |got − want| / max |want|
PIPELINE = tp.SpectralConfig(use_kernel=False)

# dims -> (JAX init, JAX apply, JAX loss, JAX step, port apply, loss, step, module)
FAMILY = {
    1: (jfno.init_fno, jfno.apply, jfno.loss_fn, jfno.train_step,
        fno.apply, fno.loss_fn, fno.train_step, fno.FNO1d),
    2: (jfno.init_fno2d, jfno.apply2d, jfno.loss_fn2d, jfno.train_step2d,
        fno.apply2d, fno.loss_fn2d, fno.train_step2d, fno.FNO2d),
    3: (jfno.init_fno3d, jfno.apply3d, jfno.loss_fn3d, jfno.train_step3d,
        fno.apply3d, fno.loss_fn3d, fno.train_step3d, fno.FNO3d),
}
# (dims, grid, modes): 2-smooth, mixed-radix and odd (two-for-one rfft) lengths
CASES = [(1, (64,), 8), (1, (90,), 6), (1, (45,), 5), (2, (16, 12), 4),
         (2, (10, 15), 3), (3, (8, 6, 10), 2)]
IDS = [f"{d}d-{'x'.join(map(str, g))}" for d, g, _ in CASES]


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


def _case(dims, grid, modes, seed=0):
    jparams = FAMILY[dims][0](jax.random.PRNGKey(seed), 2, 6, 3, n_layers=2, modes=modes)
    nparams = jax.tree_util.tree_map(np.asarray, jparams)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 2, *grid)).astype(np.float32)
    target = rng.standard_normal((2, 3, *grid)).astype(np.float32)
    return jparams, fno.params_from_jax(nparams, "cpu"), x, target


@pytest.mark.parametrize("dims,grid,modes", CASES, ids=IDS)
def test_forward_and_gradients_match_jax(dims, grid, modes):
    _, japply, jloss, _, tapply, tloss, _, _ = FAMILY[dims]
    jparams, params, x, target = _case(dims, grid, modes)
    xt, tt = torch.from_numpy(x), torch.from_numpy(target)
    want = np.asarray(jax.jit(japply)(jparams, x))
    for config in (tp.DEFAULT_CONFIG, PIPELINE):
        with torch.no_grad():
            got = tapply(params, xt, config=config)
        assert got.dtype == torch.float32 and _rel(got.numpy(), want) <= TOL
    jgrads = jax.tree_util.tree_leaves(jax.jit(jax.grad(jloss))(jparams, x, target))
    leaves = tree_map(lambda p: p.clone().requires_grad_(True), params)
    grads = torch.autograd.grad(tloss(leaves, xt, tt), tree_leaves(leaves))
    # the port's trees are dicts in insertion order, JAX's leaves sorted by key
    order = tree_leaves(tree_map(lambda p: p, _sorted(leaves)))
    by_id = {id(p): g for p, g in zip(tree_leaves(leaves), grads)}
    assert len(order) == len(jgrads)
    for p, jg in zip(order, jgrads):
        assert _rel(by_id[id(p)].numpy(), jg) <= TOL


def _sorted(tree):
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_sorted(v) for v in tree]
    return tree


@pytest.mark.parametrize("dims,grid,modes", [CASES[1], CASES[3], CASES[5]],
                         ids=[IDS[1], IDS[3], IDS[5]])
def test_two_train_steps_match_jax(dims, grid, modes):
    _, _, _, jstep, _, _, tstep, _ = FAMILY[dims]
    jparams, params, x, target = _case(dims, grid, modes, seed=1)
    xt, tt = torch.from_numpy(x), torch.from_numpy(target)
    jstep = jax.jit(jstep)
    for _ in range(2):
        jparams, jloss = jstep(jparams, x, target, 0.05)
        params, loss = tstep(params, xt, tt, 0.05)
        assert abs(float(loss) - float(jloss)) <= TOL * abs(float(jloss))
    for got, want in zip(tree_leaves(_sorted(params)), jax.tree_util.tree_leaves(jparams)):
        assert not got.requires_grad and _rel(got.numpy(), want) <= TOL


@pytest.mark.parametrize("dims,grid,modes", [CASES[0], CASES[3], CASES[5]],
                         ids=[IDS[0], IDS[3], IDS[5]])
def test_module_matches_functional(dims, grid, modes):
    tapply, module_cls = FAMILY[dims][4], FAMILY[dims][7]
    _, params, x, _ = _case(dims, grid, modes, seed=2)
    xt = torch.from_numpy(x)
    module = module_cls(2, 6, 3, n_layers=2, modes=modes,
                        generator=torch.Generator().manual_seed(0), device="cpu")
    assert set(module.state_dict()) >= {"lift.w", "layers.1.w", "proj.b"}
    assert len(list(module.parameters())) == len(tree_leaves(params))
    module.load_param_tree(params)
    with torch.no_grad():
        assert torch.equal(module(xt), tapply(params, xt))
    # an optimizer step on the module is the functional step
    step = FAMILY[dims][6]
    target = torch.zeros(2, 3, *grid)
    new, _ = step(params, xt, target, 0.05)
    opt = torch.optim.SGD(module.parameters(), lr=0.05)
    torch.mean((module(xt) - target) ** 2).backward()
    opt.step()
    for got, want in zip(tree_leaves(_sorted(module.param_tree())), tree_leaves(_sorted(new))):
        assert torch.allclose(got, want, rtol=1e-6, atol=1e-7)


def test_init_shapes_and_seed():
    g = torch.Generator().manual_seed(3)
    p = fno.init_fno(2, 8, 1, n_layers=3, modes=5, generator=g, device="cpu")
    assert len(p["layers"]) == 3 and p["layers"][0]["r_re"].shape == (8, 8, 5)
    assert p["lift"]["w"].shape == (2, 8) and p["proj"]["w"].shape == (8, 1)
    assert float(p["layers"][0]["b"].abs().sum()) == 0.0
    q = fno.init_fno(2, 8, 1, n_layers=3, modes=5,
                     generator=torch.Generator().manual_seed(3), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(p), tree_leaves(q)))
    jp = jfno.init_fno(jax.random.PRNGKey(0), 2, 8, 1, n_layers=3, modes=5)
    assert [tuple(a.shape) for a in tree_leaves(_sorted(p))] == [
        a.shape for a in jax.tree_util.tree_leaves(jp)]
    assert set(fno.init_layer2d(4, 3, 2, device="cpu")) == set(
        jfno.init_layer2d(jax.random.PRNGKey(0), 4, 3, 2))
    assert {k: tuple(v.shape) for k, v in fno.init_layer3d(4, 3, 2, 2, device="cpu").items()} == {
        k: v.shape for k, v in jfno.init_layer3d(jax.random.PRNGKey(0), 4, 3, 2, 2).items()}
    assert set(fno.init_layer(4, 3, device="cpu")) == {"r_re", "r_im", "w", "b"}


def test_too_many_modes_raise():
    p2 = fno.init_fno2d(1, 2, 1, modes=5, device="cpu")
    with pytest.raises(ValueError):
        fno.apply2d(p2, torch.ones(1, 1, 8, 16))
    p3 = fno.init_fno3d(1, 2, 1, modes=3, device="cpu")
    with pytest.raises(ValueError):
        fno.apply3d(p3, torch.ones(1, 1, 4, 8, 8))
