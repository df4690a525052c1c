"""PyTorch port: the S4D, FNet, AFNO and Koopman families as wholes against
the JAX package, from the same weights (carried across by
``params_from_jax``) and the same inputs (numpy, from a seed): forward on
both ``use_kernel`` routes, loss, gradients leaf by leaf, two SGD steps, the
``nn.Module`` wrappers, and checkpoints loaded across the two packages.

Tolerances, each max |got − want| / max |want|: forward 2e-5, loss 1e-5,
gradients 1e-4 of the leaf's maximum, parameters after two steps 2e-5.
"""

import jax
import numpy as np
import pytest
import torch

from mixed_radix_fast_fourier_transform_tpu import models as jmodels

import mixed_radix_fast_fourier_transform_tpu_torch as tp
from mixed_radix_fast_fourier_transform_tpu_torch import models
from mixed_radix_fast_fourier_transform_tpu_torch.models.checkpoint import _flatten
from mixed_radix_fast_fourier_transform_tpu_torch.utils.tree import tree_leaves, tree_map

torch.set_num_threads(1)

FORWARD_TOL, LOSS_TOL, GRAD_TOL, STEP_TOL = 2e-5, 1e-5, 1e-4, 2e-5
PIPELINE = tp.SpectralConfig(use_kernel=False)
KEY = jax.random.PRNGKey(0)
AFNO_KW = dict(patch=2, n_blocks=4)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


class Family:
    """One model family at a small size: the JAX functions, the port's, the
    JAX-initialised weights and a (x, target) pair."""

    def __init__(self, name, jmod, tmod, jparams, x, target, *, apply, loss, step=None,
                 module=None, init=None, routes=True):
        self.name, self.jmod, self.tmod = name, jmod, tmod
        self.jparams, self.x, self.target = jparams, x, target
        self.apply, self.loss, self.step = apply, loss, step
        self.module, self.init, self.routes = module, init, routes

    def params(self):
        return self.tmod.params_from_jax(jax.tree_util.tree_map(np.asarray, self.jparams), "cpu")


def _families():
    rng = np.random.default_rng(0)
    f32 = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    s4d = Family(
        "s4d", jmodels.s4d, models.s4d,
        jmodels.s4d.init_s4d_model(KEY, 16, n_layers=2, state=8, in_dim=3, out_dim=4),
        f32(2, 64, 3), f32(2, 4),
        apply=lambda m, p, x, **kw: m.apply_s4d(p, x, **kw),
        loss=lambda m, p, x, t, **kw: m.loss_fn(p, x, t, **kw),
        step=lambda m, p, x, t, lr, **kw: m.train_step(p, x, t, lr, **kw),
        module=lambda: models.s4d.S4D(16, 2, 8, 3, 4, device="cpu"),
        init=lambda g: models.s4d.init_s4d_model(16, 2, 8, 3, 4, generator=g, device="cpu"))
    fnet = Family(
        "fnet", jmodels.fnet, models.fnet,
        jmodels.fnet.init_fnet(KEY, 16, ff_dim=32, n_layers=2),
        f32(2, 12, 16), f32(2, 12, 16),
        apply=lambda m, p, x, **kw: m.apply(p, x, **kw),
        loss=lambda m, p, x, t, **kw: m.loss_fn(p, x, t, **kw),
        step=lambda m, p, x, t, lr, **kw: m.train_step(p, x, t, lr, **kw),
        module=lambda: models.fnet.FNet(16, 32, 2, device="cpu"),
        init=lambda g: models.fnet.init_fnet(16, 32, 2, generator=g, device="cpu"))
    afno = Family(
        "afno", jmodels.afno, models.afno,
        jmodels.afno.init_afno(KEY, 3, 16, 2, patch=2, n_layers=2, n_blocks=4),
        f32(2, 16, 24, 3), f32(2, 16, 24, 2),
        apply=lambda m, p, x, **kw: m.apply(p, x, **AFNO_KW, **kw),
        loss=lambda m, p, x, t, **kw: m.loss_fn(p, x, t, **AFNO_KW, **kw),
        step=lambda m, p, x, t, lr, **kw: m.train_step(p, x, t, lr, **AFNO_KW, **kw),
        module=lambda: models.afno.AFNO(3, 16, 2, patch=2, n_layers=2, n_blocks=4,
                                        device="cpu"),
        init=lambda g: models.afno.init_afno(3, 16, 2, patch=2, n_layers=2, n_blocks=4,
                                             generator=g, device="cpu"))
    trajs = f32(3, 20, 5)
    koopman = Family(
        "koopman", jmodels.koopman, models.koopman,
        jmodels.koopman.init_koopman(KEY, 5, latent_dim=6, hidden=16),
        trajs, None,
        apply=lambda m, p, x, **kw: m.koopman_rollout(p, x[:, 0], 6),
        loss=lambda m, p, x, t, **kw: m.koopman_loss(p, x, horizon=4),
        module=lambda: models.koopman.Koopman(5, 6, 16, device="cpu"),
        init=lambda g: models.koopman.init_koopman(5, 6, 16, generator=g, device="cpu"),
        routes=False)
    return [s4d, fnet, afno, koopman]


# positional arguments of each module's constructor, at its default device
_MODULE_ARGS = {"s4d": (16,), "fnet": (16,), "afno": (3, 16, 2), "koopman": (5,)}
FAMILIES = _families()
IDS = [f.name for f in FAMILIES]
WITH_STEP = [f for f in FAMILIES if f.step is not None]


def _tensor(a):
    return None if a is None else torch.from_numpy(a)


ROUTES = [(f, r) for f in FAMILIES for r in (("kernel", "pipeline") if f.routes else ("only",))]


@pytest.mark.parametrize("fam,route", ROUTES, ids=[f"{f.name}-{r}" for f, r in ROUTES])
def test_forward_matches_jax(fam, route):
    kw = {} if route == "only" else {
        "config": tp.DEFAULT_CONFIG if route == "kernel" else PIPELINE}
    want = np.asarray(fam.apply(fam.jmod, fam.jparams, fam.x))
    with torch.no_grad():
        got = fam.apply(fam.tmod, fam.params(), _tensor(fam.x), **kw)
    assert got.dtype == torch.float32 and np.all(np.isfinite(got.numpy()))
    assert _rel(got.numpy(), want) <= FORWARD_TOL


@pytest.mark.parametrize("fam", FAMILIES, ids=IDS)
def test_loss_and_gradients_match_jax(fam):
    jloss, jgrads = jax.value_and_grad(
        lambda p: fam.loss(fam.jmod, p, fam.x, fam.target))(fam.jparams)
    want = _flatten(jgrads)
    routes = (tp.DEFAULT_CONFIG, PIPELINE) if fam.routes else (None,)
    for config in routes:
        kw = {} if config is None else {"config": config}
        leaves = tree_map(lambda p: p.clone().requires_grad_(True), fam.params())
        loss = fam.loss(fam.tmod, leaves, _tensor(fam.x), _tensor(fam.target), **kw)
        assert abs(float(loss.detach()) - float(jloss)) <= LOSS_TOL * abs(float(jloss))
        grads = torch.autograd.grad(loss, tree_leaves(leaves), allow_unused=True)
        got = _flatten(tree_map(lambda p, it=iter(grads): next(it), leaves))
        assert set(got) == set(want)
        for path, g in want.items():
            assert got[path] is not None, path
            if np.max(np.abs(g)) == 0.0:
                assert np.max(np.abs(got[path])) == 0.0, path
            else:
                assert _rel(got[path], g) <= GRAD_TOL, path


@pytest.mark.parametrize("fam", WITH_STEP, ids=[f.name for f in WITH_STEP])
def test_two_train_steps_match_jax(fam):
    jparams, params = fam.jparams, fam.params()
    xt, tt = _tensor(fam.x), _tensor(fam.target)
    for _ in range(2):
        jparams, jloss = fam.step(fam.jmod, jparams, fam.x, fam.target, 0.05)
        params, loss = fam.step(fam.tmod, params, xt, tt, 0.05)
        assert abs(float(loss) - float(jloss)) <= LOSS_TOL * abs(float(jloss))
    want = _flatten(jparams)
    for path, got in _flatten(params).items():
        assert _rel(got, want[path]) <= STEP_TOL, path


@pytest.mark.parametrize("fam", FAMILIES, ids=IDS)
def test_module_matches_functional(fam):
    params = fam.params()
    module = fam.module()
    # every leaf is a parameter under its checkpoint key
    assert set(module.state_dict()) == set(_flatten(params))
    module.load_param_tree(params)
    xt = _tensor(fam.x)
    with torch.no_grad():
        want = fam.apply(fam.tmod, params, xt)
        got = module(xt[:, 0], 6) if fam.name == "koopman" else module(xt)
    assert torch.equal(got, want)
    if fam.step is None:
        return
    # an optimizer step on the module's parameters is the functional step
    tt = _tensor(fam.target)
    new, _ = fam.step(fam.tmod, params, xt, tt, 0.05)
    opt = torch.optim.SGD(module.parameters(), lr=0.05)
    fam.loss(fam.tmod, module.param_tree(), xt, tt).backward()
    opt.step()
    for path, want in _flatten(new).items():
        assert np.allclose(_flatten(module.param_tree())[path], want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("fam", FAMILIES, ids=IDS)
def test_init_shapes_scales_and_seed(fam):
    p = fam.init(torch.Generator().manual_seed(3))
    q = fam.init(torch.Generator().manual_seed(3))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(p), tree_leaves(q)))
    want, got = _flatten(fam.jparams), _flatten(p)
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    for path, w in want.items():
        g = got[path]
        assert g.dtype == np.float32
        if np.unique(w).size <= 2 or path.endswith(("a_im", "K")):
            # the deterministic leaves: zero biases, unit scales, S4D-Lin's A,
            # D = 1, Koopman's 0.99·I
            assert np.array_equal(g, w), path
        elif w.size >= 256:
            # random leaves: the same spread (both are N(0, 1) times a scale)
            assert 0.7 < np.std(g) / np.std(w) < 1.4, path


@pytest.mark.parametrize("fam", FAMILIES, ids=IDS)
def test_checkpoints_load_across_packages(fam, tmp_path):
    want = np.asarray(fam.apply(fam.jmod, fam.jparams, fam.x))
    # written by the JAX package, read into the port's template
    path = str(tmp_path / "from_jax.npz")
    n = jmodels.save_checkpoint(path, fam.jparams)
    template = fam.init(None)
    loaded = models.load_checkpoint(path, like=template, device="cpu")
    assert n == len(tree_leaves(template))
    assert all(t.dtype == torch.float32 and t.device.type == "cpu" for t in tree_leaves(loaded))
    with torch.no_grad():
        got = fam.apply(fam.tmod, loaded, _tensor(fam.x))
    assert _rel(got.numpy(), want) <= FORWARD_TOL
    # written by the port, read into the JAX package's template
    path = str(tmp_path / "from_port.npz")
    assert models.save_checkpoint(path, fam.params()) == n
    back = jmodels.load_checkpoint(path, like=fam.jparams)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(fam.jparams)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    assert np.array_equal(np.asarray(fam.apply(fam.jmod, back, fam.x)), want)


@pytest.mark.parametrize("fam", FAMILIES, ids=IDS)
def test_numpy_input_without_a_device_needs_the_card(fam):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((RuntimeError, AssertionError)):
        fam.apply(fam.tmod, fam.params(), fam.x)
    with pytest.raises((RuntimeError, AssertionError)):
        fam.loss(fam.tmod, fam.params(), fam.x, fam.target)
    with pytest.raises((RuntimeError, AssertionError)):
        fam.tmod.params_from_jax(jax.tree_util.tree_map(np.asarray, fam.jparams))
    with pytest.raises((RuntimeError, AssertionError)):
        type(fam.module())(*_MODULE_ARGS[fam.name])  # a module's default device too
