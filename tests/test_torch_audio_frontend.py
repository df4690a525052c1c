"""PyTorch port: the trainable PCEN audio front end
(``models/audio_frontend.py``) against the JAX package from the same numpy
parameter tree and waveforms, as a whole: features, logits, loss, every
gradient leaf, the parameters after one ``train_step``, the ``nn.Module``
against the functional form, and checkpoints in both directions.

Tolerance: 1e-5 of the output's maximum for features, logits and the loss;
gradients run back through the smoother's recurrence and the FFT at the
opposite sign and are held to 1e-4 of each leaf's maximum."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mixed_radix_fast_fourier_transform_tpu import models as jmodels
from mixed_radix_fast_fourier_transform_tpu.models import audio_frontend as jaf

import mixed_radix_fast_fourier_transform_tpu_torch as tp
from mixed_radix_fast_fourier_transform_tpu_torch.models import audio_frontend as taf
from mixed_radix_fast_fourier_transform_tpu_torch.utils.tree import tree_leaves, tree_map

torch.set_num_threads(1)

TOL = 1e-5
GRAD_TOL = 1e-4
N_MELS, N_CLASSES, BATCH, T = 16, 5, 4, 3000
ROUTES = {"kernel": tp.SpectralConfig(use_kernel=True), "pipeline": tp.SpectralConfig(use_kernel=False)}


def _rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30)


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(11)
    tree = {
        "frontend": {
            "log_gain": np.log(rng.uniform(0.7, 1.0, N_MELS)).astype(np.float32),
            "log_bias": np.log(rng.uniform(1.0, 3.0, N_MELS)).astype(np.float32),
            "log_power": np.log(rng.uniform(0.3, 0.7, N_MELS)).astype(np.float32),
            "smooth_logit": rng.uniform(-4.0, -2.0, N_MELS).astype(np.float32),
        },
        "head": {
            "w": (rng.standard_normal((N_MELS, N_CLASSES)) / 4).astype(np.float32),
            "b": (0.1 * rng.standard_normal(N_CLASSES)).astype(np.float32),
        },
    }
    x = rng.standard_normal((BATCH, T)).astype(np.float32)
    labels = rng.integers(0, N_CLASSES, BATCH).astype(np.int32)
    return tree, x, labels


def _jax_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.mark.parametrize("route", ROUTES)
def test_features_logits_and_loss(case, route):
    tree, x, labels = case
    jp, p = _jax_tree(tree), taf.params_from_jax(tree, device="cpu")
    xt = torch.from_numpy(x)
    feats = taf.apply_frontend(p["frontend"], xt, config=ROUTES[route])
    assert feats.shape == (BATCH, 1 + -(-T // 128), N_MELS)
    assert _rel(feats, jaf.apply_frontend(jp["frontend"], x)) <= TOL
    assert _rel(taf.apply_frontend(p["frontend"], xt, 8000.0, 256, 100, 1e-4, config=ROUTES[route]),
                jaf.apply_frontend(jp["frontend"], x, 8000.0, 256, 100, 1e-4)) <= TOL
    assert _rel(taf.apply(p, xt, config=ROUTES[route]), jaf.apply(jp, x)) <= TOL
    assert _rel(taf.apply(p, xt, 16000.0, 256, 64, config=ROUTES[route]),
                jaf.apply(jp, x, 16000.0, 256, 64)) <= TOL
    loss = taf.loss_fn(p, xt, torch.from_numpy(labels), config=ROUTES[route])
    assert _rel(loss, jaf.loss_fn(jp, x, jnp.asarray(labels))) <= TOL


@pytest.mark.parametrize("route", ROUTES)
def test_gradients_leaf_by_leaf_and_train_step(case, route):
    tree, x, labels = case
    jp = _jax_tree(tree)
    want_loss, want_grads = jax.value_and_grad(jaf.loss_fn)(jp, x, jnp.asarray(labels))
    p = tree_map(lambda v: v.requires_grad_(), taf.params_from_jax(tree, device="cpu"))
    xt = torch.from_numpy(x).requires_grad_()
    loss = taf.loss_fn(p, xt, labels, config=ROUTES[route])
    loss.backward()
    assert _rel(loss, want_loss) <= TOL
    for group in tree:
        for name in tree[group]:
            assert _rel(p[group][name].grad, want_grads[group][name]) <= GRAD_TOL, (group, name)
    want_gx = jax.grad(lambda xx: jaf.loss_fn(jp, xx, jnp.asarray(labels)))(x)
    assert _rel(xt.grad, want_gx) <= GRAD_TOL

    want_new, want_l = jaf.train_step(jp, x, jnp.asarray(labels), lr=0.1)
    new, l = taf.train_step(taf.params_from_jax(tree, device="cpu"), torch.from_numpy(x), labels,
                            lr=0.1, config=ROUTES[route])
    assert _rel(l, want_l) <= TOL and not l.requires_grad
    for group in tree:
        for name in tree[group]:
            assert _rel(new[group][name], want_new[group][name]) <= TOL, (group, name)
            assert not new[group][name].requires_grad


def test_init_matches_the_published_values_and_the_jax_tree():
    g = torch.Generator().manual_seed(0)
    p = taf.init_params(40, 35, generator=g, device="cpu")
    jp = jaf.init_params(jax.random.PRNGKey(0), 40, 35)
    for group in jp:
        assert set(p[group]) == set(jp[group])
        for name in jp[group]:
            assert tuple(p[group][name].shape) == jp[group][name].shape
    for name in jp["frontend"]:      # no draw: the published initialisation, to fp32 rounding
        assert _rel(p["frontend"][name], jp["frontend"][name]) <= 2e-6
    assert float(p["head"]["b"].abs().max()) == 0.0
    assert abs(float(p["head"]["w"].std()) - 1 / np.sqrt(40)) < 0.03
    again = taf.init_params(40, 35, generator=torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(again["head"]["w"], p["head"]["w"])
    f = taf.init_frontend(8, device="cpu")
    assert set(f) == {"log_gain", "log_bias", "log_power", "smooth_logit"}
    c = taf.init_classifier(8, 3, generator=torch.Generator().manual_seed(1), device="cpu")
    assert c["w"].shape == (8, 3) and c["b"].shape == (3,)


def test_module_against_the_functional_form(case):
    tree, x, labels = case
    model = taf.AudioFrontend(N_MELS, N_CLASSES, generator=torch.Generator().manual_seed(0), device="cpu")
    model.load_param_tree(taf.params_from_jax(tree, device="cpu"))
    xt = torch.from_numpy(x)
    want = taf.apply(taf.params_from_jax(tree, device="cpu"), xt)
    assert torch.equal(model(xt), want)
    assert sorted(n for n, _ in model.named_parameters()) == sorted(
        f"{g}/{k}" for g in tree for k in tree[g])
    loss = torch.nn.functional.cross_entropy(model(xt), torch.from_numpy(labels).long())
    loss.backward()
    assert all(q.grad is not None and torch.isfinite(q.grad).all() for q in model.parameters())
    assert _rel(loss, jaf.loss_fn(_jax_tree(tree), x, jnp.asarray(labels))) <= TOL
    small = taf.AudioFrontend(8, 2, device="cpu", sr=8000.0, n_fft=256, hop=64)
    assert small(xt).shape == (BATCH, 2)


def test_training_lowers_the_loss(case):
    tree, x, labels = case
    p = taf.params_from_jax(tree, device="cpu")
    first = None
    for _ in range(5):
        p, loss = taf.train_step(p, torch.from_numpy(x), labels, lr=0.5)
        first = float(loss) if first is None else first
    assert float(loss) < first
    assert all(torch.isfinite(v).all() for v in tree_leaves(p))


def test_checkpoints_both_ways(case, tmp_path):
    tree, x, _ = case
    jp, p = _jax_tree(tree), taf.params_from_jax(tree, device="cpu")
    # written by the port, read by the JAX package
    tp.models.save_checkpoint(str(tmp_path / "torch.npz"), p)
    back = jmodels.load_checkpoint(str(tmp_path / "torch.npz"), jp)
    assert _rel(taf.apply(p, torch.from_numpy(x)), jaf.apply(back, x)) <= TOL
    # written by the JAX package, read by the port
    jmodels.save_checkpoint(str(tmp_path / "jax.npz"), jp)
    mine = tp.models.load_checkpoint(str(tmp_path / "jax.npz"), p, device="cpu")
    for group in tree:
        for name in tree[group]:
            assert torch.equal(mine[group][name], p[group][name])
    assert _rel(taf.apply(mine, torch.from_numpy(x)), jaf.apply(jp, x)) <= TOL
