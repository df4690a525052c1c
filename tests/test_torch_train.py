"""PyTorch port: the spectral filter's loss, gradients and SGD step against
the JAX package, through the kernel route (its plain version and its
registered gradient on the CPU) and through the stage pipeline."""

import jax
import numpy as np
import pytest
import torch

from mixed_radix_fast_fourier_transform_tpu import models as jmodels
from mixed_radix_fast_fourier_transform_tpu.utils.config import SpectralConfig as JConfig

import mixed_radix_fast_fourier_transform_tpu_torch as tp
from mixed_radix_fast_fourier_transform_tpu_torch import models as tmodels

torch.set_num_threads(1)

TOL = 1e-5  # max |got − want| / max |want|
CONFIGS = {"kernel": tp.SpectralConfig(use_kernel=True), "pipeline": tp.SpectralConfig(use_kernel=False)}


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


def _case(n, batch, seed):
    rng = np.random.default_rng(seed)
    params = {
        "gain_re": (1.0 + 0.01 * rng.standard_normal(n // 2 + 1)).astype(np.float32),
        "gain_im": (0.01 * rng.standard_normal(n // 2 + 1)).astype(np.float32),
        "bias": np.float32(0.05),
    }
    x = rng.standard_normal((batch, n)).astype(np.float32)
    target = rng.standard_normal((batch, n)).astype(np.float32)
    return params, x, target


@pytest.mark.parametrize("route", ["kernel", "pipeline"])
@pytest.mark.parametrize("n", [256, 360, 45])
def test_loss_and_gradients_match_jax(n, route):
    params, x, target = _case(n, 4, n)
    want_loss, want = jax.value_and_grad(jmodels.loss_fn)(params, x, target)
    tparams = {k: v.requires_grad_(True)
               for k, v in tmodels.params_from_jax(params, "cpu").items()}
    loss = tmodels.loss_fn(tparams, torch.from_numpy(x), torch.from_numpy(target),
                           config=CONFIGS[route])
    grads = torch.autograd.grad(loss, list(tparams.values()))
    assert abs(float(loss.detach()) - float(want_loss)) <= TOL * abs(float(want_loss))
    for k, g in zip(tparams, grads):
        assert _rel(g.numpy(), want[k]) <= TOL, k


def test_loss_matches_jax_through_its_kernel():
    """The JAX loss through the Pallas kernel (interpret mode on the CPU).
    ``jax.grad`` cannot pass a ``pallas_call``, so the gradients above are
    held against the JAX package's default route."""
    n = 256
    params, x, target = _case(n, 4, 3)
    want = jmodels.loss_fn(params, x, target, config=JConfig(use_pallas=True))
    got = tmodels.loss_fn(tmodels.params_from_jax(params, "cpu"), torch.from_numpy(x),
                          torch.from_numpy(target))
    assert abs(float(got) - float(want)) <= TOL * abs(float(want))


@pytest.mark.parametrize("route", ["kernel", "pipeline"])
def test_three_train_steps_match_jax(route):
    n = 512
    params, x, target = _case(n, 8, 7)
    step = jax.jit(jmodels.train_step)
    jp = params
    tparams = tmodels.params_from_jax(params, "cpu")
    xt, tt = torch.from_numpy(x), torch.from_numpy(target)
    for _ in range(3):
        jp, jloss = step(jp, x, target)
        before = {k: v.clone() for k, v in tparams.items()}
        new, loss = tmodels.train_step(tparams, xt, tt, config=CONFIGS[route])
        # functional: the parameters given are untouched, the result is detached
        assert all(torch.equal(tparams[k], before[k]) for k in before)
        assert not loss.requires_grad and not any(v.requires_grad for v in new.values())
        tparams = new
        assert abs(float(loss) - float(jloss)) <= TOL * abs(float(jloss))
        for k in jp:
            assert _rel(tparams[k].numpy(), jp[k]) <= TOL, k


def test_module_with_sgd_takes_the_same_step():
    n = 360
    params, x, target = _case(n, 4, 9)
    xt, tt = torch.from_numpy(x), torch.from_numpy(target)
    tparams = tmodels.params_from_jax(params, "cpu")
    new, loss = tmodels.train_step(tparams, xt, tt, lr=1e-2)
    module = tmodels.SpectralFilter(n, device="cpu")
    module.load_state_dict(tparams)
    opt = torch.optim.SGD(module.parameters(), lr=1e-2)
    opt.zero_grad()
    mloss = torch.mean((module(xt) - tt) ** 2)
    mloss.backward()
    opt.step()
    assert float(mloss.detach()) == float(loss)
    for k, v in module.state_dict().items():
        assert torch.allclose(v, new[k], rtol=1e-6, atol=1e-7), k


def test_input_gradient_matches_jax():
    n = 360
    params, x, target = _case(n, 3, 13)
    want = jax.grad(lambda xx: jmodels.loss_fn(params, xx, target))(x)
    xt = torch.from_numpy(x).requires_grad_(True)
    loss = tmodels.loss_fn(tmodels.params_from_jax(params, "cpu"), xt,
                           torch.from_numpy(target))
    (g,) = torch.autograd.grad(loss, [xt])
    assert _rel(g.numpy(), want) <= TOL


def test_training_after_a_forward_under_inference_mode():
    """Plan constants are uploaded at first use and kept: a first use under
    ``torch.inference_mode()`` must leave them usable under autograd."""
    n = 128
    params, x, target = _case(n, 2, 17)
    tparams = tmodels.params_from_jax(params, "cpu")
    xt, tt = torch.from_numpy(x), torch.from_numpy(target)
    for route in CONFIGS.values():
        tp.clear_plan_cache()
        with torch.inference_mode():
            want = tmodels.loss_fn(tparams, xt, tt, config=route)
        _, loss = tmodels.train_step(tparams, xt, tt, config=route)
        assert float(loss) == float(want)
