"""PyTorch port: the Koopman autoencoder's pieces against the JAX package
from the same weights.  Tolerance: 1e-5 of the output's maximum."""

import jax
import numpy as np
import pytest
import torch

from mixed_radix_fast_fourier_transform_tpu.models import koopman as jk

from mixed_radix_fast_fourier_transform_tpu_torch import models
from mixed_radix_fast_fourier_transform_tpu_torch.models import koopman
from mixed_radix_fast_fourier_transform_tpu_torch.utils.tree import sgd_step

torch.set_num_threads(1)

TOL = 1e-5


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


@pytest.fixture(scope="module")
def both():
    jp = jk.init_koopman(jax.random.PRNGKey(0), 4, latent_dim=8, hidden=16, depth=2)
    # a K that is not diagonal, so that the order of the products matters
    jp["K"] = jp["K"] + 0.05 * jax.random.normal(jax.random.PRNGKey(1), (8, 8))
    return jp, koopman.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")


def test_encode_decode_match_jax(both, rng):
    jp, p = both
    x = rng.standard_normal((3, 7, 4)).astype(np.float32)
    z = koopman.koopman_encode(p, torch.from_numpy(x))
    assert z.shape == (3, 7, 8) and _rel(z.numpy(), jk.koopman_encode(jp, x)) <= TOL
    back = koopman.koopman_decode(p, z)
    assert _rel(back.numpy(), jk.koopman_decode(jp, np.asarray(z))) <= TOL


@pytest.mark.parametrize("n_steps", [0, 1, 5, 40])
def test_rollout_matches_jax(both, rng, n_steps):
    jp, p = both
    x0 = rng.standard_normal((3, 4)).astype(np.float32)
    got = koopman.koopman_rollout(p, torch.from_numpy(x0), n_steps)
    assert got.shape == (n_steps + 1, 3, 4)
    assert _rel(got.numpy(), jk.koopman_rollout(jp, x0, n_steps)) <= TOL


@pytest.mark.parametrize("horizon", [1, 4, 8])
@pytest.mark.parametrize("weights", [(1.0, 1.0, 0.3), (0.5, 2.0, 0.0)])
def test_loss_matches_jax(both, rng, horizon, weights):
    jp, p = both
    trajs = rng.standard_normal((3, 12, 4)).astype(np.float32)
    kw = dict(zip(("w_recon", "w_pred", "w_lin"), weights))
    got = float(koopman.koopman_loss(p, torch.from_numpy(trajs), horizon, **kw))
    want = float(jk.koopman_loss(jp, trajs, horizon, **kw))
    assert abs(got - want) <= TOL * abs(want)


def test_spectrum_is_float64_on_the_host(both):
    jp, p = both
    eigs, rates = koopman.koopman_spectrum(p)
    jeigs, jrates = jk.koopman_spectrum(jp)
    assert eigs.dtype == np.complex128 and rates.dtype == np.complex128
    assert np.allclose(np.sort_complex(eigs), np.sort_complex(jeigs), atol=1e-12)
    assert np.allclose(np.sort_complex(rates), np.sort_complex(jrates), atol=1e-12)
    fresh = koopman.init_koopman(3, latent_dim=6, device="cpu")
    eigs, rates = koopman.koopman_spectrum(fresh)
    assert eigs.shape == (6,) and np.allclose(eigs, 0.99)
    assert np.allclose(rates.real, np.log(0.99))


def test_errors(both):
    _, p = both
    with pytest.raises(ValueError):
        koopman.init_koopman(0, device="cpu")
    with pytest.raises(ValueError):
        koopman.koopman_rollout(p, torch.zeros(1, 4), -1)
    with pytest.raises(ValueError):
        koopman.koopman_loss(p, torch.zeros(12, 4))
    with pytest.raises(ValueError):
        koopman.koopman_loss(p, torch.zeros(2, 8, 4), horizon=8)


def test_package_level_names():
    for name in jk.__all__:
        assert getattr(models, name) is getattr(koopman, name)


def test_trains_and_forecasts():
    """A damped rotation is linear already: a few hundred SGD steps on the
    Lusch loss bring the multi-step forecast close (the JAX package's own
    test, shortened)."""
    theta, decay = 0.3, 0.97
    A = decay * np.array([[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]])
    rng = np.random.default_rng(0)
    x = rng.standard_normal((32, 2))
    traj = [x]
    for _ in range(15):
        traj.append(traj[-1] @ A.T)
    trajs = torch.from_numpy(np.stack(traj, axis=1).astype(np.float32))
    params = koopman.init_koopman(2, latent_dim=4, hidden=16, depth=1,
                                  generator=torch.Generator().manual_seed(0), device="cpu")
    first = float(koopman.koopman_loss(params, trajs, horizon=4))
    for _ in range(150):
        params, loss = sgd_step(koopman.koopman_loss, params, trajs, lr=5e-2, horizon=4)
    assert float(loss) < 0.5 * first
