"""PyTorch port: the distributed spectral filter and the sequence-parallel
FNet in a gloo world of 4 CPU processes, against the JAX package on a
4-device CPU mesh (meshes (1, 4), (2, 2), (4, 1)): forwards, losses,
gradients and one SGD step.  The world and its conventions are those of
``test_torch_parallel.py``; parameters are numpy trees from a seed, given
to both packages (``params_from_jax`` on the port's side)."""

import numpy as np
import pytest
import torch

from test_torch_parallel import (
    MESHES, TOL, gathered, jax_mesh, mesh_id, real_input, rel, rng_for, run_world,
)

N = 1024            # the filter's transform length
BATCH = 4
LR = 0.5
FNET = dict(seq=64, hidden=16, ff=32, layers=2)


def filter_params() -> dict:
    r = rng_for("filter params")
    return {"gain_re": (1.0 + 0.01 * r.standard_normal(N)).astype(np.float32),
            "gain_im": (0.01 * r.standard_normal(N)).astype(np.float32),
            "bias": np.float32(0.1)}


def fnet_params() -> dict:
    r = rng_for("fnet params")
    h, ff = FNET["hidden"], FNET["ff"]

    def layer():
        return {"ln1_scale": (1 + 0.1 * r.standard_normal(h)).astype(np.float32),
                "ln1_bias": (0.1 * r.standard_normal(h)).astype(np.float32),
                "w1": (r.standard_normal((h, ff)) / np.sqrt(h)).astype(np.float32),
                "b1": (0.1 * r.standard_normal(ff)).astype(np.float32),
                "w2": (r.standard_normal((ff, h)) / np.sqrt(ff)).astype(np.float32),
                "b2": (0.1 * r.standard_normal(h)).astype(np.float32),
                "ln2_scale": (1 + 0.1 * r.standard_normal(h)).astype(np.float32),
                "ln2_bias": (0.1 * r.standard_normal(h)).astype(np.float32)}

    return {"layers": [layer() for _ in range(FNET["layers"])]}


def filter_data():
    return real_input("filter x", (BATCH, N)), real_input("filter t", (BATCH, N))


def fnet_data():
    shape = (BATCH, FNET["seq"], FNET["hidden"])
    return real_input("fnet x", shape), real_input("fnet t", shape)


def flat(tree) -> list:
    """Leaves in a fixed order (sorted dict keys, list order)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in flat(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in flat(v)]
    return [tree]


def models_world() -> dict:
    """Every case of this file on every mesh (runs on each rank)."""
    from mixed_radix_fast_fourier_transform_tpu_torch import parallel as par
    from mixed_radix_fast_fourier_transform_tpu_torch.models import fnet, params_from_jax
    from mixed_radix_fast_fourier_transform_tpu_torch.models import spectral_filter as sf

    out = {}
    fp = params_from_jax(filter_params(), "cpu")
    fnp = params_from_jax(fnet_params(), "cpu")
    (x, t), (xf, tf) = filter_data(), fnet_data()
    for shape in MESHES:
        mesh = par.make_mesh(shape, device="cpu")
        tag = mesh_id(shape)
        out[f"{tag}/filter_apply"] = gathered(sf.apply_distributed(fp, x, mesh))
        new, loss = sf.train_step_distributed(fp, x, t, mesh, lr=LR)
        out[f"{tag}/filter_loss"] = loss.numpy()
        for i, leaf in enumerate(flat(new)):
            out[f"{tag}/filter_new_{i}"] = leaf.numpy()
        # the gradients of the global loss, on every rank
        leaves = {k: v.clone().requires_grad_(True) for k, v in fp.items()}
        grads = torch.autograd.grad(sf.loss_distributed(leaves, x, t, mesh),
                                    [leaves[k] for k in sorted(leaves)])
        for i, g in enumerate(grads):
            out[f"{tag}/filter_grad_{i}"] = g.numpy()
        out[f"{tag}/fnet_mix"] = gathered(fnet.fourier_mix_distributed(xf, mesh))
        out[f"{tag}/fnet_apply"] = gathered(fnet.apply_distributed(fnp, xf, mesh))
        new, loss = fnet.train_step_distributed(fnp, xf, tf, mesh, lr=LR, data_axis=None)
        out[f"{tag}/fnet_loss"] = loss.numpy()
        for i, leaf in enumerate(flat(new)):
            out[f"{tag}/fnet_new_{i}"] = leaf.numpy()
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(__name__, "models_world", tmp_path_factory.mktemp("models"))


def _jax_tree(tree):
    import jax.numpy as jnp

    if isinstance(tree, dict):
        return {k: _jax_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_jax_tree(v) for v in tree]
    return jnp.asarray(tree)


@pytest.mark.parametrize("shape", MESHES, ids=mesh_id)
def test_filter_forward_matches_jax(world, shape):
    import jax

    from mixed_radix_fast_fourier_transform_tpu.models import spectral_filter as jsf

    mesh = jax_mesh(shape)
    x, _ = filter_data()
    want = jax.jit(lambda p, x: jsf.apply_distributed(p, x, mesh))(_jax_tree(filter_params()), x)
    assert rel(world[f"{mesh_id(shape)}/filter_apply"], want) <= TOL


@pytest.mark.parametrize("shape", MESHES, ids=mesh_id)
def test_filter_train_step_matches_jax(world, shape):
    """Loss, new parameters and the gradients of ``loss_distributed``: a
    replicated parameter's gradient is counted once on every mesh."""
    import jax

    from mixed_radix_fast_fourier_transform_tpu.models import spectral_filter as jsf

    mesh = jax_mesh(shape)
    x, t = filter_data()
    params = _jax_tree(filter_params())
    new, loss = jax.jit(lambda p, x, t: jsf.train_step_distributed(p, x, t, mesh, lr=LR))(
        params, x, t)
    grads = jax.jit(jax.grad(lambda p, x, t: jsf.loss_distributed(p, x, t, mesh)))(params, x, t)
    tag = mesh_id(shape)
    assert rel(world[f"{tag}/filter_loss"], loss) <= TOL
    for i, leaf in enumerate(flat(new)):
        assert rel(world[f"{tag}/filter_new_{i}"], leaf) <= TOL, i
    for i, g in enumerate(flat(grads)):
        assert rel(world[f"{tag}/filter_grad_{i}"], g) <= TOL, i


@pytest.mark.parametrize("shape", MESHES, ids=mesh_id)
def test_fnet_mix_and_forward_match_jax(world, shape):
    import jax

    from mixed_radix_fast_fourier_transform_tpu.models import fnet as jfnet

    mesh = jax_mesh(shape)
    x, _ = fnet_data()
    mix = jax.jit(lambda x: jfnet.fourier_mix_distributed(x, mesh))(x)
    out = jax.jit(lambda p, x: jfnet.apply_distributed(p, x, mesh))(_jax_tree(fnet_params()), x)
    tag = mesh_id(shape)
    assert rel(world[f"{tag}/fnet_mix"], mix) <= TOL
    assert rel(world[f"{tag}/fnet_apply"], out) <= TOL


@pytest.mark.parametrize("shape", MESHES, ids=mesh_id)
def test_fnet_train_step_matches_jax(world, shape):
    import jax

    from mixed_radix_fast_fourier_transform_tpu.models import fnet as jfnet

    mesh = jax_mesh(shape)
    x, t = fnet_data()
    step = jax.jit(lambda p, x, t: jfnet.train_step_distributed(p, x, t, mesh, lr=LR,
                                                                data_axis=None))
    new, loss = step(_jax_tree(fnet_params()), x, t)
    tag = mesh_id(shape)
    assert rel(world[f"{tag}/fnet_loss"], loss) <= TOL
    for i, leaf in enumerate(flat(new)):
        assert rel(world[f"{tag}/fnet_new_{i}"], leaf) <= TOL, i


def test_init_params_complex_tree_converts():
    """The JAX package's ``init_params_complex`` tree goes through
    ``params_from_jax`` unchanged; the port's own draws have its shapes."""
    import jax

    from mixed_radix_fast_fourier_transform_tpu.models import spectral_filter as jsf

    import mixed_radix_fast_fourier_transform_tpu_torch as tp

    tree = jsf.init_params_complex(jax.random.PRNGKey(3), 256)
    got = tp.models.params_from_jax(tree, "cpu")
    assert set(got) == {"gain_re", "gain_im", "bias"}
    for k in got:
        assert got[k].dtype == torch.float32 and got[k].device.type == "cpu"
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(tree[k]))
    mine = tp.models.init_params_complex(256, torch.Generator().manual_seed(0), device="cpu")
    for k in tree:
        assert tuple(mine[k].shape) == tuple(tree[k].shape)
    assert abs(float(mine["gain_re"].mean()) - 1.0) < 5e-3 and float(mine["bias"]) == 0.0
