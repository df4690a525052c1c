"""PyTorch port: every model family on batch-sharded DTensors
(``utils/sharding.py``), in a gloo world of 4 CPU processes on the mesh
(4, 1), against ``jax.jit`` of the JAX functions on the JAX package's
sharded 4-device CPU mesh (``shard_batch``), as
``tests/test_torch_parallel_batch.py`` holds the ops.

The forwards (the FNO in 1-D to 3-D, S4D pooled and not, FNet, the SFNO,
the PCEN front end and its classifier, Koopman's encoder, decoder and
rollout) run on each rank's block and return DTensors sharded along the
batch (one axis later for the rollout, which stacks its steps in front).
Each ``train_step`` on sharded batches, and the gradient of
``koopman_loss``, is data-parallel through the one global-mean core: the
global loss, and on every rank the same plain new parameters, equal to the
JAX step on the sharded mesh and to the port's own step on the whole batch.
On the mesh (2, 2) a step whose input is sharded over ``seq`` along a
transformed axis gathers that axis and weights the replicated blocks.
Parameters are drawn once by the port's initialisers from a seed and given
to both packages (``params_from_jax``).  The world and its conventions are
those of ``test_torch_parallel.py``."""

import importlib

import numpy as np
import pytest

from test_torch_parallel import TOL, gathered, jax_mesh, real_input, rel, rng_for, run_world

MESH = (4, 1)
LR = 0.1
SR, N_FFT = 16000.0, 256


def _numpy_tree(p):
    from mixed_radix_fast_fourier_transform_tpu_torch.utils.tree import tree_map

    return tree_map(lambda v: v.numpy(), p)


def _init(module: str, name: str, *args, **kw):
    """The port's initialiser ``models.<module>.<name>`` on the CPU from
    seed 0, as a tree of numpy arrays (both packages take it)."""
    import torch

    mod = importlib.import_module(f"mixed_radix_fast_fourier_transform_tpu_torch.models.{module}")
    return _numpy_tree(getattr(mod, name)(*args, generator=torch.Generator().manual_seed(0),
                                          device="cpu", **kw))


PARAMS = {
    "fno": lambda: _init("fno", "init_fno", 2, 8, 1, 2, 4),
    "fno2d": lambda: _init("fno", "init_fno2d", 1, 6, 1, 1, 3),
    "fno3d": lambda: _init("fno", "init_fno3d", 1, 4, 1, 1, 2),
    "s4d": lambda: _init("s4d", "init_s4d_model", 8, 1, 8, 3, 2),
    "fnet": lambda: _init("fnet", "init_fnet", 8, 16, 1),
    "sfno": lambda: _init("sfno", "init_sfno", 2, 4, 2, 7, 1),
    "audio_frontend": lambda: _init("audio_frontend", "init_params", 16, 3),
    "koopman": lambda: _init("koopman", "init_koopman", 4, 8, 16, 2),
}


def _labels():
    return rng_for("labels").integers(0, 3, 8).astype(np.int64)


# name: (module, params, inputs (the batch array first), call(M, p, *inputs),
# the axis the output's batch sits on)
FORWARDS = {
    "fno.apply": ("fno", "fno", lambda: (real_input("fno x", (8, 2, 64)),),
                  lambda M, p, x: M.apply(p, x), 0),
    "fno.apply2d": ("fno", "fno2d", lambda: (real_input("fno2 x", (8, 1, 16, 16)),),
                    lambda M, p, x: M.apply2d(p, x), 0),
    "fno.apply3d": ("fno", "fno3d", lambda: (real_input("fno3 x", (8, 1, 8, 8, 8)),),
                    lambda M, p, x: M.apply3d(p, x), 0),
    "s4d.apply_s4d": ("s4d", "s4d", lambda: (real_input("s4d u", (8, 64, 3)),),
                      lambda M, p, u: M.apply_s4d(p, u), 0),
    "s4d.apply_s4d_unpooled": ("s4d", "s4d", lambda: (real_input("s4d u", (8, 64, 3)),),
                               lambda M, p, u: M.apply_s4d(p, u, pool=False), 0),
    "fnet.apply": ("fnet", "fnet", lambda: (real_input("fnet x", (8, 16, 8)),),
                   lambda M, p, x: M.apply(p, x), 0),
    "sfno.apply": ("sfno", "sfno", lambda: (real_input("sfno x", (8, 2, 8, 16)),),
                   lambda M, p, x: M.apply(p, x), 0),
    "audio_frontend.apply_frontend": (
        "audio_frontend", "audio_frontend", lambda: (0.1 * real_input("clips", (8, 2000)),),
        lambda M, p, x: M.apply_frontend(p["frontend"], x, SR, N_FFT), 0),
    "audio_frontend.apply": ("audio_frontend", "audio_frontend",
                             lambda: (0.1 * real_input("clips", (8, 2000)),),
                             lambda M, p, x: M.apply(p, x, SR, N_FFT), 0),
    "koopman.koopman_encode": ("koopman", "koopman", lambda: (real_input("trajs", (8, 12, 4)),),
                               lambda M, p, x: M.koopman_encode(p, x), 0),
    "koopman.koopman_decode": ("koopman", "koopman", lambda: (real_input("latents", (8, 12, 8)),),
                               lambda M, p, z: M.koopman_decode(p, z), 0),
    "koopman.koopman_rollout": ("koopman", "koopman", lambda: (real_input("x0", (8, 4)),),
                                lambda M, p, x: M.koopman_rollout(p, x, 3), 1),
}

# name: (module, params, inputs (each sharded), step(M, p, *inputs) -> (new, loss))
STEPS = {
    "fno.train_step": ("fno", "fno",
                       lambda: (real_input("fno x", (8, 2, 64)), real_input("fno t", (8, 1, 64))),
                       lambda M, p, x, t: M.train_step(p, x, t, lr=LR)),
    "fno.train_step2d": ("fno", "fno2d", lambda: (real_input("fno2 x", (8, 1, 16, 16)),
                                                  real_input("fno2 t", (8, 1, 16, 16))),
                         lambda M, p, x, t: M.train_step2d(p, x, t, lr=LR)),
    "fno.train_step3d": ("fno", "fno3d", lambda: (real_input("fno3 x", (8, 1, 8, 8, 8)),
                                                  real_input("fno3 t", (8, 1, 8, 8, 8))),
                         lambda M, p, x, t: M.train_step3d(p, x, t, lr=LR)),
    "s4d.train_step": ("s4d", "s4d",
                       lambda: (real_input("s4d u", (8, 64, 3)), real_input("s4d t", (8, 2))),
                       lambda M, p, u, t: M.train_step(p, u, t, lr=LR)),
    "s4d.train_step_unpooled": ("s4d", "s4d", lambda: (real_input("s4d u", (8, 64, 3)),
                                                       real_input("s4d tl", (8, 64, 2))),
                                lambda M, p, u, t: M.train_step(p, u, t, lr=LR)),
    "fnet.train_step": ("fnet", "fnet",
                        lambda: (real_input("fnet x", (8, 16, 8)), real_input("fnet t", (8, 16, 8))),
                        lambda M, p, x, t: M.train_step(p, x, t, lr=LR)),
    "sfno.train_step": ("sfno", "sfno", lambda: (real_input("sfno x", (8, 2, 8, 16)),
                                                 real_input("sfno t", (8, 2, 8, 16))),
                        lambda M, p, x, t: M.train_step(p, x, t, lr=LR)),
    "audio_frontend.train_step": ("audio_frontend", "audio_frontend",
                                  lambda: (0.1 * real_input("clips", (8, 2000)), _labels()),
                                  lambda M, p, x, y: M.train_step(p, x, y, LR, SR, N_FFT)),
}

# a step on the mesh (2, 2) whose input and target are sharded over ``seq``
# along the grid axis, which the FNO transforms: (mesh, spec, step case)
ACROSS = {"fno.train_step_seq_axis": ((2, 2), ("data", None, "seq"), "fno.train_step")}


def flat(tree) -> list:
    """Leaves in a fixed order (sorted dict keys, list order), as
    ``jax.tree_util.tree_leaves`` orders a JAX tree."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in flat(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in flat(v)]
    return [tree]


def koopman_grad(M, p, trajs):
    """``koopman_loss`` and its gradient for every parameter, in
    :func:`flat`'s order (the port's; the JAX test takes ``jax.grad``)."""
    import torch

    from mixed_radix_fast_fourier_transform_tpu_torch.utils.tree import tree_map

    leaves = tree_map(lambda v: v.detach().requires_grad_(True), p)
    loss = M.koopman_loss(leaves, trajs, horizon=4)
    return torch.autograd.grad(loss, flat(leaves)), loss.detach()


def _same_on_every_rank(tensors) -> bool:
    import torch
    import torch.distributed as dist

    same = True
    for v in tensors:
        got = [torch.empty_like(v) for _ in range(dist.get_world_size())]
        dist.all_gather(got, v.detach().contiguous())
        same = same and all(torch.equal(g, got[0]) for g in got)
    return same


def models_world() -> dict:
    """Every case of this file (runs on each rank)."""
    import torch
    from torch.distributed.tensor import DTensor

    from mixed_radix_fast_fourier_transform_tpu_torch import parallel as par
    from mixed_radix_fast_fourier_transform_tpu_torch.models import params_from_jax
    from mixed_radix_fast_fourier_transform_tpu_torch.parallel.distributed import _local, _wrap

    out = {}
    meshes = {s: par.make_mesh(s, device="cpu") for s in ((4, 1), (2, 2))}
    mesh = meshes[MESH]

    def module(name):
        return importlib.import_module(f"mixed_radix_fast_fourier_transform_tpu_torch.models.{name}")

    def params(name):
        return params_from_jax(PARAMS[name](), "cpu")

    def shard(a, m=mesh):
        return par.shard_batch(torch.from_numpy(a), m)

    for name, (mod, pname, inputs, call, _) in FORWARDS.items():
        with torch.no_grad():
            y = call(module(mod), params(pname), *(shard(a) for a in inputs()))
        out[name] = gathered(y)
        out[f"{name}/dims"] = np.array([p.dim for p in y.placements if p.is_shard()]
                                       if isinstance(y, DTensor) else [-1])

    def record_step(tag, new, loss, whole):
        leaves = flat(new)
        out[f"{tag}/loss"] = loss.numpy()
        out[f"{tag}/plain"] = np.array(all(type(v) is torch.Tensor for v in leaves + [loss]))
        out[f"{tag}/same"] = np.array(_same_on_every_rank(leaves + [loss]))
        for i, leaf in enumerate(leaves):
            out[f"{tag}/new_{i}"] = leaf.numpy()
        wnew, wloss = whole
        out[f"{tag}/whole_loss"] = wloss.detach().numpy()
        for i, leaf in enumerate(flat(wnew)):
            out[f"{tag}/whole_{i}"] = leaf.detach().numpy()

    for name, (mod, pname, inputs, step) in STEPS.items():
        arrays, M = inputs(), module(mod)
        new, loss = step(M, params(pname), *(shard(a) for a in arrays))
        record_step(name, new, loss,
                    step(M, params(pname), *(torch.from_numpy(a) for a in arrays)))
    for name, (shape, spec, case) in ACROSS.items():
        mod, pname, inputs, step = STEPS[case]
        m, arrays, M = meshes[shape], inputs(), module(mod)
        placed = [_wrap(_local(torch.from_numpy(a), m, spec), m, spec, a.shape) for a in arrays]
        new, loss = step(M, params(pname), *placed)
        record_step(name, new, loss,
                    step(M, params(pname), *(torch.from_numpy(a) for a in arrays)))

    trajs = real_input("trajs", (8, 12, 4))
    M = module("koopman")
    grads, loss = koopman_grad(M, params("koopman"), shard(trajs))
    record_step("koopman.koopman_loss", grads, loss,
                koopman_grad(M, params("koopman"), torch.from_numpy(trajs)))
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(__name__, "models_world", tmp_path_factory.mktemp("batch_models"))


def _jax(module: str):
    return importlib.import_module(f"mixed_radix_fast_fourier_transform_tpu.models.{module}")


def _jax_params(pname: str):
    import jax
    import jax.numpy as jnp

    return jax.tree_util.tree_map(jnp.asarray, PARAMS[pname]())


def _jax_sharded(arrays, mesh_shape=MESH, spec=None):
    """The arrays on the JAX package's 4-device mesh: ``shard_batch``, or
    laid out by ``spec`` along their leading axes."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec

    from mixed_radix_fast_fourier_transform_tpu.parallel import shard_batch

    mesh = jax_mesh(mesh_shape)
    if spec is None:
        return [shard_batch(jnp.asarray(a), mesh) for a in arrays]
    return [jax.device_put(jnp.asarray(a), NamedSharding(mesh, PartitionSpec(*spec)))
            for a in arrays]


@pytest.mark.parametrize("name", sorted(FORWARDS))
def test_forward_on_a_batch_sharded_dtensor_matches_jax(world, name):
    """Within 1e-5 of ``jax.jit`` of the JAX forward on its sharded mesh;
    the port's output is sharded along the batch only (the rollout's one
    axis later), as the JAX output is not fully replicated."""
    import jax

    mod, pname, inputs, call, batch_axis = FORWARDS[name]
    M = _jax(mod)
    want = jax.jit(lambda p, *a: call(M, p, *a))(_jax_params(pname), *_jax_sharded(inputs()))
    assert rel(world[name], want) <= TOL
    assert world[f"{name}/dims"].tolist() == [batch_axis]
    assert not want.sharding.is_fully_replicated


def _held_step(world, tag, want_new, want_loss):
    """The step's loss and each new leaf within 1e-5 of ``want``, plain
    tensors equal on every rank, and equal to the port's step on the whole
    batch in one process."""
    assert bool(world[f"{tag}/plain"]) and bool(world[f"{tag}/same"])
    assert rel(world[f"{tag}/loss"], want_loss) <= TOL
    assert rel(world[f"{tag}/loss"], world[f"{tag}/whole_loss"]) <= TOL
    leaves = flat(want_new)
    assert f"{tag}/new_{len(leaves)}" not in world
    for i, leaf in enumerate(leaves):
        assert rel(world[f"{tag}/new_{i}"], leaf) <= TOL, i
        assert rel(world[f"{tag}/new_{i}"], world[f"{tag}/whole_{i}"]) <= TOL, i


@pytest.mark.parametrize("name", sorted(STEPS))
def test_train_step_on_sharded_batches_matches_jax(world, name):
    """``jax.jit(train_step)`` on the JAX package's sharded batches: the
    global loss and every new parameter (:func:`_held_step`)."""
    import jax

    mod, pname, inputs, step = STEPS[name]
    M = _jax(mod)
    new, loss = jax.jit(lambda p, *a: step(M, p, *a))(_jax_params(pname),
                                                      *_jax_sharded(inputs()))
    _held_step(world, name, new, loss)


@pytest.mark.parametrize("name", sorted(ACROSS))
def test_step_sharded_along_a_transformed_axis_gathers_it(world, name):
    """On the mesh (2, 2) with the grid axis sharded over ``seq``: the
    transformed axis is gathered, each block is held by two ranks and
    weighted so, and the step equals the JAX step on the same layout."""
    import jax

    shape, spec, case = ACROSS[name]
    mod, pname, inputs, step = STEPS[case]
    M = _jax(mod)
    new, loss = jax.jit(lambda p, *a: step(M, p, *a))(_jax_params(pname),
                                                      *_jax_sharded(inputs(), shape, spec))
    _held_step(world, name, new, loss)


def test_koopman_loss_gradient_on_sharded_trajectories_matches_jax(world):
    """Every mean of ``koopman_loss`` on (batch, T, state) trajectories
    sharded over the batch is the global one: the loss and each
    parameter's gradient within 1e-5 of ``jax.jit(jax.value_and_grad)`` on
    the sharded mesh, equal on every rank and to the one-process call."""
    import jax

    M = _jax("koopman")
    loss, grads = jax.jit(jax.value_and_grad(lambda p, t: M.koopman_loss(p, t, horizon=4)))(
        _jax_params("koopman"), *_jax_sharded([real_input("trajs", (8, 12, 4))]))
    _held_step(world, "koopman.koopman_loss", grads, loss)
