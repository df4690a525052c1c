"""PyTorch port: the public ops on a batch-sharded DTensor
(``utils/sharding.py``), in a gloo world of 4 CPU processes on the mesh
(4, 1), against ``jax.jit`` of the JAX functions on the JAX package's
sharded 4-device CPU mesh (``shard_batch``), as
``tests/test_parallel.py::TestBatchShardedAudioOps`` runs them.

Each op runs on every rank's local block and returns a DTensor sharded as
its input along the batch axes it keeps (never fully replicated where it
keeps one); a DTensor sharded along an axis the op transforms is gathered
on that axis first and gives the same values.  The spectral filter's and
the AFNO's ``train_step`` on sharded batches are data-parallel: the global
loss and, on every rank, the same plain new parameters.  The world and its
conventions are those of ``test_torch_parallel.py``."""

import numpy as np
import pytest

from test_torch_parallel import TOL, complex_input, gathered, jax_mesh, real_input, rel, run_world

MESH = (4, 1)
LR = 0.5


def _kernel():
    return real_input("conv taps", (1, 33))


# name: (inputs (the batch array first), call(M, x, *rest) with M either package)
CASES = {
    "fft": (lambda: (complex_input("fft", (8, 360)),), lambda M, x: M.fft(x)),
    "ifft": (lambda: (complex_input("ifft", (8, 360)),), lambda M, x: M.ifft(x)),
    "fft_n": (lambda: (complex_input("fft_n", (8, 300)),), lambda M, x: M.fft(x, 512)),
    "fft2": (lambda: (complex_input("fft2", (8, 16, 24)),), lambda M, x: M.fft2(x)),
    "ifft2": (lambda: (complex_input("ifft2", (8, 16, 24)),), lambda M, x: M.ifft2(x)),
    "fftn": (lambda: (complex_input("fftn", (8, 12, 20)),),
             lambda M, x: M.fftn(x, axes=(1, 2))),
    "ifftn": (lambda: (complex_input("ifftn", (8, 12, 20)),),
              lambda M, x: M.ifftn(x, axes=(1, 2))),
    "rfft": (lambda: (real_input("rfft", (8, 1000)),), lambda M, x: M.rfft(x)),
    "irfft": (lambda: (complex_input("irfft", (8, 129)),), lambda M, x: M.irfft(x, n=256)),
    "rfftn": (lambda: (real_input("rfftn", (8, 16, 24)),),
              lambda M, x: M.rfftn(x, axes=(1, 2))),
    "irfftn": (lambda: (complex_input("irfftn", (8, 16, 13)),),
               lambda M, x: M.irfftn(x, s=(16, 24), axes=(1, 2))),
    "fft_convolve": (lambda: (real_input("conv x", (8, 1000)), _kernel()),
                     lambda M, x, k: M.fft_convolve(x, k, mode="same")),
    "melspectrogram": (lambda: (real_input("mel", (8, 8192)),),
                       lambda M, x: M.melspectrogram(x, 22050.0, n_mels=32)),
    "cqt": (lambda: (real_input("cqt", (8, 8192)),),
            lambda M, x: M.cqt(x, fs=22050.0, fmin=110.0, n_bins=24)),
    "multitaper": (lambda: (real_input("multitaper", (8, 1024)),),
                   lambda M, x: M.multitaper(x, 1.0, 4.0)),
}

# a DTensor sharded along an axis the op transforms: (mesh, spec, case)
ACROSS = {
    "fft_signal_axis": ((4, 1), (None, "data"), "fft"),
    "fft_both_axes": ((2, 2), ("data", "seq"), "fft"),
    "melspectrogram_both_axes": ((2, 2), ("data", "seq"), "melspectrogram"),
}


def filter_params() -> dict:
    r = np.random.default_rng(7)
    return {"gain_re": (1.0 + 0.01 * r.standard_normal(129)).astype(np.float32),
            "gain_im": (0.01 * r.standard_normal(129)).astype(np.float32),
            "bias": np.float32(0.1)}


def filter_data():
    return real_input("filter x", (8, 256)), real_input("filter t", (8, 256))


def afno_params():
    """The AFNO of the JAX test (2 → 16 → 1 channels, patch 4, 4 blocks, one
    layer), drawn once by the port's initialiser from a seed and given to
    both packages."""
    import torch

    from mixed_radix_fast_fourier_transform_tpu_torch.models import afno

    p = afno.init_afno(2, 16, 1, patch=4, n_layers=1, n_blocks=4,
                       generator=torch.Generator().manual_seed(0), device="cpu")
    from mixed_radix_fast_fourier_transform_tpu_torch.utils.tree import tree_map

    return tree_map(lambda v: v.numpy(), p)


def afno_data():
    return real_input("afno x", (8, 8, 8, 2)), real_input("afno t", (8, 8, 8, 1))


def flat(tree) -> list:
    """Leaves in a fixed order (sorted dict keys, list order)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in flat(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in flat(v)]
    return [tree]


def _outputs(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


def batch_world() -> dict:
    """Every case of this file (runs on each rank)."""
    import torch
    from torch.distributed.tensor import DTensor

    import mixed_radix_fast_fourier_transform_tpu_torch as tp
    from mixed_radix_fast_fourier_transform_tpu_torch import parallel as par
    from mixed_radix_fast_fourier_transform_tpu_torch.models import afno, params_from_jax
    from mixed_radix_fast_fourier_transform_tpu_torch.models import spectral_filter as sf
    from mixed_radix_fast_fourier_transform_tpu_torch.parallel.distributed import _local, _wrap

    out = {}
    meshes = {s: par.make_mesh(s, device="cpu") for s in ((4, 1), (2, 2))}
    mesh = meshes[MESH]

    def record(tag, result):
        for i, o in enumerate(_outputs(result)):
            out[f"{tag}/{i}"] = gathered(o)
            out[f"{tag}/{i}/sharded"] = np.array(
                isinstance(o, DTensor) and any(p.is_shard() for p in o.placements))

    for name, (inputs, call) in CASES.items():
        x, *rest = inputs()
        record(name, call(tp, par.shard_batch(torch.from_numpy(x), mesh),
                          *(torch.from_numpy(r) for r in rest)))
    for name, (shape, spec, case) in ACROSS.items():
        m = meshes[shape]
        x = torch.from_numpy(CASES[case][0]()[0])
        record(name, CASES[case][1](tp, _wrap(_local(x, m, spec), m, spec, x.shape)))

    fp = params_from_jax(filter_params(), "cpu")
    x, t = (par.shard_batch(torch.from_numpy(a), mesh) for a in filter_data())
    new, loss = sf.train_step(fp, x, t, lr=LR)
    out["filter/loss"] = loss.numpy()
    out["filter/plain"] = np.array(all(type(p) is torch.Tensor for p in flat(new)))
    for i, leaf in enumerate(flat(new)):
        out[f"filter/new_{i}"] = leaf.numpy()

    ap = params_from_jax(afno_params(), "cpu")
    x, t = (par.shard_batch(torch.from_numpy(a), mesh) for a in afno_data())
    new, loss = afno.train_step(ap, x, t, patch=4, n_blocks=4)
    out["afno/loss"] = loss.numpy()
    out["afno/plain"] = np.array(all(type(p) is torch.Tensor for p in flat(new)))
    for i, leaf in enumerate(flat(new)):
        out[f"afno/new_{i}"] = leaf.numpy()
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(__name__, "batch_world", tmp_path_factory.mktemp("batch"))


def _jax_sharded(call, x, *rest):
    """``jax.jit`` of the JAX call on ``x`` sharded over the batch axis of the
    4-device mesh, as the JAX test runs it."""
    import jax
    import jax.numpy as jnp

    from mixed_radix_fast_fourier_transform_tpu.parallel import shard_batch

    import mixed_radix_fast_fourier_transform_tpu as jsp

    xd = shard_batch(jnp.asarray(x), jax_mesh(MESH))
    return jax.jit(lambda *a: call(jsp, *a))(xd, *(jnp.asarray(r) for r in rest))


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_on_a_batch_sharded_dtensor_matches_jax(world, case):
    """Values within 1e-5 of the JAX function on its sharded mesh; every
    output that keeps the batch axis stays sharded, as the JAX result is not
    fully replicated (``multitaper``'s frequencies hold no batch axis)."""
    inputs, call = CASES[case]
    want = _outputs(_jax_sharded(call, *inputs()))
    for i, w in enumerate(want):
        assert rel(world[f"{case}/{i}"], w) <= TOL, i
        keeps_batch = not (case == "multitaper" and i == 0)
        assert bool(world[f"{case}/{i}/sharded"]) == keeps_batch, i
        assert w.sharding.is_fully_replicated != keeps_batch


@pytest.mark.parametrize("name", sorted(ACROSS))
def test_sharding_along_a_transformed_axis_gathers_it(world, name):
    """A DTensor sharded along the axis the op transforms gives the
    single-device values (the partitioner's gather); on the (2, 2) mesh the
    batch axis stays sharded over ``data``."""
    import jax

    import mixed_radix_fast_fourier_transform_tpu as jsp

    shape, spec, case = ACROSS[name]
    inputs, call = CASES[case]
    want = jax.jit(lambda x: call(jsp, x))(inputs()[0])
    assert rel(world[f"{name}/0"], want) <= TOL
    assert bool(world[f"{name}/0/sharded"]) == (spec[0] is not None)


def test_filter_train_step_on_sharded_batches_matches_jax(world):
    """The spectral filter's ``train_step`` on sharded batches: the global
    loss and new parameters within 1e-5 of ``jax.jit(train_step)`` on the
    JAX package's sharded batches, plain tensors on every rank."""
    import jax
    import jax.numpy as jnp

    from mixed_radix_fast_fourier_transform_tpu.models import spectral_filter as jsf
    from mixed_radix_fast_fourier_transform_tpu.parallel import shard_batch

    mesh = jax_mesh(MESH)
    x, t = filter_data()
    params = {k: jnp.asarray(v) for k, v in filter_params().items()}
    new, loss = jax.jit(lambda p, a, b: jsf.train_step(p, a, b, lr=LR))(
        params, shard_batch(x, mesh), shard_batch(t, mesh))
    assert bool(world["filter/plain"])
    assert rel(world["filter/loss"], loss) <= TOL
    for i, leaf in enumerate(flat(new)):
        assert rel(world[f"filter/new_{i}"], leaf) <= TOL, i


def test_afno_train_step_on_sharded_batches_matches_jax(world):
    """The JAX test's AFNO data-parallel step (``test_afno_dp_train_step``):
    the loss within 1e-5 of ``jax.jit(train_step)`` on sharded batches, and
    every new parameter within 1e-5 in max abs (the step's lr, 1e-3, keeps
    the ReLU and shrinkage masks' flips far below it), plain tensors on
    every rank."""
    import jax
    import jax.numpy as jnp

    from mixed_radix_fast_fourier_transform_tpu.models import afno as jafno
    from mixed_radix_fast_fourier_transform_tpu.parallel import shard_batch

    mesh = jax_mesh(MESH)
    x, t = afno_data()
    params = jax.tree_util.tree_map(jnp.asarray, afno_params())
    new, loss = jax.jit(lambda p, a, b: jafno.train_step(p, a, b, patch=4, n_blocks=4))(
        params, shard_batch(x, mesh), shard_batch(t, mesh))
    assert bool(world["afno/plain"])
    assert abs(float(world["afno/loss"]) - float(loss)) < 1e-5
    for i, leaf in enumerate(flat(new)):
        assert np.max(np.abs(world[f"afno/new_{i}"] - np.asarray(leaf))) < 1e-5, i
