"""PyTorch port under ``torch.compile``: the batch-sharded calls, with the
checks and the gloo world of 2 of ``test_torch_compile_parallel.py`` on the
mesh (2, 1).

``fft_batch_sharded``, ``pfb_analysis_sharded`` and
``range_doppler_cfar_sharded`` each take the global array plain and as a
DTensor.  The two calls the JAX tests jit on batch-sharded arrays
(``tests/test_parallel.py::TestBatchShardedAudioOps``) compile whole: a
``melspectrogram`` of a ``shard_batch`` DTensor (one graph; the output stays
sharded) and the AFNO's ``compile_sgd_step`` on sharded batches (the loss
with its backward, whose all-reduce sums the parameters' gradients, and the
update); both are also held to ``jax.jit`` of the JAX calls on the JAX
package's sharded mesh at the eager tests' tolerance.  The API ops, the
spectral filter's step, ``cqt`` and ``multitaper`` compile on a
``shard_batch`` DTensor too.  ``kalman_filter_sharded``, the sharded NUFFTs
and the SHTs are in ``test_torch_compile_parallel_nufft_sht.py``."""

import numpy as np
import pytest

from test_torch_compile_parallel import (
    WORLD, flat, held, held_step, meshes, one_graph, one_step, tensors, transforms_world,
)
from test_torch_parallel import TOL, complex_input, real_input, rel, run_world

MESH = (2, 1)

CASES = {
    "fft_batch_sharded": (MESH, lambda s: (complex_input(f"fbs{s}", (4, 360)),),
                          lambda P, m, x: P.fft_batch_sharded(x, m)),
    "ifft_batch_sharded": (MESH, lambda s: (complex_input(f"ifbs{s}", (4, 256)),),
                           lambda P, m, x: P.fft_batch_sharded(x, m, inverse=True,
                                                               norm="ortho")),
    "pfb_analysis_sharded": (MESH, lambda s: (complex_input(f"pfb{s}", (4, 512)),),
                             lambda P, m, x: P.pfb_analysis_sharded(x, 16, m,
                                                                    taps_per_branch=4)),
    "range_doppler_cfar_sharded": (MESH, lambda s: (complex_input(f"rx{s}", (2, 32, 128)),
                                                    complex_input("tx", (13,))),
                                   lambda P, m, x, tx: P.range_doppler_cfar_sharded(x, tx, m)),
}

# the public ops on a shard_batch DTensor: name: (inputs(seed), call(tp, x, *rest))
OPS = {
    "fft": (lambda s: (complex_input(f"op fft{s}", (4, 360)),), lambda T, x: T.fft(x)),
    "rfft": (lambda s: (real_input(f"op rfft{s}", (4, 1000)),), lambda T, x: T.rfft(x)),
    "fft2": (lambda s: (complex_input(f"op fft2{s}", (4, 16, 24)),), lambda T, x: T.fft2(x)),
    "irfftn": (lambda s: (complex_input(f"op irfftn{s}", (4, 16, 13)),),
               lambda T, x: T.irfftn(x, s=(16, 24), axes=(1, 2))),
    "fft_convolve": (lambda s: (real_input(f"op conv{s}", (4, 1000)),
                                real_input("op taps", (1, 33))),
                     lambda T, x, k: T.fft_convolve(x, k, mode="same")),
    "cqt": (lambda s: (real_input(f"op cqt{s}", (4, 8192)),),
            lambda T, x: T.cqt(x, fs=22050.0, fmin=110.0, n_bins=24)),
    "multitaper": (lambda s: (real_input(f"op mt{s}", (4, 1024)),),
                   lambda T, x: T.multitaper(x, 1.0, 4.0)),
}


def mel_input(s):
    return real_input(f"mel{s}", (4, 8192))


def afno_data(s):
    return real_input(f"afno x{s}", (4, 8, 8, 2)), real_input(f"afno t{s}", (4, 8, 8, 1))


def filter_data(s):
    return real_input(f"filter x{s}", (4, 64)), real_input(f"filter t{s}", (4, 64))


def afno_params():
    """The JAX test's AFNO (2 → 16 → 1 channels, patch 4, 4 blocks, one
    layer), drawn by the port's initialiser from a seed, for both packages."""
    import torch

    from mixed_radix_fast_fourier_transform_tpu_torch.models import afno
    from mixed_radix_fast_fourier_transform_tpu_torch.utils.tree import tree_map

    p = afno.init_afno(2, 16, 1, patch=4, n_layers=1, n_blocks=4,
                       generator=torch.Generator().manual_seed(0), device="cpu")
    return tree_map(lambda v: v.numpy(), p)


def ops_world() -> dict:
    import torch
    import mixed_radix_fast_fourier_transform_tpu_torch as tp
    from mixed_radix_fast_fourier_transform_tpu_torch import parallel as par
    from mixed_radix_fast_fourier_transform_tpu_torch.models import afno, params_from_jax
    from mixed_radix_fast_fourier_transform_tpu_torch.models import spectral_filter as sf
    from mixed_radix_fast_fourier_transform_tpu_torch.utils.tree import compile_sgd_step

    torch.set_num_threads(1)
    out = transforms_world(CASES)
    m = meshes()[MESH]

    def sharded(arrays):
        x, *rest = tensors(arrays)
        return (par.shard_batch(x, m),) + tuple(rest)

    for name, (inputs, call) in OPS.items():
        out.update(held(name, lambda *a: call(tp, *a), sharded(inputs(0)), sharded(inputs(1))))

    # melspectrogram as the JAX test jits it
    mel = lambda v: tp.melspectrogram(v, 22050.0, n_mels=32)  # noqa: E731
    out.update(held("melspectrogram", mel, sharded((mel_input(0),)), sharded((mel_input(1),)),
                    keep=True))

    # the data-parallel steps: the AFNO's of the JAX test, and the filter's
    ap = params_from_jax(afno_params(), "cpu")
    make = lambda: compile_sgd_step(afno.loss_fn, backend="aot_eager")  # noqa: E731
    calls = [(ap,) + sharded(afno_data(s)) for s in (0, 1)]
    out.update(held_step("afno_step",
                         lambda: _afno_bound(make()), _afno_bound(afno.train_step), calls))
    fp = {"gain_re": torch.ones(33), "gain_im": torch.zeros(33), "bias": torch.tensor(0.1)}
    out.update(held_step(
        "filter_step",
        lambda: _lr(compile_sgd_step(sf.loss_fn, backend="aot_eager"), 0.5),
        _lr(sf.train_step, 0.5), [(fp,) + sharded(filter_data(s)) for s in (0, 1)]))
    return out


def _afno_bound(step):
    return lambda p, x, t: step(p, x, t, lr=1e-3, patch=4, n_blocks=4)


def _lr(step, lr):
    return lambda p, x, t: step(p, x, t, lr=lr)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(__name__, "ops_world", tmp_path_factory.mktemp("compile_ops"), world=WORLD)


def _jax_mesh():
    import jax

    from mixed_radix_fast_fourier_transform_tpu.parallel import make_mesh

    return make_mesh(MESH, devices=jax.devices()[:WORLD])


@pytest.mark.parametrize("form", ["plain", "dtensor"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_batch_sharded_call_compiles_whole(world, case, form):
    """One graph, no break, no recompile on new data, compiled within 1e-6
    of eager, for the global array given as a plain tensor and as a
    DTensor."""
    one_graph(world, f"{case}/{form}")


@pytest.mark.parametrize("name", sorted(OPS) + ["melspectrogram"])
def test_op_on_a_batch_sharded_dtensor_compiles_whole(world, name):
    one_graph(world, name)


def test_compiled_melspectrogram_matches_jax_jit_on_the_sharded_mesh(world):
    """The JAX test's ``jax.jit(melspectrogram)`` of a ``shard_batch``
    array: the compiled port within 1e-5 of it, the output sharded."""
    import jax

    import mixed_radix_fast_fourier_transform_tpu as jsp
    from mixed_radix_fast_fourier_transform_tpu.parallel import shard_batch

    want = jax.jit(lambda v: jsp.melspectrogram(v, 22050.0, n_mels=32))(
        shard_batch(mel_input(0), _jax_mesh()))
    assert rel(world["melspectrogram/out_0"], want) <= TOL
    assert bool(world["melspectrogram/sharded_0"])
    assert not want.sharding.is_fully_replicated


@pytest.mark.parametrize("name", ["afno_step", "filter_step"])
def test_data_parallel_step_compiles(world, name):
    one_step(world, name)


def test_compiled_afno_step_matches_jax_jit_on_sharded_batches(world):
    """The JAX test's ``jax.jit(train_step)`` of the AFNO on sharded
    batches: the compiled port's loss within 1e-5 and every new parameter
    within 1e-5 in max abs."""
    import jax
    import jax.numpy as jnp

    from mixed_radix_fast_fourier_transform_tpu.models import afno as jafno
    from mixed_radix_fast_fourier_transform_tpu.parallel import shard_batch

    mesh = _jax_mesh()
    x, t = afno_data(0)
    params = jax.tree_util.tree_map(jnp.asarray, afno_params())
    new, loss = jax.jit(lambda p, a, b: jafno.train_step(p, a, b, patch=4, n_blocks=4))(
        params, shard_batch(x, mesh), shard_batch(t, mesh))
    assert abs(float(world["afno_step/loss"]) - float(loss)) < 1e-5
    for i, leaf in enumerate(flat(new)):
        assert np.max(np.abs(world[f"afno_step/new_{i}"] - np.asarray(leaf))) < 1e-5, i
