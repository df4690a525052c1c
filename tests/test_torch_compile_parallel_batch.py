"""PyTorch port under ``torch.compile``: every model family's loss and the
framed signal ops on ``shard_batch`` DTensors, with the checks and the gloo
world of 2 of ``test_torch_compile_parallel.py`` on the mesh (2, 1).

Each family's loss (the 1-D FNO, S4D, FNet, the SFNO, the PCEN
front end's cross-entropy with sharded labels, Koopman's loss) compiles
through ``utils.tree.compile_sgd_step``: the loss with its backward, whose
all-reduces sum the parameters' gradients, and the update, two graphs with
no break and no recompile on new data, the loss and new parameters within
1e-6 of the eager step on the same sharded batches, plain tensors on every
rank.  Each framed op that compiles whole on a plain tensor compiles whole
on a ``shard_batch`` DTensor: one graph, no recompile, 1e-6 of eager, the
output still sharded along the batch; this file holds ``stft``, ``welch``
and ``resample_poly`` (its designed filter's taps a host table),
``test_torch_compile_parallel_batch_framed.py`` the other sixteen.  The
eager forms are held to
``jax.jit`` of the JAX functions by ``test_torch_parallel_batch_models.py``
and ``test_torch_parallel_batch_framed.py``."""

import numpy as np
import pytest

from test_torch_compile_parallel import WORLD, held, held_step, one_graph, one_step
from test_torch_parallel import real_input, rng_for, run_world
from test_torch_parallel_batch_models import PARAMS

MESH = (2, 1)
LR = 0.1
SR, N_FFT = 16000.0, 256
FS = 1000.0


def _pair(tag, *shapes):
    """New data of the same shapes for each call: (seed 0's, seed 1's)."""
    return tuple(tuple(real_input(f"{tag} {i} {s}", shape) for i, shape in enumerate(shapes))
                 for s in (0, 1))


def _labels(s):
    return rng_for(f"labels {s}").integers(0, 3, 4).astype(np.int64)


def _clips():
    return tuple((0.1 * real_input(f"clips {s}", (4, 2000)), _labels(s)) for s in (0, 1))


# name: (module, params, (first call's arrays, second's), loss_fn(M), step(M, p, *a, lr))
STEPS = {
    "fno": ("fno", "fno", _pair("fno", (4, 2, 64), (4, 1, 64)),
            lambda M: M.loss_fn, lambda M: M.train_step),
    "s4d": ("s4d", "s4d", _pair("s4d", (4, 64, 3), (4, 2)),
            lambda M: M.loss_fn, lambda M: M.train_step),
    "fnet": ("fnet", "fnet", _pair("fnet", (4, 16, 8), (4, 16, 8)),
             lambda M: M.loss_fn, lambda M: M.train_step),
    "sfno": ("sfno", "sfno", _pair("sfno", (4, 2, 8, 16), (4, 2, 8, 16)),
             lambda M: M.loss_fn, lambda M: M.train_step),
    "audio_frontend": ("audio_frontend", "audio_frontend", _clips(),
                       lambda M: lambda p, x, y: M.loss_fn(p, x, y, SR, N_FFT),
                       lambda M: lambda p, x, y, lr: M.train_step(p, x, y, lr, SR, N_FFT)),
    "koopman": ("koopman", "koopman", _pair("koopman", (4, 12, 4)),
                lambda M: lambda p, t: M.koopman_loss(p, t, horizon=4),
                lambda M: lambda p, t, lr: _koopman_step(M, p, t, lr)),
}


def _koopman_step(M, p, trajs, lr):
    """Koopman has no ``train_step``: the SGD step on ``koopman_loss``."""
    from mixed_radix_fast_fourier_transform_tpu_torch.utils.tree import sgd_step

    return sgd_step(lambda q, t: M.koopman_loss(q, t, horizon=4), p, trajs, lr=lr)


def _x(s):
    return real_input(f"compiled framed {s}", (4, 512))


def _spec(s):
    x = np.pad(_x(s), ((0, 0), (128, 128)), mode="reflect")
    frames = np.lib.stride_tricks.sliding_window_view(x, 256, axis=-1)[:, ::128]
    return np.fft.rfft(frames * np.hanning(256), axis=-1).astype(np.complex64)


# the framed ops that compile whole on a plain tensor: name: (input(seed),
# call(tp, x)); the input is given as a shard_batch DTensor
OPS = {
    "stft": (_x, lambda T, x: T.stft(x, 256)),
    "istft": (_spec, lambda T, s: T.istft(s, 256)),
    "spectrogram": (_x, lambda T, x: T.spectrogram(x, 256)),
    "griffinlim": (lambda s: np.abs(_spec(s)), lambda T, m: T.griffinlim(m, 4, seed=3)),
    "phase_vocoder": (_spec, lambda T, s: T.phase_vocoder(s, 1.3)),
    "time_stretch": (_x, lambda T, x: T.time_stretch(x, 1.25, 256)),
    "pitch_shift": (_x, lambda T, x: T.pitch_shift(x, FS, 12, nperseg=256)),
    "spectral_diff": (_x, lambda T, x: T.spectral_diff(x)),
    "hilbert": (_x, lambda T, x: T.hilbert(x)),
    "hilbert2": (lambda s: real_input(f"compiled image {s}", (4, 16, 24)),
                 lambda T, x: T.hilbert2(x)),
    "periodogram": (_x, lambda T, x: T.periodogram(x, FS)),
    "welch": (_x, lambda T, x: T.welch(x, FS, nperseg=256)),
    "resample": (_x, lambda T, x: T.resample(x, 1500)),
    "resample_poly": (_x, lambda T, x: T.resample_poly(x, 2, 3)),
    "rceps": (_x, lambda T, x: T.rceps(x)),
    "cceps": (_x, lambda T, x: T.cceps(x)),
    "icceps": (lambda s: 0.01 * _x(s), lambda T, x: T.icceps(x, 2)),
    "minimum_phase": (lambda s: real_input(f"compiled fir {s}", (64,)),
                      lambda T, h: T.minimum_phase(h)),
    "envelope": (_x, lambda T, x: T.envelope(x, (1, 200))),
}
# outputs that hold no batch axis: the estimators' frequencies, a 1-D filter
NO_BATCH = {"periodogram": (0,), "welch": (0,), "minimum_phase": (0,)}
# the ops of this file (three that the card's phase 33 compiles); the others
# are in test_torch_compile_parallel_batch_framed.py, each file's world in its
# time budget
HERE = ("stft", "welch", "resample_poly")


def ops_world(names) -> dict:
    """:func:`held` of each op of ``names`` on shard_batch DTensors."""
    import torch

    import mixed_radix_fast_fourier_transform_tpu_torch as tp
    from mixed_radix_fast_fourier_transform_tpu_torch import parallel as par

    torch.set_num_threads(1)
    out, mesh = {}, par.make_mesh(MESH, device="cpu")
    for name in names:
        inputs, call = OPS[name]
        fn = lambda v, call=call: call(tp, v)  # noqa: E731
        out.update(held(name, fn, *((par.shard_batch(torch.from_numpy(inputs(s)), mesh),)
                                    for s in (0, 1)), keep=True))
    return out


def op_compiles_whole(world, name):
    """One graph, no break, no recompile on new data, within 1e-6 of eager;
    every output that keeps the batch is still sharded."""
    one_graph(world, name)
    i = 0
    while f"{name}/sharded_{i}" in world:
        assert bool(world[f"{name}/sharded_{i}"]) == (i not in NO_BATCH.get(name, ())), i
        i += 1
    assert i >= 1


def compile_batch_world() -> dict:
    """Every case of this file (runs on each rank)."""
    import importlib

    import torch

    from mixed_radix_fast_fourier_transform_tpu_torch import parallel as par
    from mixed_radix_fast_fourier_transform_tpu_torch.models import params_from_jax
    from mixed_radix_fast_fourier_transform_tpu_torch.utils.tree import compile_sgd_step

    torch.set_num_threads(1)
    out, mesh = {}, par.make_mesh(MESH, device="cpu")

    def shard(a):
        return par.shard_batch(torch.from_numpy(a), mesh)

    for name, (mod, pname, arrays, loss_fn, step) in STEPS.items():
        M = importlib.import_module(f"mixed_radix_fast_fourier_transform_tpu_torch.models.{mod}")
        p = params_from_jax(PARAMS[pname](), "cpu")
        calls = [(p,) + tuple(shard(a) for a in call) for call in arrays]
        out.update(held_step(name, lambda: _lr(compile_sgd_step(loss_fn(M), backend="aot_eager")),
                             _lr(step(M)), calls))
    out.update(ops_world(HERE))
    return out


def _lr(step):
    return lambda p, *a: step(p, *a, lr=LR)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(__name__, "compile_batch_world", tmp_path_factory.mktemp("compile_batch"),
                     world=WORLD)


@pytest.mark.parametrize("name", sorted(STEPS))
def test_family_step_on_sharded_batches_compiles(world, name):
    """``compile_sgd_step`` of the family's loss on ``shard_batch``
    DTensors: two graphs, no break, no recompile on new data, the loss and
    new parameters within 1e-6 of the eager step, plain tensors."""
    one_step(world, name)


@pytest.mark.parametrize("name", HERE)
def test_framed_op_on_a_shard_batch_dtensor_compiles_whole(world, name):
    """:func:`op_compiles_whole`."""
    op_compiles_whole(world, name)
