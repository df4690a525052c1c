"""PyTorch port under ``torch.compile``: the distributed spectral filter
(``apply_distributed``, ``loss_distributed``) and the sequence-parallel
FNet (``fourier_mix_distributed``, ``apply_distributed``), each given its
input plain and as a DTensor, and their ``train_step_distributed`` through
``utils.tree.compile_sgd_step`` (the parameters' gradients summed by an
all-reduce inside the compiled loss's backward); and the batch-sharded
tracker ``kalman_filter_sharded`` (its RTS smoother, the per-track loop
unrolled at the fixed local batch).  The checks and the gloo world of 2
are those of ``test_torch_compile_parallel.py``.  The eager forms are held
to ``jax.jit`` of the JAX functions by ``test_torch_parallel_models.py``
and ``test_torch_parallel_ops.py``."""

import numpy as np
import pytest

from test_torch_compile_parallel import (
    WORLD, _as_dtensor, held, held_step, meshes, one_graph, one_step, tensors, transforms_world,
)
from test_torch_parallel import real_input, run_world

N = 64
LR = 0.5
FNET = dict(seq=16, hidden=8, ff=16, layers=1)


def filter_params() -> dict:
    r = np.random.default_rng(11)
    return {"gain_re": (1.0 + 0.01 * r.standard_normal(N)).astype(np.float32),
            "gain_im": (0.01 * r.standard_normal(N)).astype(np.float32),
            "bias": np.float32(0.1)}


def fnet_params() -> dict:
    r = np.random.default_rng(12)
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


def _signals(s):
    return real_input(f"fx{s}", (4, N)), real_input(f"ft{s}", (4, N))


def _tokens(s):
    shape = (4, FNET["seq"], FNET["hidden"])
    return real_input(f"nx{s}", shape), real_input(f"nt{s}", shape)


# name: (mesh, inputs(seed), call(models, mesh, params, *args), params); the
# inputs' first array is given plain and as a DTensor
MODELS = {
    "filter_apply": ((2, 1), lambda s: _signals(s)[:1],
                     lambda M, m, p, x: M.spectral_filter.apply_distributed(p, x, m),
                     filter_params),
    "filter_loss": ((1, 2), _signals,
                    lambda M, m, p, x, t: M.spectral_filter.loss_distributed(p, x, t, m),
                    filter_params),
    "fnet_mix": ((1, 2), lambda s: _tokens(s)[:1],
                 lambda M, m, p, x: M.fnet.fourier_mix_distributed(x, m), fnet_params),
    "fnet_apply": ((2, 1), lambda s: _tokens(s)[:1],
                   lambda M, m, p, x: M.fnet.apply_distributed(p, x, m), fnet_params),
}

KALMAN = (np.array([[1.0, 1.0], [0.0, 0.95]]), 0.01 * np.eye(2), np.array([[1.0, 0.0]]),
          0.1 * np.eye(1), np.zeros(2), np.eye(2))
TRACKER = {
    "kalman_filter_sharded": ((2, 1), lambda s: (real_input(f"ys{s}", (2, 4, 1)),),
                              lambda P, m, ys: P.kalman_filter_sharded(*KALMAN, ys, m,
                                                                       smooth=True)),
}

# name: (mesh, inputs(seed), model module, params, loss options)
STEPS = {
    "filter_step": ((1, 2), _signals, "spectral_filter", filter_params, {}),
    "fnet_step": ((1, 2), _tokens, "fnet", fnet_params, {"data_axis": None}),
}


def models_world() -> dict:
    import torch

    from mixed_radix_fast_fourier_transform_tpu_torch import models
    from mixed_radix_fast_fourier_transform_tpu_torch.models import params_from_jax
    from mixed_radix_fast_fourier_transform_tpu_torch.utils.tree import compile_sgd_step

    torch.set_num_threads(1)
    out, ms = transforms_world(TRACKER), meshes()
    for name, (shape, inputs, call, params) in MODELS.items():
        m, p = ms[shape], params_from_jax(params(), "cpu")
        fn = lambda p, *a: call(models, m, p, *a)  # noqa: E731
        first, second = tensors(inputs(0)), tensors(inputs(1))
        out.update(held(f"{name}/plain", fn, (p,) + first, (p,) + second))
        out.update(held(f"{name}/dtensor", fn,
                        (p, _as_dtensor(first[0], m, shape)) + first[1:],
                        (p, _as_dtensor(second[0], m, shape)) + second[1:]))
    for name, (shape, inputs, module, params, kw) in STEPS.items():
        m, mod, p = ms[shape], getattr(models, module), params_from_jax(params(), "cpu")
        calls = [(p,) + tensors(inputs(s)) + (m,) for s in (0, 1)]
        make = lambda: _bound(compile_sgd_step(mod.loss_distributed,  # noqa: E731
                                               backend="aot_eager"), kw)
        out.update(held_step(name, make, _bound(mod.train_step_distributed, kw), calls))
    return out


def _bound(step, kw):
    return lambda p, x, t, m: step(p, x, t, m, lr=LR, **kw)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(__name__, "models_world", tmp_path_factory.mktemp("compile_models"),
                     world=WORLD)


@pytest.mark.parametrize("form", ["plain", "dtensor"])
@pytest.mark.parametrize("name", sorted(MODELS) + sorted(TRACKER))
def test_distributed_model_compiles_whole(world, name, form):
    """One graph, no break, no recompile on new data, within 1e-6 of eager,
    for the input given as a plain tensor and as a DTensor."""
    one_graph(world, f"{name}/{form}")


@pytest.mark.parametrize("name", sorted(STEPS))
def test_distributed_step_compiles(world, name):
    """``compile_sgd_step`` of the distributed loss: the loss with its
    backward (whose all-reduce sums the parameters' gradients over the
    ranks) and the update, two graphs; the loss and new parameters within
    1e-6 of ``train_step_distributed``, plain tensors on every rank."""
    one_step(world, name)
