"""PyTorch port under ``torch.compile``: ``scattering1d`` and
``scattering2d`` (their centre frequencies, second-order pairs and banks
host work, the pairs' indices and the banks host tables) at the JAX
tests' calls, with the checks of ``test_torch_compile_ops.py`` (one graph,
``jax.jit`` of the JAX op and the eager port matched, no recompile, cold
and warm table caches, no traced tensor kept), ``meta`` handed back as
eager hands it back, and the JAX tests' refusals under compile."""

import numpy as np
import pytest
import torch

import mixed_radix_fast_fourier_transform_tpu as jsp

import mixed_radix_fast_fourier_transform_tpu_torch as tp

from test_torch_compile_ops import (  # noqa: F401  (fixtures)
    ROUTES, TOL, case_rng, compiled, fresh_dynamo, hold, within,
)

torch.set_num_threads(1)


@pytest.mark.parametrize("route", ROUTES)
def test_scattering1d_compiles_whole(route, case_rng):
    """At the JAX test's call (``tests/test_scattering.py``: (2, 1024),
    J = 4, Q = 2, ``jax.jit`` of the three orders): one graph, the JAX
    function's orders and eager's, no recompile; compiled on K1's route,
    ``meta`` is eager's (the centre frequencies as float64 host arrays, the
    pairs a list)."""
    config = ROUTES[route]
    port = lambda v: tp.scattering1d(v, J=4, Q=2, config=config)[:3]  # noqa: E731
    args, args2 = ([case_rng.standard_normal((2, 1024)).astype(np.float32)] for _ in range(2))
    hold(port, lambda v: jsp.scattering1d(v, J=4, Q=2)[:3], args, args2, within(TOL),
         tables=("scattering1d", "scattering.pairs"), warm=route == "kernel")
    if route != "kernel":
        return
    x = torch.from_numpy(args[0])
    _, _, _, (xi1, xi2, pairs) = compiled(lambda v: tp.scattering1d(v, J=4, Q=2, config=config))(x)
    want = tp.scattering1d(x, J=4, Q=2)[3]
    assert isinstance(xi1, np.ndarray) and xi1.dtype == np.float64
    assert np.array_equal(xi1, want[0]) and np.array_equal(xi2, want[1])
    assert pairs == want[2] and all(xi2[j2] < xi1[j1] for j1, j2 in pairs)


@pytest.mark.parametrize("args,kw,match", [
    ((np.zeros(16, np.float32),), {"J": 6}, "signal length 16"),
    ((np.zeros(1024, np.complex64),), {}, "real signals"),
    ((np.zeros(1000, np.float32),), {"J": 4, "stride": 16}, "must divide"),
], ids=["short", "complex", "stride"])
def test_scattering1d_refusals_compiled(args, kw, match):
    """The JAX test's refusals raise their ValueErrors under compile as
    eagerly."""
    x = torch.from_numpy(args[0])
    with pytest.raises(ValueError, match=match):
        tp.scattering1d(x, **kw)
    with pytest.raises(Exception, match=match):
        compiled(lambda v: tp.scattering1d(v, **kw))(x)


@pytest.mark.parametrize("route", ROUTES)
def test_scattering2d_compiles_whole(route, case_rng):
    """At the JAX test's call (``tests/test_scattering.py``: 64 x 64, J =
    3, L = 4), against ``jax.jit`` of the JAX function's three orders:
    one graph, eager's orders, no recompile; compiled on K1's route,
    ``meta`` is eager's (each channel's (j, l) and the pairs)."""
    config = ROUTES[route]
    port = lambda v: tp.scattering2d(v, J=3, L=4, config=config)[:3]  # noqa: E731
    args, args2 = ([case_rng.standard_normal((64, 64)).astype(np.float32)] for _ in range(2))
    hold(port, lambda v: jsp.scattering2d(v, J=3, L=4)[:3], args, args2, within(TOL),
         tables=("scattering2d", "scattering.pairs"), warm=route == "kernel")
    if route != "kernel":
        return
    x = torch.from_numpy(args[0])
    meta = compiled(lambda v: tp.scattering2d(v, J=3, L=4, config=config))(x)[3]
    assert meta == tp.scattering2d(x, J=3, L=4)[3] and len(meta[1]) == 48


KERNEL = ROUTES["kernel"]
EXPLAINED = {
    "scattering1d": (lambda v: tp.scattering1d(v, J=4, Q=2, config=KERNEL)[:3], (2, 1024)),
    "scattering2d": (lambda v: tp.scattering2d(v, J=3, L=4, config=KERNEL)[:3], (64, 64)),
}


@pytest.mark.parametrize("name", EXPLAINED)
def test_explain_reads_one_graph(name, case_rng):
    """``torch._dynamo.explain`` at the JAX test's call: one graph, no
    break, on K1's route (its transform one operator node; the stage
    pipeline's route is held to one graph by ``hold``'s counters)."""
    fn, shape = EXPLAINED[name]
    out = torch._dynamo.explain(fn)(torch.from_numpy(
        case_rng.standard_normal(shape).astype(np.float32)))
    assert (out.graph_count, out.graph_break_count) == (1, 0), out.break_reasons
