"""PyTorch port under ``torch.compile``: the type-3 NUFFTs, whose span
inference mirrors the JAX module's under ``jax.jit``.  While a tracer runs
the points are not concrete: ``method="fast"`` with static extents compiles
whole, without them it raises the JAX function's ValueError, and
``method="auto"`` without extents falls back to the dense products.  Each at
its JAX test's call (``tests/test_nufft.py``), with the checks of
``test_torch_compile_ops.py`` (one graph, ``jax.jit`` of the JAX op and the
eager port matched, no recompile, cold and warm table caches, no traced
tensor kept); the dense products compile at "high" since they go through
``utils.numerics.product``; ``torch._dynamo.explain`` reads one graph."""

import jax
import numpy as np
import pytest
import torch

import mixed_radix_fast_fourier_transform_tpu as jsp

import mixed_radix_fast_fourier_transform_tpu_torch as tp

from test_torch_compile_ops import (  # noqa: F401  (fixtures)
    EAGER_TOL, ROUTES, TOL, _rel, case_rng, compiled, fresh_dynamo, hold, within,
)

torch.set_num_threads(1)

# the JAX tests' bound of the fast paths against the float64 direct sum
FAST_TOL = {1: 5e-4, 2: 1e-4, 3: 1e-4}
EXTENTS = {1: dict(x_extent=5.0, s_extent=8.0),
           2: dict(x_extent=1.5, y_extent=2.0, s_extent=20.0, t_extent=15.0),
           3: dict(extents=(1.5, 2.0, 1.0, 12.0, 10.0, 15.0))}
TYPE3 = {1: tp.nufft3, 2: tp.nufft3_2d, 3: tp.nufft3_3d}
JAX_TYPE3 = {1: jsp.nufft3, 2: jsp.nufft3_2d, 3: jsp.nufft3_3d}


def _case(dim, rng):
    """(points and strengths, frequencies) as the JAX test draws them, at
    its sizes: 1-D 80 points and 60 frequencies on [-5, 5] x [-8, 8]
    (``:411``), 2-D 120 and 90 (``:729``), 3-D 120 and 80 (``:788``)."""
    def c(m):
        return (rng.standard_normal(m) + 1j * rng.standard_normal(m)).astype(np.complex64)

    if dim == 1:
        return [rng.uniform(-5.0, 5.0, 80).astype(np.float32), c(80),
                rng.uniform(-8.0, 8.0, 60).astype(np.float32)]
    if dim == 2:
        x = rng.uniform(-1.5, 1.5, 120).astype(np.float32)
        y = rng.uniform(-2.0, 2.0, 120).astype(np.float32)
        return [x, y, c(120), rng.uniform(-20, 20, 90).astype(np.float32),
                rng.uniform(-15, 15, 90).astype(np.float32)]
    x, y, z = (rng.uniform(-a, a, 120).astype(np.float32) for a in (1.5, 2.0, 1.0))
    return [x, y, z, c(120)] + [rng.uniform(-b, b, 80).astype(np.float32) for b in (12, 10, 15)]


def _direct(dim, args):
    """The float64 direct sum e^{-i(s·x + …)} · c."""
    pts, c = args[:dim], args[dim]
    phase = sum(np.outer(f.astype(np.float64), p.astype(np.float64))
                for p, f in zip(pts, args[dim + 1:]))
    return np.exp(-1j * phase) @ c.astype(np.complex128)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("dim", [1, 2, 3])
def test_fast_with_static_extents_compiles_whole(dim, route, case_rng):
    """``nufft3``/``nufft3_2d``/``nufft3_3d(method="fast")`` with the JAX
    test's static extents: the inner type-1 NUFFT's grid reaches K1 (its
    plain version here) on the kernel route; against ``jax.jit`` of the JAX
    function at the eager tests' tolerance, and the float64 direct sum at
    the JAX test's bound."""
    config, ext = ROUTES[route], EXTENTS[dim]
    args, args2 = _case(dim, case_rng), _case(dim, case_rng)
    fn, jfn = TYPE3[dim], JAX_TYPE3[dim]
    port = lambda *a: fn(*a, method="fast", config=config, **ext)  # noqa: E731
    hold(port, lambda *a: jfn(*a, method="fast", **ext), args, args2, within(TOL),
         warm=route == "kernel" and dim == 1)
    got = compiled(port)(*(torch.from_numpy(a) for a in args))
    assert _rel(got, _direct(dim, args)) < FAST_TOL[dim]


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_fast_without_extents_raises_as_under_jit(dim, case_rng):
    """Without extents the fast grids have no static size while a tracer
    runs: the JAX function's ValueError, which reaches a compiled caller
    inside dynamo's own exception, as ``jax.jit`` raises it; eagerly the
    points' span is read as before."""
    args = [torch.from_numpy(a) for a in _case(dim, case_rng)]
    fn = TYPE3[dim]
    name = {1: "nufft3", 2: "nufft3_2d", 3: "nufft3_3d"}[dim]
    with pytest.raises(Exception, match=rf"ValueError: {name}\(method='fast'\) under "
                                        r"torch.compile or torch.export needs static extent"
                       ) as info:
        compiled(lambda *a: fn(*a, method="fast"))(*args)
    assert isinstance(info.value, (ValueError, torch._dynamo.exc.TorchDynamoException))
    with pytest.raises(ValueError):
        jax.jit(lambda *a: JAX_TYPE3[dim](*a, method="fast"))(*(a.numpy() for a in args))
    assert _rel(fn(*args, method="fast"), _direct(dim, [a.numpy() for a in args])) \
        < FAST_TOL[dim]


def test_auto_without_extents_falls_back_to_dense(case_rng):
    """``nufft3(method="auto")`` at the JAX test's call (160 points, 120
    frequencies, ``:448-470``): eagerly the cost model on the points' spans
    takes the fast path; compiled, without concrete points, the dense one,
    within 1e-6 of the eager dense call, as ``jax.jit`` of the JAX function
    falls back; no recompile on new data."""
    def draw():
        c = (case_rng.standard_normal(160) + 1j * case_rng.standard_normal(160)).astype(
            np.complex64)
        return [case_rng.uniform(-5.0, 5.0, 160).astype(np.float32), c,
                case_rng.uniform(-8.0, 8.0, 120).astype(np.float32)]

    args, args2 = draw(), draw()
    auto = lambda x, c, s: tp.nufft3(x, c, s, method="auto")  # noqa: E731
    counters = torch._dynamo.utils.counters
    counters.clear()
    comp = compiled(auto)
    targs = [torch.from_numpy(a) for a in args]
    got = comp(*targs)
    assert not counters["graph_break"] and counters["stats"]["unique_graphs"] == 1
    assert _rel(got, tp.nufft3(*targs, method="dense")) < 1e-6
    want = jax.jit(lambda x, c, s: jsp.nufft3(x, c, s, method="auto"))(*args)
    assert _rel(got, want) <= TOL
    assert _rel(want, jsp.nufft3(*args, method="dense")) < 1e-6
    assert _rel(tp.nufft3(*targs, method="auto"), _direct(1, args)) < FAST_TOL[1]
    targs2 = [torch.from_numpy(a) for a in args2]
    with torch._dynamo.config.patch(error_on_recompile=True):
        got2 = comp(*targs2)
    assert _rel(got2, tp.nufft3(*targs2, method="dense")) < 1e-6


@pytest.mark.parametrize("dim", [1, 2])
def test_dense_type3_compiles_at_high(dim, case_rng):
    """The dense type-3 products go through ``utils.numerics.product``, so
    a compiled call at "high" is no longer refused (on the CPU an fp32
    product, as eager's): against ``jax.jit`` of the JAX function at the
    same precision and the eager port."""
    config = tp.SpectralConfig(precision="high")
    jconfig = jsp.SpectralConfig(precision="high")
    args, args2 = _case(dim, case_rng), _case(dim, case_rng)
    fn, jfn = TYPE3[dim], JAX_TYPE3[dim]
    hold(lambda *a: fn(*a, method="dense", config=config),
         lambda *a: jfn(*a, method="dense", config=jconfig), args, args2, within(TOL), warm=False)


@pytest.mark.parametrize("kind", [1, 2])
def test_dense_3d_compiles_at_high_with_its_gradient(kind, case_rng):
    """``nudft1_3d``/``nudft2_3d`` multiply complex operands through
    ``utils.numerics.product``: compiled at "high" (the product operator in
    the graph), the forward matches ``jax.jit`` of the JAX function and
    the eager port, and the gradient of a real loss in the complex
    strengths (modes) matches eager's and ``jax.grad``'s (the conjugate of
    torch's, by JAX's convention)."""
    config = tp.SpectralConfig(precision="high")
    jconfig = jsp.SpectralConfig(precision="high")
    x, y, z, c = _case(3, case_rng)[:4]
    ns = (6, 5, 4)
    if kind == 1:
        v = c
        fn = lambda *a: tp.nudft1_3d(*a, ns, config=config)  # noqa: E731
        jfn = lambda *a: jsp.nudft1_3d(*a, ns, config=jconfig)  # noqa: E731
    else:
        v = (case_rng.standard_normal(ns) + 1j * case_rng.standard_normal(ns)).astype(np.complex64)
        fn = lambda *a: tp.nudft2_3d(*a, config=config)  # noqa: E731
        jfn = lambda *a: jsp.nudft2_3d(*a, config=jconfig)  # noqa: E731
    pts = [torch.from_numpy(a) for a in (x, y, z)]

    def run(f):
        leaf = torch.from_numpy(v).requires_grad_(True)
        out = f(*pts, leaf)
        out.abs().square().sum().backward()
        return out.detach(), leaf.grad

    got, grad = run(compiled(fn))
    want, want_grad = run(fn)
    assert _rel(got, want) <= EAGER_TOL and _rel(grad, want_grad) <= EAGER_TOL
    jout = jax.jit(jfn)(x, y, z, v)
    jgrad = jax.grad(lambda u: jax.numpy.sum(jax.numpy.abs(jfn(x, y, z, u)) ** 2))(v)
    assert _rel(got, jout) <= TOL and _rel(grad, np.conj(np.asarray(jgrad))) <= TOL


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_explain_reads_one_graph(dim, case_rng):
    """``torch._dynamo.explain`` at the JAX tests' calls: one graph, no
    break, for the fast forms with extents and, in 1-D, "auto" without."""
    args = [torch.from_numpy(a) for a in _case(dim, case_rng)]
    calls = [lambda *a: TYPE3[dim](*a, method="fast", **EXTENTS[dim])]
    if dim == 1:
        calls.append(lambda *a: tp.nufft3(*a, method="auto"))
    for fn in calls:
        out = torch._dynamo.explain(fn)(*args)
        assert (out.graph_count, out.graph_break_count) == (1, 0), out.break_reasons
