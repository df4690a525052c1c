"""PyTorch port under ``torch.compile``: ``parallel/``'s collectives, the
placement helpers and the four-step family (with the convolutions and the
2-D pencil), in a gloo world of 2 CPU processes (the exchange is real, not
a copy), on the mesh (1, 2) (the ``seq`` axis sharded) and, for the
batch-and-sequence layouts, (2, 1).

Every entry compiles with ``fullgraph=True, dynamic=False`` on AOTAutograd
(``backend="aot_eager"``; the CPU has no compiler for Inductor) as one
graph with no break, does not recompile on a second call with new data of
the same shapes, and matches the eager call to 1e-6, taking the global
array as a plain tensor and as a DTensor.  The world and its conventions
are those of ``test_torch_parallel.py``; the harness here serves the other
files: ``_pencils`` (the N-D pencils and the Poisson solve), ``_models``
(the distributed filter and FNet, their steps), ``_ops`` (the
batch-sharded calls) and ``_nufft_sht``."""

import numpy as np
import pytest

from test_torch_parallel import complex_input, real_input, rel, run_world

WORLD = 2
EAGER_TOL = 1e-6


# host taps made outside the compiled calls, as the JAX tests make them
TAPS = real_input("taps", (33,)).astype(np.float64)
TAPS2 = real_input("taps2", (5, 3)).astype(np.float64)


# name: (mesh, inputs(seed) as numpy arrays, call(par, mesh, *args)); the
# inputs' first array is the sharded one, given plain and as a DTensor
CASES = {
    "fft_four_step": ((1, 2), lambda s: (complex_input(f"fs{s}", (4, 1024)),),
                      lambda P, m, x: P.fft_four_step(x, m)),
    "fft_four_step_data": ((2, 1), lambda s: (complex_input(f"fsd{s}", (4, 1024)),),
                           lambda P, m, x: P.fft_four_step(x, m, data_axis="data", norm="ortho")),
    "fft_four_step_chunks": ((1, 2), lambda s: (complex_input(f"fsc{s}", (4, 1024)),),
                             lambda P, m, x: P.fft_four_step(x, m, overlap_chunks=2)),
    "ifft_four_step": ((1, 2), lambda s: (complex_input(f"ifs{s}", (4, 1024)),),
                       lambda P, m, x: P.ifft_four_step(x, m)),
    "fft_four_step_scrambled": ((1, 2), lambda s: (complex_input(f"scr{s}", (4, 1024)),),
                                lambda P, m, x: P.fft_four_step_scrambled(x, m)),
    "ifft_four_step_scrambled": ((1, 2), lambda s: (complex_input(f"iscr{s}", (4, 32, 32)),),
                                 lambda P, m, x: P.ifft_four_step_scrambled(x, m)),
    "rfft_four_step": ((1, 2), lambda s: (real_input(f"rfs{s}", (4, 2048)),),
                       lambda P, m, x: P.rfft_four_step(x, m)),
    "irfft_four_step": ((1, 2), lambda s: (complex_input(f"irfs{s}", (4, 1025)),),
                        lambda P, m, x: P.irfft_four_step(x, m)),
    "fft_convolve_sharded": ((1, 2), lambda s: (real_input(f"conv{s}", (4, 1024)),),
                             lambda P, m, x: P.fft_convolve_sharded(x, TAPS, m)),
    "fft_convolve_sharded_same": ((1, 2), lambda s: (real_input(f"convs{s}", (4, 1000)),),
                                  lambda P, m, x: P.fft_convolve_sharded(x, TAPS, m,
                                                                         mode="same")),
    "fft_convolve2_sharded": ((1, 2), lambda s: (real_input(f"conv2{s}", (2, 32, 64)),),
                              lambda P, m, x: P.fft_convolve2_sharded(x, TAPS2, m)),
    "fft2_pencil": ((1, 2), lambda s: (complex_input(f"p2{s}", (2, 32, 64)),),
                    lambda P, m, x: P.fft2_pencil(x, m)),
    "ifft2_pencil": ((1, 2), lambda s: (complex_input(f"ip2{s}", (2, 32, 64)),),
                     lambda P, m, x: P.ifft2_pencil(x, m, norm="ortho")),
}

def flat(tree) -> list:
    """Leaves in a fixed order (sorted dict keys, list order), as
    ``jax.tree_util.tree_leaves`` orders a JAX tree."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in flat(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in flat(v)]
    return [tree]


def _flat(o) -> list:
    from mixed_radix_fast_fourier_transform_tpu_torch.utils.tree import tree_leaves

    return tree_leaves(o) if isinstance(o, (tuple, list, dict)) else [o]


def held(name, fn, first, second, keep: bool = False) -> dict:
    """Compile ``fn`` (fullgraph, static shapes, ``aot_eager``), call it on
    ``first`` and then ``second`` (new data, same shapes and types), and
    return what the parent asserts: graphs, breaks, the graphs the second
    call added, and the largest error against eager of the two calls;
    with ``keep`` also the first call's outputs, gathered, and whether each
    is a DTensor sharded along some axis."""
    import torch

    from test_torch_parallel import gathered

    counters = torch._dynamo.utils.counters
    torch._dynamo.reset()
    counters.clear()
    comp = torch.compile(fn, backend="aot_eager", fullgraph=True, dynamic=False)
    got = [comp(*first)]
    graphs = counters["stats"]["unique_graphs"]
    got.append(comp(*second))
    out = {f"{name}/graphs": np.array(graphs),
           f"{name}/breaks": np.array(sum(counters["graph_break"].values())),
           f"{name}/recompiles": np.array(counters["stats"]["unique_graphs"] - graphs)}
    err = 0.0
    for g, args in zip(got, (first, second)):
        for a, b in zip(_flat(g), _flat(fn(*args))):
            a, b = gathered(a), gathered(b)
            # detections (booleans) must be equal
            err = max(err, float(np.any(a != b)) if a.dtype == bool else rel(a, b))
    out[f"{name}/err"] = np.array(err)
    if keep:
        from torch.distributed.tensor import DTensor

        for i, o in enumerate(_flat(got[0])):
            out[f"{name}/out_{i}"] = gathered(o)
            out[f"{name}/sharded_{i}"] = np.array(
                isinstance(o, DTensor) and any(p.is_shard() for p in o.placements))
    return out


def held_step(name, make, eager, calls) -> dict:
    """A train step compiled by ``make()`` (``compile_sgd_step``) held on
    each argument tuple of ``calls`` (new data, same shapes) against the
    eager step ``eager``: graphs after the first call (the loss with its
    backward, and the update), breaks, the graphs later calls added, the
    largest error of the loss and new parameters, whether every new
    parameter is a plain tensor, and the first call's loss and new
    parameters (in :func:`flat`'s order)."""
    import torch

    counters = torch._dynamo.utils.counters
    torch._dynamo.reset()
    counters.clear()
    step = make()
    err, graphs, plain, out = 0.0, None, True, {}
    for args in calls:
        new, loss = step(*args)
        if graphs is None:
            graphs = counters["stats"]["unique_graphs"]
            out[f"{name}/loss"] = loss.numpy()
            out.update({f"{name}/new_{i}": v.numpy() for i, v in enumerate(flat(new))})
        want, wloss = eager(*args)
        err = max([err, rel(loss.detach().numpy(), wloss.detach().numpy())]
                  + [rel(a.numpy(), b.numpy()) for a, b in zip(_flat(new), _flat(want))])
        plain = plain and all(type(v) is torch.Tensor for v in _flat(new))
    return {**out, f"{name}/graphs": np.array(graphs),
            f"{name}/recompiles": np.array(counters["stats"]["unique_graphs"] - graphs),
            f"{name}/breaks": np.array(sum(counters["graph_break"].values())),
            f"{name}/err": np.array(err), f"{name}/plain": np.array(plain)}


def one_step(world, name):
    """Two graphs (the loss with its backward, the update), no break, no
    recompile on new data, within 1e-6 of the eager step, plain new
    parameters."""
    assert int(world[f"{name}/graphs"]) == 2
    assert int(world[f"{name}/breaks"]) == 0
    assert int(world[f"{name}/recompiles"]) == 0
    assert float(world[f"{name}/err"]) <= EAGER_TOL
    assert bool(world[f"{name}/plain"])


def tensors(arrays) -> tuple:
    import torch

    return tuple(torch.from_numpy(a) for a in arrays)


def meshes() -> dict:
    from mixed_radix_fast_fourier_transform_tpu_torch import parallel as par

    return {s: par.make_mesh(s, device="cpu") for s in ((1, 2), (2, 1))}


def transforms_world(cases) -> dict:
    """Each case of ``cases`` (name: (mesh, inputs(seed), call(par, mesh,
    *args)); the inputs' first array the sharded one) held by :func:`held`,
    given the global array plain and as a DTensor."""
    from mixed_radix_fast_fourier_transform_tpu_torch import parallel as par

    out, ms = {}, meshes()
    for name, (shape, inputs, call) in cases.items():
        m = ms[shape]
        first, second = tensors(inputs(0)), tensors(inputs(1))
        fn = lambda *a: call(par, m, *a)  # noqa: E731
        out.update(held(f"{name}/plain", fn, first, second))
        out.update(held(f"{name}/dtensor", fn, (_as_dtensor(first[0], m, shape),) + first[1:],
                        (_as_dtensor(second[0], m, shape),) + second[1:]))
    return out


def compile_world() -> dict:
    """Every case of this file (runs on each rank)."""
    import torch

    from mixed_radix_fast_fourier_transform_tpu_torch.parallel import distributed as D

    torch.set_num_threads(1)
    # 1. the collectives alone: the exchange and its gradient, the sums
    m = meshes()[(1, 2)]
    group = D._group(m, "seq")

    def collectives(x, g):
        return (D._all_to_all(x, group, -1, -2), D._psum(x * 2.0, m, "seq"),
                D._mean_squared_error(D._wrap(x, m, (None, "seq"), (4, 8)), g))

    xs = [tensors((real_input(f"coll{s}", (4, 4)), real_input(f"collt{s}", (4, 8))))
          for s in (0, 1)]
    out = held("collectives", collectives, *xs)
    x = tensors((real_input("collg", (4, 4)),))[0].requires_grad_(True)
    y = torch.compile(lambda v: D._all_to_all(v, group, -1, -2), backend="aot_eager",
                      fullgraph=True)(x)
    out["exchange_grad"] = (torch.autograd.grad((y * y).sum(), x)[0] - 2.0 * x).abs().max()
    out["exchange_grad"] = out["exchange_grad"].detach().numpy()
    # 2.–4. the placement helpers through the four-step family
    out.update(transforms_world(CASES))
    return out


def _as_dtensor(x, mesh, shape):
    """``x`` as a DTensor: its leading axis over ``data`` where that mesh
    axis has the ranks; else its last axis over ``seq`` (the layout of the
    four-step's input) where it divides, its leading axis otherwise."""
    from mixed_radix_fast_fourier_transform_tpu_torch.parallel import distributed as D

    spec = [None] * x.ndim
    if shape[0] > 1:
        spec[0] = "data"
    else:
        spec[-1 if x.shape[-1] % shape[1] == 0 else 0] = "seq"
    return D._wrap(D._local(x, mesh, tuple(spec)), mesh, tuple(spec), x.shape)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(__name__, "compile_world", tmp_path_factory.mktemp("compile_parallel"),
                     world=WORLD)


def one_graph(world, name):
    assert int(world[f"{name}/graphs"]) == 1
    assert int(world[f"{name}/breaks"]) == 0
    assert int(world[f"{name}/recompiles"]) == 0
    assert float(world[f"{name}/err"]) <= EAGER_TOL


def test_collectives_compile_whole(world):
    """The exchange (``all_to_all_single_autograd``), the sum (``_Sum``)
    and the global MSE compile into one graph with no break and match
    eager; the exchange's gradient through a compiled call is the reverse
    exchange (of 2·y: 2·x)."""
    one_graph(world, "collectives")
    assert float(world["exchange_grad"]) == 0.0


@pytest.mark.parametrize("form", ["plain", "dtensor"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_transform_compiles_whole(world, case, form):
    """One graph, no break, no recompile on new data, compiled within 1e-6
    of eager, for the global array given as a plain tensor and as a
    DTensor."""
    one_graph(world, f"{case}/{form}")
