"""PyTorch port under ``torch.compile``: ``vmd``, whose ADMM sweeps the
JAX function runs in a ``lax.fori_loop`` and the port in
``utils.scan.fori_loop`` (one loop node whose body is one sweep), for its
three ``init_omega`` forms (the greedy peak pick reading the frequency grid
by a gather, the uniform grid a host table, a caller's frequencies keyed
on the host), at the JAX test's call, with the checks of
``test_torch_compile_ops.py`` (one graph, ``jax.jit`` of the JAX op and
the eager port matched, no recompile, cold and warm table caches, no
traced tensor kept), the JAX tests' refusals under compile, and a graph
whose size does not grow with the sweep count."""

import numpy as np
import pytest
import torch

import mixed_radix_fast_fourier_transform_tpu as jsp

import mixed_radix_fast_fourier_transform_tpu_torch as tp

from test_torch_compile_ops import (  # noqa: F401  (fixtures)
    ROUTES, _np, _rel, case_rng, compiled, fresh_dynamo, hold,
)
from test_torch_compile_ops_loops import graph_nodes

torch.set_num_threads(1)

VMD_TOL = 1e-4      # the port's eager test of vmd against the JAX function
VMD_PINNED = np.array([0.07, 0.23])


def _two_tones(rng, n: int = 1024) -> np.ndarray:
    """The JAX test's input: tones at 0.07 and 0.23 cycles/sample and a
    little noise (clean peaks: the greedy pick lands on each tone's bin in
    both packages)."""
    k = np.arange(n)
    return (np.cos(2 * np.pi * 0.07 * k) + 0.6 * np.cos(2 * np.pi * 0.23 * k)
            + 0.01 * rng.standard_normal(n)).astype(np.float32)


VMD_FORMS = {"peaks": None, "uniform": "uniform", "pinned": VMD_PINNED}
# one JAX function a form, whose jit both routes share
JAX_VMD = {form: (lambda v, init=init: jsp.vmd(v, 2, n_iter=50, init_omega=init))
           for form, init in VMD_FORMS.items()}


@pytest.mark.parametrize("form,route", [("peaks", "kernel"), ("peaks", "pipeline"),
                                        ("uniform", "kernel"), ("pinned", "kernel")])
def test_vmd_compiles_whole(form, route, case_rng):
    """At the JAX test's call (``tests/test_vmd.py``: the two-tone signal
    of 1,024 samples, K = 2, 50 sweeps, ``jax.jit``) for each
    ``init_omega`` form: one graph whose sweeps are one loop node, the
    modes and frequencies of the JAX function within the port's eager
    tolerance (1e-4 of the largest mode) and of eager within 1e-6, a
    second signal without a recompile (and, for the peak pick on K1's
    route, a compile from the warm table cache).  The peak pick reads
    ``w`` by a gather; a caller's frequencies are keyed on the host.  The
    forms differ before the sweeps and the routes in the transforms
    around them: the peak pick runs on both routes, the other forms on
    K1's."""
    init = VMD_FORMS[form]
    config = ROUTES[route]
    port = lambda v: tp.vmd(v, 2, n_iter=50, init_omega=init, config=config)  # noqa: E731

    def near_jax(got, want):
        assert _rel(got[0], want[0]) <= VMD_TOL
        assert np.max(np.abs(_np(got[1]) - np.asarray(want[1]))) <= VMD_TOL

    tables = ("vmd.pos", "vmd.w") + {"uniform": ("vmd.uniform",),
                                     "pinned": ("vmd.omega",)}.get(form, ())
    hold(port, JAX_VMD[form], [_two_tones(case_rng)], [_two_tones(case_rng)], near_jax,
         tables=tables, warm=(form, route) == ("peaks", "kernel"))


def test_vmd_closures_over_other_frequencies_get_their_own(case_rng):
    """A caller's ``init_omega`` is keyed on the host and guarded by
    identity: two compiled closures of one function over different arrays
    each give their own eager answer, never the first one's table."""
    x = torch.from_numpy(_two_tones(case_rng))

    def make(omega0):
        return lambda v: tp.vmd(v, 2, n_iter=5, init_omega=omega0, config=ROUTES["kernel"])

    for omega0 in (VMD_PINNED, np.array([0.1, 0.3])):
        got, eager = compiled(make(omega0))(x), make(omega0)(x)
        assert all(torch.equal(g, e) for g, e in zip(got, eager))
    assert not torch.equal(got[1], make(VMD_PINNED)(x)[1])


def test_vmd_refusals_compiled(case_rng):
    """The JAX test's refusals raise their ValueErrors under compile too:
    K = 0, a signal shorter than 8, an ``init_omega`` of the wrong shape
    (checked on the host) and an unknown form."""
    x = torch.from_numpy(case_rng.standard_normal((3, 512)).astype(np.float32))
    for args, kw, match in (((x, 0), {}, "1 <= K <= 32"),
                            ((torch.zeros(4), 2), {}, "length >= 8"),
                            ((x, 2), {"init_omega": np.zeros(3)}, r"shape \(2,\)"),
                            ((x, 2), {"init_omega": "bogus"}, "init_omega must be")):
        with pytest.raises(ValueError, match=match):
            tp.vmd(*args, n_iter=2, **kw)
        torch._dynamo.reset()
        with pytest.raises(Exception, match=match):
            compiled(lambda v, a=args, kw=kw: tp.vmd(v, *a[1:], n_iter=2, **kw))(args[0])


def test_vmd_graph_does_not_grow_with_the_sweep_count(case_rng):
    """``vmd`` at 50 and at 300 sweeps captures graphs of the same size:
    the sweep is a loop body traced once."""
    config = ROUTES["kernel"]
    x = torch.from_numpy(_two_tones(case_rng))
    sizes = [graph_nodes(lambda v, n=n: tp.vmd(v, 2, n_iter=n, config=config), x)
             for n in (50, 300)]
    assert sizes[0] == sizes[1]


KERNEL = ROUTES["kernel"]
EXPLAINED = {
    "peaks": lambda v: tp.vmd(v, 2, n_iter=50, config=KERNEL),
    "uniform": lambda v: tp.vmd(v, 2, n_iter=50, init_omega="uniform", config=KERNEL),
    "pinned": lambda v: tp.vmd(v, 2, n_iter=50, init_omega=VMD_PINNED, config=KERNEL),
}


@pytest.mark.parametrize("form", EXPLAINED)
def test_explain_reads_one_graph(form, case_rng):
    """``torch._dynamo.explain`` at the JAX test's call, for each
    ``init_omega`` form: one graph, no break, on K1's route (the stage
    pipeline's route is held to one graph by ``hold``'s counters)."""
    out = torch._dynamo.explain(EXPLAINED[form])(torch.from_numpy(_two_tones(case_rng)))
    assert (out.graph_count, out.graph_break_count) == (1, 0), out.break_reasons
