"""PyTorch port under ``torch.compile``: the ops with host tables made from
a caller's array or a design (``pfb_analysis``, ``radon``/``iradon``,
``multitaper``), ``griffinlim`` and the compiled loss of a ``dwt``, each at
its JAX test's call and shape, with the checks of
``test_torch_compile_ops.py`` (one graph, ``jax.jit`` of the JAX op and the
eager port matched, no recompile, cold and warm table caches, no traced
tensor kept)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mixed_radix_fast_fourier_transform_tpu as jsp

import mixed_radix_fast_fourier_transform_tpu_torch as tp
from mixed_radix_fast_fourier_transform_tpu_torch.ops import stft as tstft

from test_torch_compile_ops import (  # noqa: F401  (fixtures)
    EAGER_TOL, ROUTES, TOL, _rel, assert_no_traced_tensors, case_rng, compiled, fresh_dynamo,
    hold, within,
)

torch.set_num_threads(1)


def _disks(n=48):
    yy, xx = np.mgrid[:n, :n] - n // 2
    return np.stack([((xx ** 2 + yy ** 2) <= 8.0 ** 2), (((xx - 6) ** 2 + yy ** 2) <= 8.0 ** 2)]
                    ).astype(np.float32)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("name", ["pfb_analysis", "radon-iradon", "multitaper"])
def test_host_table_ops_compile_whole(name, route, case_rng):
    """``pfb_analysis`` with a caller's prototype (``tests/test_signal.py``),
    ``iradon(radon(v, theta), theta)`` (``tests/test_tomo.py``) and
    ``multitaper`` with unity weights (``tests/test_signal.py``): the
    caller's array keyed on the host, the DPSS tapers a host build."""
    config, warm = ROUTES[route], route == "kernel"
    if name == "pfb_analysis":
        h = tp.pfb_prototype(16, 4, window="hann")
        args, args2 = ([case_rng.standard_normal((2, 16 * 32)).astype(np.float32)]
                       for _ in range(2))
        hold(lambda v: tp.pfb_analysis(v, 16, h=h, config=config),
             lambda v: jsp.pfb_analysis(v, 16, h=h), args, args2, within(TOL), tables=("pfb.h",),
             warm=warm)
    elif name == "radon-iradon":
        theta = np.linspace(0, np.pi, 24, endpoint=False)
        args2 = [case_rng.standard_normal((2, 48, 48)).astype(np.float32)]
        hold(lambda v: tp.iradon(tp.radon(v, theta, config=config), theta, config=config),
             lambda v: jsp.iradon(jsp.radon(v, theta), theta), [_disks()], args2, within(TOL),
             tables=("tomo_polar", "tomo_filter", "nufft_modes"), warm=warm)
    else:
        args, args2 = ([case_rng.standard_normal((3, 512)).astype(np.float32)] for _ in range(2))
        hold(lambda v: tp.multitaper(v, fs=10.0, weighting="unity", k=4, config=config),
             lambda v: jsp.multitaper(v, fs=10.0, weighting="unity", k=4), args, args2,
             within(TOL), tables=("multitaper.tapers", "multitaper.weights"), warm=warm)


@pytest.mark.parametrize("route", ROUTES)
def test_griffinlim_compiles_whole(route, case_rng):
    """``griffinlim(m, n_iter=8, nperseg=128, length=2048)``
    (``tests/test_stft.py``): the ``seed`` form compiles, its draws a host
    table equal to a ``torch.Generator().manual_seed(seed)`` draw (compiled
    against the eager ``generator=`` form)."""
    config = ROUTES[route]
    mags = [np.abs(np.asarray(jsp.stft(case_rng.standard_normal((2, 2048)).astype(np.float32),
                                       nperseg=128))) for _ in range(2)]
    port = lambda m: tp.griffinlim(m, n_iter=8, nperseg=128, length=2048, config=config)  # noqa: E731
    # cold only: a warm compile repeats the eight istft/stft rounds of the other ops'
    hold(port, None, mags[:1], mags[1:], None, tables=("griffinlim.draws",), warm=False)
    m = torch.from_numpy(mags[0])
    want = tp.griffinlim(m, n_iter=8, nperseg=128, length=2048, config=config,
                         generator=torch.Generator().manual_seed(0))
    assert _rel(compiled(port)(m), want) <= EAGER_TOL


@pytest.mark.parametrize("route", ROUTES)
def test_griffinlim_loop_compiled_from_the_jax_draw(route, case_rng):
    """The JAX function draws with ``jax.random``, which torch cannot
    reproduce, so the compiled loop is held to the JAX result from the JAX
    draw, as ``tests/test_torch_stft.py`` holds the eager one (1e-4 after a
    few rounds: each renormalises by the magnitude)."""
    config = ROUTES[route]
    n_iter = 4
    mag = np.abs(np.asarray(jsp.stft(case_rng.standard_normal((2, 2048)).astype(np.float32),
                                     nperseg=128)))
    jwant = np.asarray(jax.jit(lambda v: jsp.griffinlim(v, n_iter, 128, seed=3))(mag))
    ph = jax.random.uniform(jax.random.PRNGKey(3), mag.shape, jnp.float32, 0.0, 2.0 * float(np.pi))
    spec0 = torch.from_numpy(np.array(mag * jnp.cos(ph) + 1j * (mag * jnp.sin(ph))))
    sig_len = 128 + (mag.shape[-2] - 1) * 64 - 128

    def loop(mt, s0):
        def invert(spec):
            return tp.istft(spec, 128, length=sig_len, config=config)

        def project(spec):
            return tp.stft(invert(spec), 128, config=config)[..., : mag.shape[-2], :]
        return invert(tstft._griffinlim_loop(mt, s0, n_iter, 0.99, project))

    assert _rel(compiled(loop)(torch.from_numpy(mag), spec0), jwant) <= 1e-4


# -- the compiled loss of a dwt ------------------------------------------------


def test_dwt_loss_and_gradient_compile_whole(case_rng):
    """``jax.jit(jax.grad(lambda v: sum(dwt(v, "db2")[1] ** 2)))``
    (``tests/test_dwt.py``): the loss compiles whole (the filter bank a host
    build keyed by the wavelet's name, its perfect-reconstruction probe run
    on the host), its gradient taken as ``compile_sgd_step`` takes it
    (``torch.autograd.grad`` of the compiled loss), against the JAX gradient
    and the eager one."""
    def loss(v):
        return torch.sum(tp.dwt(v, "db2")[1] ** 2)

    def jloss(v):
        return jnp.sum(jsp.dwt(v, "db2")[1] ** 2)

    x, x2 = (case_rng.standard_normal(32).astype(np.float32) for _ in range(2))

    def grads(fn, v):
        leaf = torch.from_numpy(v).requires_grad_(True)
        out = fn(leaf)
        return out, torch.autograd.grad(out, leaf)[0]

    tp.clear_plan_cache()
    counters = torch._dynamo.utils.counters
    counters.clear()
    comp = compiled(loss)
    value, g = grads(comp, x)
    assert not counters["graph_break"] and counters["stats"]["unique_graphs"] == 1
    assert_no_traced_tensors("dwt.w")
    evalue, eg = grads(loss, x)
    assert _rel(value.detach(), evalue.detach()) <= EAGER_TOL and _rel(g, eg) <= EAGER_TOL
    jvalue, jg = jax.jit(jax.value_and_grad(jloss))(jnp.asarray(x))
    assert _rel(value.detach(), jvalue) <= TOL and _rel(g, jg) <= TOL
    with torch._dynamo.config.patch(error_on_recompile=True):
        value2, g2 = grads(comp, x2)
    assert _rel(g2, grads(loss, x2)[1]) <= EAGER_TOL
