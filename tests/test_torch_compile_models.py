"""PyTorch port: every model family, the ops they stand on and the two
time-stepping examples under ``torch.compile``, as the JAX package runs
them under ``jax.jit``.

On the CPU with ``backend="aot_eager"``, ``fullgraph=True, dynamic=False``,
on both routes (``use_kernel=True``: the fused kernel's operator, its CPU
implementation; ``use_kernel=False``: the stage pipeline).  For S4D, FNet,
the AFNO, the SFNO, the PCEN front end and the Koopman autoencoder, at small
widths and 2 layers: zero graph breaks (one graph a compiled function,
by dynamo's counters; ``fullgraph=True`` raises at a break), the compiled
forward against ``jax.jit`` of the JAX function (1e-5) and the eager port
(1e-6), ``compile_sgd_step`` against ``jax.jit`` of the JAX ``train_step``
on the loss and every leaf (Koopman: ``jax.jit(jax.grad(koopman_loss))``),
no recompile on a second call, a cold plan and table cache (and a warm one
on the kernel route), and no traced tensor kept in a cache.  The AFNO's parameters are compared in the 2-norm per leaf: a
ReLU or shrinkage mask that flips between two fp32 routes moves single
entries by percents (ROADMAP F4).  Then ``sht``/``isht``/``sphere_grad``
on both grids, ``melspectrogram``, ``pcen`` with tensor and scalar
coefficients and ``linear_recurrence`` with a host and a device A compile
whole against ``jax.jit`` of the JAX functions, and the two examples
compiled against the JAX examples."""

import functools
import importlib.util
import io
import pathlib
import re
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mixed_radix_fast_fourier_transform_tpu as jsp
from mixed_radix_fast_fourier_transform_tpu import models as jmodels
from mixed_radix_fast_fourier_transform_tpu.ops import iir as jiir
from mixed_radix_fast_fourier_transform_tpu.ops import sht as jsht

import mixed_radix_fast_fourier_transform_tpu_torch as tp
from mixed_radix_fast_fourier_transform_tpu_torch import models as tmodels
from mixed_radix_fast_fourier_transform_tpu_torch import plan as tplan
from mixed_radix_fast_fourier_transform_tpu_torch.examples import pde_spectral, sphere_advection
from mixed_radix_fast_fourier_transform_tpu_torch.models.checkpoint import _flatten
from mixed_radix_fast_fourier_transform_tpu_torch.ops import cuda_fft
from mixed_radix_fast_fourier_transform_tpu_torch.utils import numerics, scan
from mixed_radix_fast_fourier_transform_tpu_torch.utils.tree import compile_sgd_step, sgd_step

torch.set_num_threads(1)

JAX_TOL = 1e-5     # max |got − want| / max |want| against the JAX function
EAGER_TOL = 1e-6   # against the eager port: the same ops, traced
ROUTES = {"kernel": tp.SpectralConfig(use_kernel=True),
          "pipeline": tp.SpectralConfig(use_kernel=False)}
KEY = jax.random.PRNGKey(0)
AFNO_KW = dict(patch=2, n_blocks=4)
LR = 0.05
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def _l2(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def compiled(fn):
    return torch.compile(fn, backend="aot_eager", fullgraph=True, dynamic=False)


@pytest.fixture(autouse=True)
def fresh_dynamo():
    torch._dynamo.reset()
    yield
    torch._dynamo.reset()


@pytest.fixture
def case_rng(request):
    """A generator made for one test case from its name: its draws do not
    depend on which tests ran before on the worker."""
    return np.random.default_rng([ord(ch) for ch in request.node.name])


def _assert_no_traced_tensors(*prefixes):
    """Every tensor in the plan, table and launch caches is a plain one (no
    fake, functional or traced tensor outlives a trace), and the device
    tables whose keys name ``prefixes`` (the SHT's Legendre chunks, the mel
    filterbank, the scan's block operators, …) are among them, kept by key."""
    kept = [t for plan in tplan._CACHE.values() for consts in plan._device.values()
            for v in consts.values() for t in (v if isinstance(v, tuple) else (v,))]
    kept += list(numerics._TABLES.values())
    kept += [r.tw for r in cuda_fft._READY.values()]
    assert all(type(t) is torch.Tensor for t in kept), {type(t) for t in kept}
    names = {part for slot in numerics._TABLES for part in slot[0] if isinstance(part, str)}
    assert set(prefixes) <= names, (prefixes, names)


class Family:
    """One model family at a small size: the JAX forward and step (under
    ``jax.jit``), the port's forward, loss and eager step, the JAX
    initialisation, an input pair, the tables its compiled calls must keep,
    and how parameters are compared."""

    def __init__(self, name, jparams, make, *, japply, jstep, apply, loss, step, kw=None,
                 tables=(), routes=True, leaf_err=_rel):
        self.name, self.jparams, self.make = name, jparams, make
        self.japply, self.jstep = japply, jstep
        self.apply, self.loss, self.step = apply, loss, step
        self.kw, self.tables, self.routes, self.leaf_err = kw or {}, tables, routes, leaf_err


def _koopman_step(params, trajs, lr):
    grads = jax.grad(lambda p: jmodels.koopman.koopman_loss(p, trajs, horizon=4))(params)
    return jax.tree_util.tree_map(lambda p, g: p - lr * g, params, grads), \
        jmodels.koopman.koopman_loss(params, trajs, horizon=4)


def _frontend_params(rng, n_mels, n_classes):
    return {
        "frontend": {
            "log_gain": np.log(rng.uniform(0.7, 1.0, n_mels)).astype(np.float32),
            "log_bias": np.log(rng.uniform(1.0, 3.0, n_mels)).astype(np.float32),
            "log_power": np.log(rng.uniform(0.3, 0.7, n_mels)).astype(np.float32),
            "smooth_logit": rng.uniform(-4.0, -2.0, n_mels).astype(np.float32),
        },
        "head": {"w": (rng.standard_normal((n_mels, n_classes)) / 4).astype(np.float32),
                 "b": (0.1 * rng.standard_normal(n_classes)).astype(np.float32)},
    }


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


FAMILIES = {
    "s4d": Family(
        "s4d", jmodels.s4d.init_s4d_model(KEY, 16, n_layers=2, state=8, in_dim=3, out_dim=4),
        lambda rng: (_f32(rng, 2, 64, 3), _f32(rng, 2, 4)),
        japply=jmodels.s4d.apply_s4d, jstep=jmodels.s4d.train_step,
        apply=tmodels.s4d.apply_s4d, loss=tmodels.s4d.loss_fn, step=tmodels.s4d.train_step),
    "fnet": Family(
        "fnet", jmodels.fnet.init_fnet(KEY, 16, ff_dim=32, n_layers=2),
        lambda rng: (_f32(rng, 2, 12, 16), _f32(rng, 2, 12, 16)),
        japply=jmodels.fnet.apply, jstep=jmodels.fnet.train_step,
        apply=tmodels.fnet.apply, loss=tmodels.fnet.loss_fn, step=tmodels.fnet.train_step),
    "afno": Family(
        "afno", jmodels.afno.init_afno(KEY, 3, 16, 2, patch=2, n_layers=2, n_blocks=4),
        lambda rng: (_f32(rng, 2, 16, 24, 3), _f32(rng, 2, 16, 24, 2)),
        japply=functools.partial(jmodels.afno.apply, **AFNO_KW),
        jstep=lambda p, x, t, lr: jmodels.afno.train_step(p, x, t, lr, **AFNO_KW),
        apply=tmodels.afno.apply, loss=tmodels.afno.loss_fn, step=tmodels.afno.train_step,
        kw=AFNO_KW, leaf_err=_l2),
    "sfno": Family(
        "sfno", jmodels.sfno.init_sfno(KEY, 3, 8, 3, 15, n_layers=2),
        lambda rng: (_f32(rng, 2, 3, 16, 32), _f32(rng, 2, 3, 16, 32)),
        japply=jmodels.sfno.apply, jstep=jmodels.sfno.train_step,
        apply=tmodels.sfno.apply, loss=tmodels.sfno.loss_fn, step=tmodels.sfno.train_step,
        tables=("sht_legendre", "sht_weights", "sht_neg_signs")),
    "frontend": Family(
        "frontend", None, lambda rng: (_f32(rng, 3, 2000), rng.integers(0, 5, 3)),
        japply=jmodels.audio_frontend.apply, jstep=jmodels.audio_frontend.train_step,
        apply=tmodels.audio_frontend.apply, loss=tmodels.audio_frontend.loss_fn,
        step=tmodels.audio_frontend.train_step, tables=("mel.filterbank", "stft.window")),
    "koopman": Family(
        "koopman", jmodels.koopman.init_koopman(KEY, 5, latent_dim=6, hidden=16),
        lambda rng: (_f32(rng, 3, 20, 5), None),
        japply=lambda p, x: jmodels.koopman.koopman_rollout(p, x[:, 0], 6), jstep=_koopman_step,
        apply=lambda p, x: tmodels.koopman.koopman_rollout(p, x[:, 0], 6),
        loss=tmodels.koopman.koopman_loss, step=None, kw=dict(horizon=4), routes=False),
}
CASES = [(f, r) for f in FAMILIES for r in (ROUTES if FAMILIES[f].routes else ("only",))]


def _setup(fam):
    """(JAX parameters, port parameters, JAX arguments, port arguments) of
    one family, drawn from a generator of its own (the same data on both
    routes); the front end's parameters are drawn, as its own test's are."""
    rng = np.random.default_rng(list(fam.name.encode()))
    x, target = fam.make(rng)
    jparams = fam.jparams
    if fam.name == "frontend":
        jparams = jax.tree_util.tree_map(jnp.asarray, _frontend_params(rng, 16, 5))
    params = tmodels.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    if fam.name == "frontend":
        target = target.astype(np.int32)
    jargs = (x,) if target is None else (x, target)
    targs = tuple(torch.from_numpy(a) for a in jargs)
    if fam.name == "frontend":
        targs = (targs[0], targs[1].long())
    return jparams, params, jargs, targs


@functools.lru_cache(maxsize=None)
def _jax_run(name):
    """The JAX package's forward and step of one family under ``jax.jit``,
    once for both routes: (forward, new parameters, loss)."""
    fam = FAMILIES[name]
    jparams, _, jargs, _ = _setup(fam)
    jnew, jloss = jax.jit(fam.jstep)(jparams, *jargs, LR)
    return np.asarray(jax.jit(fam.japply)(jparams, jargs[0])), _flatten(jnew), float(jloss)


def _route_kw(fam, route):
    kw = dict(fam.kw)
    if route != "only":
        kw["config"] = ROUTES[route]
    return kw


@pytest.mark.parametrize("name,route", CASES, ids=[f"{f}-{r}" for f, r in CASES])
def test_family_forward_compiles_whole(name, route):
    """One family's forward on one route from a cold cache: one graph,
    against ``jax.jit`` of the JAX forward and the eager port, again without
    a recompile (and on the kernel route from a warm cache); no traced
    tensor kept, the family's tables kept by key."""
    fam = FAMILIES[name]
    _, params, _, targs = _setup(fam)
    jfwd = _jax_run(name)[0]
    kw = {k: v for k, v in _route_kw(fam, route).items() if k != "horizon"}
    tp.clear_plan_cache()
    counters = torch._dynamo.utils.counters
    counters.clear()
    port = lambda p, x: fam.apply(p, x, **kw)  # noqa: E731
    fwd = compiled(port)
    got = fwd(params, targs[0])
    assert not counters["graph_break"] and counters["stats"]["unique_graphs"] == 1
    with torch.compiler.set_stance("fail_on_recompile"):
        assert torch.equal(fwd(params, targs[0].clone()), got)
    assert _rel(got, jfwd) <= JAX_TOL
    assert _rel(got, port(params, targs[0])) <= EAGER_TOL
    _assert_no_traced_tensors(*fam.tables)
    if route == "kernel":
        torch._dynamo.reset()        # the plan and table caches are warm now
        assert _rel(compiled(port)(params, targs[0]), got) <= EAGER_TOL


@pytest.mark.parametrize("name,route", CASES, ids=[f"{f}-{r}" for f, r in CASES])
def test_family_step_compiles_whole(name, route):
    """``compile_sgd_step`` of one family's loss on one route (the loss and
    its AOTAutograd backward compiled whole, the update compiled): against
    ``jax.jit`` of the JAX step and the eager port's step on the loss and
    every leaf, twice without a recompile; no traced tensor kept."""
    fam = FAMILIES[name]
    _, params, _, targs = _setup(fam)
    _, jnew, jloss = _jax_run(name)
    kw = _route_kw(fam, route)
    tp.clear_plan_cache()
    counters = torch._dynamo.utils.counters
    counters.clear()
    step = compile_sgd_step(fam.loss, backend="aot_eager")
    new, loss = step(params, *targs, lr=LR, **kw)
    assert not counters["graph_break"] and not loss.requires_grad
    assert abs(float(loss) - jloss) <= JAX_TOL * abs(jloss)
    got = _flatten(new)
    assert set(got) == set(jnew)
    for path in jnew:
        assert fam.leaf_err(got[path], jnew[path]) <= JAX_TOL, path
    if fam.step is None:   # Koopman has no train_step: the eager SGD step on its loss
        eager, eloss = sgd_step(fam.loss, params, *targs, lr=LR, **kw)
    else:
        eager, eloss = fam.step(params, *targs, LR, **kw)
    assert abs(float(loss) - float(eloss)) <= EAGER_TOL * abs(float(eloss))
    for path, e in _flatten(eager).items():
        assert fam.leaf_err(got[path], e) <= EAGER_TOL, path
    with torch.compiler.set_stance("fail_on_recompile"):
        again, _ = step(params, *targs, lr=LR, **kw)
    assert all(np.array_equal(a, got[p]) for p, a in _flatten(again).items())
    _assert_no_traced_tensors(*fam.tables)


def _complex(rng, *shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _sht_cases(rng, grid, config):
    """(port function, JAX function, input) for the SHT ops on ``grid`` at
    L = 16: ``sht`` of a real and of a complex field, ``isht`` to a real and
    to a complex field, ``sphere_grad``."""
    L = 16
    nlat = L if grid == "gauss" else 2 * L
    f, fc = _f32(rng, 2, nlat, 2 * L), _complex(rng, 2, nlat, 2 * L)
    a = np.asarray(jsht.sht(f, grid=grid))
    return [
        (lambda v: tp.sht(v, grid=grid, config=config), lambda v: jsht.sht(v, grid=grid), f),
        (lambda v: tp.sht(v, grid=grid, config=config), lambda v: jsht.sht(v, grid=grid), fc),
        (lambda v: tp.isht(v, real_output=True, grid=grid, config=config),
         lambda v: jsht.isht(v, real_output=True, grid=grid), a),
        (lambda v: tp.isht(v, grid=grid, config=config), lambda v: jsht.isht(v, grid=grid), a),
        (lambda v: tp.sphere_grad(v, grid=grid, config=config),
         lambda v: jsht.sphere_grad(v, grid=grid), f),
    ]


def _tuple(x):
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


def _check_compiled(port, jfn, *args):
    """The compiled ``port`` in one graph, against ``jax.jit(jfn)`` and
    against ``port`` eager, output by output."""
    targs = tuple(torch.from_numpy(np.array(a)) if isinstance(a, np.ndarray) else a
                  for a in args)
    torch._dynamo.reset()
    counters = torch._dynamo.utils.counters
    counters.clear()
    got = _tuple(compiled(port)(*targs))
    assert not counters["graph_break"] and counters["stats"]["unique_graphs"] == 1
    want = _tuple(jax.jit(jfn)(*args))
    eager = _tuple(port(*targs))
    assert len(got) == len(want) == len(eager)
    for g, w, e in zip(got, want, eager):
        assert _rel(g, w) <= JAX_TOL
        assert _rel(g, e) <= EAGER_TOL


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("grid", ["gauss", "equiangular"])
def test_sht_isht_and_sphere_grad_compile_whole(grid, route, case_rng):
    """Each op from a cold table cache; the Legendre chunks (and the
    derivative chunks of ``sphere_grad``) kept on the device by key."""
    for port, jfn, x in _sht_cases(case_rng, grid, ROUTES[route]):
        tp.clear_plan_cache()
        _check_compiled(port, jfn, x)
        _assert_no_traced_tensors("sht_legendre")
    assert ("sht_chunk", "sht_dlegendre", 16, grid, 0, None) in {
        slot[0] for slot in numerics._TABLES}


@pytest.mark.parametrize("route", ROUTES)
def test_melspectrogram_and_pcen_compile_whole(route, case_rng):
    """``melspectrogram`` (the filterbank and window kept by key), ``pcen``
    with per-band tensor coefficients and with its scalar defaults (the
    smoother's block operators kept by key)."""
    config = ROUTES[route]
    x = _f32(case_rng, 2, 3000)
    tp.clear_plan_cache()
    _check_compiled(lambda v: tp.melspectrogram(v, 16000.0, n_fft=256, hop=64, n_mels=20,
                                                config=config),
                    lambda v: jsp.melspectrogram(v, 16000.0, n_fft=256, hop=64, n_mels=20), x)
    _assert_no_traced_tensors("mel.filterbank", "stft.window")
    S = (np.abs(_f32(case_rng, 2, 150, 8)) + 0.1).astype(np.float32)
    per = {k: case_rng.uniform(lo, hi, 8).astype(np.float32) for k, (lo, hi) in dict(
        gain=(0.5, 1.0), bias=(1.0, 3.0), power=(0.3, 0.7), b=(0.01, 0.2)).items()}
    _check_compiled(lambda s, g, b, p, c: tp.pcen(s, gain=g, bias=b, power=p, b=c, config=config),
                    lambda s, g, b, p, c: jsp.pcen(s, gain=g, bias=b, power=p, b=c),
                    S, per["gain"], per["bias"], per["power"], per["b"])
    _check_compiled(lambda s: tp.pcen(s, 16000.0, 128, config=config),
                    lambda s: jsp.pcen(s, 16000.0, 128), S)
    _assert_no_traced_tensors("linear_recurrence")


def test_linear_recurrence_compiles_whole_with_a_host_and_a_device_a(case_rng):
    """A host A (a Python number, as PCEN's fixed smoother passes it) whose
    block operators the host builds while dynamo traces, against the JAX
    ``iir._recurrence_scan``; a device A of per-channel coefficients that
    needs a gradient, its forward and every gradient leaf against the eager
    port (the same ops, traced) and the JAX scan's."""
    c, s0 = _f32(case_rng, 300, 3, 1), _f32(case_rng, 3, 1)
    tp.clear_plan_cache()
    _check_compiled(lambda cc, ss: scan.linear_recurrence(0.95, cc, ss),
                    lambda cc, ss: jiir._recurrence_scan(np.full((1, 1), 0.95), cc, ss), c, s0)
    _assert_no_traced_tensors("linear_recurrence")
    a = case_rng.uniform(0.5, 0.99, 4).astype(np.float32)
    c, s0, w = _f32(case_rng, 300, 2, 4, 1), _f32(case_rng, 2, 4, 1), _f32(case_rng, 300, 2, 4, 1)

    def port(av, cv, sv):
        return (scan.linear_recurrence(av, cv, sv) * torch.from_numpy(w)).sum()

    def ref(av, cv, sv):
        # the diagonal recurrence per channel, one 1 × 1 scan each, as the JAX scan takes it
        out = jnp.stack([jiir._recurrence_scan(av[g].reshape(1, 1), cv[..., g, :], sv[:, g])
                         for g in range(4)], axis=-2)
        return jnp.sum(out * w)

    leaves = [torch.from_numpy(v).requires_grad_(True) for v in (a, c, s0)]
    comp = compiled(port)
    got = comp(*leaves)
    grads = torch.autograd.grad(got, leaves)
    eager = port(*leaves)
    want, jgrads = jax.jit(jax.value_and_grad(ref, argnums=(0, 1, 2)))(a, c, s0)
    assert _rel(got, eager.detach()) <= EAGER_TOL and _rel(got, want) <= JAX_TOL
    for g, e, j in zip(grads, torch.autograd.grad(eager, leaves), jgrads):
        assert _rel(g, e) <= EAGER_TOL
        assert _rel(g, j) <= 1e-4    # back through 300 steps, as the scan's own test holds pcen
    _assert_no_traced_tensors()


def _jax_example(name):
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}",
                                                  ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _quiet(fn, *args, **kw):
    out = io.StringIO()
    with redirect_stdout(out):
        return fn(*args, **kw), out.getvalue()


@pytest.fixture
def aot_eager(monkeypatch):
    """``torch.compile`` as the examples call it, on ``aot_eager`` (no
    compiler for Inductor here)."""
    monkeypatch.setattr(torch, "compile", functools.partial(torch.compile, backend="aot_eager"))


def test_pde_spectral_compiled_against_the_jax_example(aot_eager):
    """The heat step and the Burgers RK4 compiled (``compile=True``) at the
    JAX example's sizes, Burgers bit for bit the eager run here; each
    error against the shared analytic or float64 answer within the JAX
    run's bound, the JAX run's as well: by the triangle bound the port is
    within the sum of the two errors of the JAX example's field."""
    jpde = _jax_example("pde_spectral")
    heat, _ = _quiet(pde_spectral.heat_2d, device="cpu", compile=True)
    jheat, _ = _quiet(jpde.heat_2d)
    assert heat < 1e-5 and jheat < 1e-5
    burgers, _ = _quiet(pde_spectral.burgers_1d, device="cpu", compile=True)
    eager, _ = _quiet(pde_spectral.burgers_1d, device="cpu", compile=False)
    jburgers, _ = _quiet(jpde.burgers_1d)
    assert np.array_equal(burgers["u"], eager["u"])
    assert burgers["err"] + jburgers < 1e-5 and burgers["drift"] < 1e-5


def test_sphere_advection_compiled_against_the_jax_example(aot_eager):
    """The RK4 over ``sphere_grad`` compiled at the JAX example's lmax 31
    and 160 steps: its error against the exact rotation and the JAX run's
    (read from what it prints) sum below 1e-5, so the port is within that of
    the JAX example's field."""
    adv, _ = _quiet(sphere_advection.main, device="cpu", compile=True)
    _, printed = _quiet(_jax_example("sphere_advection").main)
    jerr = float(re.search(r"rel err vs exact rotation: ([0-9.e+-]+)", printed).group(1))
    assert adv["q"].shape == (32, 64) and adv["err"] + jerr < 1e-5
