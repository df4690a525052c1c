"""PyTorch port: the compiled path, ``torch.compile`` and ``torch.export``
through the main path, as the JAX package runs it under ``jax.jit``.

On the CPU with ``backend="aot_eager"`` (AOTAutograd's graphs run as they
are: no ``triton``, no C++ compiler), ``fullgraph=True, dynamic=False``:
the fused kernel's operator (its CPU implementation, the kernel's plain
version) and the stage pipeline compile whole, match the JAX functions
under ``jax.jit`` and the eager port, and compile again from a cold plan
cache.  The tables a trace uploads are never kept in a cache.
"""

import io

import jax
import numpy as np
import pytest
import torch

import mixed_radix_fast_fourier_transform_tpu as jsp
from mixed_radix_fast_fourier_transform_tpu import models as jmodels
from mixed_radix_fast_fourier_transform_tpu.models import fno as jfno

import mixed_radix_fast_fourier_transform_tpu_torch as tp
from mixed_radix_fast_fourier_transform_tpu_torch import models as tmodels
from mixed_radix_fast_fourier_transform_tpu_torch import plan as tplan
from mixed_radix_fast_fourier_transform_tpu_torch.models import fno as tfno
from mixed_radix_fast_fourier_transform_tpu_torch.ops import cuda_fft
from mixed_radix_fast_fourier_transform_tpu_torch.utils import aot, numerics
from mixed_radix_fast_fourier_transform_tpu_torch.utils.tree import compile_sgd_step, tree_leaves

torch.set_num_threads(1)

JAX_TOL = 1e-5     # max |got − want| / max |want| against the JAX function
EAGER_TOL = 1e-6   # against the eager port: the same ops, traced
ROUTES = {"kernel": tp.SpectralConfig(use_kernel=True),
          "pipeline": tp.SpectralConfig(use_kernel=False)}
# (n, route): K1 lengths through the operator's CPU implementation,
# Bluestein, and a mixed-radix length on the stage pipeline
LENGTHS = [(2048, "kernel"), (5040, "kernel"), (1009, "pipeline"), (1024, "pipeline")]
OPS = ["fft", "ifft", "rfft", "irfft", "fft_convolve"]
TAPS = 65


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def compiled(fn):
    return torch.compile(fn, backend="aot_eager", fullgraph=True, dynamic=False)


@pytest.fixture(autouse=True)
def fresh_dynamo():
    torch._dynamo.reset()
    yield
    torch._dynamo.reset()


def _assert_no_traced_tensors():
    """Every tensor in the plan, table and launch caches is a plain one
    (no fake, functional or traced tensor outlives a trace)."""
    kept = [t for plan in tplan._CACHE.values() for consts in plan._device.values()
            for v in consts.values() for t in (v if isinstance(v, tuple) else (v,))]
    kept += list(numerics._TABLES.values())
    kept += [r.tw for r in cuda_fft._READY.values()]
    assert all(type(t) is torch.Tensor for t in kept), {type(t) for t in kept}


def _case(op, n, seed):
    """(port function, JAX function, input) for one op at length n."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((4, n)) + 1j * rng.standard_normal((4, n))).astype(np.complex64)
    real = x.real.copy()
    if op == "fft":
        return (lambda v, c: tp.fft(v, config=c)), jsp.fft, x
    if op == "ifft":
        return (lambda v, c: tp.ifft(v, config=c)), jsp.ifft, x
    if op == "rfft":
        return (lambda v, c: tp.rfft(v, config=c)), jsp.rfft, real
    if op == "irfft":
        half = np.ascontiguousarray(x[:, : n // 2 + 1])
        return ((lambda v, c: tp.irfft(v, n=n, config=c)),
                (lambda v: jsp.irfft(v, n=n)), half)
    return ((lambda v, c: tp.fft_convolve(v, v[..., :TAPS], config=c)),
            (lambda v: jsp.fft_convolve(v, v[..., :TAPS])), real)


@pytest.mark.parametrize("n,route", LENGTHS, ids=[f"{n}-{r}" for n, r in LENGTHS])
@pytest.mark.parametrize("op", OPS)
def test_main_path_compiles_whole(op, n, route):
    """Zero graph breaks (fullgraph, one graph), no recompile on a second
    call, the JAX function under jax.jit and the eager port matched, from
    a cold plan cache (and for ``fft``, at every length, again from a warm
    one)."""
    fn, jfn, x = _case(op, n, n + OPS.index(op))
    config = ROUTES[route]
    port = lambda v: fn(v, config)  # noqa: E731
    xt = torch.from_numpy(x)
    tp.clear_plan_cache()
    counters = torch._dynamo.utils.counters
    counters.clear()
    comp = compiled(port)
    got = comp(xt)
    assert not counters["graph_break"] and counters["stats"]["unique_graphs"] == 1
    with torch.compiler.set_stance("fail_on_recompile"):
        again = comp(xt.clone())
    assert torch.equal(got, again)
    eager = port(xt)
    assert _rel(got.numpy(), eager.numpy()) <= EAGER_TOL
    assert _rel(got.numpy(), np.asarray(jax.jit(jfn)(x))) <= JAX_TOL
    _assert_no_traced_tensors()
    if op == "fft":
        torch._dynamo.reset()          # the plan cache is warm now
        warm = compiled(port)(xt)
        assert _rel(warm.numpy(), eager.numpy()) <= EAGER_TOL
        _assert_no_traced_tensors()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("sign", [-1, 1])
def test_operator_passes_opcheck(dtype, sign):
    """The schema, the fake and autograd registrations and AOTAutograd's
    view of the operator, on planes that need a gradient."""
    gen = torch.Generator().manual_seed(3 + sign)
    xr, xi = (torch.randn(3, 90, generator=gen).to(dtype).requires_grad_(True)
              for _ in range(2))
    torch.library.opcheck(torch.ops.mixed_radix_fft.stockham_fft.default, (xr, xi, 90, sign))


def _filter_case(n, batch, seed):
    rng = np.random.default_rng(seed)
    params = {
        "gain_re": (1.0 + 0.01 * rng.standard_normal(n // 2 + 1)).astype(np.float32),
        "gain_im": (0.01 * rng.standard_normal(n // 2 + 1)).astype(np.float32),
        "bias": np.float32(0.05),
    }
    x = rng.standard_normal((batch, n)).astype(np.float32)
    target = rng.standard_normal((batch, n)).astype(np.float32)
    return params, x, target


@pytest.mark.parametrize("route", ["kernel", "pipeline"])
def test_spectral_filter_forward_and_step_compiled_match_jax(route):
    """The flagship model at the JAX entry's width (n = 4096, batch 8): the
    forward compiled whole, and ``compile_sgd_step`` (loss and update
    compiled, the gradient between them) against ``jax.jit(train_step)``,
    two steps, without a recompile."""
    config = ROUTES[route]
    params, x, target = _filter_case(4096, 8, 11)
    tparams = tmodels.params_from_jax(params, "cpu")
    xt, tt = torch.from_numpy(x), torch.from_numpy(target)
    fwd = compiled(lambda p, v: tmodels.apply(p, v, config=config))
    got = fwd(tparams, xt)
    with torch.compiler.set_stance("fail_on_recompile"):
        assert torch.equal(fwd(tparams, xt.clone()), got)
    assert _rel(got.numpy(), np.asarray(jax.jit(jmodels.apply)(params, x))) <= JAX_TOL
    assert _rel(got.numpy(), tmodels.apply(tparams, xt, config=config).numpy()) <= EAGER_TOL
    step = compile_sgd_step(tmodels.loss_fn, backend="aot_eager")
    jstep = jax.jit(jmodels.train_step)
    jp, tp_ = params, tparams
    for i in range(2):
        jp, jloss = jstep(jp, x, target)
        eager, eloss = tmodels.train_step(tp_, xt, tt, config=config)
        with torch.compiler.set_stance("fail_on_recompile" if i else "default"):
            tp_, loss = step(tp_, xt, tt, lr=1e-2, config=config)
        assert not loss.requires_grad and not any(v.requires_grad for v in tp_.values())
        assert abs(float(loss) - float(jloss)) <= JAX_TOL * abs(float(jloss))
        assert abs(float(loss) - float(eloss)) <= EAGER_TOL * abs(float(eloss))
        for k in jp:
            assert _rel(tp_[k].numpy(), jp[k]) <= JAX_TOL, k
            assert _rel(tp_[k].numpy(), eager[k].numpy()) <= EAGER_TOL, k
    _assert_no_traced_tensors()


@pytest.mark.parametrize("route", ["kernel", "pipeline"])
def test_fno_train_step_compiled_matches_jax(route):
    """The 1-D FNO at the JAX test's widths (1 → 8 → 1 channels, one layer,
    8 modes, 8 × 64) stepped by ``compile_sgd_step`` against
    ``jax.jit(fno.train_step)``, and again without a recompile."""
    config = ROUTES[route]
    jparams = jfno.init_fno(jax.random.PRNGKey(0), 1, 8, 1, n_layers=1, modes=8)
    x = np.random.default_rng(5).standard_normal((8, 1, 64)).astype(np.float32)
    jnew, jloss = jax.jit(jfno.train_step)(jparams, x, x, 3e-2)
    params = tfno.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    step = compile_sgd_step(tfno.loss_fn, backend="aot_eager")
    xt = torch.from_numpy(x)
    new, loss = step(params, xt, xt, lr=3e-2, config=config)
    assert abs(float(loss) - float(jloss)) <= JAX_TOL * abs(float(jloss))
    for got, want in zip(tree_leaves(new), jax.tree_util.tree_leaves(jnew)):
        assert _rel(got.numpy(), want) <= JAX_TOL
    eager, _ = tfno.train_step(params, xt, xt, 3e-2, config=config)
    for got, want in zip(tree_leaves(new), tree_leaves(eager)):
        assert _rel(got.numpy(), want.numpy()) <= EAGER_TOL
    with torch.compiler.set_stance("fail_on_recompile"):
        again, _ = step(params, xt, xt, lr=3e-2, config=config)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(again), tree_leaves(new)))


def test_export_holds_the_kernel_operator_and_reloads():
    """``use_kernel=True``: the exported graph holds the operator node (no
    silent fall back to the stage pipeline), and the reloaded program
    matches the JAX ``fft``."""
    x = _case("fft", 2048, 1)[2]
    tp.clear_plan_cache()
    blob = aot.export_transform(lambda v: tp.fft(v, config=ROUTES["kernel"]), torch.from_numpy(x))
    targets = [str(node.target) for node in torch.export.load(io.BytesIO(blob)).graph.nodes]
    assert "mixed_radix_fft.stockham_fft.default" in targets
    _assert_no_traced_tensors()
    other = _case("fft", 2048, 2)[2]
    got = aot.load_transform(blob)(torch.from_numpy(other))
    assert _rel(got.numpy(), np.asarray(jsp.fft(other))) <= JAX_TOL


def test_export_keeps_no_traced_table():
    """A keyed table first made while torch.export traces is the trace's
    and is not kept; an eager call then keeps a plain tensor."""
    key = ("test_export_keeps_no_traced_table",)
    values = np.linspace(0.0, 1.0, 16)
    numerics.clear_constants()

    class Scale(torch.nn.Module):
        def forward(self, v):
            return v * numerics.constant(values, v, key=key)

    torch.export.export(Scale(), (torch.ones(2, 16),))
    assert not any(slot[0] == key for slot in numerics._TABLES)
    eager = numerics.constant(values, torch.ones(1), key=key)
    assert type(eager) is torch.Tensor and numerics._TABLES[(key, eager.device, eager.dtype)] is eager


def test_aot_compile_runs_an_op_outside_the_slice_that_traces():
    """The AFNO forward (no fused kernel on its path) traces whole, so
    ``aot_compile`` compiles it, and its calls match the eager forward."""
    from mixed_radix_fast_fourier_transform_tpu_torch.models import afno

    params = afno.init_afno(2, 16, 2, n_layers=1, device="cpu",
                            generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 16, 16, 2)).astype(np.float32))
    fn = aot.aot_compile(lambda v: afno.apply(params, v), x)
    assert _rel(fn(x).detach().numpy(), afno.apply(params, x).detach().numpy()) <= EAGER_TOL


def test_aot_compile_compiles_a_jax_jitted_op():
    """``sosfiltfilt``, one of the ops the JAX package's tests jit, traces
    whole (its design made on the host): ``aot_compile`` compiles it, and
    its calls match the eager op."""
    import scipy.signal

    sos = scipy.signal.ellip(8, 0.5, 60, [0.2, 0.6], "bandpass", output="sos")
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((2, 1024)).astype(np.float32))
    fn = aot.aot_compile(lambda v: tp.sosfiltfilt(sos, v), x)
    assert _rel(fn(x).numpy(), tp.sosfiltfilt(sos, x).numpy()) <= EAGER_TOL


def test_aot_compile_names_the_slice_for_an_op_that_does_not_trace():
    """``emd`` does not trace whole (its sifting runs on the host, as the
    JAX function's does; ``fht`` and ``vmd``, once the cases here, trace
    since their tables are host builds and ``vmd``'s sweeps a loop
    operator): ``aot_compile`` raises a ValueError that says what the
    compiled path covers."""
    a = torch.from_numpy(np.random.default_rng(4).standard_normal(64).astype(np.float32))
    with pytest.raises(ValueError, match="compiled path covers fft, ifft, rfft"):
        aot.aot_compile(lambda u: tp.emd(u)[0], a)


def test_aot_compile_compiles_the_direct_convolution():
    """The direct convolution traces whole since its axis order is inverted
    in Python: ``aot_compile`` compiles it, and its calls match the eager
    op."""
    rng = np.random.default_rng(4)
    a, k = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in ((4, 200), (4, 31)))
    fn = aot.aot_compile(lambda u, v: tp.convolve(u, v, method="direct"), a, k)
    assert torch.equal(fn(a, k), tp.convolve(a, k, method="direct"))


def test_error_free_transforms_stay_eager():
    """The two-sum/two-product chains are marked eager: a ``fullgraph``
    caller refuses them, and any other compiled caller breaks its graph
    there and runs them bit-equal to eager (no product contracted into a
    fused multiply-add)."""
    rng = np.random.default_rng(5)
    a, b = (torch.from_numpy(rng.standard_normal(64).astype(np.float32)) for _ in range(2))
    for fn in (numerics.two_sum, numerics.two_prod, numerics.dw_mul):
        args = (a, b) if fn is not numerics.dw_mul else (a, b * 1e-8, b, a * 1e-8)

        def caller(*v):
            return fn(*v)

        torch._dynamo.reset()
        with pytest.raises(torch._dynamo.exc.Unsupported, match="compiler.disable"):
            compiled(caller)(*args)
        got = torch.compile(caller, backend="aot_eager")(*args)
        assert all(torch.equal(g, w) for g, w in zip(got, fn(*args)))


@pytest.mark.parametrize("dtype", [None, torch.float32, torch.bfloat16], ids=str)
def test_reduction_flags_are_checked_for_two_byte_operands_only(dtype):
    """Under a trace the caller's reduced-precision reduction flags (on by
    default in torch) matter only for a site that names 2-byte operands:
    an unnamed (None) or fp32 site compiles, a bf16 one refuses."""
    mm = torch.backends.cuda.matmul
    saved = mm.allow_bf16_reduced_precision_reduction
    a = torch.randn(4, 4, generator=torch.Generator().manual_seed(6))

    def product(u):
        with numerics.matmul_precision("highest", dtype):
            return u @ u

    try:
        mm.allow_bf16_reduced_precision_reduction = True
        if dtype is torch.bfloat16:
            with pytest.raises(Exception, match="ValueError: .*reduced-precision reductions"):
                compiled(product)(a)
        else:
            assert torch.equal(compiled(product)(a), a @ a)
        assert mm.allow_bf16_reduced_precision_reduction is True
    finally:
        mm.allow_bf16_reduced_precision_reduction = saved


PRECISIONS_REFUSED = ["high", "default", "split6", ("highest", "high")]


@pytest.mark.parametrize("precision", PRECISIONS_REFUSED, ids=str)
def test_other_precisions_refuse_to_compile(precision):
    """The precisions whose products need other flags than the caller's
    (refused under a trace until their products carried their precision)
    now compile on the main path at torch's default flags: ``fft`` through
    Bluestein (n = 1009) and its inner stage pipeline, whose products are
    operator nodes that set their own flags, one graph, the eager values."""
    config = tp.SpectralConfig(precision=precision, use_kernel=False)
    x = torch.randn(2, 1009, dtype=torch.complex64, generator=torch.Generator().manual_seed(0))
    counters = torch._dynamo.utils.counters
    counters.clear()
    got = compiled(lambda v: tp.fft(v, config=config))(x)
    assert sum(counters["graph_break"].values()) == 0
    assert counters["stats"]["unique_graphs"] == 1
    assert _rel(got.numpy(), tp.fft(x, config=config).numpy()) <= EAGER_TOL


@pytest.mark.parametrize("op", ["sht", "multitaper"])
def test_a_site_without_the_operator_still_refuses(op):
    """A product outside the engine, the convolutions and the sites routed
    through ``utils.numerics.product`` (the SHT's Legendre products,
    ``multitaper``'s taper product) still runs in a plain precision block:
    under a trace a precision other than "highest" stops it with the port's
    ValueError naming the field and the site.  (The dense NUFFT's and the
    mel filterbank's products, once the second case here, carry their
    precision since they go through ``product``:
    ``test_torch_compile_ops_transforms.py`` and
    ``test_torch_compile_ops_loops.py`` compile them at "high".)"""
    config = tp.SpectralConfig(precision="high")
    g = torch.Generator().manual_seed(7)
    if op == "sht":
        args, fn = (torch.randn(2, 8, 16, generator=g),), (lambda f: tp.sht(f, config=config))
    else:
        args = (torch.randn(2, 1024, generator=g),)
        fn = lambda x: tp.multitaper(x, fs=10.0, weighting="unity", k=4, config=config)  # noqa: E731
    with pytest.raises(Exception, match=r"ValueError: SpectralConfig\.precision='high' cannot be "
                                        r"compiled at this site"):
        compiled(fn)(*args)


def test_flags_are_checked_not_written_while_tracing(monkeypatch):
    """No backend flag is written while a trace runs: the eager block that
    sets them is never entered (any entry fails here), and caller flags
    that would run "highest" in TF32 stop the trace instead."""

    class Refuse:
        def __init__(self, *args):
            raise AssertionError("a precision block set flags while tracing")

    monkeypatch.setattr(numerics, "_Flags", Refuse)
    x = torch.randn(2, 1024, dtype=torch.complex64, generator=torch.Generator().manual_seed(1))
    got = compiled(lambda v: tp.fft(v, config=ROUTES["pipeline"]))(x)
    monkeypatch.undo()
    assert _rel(got.numpy(), tp.fft(x, config=ROUTES["pipeline"]).numpy()) <= EAGER_TOL
    mm = torch.backends.cuda.matmul
    saved = mm.allow_tf32
    try:
        mm.allow_tf32 = True
        torch._dynamo.reset()
        with pytest.raises(Exception, match="ValueError: .*TF32"):
            compiled(lambda v: tp.fft(v, config=ROUTES["pipeline"]))(x)
        assert mm.allow_tf32 is True
    finally:
        mm.allow_tf32 = saved
