"""PyTorch port: the main path's configurations under ``torch.compile``,
as the JAX package jits them: the precision modes ("high", "default",
"split6", per-stage tuples) and the 2-byte working dtypes, whose products
carry their precision as operator nodes (``mixed_radix_precision::matmul``
and ``::convolution``, ``utils.numerics.product``/``convolution``).  The
direct convolution, the compensated SHT recurrence and the repairs of the
odd extension and of ``ssq_cwt``'s bin centres are in
``test_torch_compile_precision_ops.py``.

On the CPU with ``backend="aot_eager"``, ``fullgraph=True, dynamic=False``,
at torch's default flags (cuBLAS's reduced-precision reductions and cuDNN's
TF32 on, matmul TF32 off), which every case sets and holds unchanged after
it.  CPU products ignore the flags, so each compiled call equals the eager
port, and it is held to the JAX function under ``jax.jit`` at the bounds
of ``test_torch_precision.py``: fp32 precisions within 1e-5 plus the JAX
result's own error against float64 (split6 4e-6 of the JAX result), bf16
2e-2 (round trips 5e-2), fp16 those over 8.  That the products run in
TF32 where asked shows only on a card (``chip_smoke.py`` phase 32).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mixed_radix_fast_fourier_transform_tpu as jsp
from mixed_radix_fast_fourier_transform_tpu import models as jmodels
from mixed_radix_fast_fourier_transform_tpu import plan as jplan
from mixed_radix_fast_fourier_transform_tpu.ops import stockham as jstock

import mixed_radix_fast_fourier_transform_tpu_torch as tp
from mixed_radix_fast_fourier_transform_tpu_torch import models as tmodels
from mixed_radix_fast_fourier_transform_tpu_torch import plan as tplan
from mixed_radix_fast_fourier_transform_tpu_torch.ops import stockham as tstock
from mixed_radix_fast_fourier_transform_tpu_torch.utils.tree import compile_sgd_step

torch.set_num_threads(1)

TOL = 1e-5
EAGER_TOL = 1e-6
SPLIT6_JAX_TOL = 4e-6       # two CPU libraries' sums of the 6K-deep product
FFT_TOL_BF16, TRIP_TOL_BF16 = 2e-2, 5e-2
UNIT_RATIO = {"bfloat16": 1.0, "float16": 2.0 ** -3}   # fp16's unit roundoff over bf16's
CONFIGS = {
    "high": dict(precision="high"),
    "default": dict(precision="default"),
    "split6": dict(precision="split6"),
    "highest-high": dict(precision=("highest", "high")),
    "bfloat16": dict(dtype=(torch.bfloat16, jnp.bfloat16)),
    "float16": dict(dtype=(torch.float16, jnp.float16)),
}
MATMUL = torch.ops.mixed_radix_precision.matmul.default
CONVOLUTION = torch.ops.mixed_radix_precision.convolution.default


def _flags():
    mm, dnn = torch.backends.cuda.matmul, torch.backends.cudnn
    return (mm.allow_tf32, dnn.allow_tf32, mm.allow_bf16_reduced_precision_reduction,
            mm.allow_fp16_reduced_precision_reduction, torch.get_float32_matmul_precision())


DEFAULT_FLAGS = (False, True, True, True, "highest")


@pytest.fixture(autouse=True)
def default_flags():
    """torch's default flags for each case, held unchanged by it; dynamo
    reset around it."""
    mm, dnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = _flags()
    (mm.allow_tf32, dnn.allow_tf32, mm.allow_bf16_reduced_precision_reduction,
     mm.allow_fp16_reduced_precision_reduction) = DEFAULT_FLAGS[:4]
    torch._dynamo.reset()
    try:
        yield
        assert _flags() == DEFAULT_FLAGS
    finally:
        torch._dynamo.reset()
        (mm.allow_tf32, dnn.allow_tf32, mm.allow_bf16_reduced_precision_reduction,
         mm.allow_fp16_reduced_precision_reduction) = saved[:4]


@pytest.fixture
def case_rng(request):
    """A generator made for one test case from its name."""
    return np.random.default_rng([ord(ch) for ch in request.node.name])


def _np(v):
    if isinstance(v, torch.Tensor):
        v = v.detach()
        return (v.float() if v.dtype in (torch.bfloat16, torch.float16) else v).numpy()
    return np.asarray(v, dtype=np.complex128 if np.iscomplexobj(v) else np.float64)


def _rel(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def compiled(fn):
    return torch.compile(fn, backend="aot_eager", fullgraph=True, dynamic=False)


def _whole(fn, *args):
    """``fn`` compiled and called: asserts one graph and no break, and
    returns the result and the compiled function."""
    counters = torch._dynamo.utils.counters
    counters.clear()
    comp = compiled(fn)
    out = comp(*args)
    assert sum(counters["graph_break"].values()) == 0, dict(counters["graph_break"])
    assert counters["stats"]["unique_graphs"] == 1
    return out, comp


def _graph_targets(fn, *args) -> set:
    """The call targets of the graph that dynamo captures of ``fn``."""
    seen = set()

    def backend(gm, example_inputs):
        seen.update(str(node.target) for node in gm.graph.nodes)
        return gm.forward

    torch.compile(fn, backend=backend, fullgraph=True, dynamic=False)(*args)
    return seen


# ---------------------------------------------------------------------------
# The engine at the JAX tests' configurations


# tests/test_fft.py's two jitted exec_complex calls: (n, precision, rows,
# seed, the JAX test's own bound against numpy float64)
ENGINE = [(360, ("highest", "high"), 4, 5, 1e-4), (1024, "split6", 2, 6, 5e-6)]


@pytest.mark.parametrize("n,precision,rows,seed,tol", ENGINE,
                         ids=["360-highest-high", "1024-split6"])
def test_exec_complex_at_the_jax_tests_configurations(n, precision, rows, seed, tol):
    """``exec_complex`` on the JAX test's plan (same factors, same
    precision), compiled whole with no break, against ``jax.jit`` of the
    JAX function and numpy float64 at that test's bound, and the eager
    port at 1e-6."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, n)) + 1j * rng.standard_normal((rows, n))
    xr, xi = x.real.astype(np.float32), x.imag.astype(np.float32)
    jp = jplan.build_complex_plan(n, -1, dataclasses.replace(jsp.SpectralConfig(),
                                                             precision=precision))
    p = tplan.get_plan(n, -1, "complex", tp.SpectralConfig(precision=precision))
    assert p.factors == jp.factors and p.precision == jp.precision
    tr, ti = torch.from_numpy(xr), torch.from_numpy(xi)
    (gr, gi), _ = _whole(lambda a, c: tstock.exec_complex(p, a, c), tr, ti)
    got = gr.numpy() + 1j * gi.numpy()
    jr, ji = jax.jit(lambda a, c: jstock.exec_complex(jp, a, c))(xr, xi)
    want = np.asarray(jr) + 1j * np.asarray(ji)
    er, ei = tstock.exec_complex(p, tr, ti)
    assert _rel(got, want) <= tol
    assert _rel(got, np.fft.fft(x)) <= tol
    assert _rel(got, er.numpy() + 1j * ei.numpy()) <= EAGER_TOL


# ---------------------------------------------------------------------------
# The main path at every precision and 2-byte dtype


def _configs(name):
    kw = CONFIGS[name]
    if "dtype" in kw:
        tdt, jdt = kw["dtype"]
        return tp.SpectralConfig(dtype=tdt), jsp.SpectralConfig(dtype=jdt)
    return tp.SpectralConfig(**kw), jsp.SpectralConfig(**kw)


def _main_path(pkg, models, config):
    """fft, rfft and its inverse, fft_convolve and the spectral filter's
    forward, in one function of either package (Bluestein and its inner
    pipeline compile at each precision in ``test_torch_compile.py``)."""
    def run(x, r, s, taps, params):
        spec = pkg.rfft(r, config=config)
        return (pkg.fft(x, config=config), spec,
                pkg.irfft(spec, n=r.shape[-1], config=config),
                pkg.fft_convolve(s, taps[None], config=config),
                models.apply(params, r, config=config))
    return run


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_main_path_compiles_at_every_precision_and_dtype(case_rng, name):
    """``fft``, ``rfft``/``irfft``, ``fft_convolve`` and the filter forward
    compile whole at torch's default flags, equal the eager port, and match
    the JAX functions under ``jax.jit`` at ``test_torch_precision.py``'s
    bounds."""
    tcfg, jcfg = _configs(name)
    x = (case_rng.standard_normal((2, 360))
         + 1j * case_rng.standard_normal((2, 360))).astype(np.complex64)
    r = case_rng.standard_normal((2, 64)).astype(np.float32)
    s = case_rng.standard_normal((2, 60)).astype(np.float32)
    taps = case_rng.standard_normal(5).astype(np.float32)
    params = {"gain_re": (1.0 + 0.1 * case_rng.standard_normal(33)).astype(np.float32),
              "gain_im": (0.1 * case_rng.standard_normal(33)).astype(np.float32),
              "bias": np.float32(0.05)}
    args = [torch.from_numpy(v) for v in (x, r, s, taps)]
    tparams = tmodels.params_from_jax(params, "cpu")
    got, comp = _whole(_main_path(tp, tmodels, tcfg), *args, tparams)
    with torch.compiler.set_stance("fail_on_recompile"):
        again = comp(*(a.clone() for a in args), tparams)
    eager = _main_path(tp, tmodels, tcfg)(*args, tparams)
    want = jax.tree_util.tree_map(np.asarray, jax.jit(_main_path(jsp, jmodels, jcfg))(
        x, r, s, taps, params))
    oracle = (np.fft.fft(x.astype(np.complex128)), np.fft.rfft(r.astype(np.float64)),
              r.astype(np.float64),
              np.stack([np.convolve(v, taps.astype(np.float64)) for v in s.astype(np.float64)]),
              np.fft.irfft(np.fft.rfft(r.astype(np.float64))
                           * (params["gain_re"] + 1j * params["gain_im"]), n=64) + 0.05)
    half = name in UNIT_RATIO
    for i, (g, a, e, w, o) in enumerate(zip(got, again, eager, want, oracle)):
        assert torch.equal(g, a), i
        assert _rel(g, e) <= EAGER_TOL, i
        if half:
            bound = (TRIP_TOL_BF16 if i in (2, 4) else FFT_TOL_BF16) * UNIT_RATIO[name]
            assert _rel(g, w) <= bound, (i, _rel(g, w))
        elif name == "split6" and i == 0:
            assert _rel(g, w) <= SPLIT6_JAX_TOL
        else:
            assert _rel(g, w) <= TOL + _rel(w, o), (i, _rel(g, w), _rel(w, o))


def test_train_step_compiles_at_a_per_stage_precision():
    """``compile_sgd_step`` of the filter at ("highest", "high") on the
    stage pipeline: the loss through the operator nodes, its gradient
    through their autograd formula (plain products), two steps against the
    eager step and ``jax.jit(train_step)``."""
    precision = ("highest", "high")
    tcfg = tp.SpectralConfig(precision=precision, use_kernel=False)
    jcfg = jsp.SpectralConfig(precision=precision)
    rng = np.random.default_rng(11)
    params = {"gain_re": (1.0 + 0.01 * rng.standard_normal(181)).astype(np.float32),
              "gain_im": (0.01 * rng.standard_normal(181)).astype(np.float32),
              "bias": np.float32(0.05)}
    x, target = (rng.standard_normal((4, 360)).astype(np.float32) for _ in range(2))
    step = compile_sgd_step(tmodels.loss_fn, backend="aot_eager")
    jstep = jax.jit(lambda p, a, b: jmodels.train_step(p, a, b, config=jcfg))
    tparams, jparams = tmodels.params_from_jax(params, "cpu"), params
    xt, tt = torch.from_numpy(x), torch.from_numpy(target)
    for _ in range(2):
        jparams, jloss = jstep(jparams, x, target)
        eager, eloss = tmodels.train_step(tparams, xt, tt, config=tcfg)
        tparams, loss = step(tparams, xt, tt, lr=1e-2, config=tcfg)
        assert abs(float(loss) - float(eloss)) <= EAGER_TOL * abs(float(eloss))
        assert abs(float(loss) - float(jloss)) <= TOL * abs(float(jloss))
        for k in jparams:
            assert _rel(tparams[k], eager[k]) <= EAGER_TOL, k
            assert _rel(tparams[k], jparams[k]) <= TOL, k


def test_graph_holds_the_operator_where_the_precision_needs_it():
    """The captured graph holds ``mixed_radix_precision::matmul`` for a
    precision other than "highest" and for 2-byte planes, and none for fp32
    "highest", whose products stay plain matmuls."""
    x = torch.randn(2, 360, dtype=torch.complex64, generator=torch.Generator().manual_seed(2))
    name = "mixed_radix_precision.matmul"
    for config, holds in ((tp.SpectralConfig(precision="high"), True),
                          (tp.SpectralConfig(precision="split6"), True),
                          (tp.SpectralConfig(dtype=torch.bfloat16), True),
                          (tp.SpectralConfig(), False)):
        torch._dynamo.reset()
        targets = _graph_targets(lambda v: tp.fft(v, config=config), x)
        assert any(name in t for t in targets) is holds, config


# ---------------------------------------------------------------------------
# The operators


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16, torch.complex64],
                         ids=str)
def test_operators_pass_opcheck(dtype):
    """The schema, fake, autograd registration and AOTAutograd's view of
    the product (both operand orders the engine uses, a broadcast batch)
    and of the convolution, on operands that need a gradient."""
    g = torch.Generator().manual_seed(3)

    def leaf(*shape):
        return torch.randn(*shape, generator=g).to(dtype).requires_grad_(True)

    torch.library.opcheck(MATMUL, (leaf(3, 5, 6), leaf(6, 4), "high"))
    if dtype is torch.float32:
        torch.library.opcheck(MATMUL, (leaf(4, 5), leaf(2, 5, 3), "highest"))
        torch.library.opcheck(CONVOLUTION, (leaf(2, 3, 40), leaf(3, 1, 5), [1], [4], [1], 3,
                                            "highest"))
        torch.library.opcheck(CONVOLUTION, (leaf(1, 2, 12, 10), leaf(2, 1, 3, 4), [2, 1], [0, 0],
                                            [1, 2], 2, "default"))


@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128], ids=str)
def test_product_gradient_is_the_matmuls(dtype):
    """The product operator's gradient passes ``gradcheck`` against finite
    differences (for complex operands the conjugate transposes of
    torch.matmul's own rule), and equals torch.matmul's on a real loss."""
    g = torch.Generator().manual_seed(4)
    a = torch.randn(3, 5, 6, dtype=dtype, generator=g).requires_grad_(True)
    b = torch.randn(6, 4, dtype=dtype, generator=g).requires_grad_(True)
    assert torch.autograd.gradcheck(lambda u, v: MATMUL(u, v, "high"), (a, b))
    w = torch.randn(3, 5, 4, dtype=dtype, generator=g)
    got, want = (torch.autograd.grad((mm(a, b) * w.conj()).real.sum(), (a, b))
                 for mm in (lambda u, v: MATMUL(u, v, "high"), torch.matmul))
    for u, v in zip(got, want):
        assert torch.allclose(u, v, rtol=1e-12, atol=1e-12)


def test_operator_sets_its_flags_and_restores_them(monkeypatch):
    """Inside the operator the flags are its precision's (TF32 on for
    "high", off for "highest"; reductions off for 2-byte operands); after
    it, and after a product that raises, they are the caller's."""
    seen, matmul = [], torch.matmul

    def spy(a, b):
        seen.append(_flags()[:4])
        return matmul(a, b)

    monkeypatch.setattr(torch, "matmul", spy)
    a, b = torch.randn(4, 3), torch.randn(3, 2)
    for precision, dtype, inside in (("high", torch.float32, (True, True, True, True)),
                                     ("highest", torch.float32, (False, False, True, True)),
                                     ("default", torch.bfloat16, (True, True, False, False))):
        seen.clear()
        MATMUL(a.to(dtype), b.to(dtype), precision)
        assert seen == [inside] and _flags() == DEFAULT_FLAGS
    with pytest.raises(RuntimeError):
        MATMUL(torch.randn(4, 3), torch.randn(2, 2), "high")
    assert _flags() == DEFAULT_FLAGS
    with pytest.raises(ValueError, match="precision"):
        MATMUL(a, b, "split6")
