"""PyTorch port: the reduced-precision modes, ``SpectralConfig.precision``
and the 2-byte working dtypes (``torch.bfloat16``, ``torch.float16``).

Precision.  The plans carry the JAX plans' precision (one name, or a tuple
of per-stage names), and each precision is its own cache entry.  On the CPU
"highest", "high" and "default" are fp32 in both packages, so the port is
held to the JAX result within 1e-5 plus the JAX result's own error against
float64 (the triangle bound).  "split6" is held to numpy float64 at 5e-6
(the JAX test's bound) and to the JAX result (under ``jax.jit``: eagerly,
XLA:CPU refuses the bf16 x bf16 = f32 product) at 4e-6, and its chunks
are bit-equal to the JAX module's.  ``op_precision`` resolves as the JAX
config's, and the ops outside the stage pipeline run under every scheme.
The precision helper sets and restores torch's TF32 flags.

2-byte dtypes.  ``fft``, the real round trip, ``fftn``, ``fft_convolve``,
``dct`` and ``stft`` at bf16 and fp16 are held to float64 at the JAX test's
bounds (2e-2, the round trip 5e-2) for bf16, and at those bounds over 8 (the
ratio of the two unit roundoffs, 2^-8 / 2^-11) for fp16, and to the JAX
function at the same dtype under ``jax.jit`` at the same bounds; complex
results are complex64.  Every op case of ``test_torch_dtype_ops.py`` runs
at both dtypes against its float64 oracle within 64 unit roundoffs of the
dtype, relative to the oracle's largest value, or raises a ValueError
naming the dtype where the JAX function raises (``lombscargle`` at bf16,
checked in both packages).  The kernel's plain version at 2-byte planes
is held to float64 and to the stage pipeline.

Inputs come from a generator made per case from its name.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mixed_radix_fast_fourier_transform_tpu as jsp
from mixed_radix_fast_fourier_transform_tpu import plan as jplan
from mixed_radix_fast_fourier_transform_tpu.ops import stockham as jstock

import mixed_radix_fast_fourier_transform_tpu_torch as tp
from mixed_radix_fast_fourier_transform_tpu_torch import plan as tplan
from mixed_radix_fast_fourier_transform_tpu_torch.ops import cuda_fft, stockham as tstock
from mixed_radix_fast_fourier_transform_tpu_torch.utils import numerics

import test_torch_dtype_ops as dtype_ops

TOL = 1e-5
SPLIT6_TOL = 5e-6        # split6 against float64, the JAX test's bound
# the port's split6 against the JAX module's: both sum the 6K-deep chunk
# product in fp32, in the orders of two CPU libraries (oneDNN, Eigen), which
# alone put them up to 1.9e-6 apart at n = 1009 (their fp32 "highest"
# results 7e-7 apart); the pair is held to twice that
SPLIT6_JAX_TOL = 4e-6
PRECISIONS = ["highest", "HIGH", "default", "split6", ("highest", "high")]
HALF = {"bfloat16": (torch.bfloat16, jnp.bfloat16, 2.0 ** -8),
        "float16": (torch.float16, jnp.float16, 2.0 ** -11)}
# the JAX test's bf16 bounds (tests/test_dtypes_errors.py), scaled by the
# dtype's unit roundoff over bf16's
FFT_TOL_BF16, ROUND_TRIP_TOL_BF16 = 2e-2, 5e-2
OPS_UNITS = 64           # the op cases: unit roundoffs of the dtype


@pytest.fixture
def case_rng(request):
    """A generator made for one test case from its name."""
    return np.random.default_rng([ord(ch) for ch in request.node.name])


def _rel(got, want):
    got = _np(got)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _np(v):
    """A result as a numpy array; 2-byte tensors widened to fp32 (numpy has
    no bf16)."""
    if isinstance(v, torch.Tensor):
        v = v.detach()
        return (v.float() if v.dtype in (torch.bfloat16, torch.float16) else v).numpy()
    return np.asarray(v)


def _bounds(name):
    scale = HALF[name][2] / HALF["bfloat16"][2]
    return FFT_TOL_BF16 * scale, ROUND_TRIP_TOL_BF16 * scale


# ---------------------------------------------------------------------------
# Precision


@pytest.mark.parametrize("n", [360, 1024, 1009, 5040])
def test_plan_precision_is_the_jax_plans(n):
    keys = set()
    for prec in PRECISIONS + [("default",), ("high", "highest", "default")]:
        jp = jplan.build_complex_plan(n, -1, jsp.SpectralConfig(precision=prec))
        cfg = tp.SpectralConfig(precision=prec)
        p = tplan.get_plan(n, -1, "complex", cfg)
        jp, p = getattr(jp, "inner", jp), getattr(p, "inner", p)
        assert p.precision == jp.precision == tplan._precision_str(prec)
        assert p.factors == jp.factors
        keys.add(tplan._cfg_key(cfg))
    assert len(keys) == len(PRECISIONS) + 2


def _jax_fft(x, cfg):
    return np.asarray(jax.jit(lambda v: jsp.fft(v, config=cfg))(x))


@pytest.mark.parametrize("n", [360, 1024, 1009])
@pytest.mark.parametrize("prec", PRECISIONS, ids=str)
def test_every_precision_against_jax(case_rng, n, prec):
    x = case_rng.standard_normal((2, n)) + 1j * case_rng.standard_normal((2, n))
    want = np.fft.fft(x)
    x32 = x.astype(np.complex64)
    jgot = _jax_fft(x32, jsp.SpectralConfig(precision=prec))
    got = tp.fft(torch.from_numpy(x32), config=tp.SpectralConfig(precision=prec)).numpy()
    jax_err = _rel(jgot, want)
    assert _rel(got, jgot) <= TOL + jax_err
    assert _rel(got, want) <= (SPLIT6_TOL if prec == "split6" else TOL)
    if prec == "split6":
        assert _rel(got, jgot) <= SPLIT6_JAX_TOL


def test_bf16_chunks_are_the_jax_modules(case_rng):
    v = (case_rng.standard_normal(4096) * 10.0 ** case_rng.uniform(-6, 6, 4096)).astype(np.float32)
    v[:2] = (0.0, -0.0)
    want = jstock._bf16_chunks3(jnp.asarray(v))
    got = tstock._bf16_chunks3(torch.from_numpy(v))
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert np.array_equal(g.view(torch.int16).numpy(),
                              np.asarray(w).view(np.int16))
    total = sum(c.double() for c in got).numpy()
    assert np.max(np.abs(total - v) / np.maximum(np.abs(v), 1e-30)) < 2.0 ** -23


def test_split6_is_fp32_only():
    with pytest.raises(ValueError, match="bfloat16"):
        tp.fft(torch.ones(2, 1024), config=tp.SpectralConfig(
            precision="split6", dtype=torch.bfloat16))


def test_op_precision_resolves_as_the_jax_configs(case_rng):
    for prec in PRECISIONS + ["Highest", ("default",)]:
        want = jsp.SpectralConfig(precision=prec).op_precision
        got = tp.SpectralConfig(precision=prec).op_precision
        assert got == (want.lower() if isinstance(want, str) else want)
    x = case_rng.standard_normal(64).astype(np.float32)
    f = case_rng.standard_normal((8, 16)).astype(np.float32)
    pts = case_rng.uniform(0, 2 * np.pi, 32).astype(np.float32)
    c = case_rng.standard_normal(32).astype(np.complex64)
    for prec in PRECISIONS:
        cfg = tp.SpectralConfig(precision=prec)
        assert np.all(np.isfinite(tp.fft(torch.from_numpy(x), config=cfg).numpy()))
        assert np.all(np.isfinite(tp.dwt(torch.from_numpy(x), "db2", config=cfg)[0].numpy()))
        assert np.all(np.isfinite(tp.sht(torch.from_numpy(f), config=cfg).numpy()))
        assert np.all(np.isfinite(tp.nufft1(torch.from_numpy(pts), torch.from_numpy(c), 16,
                                            config=cfg).numpy()))


@pytest.mark.parametrize("bad", ["fast", "", (), ("highest", "bf16"), 3, None])
def test_bad_precision_names_the_field(bad):
    with pytest.raises(ValueError, match="precision"):
        tp.SpectralConfig(precision=bad)


def test_the_helper_sets_and_restores_the_flags():
    mm, dnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (mm.allow_tf32, dnn.allow_tf32, mm.allow_bf16_reduced_precision_reduction,
             mm.allow_fp16_reduced_precision_reduction)
    try:
        for outside in (False, True):
            mm.allow_tf32 = dnn.allow_tf32 = outside
            mm.allow_bf16_reduced_precision_reduction = True
            mm.allow_fp16_reduced_precision_reduction = True
            for prec, tf32 in (("highest", False), ("high", True), ("default", True)):
                with numerics.matmul_precision(prec):
                    assert mm.allow_tf32 is tf32 and dnn.allow_tf32 is tf32
                    assert mm.allow_bf16_reduced_precision_reduction is False
                    assert mm.allow_fp16_reduced_precision_reduction is False
                assert mm.allow_tf32 is outside and dnn.allow_tf32 is outside
                assert mm.allow_bf16_reduced_precision_reduction is True
            with numerics.matmul_precision("high"):
                # a mark: a nested block at "high" writes no flag, one at
                # "highest" writes them all and puts the mark back
                mm.allow_bf16_reduced_precision_reduction = True
                with numerics.matmul_precision("high"):
                    assert mm.allow_bf16_reduced_precision_reduction is True
                with numerics.matmul_precision("highest"):
                    assert mm.allow_tf32 is False
                    assert mm.allow_bf16_reduced_precision_reduction is False
                assert mm.allow_tf32 is True
                assert mm.allow_bf16_reduced_precision_reduction is True
            assert mm.allow_tf32 is outside
        with pytest.raises(RuntimeError), numerics.matmul_precision("high"):
            raise RuntimeError("restored on the way out")
        assert mm.allow_tf32 is True
        with pytest.raises(ValueError, match="precision"):
            with numerics.matmul_precision("split6"):
                pass
    finally:
        (mm.allow_tf32, dnn.allow_tf32, mm.allow_bf16_reduced_precision_reduction,
         mm.allow_fp16_reduced_precision_reduction) = saved


@pytest.mark.parametrize("n", [1024, 1009, 5040])
def test_a_transform_sets_the_flags_once(monkeypatch, n):
    """The stage products of a transform run inside the one block that the
    transform opens at its first stage's precision, so a product at that
    precision sets no flag; a product at another stage precision opens its
    own block."""
    seen, dot = [], tstock._dot

    def spy(axis, x, w, precision):
        seen.append((getattr(numerics._PRECISION, "active", None), precision))
        return dot(axis, x, w, precision)

    monkeypatch.setattr(tstock, "_dot", spy)
    x = torch.randn(2, n, generator=torch.Generator().manual_seed(n))
    for prec, outer in (("highest", "highest"), ("default", "default"),
                        ("split6", "highest"), (("high", "highest"), "high")):
        seen.clear()
        cfg = tp.SpectralConfig(precision=prec, use_kernel=False, butterfly="off")
        tp.fft(x, config=cfg)
        assert seen and all(active == outer for active, _ in seen), (prec, seen)
    assert getattr(numerics._PRECISION, "active", None) is None


def test_k1_ignores_the_lever_and_takes_two_byte_planes():
    on_card = type("T", (), {"device": torch.device("cuda")})()
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for prec in PRECISIONS:
            assert cuda_fft.uses_kernel(tp.SpectralConfig(dtype=dtype, precision=prec), 2048,
                                        on_card)
        tp.SpectralConfig(dtype=dtype, use_kernel=True)
    assert not cuda_fft.uses_kernel(tp.SpectralConfig(dtype=torch.float64), 2048, on_card)
    x = torch.randn(2, 2048, generator=torch.Generator().manual_seed(0))
    outs = [tp.fft(x, config=tp.SpectralConfig(use_kernel=True, precision=p)) for p in PRECISIONS]
    assert all(torch.equal(o, outs[0]) for o in outs[1:])


# ---------------------------------------------------------------------------
# The 2-byte working dtypes


def _jax_run(fn, *arrays):
    return jax.tree_util.tree_map(np.asarray, jax.jit(fn)(*arrays))


@pytest.mark.parametrize("name", sorted(HALF))
def test_half_dtype_transforms_against_jax_and_float64(case_rng, name):
    tdt, jdt, _ = HALF[name]
    fft_tol, trip_tol = _bounds(name)
    tcfg, jcfg = tp.SpectralConfig(dtype=tdt), jsp.SpectralConfig(dtype=jdt)
    for n in (256, 1009, 1024):
        x = case_rng.standard_normal((2, n)) + 1j * case_rng.standard_normal((2, n))
        x32 = x.astype(np.complex64)
        got = tp.fft(torch.from_numpy(x32), config=tcfg)
        assert got.dtype == torch.complex64
        jgot = _jax_run(lambda v: jsp.fft(v, config=jcfg), x32)
        assert _rel(got.numpy(), np.fft.fft(x)) <= fft_tol
        assert _rel(got.numpy(), jgot) <= fft_tol
    r = case_rng.standard_normal((2, 256)).astype(np.float32)
    spec = tp.rfft(torch.from_numpy(r), config=tcfg)
    back = tp.irfft(spec, n=256, config=tcfg)
    jspec, jback = _jax_run(lambda v: (lambda s: (s, jsp.irfft(s, n=256, config=jcfg)))(
        jsp.rfft(v, config=jcfg)), r)
    assert spec.dtype == torch.complex64 and back.dtype == tdt
    assert _rel(spec.numpy(), np.fft.rfft(r.astype(np.float64))) <= fft_tol
    assert _rel(back, r.astype(np.float64)) <= trip_tol
    assert _rel(back, jback.astype(np.float64)) <= trip_tol
    z = (case_rng.standard_normal((2, 16, 24)) + 1j * case_rng.standard_normal((2, 16, 24)))
    z32 = z.astype(np.complex64)
    got = tp.fftn(torch.from_numpy(z32), config=tcfg).numpy()
    assert _rel(got, np.fft.fftn(z)) <= fft_tol
    assert _rel(got, _jax_run(lambda v: jsp.fftn(v, config=jcfg), z32)) <= fft_tol
    sig = case_rng.standard_normal((2, 500)).astype(np.float32)
    taps = case_rng.standard_normal(33).astype(np.float32)
    got = tp.fft_convolve(torch.from_numpy(sig), torch.from_numpy(taps)[None], config=tcfg)
    want = np.stack([np.convolve(s, taps.astype(np.float64)) for s in sig.astype(np.float64)])
    assert _rel(got, want) <= fft_tol
    jgot = _jax_run(lambda a, b: jsp.fft_convolve(a, b[None], config=jcfg), sig, taps)
    assert _rel(got, jgot.astype(np.float64)) <= fft_tol
    d = case_rng.standard_normal((2, 64)).astype(np.float32)
    got = tp.dct(torch.from_numpy(d), type=2, config=tcfg)
    from scipy.fft import dct as sdct
    assert _rel(got, sdct(d.astype(np.float64), type=2)) <= fft_tol
    jgot = _jax_run(lambda v: jsp.dct(v, type=2, config=jcfg), d)
    assert _rel(got, jgot.astype(np.float64)) <= fft_tol
    s = case_rng.standard_normal((2, 500)).astype(np.float32)
    got = tp.stft(torch.from_numpy(s), 64, 48, config=tcfg)
    jgot = _jax_run(lambda v: jsp.stft(v, 64, 48, config=jcfg), s)
    want = tp.stft(torch.from_numpy(s.astype(np.float64)), 64, 48,
                   config=tp.SpectralConfig(dtype=torch.float64)).numpy()
    assert _rel(got.numpy(), want) <= fft_tol
    assert _rel(got.numpy(), jgot) <= fft_tol


@pytest.mark.parametrize("name", sorted(HALF))
@pytest.mark.parametrize("case", sorted(dtype_ops.CASES))
def test_op_at_half_dtype_against_its_float64_oracle(monkeypatch, name, case):
    """The op cases of the float64 file at the 2-byte dtype: each runs
    within OPS_UNITS unit roundoffs of its float64 oracle, or raises as the
    JAX function raises at that dtype (``lombscargle`` at bf16: numpy has
    no ``finfo`` for it).  czt's spiral overflows fp16's range (|w|^-k²/2
    reaches 1e5) in both packages: only its zoom is held at fp16."""
    tdt, _, unit = HALF[name]
    monkeypatch.setattr(dtype_ops, "F64", tp.SpectralConfig(dtype=tdt))
    monkeypatch.setattr(dtype_ops, "_np", _np)
    make, _ = dtype_ops.CASES[case]
    r = np.random.default_rng([ord(ch) for ch in case])
    if (case, name) == ("signal.lombscargle", "bfloat16"):
        with pytest.raises(ValueError, match="bfloat16"):
            make(r)
        t = np.linspace(0.0, 50.0, 64, dtype=np.float32)
        with pytest.raises(ValueError, match="bfloat16"):
            _jax_run(lambda a, b, c: jsp.lombscargle(
                a, b, c, config=jsp.SpectralConfig(dtype=jnp.bfloat16)), t, np.sin(t),
                np.linspace(0.1, 3.0, 20, dtype=np.float32))
        return
    pairs = make(r)
    if (case, name) == ("czt", "float16"):
        pairs = pairs[1:]
    for i, (got, want) in enumerate(pairs):
        err = _rel(got, np.asarray(want))
        assert err <= OPS_UNITS * unit, (case, name, i, err)


@pytest.mark.parametrize("name", sorted(HALF))
@pytest.mark.parametrize("n", [360, 1024])
def test_kernel_plain_version_at_half_planes(case_rng, name, n):
    tdt, _, unit = HALF[name]
    fft_tol, _ = _bounds(name)
    x = case_rng.standard_normal((3, n)) + 1j * case_rng.standard_normal((3, n))
    xr = torch.tensor(x.real, dtype=tdt)
    xi = torch.tensor(x.imag, dtype=tdt)
    exact = np.fft.fft(xr.double().numpy() + 1j * xi.double().numpy())
    kr, ki = cuda_fft.exec_kernel(xr, xi, n, -1)
    assert kr.dtype == ki.dtype == tdt
    got = kr.double().numpy() + 1j * ki.double().numpy()
    # one rounding at the store: half a unit of the largest value
    assert _rel(got, exact) <= unit
    cfg = tp.SpectralConfig(dtype=tdt, use_kernel=False)
    pr, pi = tstock.exec_complex(tplan.get_plan(n, -1, "complex", cfg), xr, xi)
    pipe = pr.double().numpy() + 1j * pi.double().numpy()
    assert _rel(pipe, exact) <= fft_tol
    assert _rel(got, pipe) <= fft_tol
    (gr,) = torch.autograd.grad(
        cuda_fft.exec_kernel(xr.requires_grad_(), xi, n, -1)[0].float().sum(), xr)
    assert gr.dtype == tdt
