"""PyTorch port: the working dtype, ``SpectralConfig(dtype=torch.float64)``.

The float64 route runs the whole stage pipeline (mixed radix, Bluestein,
Rader, the packed real transform, convolution, the DCT) in float64: every
result is held to numpy/scipy float64 at 1e-12 of its largest value (the
DCT at 1e-10 in absolute terms, as the JAX package's ``tests/test_fp64.py``
holds it), and is float64 or complex128.  The fp32 default is untouched:
the default config is fp32, a plan of each dtype is its own cache entry,
and the butterfly constants at fp32 are the JAX module's bit for bit.  The
model initialisers take ``dtype=``; the spectral filter's float64 forward
is held to a numpy float64 oracle.  Against the JAX package under x64 (a
subprocess, since x64 is process-global): |port − JAX| ≤ 1e-12 plus the JAX
result's own error against float64, which its fp32-rounded radix-16
constants put near 3e-8 (ROADMAP F12), and the port's own error ≤ 1e-12.
"""

import os
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest
import scipy.fft as sfft
import torch

import mixed_radix_fast_fourier_transform_tpu_torch as tp
from mixed_radix_fast_fourier_transform_tpu.ops import stockham as jstockham
from mixed_radix_fast_fourier_transform_tpu_torch import plan as tplan
from mixed_radix_fast_fourier_transform_tpu_torch.models import (
    afno, audio_frontend, fnet, fno, koopman, s4d, sfno, spectral_filter,
)
from mixed_radix_fast_fourier_transform_tpu_torch.ops import cuda_fft, stockham
from mixed_radix_fast_fourier_transform_tpu_torch.utils import numerics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = tp.SpectralConfig(dtype=torch.float64)
TOL = 1e-12
LENGTHS = [360, 1024, 1009, 4096, 5040, 10007]


@pytest.fixture
def case_rng(request):
    """A generator made for one test case from its name: its draws do not
    depend on which tests ran before on the worker."""
    return np.random.default_rng([ord(ch) for ch in request.node.name])


def _rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


@pytest.mark.parametrize("n", LENGTHS + ["1009-rader"])
def test_float64_engine_against_numpy(case_rng, n):
    """fft, ifft, rfft, irfft, fft_convolve and dct at length n in float64
    against numpy/scipy float64: 1e-12 of the largest value (dct 1e-10),
    complex128 or float64 out."""
    cfg = tp.SpectralConfig(dtype=torch.float64, rader="auto") if n == "1009-rader" else F64
    n = 1009 if n == "1009-rader" else n
    z = case_rng.standard_normal((3, n)) + 1j * case_rng.standard_normal((3, n))
    x = case_rng.standard_normal((3, n))
    k = case_rng.standard_normal((1, 33))
    zt, xt = torch.from_numpy(z), torch.from_numpy(x)
    got = {
        "fft": tp.fft(zt, config=cfg), "ifft": tp.ifft(zt, config=cfg),
        "rfft": tp.rfft(xt, config=cfg),
        "irfft": tp.irfft(torch.from_numpy(np.fft.rfft(x)), n=n, config=cfg),
        "fft_convolve": tp.fft_convolve(xt, torch.from_numpy(k), config=cfg),
    }
    want = {
        "fft": np.fft.fft(z), "ifft": np.fft.ifft(z), "rfft": np.fft.rfft(x), "irfft": x,
        "fft_convolve": np.stack([np.convolve(row, k[0]) for row in x]),
    }
    for name, g in got.items():
        assert g.dtype in (torch.float64, torch.complex128), name
        assert _rel(g, want[name]) <= TOL, name
    d = tp.dct(xt, type=2, config=cfg)
    assert d.dtype == torch.float64
    assert np.max(np.abs(d.numpy() - sfft.dct(x, type=2))) <= 1e-10


def test_float64_real_round_trip_and_dct_as_the_jax_fp64_test(case_rng):
    """``tests/test_fp64.py``'s cases: the real round trip at 4096 within
    1e-12 and the type-2 DCT at 256 within 1e-10, absolute."""
    x = case_rng.standard_normal(4096)
    back = tp.irfft(tp.rfft(torch.from_numpy(x), config=F64), n=4096, config=F64)
    assert np.max(np.abs(back.numpy() - x)) < 1e-12
    xd = case_rng.standard_normal(256)
    assert np.max(np.abs(tp.dct(torch.from_numpy(xd), type=2, config=F64).numpy()
                         - sfft.dct(xd, type=2))) < 1e-10


@pytest.mark.parametrize("butterfly", ["auto", "8", "off"])
def test_float64_every_butterfly_set_and_the_compat_plan(case_rng, butterfly):
    """The radix-16, radix-8 and matmul-only stage sets all reach 1e-12 at
    n = 1024 and 2048, as does ``compat.fft_exec`` on a float64 plan."""
    cfg = tp.SpectralConfig(dtype=torch.float64, butterfly=butterfly)
    for n in (1024, 2048):
        z = case_rng.standard_normal((2, n)) + 1j * case_rng.standard_normal((2, n))
        assert _rel(tp.fft(torch.from_numpy(z), config=cfg), np.fft.fft(z)) <= TOL
    obj = tp.compat.fft_init(1024, 1, cfg)
    z = case_rng.standard_normal(1024) + 1j * case_rng.standard_normal(1024)
    out = tp.compat.fft_exec(obj, torch.from_numpy(z))
    assert out.dtype == torch.complex128 and _rel(out, np.fft.fft(z)) <= TOL


def test_butterfly_constants_are_the_jax_modules_at_fp32_and_exact_at_float64():
    assert stockham._BFLY_CONSTS[torch.float32] == (
        jstockham._SQRT1_2, jstockham._COS_PI_8, jstockham._SIN_PI_8)
    assert stockham._BFLY_CONSTS[torch.float64] == (
        np.sqrt(0.5), np.cos(np.pi / 8), np.sin(np.pi / 8))


def test_default_is_fp32_and_each_dtype_has_its_own_plan():
    assert tp.SpectralConfig().dtype == torch.float32 == tp.DEFAULT_CONFIG.dtype
    p32 = tplan.get_plan(1024, -1, "complex", tp.SpectralConfig())
    p64 = tplan.get_plan(1024, -1, "complex", F64)
    assert p32 is not p64 and p32.factors == p64.factors
    assert p32.dft_re[0].dtype == np.float32 and p64.dft_re[0].dtype == np.float64
    b64 = tplan.get_plan(1009, -1, "complex", F64)
    assert b64.spec_re.dtype == np.float64 and b64.inner.dft_re[0].dtype == np.float64
    r64 = tplan.get_plan(4096, -1, "real", F64)
    assert r64.p_re.dtype == np.float64
    assert tplan._cfg_key(F64) != tplan._cfg_key(tp.SpectralConfig())
    x = torch.ones(2, 16)
    assert tp.fft(x).dtype == torch.complex64 and tp.rfft(x).dtype == torch.complex64


def test_dtype_errors():
    """A complex or numpy dtype is refused, and float64 with
    ``use_kernel=True``; the 2-byte working dtypes (bf16, fp16) are
    accepted, with the kernel too (``tests/test_torch_precision.py``)."""
    for dtype in (torch.complex64, np.float64):
        with pytest.raises(ValueError, match="dtype"):
            tp.SpectralConfig(dtype=dtype)
    with pytest.raises(ValueError, match="use_kernel"):
        tp.SpectralConfig(dtype=torch.float64, use_kernel=True)
    tp.SpectralConfig(dtype=torch.float64, use_kernel=False)
    for dtype in (torch.bfloat16, torch.float16):
        for use_kernel in (None, True, False):
            assert tp.SpectralConfig(dtype=dtype, use_kernel=use_kernel).dtype == dtype


def test_the_float64_route_takes_no_kernel():
    """``uses_kernel`` is False for a float64 config wherever the length
    would take the kernel, on the card too; the fp32 route is unchanged."""
    on_card = types.SimpleNamespace(device=torch.device("cuda"))
    for n in (16, 1024, 4096, 16384):
        assert cuda_fft.uses_kernel(tp.SpectralConfig(), n, on_card)
        assert not cuda_fft.uses_kernel(F64, n, on_card)
        assert not cuda_fft.uses_kernel(tp.SpectralConfig(dtype=torch.float64, use_kernel=None),
                                        n, on_card)


def test_to_planes_working_and_from_planes_keep_the_dtype():
    z = torch.complex(torch.randn(4, dtype=torch.float64), torch.randn(4, dtype=torch.float64))
    re, im = numerics.to_planes(z, torch.float64)
    assert re.dtype == im.dtype == torch.float64
    assert torch.equal(re, z.real) and torch.equal(im, z.imag)
    assert numerics.from_planes(re, im).dtype == torch.complex128
    re32, _ = numerics.to_planes(z)
    assert re32.dtype == torch.float32
    assert numerics.working(z).dtype == torch.complex64
    assert numerics.working(z, torch.float64).dtype == torch.complex128
    assert numerics.working(torch.arange(3), torch.float64).dtype == torch.float64


INITS = {
    "spectral_filter.init_params": lambda **kw: spectral_filter.init_params(16, **kw),
    "spectral_filter.init_params_complex":
        lambda **kw: spectral_filter.init_params_complex(16, **kw),
    "fno.init_layer": lambda **kw: fno.init_layer(4, 3, **kw),
    "fno.init_fno": lambda **kw: fno.init_fno(1, 4, 1, 2, 3, **kw),
    "fno.init_layer2d": lambda **kw: fno.init_layer2d(4, 2, 3, **kw),
    "fno.init_fno2d": lambda **kw: fno.init_fno2d(1, 4, 1, 2, 3, **kw),
    "fno.init_layer3d": lambda **kw: fno.init_layer3d(2, 2, 2, 2, **kw),
    "fno.init_fno3d": lambda **kw: fno.init_fno3d(1, 2, 1, 1, 2, **kw),
    "s4d.init_s4d_layer": lambda **kw: s4d.init_s4d_layer(4, 8, **kw),
    "s4d.init_s4d_model": lambda **kw: s4d.init_s4d_model(4, 1, 8, **kw),
    "fnet.init_layer": lambda **kw: fnet.init_layer(8, 16, **kw),
    "fnet.init_fnet": lambda **kw: fnet.init_fnet(8, 16, 1, **kw),
    "afno.init_block": lambda **kw: afno.init_block(8, 2, **kw),
    "afno.init_afno": lambda **kw: afno.init_afno(1, 8, 1, n_layers=1, n_blocks=2, **kw),
    "sfno.init_layer": lambda **kw: sfno.init_layer(2, 4, **kw),
    "sfno.init_sfno": lambda **kw: sfno.init_sfno(1, 2, 1, 3, 1, **kw),
    "koopman.init_koopman": lambda **kw: koopman.init_koopman(2, 3, 4, 1, **kw),
    "audio_frontend.init_frontend": lambda **kw: audio_frontend.init_frontend(8, **kw),
    "audio_frontend.init_classifier": lambda **kw: audio_frontend.init_classifier(8, 3, **kw),
    "audio_frontend.init_params": lambda **kw: audio_frontend.init_params(8, 3, **kw),
}


@pytest.mark.parametrize("name", sorted(INITS))
def test_initialisers_take_a_dtype(name):
    """Every initialiser gives float64 leaves with ``dtype=torch.float64``
    and fp32 leaves by default, of the same shapes."""
    init = INITS[name]
    leaves64 = tp.utils.tree.tree_leaves(
        init(generator=torch.Generator().manual_seed(0), device="cpu", dtype=torch.float64))
    leaves32 = tp.utils.tree.tree_leaves(
        init(generator=torch.Generator().manual_seed(0), device="cpu"))
    assert leaves64 and all(v.dtype == torch.float64 for v in leaves64)
    assert all(v.dtype == torch.float32 for v in leaves32)
    assert [tuple(v.shape) for v in leaves64] == [tuple(v.shape) for v in leaves32]


def test_spectral_filter_forward_in_float64(case_rng):
    """The flagship model at n = 4096, batch 8, in float64 against
    irfft(rfft(x)·g) + b in numpy float64: 1e-12 of the largest value."""
    n = 4096
    params = spectral_filter.init_params(n, torch.Generator().manual_seed(1), "cpu",
                                         dtype=torch.float64)
    x = case_rng.standard_normal((8, n))
    y = spectral_filter.apply(params, torch.from_numpy(x), config=F64)
    g = (params["gain_re"] + 1j * params["gain_im"]).numpy()
    want = np.fft.irfft(np.fft.rfft(x) * g, n=n) + float(params["bias"])
    assert y.dtype == torch.float64 and _rel(y, want) <= TOL


def test_model_families_run_in_float64(case_rng):
    """float64 parameters and a float64 config give float64 outputs, and
    the same function as the fp32 parameters cast up, to fp32's error."""
    g = torch.Generator().manual_seed(2)
    cases = [
        (s4d.init_s4d_model(4, 1, 8, generator=g, device="cpu", dtype=torch.float64),
         lambda p, v, c: s4d.apply_s4d(p, v, config=c), (2, 16, 1)),
        (fnet.init_fnet(8, 16, 1, generator=g, device="cpu", dtype=torch.float64),
         lambda p, v, c: fnet.apply(p, v, config=c), (2, 6, 8)),
        (fno.init_fno(1, 4, 1, 1, 3, generator=g, device="cpu", dtype=torch.float64),
         lambda p, v, c: fno.apply(p, v, config=c), (2, 1, 16)),
    ]
    for params, apply, shape in cases:
        x = torch.from_numpy(case_rng.standard_normal(shape))
        y64 = apply(params, x, F64)
        p32 = tp.utils.tree.tree_map(lambda v: v.float(), params)
        y32 = apply(p32, x.float(), tp.SpectralConfig())
        assert y64.dtype == torch.float64 and y32.dtype == torch.float32
        assert _rel(y32.double(), y64.numpy()) <= 1e-4


JAX_WORKER = textwrap.dedent(
    """
    import json, sys
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    sys.path.insert(0, {repo!r})
    import dataclasses
    import numpy as np
    import jax.numpy as jnp
    import mixed_radix_fast_fourier_transform_tpu as sp
    from mixed_radix_fast_fourier_transform_tpu.models import spectral_filter

    cases = np.load(sys.argv[1])
    cfg = dataclasses.replace(sp.DEFAULT_CONFIG, dtype=jnp.float64)
    out = {{}}
    for n in {lengths!r}:
        out[f"fft{{n}}"] = np.asarray(jax.jit(lambda v: sp.fft(v, config=cfg))(cases[f"z{{n}}"]))
    x = cases["x4096"]
    out["round_trip"] = np.asarray(jax.jit(
        lambda v: sp.irfft(sp.rfft(v, config=cfg), n=4096, config=cfg))(x))
    out["dct"] = np.asarray(jax.jit(lambda v: sp.dct(v, type=2, config=cfg))(cases["x256"]))
    params = spectral_filter.init_params(jax.random.PRNGKey(0), 4096, dtype=jnp.float64)
    out["filter"] = np.asarray(jax.jit(
        lambda p, v: spectral_filter.apply(p, v, config=cfg))(params, cases["xb"]))
    for k, v in params.items():
        out["param_" + k] = np.asarray(v)
    np.savez(sys.argv[2], **out)
    print("done", flush=True)
    """
)


def test_port_against_jax_under_x64(tmp_path, case_rng):
    """The JAX package under x64 (a subprocess) and the port on the same
    float64 inputs: ``fft`` at the six lengths, the real round trip at
    4096, the type-2 DCT at 256 and the spectral filter forward at 4096 ×
    8 with the JAX parameters carried across by ``params_from_jax(...,
    dtype=torch.float64)``.  Each case holds the port to its float64 oracle
    at 1e-12 (the DCT at 1e-10 absolute) and to the JAX result within
    1e-12 plus the JAX result's own error against the oracle."""
    cases = {f"z{n}": case_rng.standard_normal(n) + 1j * case_rng.standard_normal(n)
             for n in LENGTHS}
    cases.update(x4096=case_rng.standard_normal(4096), x256=case_rng.standard_normal(256),
                 xb=case_rng.standard_normal((8, 4096)))
    np.savez(tmp_path / "cases.npz", **cases)
    worker = JAX_WORKER.format(repo=REPO, lengths=LENGTHS)
    done = subprocess.run(
        [sys.executable, "-c", worker, str(tmp_path / "cases.npz"), str(tmp_path / "out.npz")],
        capture_output=True, text=True, timeout=300, env={**os.environ, "JAX_PLATFORMS": ""})
    assert done.returncode == 0 and "done" in done.stdout, done.stderr[-2000:]
    ref = np.load(tmp_path / "out.npz")

    def check(name, got, want, jax_out, tol=TOL, relative=True):
        scale = np.max(np.abs(want)) if relative else 1.0
        port_err = np.max(np.abs(got - want)) / scale
        jax_err = np.max(np.abs(jax_out - want)) / scale
        assert port_err <= tol, (name, port_err)
        assert np.max(np.abs(got - jax_out)) / scale <= tol + jax_err, (name, jax_err)

    for n in LENGTHS:
        z = cases[f"z{n}"]
        check(n, tp.fft(torch.from_numpy(z), config=F64).numpy(), np.fft.fft(z),
                        ref[f"fft{n}"])
    x = cases["x4096"]
    back = tp.irfft(tp.rfft(torch.from_numpy(x), config=F64), n=4096, config=F64).numpy()
    check("round trip", back, x, ref["round_trip"], relative=False)
    xd = cases["x256"]
    check("dct", tp.dct(torch.from_numpy(xd), type=2, config=F64).numpy(),
          sfft.dct(xd, type=2), ref["dct"], tol=1e-10, relative=False)
    jparams = {k[len("param_"):]: ref[k] for k in ref.files if k.startswith("param_")}
    params = tp.models.params_from_jax(jparams, "cpu", torch.float64)
    assert all(v.dtype == torch.float64 for v in params.values())
    xb = cases["xb"]
    g = jparams["gain_re"] + 1j * jparams["gain_im"]
    want = np.fft.irfft(np.fft.rfft(xb) * g, n=4096) + float(jparams["bias"])
    check("filter", spectral_filter.apply(params, torch.from_numpy(xb), config=F64).numpy(),
          want, ref["filter"])
