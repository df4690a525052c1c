"""PyTorch port: host planning, twiddles and plans agree with the JAX package."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import mixed_radix_fast_fourier_transform_tpu as jsp
from mixed_radix_fast_fourier_transform_tpu import plan as jplan
from mixed_radix_fast_fourier_transform_tpu.ops import pallas_fft as jpallas
from mixed_radix_fast_fourier_transform_tpu.utils import factorize as jfac
from mixed_radix_fast_fourier_transform_tpu.utils import twiddle as jtw

import mixed_radix_fast_fourier_transform_tpu_torch as tp
from mixed_radix_fast_fourier_transform_tpu_torch import plan as tplan
from mixed_radix_fast_fourier_transform_tpu_torch.ops import cuda_fft
from mixed_radix_fast_fourier_transform_tpu_torch.utils import factorize as tfac
from mixed_radix_fast_fourier_transform_tpu_torch.utils import twiddle as ttw

torch.set_num_threads(1)

LENGTHS = [1, 2, 13, 64, 360, 1009, 1024, 2048, 4096, 5040, 10007, 65536]


def _same_outcome(f_jax, f_torch):
    """Both raise ValueError, or both return equal values."""
    try:
        want = f_jax()
    except ValueError:
        with pytest.raises(ValueError):
            f_torch()
        return None
    got = f_torch()
    assert got == want
    return got


def _bit_equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.fixture
def jax_python_paths(monkeypatch):
    """The JAX package's pure-Python planner and numpy twiddle paths, which
    the port copies.  Its native library (when built) differs from them by
    a few fp64 ulps of 1 where cos/sin cross zero, so bit-equality is held against
    the Python paths, and the native path within that rounding."""
    monkeypatch.setattr(jfac, "_use_native", lambda: False)
    monkeypatch.setattr(jtw, "_native", lambda: None)


@pytest.mark.parametrize("n", LENGTHS)
def test_plan_stages_and_kernel_factors(n, jax_python_paths):
    for strategy in ("balanced", "greedy"):
        _same_outcome(
            lambda: jfac.plan_stages(n, 256, strategy),
            lambda: tfac.plan_stages(n, 256, strategy),
        )
    _same_outcome(lambda: jpallas.pallas_factors(n), lambda: cuda_fft.kernel_factors(n))
    assert tfac.prime_factors(n) == jfac.prime_factors(n)
    assert tfac.is_prime(n) == jfac.is_prime(n)
    assert tfac.next_fast_len(2 * n - 1) == jfac.next_fast_len(2 * n - 1)
    assert tfac.next_pow2(n) == jfac.next_pow2(n)
    if tfac.is_prime(n):
        assert tfac.primitive_root(n) == jfac.primitive_root(n)


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("sign", [-1, 1])
def test_twiddles_bit_equal(n, sign, jax_python_paths):
    if n <= 1024:
        _bit_equal(ttw.dft_matrix(n, sign), jtw.dft_matrix(n, sign))
    n1 = tfac.plan_stages(n, 256)[0] if tfac.is_smooth(n, 256) else 1
    _bit_equal(
        ttw.twiddle_split(n1, n // n1, n, sign),
        jtw.twiddle_split(n1, n // n1, n, sign),
    )
    _bit_equal(ttw.chirp(n, sign), jtw.chirp(n, sign))
    _bit_equal(ttw.split_twiddles(n, sign), jtw.split_twiddles(n, sign))
    if cuda_fft.supports(n):
        facs = cuda_fft.kernel_factors(n)
        got = cuda_fft.stage_twiddles(facs, sign)
        want = jpallas.stage_twiddles(facs, sign)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _bit_equal(g, w)


@pytest.mark.parametrize("n", [360, 1024, 5040])
def test_twiddles_match_native_path(n):
    n1 = tfac.plan_stages(n, 256)[0]
    pairs = [
        (ttw.dft_matrix(n1, -1), jtw.dft_matrix(n1, -1)),
        (ttw.twiddle_split(n1, n // n1, n, -1), jtw.twiddle_split(n1, n // n1, n, -1)),
        (ttw.chirp(n, 1), jtw.chirp(n, 1)),
        (ttw.split_twiddles(n, 1), jtw.split_twiddles(n, 1)),
    ]
    for got, want in pairs:
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-15)


def _describe(plan):
    """Plan type and stage factors, recursively through inner plans."""
    out = [type(plan).__name__, getattr(plan, "factors", None),
           getattr(plan, "m", None)]
    inner = getattr(plan, "inner", None)
    if inner is not None:
        out.append(_describe(inner))
    return out


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("rader", ["off", "auto"])
def test_get_plan_matches(n, rader, jax_python_paths):
    jcfg = jsp.SpectralConfig(rader=rader)
    tcfg = tp.SpectralConfig(rader=rader)
    for sign in (-1, 1):
        # the plan types and factors through get_plan; the constants through
        # the uncached builders, under the JAX package's Python paths
        assert _describe(tplan.get_plan(n, sign, "complex", tcfg)) == _describe(
            jplan.get_plan(n, sign, "complex", jcfg))
        jp = jplan.build_complex_plan(n, sign, jcfg)
        tpl = tplan.build_complex_plan(n, sign, tcfg)
        assert _describe(tpl) == _describe(jp)
        for name in ("dft_re", "dft_im", "tw_re", "tw_im"):
            for g, w in zip(getattr(tpl, name, ()), getattr(jp, name, ())):
                np.testing.assert_array_equal(g, w)
        if n % 2 == 0:
            jr = jplan.build_real_plan(n, sign, jcfg)
            tr = tplan.build_real_plan(n, sign, tcfg)
            assert _describe(tr) == _describe(jr)
            for name in ("p_re", "p_im", "q_re", "q_im"):
                np.testing.assert_array_equal(getattr(tr, name), getattr(jr, name))


def test_plan_cache_and_device_constants():
    tplan.clear_plan_cache()
    tp.utils.reset_metrics()
    a = tplan.get_plan(360, -1)
    b = tplan.get_plan(360, -1)
    assert a is b
    m = tp.utils.get_metrics()
    assert m["plans_built"] == 1 and m["plan_cache_hits"] == 1
    c1 = tplan.device_constants(a, "cpu")
    c2 = tplan.device_constants(a, torch.device("cpu"))
    assert c1 is c2
    assert c1["dft_re"][0].dtype == torch.float32
    np.testing.assert_array_equal(c1["tw_re"][0].numpy(), a.tw_re[0])
    r = tplan.get_plan(1009, -1, config=tp.SpectralConfig(rader="auto"))
    assert tplan.device_constants(r, "cpu")["perm_in"].dtype == torch.int64


def test_config_validation():
    for bad in (dict(pad_mode="x"), dict(rader="x"), dict(butterfly="x"),
                dict(stage_strategy="x"), dict(max_stage=1), dict(direct_dft_max=0)):
        with pytest.raises(ValueError):
            tp.SpectralConfig(**bad)
    assert tp.SpectralConfig().use_kernel is None


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import mixed_radix_fast_fourier_transform_tpu_torch as tp\n"
        "import mixed_radix_fast_fourier_transform_tpu_torch.ops.cuda_fft\n"
        "import mixed_radix_fast_fourier_transform_tpu_torch.ops._build\n"
        "jaxpkg = 'mixed_radix_fast_fourier_transform_tpu'\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', jaxpkg))\n"
        "assert not bad, bad\n"
        "print('OK')\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=root)
    assert out.returncode == 0 and "OK" in out.stdout, out.stderr


@pytest.mark.parametrize("n", [360, 1009, 10007])
def test_complex_plan_is_the_tuple_of_complex_plan_classes(n):
    """``plan.ComplexPlan`` names the three complex plan classes, as the
    JAX package's does, so ``isinstance(p, ComplexPlan)`` tells a complex
    plan from a real one in both packages alike."""
    assert tuple(c.__name__ for c in tplan.ComplexPlan) == tuple(
        c.__name__ for c in jplan.ComplexPlan)
    assert tp.ComplexPlan is tplan.ComplexPlan
    config = tp.SpectralConfig(rader="auto")
    got = tplan.build_complex_plan(n, -1, config)
    want = jplan.build_complex_plan(n, -1, jsp.SpectralConfig(rader="auto"))
    assert isinstance(got, tplan.ComplexPlan) and isinstance(want, jplan.ComplexPlan)
    assert type(got).__name__ == type(want).__name__
    assert not isinstance(tplan.build_real_plan(2 * n, -1), tplan.ComplexPlan)
