"""PyTorch port: the stage pipeline's exec_complex against the JAX package's."""

import numpy as np
import pytest
import torch

import mixed_radix_fast_fourier_transform_tpu as jsp
from mixed_radix_fast_fourier_transform_tpu import plan as jplan
from mixed_radix_fast_fourier_transform_tpu.ops import stockham as jstock

import mixed_radix_fast_fourier_transform_tpu_torch as tp
from mixed_radix_fast_fourier_transform_tpu_torch import plan as tplan
from mixed_radix_fast_fourier_transform_tpu_torch.ops import stockham as tstock

torch.set_num_threads(1)

TOL = 1e-5  # max |got − want| / max |want|: the library's error budget

# (n, config fields, plan type): n = 13 goes to Bluestein only when neither
# a direct DFT nor a stage can take it
PLANS = [
    (360, {}, "MixedRadixPlan"),
    (1024, {}, "MixedRadixPlan"),
    (2048, {}, "MixedRadixPlan"),
    (13, dict(direct_dft_max=1, max_stage=8), "BluesteinPlan"),
    (1009, {}, "BluesteinPlan"),
    (1009, dict(rader="auto"), "RaderPlan"),
]


@pytest.mark.parametrize("n,fields,kind", PLANS)
@pytest.mark.parametrize("butterfly", ["auto", "8", "off"])
@pytest.mark.parametrize("sign", [-1, 1])
def test_exec_complex_matches_jax(n, fields, kind, butterfly, sign):
    jcfg = jsp.SpectralConfig(butterfly=butterfly, **fields)
    tcfg = tp.SpectralConfig(butterfly=butterfly, **fields)
    jp = jplan.get_plan(n, sign, "complex", jcfg)
    tpl = tplan.get_plan(n, sign, "complex", tcfg)
    assert type(tpl).__name__ == type(jp).__name__ == kind
    rng = np.random.default_rng(n * 7 + sign)
    x = rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n))
    xr = x.real.astype(np.float32)
    xi = x.imag.astype(np.float32)
    wr, wi = jstock.exec_complex(jp, xr, xi)
    want = np.asarray(wr) + 1j * np.asarray(wi)
    gr, gi = tstock.exec_complex(tpl, torch.from_numpy(xr), torch.from_numpy(xi))
    got = gr.numpy() + 1j * gi.numpy()
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) / np.max(np.abs(want)) <= TOL
    oracle = np.fft.fft(x) if sign < 0 else np.fft.ifft(x) * n
    assert np.max(np.abs(got - oracle)) / np.max(np.abs(oracle)) <= TOL


@pytest.mark.parametrize("f", [2, 4, 8, 16])
@pytest.mark.parametrize("axis", [-1, -2])
def test_butterfly_stage_is_a_dft(f, axis):
    rng = np.random.default_rng(f)
    x = rng.standard_normal((3, f, 5)) + 1j * rng.standard_normal((3, f, 5))
    if axis == -1:
        x = np.swapaxes(x, -1, -2)
    xr = torch.tensor(x.real, dtype=torch.float32)
    xi = torch.tensor(x.imag, dtype=torch.float32)
    for sign in (-1, 1):
        zr, zi = tstock._butterfly_stage(f, sign, axis, xr, xi)
        got = zr.numpy() + 1j * zi.numpy()
        want = np.fft.fft(x, axis=axis) if sign < 0 else np.fft.ifft(x, axis=axis) * f
        assert np.max(np.abs(got - want)) / np.max(np.abs(want)) <= TOL


def test_exec_len_uses_pipeline_when_kernel_is_off():
    rng = np.random.default_rng(5)
    n = 360
    x = torch.tensor(rng.standard_normal((2, n)), dtype=torch.float32)
    cfg = tp.SpectralConfig(use_kernel=False)
    zr, zi = tstock.exec_len(cfg, n, -1, x, torch.zeros_like(x))
    pr, pi = tstock.exec_complex(tplan.get_plan(n, -1, "complex", cfg), x,
                                 torch.zeros_like(x))
    assert torch.equal(zr, pr) and torch.equal(zi, pi)
