"""PyTorch port: the plan cost model against the JAX package's, and the
timing helpers on the CPU."""

import os

import pytest
import torch

import mixed_radix_fast_fourier_transform_tpu as jsp
from mixed_radix_fast_fourier_transform_tpu.utils import profiling as jprof

import mixed_radix_fast_fourier_transform_tpu_torch as tp
from mixed_radix_fast_fourier_transform_tpu_torch.utils import profiling

torch.set_num_threads(1)


def _plans(n, kind, **cfg):
    return (tp.get_plan(n, -1, kind, tp.SpectralConfig(**cfg)),
            jsp.get_plan(n, -1, kind, jsp.SpectralConfig(**cfg)))


@pytest.mark.parametrize("n,kind,cfg", [
    (1024, "complex", {}),                      # (64, 16): a butterfly tail
    (1024, "complex", {"butterfly": "off"}),
    (1024, "complex", {"butterfly": "8"}),
    (4096, "complex", {}),
    (5040, "complex", {}),
    (65536, "complex", {}),                     # a Karatsuba-size stage
    (360, "complex", {}),
    (1009, "complex", {}),                      # Bluestein
    (1009, "complex", {"rader": "auto"}),       # Rader
    (4096, "real", {}),
    (2018, "real", {}),                         # real over a Bluestein inner plan
])
def test_plan_cost_matches_jax(n, kind, cfg):
    plan, jplan = _plans(n, kind, **cfg)
    assert type(plan).__name__ == type(jplan).__name__
    got, want = profiling.plan_cost(plan), jprof.plan_cost(jplan)
    assert (got.n, got.flops, got.hbm_bytes, got.fft_model_flops) == (
        want.n, want.flops, want.hbm_bytes, want.fft_model_flops)
    assert got.arithmetic_intensity == want.arithmetic_intensity
    assert profiling.plan_cost(plan, 8).hbm_bytes == 2 * got.hbm_bytes


def test_mixed_radix_model_counts_the_butterfly_stage():
    """n = 1024 plans to (64, 16); the 64-stage is a stacked matmul (8·n·f)
    with its split twiddles (6·n), the 16-stage a butterfly at 11 real
    operations a point."""
    n = 1024
    plan, _ = _plans(n, "complex")
    assert plan.factors == (64, 16) and plan.butterfly and plan.butterfly_max == 16
    cost = profiling.plan_cost(plan)
    assert cost.flops == 8 * n * 64 + 6 * n + 11 * n
    assert cost.hbm_bytes == 2 * 4 * n * 4
    assert cost.fft_model_flops == 5 * n * 10
    off, _ = _plans(n, "complex", butterfly="off")
    assert profiling.plan_cost(off).flops == 8 * n * (64 + 16) + 6 * n


def test_plan_cost_rejects_other_objects():
    with pytest.raises(TypeError):
        profiling.plan_cost(object())
    with pytest.raises(TypeError):
        profiling.plan_cost(tp.get_plan(64, -1, "kernel"))


def test_roofline_summary_matches_jax():
    plan, jplan = _plans(4096, "complex")
    got = profiling.roofline_summary(plan, 2e-4, 64)
    assert got == jprof.roofline_summary(jplan, 2e-4, 64)


def test_marginal_time_and_ab_compare_on_the_cpu():
    x = (torch.ones(64, 64),)
    light = lambda a: (a + 1.0,)
    heavy = lambda a: (a @ a @ a @ a + 1.0,)
    t = profiling.marginal_time(light, x, short=5, long=25, reps=2)
    assert 0 < t < 1e-2
    res = profiling.ab_compare(heavy, light, x, short=5, long=25, rounds=3)
    assert len(res["a_seconds"]) == len(res["b_seconds"]) == 3
    assert res["ratio_median"] > 1.0  # B, the lighter one, is faster


def test_ab_compare_drops_degenerate_rounds(monkeypatch):
    times = iter([0.0, 0.0, 2e-6, 1e-6, 1e-12, 5e-6])
    monkeypatch.setattr(profiling, "marginal_time", lambda *a, **k: next(times))
    res = profiling.ab_compare(None, None, (), rounds=3)
    assert res["ratio_median"] == 2.0
    monkeypatch.setattr(profiling, "marginal_time", lambda *a, **k: 0.0)
    with pytest.raises(RuntimeError):
        profiling.ab_compare(None, None, (), rounds=2)


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "prof")) as prof:
        tp.fft(torch.ones(4, 64))
    assert prof is not None
    assert os.path.getsize(tmp_path / "prof" / "trace.json") > 0
