"""PyTorch port: ``tools/tune.py``, the interleaved A/B harness, on CPU
tensors at a small size (n = 64, b = 4, chains of 2 and 10 applications,
three rounds: a round whose long chain happens to read faster than its
short one is dropped, and ``ab_compare`` raises only if every round is).  What is held here: every probe runs and returns its
comparison; the kernel sweep's JSON lines keep their schema and the
kernel's error against float64 stays within 1e-5; the precision probes
print each scheme's error; the device timer refuses work off the card.
No time read here is a device time."""

import io
import json
import re
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from mixed_radix_fast_fourier_transform_tpu_torch.ops import cuda_fft, stockham as stock
from mixed_radix_fast_fourier_transform_tpu_torch.tools import tune
from mixed_radix_fast_fourier_transform_tpu_torch.utils.profiling import graph_time

torch.set_num_threads(1)

KNOBS = dict(device="cpu", short=2, rounds=3)
N, B = 64, 4
TOL = 1e-5


def _is_ab(res, rounds=KNOBS["rounds"]):
    return (len(res["a_seconds"]) == len(res["b_seconds"]) == rounds
            and res["ratio_median"] > 0 and "a_device_us" not in res)


@pytest.mark.parametrize("probe", ["stages", "pad", "kernel", "builtin", "matmul_form",
                                   "rader", "butterfly", "nufft", "sht"])
def test_every_probe_runs_on_cpu_tensors(probe, capsys):
    n, b = (8, 2) if probe == "sht" else (N, B)
    res = tune.PROBES[probe](n, b, **KNOBS)
    text = capsys.readouterr().out
    if probe in ("stages", "butterfly"):   # n = 64 is one dense stage: nothing to vary
        assert res in ({}, {"base": (64,), "variants": {}}), res
        return
    if probe == "pad":
        assert set(res) == {"pow23", "fast"} and all(_is_ab(r) for r in res.values())
    else:
        assert _is_ab(res), res
    assert "median ratio" in text


def test_dispatch_probe_times_every_variant(capsys):
    """The binding's host-cost probe times each variant on CPU tensors (the
    operator's CPU implementation and the filter on the stage pipeline) and
    prints its JSON line; no number here is a card's."""
    res = tune.PROBES["dispatch"](N, B, **KNOBS)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["dispatch"]
    assert line == res and res["device"] == "cpu" and res["filter_route"] == "stage pipeline"
    assert set(res["host_us_per_call"]) == {
        "torch.fft.fft", "exec_kernel", "exec_kernel, planes needing a gradient",
        "filter forward", "filter train step"}
    assert set(res["one_call_us"]) == set(res["host_us_per_call"])
    assert all(0 < us < float("inf") for part in ("host_us_per_call", "one_call_us")
               for us in res[part].values())


@pytest.mark.parametrize("probe", ["stages", "butterfly"])
def test_stage_probes_compare_where_the_plan_has_stages(probe):
    with redirect_stdout(io.StringIO()):
        res = tune.PROBES[probe](1024, 2, **KNOBS)
    variants = res["variants"] if probe == "stages" else res
    assert variants and all(_is_ab(r) for r in variants.values())
    if probe == "butterfly":   # 1024 plans to (64, 16): every form against float64
        assert set(res) == {"bfly-to-8", "bfly-to-16"}
        assert all(r["err"] <= TOL for r in res.values())


def test_split():
    with redirect_stdout(io.StringIO()):
        res = tune.tune_split(N, B, ["8x8", "16x4"], **KNOBS)
    assert set(res) == {"8x8", "16x4"} and all(_is_ab(r) for r in res.values())
    with pytest.raises(ValueError):
        tune.tune_split(N, B, ["8x4"], **KNOBS)


@pytest.mark.parametrize("n,m,ndim", [(N, 32, 1), (4, 8, 2)])
def test_sortspread(n, m, ndim, capsys):
    # the 2-D sorted path loops over 256 tap offsets an application: one
    # round fewer and chains of 1 and 5 keep it within a few seconds
    knobs = KNOBS if ndim == 1 else dict(KNOBS, short=1, rounds=2)
    res = tune.tune_sortspread(n, m, ndim, **knobs)
    assert _is_ab(res, knobs["rounds"]) and res["err"] <= 1e-5
    assert "scatter-vs-sorted" in capsys.readouterr().out


def test_kernel_probe_holds_the_kernel_to_float64():
    with redirect_stdout(io.StringIO()):
        res = tune.tune_kernel(360, 3, **KNOBS)
    assert res["kernel_err"] <= TOL and res["factors"] == (20, 18)
    with pytest.raises(ValueError):
        tune.tune_kernel(1009, 2, **KNOBS)


def test_kernel_sweep_json_schema():
    buf = io.StringIO()
    with redirect_stdout(buf):
        rows, summary = tune.tune_kernel_all(device="cpu", lengths=(8, 360, 1024),
                                             values=4096, short=2)
    lines = [json.loads(line) for line in buf.getvalue().splitlines()]
    assert lines[:-1] == rows and lines[-1] == {"summary": summary}
    keys = {"n", "rows", "device", "timer", "kernel_us", "pipeline_us", "torch_fft_us",
            "kernel_err"}
    for row, n in zip(rows, (8, 360, 1024)):
        assert set(row) == keys and row["n"] == n and row["rows"] == 4096 // n
        assert row["device"] == "cpu" and row["timer"] == "marginal_time"
        assert all(row[k] > 0 for k in ("kernel_us", "pipeline_us", "torch_fft_us"))
        assert row["kernel_err"] <= TOL
    assert summary["lengths"] == 3 and summary["values"] == 4096
    assert sorted(summary["kernel_beats_pipeline"] + summary["kernel_loses_to_pipeline"]) \
        == [8, 360, 1024]
    assert summary["worst_kernel_over_pipeline"]["n"] in (8, 360, 1024)
    assert summary["worst_kernel_over_torch_fft"]["ratio"] > 0
    assert summary["max_kernel_err"] == max(r["kernel_err"] for r in rows)


def test_sweep_covers_every_length_the_kernel_takes(monkeypatch):
    """The sweep's lengths are what ``supports`` admits from 2 to MAX_N
    (``tests/test_torch_kernel.py`` holds ``supports`` to the 7-smooth
    lengths; here it is stood in for by that rule, which skips the geometry
    search)."""
    smooth = [n for n in range(2, 16385) if all(p <= 7 for p in _prime_factors(n))]
    admitted = set(smooth)
    monkeypatch.setattr(cuda_fft, "supports", lambda n, batch=1: n in admitted)
    lengths = tune.sweep_lengths()
    assert lengths == smooth and len(lengths) == 399 and lengths[-1] == cuda_fft.MAX_N == 16384


def _prime_factors(n):
    out, p = [], 2
    while p * p <= n:
        while n % p == 0:
            out.append(p)
            n //= p
        p += 1
    return out + ([n] if n > 1 else [])


@pytest.mark.parametrize("which", ["precision", "prec"])
def test_precision_probes_are_refused(which, capsys):
    """The JAX script's ``precision`` and ``prec`` probes run from the
    command line at n = 64 on the CPU: each scheme's error against float64
    (every precision is fp32 there, split6 within 5e-6) beside its A/B."""
    extra = ["highest,high", "default"] if which == "prec" else []
    assert tune.main([which, "64", "4", *extra, "--device", "cpu", "--short", "2",
                      "--rounds", "3"]) == 0
    out = capsys.readouterr().out
    errs = [float(m) for m in re.findall(r"err (\S+)", out)]
    assert len(errs) == (4 if which == "precision" else 3)
    assert max(errs) <= 5e-6
    assert out.count("median ratio") == (3 if which == "precision" else 2)
    if which == "prec":
        assert "scheme ('highest', 'high')" in out and "scheme ('default',)" in out
    else:
        res = tune.tune_precision(N, B, **KNOBS)
        assert all(_is_ab(res[p]) for p in ("high", "default", "split6"))
        assert res["highest"]["err"] <= TOL and res["split6"]["err"] <= 5e-6


def test_split6_forms_and_the_tf32_emulation(capsys):
    """``split6``: on the CPU the library's form and the TF32 form are both
    the exact chunk products summed in fp32 (split6's 5e-6), and the bf16
    form is the card's only; ``tf32emu``: TF32-rounded operands put the
    "default" pipeline between fp32's error and 16 TF32 unit roundoffs.
    Both probes put the library's products back."""
    kept = (stock._einsum_split6, stock._dot)
    assert tune.main(["split6", "64", "4", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    errs = [float(m) for m in re.findall(r"form: err (\S+)", out)]
    assert len(errs) == 2 and max(errs) <= 5e-6
    assert "bf16: the card's form only" in out
    res = tune.tune_tf32emu(((64, 2), (1009, 2)))
    for row in res.values():
        assert TOL < row["rounded"] <= 16 * 2.0 ** -11
        assert TOL < row["cut"] <= 16 * 2.0 ** -11
    assert (stock._einsum_split6, stock._dot) == kept


def test_command_line(capsys):
    assert tune.main(["kernel", "64", "4", "--device", "cpu", "--short", "2",
                      "--rounds", "3"]) == 0
    assert "kernel err" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        tune.main(["nosuchprobe", "64", "4", "--device", "cpu"])


def test_graph_time_refuses_work_off_the_card():
    x = torch.ones(4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        graph_time(lambda: x * 2)


def test_tune_timings_are_not_device_times():
    """On the CPU no comparison reports a graph_time field."""
    with redirect_stdout(io.StringIO()):
        res = tune.tune_matmul_form(N, B, **KNOBS)
    assert _is_ab(res) and np.isfinite(res["ratio_median"])
