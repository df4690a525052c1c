"""Profiling: analytic plan costs and timing on the device.

Counterpart of ``mixed_radix_fast_fourier_transform_tpu/utils/profiling.py``:

* :func:`plan_cost` and :func:`roofline_summary`: a flop/byte model per plan
  (stage by stage), for roofline reasoning about the stage pipeline;
* :func:`marginal_time` and :func:`ab_compare`: the time of one application
  of a function from the difference of a long and a short chain of
  applications, which cancels what a chain costs once; interleaved for an
  A/B comparison;
* :func:`trace`: a ``torch.profiler`` capture written as a Chrome trace.

The counterpart's memory estimates for the sharded four-step transform come
with ``parallel/``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import time
from typing import Callable, List, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class PlanCost:
    """Per-transform (single batch element) cost model."""

    n: int
    flops: float          # real flops through the stage products + twiddles
    hbm_bytes: float      # least device-memory traffic (one read + one write per stage)
    fft_model_flops: float  # canonical 5·N·log2(N) accounting

    @property
    def arithmetic_intensity(self) -> float:
        return self.flops / max(self.hbm_bytes, 1.0)


# real operations per complex point of a butterfly stage: radix-2 4 adds/2
# points; radix-4 16 adds/4 points; radix-8 32 + 8 (two √½ twiddles) + 16
# combine = 56/8 points; radix-16 two radix-8 halves + 7-twiddle combine
_BUTTERFLY_OPS = {2: 2.0, 4: 4.0, 8: 7.0, 16: 11.0}


def _mixed_radix_cost(plan, dtype_bytes: int = 4) -> PlanCost:
    from ..ops.stockham import BUTTERFLY_RADICES, KARATSUBA_MIN_STAGE  # ops import utils

    n = plan.n
    flops = 0.0
    bytes_ = 0.0
    for i, f in enumerate(plan.factors):
        # per stage: read + write both planes once
        bytes_ += 4.0 * n * dtype_bytes
        if plan.butterfly and f in BUTTERFLY_RADICES and f <= plan.butterfly_max:
            flops += _BUTTERFLY_OPS[f] * n
            continue
        # dense stage: the stacked form (one 2f-contraction real matmul)
        # costs 8·n·f, the Karatsuba form (three matmuls) 6·n·f
        flops += (6.0 if f >= KARATSUBA_MIN_STAGE else 8.0) * n * f
        # split twiddle multiply (all but the last stage): 6 flops per point
        if i < len(plan.factors) - 1:
            flops += 6.0 * n
    return PlanCost(
        n=n,
        flops=flops,
        hbm_bytes=bytes_,
        fft_model_flops=5.0 * n * math.log2(n) if n > 1 else 0.0,
    )


def plan_cost(plan, dtype_bytes: int = 4) -> PlanCost:
    """Analytic roofline model for any plan type of the stage pipeline."""
    from ..plan import BluesteinPlan, MixedRadixPlan, RaderPlan, RealPlan  # plan imports utils

    if isinstance(plan, MixedRadixPlan):
        return _mixed_radix_cost(plan, dtype_bytes)
    if isinstance(plan, RaderPlan):
        inner = _mixed_radix_cost(plan.inner, dtype_bytes)
        # two inner (n−1) transforms + kernel multiply + x0 adds, and the
        # two permutation gathers (one read+write pass over both planes each)
        return PlanCost(
            n=plan.n,
            flops=2 * inner.flops + 6.0 * (plan.n - 1) + 4.0 * plan.n,
            hbm_bytes=2 * inner.hbm_bytes + 4.0 * (4.0 * plan.n) * dtype_bytes,
            fft_model_flops=5.0 * plan.n * math.log2(plan.n),
        )
    if isinstance(plan, BluesteinPlan):
        inner = _mixed_radix_cost(plan.inner, dtype_bytes)
        # two inner transforms + 3 pointwise passes over m, 1 over n
        return PlanCost(
            n=plan.n,
            flops=2 * inner.flops + 6.0 * (3 * plan.m + plan.n),
            hbm_bytes=2 * inner.hbm_bytes + 4.0 * (3 * plan.m + plan.n) * dtype_bytes,
            fft_model_flops=5.0 * plan.n * math.log2(plan.n),
        )
    if isinstance(plan, RealPlan):
        inner = plan_cost(plan.inner, dtype_bytes)
        return PlanCost(
            n=plan.n,
            flops=inner.flops + 10.0 * plan.n,
            hbm_bytes=inner.hbm_bytes + 3.0 * plan.n * dtype_bytes,
            fft_model_flops=2.5 * plan.n * math.log2(plan.n) if plan.n > 1 else 0.0,
        )
    raise TypeError(f"unknown plan type {type(plan)!r}")


def roofline_summary(
    plan, measured_seconds: float, batch: int, *, dtype_bytes: int = 4
) -> dict:
    """Compare a measured per-application time against the plan's cost model."""
    cost = plan_cost(plan, dtype_bytes)
    return {
        "n": cost.n,
        "batch": batch,
        "seconds": measured_seconds,
        "gflops_fft_model": cost.fft_model_flops * batch / measured_seconds / 1e9,
        "gflops_actual": cost.flops * batch / measured_seconds / 1e9,
        "hbm_gbps_lower_bound": cost.hbm_bytes * batch / measured_seconds / 1e9,
        "arithmetic_intensity": cost.arithmetic_intensity,
    }


def _chain_seconds(fn: Callable, args: Tuple, iters: int) -> float:
    """Seconds that ``iters`` chained applications of ``fn`` take: outputs
    feed back as inputs, scaled to stay bounded.  On the card the chain sits
    between two CUDA events on the current stream; on the CPU it is timed
    with ``perf_counter``."""
    on_card = args[0].device.type == "cuda"
    if on_card:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    else:
        t0 = time.perf_counter()
    carry = tuple(args)
    for _ in range(iters):
        carry = tuple(o * 1e-3 for o in fn(*carry))
    if on_card:
        end.record()
        end.synchronize()
        return start.elapsed_time(end) * 1e-3
    return time.perf_counter() - t0


def marginal_time(
    fn: Callable,
    args: Tuple,
    *,
    short: int = 100,
    long: int = 500,
    reps: int = 3,
) -> float:
    """Seconds per application of ``fn(*args) -> same-structure outputs``.

    Times a chain of ``long`` and one of ``short`` applications (best of
    ``reps`` each, after one warm-up chain) and returns
    (T_long − T_short)/(long − short): what a chain costs once cancels.
    ``fn`` must map a tuple of tensors to a tuple of tensors of identical
    shapes and dtypes.  On the card the applications are dispatched back to
    back, so where the host dispatches them slower than the card runs them
    this is the host's time per application; ``kernel_bench.graph_us``
    replays a captured graph for the device time alone."""
    _chain_seconds(fn, args, short)  # build, plan and settle
    times = {}
    for iters in (short, long):
        times[iters] = min(_chain_seconds(fn, args, iters) for _ in range(reps))
    return max((times[long] - times[short]) / (long - short), 1e-12)


def ab_compare(
    fn_a: Callable,
    fn_b: Callable,
    args: Tuple,
    *,
    short: int = 100,
    long: int = 500,
    rounds: int = 5,
) -> dict:
    """Interleaved A/B timing: marginal_time(A) and marginal_time(B) back to
    back per round, and the per-round ratios.  Clocks, temperature and the
    host's other work drift over a run, so only interleaved pairs compare.
    Returns {'a_seconds': [...], 'b_seconds': [...], 'ratio_median': float},
    ratio > 1 meaning B is faster."""
    ta: List[float] = []
    tb: List[float] = []
    for _ in range(rounds):
        ta.append(marginal_time(fn_a, args, short=short, long=long, reps=1))
        tb.append(marginal_time(fn_b, args, short=short, long=long, reps=1))
    # a hiccup can make T_long < T_short, clamping a measurement to ~0:
    # those pairs carry no information, drop them
    valid = [(a, b) for a, b in zip(ta, tb) if a > 1e-9 and b > 1e-9]
    if not valid:
        raise RuntimeError("all A/B rounds degenerate (timing hiccups)")
    ratios = sorted(a / b for a, b in valid)
    return {
        "a_seconds": ta,
        "b_seconds": tb,
        "ratio_median": ratios[len(ratios) // 2],
    }


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the block (host activity, and
    the card's where there is one) and write it to ``log_dir/trace.json``
    as a Chrome trace (view with Perfetto).  Yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
