"""Profiling: analytic plan costs and timing on the device.

Counterpart of ``mixed_radix_fast_fourier_transform_tpu/utils/profiling.py``:

* :func:`plan_cost` and :func:`roofline_summary`: a flop/byte model per plan
  (stage by stage), for roofline reasoning about the stage pipeline;
* :func:`marginal_time` and :func:`ab_compare`: the time of one application
  of a function from the difference of a long and a short chain of
  applications, which cancels what a chain costs once; interleaved for an
  A/B comparison;
* :func:`graph_time`: the card's time of one call, from calls captured in a
  CUDA graph and replayed between CUDA events (no host gaps);
* :func:`trace`: a ``torch.profiler`` capture written as a Chrome trace;
* :func:`estimate_four_step_hbm` and :func:`require_four_step_hbm`: the
  device-memory budget of the sharded four-step transform on one card.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import time
from typing import Callable, List, Optional, Tuple

import torch

from .tree import tree_leaves


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
    this is the host's time per application; :func:`graph_time` replays a
    captured graph for the device time alone."""
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


def graph_time(fn: Callable, launches: int = 20, replays: int = 10) -> float:
    """Seconds of device time per call of ``fn()``: ``launches`` back-to-back
    calls captured in one CUDA graph, replayed ``replays`` times between two
    CUDA events, so no host gap lies between the calls.  ``fn`` takes no
    argument and must compute on the card: without one, or for a result
    tensor on another device, it raises ``ValueError`` (there is no host
    timing under this name)."""
    where = {t.device.type for t in tree_leaves(fn()) if isinstance(t, torch.Tensor)} - {"cuda"}
    if where or not torch.cuda.is_available():
        raise ValueError(
            f"graph_time times work on a CUDA device; fn returned tensors on "
            f"{sorted(where)}, CUDA available: {torch.cuda.is_available()}"
        )
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            for _ in range(launches):
                fn()
    torch.cuda.synchronize()
    for _ in range(3):
        graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e-3 / (launches * replays)


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


# The budget of one card: an H100 has 80 GB of device memory, of which the
# CUDA context, NCCL's buffers and the caching allocator's slack keep some.
CARD_MEMORY_GB = 80.0
CARD_MARGIN_GB = 4.0


def _card_budget_gb() -> float:
    """Device memory of card 0 less the margin, or the H100's 80 GB less the
    margin where there is no card (a CPU process planning for one)."""
    if torch.cuda.is_available():
        return torch.cuda.get_device_properties(0).total_memory / 2**30 - CARD_MARGIN_GB
    return CARD_MEMORY_GB - CARD_MARGIN_GB


def estimate_four_step_hbm(
    n: int, batch: int, parts: int, *, dtype_bytes: int = 4,
    copies: float = 6.0,
) -> dict:
    """Per-card device-memory estimate for the distributed four-step FFT
    (BASELINE config 5's class: transform length ``n``, total ``batch``,
    sharded over ``parts`` ranks on the sequence axis).

    Live working set per card = batch · (n/parts) · 2 planes · dtype_bytes a
    copy; ``copies`` bounds the copies alive at once (input, output, the
    all-to-all buffers, the contiguous copies around the fused kernel, the
    gradient's).  The default 6 is read on the card: at config 5 (n =
    65,536, batch 4,096, one rank, 2 GiB a copy) ``chip_smoke.py`` phase 25
    reads a peak of 10.0 GiB for a train step of the distributed filter and
    11.0 GiB for the "same" convolution on an H100 80GB HBM3 at 700 W, 5
    and 5.5 copies.  Plan constants are counted apart.  The byte formulas are
    the JAX package's, so both give the same bytes for the same arguments.
    Where the JAX function reports ``fits_v5e_16gb``, this one reports
    ``fits_h100_80gb``: the total against :data:`CARD_MEMORY_GB` less
    :data:`CARD_MARGIN_GB`."""
    shard = batch * (n // parts) * 2 * dtype_bytes
    # stage constants: bounded by 2·(n/parts)·max_stage entries per plane pair
    const = 4 * (n // parts) * 256 * dtype_bytes // 64
    total = copies * shard + const
    return {
        "per_copy_bytes": shard,
        "plan_const_bytes": const,
        "total_bytes": int(total),
        "total_gb": round(total / 2**30, 3),
        "fits_h100_80gb": bool(total < (CARD_MEMORY_GB - CARD_MARGIN_GB) * 2**30),
    }


class HBMBudgetError(ValueError):
    """A requested distributed transform exceeds the per-card memory budget:
    resource exhaustion is a checked error at the API boundary, never an
    out-of-memory error in the middle of a step."""


def require_four_step_hbm(
    n: int, batch: int, parts: int, *, limit_gb: Optional[float] = None,
    dtype_bytes: int = 4, copies: float = 6.0,
) -> dict:
    """Estimate the four-step working set and reject a configuration over
    budget.  ``limit_gb`` defaults to card 0's device memory less
    :data:`CARD_MARGIN_GB` (80 GB less the margin without a card).  Returns
    the :func:`estimate_four_step_hbm` dict when it fits; raises
    :class:`HBMBudgetError` naming the configuration and both numbers."""
    if limit_gb is None:
        limit_gb = _card_budget_gb()
    est = estimate_four_step_hbm(
        n, batch, parts, dtype_bytes=dtype_bytes, copies=copies
    )
    if est["total_gb"] > limit_gb:
        raise HBMBudgetError(
            f"distributed four-step n={n} batch={batch} over {parts} cards "
            f"needs ~{est['total_gb']} GB/card > budget {limit_gb} GB; "
            f"shard the batch further or raise parts"
        )
    return est
