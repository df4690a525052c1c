"""Tuning harness: interleaved A/B comparisons of engine variants.

Counterpart of the JAX package's ``tools/tune.py``.  Every comparison is
timed twice:

* :func:`utils.profiling.ab_compare`: the marginal time of one application,
  A and B back to back in each round, so drift between rounds cancels;
* on the card, :func:`utils.profiling.graph_time` as well: the device time
  of one call from calls captured in a CUDA graph, with no host gap.

Usage (on the card unless ``--device cpu``)::

    python -m mixed_radix_fast_fourier_transform_tpu_torch.tools.tune stages 1024 256
    python -m ....tools.tune pad 10007 16          # Bluestein padding variants
    python -m ....tools.tune kernel 1024 256       # fused kernel vs stage pipeline
    python -m ....tools.tune kernel all            # every length the kernel takes
    python -m ....tools.tune builtin 1024 256      # the default route vs torch.fft
    python -m ....tools.tune dispatch 4096 8       # host µs a call: kernel, filter
    python -m ....tools.tune split 3600 64 120x30 144x25
    python -m ....tools.tune precision 1024 256    # the matmul precision ladder
    python -m ....tools.tune prec 1024 256 highest,high   # per-stage schemes
    python -m ....tools.tune split6 10007 16       # split6's product forms
    python -m ....tools.tune tf32emu               # "default" as TF32, on the CPU
    python -m ....tools.tune butterfly 65536 16
    python -m ....tools.tune matmul_form 1024 256  # stacked vs Karatsuba stages
    python -m ....tools.tune rader 1009 64         # Rader vs Bluestein
    python -m ....tools.tune nufft 4096 4096       # dense vs grid at (n, M)
    python -m ....tools.tune sortspread 4096 65536      # 1-D; 2-D with a trailing 2
    python -m ....tools.tune sht 256 16            # Hermitian vs full SHT

``--short S`` and ``--rounds R`` cut a probe's chains (long = 5·S).
``precision`` and ``prec`` print each scheme's error against numpy float64
beside its time against all-"highest": on the card "high" and "default" are
TF32 products, on the CPU they are fp32 (the decision needs both columns).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np
import torch

from .. import plan as P
from ..ops import cuda_fft, nufft as nf
from ..ops import stockham as st
from ..ops.sht import isht, sht
from ..ops.stockham import exec_complex, exec_len
from ..utils.config import DEFAULT_CONFIG, SpectralConfig
from ..utils.numerics import matmul_precision, resolve_device
from ..utils.profiling import ab_compare, graph_time, marginal_time

SWEEP_VALUES = 1 << 22   # complex values a call of the `kernel all` sweep
SWEEP_ERROR_ROWS = 8     # rows of each length held against float64


def _knobs(short, rounds, default_short: int, default_long: int, default_rounds: int = 5):
    """(short, long, rounds): the probe's defaults, or ``short`` with long =
    5·short and ``rounds`` where given."""
    if short is None:
        short, long = default_short, default_long
    else:
        long = 5 * short
    return short, long, default_rounds if rounds is None else rounds


def _planes(n: int, b: int, device, seed: int = 0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n)) + 1j * rng.standard_normal((b, n))
    dev = resolve_device(device)
    return (
        torch.tensor(x.real, dtype=torch.float32, device=dev),
        torch.tensor(x.imag, dtype=torch.float32, device=dev),
    ), x


def _rel(got: torch.Tensor, want: np.ndarray) -> float:
    got = got.detach().cpu().numpy()
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _report(name_a, name_b, res):
    ra = [f"{t * 1e6:.0f}" for t in res["a_seconds"]]
    rb = [f"{t * 1e6:.0f}" for t in res["b_seconds"]]
    print(f"  {name_a} us: {ra}")
    print(f"  {name_b} us: {rb}")
    print(f"  median ratio {name_a}/{name_b}: {res['ratio_median']:.3f} "
          f"(>1 means {name_b} faster)")
    if "a_device_us" in res:
        print(f"  device us per call (graph_time): {name_a} {res['a_device_us']}, "
              f"{name_b} {res['b_device_us']}")


def _device_us(fn, args):
    """graph_time of ``fn(*args)`` in µs, or None where the call cannot be
    captured in a CUDA graph (it copies a host table to the card)."""
    try:
        return graph_time(lambda: fn(*args)) * 1e6
    except RuntimeError as e:   # torch refuses the capture, naming the cause
        print(f"  graph_time: not capturable ({str(e).splitlines()[0]})")
        return None


def _compare(name_a, fn_a, name_b, fn_b, args, short, long, rounds) -> dict:
    """ab_compare of A and B, and on the card graph_time of each."""
    res = ab_compare(fn_a, fn_b, args, short=short, long=long, rounds=rounds)
    if args[0].device.type == "cuda":
        res["a_device_us"] = _device_us(fn_a, args)
        res["b_device_us"] = _device_us(fn_b, args)
    _report(name_a, name_b, res)
    return res


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def _run(plan):
    return lambda a, c: exec_complex(plan, a, c)


def tune_stages(n: int, b: int, *, device=None, short=None, rounds=None) -> dict:
    """The default stage split against ``max_stage`` 32/64/128/256."""
    short, long, rounds = _knobs(short, rounds, 100, 500)
    args, _ = _planes(n, b, device)
    base = P.build_complex_plan(n, -1, DEFAULT_CONFIG)
    print(f"baseline factors: {base.factors}")
    out = {"base": base.factors, "variants": {}}
    for max_stage in (32, 64, 128, 256):
        cfg = dataclasses.replace(DEFAULT_CONFIG, max_stage=max_stage)
        plan = P.build_complex_plan(n, -1, cfg)
        if getattr(plan, "factors", None) == base.factors:
            continue
        print(f"vs max_stage={max_stage} {getattr(plan, 'factors', type(plan).__name__)}:")
        out["variants"][max_stage] = _compare(
            "base", _run(base), str(getattr(plan, "factors", max_stage)), _run(plan),
            args, short, long, rounds)
    return out


def tune_pad(n: int, b: int, *, device=None, short=None, rounds=None) -> dict:
    """Bluestein's padded length: pow2 against pow23 and fast."""
    short, long, rounds = _knobs(short, rounds, 50, 250)
    args, _ = _planes(n, b, device)
    plans = {}
    for mode in ("pow2", "pow23", "fast"):
        plans[mode] = P.build_complex_plan(n, -1, dataclasses.replace(DEFAULT_CONFIG, pad_mode=mode))
        print(f"{mode}: m={getattr(plans[mode], 'm', None)}")
    out = {}
    for mode in ("pow23", "fast"):
        print(f"pow2 vs {mode}:")
        out[mode] = _compare("pow2", _run(plans["pow2"]), mode, _run(plans[mode]),
                             args, short, long, rounds)
    return out


def tune_kernel(n: int, b: int, *, device=None, short=None, rounds=None) -> dict:
    """The fused kernel against the stage pipeline at (n, b), with the
    kernel's error against float64 (on a CPU tensor the kernel's wrapper
    runs its plain PyTorch version)."""
    if not cuda_fft.supports(n):
        raise ValueError(f"the fused kernel does not take n = {n}")
    short, long, rounds = _knobs(short, rounds, 100, 500)
    (xr, xi), x = _planes(n, b, device)
    plan = P.build_complex_plan(n, -1, DEFAULT_CONFIG)
    zr, zi = cuda_fft.exec_kernel(xr, xi, n, -1)
    err = _rel(torch.complex(zr, zi), np.fft.fft(x, axis=-1))
    print(f"kernel err: {err:.2e}")
    res = _compare("pipeline", _run(plan), "kernel",
                   lambda a, c: cuda_fft.exec_kernel(a, c, n, -1), (xr, xi), short, long, rounds)
    return dict(res, kernel_err=err, factors=plan.factors)


def sweep_lengths():
    """Every length the fused kernel takes: the 7-smooth n <= 16,384."""
    return [n for n in range(2, cuda_fft.MAX_N + 1) if cuda_fft.supports(n)]


def tune_kernel_all(*, device=None, lengths=None, values: int = SWEEP_VALUES,
                    launches: int = 4, replays: int = 3, short: int = 10):
    """The per-length sweep that decided ``use_kernel``'s default: at every length
    the kernel takes (or ``lengths``), ``values // n`` rows, one JSON line
    with the time per call of the kernel, the stage pipeline and
    ``torch.fft.fft`` on the same values, and the kernel's error against
    float64 on 8 rows; then a summary line.  On the card the times are
    :func:`graph_time` (``launches`` calls a graph, ``replays`` replays); on
    the CPU they are :func:`marginal_time` (host clock, chains of ``short``
    and 5·``short``), and the line says which.  Returns (rows, summary)."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    timer = "graph_time" if on_card else "marginal_time"
    gen = torch.Generator(device=dev).manual_seed(0)
    base_r = torch.randn(values, generator=gen, device=dev)
    base_i = torch.randn(values, generator=gen, device=dev)
    rows = []
    for n in sweep_lengths() if lengths is None else lengths:
        b = values // n
        xr = base_r[: b * n].view(b, n)
        xi = base_i[: b * n].view(b, n)
        xc = torch.complex(xr, xi)
        plan = P.get_plan(n, -1, "complex", DEFAULT_CONFIG)
        routes = {
            "kernel": lambda: cuda_fft.exec_kernel(xr, xi, n, -1),
            "pipeline": lambda: exec_complex(plan, xr, xi),
            "torch_fft": lambda: torch.fft.fft(xc),
        }
        row = {"n": n, "rows": b, "device": dev.type, "timer": timer}
        for name, fn in routes.items():
            if on_card:
                secs = graph_time(fn, launches=launches, replays=replays)
            else:
                secs = marginal_time(lambda *_, f=fn: _as_tuple(f()), (xr,), short=short,
                                     long=5 * short, reps=1)
            row[f"{name}_us"] = secs * 1e6
        k = min(SWEEP_ERROR_ROWS, b)
        zr, zi = cuda_fft.exec_kernel(xr[:k], xi[:k], n, -1)
        want = np.fft.fft(torch.complex(xr[:k], xi[:k]).cpu().numpy().astype(np.complex128))
        row["kernel_err"] = _rel(torch.complex(zr, zi), want)
        print(json.dumps(row), flush=True)
        rows.append(row)
        del xc
        if on_card:
            torch.cuda.empty_cache()

    def worst(key):
        r = max(rows, key=lambda r: r["kernel_us"] / r[key])
        return {"n": r["n"], "ratio": r["kernel_us"] / r[key]}

    summary = {
        "lengths": len(rows), "device": dev.type, "timer": timer, "values": values,
        "kernel_beats_pipeline": [r["n"] for r in rows if r["kernel_us"] < r["pipeline_us"]],
        "kernel_loses_to_pipeline": [r["n"] for r in rows if r["kernel_us"] >= r["pipeline_us"]],
        "kernel_beats_torch_fft": [r["n"] for r in rows if r["kernel_us"] < r["torch_fft_us"]],
        "worst_kernel_over_pipeline": worst("pipeline_us"),
        "worst_kernel_over_torch_fft": worst("torch_fft_us"),
        "max_kernel_err": max(r["kernel_err"] for r in rows),
    }
    print(json.dumps({"summary": summary}), flush=True)
    return rows, summary


def tune_builtin(n: int, b: int, *, device=None, short=None, rounds=None) -> dict:
    """The library's default route (``exec_len``) against ``torch.fft.fft``."""
    short, long, rounds = _knobs(short, rounds, 500, 2500)
    args, _ = _planes(n, b, device)

    def builtin(a, c):
        z = torch.fft.fft(torch.complex(a, c))
        return z.real, z.imag

    route = "kernel" if cuda_fft.uses_kernel(DEFAULT_CONFIG, n, args[0]) else "stage pipeline"
    print(f"ours: exec_len, the default route at n={n} on {args[0].device.type}: {route}")
    return _compare("builtin", builtin, "ours",
                    lambda a, c: exec_len(DEFAULT_CONFIG, n, -1, a, c), args, short, long, rounds)


def tune_dispatch(n: int, b: int, *, device=None, short=None, rounds=None) -> dict:
    """The host's cost of a call through the fused kernel's binding: wall µs
    per call of ``short`` back-to-back calls on the same inputs (synchronised
    at the end), best of ``rounds`` rounds with the variants interleaved in
    each, and the median µs of one call timed alone (``short / 4`` a round,
    CUDA events on the card), for ``torch.fft.fft`` on (b, n/2) planes (the
    control),
    ``exec_kernel`` on them with and without planes that need a gradient,
    and the spectral filter's forward and SGD step at (b, n), whose inner
    transforms are those planes' length.  At a small batch the card ends a
    call before the host issues the next, so these are host times: run it
    from two checkouts (parent, change, change, parent) to A/B a change of
    the binding."""
    import time

    from ..models import spectral_filter as sf

    short, _, rounds = _knobs(short, rounds, 200, 200)
    (xr, xi), _ = _planes(n // 2, b, device)
    gr, gi = (t.clone().requires_grad_(True) for t in (xr, xi))
    dev = xr.device
    params = sf.init_params(n, generator=torch.Generator().manual_seed(0), device=dev)
    x = torch.tensor(np.random.default_rng(1).standard_normal((b, n)), dtype=torch.float32,
                     device=dev)
    variants = {
        "torch.fft.fft": lambda: torch.fft.fft(torch.complex(xr, xi)),
        "exec_kernel": lambda: cuda_fft.exec_kernel(xr, xi, n // 2, -1),
        "exec_kernel, planes needing a gradient": lambda: cuda_fft.exec_kernel(
            gr, gi, n // 2, -1),
        "filter forward": lambda: sf.apply(params, x),
        "filter train step": lambda: sf.train_step(params, x, x, lr=1e-3),
    }

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def one_call(fn) -> float:
        if dev.type != "cuda":
            t0 = time.perf_counter()
            fn()
            return (time.perf_counter() - t0) * 1e6
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) * 1e3

    best = {name: float("inf") for name in variants}
    alone = {name: [] for name in variants}
    for fn in variants.values():
        fn()
    for _ in range(rounds):
        for name, fn in variants.items():
            sync()
            t0 = time.perf_counter()
            for _ in range(short):
                fn()
            sync()
            best[name] = min(best[name], (time.perf_counter() - t0) / short * 1e6)
            alone[name] += [one_call(fn) for _ in range(max(short // 4, 1))]
    route = "kernel" if cuda_fft.uses_kernel(DEFAULT_CONFIG, n // 2, xr) else "stage pipeline"
    out = {"n": n, "batch": b, "device": dev.type, "filter_route": route,
           "calls": short, "rounds": rounds, "host_us_per_call": best,
           "one_call_us": {name: float(np.median(v)) for name, v in alone.items()}}
    print(json.dumps({"dispatch": out}), flush=True)
    return out


def _err_of(plan, args, want) -> float:
    zr, zi = exec_complex(plan, *args)
    return _rel(torch.complex(zr, zi), want)


def tune_precision(n: int, b: int, *, device=None, short=None, rounds=None) -> dict:
    """The stage products' precision ladder: each precision's error against
    numpy float64, and "highest" against each of the others."""
    short, long, rounds = _knobs(short, rounds, 100, 500)
    args, x = _planes(n, b, device)
    want = np.fft.fft(x, axis=-1)
    plans, out = {}, {}
    for prec in ("highest", "high", "default", "split6"):
        plans[prec] = P.build_complex_plan(
            n, -1, dataclasses.replace(DEFAULT_CONFIG, precision=prec))
        out[prec] = {"err": _err_of(plans[prec], args, want)}
        print(f"{prec}: err {out[prec]['err']:.2e}")
    for prec in ("high", "default", "split6"):
        print(f"highest vs {prec}:")
        out[prec].update(_compare("highest", _run(plans["highest"]), prec, _run(plans[prec]),
                                  args, short, long, rounds))
    return out


def tune_prec(n: int, b: int, cands, *, device=None, short=None, rounds=None) -> dict:
    """Per-stage precision schemes against all-"highest": ``cands`` are
    comma-joined per-stage names, "highest,high" (stage 0 "highest", the
    rest "high").  Each scheme's error against numpy float64 beside its
    time (the budget is 1e-5)."""
    short, long, rounds = _knobs(short, rounds, min(500, max(50, 700_000 // n)),
                                 5 * min(500, max(50, 700_000 // n)))
    args, x = _planes(n, b, device)
    want = np.fft.fft(x, axis=-1)
    base = P.build_complex_plan(n, -1, DEFAULT_CONFIG)
    print(f"N={n} b={b} factors={getattr(base, 'factors', type(base).__name__)}")
    out = {"all-highest": {"err": _err_of(base, args, want)}}
    print(f"  all-highest: err {out['all-highest']['err']:.2e}")
    for cand in cands:
        scheme = tuple(v.strip() for v in cand.split(","))
        plan = P.build_complex_plan(n, -1, dataclasses.replace(DEFAULT_CONFIG, precision=scheme))
        err = _err_of(plan, args, want)
        print(f"scheme {scheme}: err {err:.2e}")
        out[cand] = dict(_compare("all-highest", _run(base), cand, _run(plan),
                                  args, short, long, rounds), err=err)
    return out


def _split6_form(form: str):
    """split6's stage product (``stockham._einsum_split6``) in a tensor-core
    form the library does not take: "tf32" multiplies the fp32 copies of the
    bf16-exact chunks with TF32 allowed, "bf16" the bf16 chunks themselves
    with an fp32 output (``torch.mm(..., out_dtype=torch.float32)``, on the
    card only)."""
    def product(axis, x, w):
        x1, x2, x3 = st._bf16_chunks3(x)
        w1, w2, w3 = st._bf16_chunks3(w)
        xs = torch.cat([x1, x1, x2, x1, x2, x3], dim=axis)
        ws = torch.cat([w1, w2, w1, w3, w2, w1], dim=0)
        if axis == -2:
            xs, ws = ws.transpose(0, 1), xs
        if form == "tf32":
            with matmul_precision("high"):
                return torch.matmul(xs.float(), ws.float())
        if xs.ndim == 2:   # (m, n) @ (..., n, k): columns of ws side by side
            lead = ws.shape[:-2]
            cols = ws.movedim(-2, 0).reshape(ws.shape[-2], -1)
            out = torch.mm(xs, cols, out_dtype=torch.float32)
            return out.reshape((xs.shape[0],) + tuple(lead) + (ws.shape[-1],)).movedim(0, -2)
        out = torch.mm(xs.reshape(-1, xs.shape[-1]), ws, out_dtype=torch.float32)
        return out.reshape(tuple(xs.shape[:-1]) + (ws.shape[-1],))
    return product


def tune_split6(n: int, b: int, *, device=None, short=None, rounds=None) -> dict:
    """split6's product forms on one plan: the library's IEEE fp32 form
    against the TF32 and bf16 tensor-core forms, each form's error against
    numpy float64 (split6's bound is 5e-6) beside its device time."""
    args, x = _planes(n, b, device)
    want = np.fft.fft(x, axis=-1)
    plan = P.build_complex_plan(n, -1, dataclasses.replace(DEFAULT_CONFIG, precision="split6"))
    on_card = args[0].device.type == "cuda"
    kept, out = st._einsum_split6, {}
    for form in ("fp32", "tf32", "bf16"):
        if form == "bf16" and not on_card:
            print("bf16: the card's form only (torch.mm with out_dtype)")
            continue
        if form != "fp32":
            st._einsum_split6 = _split6_form(form)
        try:
            out[form] = {"err": _err_of(plan, args, want)}
            if on_card:
                out[form]["device_us"] = _device_us(_run(plan), args)
        finally:
            st._einsum_split6 = kept
        print(f"split6 {form} form: err {out[form]['err']:.2e}"
              + (f", device us {out[form]['device_us']}" if on_card else ""))
    return out


# chip_smoke.py phase 4b's pipeline shapes (n, rows)
PHASE_4B_SHAPES = ((1009, 64), (10007, 16), (32768, 16), (65536, 16), (1024, 256))


def tune_tf32emu(shapes=PHASE_4B_SHAPES) -> dict:
    """The stage pipeline's error against numpy float64 at "default" with
    its products emulated as TF32 on the CPU (each operand's 13 low mantissa
    bits rounded to nearest, or cut, then an fp32 product), at ``shapes``
    (phase 4b's), one generator across them: what the card's TF32 error can
    be held against."""
    def tf32(v, nearest):
        bits = v.contiguous().view(torch.int32)
        return ((bits + 0x1000 if nearest else bits) & ~0x1FFF).view(torch.float32)

    kept = st._dot

    def emulated(nearest):
        def dot(axis, a, w, precision):
            if precision in ("high", "default") and a.dtype == torch.float32:
                return kept(axis, tf32(a, nearest), tf32(w, nearest), "highest")
            return kept(axis, a, w, precision)
        return dot

    cfg = dataclasses.replace(DEFAULT_CONFIG, precision="default", use_kernel=False)
    rng = np.random.default_rng(0)
    out = {}
    for n, b in shapes:
        x = rng.standard_normal((b, n)) + 1j * rng.standard_normal((b, n))
        xt = torch.from_numpy(x.astype(np.complex64))
        errs = []
        for nearest in (True, False):
            st._dot = emulated(nearest)
            try:
                zr, zi = exec_len(cfg, n, -1, xt.real.contiguous(), xt.imag.contiguous())
            finally:
                st._dot = kept
            errs.append(_rel(torch.complex(zr, zi), np.fft.fft(x)))
        out[n] = {"rounded": errs[0], "cut": errs[1]}
        print(f"n={n} b={b}: TF32-emulated default, rounded {errs[0]:.2e}, cut {errs[1]:.2e}")
    return out


def _plan_with(n: int, stages=None, butterfly=None):
    """The plan of n with ``stages`` forced as its split (plan_stages
    replaced for this one build) and ``butterfly`` set where given."""
    orig = P.plan_stages
    if stages is not None:
        P.plan_stages = lambda nn, ms, strategy="balanced": (
            tuple(stages) if nn == n else orig(nn, ms, strategy))
    try:
        plan = P.build_complex_plan(n, -1, DEFAULT_CONFIG)
    finally:
        P.plan_stages = orig
    return plan if butterfly is None else dataclasses.replace(plan, butterfly=butterfly)


def tune_split(n: int, b: int, cands, *, device=None, short=None, rounds=None) -> dict:
    """The default plan against explicit stage splits ("120x30", "128x96x2")."""
    short, long, rounds = _knobs(short, rounds, min(500, max(50, 700_000 // n)),
                                 5 * min(500, max(50, 700_000 // n)))
    args, _ = _planes(n, b, device)
    base = _plan_with(n)
    print(f"N={n} b={b} base factors: {base.factors}")
    out = {}
    for cand in cands:
        stages = tuple(int(s) for s in cand.lower().split("x"))
        if int(np.prod(stages)) != n:
            raise ValueError(f"{stages} does not multiply to {n}")
        print(f"vs {stages}:")
        out[cand] = _compare("base", _run(base), str(stages), _run(_plan_with(n, stages)),
                             args, short, long, rounds)
    return out


def tune_butterfly(n: int, b: int, *, device=None, short=None, rounds=None) -> dict:
    """Small-stage butterflies: with a 16 in the plan, matmul-16 against
    butterflies up to 8 and up to 16; otherwise the 2/4/8 remainder moved to
    the front factor and each ordering as a butterfly."""
    short, long, rounds = _knobs(short, rounds, min(500, max(50, 700_000 // n)),
                                 5 * min(500, max(50, 700_000 // n)))
    args, x = _planes(n, b, device)
    base = _plan_with(n, butterfly=False)
    want = np.fft.fft(x)
    if 16 in base.factors:
        cands = [("bfly-to-8", dataclasses.replace(_plan_with(n, butterfly=True), butterfly_max=8)),
                 ("bfly-to-16", dataclasses.replace(_plan_with(n, butterfly=True), butterfly_max=16))]
    else:
        small = [f for f in base.factors if f in (2, 4, 8)]
        if not small:
            print(f"N={n} default factors {base.factors} have no small stage")
            return {}
        tail = small[0]
        front = tuple([tail] + [f for f in base.factors if f != tail])
        cands = [("front-matmul", _plan_with(n, front, butterfly=False)),
                 ("tail-bfly", _plan_with(n, butterfly=True)),
                 ("front-bfly", _plan_with(n, front, butterfly=True))]
    print(f"N={n} b={b} base factors: {base.factors}")
    out = {}
    for name, plan in cands:
        gr, gi = exec_complex(plan, *args)
        err = _rel(torch.complex(gr, gi), want)
        print(f"{name}: rel err vs fp64 {err:.2e}")
        out[name] = dict(_compare("base", _run(base), name, _run(plan), args, short, long, rounds),
                         err=err)
    return out


def tune_matmul_form(n: int, b: int, *, device=None, short=None, rounds=None) -> dict:
    """Stacked against Karatsuba stage products, by moving the crossover
    (``ops/stockham.py::KARATSUBA_MIN_STAGE``) past every stage or below."""
    short, long, rounds = _knobs(short, rounds, 500, 2500)
    args, _ = _planes(n, b, device)
    plan = P.build_complex_plan(n, -1, DEFAULT_CONFIG)
    print(f"factors={plan.factors}  crossover={st.KARATSUBA_MIN_STAGE}")

    def with_threshold(t):
        def fn(a, c):
            old = st.KARATSUBA_MIN_STAGE
            st.KARATSUBA_MIN_STAGE = t
            try:
                return exec_complex(plan, a, c)
            finally:
                st.KARATSUBA_MIN_STAGE = old
        return fn

    return _compare("stacked", with_threshold(10 ** 9), "karatsuba", with_threshold(1),
                    args, short, long, rounds)


def tune_rader(n: int, b: int, *, device=None, short=None, rounds=None) -> dict:
    """Rader against Bluestein at a prime n with smooth n - 1."""
    short, long, rounds = _knobs(short, rounds, 200, 1000)
    args, _ = _planes(n, b, device)
    rader = P.build_complex_plan(n, -1, SpectralConfig(rader="auto"))
    blue = P.build_complex_plan(n, -1, SpectralConfig(rader="off"))
    print(f"rader inner={getattr(getattr(rader, 'inner', None), 'factors', None)}  "
          f"bluestein m={getattr(blue, 'm', None)}")
    return _compare("bluestein", _run(blue), "rader", _run(rader), args, short, long, rounds)


def _fit(v: torch.Tensor, m: int) -> torch.Tensor:
    """``v`` flattened, zero-padded or cut to m values (the timing chain
    feeds outputs back as inputs of the same shape)."""
    v = v.reshape(-1)
    return torch.cat([v, v.new_zeros(max(0, m - v.shape[0]))])[:m]


def tune_nufft(n: int, m: int, *, device=None, short=None, rounds=None) -> dict:
    """Dense against grid type-1 NUFFT at (n modes, m points), and their
    difference."""
    short, long, rounds = _knobs(short, rounds, 50, 250)
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.uniform(0, 2 * np.pi, m), dtype=torch.float32, device=dev)
    cr = torch.tensor(rng.standard_normal(m), dtype=torch.float32, device=dev)
    ci = torch.tensor(rng.standard_normal(m), dtype=torch.float32, device=dev)

    def t1(method):
        def g(a, c):
            out = nf.nufft1(x, torch.complex(a, c), n, method=method)
            return _fit(out.real, m), _fit(out.imag, m)
        return g

    zr, zi = t1("grid")(cr, ci)
    wr, wi = t1("dense")(cr, ci)
    err = _rel(torch.complex(zr, zi), torch.complex(wr, wi).cpu().numpy())
    print(f"grid-vs-dense err: {err:.2e}")
    return dict(_compare("dense", t1("dense"), "grid", t1("grid"), (cr, ci), short, long, rounds),
                err=err)


def tune_sortspread(n: int, m: int, ndim: int = 1, *, device=None, short=None,
                    rounds=None) -> dict:
    """The grid path's spreading: scatter (``index_add_``, the default)
    against sorted-cell segment sums, at (n modes an axis, m points); the
    crossover ``_SORTED_MIN_M`` / ``_SORTED_MIN_M_2D`` would be set from it."""
    short, long, rounds = _knobs(short, rounds, 20, 100)
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.uniform(0, 2 * np.pi, m), dtype=torch.float32, device=dev)
    y = torch.tensor(rng.uniform(0, 2 * np.pi, m), dtype=torch.float32, device=dev)
    cr = torch.tensor(rng.standard_normal(m), dtype=torch.float32, device=dev)
    ci = torch.tensor(rng.standard_normal(m), dtype=torch.float32, device=dev)
    mr, tau, msp = nf._grid_params(n, 1e-6)
    if ndim == 1:
        def scatter(a, c):
            g = nf._spread(x, torch.complex(a, c), mr, tau, msp)
            return _fit(g.real, m), _fit(g.imag, m)

        def srt(a, c):
            g = nf._spread_sorted(x, torch.complex(a, c), mr, tau, msp)
            return _fit(g.real, m), _fit(g.imag, m)
    else:
        mrs, taus = (mr, mr), (tau, tau)

        def scatter(a, c):
            g = nf._spread_2d(x, y, torch.complex(a, c), mrs, taus, msp)
            return _fit(g.real, m), _fit(g.imag, m)

        def srt(a, c):
            g = nf._spread_sorted_2d(x, y, torch.complex(a, c), mrs, taus, msp)
            return _fit(g.real, m), _fit(g.imag, m)

    zr, _ = scatter(cr, ci)
    wr, _ = srt(cr, ci)
    diff = float((zr - wr).abs().max())
    print(f"mr={mr} msp={msp} scatter-vs-sorted re-plane err: {diff:.2e}")
    return dict(_compare("scatter", scatter, "sorted", srt, (cr, ci), short, long, rounds),
                err=diff)


def tune_sht(L: int, b: int, *, device=None, short=None, rounds=None) -> dict:
    """Hermitian against full-path SHT round trip at band limit L."""
    short, long, rounds = _knobs(short, rounds, 20, 100)
    rng = np.random.default_rng(0)
    f0 = torch.tensor(rng.standard_normal((b, L, 2 * L)), dtype=torch.float32,
                      device=resolve_device(device))

    def rt_fast(g):
        return (isht(sht(g), real_output=True).to(torch.float32),)

    def rt_full(g):
        return (isht(sht(g.to(torch.complex64))).real.to(torch.float32),)

    return _compare("full", rt_full, "hermitian", rt_fast, (f0,), short, long, rounds)


PROBES = {
    "stages": tune_stages, "pad": tune_pad, "kernel": tune_kernel, "builtin": tune_builtin,
    "matmul_form": tune_matmul_form, "rader": tune_rader, "butterfly": tune_butterfly,
    "nufft": tune_nufft, "sht": tune_sht, "precision": tune_precision,
    "split6": tune_split6, "dispatch": tune_dispatch,
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m mixed_radix_fast_fourier_transform_tpu_torch.tools.tune")
    ap.add_argument("which", nargs="?", default="stages")
    ap.add_argument("n", nargs="?", default="1024")
    ap.add_argument("b", nargs="?", type=int, default=256)
    ap.add_argument("extra", nargs="*")
    ap.add_argument("--device", default=None)
    ap.add_argument("--short", type=int, default=None)
    ap.add_argument("--rounds", type=int, default=None)
    a = ap.parse_args(argv)
    knobs = dict(device=a.device, short=a.short, rounds=a.rounds)
    # the timing chains scale each output by 1e-3 and feed it back, so values
    # fall through the subnormal range, where a CPU's float units run many
    # times slower; flushed to zero they time as any other data
    flush = resolve_device(a.device).type == "cpu"
    torch.set_flush_denormal(flush)
    try:
        if a.which == "kernel" and a.n == "all":
            tune_kernel_all(device=a.device)
        elif a.which == "split":
            tune_split(int(a.n), a.b, a.extra, **knobs)
        elif a.which == "prec":
            tune_prec(int(a.n), a.b, a.extra or ["highest,high"], **knobs)
        elif a.which == "tf32emu":
            tune_tf32emu()
        elif a.which == "sortspread":
            tune_sortspread(int(a.n), a.b, int(a.extra[0]) if a.extra else 1, **knobs)
        elif a.which in PROBES:
            PROBES[a.which](int(a.n), a.b, **knobs)
        else:
            ap.error(f"unknown probe {a.which!r}; one of "
                     f"{sorted(PROBES) + ['prec', 'split', 'sortspread', 'tf32emu']}")
    finally:
        torch.set_flush_denormal(False)
    return 0


if __name__ == "__main__":
    sys.exit(main())
