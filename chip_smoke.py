"""Drive the PyTorch port's main path once on an NVIDIA GPU and check it.

    python3 chip_smoke.py

Needs one CUDA device and the CUDA toolkit (``nvcc``); there is no CPU path.
Phases, each of which raises on failure:

1. setup: the card's name and power limit, TF32 off for matmuls and cuDNN;
2. build the kernel library from ``csrc/`` (timed);
3. the fused Stockham kernel against its plain PyTorch version on the card,
   on random rows of every length class it takes;
4. the main path: the spectral filter forward (rfft → gain → irfft + bias)
   at n = 4096, batch 8 and 1024, against a float64 numpy oracle, with the
   kernel's launches counted; then the kernel against its plain version on
   the planes the forward handed it (n = 2048, both signs);
5. the core FFT lengths of the reference benchmark against numpy float64;
6. CUDA-event timings of the kernel, its plain version, the stage pipeline
   and ``torch.fft`` at the kernel-eligible shapes, and the filter's device
   time (torch.profiler) against its back-to-back wall time;
7. the kernel against its yardstick, ``torch.fft.fft`` (cuFFT), at six
   shapes: device time of 20 back-to-back launches replayed from a CUDA
   graph and timed with CUDA events, beside the bytes bound;
8. training: five ``train_step``s of the spectral filter at n = 4096, batch
   8 and 1024, with the kernel on: 3 launches a step (4 when the input
   needs a gradient), the first step's gradients against a float64
   ``torch.fft`` oracle on the CPU and against the stage pipeline on the
   card, the losses against the oracle's, and the kernel against its plain
   version on the planes each launch was handed, the backward's cotangent
   planes among them;
9. the 1-D Fourier neural operator at the Burgers configuration of Li et
   al. (width 64, 16 modes, 4 layers, batch 20) on the full grid n = 8192:
   forward and one ``train_step`` against the stage pipeline, launches
   counted; a small 2-D case (64 × 64) for transforms over a non-last axis;
10. the rest of the API from numpy input without a device, which must land
    on the card: the ``compat`` round trips, overlap-add and direct
    convolution (cuDNN in full fp32), ``hfft`` and ``dht``;
11. device and back-to-back wall time of one ``train_step``.

The last lines are one JSON line about the kernels (launches of phases 4, 8
and 9; error over the plane pairs those launches were handed: every pair of
phases 4 and 9, and in phase 8 the first step's three, every later
backward's and the four of the step with an input gradient; times on the
main path's batch-1024 planes), the card, then ``{"ok": true, "device":
{...}}``.
"""

from __future__ import annotations

import contextlib
import json
import math
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import mixed_radix_fast_fourier_transform_tpu_torch as tp
from kernel_bench import SHAPES as YARDSTICK_SHAPES, graph_us, wrapper_us
from mixed_radix_fast_fourier_transform_tpu_torch import compat
from mixed_radix_fast_fourier_transform_tpu_torch.models import fno
from mixed_radix_fast_fourier_transform_tpu_torch.ops import _build, cuda_fft
from mixed_radix_fast_fourier_transform_tpu_torch.ops.stockham import exec_complex
from mixed_radix_fast_fourier_transform_tpu_torch.utils.tree import tree_leaves, tree_map

SEED = 0
KERNEL_TOL = 2e-5   # kernel vs plain version, as the JAX kernel's tests hold it
ORACLE_TOL = 1e-5   # vs numpy float64: the library's error budget
# two fp32 routes (kernel, stage pipeline), each within ORACLE_TOL of the truth
ROUTES_TOL = 2 * ORACLE_TOL
FILTER_N = 4096
FILTER_BATCHES = (8, 1024)
# 90: n % 4 != 0, rows not 16-byte aligned; 16384: the longest length
KERNEL_LENGTHS = (8, 32, 64, 90, 360, 1024, 2048, 4096, 5040, 8192, 12005, 12288, 16384)
# NVIDIA H100 SXM peaks (data sheet): HBM bytes/s and fp32 FLOP/s
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
KERNEL_SOURCE = "mixed_radix_fast_fourier_transform_tpu_torch/csrc/stockham_fft.cu"
KERNEL_REPLACES = "mixed_radix_fast_fourier_transform_tpu/ops/pallas_fft.py:193"
PIPELINE = tp.SpectralConfig(use_kernel=False)
TRAIN_STEPS = 5
# the loss's curvature is 2 in the bias and ~4/n in a gain: the step that
# settles the bias at once moves each gain by ~1e-3 of its error
TRAIN_LR = 0.5
# 1-D FNO for Burgers' equation, Li et al. (arXiv 2010.08895): width 64, 16
# modes, 4 Fourier layers, batch 20, inputs (a(x), x) on the 8192-point grid
FNO = dict(in_channels=2, hidden=64, out_channels=1, n_layers=4, modes=16)
FNO_BATCH, FNO_GRID = 20, 8192
FNO2D = dict(in_channels=1, hidden=32, out_channels=1, n_layers=2, modes=12)
FNO2D_BATCH, FNO2D_GRID = 4, (64, 64)


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_err(got, want) -> float:
    got = np.asarray(got)
    want = np.asarray(want)
    if not np.all(np.isfinite(got)):
        return float("inf")
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def planes(x: np.ndarray):
    return (
        torch.tensor(x.real, dtype=torch.float32, device="cuda"),
        torch.tensor(x.imag, dtype=torch.float32, device="cuda"),
    )


def time_ms(fn, warmup: int = 10, runs: int = 50) -> float:
    """Median CUDA-event time of one call, after warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_and_wall_us(fn, calls: int = 20) -> dict:
    """Per call, in one process on the same inputs: ``device_us``, the summed
    device-kernel time of ``calls`` calls under torch.profiler (None where
    the profiler saw no device activity); ``wall_us``, the wall time of
    ``calls`` back-to-back calls without it (CUDA events); ``idle_share``,
    1 - device_us / wall_us; ``kernels``, the device kernels (and copies) per
    call; ``k1_us``, the fused kernel's part of the device time; and
    ``by_name``, the device µs per call by kernel name, largest first."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    wall_us = start.elapsed_time(end) * 1000.0 / calls
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    on_card = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    dev = sum(e.device_time_total for e in on_card)
    k1 = sum(e.device_time_total for e in on_card if "stockham_fft_kernel" in e.name)
    by_name = {}
    for e in on_card:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total / calls
    by_name = dict(sorted(by_name.items(), key=lambda kv: -kv[1]))
    device_us = dev / calls if dev > 0 else None
    return {"device_us": device_us, "wall_us": wall_us,
            "idle_share": None if device_us is None else 1.0 - device_us / wall_us,
            "kernels": len(on_card) / calls, "k1_us": k1 / calls, "by_name": by_name}


def fft_bound_ms(n: int, rows: int):
    """Least time for ``rows`` length-n complex FFTs on fp32 planes: each
    plane read once and written once (16·n bytes a row) at the HBM rate,
    against 5·n·log2(n) flops a row at the fp32 rate; the larger, and which."""
    by_bytes = 16.0 * n * rows / HBM_BYTES_PER_S * 1e3
    by_ops = 5.0 * n * math.log2(n) * rows / FP32_FLOP_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def setup() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only on an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    return smi


def build() -> float:
    t0 = time.perf_counter()
    _build.library()
    secs = time.perf_counter() - t0
    log(f"build: {_build.LIB_PATH.name} in {secs:.2f} s (nvcc {_build.BUILD_SECONDS:.2f} s)")
    # ptxas -v: registers, stack and spills of every kernel instantiation
    name = None
    for line in _build.PTXAS_LOG.read_text().splitlines():
        m = re.search(r"stockham_fft_kernelILi(n?)1ELi(\d+)ELi(\d+)E", line)
        if "Compiling entry function" in line and m:
            name = f"stockham_fft_kernel<sign={'-' if m.group(1) else '+'}1, elems={m.group(2)}, bound={m.group(3)}>"
        elif name and ("spill" in line or "registers" in line):
            log(f"ptxas {name}: {line.split(':', 1)[-1].strip()}")
    return secs


def kernel_error(xr, xi, n: int, sign: int, what: str) -> float:
    """Checks the kernel against its plain version on (xr, xi): raises past
    KERNEL_TOL relative to max |plain|; returns the max abs error."""
    kr, ki = cuda_fft.exec_kernel(xr, xi, n, sign)
    torch.cuda.synchronize()
    rr, ri = cuda_fft.exec_kernel_reference(xr, xi, n, sign)
    got = torch.complex(kr, ki).cpu().numpy()
    want = torch.complex(rr, ri).cpu().numpy()
    err = rel_err(got, want)
    log(f"kernel vs plain {what} n={n} planes {tuple(got.shape)} sign={sign:+d}: "
        f"rel err {err:.3e}")
    require(err <= KERNEL_TOL, f"kernel disagrees with its plain version at n={n} ({what})")
    return float(np.max(np.abs(got - want)))


def kernel_vs_plain(rng) -> None:
    """The kernel against its plain version on random rows of every length
    class it takes: powers of two, 7-smooth mixes, up to n = 12288."""
    for n in KERNEL_LENGTHS:
        for sign in (-1, 1):
            x = rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n))
            kernel_error(*planes(x), n, sign, "random")


def filter_params(rng, n: int):
    n_bins = n // 2 + 1
    return {
        "gain_re": 1.0 + 0.01 * rng.standard_normal(n_bins),
        "gain_im": 0.01 * rng.standard_normal(n_bins),
        "bias": np.array(0.1),
    }


@contextlib.contextmanager
def recorded_launches():
    """Inside the block, every call of the kernel's wrapper (forward or
    backward: both look ``cuda_fft.exec_kernel`` up at call time) is noted
    as (xr, xi, n, sign) with copies of the planes it was handed."""
    seen = []
    launch = cuda_fft.exec_kernel

    def recording(xr, xi, n, sign):
        seen.append((xr.detach().clone(), xi.detach().clone(), n, sign))
        return launch(xr, xi, n, sign)

    cuda_fft.exec_kernel = recording
    try:
        yield seen
    finally:
        cuda_fft.exec_kernel = launch


def main_path(rng):
    """Spectral filter forward on the card against the float64 oracle, then
    the kernel against its plain version on the very planes the forward
    handed it (the packed even/odd rows for rfft, the merged half spectrum
    for irfft).  Returns the launches the forward made, the largest abs
    error on those planes, and the batch-1024 forward planes."""
    params = filter_params(rng, FILTER_N)
    model = tp.models.SpectralFilter(FILTER_N, device="cuda")
    model.load_state_dict(tp.models.params_from_jax(params, "cuda"))
    gain = params["gain_re"] + 1j * params["gain_im"]
    inputs = [rng.standard_normal((b, FILTER_N)) for b in FILTER_BATCHES]
    outs = []
    cuda_fft.LAUNCHES = 0
    with recorded_launches() as seen, torch.inference_mode():
        for x in inputs:
            before = cuda_fft.LAUNCHES
            y = model(torch.tensor(x, dtype=torch.float32, device="cuda"))
            torch.cuda.synchronize()
            outs.append(y)
            require(cuda_fft.LAUNCHES - before == 2,
                    f"expected 2 kernel launches per forward, got {cuda_fft.LAUNCHES - before}")
    launches = cuda_fft.LAUNCHES
    for x, y in zip(inputs, outs):
        want = np.fft.irfft(np.fft.rfft(x) * gain, n=FILTER_N) + params["bias"]
        require(tuple(y.shape) == x.shape, f"filter output shape {tuple(y.shape)}")
        err = rel_err(y.cpu().numpy(), want)
        log(f"spectral filter n={FILTER_N} batch={x.shape[0]}: rel err {err:.3e} vs float64 oracle")
        require(err <= ORACLE_TOL, f"spectral filter error {err:.3e} at batch {x.shape[0]}")
    log(f"main path kernel launches: {launches}")
    require(launches > 0, "the main path never launched the kernel")
    expected = [(b, sign) for b in FILTER_BATCHES for sign in (-1, 1)]
    require([(xr.shape[0], sign) for xr, _, _, sign in seen] == expected,
            f"main path kernel calls {[(tuple(r[0].shape), r[3]) for r in seen]}")
    worst_abs = max(kernel_error(xr, xi, n, sign, "main-path planes")
                    for xr, xi, n, sign in seen)
    big_forward = seen[expected.index((FILTER_BATCHES[-1], -1))]
    return launches, worst_abs, big_forward[:2]


def core_lengths(rng) -> None:
    """The core FFT configurations of the reference benchmark vs numpy."""
    cases = [
        ("n1024_b256", 1024, 256, tp.DEFAULT_CONFIG, True),
        ("n4096_b64", 4096, 64, tp.DEFAULT_CONFIG, True),
        ("n5040_b64", 5040, 64, tp.DEFAULT_CONFIG, True),
        ("n32768_b16", 32768, 16, tp.DEFAULT_CONFIG, False),
        ("n65536_b16", 65536, 16, tp.DEFAULT_CONFIG, False),
        ("n10007_b16", 10007, 16, tp.DEFAULT_CONFIG, False),
        ("n1009_b64", 1009, 64, tp.SpectralConfig(rader="off"), False),
    ]
    for name, n, b, cfg, on_kernel in cases:
        x = rng.standard_normal((b, n)) + 1j * rng.standard_normal((b, n))
        before = cuda_fft.LAUNCHES
        got = tp.fft(torch.tensor(x, dtype=torch.complex64, device="cuda"), config=cfg)
        torch.cuda.synchronize()
        err = rel_err(got.cpu().numpy(), np.fft.fft(x))
        launched = cuda_fft.LAUNCHES - before
        log(f"{name}: rel err {err:.3e}, kernel launches {launched}")
        require(err <= ORACLE_TOL, f"{name} error {err:.3e}")
        require(launched == (1 if on_kernel else 0),
                f"{name}: expected {'the kernel' if on_kernel else 'the stage pipeline'}")

    x = rng.standard_normal((64, 4096))
    xt = torch.tensor(x, dtype=torch.float32, device="cuda")
    spec = tp.rfft(xt)
    back = tp.irfft(spec, n=4096)
    torch.cuda.synchronize()
    err = max(rel_err(spec.cpu().numpy(), np.fft.rfft(x)), rel_err(back.cpu().numpy(), x))
    log(f"rfft4096_roundtrip_b64: rel err {err:.3e}")
    require(err <= ORACLE_TOL, f"rfft4096_roundtrip_b64 error {err:.3e}")

    sig = rng.standard_normal((64, 4000))
    taps = rng.standard_normal(129)
    got = tp.fft_convolve(
        torch.tensor(sig, dtype=torch.float32, device="cuda"),
        torch.tensor(taps[None], dtype=torch.float32, device="cuda"),
        mode="same",
    )
    torch.cuda.synchronize()
    want = np.stack([np.convolve(row, taps, mode="same") for row in sig])
    require(tuple(got.shape) == want.shape, f"conv shape {tuple(got.shape)}")
    err = rel_err(got.cpu().numpy(), want)
    log(f"conv4000x129_same_b64: rel err {err:.3e}")
    require(err <= ORACLE_TOL, f"conv4000x129_same_b64 error {err:.3e}")


def cuda32(x: np.ndarray) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device="cuda")


def oracle_filter(p64, x64):
    """The spectral filter in float64 on the CPU through torch.fft."""
    gain = torch.complex(p64["gain_re"], p64["gain_im"])
    return torch.fft.irfft(torch.fft.rfft(x64) * gain, n=x64.shape[-1]) + p64["bias"]


def training(rng):
    """Five train steps of the spectral filter on the card, kernel on, per
    batch size.  Returns the launches of the counted steps and the largest
    abs error of the kernel against its plain version on their planes."""
    total, worst_abs = 0, 0.0
    for b in FILTER_BATCHES:
        params = filter_params(rng, FILTER_N)
        x = rng.standard_normal((b, FILTER_N))
        true_gain = 1.0 + 0.3 * rng.standard_normal(FILTER_N // 2 + 1)
        target = np.fft.irfft(np.fft.rfft(x) * true_gain, n=FILTER_N) + 0.3
        xt, tt = cuda32(x), cuda32(target)
        x64, t64 = torch.tensor(x), torch.tensor(target)

        # (b) the first step's gradients: float64 oracle, and the stage pipeline
        p64 = {k: torch.tensor(v, dtype=torch.float64, requires_grad=True)
               for k, v in params.items()}
        want = torch.autograd.grad(torch.mean((oracle_filter(p64, x64) - t64) ** 2),
                                   list(p64.values()))
        grads = {}
        for name, config in (("kernel", tp.DEFAULT_CONFIG), ("pipeline", PIPELINE)):
            leaves = {k: v.requires_grad_(True)
                      for k, v in tp.models.params_from_jax(params, "cuda").items()}
            loss = tp.models.loss_fn(leaves, xt, tt, config=config)
            grads[name] = torch.autograd.grad(loss, list(leaves.values()))
        for k, g, gp, w in zip(params, grads["kernel"], grads["pipeline"], want):
            err = rel_err(g.cpu().numpy(), w.numpy())
            err_pipe = rel_err(g.cpu().numpy(), gp.cpu().numpy())
            log(f"train b={b} d loss/d {k}: rel err {err:.3e} vs float64 oracle, "
                f"{err_pipe:.3e} vs stage pipeline")
            require(err <= ORACLE_TOL, f"gradient of {k} at batch {b}: {err:.3e}")
            require(err_pipe <= ROUTES_TOL, f"gradient of {k} vs pipeline at batch {b}")

        # (a), (d) the counted steps, beside the same steps in float64
        tparams = tp.models.params_from_jax(params, "cuda")
        p64 = {k: torch.tensor(v, dtype=torch.float64) for k, v in params.items()}
        losses, losses64 = [], []
        cuda_fft.LAUNCHES = 0
        with recorded_launches() as seen:
            for _ in range(TRAIN_STEPS):
                before = cuda_fft.LAUNCHES
                tparams, loss = tp.models.train_step(tparams, xt, tt, lr=TRAIN_LR)
                torch.cuda.synchronize()
                require(cuda_fft.LAUNCHES - before == 3,
                        f"expected 3 kernel launches per train step, got "
                        f"{cuda_fft.LAUNCHES - before}")
                losses.append(float(loss))
        total += cuda_fft.LAUNCHES
        for _ in range(TRAIN_STEPS):
            leaves = {k: v.requires_grad_(True) for k, v in p64.items()}
            loss = torch.mean((oracle_filter(leaves, x64) - t64) ** 2)
            g64 = torch.autograd.grad(loss, list(leaves.values()))
            p64 = {k: (v - TRAIN_LR * g).detach() for (k, v), g in zip(leaves.items(), g64)}
            losses64.append(float(loss.detach()))
        err = rel_err(np.array(losses), np.array(losses64))
        log(f"train b={b}: losses {[f'{v:.6f}' for v in losses]}, rel err {err:.3e} "
            f"vs float64 oracle; 3 launches a step")
        require(all(b_ < a for a, b_ in zip(losses, losses[1:])), f"loss did not fall: {losses}")
        require(err <= ORACLE_TOL, f"train losses at batch {b}: {err:.3e}")
        for k, v in tparams.items():
            err = rel_err(v.cpu().numpy(), p64[k].numpy())
            require(err <= ORACLE_TOL, f"{k} after {TRAIN_STEPS} steps at batch {b}: {err:.3e}")
        h = FILTER_N // 2
        require([(r[0].shape, r[2], r[3]) for r in seen]
                == [((b, h), h, sign) for sign in (-1, 1, -1)] * TRAIN_STEPS,
                f"train step kernel calls {[(tuple(r[0].shape), r[3]) for r in seen]}")

        # the module with an optimizer, input gradient wanted: 4 launches
        model = tp.models.SpectralFilter(FILTER_N, device="cuda")
        model.load_state_dict(tp.models.params_from_jax(params, "cuda"))
        opt = torch.optim.SGD(model.parameters(), lr=TRAIN_LR)
        xg = xt.clone().requires_grad_(True)
        cuda_fft.LAUNCHES = 0
        with recorded_launches() as seen4:
            torch.mean((model(xg) - tt) ** 2).backward()
            opt.step()
            torch.cuda.synchronize()
        require(cuda_fft.LAUNCHES == 4, f"expected 4 launches with an input gradient, "
                                        f"got {cuda_fft.LAUNCHES}")
        total += cuda_fft.LAUNCHES
        x64g = x64.clone().requires_grad_(True)
        p0 = {k: torch.tensor(v, dtype=torch.float64) for k, v in params.items()}
        (want_x,) = torch.autograd.grad(
            torch.mean((oracle_filter(p0, x64g) - t64) ** 2), [x64g])
        err = rel_err(xg.grad.cpu().numpy(), want_x.numpy())
        log(f"train b={b} module + SGD, d loss/d x: rel err {err:.3e} vs float64 oracle; "
            f"4 launches")
        require(err <= ORACLE_TOL, f"input gradient at batch {b}: {err:.3e}")
        first, _ = tp.models.train_step(tp.models.params_from_jax(params, "cuda"), xt, tt,
                                        lr=TRAIN_LR)
        for k, v in model.state_dict().items():
            require(torch.allclose(v, first[k], rtol=1e-6, atol=1e-7),
                    f"SGD on the module and train_step disagree on {k}")

        # (c) the kernel against its plain version on the planes it was handed:
        # the first step's three (the third is the backward's cotangent pair),
        # every later backward, and the four of the step with an input gradient
        checked = seen[:3] + seen[5::3] + seen4
        worst_abs = max([worst_abs] + [
            kernel_error(xr, xi, n, sign, f"train-step planes b={b}")
            for xr, xi, n, sign in checked])
    log(f"training kernel launches: {total}")
    return total, worst_abs


def gradients(loss_fn, params, x, target, config):
    """The leaves of d loss / d params, in tree_leaves' order."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    return torch.autograd.grad(loss_fn(leaves, x, target, config=config), tree_leaves(leaves))


def route_error(loss_fn, step, params, x, target, what: str) -> None:
    """One train step on the kernel route against the stage pipeline's:
    the losses within ORACLE_TOL, the stepped parameters and, since a
    step of a small learning rate hides the gradients in the parameters'
    rounding, the gradients themselves leaf by leaf within ROUTES_TOL."""
    new, loss = step(params, x, target)
    new_pipe, loss_pipe = step(params, x, target, config=PIPELINE)
    loss, loss_pipe = float(loss), float(loss_pipe)
    require(math.isfinite(loss), f"{what} loss is not finite")
    require(abs(loss - loss_pipe) <= ORACLE_TOL * abs(loss_pipe),
            f"{what} loss {loss} disagrees with the stage pipeline's {loss_pipe}")
    err = max(rel_err(a.cpu().numpy(), b.cpu().numpy())
              for a, b in zip(tree_leaves(new), tree_leaves(new_pipe)))
    require(err <= ROUTES_TOL, f"{what} stepped parameters: {err:.3e}")
    grad_err = max(rel_err(g.cpu().numpy(), gp.cpu().numpy()) for g, gp in zip(
        gradients(loss_fn, params, x, target, tp.DEFAULT_CONFIG),
        gradients(loss_fn, params, x, target, PIPELINE)))
    log(f"{what} train step: loss {loss:.6f} (pipeline {loss_pipe:.6f}), stepped parameters "
        f"rel err {err:.3e}, gradients rel err {grad_err:.3e} (worst leaf) vs stage pipeline")
    require(grad_err <= ROUTES_TOL, f"{what} gradients: {grad_err:.3e}")


def fno_path(rng):
    """The 1-D FNO at the Burgers configuration and a small 2-D FNO: forward
    and one train step, kernel route against the stage pipeline on the card.
    Returns the launches and the largest abs error of the kernel against its
    plain version on every plane pair the two train steps handed it: rows
    of 4096 in the 1-D step, and in the 2-D step rows of 32 and 64 made
    contiguous from moveaxis views, forward and as backward cotangents."""
    gen = torch.Generator().manual_seed(SEED)
    params = fno.init_fno(**FNO, generator=gen, device="cuda")
    x = cuda32(rng.standard_normal((FNO_BATCH, FNO["in_channels"], FNO_GRID)))
    target = cuda32(rng.standard_normal((FNO_BATCH, FNO["out_channels"], FNO_GRID)))
    layers = FNO["n_layers"]
    cuda_fft.LAUNCHES = 0
    with torch.no_grad():
        y = fno.apply(params, x)
        torch.cuda.synchronize()
        forward = cuda_fft.LAUNCHES
        y_pipe = fno.apply(params, x, config=PIPELINE)
    require(tuple(y.shape) == tuple(target.shape), f"FNO output shape {tuple(y.shape)}")
    err = rel_err(y.cpu().numpy(), y_pipe.cpu().numpy())
    log(f"fno 1-d width {FNO['hidden']} modes {FNO['modes']} layers {layers} batch "
        f"{FNO_BATCH} n={FNO_GRID}: forward rel err {err:.3e} vs stage pipeline, "
        f"{forward} launches")
    require(err <= ORACLE_TOL, f"FNO forward error {err:.3e}")
    require(forward == 2 * layers, f"FNO forward launches {forward}")
    with recorded_launches() as seen:
        fno.train_step(params, x, target)
        torch.cuda.synchronize()
    step = cuda_fft.LAUNCHES - forward
    total = cuda_fft.LAUNCHES
    # per layer: rfft and irfft forward, and both backward
    log(f"fno 1-d train step: {step} launches")
    require(step == 4 * layers, f"FNO train step launches {step}")
    route_error(fno.loss_fn, fno.train_step, params, x, target, "fno 1-d")
    # per layer the forward pair, then the backward's cotangent pairs
    require(len(seen) == step, f"recorded {len(seen)} of the FNO step's {step} launches")
    worst_abs = max(kernel_error(xr, xi, n, sign, f"fno 1-d train-step planes, launch {i}")
                    for i, (xr, xi, n, sign) in enumerate(seen))
    del seen

    params = fno.init_fno2d(**FNO2D, generator=gen, device="cuda")
    x = cuda32(rng.standard_normal((FNO2D_BATCH, FNO2D["in_channels"], *FNO2D_GRID)))
    target = torch.zeros_like(x)
    cuda_fft.LAUNCHES = 0
    with recorded_launches() as seen:
        fno.train_step2d(params, x, target)
        torch.cuda.synchronize()
    step = cuda_fft.LAUNCHES
    # per layer: rfft over W, fft over H, ifft over H, irfft, each forward and backward
    log(f"fno 2-d {FNO2D_GRID} width {FNO2D['hidden']} modes {FNO2D['modes']}: {step} launches")
    require(step == 8 * FNO2D["n_layers"], f"2-D FNO train step launches {step}")
    route_error(fno.loss_fn2d, fno.train_step2d, params, x, target, "fno 2-d")
    require(len(seen) == step, f"recorded {len(seen)} of the 2-D step's {step} launches")
    half = FNO2D_GRID[1] // 2
    require({(r[2], r[3]) for r in seen} == {(n, s) for n in (half, FNO2D_GRID[0])
                                             for s in (-1, 1)},
            f"2-D FNO step kernel calls {sorted({(r[2], r[3]) for r in seen})}")
    worst_abs = max([worst_abs] + [
        kernel_error(xr, xi, n, sign, f"fno 2-d train-step planes, launch {i}")
        for i, (xr, xi, n, sign) in enumerate(seen)])
    log(f"fno kernel launches: {total + step}")
    return total + step, worst_abs


def api_remainder(rng) -> None:
    """The C-reference surface and the rest of the fft/convolve API, from
    numpy input without a device: every result must lie on the card."""
    def check(name, got, want, tol=ORACLE_TOL):
        require(got.device.type == "cuda", f"{name}: result on {got.device}, not the card")
        torch.cuda.synchronize()
        require(tuple(got.shape) == want.shape, f"{name} shape {tuple(got.shape)}")
        err = rel_err(got.cpu().numpy(), want)
        log(f"{name}: rel err {err:.3e}")
        require(err <= tol, f"{name} error {err:.3e}")

    n = 4096
    x = rng.standard_normal((4, n)) + 1j * rng.standard_normal((4, n))
    spec = compat.fft_exec(compat.fft_init(n, 1), x)
    check("compat fft_exec n=4096 sgn=+1", spec, np.fft.fft(x))
    check("compat fft_exec round trip = N·x", compat.fft_exec(compat.fft_init(n, -1), spec),
          n * x)
    r = rng.standard_normal((4, n))
    full = compat.fft_r2c_exec(compat.fft_real_init(n, 1), r)
    check("compat fft_r2c_exec (mirrored length N)", full, np.fft.fft(r))
    check("compat fft_c2r_exec(r2c(x)) = N·x",
          compat.fft_c2r_exec(compat.fft_real_init(n, -1), full), n * r)
    out, length = compat.fft_convolve("same", "linear", r[0], r[1, :129])
    require(length == n, f"compat fft_convolve length {length}")
    check("compat fft_convolve same", out, np.convolve(r[0], r[1, :129], mode="same"))

    sig = rng.standard_normal((16, 65408))
    taps = rng.standard_normal(129)
    want = np.stack([np.convolve(row, taps, mode="same") for row in sig])
    check("fft_oaconvolve 65408x129 same b16", tp.fft_oaconvolve(sig, taps, mode="same"), want)
    # direct method: the convolution op, which cuDNN may run in TF32 by
    # default.  The default is put back here, and the op is wrapped to note
    # the flag at the moment it is called: the function's own guard, not this
    # script's setup, must have switched TF32 off by then.  (The error bound
    # alone cannot tell: cuDNN need not pick a TF32 kernel for these shapes.)
    flag_at_call = []

    def noting(conv):
        def call(*args, **kwargs):
            flag_at_call.append(torch.backends.cudnn.allow_tf32)
            return conv(*args, **kwargs)
        return call

    functional = torch.nn.functional
    conv1d, conv2d = functional.conv1d, functional.conv2d
    torch.backends.cudnn.allow_tf32 = True
    functional.conv1d, functional.conv2d = noting(conv1d), noting(conv2d)
    sig = rng.standard_normal((64, 4000))
    taps = rng.standard_normal((1, 15))
    want = np.stack([np.convolve(row, taps[0], mode="same") for row in sig])
    check("convolve direct 4000x15 same b64", tp.convolve(sig, taps, "same", "direct"), want)
    img = rng.standard_normal((256, 256))
    ker = rng.standard_normal((5, 5))
    want = np.fft.irfft2(np.fft.rfft2(img, (260, 260)) * np.fft.rfft2(ker, (260, 260)),
                         (260, 260))
    check("convolve direct 256x256 * 5x5 full", tp.convolve(img, ker, "full", "direct"), want)
    functional.conv1d, functional.conv2d = conv1d, conv2d
    log(f"cudnn.allow_tf32 at the direct method's {len(flag_at_call)} convolution calls: "
        f"{flag_at_call}; after them: {torch.backends.cudnn.allow_tf32}")
    require(len(flag_at_call) == 2 and not any(flag_at_call),
            "the direct method called the convolution op with cuDNN's TF32 allowed")
    require(torch.backends.cudnn.allow_tf32 is True,
            "the direct method did not put cuDNN's TF32 flag back")
    torch.backends.cudnn.allow_tf32 = False

    n = 5040
    half = rng.standard_normal((8, n // 2 + 1)) + 1j * rng.standard_normal((8, n // 2 + 1))
    check("hfft n=5040", tp.hfft(half, n=n), np.fft.hfft(half, n=n))
    x = rng.standard_normal((8, n))
    f = np.fft.fft(x)
    check("dht n=5040", tp.dht(x), f.real - f.imag)
    check("fftfreq n=5040", tp.fftfreq(n, 0.5), np.fft.fftfreq(n, 0.5))


def train_timings(rng, card: str) -> None:
    """One train step of the spectral filter at n = 4096 and of the 1-D FNO
    at the Burgers shape: device time by CUDA-graph replay and by
    torch.profiler sums, back-to-back wall time, idle share, device kernels
    per step and the fused kernel's share of the device time."""
    cases = []
    for b in FILTER_BATCHES:
        tparams = tp.models.params_from_jax(filter_params(rng, FILTER_N), "cuda")
        xt = cuda32(rng.standard_normal((b, FILTER_N)))
        tt = cuda32(rng.standard_normal((b, FILTER_N)))
        cases.append((f"spectral filter n={FILTER_N} b={b}", 20, 5,
                      lambda p=tparams, x=xt, t=tt: tp.models.train_step(p, x, t)))
    params = fno.init_fno(**FNO, generator=torch.Generator().manual_seed(SEED), device="cuda")
    x = cuda32(rng.standard_normal((FNO_BATCH, FNO["in_channels"], FNO_GRID)))
    target = cuda32(rng.standard_normal((FNO_BATCH, FNO["out_channels"], FNO_GRID)))
    cases.append((f"fno 1-d n={FNO_GRID} b={FNO_BATCH}", 5, 2,
                  lambda: fno.train_step(params, x, target)))
    rows = []
    for name, calls, captured, step in cases:
        t = device_and_wall_us(step, calls=calls)
        graph = graph_us(torch, step, launches=captured)
        row = {"train_step": name, "device_us_profiler": t["device_us"],
               "device_us_graph_replay": graph, "back_to_back_us": t["wall_us"],
               "idle_share": t["idle_share"],
               "device_kernels_per_step": t["kernels"], "k1_device_us": t["k1_us"],
               "k1_share": None if t["device_us"] is None else t["k1_us"] / t["device_us"]}
        rows.append(row)
        log(f"train step {name}: device {t['device_us']} us (torch.profiler sum), "
            f"{graph:.2f} us (graph replay of {captured} steps), back to back "
            f"{t['wall_us']:.2f} us, idle share {t['idle_share']}, {t['kernels']} device "
            f"kernels a step, K1 {t['k1_us']:.2f} us")
        for kernel, us in list(t["by_name"].items())[:8]:
            short = re.sub(r"void |at::native::|\(anonymous namespace\)::|binary_internal::", "",
                           kernel)
            log(f"  {us:9.2f} us  {short[:110]}")
    log(json.dumps({"train_step_timing": {"card": card, "steps": rows}}))


def timings(rng, card: str):
    """Per-call medians (ms) at the kernel-eligible shapes, and the spectral
    filter's device time against its back-to-back wall time."""
    shapes = [(2048, 8), (2048, 1024), (1024, 256), (4096, 64), (5040, 64)]
    rows = []
    for n, b in shapes:
        x = rng.standard_normal((b, n)) + 1j * rng.standard_normal((b, n))
        xr, xi = planes(x)
        xc = torch.complex(xr, xi)
        plan = tp.get_plan(n, -1, "complex", PIPELINE)
        row = {
            "n": n, "batch": b,
            "kernel_ms": time_ms(lambda: cuda_fft.exec_kernel(xr, xi, n, -1)),
            "plain_ms": time_ms(lambda: cuda_fft.exec_kernel_reference(xr, xi, n, -1)),
            "pipeline_ms": time_ms(lambda: exec_complex(plan, xr, xi)),
            "torch_fft_ms": time_ms(lambda: torch.fft.fft(xc)),
        }
        if (n, b) == (2048, 8):
            # the wrapper's host path (kernel_bench.wrapper_us)
            row["kernel_back_to_back_us"] = wrapper_us(
                torch, lambda: cuda_fft.exec_kernel(xr, xi, n, -1))
            log(f"kernel wrapper n={n} b={b}: {row['kernel_back_to_back_us']:.2f} us "
                f"per call back to back")
        rows.append(row)
        log(f"timing n={n} b={b}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in row.items() if k.endswith("_ms")))
    params = filter_params(rng, FILTER_N)
    model = tp.models.SpectralFilter(FILTER_N, device="cuda")
    model.load_state_dict(tp.models.params_from_jax(params, "cuda"))
    model_pipe = tp.models.SpectralFilter(FILTER_N, device="cuda", config=PIPELINE)
    model_pipe.load_state_dict(model.state_dict())
    gain = torch.complex(model.gain_re, model.gain_im).detach()
    filt = []
    with torch.inference_mode():
        for b in FILTER_BATCHES:
            xt = torch.tensor(rng.standard_normal((b, FILTER_N)), dtype=torch.float32,
                              device="cuda")
            row = {
                "n": FILTER_N, "batch": b,
                "kernel_ms": time_ms(lambda: model(xt)),
                "pipeline_ms": time_ms(lambda: model_pipe(xt)),
                "torch_fft_ms": time_ms(
                    lambda: torch.fft.irfft(torch.fft.rfft(xt) * gain, n=FILTER_N)
                    + model.bias),
            }
            t = device_and_wall_us(lambda: model(xt))
            row["kernel_path_device_us"] = t["device_us"]
            row["kernel_path_back_to_back_us"] = t["wall_us"]
            row["idle_share"] = t["idle_share"]
            filt.append(row)
            log(f"timing spectral filter b={b}: " + ", ".join(
                f"{k} {v:.4f}" for k, v in row.items() if k.endswith("_ms")))
            log(f"spectral filter b={b} kernel path: device {t['device_us']} us, back to "
                f"back {t['wall_us']:.2f} us per call, idle share {t['idle_share']}")
    log(json.dumps({"timing": {"card": card, "fft": rows, "spectral_filter": filt}}))


def yardstick(rng, card: str) -> None:
    """The kernel against torch.fft.fft (cuFFT) at YARDSTICK_SHAPES, device
    times from kernel_bench.graph_us, with the bytes bound and the kernel's share of it."""
    rows = []
    for n, b in YARDSTICK_SHAPES:
        x = rng.standard_normal((b, n)) + 1j * rng.standard_normal((b, n))
        xr, xi = planes(x)
        xc = torch.complex(xr, xi)
        kernel_ms = graph_us(torch, lambda: cuda_fft.exec_kernel(xr, xi, n, -1)) / 1e3
        cufft_ms = graph_us(torch, lambda: torch.fft.fft(xc)) / 1e3
        bound, bound_by = fft_bound_ms(n, b)
        row = {"n": n, "batch": b, "kernel_us": kernel_ms * 1e3, "cufft_us": cufft_ms * 1e3,
               "bound_us": bound * 1e3, "bound_by": bound_by,
               "share_of_bound": bound / kernel_ms, "kernel_over_cufft": kernel_ms / cufft_ms}
        rows.append(row)
        log(f"yardstick n={n} b={b}: kernel {row['kernel_us']:.2f} us, cuFFT "
            f"{row['cufft_us']:.2f} us, bound {row['bound_us']:.2f} us ({bound_by}), "
            f"share {row['share_of_bound']:.3f}, kernel/cuFFT {row['kernel_over_cufft']:.2f}")
    log(json.dumps({"k1_vs_cufft": {"card": card, "method": "CUDA graph of 20 "
                    "back-to-back launches, 10 replays, CUDA events", "shapes": rows}}))


def main() -> int:
    card = setup()
    build()
    rng = np.random.default_rng(SEED)
    kernel_vs_plain(rng)
    launches, max_abs, (xr, xi) = main_path(rng)
    core_lengths(rng)
    timings(rng, card)
    yardstick(rng, card)
    train_launches, train_abs = training(rng)
    fno_launches, fno_abs = fno_path(rng)
    api_remainder(rng)
    train_timings(rng, card)
    log(f"kernel launches by path: filter forward {launches}, training {train_launches}, "
        f"fno {fno_launches}")
    launches += train_launches + fno_launches
    max_abs = max(max_abs, train_abs, fno_abs)
    # the kernel line's times are on the same planes as its error: the
    # forward transform of the batch-1024 filter call.  ms, plain_ms and
    # library_ms are medians of single timed calls, dispatch included
    # (time_ms); device_ms and library_device_ms are device times (graph_us).
    h = FILTER_N // 2
    xc = torch.complex(xr, xi)
    bound, bound_by = fft_bound_ms(h, xr.shape[0])

    def kernel():
        return cuda_fft.exec_kernel(xr, xi, h, -1)

    main_row = {
        "kernel_ms": time_ms(kernel),
        "plain_ms": time_ms(lambda: cuda_fft.exec_kernel_reference(xr, xi, h, -1)),
        "library_ms": time_ms(lambda: torch.fft.fft(xc)),
        "device_ms": graph_us(torch, kernel) / 1e3,
        "library_device_ms": graph_us(torch, lambda: torch.fft.fft(xc)) / 1e3,
    }
    log(f"kernel on the main path's planes ({h} x {xr.shape[0]}): " + ", ".join(
        f"{k} {v:.4f}" for k, v in main_row.items()) + f", bound {bound:.4f} ms ({bound_by})")
    log(json.dumps({"kernels": [{
        "name": "stockham_fft",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": launches,
        "max_abs_err": max_abs,
        "ms": main_row["kernel_ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": bound,
        "bound_by": bound_by,
        "library_ms": main_row["library_ms"],
        "device_ms": main_row["device_ms"],
        "library_device_ms": main_row["library_device_ms"],
    }]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
