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
   time (torch.profiler) against its back-to-back wall time.

The last lines are one JSON line about the kernels (error and times on the
main path's batch-1024 planes), the card, then
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import mixed_radix_fast_fourier_transform_tpu_torch as tp
from mixed_radix_fast_fourier_transform_tpu_torch.ops import _build, cuda_fft
from mixed_radix_fast_fourier_transform_tpu_torch.ops.stockham import exec_complex

SEED = 0
KERNEL_TOL = 2e-5   # kernel vs plain version, as the JAX kernel's tests hold it
ORACLE_TOL = 1e-5   # vs numpy float64: the library's error budget
FILTER_N = 4096
FILTER_BATCHES = (8, 1024)
KERNEL_LENGTHS = (8, 64, 360, 1024, 2048, 4096, 5040, 8192, 12288)
KERNEL_SOURCE = "mixed_radix_fast_fourier_transform_tpu_torch/csrc/stockham_fft.cu"
KERNEL_REPLACES = "mixed_radix_fast_fourier_transform_tpu/ops/pallas_fft.py:193"
PIPELINE = tp.SpectralConfig(use_kernel=False)


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


def device_and_wall_us(fn, calls: int = 20):
    """Per call, in one process on the same inputs: the summed device-kernel
    time of ``calls`` calls under torch.profiler, and the wall time of
    ``calls`` back-to-back calls without it (CUDA events).  The device time
    is None where the profiler saw no device activity."""
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
    dev = sum(e.device_time_total for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA)
    return (dev / calls if dev > 0 else None), wall_us


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
    log(f"kernel vs plain {what} n={n} rows={got.shape[0]} sign={sign:+d}: rel err {err:.3e}")
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
    seen = []
    launch = cuda_fft.exec_kernel

    def recording(xr, xi, n, sign):
        seen.append((xr.clone(), xi.clone(), n, sign))
        return launch(xr, xi, n, sign)

    # maybe_exec_kernel looks the wrapper up at call time
    cuda_fft.exec_kernel = recording
    cuda_fft.LAUNCHES = 0
    outs = []
    with torch.inference_mode():
        for x in inputs:
            before = cuda_fft.LAUNCHES
            y = model(torch.tensor(x, dtype=torch.float32, device="cuda"))
            torch.cuda.synchronize()
            outs.append(y)
            require(cuda_fft.LAUNCHES - before == 2,
                    f"expected 2 kernel launches per forward, got {cuda_fft.LAUNCHES - before}")
    launches = cuda_fft.LAUNCHES
    cuda_fft.exec_kernel = launch
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
            dev_us, wall_us = device_and_wall_us(lambda: model(xt))
            row["kernel_path_device_us"] = dev_us
            row["kernel_path_back_to_back_us"] = wall_us
            row["idle_share"] = None if dev_us is None else 1.0 - dev_us / wall_us
            filt.append(row)
            log(f"timing spectral filter b={b}: " + ", ".join(
                f"{k} {v:.4f}" for k, v in row.items() if k.endswith("_ms")))
            log(f"spectral filter b={b} kernel path: device {dev_us} us, "
                f"back to back {wall_us:.2f} us per call, idle share {row['idle_share']}")
    log(json.dumps({"timing": {"card": card, "fft": rows, "spectral_filter": filt}}))


def main() -> int:
    card = setup()
    build()
    rng = np.random.default_rng(SEED)
    kernel_vs_plain(rng)
    launches, max_abs, (xr, xi) = main_path(rng)
    core_lengths(rng)
    timings(rng, card)
    # the kernel line's times are on the same planes as its error: the
    # forward transform of the batch-1024 filter call
    h = FILTER_N // 2
    main_row = {
        "kernel_ms": time_ms(lambda: cuda_fft.exec_kernel(xr, xi, h, -1)),
        "plain_ms": time_ms(lambda: cuda_fft.exec_kernel_reference(xr, xi, h, -1)),
    }
    log(f"kernel on the main path's planes ({h} x {xr.shape[0]}): "
        f"kernel {main_row['kernel_ms']:.4f} ms, plain {main_row['plain_ms']:.4f} ms")
    log(json.dumps({"kernels": [{
        "name": "stockham_fft",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": launches,
        "max_abs_err": max_abs,
        "ms": main_row["kernel_ms"],
        "plain_ms": main_row["plain_ms"],
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
