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
   shapes, the four of phase 12's model families and the two of the audio
   front ends (256 x 32,256 and 200 x 48,016 rows): device time of 20 back-to-back launches replayed from a CUDA
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
11. device and back-to-back wall time of one ``train_step``;
12. the three FFT-bearing model families at a published width, random
    weights and input from the seed: S4D as in the authors' sequential
    CIFAR-10 example (d_model 128, 4 layers, state 64, L = 1024, batch 64),
    FNet-Base (hidden 768, ff 3072, 12 layers, sequence 512, batch 8) and
    the AFNO of FourCastNet (720 × 1440 grid, 20 channels, patch 8, dim
    768, 12 layers, 8 blocks, batch 1).  Each: forward from numpy input on
    the kernel route against the stage pipeline, one layer's mixing op
    against a float64 oracle, one ``train_step`` with the kernel held
    against its plain version on every plane pair it was handed, and losses
    and gradients leaf by leaf against the stage pipeline.  Then S4D's
    recurrence against its convolution, and the Koopman autoencoder (no
    transform) on the card against the CPU;
13. the short-time, cosine, Chebyshev, Hankel, chirp-z and fractional
    transforms from numpy input without a device, which must land on the
    card, against numpy/scipy float64, with the kernel's launches of each
    logged, and ``dct`` at 1024 × 256 timed beside its inner transform on
    the stage pipeline (its route) and through the kernel, ``dct`` and an
    ``stft`` captured in CUDA graphs (their host tables stay on the card);
14. device and back-to-back wall time of phase 12's forwards and train steps;
15. the trainable PCEN audio front end of Wang et al. as
    ``models/audio_frontend.py`` configures it, nothing cut: 16 kHz, n_fft
    512, hop 128, 40 mel bands, 35 classes, 256 clips of 1 s.  Forward from
    numpy input on the kernel route against the stage pipeline, mel power and
    PCEN features against float64 numpy, one ``train_step`` with loss and
    every gradient leaf against the stage pipeline and a float64 ``torch``
    oracle on the CPU, the kernel against its plain version on every plane
    pair (n = 256 x 32,256 rows), and the launches counted: 1 a forward, 1 a
    train step (the waveform needs no gradient), 2 with an input gradient;
16. the audio path's ops from numpy input without a device, which must land
    on the card, against scipy/numpy float64: ``melspectrogram`` as Whisper
    configures it (16 x 30 s, 3001 frames), ``pcen`` and ``mfcc`` on it,
    ``ShortTimeFFT``, ``resample_poly`` 48 -> 16 kHz with its peak memory,
    ``resample``, ``decimate``, ``upfirdn``, ``welch``/``csd``/``coherence``,
    ``hilbert``, ``envelope``, ``periodogram``, ``lombscargle``,
    ``savgol_filter``, ``freqz``, ``minimum_phase``, ``cwt``,
    ``gammatonegram``, ``bispectrum``, ``pitch_shift``, ``yin``/``pyin``,
    ``hpss``, with the kernel's launches of each logged;
17. device and back-to-back wall time of the front end's forward and train
    step, Whisper's ``melspectrogram``, ``pcen`` at 3001 frames forward and
    with its backward, and ``resample_poly``;
18. the recurrences from numpy input without a device, which must land on
    the card, against scipy/numpy float64: ``decimate(ftype="iir")`` on
    phase 16's 16 x 1,440,000 by 3, ``sosfilt``/``sosfiltfilt`` of
    ``butter(6)`` and ``lfilter``/``filtfilt`` of ``butter(4)`` at 8 x
    65,536, ``dlsim`` of a 4-state ``cont2discrete`` system over 65,536
    steps, ``cspline1d``/``cspline1d_eval`` at 8 x 65,536, ``kalman_filter``
    and ``kalman_smoother`` on the constant-velocity car tracker of Särkkä &
    García-Fernández (parallel at T = 10,000, sequential at 1,000), ``pcen``
    at Whisper's 16 x 3001 x 80 with scalar and per-band coefficients and
    the per-band gradients against a float64 torch loop on the CPU;
19. the audio remainder from numpy input, against float64 numpy written out
    here: ``cqt``, ``icqt``, ``chroma_cqt`` at librosa's defaults on 8 clips
    of 30 s, the spectral features, ``onset_strength``, ``tempo`` and
    ``beat_track`` of a click track, ``decompose``, ``scattering1d`` (J 6,
    Q 8) at 16 x 2^16, ``ssq_stft``/``issq_stft``, ``stockwell``/
    ``istockwell`` and ``wigner_ville`` at 8 x 4096, with the kernel's
    launches of each logged and the kernel held against its plain version
    on every plane pair it was handed;
20. device and back-to-back wall time of ``pcen`` (forward, and with its
    backward), the front end's forward and train step, ``decimate(ftype=
    "iir")``, ``sosfilt``, ``kalman_filter`` parallel and sequential, and
    ``cqt``.

``python3 chip_smoke.py audio`` runs phases 1, 2 and 15-17 alone, and
``python3 chip_smoke.py recurrence`` phases 1, 2 and 18-20 (for
development; they print no result line).

The last lines are one JSON line about the kernels (launches of phases 4, 8,
9, 12, 13, 15, 16, 18 and 19; error over the plane pairs those launches were handed:
every pair of phases 4, 9, 12, 13, 15, 16 and 19, and in phase 8 the first step's three, every
later backward's and the four of the step with an input gradient; times on
the main path's batch-1024 planes), the card, then ``{"ok": true, "device":
{...}}``.
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import scipy.fft
import scipy.linalg
import scipy.signal
import torch

import mixed_radix_fast_fourier_transform_tpu_torch as tp
from kernel_bench import SHAPES as YARDSTICK_SHAPES, graph_us, wrapper_us
from mixed_radix_fast_fourier_transform_tpu_torch import compat
from mixed_radix_fast_fourier_transform_tpu_torch.models import (
    afno, audio_frontend, fnet, fno, koopman, s4d,
)
from mixed_radix_fast_fourier_transform_tpu_torch.ops import _build, cuda_fft
from mixed_radix_fast_fourier_transform_tpu_torch.ops import cqt as cqt_ops
from mixed_radix_fast_fourier_transform_tpu_torch.ops import feature as feature_ops
from mixed_radix_fast_fourier_transform_tpu_torch.ops import scattering as scattering_ops
from mixed_radix_fast_fourier_transform_tpu_torch.ops.stockham import exec_complex, exec_len
from mixed_radix_fast_fourier_transform_tpu_torch.utils.tree import tree_leaves, tree_map

SEED = 0
KERNEL_TOL = 2e-5   # kernel vs plain version, as the JAX kernel's tests hold it
ORACLE_TOL = 1e-5   # vs numpy float64: the library's error budget
# two fp32 routes (kernel, stage pipeline), each within ORACLE_TOL of the truth
ROUTES_TOL = 2 * ORACLE_TOL
FILTER_N = 4096
FILTER_BATCHES = (8, 1024)
# 90: n % 4 != 0, rows not 16-byte aligned; 16384: the longest length
KERNEL_LENGTHS = (8, 32, 64, 90, 180, 360, 768, 1024, 2048, 4096, 5040, 8192, 12005, 12288,
                  16384)
# (n, rows) of the model families' transforms: FNet-Base's two axes, and the
# FourCastNet token grid's 69,120 rows of 90 (rows not 16-byte aligned; two
# rows a block, so 34,560 blocks along x, the one grid dimension the launch
# uses and the one without a 65,535 limit)
KERNEL_MANY_ROWS = ((768, 4096), (512, 6144), (90, 69120))
# NVIDIA H100 SXM peaks (data sheet): HBM bytes/s and fp32 FLOP/s
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
KERNEL_SOURCE = "mixed_radix_fast_fourier_transform_tpu_torch/csrc/stockham_fft.cu"
KERNEL_REPLACES = "mixed_radix_fast_fourier_transform_tpu/ops/pallas_fft.py:193"
PIPELINE = tp.SpectralConfig(use_kernel=False)
CARD = "cuda"   # the device type every result of a phase must have
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
# S4D, the authors' standalone example on sequential CIFAR-10 (Gu et al.,
# arXiv 2206.11893; state-spaces/s4 example.py defaults)
S4D = dict(hidden=128, n_layers=4, state=64, in_dim=3, out_dim=10)
S4D_BATCH, S4D_LENGTH = 64, 1024
# FNet-Base (Lee-Thorp et al., arXiv 2105.03824), continuous input
FNET = dict(hidden=768, ff_dim=3072, n_layers=12)
FNET_BATCH, FNET_SEQ = 8, 512
# AFNO as in FourCastNet (Guibas et al., arXiv 2111.13587; Pathak et al.,
# arXiv 2202.11214): 720 x 1440 grid, 20 variables, 90 x 180 tokens
AFNO = dict(in_channels=20, dim=768, out_channels=20, patch=8, n_layers=12, n_blocks=8,
            mlp_ratio=4.0)
AFNO_RUN = dict(patch=8, n_blocks=8, sparsity=0.01)
AFNO_GRID = (720, 1440)
# The AFNO's spectral MLP has a ReLU and a soft shrinkage on every spectral
# element, and a weight gradient is a sum over the ~4095 kept frequencies of
# random sign: one element whose mask differs between two fp32 routes moves
# an entry by 1/sqrt(4095) = 1.6% of its size, and every gradient upstream
# with it.  So the whole model's gradients are held leaf by leaf in the
# 2-norm (l2_err), where a few such entries weigh little, to this; and the
# transforms' own gradients at its shapes to ROUTES_TOL on a linear filter.
AFNO_GRAD_TOL = 5e-2
# fp32 evaluates S4D's phases l·Δ·Im(A) (hundreds of radians where the mode
# still has weight) to ~1e-5 rad: the kernel table's own budget
S4D_TABLE_TOL = 1e-4
# the recurrence against the convolution, as the JAX package's test holds it
S4D_STEP_TOL = 1e-4
# The trainable PCEN front end of Wang et al. (arXiv 1607.05666) as
# models/audio_frontend.py configures it: 16 kHz, n_fft 512, hop 128 (what
# loss_fn fixes), 40 mel bands, PCEN at the published initialisation, a linear
# head over the 35 classes of Speech Commands v2 (Warden, arXiv 1804.03209),
# 256 clips of 1 s.  Its transform: 126 frames x 256 clips = 32,256 rows of 256
AUDIO = dict(sr=16000.0, n_fft=512, hop=128, n_mels=40, n_classes=35)
AUDIO_BATCH, AUDIO_SAMPLES = 256, 16000
# Whisper's log-mel front end (Radford et al., arXiv 2212.04356): 30 s at
# 16 kHz, n_fft 400, hop 160, 80 mel bands, 3001 frames; 16 clips
WHISPER = dict(sr=16000.0, n_fft=400, hop=160, n_mels=80)
WHISPER_BATCH, WHISPER_SAMPLES = 16, 480000
# (n, rows) the two front ends hand the kernel: many short rows
AUDIO_KERNEL_SHAPES = ((256, 32256), (200, 48016))
# PCEN is exp(-gain·log(eps + M)) and a power of fp32 values within
# ORACLE_TOL of the truth: a few ulps more
PCEN_TOL = 5e-5
# 10·log10 of band energies within 1e-5, a DCT over 80 of them, relative to
# coefficients of ~100 dB
MFCC_TOL = 1e-4
# gradients of the front end against float64: sums over 256 x 126 x 40 fp32
# terms, back through 126 steps of the smoother and the transform
AUDIO_GRAD_TOL = 2e-4
# Lomb-Scargle evaluates cos/sin of up to 100 rad in fp32 (an ulp of 8e-6 rad)
LOMB_TOL = 1e-4
# the homomorphic method takes the log of a stopband's near-zeros in fp32
MINPHASE_TOL = 2e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_err(got, want) -> float:
    got = np.asarray(got)
    want = np.asarray(want)
    if not np.all(np.isfinite(got)):
        return float("inf")
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def l2_err(got, want) -> float:
    """‖got − want‖₂ / ‖want‖₂: unlike :func:`rel_err`, a few entries far off
    weigh little in it."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if not np.all(np.isfinite(got)):
        return float("inf")
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


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


def kernel_error(xr, xi, n: int, sign: int, what: str, verbose: bool = True) -> float:
    """Checks the kernel against its plain version on (xr, xi): raises past
    KERNEL_TOL relative to max |plain|; returns the max abs error."""
    kr, ki = cuda_fft.exec_kernel(xr, xi, n, sign)
    torch.cuda.synchronize()
    rr, ri = cuda_fft.exec_kernel_reference(xr, xi, n, sign)
    got = torch.complex(kr, ki).cpu().numpy()
    want = torch.complex(rr, ri).cpu().numpy()
    err = rel_err(got, want)
    if verbose:
        log(f"kernel vs plain {what} n={n} planes {tuple(got.shape)} sign={sign:+d}: "
            f"rel err {err:.3e}")
    require(err <= KERNEL_TOL, f"kernel disagrees with its plain version at n={n} ({what})")
    return float(np.max(np.abs(got - want)))


def kernel_vs_plain(rng) -> None:
    """The kernel against its plain version on random rows of every length
    class it takes (powers of two, 7-smooth mixes, up to n = 16384), three
    rows each, and at the model families' shapes of thousands of rows."""
    for n in KERNEL_LENGTHS:
        for sign in (-1, 1):
            x = rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n))
            kernel_error(*planes(x), n, sign, "random")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for n, rows in KERNEL_MANY_ROWS:
        xr, xi = (torch.randn(rows, n, device="cuda", generator=gen) for _ in range(2))
        for sign in (-1, 1):
            kernel_error(xr, xi, n, sign, "random, many rows")


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


def route_error(loss_fn, step, params, x, target, what: str, err_of=rel_err,
                tol: float = ROUTES_TOL) -> None:
    """One train step on the kernel route against the stage pipeline's:
    the losses within ORACLE_TOL, the stepped parameters and, since a
    step of a small learning rate hides the gradients in the parameters'
    rounding, the gradients themselves leaf by leaf within ``tol`` by
    ``err_of`` (the largest entry's error over the leaf's maximum unless
    told otherwise)."""
    new, loss = step(params, x, target)
    new_pipe, loss_pipe = step(params, x, target, config=PIPELINE)
    loss, loss_pipe = float(loss), float(loss_pipe)
    require(math.isfinite(loss), f"{what} loss is not finite")
    require(abs(loss - loss_pipe) <= ORACLE_TOL * abs(loss_pipe),
            f"{what} loss {loss} disagrees with the stage pipeline's {loss_pipe}")
    err = max(err_of(a.cpu().numpy(), b.cpu().numpy())
              for a, b in zip(tree_leaves(new), tree_leaves(new_pipe)))
    require(err <= tol, f"{what} stepped parameters: {err:.3e}")
    pairs = [(g.cpu().numpy(), gp.cpu().numpy()) for g, gp in zip(
        gradients(loss_fn, params, x, target, tp.DEFAULT_CONFIG),
        gradients(loss_fn, params, x, target, PIPELINE))]
    grad_errs = sorted(err_of(g, gp) for g, gp in pairs)
    log(f"{what} train step: loss {loss:.6f} (pipeline {loss_pipe:.6f}), stepped parameters "
        f"{err_of.__name__} {err:.3e}, gradients {err_of.__name__} {grad_errs[-1]:.3e} (worst "
        f"leaf), {grad_errs[len(grad_errs) // 2]:.3e} (median leaf), largest entry's error "
        f"{max(rel_err(g, gp) for g, gp in pairs):.3e} (worst leaf) vs stage pipeline")
    require(grad_errs[-1] <= tol, f"{what} gradients: {grad_errs[-1]:.3e}")


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


def kernel_errors(seen, what: str) -> float:
    """The kernel against its plain version on every recorded plane pair;
    logs the worst error per (n, rows, sign) and returns the worst abs error."""
    worst_abs, by_shape = 0.0, {}
    for xr, xi, n, sign in seen:
        err = kernel_error(xr, xi, n, sign, what, verbose=False)
        key = (n, xr.numel() // n, sign)
        by_shape[key] = max(by_shape.get(key, 0.0), err)
        worst_abs = max(worst_abs, err)
    for (n, rows, sign), err in sorted(by_shape.items()):
        calls = sum(1 for r in seen if (r[2], r[0].numel() // r[2], r[3]) == (n, rows, sign))
        log(f"kernel vs plain {what}: n={n} x {rows} rows sign={sign:+d}, {calls} plane "
            f"pairs, worst abs err {err:.3e}")
    return worst_abs


def model_family(name, apply, loss_fn, step, params, x, target, forward_launches,
                 step_launches, err_of=rel_err, grad_tol: float = ROUTES_TOL):
    """One model family on the card: the forward from numpy input on the
    kernel route against the stage pipeline, then one train step with the
    kernel held against its plain version on every plane pair it was handed
    (forward planes and backward cotangents), then the step's loss, stepped
    parameters and gradients against the stage pipeline's.  Returns the
    launches of the forward and the recorded step, and the worst abs error."""
    torch.cuda.reset_peak_memory_stats()
    cuda_fft.LAUNCHES = 0
    with torch.no_grad():
        y = apply(params, x)
        torch.cuda.synchronize()
        forward = cuda_fft.LAUNCHES
        y_pipe = apply(params, x, config=PIPELINE)
    require(y.device.type == "cuda", f"{name}: result on {y.device}, not the card")
    err = rel_err(y.cpu().numpy(), y_pipe.cpu().numpy())
    log(f"{name}: forward {tuple(y.shape)} rel err {err:.3e} vs stage pipeline, "
        f"{forward} launches")
    require(err <= ROUTES_TOL, f"{name} forward error {err:.3e}")
    require(forward == forward_launches, f"{name} forward launches {forward}")
    xt, tt = cuda32(x), cuda32(target)
    with recorded_launches() as seen:
        step(params, xt, tt)
        torch.cuda.synchronize()
    n_step = cuda_fft.LAUNCHES - forward
    total = cuda_fft.LAUNCHES
    log(f"{name} train step: {n_step} launches")
    require(n_step == step_launches, f"{name} train step launches {n_step}")
    require(len(seen) == n_step, f"recorded {len(seen)} of {name}'s {n_step} launches")
    worst_abs = kernel_errors(seen, f"{name} train-step planes")
    del seen
    route_error(loss_fn, step, params, xt, tt, name, err_of, grad_tol)
    log(f"{name}: peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    torch.cuda.empty_cache()
    return total, worst_abs


def s4d_kernel_oracle(p, length: int) -> np.ndarray:
    """S4D's convolution kernel in float64 from a layer's numpy parameters."""
    a = -np.exp(p["log_neg_a_re"]) + 1j * p["a_im"]             # (N/2,)
    dta = np.exp(p["log_dt"])[:, None] * a[None, :]              # (H, N/2)
    bc = (p["c_re"] + 1j * p["c_im"]) * (np.exp(dta) - 1.0) / a
    table = np.exp(dta[..., None] * np.arange(length))           # (H, N/2, L)
    return 2.0 * np.einsum("hn,hnl->hl", bc, table).real


def afno_filter_oracle(p, x, n_blocks: int, sparsity: float) -> np.ndarray:
    """AFNO's spectral filter in float64 on the CPU through torch.fft, from
    a block's numpy parameters: (b, h, w, d) -> (b, h, w, d)."""
    p = {k: torch.tensor(v, dtype=torch.float64) for k, v in p.items()}
    x = torch.tensor(x, dtype=torch.float64)
    b, h, w, d = x.shape
    spec = torch.fft.rfft2(x, dim=(1, 2)).reshape(b, h, w // 2 + 1, n_blocks, d // n_blocks)
    w1 = torch.complex(p["w1_re"], p["w1_im"])
    w2 = torch.complex(p["w2_re"], p["w2_im"])
    o1 = torch.einsum("bhwnc,nco->bhwno", spec, w1) + torch.complex(p["b1_re"], p["b1_im"])
    o1 = torch.complex(torch.relu(o1.real), torch.relu(o1.imag))
    o2 = torch.einsum("bhwnc,nco->bhwno", o1, w2) + torch.complex(p["b2_re"], p["b2_im"])
    shrink = torch.nn.functional.softshrink
    o2 = torch.complex(shrink(o2.real, sparsity), shrink(o2.imag, sparsity))
    return torch.fft.irfft2(o2.reshape(b, h, w // 2 + 1, d), s=(h, w), dim=(1, 2)).numpy()


def afno_transform_gradients(block, tokens, gen) -> None:
    """What the AFNO's transforms contribute to a gradient, without its
    masks: d/dx of Σ w ⊙ irfft2(rfft2(x) ⊙ M) for a fixed complex M, on the
    token grid's moved-axis views, kernel route against stage pipeline
    within ROUTES_TOL.  Then the elements of the first spectral layer whose
    ReLU mask differs between the two routes, counted."""
    b, h, w, d = tokens.shape
    m = torch.complex(*(torch.randn(b, d, h, w // 2 + 1, generator=gen).cuda() for _ in range(2)))
    weight = torch.randn(tokens.shape, generator=gen).cuda()
    grads, specs = [], []
    for config in (tp.DEFAULT_CONFIG, PIPELINE):
        xg = tokens.clone().requires_grad_(True)
        spec = tp.rfft2(torch.movedim(xg, -1, 1), config=config)
        y = tp.irfft2(spec * m, s=(h, w), config=config)
        (torch.movedim(y, 1, -1) * weight).sum().backward()
        grads.append(xg.grad)
        specs.append(spec.detach())
    err = rel_err(grads[0].cpu().numpy(), grads[1].cpu().numpy())
    log(f"afno transforms, linear filter on {tuple(tokens.shape)}: input gradient rel err "
        f"{err:.3e} vs stage pipeline")
    require(err <= ROUTES_TOL, f"afno transforms' gradient: {err:.3e}")
    nb = block["w1_re"].shape[0]
    hidden = []
    for spec in specs:
        a = spec.reshape(b, nb, d // nb, h, w // 2 + 1)
        hidden.append(torch.einsum("bnchw,nco->bnohw", a.real, block["w1_re"])
                      - torch.einsum("bnchw,nco->bnohw", a.imag, block["w1_im"]))
    flips = int(((hidden[0] > 0) != (hidden[1] > 0)).sum())
    log(f"afno first spectral layer, real plane: {flips} of {hidden[0].numel()} elements "
        f"change their ReLU mask between the routes (each moves a weight-gradient entry by "
        f"~{1 / math.sqrt(h * (w // 2 + 1) / 2):.3f} of its size)")


def to_numpy(tree):
    return tree_map(lambda t: t.cpu().numpy().astype(np.float64), tree)


def model_families(rng):
    """S4D, FNet-Base and the FourCastNet AFNO at their published widths,
    then S4D's recurrence and the Koopman autoencoder.  Returns the launches
    of the three forwards and recorded train steps and the kernel's worst
    abs error on their plane pairs."""
    gen = torch.Generator().manual_seed(SEED)
    total, worst_abs = 0, 0.0

    # S4D: per layer rfft(u), rfft(k), irfft forward, and each one's backward
    params = s4d.init_s4d_model(**S4D, generator=gen, device="cuda")
    x = rng.standard_normal((S4D_BATCH, S4D_LENGTH, S4D["in_dim"]))
    target = rng.standard_normal((S4D_BATCH, S4D["out_dim"]))
    layers = S4D["n_layers"]
    launches, err = model_family(
        "s4d", s4d.apply_s4d, s4d.loss_fn, s4d.train_step, params, x, target,
        3 * layers, 6 * layers)
    total, worst_abs = total + launches, max(worst_abs, err)
    layer = params["layers"][0]
    p64 = to_numpy(layer)
    k = s4d.s4d_kernel(layer, S4D_LENGTH)
    err = rel_err(k.cpu().numpy(), s4d_kernel_oracle(p64, S4D_LENGTH))
    log(f"s4d kernel table {tuple(k.shape)}: rel err {err:.3e} vs float64")
    require(err <= S4D_TABLE_TOL, f"s4d kernel table error {err:.3e}")
    u = rng.standard_normal((S4D_BATCH, S4D_LENGTH, S4D["hidden"]))
    ut = cuda32(u)
    with torch.no_grad():
        y = s4d.s4d_conv(layer, ut)
    m = 2 * S4D_LENGTH
    k64 = k.cpu().numpy().astype(np.float64)
    want = np.fft.irfft(np.fft.rfft(np.moveaxis(u, -1, -2), n=m) * np.fft.rfft(k64, n=m),
                        n=m)[..., :S4D_LENGTH]
    want = np.moveaxis(want, -2, -1) + u * p64["d"]
    err = rel_err(y.cpu().numpy(), want)
    log(f"s4d_conv {tuple(y.shape)}: rel err {err:.3e} vs float64 oracle")
    require(err <= ORACLE_TOL, f"s4d_conv error {err:.3e}")
    # the recurrence fed 64 steps gives the convolution's first 64 outputs
    state = tuple(ut.new_zeros(S4D_BATCH, S4D["hidden"], S4D["state"] // 2) for _ in range(2))
    ys = []
    with torch.no_grad():
        for t in range(64):
            state, yt = s4d.s4d_step(layer, *state, ut[:, t])
            ys.append(yt)
    y_rec = torch.stack(ys, dim=1).cpu().numpy()
    err = float(np.max(np.abs(y[:, :64].cpu().numpy() - y_rec)) / max(1.0, np.max(np.abs(y_rec))))
    log(f"s4d_step x 64 vs s4d_conv: err {err:.3e}")
    require(err <= S4D_STEP_TOL, f"s4d recurrence disagrees with the convolution: {err:.3e}")
    del params, layer, ut, y, state, ys

    # FNet: per layer an FFT over hidden and one over the sequence; the first
    # layer's input needs no gradient, so its two have no backward
    params = fnet.init_fnet(**FNET, generator=gen, device="cuda")
    x = rng.standard_normal((FNET_BATCH, FNET_SEQ, FNET["hidden"]))
    target = rng.standard_normal(x.shape)
    layers = FNET["n_layers"]
    launches, err = model_family(
        "fnet", fnet.apply, fnet.loss_fn, fnet.train_step, params, x, target,
        2 * layers, 2 * layers + 2 * (layers - 1))
    total, worst_abs = total + launches, max(worst_abs, err)
    mix = fnet.fourier_mix(x)
    err = rel_err(mix.cpu().numpy(), np.fft.fft2(x).real)
    log(f"fnet fourier_mix {tuple(mix.shape)}: rel err {err:.3e} vs float64 oracle")
    require(err <= ORACLE_TOL, f"fourier_mix error {err:.3e}")
    del params, mix

    # AFNO: per block rfft over W, fft over H, ifft over H, irfft over W
    params = afno.init_afno(**AFNO, generator=gen, device="cuda")
    x = rng.standard_normal((1, *AFNO_GRID, AFNO["in_channels"]))
    target = rng.standard_normal((1, *AFNO_GRID, AFNO["out_channels"]))
    layers = AFNO["n_layers"]
    launches, err = model_family(
        "afno", functools.partial(afno.apply, **AFNO_RUN),
        functools.partial(afno.loss_fn, **AFNO_RUN),
        functools.partial(afno.train_step, **AFNO_RUN), params, x, target,
        4 * layers, 8 * layers, l2_err, AFNO_GRAD_TOL)
    total, worst_abs = total + launches, max(worst_abs, err)
    block = params["blocks"][0]
    tokens = rng.standard_normal((1, AFNO_GRID[0] // 8, AFNO_GRID[1] // 8, AFNO["dim"]))
    afno_transform_gradients(block, cuda32(tokens), gen)
    with torch.no_grad():
        got = afno.afno_filter(block, cuda32(tokens), AFNO["n_blocks"], sparsity=0.01)
    want = afno_filter_oracle(to_numpy(block), tokens, AFNO["n_blocks"], 0.01)
    err = rel_err(got.cpu().numpy(), want)
    log(f"afno_filter {tuple(got.shape)}: rel err {err:.3e} vs float64 oracle")
    require(err <= ORACLE_TOL, f"afno_filter error {err:.3e}")
    del params, block, got

    # Koopman: no transform; from numpy input the entry points land on the card
    kp = koopman.init_koopman(8, latent_dim=16, hidden=64, depth=2, generator=gen,
                              device="cuda")
    kp["K"] = kp["K"] + 0.05 * torch.randn(16, 16, generator=gen).cuda()
    kp_cpu = tree_map(lambda t: t.cpu(), kp)
    trajs = rng.standard_normal((256, 64, 8)).astype(np.float32)
    with torch.no_grad():
        loss = koopman.koopman_loss(kp, trajs)
        roll = koopman.koopman_rollout(kp, trajs[:, 0], 16)
        loss_cpu = koopman.koopman_loss(kp_cpu, torch.from_numpy(trajs))
        roll_cpu = koopman.koopman_rollout(kp_cpu, torch.from_numpy(trajs[:, 0]), 16)
    require(loss.device.type == "cuda" and roll.device.type == "cuda",
            "koopman: results not on the card")
    err = max(abs(float(loss) - float(loss_cpu)) / abs(float(loss_cpu)),
              rel_err(roll.cpu().numpy(), roll_cpu.numpy()))
    log(f"koopman loss {float(loss):.6f} and 16-step rollout {tuple(roll.shape)}: rel err "
        f"{err:.3e} vs the CPU")
    require(err <= ORACLE_TOL, f"koopman on the card disagrees with the CPU: {err:.3e}")
    log(f"model family kernel launches: {total}")
    return total, worst_abs


def ops_tail(rng, card: str):
    """The ops tail from numpy input without a device: every result must lie
    on the card and agree with numpy/scipy float64 within ORACLE_TOL of the
    output's maximum.  Logs the kernel's launches per op.  Returns the
    launches and the kernel's worst abs error on the plane pairs it was
    handed."""
    ops = Ops()
    run, check, used, seen_all = ops.run, ops.check, ops.used, ops.seen

    cuda_fft.LAUNCHES = 0
    # short-time transforms at nperseg 1024, hop 256 on 16 x 2^18 samples
    nperseg, hop, t = 1024, 256, 2 ** 18
    x = rng.standard_normal((16, t))
    spec = run("stft", tp.stft, x, nperseg, nperseg - hop)
    win = scipy.signal.get_window("hann", nperseg)
    _, _, want = scipy.signal.stft(x, window=win, nperseg=nperseg, noverlap=nperseg - hop,
                                   boundary="even", padded=True)
    want = np.swapaxes(want, -1, -2) * win.sum()   # scipy scales by the window's sum
    frames = want.shape[1]
    check("stft 16 x 2^18, nperseg 1024, hop 256 vs scipy.signal.stft", spec[:, :frames], want)
    check("spectrogram", run("spectrogram", tp.spectrogram, x, nperseg, nperseg - hop)[:, :frames],
          np.abs(want) ** 2)
    check("istft(stft(x))", run("istft", tp.istft, spec, nperseg, nperseg - hop, length=t), x)
    del spec, want

    # Griffin-Lim: the spectral convergence falls with the iterations
    tone = np.arange(2 ** 16) / 16384.0
    sig = np.sin(2 * np.pi * 440 * tone) + 0.5 * np.sin(2 * np.pi * 1250 * tone)
    mag = torch.abs(run("stft", tp.stft, sig, nperseg, nperseg - hop))
    conv = []
    for n_iter in (1, 8):
        y = run("griffinlim", tp.griffinlim, mag, n_iter, nperseg, nperseg - hop, seed=SEED)
        est = torch.abs(run("stft", tp.stft, y, nperseg, nperseg - hop))[: mag.shape[0]]
        conv.append(float(torch.linalg.norm(est - mag) / torch.linalg.norm(mag)))
    log(f"griffinlim spectral convergence after 1 and 8 iterations: {conv[0]:.4f}, {conv[1]:.4f}")
    require(math.isfinite(conv[1]) and conv[1] < conv[0], f"griffinlim did not converge: {conv}")
    # time stretch keeps the pitch: the 440 Hz tone stays at 440 Hz
    y = run("time_stretch", tp.time_stretch, sig, 1.25, 2048)
    require(y.shape[-1] == int(round(len(sig) / 1.25)), f"time_stretch length {y.shape[-1]}")
    yn = y.cpu().numpy().astype(np.float64)
    peak = np.argmax(np.abs(np.fft.rfft(yn * np.hanning(len(yn))))) * 16384.0 / len(yn)
    log(f"time_stretch 2^16 samples by 1.25: {y.shape[-1]} samples, peak at {peak:.2f} Hz")
    require(np.all(np.isfinite(yn)) and abs(peak - 440.0) < 2.0, f"time_stretch peak {peak}")

    # cosine and sine transforms at n = 1024 x 256 rows
    x = rng.standard_normal((256, 1024))
    for kind in ("dct", "idct", "dst"):
        for type_ in (1, 2, 3, 4):
            check(f"{kind} type {type_} 1024 x 256",
                  run(kind, getattr(tp, kind), x, type_),
                  getattr(scipy.fft, kind)(x, type_))
    check("dct type 2 ortho", run("dct", tp.dct, x, norm="ortho"), scipy.fft.dct(x, norm="ortho"))
    sig = rng.standard_normal((8, 48000))
    coeff = run("mdct", tp.mdct, sig, 2048)
    check("imdct(mdct(x)) frame 2048", run("imdct", tp.imdct, coeff, length=48000), sig)
    grid = tp.cheb_points(129, np.float64)
    poly = np.polynomial.Polynomial([0.5, -1.0, 0.0, 2.0, 0.0, 1.0, -0.75])
    check("cheb_diff of a degree-6 polynomial, 129 points",
          run("cheb_diff", tp.cheb_diff, poly(grid)), poly.deriv()(grid), 2e-4)
    a = np.abs(rng.standard_normal((64, 4096)))
    check("fht n=4096 mu=1 bias=0.3", run("fht", tp.fht, a, 0.01, 1.0, offset=0.1, bias=0.3),
          scipy.fft.fht(a, 0.01, 1.0, offset=0.1, bias=0.3))
    x = rng.standard_normal((64, 1024))
    check("fwht n=1024", run("fwht", tp.fwht, x), x @ scipy.linalg.hadamard(1024))
    z = rng.standard_normal((16, 1000)) + 1j * rng.standard_normal((16, 1000))
    w, a0 = np.exp(-2j * np.pi / 4000), np.exp(0.3j)
    check("czt n=1000 m=600", run("czt", tp.czt, z, 600, w, a0), scipy.signal.czt(z, 600, w, a0))
    check("zoom_fft n=1000 [0.1, 0.4] m=512", run("zoom_fft", tp.zoom_fft, z, [0.1, 0.4], 512),
          scipy.signal.zoom_fft(z, [0.1, 0.4], 512, endpoint=False))
    # fractional orders add: 0.3 then 0.7 is the centered unitary DFT, and
    # ifrft inverts (the sampled kernel's own accuracy in fp32 sets the tolerance)
    tt = np.linspace(-4, 4, 1024)
    g = np.exp(-tt ** 2) * np.cos(3 * tt)
    f03 = run("frft", tp.frft, g, 0.3)
    want = np.roll(np.fft.fft(np.roll(g, -512)), 512) / 32.0
    check("frft(frft(x, 0.3), 0.7) = centered unitary DFT", run("frft", tp.frft, f03, 0.7),
          want, 2e-4)
    check("ifrft(frft(x, 0.3), 0.3) = x", run("frft", tp.ifrft, f03, 0.3), g.astype(complex), 2e-4)
    launches = cuda_fft.LAUNCHES
    log("ops tail kernel launches: " + ", ".join(f"{k} {v}" for k, v in used.items()))
    require(all(used[k] > 0 for k in ("stft", "istft", "spectrogram", "griffinlim",
                                      "time_stretch", "fht", "frft")),
            f"an op that goes through the fft layer never launched the kernel: {used}")
    require(all(used[k] == 0 for k in ("dct", "idct", "dst", "mdct", "imdct", "cheb_diff",
                                       "czt", "zoom_fft", "fwht")),
            f"an op of the stage pipeline launched the kernel: {used}")
    worst_abs = kernel_errors(seen_all, "ops-tail planes")
    del seen_all, ops

    # dct 1024 x 256 on its route (the stage pipeline) beside the kernel's
    xt = cuda32(rng.standard_normal((256, 1024)))
    zero = torch.zeros_like(xt)
    plan = tp.get_plan(1024, -1, "complex", tp.DEFAULT_CONFIG)
    # the calls' host tables stay on the card after the first call, so a CUDA
    # graph captures dct and stft: device time by replay beside the profiler's sum
    xs = cuda32(rng.standard_normal((16, 2 ** 18)))
    before = tp.utils.get_metrics().get("constant_uploads", 0)
    row = {
        "dct2_us": device_and_wall_us(lambda: tp.dct(xt))["device_us"],
        "dct2_graph_replay_us": graph_us(torch, lambda: tp.dct(xt)),
        "stft_16x2^18_nperseg1024_graph_replay_us": graph_us(
            torch, lambda: tp.stft(xs, 1024, 768)),
        "inner_stage_pipeline_us": graph_us(torch, lambda: exec_complex(plan, xt, zero)),
        "inner_kernel_us": graph_us(torch, lambda: exec_len(tp.DEFAULT_CONFIG, 1024, -1, xt, zero)),
    }
    uploads = tp.utils.get_metrics().get("constant_uploads", 0) - before
    log(f"dct and stft captured in CUDA graphs; host tables uploaded meanwhile: {uploads}")
    require(uploads <= 2, f"dct at a shape seen before uploaded {uploads} tables")
    log("dct type 2, 1024 x 256, device time: " + ", ".join(f"{k} {v:.2f}" for k, v in row.items()))
    log(json.dumps({"dct_routes": {"card": card, "n": 1024, "rows": 256, **row}}))
    return launches, worst_abs


# ---------------------------------------------------------------------------
# The audio path: phases 15-17
# ---------------------------------------------------------------------------


def slaney_filterbank(sr: float, n_fft: int, n_mels: int) -> np.ndarray:
    """The Slaney-scale, area-normalized triangular mel filterbank
    (librosa.filters.mel defaults) in float64, written out here so that the
    oracle shares no table with the library: (n_mels, n_fft//2 + 1)."""
    f_sp, min_log_hz, logstep = 200.0 / 3.0, 1000.0, np.log(6.4) / 27.0

    def to_mel(f):
        f = np.asarray(f, np.float64)
        return np.where(f >= min_log_hz,
                        min_log_hz / f_sp + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
                        f / f_sp)

    def to_hz(m):
        return np.where(m >= min_log_hz / f_sp,
                        min_log_hz * np.exp(logstep * (m - min_log_hz / f_sp)), f_sp * m)

    edges = to_hz(np.linspace(to_mel(0.0), to_mel(sr / 2.0), n_mels + 2))
    freqs = np.arange(n_fft // 2 + 1) * sr / n_fft
    up = (freqs[None, :] - edges[:-2, None]) / (edges[1:-1] - edges[:-2])[:, None]
    down = (edges[2:, None] - freqs[None, :]) / (edges[2:] - edges[1:-1])[:, None]
    return np.maximum(0.0, np.minimum(up, down)) * (2.0 / (edges[2:] - edges[:-2]))[:, None]


def frames_oracle(x: np.ndarray, n_fft: int, hop: int) -> np.ndarray:
    """Centered frames of (batch, T) float64: reflect-padded by n_fft//2,
    the tail zero-padded to a whole frame; (batch, frames, n_fft)."""
    xp = np.pad(x, ((0, 0), (n_fft // 2, n_fft // 2)), mode="reflect")
    n_frames = 1 + -(-(xp.shape[-1] - n_fft) // hop)
    xp = np.pad(xp, ((0, 0), (0, n_fft + (n_frames - 1) * hop - xp.shape[-1])))
    return xp[:, np.arange(n_frames)[:, None] * hop + np.arange(n_fft)[None, :]]


def mel_oracle(x: np.ndarray, sr: float, n_fft: int, hop: int, n_mels: int) -> np.ndarray:
    """Mel power spectrogram in float64 numpy: (batch, frames, n_mels)."""
    win = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft)
    spec = np.fft.rfft(frames_oracle(x, n_fft, hop) * win)
    return (spec.real ** 2 + spec.imag ** 2) @ slaney_filterbank(sr, n_fft, n_mels).T


def pcen_oracle(S: np.ndarray, gain, bias, power, b, eps: float = 1e-6) -> np.ndarray:
    """PCEN in float64 numpy on (batch, frames, bands): the one-pole
    smoother starts from the first frame and consumes it too."""
    m = S[:, 0]
    M = np.empty_like(S)
    for t in range(S.shape[1]):
        m = (1.0 - b) * m + b * S[:, t]
        M[:, t] = m
    return (S / (eps + M) ** gain + bias) ** power - bias ** power


def pcen_b(sr: float, hop: int, time_constant: float = 0.4) -> float:
    t_frames = time_constant * sr / hop
    return (np.sqrt(1.0 + 4.0 * t_frames ** 2) - 1.0) / (2.0 * t_frames ** 2)


def frontend_oracle_loss(p64, x64: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The audio front end's loss in float64 on the CPU through torch.fft,
    with autograd: mel power, PCEN with the per-band learned coefficients,
    mean over frames, linear head, mean softmax cross-entropy."""
    n_fft, hop = AUDIO["n_fft"], AUDIO["hop"]
    xp = torch.nn.functional.pad(x64[:, None], (n_fft // 2, n_fft // 2), mode="reflect")[:, 0]
    n_frames = 1 + -(-(xp.shape[-1] - n_fft) // hop)
    xp = torch.nn.functional.pad(xp, (0, n_fft + (n_frames - 1) * hop - xp.shape[-1]))
    win = torch.tensor(0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft))
    spec = torch.fft.rfft(xp.unfold(-1, n_fft, hop) * win)
    fb = torch.tensor(slaney_filterbank(AUDIO["sr"], n_fft, AUDIO["n_mels"]))
    S = (spec.real ** 2 + spec.imag ** 2) @ fb.T
    f = p64["frontend"]
    gain, bias, power = (torch.exp(f[k]) for k in ("log_gain", "log_bias", "log_power"))
    b = torch.sigmoid(f["smooth_logit"])
    m, smoothed = S[:, 0], []
    for t in range(S.shape[1]):
        m = (1.0 - b) * m + b * S[:, t]
        smoothed.append(m)
    M = torch.stack(smoothed, dim=1)
    feats = (S / (1e-6 + M) ** gain + bias) ** power - bias ** power
    logits = feats.mean(dim=1) @ p64["head"]["w"] + p64["head"]["b"]
    return torch.nn.functional.cross_entropy(logits, labels)


def audio_frontend_path(rng):
    """Phase 15: the trainable PCEN front end at its full size.  Forward from
    numpy input on the kernel route against the stage pipeline; mel power
    and PCEN features against float64 numpy; one train step with loss and
    every gradient leaf against the stage pipeline and a float64 torch oracle
    on the CPU; the kernel against its plain version on every plane pair it
    was handed; launches as the code predicts them.  Returns the launches and
    the kernel's worst abs error."""
    sr, n_fft, hop, n_mels = (AUDIO[k] for k in ("sr", "n_fft", "hop", "n_mels"))
    params = audio_frontend.init_params(
        n_mels, AUDIO["n_classes"], generator=torch.Generator().manual_seed(SEED), device="cuda")
    t = np.arange(AUDIO_SAMPLES) / sr
    tones = np.sin(2 * np.pi * rng.uniform(100.0, 4000.0, (AUDIO_BATCH, 1)) * t)
    x = 0.1 * rng.standard_normal((AUDIO_BATCH, AUDIO_SAMPLES)) + 0.3 * tones
    labels = rng.integers(0, AUDIO["n_classes"], AUDIO_BATCH)
    rows = AUDIO_BATCH * (1 + -(-AUDIO_SAMPLES // hop))
    torch.cuda.reset_peak_memory_stats()

    cuda_fft.LAUNCHES = 0
    with recorded_launches() as seen, torch.no_grad():
        logits = audio_frontend.apply(params, x, sr, n_fft)
        torch.cuda.synchronize()
        forward = cuda_fft.LAUNCHES
        logits_pipe = audio_frontend.apply(params, x, sr, n_fft, config=PIPELINE)
        feats = audio_frontend.apply_frontend(params["frontend"], x, sr, n_fft)
        mel = tp.melspectrogram(x, sr, n_fft, hop, n_mels=n_mels)
        torch.cuda.synchronize()
    require(logits.device.type == "cuda" and mel.device.type == "cuda",
            "audio front end: result not on the card")
    require(tuple(logits.shape) == (AUDIO_BATCH, AUDIO["n_classes"]),
            f"audio front end logits {tuple(logits.shape)}")
    require(forward == 1, f"audio front end forward launches {forward}, expected 1")
    err = rel_err(logits.cpu().numpy(), logits_pipe.cpu().numpy())
    log(f"audio front end: logits {tuple(logits.shape)} rel err {err:.3e} vs stage pipeline, "
        f"{forward} launch a forward ({n_fft // 2} x {rows} rows)")
    require(err <= ROUTES_TOL, f"audio front end forward error {err:.3e}")
    want_mel = mel_oracle(x, sr, n_fft, hop, n_mels)
    err = rel_err(mel.cpu().numpy(), want_mel)
    log(f"melspectrogram {tuple(mel.shape)}: rel err {err:.3e} vs float64 numpy")
    require(err <= ORACLE_TOL, f"melspectrogram error {err:.3e}")
    want_feats = pcen_oracle(want_mel, 0.98, 2.0, 0.5, 0.025)
    err = rel_err(feats.cpu().numpy(), want_feats)
    log(f"PCEN features {tuple(feats.shape)}: rel err {err:.3e} vs float64 numpy")
    require(err <= PCEN_TOL, f"PCEN features error {err:.3e}")

    xt, lt = cuda32(x), torch.tensor(labels, device="cuda")
    before = cuda_fft.LAUNCHES
    with recorded_launches() as seen_step:
        audio_frontend.train_step(params, xt, lt, sr=sr, n_fft=n_fft)
        torch.cuda.synchronize()
    n_step = cuda_fft.LAUNCHES - before
    # the waveform needs no gradient, so the backward launches nothing
    require(n_step == 1, f"audio front end train step launches {n_step}, expected 1")
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    xg = xt.clone().requires_grad_(True)
    before = cuda_fft.LAUNCHES
    with recorded_launches() as seen_input:
        loss = audio_frontend.loss_fn(leaves, xg, lt, sr, n_fft)
        grads = torch.autograd.grad(loss, tree_leaves(leaves) + [xg])
        torch.cuda.synchronize()
    n_input = cuda_fft.LAUNCHES - before
    require(n_input == 2, f"audio front end with an input gradient: {n_input} launches, expected 2")
    total = cuda_fft.LAUNCHES
    log(f"audio front end: {n_step} launch a train step, {n_input} with an input gradient")
    recorded = seen + seen_step + seen_input
    require(all((r[2], r[0].numel() // r[2]) == (n_fft // 2, rows) for r in recorded),
            f"audio front end kernel calls {[(r[2], tuple(r[0].shape), r[3]) for r in recorded]}")
    worst_abs = kernel_errors(recorded, "audio front-end planes")
    del seen, seen_step, seen_input, recorded

    route_error(audio_frontend.loss_fn, audio_frontend.train_step, params, xt, lt,
                "audio front end")
    p64 = tree_map(lambda p: p.detach().cpu().double().requires_grad_(True), params)
    x64 = torch.tensor(x, requires_grad=True)
    loss64 = frontend_oracle_loss(p64, x64, torch.tensor(labels))
    want = torch.autograd.grad(loss64, tree_leaves(p64) + [x64])
    loss, loss64 = float(loss.detach()), float(loss64.detach())
    err = abs(loss - loss64) / abs(loss64)
    names = [f"{g}/{k}" for g in params for k in params[g]] + ["x"]
    errs = {k: rel_err(g.cpu().numpy(), w.numpy()) for k, g, w in zip(names, grads, want)}
    log(f"audio front end: loss {loss:.6f} rel err {err:.3e} vs float64 oracle; gradients "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    require(err <= ORACLE_TOL, f"audio front end loss vs float64: {err:.3e}")
    require(max(errs.values()) <= AUDIO_GRAD_TOL,
            f"audio front end gradients vs float64: {errs}")
    log(f"audio front end: peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"kernel launches {total}")
    return total, worst_abs


def shorttime_oracle(x: np.ndarray, win: np.ndarray, hop: int, p0: int, p1: int) -> np.ndarray:
    """One-sided STFT with zero padding in float64 numpy, slice p over
    samples [p·hop − m//2, p·hop − m//2 + m): (batch, bins, slices)."""
    m = len(win)
    k = np.arange(p0, p1)[:, None] * hop - m // 2 + np.arange(m)[None, :]
    xp = np.pad(x, ((0, 0), (m, 2 * m + hop)))
    return np.swapaxes(np.fft.rfft(xp[:, k + m] * win), -1, -2)


def bispectrum_oracle(x: np.ndarray, nperseg: int) -> np.ndarray:
    """Direct bispectrum in float64 numpy: hann frames at half overlap, the
    mean removed, the triple product averaged, the principal domain kept."""
    hop = nperseg // 2
    n_frames = 1 + (x.shape[-1] - nperseg) // hop
    frames = x[..., np.arange(n_frames)[:, None] * hop + np.arange(nperseg)[None, :]]
    frames = frames - frames.mean(-1, keepdims=True)
    X = np.fft.rfft(frames * scipy.signal.get_window("hann", nperseg))
    f = np.arange(X.shape[-1])
    valid = (f[None, :] <= f[:, None]) & (f[:, None] + f[None, :] <= X.shape[-1] - 1)
    Xs = X[..., np.where(valid, f[:, None] + f[None, :], 0)]
    return (X[..., :, None] * X[..., None, :] * np.conj(Xs)).mean(-3) * valid


def gammatonegram_oracle(x: np.ndarray, fs: float, n_filters: int) -> np.ndarray:
    """Cochleagram in float64: 4th-order FIR gammatones on the ERB-rate
    ladder from 50 Hz to 0.45·fs, 'same' convolution, energy per 10 ms."""
    c = 9.26449 * 24.7
    freqs = np.exp(np.linspace(np.log(50.0 + c), np.log(0.45 * fs + c), n_filters)) - c
    tt = np.arange(max(int(fs * 0.015), 15)) / fs
    hop = int(0.010 * fs)
    out = []
    for f in freqs:
        bw = 1.019 * (f / 9.26449 + 24.7)
        h = tt ** 3 * np.exp(-2 * np.pi * bw * tt) * np.cos(2 * np.pi * f * tt)
        h *= 2 * (2 * np.pi * bw) ** 4 / 6.0 / fs
        y = scipy.signal.fftconvolve(x, h[None, :], mode="same", axes=-1) ** 2
        out.append(y[:, : (y.shape[-1] // hop) * hop].reshape(x.shape[0], -1, hop).mean(-1))
    return np.stack(out, axis=1)


class Ops:
    """Runs library calls from numpy input without a device: every tensor
    that comes back must lie on the card; the kernel's launches are counted
    per op name and the planes it was handed are kept."""

    def __init__(self):
        self.used, self.seen = {}, []

    def run(self, name, fn, *args, **kw):
        before = cuda_fft.LAUNCHES
        with recorded_launches() as seen:
            got = fn(*args, **kw)
            torch.cuda.synchronize()
        self.used[name] = self.used.get(name, 0) + cuda_fft.LAUNCHES - before
        self.seen.extend(seen)
        for t in (got if isinstance(got, tuple) else (got,)):
            if isinstance(t, torch.Tensor):
                require(t.device.type == CARD, f"{name}: result on {t.device}, not the card")
        return got

    @staticmethod
    def check(name, got, want, tol=ORACLE_TOL):
        want = np.asarray(want)
        require(tuple(got.shape) == want.shape, f"{name} shape {tuple(got.shape)} != {want.shape}")
        err = rel_err(got.cpu().numpy(), want)
        log(f"{name}: rel err {err:.3e}")
        require(err <= tol, f"{name} error {err:.3e}")


def audio_ops(rng, card: str):
    """Phase 16: the audio path's ops from numpy input without a device,
    against scipy/numpy float64.  Returns the launches and the kernel's worst
    abs error on the plane pairs it was handed."""
    ops = Ops()
    run, check = ops.run, ops.check
    cuda_fft.LAUNCHES = 0

    # Whisper's front end: 30 s at 16 kHz, n_fft 400, hop 160, 80 mel bands
    sr = WHISPER["sr"]
    t = np.arange(WHISPER_SAMPLES) / sr
    x = (0.1 * rng.standard_normal((WHISPER_BATCH, WHISPER_SAMPLES))
         + 0.3 * np.sin(2 * np.pi * rng.uniform(100.0, 4000.0, (WHISPER_BATCH, 1)) * t))
    mel = run("melspectrogram", tp.melspectrogram, x, sr, WHISPER["n_fft"], WHISPER["hop"],
              n_mels=WHISPER["n_mels"])
    want_mel = mel_oracle(x, **WHISPER)
    require(want_mel.shape[1] == 3001, f"{want_mel.shape[1]} frames")
    check(f"melspectrogram 16 x 480,000, n_fft 400, hop 160, 80 bands -> {tuple(mel.shape)}",
          mel, want_mel)
    inner = sorted({(r[2], r[0].numel() // r[2]) for r in ops.seen})
    log(f"melspectrogram n_fft 400 hands the kernel (n, rows) = {inner}")
    pc = run("pcen", tp.pcen, want_mel, sr, WHISPER["hop"])
    check("pcen, 3001 frames x 80 bands x 16", pc,
          pcen_oracle(want_mel, 0.98, 2.0, 0.5, pcen_b(sr, WHISPER["hop"])), PCEN_TOL)
    coeffs = run("mfcc", tp.mfcc, x, sr, 20, WHISPER["n_fft"], WHISPER["hop"], n_mels=80)
    db = 10.0 * np.log10(np.maximum(want_mel, 1e-10))
    db = np.maximum(db, db.max(axis=(-2, -1), keepdims=True) - 80.0)
    check("mfcc, 20 coefficients", coeffs, scipy.fft.dct(db, norm="ortho")[..., :20], MFCC_TOL)
    del mel, pc, coeffs, db

    # ShortTimeFFT at the same window and hop
    m, hop = WHISPER["n_fft"], WHISPER["hop"]
    win = scipy.signal.get_window("hann", m)
    st = tp.ShortTimeFFT(win, hop, sr)
    S = run("ShortTimeFFT.stft", st.stft, x)
    if hasattr(scipy.signal, "ShortTimeFFT"):
        ref, against = scipy.signal.ShortTimeFFT(win, hop, sr), "scipy.signal.ShortTimeFFT"
        want = ref.stft(x)
        require((st.p_min, st.p_max(x.shape[-1])) == (ref.p_min, ref.p_max(x.shape[-1])),
                "ShortTimeFFT slice range")
    else:
        want, against = shorttime_oracle(x, win, hop, st.p_min, st.p_max(x.shape[-1])), "numpy"
    check(f"ShortTimeFFT.stft 16 x 480,000, hann 400, hop 160 -> {tuple(S.shape)} vs {against}",
          S, want)
    check("ShortTimeFFT.spectrogram", run("ShortTimeFFT.spectrogram", st.spectrogram, x),
          np.abs(want) ** 2)
    check("ShortTimeFFT.istft(stft(x))",
          run("ShortTimeFFT.istft", st.istft, S, k1=x.shape[-1]), x)
    for args in (("hann", 400, 240), ("hann", 400, 200), ("boxcar", 400, 0)):
        require(tp.check_COLA(*args) == scipy.signal.check_COLA(*args), f"check_COLA{args}")
        require(tp.check_NOLA(*args) == scipy.signal.check_NOLA(*args), f"check_NOLA{args}")
    del S, want, x

    # resampling: 48 kHz -> 16 kHz on 30 s of 16 channels
    x48 = rng.standard_normal((16, 1_440_000))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    y = run("resample_poly", tp.resample_poly, x48, 1, 3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(f"resample_poly 16 x 1,440,000 by 1/3 (peak device memory {peak:.2f} GiB)", y,
          scipy.signal.resample_poly(x48, 1, 3, axis=-1))
    log(json.dumps({"resample_poly_memory": {"card": card, "shape": [16, 1_440_000], "up": 1,
                                             "down": 3, "peak_gib": peak}}))
    del y
    check("resample_poly 16 x 48,000 by 160/147",
          run("resample_poly", tp.resample_poly, x48[:, :48000], 160, 147),
          scipy.signal.resample_poly(x48[:, :48000], 160, 147, axis=-1))
    check("resample 16 x 30,000 -> 10,000", run("resample", tp.resample, x48[:, :30000], 10000),
          scipy.signal.resample(x48[:, :30000], 10000, axis=-1))
    check("decimate 16 x 2^18 by 4 (fir)", run("decimate", tp.decimate, x48[:, :2 ** 18], 4),
          scipy.signal.decimate(x48[:, :2 ** 18], 4, ftype="fir", axis=-1))
    taps = scipy.signal.firwin(64, 0.3)
    check("upfirdn 16 x 100,000, 64 taps, up 3, down 2",
          run("upfirdn", tp.upfirdn, taps, x48[:, :100000], 3, 2),
          scipy.signal.upfirdn(taps, x48[:, :100000], 3, 2, axis=-1))
    del x48

    # spectral estimates at nperseg 1024 on 16 x 2^20 samples
    x = rng.standard_normal((16, 2 ** 20))
    y = scipy.signal.lfilter(scipy.signal.firwin(31, 0.25), 1.0, x) + 0.5 * rng.standard_normal(x.shape)
    for name, fn, ref, args in (("welch", tp.welch, scipy.signal.welch, (x,)),
                                ("csd", tp.csd, scipy.signal.csd, (x, y)),
                                ("coherence", tp.coherence, scipy.signal.coherence, (x, y))):
        f, p = run(name, fn, *args, 16000.0, "hann", 1024)
        f_want, p_want = ref(*args, 16000.0, "hann", 1024, axis=-1)
        check(f"{name} 16 x 2^20, nperseg 1024", p, p_want)
        require(rel_err(f.cpu().numpy(), f_want) <= 1e-6, f"{name} frequencies")
    f, p = run("welch", tp.welch, x[:, :2 ** 16], 16000.0, "hann", 1024, average="median")
    check("welch, median average", p,
          scipy.signal.welch(x[:, :2 ** 16], 16000.0, "hann", 1024, average="median", axis=-1)[1])
    xs = x[:, :16384]
    check("hilbert 16 x 16,384", run("hilbert", tp.hilbert, xs), scipy.signal.hilbert(xs, axis=-1))
    X = np.fft.fft(xs)
    band = np.zeros_like(X)
    band[:, 1:8192] = 2.0 * X[:, 1:8192]
    env = run("envelope", tp.envelope, xs)
    check("envelope 16 x 16,384, band (1, None): envelope", env[0], np.abs(np.fft.ifft(band)))
    # outside the band (1, 8192) lie the mean and the Nyquist bin: ~1e-2 each
    # beside samples of ~4, so fp32 rounding of the transform shows at 1e-4
    alt = (-1.0) ** np.arange(16384)
    check("envelope: low-pass residual", env[1],
          (X[:, :1].real + X[:, 8192:8193].real * alt) / 16384.0, 1e-3)
    f, p = run("periodogram", tp.periodogram, xs, 16000.0, "hann")
    check("periodogram 16 x 16,384, hann", p, scipy.signal.periodogram(xs, 16000.0, "hann", axis=-1)[1])
    times = np.sort(rng.uniform(0.0, 10.0, 2000))
    obs = np.sin(3.7 * times) + 0.5 * rng.standard_normal((4, 2000))
    omegas = np.linspace(0.5, 10.0, 500)
    check("lombscargle 4 x 2000 samples, 500 frequencies",
          run("lombscargle", tp.lombscargle, times, obs, omegas),
          np.stack([scipy.signal.lombscargle(times, o, omegas) for o in obs]), LOMB_TOL)
    check("savgol_filter 16 x 16,384, window 11, order 3",
          run("savgol_filter", tp.savgol_filter, xs, 11, 3), scipy.signal.savgol_filter(xs, 11, 3, axis=-1))
    taps = scipy.signal.firwin(101, 0.3)
    w, h = run("freqz", tp.freqz, taps, 1.0, 512)
    check("freqz, 101 taps, 512 points", h, scipy.signal.freqz(taps, 1.0, 512)[1])
    proto = scipy.signal.remez(31, [0, 0.2, 0.3, 0.5], [1, 0])
    check("minimum_phase, 31 taps (homomorphic)", run("minimum_phase", tp.minimum_phase, proto),
          scipy.signal.minimum_phase(proto, method="homomorphic"), MINPHASE_TOL)
    del x, y, xs

    # wavelets, cochleagram, bispectrum
    data = rng.standard_normal((4, 4096))
    widths = [4.0, 8.0, 16.0, 32.0]
    want = np.stack([[np.convolve(row, np.conj(tp.morlet2(min(10 * wd, 4096), wd))[::-1], "same")
                      for row in data] for wd in widths])
    check("cwt morlet2, 4 widths on 4 x 4096", run("cwt", tp.cwt, data, tp.morlet2, widths), want)
    sig = rng.standard_normal((4, 16000))
    check("gammatonegram, 64 filters on 4 x 16,000 at 16 kHz",
          run("gammatonegram", tp.gammatonegram, sig, 16000.0, 64),
          gammatonegram_oracle(sig, 16000.0, 64))
    sig = rng.standard_normal((4, 65536))
    check("bispectrum nperseg 128 on 4 x 65,536", run("bispectrum", tp.bispectrum, sig, 128),
          bispectrum_oracle(sig, 128))

    # pitch: an octave up; a chirp tracked; a tone and clicks separated
    sr = 22050.0
    t = np.arange(32768) / sr
    y = run("pitch_shift", tp.pitch_shift, np.sin(2 * np.pi * 440.0 * t), sr, 12.0, nperseg=1024)
    yn = y.cpu().numpy().astype(np.float64)
    core = yn[4096:-4096] * np.hanning(len(yn) - 8192)
    peak_hz = np.argmax(np.abs(np.fft.rfft(core))) * sr / len(core)
    log(f"pitch_shift of 440 Hz by +12 steps: peak at {peak_hz:.2f} Hz")
    require(yn.shape == t.shape and abs(peak_hz - 880.0) < 10.0, f"pitch_shift peak {peak_hz}")
    sr, hop = 16000.0, 256
    t = np.arange(32000) / sr
    f_true = 200.0 + 100.0 * t
    chirp = np.sin(2 * np.pi * np.cumsum(f_true) / sr)
    f0 = run("yin", tp.yin, chirp, 100.0, 800.0, sr, 1024).cpu().numpy()
    centers = np.minimum(np.arange(len(f0)) * hop, len(t) - 1)
    inner = slice(3, -3)
    err = np.max(np.abs(f0[inner] - f_true[centers][inner]) / f_true[centers][inner])
    log(f"yin on a 200 -> 400 Hz chirp: worst relative pitch error {err:.4f} over {len(f0)} frames")
    require(err < 0.02, f"yin pitch error {err}")
    f0, voiced, prob = (v.cpu().numpy() for v in run("pyin", tp.pyin, chirp, 100.0, 800.0, sr, 1024))
    ok = voiced[inner]
    err = np.max(np.abs(f0[inner][ok] - f_true[centers][inner][ok]) / f_true[centers][inner][ok])
    log(f"pyin on the chirp: {ok.mean():.3f} of the frames voiced, worst relative pitch error "
        f"{err:.4f}")
    require(ok.mean() > 0.9 and err < 0.02, f"pyin: voiced {ok.mean()}, error {err}")
    sr = 22050.0
    t = np.arange(16384) / sr
    tone = 0.8 * np.sin(2 * np.pi * 880.0 * t)
    clicks = np.zeros_like(tone)
    clicks[2000::3000] = 3.0
    S = run("stft", tp.stft, tone + clicks, 512, 384)
    H, P = run("hpss", tp.hpss, S)
    xh = run("istft", tp.istft, H, 512, 384, length=len(t)).cpu().numpy()
    xp = run("istft", tp.istft, P, 512, 384, length=len(t)).cpu().numpy()
    corr = np.corrcoef(xh[1024:-1024], tone[1024:-1024])[0, 1]
    at = np.flatnonzero(clicks)
    at = at[(at > 1024) & (at < len(t) - 1024)]
    ratio = np.mean(np.abs(xp[at])) / np.mean(np.abs(xh[at]))
    log(f"hpss of a tone plus clicks: harmonic part correlates {corr:.4f} with the tone; the "
        f"clicks are {ratio:.1f}x larger in the percussive part")
    require(corr > 0.95 and ratio > 3.0, f"hpss: {corr}, {ratio}")

    launches = cuda_fft.LAUNCHES
    log("audio ops kernel launches: " + ", ".join(f"{k} {v}" for k, v in ops.used.items()))
    through = ("melspectrogram", "mfcc", "ShortTimeFFT.stft", "ShortTimeFFT.spectrogram",
               "ShortTimeFFT.istft", "resample", "welch", "csd", "coherence", "hilbert", "envelope",
               "periodogram", "freqz", "minimum_phase", "cwt", "gammatonegram", "bispectrum",
               "pitch_shift", "yin", "pyin", "stft", "istft")
    require(all(ops.used[k] > 0 for k in through),
            f"an op that goes through the fft layer never launched the kernel: {ops.used}")
    require(all(ops.used[k] == 0 for k in ("pcen", "upfirdn", "lombscargle", "savgol_filter", "hpss")),
            f"an op without a transform launched the kernel: {ops.used}")
    worst_abs = kernel_errors(ops.seen, "audio-ops planes")
    return launches, worst_abs


def timing_row(name: str, fn, calls: int, capture: bool = True) -> dict:
    """Device and wall times of ``fn`` as phases 11 and 14 read them, and the
    fused kernel's launches and share."""
    before = cuda_fft.LAUNCHES
    fn()
    k1_launches = cuda_fft.LAUNCHES - before
    t = device_and_wall_us(fn, calls=calls)
    graph = graph_us(torch, fn, launches=1, replays=calls) if capture else None
    row = {"call": name, "device_us_profiler": t["device_us"], "device_us_graph_replay": graph,
           "back_to_back_us": t["wall_us"], "idle_share": t["idle_share"],
           "device_kernels_per_call": t["kernels"], "k1_launches": k1_launches,
           "k1_device_us": t["k1_us"],
           "k1_share": None if t["device_us"] is None else t["k1_us"] / t["device_us"]}
    log(f"{name}: device {t['device_us']} us (torch.profiler sum), {graph} us (graph replay), "
        f"back to back {t['wall_us']:.2f} us, idle share {t['idle_share']}, {t['kernels']} device "
        f"kernels, K1 {t['k1_us']:.2f} us in {k1_launches} launches")
    for kernel, us in list(t["by_name"].items())[:6]:
        short = re.sub(r"void |at::native::|\(anonymous namespace\)::|binary_internal::", "", kernel)
        log(f"  {us:9.2f} us  {short[:110]}")
    return row


def audio_timings(rng, card: str) -> None:
    """Phase 17: device time (profiler sum and graph replay), back-to-back
    wall time, idle share, device kernels and the fused kernel's share of the
    audio path's calls at the sizes of phases 15 and 16."""
    sr, n_fft, hop, n_mels = (AUDIO[k] for k in ("sr", "n_fft", "hop", "n_mels"))
    params = audio_frontend.init_params(
        n_mels, AUDIO["n_classes"], generator=torch.Generator().manual_seed(SEED), device="cuda")
    x = cuda32(0.1 * rng.standard_normal((AUDIO_BATCH, AUDIO_SAMPLES)))
    labels = torch.tensor(rng.integers(0, AUDIO["n_classes"], AUDIO_BATCH), device="cuda")

    def forward():
        with torch.no_grad():
            return audio_frontend.apply(params, x, sr, n_fft)

    rows = [
        timing_row("audio front end forward, 256 x 16,000", forward, 5),
        timing_row("audio front end train step, 256 x 16,000",
                   lambda: audio_frontend.train_step(params, x, labels, sr=sr, n_fft=n_fft), 5),
    ]
    del x
    xw = cuda32(0.1 * rng.standard_normal((WHISPER_BATCH, WHISPER_SAMPLES)))
    with torch.no_grad():
        rows.append(timing_row(
            "melspectrogram 16 x 480,000, n_fft 400, hop 160, 80 bands",
            lambda: tp.melspectrogram(xw, WHISPER["sr"], WHISPER["n_fft"], WHISPER["hop"], n_mels=80), 5))
        mel = tp.melspectrogram(xw, WHISPER["sr"], WHISPER["n_fft"], WHISPER["hop"], n_mels=80)
        rows.append(timing_row("pcen forward, 16 x 3001 x 80",
                               lambda: tp.pcen(mel, WHISPER["sr"], WHISPER["hop"]), 3))
    del xw
    coef = {k: torch.full((80,), v, device="cuda", requires_grad=True)
            for k, v in dict(gain=0.98, bias=2.0, power=0.5, b=0.025).items()}

    def pcen_step():
        return torch.autograd.grad(tp.pcen(mel, **coef).sum(), list(coef.values()))

    rows.append(timing_row("pcen forward + backward, per-band coefficients, 16 x 3001 x 80",
                           pcen_step, 3))
    del mel
    x48 = cuda32(rng.standard_normal((16, 1_440_000)))
    with torch.no_grad():
        rows.append(timing_row("resample_poly 16 x 1,440,000 by 1/3",
                               lambda: tp.resample_poly(x48, 1, 3), 5))
    del x48
    torch.cuda.empty_cache()
    log(json.dumps({"audio_timing": {"card": card, "calls": rows}}))


def family_timings(rng, card: str) -> None:
    """Forward and train step of the three model families of phase 12:
    device time by torch.profiler sums and by CUDA-graph replay, back-to-back
    wall time, idle share, device kernels per call and the fused kernel's
    share of the device time."""
    gen = torch.Generator().manual_seed(SEED)
    f32 = lambda *shape: cuda32(rng.standard_normal(shape))
    cases = [
        ("s4d 128 x 4, L=1024, b=64", s4d.init_s4d_model(**S4D, generator=gen, device="cuda"),
         f32(S4D_BATCH, S4D_LENGTH, S4D["in_dim"]), f32(S4D_BATCH, S4D["out_dim"]),
         s4d.apply_s4d, s4d.train_step),
        ("fnet-base 768 x 12, seq 512, b=8", fnet.init_fnet(**FNET, generator=gen, device="cuda"),
         f32(FNET_BATCH, FNET_SEQ, FNET["hidden"]), f32(FNET_BATCH, FNET_SEQ, FNET["hidden"]),
         fnet.apply, fnet.train_step),
        ("afno 768 x 12, 90 x 180 tokens, b=1", afno.init_afno(**AFNO, generator=gen, device="cuda"),
         f32(1, *AFNO_GRID, AFNO["in_channels"]), f32(1, *AFNO_GRID, AFNO["out_channels"]),
         functools.partial(afno.apply, **AFNO_RUN),
         functools.partial(afno.train_step, **AFNO_RUN)),
    ]
    rows = []
    for name, params, x, target, apply, step in cases:
        def forward():
            with torch.no_grad():
                return apply(params, x)

        rows.append(timing_row(f"{name} forward", forward, 5))
        rows.append(timing_row(f"{name} train_step", lambda: step(params, x, target), 5))
        del params
        torch.cuda.empty_cache()
    log(json.dumps({"family_timing": {"card": card, "calls": rows}}))


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
    """The kernel against torch.fft.fft (cuFFT) at YARDSTICK_SHAPES and at the
    model families' shapes (S4D's 1024 x 8192 rows among them), device times
    from kernel_bench.graph_us, with the bytes bound and the kernel's share of it."""
    rows = []
    family_shapes = KERNEL_MANY_ROWS + ((1024, S4D_BATCH * S4D["hidden"]),) + AUDIO_KERNEL_SHAPES
    own = np.random.default_rng(SEED)   # the added shapes leave ``rng``'s stream as it was
    for n, b in YARDSTICK_SHAPES + family_shapes:
        draw = own if (n, b) in family_shapes else rng
        x = draw.standard_normal((b, n)) + 1j * draw.standard_normal((b, n))
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


# ---------------------------------------------------------------------------
# The recurrences and the audio remainder: phases 18-20
# ---------------------------------------------------------------------------

# phase 16's 16 channels of 30 s at 48 kHz, decimated to 16 kHz by scipy's
# default IIR (Chebyshev I, order 8, zero phase)
DECIMATE_SHAPE, DECIMATE_Q = (16, 1_440_000), 3
# sosfilt of butter(6) at 8 x 65,536, the case the JAX package measured its
# scan's precision on (ops/iir.py:999-1002); the other filters, dlsim and
# the cubic spline at the same length
RECURRENCE_SHAPE = (8, 65536)
# the constant-velocity car tracker of Särkkä & García-Fernández, "Temporal
# parallelization of Bayesian smoothers" (arXiv 1905.13002): state
# (x, y, vx, vy), position observed; step 0.1 s, white-noise acceleration of
# spectral density 1, observation noise 0.5
KALMAN_DT, KALMAN_QC, KALMAN_SIGMA = 0.1, 1.0, 0.5
KALMAN_PARALLEL_T, KALMAN_SEQUENTIAL_T = 10_000, 1_000
# against scipy float64: the JAX package's own tests' tolerances for the same
# functions (tests/test_iir.py, test_ltisys.py, test_splines.py, test_kalman.py)
SOSFILT_TOL = 1e-5
LFILTER_TOL = 2e-4
FILTFILT_TOL = 5e-4
SOSFILTFILT_TOL = 1e-4
DECIMATE_IIR_TOL = 1e-3
DLSIM_TOL = 1e-4
CSPLINE_TOL = 5e-5
CSPLINE_EVAL_TOL = 1e-4
KALMAN_FILTER_TOL = 3e-4
KALMAN_SMOOTHER_TOL = 5e-4
# librosa's defaults, which are the JAX package's: 22,050 Hz, hop 512, fmin C1,
# 84 bins, 12 per octave; 8 clips of 30 s
CQT = dict(fs=22050.0, fmin=32.703195662574764, n_bins=84, bins_per_octave=12, hop=512)
CLIP_BATCH, CLIP_SAMPLES = 8, 30 * 22050
SCATTER_SHAPE = (16, 2 ** 16)        # scattering1d at J = 6, Q = 8
TFR_SHAPE = (8, 4096)
# the synchrosqueezed bin-sum inversion at the frame centers, as the JAX
# package's test holds it (tests/test_tfr.py)
ISSQ_TOL = 0.05
# fp32 sums over a CQT band of up to 11,339 taps, and over an 16,384-point
# frame, relative to the largest coefficient
CQT_TOL = 1e-5
# Lee-Seung updates multiply ratios of fp32 products 50 times over
DECOMPOSE_TOL = 1e-3
# the geometric mean of the power spectrum takes the log of every bin, and a
# weak bin's fp32 error is relative to its frame's strongest bin
FLATNESS_TOL = 2e-4
# the oracles of phase 19 run on these rows of each batch (float64 numpy on
# the host is the slow side)
ORACLE_ROWS = (0, -1)


def kalman_model():
    """(F, Q, H, R, m0, P0) of the constant-velocity car tracker."""
    dt, qc, s = KALMAN_DT, KALMAN_QC, KALMAN_SIGMA
    F = np.eye(4)
    F[0, 2] = F[1, 3] = dt
    Q = qc * np.kron(np.array([[dt ** 3 / 3, dt ** 2 / 2], [dt ** 2 / 2, dt]]), np.eye(2))
    H = np.eye(2, 4)
    return F, Q, H, s * s * np.eye(2), np.zeros(4), np.eye(4)


def kalman_track(rng, T: int):
    """Observations of a simulated track, (T, 2) float64."""
    F, Q, H, R, m0, P0 = kalman_model()
    w = rng.standard_normal((T, 4)) @ np.linalg.cholesky(Q).T
    v = rng.standard_normal((T, 2)) @ np.linalg.cholesky(R).T
    x, ys = rng.multivariate_normal(m0, P0), np.empty((T, 2))
    for t in range(T):
        x = F @ x + w[t]
        ys[t] = H @ x + v[t]
    return ys


def kalman_oracle(F, Q, H, R, m0, P0, ys):
    """Kalman filter then Rauch-Tung-Striebel smoother in float64 numpy."""
    m, P, ms, Ps = m0, P0, [], []
    for y in ys:
        m, P = F @ m, F @ P @ F.T + Q
        K = P @ H.T @ np.linalg.inv(H @ P @ H.T + R)
        m, P = m + K @ (y - H @ m), (np.eye(len(m)) - K @ H) @ P
        ms.append(m)
        Ps.append(P)
    gs, Ls = [ms[-1]], [Ps[-1]]
    for k in range(len(ys) - 2, -1, -1):
        P_pred = F @ Ps[k] @ F.T + Q
        G = Ps[k] @ F.T @ np.linalg.inv(P_pred)
        gs.append(ms[k] + G @ (gs[-1] - F @ ms[k]))
        Ls.append(Ps[k] + G @ (Ls[-1] - P_pred) @ G.T)
    return np.array(ms), np.array(Ps), np.array(gs[::-1]), np.array(Ls[::-1])


def pcen_oracle_torch(S64: torch.Tensor, gain, bias, power, b, eps: float = 1e-6) -> torch.Tensor:
    """PCEN in float64 torch on the CPU (autograd through a loop over frames)."""
    m, smoothed = S64[:, 0], []
    for t in range(S64.shape[1]):
        m = (1.0 - b) * m + b * S64[:, t]
        smoothed.append(m)
    M = torch.stack(smoothed, dim=1)
    return (S64 / (eps + M) ** gain + bias) ** power - bias ** power


def check_kalman(name, got, want_m, want_P, tol):
    scale = max(1.0, float(np.max(np.abs(want_m))))
    err_m = float(np.max(np.abs(got[0].cpu().numpy() - want_m))) / scale
    err_P = float(np.max(np.abs(got[1].cpu().numpy() - want_P)))
    log(f"{name}: means {err_m:.3e} of max |m| = {scale:.1f}, covariances abs err {err_P:.3e}")
    require(err_m <= tol and err_P <= tol, f"{name}: {err_m:.3e}, {err_P:.3e}")


def recurrences(rng, card: str):
    """Phase 18: the recurrence group from numpy input without a device, on
    the card, against scipy/numpy float64 (PCEN's per-band gradients against
    a float64 torch loop on the CPU).  None of these calls reaches the fft
    layer.  Returns the kernel's launches."""
    ops = Ops()
    run, check = ops.run, ops.check
    cuda_fft.LAUNCHES = 0

    x48 = rng.standard_normal(DECIMATE_SHAPE)
    check(f"decimate {DECIMATE_SHAPE[0]} x {DECIMATE_SHAPE[1]:,} by {DECIMATE_Q}, ftype='iir' "
          "(Chebyshev I order 8, zero phase)",
          run("decimate(iir)", tp.decimate, x48, DECIMATE_Q, ftype="iir"),
          scipy.signal.decimate(x48, DECIMATE_Q, ftype="iir", axis=-1), DECIMATE_IIR_TOL)
    del x48

    rows, n = RECURRENCE_SHAPE
    x = rng.standard_normal(RECURRENCE_SHAPE)
    shape = f"{rows} x {n:,}"
    sos, sos64 = tp.butter(6, 0.2, output="sos"), scipy.signal.butter(6, 0.2, output="sos")
    check(f"sosfilt butter(6) sos {shape}", run("sosfilt", tp.sosfilt, sos, x),
          scipy.signal.sosfilt(sos64, x, axis=-1), SOSFILT_TOL)
    check(f"sosfiltfilt butter(6) sos {shape}", run("sosfiltfilt", tp.sosfiltfilt, sos, x),
          scipy.signal.sosfiltfilt(sos64, x, axis=-1), SOSFILTFILT_TOL)
    b, a = tp.butter(4, 0.2)
    b64, a64 = scipy.signal.butter(4, 0.2)
    check(f"lfilter butter(4) ba {shape}", run("lfilter", tp.lfilter, b, a, x),
          scipy.signal.lfilter(b64, a64, x, axis=-1), LFILTER_TOL)
    check(f"filtfilt butter(4) ba {shape}", run("filtfilt", tp.filtfilt, b, a, x),
          scipy.signal.filtfilt(b64, a64, x, axis=-1), FILTFILT_TOL)

    # two damped modes, zero-order hold at 10 ms
    A = np.array([[0.0, 1.0, 0.0, 0.0], [-4.0, -2.0, 1.0, 0.0],
                  [0.0, 0.0, 0.0, 1.0], [1.0, 0.0, -9.0, -3.0]])
    B, C, D = np.array([[0.0], [1.0], [0.0], [0.5]]), np.array([[1.0, 0.0, 0.5, 0.0]]), np.zeros((1, 1))
    sysd = tp.cont2discrete((A, B, C, D), 0.01)
    sysd64 = scipy.signal.cont2discrete((A, B, C, D), 0.01)
    require(all(np.allclose(g, w, rtol=0, atol=1e-12) for g, w in zip(sysd[:4], sysd64[:4])),
            "cont2discrete differs from scipy's")
    u = rng.standard_normal((n, 1))
    _, y, xs = run("dlsim", tp.dlsim, sysd, u)
    _, y64, x64 = scipy.signal.dlsim(sysd64, u)
    check(f"dlsim 4 states x {n:,} steps: output", y, y64, DLSIM_TOL)
    check("dlsim: states", xs, x64, DLSIM_TOL)

    sig = np.cumsum(rng.standard_normal(RECURRENCE_SHAPE), axis=-1) / np.sqrt(n)
    cj = run("cspline1d", tp.cspline1d, sig)
    check(f"cspline1d {shape}", cj, np.stack([scipy.signal.cspline1d(r) for r in sig]), CSPLINE_TOL)
    newx = np.sort(rng.uniform(-8.0, n + 8.0, 4096))
    cj64 = np.stack([scipy.signal.cspline1d(r) for r in sig])
    check(f"cspline1d_eval {shape} at 4096 points (mirrored past the ends)",
          run("cspline1d_eval", tp.cspline1d_eval, cj, newx),
          np.stack([scipy.signal.cspline1d_eval(c, newx) for c in cj64]), CSPLINE_EVAL_TOL)
    del x, sig, cj, cj64

    model = kalman_model()
    for T, parallel in ((KALMAN_PARALLEL_T, True), (KALMAN_SEQUENTIAL_T, False)):
        ys = kalman_track(rng, T)
        fm, fP, sm, sP = kalman_oracle(*model, ys)
        form = "parallel" if parallel else "sequential"
        check_kalman(f"kalman_filter, car tracker, T = {T:,}, {form}",
                     run("kalman_filter", tp.kalman_filter, *model, ys, parallel=parallel),
                     fm, fP, KALMAN_FILTER_TOL)
        check_kalman(f"kalman_smoother, T = {T:,}, {form}",
                     run("kalman_smoother", tp.kalman_smoother, *model, ys, parallel=parallel),
                     sm, sP, KALMAN_SMOOTHER_TOL)

    # PCEN on Whisper's mel power: 16 x 3001 frames x 80 bands
    sr, hop = WHISPER["sr"], WHISPER["hop"]
    t = np.arange(WHISPER_SAMPLES) / sr
    xw = (0.1 * rng.standard_normal((WHISPER_BATCH, WHISPER_SAMPLES))
          + 0.3 * np.sin(2 * np.pi * rng.uniform(100.0, 4000.0, (WHISPER_BATCH, 1)) * t))
    S = mel_oracle(xw, **WHISPER).astype(np.float32).astype(np.float64)
    del xw
    check(f"pcen {tuple(S.shape)}, scalar coefficients",
          run("pcen", tp.pcen, S.astype(np.float32), sr, hop),
          pcen_oracle(S, 0.98, 2.0, 0.5, pcen_b(sr, hop)), PCEN_TOL)
    coef = {"gain": 0.98 + 0.01 * rng.standard_normal(80), "bias": 2.0 + 0.1 * rng.standard_normal(80),
            "power": 0.5 + 0.01 * rng.standard_normal(80),
            "b": pcen_b(sr, hop) * (1.0 + 0.1 * rng.standard_normal(80))}
    w = rng.standard_normal(S.shape)
    leaves = {k: cuda32(v).requires_grad_(True) for k, v in coef.items()}
    out = run("pcen", tp.pcen, cuda32(S), **leaves)
    check("pcen, per-band coefficients", out.detach(), pcen_oracle(S, *coef.values()), PCEN_TOL)
    grads = torch.autograd.grad((out * cuda32(w)).sum(), list(leaves.values()))
    leaves64 = {k: torch.tensor(v, requires_grad=True) for k, v in coef.items()}
    loss64 = (pcen_oracle_torch(torch.tensor(S), **leaves64) * torch.tensor(w)).sum()
    want = torch.autograd.grad(loss64, list(leaves64.values()))
    errs = {k: rel_err(g.cpu().numpy(), wt.numpy()) for k, g, wt in zip(coef, grads, want)}
    log("pcen per-band gradients vs float64: " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    require(max(errs.values()) <= AUDIO_GRAD_TOL, f"pcen gradients vs float64: {errs}")

    launches = cuda_fft.LAUNCHES
    log("recurrence kernel launches: " + ", ".join(f"{k} {v}" for k, v in ops.used.items()))
    require(launches == 0, f"a recurrence launched the fft kernel: {ops.used}")
    return launches


def cqt_oracle(x: np.ndarray, fs, fmin, n_bins, bins_per_octave, hop) -> np.ndarray:
    """The constant-Q transform by its definition in float64 numpy: each band
    k a Hann window of N_k = round(Q·fs/f_k) samples times e^(2πi·f_k·n/fs)
    over N_k, correlated with the zero-padded signal at frames t·hop (frames
    of the next power of two above the longest band, each band centered in
    it): (frames, n_bins)."""
    freqs = fmin * 2.0 ** (np.arange(n_bins) / bins_per_octave)
    Q = 1.0 / (2.0 ** (1.0 / bins_per_octave) - 1.0)
    lengths = [max(int(round(Q * fs / f)), 1) for f in freqs]
    nf = 1 << int(np.ceil(np.log2(max(lengths))))
    xp = np.concatenate([np.zeros(nf // 2), x, np.zeros(nf // 2)])
    frames = np.lib.stride_tricks.sliding_window_view(xp, nf)[::hop]
    out = np.empty((frames.shape[0], n_bins), np.complex128)
    for k, (f, n_k) in enumerate(zip(freqs, lengths)):
        m = np.arange(n_k) - (n_k - 1) / 2.0
        g = scipy.signal.get_window("hann", n_k, fftbins=False) * np.exp(2j * np.pi * f / fs * m) / n_k
        s = (nf - n_k) // 2
        out[:, k] = frames[:, s: s + n_k] @ np.conj(g)
    return out


def icqt_oracle(C: np.ndarray, length: int, fs, fmin, n_bins, bins_per_octave, hop) -> np.ndarray:
    """The inverse through the dual kernel (the host table of ``ops/cqt.py``)
    in float64 numpy: 2·Re ifft of each frame's spectrum, overlap-added and
    divided by the coverage, the centering cut."""
    P, nf = cqt_ops._icqt_dual_kernel(fs, fmin, n_bins, bins_per_octave, "hann", 1.0, None, 1e-6)
    frames = 2.0 * np.real(np.fft.ifft(C @ P.T, axis=-1))
    out, cover = np.zeros(nf + (len(C) - 1) * hop), np.zeros(nf + (len(C) - 1) * hop)
    for i, fr in enumerate(frames):
        out[i * hop: i * hop + nf] += fr
        cover[i * hop: i * hop + nf] += 1.0
    return (out / np.maximum(cover, 1.0))[nf // 2: len(out) - nf // 2][:length]


def scattering_oracle(x: np.ndarray, J: int, Q: int, pairs) -> tuple:
    """First and second scattering orders in float64 numpy with the host bank
    of ``ops/scattering.py``, stride 2^(J-1)."""
    psi1, psi2, phi, _, _ = scattering_ops._scattering_bank(x.shape[-1], J, Q, None)
    stride = 1 << (J - 1)
    low = lambda v: np.real(np.fft.ifft(np.fft.fft(v) * phi))[..., ::stride]
    X = np.fft.fft(x)
    U1 = np.abs(np.fft.ifft(X[None] * psi1))
    U2 = np.abs(np.fft.ifft(np.fft.fft(U1[[p[0] for p in pairs]]) * psi2[[p[1] for p in pairs]]))
    return low(x), low(U1), low(U2)


def wigner_ville_oracle(x: np.ndarray, nperseg: int) -> np.ndarray:
    """The pseudo Wigner-Ville distribution in float64 numpy: lag products of
    the analytic signal z[t+τ]·conj(z[t−τ]) for |τ| <= nperseg//2, a Hann lag
    window, the transform over lags."""
    T, half = x.shape[-1], nperseg // 2
    z = scipy.signal.hilbert(x, axis=-1)
    t, tau = np.arange(T)[:, None], np.arange(-half, half + 1)[None, :]
    valid = (t + tau >= 0) & (t + tau < T) & (t - tau >= 0) & (t - tau < T)
    prod = z[..., np.clip(t + tau, 0, T - 1)] * np.conj(z[..., np.clip(t - tau, 0, T - 1)]) * valid
    w = scipy.signal.get_window("hann", nperseg - 1)
    h = np.fft.ifftshift(np.concatenate([w, w[:1]]))
    return np.real(np.fft.fft(np.roll(prod, -half, axis=-1) * h, axis=-1))


def stockwell_oracle(x: np.ndarray) -> np.ndarray:
    """The S-transform in float64 numpy: voice k is the inverse transform of
    the spectrum shifted by k times a Gaussian of width k; voice 0 the mean."""
    T = x.shape[-1]
    X = np.fft.fft(x)
    j = np.fft.fftfreq(T) * T
    ks = np.arange(T // 2 + 1)
    G = np.exp(-2.0 * np.pi ** 2 * j[None, :] ** 2 / np.maximum(ks[:, None], 1) ** 2)
    S = np.fft.ifft(X[..., (np.arange(T)[None, :] + ks[:, None]) % T] * G)
    S[..., 0, :] = x.mean(-1, keepdims=True)
    return S


def features_oracle(x: np.ndarray, sr: float, nperseg: int, hop: int) -> dict:
    """Spectral features of one clip in float64 numpy from its magnitude
    spectrogram (periodic Hann, reflect-centered frames)."""
    mag = np.abs(np.fft.rfft(frames_oracle(x[None], nperseg, hop)[0]
                             * scipy.signal.get_window("hann", nperseg)))
    f = np.fft.rfftfreq(nperseg) * sr
    norm = np.maximum(mag.sum(-1), 1e-30)
    cent = (mag * f).sum(-1) / norm
    p = np.maximum(mag ** 2, 1e-10)
    csum = np.cumsum(mag, -1)
    return {
        "spectral_centroid": cent,
        "spectral_bandwidth": np.sqrt((mag * (f - cent[:, None]) ** 2).sum(-1) / norm),
        "spectral_rolloff": f[np.argmax(csum >= 0.85 * csum[:, -1:], axis=-1)],
        "spectral_flatness": np.exp(np.log(p).mean(-1)) / p.mean(-1),
    }


def beat_oracle(env: np.ndarray, bpm: float, sr: float, hop: int, tightness: float = 100.0,
                min_bpm: float = 24.0) -> np.ndarray:
    """Ellis's dynamic programme in float64 numpy: score C[t] = O[t] +
    max(0, max_Δ C[t−Δ] − tightness·log²(Δ/p)), beats by the backpointers
    from the best frame."""
    n = len(env)
    env = env / max(env.std(), 1e-10)
    period = 60.0 * sr / (hop * bpm)
    D = int(min(np.ceil(2.0 * 60.0 * sr / (hop * min_bpm)), n - 1))
    pen = -tightness * np.log(np.arange(1, D + 1) / period) ** 2
    C, back = np.zeros(n), np.zeros(n, np.int64)
    for t in range(n):
        lo = max(0, t - D)
        cand = C[lo:t][::-1] + pen[: t - lo]
        best = cand.max() if t > 0 else -np.inf
        C[t] = env[t] + max(best, 0.0)
        back[t] = np.argmax(cand) + 1 if best > 0.0 else 0
    beats, cur = np.zeros(n, bool), int(np.argmax(C))
    while cur >= 0:
        beats[cur] = True
        cur = cur - back[cur] if back[cur] > 0 else -1
    return beats


def audio_remainder(rng, card: str):
    """Phase 19: the CQT, time-frequency, scattering and feature ops from
    numpy input without a device, on the card, against float64 numpy (the
    definitions written out here; a few rows of each batch).  Returns the
    launches and the kernel's worst abs error on the plane pairs it was
    handed."""
    ops = Ops()
    run, check = ops.run, ops.check
    cuda_fft.LAUNCHES = 0
    worst = []

    def kernel_check(what):
        worst.append(kernel_errors(ops.seen, what))
        ops.seen.clear()
        log(f"audio remainder: {what} checked at {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()

    fs, hop = CQT["fs"], CQT["hop"]
    t = np.arange(CLIP_SAMPLES) / fs
    notes = 110.0 * 2.0 ** (rng.integers(0, 36, (CLIP_BATCH, 3)) / 12.0)
    clips = (0.1 * rng.standard_normal((CLIP_BATCH, CLIP_SAMPLES))
             + np.sin(2 * np.pi * notes[:, :1] * t) + 0.5 * np.sin(2 * np.pi * notes[:, 1:2] * t)
             + 0.3 * np.sin(2 * np.pi * notes[:, 2:] * t))
    C = run("cqt", tp.cqt, clips)
    sub = np.asarray(ORACLE_ROWS)
    want = np.stack([cqt_oracle(clips[i], **CQT) for i in sub])
    check(f"cqt {CLIP_BATCH} x 30 s at 22,050 Hz, 84 bins from C1, hop 512 -> {tuple(C.shape)} "
          f"(rows {ORACLE_ROWS} vs the definition)", C[sub], want, CQT_TOL)
    kernel_check("cqt planes")
    y = run("icqt", tp.icqt, C, length=CLIP_SAMPLES)
    check("icqt(cqt(x)) vs the float64 inverse of the same coefficients", y[sub],
          np.stack([icqt_oracle(C[i].cpu().numpy().astype(np.complex128), CLIP_SAMPLES, **CQT)
                    for i in sub]), CQT_TOL)
    # the inverse covers the frames' span: the last (T − 1) mod hop samples fall out
    yn = y[0].cpu().numpy()
    inner = slice(int(fs), len(yn) - int(fs))
    corr = np.corrcoef(yn[inner], clips[0][inner])[0, 1]
    # the inverse is band-limited and approximate (a minimum-norm frame a CQT
    # row): how close it comes depends on the notes, so this is a reading
    log(f"icqt(cqt(x)) correlates {corr:.4f} with the clip (a band-limited inverse)")
    kernel_check("icqt planes")
    # librosa's chroma_cqt: 6 octaves of 36 bins from C1, folded onto 12 classes
    chroma = run("chroma_cqt", tp.chroma_cqt, clips)
    C36 = np.abs(cqt_oracle(clips[0], fs, CQT["fmin"], 216, 36, hop))   # one clip: 216 bands
    fold = C36.reshape(*C36.shape[:-1], 6, 12, 3).sum((-3, -1))
    check(f"chroma_cqt (216 bins, 36 an octave) -> {tuple(chroma.shape)}, clip 0", chroma[0],
          fold / np.maximum(fold.max(-1, keepdims=True), 1e-30), CQT_TOL)
    kernel_check("chroma_cqt planes")
    del C, y, chroma, want

    # spectral features, onsets, tempo and beats on the same clips
    nperseg, fhop = 2048, 512
    got = {name: run(name, getattr(tp, name), clips, fs, nperseg, fhop)
           for name in ("spectral_centroid", "spectral_bandwidth", "spectral_rolloff")}
    got["spectral_flatness"] = run("spectral_flatness", tp.spectral_flatness, clips, nperseg, fhop)
    for i in sub:
        want = features_oracle(clips[i], fs, nperseg, fhop)
        for name, value in want.items():
            if name == "spectral_rolloff":   # the first bin past 85%: one bin apart at most
                err = float(np.max(np.abs(got[name][i].cpu().numpy() - value)))
                log(f"spectral_rolloff clip {i}: worst {err:.3f} Hz apart (bins of {fs / nperseg:.3f} Hz)")
                require(err <= fs / nperseg + 1e-3, f"spectral_rolloff {err}")
            else:
                check(f"{name} clip {i}", got[name][i], value,
                      FLATNESS_TOL if name == "spectral_flatness" else ORACLE_TOL)
    kernel_check("feature planes")
    bpm_true = 120.0
    click_t = np.arange(0.25, 30.0, 60.0 / bpm_true)
    clicks = np.zeros(CLIP_SAMPLES)
    clicks[(click_t * fs).astype(int)] = 1.0
    clicks = np.convolve(clicks, np.hanning(64), "same") + 0.05 * rng.standard_normal(CLIP_SAMPLES)
    env = run("onset_strength", tp.onset_strength, clicks, fs, nperseg, fhop)
    S = mel_oracle(clicks[None], fs, nperseg, fhop, 128)[0]
    db = 10.0 * np.log10(np.maximum(S, 1e-10))
    check("onset_strength of a 120 BPM click track, 30 s",
          env, np.concatenate([[0.0], np.maximum(np.diff(db, axis=0), 0.0).mean(-1)]))
    bpm = float(run("tempo", tp.tempo, onset_env=env, sr=fs, hop=fhop))
    bpm_beats, beats = run("beat_track", tp.beat_track, onset_env=env, sr=fs, hop=fhop)
    want_beats = beat_oracle(env.cpu().numpy().astype(np.float64), float(bpm_beats), fs, fhop)
    log(f"tempo {bpm:.2f} BPM (clicks at {bpm_true}); beat_track {int(beats.sum())} beats, "
        f"{int((beats.cpu().numpy() != want_beats).sum())} frames differ from the float64 programme")
    require(abs(bpm - bpm_true) / bpm_true < 0.08, f"tempo {bpm}")
    require(np.array_equal(beats.cpu().numpy(), want_beats), "beat_track differs from float64")
    kernel_check("onset and tempo planes")

    # non-negative decomposition of one clip's magnitude spectrogram
    mag = np.abs(np.fft.rfft(frames_oracle(clips[:1], nperseg, fhop)[0]
                             * scipy.signal.get_window("hann", nperseg))).T   # (bins, frames)
    A, Cs = run("decompose", tp.decompose, mag, 8, 50)
    require(tuple(A.shape) == (mag.shape[0], 8) and tuple(Cs.shape) == (8, mag.shape[1]),
            f"decompose shapes {tuple(A.shape)}, {tuple(Cs.shape)}")
    scale = np.sqrt(mag.mean() / 8 + 1e-10)
    A0 = scale * rng.uniform(0.1, 1.0, (mag.shape[0], 8))
    C0 = scale * rng.uniform(0.1, 1.0, (8, mag.shape[1]))
    A1, C1 = run("decompose", feature_ops._decompose_from, cuda32(mag), cuda32(A0), cuda32(C0), 50, 1e-10)
    a64, c64 = A0, C0
    for _ in range(50):
        a64 = a64 * (mag @ c64.T) / (a64 @ (c64 @ c64.T) + 1e-10)
        c64 = c64 * (a64.T @ mag) / ((a64.T @ a64) @ c64 + 1e-10)
    check("decompose, 8 components, 50 updates: A·C", A1 @ C1, a64 @ c64, DECOMPOSE_TOL)
    del clips, mag

    # scattering at the JAX defaults J = 6, Q = 8
    xs = rng.standard_normal(SCATTER_SHAPE)
    s0, s1, s2, (xi1, xi2, pairs) = run("scattering1d", tp.scattering1d, xs)
    for i in sub:
        w0, w1, w2 = scattering_oracle(xs[i], 6, 8, pairs)
        for order, got_o, want_o in (("0", s0, w0), ("1", s1, w1), ("2", s2, w2)):
            check(f"scattering1d {SCATTER_SHAPE[0]} x 2^16, J 6, Q 8, order {order} row {i} "
                  f"{tuple(got_o.shape)}", got_o[i], want_o)
    kernel_check("scattering planes")
    del xs, s0, s1, s2

    # time-frequency representations at 8 x 4096
    rows, T = TFR_SHAPE
    tt = np.arange(T)
    x = (np.cos(2 * np.pi * rng.uniform(0.02, 0.2, (rows, 1)) * tt)
         + 0.7 * np.cos(2 * np.pi * (0.05 * tt + 0.15 * tt ** 2 / (2 * T))))
    S, freqs = run("ssq_stft", tp.ssq_stft, x)
    xr = run("issq_stft", tp.issq_stft, S).cpu().numpy()
    centers = np.arange(xr.shape[-1]) * 32
    keep = (centers > 256) & (centers < T - 256)
    err = np.linalg.norm(xr[:, keep] - x[:, centers[keep]]) / np.linalg.norm(x[:, centers[keep]])
    log(f"issq_stft(ssq_stft(x)) at the frame centers, {TFR_SHAPE}: rel err {err:.3e}")
    require(err < ISSQ_TOL, f"issq_stft round trip {err}")
    St, _ = run("stockwell", tp.stockwell, x)
    check(f"stockwell {TFR_SHAPE} -> {tuple(St.shape)}", St[sub], stockwell_oracle(x[sub]))
    check("istockwell(stockwell(x))", run("istockwell", tp.istockwell, St), x)
    del S, St
    W = run("wigner_ville", tp.wigner_ville, x)
    check(f"wigner_ville {TFR_SHAPE} -> {tuple(W.shape)}", W[sub], wigner_ville_oracle(x[sub], 257))
    kernel_check("time-frequency planes")
    del W

    launches = cuda_fft.LAUNCHES
    log("audio remainder kernel launches: " + ", ".join(f"{k} {v}" for k, v in ops.used.items()))
    # chroma_cqt's frames (36 bins an octave) are 65,536 long and scattering1d's
    # rows 2^16: longer than the kernel takes, so the stage pipeline runs them
    through = ("cqt", "icqt", "spectral_centroid", "onset_strength", "tempo", "beat_track",
               "ssq_stft", "stockwell", "istockwell", "wigner_ville")
    require(all(ops.used[k] > 0 for k in through),
            f"an op that goes through the fft layer never launched the kernel: {ops.used}")
    return launches, max(worst)


def recurrence_timings(rng, card: str) -> None:
    """Phase 20: device time (profiler sum and graph replay), back-to-back
    wall time, idle share and device kernels of the recurrences at the sizes
    of phases 15, 18 and 19."""
    sr, n_fft, hop = WHISPER["sr"], WHISPER["n_fft"], WHISPER["hop"]
    rows = []
    xw = cuda32(0.1 * rng.standard_normal((WHISPER_BATCH, WHISPER_SAMPLES)))
    with torch.no_grad():
        mel = tp.melspectrogram(xw, sr, n_fft, hop, n_mels=WHISPER["n_mels"])
        rows.append(timing_row("pcen forward, 16 x 3001 x 80", lambda: tp.pcen(mel, sr, hop), 5))
    del xw
    coef = {k: torch.full((80,), v, device="cuda", requires_grad=True)
            for k, v in dict(gain=0.98, bias=2.0, power=0.5, b=0.025).items()}
    rows.append(timing_row("pcen forward + backward, per-band coefficients, 16 x 3001 x 80",
                           lambda: torch.autograd.grad(tp.pcen(mel, **coef).sum(), list(coef.values())), 5))
    del mel
    params = audio_frontend.init_params(
        AUDIO["n_mels"], AUDIO["n_classes"], generator=torch.Generator().manual_seed(SEED), device="cuda")
    x = cuda32(0.1 * rng.standard_normal((AUDIO_BATCH, AUDIO_SAMPLES)))
    labels = torch.tensor(rng.integers(0, AUDIO["n_classes"], AUDIO_BATCH), device="cuda")

    def forward():
        with torch.no_grad():
            return audio_frontend.apply(params, x, AUDIO["sr"], AUDIO["n_fft"])

    rows.append(timing_row("audio front end forward, 256 x 16,000", forward, 5))
    rows.append(timing_row("audio front end train step, 256 x 16,000",
                           lambda: audio_frontend.train_step(params, x, labels, sr=AUDIO["sr"],
                                                             n_fft=AUDIO["n_fft"]), 5))
    del x
    x48 = cuda32(rng.standard_normal(DECIMATE_SHAPE))
    with torch.no_grad():
        rows.append(timing_row("decimate 16 x 1,440,000 by 3, ftype='iir'",
                               lambda: tp.decimate(x48, DECIMATE_Q, ftype="iir"), 5))
    del x48
    xs = cuda32(rng.standard_normal(RECURRENCE_SHAPE))
    sos = tp.butter(6, 0.2, output="sos")
    rows.append(timing_row("sosfilt butter(6) 8 x 65,536", lambda: tp.sosfilt(sos, xs), 5))
    del xs
    model = [cuda32(m) for m in kalman_model()]
    for T in (KALMAN_SEQUENTIAL_T, KALMAN_PARALLEL_T):
        ys = cuda32(kalman_track(rng, T))
        for parallel in ((True, False) if T == KALMAN_SEQUENTIAL_T else (True,)):
            form = "parallel" if parallel else "sequential"
            # batched solves may take a library path that a graph cannot capture
            rows.append(timing_row(f"kalman_filter car tracker T = {T:,}, {form}",
                                   lambda: tp.kalman_filter(*model, ys, parallel=parallel), 3,
                                   capture=False))
    clips = cuda32(rng.standard_normal((CLIP_BATCH, CLIP_SAMPLES)))
    with torch.no_grad():
        rows.append(timing_row("cqt 8 x 30 s at 22,050 Hz, 84 bins", lambda: tp.cqt(clips), 3))
    del clips
    torch.cuda.empty_cache()
    log(json.dumps({"recurrence_timing": {"card": card, "calls": rows}}))


def timed(phase, *args):
    """Runs one phase and logs its wall time (the whole run has a time limit)."""
    t0 = time.perf_counter()
    out = phase(*args)
    log(f"{phase.__name__}: {time.perf_counter() - t0:.1f} s")
    return out


def main(argv) -> int:
    card = setup()
    build()
    rng = np.random.default_rng(SEED)
    if argv == ["audio"]:   # development: phases 15-17 alone
        timed(audio_frontend_path, rng)
        timed(audio_ops, rng, card)
        timed(audio_timings, rng, card)
        return 0
    if argv == ["recurrence"]:   # development: phases 18-20 alone
        for phase in (recurrences, audio_remainder, recurrence_timings):
            timed(phase, rng, card)
        return 0
    timed(kernel_vs_plain, rng)
    launches, max_abs, (xr, xi) = timed(main_path, rng)
    timed(core_lengths, rng)
    timed(timings, rng, card)
    timed(yardstick, rng, card)
    train_launches, train_abs = timed(training, rng)
    fno_launches, fno_abs = timed(fno_path, rng)
    timed(api_remainder, rng)
    timed(train_timings, rng, card)
    family_launches, family_abs = timed(model_families, rng)
    ops_launches, ops_abs = timed(ops_tail, rng, card)
    timed(family_timings, rng, card)
    frontend_launches, frontend_abs = timed(audio_frontend_path, rng)
    audio_launches, audio_abs = timed(audio_ops, rng, card)
    timed(audio_timings, rng, card)
    recurrence_launches = timed(recurrences, rng, card)
    remainder_launches, remainder_abs = timed(audio_remainder, rng, card)
    timed(recurrence_timings, rng, card)
    log(f"kernel launches by path: filter forward {launches}, training {train_launches}, "
        f"fno {fno_launches}, s4d + fnet + afno {family_launches}, ops tail {ops_launches}, "
        f"audio front end {frontend_launches}, audio ops {audio_launches}, "
        f"recurrences {recurrence_launches}, audio remainder {remainder_launches}")
    launches += (train_launches + fno_launches + family_launches + ops_launches
                 + frontend_launches + audio_launches + recurrence_launches + remainder_launches)
    max_abs = max(max_abs, train_abs, fno_abs, family_abs, ops_abs, frontend_abs, audio_abs,
                  remainder_abs)
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
    sys.exit(main(sys.argv[1:]))
