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
4a. the float64 route, ``SpectralConfig(dtype=torch.float64)``: ``fft`` at
   n = 360, 1024, 1009, 5040 and 10007, the ``rfft`` → ``irfft`` round trip
   at 4096 and ``dct`` type 2 at 256 against numpy/scipy float64 (1e-12;
   the DCT 1e-10), and the spectral filter forward at n = 4096, batch 8 and
   1024, with ``init_params(..., dtype=torch.float64)``, against the float64
   oracle at 1e-12; the fused kernel (fp32 only) must launch no time in the
   phase; the float64 forward's device time beside the fp32 forward's
   (CUDA-graph replay);
4b. the reduced-precision modes: ``fft`` under each of "highest", "high",
   "default", "split6" and ("highest", "high") at the stage pipeline's
   lengths (1009, 10007, 32768, 65536, and 1024 with the kernel off) against
   numpy float64, with graph-replay device times ("highest" 1e-5, "split6"
   5e-6, the TF32 ones 16 TF32 units, and "default" at least twice
   "highest"'s error: the lever is live) and split6's bf16 tensor-core form
   beside the kept TF32 one; a kernel length (2048) whose output is the same
   at every precision; the FourCastNet AFNO forward under "default" against
   "highest"; at bf16 and fp16 ``fft`` and the real round trip at 1024, 1009
   and 4096 (2e-2, 5e-2), the spectral filter forward at batch 8 and 1024
   through the kernel on 2-byte planes, the kernel against its plain version
   on every plane pair it was handed there (one unit in the last place of
   the largest value), and its device time at 2048 x 1024 in bf16 and fp16
   beside fp32 and the bytes bounds;
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
    ``cqt``;
21. the non-uniform FFTs from numpy input at cuFINUFFT's single-precision
    sizes (2^20 points, ε = 1e-5): types 1 and 2 in 1-D at 8,192 modes (the
    fused kernel's 16,384-long grid) on [0, 2π), and in 2-D at 1,024 x 1,024
    modes on [-π, π)^2; ``radon`` then ``iradon`` of a 400 x 400 Shepp-Logan
    phantom at 400 angles; each against the float64 direct sum of its
    definition on a sample of outputs, with its launches, the kernel against
    its plain version on every plane pair, device and back-to-back times and
    peak memory;
22. ``sht``/``isht`` at L = 256 (batch 16, real and complex) and the
    recurrence pair at L = 512 (plain and compensated) against band-limited
    fields synthesized in float64 with scipy's spherical harmonics, the
    recurrence timed at L = 2,048; the SFNO at the shallow-water
    configuration of Bonev et al. (L = 256, 3 channels, hidden 256, 4
    layers, batch 2): forward from numpy input against the stage pipeline,
    layer 0's spectral mix against float64, three train steps, the first
    with the kernel against its plain version on every plane pair and its
    loss and gradients leaf by leaf against the stage pipeline, with device
    and back-to-back times;
23. the radar and radio-astronomy front end from numpy input: a
    pulse-Doppler CPI (16 channels of a half-wavelength ULA x 128 pulses x
    8,192 samples, a 512-sample LFM ``chirp``, three planted targets):
    ``range_doppler`` with a Hamming taper against float64 on three
    channels, 2-D cell-averaging and 1-D order-statistic ``cfar`` against
    float64 thresholds and detections, ``spatial_covariance``,
    ``mvdr_spectrum`` over 181 angles and ``music_doa`` on the targets'
    Doppler bins finding the planted angles, ``find_peaks`` finding the
    planted delays; ``pfb_analysis`` at 4,096 channels, 4 taps, on 2 x 2^25
    samples against float64 on 256 frames and ``pfb_synthesis`` of a 2^20
    cut; ``music``/``root_music``/``esprit`` on 8 records of 4,096 (m = 64,
    p = 4) recovering the planted frequencies;
24. the wavelets and the other leaves from numpy input against float64
    oracles written here: ``wavedec``/``waverec`` db4 (5 levels) and
    ``wavelet_denoise`` on Whisper's clips, ``wavedec2``/``waverec2``
    bior4.4 (5 levels) on 4 x 2,048² images, ``swt`` db2 on 16 x 65,536,
    ``dtcwt2``/``idtcwt2`` on 4 x 512²; ``ewt``, ``hilbert_huang``, ``vmd``
    (K = 4, 300 sweeps), ``phase_cross_correlation`` to 1/100 pixel on 16
    pairs of 1,024², ``unwrap_phase_2d``, ``fourier_gaussian``, the median
    filters, LMS/NLMS/RLS with 256 taps on 8,000 samples, ``ar_psd``,
    ``ssa`` and ``dmd``; each with its launches, device and back-to-back
    times, idle share and peak memory; then the kernel against
    ``torch.fft.fft`` at the shapes of phases 19-24;
25. ``parallel/`` on a NCCL world of one (mesh (1, 1), joined through
    ``initialize_multihost``, left at the phase's end), at BASELINE config
    5's width: ``require_four_step_hbm(65536, 4096, 1)``; the distributed
    complex filter at n = 65,536, batch 4,096: its forward against float64
    ``torch.fft`` on 3 rows, one step's gradients on those rows against
    float64, peak memory, five ``train_step_distributed``s with a finite,
    falling loss; ``fft_convolve_sharded`` of 65,408-sample signals with 129
    taps, "same", against ``scipy.signal.fftconvolve`` on 3 rows; FNet-Base's
    ``fourier_mix_distributed``, ``apply_distributed`` and one
    ``train_step_distributed`` against the single-device model;
    ``rfft_four_step``/``irfft_four_step`` and ``fft_batch_sharded`` at 64 x
    65,536; K1's launches counted and held against its plain version on the
    first rows of every plane pair; then, in a fresh process (``python3
    chip_smoke.py parallel-timings``), each call's device time (profiler
    sum), back-to-back time, idle share, K1 share, all-to-all time and peak
    memory;
26. the rest of ``parallel/`` on a new world of one, one shape each, against
    the port's single-device function: ``fftn_pencil2``, ``rfftn_pencil2``
    and ``poisson_solve_pencil2`` at 256³, ``fft2_pencil`` at 2,048² (and
    float64 on 4 rows), the sharded NUFFTs and SHTs at phases 21-22's sizes,
    ``kalman_filter_sharded`` on 4 tracks of 10,000 steps,
    ``pfb_analysis_sharded`` and ``range_doppler_cfar_sharded`` at phase
    23's sizes; then ``export_transform``/``load_transform`` of ``fft`` at
    64 x 4,096 on the card against the live call, on K1 (the program holds
    the kernel's operator and launches it) and on the stage pipeline (no
    launch);
27. the nine example programs (``examples/``), each ``main`` on the card at
    the JAX example's own sizes with its asserts (``pde_spectral``'s two time
    steps and ``sphere_advection``'s RK4 step eagerly in the whole run, and
    compiled, their default on a card, as the JAX examples jit them, in
    ``python3 chip_smoke.py examples``), then ``mri_recon`` at 256²
    with 402 spokes of 512 points and the advection at lmax 255 eagerly (160 RK4
    steps, its error against the exact rotation bounded): per run the
    kernel's launches, the kernel against its plain version on the first
    two and the last plane pairs it was handed (for the two compiled
    examples, by an eager run of the same example), back-to-back wall ms of a
    warm run and the profiler's device ms;
28. ``tools/tune.py kernel all``: the kernel, the stage pipeline and
    ``torch.fft.fft`` at every length the kernel takes (399, 2^22 complex
    values a call, CUDA-graph replay), the kernel against float64 on 8 rows
    each, a summary, and ``torch.fft.fft`` against the kernel at 256 x
    1,048,576;
29. the compiled path (``torch.compile``, Inductor, ``fullgraph=True,
    dynamic=False``, as the JAX package runs under ``jax.jit``):
    ``fft``/``rfft``/``irfft`` at 2048 x 1024, the spectral filter's
    forward and SGD step (``utils.tree.compile_sgd_step``) at n = 4096,
    batch 8 and 1024, and ``fno_train`` at the JAX sizes, each beside the
    same call eager (phase 27's eager ``fno_train``; ``fno_train`` timed in
    ``python3 chip_smoke.py compile`` only): zero graph breaks, no
    recompile, K1's launches (its
    operator is a node of the graphs), compiled against eager (2e-5) and
    the filter against float64 (1e-5), compile seconds, device µs by graph
    replay and profiler, kernels a call, back-to-back time, idle share, and
    the host's events of a compiled call;
30. every model family compiled (Inductor, as the JAX package's tests jit
    them) at the widths of its eager phase: S4D, FNet-Base, the FourCastNet
    AFNO, the SFNO, the PCEN front end and the Koopman autoencoder, each
    forward and ``compile_sgd_step`` beside eager on the same weights: zero
    graph breaks, no recompile, K1's launches equal to eager's, compiled
    against eager (the forward 2e-5; the step's loss 1e-5 and its new
    parameters at the family's eager tolerance, the AFNO's in the 2-norm),
    compile seconds, device and back-to-back times and idle share; the SFNO's
    compile adds less device memory than its kept Legendre tables.  Depths
    are cut to COMPILED_DEPTH in the whole run, and there the forwards and
    steps compile with ``aot_eager``; ``python3 chip_smoke.py compile`` runs
    the published depths, all with Inductor, and the front end's compiled loss
    with an input gradient (K1 twice);
31. the ops that the JAX package's tests jit, compiled whole at their eager
    phases' shapes (``sosfilt``/``sosfiltfilt``/``lfilter``/``filtfilt``,
    ``pfb_analysis`` with a caller's prototype, ``radon``/``iradon``,
    ``multitaper``, ``griffinlim``, the TFR ops, a ``dwt`` loss and its
    gradient, ``cqt``/``icqt``) with ``backend="aot_eager"`` on CUDA
    tensors, and ``ssq_stft(sosfilt(x))`` with Inductor: zero graph breaks,
    no recompile on a second call with new data, K1's launches equal to
    eager's, compiled against eager (2e-5; the squeezed and reassigned
    planes by their bin sums), against float64 where the eager phase checks
    float64, and K1 against its plain version on the planes the calls hand
    it;
32. the main path's configurations compiled with ``aot_eager`` on CUDA
    tensors at torch's default flags (set for the phase, restored after):
    ``exec_complex`` or ``fft`` with ``rfft`` at 10007 x 16, 1009 x 64 and
    32768 x 16 under "highest", "high" and "split6" (not at 1009); ``fft`` and the
    spectral filter's forward in bf16 and fp16 through K1 on 2-byte planes;
    the direct convolution of phase 13: zero graph breaks, no recompile on
    new data, compiled against eager (2e-5), against float64 at phase 4b's
    bounds, the compiled "high" error at least 10x the compiled "highest"
    one (TF32 ran), cuDNN's TF32 flag off at each convolution call, the four
    flags unchanged by the phase, K1's launches equal to eager's and K1
    against its plain version on the calls' planes; the ladder's device
    times by graph replay at 10007 and 32768;
33. ``parallel/`` compiled with ``aot_eager`` on a NCCL world of one at
    phases 25-26's shapes (the four-step family at config 5, the pencils,
    the distributed filter and FNet-Base with their ``compile_sgd_step``,
    the batch-sharded calls with a Whisper ``melspectrogram`` and the
    FourCastNet AFNO's step on ``shard_batch`` DTensors, the API ops on
    them, the sharded NUFFTs and SHTs), in three processes at once: 0
    graph breaks, one graph (two for a step), no recompile on new data, K1
    launches equal to eager's, compiled against eager (2e-5), the filter
    against float64, K1 against its plain version on the calls' planes, the
    batch-sharded outputs still sharded.

``python3 chip_smoke.py precision`` runs phases 1, 2 and 4b alone,
``python3 chip_smoke.py audio`` phases 1, 2 and 15-17,
``python3 chip_smoke.py recurrence`` phases 1, 2 and 18-20,
``python3 chip_smoke.py sphere`` phases 1, 2, 21 and 22 (with the
recurrence's timing rows at L = 512 and 2048), and
``python3 chip_smoke.py frontend`` phases 1, 2, 23 and 24, and
``python3 chip_smoke.py parallel`` phases 1, 2, 25 and 26,
``python3 chip_smoke.py examples`` phases 1, 2 and 27, and
``python3 chip_smoke.py tune`` phases 1, 2 and 28, and
``python3 chip_smoke.py compile`` phases 1, 2, 29 and 30, phase 30 at the families'
published depths, and
``python3 chip_smoke.py compile-ops`` phases 1, 2 and 31 with Inductor for every
op, each timed beside eager, and
``python3 chip_smoke.py compile-precision`` phases 1, 2 and 32, and
``python3 chip_smoke.py compile-parallel [k ...]`` phases 1, 2 and 33 (its groups
k, else all three) with Inductor at the
published depths, each call timed beside eager (for development;
they print no result line).

The last lines are one JSON line about the kernels (launches of phases 4, 4b, 8,
9, 12, 13, 15, 16, 18, 19, 21, 22, 23, 24, 25, 26, 27, 29, 30, 31, 32 and 33; error over the plane pairs those launches were handed:
every pair of phases 4, 9, 12, 13, 15, 16, 19, 21, 22, 23 and 24, the first rows of phase 25's, three of each run of phase 27's, the first rows of three of each op's eager run in phases 31 and 33 and of each fp32 call's in phase 32, and in phase 8 the first step's three, every
later backward's and the four of the step with an input gradient; times on
the main path's batch-1024 planes), the card, then ``{"ok": true, "device":
{...}}``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import functools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import scipy.fft
import scipy.linalg
import scipy.ndimage
import scipy.optimize
import scipy.signal
import torch

import mixed_radix_fast_fourier_transform_tpu_torch as tp
from kernel_bench import SHAPES as YARDSTICK_SHAPES, wrapper_us
from mixed_radix_fast_fourier_transform_tpu_torch import compat, parallel
from mixed_radix_fast_fourier_transform_tpu_torch.models import (
    afno, audio_frontend, fnet, fno, koopman, s4d, sfno,
)
from mixed_radix_fast_fourier_transform_tpu_torch.ops import _build, cuda_fft
from mixed_radix_fast_fourier_transform_tpu_torch.ops import cqt as cqt_ops
from mixed_radix_fast_fourier_transform_tpu_torch.ops import feature as feature_ops
from mixed_radix_fast_fourier_transform_tpu_torch.ops import scattering as scattering_ops
from mixed_radix_fast_fourier_transform_tpu_torch.ops.stockham import exec_complex, exec_len
from mixed_radix_fast_fourier_transform_tpu_torch.utils import aot
from mixed_radix_fast_fourier_transform_tpu_torch.utils.numerics import traced
from mixed_radix_fast_fourier_transform_tpu_torch.utils.profiling import graph_time
from mixed_radix_fast_fourier_transform_tpu_torch.utils.tree import (
    compile_sgd_step, sgd_step, tree_leaves, tree_map, tree_map_with_path,
)

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


def device_and_wall_us(fn, calls: int = 20, collectives: bool = False) -> dict:
    """Per call, in one process on the same inputs: ``device_us``, the summed
    device-kernel time of ``calls`` calls under torch.profiler (None where
    the profiler saw no device activity); ``wall_us``, the wall time of
    ``calls`` back-to-back calls without it (CUDA events); ``idle_share``,
    1 - device_us / wall_us; ``kernels``, the device kernels (and copies) per
    call; ``k1_us``, the fused kernel's part of the device time; and
    ``by_name``, the device µs per call by kernel name, largest first;
    ``collective_spans``, with ``collectives``, the device µs per call of
    each NCCL collective's span (its copies and kernels, which ``device_us``
    counts once)."""
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
    # the card's activity, read from the profiler's raw events: a call of
    # tens of thousands of kernels costs more in host events and their parse
    # into function events than in the run itself.  A collective's span
    # ("nccl:all_to_all") is the device side of a host range, which the
    # profiler records only while it traces the host too
    activities = [torch.profiler.ProfilerActivity.CUDA]
    if collectives:
        activities.append(torch.profiler.ProfilerActivity.CPU)
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [(e.name(), e.duration_ns() / 1e3) for e in prof.profiler.kineto_results.events()
              if e.device_type() == torch.autograd.DeviceType.CUDA]
    # a NCCL collective also shows as an annotation ("nccl:all_to_all")
    # spanning its own copies and kernels: kept apart, not counted twice
    on_card = [(name, us) for name, us in events if not name.startswith("nccl:")]
    spans = {}
    for name, us in events:
        if name.startswith("nccl:"):
            spans[name] = spans.get(name, 0.0) + us / calls
    dev = sum(us for _, us in on_card)
    k1 = sum(us for name, us in on_card if "stockham_fft_kernel" in name)
    by_name = {}
    for name, us in on_card:
        by_name[name] = by_name.get(name, 0.0) + us / calls
    by_name = dict(sorted(by_name.items(), key=lambda kv: -kv[1]))
    device_us = dev / calls if dev > 0 else None
    return {"device_us": device_us, "wall_us": wall_us,
            "idle_share": None if device_us is None else 1.0 - device_us / wall_us,
            "kernels": len(on_card) / calls, "k1_us": k1 / calls, "by_name": by_name,
            "collective_spans": spans}


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
        m = re.search(r"stockham_fft_kernelI(f|13__nv_bfloat16|6__half)Li(n?)1ELi(\d+)ELi(\d+)E",
                      line)
        if "Compiling entry function" in line and m:
            plane = {"f": "float", "13__nv_bfloat16": "bf16", "6__half": "fp16"}[m.group(1)]
            name = (f"stockham_fft_kernel<{plane}, sign={'-' if m.group(2) else '+'}1, "
                    f"elems={m.group(3)}, bound={m.group(4)}>")
        elif name and ("spill" in line or "registers" in line):
            log(f"ptxas {name}: {line.split(':', 1)[-1].strip()}")
    return secs


def kernel_error(xr, xi, n: int, sign: int, what: str, verbose: bool = True) -> float:
    """Checks the kernel against its plain version on (xr, xi): raises past
    KERNEL_TOL relative to max |plain| (2-byte planes: past HALF_KERNEL_TOL,
    one unit in the last place of the largest value); returns the max abs
    error."""
    kr, ki = cuda_fft.exec_kernel(xr, xi, n, sign)
    torch.cuda.synchronize()
    rr, ri = cuda_fft.exec_kernel_reference(xr, xi, n, sign)
    require(kr.dtype == rr.dtype == xr.dtype, f"{what}: the kernel gave {kr.dtype} planes")
    got = torch.complex(kr.float(), ki.float()).cpu().numpy()
    want = torch.complex(rr.float(), ri.float()).cpu().numpy()
    err = rel_err(got, want)
    name = str(xr.dtype).split(".")[-1]
    tol = HALF_KERNEL_TOL.get(name, KERNEL_TOL)
    if verbose:
        log(f"kernel vs plain {what} n={n} planes {tuple(got.shape)}"
            f"{'' if tol == KERNEL_TOL else ' ' + name} sign={sign:+d}: rel err {err:.3e}")
    require(err <= tol, f"kernel disagrees with its plain version at n={n} ({what}, {name})")
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
def recorded_launches(keep=None):
    """Inside the block, every call of the kernel's wrapper (forward or
    backward: both look ``cuda_fft.exec_kernel`` up at call time) is noted
    as (xr, xi, n, sign) with copies of the planes it was handed; with
    ``keep``, only the first ``keep`` calls and the latest.  A call made
    while torch.compile or torch.export traces is not noted (its planes are
    the tracer's, and the compiled graph calls the operator directly)."""
    seen = []
    launch = cuda_fft.exec_kernel

    def recording(xr, xi, n, sign):
        if traced(xr):
            return launch(xr, xi, n, sign)
        pair = (xr.detach().clone(), xi.detach().clone(), n, sign)
        if keep is not None and len(seen) > keep:
            seen[-1] = pair
        else:
            seen.append(pair)
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


F64 = tp.SpectralConfig(dtype=torch.float64)
F64_TOL = 1e-12          # float64 route vs numpy/scipy float64
F64_DCT_TOL = 1e-10      # the DCT, absolute, as the JAX package's fp64 test holds it
F64_LENGTHS = ((360, 64), (1024, 64), (1009, 64), (5040, 16), (10007, 16))


def float64_path(rng, card: str) -> None:
    """The float64 route on the card: the engine's algorithm classes, the
    real round trip, the DCT and the spectral filter forward against float64
    oracles, none of it through the fp32 kernel; then the filter forward's
    device time in float64 beside fp32 (graph replay)."""
    before = cuda_fft.LAUNCHES
    for n, b in F64_LENGTHS:
        x = rng.standard_normal((b, n)) + 1j * rng.standard_normal((b, n))
        got = tp.fft(torch.tensor(x, device="cuda"), config=F64)
        require(got.dtype == torch.complex128, f"float64 fft n={n} gave {got.dtype}")
        err = rel_err(got.cpu().numpy(), np.fft.fft(x))
        log(f"float64 fft n={n} b={b}: rel err {err:.3e}")
        require(err <= F64_TOL, f"float64 fft n={n} error {err:.3e}")
    x = rng.standard_normal((64, 4096))
    back = tp.irfft(tp.rfft(torch.tensor(x, device="cuda"), config=F64), n=4096, config=F64)
    err = float(np.max(np.abs(back.cpu().numpy() - x)))
    log(f"float64 rfft->irfft 4096 b=64: max abs err {err:.3e}")
    require(back.dtype == torch.float64 and err <= F64_TOL, f"float64 round trip {err:.3e}")
    x = rng.standard_normal((64, 256))
    got = tp.dct(torch.tensor(x, device="cuda"), type=2, config=F64)
    err = float(np.max(np.abs(got.cpu().numpy() - scipy.fft.dct(x, type=2))))
    log(f"float64 dct2 256 b=64: max abs err {err:.3e}")
    require(got.dtype == torch.float64 and err <= F64_DCT_TOL, f"float64 dct {err:.3e}")
    params = tp.models.spectral_filter.init_params(
        FILTER_N, torch.Generator(device="cuda").manual_seed(SEED), "cuda", dtype=torch.float64)
    gain = (params["gain_re"] + 1j * params["gain_im"]).cpu().numpy()
    bias = float(params["bias"])
    rows = []
    with torch.inference_mode():
        for b in FILTER_BATCHES:
            x = rng.standard_normal((b, FILTER_N))
            xt = torch.tensor(x, device="cuda")
            y = tp.models.spectral_filter.apply(params, xt, config=F64)
            want = np.fft.irfft(np.fft.rfft(x) * gain, n=FILTER_N) + bias
            err = rel_err(y.cpu().numpy(), want)
            log(f"float64 spectral filter n={FILTER_N} batch={b}: rel err {err:.3e}")
            require(y.dtype == torch.float64 and err <= F64_TOL,
                    f"float64 spectral filter error {err:.3e} at batch {b}")
            rows.append({"n": FILTER_N, "batch": b, "float64_rel_err": err, "x": xt})
    launched = cuda_fft.LAUNCHES - before
    log(f"fused kernel launches in the float64 phase: {launched}")
    require(launched == 0, f"the float64 route launched the fp32 kernel {launched} times")
    p32 = {k: v.float() for k, v in params.items()}
    for row in rows:
        xt = row.pop("x")
        x32 = xt.float()
        row["float64_device_us"] = 1e6 * graph_time(
            lambda: tp.models.spectral_filter.apply(params, xt, config=F64))
        row["fp32_device_us"] = 1e6 * graph_time(
            lambda: tp.models.spectral_filter.apply(p32, x32))
        row["fp32_pipeline_device_us"] = 1e6 * graph_time(
            lambda: tp.models.spectral_filter.apply(p32, x32, config=PIPELINE))
        log(f"spectral filter b={row['batch']} forward device us (graph replay): " + ", ".join(
            f"{k} {v:.2f}" for k, v in row.items() if k.endswith("_us")))
    log(json.dumps({"float64_path": {"card": card, "spectral_filter": rows}}))


# Phase 4b: the reduced-precision modes.
PRECISION_LADDER = ("highest", "high", "default", "split6", ("highest", "high"))
# (n, rows, config fields) the stage pipeline carries: Bluestein (1009,
# 10007), lengths past the kernel's 16,384 (32768, 65536), and 1024 with the
# kernel off
PRECISION_SHAPES = ((1009, 64, {}), (10007, 16, {}), (32768, 16, {}), (65536, 16, {}),
                    (1024, 256, {"use_kernel": False}))
HIGHEST_TOL = 1e-5
SPLIT6_TOL = 5e-6        # the JAX package's split6 test bound
# "high"/"default" are TF32 products on the card: 16 TF32 unit roundoffs
# (2^-11).  A CPU emulation of TF32 stage products at these shapes reads
# 2.4e-4 to 7.6e-4 with the inputs rounded to nearest, 6.5e-4 to 2.5e-3
# with them truncated (``tools/tune.py tf32emu``; PERF.md §6).
TF32_TOL = 16 * 2.0 ** -11
# "default" is live where its error passes this many times "highest"'s
LIVE_FACTOR = 2.0
# the AFNO under "default" against "highest", l2 over the whole output
AFNO_TF32_TOL = 1e-2
# 2-byte working dtypes: the JAX package's bf16 test bounds, for both
HALF_FFT_TOL, HALF_TRIP_TOL = 2e-2, 5e-2
HALF_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}
# K1 against its plain version on 2-byte planes: both compute in fp32 and
# round once at the store, so an element differs by at most one unit in its
# last place, which is at most 2^-7 (bf16) or 2^-10 (fp16) of the largest
# value (an ulp relative to its value is 2^-8..2^-7 and 2^-11..2^-10)
HALF_KERNEL_TOL = {"bfloat16": 2.0 ** -7, "float16": 2.0 ** -10}
HALF_K1_SHAPE = (2048, 1024)


def precision_path(rng, card: str) -> int:
    """Phase 4b: ``SpectralConfig.precision`` and the 2-byte working dtypes
    on the card.  Returns the kernel's launches of the driven part (counted
    from 0 at the phase's start).  The comparisons with the plain version,
    the AFNO's and the kernel's timings come after the count is read; the
    ladder's timings run the stage pipeline only (checked), which launches
    no kernel."""
    cuda_fft.LAUNCHES = 0
    ladder = []
    for n, b, fields in PRECISION_SHAPES:
        x = rng.standard_normal((b, n)) + 1j * rng.standard_normal((b, n))
        xt = torch.tensor(x, dtype=torch.complex64, device=CARD)
        want = np.fft.fft(x)
        row = {"n": n, "rows": b, **fields}
        for prec in PRECISION_LADDER:
            cfg = tp.SpectralConfig(precision=prec, **fields)
            before = cuda_fft.LAUNCHES
            got = tp.fft(xt, config=cfg)
            torch.cuda.synchronize()
            require(cuda_fft.LAUNCHES == before, f"n={n} {prec}: took the kernel")
            row[f"{prec}_err"] = rel_err(got.cpu().numpy(), want)
            row[f"{prec}_device_us"] = 1e6 * graph_time(lambda: tp.fft(xt, config=cfg),
                                                        launches=10, replays=5)
        log(f"precision ladder fft n={n} b={b}: " + ", ".join(
            f"{p} err {row[f'{p}_err']:.3e} / {row[f'{p}_device_us']:.1f} us"
            for p in PRECISION_LADDER))
        require(row["highest_err"] <= HIGHEST_TOL, f"highest n={n}: {row['highest_err']:.3e}")
        require(row["split6_err"] <= SPLIT6_TOL, f"split6 n={n}: {row['split6_err']:.3e}")
        for prec in ("high", "default", "('highest', 'high')"):
            require(row[f"{prec}_err"] <= TF32_TOL, f"{prec} n={n}: {row[f'{prec}_err']:.3e}")
        require(row["default_err"] > LIVE_FACTOR * row["highest_err"],
                f"default is not live at n={n}: {row['default_err']:.3e} against "
                f"highest {row['highest_err']:.3e}")
        ladder.append(row)
        del xt
    # a kernel length: the kernel ignores the lever, as the JAX kernel does
    x = rng.standard_normal((256, 2048)) + 1j * rng.standard_normal((256, 2048))
    xt = torch.tensor(x, dtype=torch.complex64, device=CARD)
    outs = []
    for prec in PRECISION_LADDER:
        before = cuda_fft.LAUNCHES
        outs.append(tp.fft(xt, config=tp.SpectralConfig(precision=prec)))
        require(cuda_fft.LAUNCHES == before + 1, f"n=2048 {prec}: no kernel launch")
    require(all(torch.equal(o, outs[0]) for o in outs[1:]),
            "the kernel's output at n=2048 depends on the precision")
    log(f"kernel length 2048 b=256: one output for all {len(outs)} precisions, rel err "
        f"{rel_err(outs[0].cpu().numpy(), np.fft.fft(x)):.3e}")
    del outs, xt
    # the FourCastNet AFNO forward under "default" against "highest"
    gen = torch.Generator().manual_seed(SEED)
    params = afno.init_afno(**AFNO, generator=gen, device=CARD)
    xa = cuda32(rng.standard_normal((1, *AFNO_GRID, AFNO["in_channels"])))
    with torch.no_grad():
        ys = {p: afno.apply(params, xa, config=tp.SpectralConfig(precision=p), **AFNO_RUN)
              for p in ("highest", "default")}
    afno_row = {"default_vs_highest_l2": l2_err(ys["default"].cpu().numpy(),
                                                ys["highest"].cpu().numpy())}
    log(f"afno 768 x 12 forward: default vs highest l2 {afno_row['default_vs_highest_l2']:.3e}")
    require(0.0 < afno_row["default_vs_highest_l2"] <= AFNO_TF32_TOL,
            f"afno default against highest: {afno_row['default_vs_highest_l2']:.3e}")
    del ys
    # the 2-byte working dtypes: fft, the real round trip, the filter forward
    half, seen_by = [], {}
    fparams = tp.models.spectral_filter.init_params(
        FILTER_N, torch.Generator(device=CARD).manual_seed(SEED), CARD)
    gain = (fparams["gain_re"] + 1j * fparams["gain_im"]).cpu().numpy()
    bias = float(fparams["bias"])
    for name, dtype in HALF_DTYPES.items():
        cfg = tp.SpectralConfig(dtype=dtype)
        for n in (1024, 1009, 4096):
            x = rng.standard_normal((64, n)) + 1j * rng.standard_normal((64, n))
            before = cuda_fft.LAUNCHES
            got = tp.fft(torch.tensor(x, dtype=torch.complex64, device=CARD), config=cfg)
            k1 = cuda_fft.LAUNCHES - before
            require(got.dtype == torch.complex64, f"{name} fft gave {got.dtype}")
            require(k1 == (0 if n == 1009 else 1), f"{name} fft n={n}: {k1} kernel launches")
            err = rel_err(got.cpu().numpy(), np.fft.fft(x))
            r = rng.standard_normal((64, n))
            back = tp.irfft(tp.rfft(cuda32(r), config=cfg), n=n, config=cfg)
            trip = rel_err(back.float().cpu().numpy(), r)
            log(f"{name} fft n={n} b=64: rel err {err:.3e}; rfft->irfft {trip:.3e}; "
                f"kernel launches (fft) {k1}")
            require(err <= HALF_FFT_TOL and trip <= HALF_TRIP_TOL,
                    f"{name} n={n}: fft {err:.3e}, round trip {trip:.3e}")
            half.append({"dtype": name, "n": n, "fft_err": err, "round_trip_err": trip,
                         "fft_k1_launches": k1})
        with recorded_launches() as seen, torch.inference_mode():
            for b in FILTER_BATCHES:
                x = rng.standard_normal((b, FILTER_N))
                before = cuda_fft.LAUNCHES
                y = tp.models.spectral_filter.apply(fparams, cuda32(x), config=cfg)
                torch.cuda.synchronize()
                k1 = cuda_fft.LAUNCHES - before
                want = np.fft.irfft(np.fft.rfft(x) * gain, n=FILTER_N) + bias
                err = rel_err(y.float().cpu().numpy(), want)
                log(f"{name} spectral filter n={FILTER_N} batch={b}: rel err {err:.3e}, "
                    f"kernel launches {k1}")
                require(k1 == 2, f"{name} filter forward: {k1} kernel launches, expected 2")
                require(err <= HALF_TRIP_TOL, f"{name} spectral filter error {err:.3e}")
                half.append({"dtype": name, "filter_batch": b, "err": err, "k1_launches": k1})
        seen_by[name] = seen
    launches = cuda_fft.LAUNCHES
    # (not counted) the kernel against its plain version on every plane pair
    # the 2-byte filter forwards handed it
    for name, seen in seen_by.items():
        for xr, xi, n, sign in seen:
            require(xr.dtype == HALF_DTYPES[name], f"{name} filter handed {xr.dtype} planes")
            kernel_error(xr, xi, n, sign, "filter planes")
    del seen_by
    # (not counted) the AFNO forward's device time at both precisions
    with torch.no_grad():
        for p in ("highest", "default"):
            cfg = tp.SpectralConfig(precision=p)
            afno_row[f"{p}_device_ms"] = 1e3 * graph_time(
                lambda: afno.apply(params, xa, config=cfg, **AFNO_RUN), launches=1, replays=3)
    log(f"afno 768 x 12 forward device ms (graph replay): highest "
        f"{afno_row['highest_device_ms']:.2f}, default {afno_row['default_device_ms']:.2f}")
    del params, xa
    torch.cuda.empty_cache()
    # K1's device time on 2-byte planes beside fp32, and the bytes bounds
    n, b = HALF_K1_SHAPE
    gen = torch.Generator(device=CARD).manual_seed(SEED)
    xr32, xi32 = (torch.randn(b, n, device=CARD, generator=gen) for _ in range(2))
    k1_times = {"n": n, "rows": b}
    for name, dtype in (("float32", torch.float32), *HALF_DTYPES.items()):
        xr, xi = xr32.to(dtype), xi32.to(dtype)
        if dtype != torch.float32:
            kernel_error(xr, xi, n, -1, "random")
        k1_times[f"{name}_device_us"] = 1e6 * graph_time(
            lambda: cuda_fft.exec_kernel(xr, xi, n, -1))
        bytes_bound = (4 if dtype == torch.float32 else 2) * 4.0 * n * b / HBM_BYTES_PER_S
        k1_times[f"{name}_bytes_bound_us"] = 1e6 * bytes_bound
    log(f"kernel {n} x {b} device us (graph replay): " + ", ".join(
        f"{k} {v:.2f}" for k, v in k1_times.items() if k.endswith("_us")))
    line = json.dumps({"precision_path": {"card": card, "ladder": ladder, "afno": afno_row,
                                          "half_dtypes": half, "k1_half": k1_times,
                                          "launches": launches}})
    log(line)
    os.makedirs("chiprun_out", exist_ok=True)   # the whole run's log outgrows its tail
    with open(os.path.join("chiprun_out", "precision_path.json"), "w") as fh:
        fh.write(line + "\n")
    return launches


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
        "dct2_graph_replay_us": 1e6 * graph_time(lambda: tp.dct(xt)),
        "stft_16x2^18_nperseg1024_graph_replay_us": 1e6 * graph_time(
            lambda: tp.stft(xs, 1024, 768)),
        "inner_stage_pipeline_us": 1e6 * graph_time(lambda: exec_complex(plan, xt, zero)),
        "inner_kernel_us": 1e6 * graph_time(lambda: exec_len(tp.DEFAULT_CONFIG, 1024, -1, xt, zero)),
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
    graph = 1e6 * graph_time(fn, launches=1, replays=calls) if capture else None
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
        graph = 1e6 * graph_time(step, launches=captured)
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
    from utils.profiling.graph_time, with the bytes bound and the kernel's share of it."""
    rows = []
    family_shapes = KERNEL_MANY_ROWS + ((1024, S4D_BATCH * S4D["hidden"]),) + AUDIO_KERNEL_SHAPES
    own = np.random.default_rng(SEED)   # the added shapes leave ``rng``'s stream as it was
    for n, b in YARDSTICK_SHAPES + family_shapes:
        draw = own if (n, b) in family_shapes else rng
        x = draw.standard_normal((b, n)) + 1j * draw.standard_normal((b, n))
        xr, xi = planes(x)
        xc = torch.complex(xr, xi)
        kernel_ms = 1e6 * graph_time(lambda: cuda_fft.exec_kernel(xr, xi, n, -1)) / 1e3
        cufft_ms = 1e6 * graph_time(lambda: torch.fft.fft(xc)) / 1e3
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


def click_track(rng, bpm: float = 120.0) -> np.ndarray:
    """30 s of Hann-shaped clicks at ``bpm`` from 0.25 s, at 22,050 Hz, in
    a little noise."""
    fs = CQT["fs"]
    clicks = np.zeros(CLIP_SAMPLES)
    clicks[(np.arange(0.25, 30.0, 60.0 / bpm) * fs).astype(int)] = 1.0
    return np.convolve(clicks, np.hanning(64), "same") + 0.05 * rng.standard_normal(CLIP_SAMPLES)


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
    clicks = click_track(rng, bpm_true)
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

# Phases 21-22: the NUFFT and tomography path, the SHT and the SFNO.
NUFFT_MODES = 8192                 # the oversampled grid mr = 16,384: K1's longest row
NUFFT_MODES_2D = (1024, 1024)      # cuFINUFFT's single-precision class (arXiv 2102.08463)
NUFFT_POINTS = 2 ** 20
NUFFT_EPS = 1e-5
NUFFT_SAMPLES = 512                # outputs held against the float64 direct sum
# ε = 1e-5 (6 taps a side) plus fp32 rounding of the spread and the FFT, which
# the deconvolution multiplies by up to e^(k²τ) = e^(π·6/12) ≈ 4.8 at the band edge
NUFFT_TOL = 5e-5
# points with a negative coordinate: the reduction shared with the JAX module
# loses up to 2^-25 of frac(x/2π) there (ROADMAP F7), a phase error of up to
# 2π·|k|·2^-25 per axis
F7_PHASE = 2.0 * math.pi * 2.0 ** -25
TOMO_N, TOMO_ANGLES = 400, 400     # scikit-image's phantom size and iradon example
TOMO_ORACLE_ANGLES, TOMO_ORACLE_PIXELS = 8, 256
SHT_L, SHT_BATCH = 256, 16         # the 256 x 512 Gauss grid
SHT_REC_L, SHT_REC_BATCH, SHT_REC_TIME_L = 512, 2, 2048
SHT_ORDERS = 32                    # orders with random coefficients in the float64 fields
# the plain recurrence's fp32 carry drifts: the analysis by ~L·eps (the JAX
# module measured 1.6e-4 at L = 512), the synthesis faster (the JAX function
# reads 2.6e-4 at L = 256 on this script's fields, the port 2.4e-4, on the
# CPU; the port 1.3e-3 at L = 512 on the card); the compensated pair holds
# ORACLE_TOL
SHT_REC_PLAIN_TOL = 3e-4
ISHT_REC_PLAIN_TOL = 3e-3
# the SFNO of Bonev et al.'s shallow-water runs (arXiv 2306.03838): L = 256,
# height and two velocity components in and out; hidden 256, 4 layers, batch 2
SFNO = dict(in_channels=3, hidden=256, out_channels=3, lmax=255, n_layers=4)
SFNO_BATCH, SFNO_STEPS, SFNO_LR = 2, 3, 1e-3
SFNO_ORACLE_CHANNELS = 8


def complex64(rng, *shape) -> np.ndarray:
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def cuda_complex(x: np.ndarray) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.complex64, device="cuda")


def direct_sum(phases, weights: np.ndarray, sign: float, chunk: int = 1 << 15) -> np.ndarray:
    """Σ_j w_j·e^(sign·i·θ[o, j]) in float64 for each output o, where
    ``phases(j0, j1)`` gives the (outputs, j1 - j0) phase block of the
    terms j0:j1 (chunked, so no (outputs, all terms) matrix is held)."""
    w = weights.astype(np.complex128)

    def part(j0):
        th = phases(j0, min(j0 + chunk, w.shape[-1]))
        return (np.cos(th) + 1j * sign * np.sin(th)) @ w[j0: j0 + th.shape[1]]

    # numpy's ufuncs release the GIL: the chunks run on the host's cores
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        return sum(pool.map(part, range(0, w.shape[-1], chunk)))


def modes_of(n: int) -> np.ndarray:
    return np.arange(-(n // 2), (n + 1) // 2, dtype=np.float64)


def shepp_logan(n: int) -> np.ndarray:
    """The modified Shepp-Logan phantom on an n x n grid from its ten
    ellipses (value, semi-axes a, b, centre x0, y0, angle in degrees), as
    scikit-image draws it."""
    ellipses = [(1.0, 0.69, 0.92, 0.0, 0.0, 0.0), (-0.8, 0.6624, 0.874, 0.0, -0.0184, 0.0),
                (-0.2, 0.11, 0.31, 0.22, 0.0, -18.0), (-0.2, 0.16, 0.41, -0.22, 0.0, 18.0),
                (0.1, 0.21, 0.25, 0.0, 0.35, 0.0), (0.1, 0.046, 0.046, 0.0, 0.1, 0.0),
                (0.1, 0.046, 0.046, 0.0, -0.1, 0.0), (0.1, 0.046, 0.023, -0.08, -0.605, 0.0),
                (0.1, 0.023, 0.023, 0.0, -0.606, 0.0), (0.1, 0.023, 0.046, 0.06, -0.605, 0.0)]
    c = (np.arange(n) - (n - 1) / 2.0) / (n / 2.0)
    y, x = np.meshgrid(-c, c, indexing="ij")
    img = np.zeros((n, n))
    for v, a, b, x0, y0, phi in ellipses:
        t = np.deg2rad(phi)
        xr = (x - x0) * np.cos(t) + (y - y0) * np.sin(t)
        yr = -(x - x0) * np.sin(t) + (y - y0) * np.cos(t)
        img[(xr / a) ** 2 + (yr / b) ** 2 <= 1.0] += v
    return img


def peak_gib(fn):
    """``fn()`` and the peak device memory it allocated, GiB."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    return out, (torch.cuda.max_memory_allocated() - base) / 2 ** 30


def radon64(img: np.ndarray, theta: np.ndarray) -> np.ndarray:
    """The Radon transform of the N x N ``img`` at the angles ``theta`` by
    its definition in float64: the image spectrum on each polar slice, by
    direct sums, then the slice's centered inverse transform."""
    N = img.shape[-1]
    om = 2.0 * np.pi * (np.arange(N) - N // 2) / N
    off = np.arange(N) - N // 2
    ex = np.exp(-1j * np.outer(off, np.outer(np.cos(theta), om).ravel()))   # (x, points)
    ey = np.exp(-1j * np.outer(off, np.outer(np.sin(theta), om).ravel()))   # (y, points)
    G = np.sum(ey * (img @ ex), axis=0).reshape(len(theta), N)
    return np.fft.fftshift(np.fft.ifft(np.fft.ifftshift(G, axes=-1)), axes=-1).real


def iradon64(sino: np.ndarray, theta: np.ndarray, px: np.ndarray) -> np.ndarray:
    """The ramp-filtered backprojection of ``sino`` at the (row, col) pixels
    ``px`` by its definition in float64 (direct sums over every polar
    point, with the polar quadrature weights)."""
    T, N = sino.shape
    om = 2.0 * np.pi * (np.arange(N) - N // 2) / N
    off = np.arange(N) - N // 2
    s64 = sino.astype(np.float64)
    slices = np.fft.fftshift(np.fft.fft(np.fft.ifftshift(s64, axes=-1)), axes=-1) * np.abs(om)
    strengths = (slices * (np.pi / T) * (2.0 * np.pi / N) / (4.0 * np.pi ** 2)).ravel()
    ox = np.outer(np.cos(theta), om).ravel()
    oy = np.outer(np.sin(theta), om).ravel()
    py, pxx = off[px[:, 0]].astype(np.float64), off[px[:, 1]].astype(np.float64)
    return direct_sum(lambda a, b: np.outer(py, oy[a:b]) + np.outer(pxx, ox[a:b]), strengths,
                      1.0).real


def nufft_tomography(rng, card: str):
    """Phase 21: the non-uniform FFTs at cuFINUFFT's single-precision sizes
    and the Radon pair of a 400 x 400 phantom, from numpy input without a
    device, against float64 direct sums of the definitions (a sample of
    outputs), with the kernel's launches per call, the kernel against its
    plain version on every plane pair, device and back-to-back times and
    peak memory.  Returns the launches and the kernel's worst abs error."""
    ops = Ops()
    run, check = ops.run, ops.check
    cuda_fft.LAUNCHES = 0
    rows, worst = [], []
    M, n = NUFFT_POINTS, NUFFT_MODES
    eps = dict(eps=NUFFT_EPS)

    def timed_row(name, fn, calls=5):
        _, gib = peak_gib(fn)
        row = timing_row(name, fn, calls)
        row["peak_gib"] = gib
        log(f"{name}: peak device memory {gib:.3f} GiB")
        rows.append(row)

    # 1-D on [0, 2π): the phase reduction is exact there
    x = rng.uniform(0.0, 2.0 * np.pi, M).astype(np.float32)
    c = complex64(rng, M)
    f = run("nufft1", tp.nufft1, x, c, n, **eps)
    ks = np.sort(rng.choice(n, NUFFT_SAMPLES, replace=False))
    kv = modes_of(n)[ks]
    x64 = x.astype(np.float64)
    want = direct_sum(lambda a, b: np.outer(kv, x64[a:b]), c, -1.0)
    check(f"nufft1 {n:,} modes from {M:,} points, eps {NUFFT_EPS} ({NUFFT_SAMPLES} modes vs "
          "the float64 sum)", f[ks], want, NUFFT_TOL)
    fm = complex64(rng, n)
    v = run("nufft2", tp.nufft2, x, fm, **eps)
    js = np.sort(rng.choice(M, NUFFT_SAMPLES, replace=False))
    km = modes_of(n)
    want = direct_sum(lambda a, b: np.outer(x64[js], km[a:b]), fm, 1.0)
    check(f"nufft2 {n:,} modes to {M:,} points ({NUFFT_SAMPLES} points vs the float64 sum)",
          v[js], want, NUFFT_TOL)
    worst.append(kernel_errors(ops.seen, "nufft 1-D planes"))
    ops.seen.clear()
    xt, ct, ft = cuda32(x), cuda_complex(c), cuda_complex(fm)
    with torch.no_grad():
        timed_row(f"nufft1 {n:,} modes, {M:,} points", lambda: tp.nufft1(xt, ct, n, **eps))
        timed_row(f"nufft2 {n:,} modes, {M:,} points", lambda: tp.nufft2(xt, ft, **eps))
    del f, v, xt, ct, ft

    # 2-D on [-π, π)², the benchmark's convention: F7 applies
    n1, n2 = NUFFT_MODES_2D
    x, y = (rng.uniform(-np.pi, np.pi, M).astype(np.float32) for _ in range(2))
    x64, y64 = x.astype(np.float64), y.astype(np.float64)
    tol2 = NUFFT_TOL + F7_PHASE * (n1 // 2 + n2 // 2)
    f = run("nufft1_2d", tp.nufft1_2d, x, y, c, (n1, n2), **eps)
    k1 = rng.integers(0, n1, NUFFT_SAMPLES)
    k2 = rng.integers(0, n2, NUFFT_SAMPLES)
    kv1, kv2 = modes_of(n1)[k1], modes_of(n2)[k2]
    want = direct_sum(lambda a, b: np.outer(kv1, x64[a:b]) + np.outer(kv2, y64[a:b]), c, -1.0)
    check(f"nufft1_2d {n1} x {n2} modes from {M:,} points on [-π, π)² (bound {tol2:.2e} with "
          "F7's phase error)", f[k1, k2], want, tol2)
    fm = complex64(rng, n1, n2)
    v = run("nufft2_2d", tp.nufft2_2d, x, y, fm, **eps)
    g1, g2 = np.meshgrid(modes_of(n1), modes_of(n2), indexing="ij")
    g1, g2 = g1.ravel(), g2.ravel()
    want = direct_sum(lambda a, b: np.outer(x64[js], g1[a:b]) + np.outer(y64[js], g2[a:b]),
                      fm.ravel(), 1.0)
    check(f"nufft2_2d {n1} x {n2} modes to {M:,} points", v[js], want, tol2)
    worst.append(kernel_errors(ops.seen, "nufft 2-D planes"))
    ops.seen.clear()
    xt, yt, ct, ft = cuda32(x), cuda32(y), cuda_complex(c), cuda_complex(fm)
    with torch.no_grad():
        timed_row(f"nufft1_2d {n1} x {n2} modes, {M:,} points",
                  lambda: tp.nufft1_2d(xt, yt, ct, (n1, n2), **eps), 3)
        timed_row(f"nufft2_2d {n1} x {n2} modes, {M:,} points",
                  lambda: tp.nufft2_2d(xt, yt, ft, **eps), 3)
    del f, v, xt, yt, ct, ft, g1, g2

    # tomography: radon then iradon of the phantom
    N, T = TOMO_N, TOMO_ANGLES
    img = shepp_logan(N)
    theta = np.linspace(0.0, np.pi, T, endpoint=False)
    sino = run("radon", tp.radon, img.astype(np.float32), theta)
    rows_t = np.linspace(0, T - 1, TOMO_ORACLE_ANGLES).astype(int)
    tol_t = NUFFT_TOL + F7_PHASE * N
    check(f"radon {N} x {N} Shepp-Logan at {T} angles -> {tuple(sino.shape)} "
          f"({TOMO_ORACLE_ANGLES} angles vs the float64 definition; bound {tol_t:.2e})",
          sino[rows_t], radon64(img, theta[rows_t]), tol_t)
    back = run("iradon", tp.iradon, sino, theta)
    px = rng.integers(0, N, (TOMO_ORACLE_PIXELS, 2))
    check(f"iradon -> {tuple(back.shape)} ({TOMO_ORACLE_PIXELS} pixels vs the float64 definition)",
          back[px[:, 0], px[:, 1]], iradon64(sino.cpu().numpy(), theta, px), tol_t)
    worst.append(kernel_errors(ops.seen, "tomography planes"))
    ops.seen.clear()
    imgt, sinot = cuda32(img), sino
    with torch.no_grad():
        timed_row(f"radon {N} x {N}, {T} angles", lambda: tp.radon(imgt, theta), 3)
        timed_row(f"iradon {T} x {N}", lambda: tp.iradon(sinot, theta), 3)
    del sino, back, sinot, imgt
    torch.cuda.empty_cache()

    launches = sum(ops.used.values())
    log("nufft and tomography kernel launches: " + ", ".join(f"{k} {v}" for k, v in ops.used.items()))
    expected = {"nufft1": 1, "nufft2": 1, "nufft1_2d": 2, "nufft2_2d": 2, "radon": 3, "iradon": 3}
    require(ops.used == expected, f"kernel launches {ops.used}, expected {expected}")
    log(json.dumps({"nufft_timing": {"card": card, "calls": rows}}))
    return launches, max(worst)


def sh_coefficients(rng, L: int, batch: int, real: bool, orders: np.ndarray) -> np.ndarray:
    """Packed (batch, 2L-1, L) coefficients, random on the packed rows of
    ``orders`` (m >= 0; for a complex field also -m), zero below |m| <= l;
    a real field's negative orders by a_{l,-m} = (-1)^m conj(a_lm)."""
    a = np.zeros((batch, 2 * L - 1, L), np.complex128)
    for m in orders:
        rows = [m] if (real or m == 0) else [m, 2 * L - 1 - m]
        for r in rows:
            a[:, r, m:] = rng.standard_normal((batch, L - m)) + 1j * rng.standard_normal((batch, L - m))
        if real:
            if m == 0:
                a[:, 0] = a[:, 0].real
            else:
                a[:, 2 * L - 1 - m] = (-1) ** m * np.conj(a[:, m])
    return a


def sh_synthesis64(a: np.ndarray, L: int, orders: np.ndarray, real: bool) -> np.ndarray:
    """Σ_lm a_lm Y_lm on the (L, 2L) Gauss grid in float64, Y from scipy's
    ``sph_harm_y``, over the packed rows of ``orders`` (both signs).  The
    tables Y_lm(θ, 0) are made once per order, in threads (scipy's ufunc
    leaves the interpreter lock), and Y_l,-m(θ, 0) = (-1)^m Y_lm(θ, 0)."""
    from scipy.special import sph_harm_y
    theta, phi, _ = tp.sht_grid(L - 1)

    def table(m):                                                          # (l, lat)
        return sph_harm_y(np.arange(m, L)[:, None], m, theta[None, :], 0.0)

    with concurrent.futures.ThreadPoolExecutor() as pool:
        tables = dict(zip(orders.tolist(), pool.map(table, orders.tolist())))
    out = np.zeros(a.shape[:-2] + (L, 2 * L), np.complex128)
    for m in orders.tolist():
        for mm, r in ([(m, m), (-m, 2 * L - 1 - m)] if m else [(0, 0)]):
            Y = tables[m] if mm >= 0 else (-1) ** m * tables[m]
            g = a[..., r, m:] @ Y                                          # (…, lat)
            out += g[..., :, None] * np.exp(1j * mm * phi)[None, :]
    return out.real if real else out


def sht_orders(rng, L: int) -> np.ndarray:
    return np.unique(np.concatenate([[0, 1, L - 1], rng.choice(L, SHT_ORDERS - 3, replace=False)]))


def sht_sfno(rng, card: str, full: bool = False):
    """Phase 22: ``sht``/``isht`` at L = 256 (batch 16, real and complex),
    the recurrence pair at L = 512 (plain and compensated) against fields
    synthesized in float64 with scipy's spherical harmonics, the recurrence
    finite at L = 2048 and, with ``full`` (``python3 chip_smoke.py sphere``),
    the recurrence timed at L = 512 and 2048 (the profiler's events of its
    16,000-66,000 kernels a call do not fit the whole run's time limit);
    then the SFNO at the shallow-water configuration:
    forward from numpy input against the stage pipeline, one layer's spectral
    mix against float64, three train steps (the first with the kernel held
    against its plain version on every plane pair, its loss and gradients
    leaf by leaf against the stage pipeline).  Returns the launches and the
    kernel's worst abs error."""
    ops = Ops()
    run, check = ops.run, ops.check
    cuda_fft.LAUNCHES = 0
    rows, worst = [], []

    L = SHT_L
    orders = sht_orders(rng, L)
    for real in (True, False):
        kind = "real" if real else "complex"
        a = sh_coefficients(rng, L, SHT_BATCH, real, orders)
        f64 = sh_synthesis64(a, L, orders, real)
        f = f64.astype(np.float32 if real else np.complex64)
        got = run(f"sht {kind}", tp.sht, f)
        check(f"sht {kind} L={L}, batch {SHT_BATCH} -> {tuple(got.shape)} vs the float64 "
              "coefficients", got, a)
        back = run(f"isht {kind}", tp.isht, a.astype(np.complex64), real_output=real)
        check(f"isht {kind} L={L} vs the float64 field (scipy sph_harm_y)", back, f64)
        ft, at = (cuda32(f) if real else cuda_complex(f)), cuda_complex(a)
        with torch.no_grad():
            rows.append(timing_row(f"sht {kind} L={L} batch {SHT_BATCH}", lambda: tp.sht(ft), 5))
            rows.append(timing_row(f"isht {kind} L={L} batch {SHT_BATCH}",
                                   lambda: tp.isht(at, real_output=real), 5))
        del got, back, ft, at
    worst.append(kernel_errors(ops.seen, "sht planes"))
    ops.seen.clear()

    L = SHT_REC_L
    orders = sht_orders(rng, L)
    a = sh_coefficients(rng, L, SHT_REC_BATCH, True, orders)
    f = sh_synthesis64(a, L, orders, True)
    for compensated in (False, True):
        kind = "compensated" if compensated else "plain"
        got = run(f"sht_recurrence {kind}", tp.sht_recurrence, f.astype(np.float32),
                  compensated=compensated)
        check(f"sht_recurrence {kind} L={L} batch {SHT_REC_BATCH}", got, a,
              ORACLE_TOL if compensated else SHT_REC_PLAIN_TOL)
        back = run(f"isht_recurrence {kind}", tp.isht_recurrence, a.astype(np.complex64),
                   real_output=True, compensated=compensated)
        check(f"isht_recurrence {kind} L={L}", back, f,
              ORACLE_TOL if compensated else ISHT_REC_PLAIN_TOL)
    ft = cuda32(f)
    # the recurrence rows time one call each: the profiler's events of these
    # 16,000-66,000-kernel calls are most of the phase's wall time, so the
    # whole run leaves them to ``python3 chip_smoke.py sphere``
    with torch.no_grad():
        for compensated in (False, True) if full else ():
            rows.append(timing_row(
                f"sht_recurrence {'compensated' if compensated else 'plain'} L={L} batch "
                f"{SHT_REC_BATCH}", lambda: tp.sht_recurrence(ft, compensated=compensated), 1))
        L = SHT_REC_TIME_L
        fl = cuda32(rng.standard_normal((1, L, 2 * L)))
        got = tp.sht_recurrence(fl)
        require(bool(torch.isfinite(got).all()), f"sht_recurrence at L={L} is not finite")
        if full:
            rows.append(timing_row(f"sht_recurrence plain L={L} batch 1",
                                   lambda: tp.sht_recurrence(fl), 1))
    del ft, fl, got
    worst.append(kernel_errors(ops.seen, "recurrence planes"))
    ops.seen.clear()
    log("sht kernel launches: " + ", ".join(f"{k} {v}" for k, v in ops.used.items()))
    require(all(v == 1 for v in ops.used.values()), f"sht kernel launches {ops.used}")

    # the SFNO
    launches, err = sfno_path(rng, card, rows)
    worst.append(err)
    log(json.dumps({"sht_sfno_timing": {"card": card, "calls": rows}}))
    return sum(ops.used.values()) + launches, max(worst)


def sfno_mix_oracle(layer, a: np.ndarray, L: int, orders: np.ndarray, outs: np.ndarray):
    """Layer 0's spectral mix in float64 on a band-limited field of packed
    coefficients ``a`` (channels, 2L-1, L): Re Σ_lm (Σ_i a[i]·R[i, o, l]) Y_lm
    for the output channels ``outs``."""
    R = (layer["r_re"].double() + 1j * layer["r_im"].double()).cpu().numpy()[:, outs]
    rows = sorted({m for m in orders} | {(2 * L - 1 - m) % (2 * L - 1) for m in orders})
    mixed = np.zeros((len(outs), 2 * L - 1, L), np.complex128)
    # per degree: (rows, c_in) @ (c_in, outs)
    part = np.matmul(np.moveaxis(a[:, rows, :], -1, 0).transpose(0, 2, 1), np.moveaxis(R, -1, 0))
    mixed[:, rows, :] = np.moveaxis(part, 0, -1).transpose(1, 0, 2)
    return sh_synthesis64(mixed, L, orders, False).real


def sfno_path(rng, card: str, rows: list):
    """The SFNO part of phase 22; appends its timing rows to ``rows`` and
    returns the launches of its forward and train steps and the kernel's
    worst abs error."""
    n_layers = SFNO["n_layers"]
    L = SFNO["lmax"] + 1
    gen = torch.Generator().manual_seed(SEED)
    params = sfno.init_sfno(**SFNO, generator=gen, device="cuda")
    x = rng.standard_normal((SFNO_BATCH, SFNO["in_channels"], L, 2 * L))
    target = rng.standard_normal((SFNO_BATCH, SFNO["out_channels"], L, 2 * L))
    cuda_fft.LAUNCHES = 0
    with torch.no_grad():
        y = sfno.apply(params, x)
        torch.cuda.synchronize()
        forward = cuda_fft.LAUNCHES
        y_pipe = sfno.apply(params, x, config=PIPELINE)
    require(y.device.type == "cuda", f"sfno: result on {y.device}, not the card")
    err = rel_err(y.cpu().numpy(), y_pipe.cpu().numpy())
    log(f"sfno L={L} hidden {SFNO['hidden']} x {n_layers} layers, batch {SFNO_BATCH}: forward "
        f"{tuple(y.shape)} rel err {err:.3e} vs stage pipeline, {forward} launches")
    require(err <= ROUTES_TOL, f"sfno forward error {err:.3e}")
    require(forward == 2 * n_layers, f"sfno forward launches {forward}")
    del y, y_pipe

    # one layer's spectral mix against float64 on a band-limited hidden field
    orders = sht_orders(rng, L)
    a = sh_coefficients(rng, L, SFNO["hidden"], True, orders)
    h = sh_synthesis64(a, L, orders, True)
    outs = np.sort(rng.choice(SFNO["hidden"], SFNO_ORACLE_CHANNELS, replace=False))
    with torch.no_grad():
        mix = sfno.spectral_mix(params["layers"][0], cuda32(h[None]))[0, outs]
    err = rel_err(mix.cpu().numpy(), sfno_mix_oracle(params["layers"][0], a, L, orders, outs))
    log(f"sfno spectral_mix of layer 0 on {SFNO['hidden']} band-limited channels "
        f"({SFNO_ORACLE_CHANNELS} outputs vs float64): rel err {err:.3e}")
    require(err <= ORACLE_TOL, f"sfno spectral_mix error {err:.3e}")
    del h, a, mix

    xt, tt = cuda32(x), cuda32(target)
    before = cuda_fft.LAUNCHES
    losses = []
    with recorded_launches() as seen:
        new, loss = sfno.train_step(params, xt, tt, SFNO_LR)
        torch.cuda.synchronize()
    n_step = cuda_fft.LAUNCHES - before
    log(f"sfno train step: {n_step} launches")
    require(n_step == 4 * n_layers, f"sfno train step launches {n_step}")
    worst = kernel_errors(seen, "sfno train-step planes")
    del seen
    losses.append(float(loss))
    # the step against the stage pipeline: loss, stepped parameters, gradients
    new_pipe, loss_pipe = sfno.train_step(params, xt, tt, SFNO_LR, config=PIPELINE)
    require(abs(float(loss) - float(loss_pipe)) <= ORACLE_TOL * abs(float(loss_pipe)),
            f"sfno loss {float(loss)} vs the stage pipeline's {float(loss_pipe)}")
    err = max(rel_err(p.cpu().numpy(), q.cpu().numpy())
              for p, q in zip(tree_leaves(new), tree_leaves(new_pipe)))
    require(err <= ROUTES_TOL, f"sfno stepped parameters: {err:.3e}")
    names = []
    tree_map_with_path(lambda path, p: names.append(path), params)
    grads = dict(zip(names, (g.cpu().numpy() for g in gradients(
        sfno.loss_fn, params, xt, tt, tp.DEFAULT_CONFIG))))
    grads_pipe = dict(zip(names, (g.cpu().numpy() for g in gradients(
        sfno.loss_fn, params, xt, tt, PIPELINE))))
    errs = {}
    for name in names:
        # Re isht(a·i·s_l) = 0 for the Hermitian a of a real field: the exact
        # gradient of an imaginary spectral weight is zero, both routes' are
        # rounding noise, held to the scale of the layer's real part's gradient
        ref = grads_pipe[name[:-2] + "re"] if name.endswith("r_im") else grads_pipe[name]
        errs[name] = float(np.max(np.abs(grads[name] - grads_pipe[name])) / np.max(np.abs(ref)))
    log(f"sfno train step: loss {float(loss):.6f} (pipeline {float(loss_pipe):.6f}), stepped "
        f"parameters {err:.3e}, gradients {max(errs.values()):.3e} (worst leaf: "
        f"{max(errs, key=errs.get)}) vs stage pipeline")
    require(max(errs.values()) <= ROUTES_TOL, f"sfno gradients: {errs}")
    del grads, grads_pipe, new_pipe
    for _ in range(SFNO_STEPS - 1):
        new, loss = sfno.train_step(new, xt, tt, SFNO_LR)
        losses.append(float(loss))
    moved = max(float((a - b).abs().max()) for a, b in zip(tree_leaves(new), tree_leaves(params)))
    require(all(math.isfinite(v) for v in losses) and moved > 0.0,
            f"sfno losses {losses}, largest parameter change {moved}")
    log(f"sfno {SFNO_STEPS} train steps: losses {losses}, largest parameter change {moved:.3e} "
        "(random targets: the loss stays at their variance)")
    launches = cuda_fft.LAUNCHES
    with torch.no_grad():
        rows.append(timing_row(f"sfno forward L={L}, hidden {SFNO['hidden']} x {n_layers}, "
                               f"batch {SFNO_BATCH}", lambda: sfno.apply(params, xt), 3))
    rows.append(timing_row(f"sfno train step L={L}, hidden {SFNO['hidden']} x {n_layers}, "
                           f"batch {SFNO_BATCH}", lambda: sfno.train_step(params, xt, tt, SFNO_LR), 3))
    _, gib = peak_gib(lambda: sfno.train_step(params, xt, tt, SFNO_LR))
    rows[-1]["peak_gib"] = gib
    log(f"sfno train step: peak device memory {gib:.2f} GiB")
    torch.cuda.empty_cache()
    return launches, worst


# ---------------------------------------------------------------------------
# Phases 23-24: the radar and radio front end, wavelets and the other leaves
# ---------------------------------------------------------------------------

# A pulse-Doppler coherent processing interval: 16 receive channels of a
# half-wavelength ULA x 128 pulses x 8,192 complex fast-time samples (128 MiB
# of complex64), one LFM pulse of 512 samples sweeping ±0.2 cycles/sample,
# three point targets as (delay in samples, Doppler bin of the 128, angle in
# degrees, amplitude) in unit complex noise.  The first two share a Doppler
# bin, so the snapshots of that bin hold two sources for MVDR and MUSIC.
RADAR_CHANNELS, RADAR_PULSES, RADAR_SAMPLES, RADAR_PULSE = 16, 128, 8192, 512
RADAR_TARGETS = ((1500, 10, -20.0, 0.5), (4200, 10, 10.0, 0.4), (6100, -24, 35.0, 0.3))
RADAR_ORACLE_CHANNELS = (0, 7, 15)   # the float64 range-Doppler oracle's channels
RADAR_CFAR = dict(num_train=8, num_guard=2, pfa=1e-4)
CFAR_TOL = 1e-4   # thresholds: box sums differenced from fp32 cumulative sums
MVDR_TOL = 1e-4   # 1/(aᴴR⁻¹a) through a 16 x 16 solve in fp32: cond(R)·2^-24 and more
# The critically sampled CASPER-style spectrometer (Price, arXiv 1607.03579):
# 4,096 channels, 4 taps a branch, Hamming; 2 polarizations of 2^25 real
# samples; the float64 oracle on 256 sampled frames; the synthesis on a cut
PFB = dict(n_channels=4096, taps_per_branch=4, window="hamming")
PFB_POLS, PFB_SAMPLES, PFB_ORACLE_FRAMES, PFB_CUT = 2, 1 << 25, 256, 1 << 20
# line spectra: 8 records of 4,096 complex samples, 4 exponentials each
SUBSPACE_SIGNALS, SUBSPACE_N, SUBSPACE_M, SUBSPACE_P = 8, 4096, 64, 4
# Phase 24.  The wavelets on Whisper's clips (16 x 30 s at 16 kHz, as phase
# 17), JPEG 2000's 9/7 pair on 2,048² images, the dual tree on 512² images
DWT_LEVELS, DWT2_LEVELS, SWT_LEVELS, DTCWT_LEVELS = 5, 5, 4, 4
DWT2_IMAGES, DWT2_N = 4, 2048
SWT_SHAPE, EWT_SHAPE, EWT_BANDS = (16, 65536), (16, 65536), 5
DTCWT_IMAGES, DTCWT_N = 4, 512
EMD_N, VMD_SHAPE, VMD_K, VMD_ITERS = 10000, (8, 4096), 4, 300
VMD_TOL = 1e-4   # 300 ADMM sweeps in fp32 against the same sweeps in float64
# Guizar-Sicairos et al. 2008: 1/100 pixel on 16 pairs of 1,024² images
REG_PAIRS, REG_N, REG_UP = 16, 1024, 100
UNWRAP_N, UNWRAP_TOL = 1024, 1e-4   # a Poisson solve through dctn/idctn in fp32
GAUSS_N = 2048
# an echo canceller's 32 ms tail at 8 kHz: 256 taps, 8,000 samples
ADAPT_TAPS, ADAPT_N = 256, 8000
AR_ORDER, AR_NFREQ, AR_N = 16, 512, 4096
SSA_N, SSA_WINDOW, DMD_SHAPE = 4096, 256, (256, 200)
# K1 against cuFFT at the shapes the CQT, NUFFT and SFNO paths (phases 19-22)
# and the range-Doppler and PFB paths (phase 23) hand it: (n, rows)
SLICE_YARDSTICK = ((16384, 10336), (16384, 1), (2048, 2048), (256, 131072), (512, 131072),
                   (8748, 2048), (128, RADAR_CHANNELS * (RADAR_SAMPLES - RADAR_PULSE + 1)),
                   (4096, PFB_POLS * (PFB_SAMPLES // 4096)))
ON_CARD = True   # a CPU rehearsal of phases 23-24 sets this False: no timings, no launch counts


def front_end_row(rows, name, fn, calls, err=None, capture=True):
    """A timing row (device, graph-replay and back-to-back µs, idle share,
    device kernels, K1 launches and µs) with the call's peak device memory
    and its error against the float64 oracle."""
    if not ON_CARD:
        return
    _, gib = peak_gib(fn)
    row = timing_row(name, fn, calls, capture)
    row["peak_gib"] = gib
    row["rel_err_vs_float64"] = err
    log(f"{name}: peak device memory {gib:.3f} GiB, rel err vs float64 {err}")
    rows.append(row)


def lfm_pulse(n: int) -> np.ndarray:
    """The complex LFM pulse from the port's ``chirp`` (cos and, at -90°,
    sin of the same phase), computed on the host in float64."""
    t = np.arange(n, dtype=np.float64)
    kw = dict(f0=-0.2, t1=float(n - 1), f1=0.2)
    re = tp.chirp(t, **kw).cpu().numpy()
    im = tp.chirp(t, phi=-90.0, **kw).cpu().numpy()
    return (re + 1j * im).astype(np.complex64)


def radar_cpi(rng, tx: np.ndarray) -> np.ndarray:
    c, p, n = RADAR_CHANNELS, RADAR_PULSES, RADAR_SAMPLES
    rx = ((rng.standard_normal((c, p, n), dtype=np.float32)
           + 1j * rng.standard_normal((c, p, n), dtype=np.float32)) * 0.5 ** 0.5).astype(np.complex64)
    for delay, dbin, angle, amp in RADAR_TARGETS:
        steer = np.exp(1j * np.pi * np.arange(c) * np.sin(np.deg2rad(angle)))
        dop = np.exp(2j * np.pi * dbin * np.arange(p) / p)
        echo = amp * steer[:, None, None] * dop[None, :, None] * tx[None, None, :]
        rx[:, :, delay: delay + tx.size] += echo.astype(np.complex64)
    return rx


def range_doppler64(rx: np.ndarray, tx: np.ndarray) -> np.ndarray:
    """float64: Σ_n rx[n+d]·conj(w·tx[n]) / Σ w|tx|² by a padded FFT
    correlation, then the Hann-tapered, fftshifted slow-time DFT."""
    n, nt = rx.shape[-1], tx.size
    w = scipy.signal.get_window("hamming", nt, fftbins=True)
    L = 1 << int(math.ceil(math.log2(n + nt - 1)))
    kern = np.conj(np.fft.fft(w * tx.astype(np.complex128), L))
    y = np.fft.ifft(np.fft.fft(rx.astype(np.complex128), L) * kern)[..., : n - nt + 1]
    y /= np.sum(w * np.abs(tx.astype(np.complex128)) ** 2)
    m = rx.shape[-2]
    hann = scipy.signal.get_window("hann", m, fftbins=True)
    y = y * (hann / hann.sum())[:, None]
    return np.fft.fftshift(np.fft.fft(y, axis=-2), axes=-2)


def cfar_ca64(p: np.ndarray, t: int, g: int, pfa: float, axes) -> np.ndarray:
    """float64 cell-averaging CFAR over the box ring of ``axes``: the ring's
    sum and in-bounds count by zero-padded box sums, α = N(pfa^(-1/N) - 1)."""
    def box(v, half):
        for a in axes:
            v = np.moveaxis(v, a, -1)
            c = np.cumsum(np.pad(v, [(0, 0)] * (v.ndim - 1) + [(half + 1, half)]), axis=-1)
            v = np.moveaxis(c[..., 2 * half + 1:] - c[..., : -(2 * half + 1)], -1, a)
        return v
    ones = np.ones(p.shape)
    ring_s = box(p, t + g) - box(p, g)
    ring_n = box(ones, t + g) - box(ones, g)
    return ring_n * (pfa ** (-1.0 / ring_n) - 1.0) * ring_s / ring_n


def cfar_os64(p: np.ndarray, t: int, g: int, pfa: float) -> np.ndarray:
    """float64 order-statistic CFAR along the last axis: the k-th smallest
    of the 2t training cells of the reflect-padded row, k = ⌈3·2t/4⌉,
    Rohling's threshold factor by a root finder."""
    n, k = 2 * t, int(math.ceil(0.75 * 2 * t))
    pp = np.pad(p, [(0, 0)] * (p.ndim - 1) + [(t + g, t + g)], mode="reflect")
    offs = list(range(t)) + list(range(t + 2 * g + 1, 2 * t + 2 * g + 1))
    win = np.stack([pp[..., o: o + p.shape[-1]] for o in offs], axis=-1)
    noise = np.partition(win, k - 1, axis=-1)[..., k - 1]
    i = np.arange(k)
    alpha = scipy.optimize.brentq(
        lambda a: np.sum(np.log(n - i) - np.log(n - i + a)) - np.log(pfa), 0.0, 1e6)
    return alpha * noise


def pfb_round_trip64(x: np.ndarray, h: np.ndarray, K: int, P: int, eps: float = 1e-8) -> np.ndarray:
    """float64 full-mode analysis of ``x`` (..., T) and the Tikhonov-floored
    deconvolution that inverts it, as ``pfb_analysis``/``pfb_synthesis``
    define them."""
    xp = np.pad(x.astype(np.float64), [(0, 0)] * (x.ndim - 1) + [((P - 1) * K, (P - 1) * K + (-x.shape[-1]) % K)])
    F = (xp.shape[-1] - P * K) // K + 1
    blocks = xp.reshape(xp.shape[:-1] + (-1, K))
    v = sum(blocks[..., p: p + F, :] * h[p * K: (p + 1) * K] for p in range(P))
    y = np.fft.fft(v, axis=-1)
    hb = h.reshape(P, K)[::-1]
    Hf = np.fft.fft(np.concatenate([hb, np.zeros((F - P, K))]), axis=0)
    mag2 = np.abs(Hf) ** 2
    inv = np.conj(Hf) / (mag2 + eps * mag2.max(axis=0, keepdims=True))
    xr = np.fft.ifft(np.fft.fft(np.fft.ifft(y, axis=-1), axis=-2) * inv, axis=-2)[..., : F - P + 1, :]
    return xr.reshape(xr.shape[:-2] + (-1,))


def top_angles(ang: np.ndarray, spec: np.ndarray, count: int) -> np.ndarray:
    pk, _ = tp.find_peaks(spec)
    return np.sort(ang[pk[np.argsort(spec[pk])[-count:]]])


def radar_radio(rng, card: str):
    """Phase 23: the pulse-Doppler radar chain and the radio-astronomy
    channelizer at full width, from numpy input without a device, against
    float64 numpy oracles, with the kernel's launches per op, the kernel
    against its plain version on every plane pair, and device and
    back-to-back times, idle shares and peak memory.  Returns the launches
    and the kernel's worst abs error."""
    ops = Ops()
    run, check = ops.run, ops.check
    cuda_fft.LAUNCHES = 0
    rows, worst = [], []
    tx = lfm_pulse(RADAR_PULSE)
    rx = radar_cpi(rng, tx)
    rd = run("range_doppler", tp.range_doppler, rx, tx, window="hamming")
    n_range = RADAR_SAMPLES - RADAR_PULSE + 1
    require(tuple(rd.shape) == (RADAR_CHANNELS, RADAR_PULSES, n_range), f"range-Doppler {rd.shape}")
    sel = list(RADAR_ORACLE_CHANNELS)
    want = range_doppler64(rx[sel], tx)
    rd_err = rel_err(rd[sel].cpu().numpy(), want)
    check(f"range_doppler {RADAR_CHANNELS} x {RADAR_PULSES} x {RADAR_SAMPLES} CPI, "
          f"{RADAR_PULSE}-sample LFM, Hamming (channels {sel} vs float64)", rd[sel], want)
    del want
    worst.append(kernel_errors(ops.seen, "range-Doppler planes"))
    ops.seen.clear()

    # CFAR: 2-D cell averaging on the power map, 1-D order statistic on one channel
    power = rd.real ** 2 + rd.imag ** 2
    t_, g_, pfa = RADAR_CFAR["num_train"], RADAR_CFAR["num_guard"], RADAR_CFAR["pfa"]
    det, thr = run("cfar ca 2-D", tp.cfar, power, t_, g_, pfa, axes=(-2, -1))
    p64 = power.double().cpu().numpy()
    thr64 = cfar_ca64(p64, t_, g_, pfa, (-2, -1))
    cfar_err = rel_err(thr.cpu().numpy(), thr64)
    log(f"cfar ca 2-D {tuple(power.shape)}: threshold rel err {cfar_err:.3e} vs float64")
    require(cfar_err <= CFAR_TOL, f"cfar thresholds {cfar_err:.3e}")
    clear = np.abs(p64 - thr64) > 1e-3 * thr64
    det_np = det.cpu().numpy()
    agree = np.array_equal(det_np[clear], (p64 > thr64)[clear])
    log(f"cfar ca 2-D: {int(det_np.sum())} detections, {int((~clear).sum())} cells within 1e-3 "
        f"of the threshold, detections elsewhere equal to float64: {agree}")
    require(agree, "cfar ca detections differ from the float64 oracle away from ties")
    for delay, dbin, _, _ in RADAR_TARGETS:
        require(bool(det_np[:, RADAR_PULSES // 2 + dbin, delay].all()),
                f"target at delay {delay}, Doppler bin {dbin} not detected on every channel")
    det1, thr1 = run("cfar os 1-D", tp.cfar, power[0], t_, g_, pfa, "os")
    thr1_64 = cfar_os64(p64[0], t_, g_, pfa)
    os_err = rel_err(thr1.cpu().numpy(), thr1_64)
    clear1 = np.abs(p64[0] - thr1_64) > 1e-3 * thr1_64
    agree1 = np.array_equal(det1.cpu().numpy()[clear1], (p64[0] > thr1_64)[clear1])
    log(f"cfar os 1-D {tuple(power[0].shape)}: threshold rel err {os_err:.3e}, detections "
        f"equal away from ties: {agree1}")
    require(os_err <= CFAR_TOL and agree1, "cfar os differs from the float64 oracle")
    del p64, thr64, clear, det_np, thr1_64

    # beamforming on the snapshots of the targets' Doppler bins
    bins = sorted({RADAR_PULSES // 2 + t[1] for t in RADAR_TARGETS}, reverse=True)
    snaps = rd[:, bins, :].transpose(0, 1).contiguous()          # (bins, channels, cells)
    R = run("spatial_covariance", tp.spatial_covariance, snaps)
    s64 = snaps.cpu().numpy().astype(np.complex128)
    R64 = np.einsum("bit,bjt->bij", s64, s64.conj()) / s64.shape[-1]
    check(f"spatial_covariance {tuple(snaps.shape)}", R, R64)
    grid = np.arange(-90.0, 91.0)
    ang, mv = run("mvdr_spectrum", tp.mvdr_spectrum, R, RADAR_CHANNELS, grid)
    A = np.exp(1j * np.pi * np.arange(RADAR_CHANNELS)[:, None] * np.sin(np.deg2rad(grid))[None, :])
    mv64 = 1.0 / np.real(np.einsum("ig,big->bg", A.conj(), np.linalg.solve(
        R.cpu().numpy().astype(np.complex128), np.broadcast_to(A, (len(bins),) + A.shape))))
    log(f"covariance condition numbers {np.round(np.linalg.cond(R64), 1)}")
    mv_err = rel_err(mv.cpu().numpy(), mv64)
    check(f"mvdr_spectrum over {grid.size} angles, {len(bins)} Doppler bins", mv, mv64, MVDR_TOL)
    planted = [sorted(t[2] for t in RADAR_TARGETS if RADAR_PULSES // 2 + t[1] == b) for b in bins]
    for i, want_ang in enumerate(planted):
        got_ang = top_angles(ang, mv[i].cpu().numpy(), len(want_ang))
        _, mu = tp.music_doa(R[i], RADAR_CHANNELS, len(want_ang), grid)
        mu_ang = top_angles(ang, mu, len(want_ang))
        log(f"Doppler bin {bins[i] - RADAR_PULSES // 2:+d}: MVDR peaks {got_ang}, MUSIC peaks "
            f"{mu_ang}, planted {want_ang}")
        require(np.allclose(got_ang, want_ang, atol=1.0) and np.allclose(mu_ang, want_ang, atol=1.0),
                f"direction finding missed the planted angles {want_ang}")
    prof = power[0, bins[0]].cpu().numpy()
    pk, _ = tp.find_peaks(prof, height=0.1 * prof.max(), distance=RADAR_PULSE // 8)
    planted_cells = [t[0] for t in RADAR_TARGETS if RADAR_PULSES // 2 + t[1] == bins[0]]
    log(f"find_peaks on the range profile of Doppler bin {bins[0] - RADAR_PULSES // 2:+d}: {pk}")
    require(set(planted_cells) <= set(pk.tolist()), f"range peaks {pk} miss {planted_cells}")

    if ON_CARD:
        rxt, txt = cuda_complex(rx), cuda_complex(tx)
        with torch.no_grad():
            front_end_row(rows, "range_doppler 16 x 128 x 8192", lambda: tp.range_doppler(
                rxt, txt, window="hamming"), 3, rd_err)
            front_end_row(rows, "cfar ca 2-D 16 x 128 x 7681", lambda: tp.cfar(
                power, t_, g_, pfa, axes=(-2, -1)), 3, cfar_err)
            front_end_row(rows, "cfar os 1-D 128 x 7681", lambda: tp.cfar(
                power[0], t_, g_, pfa, "os"), 3, os_err)
            front_end_row(rows, "spatial_covariance + mvdr_spectrum, 181 angles", lambda: tp.mvdr_spectrum(
                tp.spatial_covariance(snaps), RADAR_CHANNELS, grid), 3, mv_err, capture=False)
        del rxt, txt
    del rx, rd, power, snaps, R

    # the channelizer: 2 polarizations x 2^25 samples, tones plus noise
    K, P = PFB["n_channels"], PFB["taps_per_branch"]
    x = rng.standard_normal((PFB_POLS, PFB_SAMPLES), dtype=np.float32) * np.float32(0.1)
    tt = np.arange(PFB_SAMPLES)
    for pol, f in enumerate((1000.0 / K, 2345.5 / K)):   # a channel centre, a channel edge
        x[pol] += np.cos(2.0 * np.pi * f * tt).astype(np.float32)
    del tt
    y = run("pfb_analysis", tp.pfb_analysis, x, **PFB)
    frames = (PFB_SAMPLES - P * K) // K + 1
    require(tuple(y.shape) == (PFB_POLS, frames, K), f"pfb_analysis {tuple(y.shape)}")
    h = np.sinc((np.arange(P * K) - (P * K - 1) / 2.0) / K) * scipy.signal.get_window(
        "hamming", P * K, fftbins=True)
    h /= h.sum()
    pick = np.sort(rng.choice(frames, PFB_ORACLE_FRAMES, replace=False))
    idx = pick[:, None] * K + np.arange(P * K)[None, :]
    v = (x[:, idx].astype(np.float64) * h).reshape(PFB_POLS, PFB_ORACLE_FRAMES, P, K).sum(-2)
    want = np.fft.fft(v, axis=-1)
    pfb_err = rel_err(y[:, pick].cpu().numpy(), want)
    check(f"pfb_analysis K={K}, P={P}, {PFB_POLS} x 2^25 samples -> {tuple(y.shape)} "
          f"({PFB_ORACLE_FRAMES} frames vs float64)", y[:, pick], want)
    del v, want, idx
    cut = x[:, :PFB_CUT]
    yf = run("pfb_analysis full", tp.pfb_analysis, cut, mode="full", **PFB)
    back = run("pfb_synthesis", tp.pfb_synthesis, yf, P, PFB["window"])
    rt64 = pfb_round_trip64(cut, h, K, P)
    syn_err = rel_err(back.cpu().numpy(), rt64)
    check(f"pfb analysis (full) and pfb_synthesis of the 2^20-sample cut, {tuple(yf.shape)} "
          "frames, against the same two steps in float64", back, rt64)
    log(f"pfb round trip against the cut itself: {rel_err(back[:, :PFB_CUT].real.cpu().numpy(), cut):.3e} "
        f"(float64's own: {rel_err(rt64[:, :PFB_CUT].real, cut):.3e}; the Tikhonov floor eps = 1e-8 "
        "biases the branch inverses where a tone sits at a channel edge)")
    worst.append(kernel_errors(ops.seen, "pfb planes"))
    ops.seen.clear()
    if ON_CARD:
        xt, yft = cuda32(x), yf
        with torch.no_grad():
            front_end_row(rows, "pfb_analysis 4096 ch x 4 taps, 2 x 2^25", lambda: tp.pfb_analysis(
                xt, **PFB), 3, pfb_err)
            front_end_row(rows, f"pfb_synthesis {tuple(yf.shape)}", lambda: tp.pfb_synthesis(
                yft, P, PFB["window"]), 3, syn_err)
        del xt, yft
    del x, y, yf, back, cut
    torch.cuda.empty_cache()

    # line spectra: MUSIC, root-MUSIC and ESPRIT at m = 64, p = 4
    k = np.arange(SUBSPACE_N)
    for s in range(SUBSPACE_SIGNALS):
        f0 = np.sort(rng.uniform(-0.45, 0.45 - 0.06, 1))[0] + np.array([0.0, 0.02, 0.04, 0.06])
        sig = np.exp(2j * np.pi * f0[:, None] * k[None, :]).sum(0) + 0.1 * (
            rng.standard_normal(SUBSPACE_N) + 1j * rng.standard_normal(SUBSPACE_N))
        sig = sig.astype(np.complex64)
        f, Pm = tp.music(sig, SUBSPACE_P, m=SUBSPACE_M, nfreq=4096)
        got = {"music": top_angles(f, Pm, SUBSPACE_P),
               "root_music": tp.root_music(sig, SUBSPACE_P, m=SUBSPACE_M),
               "esprit": tp.esprit(sig, SUBSPACE_P, m=SUBSPACE_M)}
        for name, est in got.items():
            tol = 0.5 / 4096 + 1e-4 if name == "music" else 1e-3
            require(np.allclose(est, f0, atol=tol), f"{name} found {est}, planted {f0}")
        if s == 0:
            log(f"subspace, {SUBSPACE_SIGNALS} records of {SUBSPACE_N}: planted {f0}; " + ", ".join(
                f"{k_} {np.round(v_, 5)}" for k_, v_ in got.items()))
    snaps64 = np.lib.stride_tricks.sliding_window_view(sig.astype(np.complex128), SUBSPACE_M)
    Rs = snaps64.T @ snaps64.conj() / snaps64.shape[0]
    J = np.eye(SUBSPACE_M)[::-1]
    corr_err = rel_err(tp.corr_matrix(sig, SUBSPACE_M), 0.5 * (Rs + J @ Rs.conj() @ J))
    log(f"corr_matrix m={SUBSPACE_M} on {SUBSPACE_N}: rel err {corr_err:.3e} vs float64")
    require(corr_err <= ORACLE_TOL, "corr_matrix against float64")
    if ON_CARD:
        sig_t = cuda_complex(sig)
        front_end_row(rows, "corr_matrix m=64 on 4096 (to the host)", lambda: tp.corr_matrix(
            sig_t, SUBSPACE_M), 5, corr_err, capture=False)

    launches = sum(ops.used.values())
    log("radar and radio kernel launches: " + ", ".join(f"{k} {v}" for k, v in ops.used.items()))
    expected = {"range_doppler": 4, "cfar ca 2-D": 0, "cfar os 1-D": 0, "spatial_covariance": 0,
                "mvdr_spectrum": 0, "pfb_analysis": 1, "pfb_analysis full": 1, "pfb_synthesis": 1}
    require(ops.used == expected or not ON_CARD, f"kernel launches {ops.used}, expected {expected}")
    log(json.dumps({"radar_radio_timing": {"card": card, "calls": rows}}))
    return launches, max(worst)


def periodized_dwt64(x: np.ndarray, filt: np.ndarray):
    """float64 periodized analysis along the last axis:
    out[c, k] = Σ_f filt[c, f]·x[(2k + f) mod N]."""
    n = x.shape[-1]
    idx = (2 * np.arange(n // 2)[:, None] + np.arange(filt.shape[-1])[None, :]) % n
    w = x.astype(np.float64)[..., idx]
    return w @ filt[0], w @ filt[1]


def wavedec64(x: np.ndarray, filt: np.ndarray, levels: int) -> list:
    out, a = [], x
    for _ in range(levels):
        a, d = periodized_dwt64(a, filt)
        out.append(d)
    return [a] + out[::-1]


def dwt2_64(x: np.ndarray, filt: np.ndarray):
    lo, hi = periodized_dwt64(x, filt)
    (ll, lh), (hl, hh) = (tuple(np.swapaxes(v, -1, -2) for v in periodized_dwt64(np.swapaxes(b, -1, -2), filt))
                          for b in (lo, hi))
    return ll, (lh, hl, hh)


def adaptive64(kind: str, x: np.ndarray, d: np.ndarray, m: int, **kw):
    """The adaptive recursions in float64 numpy: (y, w)."""
    x, d = x.astype(np.float64), d.astype(np.float64)
    U = np.lib.stride_tricks.sliding_window_view(np.concatenate([np.zeros(m - 1), x]), m)[:, ::-1]
    w, P, ys = np.zeros(m), 100.0 * np.eye(m), np.empty(len(x))
    for i, (u, dk) in enumerate(zip(U, d)):
        ys[i] = u @ w
        e = dk - ys[i]
        if kind == "lms_filter":
            w = w + kw["mu"] * e * u
        elif kind == "nlms_filter":
            w = w + kw["mu"] / (u @ u + 1e-6) * e * u
        else:
            Pu = P @ u
            g = Pu / (kw["lam"] + u @ Pu)
            w = w + g * e
            P = (P - np.outer(g, Pu)) / kw["lam"]
    return ys, w


def vmd64(x: np.ndarray, K: int, alpha: float, n_iter: int, omega0: np.ndarray):
    """VMD's ADMM (tau = 0) in float64 numpy, from pinned frequencies."""
    T0 = x.shape[-1]
    half = T0 // 2
    xm = np.concatenate([x[..., :half][..., ::-1], x, x[..., T0 - half:][..., ::-1]], -1)
    T = xm.shape[-1]
    pos = (np.arange(T) <= T // 2).astype(np.float64)
    w = np.abs(np.fft.fftfreq(T))
    f_pos = np.fft.fft(xm.astype(np.float64)) * pos
    u = np.zeros(x.shape[:-1] + (K, T), complex)
    om = np.broadcast_to(omega0, x.shape[:-1] + (K,)).copy()
    for _ in range(n_iter):
        sum_u = u.sum(-2)
        for k in range(K):
            sum_u = sum_u - u[..., k, :]
            u[..., k, :] = (f_pos - sum_u) / (1 + 2 * alpha * (w - om[..., k, None]) ** 2) * pos
            p = np.abs(u[..., k, :]) ** 2
            om[..., k] = (w * p).sum(-1) / (p.sum(-1) + 1e-30)
            sum_u = sum_u + u[..., k, :]
    full = u + np.conj(np.flip(np.roll(u, -1, -1), -1))
    full[..., 0] = u[..., 0].real
    full[..., T // 2] = u[..., T // 2].real
    modes = np.fft.ifft(full).real[..., half: half + T0]
    order = np.argsort(om, -1)
    return np.take_along_axis(modes, order[..., None], -2), np.take_along_axis(om, order, -1)


def wavelets_leaves(rng, card: str):
    """Phase 24: the wavelet transforms at full width and the other ops
    leaves from numpy input without a device, against float64 numpy/scipy
    oracles written out here (sampled rows where the whole would take
    long), with the kernel's launches, device and back-to-back times, idle
    shares and peak memory.  Returns the launches and the kernel's worst
    abs error."""
    from mixed_radix_fast_fourier_transform_tpu_torch.ops import dtcwt as dtcwt_ops
    from mixed_radix_fast_fourier_transform_tpu_torch.ops import dwt as dwt_ops

    ops = Ops()
    run, check = ops.run, ops.check
    cuda_fft.LAUNCHES = 0
    rows, worst, errs = [], [], {}

    # db4, 5 levels, periodization, on Whisper's clips
    sr = WHISPER["sr"]
    t = np.arange(WHISPER_SAMPLES) / sr
    # tones under 500 Hz: in the approximation band that the denoiser keeps
    clean = np.sin(2 * np.pi * rng.uniform(100.0, 400.0, (WHISPER_BATCH, 1)) * t)
    clips = (clean + 0.3 * rng.standard_normal((WHISPER_BATCH, WHISPER_SAMPLES))).astype(np.float32)
    lo, hi = dwt_ops._banks("db4")[:2]
    filt = np.stack([lo, hi])
    coeffs = run("wavedec", tp.wavedec, clips, "db4", DWT_LEVELS)
    want = wavedec64(clips[:2], filt, DWT_LEVELS)
    errs["wavedec"] = max(rel_err(c[:2].cpu().numpy(), w) for c, w in zip(coeffs, want))
    log(f"wavedec db4 {DWT_LEVELS} levels {clips.shape}: coefficients (2 clips) rel err "
        f"{errs['wavedec']:.3e} vs float64")
    require(errs["wavedec"] <= ORACLE_TOL, "wavedec coefficients")
    rec = run("waverec", tp.waverec, coeffs, "db4")
    errs["waverec"] = rel_err(rec.cpu().numpy(), clips)
    check("waverec: perfect reconstruction of the clips", rec, clips)
    den = run("wavelet_denoise", tp.wavelet_denoise, clips)
    snr_in = 10 * np.log10(np.mean(clean ** 2) / np.mean((clips - clean) ** 2))
    snr_out = 10 * np.log10(np.mean(clean ** 2) / np.mean((den.cpu().numpy() - clean) ** 2))
    log(f"wavelet_denoise db4 (universal, soft, symmetric) on the clips: SNR {snr_in:.2f} -> "
        f"{snr_out:.2f} dB")
    require(np.isfinite(snr_out) and snr_out > snr_in + 3.0, "wavelet_denoise did not denoise")
    del want, rec, den

    # bior4.4 (JPEG 2000's 9/7), 5 levels, on 4 x 2048² images
    yy, xx = np.mgrid[:DWT2_N, :DWT2_N] / DWT2_N
    images = np.stack([np.sin(2 * np.pi * (3 + i) * xx) * np.cos(2 * np.pi * (2 + i) * yy)
                       + 0.1 * rng.standard_normal((DWT2_N, DWT2_N)) for i in range(DWT2_IMAGES)])
    images = images.astype(np.float32)
    del yy, xx
    b_lo, b_hi = dwt_ops._banks("bior4.4")[:2]
    c2 = run("wavedec2", tp.wavedec2, images, "bior4.4", DWT2_LEVELS)
    a64, bands64 = dwt2_64(images[0], np.stack([b_lo, b_hi]))
    errs["wavedec2"] = max(rel_err(c2[-1][i][0].cpu().numpy(), bands64[i]) for i in range(3))
    log(f"wavedec2 bior4.4 {DWT2_LEVELS} levels {images.shape}: finest level (image 0) rel err "
        f"{errs['wavedec2']:.3e} vs float64")
    require(errs["wavedec2"] <= ORACLE_TOL, "wavedec2 coefficients")
    rec2 = run("waverec2", tp.waverec2, c2, "bior4.4")
    errs["waverec2"] = rel_err(rec2.cpu().numpy(), images)
    check("waverec2: perfect reconstruction of the images", rec2, images)
    del a64, bands64, rec2

    # the stationary transform, db2, 4 levels, on 16 x 65,536
    sx = rng.standard_normal(SWT_SHAPE).astype(np.float32)
    st = run("swt", tp.swt, sx, "db2", SWT_LEVELS)
    d_lo, d_hi = dwt_ops._banks("db2")[:2]
    a = sx[:2].astype(np.float64)
    n = SWT_SHAPE[1]
    e_swt = 0.0
    for j in range(SWT_LEVELS):
        idx = (np.arange(n)[:, None] + (1 << j) * np.arange(len(d_lo))[None, :]) % n
        win = a[..., idx]
        a, d = win @ d_lo, win @ d_hi
        got_a, got_d = st[SWT_LEVELS - 1 - j]
        e_swt = max(e_swt, rel_err(got_a[:2].cpu().numpy(), a), rel_err(got_d[:2].cpu().numpy(), d))
    errs["swt"] = e_swt
    log(f"swt db2 {SWT_LEVELS} levels {SWT_SHAPE}: rel err {e_swt:.3e} vs float64 (2 rows)")
    require(e_swt <= ORACLE_TOL, "swt coefficients")
    back = tp.iswt(st, "db2")
    check("iswt: perfect reconstruction", back, sx)

    # the dual tree, 4 levels, on 4 x 512²
    dimg = images[:, :DTCWT_N, :DTCWT_N].copy()
    yl, yh = run("dtcwt2", tp.dtcwt2, dimg, DTCWT_LEVELS)
    bank = dtcwt_ops._dt_bank(3, 3)
    # level 1 of tree aa is a plain DWT: along axis -2, then the lowpass
    # band along axis -1 gives LH; Re(z+ + z-) = t_aa
    lo_r, _ = periodized_dwt64(np.swapaxes(dimg[0], -1, -2), bank.dec_a)
    _, lh = periodized_dwt64(np.swapaxes(lo_r, -1, -2), bank.dec_a)
    aa_lh = (yh[0][0, 0] + yh[0][1, 0]).real
    errs["dtcwt2"] = rel_err(aa_lh.cpu().numpy(), lh)
    log(f"dtcwt2 {DTCWT_LEVELS} levels {dimg.shape}: level-1 tree aa LH rel err "
        f"{errs['dtcwt2']:.3e} vs float64")
    require(errs["dtcwt2"] <= ORACLE_TOL, "dtcwt2 coefficients")
    drec = run("idtcwt2", tp.idtcwt2, yl, yh)
    errs["idtcwt2"] = rel_err(drec.cpu().numpy(), dimg)
    check("idtcwt2: perfect reconstruction", drec, dimg)

    if ON_CARD:
        ct, it, st_t, dt = cuda32(clips), cuda32(images), cuda32(sx), cuda32(dimg)
        cfs, c2s = tp.wavedec(ct, "db4", DWT_LEVELS), tp.wavedec2(it, "bior4.4", DWT2_LEVELS)
        d_yl, d_yh = tp.dtcwt2(dt, DTCWT_LEVELS)
        with torch.no_grad():
            front_end_row(rows, "wavedec db4 5 levels 16 x 480000", lambda: tp.wavedec(
                ct, "db4", DWT_LEVELS), 5, errs["wavedec"])
            front_end_row(rows, "waverec db4 5 levels", lambda: tp.waverec(cfs, "db4"), 5,
                          errs["waverec"])
            front_end_row(rows, "wavedec2 bior4.4 5 levels 4 x 2048²", lambda: tp.wavedec2(
                it, "bior4.4", DWT2_LEVELS), 3, errs["wavedec2"])
            front_end_row(rows, "waverec2 bior4.4 5 levels", lambda: tp.waverec2(c2s, "bior4.4"), 3,
                          errs["waverec2"])
            front_end_row(rows, "swt db2 4 levels 16 x 65536", lambda: tp.swt(st_t, "db2", SWT_LEVELS),
                          5, errs["swt"])
            front_end_row(rows, "dtcwt2 4 levels 4 x 512²", lambda: tp.dtcwt2(dt, DTCWT_LEVELS), 5,
                          errs["dtcwt2"])
            front_end_row(rows, "idtcwt2 4 levels", lambda: tp.idtcwt2(d_yl, d_yh), 5, errs["idtcwt2"])
            front_end_row(rows, "wavelet_denoise db4 16 x 480000", lambda: tp.wavelet_denoise(ct), 3,
                          None)
        del ct, it, st_t, dt, cfs, c2s, d_yl, d_yh
    del coeffs, c2, st, back, yl, yh, drec
    torch.cuda.empty_cache()

    # EWT, 5 bands, boundaries detected on the first row
    k = np.arange(EWT_SHAPE[1])
    ex = sum(np.sin(2 * np.pi * f * k) for f in (0.02, 0.07, 0.15, 0.27, 0.41))
    ex = (ex[None] + 0.05 * rng.standard_normal(EWT_SHAPE)).astype(np.float32)
    bounds = tp.ewt_boundaries(ex[0], EWT_BANDS)
    bands, _ = run("ewt", tp.ewt, ex, boundaries=bounds)
    X = np.fft.rfft(ex[:2].astype(np.float64))
    bank64 = tp.ops.ewt._partition_bank(X.shape[-1], bounds, 0.2, EWT_SHAPE[1])
    want = np.fft.irfft(X[:, None, :] * bank64, n=EWT_SHAPE[1])
    errs["ewt"] = rel_err(bands[:2].cpu().numpy(), want)
    check(f"ewt {EWT_BANDS} bands {EWT_SHAPE} (2 rows vs float64)", bands[:2], want)
    check("ewt: the bands sum to the signal", bands.sum(-2), ex)
    del bands, X, want

    # EMD on the host, Hilbert-Huang's analytic signal on the card
    kk = np.arange(EMD_N)
    tone = np.sin(2 * np.pi * 0.01 * kk) + 0.5 * np.sin(2 * np.pi * 0.13 * kk)
    imfs, amp, freq = run("hilbert_huang", tp.hilbert_huang, tone)
    analytic = scipy.signal.hilbert(imfs)
    errs["hilbert_huang"] = rel_err(amp.cpu().numpy(), np.abs(analytic))
    check(f"hilbert_huang amplitude ({imfs.shape[0]} rows of {EMD_N}) vs float64", amp,
          np.abs(analytic))
    log(f"emd: {imfs.shape[0] - 1} IMFs; mean instantaneous frequency of the first two "
        f"{np.round(freq[:2, EMD_N // 10: -EMD_N // 10].mean(-1).cpu().numpy(), 5)} "
        "(planted 0.13, 0.01)")
    imfs_t = cuda32(imfs)

    # VMD, K = 4, 300 sweeps, pinned centre frequencies
    kk = np.arange(VMD_SHAPE[1])
    planted = np.array([0.03, 0.11, 0.2, 0.34])
    vx = sum(np.cos(2 * np.pi * f * kk + rng.uniform(0, 6.28, (VMD_SHAPE[0], 1))) for f in planted)
    vx = (vx + 0.05 * rng.standard_normal(VMD_SHAPE)).astype(np.float32)
    omega0 = planted + np.array([0.005, -0.005, 0.005, -0.005])
    modes, om = run("vmd", tp.vmd, vx, VMD_K, n_iter=VMD_ITERS, init_omega=omega0)
    m64, o64 = vmd64(vx[:2], VMD_K, 2000.0, VMD_ITERS, omega0)
    errs["vmd"] = rel_err(modes[:2].cpu().numpy(), m64)
    log(f"vmd K={VMD_K}, {VMD_ITERS} sweeps {VMD_SHAPE}: modes rel err {errs['vmd']:.3e} "
        f"(2 rows vs float64), centre frequencies {np.round(om[0].cpu().numpy(), 5)}")
    require(errs["vmd"] <= VMD_TOL and np.allclose(om[:2].cpu().numpy(), o64, atol=1e-5),
            "vmd against float64")

    # registration: 16 sub-pixel shifts of one 1,024² scene, to 1/100 pixel
    scene = scipy.ndimage.gaussian_filter(rng.standard_normal((REG_N, REG_N)), 3.0)
    S = np.fft.fft2(scene)
    shifts = np.round(rng.uniform(-20.0, 20.0, (REG_PAIRS, 2)), 2)
    fr, fc = np.fft.fftfreq(REG_N)[:, None], np.fft.fftfreq(REG_N)[None, :]
    moving = np.stack([np.fft.ifft2(S * np.exp(-2j * np.pi * (s[0] * fr + s[1] * fc))).real
                       for s in shifts]).astype(np.float32)
    ref = np.broadcast_to(scene.astype(np.float32), moving.shape).copy()
    del S
    found, rerr = run("phase_cross_correlation", tp.phase_cross_correlation, ref, moving, REG_UP)
    miss = float(np.max(np.abs(found.cpu().numpy() + shifts)))
    errs["phase_cross_correlation"] = miss
    log(f"phase_cross_correlation {REG_PAIRS} pairs of {REG_N}², upsample {REG_UP}: worst shift "
        f"error {miss:.4f} px, error metric {float(rerr.max()):.3e}")
    require(miss <= 1.0 / REG_UP + 1e-4, "registration missed the planted shifts")
    # unwrapping a smooth phase field with gradients under π a pixel
    yy, xx = np.mgrid[:UNWRAP_N, :UNWRAP_N] / UNWRAP_N
    field = 60.0 * np.exp(-((xx - 0.4) ** 2 + (yy - 0.6) ** 2) / 0.1) + 40.0 * xx * yy
    wrapped = np.angle(np.exp(1j * field)).astype(np.float32)
    un = run("unwrap_phase_2d", tp.unwrap_phase_2d, wrapped)
    errs["unwrap_phase_2d"] = rel_err(un.cpu().numpy(), field - field.mean())
    check(f"unwrap_phase_2d {UNWRAP_N}²", un, field - field.mean(), UNWRAP_TOL)
    del yy, xx, field
    spec = np.fft.fft2(images[0].astype(np.float64)).astype(np.complex64)
    fg = run("fourier_gaussian", tp.fourier_gaussian, spec, 3.0)
    want = scipy.ndimage.fourier_gaussian(spec.astype(np.complex128), 3.0)
    errs["fourier_gaussian"] = rel_err(fg.cpu().numpy(), want)
    check(f"fourier_gaussian {GAUSS_N}² spectrum", fg, want)
    mf = run("medfilt2d", tp.medfilt2d, images[0], 3)
    require(np.array_equal(mf.cpu().numpy(), scipy.signal.medfilt2d(images[0], 3)),
            "medfilt2d differs from scipy")
    mc = run("medfilt", tp.medfilt, clips, [1, 5])
    require(np.array_equal(mc[:2].cpu().numpy(), scipy.signal.medfilt(clips[:2], [1, 5])),
            "medfilt differs from scipy")
    log("medfilt2d 3x3 on a 2048² image and medfilt 5 on the clips: equal to scipy")
    errs["medfilt2d"] = errs["medfilt"] = 0.0

    # adaptive echo cancellation: 256 taps, 8,000 samples
    far = rng.standard_normal(ADAPT_N).astype(np.float32)
    path = rng.standard_normal(ADAPT_TAPS) * np.exp(-np.arange(ADAPT_TAPS) / 40.0)
    path /= np.abs(path).max()
    mic = (np.convolve(far, path)[:ADAPT_N] + 1e-3 * rng.standard_normal(ADAPT_N)).astype(np.float32)
    adaptive = (("lms_filter", {"mu": 0.002}), ("nlms_filter", {"mu": 0.5}), ("rls_filter", {"lam": 0.9999}))
    for name, kw in adaptive:
        y_, e_, w_ = run(name, getattr(tp, name), far, mic, ADAPT_TAPS, **kw)
        y64, w64 = adaptive64(name, far, mic, ADAPT_TAPS, **kw)
        err = max(float(np.max(np.abs(y_.cpu().numpy() - y64)) / np.max(np.abs(mic))),
                  float(np.max(np.abs(w_.cpu().numpy() - w64)) / np.max(np.abs(path))))
        errs[name] = err
        erle = 10 * np.log10(np.mean(mic[-1000:] ** 2) / np.mean(e_[-1000:].cpu().numpy() ** 2))
        log(f"{name} {ADAPT_TAPS} taps, {ADAPT_N} samples: y and w rel err {err:.3e} vs the "
            f"float64 loop, echo return loss enhancement over the last 1000 samples {erle:.1f} dB")
        require(err <= ORACLE_TOL, f"{name} against float64")

    # AR fits on the host, the model spectrum on the card
    poles = [0.95 * np.exp(0.3j), 0.95 * np.exp(-0.3j), 0.9 * np.exp(1.2j), 0.9 * np.exp(-1.2j)]
    ar = scipy.signal.lfilter([1.0], np.poly(poles).real, rng.standard_normal(AR_N))
    for fit in (tp.aryule, tp.arburg):
        a_, s2, _ = fit(ar, AR_ORDER)
        f_, P_ = run(f"ar_psd ({fit.__name__})", tp.ar_psd, a_, s2, AR_NFREQ)
        z = np.exp(-2j * np.pi * np.linspace(0.0, 0.5, AR_NFREQ)[None, :] * np.arange(AR_ORDER + 1)[:, None])
        P64 = s2 / np.abs(a_ @ z) ** 2
        P64[1:-1] *= 2.0
        pt_err = float(np.max(np.abs(P_.cpu().numpy() / P64 - 1.0)))
        errs["ar_psd"] = max(errs.get("ar_psd", 0.0), pt_err)
        log(f"{fit.__name__} order {AR_ORDER} on {AR_N} samples, ar_psd {AR_NFREQ}: worst "
            f"pointwise rel err {pt_err:.3e} vs float64")
        require(pt_err <= ORACLE_TOL, "ar_psd against float64")
    a_t = cuda32(a_)

    # SSA and DMD: host float64 by design
    t0 = time.perf_counter()
    kk = np.arange(SSA_N)
    series = 0.001 * kk + np.sin(2 * np.pi * kk / 50.0) + 0.1 * rng.standard_normal(SSA_N)
    comps, sv = tp.ssa(series, SSA_WINDOW)
    require(np.allclose(comps.sum(0), series, atol=1e-10), "ssa components do not add up")
    snap_t = np.arange(DMD_SHAPE[1]) * 0.1
    basis = rng.standard_normal((DMD_SHAPE[0], 3))
    Xd = (basis[:, :1] * np.cos(2.0 * snap_t) + basis[:, 1:2] * np.sin(2.0 * snap_t)
          + basis[:, 2:] * np.exp(-0.2 * snap_t)) + 1e-6 * rng.standard_normal(DMD_SHAPE)
    modes_d, eigs, amps, _ = tp.dmd(Xd, 3, dt=0.1)
    rec_d = tp.dmd_reconstruct(modes_d, eigs, amps, DMD_SHAPE[1]).real
    dmd_err = rel_err(rec_d, Xd)
    log(f"ssa window {SSA_WINDOW} on {SSA_N} and dmd rank 3 on {DMD_SHAPE} (host float64): "
        f"{time.perf_counter() - t0:.2f} s, dmd reconstruction rel err {dmd_err:.3e}")
    require(dmd_err <= 1e-4, "dmd reconstruction")

    worst.append(kernel_errors(ops.seen, "leaves planes"))
    ops.seen.clear()
    if ON_CARD:
        et, vt, rt, mt = cuda32(ex), cuda32(vx), cuda32(ref), cuda32(moving)
        wt, st2 = cuda32(wrapped), cuda_complex(spec)
        i0, ct = cuda32(images[0]), cuda32(clips)
        ft, mict = cuda32(far), cuda32(mic)
        with torch.no_grad():
            front_end_row(rows, "ewt 5 bands 16 x 65536", lambda: tp.ewt(et, boundaries=bounds), 5,
                          errs["ewt"])
            front_end_row(rows, f"hilbert of the {imfs.shape[0]} x {EMD_N} IMF stack", lambda: tp.hilbert(
                imfs_t), 5, errs["hilbert_huang"])
            front_end_row(rows, "vmd K=4, 300 sweeps, 8 x 4096", lambda: tp.vmd(
                vt, VMD_K, n_iter=VMD_ITERS, init_omega=omega0), 1, errs["vmd"])
            front_end_row(rows, "phase_cross_correlation 16 x 1024², upsample 100", lambda: (
                tp.phase_cross_correlation(rt, mt, REG_UP)), 3, errs["phase_cross_correlation"])
            front_end_row(rows, "unwrap_phase_2d 1024² (dctn/idctn, stage pipeline)", lambda: (
                tp.unwrap_phase_2d(wt)), 3, errs["unwrap_phase_2d"])
            front_end_row(rows, "fourier_gaussian 2048²", lambda: tp.fourier_gaussian(st2, 3.0), 5,
                          errs["fourier_gaussian"])
            front_end_row(rows, "medfilt2d 3x3 2048²", lambda: tp.medfilt2d(i0, 3), 5, 0.0)
            front_end_row(rows, "medfilt 5 on 16 x 480000", lambda: tp.medfilt(ct, [1, 5]), 3, 0.0)
            for name, kw in adaptive:
                front_end_row(rows, f"{name} 256 taps, 8000 samples", lambda: getattr(tp, name)(
                    ft, mict, ADAPT_TAPS, **kw), 1, errs[name])
            front_end_row(rows, "ar_psd order 16, 512 frequencies", lambda: tp.ar_psd(a_t, 1.0, AR_NFREQ),
                          5, errs["ar_psd"])
        del et, vt, rt, mt, wt, st2, i0, ct, ft, mict
    del images, clips, imfs_t
    torch.cuda.empty_cache()

    launches = sum(ops.used.values())
    log("wavelet and leaves kernel launches: " + ", ".join(f"{k} {v}" for k, v in ops.used.items()))
    k1_paths = {"hilbert_huang": 2, "vmd": 2, "phase_cross_correlation": 6}
    require(all(ops.used[k] == v for k, v in k1_paths.items()) or not ON_CARD,
            f"kernel launches {ops.used}, expected {k1_paths} on these paths")
    log(json.dumps({"leaves_timing": {"card": card, "calls": rows}}))
    return launches, max(worst)


def slice_yardstick(card: str) -> None:
    """K1 against ``torch.fft.fft`` (cuFFT) at the shapes phases 19-23 hand
    the kernel (CQT, NUFFT, SFNO, range-Doppler, PFB), by graph replay in
    one process, beside the bytes bound."""
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for n, b in SLICE_YARDSTICK:
        xr, xi = (torch.randn(b, n, device="cuda", generator=gen) for _ in range(2))
        xc = torch.complex(xr, xi)
        kernel_us = 1e6 * graph_time(lambda: cuda_fft.exec_kernel(xr, xi, n, -1))
        cufft_us = 1e6 * graph_time(lambda: torch.fft.fft(xc))
        bound, bound_by = fft_bound_ms(n, b)
        row = {"n": n, "rows": b, "kernel_us": kernel_us, "cufft_us": cufft_us,
               "bound_us": bound * 1e3, "bound_by": bound_by,
               "share_of_bound": bound * 1e3 / kernel_us, "kernel_over_cufft": kernel_us / cufft_us}
        rows.append(row)
        log(f"yardstick n={n} x {b} rows: kernel {kernel_us:.2f} us, cuFFT {cufft_us:.2f} us, "
            f"bound {bound * 1e3:.2f} us ({bound_by}), share {row['share_of_bound']:.3f}, "
            f"kernel/cuFFT {row['kernel_over_cufft']:.2f}")
        del xr, xi, xc
        torch.cuda.empty_cache()
    log(json.dumps({"k1_vs_cufft_slice_shapes": {"card": card, "method": "CUDA graph of 20 "
                    "back-to-back launches, 10 replays, CUDA events", "shapes": rows}}))


# ---------------------------------------------------------------------------
# Phases 25-26: parallel/ on a NCCL world of one (mesh (1, 1)).
# ---------------------------------------------------------------------------

# BASELINE.md config 5: 65,536-point FFT convolution, batch 4,096, sharded
# over the mesh by the four-step all-to-all transform.  2 GiB a live copy of
# the (re, im) fp32 planes.
PAR_N, PAR_BATCH = 65536, 4096
PAR_CONV_SIGNAL, PAR_CONV_TAPS = 65408, 129   # mode "same" pads to 65,536
PAR_STEPS = 5
# the filter learns a gain and a delay: target = 0.5·x delayed 3 samples.
# x has standard deviation √n, so |X_k|² ≈ n² / n = n and the Hessian of
# the loss in every gain entry and in the bias is ≈ 2: lr 0.25 halves the
# error a step
PAR_SCALE, PAR_LR, PAR_DELAY = float(PAR_N) ** 0.5, 0.25, 3
PAR_ORACLE_ROWS = (0, PAR_BATCH // 2 - 1, PAR_BATCH - 1)
PAR_FNET_BATCH = 8                   # FNet-Base: sequence 512, hidden 768, 12 layers
PAR_RFFT_SHAPE = (64, PAR_N)
PAR_KERNEL_ROWS = 4096               # rows of each recorded plane pair held against the plain K1
PENCIL_N, PENCIL2D_N = 256, 2048
PAR_KALMAN_TRACKS = 4
EXPORT_SHAPE = (64, 4096)


def world_of_one():
    """Joins a NCCL world of one through the port's own entry point and
    builds the (1, 1) mesh on the card; raises if NCCL does not start."""
    import torch.distributed as dist

    rank, world = parallel.initialize_multihost(device=CARD)
    require((rank, world) == (0, 1), f"world {rank}/{world}, expected a world of one")
    require(dist.get_backend() == ("nccl" if CARD == "cuda" else "gloo"),
            f"backend {dist.get_backend()} on {CARD}")
    mesh = parallel.make_mesh((1, 1), device=CARD)
    require(mesh.device_type == CARD, f"mesh on {mesh.device_type}")
    return mesh


def end_world() -> None:
    import torch.distributed as dist

    dist.destroy_process_group()


def local(x) -> torch.Tensor:
    """A DTensor's block on this rank (the whole array in a world of one)."""
    return x.to_local() if hasattr(x, "to_local") else x


def sampled(seen, rows: int = PAR_KERNEL_ROWS):
    """The first ``rows`` rows of every recorded plane pair."""
    return [(xr.reshape(-1, n)[:rows].contiguous(), xi.reshape(-1, n)[:rows].contiguous(), n,
             sign) for xr, xi, n, sign in seen]


def filter_oracle64(params, x64: torch.Tensor) -> torch.Tensor:
    """The distributed filter in float64 on the CPU: Re(ifft(fft(x)·g)) + b."""
    g = torch.complex(params["gain_re"].double(), params["gain_im"].double()).cpu()
    return torch.fft.ifft(torch.fft.fft(x64) * g).real + params["bias"].double().cpu()


def parallel_main(rng, card: str):
    """Phase 25: the slice's main path at config 5 width on a NCCL world of
    one: the distributed complex filter's forward and five train steps, the
    sharded convolution, FNet-Base's sequence-parallel mix, forward and
    step, ``rfft_four_step`` and ``fft_batch_sharded``, each against float64
    or the port's single-device route; then their device times from a fresh
    process (see ``parallel_timings``).  Returns the launches and the
    kernel's worst abs error on the plane pairs it was handed."""
    from mixed_radix_fast_fourier_transform_tpu_torch.models import spectral_filter as sf
    from mixed_radix_fast_fourier_transform_tpu_torch.utils.profiling import require_four_step_hbm

    mesh = world_of_one()
    par = parallel
    est = require_four_step_hbm(PAR_N, PAR_BATCH, 1)
    log(f"require_four_step_hbm({PAR_N}, {PAR_BATCH}, 1): {est}")
    cuda_fft.LAUNCHES = 0
    launches, worst = {}, []

    def counted(name, fn, record=True):
        """``fn()`` with its K1 launches counted and, with ``record``, K1
        held against its plain version on the first rows of every plane
        pair it was handed (a record copies each pair: 2 GiB at config 5)."""
        before = cuda_fft.LAUNCHES
        with recorded_launches() if record else contextlib.nullcontext([]) as seen:
            out = fn()
            torch.cuda.synchronize()
        launches[name] = launches.get(name, 0) + cuda_fft.LAUNCHES - before
        worst.append(kernel_errors(sampled(seen), f"{name} planes") if seen else 0.0)
        return out

    # the distributed complex filter, n = 65,536, batch 4,096
    gen = torch.Generator(device=CARD).manual_seed(SEED)
    params = sf.init_params_complex(PAR_N, generator=gen, device=CARD)
    x = torch.randn(PAR_BATCH, PAR_N, device=CARD, generator=gen) * PAR_SCALE
    target = 0.5 * torch.roll(x, PAR_DELAY, dims=-1)
    rows = list(PAR_ORACLE_ROWS)
    x64 = x[rows].double().cpu()
    with torch.no_grad():
        y = counted("filter forward", lambda: sf.apply_distributed(params, x, mesh))
    require(tuple(y.shape) == (PAR_BATCH, PAR_N) and local(y).device.type == CARD,
            f"apply_distributed {tuple(y.shape)} on {local(y).device}")
    err = rel_err(local(y)[rows].cpu().numpy(), filter_oracle64(params, x64).numpy())
    log(f"apply_distributed {PAR_BATCH} x {PAR_N}: rel err {err:.3e} vs float64 on rows {rows}")
    require(err <= ORACLE_TOL, f"distributed filter forward error {err:.3e}")
    del y

    # one step's gradients on the oracle rows against float64 torch.fft
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    loss = sf.loss_distributed(leaves, x[rows], target[rows], mesh)
    grads = torch.autograd.grad(loss, [leaves[k] for k in sorted(leaves)])
    ref = {k: v.detach().double().cpu().requires_grad_(True) for k, v in params.items()}
    loss64 = torch.mean((filter_oracle64(ref, x64) - target[rows].double().cpu()) ** 2)
    want = torch.autograd.grad(loss64, [ref[k] for k in sorted(ref)])
    errs = [rel_err(g.cpu().numpy(), w.numpy()) for g, w in zip(grads, want)]
    err = max(errs + [abs(float(loss.detach()) - float(loss64.detach())) / float(loss64.detach())])
    log(f"loss_distributed gradients on rows {rows} ({', '.join(sorted(leaves))}): rel err "
        f"{', '.join(f'{e:.3e}' for e in errs)} vs float64 torch.fft")
    require(err <= ROUTES_TOL, f"distributed filter gradients error {err:.3e}")
    del leaves, loss, grads, ref, want

    _, gib = peak_gib(lambda: sf.train_step_distributed(params, x, target, mesh, lr=PAR_LR))
    log(f"train_step_distributed peak device memory {gib:.3f} GiB (estimate_four_step_hbm: "
        f"{est['total_gb']} GB at copies=6)")
    losses = []
    for step in range(PAR_STEPS):
        params, loss = counted("filter train step", lambda: sf.train_step_distributed(
            params, x, target, mesh, lr=PAR_LR), record=step == 0)
        losses.append(float(loss))
    log(f"train_step_distributed x {PAR_STEPS}: losses {losses}")
    require(all(math.isfinite(v) for v in losses) and all(
        b < a for a, b in zip(losses, losses[1:])), f"losses not finite and falling: {losses}")
    del x, target, x64, params

    # config 5: the sharded FFT convolution, 65,408 samples, 129 taps, "same"
    xs = torch.randn(PAR_BATCH, PAR_CONV_SIGNAL, device=CARD, generator=gen)
    taps = rng.standard_normal(PAR_CONV_TAPS)
    with torch.no_grad():
        out = counted("fft_convolve_sharded", lambda: par.fft_convolve_sharded(
            xs, taps, mesh, mode="same"))
    want = scipy.signal.fftconvolve(xs[rows].double().cpu().numpy(), taps[None], mode="same")
    err = rel_err(local(out)[rows].cpu().numpy(), want)
    log(f"fft_convolve_sharded {PAR_BATCH} x {PAR_CONV_SIGNAL}, {PAR_CONV_TAPS} taps, same: "
        f"rel err {err:.3e} vs scipy float64 on rows {rows}")
    require(tuple(out.shape) == tuple(xs.shape) and err <= ORACLE_TOL,
            f"fft_convolve_sharded {tuple(out.shape)} error {err:.3e}")
    del xs, out

    # FNet-Base, sequence parallel, against the port's single-device model
    fp = fnet.init_fnet(**FNET, generator=gen, device=CARD)
    xf = rng.standard_normal((PAR_FNET_BATCH, FNET_SEQ, FNET["hidden"])).astype(np.float32)
    tf = rng.standard_normal(xf.shape).astype(np.float32)
    with torch.no_grad():
        mix = counted("fnet mix", lambda: fnet.fourier_mix_distributed(xf, mesh))
        err = rel_err(local(mix).cpu().numpy(), fnet.fourier_mix(xf).cpu().numpy())
        log(f"fourier_mix_distributed {xf.shape}: rel err {err:.3e} vs fourier_mix")
        require(err <= ROUTES_TOL, f"fourier_mix_distributed error {err:.3e}")
        out = counted("fnet forward", lambda: fnet.apply_distributed(fp, xf, mesh))
        err = rel_err(local(out).cpu().numpy(), fnet.apply(fp, xf).cpu().numpy())
        log(f"FNet-Base apply_distributed: rel err {err:.3e} vs apply")
        require(err <= ROUTES_TOL, f"FNet apply_distributed error {err:.3e}")
    new, loss = counted("fnet train step", lambda: fnet.train_step_distributed(
        fp, xf, tf, mesh, lr=1e-3))
    ref_new, ref_loss = fnet.train_step(fp, xf, tf, lr=1e-3)
    errs = [abs(float(loss) - float(ref_loss)) / float(ref_loss)] + [
        rel_err(a.cpu().numpy(), b.cpu().numpy())
        for a, b in zip(tree_leaves(new), tree_leaves(ref_new))]
    log(f"FNet-Base train_step_distributed: loss {float(loss):.6f}, worst rel err over loss "
        f"and {len(errs) - 1} new leaves {max(errs):.3e} vs train_step")
    require(max(errs) <= ROUTES_TOL, f"FNet train_step_distributed error {max(errs):.3e}")
    del fp, new, ref_new, mix, out

    # the real four-step and the batch-sharded FFT at 65,536 x 64
    xr = rng.standard_normal(PAR_RFFT_SHAPE).astype(np.float32)
    with torch.no_grad():
        spec = counted("rfft_four_step", lambda: par.rfft_four_step(xr, mesh))
        few = [0, PAR_RFFT_SHAPE[0] - 1]
        err = rel_err(local(spec)[few].cpu().numpy(), np.fft.rfft(xr[few].astype(np.float64)))
        log(f"rfft_four_step {xr.shape}: rel err {err:.3e} vs float64 on rows {few}")
        require(err <= ORACLE_TOL, f"rfft_four_step error {err:.3e}")
        back = par.irfft_four_step(spec, mesh)
        err = rel_err(local(back).cpu().numpy(), xr)
        log(f"irfft_four_step round trip: rel err {err:.3e}")
        require(err <= ORACLE_TOL, f"irfft_four_step error {err:.3e}")
        xc = (xr + 1j * rng.standard_normal(xr.shape)).astype(np.complex64)
        out = counted("fft_batch_sharded", lambda: par.fft_batch_sharded(xc, mesh))
        err = rel_err(local(out)[few].cpu().numpy(), np.fft.fft(xc[few].astype(np.complex128)))
        log(f"fft_batch_sharded {xc.shape}: rel err {err:.3e} vs float64 on rows {few}")
        require(err <= ORACLE_TOL, f"fft_batch_sharded error {err:.3e}")
    del spec, back, out
    end_world()
    torch.cuda.empty_cache()

    total = sum(launches.values())
    log("parallel main path kernel launches: " + ", ".join(f"{k} {v}" for k, v in launches.items()))
    require(launches["filter forward"] == 4 and launches["fft_convolve_sharded"] == 4
            or not ON_CARD,
            f"kernel launches {launches}: the four-step's local transforms missed the kernel")
    # device times in a fresh process: late in a long run the profiler drops events
    done = subprocess.run([sys.executable, __file__, "parallel-timings"], capture_output=True,
                          text=True, timeout=600)
    sys.stdout.write(done.stdout)
    require(done.returncode == 0, f"parallel timings failed:\n{done.stderr[-3000:]}")
    return total, max(worst)


def parallel_timings(card: str) -> None:
    """Phase 25's device times, in a process of its own on a fresh NCCL
    world of one: per call the torch.profiler sum of device kernels (a NCCL
    exchange is not captured in a CUDA graph here), back-to-back time, idle
    share, K1's launches and share, the all-to-alls' device time, and peak
    memory beside ``estimate_four_step_hbm``."""
    from mixed_radix_fast_fourier_transform_tpu_torch.models import spectral_filter as sf
    from mixed_radix_fast_fourier_transform_tpu_torch.utils.profiling import estimate_four_step_hbm

    mesh = world_of_one()
    par = parallel
    gen = torch.Generator(device=CARD).manual_seed(SEED)
    params = sf.init_params_complex(PAR_N, generator=gen, device=CARD)
    x = torch.randn(PAR_BATCH, PAR_N, device=CARD, generator=gen) * PAR_SCALE
    target = 0.5 * torch.roll(x, PAR_DELAY, dims=-1)
    xs = torch.randn(PAR_BATCH, PAR_CONV_SIGNAL, device=CARD, generator=gen)
    taps = np.random.default_rng(SEED).standard_normal(PAR_CONV_TAPS)
    fp = fnet.init_fnet(**FNET, generator=gen, device=CARD)
    xf = torch.randn(PAR_FNET_BATCH, FNET_SEQ, FNET["hidden"], device=CARD, generator=gen)
    xr = torch.randn(*PAR_RFFT_SHAPE, device=CARD, generator=gen)
    xc = torch.complex(xr, torch.randn(*PAR_RFFT_SHAPE, device=CARD, generator=gen))
    est = estimate_four_step_hbm(PAR_N, PAR_BATCH, 1)
    calls = [
        ("fft_four_step 4,096 x 65,536", lambda: par.fft_four_step(x, mesh), 5, True),
        ("filter apply_distributed 4,096 x 65,536", lambda: sf.apply_distributed(
            params, x, mesh), 5, True),
        ("filter train_step_distributed 4,096 x 65,536", lambda: sf.train_step_distributed(
            params, x, target, mesh, lr=PAR_LR), 3, False),
        ("fft_convolve_sharded 4,096 x 65,408, 129 taps, same", lambda: par.fft_convolve_sharded(
            xs, taps, mesh, mode="same"), 5, True),
        ("FNet-Base fourier_mix_distributed 8 x 512 x 768", lambda: fnet.fourier_mix_distributed(
            xf, mesh), 5, True),
        ("FNet-Base apply_distributed", lambda: fnet.apply_distributed(fp, xf, mesh), 3, True),
        ("FNet-Base train_step_distributed", lambda: fnet.train_step_distributed(
            fp, xf, xf, mesh, lr=1e-3), 3, False),
        ("rfft_four_step 64 x 65,536", lambda: par.rfft_four_step(xr, mesh), 5, True),
        ("fft_batch_sharded 64 x 65,536 (stage pipeline)", lambda: par.fft_batch_sharded(
            xc, mesh), 5, True),
    ]
    rows = []
    for name, fn, n_calls, no_grad in calls:
        with torch.no_grad() if no_grad else contextlib.nullcontext():
            _, gib = peak_gib(fn)
            before = cuda_fft.LAUNCHES
            fn()
            torch.cuda.synchronize()
            k1 = cuda_fft.LAUNCHES - before
            t = device_and_wall_us(fn, calls=n_calls, collectives=True)
        nccl = t["collective_spans"].get("nccl:all_to_all", 0.0)
        row = {"call": name, "device_us_profiler": t["device_us"], "back_to_back_us": t["wall_us"],
               "idle_share": t["idle_share"], "device_kernels_per_call": t["kernels"],
               "k1_launches": k1, "k1_device_us": t["k1_us"],
               "k1_share": None if not t["device_us"] else t["k1_us"] / t["device_us"],
               "all_to_all_us": nccl, "peak_gib": gib}
        log(f"{name}: device {t['device_us']} us (torch.profiler sum, fresh process), back to "
            f"back {t['wall_us']:.2f} us, idle share {t['idle_share']}, {t['kernels']} device "
            f"kernels, K1 {t['k1_us']:.2f} us in {k1} launches, all-to-alls {nccl:.2f} us, "
            f"peak {gib:.3f} GiB")
        for kernel, us in list(t["by_name"].items())[:8]:
            short = re.sub(r"void |at::native::|\(anonymous namespace\)::|binary_internal::", "",
                           kernel)
            log(f"  {us:10.2f} us  {short[:110]}")
        rows.append(row)
    # the four-step rows exchange (fft_batch_sharded does not): a profiler
    # that records no collective span reads 0 for all of them
    require(any(r["all_to_all_us"] > 0 for r in rows), "the profiler saw no all_to_all span")
    log(f"estimate_four_step_hbm({PAR_N}, {PAR_BATCH}, 1): {est}")
    log(json.dumps({"parallel_timing": {"card": card, "calls": rows, "estimate": est,
                                        "method": "torch.profiler device-kernel sum in a "
                                        "fresh process; back to back: CUDA events"}}))
    end_world()


def parallel_rest(rng, card: str):
    """Phase 26: the rest of parallel/ on a NCCL world of one, one shape
    each, against the port's single-device function (<= 2e-5) and float64
    where a few rows are cheap: the pencils at 256³ and 2,048², the sharded
    NUFFTs and SHTs at phases 21-22's sizes, the batch-sharded Kalman filter,
    PFB and radar chain at phases 20 and 23's; then an exported ``fft``
    reloaded on the card against the live call.  Returns the launches."""
    par = parallel
    mesh = world_of_one()
    cuda_fft.LAUNCHES = 0
    used, rows = {}, []

    def check(name, got, want, tol=ROUTES_TOL):
        got = local(got)
        require(got.device.type == CARD, f"{name}: result on {got.device}")
        err = rel_err(got.cpu().numpy(), want.cpu().numpy() if isinstance(want, torch.Tensor)
                      else want)
        log(f"{name}: rel err {err:.3e}")
        require(err <= tol, f"{name} error {err:.3e}")

    def run(name, fn, calls=3):
        before = cuda_fft.LAUNCHES
        out = fn()
        torch.cuda.synchronize()
        used[name] = cuda_fft.LAUNCHES - before
        ms = time_ms(fn, warmup=1, runs=calls)
        rows.append({"call": name, "ms_per_call": ms, "k1_launches": used[name]})
        log(f"{name}: {ms:.3f} ms a call (median of {calls}, CUDA events), "
            f"{used[name]} K1 launches")
        return out

    gen = torch.Generator(device=CARD).manual_seed(SEED)
    with torch.no_grad():
        vol = torch.randn(PENCIL_N, PENCIL_N, PENCIL_N, device=CARD, generator=gen)
        vc = torch.complex(vol, torch.randn_like(vol))
        check("fftn_pencil2 256³", run("fftn_pencil2", lambda: par.fftn_pencil2(vc, mesh)),
              tp.fftn(vc))
        check("rfftn_pencil2 256³", run("rfftn_pencil2", lambda: par.rfftn_pencil2(vol, mesh)),
              tp.rfftn(vol))
        f = vol - vol.mean()
        check("poisson_solve_pencil2 256³", run("poisson_solve_pencil2",
              lambda: par.poisson_solve_pencil2(f, mesh)), tp.poisson_solve(f))
        del vol, vc, f
        im = torch.complex(*(torch.randn(PENCIL2D_N, PENCIL2D_N, device=CARD, generator=gen)
                             for _ in range(2)))
        got = run("fft2_pencil", lambda: par.fft2_pencil(im, mesh))
        check("fft2_pencil 2048²", got, tp.fft2(im))
        check("fft2_pencil 2048² (rows 0-3 vs float64)", local(got)[:4],
              np.fft.fft2(im.cpu().numpy().astype(np.complex128))[:4], ORACLE_TOL)
        del im, got

        # the NUFFTs at phase 21's sizes: 2^20 points, eps 1e-5
        xs = rng.uniform(0.0, 2.0 * np.pi, NUFFT_POINTS).astype(np.float32)
        ys = rng.uniform(-np.pi, np.pi, NUFFT_POINTS).astype(np.float32)
        cs = complex64(rng, NUFFT_POINTS)
        xt, yt, ct = cuda32(xs), cuda32(ys), cuda_complex(cs)
        xst = cuda32(rng.uniform(-np.pi, np.pi, NUFFT_POINTS).astype(np.float32))
        kw = dict(eps=NUFFT_EPS)
        check("nufft1_sharded 8,192 modes", run("nufft1_sharded", lambda: par.nufft1_sharded(
            xt, ct, NUFFT_MODES, mesh, **kw)), tp.nufft1(xt, ct, NUFFT_MODES, method="grid", **kw))
        f1 = cuda_complex(complex64(rng, NUFFT_MODES))
        check("nufft2_sharded 8,192 modes", run("nufft2_sharded", lambda: par.nufft2_sharded(
            xt, f1, mesh, **kw)), tp.nufft2(xt, f1, method="grid", **kw))
        check("nufft1_2d_sharded 1,024²", run("nufft1_2d_sharded", lambda: par.nufft1_2d_sharded(
            xst, yt, ct, NUFFT_MODES_2D, mesh, **kw)),
            tp.nufft1_2d(xst, yt, ct, NUFFT_MODES_2D, method="grid", **kw))
        f2 = cuda_complex(complex64(rng, *NUFFT_MODES_2D))
        check("nufft2_2d_sharded 1,024²", run("nufft2_2d_sharded", lambda: par.nufft2_2d_sharded(
            xst, yt, f2, mesh, **kw)), tp.nufft2_2d(xst, yt, f2, method="grid", **kw))
        del xt, yt, ct, xst, f1, f2

        # the SHTs at phase 22's sizes
        fs = cuda32(rng.standard_normal((SHT_BATCH, SHT_L, 2 * SHT_L)))
        a = run("sht_sharded", lambda: par.sht_sharded(fs, mesh))
        check(f"sht_sharded L = {SHT_L}, batch {SHT_BATCH}", a, tp.sht(fs))
        check("isht_sharded", run("isht_sharded", lambda: par.isht_sharded(local(a), mesh)),
              tp.isht(local(a)))
        fr = cuda32(rng.standard_normal((SHT_REC_BATCH, SHT_REC_L, 2 * SHT_REC_L)))
        ar = run("sht_recurrence_sharded", lambda: par.sht_recurrence_sharded(fr, mesh), calls=1)
        check(f"sht_recurrence_sharded L = {SHT_REC_L}", ar, tp.sht_recurrence(fr))
        check("isht_recurrence_sharded", run("isht_recurrence_sharded",
              lambda: par.isht_recurrence_sharded(local(ar), mesh, real_output=True), calls=1),
              tp.isht_recurrence(local(ar), real_output=True))
        del fs, a, fr, ar

    # batch-sharded: Kalman tracks (phase 20), the PFB and the radar CPI (phase 23)
    model = kalman_model()
    tracks = np.stack([kalman_track(rng, KALMAN_PARALLEL_T) for _ in range(PAR_KALMAN_TRACKS)])
    ms, Ps = run("kalman_filter_sharded", lambda: par.kalman_filter_sharded(
        *model, tracks, mesh), calls=1)
    want = tp.kalman_filter(*model, tracks[1], parallel=True)
    check(f"kalman_filter_sharded {PAR_KALMAN_TRACKS} tracks, T = {KALMAN_PARALLEL_T:,} (track 1)",
          local(ms)[1], want[0])
    check("kalman_filter_sharded covariances (track 1)", local(Ps)[1], want[1])
    with torch.no_grad():
        xp = cuda32(rng.standard_normal((PFB_POLS, PFB_SAMPLES)) * 0.1)
        got = run("pfb_analysis_sharded", lambda: par.pfb_analysis_sharded(
            xp, PFB["n_channels"], mesh, taps_per_branch=PFB["taps_per_branch"]))
        want = tp.pfb_analysis(xp, PFB["n_channels"], PFB["taps_per_branch"])
        check(f"pfb_analysis_sharded {PFB_POLS} x 2^25, {PFB['n_channels']} channels (first "
              f"{PFB_ORACLE_FRAMES} frames)", local(got)[:, :PFB_ORACLE_FRAMES],
              want[:, :PFB_ORACLE_FRAMES])
        require(tuple(got.shape) == tuple(want.shape), f"pfb_analysis_sharded {tuple(got.shape)}")
        del got, want
        del xp
        tx = lfm_pulse(RADAR_PULSE)
        rx = cuda_complex(radar_cpi(rng, tx))
        Y, det, th = run("range_doppler_cfar_sharded", lambda: par.range_doppler_cfar_sharded(
            rx, tx, mesh))
        Yw = tp.range_doppler(rx, tx)
        detw, thw = tp.cfar(Yw.real ** 2 + Yw.imag ** 2, axes=(-2, -1))
        check(f"range_doppler_cfar_sharded {tuple(rx.shape)} map", Y, Yw)
        check("range_doppler_cfar_sharded thresholds", th, thw)
        require(torch.equal(local(det), detw), "range_doppler_cfar_sharded detections differ")
        del rx, Y, det, th, Yw, detw, thw
    end_world()

    # an exported fft reloaded on the card: at a K1 length the program holds
    # the kernel's operator and launches it, as the live call does; exported
    # on the stage pipeline it launches none
    xe = cuda_complex(complex64(rng, *EXPORT_SHAPE))
    for route, config in (("K1", tp.DEFAULT_CONFIG), ("stage pipeline", PIPELINE)):
        blob = tp.utils.export_transform(lambda v, c=config: tp.fft(v, config=c), xe)
        loaded = tp.utils.load_transform(blob)
        before = cuda_fft.LAUNCHES
        got = loaded(xe)
        torch.cuda.synchronize()
        launched = cuda_fft.LAUNCHES - before
        used[f"exported fft ({route})"] = launched
        require((launched > 0) == (route == "K1"),
                f"the exported transform on the {route} launched the kernel {launched} times")
        check(f"export_transform -> load_transform fft {EXPORT_SHAPE} on the {route} "
              f"({len(blob):,} bytes, {launched} K1 launches) vs live", got, tp.fft(xe, config=config))
    torch.cuda.empty_cache()
    log("parallel rest kernel launches: " + ", ".join(f"{k} {v}" for k, v in used.items()))
    log(json.dumps({"parallel_rest_timing": {"card": card, "calls": rows}}))
    return sum(used.values())


# ---------------------------------------------------------------------------
# Phases 27-28: the programs that drive the package (examples/, tools/tune.py).
# ---------------------------------------------------------------------------

# each example's main at the JAX example's own sizes, in the order of the
# port (smallest first); then two at a size their users run: MRI at 256²
# with pi/2·N = 402 spokes of 2N points (the radial Nyquist count), and the
# advection at phase 22's L = 256 grid with the same 1/8 revolution
EXAMPLE_RUNS = (
    ("serving_export", {}), ("fno_train", dict(compile=False)), ("pde_spectral", {}),
    ("sphere_advection", {}), ("mri_recon", {}), ("radar_array", {}),
    ("audio_features", {}), ("signal_toolbox", {}), ("demo", {}),
    ("mri_recon", dict(n=256, spokes=402, per_spoke=512)),
    ("sphere_advection", dict(lmax=255, steps=160, compile=False)),
)
# phase 27's eager fno_train run (its output and times), which phase 29
# reads beside its compiled run instead of running it again
FNO_EAGER: dict = {}
# the examples whose steps compile by default on a card, as the JAX examples
# jit them: compiled in ``python3 chip_smoke.py examples``, eagerly in the
# whole run, whose time limit their Inductor compiles do not leave room
# for (49-78 s and 67-106 s of first run on the card, more on a busier
# host); the advection at lmax 255 runs eagerly in both, so that its row
# stays comparable with earlier runs' (a compile of its step took 62-108 s)
COMPILED_EXAMPLES = ("pde_spectral", "sphere_advection")
# fno_train's final evaluation loss against the predict-zero baseline (the
# JAX example reads 1e-5 against 0.058 on a CPU)
FNO_TRAIN_GAIN = 0.1
# the advection's error against the exact rotation at lmax = 255: the RK4
# truncation and fp32 round-off, 2.09e-6 in a CPU rehearsal of the same run
# (stage pipeline); five times that
ADVECTION_255_TOL = 1e-5
TUNE_BIG = (256, 1 << 20)        # the four-step's K1 shape at config 5 (phase 25)
# the whole run times every twelfth length of the sweep (85.6 s for all 399
# in a whole run before phase 32 took the time, 39.7-47.4 s for every third,
# 25.1 s for every sixth before phase 33 did); ``tune`` times them all
TUNE_STRIDE = 12


def profiled_device_ms(fn) -> float:
    """Sum of the device kernels' time of one ``fn()`` under torch.profiler,
    ms.  Only the card's activity is traced, and the sum is read from the
    profiler's raw events: a run of an example issues tens of thousands of
    calls, whose CPU events and whose parse into function events would cost
    more than the run itself."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA
               and not e.name().startswith("nccl:")) / 1e6


def examples(rng, card: str, full: bool = False):
    """Phase 27: every example's ``main`` on the card, its asserts the
    check; per run the kernel's launches (counted from 0 just before it), the
    kernel against its plain version on the first two and the latest plane
    pairs it was handed (relative errors, logged: the planes are
    unnormalised, so their absolute errors stay off the kernels line; a
    compiled example's pairs come from one more run of it, eager, after its
    first: a step traced under the recorder would compile again once the
    recorder is gone, and its launches are not counted),
    back-to-back wall ms of a second, warm run, the profiler's device ms of a
    third, and the idle share (the second and third runs, about a minute
    on an H100's host, are ``python3 chip_smoke.py examples``'s; the whole
    run runs each example once).  ``fno_train`` runs eagerly here, so that
    its row stays comparable across runs (phase 29 times its compiled
    loop); ``serving_export``
    exports and compiles in every run, as the JAX example lowers and
    compiles in every run: its traced calls hand no planes to note, its
    eager ones (the live denoiser) do.  Without ``full`` (the whole run)
    the COMPILED_EXAMPLES run eagerly."""
    import importlib

    del rng   # each example draws from its own seeds
    rows, total = [], 0
    for name, kw in EXAMPLE_RUNS:
        if not full and name in COMPILED_EXAMPLES:
            kw = {**kw, "compile": False}
        mod = importlib.import_module(f"mixed_radix_fast_fourier_transform_tpu_torch.examples.{name}")
        label = name + ("" if not kw else " " + " ".join(f"{k}={v}" for k, v in kw.items()))
        t0 = time.perf_counter()
        cuda_fft.LAUNCHES = 0
        # a compiled step traced under the recorder would guard on it and
        # compile again once it is gone: a compiled example's first run is
        # unrecorded, and an eager run of it after that notes the planes
        compiles = name in COMPILED_EXAMPLES and kw.get("compile", True)
        with contextlib.nullcontext([]) if compiles else recorded_launches(keep=2) as seen:
            out = mod.main(device=CARD, **kw)
            torch.cuda.synchronize()
        launches = cuda_fft.LAUNCHES
        first_s = time.perf_counter() - t0
        total += launches
        if compiles:
            with recorded_launches(keep=2) as seen, contextlib.redirect_stdout(None):
                mod.main(device=CARD, **kw, compile=False)
                torch.cuda.synchronize()
        for pair in seen:   # each logs its relative error, the quantity held to KERNEL_TOL
            kernel_error(*pair, label)
        del seen
        if name == "fno_train":
            require(out["final_eval_loss"] < FNO_TRAIN_GAIN * out["baseline"],
                    f"fno_train: final eval loss {out['final_eval_loss']:.3e} against the "
                    f"baseline {out['baseline']:.3e}")
        if name == "sphere_advection" and "lmax" in kw:
            require(out["err"] <= ADVECTION_255_TOL,
                    f"advection at lmax {kw['lmax']}: error {out['err']:.3e}")
        row = {"example": label, "k1_launches": launches, "first_run_s": first_s}
        rows.append(row)
        if name == "fno_train":
            FNO_EAGER.update(out=out, row=row)
        if not full:
            log(f"example {label}: {launches} K1 launches, first run {first_s:.1f} s (timed in "
                f"python3 chip_smoke.py examples)")
            torch.cuda.empty_cache()
            continue
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(None):
            mod.main(device=CARD, **kw)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(None):
            device_ms = profiled_device_ms(lambda: mod.main(device=CARD, **kw))
        profiled_s = time.perf_counter() - t0
        require(device_ms > 0, f"example {label}: the profiler saw no device time")
        row.update(back_to_back_ms=wall_ms, device_ms_profiler=device_ms,
                   idle_share=1.0 - device_ms / wall_ms, profiled_run_s=profiled_s)
        log(f"example {label}: {launches} K1 launches, back to back {wall_ms:.1f} ms, "
            f"device {device_ms:.1f} ms (profiler), idle share {row['idle_share']:.3f}, "
            f"first run {first_s:.1f} s, profiled run {profiled_s:.1f} s")
        torch.cuda.empty_cache()
    log(json.dumps({"examples_timing": {"card": card, "runs": rows}}))
    return total


def tune_phase(card: str, stride: int = TUNE_STRIDE) -> None:
    """Phase 28: ``tools/tune.py kernel all`` on the card at every
    ``stride``-th length the kernel takes (2^22 complex values a call,
    graph_time of 2 launches and 2 replays per route: 4 and 3 until phase 31
    needed the time; every length until phase 32 did, every third until a
    slower host ran the whole run past its limit: ``python3 chip_smoke.py
    tune`` sweeps them all), every length's kernel against
    float64 on 8 rows, then ``torch.fft.fft`` and the kernel at 256 x
    1,048,576 rows (4 and 3).  The sweep's lines are written to
    chiprun_out/tune_sweep.jsonl as well."""
    from mixed_radix_fast_fourier_transform_tpu_torch.tools import tune

    lengths = tune.sweep_lengths()
    require(len(lengths) == 399, f"the kernel takes {len(lengths)} lengths")
    timed = lengths[::stride]
    rows, summary = tune.tune_kernel_all(device=CARD, lengths=timed, launches=2, replays=2)
    require(summary["lengths"] == len(timed), f"sweep covered {summary['lengths']} lengths")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    untimed_err = 0.0
    for n in sorted(set(lengths) - set(timed)):
        xr, xi = (torch.randn(8, n, device="cuda", generator=gen) for _ in range(2))
        zr, zi = cuda_fft.exec_kernel(xr, xi, n, -1)
        want = np.fft.fft(torch.complex(xr, xi).cpu().numpy().astype(np.complex128))
        untimed_err = max(untimed_err, rel_err(torch.complex(zr, zi).cpu().numpy(), want))
    log(f"kernel sweep: {len(timed)} of {len(lengths)} lengths timed; the kernel against "
        f"float64 on 8 rows: {summary['max_kernel_err']:.3e} at the timed lengths, "
        f"{untimed_err:.3e} at the others")
    require(max(summary["max_kernel_err"], untimed_err) <= ORACLE_TOL,
            f"kernel error {summary['max_kernel_err']:.3e} / {untimed_err:.3e} against "
            f"float64 in the sweep")
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "tune_sweep.jsonl"), "w") as fh:
        fh.write(json.dumps({"card": card}) + "\n")
        for r in rows:
            fh.write(json.dumps(r) + "\n")
        fh.write(json.dumps({"summary": summary}) + "\n")
    n, b = TUNE_BIG
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    xr, xi = (torch.randn(b, n, device="cuda", generator=gen) for _ in range(2))
    kernel_us = 1e6 * graph_time(lambda: cuda_fft.exec_kernel(xr, xi, n, -1), launches=4, replays=3)
    del xi
    xc = torch.complex(xr, torch.randn(b, n, device="cuda", generator=gen))
    del xr
    cufft_us = 1e6 * graph_time(lambda: torch.fft.fft(xc), launches=4, replays=3)
    bound, bound_by = fft_bound_ms(n, b)
    log(json.dumps({"tune_big_shape": {"card": card, "n": n, "rows": b, "kernel_us": kernel_us,
                                       "torch_fft_us": cufft_us, "bound_us": bound * 1e3,
                                       "bound_by": bound_by}}))
    del xc
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 29: the compiled path, torch.compile as jax.jit runs the JAX package
# ---------------------------------------------------------------------------

# the spectral filter's inner transform at batch 1024: rows x n
COMPILE_FFT_SHAPE = (1024, 2048)
# compiled against eager: the same fp32 work, its elementwise passes fused
# and ordered by Inductor, a few ulps apart
COMPILE_TOL = ROUTES_TOL
# fno_train's per-step losses, compiled against eager, over the first steps
FNO_COMPILE_STEPS = 20
FNO_COMPILE_TOL = 1e-4


def compiled(fn, backend: str = "inductor"):
    """``fn`` under ``torch.compile(fullgraph=True, dynamic=False)`` on
    ``backend`` (default Inductor): the counterpart of ``jax.jit``."""
    return torch.compile(fn, backend=backend, fullgraph=True, dynamic=False)


def first_call(name: str, fn, *args):
    """The first call of a compiled ``fn`` (it compiles: set-up seconds),
    zero graph breaks by dynamo's counters over that compile, then a second
    call under ``fail_on_recompile``.  Returns the second call's output and
    the compile seconds."""
    counters = torch._dynamo.utils.counters
    counters.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(*args)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    breaks = sum(counters["graph_break"].values())
    require(breaks == 0, f"{name}: {breaks} graph breaks")
    with torch.compiler.set_stance("fail_on_recompile"):
        out = fn(*args)
    torch.cuda.synchronize()
    log(f"compiled {name}: first call (compile) {secs:.2f} s, 0 graph breaks, no recompile "
        f"on the second")
    return out, secs


def step_oracle64(params, x: np.ndarray, target: np.ndarray, lr: float):
    """One SGD step of the spectral filter in float64 on the CPU."""
    leaves = {k: torch.tensor(v, dtype=torch.float64, requires_grad=True)
              for k, v in params.items()}
    loss = torch.mean((oracle_filter(leaves, torch.tensor(x)) - torch.tensor(target)) ** 2)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return {k: (v - lr * g).detach() for (k, v), g in zip(leaves.items(), grads)}, loss.detach()


def timing_pair(name: str, eager, comp, calls: int, captured: int,
                capture_compiled: bool = True) -> dict:
    """Eager and compiled forms of one call side by side: device µs by
    graph replay, the profiler's device µs and kernels per call,
    back-to-back µs, and the idle share 1 - graph-replay µs / back-to-back
    µs (late in a whole run the profiler can drop events; replay cannot).
    A compiled loop operator reads its trip condition on the host, which a
    CUDA graph cannot capture: without ``capture_compiled`` the compiled
    form's device µs and idle share are the profiler's."""
    row = {"call": name}
    for label, fn in (("eager", eager), ("compiled", comp)):
        t = device_and_wall_us(fn, calls=calls)
        capture = label == "eager" or capture_compiled
        graph_us = 1e6 * graph_time(fn, launches=captured) if capture else None
        row[label] = {"device_us_graph_replay": graph_us,
                      "device_us_profiler": t["device_us"],
                      "device_kernels_per_call": t["kernels"], "k1_us": t["k1_us"],
                      "back_to_back_us": t["wall_us"],
                      "idle_share": 1.0 - graph_us / t["wall_us"] if capture
                      else t["idle_share"]}
        r = row[label]
        log(f"{name} {label}: {r['device_us_graph_replay']} us device (graph replay), "
            f"{r['device_us_profiler']} us (profiler), {r['device_kernels_per_call']} "
            f"kernels a call, K1 {r['k1_us']:.2f} us, back to back "
            f"{r['back_to_back_us']:.2f} us, idle share {r['idle_share']}")
    return row


def host_breakdown(name: str, fn, calls: int = 20, top: int = 8) -> list:
    """The host side of ``calls`` calls of ``fn``: torch.profiler's CPU
    events by self time per call, largest first (what keeps the card idle
    between launches)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = sorted(((e.key, e.self_cpu_time_total / calls, e.count / calls)
                   for e in prof.key_averages()), key=lambda r: -r[1])[:top]
    for key, us, count in rows:
        log(f"  host {name}: {us:9.2f} us self a call ({count:g} calls)  {key[:90]}")
    return [{"event": key, "self_us": us, "count": count} for key, us, count in rows]


def compile_path(rng, card: str, full: bool = False) -> int:
    """Phase 29: the main path under ``torch.compile`` (Inductor,
    ``fullgraph=True, dynamic=False``), as the JAX package runs it under
    ``jax.jit``.  ``fft``/``rfft``/``irfft`` at 2048 x 1024; the spectral
    filter's forward and SGD step (``utils.tree.compile_sgd_step``) at
    n = 4096, batch 8 and 1024; ``fno_train`` at the JAX sizes compiled
    beside eager (phase 27's eager run where the whole run made one; with
    ``full``, ``python3 chip_smoke.py compile``, both timed, where the whole
    run checks the compiled run's losses and launches only).  Each:
    zero graph breaks (dynamo's counters), no recompile on the second call,
    the fused kernel's launches (the compiled graph holds its operator),
    compiled against eager (2e-5) and the filter against float64 (1e-5),
    compile seconds, and device / back-to-back times and idle share beside
    eager's.  Returns the launches of the counted calls (from 0 at the
    phase's start; compiles and timings add none to it)."""
    from mixed_radix_fast_fourier_transform_tpu_torch.examples import fno_train

    rows, counted = [], 0
    rows_n, n = COMPILE_FFT_SHAPE
    x = torch.complex(cuda32(rng.standard_normal(COMPILE_FFT_SHAPE)),
                      cuda32(rng.standard_normal(COMPILE_FFT_SHAPE)))
    xr = x.real.contiguous()
    spec = tp.rfft(xr)
    for name, fn, arg in (("fft", lambda v: tp.fft(v), x), ("rfft", lambda v: tp.rfft(v), xr),
                          ("irfft", lambda v: tp.irfft(v, n=n), spec)):
        label = f"{name} {n} x {rows_n}"
        torch._dynamo.reset()   # each call compiles from empty caches
        comp = compiled(fn)
        _, secs = first_call(label, comp, arg)
        before = cuda_fft.LAUNCHES
        got = comp(arg)
        torch.cuda.synchronize()
        launched = cuda_fft.LAUNCHES - before
        counted += launched
        require(launched == 1, f"{label}: {launched} K1 launches compiled")
        err = rel_err(got.cpu().numpy(), fn(arg).cpu().numpy())
        log(f"{label} compiled: 0 graph breaks, {launched} K1 launch, rel err {err:.3e} vs eager")
        require(err <= COMPILE_TOL, f"{label} compiled vs eager {err:.3e}")
        rows.append({"call": label, "compile_s": secs, "graph_breaks": 0,
                     "k1_launches": launched, "rel_err_vs_eager": err,
                     **timing_pair(label, lambda: fn(arg), lambda: comp(arg), 20, 20)})
        if name == "fft":   # the same four device kernels: what the compiled call adds on the host
            rows[-1]["host_eager"] = host_breakdown(f"{label} eager", lambda: fn(arg))
            rows[-1]["host_compiled"] = host_breakdown(f"{label} compiled", lambda: comp(arg))
    del x, xr, spec

    for b in FILTER_BATCHES:
        params = filter_params(rng, FILTER_N)
        xn = rng.standard_normal((b, FILTER_N))
        true_gain = 1.0 + 0.3 * rng.standard_normal(FILTER_N // 2 + 1)
        tn = np.fft.irfft(np.fft.rfft(xn) * true_gain, n=FILTER_N) + 0.3
        xt, tt = cuda32(xn), cuda32(tn)
        tparams = tp.models.params_from_jax(params, CARD)
        label = f"spectral filter n={FILTER_N} b={b}"

        # the forward
        torch._dynamo.reset()
        fwd = compiled(tp.models.apply)
        _, fwd_s = first_call(f"{label} forward", fwd, tparams, xt)
        before = cuda_fft.LAUNCHES
        y = fwd(tparams, xt)
        torch.cuda.synchronize()
        fwd_launches = cuda_fft.LAUNCHES - before
        counted += fwd_launches
        require(fwd_launches == 2, f"{label}: {fwd_launches} K1 launches a compiled forward")
        gain = params["gain_re"] + 1j * params["gain_im"]
        want = np.fft.irfft(np.fft.rfft(xn) * gain, n=FILTER_N) + params["bias"]
        err64 = rel_err(y.cpu().numpy(), want)
        err = rel_err(y.cpu().numpy(), tp.models.apply(tparams, xt).cpu().numpy())
        log(f"{label} compiled forward: rel err {err:.3e} vs eager, {err64:.3e} vs float64; "
            f"{fwd_launches} K1 launches")
        require(err <= COMPILE_TOL and err64 <= ORACLE_TOL,
                f"{label} compiled forward: {err:.3e} vs eager, {err64:.3e} vs float64")

        # the SGD step: loss and update compiled, the gradient between them
        step = compile_sgd_step(tp.models.loss_fn)
        _, step_s = first_call(f"{label} train step", lambda: step(tparams, xt, tt, lr=TRAIN_LR))
        before = cuda_fft.LAUNCHES
        new, loss = step(tparams, xt, tt, lr=TRAIN_LR)
        torch.cuda.synchronize()
        step_launches = cuda_fft.LAUNCHES - before
        counted += step_launches
        require(step_launches == 3, f"{label}: {step_launches} K1 launches a compiled step")
        new_e, loss_e = tp.models.train_step(tparams, xt, tt, lr=TRAIN_LR)
        new64, loss64 = step_oracle64(params, xn, tn, TRAIN_LR)
        errs = [rel_err(float(loss), float(loss_e))] + [
            rel_err(new[k].cpu().numpy(), new_e[k].cpu().numpy()) for k in new]
        errs64 = [rel_err(float(loss), float(loss64))] + [
            rel_err(new[k].cpu().numpy(), new64[k].numpy()) for k in new]
        log(f"{label} compiled train step: loss and new parameters rel err {max(errs):.3e} "
            f"vs eager, {max(errs64):.3e} vs float64; {step_launches} K1 launches")
        require(max(errs) <= COMPILE_TOL and max(errs64) <= ORACLE_TOL,
                f"{label} compiled step: {max(errs):.3e} vs eager, {max(errs64):.3e} vs float64")
        rows.append({"call": f"{label} forward", "compile_s": fwd_s, "graph_breaks": 0,
                     "k1_launches": fwd_launches, "rel_err_vs_eager": err,
                     "rel_err_vs_float64": err64,
                     **timing_pair(f"{label} forward", lambda: tp.models.apply(tparams, xt),
                                   lambda: fwd(tparams, xt), 20, 20)})
        if b == FILTER_BATCHES[0]:
            rows[-1]["host_compiled"] = host_breakdown(f"{label} forward compiled",
                                                       lambda: fwd(tparams, xt))
        rows.append({"call": f"{label} train step", "compile_s": step_s,
                     "k1_launches": step_launches, "rel_err_vs_eager": max(errs),
                     "rel_err_vs_float64": max(errs64),
                     **timing_pair(f"{label} train step",
                                   lambda: tp.models.train_step(tparams, xt, tt, lr=TRAIN_LR),
                                   lambda: step(tparams, xt, tt, lr=TRAIN_LR), 20, 5)})
        torch.cuda.empty_cache()

    # fno_train at the JAX sizes: the loss compiled (the default on a card)
    # beside the eager loop (phase 27's run of it where the whole run made one)
    runs = {}
    for mode in (False, True):
        label = f"fno_train {'compiled' if mode else 'eager'}"
        if not mode and FNO_EAGER:
            r = FNO_EAGER["row"]
            runs[mode] = FNO_EAGER["out"]
            rows.append({**r, "call": label + " (phase 27's run)"})
            log(f"{label}: phase 27's run, first run {r['first_run_s']:.1f} s")
            continue
        t0 = time.perf_counter()
        before = cuda_fft.LAUNCHES
        with contextlib.redirect_stdout(None):
            out = fno_train.main(device=CARD, compile=mode)
            torch.cuda.synchronize()
        launched = cuda_fft.LAUNCHES - before
        counted += launched
        first_s = time.perf_counter() - t0
        require(out["final_eval_loss"] < FNO_TRAIN_GAIN * out["baseline"],
                f"{label}: final eval loss {out['final_eval_loss']:.3e}")
        runs[mode] = out
        rows.append({"call": label, "k1_launches": launched, "first_run_s": first_s})
        if not full:
            log(f"{label}: {launched} K1 launches, first run {first_s:.1f} s (timed in "
                f"python3 chip_smoke.py compile)")
            continue
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(None):
            fno_train.main(device=CARD, compile=mode)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        with contextlib.redirect_stdout(None):
            device_ms = profiled_device_ms(lambda: fno_train.main(device=CARD, compile=mode))
        rows[-1].update(back_to_back_ms=wall_ms, device_ms_profiler=device_ms,
                        idle_share=1.0 - device_ms / wall_ms)
        log(f"{label}: {launched} K1 launches, first run {first_s:.1f} s, back to back "
            f"{wall_ms:.1f} ms, device {device_ms:.1f} ms (profiler), idle share "
            f"{1.0 - device_ms / wall_ms:.3f}")
    a, b = (runs[m]["losses"][:FNO_COMPILE_STEPS] for m in (True, False))
    err = float(np.max(np.abs(a - b) / np.abs(b)))
    log(f"fno_train: first {FNO_COMPILE_STEPS} losses compiled vs eager, rel err {err:.3e}")
    require(len(a) == FNO_COMPILE_STEPS and err <= FNO_COMPILE_TOL,
            f"fno_train compiled vs eager losses: {err:.3e}")
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "compile_path.json"), "w") as fh:
        json.dump({"card": card, "torch": torch.__version__, "rows": rows}, fh, indent=1)
    log(json.dumps({"compile_timing": {"card": card, "rows": rows}}))
    return counted


# ---------------------------------------------------------------------------
# Phase 30: every model family compiled, as the JAX package's tests jit them
# ---------------------------------------------------------------------------

# Layers of a compiled family's rows in the whole run: Inductor's compile
# grows with the layers (at full depth phase 30 read 1,072 s on the card,
# S4D 116 s, FNet 113 s, AFNO 483 s, SFNO 156 s of it), so the depth is cut
# to fit the run's time limit; the width never is (PERF.md §4).
# ``python3 chip_smoke.py compile`` runs the published depths
COMPILED_DEPTH = {"fno": 1, "s4d": 1, "fnet": 1, "afno": 1, "sfno": 1}
# calls a timing row averages (device and back-to-back time)
COMPILED_CALLS = 3


def compiled_timing(name: str, eager, comp) -> dict:
    """Eager and compiled forms of one family call side by side, as
    phase 14 reads a family: device µs by CUDA-graph replay (one call
    captured, replayed COMPILED_CALLS times) and by the profiler, device
    kernels a call, back-to-back µs and the idle share 1 − graph-replay µs /
    back-to-back µs."""
    row = {"call": name}
    for label, fn in (("eager", eager), ("compiled", comp)):
        t = device_and_wall_us(fn, calls=COMPILED_CALLS)
        graph_us = 1e6 * graph_time(fn, launches=1, replays=COMPILED_CALLS)
        row[label] = {"device_us_graph_replay": graph_us,
                      "device_us_profiler": t["device_us"],
                      "device_kernels_per_call": t["kernels"], "k1_us": t["k1_us"],
                      "back_to_back_us": t["wall_us"],
                      "idle_share": 1.0 - graph_us / t["wall_us"]}
        r = row[label]
        log(f"{name} {label}: {r['device_us_graph_replay']:.2f} us device (graph replay), "
            f"{r['device_us_profiler']} us (profiler), {r['device_kernels_per_call']} "
            f"kernels a call, K1 {r['k1_us']:.2f} us, back to back "
            f"{r['back_to_back_us']:.2f} us, idle share {r['idle_share']:.3f}")
    return row


def counted(fn):
    """``fn()`` and the fused kernel's launches it made."""
    before = cuda_fft.LAUNCHES
    out = fn()
    torch.cuda.synchronize()
    return out, cuda_fft.LAUNCHES - before


def compiled_family(name, apply, loss_fn, step, params, x, target, forward_launches,
                    step_launches, err_of=rel_err, step_tol: float = ROUTES_TOL,
                    tables=None, backend: str = "inductor"):
    """One family under torch.compile (its forward and the step's loss and
    update on ``backend``) beside eager on the same
    weights and inputs: zero graph breaks in the compiled forward and in the
    step's compiled loss and update (dynamo's counters over their first
    calls, from dynamo's caches emptied), the compiled forward with no
    recompile on its second call, its K1 launches
    (equal to eager's), against eager (COMPILE_TOL), and the device memory
    its compile leaves allocated (below ``tables``, the bytes of the device
    tables its graph reads, where given: they are held, not copied);
    ``compile_sgd_step`` of the loss (``step`` None: the loss's gradient
    eagerly, as the Koopman autoencoder's JAX test jits it), its launches
    equal to eager's, its loss (ORACLE_TOL) and new parameters
    (``step_tol`` by ``err_of``) against the eager step; compile seconds;
    device and back-to-back times and idle share beside eager's.  Returns
    the rows and the launches of the counted compiled calls."""
    torch._dynamo.reset()
    with torch.no_grad():
        want, eager_fwd = counted(lambda: apply(params, x))
        fwd = compiled(apply, backend)
        before = torch.cuda.memory_allocated()
        out, fwd_s = first_call(f"{name} forward", fwd, params, x)
        del out
        added = torch.cuda.memory_allocated() - before
        got, fwd_launches = counted(lambda: fwd(params, x))
    log(f"{name}: the compiled forward's first calls leave {added / 2**20:.1f} MiB allocated"
        + ("" if tables is None else f" beside {tables / 2**20:.1f} MiB of kept tables"))
    require(tables is None or added < tables,
            f"{name}: a compile left {added} bytes allocated beside {tables} of tables")
    require(fwd_launches == eager_fwd == forward_launches,
            f"{name}: {fwd_launches} K1 launches a compiled forward, {eager_fwd} eager, "
            f"{forward_launches} expected")
    err = rel_err(got.cpu().numpy(), want.cpu().numpy())
    log(f"{name} compiled forward {tuple(got.shape)}: 0 graph breaks, {fwd_launches} K1 "
        f"launches (eager {eager_fwd}), rel err {err:.3e} vs eager")
    require(err <= COMPILE_TOL, f"{name} compiled forward vs eager {err:.3e}")
    del got, want

    comp_step = compile_sgd_step(loss_fn, backend=backend)
    lr = 1e-3
    if step is None:
        step = functools.partial(sgd_step, loss_fn)
    _, step_s = first_call(f"{name} train step", lambda: comp_step(params, x, target, lr=lr))
    (new, loss), launched = counted(lambda: comp_step(params, x, target, lr=lr))
    (new_e, loss_e), eager_launched = counted(lambda: step(params, x, target, lr=lr))
    require(launched == eager_launched == step_launches,
            f"{name}: {launched} K1 launches a compiled step, {eager_launched} eager, "
            f"{step_launches} expected")
    loss_err = abs(float(loss) - float(loss_e)) / abs(float(loss_e))
    errs = [err_of(a.cpu().numpy(), b.cpu().numpy())
            for a, b in zip(tree_leaves(new), tree_leaves(new_e))]
    log(f"{name} compiled train step: {launched} K1 launches (eager {eager_launched}), loss "
        f"rel err {loss_err:.3e}, new parameters {err_of.__name__} {max(errs):.3e} (worst "
        f"leaf) vs eager")
    require(loss_err <= ORACLE_TOL and max(errs) <= step_tol,
            f"{name} compiled step vs eager: loss {loss_err:.3e}, parameters {max(errs):.3e}")
    del new, new_e

    def eager_forward():
        with torch.no_grad():
            return apply(params, x)

    def compiled_forward():
        with torch.no_grad():
            return fwd(params, x)

    rows = [
        {"call": f"{name} forward", "compile_s": fwd_s, "graph_breaks": 0,
         "k1_launches": fwd_launches, "k1_launches_eager": eager_fwd, "rel_err_vs_eager": err,
         "compile_allocated_mib": added / 2**20,
         **compiled_timing(f"{name} forward", eager_forward, compiled_forward)},
        {"call": f"{name} train step", "compile_s": step_s, "k1_launches": launched,
         "k1_launches_eager": eager_launched, "loss_rel_err_vs_eager": loss_err,
         f"params_{err_of.__name__}_vs_eager": max(errs),
         **compiled_timing(f"{name} train step", lambda: step(params, x, target, lr=lr),
                           lambda: comp_step(params, x, target, lr=lr))},
    ]
    torch.cuda.empty_cache()
    return rows, fwd_launches + launched


def compiled_families(rng, card: str, full: bool = False) -> int:
    """Phase 30: S4D, FNet-Base, the FourCastNet AFNO, the SFNO, the PCEN
    front end and the Koopman autoencoder at the widths of their eager
    phases (12-15, 22), each under torch.compile (Inductor,
    ``fullgraph=True, dynamic=False``) beside eager (:func:`compiled_family`),
    and the SFNO's compiled forward keeps its Legendre tables where they
    are (the device memory a compile adds stays below their size).  With
    ``full`` (``python3 chip_smoke.py compile``) every family at its
    published depth and the front end's compiled loss with an input gradient
    too (2 launches), all with Inductor; without, the depths of
    COMPILED_DEPTH, no input gradient and each forward and train step
    compiled with ``aot_eager``, to fit the whole run's time limit:
    Inductor's compiles of the six steps read 165-190 s of the whole run,
    of the six forwards 95.4 s on a slower host (PERF.md).  Rows are added to
    chiprun_out/compile_path.json.  Returns the launches of the counted
    compiled calls."""
    gen = torch.Generator().manual_seed(SEED)
    rows, total = [], 0

    def depth(name, layers):
        return layers if full else COMPILED_DEPTH.get(name, layers)

    def run(name, *args, **kw):
        nonlocal total
        got, launched = compiled_family(name, *args, **kw,
                                        backend="inductor" if full else "aot_eager")
        rows.extend(got)
        total += launched

    n = depth("s4d", S4D["n_layers"])
    run(f"s4d {S4D['hidden']} x {n}, L={S4D_LENGTH}, b={S4D_BATCH}", s4d.apply_s4d, s4d.loss_fn,
        s4d.train_step, s4d.init_s4d_model(**{**S4D, "n_layers": n}, generator=gen, device=CARD),
        cuda32(rng.standard_normal((S4D_BATCH, S4D_LENGTH, S4D["in_dim"]))),
        cuda32(rng.standard_normal((S4D_BATCH, S4D["out_dim"]))), 3 * n, 6 * n)

    n = depth("fnet", FNET["n_layers"])
    run(f"fnet-base {FNET['hidden']} x {n}, seq {FNET_SEQ}, b={FNET_BATCH}", fnet.apply,
        fnet.loss_fn, fnet.train_step,
        fnet.init_fnet(**{**FNET, "n_layers": n}, generator=gen, device=CARD),
        cuda32(rng.standard_normal((FNET_BATCH, FNET_SEQ, FNET["hidden"]))),
        cuda32(rng.standard_normal((FNET_BATCH, FNET_SEQ, FNET["hidden"]))),
        2 * n, 2 * n + 2 * (n - 1))

    n = depth("afno", AFNO["n_layers"])
    run(f"afno {AFNO['dim']} x {n}, {AFNO_GRID[0] // 8} x {AFNO_GRID[1] // 8} tokens",
        functools.partial(afno.apply, **AFNO_RUN), functools.partial(afno.loss_fn, **AFNO_RUN),
        functools.partial(afno.train_step, **AFNO_RUN),
        afno.init_afno(**{**AFNO, "n_layers": n}, generator=gen, device=CARD),
        cuda32(rng.standard_normal((1, *AFNO_GRID, AFNO["in_channels"]))),
        cuda32(rng.standard_normal((1, *AFNO_GRID, AFNO["out_channels"]))),
        4 * n, 8 * n, l2_err, AFNO_GRAD_TOL)

    # the SFNO: its Legendre chunks (tens of MB at L = 256) are kept on the
    # card once; a compiled graph holds those tensors, it copies none
    n = depth("sfno", SFNO["n_layers"])
    L = SFNO["lmax"] + 1
    params = sfno.init_sfno(**{**SFNO, "n_layers": n}, generator=gen, device=CARD)
    x = cuda32(rng.standard_normal((SFNO_BATCH, SFNO["in_channels"], L, 2 * L)))
    target = cuda32(rng.standard_normal((SFNO_BATCH, SFNO["out_channels"], L, 2 * L)))
    with torch.no_grad():
        sfno.apply(params, x)
    tables = sum(t.numel() * t.element_size() for key, t in tp.utils.numerics._TABLES.items()
                 if key[0][:3] == ("sht_chunk", "sht_legendre", L))
    require(tables > 0, "sfno: no Legendre chunk kept on the card")
    run(f"sfno L={L} hidden {SFNO['hidden']} x {n}, batch {SFNO_BATCH}", sfno.apply,
        sfno.loss_fn, sfno.train_step, params, x, target, 2 * n, 4 * n, tables=tables)
    del params, x, target

    # the PCEN front end: the waveform needs no gradient, so a step's backward
    # launches nothing; with an input gradient it launches once more
    sr, n_fft = AUDIO["sr"], AUDIO["n_fft"]
    params = audio_frontend.init_params(AUDIO["n_mels"], AUDIO["n_classes"], generator=gen,
                                        device=CARD)
    x = cuda32(0.1 * rng.standard_normal((AUDIO_BATCH, AUDIO_SAMPLES)))
    labels = torch.tensor(rng.integers(0, AUDIO["n_classes"], AUDIO_BATCH), device=CARD)
    run(f"pcen front end {AUDIO['n_mels']} bands, {AUDIO_BATCH} x {AUDIO_SAMPLES}",
        functools.partial(audio_frontend.apply, sr=sr, n_fft=n_fft),
        functools.partial(audio_frontend.loss_fn, sr=sr, n_fft=n_fft),
        functools.partial(audio_frontend.train_step, sr=sr, n_fft=n_fft), params, x, labels, 1, 1)
    if full:
        leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
        xg = x.clone().requires_grad_(True)
        loss_c = compiled(functools.partial(audio_frontend.loss_fn, sr=sr, n_fft=n_fft))
        grads, launched = counted(lambda: torch.autograd.grad(loss_c(leaves, xg, labels),
                                                              tree_leaves(leaves) + [xg]))
        want = torch.autograd.grad(audio_frontend.loss_fn(leaves, xg, labels, sr, n_fft),
                                   tree_leaves(leaves) + [xg])
        err = max(rel_err(g.cpu().numpy(), w.cpu().numpy()) for g, w in zip(grads, want))
        log(f"pcen front end compiled loss with an input gradient: {launched} K1 launches, "
            f"gradients rel err {err:.3e} vs eager (worst leaf)")
        require(launched == 2 and err <= ROUTES_TOL,
                f"front end with an input gradient: {launched} launches, {err:.3e}")
        total += launched
    del params, x

    # Koopman as in phase 14: no transform; the loss and its gradient compiled
    kp = koopman.init_koopman(8, latent_dim=16, hidden=64, depth=2, generator=gen, device=CARD)
    trajs = cuda32(rng.standard_normal((256, 64, 8)))
    run("koopman 8 -> 16, hidden 64, 256 x 64 steps",
        lambda p, t: koopman.koopman_rollout(p, t[:, 0], 16),
        lambda p, t, _: koopman.koopman_loss(p, t), None, kp, trajs, None, 0, 0)

    os.makedirs("chiprun_out", exist_ok=True)
    path = os.path.join("chiprun_out", "compile_path.json")
    record = {"card": card, "torch": torch.__version__, "rows": []}
    if os.path.exists(path):
        with open(path) as fh:
            record = json.load(fh)
    record["family_rows"] = rows
    with open(path, "w") as fh:
        json.dump(record, fh, indent=1)
    log(json.dumps({"compiled_families": {"card": card, "rows": rows}}))
    return total


# ---------------------------------------------------------------------------
# Phase 31: the ops that the JAX package's tests jit, compiled
# ---------------------------------------------------------------------------

# compiled against eager: the same fp32 ops (aot_eager), or fused and
# reordered by Inductor a few ulps apart
COMPILE_OPS_TOL = ROUTES_TOL
# multitaper has no eager phase: the recurrences' shape, the JAX test's call
MULTITAPER_SHAPE = RECURRENCE_SHAPE
# griffinlim as phase 13 runs it: 2^16 samples, nperseg 1024, hop 256, 8 rounds
GRIFFIN_SAMPLES, GRIFFIN_NPERSEG, GRIFFIN_HOP, GRIFFIN_ITERS = 2 ** 16, 1024, 256, 8
# the compiled dwt loss at phase 24's wavedec shape (Whisper's clips)
DWT_LOSS_SHAPE = (16, 480_000)
# rows of each recorded plane pair held against the plain K1 (every row runs
# the same schedule; the eager phases hold whole planes of these shapes)
OPS_KERNEL_ROWS = 1024
# the transforms of queue 1 at their eager phases' shapes: fht as phase 13
# calls it, cwt_tc on phase 19's signal shape (TFR_SHAPE) and ladder
# tc_scales(4096), specaugment on phase 17's Whisper log-mel (16 clips, 3001
# frames, 80 bands), ewt as phase 24 runs it (EWT_SHAPE, EWT_BANDS)
FHT_SHAPE, FHT_ARGS = (64, 4096), dict(dln=0.01, mu=1.0, offset=0.1, bias=0.3)
SPECAUGMENT_SHAPE = (16, 3001, 80)
# the type-3 NUFFT at phase 21's size: 2^20 points on [0, 2π) and 2^20
# frequencies on [-1000, 1000), the fast path with static extents (2π about
# 0: no negative coordinate, so no F7 phase error), whose inner type-1 grid
# of 8,017 modes is K1's 16,384; NUFFT_SAMPLES outputs against the float64
# direct sum, within phase 21's bound
NUFFT3_S = 1000.0
NUFFT3_EXTENTS = dict(x_extent=2.0 * math.pi, s_extent=NUFFT3_S)
# the last ops of queue 1 at their eager phases' shapes: beat_track (tempo
# inside) on phase 19's 30-s click envelope, scattering1d at SCATTER_SHAPE
# (J 6, Q 8), vmd at VMD_SHAPE (K 4, 300 sweeps); scattering2d, which no
# eager phase runs, at its defaults (J 3, L 6) on 8 images of 256 x 256
SCATTER2D_SHAPE = (8, 256, 256)


def cwt_tc64(x: np.ndarray, scales: np.ndarray, dt: float = 1.0, w0: float = 6.0) -> np.ndarray:
    """Torrence & Compo's Morlet CWT in float64: the analytic windows
    π^-1/4·√(2πs/dt)·H(ω)·e^(-(sω − w0)²/2) times the signal's spectrum,
    inverted along time."""
    w = 2.0 * np.pi * np.fft.fftfreq(x.shape[-1], dt)
    pos = w[None, :] > 0
    psi = (np.pi ** -0.25 * np.sqrt(2.0 * np.pi * scales[:, None] / dt) * pos
           * np.exp(-0.5 * (scales[:, None] * w[None, :] - w0) ** 2 * pos))
    return np.fft.ifft(np.fft.fft(x)[..., None, :] * psi, axis=-1)


def compare(got, want, bins=None) -> float:
    """Outputs (tensors or host arrays) against ``want``: elementwise, or for
    a squeezed or reassigned plane (the first output, with ``bins`` its bin
    axes) by its bin sums, which a bin flip under another reduction order
    leaves alone (ROADMAP F2); its grid exactly."""
    def host(t):
        if not isinstance(t, torch.Tensor):
            return np.asarray(t)
        t = local(t).detach()   # a DTensor's block: the whole array in a world of one
        # a mask as 0/1: one flipped entry is a relative error of 1
        return (t.float() if t.dtype in (torch.bfloat16, torch.float16, torch.bool)
                else t).cpu().numpy()

    def on_card(t):
        return isinstance(t, torch.Tensor) and local(t).is_cuda

    errs = []
    for i, (g, w) in enumerate(zip(got, want)):
        if on_card(g) and on_card(w) and not (i == 0 and bins is not None):
            # rel_err on the card: a copy of a config-5 output to the host
            # and numpy's pass over it cost seconds
            g, w = (local(t).detach() for t in (g, w))
            if g.dtype in (torch.bfloat16, torch.float16, torch.bool):
                g, w = g.float(), w.float()
            require(g.shape == w.shape, f"shape {tuple(g.shape)} != {tuple(w.shape)}")
            finite = bool(torch.isfinite(g).all())
            errs.append(float((g - w).abs().max() / w.abs().max()) if finite else float("inf"))
            continue
        g, w = host(g), host(w)
        require(g.shape == w.shape, f"shape {g.shape} != {w.shape}")
        if i == 0 and bins is not None:
            g, w = g.sum(bins), w.sum(bins)
        errs.append(rel_err(g, w))
    return max(errs)


def compiled_op(name: str, fn, args, args2, backend: str, bins=None, tol=COMPILE_OPS_TOL):
    """One op of phase 31.  Eager on ``args`` (its K1 launches and output;
    a second eager call against the first, which differ where the op adds
    by atomics on the card), then ``fn`` under ``torch.compile(backend=backend, fullgraph=True,
    dynamic=False)`` on the same tensors: compile seconds, graph breaks by
    dynamo's counters (0, in one graph), its K1 launches (the compiled
    graph's operator node: equal to eager's), against eager
    (COMPILE_OPS_TOL; through the bin sums over ``bins``), then a second
    call on ``args2`` under ``fail_on_recompile``, against eager there
    (``tol``: a TF32 or 2-byte call compiled by Inductor, whose operands may
    round otherwise than eager's before a TF32 or 2-byte product, is held
    to that mode's own bound).
    Where the op reaches K1, the kernel is held against its plain version on
    the first OPS_KERNEL_ROWS rows of the first two and the last plane pairs
    the eager call hands it (the compiled graph calls the operator itself,
    so its planes are those).  Returns the row, the compiled
    output, the compiled function and its counted launches."""
    with recorded_launches(keep=2) as seen:
        out_e, eager_launches = counted(lambda: fn(*args))
    wrap = lambda o: o if isinstance(o, tuple) else (o,)  # noqa: E731
    # eager against itself: an op that adds by atomics on the card (index_add,
    # scatter_add) sums in another order on each call
    rep = compare(wrap(fn(*args)), wrap(out_e), bins)
    counters = torch._dynamo.utils.counters
    counters.clear()
    comp = torch.compile(fn, backend=backend, fullgraph=True, dynamic=False)
    t0 = time.perf_counter()
    out_c, launches = counted(lambda: comp(*args))
    secs = time.perf_counter() - t0
    breaks = sum(counters["graph_break"].values())
    graphs = counters["stats"]["unique_graphs"]
    err = compare(wrap(out_c), wrap(out_e), bins)
    with torch.compiler.set_stance("fail_on_recompile"):
        out2 = comp(*args2)
    err2 = compare(wrap(out2), wrap(fn(*args2)), bins)
    torch.cuda.synchronize()
    k1 = None
    if eager_launches:
        k1 = kernel_errors(sampled(seen, OPS_KERNEL_ROWS),
                           f"{name}, the compiled call's planes")
    del seen
    log(f"compiled op {name} ({backend}): compile {secs:.2f} s, {breaks} graph breaks, "
        f"{graphs} graph, K1 launches {launches} (eager {eager_launches}), rel err vs eager "
        f"{err:.3e}{' (bin sums)' if bins is not None else ''}, second call (no recompile) "
        f"{err2:.3e}, eager vs eager {rep:.3e}")
    require(breaks == 0 and graphs == 1, f"{name}: {breaks} graph breaks, {graphs} graphs")
    require(launches == eager_launches, f"{name}: {launches} K1 launches, eager {eager_launches}")
    require(max(err, err2) <= tol, f"{name}: {err:.3e}, {err2:.3e} vs eager")
    row = {"call": name, "backend": backend, "compile_s": secs, "graph_breaks": breaks,
           "k1_launches": launches, "k1_launches_eager": eager_launches,
           "rel_err_vs_eager": err, "second_call_rel_err_vs_eager": err2,
           "eager_repeat_rel_err": rep,
           "k1_vs_plain_abs_err": k1}
    return row, out_c, comp, launches


def check64(row: dict, name: str, got, want, tol: float) -> None:
    """A compiled result against float64 where its eager phase holds it there
    (none where Inductor could not compile the op)."""
    if "inductor_error" in row:
        return
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    err = rel_err(got, want)
    log(f"compiled op {name} vs float64: rel err {err:.3e} (tolerance {tol:.0e})")
    require(err <= tol, f"compiled {name}: {err:.3e} vs float64")
    row["rel_err_vs_float64"] = err


def compiled_ops(rng, card: str, inductor: bool = False) -> int:
    """Phase 31: the ops that the JAX package's tests run under ``jax.jit``
    (groups 1, 3, 4 and 6 of ROADMAP's compile queue), compiled whole at
    their eager phases' shapes: ``sosfilt``/``sosfiltfilt``/``lfilter``/
    ``filtfilt`` at 8 x 65,536, ``pfb_analysis`` with a caller's prototype at
    4,096 channels x 4 taps on 2 x 2^25, ``iradon(radon(.))`` at 400 x 400
    with 400 angles, ``multitaper``, ``griffinlim`` (the ``seed`` form), the
    TFR ops at 8 x 4096, a ``dwt`` loss and its gradient at 16 x 480,000
    (db4), ``cqt`` of 8 clips of 30 s and ``icqt`` with five Landweber
    rounds; ``fht`` at phase 13's call, ``cwt_tc`` at 8 x 4096,
    ``specaugment(seed=)`` on a 16 x 3001 x 80 log-mel (masks equal to
    eager's), ``ewt`` with phase 24's boundaries at 16 x 65,536 (its bands
    summing to the signal) and ``nufft3(method="fast")`` with static extents
    at 2^20 points and frequencies, with its refusal without extents;
    :func:`last_of_queue1` (``tempo``, ``beat_track``, ``scattering1d``,
    ``scattering2d``, ``vmd`` pinned and from the peak pick, their loops
    loop operators; the compiled loops are timed without graph replay,
    which cannot capture a loop whose trip condition the host reads).  Each
    through :func:`compiled_op` (backend ``aot_eager``: a
    full-graph capture with CUDA fake tensors and K1's node, seconds a
    call), against float64 where its eager phase checks float64; then one
    chain, ``ssq_stft(sosfilt(x))``, under Inductor.  With ``inductor``
    (``python3 chip_smoke.py compile-ops``) every op compiles with Inductor,
    and each row gets device µs by graph replay, kernels a call,
    back-to-back µs and idle share beside eager's (rows in
    ``chiprun_out/compile_ops.json``).  Returns the launches of the counted
    compiled calls and K1's worst abs error against its plain version."""
    backend = "inductor" if inductor else "aot_eager"
    rows, total = [], 0
    sub = np.asarray(ORACLE_ROWS)
    os.makedirs("chiprun_out", exist_ok=True)
    path = os.path.join("chiprun_out", "compile_ops.json")

    def record():
        with open(path, "w") as fh:
            json.dump({"card": card, "torch": torch.__version__, "inductor": inductor,
                       "rows": rows}, fh, indent=1)

    def run(name, fn, args, args2, bins=None, timing=True, tol=COMPILE_OPS_TOL, loop=False):
        nonlocal total
        t0 = time.perf_counter()
        try:
            row, out, comp, launched = compiled_op(name, fn, args, args2, backend, bins, tol)
        except torch._inductor.exc.InductorError as e:
            if not inductor:
                raise
            # compile-ops records what Inductor cannot compile and goes on
            # (the later ops read this one's eager output)
            log(f"compiled op {name}: Inductor failed: {str(e).splitlines()[0]}")
            rows.append({"call": name, "backend": backend,
                         "inductor_error": str(e).splitlines()[0]})
            record()
            return rows[-1], fn(*args)
        row["op_s"] = time.perf_counter() - t0
        total += launched
        rows.append(row)
        if inductor and timing:
            row.update(timing_pair(name, lambda: fn(*args), lambda: comp(*args), 3, 1,
                                   capture_compiled=not loop))
        record()
        return row, out

    # the IIR filters: designed on the host, keyed by their coefficients
    x, x2 = (cuda32(rng.standard_normal(RECURRENCE_SHAPE)) for _ in range(2))
    x64 = x.cpu().numpy().astype(np.float64)
    sos, (b, a) = tp.butter(6, 0.2, output="sos"), tp.butter(4, 0.2)
    for name, fn, want, tol in (
            ("sosfilt", lambda v: tp.sosfilt(sos, v), scipy.signal.sosfilt, SOSFILT_TOL),
            ("sosfiltfilt", lambda v: tp.sosfiltfilt(sos, v), scipy.signal.sosfiltfilt,
             SOSFILTFILT_TOL),
            ("lfilter", lambda v: tp.lfilter(b, a, v), scipy.signal.lfilter, LFILTER_TOL),
            ("filtfilt", lambda v: tp.filtfilt(b, a, v), scipy.signal.filtfilt, FILTFILT_TOL)):
        row, out = run(f"{name} {RECURRENCE_SHAPE}", fn, (x,), (x2,))
        design = (sos,) if name.startswith("sos") else (b, a)
        check64(row, name, out, want(*design, x64, axis=-1), tol)
    del x, x2, x64

    # the channelizer with a caller's prototype (the JAX test's form)
    K, P = PFB["n_channels"], PFB["taps_per_branch"]
    h = tp.pfb_prototype(K, P, PFB["window"])
    xp, xp2 = (cuda32(0.1 * rng.standard_normal((PFB_POLS, PFB_SAMPLES), dtype=np.float32))
               for _ in range(2))
    row, y = run(f"pfb_analysis h= {K} ch x {P} taps, {PFB_POLS} x 2^25",
                 lambda v: tp.pfb_analysis(v, K, h=h), (xp,), (xp2,))
    frames = y.shape[-2]
    pick = np.sort(rng.choice(frames, PFB_ORACLE_FRAMES, replace=False))
    idx = pick[:, None] * K + np.arange(P * K)[None, :]
    v = (xp.cpu().numpy()[:, idx].astype(np.float64) * h).reshape(
        PFB_POLS, PFB_ORACLE_FRAMES, P, K).sum(-2)
    check64(row, "pfb_analysis", y[:, pick], np.fft.fft(v, axis=-1), ORACLE_TOL)
    del xp, xp2, y, v, idx
    torch.cuda.empty_cache()

    # tomography: the angles keyed on the host
    N, T = TOMO_N, TOMO_ANGLES
    theta = np.linspace(0.0, np.pi, T, endpoint=False)
    img, img2 = cuda32(shepp_logan(N)), cuda32(rng.uniform(0.0, 1.0, (N, N)))
    row, sino = run(f"radon {N} x {N}, {T} angles", lambda v: tp.radon(v, theta), (img,), (img2,))
    rows_t = np.linspace(0, T - 1, TOMO_ORACLE_ANGLES).astype(int)
    tol_t = NUFFT_TOL + F7_PHASE * N
    check64(row, "radon", sino[rows_t], radon64(shepp_logan(N), theta[rows_t]), tol_t)
    sino = sino.contiguous()
    row, back = run(f"iradon {T} x {N}", lambda v: tp.iradon(v, theta), (sino,),
                    (sino.flip(-1).contiguous(),))
    px = rng.integers(0, N, (TOMO_ORACLE_PIXELS, 2))
    check64(row, "iradon", back[px[:, 0], px[:, 1]], iradon64(sino.cpu().numpy(), theta, px),
            tol_t)
    del img, img2, sino, back

    # multitaper (the DPSS tapers a host build) and griffinlim's seed form
    xm, xm2 = (cuda32(rng.standard_normal(MULTITAPER_SHAPE)) for _ in range(2))
    run(f"multitaper unity k=4 {MULTITAPER_SHAPE}",
        lambda v: tp.multitaper(v, fs=10.0, weighting="unity", k=4), (xm,), (xm2,))
    del xm, xm2
    # phase 13's tone pair, and another for the second call: a bin whose
    # magnitude all but vanishes (noise) carries rounding noise through every
    # round's renormalisation, in eager and compiled alike
    tone = np.arange(GRIFFIN_SAMPLES) / 16384.0
    over = GRIFFIN_NPERSEG - GRIFFIN_HOP
    mag, mag2 = (torch.abs(tp.stft(cuda32(np.sin(2 * np.pi * f0 * tone)
                                          + 0.5 * np.sin(2 * np.pi * f1 * tone)),
                                   GRIFFIN_NPERSEG, over)) for f0, f1 in ((440, 1250), (330, 990)))
    run(f"griffinlim {GRIFFIN_ITERS} rounds, 2^16 samples, nperseg {GRIFFIN_NPERSEG}",
        lambda m: tp.griffinlim(m, GRIFFIN_ITERS, GRIFFIN_NPERSEG, over, seed=SEED), (mag,), (mag2,))
    del mag, mag2

    # the time-frequency group at 8 x 4096 (phase 19's signals)
    rows_f, Tf = TFR_SHAPE
    tt = np.arange(Tf)

    def tfr_signal():
        return (np.cos(2 * np.pi * rng.uniform(0.02, 0.2, (rows_f, 1)) * tt)
                + 0.7 * np.cos(2 * np.pi * (0.05 * tt + 0.15 * tt ** 2 / (2 * Tf))))

    xf64, xf2 = tfr_signal(), tfr_signal()
    xf, xf2 = cuda32(xf64), cuda32(xf2)
    row, W = run(f"wigner_ville {TFR_SHAPE}", tp.wigner_ville, (xf,), (xf2,))
    check64(row, "wigner_ville", W[sub], wigner_ville_oracle(xf64[sub], 257), ORACLE_TOL)
    row, (St, _) = run(f"stockwell {TFR_SHAPE}", tp.stockwell, (xf,), (xf2,))
    check64(row, "stockwell", St[sub], stockwell_oracle(xf64[sub]), ORACLE_TOL)
    del W, St
    run(f"ssq_stft {TFR_SHAPE}", tp.ssq_stft, (xf,), (xf2,), bins=-1)
    run(f"ssq_cwt {TFR_SHAPE}", tp.ssq_cwt, (xf,), (xf2,), bins=-2)
    run(f"reassigned_spectrogram {TFR_SHAPE}", tp.reassigned_spectrogram, (xf,), (xf2,),
        bins=(-2, -1))

    # the compiled loss of a dwt and its gradient, as compile_sgd_step takes it
    clips, clips2 = (cuda32(0.1 * rng.standard_normal(DWT_LOSS_SHAPE)) for _ in range(2))

    def dwt_grad(v):
        leaf = v.detach().requires_grad_(True)
        return torch.autograd.grad(dwt_loss(leaf), leaf)[0]

    def dwt_loss(v):
        return torch.sum(tp.dwt(v, "db4")[1] ** 2)

    row, loss = run(f"dwt db4 loss {DWT_LOSS_SHAPE}", dwt_loss, (clips,), (clips2,), timing=False)
    comp_loss = torch.compile(dwt_loss, backend=backend, fullgraph=True, dynamic=False)
    leaf = clips.detach().requires_grad_(True)
    g = torch.autograd.grad(comp_loss(leaf), leaf)[0]
    geager = dwt_grad(clips)
    gerr = rel_err(g.cpu().numpy(), geager.cpu().numpy())
    # float64: the gradient of Σ d² is 2·Wᵀd, on two clips
    from mixed_radix_fast_fourier_transform_tpu_torch.ops import dwt as dwt_ops

    hi = dwt_ops._banks("db4")[1]
    c64 = torch.tensor(clips.cpu().numpy()[sub], dtype=torch.float64, requires_grad=True)
    n = c64.shape[-1]
    widx = torch.tensor((2 * np.arange(n // 2)[:, None] + np.arange(len(hi))[None, :]) % n)
    d64 = c64[..., widx] @ torch.tensor(hi)
    g64 = torch.autograd.grad(torch.sum(d64 ** 2), c64)[0].numpy()
    log(f"compiled dwt loss gradient: rel err {gerr:.3e} vs eager")
    require(gerr <= COMPILE_OPS_TOL, f"compiled dwt gradient: {gerr:.3e} vs eager")
    row["gradient_rel_err_vs_eager"] = gerr
    check64(row, "dwt loss gradient", g[sub], g64, ORACLE_TOL)
    del clips, clips2, leaf, g, geager, c64, d64, widx

    # the CQT of phase 19's clips and the inverse with five Landweber rounds
    fs = CQT["fs"]
    t = np.arange(CLIP_SAMPLES) / fs

    def clip_batch():
        notes = 110.0 * 2.0 ** (rng.integers(0, 36, (CLIP_BATCH, 2)) / 12.0)
        return (0.1 * rng.standard_normal((CLIP_BATCH, CLIP_SAMPLES))
                + np.sin(2 * np.pi * notes[:, :1] * t) + 0.5 * np.sin(2 * np.pi * notes[:, 1:] * t))

    c64, c2 = clip_batch(), clip_batch()
    row, C = run(f"cqt {CLIP_BATCH} x 30 s, 84 bins", tp.cqt, (cuda32(c64),), (cuda32(c2),))
    check64(row, "cqt", C[:1], cqt_oracle(c64[0], **CQT)[None], CQT_TOL)
    C2 = tp.cqt(cuda32(c2))
    run(f"icqt {CLIP_BATCH} x 30 s, 5 rounds", lambda c: tp.icqt(c, length=CLIP_SAMPLES, n_iter=5),
        (C,), (C2,))
    del C, C2, c64, c2
    torch.cuda.empty_cache()

    # the transforms of queue 1, their host tables built on the host
    t0 = time.perf_counter()
    a64, a2 = (np.abs(rng.standard_normal(FHT_SHAPE)) for _ in range(2))
    row, out = run(f"fht {FHT_SHAPE} mu=1 bias=0.3", lambda v: tp.fht(v, **FHT_ARGS),
                   (cuda32(a64),), (cuda32(a2),))
    check64(row, "fht", out, scipy.fft.fht(a64, **FHT_ARGS), ORACLE_TOL)
    scales = tp.tc_scales(TFR_SHAPE[1])
    xc64, xc2 = (rng.standard_normal(TFR_SHAPE) for _ in range(2))
    row, W = run(f"cwt_tc {TFR_SHAPE}, {len(scales)} scales", lambda v: tp.cwt_tc(v, scales),
                 (cuda32(xc64),), (cuda32(xc2),))
    check64(row, "cwt_tc", W[sub], cwt_tc64(xc64[sub], scales), ORACLE_TOL)
    del out, W
    mel, mel2 = (cuda32(np.abs(rng.standard_normal(SPECAUGMENT_SHAPE))) for _ in range(2))
    row, _ = run(f"specaugment seed= {SPECAUGMENT_SHAPE}",
                 lambda v: tp.specaugment(v, seed=SEED, mask_value=-1.0), (mel,), (mel2,))
    require(row["rel_err_vs_eager"] == 0 and row["second_call_rel_err_vs_eager"] == 0,
            "compiled specaugment(seed=) masks other cells than eager's")
    del mel, mel2
    k = np.arange(EWT_SHAPE[1])
    tones = sum(np.sin(2 * np.pi * f * k) for f in (0.02, 0.07, 0.15, 0.27, 0.41))
    ex, ex2 = ((tones[None] + 0.05 * rng.standard_normal(EWT_SHAPE)).astype(np.float32)
               for _ in range(2))
    bounds = tp.ewt_boundaries(ex[0], EWT_BANDS)
    row, bands = run(f"ewt {EWT_BANDS} bands {EWT_SHAPE}",
                     lambda v: tp.ewt(v, boundaries=bounds)[0], (cuda32(ex),), (cuda32(ex2),))
    X = np.fft.rfft(ex[:2].astype(np.float64))
    bank64 = tp.ops.ewt._partition_bank(X.shape[-1], bounds, 0.2, EWT_SHAPE[1])
    check64(row, "ewt", bands[:2], np.fft.irfft(X[:, None, :] * bank64, n=EWT_SHAPE[1]),
            ORACLE_TOL)
    row["bands_sum_rel_err"] = rel_err(bands.sum(-2).cpu().numpy(), ex)
    log(f"compiled op ewt: the bands sum to the signal, rel err {row['bands_sum_rel_err']:.3e}")
    require(row["bands_sum_rel_err"] <= ORACLE_TOL, "compiled ewt: the bands' sum")
    del bands, X, bank64
    nufft3_args = [(cuda32(rng.uniform(0.0, 2 * np.pi, NUFFT_POINTS)),
                    cuda_complex(complex64(rng, NUFFT_POINTS)),
                    cuda32(rng.uniform(-NUFFT3_S, NUFFT3_S, NUFFT_POINTS))) for _ in range(2)]
    row, f = run(f"nufft3 fast {NUFFT_POINTS:,} points, {NUFFT_POINTS:,} frequencies",
                 lambda x, c, s: tp.nufft3(x, c, s, method="fast", eps=NUFFT_EPS,
                                           **NUFFT3_EXTENTS), *nufft3_args)
    x64, c64, s64 = (v.cpu().numpy() for v in nufft3_args[0])
    ks = np.sort(rng.choice(NUFFT_POINTS, NUFFT_SAMPLES, replace=False))
    check64(row, "nufft3 fast", f[ks],
            direct_sum(lambda a, b: np.outer(s64[ks].astype(np.float64), x64[a:b]), c64, -1.0),
            NUFFT_TOL)
    try:
        torch.compile(lambda x, c, s: tp.nufft3(x, c, s, method="fast"), backend=backend,
                      fullgraph=True, dynamic=False)(*nufft3_args[0])
        refusal = "none"
    except Exception as e:  # dynamo's exception around the port's ValueError
        refusal = str(e).splitlines()[0]
    log(f"compiled nufft3(method='fast') without extents: {refusal}")
    require(refusal.startswith("ValueError: nufft3(method='fast') under torch.compile"),
            f"compiled nufft3(method='fast') without extents: {refusal}")
    rows.append({"call": "nufft3 fast without extents", "backend": backend, "refusal": refusal})
    del f, nufft3_args, x64, c64, s64
    torch.cuda.empty_cache()
    log(f"phase 31, the transforms of queue 1: {time.perf_counter() - t0:.1f} s")

    last_of_queue1(run, rng)

    if inductor:
        # the main path's configurations with Inductor (phase 32 holds them
        # with aot_eager in the whole run): "highest" and "high" at phase
        # 32's first shape, TF32 shown by the error ratio, and aot_compile's
        # CUDA graph of the "high" call; fft and the filter forward on bf16
        # planes at torch's default reduced-precision flags
        n, b = PRECISION_COMPILE_SHAPES[0]
        x, x2 = (rng.standard_normal((b, n)) + 1j * rng.standard_normal((b, n))
                 for _ in range(2))
        xt, x2t = (torch.tensor(v, dtype=torch.complex64, device=CARD) for v in (x, x2))
        errs = {}
        for prec in ("highest", "high"):
            cfg = tp.SpectralConfig(precision=prec)
            row, out = run(f"fft {n} x {b} {prec}", lambda v, cfg=cfg: tp.fft(v, config=cfg),
                           (xt,), (x2t,), tol=PRECISION_COMPILE_BOUND[prec])
            errs[prec] = rel_err(out.cpu().numpy(), np.fft.fft(x))
            check64(row, f"fft {prec}", out, np.fft.fft(x), PRECISION_COMPILE_BOUND[prec])
        ready = aot.aot_compile(lambda v: tp.fft(v, config=tp.SpectralConfig(precision="high")),
                                xt)
        err = rel_err(ready(x2t).cpu().numpy(), np.fft.fft(x2))
        log(f"aot_compile fft {n} x {b} high (CUDA graph): rel err {err:.3e} vs float64; "
            f"compiled high {errs['high'] / errs['highest']:.1f}x highest's error")
        require(errs["high"] >= TF32_PROOF * errs["highest"] and err <= TF32_TOL
                and err >= TF32_PROOF * errs["highest"],
                f"no TF32 in the compiled 'high' fft: {errs}, aot_compile {err:.3e}")
        rows.append({"call": f"aot_compile fft {n} x {b} high", "rel_err_vs_float64": err})
        del xt, x2t, ready
        fparams = tp.models.spectral_filter.init_params(
            FILTER_N, torch.Generator(device=CARD).manual_seed(SEED), CARD)
        bf16 = tp.SpectralConfig(dtype=torch.bfloat16)
        r, r2 = (cuda32(rng.standard_normal((HALF_COMPILE_BATCH, FILTER_N))) for _ in range(2))
        gain = (fparams["gain_re"] + 1j * fparams["gain_im"]).cpu().numpy()
        row, y = run(f"filter forward {FILTER_N} x {HALF_COMPILE_BATCH} bfloat16",
                     lambda u: tp.models.spectral_filter.apply(fparams, u, config=bf16), (r,),
                     (r2,), tol=HALF_TRIP_TOL)
        check64(row, "filter forward bfloat16", y.float(),
                np.fft.irfft(np.fft.rfft(r.cpu().numpy().astype(np.float64)) * gain, n=FILTER_N)
                + float(fparams["bias"]), HALF_TRIP_TOL)
        del r, r2

    # one chain of an IIR op and a K1 op, under Inductor in the whole run too
    backend = "inductor"
    run(f"ssq_stft(sosfilt(x)) {TFR_SHAPE}", lambda v: tp.ssq_stft(tp.sosfilt(sos, v)),
        (xf,), (xf2,), bins=-1)
    del xf, xf2

    record()
    log(json.dumps({"compiled_ops": {"card": card, "rows": rows}}))
    worst = max((r["k1_vs_plain_abs_err"] for r in rows if r.get("k1_vs_plain_abs_err") is not None),
                default=0.0)
    return total, worst


def last_of_queue1(run, rng) -> None:
    """Phase 31's last ops of queue 1, through ``run`` (``compiled_ops``'):
    ``tempo`` and ``beat_track`` on phase 19's click envelope (the beats
    equal to the float64 programme's), ``scattering1d`` at SCATTER_SHAPE
    (orders 0-2 of ORACLE_ROWS against float64), ``scattering2d`` at
    SCATTER2D_SHAPE, ``vmd`` at VMD_SHAPE with phase 24's pinned
    frequencies and with the peak pick (against the float64 sweeps from
    the same start).  Their loops are loop operators (one node whose body
    is traced once) and their host work runs on the host."""
    t0 = time.perf_counter()
    fs, fhop = CQT["fs"], 512
    env, env2 = (tp.onset_strength(cuda32(click_track(rng)), fs, 2048, fhop) for _ in range(2))
    row, bpm = run(f"tempo {env.shape[0]} frames", lambda e: tp.tempo(onset_env=e, sr=fs, hop=fhop),
                   (env,), (env2,))
    log(f"compiled tempo {float(bpm):.2f} BPM (clicks at 120)")
    require(abs(float(bpm) - 120.0) / 120.0 < 0.08, f"compiled tempo {float(bpm)}")
    row, (bpm, beats) = run(f"beat_track (tempo inside) {env.shape[0]} frames",
                            lambda e: tp.beat_track(onset_env=e, sr=fs, hop=fhop), (env,), (env2,),
                            loop=True)
    want = beat_oracle(env.cpu().numpy().astype(np.float64), float(bpm), fs, fhop)
    row["beats_differing_from_float64"] = int((beats.cpu().numpy() != want).sum())
    log(f"compiled beat_track: {int(beats.sum())} beats, {row['beats_differing_from_float64']} "
        f"frames differ from the float64 programme")
    require(row["beats_differing_from_float64"] == 0, "compiled beat_track differs from float64")
    del env, env2
    x64, xs2 = (rng.standard_normal(SCATTER_SHAPE) for _ in range(2))
    row, orders = run(f"scattering1d {SCATTER_SHAPE[0]} x 2^16, J 6, Q 8",
                      lambda v: tp.scattering1d(v)[:3], (cuda32(x64),), (cuda32(xs2),))
    pairs = list(scattering_ops._layout(6, 8)[1])
    want = [np.stack(o) for o in zip(*(scattering_oracle(x64[i], 6, 8, pairs) for i in ORACLE_ROWS))]
    for order, got_o, want_o in zip("012", orders, want):
        check64(row, f"scattering1d order {order}", got_o[list(ORACLE_ROWS)], want_o, ORACLE_TOL)
    del orders, x64, xs2
    im, im2 = (cuda32(rng.standard_normal(SCATTER2D_SHAPE)) for _ in range(2))
    run(f"scattering2d {SCATTER2D_SHAPE}, J 3, L 6", lambda v: tp.scattering2d(v)[:3], (im,),
        (im2,))
    del im, im2
    kk = np.arange(VMD_SHAPE[1])
    planted = np.array([0.03, 0.11, 0.2, 0.34])

    def tones():
        v = sum(np.cos(2 * np.pi * f * kk + rng.uniform(0, 6.28, (VMD_SHAPE[0], 1)))
                for f in planted)
        return (v + 0.05 * rng.standard_normal(VMD_SHAPE)).astype(np.float32)

    vx, vx2 = tones(), tones()
    pinned = planted + np.array([0.005, -0.005, 0.005, -0.005])   # phase 24's
    for form, init in (("pinned", pinned), ("peaks", "peaks")):
        row, (modes, om) = run(f"vmd K={VMD_K}, {VMD_ITERS} sweeps {VMD_SHAPE}, {form}",
                               lambda v, init=init: tp.vmd(v, VMD_K, n_iter=VMD_ITERS,
                                                           init_omega=init),
                               (cuda32(vx),), (cuda32(vx2),), loop=True)
        # the peak pick's frequencies: the same call with no sweep
        omega0 = pinned if form == "pinned" else tp.vmd(
            cuda32(vx[:2]), VMD_K, n_iter=0)[1].cpu().numpy()
        m64, o64 = vmd64(vx[:2], VMD_K, 2000.0, VMD_ITERS, omega0)
        check64(row, f"vmd {form} modes", modes[:2], m64, VMD_TOL)
        row["omega_abs_err_vs_float64"] = float(np.max(np.abs(om[:2].cpu().numpy() - o64)))
        require(row["omega_abs_err_vs_float64"] <= 1e-5, f"compiled vmd {form} frequencies")
    del vx, vx2, modes, om
    torch.cuda.empty_cache()
    log(f"phase 31, the last ops of queue 1: {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# Phase 32: the main path's configurations compiled

# (n, rows) the stage pipeline carries: Bluestein (10007, inner 20,736; 1009)
# and a length past K1's 16,384
PRECISION_COMPILE_SHAPES = ((10007, 16), (1009, 64), (32768, 16))
PRECISION_COMPILE_LADDER = ("highest", "high", "split6")
PRECISION_COMPILE_BOUND = {"highest": HIGHEST_TOL, "high": TF32_TOL, "split6": SPLIT6_TOL}
# TF32 ran in the compiled "high" call where its error against float64 is at
# least this many times the compiled "highest" one's on the same input
TF32_PROOF = 10.0
# the shapes whose compiled ladder is timed by graph replay
PRECISION_TIMED = (10007, 32768)
# split6 at 1009 is held at 10007 and 32768: its compile read 5.2-13.8 s
PRECISION_COMPILE_SKIPPED = ((1009, "split6"),)
# K1 on 2-byte planes: fft at 2048 x 1024, the filter forward at n = 4096,
# batch 1024 (K1 at 2048 x 1024 both ways)
HALF_COMPILE_FFT, HALF_COMPILE_BATCH = (1024, 2048), 1024
# the direct convolution as phase 13 runs it: 64 rows of 4000, 15 taps, same
DIRECT_SHAPE, DIRECT_TAPS = (64, 4000), 15


def backend_flags():
    """torch's four flags that the precision lever sets: matmul and cuDNN
    TF32, cuBLAS's bf16 and fp16 reduced-precision reductions."""
    mm = torch.backends.cuda.matmul
    return (mm.allow_tf32, torch.backends.cudnn.allow_tf32,
            mm.allow_bf16_reduced_precision_reduction, mm.allow_fp16_reduced_precision_reduction)


def set_backend_flags(flags) -> None:
    mm = torch.backends.cuda.matmul
    (mm.allow_tf32, torch.backends.cudnn.allow_tf32, mm.allow_bf16_reduced_precision_reduction,
     mm.allow_fp16_reduced_precision_reduction) = flags


# torch's defaults: matmul TF32 off, cuDNN TF32 on, both reductions on
TORCH_DEFAULT_FLAGS = (False, True, True, True)


def compiled_precisions(rng, card: str) -> tuple:
    """Phase 32: the main path's configurations under ``torch.compile``
    (``backend="aot_eager"`` on CUDA tensors, ``fullgraph=True,
    dynamic=False``) at torch's default flags, as the JAX package jits
    them: ``exec_complex`` (10007) or ``fft`` (1009, 32768), with ``rfft``
    but at 1009, in one function at PRECISION_COMPILE_SHAPES under
    "highest", "high" and "split6" (split6 not at 1009); ``fft``
    and the spectral filter's forward at bf16 and fp16 (K1 on 2-byte
    planes); the direct convolution at phase 13's shape.  Each through
    :func:`compiled_op`: zero graph breaks, one graph, no recompile on a
    second call with new data, K1's launches equal to eager's, compiled
    against eager (COMPILE_OPS_TOL), K1 against its plain version on the
    planes the calls hand it.  Then against float64 at phase 4b's bounds; the
    proof that TF32 ran (the compiled "high" error at least TF32_PROOF times
    the compiled "highest" one on the same input); cuDNN's TF32 flag off at
    the moment the compiled convolution runs; the process's four flags
    unchanged by the phase; and the compiled ladder's device µs by graph
    replay at PRECISION_TIMED (printed, not gated).  Returns the launches of
    the counted compiled calls and K1's worst abs error against its plain
    version on fp32 planes (2-byte planes are held to one unit in the last
    place of the largest value and stay off the kernels line, as in phase
    4b)."""
    saved = backend_flags()
    set_backend_flags(TORCH_DEFAULT_FLAGS)
    before = backend_flags()
    rows, total, worst = [], 0, 0.0

    def run(name, fn, args, args2, on_line=True):
        nonlocal total, worst
        row, out, comp, launched = compiled_op(name, fn, args, args2, "aot_eager")
        total += launched
        if on_line:
            worst = max(worst, row["k1_vs_plain_abs_err"] or 0.0)
        rows.append(row)
        return row, out, comp

    def engine_call(n, plan, cfg):
        # exec_complex at 10007 and fft at the other lengths, and rfft of the
        # real parts but at 1009, whose inner 2048 runs radix-16 butterflies
        # (hundreds of elementwise ops a trace: its compiles took 8-14 s)
        def call(v):
            if n == PRECISION_COMPILE_SHAPES[0][0]:
                zr, zi = exec_complex(plan, v.real.contiguous(), v.imag.contiguous())
                z = torch.complex(zr, zi)
            else:
                z = tp.fft(v, config=cfg)
            if n == PRECISION_COMPILE_SHAPES[1][0]:
                return (z,)
            return z, tp.rfft(v.real.contiguous(), config=cfg)
        return call

    try:
        for n, b in PRECISION_COMPILE_SHAPES:
            # one code object compiles once per precision and shape: dynamo's
            # recompile limit counts them all, so each shape starts afresh
            torch._dynamo.reset()
            x, x2 = (rng.standard_normal((b, n)) + 1j * rng.standard_normal((b, n))
                     for _ in range(2))
            xt, x2t = (torch.tensor(v, dtype=torch.complex64, device=CARD) for v in (x, x2))
            want = (np.fft.fft(x), np.fft.rfft(x.real))   # zip stops at the outputs
            errs, comps = {}, {}
            for prec in PRECISION_COMPILE_LADDER:
                if (n, prec) in PRECISION_COMPILE_SKIPPED:
                    continue
                cfg = tp.SpectralConfig(precision=prec)
                plan = tp.get_plan(n, -1, "complex", cfg)
                first = "exec_complex" if n == PRECISION_COMPILE_SHAPES[0][0] else "fft"
                rfft = "" if n == PRECISION_COMPILE_SHAPES[1][0] else "+rfft"
                row, out, comps[prec] = run(f"{first}{rfft} {n} x {b} {prec}",
                                            engine_call(n, plan, cfg), (xt,), (x2t,))
                errs[prec] = max(rel_err(o.cpu().numpy(), w) for o, w in zip(out, want))
                row["rel_err_vs_float64"] = errs[prec]
                log(f"compiled {prec} {n} x {b} vs float64: rel err {errs[prec]:.3e} "
                    f"(tolerance {PRECISION_COMPILE_BOUND[prec]:.2e})")
                require(errs[prec] <= PRECISION_COMPILE_BOUND[prec],
                        f"compiled {prec} at {n}: {errs[prec]:.3e} vs float64")
            ratio = errs["high"] / errs["highest"]
            log(f"compiled high against highest at {n} x {b}: {ratio:.1f}x the error (TF32 "
                f"ran where it is at least {TF32_PROOF:g}x)")
            require(ratio >= TF32_PROOF, f"compiled 'high' at {n} ran no TF32 product: its "
                    f"error {errs['high']:.3e} is {ratio:.1f}x the 'highest' one's")
            if n in PRECISION_TIMED:
                times = {p: 1e6 * graph_time(lambda: comps[p](xt), launches=5, replays=5)
                         for p in PRECISION_COMPILE_LADDER}
                log(f"compiled {n} x {b} device us (graph replay): " + ", ".join(
                    f"{p} {t:.2f}" for p, t in times.items()))
                rows.append({"call": f"ladder {n} x {b}", "device_us_graph_replay": times,
                             "high_over_highest_err": ratio})
            del xt, x2t, comps
        # K1 on 2-byte planes, at torch's default reduced-precision flags
        fparams = tp.models.spectral_filter.init_params(
            FILTER_N, torch.Generator(device=CARD).manual_seed(SEED), CARD)
        gain = (fparams["gain_re"] + 1j * fparams["gain_im"]).cpu().numpy()
        bias = float(fparams["bias"])
        rows_f, n_f = HALF_COMPILE_FFT
        x, x2 = (rng.standard_normal((rows_f, n_f)) + 1j * rng.standard_normal((rows_f, n_f))
                 for _ in range(2))
        r, r2 = (rng.standard_normal((HALF_COMPILE_BATCH, FILTER_N)) for _ in range(2))
        args = (torch.tensor(x, dtype=torch.complex64, device=CARD), cuda32(r))
        args2 = (torch.tensor(x2, dtype=torch.complex64, device=CARD), cuda32(r2))
        want_f = np.fft.fft(x)
        want_y = np.fft.irfft(np.fft.rfft(r) * gain, n=FILTER_N) + bias
        for name, dtype in HALF_DTYPES.items():
            cfg = tp.SpectralConfig(dtype=dtype)
            row, (f, y), _ = run(
                f"fft {n_f} x {rows_f} + filter forward {FILTER_N} x {HALF_COMPILE_BATCH} {name}",
                lambda v, u, cfg=cfg: (tp.fft(v, config=cfg),
                                       tp.models.spectral_filter.apply(fparams, u, config=cfg)),
                args, args2, on_line=False)
            err_f = rel_err(f.cpu().numpy(), want_f)
            err_y = rel_err(y.float().cpu().numpy(), want_y)
            row["rel_err_vs_float64"] = {"fft": err_f, "filter": err_y}
            log(f"compiled {name}: fft rel err {err_f:.3e}, filter forward {err_y:.3e} vs "
                f"float64, K1 launches {row['k1_launches']}")
            require(row["k1_launches"] == 3, f"compiled {name}: {row['k1_launches']} K1 "
                    f"launches, expected 3 (fft, the filter's rfft and irfft)")
            require(err_f <= HALF_FFT_TOL and err_y <= HALF_TRIP_TOL,
                    f"compiled {name}: fft {err_f:.3e}, filter {err_y:.3e} vs float64")
        del args, args2
        # the direct convolution: cuDNN's TF32 flag is on by default, and the
        # compiled graph's convolution node must turn it off around its call
        sig, sig2 = (cuda32(rng.standard_normal(DIRECT_SHAPE)) for _ in range(2))
        taps = cuda32(rng.standard_normal((1, DIRECT_TAPS)))
        flag_at_call = []
        functional = torch.nn.functional
        convs = functional.conv1d, functional.conv2d

        def noting(conv):
            def call(*a, **kw):
                if not traced(a[0]):    # not the fake run of a trace: a launch
                    flag_at_call.append(torch.backends.cudnn.allow_tf32)
                return conv(*a, **kw)
            return call

        functional.conv1d, functional.conv2d = (noting(c) for c in convs)
        try:
            row, out, _ = run(f"convolve direct {DIRECT_SHAPE[1]}x{DIRECT_TAPS} same "
                              f"b{DIRECT_SHAPE[0]}",
                              lambda u, k: tp.convolve(u, k, "same", "direct"),
                              (sig, taps), (sig2, taps))
        finally:
            functional.conv1d, functional.conv2d = convs
        sig64, taps64 = sig.cpu().numpy().astype(np.float64), taps.cpu().numpy()[0]
        err = rel_err(out.cpu().numpy(),
                      np.stack([np.convolve(v, taps64, mode="same") for v in sig64]))
        row["rel_err_vs_float64"] = err
        log(f"compiled direct convolution vs float64: rel err {err:.3e}; cudnn.allow_tf32 at "
            f"its {len(flag_at_call)} convolution calls: {flag_at_call}")
        require(err <= ORACLE_TOL, f"compiled direct convolution: {err:.3e} vs float64")
        require(flag_at_call and not any(flag_at_call),
                "a convolution ran with cuDNN's TF32 allowed")
        after = backend_flags()
        log(f"flags before phase 32 {before}, after {after}")
        require(after == before, f"phase 32 left the flags {after}, found {before}")
    finally:
        set_backend_flags(saved)
    os.makedirs("chiprun_out", exist_ok=True)
    line = json.dumps({"compiled_precisions": {"card": card, "rows": rows, "launches": total}})
    with open(os.path.join("chiprun_out", "compiled_precisions.json"), "w") as fh:
        fh.write(line + "\n")
    log(line)
    return total, worst


# ---------------------------------------------------------------------------
# Phase 33: parallel/ compiled, on a NCCL world of one (mesh (1, 1)).
# ---------------------------------------------------------------------------

# the recurrence pair compiled: its degree loop unrolls L steps into the
# graph, so phase 22's L = 512 is cut to 8 (the quadrature pair keeps
# L = 256, one product a chunk)
PAR_COMPILE_REC_L = 8
# the Kalman tracks compiled in the whole run: the log2(T) levels of the
# scans unroll into the graph (28 s to compile 4 tracks of 16 steps on an
# H100's host), so phase 26's 4 tracks of 10,000 steps are cut to 4 of 16
# (compile-parallel runs 4 of 10,000)
PAR_COMPILE_KALMAN = (4, 16)
# the 2-D sharded convolution on a 2,048² image (phase 26's fft2_pencil)
PAR_CONV2_TAPS = (7, 7)
# the API ops on a shard_batch DTensor: phase 29's fft, phase 13's
# convolution shape (4,000 samples, 129 taps, batch 64)
PAR_API_CONV = (64, 4000, 129)
# calls a compile-parallel timing row averages
PAR_COMPILE_CALLS = 3
# phase 33's groups of calls (see compiled_parallel), one process each in the
# whole run
PAR_COMPILE_GROUPS = (0, 1, 2)


def parallel_timing_pair(name: str, eager, comp) -> dict:
    """Eager and compiled forms of one sharded call side by side: the
    profiler's device µs (a NCCL call is not captured in a CUDA graph),
    back-to-back µs, idle share, device kernels, K1's µs and share, and the
    all-to-alls' device µs."""
    row = {}
    for label, fn in (("eager", eager), ("compiled", comp)):
        t = device_and_wall_us(fn, calls=PAR_COMPILE_CALLS, collectives=True)
        a2a = t["collective_spans"].get("nccl:all_to_all", 0.0)
        row[label] = {"device_us_profiler": t["device_us"], "back_to_back_us": t["wall_us"],
                      "idle_share": t["idle_share"], "device_kernels_per_call": t["kernels"],
                      "k1_us": t["k1_us"],
                      "k1_share": t["k1_us"] / t["device_us"] if t["device_us"] else None,
                      "all_to_all_us": a2a}
        log(f"{name} {label}: device {t['device_us']} us (profiler), back to back "
            f"{t['wall_us']:.2f} us, idle share {t['idle_share']}, {t['kernels']} kernels a "
            f"call, K1 {t['k1_us']:.2f} us, all-to-alls {a2a:.2f} us")
    return row


def compiled_parallel(rng, card: str, inductor: bool = False, groups=PAR_COMPILE_GROUPS):
    """Phase 33: ``parallel/`` compiled on a NCCL world of one, as the JAX
    package runs it (every ``parallel/distributed.py`` function is a
    ``shard_map``, which XLA compiles, and the JAX tests jit the
    distributed models and the batch-sharded calls), at phases 25-26's
    shapes: the four-step family at config 5 (4,096 x 65,536;
    ``fft_convolve_sharded`` at 65,408 x 129 "same"), the pencils at 256³
    and 2,048², the distributed filter's forward and ``compile_sgd_step``
    at config 5, FNet-Base's distributed mix, forward and step,
    ``fft_batch_sharded``, a Whisper ``melspectrogram`` of a
    ``shard_batch`` DTensor (16 x 480,000), the FourCastNet AFNO's step on
    sharded batches, the PFB, radar chain and Kalman tracks of phases 20
    and 23, the API ops, ``multitaper``, ``cqt`` and the filter on
    ``shard_batch`` DTensors, the sharded NUFFTs at 2^20 points and the
    SHTs at L = 256 (the recurrence pair at PAR_COMPILE_REC_L; the Kalman
    tracks at PAR_COMPILE_KALMAN in the whole run).  A global
    array goes in plain and, for the inverse forms, as the DTensor the
    forward returned.  Each call through :func:`compiled_op` (one graph, 0
    breaks, no recompile on new data, K1 launches equal to eager's,
    compiled against eager 2e-5, K1 against its plain version on the eager
    call's planes), each step through :func:`compiled_parallel_step`; the
    filter's forward against float64 (1e-5); a batch-sharded output must
    stay sharded.  ``backend="aot_eager"`` and COMPILED_DEPTH in the whole
    run; with ``inductor`` (``python3 chip_smoke.py compile-parallel``)
    Inductor at the published depths and every row timed beside eager
    (:func:`parallel_timing_pair`).  ``groups`` picks the calls: 0 the
    config-5 four-step family and filter, the 2-D convolution and pencil,
    then every family's step and the framed ops on ``shard_batch``
    DTensors (:func:`families_on_shard_batch`);
    1 the N-D pencils, FNet-Base, ``fft_batch_sharded``,
    ``melspectrogram``, the AFNO step and the NUFFTs; 2 the PFB, radar,
    Kalman, the API ops on ``shard_batch`` DTensors and the SHTs (the whole
    run compiles each group in a process of its own, all three at once:
    :func:`compiled_parallel_parts`).  Rows in
    ``chiprun_out/compile_parallel.json`` (one group's in
    ``compile_parallel_part<k>.json``).  Returns the launches of the
    counted compiled calls and K1's worst abs error."""
    from mixed_radix_fast_fourier_transform_tpu_torch.models import spectral_filter as sf

    backend = "inductor" if inductor else "aot_eager"
    par = parallel
    mesh = world_of_one()
    rows, total, worst = [], 0, 0.0
    os.makedirs("chiprun_out", exist_ok=True)
    path = os.path.join("chiprun_out", "compile_parallel.json" if len(groups) > 1
                        else f"compile_parallel_part{groups[0]}.json")
    gen = torch.Generator(device=CARD).manual_seed(SEED)

    def record():
        with open(path, "w") as fh:
            json.dump({"card": card, "torch": torch.__version__, "inductor": inductor,
                       "rows": rows}, fh, indent=1)

    def finish(row, t0, launched, timing):
        nonlocal total, worst
        row["op_s"] = time.perf_counter() - t0
        total += launched
        worst = max(worst, row.get("k1_vs_plain_abs_err") or 0.0)
        if inductor:
            row.update(parallel_timing_pair(row["call"], *timing))
        rows.append(row)
        record()

    failed = []

    def go(name, call):
        """``call()``; in ``compile-parallel`` a failed check is recorded
        and the phase goes on to time the rest (it fails at its end)."""
        if not inductor:
            return call()
        try:
            return call()
        except Exception as e:   # noqa: BLE001  (recorded, and the phase fails at its end)
            log(f"compiled {name}: FAILED: {str(e).splitlines()[0]}")
            failed.append(name)
            rows.append({"call": name, "backend": backend, "error": str(e).splitlines()[0]})
            record()
            return None

    def run(name, fn, args, args2, sharded=False):
        return go(name, lambda: run_checked(name, fn, args, args2, sharded))

    def run_checked(name, fn, args, args2, sharded):
        torch._dynamo.reset()
        t0 = time.perf_counter()
        row, out, comp, launched = compiled_op(name, fn, args, args2, backend)
        if sharded:
            placed = [tuple(o.placements) for o in (out if isinstance(out, tuple) else (out,))
                      if hasattr(o, "placements")]
            row["placements"] = [str(p) for p in placed]
            log(f"compiled {name}: output placements {row['placements']}")
            # every output that keeps the batch axis (multitaper's frequencies do not)
            require(any(any(q.is_shard() for q in p) for p in placed),
                    f"{name}: the batch-sharded output is not sharded: {placed}")
        finish(row, t0, launched, (lambda: fn(*args), lambda: comp(*args)))
        return out

    def step(name, loss_fn, eager_step, params, args, args2, lr, **kw):
        def checked():
            t0 = time.perf_counter()
            row, launched, timing = compiled_parallel_step(name, loss_fn, eager_step, params,
                                                           args, args2, lr, backend, **kw)
            finish(row, t0, launched, timing)

        go(name, checked)

    def pair(shape, complex_=True):
        def one():
            re = torch.randn(*shape, device=CARD, generator=gen)
            return torch.complex(re, torch.randn(*shape, device=CARD, generator=gen)) \
                if complex_ else re
        return one(), one()

    shard = functools.partial(par.shard_batch, mesh=mesh)

    if 0 in groups:
        # 4. the four-step family at config 5; each inverse on the forward's DTensor
        x, x2 = pair((PAR_BATCH, PAR_N))
        spec = run(f"fft_four_step {PAR_BATCH:,} x {PAR_N:,}", lambda v: par.fft_four_step(v, mesh),
                   (x,), (x2,))
        run("ifft_four_step (DTensor)", lambda v: par.ifft_four_step(v, mesh), (spec,),
            (par.fft_four_step(x2, mesh),))
        del spec
        scr = run(f"fft_four_step_scrambled {PAR_BATCH:,} x {PAR_N:,}",
                  lambda v: par.fft_four_step_scrambled(v, mesh), (x,), (x2,))
        run("ifft_four_step_scrambled (DTensor)", lambda v: par.ifft_four_step_scrambled(v, mesh),
            (scr,), (par.fft_four_step_scrambled(x2, mesh),))
        del x, x2, scr
        torch.cuda.empty_cache()
        xr, xr2 = pair(PAR_RFFT_SHAPE, False)
        half = run(f"rfft_four_step {PAR_RFFT_SHAPE}", lambda v: par.rfft_four_step(v, mesh),
                   (xr,), (xr2,))
        run("irfft_four_step (DTensor)", lambda v: par.irfft_four_step(v, mesh), (half,),
            (par.rfft_four_step(xr2, mesh),))
        del xr, xr2, half
        taps = rng.standard_normal(PAR_CONV_TAPS)
        xs, xs2 = pair((PAR_BATCH, PAR_CONV_SIGNAL), False)
        run(f"fft_convolve_sharded {PAR_BATCH:,} x {PAR_CONV_SIGNAL:,}, {PAR_CONV_TAPS} taps, same",
            lambda v: par.fft_convolve_sharded(v, taps, mesh, mode="same"), (xs,), (xs2,))
        del xs, xs2
    if 0 in groups:
        taps2 = rng.standard_normal(PAR_CONV2_TAPS)
        im, im2 = pair((PENCIL2D_N, PENCIL2D_N), False)
        run(f"fft_convolve2_sharded {PENCIL2D_N}², {PAR_CONV2_TAPS} taps",
            lambda v: par.fft_convolve2_sharded(v, taps2, mesh), (im,), (im2,))
        del im, im2
        torch.cuda.empty_cache()

        # 5. the pencils at 2,048² and 256³; each inverse on the forward's DTensor
        im, im2 = pair((PENCIL2D_N, PENCIL2D_N))
        spec = run(f"fft2_pencil {PENCIL2D_N}²", lambda v: par.fft2_pencil(v, mesh), (im,), (im2,))
        run("ifft2_pencil (DTensor)", lambda v: par.ifft2_pencil(v, mesh), (spec,),
            (par.fft2_pencil(im2, mesh),))
        del im, im2, spec
    if 1 in groups:
        vol = (PENCIL_N,) * 3
        vc, vc2 = pair(vol)
        for fwd, inv in ((par.fftn_pencil, par.ifftn_pencil), (par.fftn_pencil2, par.ifftn_pencil2)):
            spec = run(f"{fwd.__name__} {PENCIL_N}³", lambda v, f=fwd: f(v, mesh), (vc,), (vc2,))
            run(f"{inv.__name__} (DTensor)", lambda v, f=inv: f(v, mesh), (spec,), (fwd(vc2, mesh),))
            del spec
        del vc, vc2
        vr, vr2 = pair(vol, False)
        half = run(f"rfftn_pencil2 {PENCIL_N}³", lambda v: par.rfftn_pencil2(v, mesh), (vr,), (vr2,))
        run("irfftn_pencil2 (DTensor)", lambda v: par.irfftn_pencil2(v, mesh, n2=PENCIL_N), (half,),
            (par.rfftn_pencil2(vr2, mesh),))
        del half
        run(f"poisson_solve_pencil2 {PENCIL_N}³", lambda v: par.poisson_solve_pencil2(v, mesh),
            (vr - vr.mean(),), (vr2 - vr2.mean(),))
        del vr, vr2
        torch.cuda.empty_cache()

    if 0 in groups:
        # 6. the distributed models: the filter at config 5, FNet-Base
        params = sf.init_params_complex(PAR_N, generator=gen, device=CARD)
        xf, xf2 = (v * PAR_SCALE for v in pair((PAR_BATCH, PAR_N), False))
        with torch.no_grad():
            y = run(f"filter apply_distributed {PAR_BATCH:,} x {PAR_N:,}",
                    lambda p, v: sf.apply_distributed(p, v, mesh), (params, xf), (params, xf2))
        rows_ = list(PAR_ORACLE_ROWS)
        if y is not None:   # None: compile-parallel recorded its failure
            err = rel_err(local(y)[rows_].cpu().numpy(),
                          filter_oracle64(params, xf[rows_].double().cpu()).numpy())
            log(f"compiled filter apply_distributed: rel err {err:.3e} vs float64 on rows "
                f"{rows_}")
            require(err <= ORACLE_TOL, f"compiled distributed filter forward {err:.3e} vs "
                    f"float64")
            rows[-1]["rel_err_vs_float64"] = err
        del y
        target, target2 = (0.5 * torch.roll(v, PAR_DELAY, dims=-1) for v in (xf, xf2))
        step(f"filter train_step_distributed {PAR_BATCH:,} x {PAR_N:,}", sf.loss_distributed,
             sf.train_step_distributed, params, (xf, target, mesh), (xf2, target2, mesh), PAR_LR)
        del params, xf, xf2, target, target2
        torch.cuda.empty_cache()
        # 6b. every family's step and the framed ops on shard_batch DTensors
        families_on_shard_batch(run, step, shard, pair, rng, inductor)
    if 1 in groups:
        layers = FNET["n_layers"] if inductor else COMPILED_DEPTH["fnet"]
        fp = fnet.init_fnet(**{**FNET, "n_layers": layers}, generator=gen, device=CARD)
        tokens = (PAR_FNET_BATCH, FNET_SEQ, FNET["hidden"])
        xt, xt2 = pair(tokens, False)
        with torch.no_grad():
            run(f"FNet-Base fourier_mix_distributed {tokens}",
                lambda v: fnet.fourier_mix_distributed(v, mesh), (xt,), (xt2,))
            run(f"FNet-Base {layers} layers apply_distributed",
                lambda p, v: fnet.apply_distributed(p, v, mesh), (fp, xt), (fp, xt2))
        step(f"FNet-Base {layers} layers train_step_distributed", fnet.loss_distributed,
             fnet.train_step_distributed, fp, (xt, xt2, mesh), (xt2, xt, mesh), 1e-3)
        del fp, xt, xt2

        # 7. the batch-sharded calls
        xc, xc2 = pair(PAR_RFFT_SHAPE)
        run(f"fft_batch_sharded {PAR_RFFT_SHAPE}", lambda v: par.fft_batch_sharded(v, mesh),
            (xc,), (xc2,), sharded=True)
        del xc, xc2
        w = WHISPER
        clips, clips2 = (shard(0.1 * v) for v in pair((WHISPER_BATCH, WHISPER_SAMPLES), False))
        run(f"melspectrogram of a shard_batch DTensor {WHISPER_BATCH} x {WHISPER_SAMPLES:,}",
            lambda v: tp.melspectrogram(v, w["sr"], n_fft=w["n_fft"], hop=w["hop"],
                                        n_mels=w["n_mels"]), (clips,), (clips2,), sharded=True)
        del clips, clips2
        layers = AFNO["n_layers"] if inductor else COMPILED_DEPTH["afno"]
        ap = afno.init_afno(**{**AFNO, "n_layers": layers}, generator=torch.Generator().manual_seed(
            SEED), device=CARD)
        fields = [shard(cuda32(rng.standard_normal((1, *AFNO_GRID, AFNO[c]))))
                  for c in ("in_channels", "out_channels", "in_channels", "out_channels")]
        step(f"afno {AFNO['dim']} x {layers} train_step on shard_batch DTensors", afno.loss_fn,
             afno.train_step, ap, tuple(fields[:2]), tuple(fields[2:]), 1e-3, err_of=l2_err,
             tol=AFNO_GRAD_TOL, **AFNO_RUN)
        del ap, fields
        torch.cuda.empty_cache()
    if 2 in groups:
        xp, xp2 = (0.1 * v for v in pair((PFB_POLS, PFB_SAMPLES), False))
        run(f"pfb_analysis_sharded {PFB_POLS} x 2^25, {PFB['n_channels']} channels",
            lambda v: par.pfb_analysis_sharded(v, PFB["n_channels"], mesh,
                                               taps_per_branch=PFB["taps_per_branch"]),
            (xp,), (xp2,), sharded=True)
        del xp, xp2
        tx = lfm_pulse(RADAR_PULSE)
        rx, rx2 = (cuda_complex(radar_cpi(rng, tx)) for _ in range(2))
        run(f"range_doppler_cfar_sharded {tuple(rx.shape)}",
            lambda v: par.range_doppler_cfar_sharded(v, tx, mesh), (rx,), (rx2,), sharded=True)
        del rx, rx2
        model = kalman_model()
        n_tracks, T = (PAR_KALMAN_TRACKS, KALMAN_PARALLEL_T) if inductor else PAR_COMPILE_KALMAN
        tracks, tracks2 = (cuda32(np.stack([kalman_track(rng, T) for _ in range(n_tracks)]))
                           for _ in range(2))
        run(f"kalman_filter_sharded {n_tracks} tracks, T = {T:,}",
            lambda v: par.kalman_filter_sharded(*model, v, mesh), (tracks,), (tracks2,),
            sharded=True)
        del tracks, tracks2
        torch.cuda.empty_cache()
        # the API ops, multitaper, cqt and the filter on shard_batch DTensors
        a, a2 = (shard(v) for v in pair(COMPILE_FFT_SHAPE))
        run(f"fft of a shard_batch DTensor {COMPILE_FFT_SHAPE}", tp.fft, (a,), (a2,), sharded=True)
        a, a2 = (shard(v) for v in pair(COMPILE_FFT_SHAPE, False))
        run(f"rfft of a shard_batch DTensor {COMPILE_FFT_SHAPE}", tp.rfft, (a,), (a2,), sharded=True)
        b, n, k = PAR_API_CONV
        kern = cuda32(rng.standard_normal((1, k)))
        a, a2 = (shard(v) for v in pair((b, n), False))
        run(f"fft_convolve of a shard_batch DTensor {b} x {n}, {k} taps, same",
            lambda v: tp.fft_convolve(v, kern, "same"), (a,), (a2,), sharded=True)
        a, a2 = (shard(v) for v in pair(MULTITAPER_SHAPE, False))
        run(f"multitaper of a shard_batch DTensor {MULTITAPER_SHAPE}",
            lambda v: tp.multitaper(v, 1.0, 4.0), (a,), (a2,), sharded=True)
        a, a2 = (shard(0.1 * v) for v in pair((CLIP_BATCH, CLIP_SAMPLES), False))
        run(f"cqt of a shard_batch DTensor {CLIP_BATCH} x 30 s", tp.cqt, (a,), (a2,), sharded=True)
        fparams = {k: cuda32(v) for k, v in filter_params(rng, FILTER_N).items()}
        a, a2, t, t2 = (shard(v) for v in (*pair((FILTER_BATCHES[1], FILTER_N), False),
                                           *pair((FILTER_BATCHES[1], FILTER_N), False)))
        with torch.no_grad():
            run(f"spectral filter apply on a shard_batch DTensor {FILTER_BATCHES[1]} x {FILTER_N}",
                lambda p, v: sf.apply(p, v), (fparams, a), (fparams, a2), sharded=True)
        step(f"spectral filter train_step on shard_batch DTensors {FILTER_BATCHES[1]} x {FILTER_N}",
             sf.loss_fn, sf.train_step, fparams, (a, t), (a2, t2), TRAIN_LR)
        del a, a2, t, t2
        torch.cuda.empty_cache()

    if 1 in groups:
        # 8. the sharded NUFFTs at 2^20 points, then the SHTs
        kw = dict(eps=NUFFT_EPS)

        def points(lo):
            return cuda32(rng.uniform(lo, lo + 2.0 * np.pi, NUFFT_POINTS).astype(np.float32))

        pts = [(points(0.0), points(-np.pi), cuda_complex(complex64(rng, NUFFT_POINTS)))
               for _ in range(2)]
        run(f"nufft1_sharded {NUFFT_MODES:,} modes, 2^20 points",
            lambda x_, c: par.nufft1_sharded(x_, c, NUFFT_MODES, mesh, **kw),
            (pts[0][0], pts[0][2]), (pts[1][0], pts[1][2]))
        modes = [cuda_complex(complex64(rng, NUFFT_MODES)) for _ in range(2)]
        run(f"nufft2_sharded {NUFFT_MODES:,} modes, 2^20 points",
            lambda x_, f: par.nufft2_sharded(x_, f, mesh, **kw), (pts[0][0], modes[0]),
            (pts[1][0], modes[1]))
        run(f"nufft1_2d_sharded {NUFFT_MODES_2D}, 2^20 points",
            lambda x_, y_, c: par.nufft1_2d_sharded(x_, y_, c, NUFFT_MODES_2D, mesh, **kw),
            (pts[0][1], pts[0][0] - np.pi, pts[0][2]), (pts[1][1], pts[1][0] - np.pi, pts[1][2]))
        modes = [cuda_complex(complex64(rng, *NUFFT_MODES_2D)) for _ in range(2)]
        run(f"nufft2_2d_sharded {NUFFT_MODES_2D}, 2^20 points",
            lambda x_, y_, f: par.nufft2_2d_sharded(x_, y_, f, mesh, **kw),
            (pts[0][1], pts[0][0] - np.pi, modes[0]), (pts[1][1], pts[1][0] - np.pi, modes[1]))
        del pts, modes
    if 2 in groups:
        fs, fs2 = pair((SHT_BATCH, SHT_L, 2 * SHT_L), False)
        alm = run(f"sht_sharded L = {SHT_L}, batch {SHT_BATCH}", lambda v: par.sht_sharded(v, mesh),
                  (fs,), (fs2,))
        run("isht_sharded (DTensor)", lambda v: par.isht_sharded(v, mesh), (alm,),
            (par.sht_sharded(fs2, mesh),))
        L = PAR_COMPILE_REC_L
        fr, fr2 = pair((SHT_REC_BATCH, L, 2 * L), False)
        alm = run(f"sht_recurrence_sharded compensated L = {L}",
                  lambda v: par.sht_recurrence_sharded(v, mesh, compensated=True), (fr,), (fr2,))
        run("isht_recurrence_sharded (DTensor)",
            lambda v: par.isht_recurrence_sharded(v, mesh, real_output=True), (alm,),
            (par.sht_recurrence_sharded(fr2, mesh, compensated=True),))
        del fs, fs2, fr, fr2, alm
    end_world()
    torch.cuda.empty_cache()
    log(f"phase 33: {len(rows)} compiled calls, {total} K1 launches, K1 vs plain worst abs "
        f"err {worst:.3e}")
    require(not failed, f"phase 33: {len(failed)} calls failed: {failed}")
    log(json.dumps({"compiled_parallel": {"card": card, "groups": list(groups), "rows": rows,
                                          "launches": total, "worst_abs_err": worst}}))
    return total, worst


def families_on_shard_batch(run, step, shard, pair, rng, inductor: bool) -> None:
    """Phase 33's calls on ``shard_batch`` DTensors of every model family
    and the framed ops: the FNO (Burgers), S4D, FNet-Base, SFNO (lmax 255),
    PCEN front end (its labels sharded alike) and Koopman steps at their
    eager phases' widths (COMPILED_DEPTH, the published depths with
    ``inductor``), then ``stft``, ``welch``, ``resample_poly`` and
    ``hilbert`` on Whisper's 16 x 480,000, each through phase 33's
    ``run(..., sharded=True)`` / ``step`` checks."""
    pgen = torch.Generator().manual_seed(SEED)

    def depth(name, layers):
        return layers if inductor else COMPILED_DEPTH[name]

    def fields(*shapes):
        return [shard(cuda32(rng.standard_normal(s))) for s in shapes + shapes]

    n = depth("fno", FNO["n_layers"])
    x, t, x2, t2 = fields((FNO_BATCH, FNO["in_channels"], FNO_GRID),
                          (FNO_BATCH, FNO["out_channels"], FNO_GRID))
    step(f"fno {FNO['hidden']} x {n}, grid {FNO_GRID:,}, b={FNO_BATCH} train_step on shard_batch "
         f"DTensors", fno.loss_fn, fno.train_step,
         fno.init_fno(**{**FNO, "n_layers": n}, generator=pgen, device=CARD), (x, t), (x2, t2),
         1e-3)
    n = depth("s4d", S4D["n_layers"])
    x, t, x2, t2 = fields((S4D_BATCH, S4D_LENGTH, S4D["in_dim"]), (S4D_BATCH, S4D["out_dim"]))
    step(f"s4d {S4D['hidden']} x {n}, L={S4D_LENGTH}, b={S4D_BATCH} train_step on shard_batch "
         f"DTensors", s4d.loss_fn, s4d.train_step,
         s4d.init_s4d_model(**{**S4D, "n_layers": n}, generator=pgen, device=CARD), (x, t),
         (x2, t2), 1e-3)
    n = depth("fnet", FNET["n_layers"])
    x, t, x2, t2 = fields(*(((FNET_BATCH, FNET_SEQ, FNET["hidden"]),) * 2))
    step(f"FNet-Base {n} layers train_step on shard_batch DTensors", fnet.loss_fn,
         fnet.train_step, fnet.init_fnet(**{**FNET, "n_layers": n}, generator=pgen, device=CARD),
         (x, t), (x2, t2), 1e-3)
    n = depth("sfno", SFNO["n_layers"])
    L = SFNO["lmax"] + 1
    x, t, x2, t2 = fields((SFNO_BATCH, SFNO["in_channels"], L, 2 * L),
                          (SFNO_BATCH, SFNO["out_channels"], L, 2 * L))
    step(f"sfno L={L} hidden {SFNO['hidden']} x {n}, batch {SFNO_BATCH} train_step on "
         f"shard_batch DTensors", sfno.loss_fn, sfno.train_step,
         sfno.init_sfno(**{**SFNO, "n_layers": n}, generator=pgen, device=CARD), (x, t), (x2, t2),
         SFNO_LR)
    del x, t, x2, t2
    clips = [shard(cuda32(0.1 * rng.standard_normal((AUDIO_BATCH, AUDIO_SAMPLES))))
             for _ in range(2)]
    labels = [shard(torch.tensor(rng.integers(0, AUDIO["n_classes"], AUDIO_BATCH), device=CARD))
              for _ in range(2)]
    step(f"pcen front end {AUDIO['n_mels']} bands, {AUDIO_BATCH} x {AUDIO_SAMPLES} train_step on "
         f"shard_batch DTensors (labels too)", audio_frontend.loss_fn, audio_frontend.train_step,
         audio_frontend.init_params(AUDIO["n_mels"], AUDIO["n_classes"], generator=pgen,
                                    device=CARD),
         (clips[0], labels[0]), (clips[1], labels[1]), 0.05, sr=AUDIO["sr"],
         n_fft=AUDIO["n_fft"])
    del clips, labels
    trajs = fields((256, 64, 8))
    step("koopman 8 -> 16, hidden 64, 256 x 64 steps: an SGD step on koopman_loss of "
         "shard_batch DTensors", koopman.koopman_loss, functools.partial(sgd_step,
                                                                       koopman.koopman_loss),
         koopman.init_koopman(8, latent_dim=16, hidden=64, depth=2, generator=pgen, device=CARD),
         (trajs[0],), (trajs[1],), 1e-3)
    del trajs
    torch.cuda.empty_cache()

    w = WHISPER
    a, a2 = (shard(0.1 * v) for v in pair((WHISPER_BATCH, WHISPER_SAMPLES), False))
    shape = f"{WHISPER_BATCH} x {WHISPER_SAMPLES:,}"
    run(f"stft of a shard_batch DTensor {shape}, n_fft {w['n_fft']}, hop {w['hop']}",
        lambda v: tp.stft(v, w["n_fft"], w["n_fft"] - w["hop"]), (a,), (a2,), sharded=True)
    run(f"welch of a shard_batch DTensor {shape}, 1024", lambda v: tp.welch(v, w["sr"], "hann", 1024),
        (a,), (a2,), sharded=True)
    run(f"resample_poly of a shard_batch DTensor {shape} by 1/3",
        lambda v: tp.resample_poly(v, 1, 3), (a,), (a2,), sharded=True)
    run(f"hilbert of a shard_batch DTensor {shape}", tp.hilbert, (a,), (a2,), sharded=True)
    del a, a2
    torch.cuda.empty_cache()


def compiled_parallel_parts(rng, card: str):
    """Phase 33 in the whole run: :func:`compiled_parallel`'s groups, each in
    a process of its own on its own NCCL world of one, all at once (the
    phase is host-bound by its compiles, and a process compiles on one
    core), every process required to exit 0.  Returns the summed launches
    and the worst abs error; the rows go to
    ``chiprun_out/compile_parallel.json``."""
    del rng   # each process draws from SEED
    os.makedirs("chiprun_out", exist_ok=True)
    logs = [os.path.join("chiprun_out", f"compile_parallel_part{k}.log")
            for k in PAR_COMPILE_GROUPS]
    procs = []
    for k, path in zip(PAR_COMPILE_GROUPS, logs):
        with open(path, "w") as fh:   # a file, not a pipe: no process waits on a full pipe
            procs.append(subprocess.Popen(
                [sys.executable, __file__, "compile-parallel-part", str(k)], stdout=fh,
                stderr=subprocess.STDOUT, text=True))
    try:
        for p in procs:
            p.wait(timeout=900)
    finally:   # the script stops every process it starts
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    total, worst, rows = 0, 0.0, []
    for k, p, path in zip(PAR_COMPILE_GROUPS, procs, logs):
        with open(path) as fh:
            out = fh.read()
        sys.stdout.write(out)
        require(p.returncode == 0, f"phase 33 group {k} failed (rc {p.returncode}): {path}")
        line = [ln for ln in out.splitlines() if ln.startswith('{"compiled_parallel"')][-1]
        got = json.loads(line)["compiled_parallel"]
        total += got["launches"]
        worst = max(worst, got["worst_abs_err"])
        rows += got["rows"]
    with open(os.path.join("chiprun_out", "compile_parallel.json"), "w") as fh:
        json.dump({"card": card, "torch": torch.__version__, "inductor": False, "rows": rows},
                  fh, indent=1)
    log(f"phase 33: {len(rows)} compiled calls in {len(procs)} processes, {total} K1 launches, "
        f"K1 vs plain worst abs err {worst:.3e}")
    return total, worst


def compiled_parallel_step(name, loss_fn, eager_step, params, args, args2, lr, backend,
                           err_of=rel_err, tol=COMPILE_TOL, **kw):
    """``compile_sgd_step(loss_fn)`` beside ``eager_step`` on ``params``
    with the arguments ``args`` and then ``args2`` (new data, no recompile):
    the loss with its backward and the update, two graphs, 0 breaks; K1's
    launches equal to eager's; the loss (ORACLE_TOL) and the new parameters
    (``tol`` by ``err_of``; a leaf's ``rel_err`` against the larger of its
    new and old size) against the eager step's, plain tensors;
    K1 against its plain version on the eager step's planes.  Returns the
    row, the launches and the (eager, compiled) pair to time."""
    torch._dynamo.reset()
    counters = torch._dynamo.utils.counters
    counters.clear()
    comp = compile_sgd_step(loss_fn, backend=backend)
    with recorded_launches(keep=2) as seen:
        (want, wloss), eager_launches = counted(lambda: eager_step(params, *args, lr=lr, **kw))
    t0 = time.perf_counter()
    (new, loss), launched = counted(lambda: comp(params, *args, lr=lr, **kw))
    secs = time.perf_counter() - t0
    breaks = sum(counters["graph_break"].values())
    graphs = counters["stats"]["unique_graphs"]
    with torch.compiler.set_stance("fail_on_recompile"):
        new2, loss2 = comp(params, *args2, lr=lr, **kw)
    want2, wloss2 = eager_step(params, *args2, lr=lr, **kw)
    loss_err = max(abs(float(a) - float(b)) / abs(float(b))
                   for a, b in ((loss, wloss), (loss2, wloss2)))

    def leaf_err(a, b, p):
        # rel_err against the larger of the new and the old leaf's size: a
        # step can take a leaf near 0 (the filter's bias), where any
        # reordered sum reads as a large relative error
        a, b, p = (t.detach().cpu().numpy() for t in (a, b, p))
        if err_of is not rel_err or not np.all(np.isfinite(a)):
            return err_of(a, b)
        return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), np.max(np.abs(p))))

    err = max(leaf_err(a, b, p)
              for got, ref in ((new, want), (new2, want2))
              for a, b, p in zip(tree_leaves(got), tree_leaves(ref), tree_leaves(params)))
    plain = all(type(v) is torch.Tensor for v in tree_leaves(new) + tree_leaves(new2))
    k1 = kernel_errors(sampled(seen, OPS_KERNEL_ROWS), f"{name}, the eager step's planes") \
        if eager_launches else None
    del seen
    log(f"compiled step {name} ({backend}): compile {secs:.2f} s, {breaks} graph breaks, "
        f"{graphs} graphs, K1 launches {launched} (eager {eager_launches}), loss rel err "
        f"{loss_err:.3e}, new parameters {err_of.__name__} {err:.3e} vs eager, second call "
        f"with no recompile")
    require(breaks == 0 and graphs == 2, f"{name}: {breaks} graph breaks, {graphs} graphs")
    require(launched == eager_launches, f"{name}: {launched} K1 launches, eager {eager_launches}")
    require(loss_err <= ORACLE_TOL and err <= tol,
            f"{name}: loss {loss_err:.3e}, parameters {err:.3e} vs eager")
    require(plain, f"{name}: new parameters are not plain tensors")
    row = {"call": name, "backend": backend, "compile_s": secs, "graph_breaks": breaks,
           "k1_launches": launched, "k1_launches_eager": eager_launches,
           "loss_rel_err_vs_eager": loss_err, f"params_{err_of.__name__}_vs_eager": err,
           "k1_vs_plain_abs_err": k1}
    timing = (lambda: eager_step(params, *args, lr=lr, **kw),
              lambda: comp(params, *args, lr=lr, **kw))
    return row, launched, timing


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
    if argv == ["sphere"]:   # development: phases 21-22 alone, 22 with its L = 2048 row
        timed(nufft_tomography, rng, card)
        timed(sht_sfno, rng, card, True)
        return 0
    if argv == ["frontend"]:   # development: phases 23-24 alone
        for phase in (radar_radio, wavelets_leaves, slice_yardstick):
            timed(phase, *((rng, card) if phase is not slice_yardstick else (card,)))
        return 0
    if argv == ["parallel"]:   # development: phases 25-26 alone
        timed(parallel_main, rng, card)
        timed(parallel_rest, rng, card)
        return 0
    if argv == ["examples"]:   # development: phase 27 alone, its examples compiled
        timed(examples, rng, card, True)
        return 0
    if argv == ["tune"]:   # development: phase 28 alone, every length timed
        timed(tune_phase, card, 1)
        return 0
    if argv == ["float64"]:   # development: phase 4a alone
        timed(float64_path, rng, card)
        return 0
    if argv == ["precision"]:   # development: phase 4b alone
        timed(precision_path, rng, card)
        return 0
    if argv == ["compile"]:   # development: phases 29-30 alone, at the published depths
        timed(compile_path, rng, card, True)
        timed(compiled_families, rng, card, True)
        return 0
    if argv == ["compile-ops"]:   # development: phase 31 with Inductor for every op, timed
        timed(compiled_ops, rng, card, True)
        return 0
    if argv == ["compile-precision"]:   # development: phase 32 alone
        timed(compiled_precisions, rng, card)
        return 0
    if argv[:1] == ["compile-parallel"]:   # development: phase 33 with Inductor, timed
        # (the groups named after it, else all three)
        timed(compiled_parallel, rng, card, True,
              tuple(int(k) for k in argv[1:]) or PAR_COMPILE_GROUPS)
        return 0
    if argv[:1] == ["compile-parallel-part"]:   # one group of phase 33, a process of its own
        timed(compiled_parallel, rng, card, False, (int(argv[1]),))
        return 0
    if argv == ["parallel-timings"]:   # phase 25's device times, a process of their own
        timed(parallel_timings, card)
        return 0
    timed(kernel_vs_plain, rng)
    launches, max_abs, (xr, xi) = timed(main_path, rng)
    timed(float64_path, rng, card)
    precision_launches = timed(precision_path, rng, card)
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
    nufft_launches, nufft_abs = timed(nufft_tomography, rng, card)
    sphere_launches, sphere_abs = timed(sht_sfno, rng, card)
    radar_launches, radar_abs = timed(radar_radio, rng, card)
    leaves_launches, leaves_abs = timed(wavelets_leaves, rng, card)
    timed(slice_yardstick, card)
    parallel_launches, parallel_abs = timed(parallel_main, rng, card)
    rest_launches = timed(parallel_rest, rng, card)
    example_launches = timed(examples, rng, card)
    timed(tune_phase, card)
    compile_launches = timed(compile_path, rng, card)
    compile_launches += timed(compiled_families, rng, card)
    ops_compiled_launches, ops_compiled_abs = timed(compiled_ops, rng, card)
    precision_compiled_launches, precision_compiled_abs = timed(compiled_precisions, rng, card)
    parallel_compiled_launches, parallel_compiled_abs = timed(compiled_parallel_parts, rng, card)
    log(f"kernel launches by path: filter forward {launches}, "
        f"reduced precision {precision_launches}, training {train_launches}, "
        f"fno {fno_launches}, s4d + fnet + afno {family_launches}, ops tail {ops_launches}, "
        f"audio front end {frontend_launches}, audio ops {audio_launches}, "
        f"recurrences {recurrence_launches}, audio remainder {remainder_launches}, "
        f"nufft + tomography {nufft_launches}, sht + sfno {sphere_launches}, "
        f"radar + radio {radar_launches}, wavelets + leaves {leaves_launches}, "
        f"parallel main path {parallel_launches}, parallel rest {rest_launches}, "
        f"examples {example_launches}, compiled {compile_launches}, "
        f"compiled ops {ops_compiled_launches}, "
        f"compiled precisions {precision_compiled_launches}, "
        f"compiled parallel {parallel_compiled_launches}")
    launches += (precision_launches + train_launches + fno_launches + family_launches + ops_launches
                 + frontend_launches + audio_launches + recurrence_launches + remainder_launches
                 + nufft_launches + sphere_launches + radar_launches + leaves_launches
                 + parallel_launches + rest_launches + example_launches + compile_launches
                 + ops_compiled_launches + precision_compiled_launches
                 + parallel_compiled_launches)
    max_abs = max(max_abs, train_abs, fno_abs, family_abs, ops_abs, frontend_abs, audio_abs,
                  remainder_abs, nufft_abs, sphere_abs, radar_abs, leaves_abs, parallel_abs,
                  ops_compiled_abs, precision_compiled_abs, parallel_compiled_abs)
    # the kernel line's times are on the same planes as its error: the
    # forward transform of the batch-1024 filter call.  ms, plain_ms and
    # library_ms are medians of single timed calls, dispatch included
    # (time_ms); device_ms and library_device_ms are device times (graph_time).
    h = FILTER_N // 2
    xc = torch.complex(xr, xi)
    bound, bound_by = fft_bound_ms(h, xr.shape[0])

    def kernel():
        return cuda_fft.exec_kernel(xr, xi, h, -1)

    main_row = {
        "kernel_ms": time_ms(kernel),
        "plain_ms": time_ms(lambda: cuda_fft.exec_kernel_reference(xr, xi, h, -1)),
        "library_ms": time_ms(lambda: torch.fft.fft(xc)),
        "device_ms": 1e6 * graph_time(kernel) / 1e3,
        "library_device_ms": 1e6 * graph_time(lambda: torch.fft.fft(xc)) / 1e3,
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
