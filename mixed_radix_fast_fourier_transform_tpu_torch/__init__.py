"""mixed_radix_fast_fourier_transform_tpu_torch — the spectral library on PyTorch and CUDA.

A port of ``mixed_radix_fast_fourier_transform_tpu`` (JAX) that imports
``torch`` and numpy and never ``jax``.  Module paths and public names mirror
the JAX package.  Functions take tensors and compute on the tensor's own
device; on an NVIDIA GPU the fused Stockham FFT kernel (``csrc/``, built
with ``nvcc`` at first use) carries every length it supports, and the
plan-based stage pipeline carries the rest.

Public API (numpy.fft-flavoured):
    fft, ifft, fft2, ifft2, fftn, ifftn
    rfft, irfft, rfftn, irfftn
    fft_convolve
    plan-level: get_plan, build_complex_plan, build_real_plan, clear_plan_cache
    models: init_params, apply, params_from_jax, SpectralFilter
"""

from .ops.fft import fft, ifft, fft2, ifft2, fftn, ifftn
from .ops.rfft import rfft, irfft, rfftn, irfftn
from .ops.convolve import fft_convolve
from .plan import (
    BluesteinPlan,
    MixedRadixPlan,
    RaderPlan,
    RealPlan,
    build_bluestein_plan,
    build_complex_plan,
    build_mixed_radix_plan,
    build_rader_plan,
    build_real_plan,
    clear_plan_cache,
    get_plan,
)
from .utils.config import DEFAULT_CONFIG, SpectralConfig
from . import models, ops, utils

__all__ = [
    "fft", "ifft", "fft2", "ifft2", "fftn", "ifftn",
    "rfft", "irfft", "rfftn", "irfftn",
    "fft_convolve",
    "BluesteinPlan", "MixedRadixPlan", "RaderPlan", "RealPlan",
    "build_bluestein_plan", "build_complex_plan", "build_mixed_radix_plan",
    "build_rader_plan", "build_real_plan", "clear_plan_cache", "get_plan",
    "DEFAULT_CONFIG", "SpectralConfig",
    "models", "ops", "utils",
]
