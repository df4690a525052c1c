"""Runtime configuration for the PyTorch port of the spectral library.

Counterpart of ``mixed_radix_fast_fourier_transform_tpu/utils/config.py``.
The plan levers keep the JAX package's defaults and validation so that both
packages build the same plans and their outputs compare stage for stage.
Those defaults were tuned on another accelerator and are kept for parity
only; none of them is evidence for the GPU.

The working dtype is fp32 (the default) or float64 (``dtype=torch.float64``,
the JAX package's x64 route): the stage pipeline and every op that reads
``config.dtype`` then compute in float64 on the device, and the fused
kernel, which is fp32 by construction, is never taken.  There is no
``precision`` lever and no bf16 (the JAX package's reduced-precision passes
exist for the TPU's bf16 matrix unit).  TF32 stays off for the stage
matmuls; callers that need fp32 accuracy on the GPU keep
``torch.backends.cuda.matmul.allow_tf32`` False, which is PyTorch's default.
"""

from __future__ import annotations

import dataclasses

import torch

# Default working dtype of the (re, im) planes, and the dtype of the ops
# that the JAX package fixes at float32.
DTYPE = torch.float32
# The working dtypes a config may name.
DTYPES = (torch.float32, torch.float64)


@dataclasses.dataclass(frozen=True)
class SpectralConfig:
    # Largest dense DFT stage the stage pipeline emits; lengths with a larger
    # prime factor go to Rader or Bluestein.
    max_stage: int = 256
    # Lengths <= this are done as one dense DFT stage.
    direct_dft_max: int = 64
    # Stage grouping: "balanced" (fewest stages, then equal sizes) or
    # "greedy" (descending-prime packing).
    stage_strategy: str = "balanced"
    # Working dtype of the (re, im) planes on the device: torch.float32 or
    # torch.float64.  Complex results are complex64 or complex128 to match.
    dtype: torch.dtype = DTYPE
    # Padded length for Bluestein and convolution: "pow23" (smallest 2^a or
    # 3·2^a), "pow2" or "fast" (2·3·5·7-smooth).
    pad_mode: str = "pow23"
    # Rader's algorithm for primes whose n−1 is max_stage-smooth: "auto" or
    # "off" (Bluestein for every non-smooth length).
    rader: str = "off"
    # Stages of size 2/4/8/16 as elementwise butterflies instead of dense
    # DFT matmuls: "auto"/"16" (2..16), "8" (2..8) or "off".
    butterfly: str = "auto"
    # Fused Stockham kernel (ops/cuda_fft.py) for the lengths it supports
    # (7-smooth, n <= 16,384).  True: always (a CUDA tensor launches the
    # kernel, a CPU tensor runs its plain PyTorch version); False: never,
    # the stage pipeline.  None (default): the kernel on a CUDA tensor at
    # every length it takes, and the stage pipeline on a CPU tensor (3.6-45x
    # faster there than the plain version; `tools/tune.py kernel --device
    # cpu` at n = 64 to 16,384; PERF.md).  On the card the sweep
    # (`tools/tune.py kernel all`, chip_smoke.py phase 28, NVIDIA H100 80GB
    # HBM3 at 700 W) has the kernel ahead of the stage pipeline at 361 of
    # 399 lengths at 2^22 values a call and behind at 38 below 128; at the
    # row counts the examples send there the kernel was the faster route
    # (phase 27), so short rows are the kernel's to win (ROADMAP queue 2).
    use_kernel: "bool | None" = None

    def __post_init__(self):
        if self.dtype not in DTYPES:
            raise ValueError(
                f"dtype must be torch.float32 or torch.float64, got {self.dtype!r}"
            )
        if self.dtype != torch.float32 and self.use_kernel:
            raise ValueError(
                "use_kernel=True needs dtype=torch.float32: the fused kernel "
                "is fp32 only"
            )
        if self.pad_mode not in ("pow2", "pow23", "fast"):
            raise ValueError(
                f"pad_mode must be 'pow2', 'pow23' or 'fast', got {self.pad_mode!r}"
            )
        if self.rader not in ("auto", "off"):
            raise ValueError(
                f"rader must be 'auto' or 'off', got {self.rader!r}"
            )
        if self.butterfly not in ("auto", "off", "8", "16"):
            raise ValueError(
                f"butterfly must be 'auto', 'off', '8' or '16', got "
                f"{self.butterfly!r}"
            )
        if self.stage_strategy not in ("balanced", "greedy"):
            raise ValueError(
                f"stage_strategy must be 'balanced' or 'greedy', "
                f"got {self.stage_strategy!r}"
            )
        if self.max_stage < 2:
            raise ValueError(f"max_stage must be >= 2, got {self.max_stage}")
        if self.direct_dft_max < 1:
            raise ValueError(
                f"direct_dft_max must be >= 1, got {self.direct_dft_max}"
            )


DEFAULT_CONFIG = SpectralConfig()
