"""Runtime configuration for the PyTorch port of the spectral library.

Counterpart of ``mixed_radix_fast_fourier_transform_tpu/utils/config.py``.
The plan levers keep the JAX package's defaults and validation so that both
packages build the same plans and their outputs compare stage for stage.
Those defaults were tuned on another accelerator and are kept for parity
only; none of them is evidence for the GPU.

fp32 is the one working precision of the port: there is no ``precision``
lever (the JAX package's reduced-precision passes exist for the TPU's bf16
matrix unit).  TF32 stays off for the stage matmuls; callers that need
fp32 accuracy on the GPU keep ``torch.backends.cuda.matmul.allow_tf32``
False, which is PyTorch's default.
"""

from __future__ import annotations

import dataclasses

import torch

# Working dtype of the (re, im) planes.
DTYPE = torch.float32


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
    # Padded length for Bluestein and convolution: "pow23" (smallest 2^a or
    # 3·2^a), "pow2" or "fast" (2·3·5·7-smooth).
    pad_mode: str = "pow23"
    # Rader's algorithm for primes whose n−1 is max_stage-smooth: "auto" or
    # "off" (Bluestein for every non-smooth length).
    rader: str = "off"
    # Stages of size 2/4/8/16 as elementwise butterflies instead of dense
    # DFT matmuls: "auto"/"16" (2..16), "8" (2..8) or "off".
    butterfly: str = "auto"
    # Fused Stockham kernel (ops/cuda_fft.py) for lengths it supports:
    # None (default) or True = on, False = always the stage pipeline.  On a
    # CUDA tensor "on" launches the CUDA kernel; on a CPU tensor it runs the
    # kernel's plain PyTorch version.
    use_kernel: "bool | None" = None

    def __post_init__(self):
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
