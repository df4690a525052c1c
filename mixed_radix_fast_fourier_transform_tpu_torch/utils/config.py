"""Runtime configuration for the PyTorch port of the spectral library.

Counterpart of ``mixed_radix_fast_fourier_transform_tpu/utils/config.py``.
The plan levers keep the JAX package's defaults and validation so that both
packages build the same plans and their outputs compare stage for stage.
Those defaults were tuned on another accelerator and are kept for parity
only; none of them is evidence for the GPU.

The working dtype (``dtype``) is fp32 (the default), float64 (the JAX
package's x64 route: the stage pipeline and every op that reads
``config.dtype`` compute in float64, and the fused kernel is never taken),
or one of the two 2-byte types, ``torch.bfloat16`` and ``torch.float16``
(the JAX package's working-dtype mode for ML pipelines: the planes, the
stage products and the plan tables are at that dtype, products accumulate
in fp32 and round to it, and complex results are complex64, as the JAX
package returns them).  The fused kernel takes fp32 and 2-byte planes; it
loads 2-byte values into fp32, computes in fp32 and rounds its stores.

The matrix-product precision (``precision``) follows ``jax.lax.Precision``
on a GPU.  "highest" (the default) is IEEE fp32 everywhere.  "high" and
"default" let fp32 products on a CUDA tensor run in TF32 on the tensor cores
(``torch.backends.cuda.matmul.allow_tf32``, and cuDNN's flag for a product
computed as a convolution, set only around the product); on the CPU they are
fp32, since torch's CPU products ignore the flag as XLA:CPU ignores the
lever.  "split6" (stage products only) cuts each fp32 operand into three
bf16-exact chunks and sums the six leading chunk products in fp32 on every
device (on the card with IEEE fp32 FMAs: the tensor cores' accumulation
missed split6's 5e-6 bound there, ``tools/tune.py split6``); a
tuple of these names gives one per stage (stage i takes
``precision[min(i, len - 1)]``).  Every op outside the stage pipeline reads
``op_precision``, where a tuple or "split6" is "highest".  The fused kernel
ignores the lever, as the JAX kernel does.

Select them as ``SpectralConfig(precision="high")`` or
``SpectralConfig(dtype=torch.bfloat16)``; both combine with every other
field (but "split6" needs fp32 planes).
"""

from __future__ import annotations

import dataclasses

import torch

# Default working dtype of the (re, im) planes, and the dtype of the ops
# that the JAX package fixes at float32.
DTYPE = torch.float32
# The working dtypes a config may name.
DTYPES = (torch.float32, torch.float64, torch.bfloat16, torch.float16)
# The matrix-product precisions, as ``jax.lax.Precision`` names them, and the
# stage pipeline's own "split6".
PRECISIONS = ("highest", "high", "default")
STAGE_PRECISIONS = PRECISIONS + ("split6",)


def precision_name(p):
    """``p`` in canonical form: a lower-case name, or a tuple of them (one
    per stage).  Raises ValueError, naming the field, for anything else."""
    if isinstance(p, str) and p.lower() in STAGE_PRECISIONS:
        return p.lower()
    if isinstance(p, (tuple, list)) and p and all(
            isinstance(q, str) and q.lower() in STAGE_PRECISIONS for q in p):
        return tuple(q.lower() for q in p)
    raise ValueError(
        f"precision must be 'highest', 'high', 'default', 'split6' or a "
        f"non-empty tuple of them (one per stage), got {p!r}"
    )


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
    # Working dtype of the (re, im) planes on the device: torch.float32,
    # torch.float64, torch.bfloat16 or torch.float16.  Complex results are
    # complex128 for float64 and complex64 otherwise.
    dtype: torch.dtype = DTYPE
    # Matrix-product precision of the stage DFTs: "highest" (fp32),
    # "high"/"default" (TF32 on a CUDA tensor, fp32 on the CPU), "split6"
    # (three bf16-exact chunks a side, six products summed in fp32), or a
    # tuple of those, one per stage (stage i uses precision[min(i, len-1)]).
    # Names are case-insensitive.  Other ops read ``op_precision``.
    precision: "str | tuple" = "highest"
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

    @property
    def op_precision(self) -> str:
        """``precision`` for the products outside the stage pipeline: the
        per-stage tuples and "split6" belong to the stage products only and
        resolve to "highest", their accuracy's equal."""
        p = precision_name(self.precision)
        return "highest" if isinstance(p, tuple) or p == "split6" else p

    def __post_init__(self):
        if self.dtype not in DTYPES:
            raise ValueError(
                "dtype must be torch.float32, torch.float64, torch.bfloat16 "
                f"or torch.float16, got {self.dtype!r}"
            )
        if self.dtype == torch.float64 and self.use_kernel:
            raise ValueError(
                "use_kernel=True does not take dtype=torch.float64: the fused "
                "kernel computes in fp32"
            )
        precision_name(self.precision)
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
