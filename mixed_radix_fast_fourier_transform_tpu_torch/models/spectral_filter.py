"""Flagship model: a learned spectral filter.

Counterpart of the forward path of
``mixed_radix_fast_fourier_transform_tpu/models/spectral_filter.py``:

    y = irfft( rfft(x) ⊙ (gain_re + i·gain_im) ) + bias

over the last axis of a (..., n) real signal.  This port covers the forward
pass; on a CUDA tensor the fused kernel has no backward yet, so run the
forward under ``torch.no_grad()`` or ``torch.inference_mode()`` there.
Parameters live on the card unless the caller asks for another device.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from ..ops.rfft import irfft, rfft
from ..utils.config import DEFAULT_CONFIG, DTYPE, SpectralConfig

Tensor = torch.Tensor
Params = Dict[str, Tensor]


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; None means the card ("cuda").  There is
    no fallback to the CPU: without a card, using the result raises."""
    return torch.device("cuda" if device is None else device)


def init_params(
    n: int,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> Params:
    """Per-bin complex gain (identity plus 0.01·N(0, 1) noise) and a zero
    bias, drawn from ``generator`` on its own device (the CPU when None),
    then placed on ``device`` (default: the card, see resolve_device)."""
    n_bins = n // 2 + 1
    gen_device = generator.device if generator is not None else torch.device("cpu")
    device = resolve_device(device)

    def noise():
        return torch.randn(n_bins, generator=generator, dtype=DTYPE,
                           device=gen_device).to(device)

    return {
        "gain_re": 1.0 + 0.01 * noise(),
        "gain_im": 0.01 * noise(),
        "bias": torch.zeros((), dtype=DTYPE, device=device),
    }


def params_from_jax(params: Mapping[str, np.ndarray], device=None) -> Params:
    """The JAX package's parameters (numpy arrays) as fp32 tensors on
    ``device`` (default: the card, see resolve_device), so that both
    packages compute the same function."""
    device = resolve_device(device)
    return {
        k: torch.tensor(np.asarray(v), dtype=DTYPE, device=device)
        for k, v in params.items()
    }


def apply(params: Params, x: Tensor, *, config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    """Forward pass: (..., n) real -> (..., n) real."""
    x = torch.as_tensor(x)
    n = x.shape[-1]
    spec = rfft(x, config=config)
    gain = torch.complex(params["gain_re"], params["gain_im"])
    return irfft(spec * gain, n=n, config=config) + params["bias"]


class SpectralFilter(nn.Module):
    """The spectral filter for length-``n`` signals as a module holding
    ``gain_re``, ``gain_im`` and ``bias`` (set them from other parameters
    with ``load_state_dict``), on ``device`` (default: the card)."""

    def __init__(
        self,
        n: int,
        generator: Optional[torch.Generator] = None,
        device=None,
        *,
        config: SpectralConfig = DEFAULT_CONFIG,
    ):
        super().__init__()
        self.n = n
        self.config = config
        p = init_params(n, generator, device)
        self.gain_re = nn.Parameter(p["gain_re"])
        self.gain_im = nn.Parameter(p["gain_im"])
        self.bias = nn.Parameter(p["bias"])

    def forward(self, x: Tensor) -> Tensor:
        params = {"gain_re": self.gain_re, "gain_im": self.gain_im,
                  "bias": self.bias}
        return apply(params, x, config=self.config)
