"""Flagship model: a trainable spectral filter.

Counterpart of the single-device part of
``mixed_radix_fast_fourier_transform_tpu/models/spectral_filter.py``:

    y = irfft( rfft(x) ⊙ (gain_re + i·gain_im) ) + bias

over the last axis of a (..., n) real signal, with its MSE loss and one SGD
step.  Gradients flow through the whole engine: through the fused kernel
(its backward is the kernel at the opposite sign) on the card as on the
CPU, or through the stage pipeline.  Parameters live on the card unless the
caller asks for another device.  The distributed variant of the JAX module
comes with ``parallel/``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..ops.rfft import irfft, rfft
from ..utils.config import DEFAULT_CONFIG, DTYPE, SpectralConfig
from ..utils.numerics import as_tensor, resolve_device
from ..utils.tree import sgd_step
from ._common import params_from_jax

Tensor = torch.Tensor
Params = Dict[str, Tensor]


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


def apply(params: Params, x: Tensor, *, config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    """Forward pass: (..., n) real -> (..., n) real."""
    x = as_tensor(x)
    n = x.shape[-1]
    spec = rfft(x, config=config)
    gain = torch.complex(params["gain_re"], params["gain_im"])
    return irfft(spec * gain, n=n, config=config) + params["bias"]


def loss_fn(
    params: Params, x: Tensor, target: Tensor, *, config: SpectralConfig = DEFAULT_CONFIG
) -> Tensor:
    """MSE between the filtered signal and the target."""
    y = apply(params, x, config=config)
    return torch.mean((y - as_tensor(target, y.device)) ** 2)


def train_step(
    params: Params,
    x: Tensor,
    target: Tensor,
    lr: float = 1e-2,
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tuple[Params, Tensor]:
    """One SGD step, differentiating through the whole FFT engine: returns
    (new parameters, loss).  The parameters given are not changed.  With
    the fused kernel it launches three times: rfft, irfft, and irfft's
    backward (the input needs no gradient, so rfft's is never computed)."""
    return sgd_step(loss_fn, params, x, target, lr=lr, config=config)


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
