"""FNet encoder: parameter-free Fourier token mixing (Lee-Thorp et al. 2021).

Counterpart of the single-device part of
``mixed_radix_fast_fourier_transform_tpu/models/fnet.py``.  The library's
FFT takes the place of a transformer encoder's attention sublayer:

    mix(x)  = Re( F_seq( F_hidden(x) ) )          (one 2-D FFT, no params)
    h       = LayerNorm( x + mix(x) )
    out     = LayerNorm( h + FFN(h) )             FFN = GELU(x·W1+b1)·W2+b2

The hidden-axis transform runs over the last axis; the sequence-axis one
runs over axis −2, so the fft layer hands the fused kernel planes made
contiguous from the moved-axis view, forward and backward.  The feed-forward
products are ``torch.matmul`` in full fp32 (keep
``torch.backends.cuda.matmul.allow_tf32`` False).  The sequence-parallel
variant of the JAX module comes with ``parallel/``.

Functional API as in the JAX module; :class:`FNet` wraps it as an
``nn.Module``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from ..ops.fft import fft
from ..utils.config import DEFAULT_CONFIG, SpectralConfig
from ..utils.tree import sgd_step
from ._common import Draws, TreeModule, as_input, gelu, layer_norm, params_from_jax

Tensor = torch.Tensor
Params = Dict[str, object]

__all__ = [
    "FNet", "apply", "fourier_mix", "init_fnet", "init_layer", "loss_fn",
    "params_from_jax", "train_step",
]


def _init_layer(draw: Draws, hidden: int, ff_dim: int) -> Params:
    return {
        "ln1_scale": draw.ones(hidden),
        "ln1_bias": draw.zeros(hidden),
        "w1": draw(hidden, ff_dim) / math.sqrt(hidden),
        "b1": draw.zeros(ff_dim),
        "w2": draw(ff_dim, hidden) / math.sqrt(ff_dim),
        "b2": draw.zeros(hidden),
        "ln2_scale": draw.ones(hidden),
        "ln2_bias": draw.zeros(hidden),
    }


def init_layer(hidden: int, ff_dim: int, generator=None, device=None) -> Params:
    return _init_layer(Draws(generator, device), hidden, ff_dim)


def init_fnet(hidden: int, ff_dim: Optional[int] = None, n_layers: int = 2,
              generator=None, device=None) -> Dict[str, List[Params]]:
    """Encoder stack over continuous inputs (batch, seq, hidden)."""
    ff_dim = ff_dim if ff_dim is not None else 4 * hidden
    draw = Draws(generator, device)
    return {"layers": [_init_layer(draw, hidden, ff_dim) for _ in range(n_layers)]}


def fourier_mix(x, *, config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    """Token mixing: Re(F_seq(F_hidden(x))) over (..., seq, hidden) real."""
    z = fft(as_input(x), axis=-1, config=config)   # hidden-axis FFT
    z = fft(z, axis=-2, config=config)             # sequence-axis FFT
    return z.real


def _encoder_layer(p: Params, x: Tensor, mix: Tensor) -> Tensor:
    h = layer_norm(x + mix, p["ln1_scale"], p["ln1_bias"])
    ff = gelu(h @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]
    return layer_norm(h + ff, p["ln2_scale"], p["ln2_bias"])


def apply(params, x, *, config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    """(batch, seq, hidden) real -> same shape."""
    x = as_input(x)
    for p in params["layers"]:
        x = _encoder_layer(p, x, fourier_mix(x, config=config))
    return x


def loss_fn(params, x, target, *, config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    y = apply(params, x, config=config)
    return torch.mean((y - as_input(target, y.device)) ** 2)


def train_step(params, x, target, lr: float = 1e-2, *,
               config: SpectralConfig = DEFAULT_CONFIG) -> Tuple[Params, Tensor]:
    """One SGD step through both FFT passes: (new parameter tree, loss)."""
    return sgd_step(loss_fn, params, x, target, lr=lr, config=config)


class FNet(TreeModule):
    """:func:`init_fnet` and :func:`apply` as a module, on ``device``
    (default: the card)."""

    def __init__(self, hidden: int, ff_dim: Optional[int] = None, n_layers: int = 2,
                 generator=None, device=None, *, config: SpectralConfig = DEFAULT_CONFIG):
        super().__init__(init_fnet(hidden, ff_dim, n_layers, generator, device))
        self.config = config

    def forward(self, x: Tensor) -> Tensor:
        return apply(self.param_tree(), x, config=self.config)
