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
variant runs the sequence-axis FFT through the four-step all-to-all
transform, so contexts larger than one card's memory still mix globally.

Functional API as in the JAX module; :class:`FNet` wraps it as an
``nn.Module``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from ..ops.fft import fft
from ..parallel.distributed import (
    _input, _local, _mean_squared_error, _replicated, _wrap, fft_four_step,
)
from ..utils.config import DEFAULT_CONFIG, DTYPE, SpectralConfig
from ..utils.sharding import batch_sharded, data_parallel_mse, non_batch
from ..utils.tree import sgd_step
from ._common import (
    Draws, TreeModule, as_input, gelu, layer_norm, param_dtype, params_from_jax,
)

Tensor = torch.Tensor
Params = Dict[str, object]

__all__ = [
    "FNet", "apply", "apply_distributed", "fourier_mix", "fourier_mix_distributed",
    "init_fnet", "init_layer", "loss_distributed", "loss_fn", "params_from_jax",
    "train_step", "train_step_distributed",
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


def init_layer(hidden: int, ff_dim: int, generator=None, device=None, dtype=DTYPE) -> Params:
    return _init_layer(Draws(generator, device, dtype), hidden, ff_dim)


def init_fnet(hidden: int, ff_dim: Optional[int] = None, n_layers: int = 2,
              generator=None, device=None, dtype=DTYPE) -> Dict[str, List[Params]]:
    """Encoder stack over continuous inputs (batch, seq, hidden)."""
    ff_dim = ff_dim if ff_dim is not None else 4 * hidden
    draw = Draws(generator, device, dtype)
    return {"layers": [_init_layer(draw, hidden, ff_dim) for _ in range(n_layers)]}


def fourier_mix(x, *, config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    """Token mixing: Re(F_seq(F_hidden(x))) over (..., seq, hidden) real."""
    z = fft(as_input(x, dtype=config.dtype), axis=-1, config=config)   # hidden-axis FFT
    z = fft(z, axis=-2, config=config)             # sequence-axis FFT
    return z.real


def _encoder_layer(p: Params, x: Tensor, mix: Tensor) -> Tensor:
    h = layer_norm(x + mix, p["ln1_scale"], p["ln1_bias"])
    ff = gelu(h @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]
    return layer_norm(h + ff, p["ln2_scale"], p["ln2_bias"])


@batch_sharded(non_batch, arg=1)
def apply(params, x, *, config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    """(batch, seq, hidden) real -> same shape; a batch-sharded DTensor
    ``x`` runs on each rank's block (``utils.sharding.batch_sharded``)."""
    x = as_input(x, dtype=param_dtype(params))
    for p in params["layers"]:
        x = _encoder_layer(p, x, fourier_mix(x, config=config))
    return x


def loss_fn(params, x, target, *, config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    """MSE against ``target``; on a batch-sharded DTensor ``x`` the global
    MSE, data-parallel (``utils.sharding.data_parallel_mse``)."""
    if isinstance(x, DTensor):
        return data_parallel_mse(lambda p, v: apply(p, v, config=config), params, x, target)
    y = apply(params, x, config=config)
    return torch.mean((y - as_input(target, y.device, y.dtype)) ** 2)


def train_step(params, x, target, lr: float = 1e-2, *,
               config: SpectralConfig = DEFAULT_CONFIG) -> Tuple[Params, Tensor]:
    """One SGD step through both FFT passes: (new parameter tree, loss)."""
    return sgd_step(loss_fn, params, x, target, lr=lr, config=config)


# ---------------------------------------------------------------------------
# Distributed variant: data parallelism over "data" (batch) and sequence
# parallelism over "seq": the sequence-axis mixing FFT is the four-step.
# ---------------------------------------------------------------------------


def _token_spec(data_axis: Optional[str], seq_axis: str):
    return (data_axis, seq_axis, None)


def fourier_mix_distributed(
    x,
    mesh: DeviceMesh,
    *,
    data_axis: Optional[str] = "data",
    seq_axis: str = "seq",
    n1: Optional[int] = None,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> DTensor:
    """Token mixing with the sequence axis sharded over ``seq_axis``:
    ``x`` (batch, seq, hidden) sharded (data_axis, seq_axis, None).  The
    hidden-axis FFT is local; the sequence-axis FFT is the distributed
    four-step (three all-to-alls) on the (batch, hidden, seq) view."""
    spec = _token_spec(data_axis, seq_axis)
    x = _input(x, mesh)
    b, s, h = x.shape
    xl = as_input(_local(x, mesh, spec), dtype=config.dtype)
    zt = fft(xl, axis=-1, config=config).transpose(-1, -2)      # (batch, hidden, seq) block
    zt = fft_four_step(_wrap(zt, mesh, (data_axis, None, seq_axis), (b, h, s)), mesh,
                       seq_axis=seq_axis, data_axis=data_axis, n1=n1, config=config)
    return _wrap(zt.to_local().transpose(-1, -2).real, mesh, spec, (b, s, h))


def apply_distributed(
    params,
    x,
    mesh: DeviceMesh,
    *,
    data_axis: Optional[str] = "data",
    seq_axis: str = "seq",
    n1: Optional[int] = None,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> DTensor:
    """(batch, seq, hidden) real -> same shape, sharded (data_axis,
    seq_axis, None); the feed-forward and normalisations act per token on
    each rank's block.  The parameters are plain tensors every rank holds;
    their gradients come back summed over the mesh."""
    params = _replicated(params, mesh)
    spec = _token_spec(data_axis, seq_axis)
    x = _input(x, mesh)
    shape = x.shape
    xl = as_input(_local(x, mesh, spec), dtype=param_dtype(params))
    for p in params["layers"]:
        mix = fourier_mix_distributed(_wrap(xl, mesh, spec, shape), mesh,
                                      data_axis=data_axis, seq_axis=seq_axis, n1=n1,
                                      config=config)
        xl = _encoder_layer(p, xl, mix.to_local())
    return _wrap(xl, mesh, spec, shape)


def loss_distributed(params, x, target, mesh: DeviceMesh, **kw) -> Tensor:
    """The global MSE, held by every rank."""
    return _mean_squared_error(apply_distributed(params, x, mesh, **kw), target)


def train_step_distributed(
    params, x, target, mesh: DeviceMesh, lr: float = 1e-2, **kw
) -> Tuple[Params, Tensor]:
    """One SGD step of the sequence-parallel FNet: activation gradients ride
    the reverse all-to-alls of the four-step, and each rank's parameter
    gradients are summed over the mesh with an all-reduce.  Returns (new
    parameters, loss)."""
    return sgd_step(loss_distributed, params, x, target, mesh, lr=lr, **kw)


class FNet(TreeModule):
    """:func:`init_fnet` and :func:`apply` as a module, on ``device``
    (default: the card)."""

    def __init__(self, hidden: int, ff_dim: Optional[int] = None, n_layers: int = 2,
                 generator=None, device=None, *, config: SpectralConfig = DEFAULT_CONFIG):
        super().__init__(init_fnet(hidden, ff_dim, n_layers, generator, device))
        self.config = config

    def forward(self, x: Tensor) -> Tensor:
        return apply(self.param_tree(), x, config=self.config)
