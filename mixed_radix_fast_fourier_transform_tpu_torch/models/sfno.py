"""Spherical Fourier Neural Operator (SFNO): learning on the sphere.

Counterpart of ``mixed_radix_fast_fourier_transform_tpu/models/sfno.py``.
Channels mix in the spherical-harmonic basis, the architecture of ML weather
models (Bonev et al., ICML 2023).  Each layer computes

    y = gelu( W·x + Re isht( R_l ⊙ sht(x) ) )

with a learned complex tensor R[i, o, l] that depends on the degree l only,
so the spectral path commutes with rotations.  ``sht``/``isht`` are the
library's Gauss-Legendre pair (:mod:`..ops.sht`): fp32 Legendre products on
the device and the longitude transforms through the engine, so on the card
the fused Stockham kernel runs them forward and backward where 2L is
7-smooth and ≤ 16,384.  The per-degree mix is a complex ``torch.einsum`` at
the config's ``op_precision``, as the JAX module passes it; the pointwise
lifts and projections are full fp32 (TF32 off).

Functional API as in the JAX module (parameters are nested dicts;
``params_from_jax`` converts the JAX package's); :class:`SFNO` wraps it as an
``nn.Module``.  The activation is the tanh approximation of GELU.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch.distributed.tensor import DTensor

from ..ops.sht import isht, sht
from ..utils.config import DEFAULT_CONFIG, DTYPE, SpectralConfig
from ..utils.numerics import matmul_precision
from ..utils.sharding import batch_sharded, data_parallel_mse, non_batch
from ..utils.tree import sgd_step
from ._common import Draws, TreeModule, as_input, gelu, param_dtype, params_from_jax

Tensor = torch.Tensor
Params = Dict[str, Tensor]


def _init_layer(normal: Draws, channels: int, L: int) -> Params:
    scale = 1.0 / channels
    return {
        "r_re": scale * normal(channels, channels, L),
        "r_im": scale * normal(channels, channels, L),
        "w": scale * normal(channels, channels),
        "b": normal.zeros(channels),
    }


def init_layer(channels: int, L: int, generator=None, device=None, dtype=DTYPE) -> Params:
    return _init_layer(Draws(generator, device, dtype), channels, L)


def init_sfno(in_channels: int, hidden: int, out_channels: int, lmax: int,
              n_layers: int = 2, generator=None, device=None, dtype=DTYPE) -> Dict[str, object]:
    """Parameters for an SFNO on (batch, ch, L, 2L) sphere grids,
    L = lmax + 1 (the grid of :func:`..ops.sht.sht_grid`)."""
    L = lmax + 1
    normal = Draws(generator, device, dtype)
    return {
        "lift": {"w": normal(in_channels, hidden) / max(in_channels, 1),
                 "b": normal.zeros(hidden)},
        "layers": [_init_layer(normal, hidden, L) for _ in range(n_layers)],
        "proj": {"w": normal(hidden, out_channels) / hidden,
                 "b": normal.zeros(out_channels)},
    }


def spectral_mix(layer: Params, x: Tensor, *, config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    """(b, c, L, 2L) -> (b, c, L, 2L): per-degree channel mixing in SH space."""
    a = sht(x, config=config)                              # (b, c, 2L-1, L) complex
    r = torch.complex(layer["r_re"], layer["r_im"])        # (c_in, c_out, L)
    with matmul_precision(config.op_precision):
        mixed = torch.einsum("biql,iol->boql", a, r)
    return isht(mixed, config=config).real


def _pointwise(p: Params, x: Tensor) -> Tensor:
    """x·w + b over the channel axis at every grid point."""
    return torch.einsum("bihw,io->bohw", x, p["w"]) + p["b"][None, :, None, None]


def sfno_layer(layer: Params, x: Tensor, *, config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    with matmul_precision():
        local = _pointwise(layer, x)
    return gelu(local + spectral_mix(layer, x, config=config))


@batch_sharded(non_batch, arg=1)
def apply(params: Dict[str, object], x, *, config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    """(batch, in_channels, L, 2L) -> (batch, out_channels, L, 2L); a
    batch-sharded DTensor ``x`` runs on each rank's block
    (``utils.sharding.batch_sharded``)."""
    with matmul_precision():
        h = _pointwise(params["lift"], as_input(x, dtype=param_dtype(params)))
    for layer in params["layers"]:
        h = sfno_layer(layer, h, config=config)
    with matmul_precision():
        return _pointwise(params["proj"], h)


def loss_fn(params, x, target, *, config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    """MSE against ``target``; on a batch-sharded DTensor ``x`` the global
    MSE, data-parallel (``utils.sharding.data_parallel_mse``)."""
    if isinstance(x, DTensor):
        return data_parallel_mse(lambda p, v: apply(p, v, config=config), params, x, target)
    y = apply(params, x, config=config)
    return torch.mean((y - as_input(target, y.device, y.dtype)) ** 2)


def train_step(params, x, target, lr: float = 1e-3, *, config: SpectralConfig = DEFAULT_CONFIG):
    """One SGD step: (new parameter tree, loss)."""
    return sgd_step(loss_fn, params, x, target, lr=lr, config=config)


class SFNO(TreeModule):
    """:func:`init_sfno` and :func:`apply` as a module, on ``device``
    (default: the card)."""

    def __init__(self, in_channels: int, hidden: int, out_channels: int, lmax: int,
                 n_layers: int = 2, generator=None, device=None, *,
                 config: SpectralConfig = DEFAULT_CONFIG):
        super().__init__(init_sfno(in_channels, hidden, out_channels, lmax, n_layers,
                                   generator, device))
        self.config = config

    def forward(self, x: Tensor) -> Tensor:
        return apply(self.param_tree(), x, config=self.config)
