"""Koopman autoencoder: learned linear latent dynamics (Lusch et al. 2018).

Counterpart of ``mixed_radix_fast_fourier_transform_tpu/models/koopman.py``.
An encoder φ lifts nonlinear system states into a latent space where one
matrix K advances time; multi-step forecasting is latent matrix powers and
one decode, ``x̂_{t+s} = ψ(K^s φ(x_t))``.  The rollout applies K step by
step, in the order the JAX module's scan does, so rounding matches; the
learned spectrum (eig K) reads like a DMD mode analysis.  No transform is
involved: the products are ``torch.matmul`` in full fp32 (keep
``torch.backends.cuda.matmul.allow_tf32`` False).

Parameter trees and plain functions as in the other model families;
:class:`Koopman` wraps them as an ``nn.Module``.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from ..utils.config import DTYPE
from ..utils.sharding import batch_sharded, global_mean, non_batch, replicated
from ._common import Draws, TreeModule, as_input, gelu, param_dtype, params_from_jax

Tensor = torch.Tensor
Params = Dict[str, object]

__all__ = ["Koopman", "init_koopman", "koopman_encode", "koopman_decode",
           "koopman_rollout", "koopman_loss", "koopman_spectrum", "params_from_jax"]


def _init_mlp(draw: Draws, sizes):
    return [{"w": draw(a, b) * math.sqrt(2.0 / a), "b": draw.zeros(b)}
            for a, b in zip(sizes[:-1], sizes[1:])]


def _mlp(layers, x: Tensor) -> Tensor:
    for i, l in enumerate(layers):
        x = x @ l["w"] + l["b"]
        if i < len(layers) - 1:
            x = gelu(x)
    return x


def init_koopman(state_dim: int, latent_dim: int = 16, hidden: int = 64, depth: int = 2,
                 generator=None, device=None, dtype=DTYPE) -> Params:
    """Encoder/decoder MLPs (``depth`` hidden layers of ``hidden``) and the
    latent advance matrix K, initialized as a slightly contractive identity
    so early rollouts don't explode."""
    if latent_dim < 1 or state_dim < 1:
        raise ValueError("state_dim and latent_dim must be >= 1")
    draw = Draws(generator, device, dtype)
    enc = _init_mlp(draw, [state_dim] + [hidden] * depth + [latent_dim])
    dec = _init_mlp(draw, [latent_dim] + [hidden] * depth + [state_dim])
    K = 0.99 * torch.eye(latent_dim, dtype=draw.dtype, device=draw.device)
    return {"enc": enc, "dec": dec, "K": K}


@batch_sharded(non_batch, arg=1)
def koopman_encode(params: Params, x) -> Tensor:
    """States (..., state_dim) → latents (..., latent_dim)."""
    return _mlp(params["enc"], as_input(x, dtype=param_dtype(params)))


@batch_sharded(non_batch, arg=1)
def koopman_decode(params: Params, z) -> Tensor:
    """Latents (..., latent_dim) → states (..., state_dim)."""
    return _mlp(params["dec"], as_input(z, dtype=param_dtype(params)))


@batch_sharded(non_batch, arg=1, lead=1)
def koopman_rollout(params: Params, x0, n_steps: int) -> Tensor:
    """Forecast: encode once, advance ``n_steps`` in the linear latent space
    (one product with K a step), decode every step.  Returns
    (n_steps + 1, ..., state_dim) including the reconstruction of x0: the
    batch axis of a batch-sharded DTensor ``x0`` (as of
    :func:`koopman_encode` and :func:`koopman_decode`) comes out one axis
    later, sharded as in ``x0``."""
    if n_steps < 0:
        raise ValueError("n_steps must be >= 0")
    zs = [koopman_encode(params, x0)]
    for _ in range(n_steps):
        zs.append(zs[-1] @ params["K"])
    return koopman_decode(params, torch.stack(zs, dim=0))


def koopman_loss(params: Params, trajs, horizon: int = 8, w_recon: float = 1.0,
                 w_pred: float = 1.0, w_lin: float = 0.3) -> Tensor:
    """Lusch-style objective on (batch, T, state_dim) trajectories:
    reconstruction ‖x − ψφx‖², multi-step prediction ‖x_{t+s} − ψ(K^sφx_t)‖²,
    and latent linearity ‖φx_{t+s} − K^sφx_t‖² over s = 1..horizon.  On a
    batch-sharded DTensor ``trajs`` every mean is the global one
    (``utils.sharding.global_mean``), data-parallel: the loss is held by
    every rank and the parameters' gradients are summed over the ranks."""
    trajs = as_input(trajs, dtype=param_dtype(params))
    if trajs.ndim != 3:
        raise ValueError("trajs must be (batch, T, state_dim)")
    T = trajs.shape[1]
    if T <= horizon:
        raise ValueError(f"need T > horizon, got T={T}, horizon={horizon}")
    if isinstance(trajs, DTensor):
        terms = _sharded_terms(replicated(params, trajs.device_mesh), trajs, horizon)
        mean = lambda t: global_mean(t.to_local(), t)  # noqa: E731
    else:
        terms, mean = _terms(params, trajs, horizon), torch.mean
    loss = w_recon * mean(terms[0])
    for pred, lin in zip(terms[1::2], terms[2::2]):
        loss = loss + (w_pred / horizon) * mean(pred)
        loss = loss + (w_lin / horizon) * mean(lin)
    return loss


def _terms(params: Params, trajs: Tensor, horizon: int) -> Tuple[Tensor, ...]:
    """The squared errors :func:`koopman_loss` averages: the
    reconstruction's, then for s = 1..horizon the prediction's and the
    latent linearity's."""
    T = trajs.shape[1]
    z = koopman_encode(params, trajs)            # (B, T, L)
    x_rec = koopman_decode(params, z)
    terms = [(x_rec - trajs) ** 2]
    K = params["K"]
    z_s = z[:, : T - horizon]                    # rollout sources
    for s in range(1, horizon + 1):
        z_s = z_s @ K                            # K^s φ(x_t)
        target_x = trajs[:, s: T - horizon + s]
        target_z = z[:, s: T - horizon + s]
        terms.append((koopman_decode(params, z_s) - target_x) ** 2)
        terms.append((z_s - target_z) ** 2)
    return tuple(terms)


# on a batch-sharded DTensor: each term sharded as ``trajs`` along the batch
_sharded_terms = batch_sharded(non_batch, arg=1)(_terms)


def koopman_spectrum(params: Params) -> Tuple[np.ndarray, np.ndarray]:
    """(eigenvalues, continuous rates log λ) of the learned latent advance,
    in float64 on the host: read like a DMD spectrum (|λ| < 1 decaying,
    angle = frequency)."""
    K = params["K"]
    if isinstance(K, torch.Tensor):
        K = K.detach().cpu().numpy()
    eigs = np.linalg.eigvals(np.asarray(K, np.float64))
    return eigs, np.log(eigs.astype(np.complex128))


class Koopman(TreeModule):
    """:func:`init_koopman` as a module, on ``device`` (default: the card);
    ``forward`` is :func:`koopman_rollout`."""

    def __init__(self, state_dim: int, latent_dim: int = 16, hidden: int = 64,
                 depth: int = 2, generator=None, device=None):
        super().__init__(init_koopman(state_dim, latent_dim, hidden, depth, generator,
                                      device))

    def forward(self, x0: Tensor, n_steps: int = 0) -> Tensor:
        return koopman_rollout(self.param_tree(), x0, n_steps)

    def loss(self, trajs: Tensor, **kw) -> Tensor:
        return koopman_loss(self.param_tree(), trajs, **kw)
