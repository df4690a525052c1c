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

from ..utils.config import DTYPE
from ._common import Draws, TreeModule, as_input, gelu, params_from_jax

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
                 generator=None, device=None) -> Params:
    """Encoder/decoder MLPs (``depth`` hidden layers of ``hidden``) and the
    latent advance matrix K, initialized as a slightly contractive identity
    so early rollouts don't explode."""
    if latent_dim < 1 or state_dim < 1:
        raise ValueError("state_dim and latent_dim must be >= 1")
    draw = Draws(generator, device)
    enc = _init_mlp(draw, [state_dim] + [hidden] * depth + [latent_dim])
    dec = _init_mlp(draw, [latent_dim] + [hidden] * depth + [state_dim])
    K = 0.99 * torch.eye(latent_dim, dtype=DTYPE, device=draw.device)
    return {"enc": enc, "dec": dec, "K": K}


def koopman_encode(params: Params, x) -> Tensor:
    """States (..., state_dim) → latents (..., latent_dim)."""
    return _mlp(params["enc"], as_input(x))


def koopman_decode(params: Params, z) -> Tensor:
    """Latents (..., latent_dim) → states (..., state_dim)."""
    return _mlp(params["dec"], as_input(z))


def koopman_rollout(params: Params, x0, n_steps: int) -> Tensor:
    """Forecast: encode once, advance ``n_steps`` in the linear latent space
    (one product with K a step), decode every step.  Returns
    (n_steps + 1, ..., state_dim) including the reconstruction of x0."""
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
    and latent linearity ‖φx_{t+s} − K^sφx_t‖² over s = 1..horizon."""
    trajs = as_input(trajs)
    if trajs.ndim != 3:
        raise ValueError("trajs must be (batch, T, state_dim)")
    T = trajs.shape[1]
    if T <= horizon:
        raise ValueError(f"need T > horizon, got T={T}, horizon={horizon}")
    z = koopman_encode(params, trajs)            # (B, T, L)
    x_rec = koopman_decode(params, z)
    loss = w_recon * torch.mean((x_rec - trajs) ** 2)
    K = params["K"]
    z_s = z[:, : T - horizon]                    # rollout sources
    for s in range(1, horizon + 1):
        z_s = z_s @ K                            # K^s φ(x_t)
        target_x = trajs[:, s: T - horizon + s]
        target_z = z[:, s: T - horizon + s]
        loss = loss + (w_pred / horizon) * torch.mean(
            (koopman_decode(params, z_s) - target_x) ** 2)
        loss = loss + (w_lin / horizon) * torch.mean((z_s - target_z) ** 2)
    return loss


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
