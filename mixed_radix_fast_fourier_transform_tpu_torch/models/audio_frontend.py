"""Trainable audio frontend: mel spectrogram + learnable PCEN + linear head.

Counterpart of ``mixed_radix_fast_fourier_transform_tpu/models/audio_frontend.py``:
the keyword-spotting / acoustic-event frontend of Wang et al. 2017
("Trainable Frontend For Robust and Far-Field Keyword Spotting"), where
PCEN's gain, bias, power and smoothing coefficients are LEARNED per mel band
instead of fixed.  The whole pipeline (engine STFT → mel filterbank matmul →
one-pole smoother over frames → PCEN pointwise → mean-pool → linear
classifier) is a parameter-tree functional model like the other families
(init/apply/loss_fn/train_step), differentiated through every FFT stage (the
fused kernel's autograd Function on the card) and through the smoother's
loop.

Positivity is enforced by parameterization (exp/sigmoid), so SGD stays
unconstrained.  Functional API as in the JAX module; :class:`AudioFrontend`
wraps it as an ``nn.Module``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from ..ops.mel import melspectrogram, pcen
from ..utils.config import DEFAULT_CONFIG, SpectralConfig
from ..utils.numerics import as_tensor
from ..utils.tree import sgd_step
from ._common import Draws, TreeModule, as_input, params_from_jax

Tensor = torch.Tensor
Params = Dict[str, Tensor]

__all__ = [
    "AudioFrontend", "apply", "apply_frontend", "init_classifier", "init_frontend",
    "init_params", "loss_fn", "params_from_jax", "train_step",
]


def _init_frontend(draw: Draws, n_mels: int) -> Params:
    ones = draw.ones(n_mels)
    b0 = 0.025
    return {
        "log_gain": math.log(0.98) * ones,
        "log_bias": math.log(2.0) * ones,
        "log_power": math.log(0.5) * ones,
        "smooth_logit": math.log(b0 / (1 - b0)) * ones,
    }


def _init_classifier(draw: Draws, n_mels: int, n_classes: int) -> Params:
    return {
        "w": draw(n_mels, n_classes) / math.sqrt(n_mels),
        "b": draw.zeros(n_classes),
    }


def init_frontend(n_mels: int = 40, generator=None, device=None) -> Params:
    """Per-band PCEN parameters at the published initialization
    (gain 0.98, bias 2, power 0.5, smoothing b ≈ 0.025); no random draw."""
    return _init_frontend(Draws(generator, device), n_mels)


def init_classifier(n_mels: int, n_classes: int, generator=None, device=None) -> Params:
    return _init_classifier(Draws(generator, device), n_mels, n_classes)


def init_params(n_mels: int = 40, n_classes: int = 2, generator=None,
                device=None) -> Dict[str, Params]:
    draw = Draws(generator, device)
    return {
        "frontend": _init_frontend(draw, n_mels),
        "head": _init_classifier(draw, n_mels, n_classes),
    }


def apply_frontend(
    params: Params,
    x,
    sr: float = 16000.0,
    n_fft: int = 512,
    hop: Optional[int] = None,
    eps: float = 1e-6,
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """(…, T) waveforms -> (…, frames, n_mels) PCEN features with the
    TRAINED per-band coefficients."""
    n_mels = params["log_gain"].shape[0]
    hop = n_fft // 4 if hop is None else int(hop)
    M = melspectrogram(as_input(x, params["log_gain"].device), sr, n_fft=n_fft, hop=hop,
                       n_mels=n_mels, config=config)
    # ops/mel.pcen with learned per-band coefficients
    return pcen(
        M,
        gain=torch.exp(params["log_gain"]),
        bias=torch.exp(params["log_bias"]),
        power=torch.exp(params["log_power"]),
        b=torch.sigmoid(params["smooth_logit"]),
        eps=eps,
        config=config,
    )


def apply(params: Dict[str, Params], x, sr: float = 16000.0,
          n_fft: int = 512, hop: Optional[int] = None,
          *, config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    """Full model: frontend -> mean-pool over frames -> linear logits."""
    feats = apply_frontend(params["frontend"], x, sr, n_fft, hop,
                           config=config)
    pooled = torch.mean(feats, dim=-2)
    head = params["head"]
    return pooled @ head["w"] + head["b"]


def loss_fn(params, x, labels, sr: float = 16000.0, n_fft: int = 512,
            *, config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    """Mean softmax cross-entropy over integer ``labels``."""
    logits = apply(params, x, sr, n_fft, config=config)
    labels = as_tensor(labels, logits.device).to(torch.long)
    logz = torch.logsumexp(logits, dim=-1)
    picked = torch.take_along_dim(logits, labels[..., None], dim=-1)[..., 0]
    return torch.mean(logz - picked)


def train_step(params, x, labels, lr: float = 0.05,
               sr: float = 16000.0, n_fft: int = 512,
               *, config: SpectralConfig = DEFAULT_CONFIG) -> Tuple[Dict[str, Params], Tensor]:
    """One SGD step: (new parameter tree, loss)."""
    return sgd_step(loss_fn, params, x, labels, sr, n_fft, lr=lr, config=config)


class AudioFrontend(TreeModule):
    """:func:`init_params` and :func:`apply` as a module, on ``device``
    (default: the card)."""

    def __init__(self, n_mels: int = 40, n_classes: int = 2, generator=None, device=None,
                 *, sr: float = 16000.0, n_fft: int = 512, hop: Optional[int] = None,
                 config: SpectralConfig = DEFAULT_CONFIG):
        super().__init__(init_params(n_mels, n_classes, generator, device))
        self.sr, self.n_fft, self.hop, self.config = sr, n_fft, hop, config

    def forward(self, x: Tensor) -> Tensor:
        return apply(self.param_tree(), x, self.sr, self.n_fft, self.hop, config=self.config)
