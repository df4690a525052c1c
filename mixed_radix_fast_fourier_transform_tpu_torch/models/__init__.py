"""Models built on the engine: the trainable spectral filter and the
Fourier neural operators."""

from . import fno
from .spectral_filter import (
    SpectralFilter,
    apply,
    init_params,
    loss_fn,
    params_from_jax,
    train_step,
)

__all__ = [
    "SpectralFilter", "apply", "init_params", "loss_fn", "params_from_jax",
    "train_step", "fno",
]
