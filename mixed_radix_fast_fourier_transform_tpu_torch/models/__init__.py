"""Models built on the engine: the trainable spectral filter, the Fourier
neural operators, S4D, FNet, AFNO, the Koopman autoencoder and the trainable
PCEN audio front end, with checkpoints."""

from . import afno, audio_frontend, fnet, fno, koopman, s4d
from .checkpoint import load_checkpoint, save_checkpoint
from .koopman import (
    init_koopman,
    koopman_decode,
    koopman_encode,
    koopman_loss,
    koopman_rollout,
    koopman_spectrum,
)
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
    "train_step", "afno", "audio_frontend", "fnet", "fno", "koopman", "s4d",
    "save_checkpoint", "load_checkpoint",
    "init_koopman", "koopman_encode", "koopman_decode", "koopman_rollout",
    "koopman_loss", "koopman_spectrum",
]
