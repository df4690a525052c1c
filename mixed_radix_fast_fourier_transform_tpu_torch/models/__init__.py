"""Models built on the engine: the trainable spectral filter, the Fourier
neural operators, S4D, FNet, AFNO, the Koopman autoencoder and the trainable
PCEN audio front end and the spherical Fourier neural operator, with
checkpoints."""

from . import afno, audio_frontend, fnet, fno, koopman, s4d, sfno
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
    apply_distributed,
    init_params,
    init_params_complex,
    loss_distributed,
    loss_fn,
    params_from_jax,
    train_step,
    train_step_distributed,
)

__all__ = [
    "SpectralFilter", "apply", "apply_distributed", "init_params", "init_params_complex",
    "loss_distributed", "loss_fn", "params_from_jax", "train_step", "train_step_distributed", "afno", "audio_frontend", "fnet", "fno", "koopman", "s4d", "sfno",
    "save_checkpoint", "load_checkpoint",
    "init_koopman", "koopman_encode", "koopman_decode", "koopman_rollout",
    "koopman_loss", "koopman_spectrum",
]
