"""Models built on the engine: the spectral filter (forward)."""

from .spectral_filter import SpectralFilter, apply, init_params, params_from_jax

__all__ = ["SpectralFilter", "apply", "init_params", "params_from_jax"]
