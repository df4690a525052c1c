"""Host-side utilities: planning math, twiddle generation, config, numerics."""

from .config import DEFAULT_CONFIG, SpectralConfig
from .factorize import (
    is_smooth,
    largest_prime_factor,
    next_fast_len,
    next_pow2,
    plan_stages,
    prime_factors,
)
from .numerics import (
    as_tensor,
    as_tensors,
    cmul,
    conj_planes,
    from_planes,
    resolve_device,
    to_planes,
)
from .metrics import get_metrics, reset_metrics
