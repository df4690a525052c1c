"""Host-side utilities: planning math, twiddle generation, config, numerics,
profiling, plan persistence and exported transforms."""

from .config import DEFAULT_CONFIG, SpectralConfig
from .factorize import (
    dividebyN,
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
from .metrics import enable_logging, get_metrics, reset_metrics
from .profiling import marginal_time, plan_cost, roofline_summary, trace
from .aot import aot_compile, export_transform, load_transform
