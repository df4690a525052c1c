"""Process-wide counters and the library logger.

Counterpart of ``mixed_radix_fast_fourier_transform_tpu/utils/metrics.py``.
The plan layer counts builds and cache hits here; snapshot with
:func:`get_metrics`.
"""

from __future__ import annotations

import collections
import logging
import threading
from typing import Dict

_LOCK = threading.Lock()
_COUNTERS: Dict[str, int] = collections.defaultdict(int)

logger = logging.getLogger("mixed_radix_fft_torch")
logger.addHandler(logging.NullHandler())


def incr(name: str, by: int = 1) -> None:
    with _LOCK:
        _COUNTERS[name] += by


def get_metrics() -> Dict[str, int]:
    with _LOCK:
        return dict(_COUNTERS)


def reset_metrics() -> None:
    with _LOCK:
        _COUNTERS.clear()
