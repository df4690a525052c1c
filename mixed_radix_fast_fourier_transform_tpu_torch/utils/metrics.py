"""Process-wide counters and the library logger.

Counterpart of ``mixed_radix_fast_fourier_transform_tpu/utils/metrics.py``.
The plan layer counts builds and cache hits here; snapshot with
:func:`get_metrics`.  While ``torch.compile`` or ``torch.export`` traces,
nothing is counted: a count is a host event, and a traced one would be a
side effect of the graph (or a lock dynamo cannot trace).
"""

from __future__ import annotations

import collections
import logging
import threading
from typing import Dict

import torch

_LOCK = threading.Lock()
_COUNTERS: Dict[str, int] = collections.defaultdict(int)

logger = logging.getLogger("mixed_radix_fft_torch")
logger.addHandler(logging.NullHandler())


def tracing() -> bool:
    """Is ``torch.compile`` or ``torch.export`` tracing?  (Dynamo reads
    both as constants; torch sets them while its tracers run.)"""
    return torch.compiler.is_compiling() or torch.compiler.is_exporting()


def incr(name: str, by: int = 1) -> None:
    if tracing():
        return
    with _LOCK:
        _COUNTERS[name] += by


def get_metrics() -> Dict[str, int]:
    with _LOCK:
        return dict(_COUNTERS)


def reset_metrics() -> None:
    with _LOCK:
        _COUNTERS.clear()


def enable_logging(level: int = logging.INFO) -> None:
    """Route library events (plan builds, capped arguments) to stderr."""
    handler = logging.StreamHandler()
    handler.setFormatter(
        logging.Formatter("[%(name)s] %(levelname)s %(message)s")
    )
    logger.addHandler(handler)
    logger.setLevel(level)
