"""Build and plan persistence.

Counterpart of ``mixed_radix_fast_fourier_transform_tpu/utils/cache.py``.
There the expensive artifact of a fresh process is XLA's compiled
executable; here it is the fused kernel's library, which ``nvcc`` compiles
at the first CUDA launch, and the plans:

* :func:`enable_persistent_cache` points the kernel build directory at a
  directory that outlives the process, so the library is compiled once per
  machine (XLA's compilation cache has no torch counterpart: the port's
  transforms run eagerly and compile nothing else);
* :func:`save_plans` / :func:`load_plans` persist the plan manifest (which
  (kind, n, sign) plans a workload used) so a fresh process can rebuild
  exactly that working set up front; plan constants are deterministic, so
  rebuilding equals deserializing.
"""

from __future__ import annotations

import os
from typing import Iterable, Optional, Tuple

import numpy as np

from ..plan import _CACHE, get_plan
from .config import DEFAULT_CONFIG, SpectralConfig

DEFAULT_CACHE_DIR = os.path.expanduser("~/.cache/mixed_radix_fft_torch/build")

# Manifest kind ids: 0 and 1 as the JAX package writes them; 2 is the fused
# kernel's schedule, which only the port plans.
_KIND_IDS = {"complex": 0, "real": 1, "kernel": 2}
_KINDS = {v: k for k, v in _KIND_IDS.items()}


def enable_persistent_cache(path: Optional[str] = None) -> str:
    """Build and load the fused kernel's library in ``path`` (default
    :data:`DEFAULT_CACHE_DIR`) from now on; returns the path.  A process
    that finds an up-to-date library there loads it without compiling."""
    from ..ops import _build

    path = path or DEFAULT_CACHE_DIR
    os.makedirs(path, exist_ok=True)
    _build.set_build_dir(path)
    return path


def warm_plans(
    lengths: Iterable[int],
    *,
    signs: Tuple[int, ...] = (-1, 1),
    kinds: Tuple[str, ...] = ("complex",),
    config: SpectralConfig = DEFAULT_CONFIG,
) -> int:
    """Eagerly build plans for the given lengths; returns how many were built."""
    count = 0
    for n in lengths:
        for kind in kinds:
            for sign in signs:
                if kind == "real" and n % 2:
                    continue
                get_plan(n, sign, kind, config)
                count += 1
    return count


def save_plans(path: str) -> int:
    """Write the manifest of every cached plan to ``path`` (.npz): rows of
    (kind id, n, sign).  Returns the plan count."""
    keys = list(_CACHE.copy())   # dict.copy is atomic; the cache takes no lock
    rows = np.asarray(
        [[_KIND_IDS[kind], n, sign] for kind, n, sign, _ in keys], dtype=np.int64,
    ).reshape(-1, 3)
    np.savez_compressed(path, manifest=rows)
    return len(keys)


def load_plans(path: str, *, config: SpectralConfig = DEFAULT_CONFIG) -> int:
    """Rebuild every plan of a manifest saved by :func:`save_plans` (or by
    the JAX package's) into the live cache.  Returns the plan count.

    A missing path raises ``FileNotFoundError``; anything unreadable or
    structurally wrong raises ``ValueError`` naming the path, and the live
    cache is untouched (plans are built only after the whole manifest
    validates)."""
    try:
        with np.load(path) as z:
            rows = np.asarray(z["manifest"])
    except FileNotFoundError:
        raise
    except Exception as e:
        raise ValueError(f"corrupt plan manifest {path!r}: {e}") from e
    if rows.ndim != 2 or (rows.size and rows.shape[1] != 3):
        raise ValueError(
            f"corrupt plan manifest {path!r}: expected (k, 3) rows, "
            f"got shape {rows.shape}"
        )
    bad = [int(k) for k in np.unique(rows[:, 0]) if int(k) not in _KINDS]
    if bad or (rows.size and int(rows[:, 1].min()) < 1):
        raise ValueError(
            f"corrupt plan manifest {path!r}: invalid kind ids {bad} "
            f"or non-positive lengths"
        )
    if rows.size:
        bad_sign = [int(s) for s in np.unique(rows[:, 2]) if int(s) not in (-1, 1)]
        if bad_sign:
            raise ValueError(
                f"corrupt plan manifest {path!r}: invalid signs {bad_sign}"
            )
        odd_real = rows[(rows[:, 0] == 1) & (rows[:, 1] % 2 == 1)]
        if len(odd_real):
            raise ValueError(
                f"corrupt plan manifest {path!r}: odd lengths for real-kind "
                f"plans {sorted(set(int(n) for n in odd_real[:, 1]))}"
            )
    for kind_id, n, sign in rows:
        get_plan(int(n), int(sign), _KINDS[int(kind_id)], config)
    return len(rows)
