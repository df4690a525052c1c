"""Twiddle and chirp constants, host-side numpy in fp64.

Counterpart of ``mixed_radix_fast_fourier_transform_tpu/utils/twiddle.py``
(its numpy paths).  Every phase index is reduced exactly as an integer
before fp64 cos/sin see it, which keeps fp32 transforms near 1e-7 relative
error even at large n.  These are plan constants: computed once per plan,
then cast and uploaded by the plan layer.
"""

from __future__ import annotations

import numpy as np


def _planes(angles: np.ndarray, dtype) -> tuple[np.ndarray, np.ndarray]:
    return np.cos(angles).astype(dtype), np.sin(angles).astype(dtype)


def dft_matrix(n: int, sign: int, dtype=np.float32) -> tuple[np.ndarray, np.ndarray]:
    """Dense n×n DFT matrix W[j,k] = e^(sign·2πi·j·k/n) as (real, imag) planes."""
    k = np.arange(n, dtype=np.int64)
    phase = (np.outer(k, k) % n).astype(np.float64)
    angles = (sign * 2.0 * np.pi / n) * phase
    return _planes(angles, dtype)


def twiddle_split(
    n1: int, n2: int, big_n: int, sign: int, dtype=np.float32
) -> tuple[np.ndarray, np.ndarray]:
    """Inter-stage twiddles T[j1, k2] = e^(sign·2πi·j1·k2/N) of shape (n1, n2)."""
    j1 = np.arange(n1, dtype=np.int64)
    k2 = np.arange(n2, dtype=np.int64)
    phase = (np.outer(j1, k2) % big_n).astype(np.float64)
    angles = (sign * 2.0 * np.pi / big_n) * phase
    return _planes(angles, dtype)


def split_twiddles(n: int, sign: int, dtype=np.float32) -> tuple[np.ndarray, np.ndarray]:
    """Half-spectrum split twiddles e^(sign·2πi·k/N), k = 0..N/2, for the
    packed real FFT."""
    k = np.arange(n // 2 + 1, dtype=np.int64)
    angles = (sign * 2.0 * np.pi / n) * k.astype(np.float64)
    return _planes(angles, dtype)


def chirp(n: int, sign: int, dtype=np.float32) -> tuple[np.ndarray, np.ndarray]:
    """Bluestein chirp w[j] = e^(sign·iπ·j²/n), j = 0..n-1, as (re, im) planes,
    with the quadratic phase reduced exactly as j² mod 2n."""
    j = np.arange(n, dtype=np.int64)
    phase = ((j * j) % (2 * n)).astype(np.float64)
    angles = (sign * np.pi / n) * phase
    return _planes(angles, dtype)
