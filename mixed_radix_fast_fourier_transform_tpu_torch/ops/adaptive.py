"""Adaptive filters: LMS, NLMS, RLS.

Counterpart of ``mixed_radix_fast_fourier_transform_tpu/ops/adaptive.py``:
sample-recursive adaptation (echo cancellation, channel equalization,
noise cancellation).  The regression vectors come from one ``unfold`` of
the zero-prefixed signal; the weight recursion runs in the scan's order as
a Python loop of a few small kernels a sample (the JAX module's
``lax.scan``).  LMS and NLMS are affine in w but time-varying
(w ← (I − μ·u·uᵀ)·w + μ·d·u), and RLS carries P and is not linear: an
associative scan of such steps would combine n_taps × n_taps operators,
n_taps³ work a combine, so the loop stays.  The filter OUTPUT for frozen
weights is a convolution — use ops/convolve for that.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..utils.config import DEFAULT_CONFIG, DTYPE, SpectralConfig
from ..utils.numerics import as_tensors, matmul_precision

Tensor = torch.Tensor

__all__ = ["lms_filter", "nlms_filter", "rls_filter"]


def _regressors(x: Tensor, n_taps: int) -> Tensor:
    """(T, n_taps) sliding regression vectors u[k] = [x[k], …, x[k−m+1]]
    (zero-prehistory)."""
    return torch.flip(F.pad(x, (n_taps - 1, 0)).unfold(0, n_taps, 1), (-1,)).contiguous()


def _check(x, d, n_taps):
    x, d = as_tensors(x, d)
    x, d = x.to(DTYPE), d.to(DTYPE)
    if x.ndim != 1 or d.shape != x.shape:
        raise ValueError("x and d must be 1-D of equal length")
    if not 1 <= n_taps <= x.shape[0]:
        raise ValueError(f"need 1 <= n_taps <= len(x), got {n_taps}")
    return x, d


def _w0(w0, n_taps: int, like: Tensor) -> Tensor:
    if w0 is None:
        return torch.zeros(n_taps, dtype=DTYPE, device=like.device)
    return as_tensors(like, w0)[1].to(DTYPE)


def _gradient_loop(U: Tensor, d: Tensor, w: Tensor, step: Tensor):
    """w ← w + step[k]·e[k]·u[k] over every sample; returns (y, e, w)."""
    ys, es = [], []
    for k in range(U.shape[0]):
        u = U[k]
        y = torch.dot(u, w)
        e = d[k] - y
        w = torch.addcmul(w, u, e * step[k])
        ys.append(y)
        es.append(e)
    return torch.stack(ys), torch.stack(es), w


def lms_filter(x, d, n_taps: int, mu: float = 0.01, *,
               w0: Optional[Tensor] = None,
               config: SpectralConfig = DEFAULT_CONFIG
               ) -> Tuple[Tensor, Tensor, Tensor]:
    """Least-mean-squares adaptation: returns (y, e, w) — the filter output,
    the error d − y, and the final weights.  Update
    w ← w + μ·e[k]·u[k] (Widrow-Hoff)."""
    x, d = _check(x, d, n_taps)
    U = _regressors(x, n_taps)
    step = torch.full((U.shape[0],), float(mu), dtype=DTYPE, device=x.device)
    return _gradient_loop(U, d, _w0(w0, n_taps, x), step)


def nlms_filter(x, d, n_taps: int, mu: float = 0.5, eps: float = 1e-6, *,
                w0: Optional[Tensor] = None,
                config: SpectralConfig = DEFAULT_CONFIG
                ) -> Tuple[Tensor, Tensor, Tensor]:
    """Normalized LMS: step size divided by the regressor energy
    ‖u‖² + eps — stable for 0 < μ < 2 regardless of signal scale."""
    x, d = _check(x, d, n_taps)
    U = _regressors(x, n_taps)
    step = mu / (torch.sum(U * U, dim=-1) + eps)  # every sample's step at once
    return _gradient_loop(U, d, _w0(w0, n_taps, x), step)


def rls_filter(x, d, n_taps: int, lam: float = 0.99, delta: float = 100.0, *,
               w0: Optional[Tensor] = None,
               config: SpectralConfig = DEFAULT_CONFIG
               ) -> Tuple[Tensor, Tensor, Tensor]:
    """Recursive least squares with forgetting factor ``lam``: order of
    magnitude faster convergence than LMS at O(n_taps²) per step (the loop
    carries the inverse correlation matrix P, initialized δ·I)."""
    x, d = _check(x, d, n_taps)
    if not 0 < lam <= 1:
        raise ValueError(f"lam must be in (0, 1], got {lam}")
    U = _regressors(x, n_taps)
    w = _w0(w0, n_taps, x)
    P = delta * torch.eye(n_taps, dtype=DTYPE, device=x.device)
    ys, es = [], []
    with matmul_precision():
        for k in range(U.shape[0]):
            u = U[k]
            Pu = torch.mv(P, u)
            gain = Pu / (lam + torch.dot(u, Pu))
            y = torch.dot(u, w)
            e = d[k] - y
            w = torch.addcmul(w, gain, e)
            P = torch.addr(P, gain, Pu, beta=1.0 / lam, alpha=-1.0 / lam)
            ys.append(y)
            es.append(e)
    return torch.stack(ys), torch.stack(es), w
