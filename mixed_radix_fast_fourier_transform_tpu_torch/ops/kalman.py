"""Parallel-in-time Kalman filtering and RTS smoothing.

Counterpart of ``mixed_radix_fast_fourier_transform_tpu/ops/kalman.py``.
The textbook Kalman filter is a sequential recurrence over time — serial
depth T.  Särkkä & García-Fernández (2021, "Temporal parallelization of
Bayesian smoothers") showed the Bayesian filtering/smoothing recursions are
compositions of an ASSOCIATIVE operator on small per-step elements, so the
whole pass runs as ``utils.scan.associative_scan`` — log₂(T) levels of
batched (T, d, d) matrix products and solves.

Filtering elements (A, b, C, η, J) represent the map from the previous
filtered density to the current one; smoothing elements (E, g, L) compose
in reverse.  Time-invariant (F, Q, H, R) models; per-step inverses are
batched ``torch.linalg.solve_ex`` calls.  ``parallel=False`` (the default, as
in the JAX package) runs the sequential form, a loop in the scan's order —
the two paths oracle-test each other.  Every product is fp32 with TF32 off.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..utils.config import DEFAULT_CONFIG, DTYPE, SpectralConfig
from ..utils.numerics import as_tensor, as_tensors, fp32_matmul
from ..utils.scan import associative_scan

Tensor = torch.Tensor

__all__ = ["kalman_filter", "kalman_smoother"]


def _as_f32(*mats):
    return tuple(m.to(DTYPE) for m in as_tensors(*mats))


def _T(M: Tensor) -> Tensor:
    return M.transpose(-1, -2)


def _solve(A: Tensor, B: Tensor) -> Tensor:
    """A⁻¹B, batched.  A singular A gives non-finite values, as
    ``jnp.linalg.solve`` does, instead of a check that waits for the device."""
    return torch.linalg.solve_ex(A, B).result


def _mv(M: Tensor, v: Tensor) -> Tensor:
    """Batched matrix-vector product for (..., d, d) @ (..., d)."""
    return (M @ v[..., None])[..., 0]


def _filter_elements(F, Q, H, R, m0, P0, ys):
    """Per-step associative filtering elements (A, b, C, eta, J)."""
    d = F.shape[0]
    n = ys.shape[0]
    I = torch.eye(d, dtype=F.dtype, device=F.device)
    S_generic = H @ Q @ H.T + R                             # innovation cov, k >= 2
    K_generic = _T(_solve(S_generic, H @ Q))                # Q Hᵀ S⁻¹
    ImKH = I - K_generic @ H
    HtSinv = _T(_solve(S_generic, H))                       # Hᵀ S⁻¹
    A = (ImKH @ F).expand(n, d, d).clone()
    b = ys @ K_generic.T
    C = (ImKH @ Q).expand(n, d, d).clone()
    eta = ys @ (F.T @ HtSinv).T
    J = (F.T @ HtSinv @ H @ F).expand(n, d, d)

    # first element folds in the prior exactly
    m_pred = F @ m0
    P_pred = F @ P0 @ F.T + Q
    S1 = H @ P_pred @ H.T + R
    K1 = _T(_solve(S1, H @ P_pred))
    A[0] = 0.0
    b[0] = m_pred + K1 @ (ys[0] - H @ m_pred)
    C[0] = (I - K1 @ H) @ P_pred
    return A, b, C, eta, J


def _filter_combine(left, right):
    """Särkkä & García-Fernández eq. (10)-(11): composition of filtering
    elements (associative)."""
    A1, b1, C1, eta1, J1 = left
    A2, b2, C2, eta2, J2 = right
    d = A1.shape[-1]
    I = torch.eye(d, dtype=A1.dtype, device=A1.device)
    # (I + C1 J2)⁻¹ applied from the right of A2 / left of (b1 + C1 η2)
    M = I + C1 @ J2
    A2M = A2 @ _solve(M, I.expand(M.shape))
    A = A2M @ A1
    b = _mv(A2M, b1 + _mv(C1, eta2)) + b2
    C = A2M @ C1 @ _T(A2) + C2
    Mt = I + J2 @ C1
    A1tM = _T(A1) @ _solve(Mt, I.expand(Mt.shape))
    eta = _mv(A1tM, eta2 - _mv(J2, b1)) + eta1
    J = A1tM @ J2 @ A1 + J1
    return A, b, C, eta, J


def kalman_filter(F, Q, H, R, m0, P0, ys, *, parallel: bool = False,
                  config: SpectralConfig = DEFAULT_CONFIG
                  ) -> Tuple[Tensor, Tensor]:
    """Kalman filter for x_{k+1} = F x_k + w (cov Q), y_k = H x_k + v
    (cov R), prior N(m0, P0), observations ``ys`` of shape (T, d_obs).

    Returns (means (T, d), covs (T, d, d)) of the filtered densities.
    ``parallel=True`` runs the log-depth associative scan; ``False``
    (default) the sequential loop (the same results to fp32 rounding).
    Numpy input goes to the device of the first tensor among the
    arguments (default: the card)."""
    F, Q, H, R, m0, P0, ys = _as_f32(F, Q, H, R, m0, P0, ys)
    if ys.ndim != 2 or ys.shape[0] < 1:
        raise ValueError("ys must be (T >= 1, d_obs)")
    d = F.shape[0]
    if F.shape != (d, d) or Q.shape != (d, d) or P0.shape != (d, d):
        raise ValueError("F, Q, P0 must all be (d, d)")
    if H.shape[1] != d or R.shape != (H.shape[0], H.shape[0]):
        raise ValueError("H must be (d_obs, d) and R (d_obs, d_obs)")
    if ys.shape[1] != H.shape[0]:
        raise ValueError(f"ys.shape[1]={ys.shape[1]} must equal "
                         f"d_obs={H.shape[0]}")
    # full fp32 products throughout: reduced-precision passes compound over
    # the log2(T) combine levels and over T serial steps alike
    with fp32_matmul():
        if parallel:
            elems = _filter_elements(F, Q, H, R, m0, P0, ys)
            _, b, C, _, _ = associative_scan(_filter_combine, elems)
            return b, C
        I = torch.eye(d, dtype=F.dtype, device=F.device)
        m, P = m0, P0
        ms, Ps = [], []
        for y in ys:
            m_pred = F @ m
            P_pred = F @ P @ F.T + Q
            S = H @ P_pred @ H.T + R
            K = _T(_solve(S, H @ P_pred))
            m = m_pred + K @ (y - H @ m_pred)
            P = (I - K @ H) @ P_pred
            ms.append(m)
            Ps.append(P)
        return torch.stack(ms), torch.stack(Ps)


def _smoother_elements(F, Q, ms, Ps):
    """Per-step associative smoothing elements (E, g, L)."""
    P_pred = F @ Ps @ F.T + Q
    E = _T(_solve(_T(P_pred), F @ _T(Ps)))               # P Fᵀ P_pred⁻¹
    g = ms - _mv(E, ms @ F.T)
    L = Ps - E @ P_pred @ _T(E)
    # last element carries the filtered terminal density
    E[-1] = 0.0
    g[-1] = ms[-1]
    L[-1] = Ps[-1]
    return E, g, L


def _smoother_combine(right, left):
    """Reverse-direction composition (associative): applying ``left``'s
    gain to ``right``'s already-combined tail."""
    E2, g2, L2 = right
    E1, g1, L1 = left
    E = E1 @ E2
    g = _mv(E1, g2) + g1
    L = E1 @ L2 @ _T(E1) + L1
    return E, g, L


def kalman_smoother(F, Q, H, R, m0, P0, ys, *, parallel: bool = False,
                    config: SpectralConfig = DEFAULT_CONFIG
                    ) -> Tuple[Tensor, Tensor]:
    """Rauch-Tung-Striebel smoother: the full-information posterior at every
    step.  Runs the (parallel or sequential) Kalman filter, then composes
    the smoothing gains with a second log-depth associative scan in
    reverse (or the sequential backward loop).  Returns (means (T, d),
    covs (T, d, d))."""
    ms, Ps = kalman_filter(F, Q, H, R, m0, P0, ys, parallel=parallel,
                           config=config)
    F32, Q32 = (as_tensor(m, ms.device).to(DTYPE) for m in (F, Q))
    with fp32_matmul():
        E, g, L = _smoother_elements(F32, Q32, ms, Ps)
        if parallel:
            _, g, L = associative_scan(_smoother_combine, (E, g, L), reverse=True)
            return g, L
        m, P = g[-1], L[-1]
        gs, Ls = [m], [P]
        for k in range(ms.shape[0] - 2, -1, -1):
            m = E[k] @ m + g[k]
            P = E[k] @ P @ E[k].T + L[k]
            gs.append(m)
            Ls.append(P)
        return torch.stack(gs[::-1]), torch.stack(Ls[::-1])
