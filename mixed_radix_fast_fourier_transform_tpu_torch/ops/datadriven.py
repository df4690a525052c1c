"""Data-driven spectral decompositions: SSA and DMD.

Counterpart of ``mixed_radix_fast_fourier_transform_tpu/ops/datadriven.py``.

Singular spectrum analysis (Broomhead-King / Vautard-Ghil): embed the
signal in a Hankel trajectory matrix, SVD, group components, reconstruct by
anti-diagonal (Hankel) averaging — the model-free trend/seasonal/noise
splitter.  Dynamic mode decomposition (Schmid 2010, exact-DMD variant):
eigen-decompose the best-fit linear operator between snapshot pairs —
spatial modes with single complex frequencies, the operator-theoretic
complement to the FFT for dynamical data (and the standard analysis tool
for the PDE states models/fno produces).

Decompositions run on the host in float64, as in the JAX module (small
SVD/eig on design-time-class matrices, same convention as ops/subspace.py;
a tensor is brought from its device); trajectory/snapshot assembly is
static indexing.  Results are numpy arrays, as the JAX module's are.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from ..utils.numerics import to_host

__all__ = ["ssa", "dmd", "dmd_reconstruct"]


def _hankelize(M: np.ndarray) -> np.ndarray:
    """Anti-diagonal averaging of an (L, K) matrix back to a length
    L+K−1 series (the Hankel projection step of SSA)."""
    L, K = M.shape
    n = L + K - 1
    out = np.zeros(n, dtype=M.dtype)
    counts = np.zeros(n)
    rows = np.arange(L)[:, None] + np.arange(K)[None, :]
    np.add.at(out, rows.ravel(), M.ravel())
    np.add.at(counts, rows.ravel(), 1.0)
    return out / counts


def ssa(x, window: int, groups: Optional[Sequence[Sequence[int]]] = None,
        n_components: Optional[int] = None
        ) -> Tuple[np.ndarray, np.ndarray]:
    """Singular spectrum analysis: returns (components, singular_values).

    ``components`` is (n_groups, n): reconstructed additive series, one per
    group of eigentriples (default: each of the leading ``n_components``
    singular components is its own group).  Ungrouped components are NOT
    dropped — the final row collects the remainder so the rows always sum
    to ``x`` exactly (additivity is the SSA contract).

    A sinusoid occupies a PAIR of near-equal singular values; group them
    (e.g. ``groups=[[0], [1, 2]]`` for trend + one tone) to get one series
    per physical component.
    """
    x = to_host(x, np.float64)
    if x.ndim != 1:
        raise ValueError("ssa expects a 1-D signal")
    n = len(x)
    if not 2 <= window <= n - 1:
        raise ValueError(f"need 2 <= window <= n-1 = {n - 1}, "
                         f"got window={window}")
    L = window
    K = n - L + 1
    X = x[np.arange(L)[:, None] + np.arange(K)[None, :]]  # (L, K) Hankel
    U, s, Vt = np.linalg.svd(X, full_matrices=False)
    r = len(s)
    if groups is None:
        k = min(n_components if n_components is not None else 8, r)
        groups = [[i] for i in range(k)]
    flat = [i for g in groups for i in g]
    used = sorted(set(flat))
    if used and (used[0] < 0 or used[-1] >= r):
        raise ValueError(f"group indices must lie in [0, {r - 1}]")
    if len(flat) != len(used):
        raise ValueError("groups must be disjoint (an index counted twice "
                         "would break the exact-additivity contract)")
    comps = []
    for g in groups:
        Mg = (U[:, g] * s[g]) @ Vt[g, :]
        comps.append(_hankelize(Mg))
    rest = [i for i in range(r) if i not in used]
    if rest:
        Mr = (U[:, rest] * s[rest]) @ Vt[rest, :]
        comps.append(_hankelize(Mr))
    return np.vstack(comps), s


def dmd(X, rank: Optional[int] = None, *, dt: float = 1.0):
    """Exact dynamic mode decomposition of a snapshot matrix X
    (n_state, n_times): returns (modes, eigs, amplitudes, omega).

    ``modes`` (n_state, r) are the exact DMD modes, ``eigs`` the discrete
    Koopman eigenvalues (x_{k+1} ≈ Σ φᵢ λᵢᵏ bᵢ gives the k-th snapshot),
    ``amplitudes`` the least-squares b fitting the first snapshot, and
    ``omega = log(eigs)/dt`` the continuous-time growth rates/frequencies.
    ``rank`` truncates the snapshot SVD (default: full numerical rank).
    """
    X = to_host(X)
    if X.ndim != 2 or X.shape[1] < 2:
        raise ValueError("dmd expects (n_state, n_times >= 2) snapshots")
    X1, X2 = X[:, :-1], X[:, 1:]
    U, s, Vt = np.linalg.svd(X1, full_matrices=False)
    tol = max(X1.shape) * np.finfo(np.float64).eps * (s[0] if len(s) else 1)
    r_num = int(np.sum(s > tol))
    r = r_num if rank is None else min(int(rank), r_num)
    if r < 1:
        raise ValueError("snapshot matrix is numerically rank-0")
    U, s, V = U[:, :r], s[:r], Vt[:r].conj().T
    Atil = U.conj().T @ X2 @ V / s
    eigs, W = np.linalg.eig(Atil)
    modes = X2 @ V / s @ W  # exact DMD modes (Tu et al. 2014)
    amps = np.linalg.lstsq(modes, X[:, 0].astype(np.complex128),
                           rcond=None)[0]
    omega = np.log(eigs.astype(np.complex128)) / dt
    order = np.argsort(-np.abs(amps))
    return modes[:, order], eigs[order], amps[order], omega[order]


def dmd_reconstruct(modes: np.ndarray, eigs: np.ndarray,
                    amplitudes: np.ndarray, n_times: int) -> np.ndarray:
    """Forecast/reconstruct snapshots: (n_state, n_times) from the DMD
    triplet — x_k = Σ φᵢ λᵢᵏ bᵢ."""
    modes, eigs, amplitudes = to_host(modes), to_host(eigs), to_host(amplitudes)
    powers = eigs[:, None] ** np.arange(n_times)[None, :]
    return modes @ (powers * amplitudes[:, None])
