"""LTI system classes (lti/dlti/TransferFunction/ZerosPolesGain/StateSpace)
and full-state-feedback pole placement.

Counterpart of ``mixed_radix_fast_fourier_transform_tpu/ops/lticlasses.py``,
its code line for line but for the simulation methods' ``device``.  The class
layer is a thin, scipy.signal-compatible wrapper over the functional toolbox
in :mod:`.ltisys` — representations are host fp64 design constants; every
simulation method (`output`, `step`, `impulse`) lands in the same blocked
state-recurrence scan the functional API uses, so the device path is
identical whichever surface is called.  Numpy input and the inputs those
methods make go to ``device`` (default: the card).

`place_poles` is host-side fp64 numerics (gain design, like filter design —
it runs once, not per-sample).  Capability extension: the reference
(highSpeedFFT.c) has no system toolbox at all.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .iir import normalize, tf2zpk, zpk2tf
from . import ltisys
from .ltisys import (abcd_normalize, cont2discrete, ss2tf, ss2zpk, tf2ss,
                     zpk2ss)

__all__ = [
    "lti", "dlti", "TransferFunction", "ZerosPolesGain", "StateSpace",
    "place_poles",
]


class LinearTimeInvariant:
    """Common base: holds the sampling interval (None = continuous) and the
    conversion plumbing shared by every representation."""

    def __init__(self):
        self._dt = None

    @property
    def dt(self):
        return self._dt

    @property
    def zeros(self) -> np.ndarray:
        return self.to_zpk().zeros

    @property
    def poles(self) -> np.ndarray:
        return self.to_zpk().poles

    # --- representation hooks (overridden per subclass) ---------------------
    def _tf_tuple(self):
        raise NotImplementedError

    def _system_tuple(self):
        """The tuple the functional ltisys API expects (dt appended when
        discrete)."""
        raise NotImplementedError

    def _dt_args(self):
        return {} if self._dt is None else {"dt": self._dt}

    # --- conversions ---------------------------------------------------------
    def to_tf(self) -> "TransferFunction":
        num, den = self._tf_tuple()
        return TransferFunction(num, den, **self._dt_args())

    def to_zpk(self) -> "ZerosPolesGain":
        num, den = self._tf_tuple()
        return ZerosPolesGain(*tf2zpk(num, den), **self._dt_args())

    def to_ss(self) -> "StateSpace":
        num, den = self._tf_tuple()
        return StateSpace(*tf2ss(num, den), **self._dt_args())

    # --- simulation ----------------------------------------------------------
    def _check_continuous(self, what: str):
        if self._dt is not None:
            raise ValueError(f"{what} is for continuous systems; this system "
                             f"has dt={self._dt}")

    def _check_discrete(self, what: str):
        if self._dt is None:
            raise ValueError(f"{what} is for discrete systems; this system "
                             "is continuous")

    def output(self, U, T, X0=None, *, device=None):
        """(tout, yout[, xout]) — lsim for continuous, dlsim for discrete."""
        sys = self._system_tuple()
        if self._dt is None:
            return ltisys.lsim(sys, U, T, X0=X0, device=device)
        return ltisys.dlsim(sys, U, t=T, x0=X0, device=device)

    def step(self, X0=None, T=None, N=None, *, x0=None, t=None, n=None,
             device=None):
        # scipy spells the continuous args X0/T/N and the discrete ones
        # x0/t/n; accept both on either kind
        X0, T, N = (x0 if X0 is None else X0, t if T is None else T,
                    n if N is None else N)
        sys = self._system_tuple()
        if self._dt is None:
            kw = {} if N is None else {"N": N}
            return ltisys.step(sys, X0=X0, T=T, device=device, **kw)
        return ltisys.dstep(sys, x0=X0, t=T, n=N, device=device)

    def impulse(self, X0=None, T=None, N=None, *, x0=None, t=None, n=None,
                device=None):
        X0, T, N = (x0 if X0 is None else X0, t if T is None else T,
                    n if N is None else N)
        sys = self._system_tuple()
        if self._dt is None:
            kw = {} if N is None else {"N": N}
            return ltisys.impulse(sys, X0=X0, T=T, device=device, **kw)
        return ltisys.dimpulse(sys, x0=X0, t=T, n=N, device=device)

    def freqresp(self, w=None, n: int = 10000):
        sys = self._system_tuple()
        if self._dt is None:
            return ltisys.freqresp(sys, w=w, n=n)
        return ltisys.dfreqresp(sys, w=w, n=n)

    def bode(self, w=None, n: int = 100):
        sys = self._system_tuple()
        if self._dt is None:
            return ltisys.bode(sys, w=w, n=n)
        return ltisys.dbode(sys, w=w, n=n)

    def to_discrete(self, dt: float, method: str = "zoh",
                    alpha: Optional[float] = None):
        self._check_continuous("to_discrete")
        raise NotImplementedError  # overridden per representation


def _unpack_dt(kwargs, default=None):
    dt = kwargs.pop("dt", default)
    if kwargs:
        raise TypeError(f"unexpected keyword arguments {sorted(kwargs)}")
    return dt


class lti(LinearTimeInvariant):
    """Continuous-time LTI factory (scipy.signal.lti): dispatches on the
    number of arguments — 2 → TransferFunction, 3 → ZerosPolesGain,
    4 → StateSpace."""

    def __new__(cls, *system, **kwargs):
        if cls is lti:
            kinds = {2: TransferFunction, 3: ZerosPolesGain, 4: StateSpace}
            if len(system) not in kinds:
                raise ValueError("lti takes 2 (tf), 3 (zpk) or 4 (ss) "
                                 f"arguments, got {len(system)}")
            return kinds[len(system)](*system)
        return super().__new__(cls)

    def __init__(self, *system, **kwargs):
        super().__init__()


class dlti(LinearTimeInvariant):
    """Discrete-time LTI factory (scipy.signal.dlti); ``dt=True`` means an
    unspecified (unit) sampling interval."""

    def __new__(cls, *system, **kwargs):
        if cls is dlti:
            dt = kwargs.pop("dt", True)
            kinds = {2: TransferFunction, 3: ZerosPolesGain, 4: StateSpace}
            if len(system) not in kinds:
                raise ValueError("dlti takes 2 (tf), 3 (zpk) or 4 (ss) "
                                 f"arguments, got {len(system)}")
            return kinds[len(system)](*system, dt=dt)
        return super().__new__(cls)

    def __init__(self, *system, **kwargs):
        super().__init__()


def _copy_construct(cls, other):
    if cls is TransferFunction:
        return other.to_tf()
    if cls is ZerosPolesGain:
        return other.to_zpk()
    return other.to_ss()


class TransferFunction(LinearTimeInvariant):
    """Rational transfer function H(s)=num/den (or H(z) when dt is given) —
    scipy.signal.TransferFunction."""

    def __new__(cls, *args, **kwargs):
        return super().__new__(cls)

    def __init__(self, *args, **kwargs):
        if len(args) == 1 and isinstance(args[0], LinearTimeInvariant):
            other = args[0].to_tf()
            args = (other.num, other.den)
            kwargs.setdefault("dt", other.dt)
        if len(args) != 2:
            raise ValueError("TransferFunction needs (num, den)")
        super().__init__()
        self._dt = _unpack_dt(kwargs)
        self.num, self.den = normalize(*args)  # scipy-normalized (a0=1, trim)

    @property
    def num(self) -> np.ndarray:
        return self._num

    @num.setter
    def num(self, v):
        self._num = np.atleast_1d(np.asarray(v, np.float64))

    @property
    def den(self) -> np.ndarray:
        return self._den

    @den.setter
    def den(self, v):
        self._den = np.atleast_1d(np.asarray(v, np.float64))

    def _tf_tuple(self):
        return self._num, self._den

    def _system_tuple(self):
        base = (self._num, self._den)
        return base if self._dt is None else base + (float(self._dt),)

    def to_tf(self):
        return TransferFunction(self._num.copy(), self._den.copy(),
                                **self._dt_args())

    def to_discrete(self, dt: float, method: str = "zoh",
                    alpha: Optional[float] = None):
        self._check_continuous("to_discrete")
        num, den, _ = cont2discrete((self._num, self._den), dt,
                                    method=method, alpha=alpha)
        return TransferFunction(np.squeeze(num), den, dt=dt)

    def __repr__(self):
        return (f"TransferFunction({self._num.tolist()}, "
                f"{self._den.tolist()}, dt={self._dt})")


class ZerosPolesGain(LinearTimeInvariant):
    """Zero-pole-gain representation — scipy.signal.ZerosPolesGain."""

    def __new__(cls, *args, **kwargs):
        return super().__new__(cls)

    def __init__(self, *args, **kwargs):
        if len(args) == 1 and isinstance(args[0], LinearTimeInvariant):
            other = args[0].to_zpk()
            args = (other.zeros, other.poles, other.gain)
            kwargs.setdefault("dt", other.dt)
        if len(args) != 3:
            raise ValueError("ZerosPolesGain needs (zeros, poles, gain)")
        super().__init__()
        self._dt = _unpack_dt(kwargs)
        self.zeros, self.poles, self.gain = args

    @property
    def zeros(self) -> np.ndarray:
        return self._zeros

    @zeros.setter
    def zeros(self, v):
        self._zeros = np.atleast_1d(np.asarray(v))

    @property
    def poles(self) -> np.ndarray:
        return self._poles

    @poles.setter
    def poles(self, v):
        self._poles = np.atleast_1d(np.asarray(v))

    @property
    def gain(self) -> float:
        return self._gain

    @gain.setter
    def gain(self, v):
        self._gain = float(np.real_if_close(v))

    def _tf_tuple(self):
        return zpk2tf(self._zeros, self._poles, self._gain)

    def _system_tuple(self):
        base = (self._zeros, self._poles, self._gain)
        return base if self._dt is None else base + (float(self._dt),)

    def to_zpk(self):
        return ZerosPolesGain(self._zeros.copy(), self._poles.copy(),
                              self._gain, **self._dt_args())

    def to_ss(self):
        return StateSpace(*zpk2ss(self._zeros, self._poles, self._gain),
                          **self._dt_args())

    def to_discrete(self, dt: float, method: str = "zoh",
                    alpha: Optional[float] = None):
        self._check_continuous("to_discrete")
        z, p, k, _ = cont2discrete((self._zeros, self._poles, self._gain),
                                   dt, method=method, alpha=alpha)
        return ZerosPolesGain(z, p, k, dt=dt)

    def __repr__(self):
        return (f"ZerosPolesGain({self._zeros.tolist()}, "
                f"{self._poles.tolist()}, {self._gain}, dt={self._dt})")


class StateSpace(LinearTimeInvariant):
    """State-space representation — scipy.signal.StateSpace."""

    def __new__(cls, *args, **kwargs):
        return super().__new__(cls)

    def __init__(self, *args, **kwargs):
        if len(args) == 1 and isinstance(args[0], LinearTimeInvariant):
            other = args[0].to_ss()
            args = (other.A, other.B, other.C, other.D)
            kwargs.setdefault("dt", other.dt)
        if len(args) != 4:
            raise ValueError("StateSpace needs (A, B, C, D)")
        super().__init__()
        self._dt = _unpack_dt(kwargs)
        self.A, self.B, self.C, self.D = abcd_normalize(*args)

    def _tf_tuple(self):
        num, den = ss2tf(self.A, self.B, self.C, self.D)
        return np.squeeze(np.asarray(num)), den

    def _system_tuple(self):
        base = (self.A, self.B, self.C, self.D)
        return base if self._dt is None else base + (float(self._dt),)

    def to_ss(self):
        return StateSpace(self.A.copy(), self.B.copy(), self.C.copy(),
                          self.D.copy(), **self._dt_args())

    def to_zpk(self):
        return ZerosPolesGain(*ss2zpk(self.A, self.B, self.C, self.D),
                              **self._dt_args())

    def to_discrete(self, dt: float, method: str = "zoh",
                    alpha: Optional[float] = None):
        self._check_continuous("to_discrete")
        Ad, Bd, Cd, Dd, _ = cont2discrete(
            (self.A, self.B, self.C, self.D), dt, method=method, alpha=alpha)
        return StateSpace(Ad, Bd, Cd, Dd, dt=dt)

    def __repr__(self):
        return (f"StateSpace(A={self.A.tolist()}, B={self.B.tolist()}, "
                f"C={self.C.tolist()}, D={self.D.tolist()}, dt={self._dt})")


# register the concrete classes as virtual lti/dlti members so
# isinstance(TransferFunction(...), lti) behaves usefully is NOT done —
# scipy's parallel Continuous/Discrete subclass lattice is an implementation
# detail; the factory contract (lti(...) returns the right representation)
# is what the tests pin.


# ---------------------------------------------------------------------------
# Pole placement
# ---------------------------------------------------------------------------


class _PlaceResult:
    """Bunch-style result of :func:`place_poles` (scipy field names)."""

    def __init__(self, gain_matrix, computed_poles, requested_poles, X,
                 rtol, nb_iter):
        self.gain_matrix = gain_matrix
        self.computed_poles = computed_poles
        self.requested_poles = requested_poles
        self.X = X
        self.rtol = rtol
        self.nb_iter = nb_iter

    def __repr__(self):
        return (f"PlaceResult(gain_matrix={self.gain_matrix!r}, "
                f"computed_poles={self.computed_poles!r})")


def _order_poles(poles: np.ndarray) -> np.ndarray:
    """Sort with conjugate pairs adjacent (real part, then |imag|, then the
    +imag member first) — scipy's presentation order."""
    key = np.lexsort((-poles.imag, np.abs(poles.imag), poles.real))
    return poles[key]


def place_poles(A, B, poles, method: str = "YT", rtol: float = 1e-3,
                maxiter: int = 30) -> _PlaceResult:
    """Full-state-feedback gain K with eig(A − B·K) = ``poles``
    (scipy.signal.place_poles interface).

    Both ``method`` values run the same robust algorithm here: per-pole
    eigenvector subspaces S_i = null(Q1ᴴ(A − λᵢI)) (Q1 the orthogonal
    complement of range(B)), then Kautsky-Nichols-Van-Dooren-style sweeps
    that re-pick each eigenvector to maximize the conditioning |det X| of
    the closed-loop eigenvector matrix, with conjugate-pair symmetry kept
    exactly so K is real.  scipy's KNV0/YT split is an update-rule
    optimization detail; the contract (requested poles placed, X as well
    conditioned as the sweeps can make it) is identical.  Single-input
    systems have one-dimensional subspaces, so X is fully determined and no
    optimization is possible (as in scipy).
    """
    if method not in ("YT", "KNV0"):
        raise ValueError("method must be 'YT' or 'KNV0'")
    A = np.atleast_2d(np.asarray(A, np.float64))
    B = np.atleast_2d(np.asarray(B, np.float64))
    n = A.shape[0]
    if A.shape != (n, n):
        raise ValueError("A must be square")
    if B.shape[0] != n:
        raise ValueError("A and B must have the same number of rows")
    poles = np.atleast_1d(np.asarray(poles, np.complex128))
    if poles.shape != (n,):
        raise ValueError(f"needs exactly n={n} poles, got {poles.shape}")
    # conjugate closure
    if not np.allclose(_order_poles(poles),
                       _order_poles(np.conj(poles)), rtol=0, atol=1e-12):
        raise ValueError("complex poles must come in conjugate pairs")
    poles = _order_poles(poles)

    # controllability + multiplicity limits
    rank_b = np.linalg.matrix_rank(B)
    if rank_b == 0:
        raise ValueError("B is the zero matrix; nothing can be placed")
    ctrl = np.hstack([np.linalg.matrix_power(A, k) @ B for k in range(n)])
    if np.linalg.matrix_rank(ctrl) < n:
        raise ValueError("the pair (A, B) is not controllable")
    vals, counts = np.unique(np.round(poles, 10), return_counts=True)
    if counts.max() > rank_b:
        raise ValueError("at most rank(B) = "
                         f"{rank_b} poles may coincide, got {counts.max()}")

    # QR split of B: range (Q0, R0) and complement (Q1)
    Q, R = np.linalg.qr(B, mode="complete")
    Q0, Q1 = Q[:, :rank_b], Q[:, rank_b:]
    R0 = R[:rank_b, :]
    if B.shape[1] > rank_b:
        raise ValueError("B must have full column rank (drop dependent "
                         "input columns first)")

    # per-pole admissible eigenvector subspaces
    subspaces = []
    for lam in poles:
        Mn = Q1.conj().T @ (A - lam * np.eye(n))
        _, s, vh = np.linalg.svd(Mn)
        ns_dim = n - np.sum(s > max(n, 10) * np.finfo(float).eps *
                            (s[0] if len(s) else 1.0))
        subspaces.append(vh[len(vh) - ns_dim:].conj().T)  # (n, dim)

    # initial X: first basis vector of each subspace, conjugate-paired
    X = np.zeros((n, n), np.complex128)
    partner = {}
    i = 0
    while i < n:
        if abs(poles[i].imag) > 0:
            partner[i], partner[i + 1] = i + 1, i
            X[:, i] = subspaces[i][:, 0]
            X[:, i + 1] = np.conj(X[:, i])
            i += 2
        else:
            partner[i] = i
            X[:, i] = np.real(subspaces[i][:, 0])
            i += 1

    def _absdet(M):
        sign, logdet = np.linalg.slogdet(M)
        return 0.0 if sign == 0 else np.exp(logdet).real

    # conditioning sweeps (skipped when every subspace is 1-D: nothing to pick)
    nb_iter = 0
    if any(s.shape[1] > 1 for s in subspaces):
        best = _absdet(X)
        for _ in range(maxiter):
            nb_iter += 1
            for i in range(n):
                if partner[i] < i:
                    continue  # conjugate handled with its partner
                S = subspaces[i]
                if S.shape[1] == 1:
                    continue
                others = [j for j in range(n) if j != i and j != partner[i]]
                if others:
                    # orthonormal basis U of the complement of the other cols
                    Qo, _ = np.linalg.qr(X[:, others])
                    proj = S - Qo @ (Qo.conj().T @ S)
                else:
                    proj = S
                # direction in S with the largest component off the others
                _, sv, vh = np.linalg.svd(proj, full_matrices=False)
                x_new = S @ vh[0].conj()
                nrm = np.linalg.norm(x_new)
                if nrm < 1e-12:
                    continue
                x_new = x_new / nrm
                old_i = X[:, i].copy()
                old_p = X[:, partner[i]].copy()
                before = _absdet(X)
                X[:, i] = x_new
                if partner[i] != i:
                    X[:, partner[i]] = np.conj(x_new)
                elif abs(poles[i].imag) == 0:
                    X[:, i] = np.real_if_close(X[:, i])
                if _absdet(X) < before:  # keep only improving updates
                    X[:, i] = old_i
                    X[:, partner[i]] = old_p
            cur = _absdet(X)
            if cur <= best * (1 + rtol):
                best = max(best, cur)
                break
            best = cur

    cond = np.linalg.cond(X)
    if cond > 1e12:
        raise ValueError("failed to find a well-conditioned eigenvector "
                         f"basis (cond(X) = {cond:.2e}); the requested pole "
                         "set may be unreachable with a real gain")
    # K = B⁺ (A X − X Λ) X⁻¹, real by conjugate symmetry
    AXmXL = A @ X - X * poles[None, :]
    K = np.linalg.solve(R0, Q0.conj().T @ AXmXL) @ np.linalg.inv(X)
    K = np.real(K)
    computed = _order_poles(np.linalg.eigvals(A - B @ K))
    return _PlaceResult(gain_matrix=K, computed_poles=computed,
                        requested_poles=poles, X=X, rtol=rtol,
                        nb_iter=nb_iter)
