"""LTI system toolbox: representation conversions, discretization, and
simulation (scipy.signal lsim/dlsim family, functional API).

Counterpart of ``mixed_radix_fast_fourier_transform_tpu/ops/ltisys.py``.
Conversions and discretization are host fp64 (state matrices are design
constants, like filter taps and plan twiddles), the JAX module's code line
for line.  SIMULATION is the device path: the state recurrence
x[k+1] = A·x[k] + B·u[k] runs as the blocked scan of ``ops/iir.py``
(``utils.scan.linear_recurrence``), batched over the state dimension.
Continuous ``lsim`` reduces to exact ZOH/FOH discretization
(augmented-matrix exponential, host) followed by the same device scan.
Inputs made by the library (``dstep``, ``dimpulse``, ``step``, ``impulse``)
go to ``device`` (default: the card).

Systems are plain tuples, matching scipy's flexible-argument convention:
(num, den) | (z, p, k) | (A, B, C, D), with dt appended for the discrete
functions.  The class wrappers are in ``ops/lticlasses.py``.
"""

from __future__ import annotations

import math

from typing import Optional, Tuple

import numpy as np
import torch

from ..utils.config import DEFAULT_CONFIG, SpectralConfig
from ..utils.numerics import as_tensor, constant, content_key, matmul_precision
from .iir import _recurrence_scan, tf2zpk, zpk2tf

Tensor = torch.Tensor

__all__ = [
    "tf2ss", "ss2tf", "zpk2ss", "ss2zpk", "abcd_normalize",
    "cont2discrete", "dlsim", "dstep", "dimpulse", "dfreqresp", "dbode",
    "lsim", "step", "impulse", "freqresp", "bode",
]


# ---------------------------------------------------------------------------
# Conversions (host fp64)
# ---------------------------------------------------------------------------


def tf2ss(num, den):
    """Transfer function → controller-canonical state space
    (scipy.signal.tf2ss conventions, single input)."""
    num = np.atleast_2d(np.asarray(num, np.float64))
    den = np.atleast_1d(np.asarray(den, np.float64))
    if den[0] == 0:
        raise ValueError("den[0] must be nonzero")
    num, den = num / den[0], den / den[0]
    K = len(den)
    if num.shape[1] > K:
        raise ValueError("improper transfer function (deg num > deg den)")
    # left-pad numerator rows to the denominator length
    num = np.hstack([np.zeros((num.shape[0], K - num.shape[1])), num])
    n = K - 1
    if n == 0:  # static gain
        return (np.zeros((0, 0)), np.zeros((0, 1)),
                np.zeros((num.shape[0], 0)), num[:, :1].copy())
    A = np.zeros((n, n))
    A[0, :] = -den[1:]
    if n > 1:
        A[1:, :-1] = np.eye(n - 1)
    B = np.zeros((n, 1))
    B[0, 0] = 1.0
    C = num[:, 1:] - num[:, :1] * den[1:]
    D = num[:, :1].copy()
    return A, B, C, D


def ss2tf(A, B, C, D, input: int = 0):
    """State space → transfer function via the pole-shift identity
    num_k(s) = |sI − (A − B·e C_k)| + (D_k − 1)·den(s) (scipy.signal.ss2tf)."""
    A, B, C, D = abcd_normalize(A, B, C, D)
    B = B[:, input: input + 1]
    D = D[:, input: input + 1]
    den = np.poly(A) if A.size else np.ones(1)
    if B.size == 0 and C.size == 0:
        num = np.atleast_2d(D.ravel()).astype(np.float64)
        return num, den
    n_out = C.shape[0]
    num = np.empty((n_out, len(den)))
    for k in range(n_out):
        Ck = np.atleast_2d(C[k, :])
        num[k] = np.poly(A - B @ Ck) + (D[k, 0] - 1.0) * den
    return num, den


def zpk2ss(z, p, k):
    """Zeros/poles/gain → state space (scipy.signal.zpk2ss)."""
    return tf2ss(*zpk2tf(z, p, k))


def ss2zpk(A, B, C, D, input: int = 0):
    """State space → zeros/poles/gain (scipy.signal.ss2zpk)."""
    num, den = ss2tf(A, B, C, D, input=input)
    return tf2zpk(num[0], den)


def abcd_normalize(A=None, B=None, C=None, D=None):
    """Shape-check and 2-D-ify state matrices (scipy.signal.abcd_normalize)."""
    if A is None or B is None or C is None or D is None:
        raise ValueError("all four state matrices are required")
    A = np.atleast_2d(np.asarray(A, np.float64))
    B = np.atleast_2d(np.asarray(B, np.float64))
    C = np.atleast_2d(np.asarray(C, np.float64))
    D = np.atleast_2d(np.asarray(D, np.float64))
    n = A.shape[0]
    if A.shape != (n, n):
        raise ValueError(f"A must be square, got {A.shape}")
    if B.shape[0] != n:
        raise ValueError(f"B rows ({B.shape[0]}) must match A ({n})")
    if C.shape[1] != n:
        raise ValueError(f"C cols ({C.shape[1]}) must match A ({n})")
    if D.shape != (C.shape[0], B.shape[1]):
        raise ValueError(
            f"D must be (outputs, inputs) = ({C.shape[0]}, {B.shape[1]}), "
            f"got {D.shape}"
        )
    return A, B, C, D


def _expm(M: np.ndarray) -> np.ndarray:
    """Host matrix exponential (scipy.linalg.expm; trace-time constant)."""
    try:
        from scipy.linalg import expm as _scipy_expm

        return _scipy_expm(M)
    except Exception:  # pragma: no cover — scaling-and-squaring fallback
        n = int(np.ceil(max(0.0, np.log2(max(1e-30, np.linalg.norm(M, 1))))))
        Ms = M / (2 ** n)
        out = np.eye(M.shape[0])
        term = np.eye(M.shape[0])
        for k in range(1, 24):
            term = term @ Ms / k
            out = out + term
        for _ in range(n):
            out = out @ out
        return out


def _as_ss(system):
    """Flexible system tuple → (A, B, C, D) (scipy convention)."""
    if isinstance(system, tuple) and len(system) == 4:
        return abcd_normalize(*system)
    if isinstance(system, tuple) and len(system) == 2:
        return tf2ss(*system)
    if isinstance(system, tuple) and len(system) == 3:
        return zpk2ss(*system)
    raise ValueError(
        "system must be (num, den), (z, p, k) or (A, B, C, D); classes are "
        "deliberately unsupported (functional API)"
    )


def _as_dss(system):
    """Discrete system tuple (…, dt) → (A, B, C, D, dt)."""
    if not isinstance(system, tuple) or len(system) < 3:
        raise ValueError("discrete system must be a tuple ending in dt")
    dt = float(system[-1])
    return _as_ss(tuple(system[:-1])) + (dt,)


def cont2discrete(system, dt: float, method: str = "zoh",
                  alpha: Optional[float] = None):
    """Discretize a continuous system (scipy.signal.cont2discrete):
    'zoh' / 'foh' / 'impulse' by augmented matrix exponentials,
    'gbt' / 'bilinear' / 'euler' / 'backward_diff' by the generalized
    bilinear transform.  Returns matrices in the input representation."""
    rep = len(system) if isinstance(system, tuple) else 0
    A, B, C, D = _as_ss(system)
    n, m = A.shape[0], B.shape[1]
    if method == "gbt" and alpha is None:
        raise ValueError("gbt needs alpha in [0, 1]")
    alpha = {"bilinear": 0.5, "tustin": 0.5, "euler": 0.0,
             "forward_diff": 0.0, "backward_diff": 1.0}.get(method, alpha)
    if method in ("gbt", "bilinear", "tustin", "euler", "forward_diff",
                  "backward_diff"):
        ima = np.eye(n) - alpha * dt * A
        Ad = np.linalg.solve(ima, np.eye(n) + (1.0 - alpha) * dt * A)
        Bd = np.linalg.solve(ima, dt * B)
        Cd = np.linalg.solve(ima.T, C.T).T
        Dd = D + alpha * (C @ Bd)
    elif method == "zoh":
        M = np.zeros((n + m, n + m))
        M[:n, :n] = A * dt
        M[:n, n:] = B * dt
        E = _expm(M)
        Ad, Bd, Cd, Dd = E[:n, :n], E[:n, n:], C.copy(), D.copy()
    elif method == "foh":
        # scipy's triangular-hold construction via a doubly-augmented expm
        M = np.zeros((n + 2 * m, n + 2 * m))
        M[:n, :n] = A * dt
        M[:n, n: n + m] = B * dt
        M[n: n + m, n + m:] = np.eye(m)
        E = _expm(M)
        Ad = E[:n, :n]
        G1 = E[:n, n: n + m]          # = Γ1 = ∫e^{As}B ds
        G2 = E[:n, n + m:]            # = Γ2/dt (the dt·B block scaling
        #                               already folds one dt into E13)
        # triangular-hold identities: Bd = Γ1 + (Ad − I)·Γ2/dt,
        # Dd = D + C·Γ2/dt  (scipy's foh construction)
        Bd = G1 + Ad @ G2 - G2
        Cd = C.copy()
        Dd = D + C @ G2
    elif method == "impulse":
        if not np.allclose(D, 0):
            raise ValueError("impulse method requires D = 0")
        Ad = _expm(A * dt)
        Bd = Ad @ B * dt
        Cd = C.copy()
        Dd = C @ B * dt
    else:
        raise ValueError(f"unknown method {method!r}")
    if rep == 2:
        num, den = ss2tf(Ad, Bd, Cd, Dd)
        return num, den, dt
    if rep == 3:
        z, p, k = ss2zpk(Ad, Bd, Cd, Dd)
        return z, p, k, dt
    return Ad, Bd, Cd, Dd, dt


# ---------------------------------------------------------------------------
# Simulation (device scan)
# ---------------------------------------------------------------------------


def _matrix(M: np.ndarray, like: Tensor) -> Tensor:
    """A host matrix as a device table of ``like``'s dtype, keyed by its
    contents."""
    M = np.asarray(M, np.float64)
    return constant(M, like, like.dtype, key=content_key("ltisys", M))


def _inputs(u, device, dtype) -> Tensor:
    """``u`` as (n_steps, m) in the working ``dtype`` (numpy input goes to
    ``device``)."""
    u = as_tensor(u, device).to(dtype)
    u = torch.atleast_1d(u)
    return u[:, None] if u.ndim == 1 else u


def _initial_state(x0, n: int, like: Tensor) -> Tensor:
    if x0 is None:
        return like.new_zeros(n)
    return as_tensor(x0, like.device).to(like.dtype).reshape(n)


def _scan_ss(Ad: np.ndarray, Bd: np.ndarray, Cd: np.ndarray, Dd: np.ndarray,
             u: Tensor, x0, config: SpectralConfig) -> Tuple[Tensor, Tensor]:
    """(yout, xout) of x[k+1] = Ad x[k] + Bd u[k]; y[k] = Cd x[k] + Dd u[k]
    via one blocked scan over the time axis.  ``u``: (n_steps, m)."""
    n = Ad.shape[0]
    with matmul_precision():
        if n == 0:  # static system
            y = u @ _matrix(Dd.T, u)
            return y, u.new_zeros((u.shape[0], 0))
        x0d = _initial_state(x0, n, u)
        drive = u @ _matrix(Bd.T, u)                  # (T, n): B·u[k]
        # states AFTER each step of x[k+1] = A x[k] + B u[k], so xout[k] for
        # k >= 1; xout[0] is x0 itself
        states = _recurrence_scan(Ad, drive, x0d)
        xout = torch.cat([x0d[None, :], states[:-1]], dim=0)  # (T, n)
        y = xout @ _matrix(Cd.T, u) + u @ _matrix(Dd.T, u)
    return y, xout


def dlsim(system, u, t=None, x0=None, *, device=None,
          config: SpectralConfig = DEFAULT_CONFIG):
    """Simulate a discrete-time system (scipy.signal.dlsim): returns
    (tout, yout, xout) for state-space systems and (tout, yout) for tf/zpk
    input (scipy's convention).  The time loop is one blocked scan;
    ``tout`` is host numpy."""
    Ad, Bd, Cd, Dd, dt = _as_dss(system)
    u = _inputs(u, device, config.dtype)
    steps = u.shape[0]
    tout = np.arange(steps) * dt if t is None else np.asarray(t, np.float64)
    y, x = _scan_ss(Ad, Bd, Cd, Dd, u, x0, config)
    if len(system) == 5:
        return tout, y, x
    return tout, y


def dstep(system, x0=None, t=None, n: Optional[int] = None, *, device=None,
          config: SpectralConfig = DEFAULT_CONFIG):
    """Discrete step response (scipy.signal.dstep): (tout, (y_per_input,…))."""
    Ad, Bd, Cd, Dd, dt = _as_dss(system)
    if n is None:
        n = 100
    outs = []
    tout = np.arange(n) * dt
    for i in range(Bd.shape[1]):
        u = np.zeros((n, Bd.shape[1]), np.float64)
        u[:, i] = 1.0
        _, y, _ = dlsim((Ad, Bd, Cd, Dd, dt), u, x0=x0, device=device, config=config)
        outs.append(y)
    return tout, tuple(outs)


def dimpulse(system, x0=None, t=None, n: Optional[int] = None, *, device=None,
             config: SpectralConfig = DEFAULT_CONFIG):
    """Discrete impulse response (scipy.signal.dimpulse)."""
    Ad, Bd, Cd, Dd, dt = _as_dss(system)
    if n is None:
        n = 100
    outs = []
    tout = np.arange(n) * dt
    for i in range(Bd.shape[1]):
        u = np.zeros((n, Bd.shape[1]), np.float64)
        u[0, i] = 1.0
        _, y, _ = dlsim((Ad, Bd, Cd, Dd, dt), u, x0=x0, device=device, config=config)
        outs.append(y)
    return tout, tuple(outs)


def dfreqresp(system, w=None, n: int = 10000):
    """Discrete frequency response H(e^{jωdt}) (scipy.signal.dfreqresp,
    host fp64 via the zpk factorization for conditioning)."""
    Ad, Bd, Cd, Dd, dt = _as_dss(system)
    z, p, k = ss2zpk(Ad, Bd, Cd, Dd)
    if w is None:
        w = np.linspace(0, np.pi, n, endpoint=False)  # rad/sample (scipy)
    else:
        w = np.asarray(w, np.float64)
    zd = np.exp(1j * w)
    num = np.prod(zd[:, None] - z[None, :], axis=1) if len(z) else 1.0
    den = np.prod(zd[:, None] - p[None, :], axis=1) if len(p) else 1.0
    return w, k * num / den


def dbode(system, w=None, n: int = 100):
    """Discrete Bode data: (w in rad/time-unit, mag_dB, phase_deg)
    (scipy.signal.dbode — frequencies are rad/sample ÷ dt)."""
    dt = float(system[-1])
    w, h = dfreqresp(system, w=w, n=n)
    mag = 20.0 * np.log10(np.abs(h) + 0.0)
    phase = np.degrees(np.unwrap(np.angle(h)))
    return w / dt, mag, phase


def lsim(system, U, T, X0=None, interp: bool = True, *, device=None,
         config: SpectralConfig = DEFAULT_CONFIG):
    """Simulate a continuous system on an equispaced grid
    (scipy.signal.lsim): exact FOH (``interp=True``, linear-interpolated
    input) or ZOH discretization on host, then the device scan."""
    A, B, C, D = _as_ss(system)
    T = np.asarray(T, np.float64)
    if T.ndim != 1 or len(T) < 2:
        raise ValueError("T must be a 1-D array with at least 2 samples")
    dt = T[1] - T[0]
    if not np.allclose(np.diff(T), dt, rtol=1e-6):
        raise ValueError("lsim requires equally spaced time samples")
    U = _inputs(U, device, config.dtype)
    if U.shape[0] != len(T):
        raise ValueError("U must have one row per time sample")
    if interp:
        # FOH splits the input between u[k] and u[k+1]; realize it as the
        # standard scipy form: x[k+1] = Ad x[k] + Bd0 u[k] + Bd1 u[k+1]
        n, m = A.shape[0], B.shape[1]
        M = np.zeros((n + 2 * m, n + 2 * m))
        M[:n, :n] = A * dt
        M[:n, n: n + m] = B * dt
        M[n: n + m, n + m:] = np.eye(m)
        E = _expm(M)
        Adm = E[:n, :n]
        G1 = E[:n, n: n + m]
        G2 = E[:n, n + m:]                     # = Γ2/dt (see cont2discrete)
        Bd_next = G2                           # weight on u[k+1]
        Bd_cur = G1 - G2                       # weight on u[k]
        with matmul_precision():
            if n == 0:
                y = U @ _matrix(D.T, U)
                return T, y, U.new_zeros((len(T), 0))
            drive_u = U @ _matrix(Bd_cur.T, U) + \
                torch.cat([U[1:], U[-1:]], dim=0) @ _matrix(Bd_next.T, U)
            x0d = _initial_state(X0, n, U)
            states = _recurrence_scan(Adm, drive_u, x0d)
            xout = torch.cat([x0d[None, :], states[:-1]], dim=0)
            y = xout @ _matrix(C.T, U) + U @ _matrix(D.T, U)
        return T, y, xout
    Ad, Bd, Cd, Dd, _ = cont2discrete((A, B, C, D), dt, method="zoh")
    y, x = _scan_ss(Ad, Bd, Cd, Dd, U, X0, config)
    return T, y, x


def _default_t(A: np.ndarray, n: int = 200) -> np.ndarray:
    """Response horizon from the slowest stable pole (scipy heuristic)."""
    if A.size == 0:
        return np.linspace(0, 1.0, n)
    vals = np.linalg.eigvals(A)
    re = np.abs(np.real(vals))
    re = re[re > 1e-12]
    tc = 1.0 / np.min(re) if len(re) else 1.0
    return np.linspace(0, 7.0 * tc, n)


def step(system, X0=None, T=None, N: int = 200, *, device=None,
         config: SpectralConfig = DEFAULT_CONFIG):
    """Continuous step response (scipy.signal.step): (T, yout)."""
    A, B, C, D = _as_ss(system)
    if T is None:
        T = _default_t(A, N)
    U = np.ones((len(T), B.shape[1]))
    _, y, _ = lsim((A, B, C, D), U, T, X0=X0, device=device, config=config)
    return np.asarray(T), y[:, 0] if y.shape[1] == 1 else y


def impulse(system, X0=None, T=None, N: int = 200, *, device=None,
            config: SpectralConfig = DEFAULT_CONFIG):
    """Continuous impulse response (scipy.signal.impulse): simulated as the
    free response from X0 + B (the impulse loads the state directly)."""
    A, B, C, D = _as_ss(system)
    if T is None:
        T = _default_t(A, N)
    x0 = B[:, 0] if X0 is None else np.asarray(X0, np.float64) + B[:, 0]
    U = np.zeros((len(T), B.shape[1]))
    _, y, _ = lsim((A, B, C, D), U, T, X0=x0, device=device, config=config)
    return np.asarray(T), y[:, 0] if y.shape[1] == 1 else y


def freqresp(system, w=None, n: int = 10000):
    """Continuous frequency response H(jω) (scipy.signal.freqresp)."""
    A, B, C, D = _as_ss(system)
    z, p, k = ss2zpk(A, B, C, D)
    if w is None:
        mags = np.abs(np.concatenate([z, p]))
        mags = mags[mags > 0]
        ref = np.exp(np.mean(np.log(mags))) if len(mags) else 1.0
        w = np.logspace(math.log10(ref) - 2, math.log10(ref) + 2, n)
    else:
        w = np.asarray(w, np.float64)
    s = 1j * w
    num = np.prod(s[:, None] - z[None, :], axis=1) if len(z) else 1.0
    den = np.prod(s[:, None] - p[None, :], axis=1) if len(p) else 1.0
    return w, k * num / den


def bode(system, w=None, n: int = 100):
    """Continuous Bode data: (w, mag_dB, phase_deg) (scipy.signal.bode)."""
    w, h = freqresp(system, w=w, n=n)
    mag = 20.0 * np.log10(np.abs(h))
    phase = np.degrees(np.unwrap(np.angle(h)))
    return w, mag, phase
