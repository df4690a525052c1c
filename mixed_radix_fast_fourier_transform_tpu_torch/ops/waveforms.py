"""Test-signal generators (scipy.signal waveform parity).

Counterpart of ``mixed_radix_fast_fourier_transform_tpu/ops/waveforms.py``.
Phase integrals are closed-form (host polynomial algebra for
:func:`sweep_poly`), so the generators are exact, not cumulative-sum
approximations.  The phase is computed in float64 before the fp32 cast (a
1000-rad phase loses ~1e-4 in fp32): a numpy array or list is evaluated on
the host, as the JAX module does with concrete input, and the result goes to
the card; a tensor is evaluated in float64 on its own device.  Results are
fp32 tensors.
"""

from __future__ import annotations

import types

import numpy as np
import torch

from ..utils.config import DTYPE
from ..utils.numerics import as_tensor, resolve_device

Tensor = torch.Tensor

# the few array functions the generators use, for float64 tensors
_TORCH = types.SimpleNamespace(
    cos=torch.cos, sin=torch.sin, exp=torch.exp, log=torch.log, abs=torch.abs,
    power=torch.pow, mod=torch.remainder, where=torch.where,
)


def _np_of(t):
    """(namespace, float64 array): numpy on the host for array-likes,
    torch on the tensor's own device for tensors."""
    if isinstance(t, Tensor):
        return _TORCH, t.to(torch.float64)
    return np, np.asarray(t, np.float64)


def _out(y) -> Tensor:
    """fp32 result: a host array goes to the card, a tensor stays put."""
    return y.to(DTYPE) if isinstance(y, Tensor) else as_tensor(np.asarray(y, np.float32))


def chirp(t, f0: float, t1: float, f1: float, method: str = "linear",
          phi: float = 0.0, vertex_zero: bool = True) -> Tensor:
    """Swept-frequency cosine (scipy.signal.chirp): instantaneous
    frequency runs f0 -> f1 over [0, t1] by the chosen law."""
    xp, t = _np_of(t)
    if t1 <= 0:
        raise ValueError(f"t1 must be > 0, got {t1}")
    f0 = float(f0); f1 = float(f1)
    if method == "linear":
        beta = (f1 - f0) / t1
        phase = 2 * np.pi * (f0 * t + 0.5 * beta * t * t)
    elif method == "quadratic":
        beta = (f1 - f0) / (t1 * t1)
        if vertex_zero:
            phase = 2 * np.pi * (f0 * t + beta * t**3 / 3.0)
        else:
            phase = 2 * np.pi * (
                f1 * t + beta * ((t1 - t) ** 3 - t1**3) / 3.0
            )
    elif method == "logarithmic":
        if f0 <= 0 or f1 <= 0:
            raise ValueError("logarithmic sweep needs f0, f1 > 0")
        if f0 == f1:
            phase = 2 * np.pi * f0 * t
        else:
            beta = t1 / np.log(f1 / f0)
            phase = 2 * np.pi * beta * f0 * (
                xp.power(f1 / f0, t / t1) - 1.0
            )
    elif method in ("hyperbolic", "hyp"):
        if f0 == 0 or f1 == 0:
            raise ValueError("hyperbolic sweep needs nonzero f0, f1")
        if f0 == f1:
            phase = 2 * np.pi * f0 * t
        else:
            sing = -f1 * t1 / (f0 - f1)
            phase = 2 * np.pi * (-sing * f0) * xp.log(
                xp.abs(1.0 - t / sing)
            )
    else:
        raise ValueError(f"unknown chirp method {method!r}")
    return _out(xp.cos(phase + phi * np.pi / 180.0))


def sweep_poly(t, poly, phi: float = 0.0) -> Tensor:
    """Cosine with polynomial instantaneous frequency f(t) = polyval(poly,
    t) — scipy.signal.sweep_poly (descending coefficients); the phase is
    the exact polynomial integral."""
    xp, t = _np_of(t)
    p = np.atleast_1d(np.asarray(poly, np.float64))
    if p.ndim != 1 or p.size == 0:
        raise ValueError("poly must be a 1-D coefficient array")
    intp = np.polyint(p)  # exact host antiderivative
    if xp is np:
        phase = 2 * np.pi * np.polyval(intp, t)
    else:
        acc = torch.zeros_like(t)
        for c in intp:  # Horner, as np.polyval
            acc = acc * t + float(c)
        phase = 2 * np.pi * acc
    return _out(xp.cos(phase + phi * np.pi / 180.0))


def gausspulse(t, fc: float = 1000.0, bw: float = 0.5, bwr: float = -6.0,
               tpr: float = -60.0, retquad: bool = False,
               retenv: bool = False):
    """Gaussian-modulated sinusoid (scipy.signal.gausspulse): ``bw`` is
    the fractional bandwidth at ``bwr`` dB.  ``t='cutoff'`` returns the
    host scalar time where the envelope falls to ``tpr`` dB."""
    if fc <= 0:
        raise ValueError(f"fc must be > 0, got {fc}")
    if bw <= 0:
        raise ValueError(f"bw must be > 0, got {bw}")
    if bwr >= 0:
        raise ValueError(f"bwr must be < 0, got {bwr}")
    ref = 10.0 ** (bwr / 20.0)
    a = -((np.pi * fc * bw) ** 2) / (4.0 * np.log(ref))
    if isinstance(t, str):
        if t != "cutoff":
            raise ValueError(f"unknown t spec {t!r}")
        if tpr >= 0:
            raise ValueError(f"tpr must be < 0, got {tpr}")
        return float(np.sqrt(-np.log(10.0 ** (tpr / 20.0)) / a))
    xp, t = _np_of(t)
    env = xp.exp(-a * t * t)
    out = [env * xp.cos(2 * np.pi * fc * t)]
    if retquad:
        out.append(env * xp.sin(2 * np.pi * fc * t))
    if retenv:
        out.append(env)
    out = [_out(o) for o in out]
    return out[0] if len(out) == 1 else tuple(out)


def sawtooth(t, width: float = 1.0) -> Tensor:
    """Periodic sawtooth of period 2π rising over ``width`` of the cycle
    (scipy.signal.sawtooth; width=0.5 is a triangle)."""
    if not 0.0 <= width <= 1.0:
        raise ValueError(f"width must be in [0, 1], got {width}")
    xp, t = _np_of(t)
    tmod = xp.mod(t, 2 * np.pi) / (2 * np.pi)  # in [0, 1)
    w = width
    rising = 2.0 * tmod / max(w, 1e-30) - 1.0
    falling = 1.0 - 2.0 * (tmod - w) / max(1.0 - w, 1e-30)
    y = xp.where(tmod < w, rising if w > 0 else 1.0, falling if w < 1 else 1.0)
    return _out(y)


def square(t, duty: float = 0.5) -> Tensor:
    """Periodic square wave of period 2π, +1 for the first ``duty``
    fraction of each cycle, −1 after (scipy.signal.square)."""
    if not 0.0 <= duty <= 1.0:
        raise ValueError(f"duty must be in [0, 1], got {duty}")
    xp, t = _np_of(t)
    tmod = xp.mod(t, 2 * np.pi) / (2 * np.pi)
    return _out(xp.where(tmod < duty, 1.0, -1.0))


def unit_impulse(shape, idx=None, dtype=np.float32, *, device=None) -> Tensor:
    """Unit impulse δ (scipy.signal.unit_impulse): 1 at ``idx``
    (default 0; 'mid' for the center), zeros elsewhere; on ``device``
    (default: the card)."""
    if np.ndim(shape) == 0:
        shape = (int(shape),)
    shape = tuple(int(s) for s in shape)
    if idx is None:
        idx = (0,) * len(shape)
    elif idx == "mid":
        idx = tuple(s // 2 for s in shape)
    elif np.ndim(idx) == 0:
        idx = (int(idx),) * len(shape)
    else:
        idx = tuple(int(i) for i in idx)
    out = np.zeros(shape, dtype)
    out[idx] = 1
    return torch.from_numpy(out).to(resolve_device(device))
