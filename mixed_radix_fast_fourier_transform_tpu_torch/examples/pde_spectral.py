"""Spectral PDE toolbox: heat, Burgers and Poisson on the engine.

Counterpart of the JAX package's ``examples/pde_spectral.py``.  Three
pseudo-spectral workloads, each held against an analytic or float64 result:

1. 2-D periodic heat equation, exact integrating-factor step in Fourier
   space (error against the closed-form mode decay);
2. 1-D viscous Burgers via spectral derivatives + RK4 (against the same
   scheme in float64 numpy; the mean is conserved);
3. 2-D Poisson solve (against float64, and the residual through the
   spectral Laplacian).

The JAX example jits the heat step and the RK4 step; here ``compile``
compiles them (``torch.compile``, fullgraph): True with Inductor, False
eagerly, None (the default) on a CUDA device only.

Run: python -m mixed_radix_fast_fourier_transform_tpu_torch.examples.pde_spectral
"""

from __future__ import annotations

import numpy as np
import torch

from .. import fft2, ifft2, poisson_solve, spectral_diff
from ..utils.numerics import resolve_device
from . import jitted


def _heat_step(u, decay):
    return ifft2(fft2(u.to(torch.complex64)) * decay).real


def _burgers_rhs(u, nu: float):
    return -u * spectral_diff(u, order=1) + nu * spectral_diff(u, order=2)


def _burgers_rk4(u, dt: float, nu: float):
    k1 = _burgers_rhs(u, nu)
    k2 = _burgers_rhs(u + 0.5 * dt * k1, nu)
    k3 = _burgers_rhs(u + 0.5 * dt * k2, nu)
    k4 = _burgers_rhs(u + dt * k3, nu)
    return u + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)


def heat_2d(*, device=None, n: int = 128, nu: float = 0.05, t: float = 0.7,
            compile: bool | None = None) -> float:
    """u_t = nu * lap(u) on [0, 2pi)^2: the spectral step is exact per mode."""
    dev = resolve_device(device)
    xs = np.linspace(0, 2 * np.pi, n, endpoint=False)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    u0 = (np.sin(3 * X) * np.cos(5 * Y) + 0.5 * np.cos(X + 2 * Y)).astype(np.float32)
    kx = np.fft.fftfreq(n, 1.0 / n)
    k2 = kx[:, None] ** 2 + kx[None, :] ** 2  # full-grid |k|^2
    decay = torch.tensor(np.exp(-nu * k2 * t), dtype=torch.float32, device=dev)

    step = jitted(_heat_step, dev.type == "cuda" if compile is None else compile)
    u = step(torch.tensor(u0, device=dev), decay).cpu().numpy()
    # analytic: each initial mode decays by exp(-nu |k|^2 t)
    want = (np.exp(-nu * (9 + 25) * t) * np.sin(3 * X) * np.cos(5 * Y)
            + 0.5 * np.exp(-nu * (1 + 4) * t) * np.cos(X + 2 * Y))
    err = float(np.max(np.abs(u - want)) / np.max(np.abs(want)))
    print(f"heat 2-D (n={n}): rel err vs analytic decay {err:.2e}")
    assert err < 1e-5
    return err


def burgers_1d(*, device=None, n: int = 256, nu: float = 0.02, dt: float = 1e-3,
               steps: int = 400, compile: bool | None = None) -> dict:
    """u_t + u u_x = nu u_xx, periodic, pseudo-spectral RK4."""
    dev = resolve_device(device)
    xs = np.linspace(0, 2 * np.pi, n, endpoint=False)
    u0 = (np.sin(xs) + 0.5 * np.sin(3 * xs)).astype(np.float32)

    step = jitted(_burgers_rk4, dev.type == "cuda" if compile is None else compile)
    u = torch.tensor(u0, device=dev)
    for _ in range(steps):
        u = step(u, dt, nu)
    u = u.cpu().numpy()

    # float64 numpy oracle of the same scheme
    k = np.fft.fftfreq(n, 1.0 / n)

    def rhs64(v):
        vh = np.fft.fft(v)
        vx = np.real(np.fft.ifft(1j * k * vh))
        vxx = np.real(np.fft.ifft(-(k ** 2) * vh))
        return -v * vx + nu * vxx

    v = u0.astype(np.float64)
    for _ in range(steps):
        k1 = rhs64(v)
        k2 = rhs64(v + 0.5 * dt * k1)
        k3 = rhs64(v + 0.5 * dt * k2)
        k4 = rhs64(v + dt * k3)
        v = v + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)

    err = float(np.max(np.abs(u - v)) / np.max(np.abs(v)))
    # momentum is conserved up to viscosity (mean(u) stays 0)
    drift = abs(float(np.mean(u)))
    print(f"burgers 1-D (n={n}, {steps} RK4 steps): rel err vs fp64 oracle "
          f"{err:.2e}, mean drift {drift:.2e}")
    assert err < 1e-3 and drift < 1e-5
    return {"err": err, "drift": drift, "u": u}


def poisson_2d(*, device=None, n: int = 192) -> dict:
    """lap(u) = f, periodic: solve, then check the residual spectrally."""
    dev = resolve_device(device)
    xs = np.linspace(0, 2 * np.pi, n, endpoint=False)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    f = (np.sin(2 * X) * np.sin(Y) - 0.3 * np.cos(4 * X + 3 * Y)).astype(np.float32)
    ft = torch.tensor(f, device=dev)
    ud = poisson_solve(ft)
    u = ud.cpu().numpy()

    # float64 oracle solution
    k = np.fft.fftfreq(n, 1.0 / n)
    k2 = k[:, None] ** 2 + k[None, :] ** 2
    inv = np.where(k2 > 0, -1.0 / np.where(k2 > 0, k2, 1.0), 0.0)
    want = np.real(np.fft.ifft2(np.fft.fft2(f.astype(np.float64)) * inv))
    err = float(np.max(np.abs(u - want)) / np.max(np.abs(want)))

    # the residual is ill-conditioned in fp32 (re-amplified by k_max^2), so
    # it only gets a loose bound
    lap = spectral_diff(ud, order=2, axis=0) + spectral_diff(ud, order=2, axis=1)
    res = float((lap - ft).abs().max()) / float(np.max(np.abs(f)))
    print(f"poisson 2-D (n={n}): rel err vs fp64 oracle {err:.2e}, fp32 residual {res:.2e}")
    assert err < 1e-5 and res < 1e-2
    return {"err": err, "residual": res, "u": u}


def main(*, device=None, compile: bool | None = None) -> dict:
    """The three workloads; ``compile`` as :func:`heat_2d` takes it, for the
    two time steps (the Poisson solve is one call, as in the JAX example)."""
    out = {"heat_err": heat_2d(device=device, compile=compile),
           "burgers_err": burgers_1d(device=device, compile=compile)["err"],
           "poisson_err": poisson_2d(device=device)["err"]}
    print("PDE spectral demo: ALL OK")
    return out


if __name__ == "__main__":
    main()
