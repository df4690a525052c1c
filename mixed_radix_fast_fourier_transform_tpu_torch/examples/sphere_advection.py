"""Spectral advection on the sphere: transport a tracer with the SHT ops.

Counterpart of the JAX package's ``examples/sphere_advection.py``.  A
passive tracer q is advected by a solid-body rotation wind (u_phi =
sin(theta)·omega, u_theta = 0); the exact solution is the initial field
rotated in longitude, so the error after any time is measurable exactly.
The right-hand side -u·∇q uses :func:`sphere_grad`, time stepping is
classic RK4: the skeleton of a spherical dynamical core on the library's
transforms.  The JAX example jits the RK4 step; here ``compile`` compiles
it (``torch.compile``, fullgraph): True with Inductor, False eagerly, None
(the default) on a CUDA device only.

Run: python -m mixed_radix_fast_fourier_transform_tpu_torch.examples.sphere_advection
"""

from __future__ import annotations

import numpy as np
import torch

from .. import isht, sht, sht_grid, sphere_grad
from ..utils.numerics import resolve_device
from . import jitted


def _rk4(q, dt: float, sin_th, omega: float):
    """One classic RK4 step of dq/dt = -u·∇q."""
    def rhs(v):
        # u·∇q with u_phi = omega·sin(theta), u_theta = 0; sphere_grad's phi
        # component carries the 1/sin factor, so -u_phi·(∇q)_phi = -omega·dq/dphi
        _, gphi = sphere_grad(v)
        return -omega * sin_th * gphi

    k1 = rhs(q)
    k2 = rhs(q + 0.5 * dt * k1)
    k3 = rhs(q + 0.5 * dt * k2)
    k4 = rhs(q + dt * k3)
    return q + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)


def main(*, device=None, lmax: int = 31, steps: int = 160,
         compile: bool | None = None) -> dict:
    """One-eighth of a revolution in ``steps`` RK4 steps at band limit
    ``lmax``; returns the error against the exact rotation."""
    dev = resolve_device(device)
    L = lmax + 1
    theta, phi, _ = sht_grid(lmax)
    TH, PH = theta[:, None], phi[None, :]

    # smooth band-limited blob centred on the equator
    q0 = np.exp(-((TH - np.pi / 2) ** 2 + (PH - np.pi) ** 2) / 0.18).astype(np.float32)
    # project onto the band limit so "exact rotation" stays in-band
    q0 = isht(sht(torch.tensor(q0, device=dev))).real
    omega = 1.0  # solid-body angular velocity about the pole
    sin_th = torch.tensor(np.sin(theta).astype(np.float32), device=dev)[:, None]
    step = jitted(_rk4, dev.type == "cuda" if compile is None else compile)
    dt = 2.0 * np.pi / (8 * steps)  # one-eighth revolution
    q = q0
    for _ in range(steps):
        q = step(q, dt, sin_th, omega)
    # exact: rotate by omega*T = 2pi/8 = one-eighth of the longitudes
    q0 = q0.cpu().numpy()
    exact = np.roll(q0, (2 * L) // 8, axis=-1)
    got = q.cpu().numpy()
    err = float(np.max(np.abs(got - exact)) / np.max(np.abs(exact)))
    print(f"spectral advection on the sphere (lmax={lmax}, RK4 x{steps}):")
    print(f"  rel err vs exact rotation: {err:.3e}")
    print("  (spectral in space: the error is the RK4 time truncation)")
    assert np.all(np.isfinite(got))
    return {"err": err, "q": got}


if __name__ == "__main__":
    main()
