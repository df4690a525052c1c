"""Train a 1-D FNO on a synthetic operator-learning task.

Counterpart of the JAX package's ``examples/fno_train.py``.  Task: learn
the map u0 -> the solution of the periodic heat equation at time t
(u_t = nu * u_xx), whose exact solution is a per-mode spectral decay:
learnable by the FNO's frequency-domain channel mixing, and an end-to-end
exercise of the rfft/irfft gradients.  Adam (lr 3e-3) as the JAX example's
``optax.adam``.  The JAX example jits its step; here the loss is compiled
(``torch.compile``, fullgraph; its backward with it, the fused kernel an
operator node of both graphs) and the gradient and Adam's update run
outside it, Adam ``capturable`` on the card so its step count stays there.

Run: python -m mixed_radix_fast_fourier_transform_tpu_torch.examples.fno_train
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import fno
from ..utils.numerics import resolve_device
from ..utils.tree import tree_leaves, tree_map
from . import jitted


def heat_solution(u0: np.ndarray, nu: float = 0.05, t: float = 1.0) -> np.ndarray:
    """Exact periodic heat-equation evolution via the spectral propagator."""
    n = u0.shape[-1]
    k = np.fft.fftfreq(n) * n
    decay = np.exp(-nu * (2 * np.pi * k / n) ** 2 * t * n)
    return np.fft.ifft(np.fft.fft(u0, axis=-1) * decay, axis=-1).real.astype(np.float32)


def make_batch(rng: np.random.Generator, batch: int, n: int):
    # smooth random initial conditions: low-pass filtered noise
    z = rng.standard_normal((batch, n)).astype(np.float32)
    spec = np.fft.rfft(z, axis=-1)
    spec[:, 12:] = 0
    u0 = np.fft.irfft(spec, n=n, axis=-1).astype(np.float32)
    return u0[:, None, :], heat_solution(u0)[:, None, :]  # (b, 1, n)


def main(*, device=None, steps: int = 300, n: int = 256, batch: int = 32,
         params=None, compile: bool | None = None) -> dict:
    """Trains from ``params`` (a parameter tree: tensors, or numpy arrays such
    as the JAX package's initialisation; default: ``fno.init_fno`` from
    seed 0) and returns the losses: ``history`` (step, train, eval) every 50
    steps, ``losses`` every step's train loss.  ``compile``: True compiles
    the loss with Inductor, False runs it eagerly, None (the default)
    compiles on a CUDA device only.  The evaluation loss is always eager."""
    dev = resolve_device(device)
    if compile is None:
        compile = dev.type == "cuda"
    loss_fn = jitted(fno.loss_fn, compile)
    rng = np.random.default_rng(0)
    if params is None:
        params = fno.init_fno(1, 16, 1, n_layers=2, modes=24,
                              generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    else:
        params = tree_map(lambda a: a.detach().to(dev, torch.float32).clone()
                          if isinstance(a, torch.Tensor) else
                          torch.tensor(np.asarray(a), dtype=torch.float32, device=dev), params)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    opt = torch.optim.Adam(leaves, lr=3e-3,
                           capturable=compile and dev.type == "cuda")

    def as_dev(a):
        return torch.tensor(a, device=dev)

    xe, ye = make_batch(rng, batch, n)
    xe_t, ye_t = as_dev(xe), as_dev(ye)
    history, losses = [], []
    for i in range(steps):
        x, y = make_batch(rng, batch, n)
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(params, as_dev(x), as_dev(y))
        loss.backward()
        opt.step()
        losses.append(loss.detach())
        if i % 50 == 0:
            with torch.no_grad():
                eval_loss = float(fno.loss_fn(params, xe_t, ye_t))
            history.append((i, float(loss.detach()), eval_loss))
            print(f"step {i:4d}: train {history[-1][1]:.5f}  eval {eval_loss:.5f}")
    with torch.no_grad():
        final = float(fno.loss_fn(params, xe_t, ye_t))
    base = float(np.mean(ye ** 2))
    print(f"final eval loss: {final:.5f}  (predict-zero baseline {base:.5f})")
    assert np.isfinite(final)
    return {"final_eval_loss": final, "baseline": base, "history": history,
            "losses": torch.stack(losses).cpu().numpy() if losses else np.zeros(0),
            "params": params}


if __name__ == "__main__":
    main()
