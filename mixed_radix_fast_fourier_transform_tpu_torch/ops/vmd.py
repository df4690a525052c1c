"""Variational mode decomposition (Dragomiretskiy & Zosso 2014).

Counterpart of ``mixed_radix_fast_fourier_transform_tpu/ops/vmd.py``:
decompose a signal into K band-limited modes by ADMM on
min Σ_k ‖∂_t[(δ + j/πt) * u_k]e^{−jω_k t}‖² subject to Σu_k = f.  Every
ADMM update is elementwise in the frequency domain — a Wiener filter per
mode plus a spectral centroid — so the whole decomposition runs on the
card: one engine FFT in, ``n_iter`` sweeps of vectorized updates, one
inverse FFT out.  The sweeps run as the JAX module's ``lax.fori_loop``
does, through ``utils.scan.fori_loop`` (:func:`_admm`: eagerly a few
small kernels per mode and sweep, which a caller may capture in a CUDA
graph; under ``torch.compile`` one loop node whose body is one sweep).
The host tables (the one-sided mask, the |ω| grid, the uniform and a
caller's initial frequencies) are built on the host, so ``vmd`` compiles
whole for every ``init_omega`` form.

Mirror extension (standard) removes boundary splits; the iteration count
is fixed.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..utils.config import DEFAULT_CONFIG, SpectralConfig
from ..utils.numerics import as_tensor, content_key, host_table, key_array, on_host
from ..utils.scan import fori_loop
from .fft import fft, ifft

Tensor = torch.Tensor

__all__ = ["vmd"]


def _admm(f_pos: Tensor, pos: Tensor, w: Tensor, omega: Tensor, alpha: float,
          tau: float, n_iter: int):
    """``n_iter`` Gauss-Seidel sweeps over the K modes (sequential over k,
    as the JAX module's loop body): returns the one-sided mode spectra
    (..., K, T) and the centre frequencies (..., K).  One sweep is the body
    of a ``fori_loop``; the K modes are unrolled inside it."""
    K = omega.shape[-1]

    def sweep(_, state):
        u, om, lam = list(state[0]), list(state[1]), state[2]
        sum_u = u[0]
        for k in range(1, K):
            sum_u = sum_u + u[k]
        for k in range(K):
            sum_u = sum_u - u[k]
            denom = 1.0 + 2.0 * alpha * (w - om[k][..., None]) ** 2
            u_k = (f_pos - sum_u + lam / 2.0) / denom * pos  # stay one-sided
            power = u_k.real ** 2 + u_k.imag ** 2
            om[k] = torch.sum(w * power, dim=-1) / (torch.sum(power, dim=-1) + 1e-30)
            u[k] = u_k
            sum_u = sum_u + u_k
        if tau:
            lam = lam + tau * (f_pos - sum_u)
        return tuple(u), tuple(om), lam

    u0 = tuple(torch.zeros_like(f_pos) for _ in range(K))
    om0 = tuple(omega[..., k] for k in range(K))
    u, om, _ = fori_loop(0, n_iter, sweep, (u0, om0, torch.zeros_like(f_pos)))
    return torch.stack(u, dim=-2), torch.stack(om, dim=-1)


def _pos(T: int) -> np.ndarray:
    # analytic one-sided spectrum: bins 0..T//2 (incl. Nyquist for even T
    # — fftfreq reports it as −0.5, so a freqs>=0 mask would drop it)
    return (np.arange(T) <= T // 2).astype(np.float32)


def _grid(T: int) -> np.ndarray:
    return np.abs(np.fft.fftfreq(T)).astype(np.float32)  # |ω|, cycles/sample


def _uniform(K: int) -> np.ndarray:
    return 0.5 * (np.arange(K) + 0.5) / K    # uniform in [0, 0.5)


def _omega_key(init_omega, K: int) -> tuple:
    """Host prologue of a caller's initial frequencies
    (``utils.numerics.on_host``): checked, as their content key."""
    omega0 = np.asarray(init_omega, np.float64)
    if omega0.shape != (K,):
        raise ValueError(f"init_omega must have shape ({K},)")
    return content_key("vmd.omega", omega0)


def vmd(x, K: int, alpha: float = 2000.0, tau: float = 0.0,
        n_iter: int = 300,
        init_omega=None, *,
        config: SpectralConfig = DEFAULT_CONFIG
        ) -> Tuple[Tensor, Tensor]:
    """Decompose ``x`` (..., T) into ``K`` band-limited modes.

    Returns (modes (..., K, T), center_freqs (..., K) in cycles/sample,
    sorted ascending).  ``alpha`` is the bandwidth penalty (larger =
    narrower modes), ``tau`` the dual ascent step (0 = no exact-recon
    constraint, robust to noise).  ``n_iter`` is a fixed count (VMD
    converges geometrically).

    ``init_omega``: ``"peaks"`` (default) seeds the center frequencies at
    the ``K`` largest mutually-separated spectral peaks (greedy argmax with
    a T/(16K)-bin suppression window, per batch element, on the card);
    ``"uniform"`` is the Dragomiretskiy & Zosso grid; an explicit (K,)
    array pins the initialization (under ``torch.compile`` a numpy array
    or a list: its values are read on the host).  The peak pick is an
    argmax, which may pick another of two near-equal peaks than the JAX
    function does.
    """
    x = as_tensor(x)
    if x.shape[-1] < 8:
        raise ValueError("vmd needs a signal of length >= 8")
    if not 1 <= K <= 32:
        raise ValueError(f"need 1 <= K <= 32, got {K}")
    if x.is_complex():
        raise ValueError("vmd expects a real signal (decompose the real "
                         "and imaginary parts separately for IQ data)")
    if not x.is_floating_point():
        x = x.to(config.dtype)
    T0 = x.shape[-1]
    half = T0 // 2
    # mirror extension: [rev(first half), x, rev(last half)]
    xm = torch.cat([torch.flip(x[..., :half], (-1,)), x,
                    torch.flip(x[..., T0 - half:], (-1,))], dim=-1)
    T = xm.shape[-1]
    f_hat = fft(xm, config=config)
    pos = host_table("vmd.pos", _pos, T, like=f_hat)
    w = host_table("vmd.w", _grid, T, like=f_hat)
    f_pos = f_hat * pos

    batch = tuple(x.shape[:-1])
    if init_omega is None:
        init_omega = "peaks"
    if isinstance(init_omega, str):
        if init_omega == "peaks":
            # greedy K-peak pick on the one-sided power spectrum: argmax,
            # record w there, suppress a window, repeat
            p = f_pos.real ** 2 + f_pos.imag ** 2
            halfw = max(1, T // (16 * K))
            bins = torch.arange(T, device=p.device)
            oms = []
            for _ in range(K):
                m = torch.argmax(p, dim=-1)
                oms.append(torch.index_select(w, 0, m.reshape(-1)).reshape(m.shape))
                p = p * (torch.abs(bins - m[..., None]) > halfw)
            omega_init = torch.sort(torch.stack(oms, dim=-1), dim=-1).values
        elif init_omega == "uniform":
            omega_init = host_table("vmd.uniform", _uniform, K, like=f_hat).expand(batch + (K,))
        else:
            raise ValueError(
                f"init_omega must be 'peaks', 'uniform', or a (K,) array, "
                f"got {init_omega!r}")
    else:
        okey = on_host(_omega_key, init_omega, K)
        omega_init = host_table("vmd.omega", key_array, okey, like=f_hat).expand(batch + (K,))

    u, omega = _admm(f_pos, pos, w, omega_init, float(alpha), float(tau), int(n_iter))

    # modes: Hermitian-complete the one-sided spectra, inverse, un-mirror.
    # The flip/roll maps bin m → conj(u[(T−m) mod T]); the self-conjugate
    # bins (0 and, for even T, T/2) map onto themselves and would double —
    # reset them to their (real) one-sided values.
    u_full = u + torch.conj(torch.flip(torch.roll(u, -1, dims=-1), (-1,)))
    u_full[..., 0] = u[..., 0].real.to(u.dtype)
    if T % 2 == 0:
        u_full[..., T // 2] = u[..., T // 2].real.to(u.dtype)
    modes = ifft(u_full, config=config).real[..., half: half + T0]
    order = torch.argsort(omega, dim=-1)
    modes = torch.take_along_dim(modes, order[..., None], dim=-2)
    omega = torch.take_along_dim(omega, order, dim=-1)
    return modes, omega
