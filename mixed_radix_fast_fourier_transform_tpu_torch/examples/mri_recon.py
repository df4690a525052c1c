"""MRI-style image reconstruction from radial k-space samples.

Counterpart of the JAX package's ``examples/mri_recon.py``.  A synthetic
phantom is sampled along radial k-space spokes (2-D type-2 NUFFT), then
reconstructed two ways:

1. adjoint ("gridding") reconstruction with radial density compensation:
   one 2-D type-1 NUFFT;
2. iterative least squares via :func:`nufft_lsq_2d`: CG on the
   block-Toeplitz normal equations, each iteration one padded fft2.

Run: python -m mixed_radix_fast_fourier_transform_tpu_torch.examples.mri_recon
"""

from __future__ import annotations

import numpy as np
import torch

from .. import nufft1_2d, nufft2_2d, nufft_lsq_2d
from ..utils.numerics import resolve_device


def phantom(n: int) -> np.ndarray:
    """Tiny Shepp-Logan-flavoured phantom: nested ellipses."""
    yy, xx = np.mgrid[-1 : 1 : n * 1j, -1 : 1 : n * 1j]
    img = np.zeros((n, n))
    for (cx, cy, ax, ay, val) in [
        (0.0, 0.0, 0.75, 0.9, 1.0),
        (0.0, 0.05, 0.65, 0.8, -0.6),
        (0.2, 0.2, 0.15, 0.25, 0.4),
        (-0.25, -0.2, 0.2, 0.15, 0.35),
    ]:
        img[((xx - cx) / ax) ** 2 + ((yy - cy) / ay) ** 2 <= 1.0] += val
    return img


def radial_kspace(n: int, spokes: int, per_spoke: int):
    """Radial k-space trajectory.  The image's centered pixels play the
    modes of the 2-D NUFFT, so a k-space coordinate kappa (cycles per FOV,
    |kappa| <= n/2) is the point x = 2*pi*kappa/n; spokes cover the inscribed
    disc (the corners of k-space are unsampled, as usual in radial MRI)."""
    th = np.pi * np.arange(spokes) / spokes
    kappa = np.linspace(-n / 2, n / 2, per_spoke, endpoint=False)
    kx = np.outer(np.cos(th), kappa).ravel() * 2 * np.pi / n
    ky = np.outer(np.sin(th), kappa).ravel() * 2 * np.pi / n
    # density compensation ~ |kappa| (ram-lak), normalized to mean 1
    w = np.abs(np.outer(np.ones(spokes), kappa)).ravel()
    w = w / w.sum() * len(w)
    return (np.mod(kx, 2 * np.pi).astype(np.float32),
            np.mod(ky, 2 * np.pi).astype(np.float32),
            w.astype(np.float32))


def psnr(a, b):
    mse = np.mean((a - b) ** 2)
    return 10 * np.log10(np.max(b) ** 2 / mse) if mse > 0 else np.inf


def main(*, device=None, n: int = 32, spokes: int = 64, per_spoke=None,
         iters: int = 25) -> dict:
    """``per_spoke`` defaults to 2n points a spoke.  Returns the PSNRs of the
    two reconstructions and of the disc-truncation oracle, and the images."""
    dev = resolve_device(device)
    per_spoke = 2 * n if per_spoke is None else per_spoke
    img = phantom(n)
    x, y, w = radial_kspace(n, spokes=spokes, per_spoke=per_spoke)
    print(f"phantom {n}x{n}, {len(x)} radial k-space samples "
          f"({spokes} spokes x {per_spoke} points)")
    xt, yt, wt = (torch.tensor(a, device=dev) for a in (x, y, w))

    # forward "scanner": the image's centered pixels are the NUFFT modes, so
    # type 2 evaluates the k-space signal along the spokes
    b = nufft2_2d(xt, yt, torch.tensor(img.astype(np.complex64), device=dev), isign=-1)

    # 1. adjoint + density compensation ("gridding" reconstruction)
    adj = (nufft1_2d(xt, yt, b * wt, (n, n), isign=+1) / len(x)).cpu().numpy()
    p_adj = float(psnr(np.real(adj), img))
    print(f"  adjoint+DCF reconstruction: PSNR {p_adj:.1f} dB")

    # 2. iterative least squares (CG on the Toeplitz normal equations); the
    # unsampled k-space corners are the system's null space: CG leaves them
    # at zero, so the result approaches the disc-truncation oracle
    rec = nufft_lsq_2d(xt, yt, b, (n, n), weights=wt, iters=iters, isign=-1).cpu().numpy()
    p_cg = float(psnr(np.real(rec), img))
    print(f"  CG least-squares ({iters} iters):  PSNR {p_cg:.1f} dB")

    # oracle: zero the k-space disc complement (what radial can never see)
    k = np.arange(-(n // 2), n // 2)
    K1, K2 = np.meshgrid(k, k, indexing="ij")
    spec = np.fft.fftshift(np.fft.fft2(np.fft.ifftshift(img)))
    spec[K1 ** 2 + K2 ** 2 > (n / 2) ** 2] = 0
    oracle = np.real(np.fft.fftshift(np.fft.ifft2(np.fft.ifftshift(spec))))
    p_oracle = float(psnr(oracle, img))
    print(f"  disc-truncation oracle:       PSNR {p_oracle:.1f} dB")
    assert np.all(np.isfinite(adj)) and np.all(np.isfinite(rec))
    assert p_cg > p_adj, (p_cg, p_adj)
    return {"psnr_adjoint": p_adj, "psnr_cg": p_cg, "psnr_oracle": p_oracle,
            "adjoint": adj, "cg": rec, "samples": b.cpu().numpy()}


if __name__ == "__main__":
    main()
