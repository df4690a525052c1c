"""Serving-side deployment of a spectral pipeline.

Counterpart of the JAX package's ``examples/serving_export.py``.  Exports a
denoise pipeline (rfft -> per-bin Wiener-style gain -> irfft) with
``torch.export`` to bytes, then reloads and runs it as a serving fleet would:
no plan construction, no factorization on the serving path (the stage
matrices and twiddles are constants of the exported graph; on the card the
graph holds the fused kernel's operator, which the reloading process
registers by importing the port).  Then the same pipeline compiled ahead of
time in-process (``aot_compile``: ``torch.compile`` now, plans, tables and
the kernel built while it traces, one call captured in a CUDA graph on the
card).

Run: python -m mixed_radix_fast_fourier_transform_tpu_torch.examples.serving_export
"""

from __future__ import annotations

import numpy as np
import torch

from .. import irfft, rfft
from ..utils.aot import aot_compile, export_transform, load_transform
from ..utils.numerics import resolve_device

# the exported and compiled pipelines take the live call's route, but
# Inductor fuses and orders the elementwise work its own way: the outputs
# agree within the two fp32 routes' 2e-5
RELOAD_TOL = 2e-5


def denoise(x: torch.Tensor) -> torch.Tensor:
    """Fixed-gain spectral denoiser for (batch, 4096) fp32 frames."""
    spec = rfft(x)
    k = torch.arange(spec.shape[-1], dtype=torch.float32, device=x.device)
    gain = 1.0 / (1.0 + (k / 400.0) ** 4)  # lowpass Butterworth-style
    return irfft(spec * gain, n=x.shape[-1])


def main(*, device=None, batch: int = 8, n: int = 4096) -> dict:
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    frames = torch.tensor(rng.standard_normal((batch, n)).astype(np.float32), device=dev)

    # 1. build side: export the pipeline for the serving shape
    blob = export_transform(denoise, frames)
    print(f"exported artifact: {len(blob)} bytes (torch.export, plans baked in)")

    # 2. serve side: reload from bytes and run
    runner = load_transform(blob)
    out = runner(frames)
    ref = denoise(frames)
    scale = float(ref.abs().max())
    reload_err = float((out - ref).abs().max())
    print(f"reloaded output matches source: max err {reload_err:.2e}")
    assert out.shape == frames.shape and reload_err <= RELOAD_TOL * scale

    # 3. alternative: set up in-process ahead of time (no first-request cost)
    compiled = aot_compile(denoise, frames)
    t = compiled(frames)
    aot_err = float((t - ref).abs().max())
    print(f"AOT set-up ready; its output against the live call: max err {aot_err:.2e}")
    assert aot_err <= RELOAD_TOL * scale
    return {"artifact_bytes": len(blob), "reload_max_err": reload_err,
            "aot_max_err": aot_err, "output": ref}


if __name__ == "__main__":
    main()
