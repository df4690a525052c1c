"""Flagship model: a trainable spectral filter.

Counterpart of the single-device part of
``mixed_radix_fast_fourier_transform_tpu/models/spectral_filter.py``:

    y = irfft( rfft(x) ⊙ (gain_re + i·gain_im) ) + bias

over the last axis of a (..., n) real signal, with its MSE loss and one SGD
step.  Gradients flow through the whole engine: through the fused kernel
(its backward is the kernel at the opposite sign) on the card as on the
CPU, or through the stage pipeline.  Parameters live on the card unless the
caller asks for another device.

The distributed variant (data parallelism over the mesh's ``data`` axis,
the transform sharded over ``seq`` by the four-step all-to-all FFT) filters
with a full-spectrum complex gain.  Its parameters are plain tensors that
every rank holds; a step sums the ranks' gradients with an all-reduce.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from ..ops.rfft import irfft, rfft
from ..parallel.distributed import (
    _like, _local, _mean_squared_error, _replicated, fft_four_step, ifft_four_step,
)
from ..utils.config import DEFAULT_CONFIG, DTYPE, SpectralConfig
from ..utils.numerics import as_tensor, resolve_device
from ..utils.sharding import batch_sharded, data_parallel_mse, last_axis
from ..utils.tree import sgd_step
from ._common import params_from_jax

Tensor = torch.Tensor
Params = Dict[str, Tensor]


def init_params(
    n: int,
    generator: Optional[torch.Generator] = None,
    device=None,
    dtype=DTYPE,
) -> Params:
    """Per-bin complex gain (identity plus 0.01·N(0, 1) noise) and a zero
    bias of ``dtype`` (fp32, or float64 for the float64 route), drawn from
    ``generator`` on its own device (the CPU when None), then placed on
    ``device`` (default: the card, see resolve_device)."""
    n_bins = n // 2 + 1
    gen_device = generator.device if generator is not None else torch.device("cpu")
    device = resolve_device(device)

    def noise():
        return torch.randn(n_bins, generator=generator, dtype=dtype,
                           device=gen_device).to(device)

    return {
        "gain_re": 1.0 + 0.01 * noise(),
        "gain_im": 0.01 * noise(),
        "bias": torch.zeros((), dtype=dtype, device=device),
    }


def _signal_axis(params, x, *args, **kwargs):
    return last_axis(x)


@batch_sharded(_signal_axis, arg=1)
def apply(params: Params, x: Tensor, *, config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    """Forward pass: (..., n) real -> (..., n) real."""
    x = as_tensor(x)
    n = x.shape[-1]
    spec = rfft(x, config=config)
    gain = torch.complex(params["gain_re"], params["gain_im"])
    return irfft(spec * gain, n=n, config=config) + params["bias"]


def loss_fn(
    params: Params, x: Tensor, target: Tensor, *, config: SpectralConfig = DEFAULT_CONFIG
) -> Tensor:
    """MSE between the filtered signal and the target; on a batch-sharded
    DTensor ``x`` the global MSE, data-parallel (see
    ``utils.sharding.data_parallel_mse``)."""
    if isinstance(x, DTensor):
        return data_parallel_mse(lambda p, v: apply(p, v, config=config), params, x, target)
    y = apply(params, x, config=config)
    return torch.mean((y - as_tensor(target, y.device)) ** 2)


def train_step(
    params: Params,
    x: Tensor,
    target: Tensor,
    lr: float = 1e-2,
    *,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tuple[Params, Tensor]:
    """One SGD step, differentiating through the whole FFT engine: returns
    (new parameters, loss).  The parameters given are not changed.  With
    the fused kernel it launches three times: rfft, irfft, and irfft's
    backward (the input needs no gradient, so rfft's is never computed).
    On batch-sharded DTensors ``x`` and ``target`` the step is
    data-parallel: the new parameters are plain tensors equal on every
    rank."""
    return sgd_step(loss_fn, params, x, target, lr=lr, config=config)


# ---------------------------------------------------------------------------
# Distributed variant: data parallelism over "data" (batch) and the
# transform axis sharded over "seq" through the four-step all-to-all FFT.
# A complex-valued filter, so the sharded transform is the plain complex
# four-step.
# ---------------------------------------------------------------------------


def init_params_complex(
    n: int,
    generator: Optional[torch.Generator] = None,
    device=None,
    dtype=DTYPE,
) -> Params:
    """Full-spectrum (length n) gain for the distributed complex filter:
    identity plus 0.01·N(0, 1) noise in both parts and a zero bias of
    ``dtype``, drawn
    from ``generator`` on its own device (the CPU when None), then placed on
    ``device`` (default: the card)."""
    gen_device = generator.device if generator is not None else torch.device("cpu")
    device = resolve_device(device)

    def noise():
        return torch.randn(n, generator=generator, dtype=dtype, device=gen_device).to(device)

    return {
        "gain_re": 1.0 + 0.01 * noise(),
        "gain_im": 0.01 * noise(),
        "bias": torch.zeros((), dtype=dtype, device=device),
    }


def apply_distributed(
    params: Params,
    x,
    mesh: DeviceMesh,
    *,
    data_axis: Optional[str] = "data",
    seq_axis: str = "seq",
    n1: Optional[int] = None,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> DTensor:
    """(batch, n) real -> (batch, n) real with batch and transform both
    sharded: forward four-step FFT, the per-bin complex gain (each rank
    multiplies its block of the spectrum by its block of the replicated
    gain), inverse four-step; three all-to-alls a transform.  The
    parameters are plain tensors every rank holds; their gradients come
    back summed over the mesh."""
    params = _replicated(params, mesh)
    spec = fft_four_step(x, mesh, seq_axis=seq_axis, data_axis=data_axis, n1=n1,
                         config=config)
    gain = torch.complex(_local(params["gain_re"], mesh, (seq_axis,)),
                         _local(params["gain_im"], mesh, (seq_axis,)))
    y = ifft_four_step(_like(spec, spec.to_local() * gain), mesh, seq_axis=seq_axis,
                       data_axis=data_axis, n1=n1, config=config)
    return _like(y, y.to_local().real + params["bias"])


def loss_distributed(params: Params, x, target, mesh: DeviceMesh, **kw) -> Tensor:
    """The global MSE, held by every rank (a local sum, an all-reduce, the
    global count)."""
    return _mean_squared_error(apply_distributed(params, x, mesh, **kw), target)


def train_step_distributed(
    params: Params, x, target, mesh: DeviceMesh, lr: float = 1e-2, **kw
) -> Tuple[Params, Tensor]:
    """One SGD step of the sharded spectral filter: gradients flow through
    the all-to-alls (the backward of each is the reverse exchange); each
    rank's parameter gradients are summed over the mesh with an all-reduce,
    so every rank holds the same new parameters.  Returns (new parameters,
    loss)."""
    return sgd_step(loss_distributed, params, x, target, mesh, lr=lr, **kw)


class SpectralFilter(nn.Module):
    """The spectral filter for length-``n`` signals as a module holding
    ``gain_re``, ``gain_im`` and ``bias`` (set them from other parameters
    with ``load_state_dict``), on ``device`` (default: the card)."""

    def __init__(
        self,
        n: int,
        generator: Optional[torch.Generator] = None,
        device=None,
        *,
        config: SpectralConfig = DEFAULT_CONFIG,
    ):
        super().__init__()
        self.n = n
        self.config = config
        p = init_params(n, generator, device)
        self.gain_re = nn.Parameter(p["gain_re"])
        self.gain_im = nn.Parameter(p["gain_im"])
        self.bias = nn.Parameter(p["bias"])

    def forward(self, x: Tensor) -> Tensor:
        params = {"gain_re": self.gain_re, "gain_im": self.gain_im,
                  "bias": self.bias}
        return apply(params, x, config=self.config)
