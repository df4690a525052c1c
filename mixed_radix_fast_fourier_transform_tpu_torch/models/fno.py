"""Fourier neural operators in one, two and three dimensions.

Counterpart of ``mixed_radix_fast_fourier_transform_tpu/models/fno.py``.
An FNO layer mixes channels in the frequency domain,

    y = gelu( W·x + irfft( R ⊙ rfft(x) ) )

with a learned complex tensor R over the lowest ``modes`` bins (Li et al.,
2021), on this library's rfft/fft instead of a framework builtin.  The
spectral mix is a ``torch.einsum`` over channels on the low-mode slice (full
fp32: keep ``torch.backends.cuda.matmul.allow_tf32`` False); the transforms
go through the engine, so on the card every transform of a 7-smooth length
and its gradient run the fused kernel.  The 2-D and 3-D forms transform
non-last axes too; the fft layer hands the kernel planes made contiguous
from the moved-axis views, forward and backward.

Functional API as in the JAX module: parameters are nested dicts of tensors
(``params_from_jax`` converts the JAX package's), ``apply*``/``loss_fn*``/
``train_step*`` are plain functions.  ``FNO1d``/``FNO2d``/``FNO3d`` wrap the
same functions as ``nn.Module``s.  The activation is the tanh approximation
of GELU, the JAX default.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor

from ..ops.fft import fft, ifft
from ..ops.rfft import irfft, rfft
from ..utils.config import DEFAULT_CONFIG, DTYPE, SpectralConfig
from ..utils.numerics import as_tensor
from ..utils.sharding import batch_sharded, data_parallel_mse, non_batch
from ..utils.tree import sgd_step, tree_map
from ._common import Draws, params_from_jax

Tensor = torch.Tensor
Params = Dict[str, Tensor]

# channel-mixing einsums and bias shapes by number of spatial axes
_SPACE = {1: "n", 2: "hw", 3: "dhw"}


def _init_layer(normal: Draws, channels: int, modes, corners) -> Params:
    scale = 1.0 / channels
    out: Params = {}
    for name in corners:
        out[f"{name}_re"] = scale * normal(channels, channels, *modes)
        out[f"{name}_im"] = scale * normal(channels, channels, *modes)
    out["w"] = scale * normal(channels, channels)
    out["b"] = normal.zeros(channels)
    return out


def _init(normal: Draws, in_channels, hidden, out_channels, n_layers, modes, corners):
    return {
        "lift": {
            "w": normal(in_channels, hidden) / max(in_channels, 1),
            "b": normal.zeros(hidden),
        },
        "layers": [_init_layer(normal, hidden, modes, corners) for _ in range(n_layers)],
        "proj": {
            "w": normal(hidden, out_channels) / hidden,
            "b": normal.zeros(out_channels),
        },
    }


def init_layer(channels: int, modes: int, generator=None, device=None, dtype=DTYPE) -> Params:
    return _init_layer(Draws(generator, device, dtype), channels, (modes,), ("r",))


def init_fno(in_channels: int, hidden: int, out_channels: int, n_layers: int = 2,
             modes: int = 16, generator=None, device=None, dtype=DTYPE):
    """1-D FNO parameters: a pointwise lift, ``n_layers`` Fourier layers on
    ``hidden`` channels and a pointwise projection."""
    return _init(Draws(generator, device, dtype), in_channels, hidden, out_channels,
                 n_layers, (modes,), ("r",))


def init_layer2d(channels: int, modes_h: int, modes_w: int, generator=None,
                 device=None, dtype=DTYPE) -> Params:
    """Two learned tensors, one per low-frequency corner of the half-plane
    spectrum (non-negative H modes ``r``, negative H modes ``r2``)."""
    return _init_layer(Draws(generator, device, dtype), channels, (modes_h, modes_w),
                       ("r", "r2"))


def init_fno2d(in_channels: int, hidden: int, out_channels: int, n_layers: int = 2,
               modes: int = 8, generator=None, device=None, dtype=DTYPE):
    return _init(Draws(generator, device, dtype), in_channels, hidden, out_channels,
                 n_layers, (modes, modes), ("r", "r2"))


def init_layer3d(channels: int, modes_d: int, modes_h: int, modes_w: int,
                 generator=None, device=None, dtype=DTYPE) -> Params:
    """Four learned tensors ``r0``..``r3``, one per signed-frequency corner
    of the (D, H) plane (W is the non-negative rfft half)."""
    return _init_layer(Draws(generator, device, dtype), channels,
                       (modes_d, modes_h, modes_w), ("r0", "r1", "r2", "r3"))


def init_fno3d(in_channels: int, hidden: int, out_channels: int, n_layers: int = 2,
               modes: int = 4, generator=None, device=None, dtype=DTYPE):
    return _init(Draws(generator, device, dtype), in_channels, hidden, out_channels,
                 n_layers, (modes, modes, modes), ("r0", "r1", "r2", "r3"))


def _weight(layer: Params, name: str) -> Tensor:
    return torch.complex(layer[f"{name}_re"], layer[f"{name}_im"])


def spectral_mix(layer: Params, x: Tensor, *, config: SpectralConfig) -> Tensor:
    """(batch, channels, n) -> (batch, channels, n): per-mode channel mixing."""
    n = x.shape[-1]
    r = _weight(layer, "r")  # (c_in, c_out, modes)
    modes = r.shape[-1]
    spec = rfft(x, config=config)  # (b, c, n//2+1) complex
    mixed = spec.new_zeros(spec.shape[0], r.shape[1], spec.shape[-1])
    mixed[..., :modes] = torch.einsum("bim,iom->bom", spec[..., :modes], r)
    return irfft(mixed, n=n, config=config)


def spectral_mix2d(layer: Params, x: Tensor, *, config: SpectralConfig) -> Tensor:
    """(b, c, H, W) -> (b, c, H, W): low-mode channel mixing in 2-D frequency
    space (rfft over W, complex fft over H), on both low-frequency corners
    of the half-plane spectrum: non-negative H modes with ``r``, negative H
    modes with ``r2``."""
    bh, bw = x.shape[-2], x.shape[-1]
    r, r2 = _weight(layer, "r"), _weight(layer, "r2")
    mh, mw = r.shape[-2:]
    if 2 * mh > bh:
        raise ValueError(f"modes_h={mh} needs H >= 2*modes_h, got H={bh}")
    spec = fft(rfft(x, config=config), axis=-2, config=config)  # (b,c,H,W//2+1)
    mixed = spec.new_zeros(spec.shape[0], r.shape[1], *spec.shape[2:])
    mixed[..., :mh, :mw] = torch.einsum("bihw,iohw->bohw", spec[..., :mh, :mw], r)
    mixed[..., bh - mh:, :mw] = torch.einsum(
        "bihw,iohw->bohw", spec[..., bh - mh:, :mw], r2)
    return irfft(ifft(mixed, axis=-2, config=config), n=bw, config=config)


def spectral_mix3d(layer: Params, x: Tensor, *, config: SpectralConfig) -> Tensor:
    """(b, c, D, H, W) -> (b, c, D, H, W): low-mode channel mixing in 3-D
    frequency space over all four signed-frequency corners of the (D, H)
    plane."""
    bd, bh, bw = x.shape[-3], x.shape[-2], x.shape[-1]
    md, mh, mw = layer["r0_re"].shape[-3:]
    if 2 * md > bd or 2 * mh > bh:
        raise ValueError(
            f"modes ({md}, {mh}) need D >= 2*modes_d and H >= 2*modes_h, "
            f"got ({bd}, {bh})"
        )
    spec = rfft(x, config=config)                      # (b,c,D,H,W//2+1)
    spec = fft(spec, axis=-2, config=config)           # over H
    spec = fft(spec, axis=-3, config=config)           # over D
    mixed = spec.new_zeros(spec.shape[0], layer["r0_re"].shape[1], *spec.shape[2:])
    corners = [
        (slice(None, md), slice(None, mh)),
        (slice(bd - md, None), slice(None, mh)),
        (slice(None, md), slice(bh - mh, None)),
        (slice(bd - md, None), slice(bh - mh, None)),
    ]
    for i, (sd, sh) in enumerate(corners):
        mixed[..., sd, sh, :mw] = torch.einsum(
            "bidhw,iodhw->bodhw", spec[..., sd, sh, :mw], _weight(layer, f"r{i}"))
    out = ifft(mixed, axis=-3, config=config)
    out = ifft(out, axis=-2, config=config)
    return irfft(out, n=bw, config=config)


_MIX = {1: spectral_mix, 2: spectral_mix2d, 3: spectral_mix3d}


def _pointwise(p: Params, x: Tensor, nd: int) -> Tensor:
    """Channel mixing at every grid point: x·w + b over axis 1."""
    sp = _SPACE[nd]
    return torch.einsum(f"bi{sp},io->bo{sp}", x, p["w"]) + p["b"].reshape(-1, *(1,) * nd)


def _layer(layer: Params, x: Tensor, nd: int, config: SpectralConfig) -> Tensor:
    return F.gelu(_pointwise(layer, x, nd) + _MIX[nd](layer, x, config=config),
                  approximate="tanh")


@batch_sharded(non_batch, arg=1)
def _apply(params, x: Tensor, nd: int, config: SpectralConfig) -> Tensor:
    h = _pointwise(params["lift"], as_tensor(x), nd)
    for layer in params["layers"]:
        h = _layer(layer, h, nd, config)
    return _pointwise(params["proj"], h, nd)


def fno_layer(layer: Params, x: Tensor, *, config: SpectralConfig) -> Tensor:
    return _layer(layer, x, 1, config)


def fno2d_layer(layer: Params, x: Tensor, *, config: SpectralConfig) -> Tensor:
    return _layer(layer, x, 2, config)


def fno3d_layer(layer: Params, x: Tensor, *, config: SpectralConfig) -> Tensor:
    return _layer(layer, x, 3, config)


def apply(params, x: Tensor, *, config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    """(batch, in_channels, n) -> (batch, out_channels, n).  Each of the
    three forwards takes a batch-sharded DTensor ``x`` (see
    ``utils.sharding.batch_sharded``): every axis but the batch is
    gathered, the layers run on each rank's block, and the output is
    sharded as ``x`` along the batch."""
    return _apply(params, x, 1, config)


def apply2d(params, x: Tensor, *, config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    """(batch, in_channels, H, W) -> (batch, out_channels, H, W)."""
    return _apply(params, x, 2, config)


def apply3d(params, x: Tensor, *, config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    """(batch, in_channels, D, H, W) -> (batch, out_channels, D, H, W)."""
    return _apply(params, x, 3, config)


def _loss(params, x, target, nd: int, config: SpectralConfig) -> Tensor:
    """MSE against ``target``; on a batch-sharded DTensor ``x`` the global
    MSE, data-parallel (``utils.sharding.data_parallel_mse``), so each
    ``train_step*`` on sharded batches leaves the same plain parameters on
    every rank."""
    if isinstance(x, DTensor):
        return data_parallel_mse(lambda p, v: _apply(p, v, nd, config), params, x, target)
    y = _apply(params, x, nd, config)
    return torch.mean((y - as_tensor(target, y.device)) ** 2)


def loss_fn(params, x, target, *, config=DEFAULT_CONFIG) -> Tensor:
    return _loss(params, x, target, 1, config)


def loss_fn2d(params, x, target, *, config=DEFAULT_CONFIG) -> Tensor:
    return _loss(params, x, target, 2, config)


def loss_fn3d(params, x, target, *, config=DEFAULT_CONFIG) -> Tensor:
    return _loss(params, x, target, 3, config)


def train_step(params, x, target, lr: float = 1e-3, *, config=DEFAULT_CONFIG):
    """One SGD step: (new parameter tree, loss)."""
    return sgd_step(loss_fn, params, x, target, lr=lr, config=config)


def train_step2d(params, x, target, lr: float = 1e-3, *, config=DEFAULT_CONFIG):
    return sgd_step(loss_fn2d, params, x, target, lr=lr, config=config)


def train_step3d(params, x, target, lr: float = 1e-3, *, config=DEFAULT_CONFIG):
    return sgd_step(loss_fn3d, params, x, target, lr=lr, config=config)


class _FNO(nn.Module):
    """A parameter tree as a module: ``lift``, ``layers`` and ``proj`` hold
    the tree's leaves under its own names (``layers.0.r_re`` …)."""

    nd = 0

    def __init__(self, params, config: SpectralConfig):
        super().__init__()
        self.config = config
        as_dict = lambda p: nn.ParameterDict(tree_map(nn.Parameter, p))
        self.lift = as_dict(params["lift"])
        self.layers = nn.ModuleList(as_dict(layer) for layer in params["layers"])
        self.proj = as_dict(params["proj"])

    def param_tree(self):
        """The module's parameters as the functional API's tree."""
        return {"lift": dict(self.lift.items()),
                "layers": [dict(layer.items()) for layer in self.layers],
                "proj": dict(self.proj.items())}

    def load_param_tree(self, params) -> None:
        """Copy a parameter tree of the same structure into the module."""
        with torch.no_grad():
            tree_map(lambda mine, theirs: mine.copy_(theirs), self.param_tree(), params)

    def forward(self, x: Tensor) -> Tensor:
        return _apply(self.param_tree(), x, self.nd, self.config)


class FNO1d(_FNO):
    """:func:`init_fno` and :func:`apply` as a module, on ``device``
    (default: the card)."""

    nd = 1

    def __init__(self, in_channels, hidden, out_channels, n_layers=2, modes=16,
                 generator=None, device=None, *, config=DEFAULT_CONFIG):
        super().__init__(init_fno(in_channels, hidden, out_channels, n_layers,
                                  modes, generator, device), config)


class FNO2d(_FNO):
    """:func:`init_fno2d` and :func:`apply2d` as a module."""

    nd = 2

    def __init__(self, in_channels, hidden, out_channels, n_layers=2, modes=8,
                 generator=None, device=None, *, config=DEFAULT_CONFIG):
        super().__init__(init_fno2d(in_channels, hidden, out_channels, n_layers,
                                    modes, generator, device), config)


class FNO3d(_FNO):
    """:func:`init_fno3d` and :func:`apply3d` as a module."""

    nd = 3

    def __init__(self, in_channels, hidden, out_channels, n_layers=2, modes=4,
                 generator=None, device=None, *, config=DEFAULT_CONFIG):
        super().__init__(init_fno3d(in_channels, hidden, out_channels, n_layers,
                                    modes, generator, device), config)
