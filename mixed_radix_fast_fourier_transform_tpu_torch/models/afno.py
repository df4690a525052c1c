"""Adaptive Fourier Neural Operator (AFNO), the FourCastNet-class mixer.

Counterpart of ``mixed_radix_fast_fourier_transform_tpu/models/afno.py``: a
ViT-style backbone whose token mixing happens in the 2-D Fourier domain
(Guibas et al., 2022).  Each block computes

    x = x + irfft2( softshrink( BlockMLP( rfft2(LN(x)) ) ) )
    x = x + MLP(LN(x))

where BlockMLP is a two-layer complex MLP applied block-diagonally over the
channel dimension (channels split into ``n_blocks`` groups: O(d²/nb) weights
instead of the FNO's O(d²·modes)) and softshrink(z, λ) = sign(z)·max(|z|−λ, 0)
sparsifies the spectrum.  A hard mode fraction keeps only the lowest spatial
frequencies.

The complex arithmetic of the spectral MLP is explicit on (re, im) planes:
four real ``torch.einsum`` products per complex one, full fp32 (keep
``torch.backends.cuda.matmul.allow_tf32`` False).  ``rfft2``/``irfft2`` go
through the engine, so on the card both axes of the token grid, forward and
backward, run the fused kernel where their lengths qualify.

Functional API as in the JAX module; :class:`AFNO` wraps it as an
``nn.Module``.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from ..ops.rfft import irfft2, rfft2
from ..utils.config import DEFAULT_CONFIG, SpectralConfig
from ..utils.tree import sgd_step
from ._common import Draws, TreeModule, as_input, gelu, layer_norm, params_from_jax

Tensor = torch.Tensor
Params = Dict[str, Tensor]

__all__ = [
    "AFNO", "afno_block", "afno_filter", "apply", "init_afno", "init_block", "loss_fn",
    "params_from_jax", "train_step",
]

_INIT_SCALE = 0.02


def _init_block(draw: Draws, dim: int, n_blocks: int, mlp_ratio: float) -> Params:
    if dim % n_blocks:
        raise ValueError(f"dim {dim} not divisible by n_blocks {n_blocks}")
    bs = dim // n_blocks
    hidden = bs  # AFNO uses a square block MLP in the spectral domain
    s = _INIT_SCALE
    ff = int(dim * mlp_ratio)
    return {
        # spectral block-diagonal complex MLP: (nb, bs, hidden) × {re, im}
        "w1_re": s * draw(n_blocks, bs, hidden),
        "w1_im": s * draw(n_blocks, bs, hidden),
        "b1_re": draw.zeros(n_blocks, hidden),
        "b1_im": draw.zeros(n_blocks, hidden),
        "w2_re": s * draw(n_blocks, hidden, bs),
        "w2_im": s * draw(n_blocks, hidden, bs),
        "b2_re": draw.zeros(n_blocks, bs),
        "b2_im": draw.zeros(n_blocks, bs),
        # token MLP
        "mlp_w1": s * draw(dim, ff),
        "mlp_b1": draw.zeros(ff),
        "mlp_w2": s * draw(ff, dim),
        "mlp_b2": draw.zeros(dim),
        "ln1_s": draw.ones(dim),
        "ln1_b": draw.zeros(dim),
        "ln2_s": draw.ones(dim),
        "ln2_b": draw.zeros(dim),
    }


def init_block(dim: int, n_blocks: int, mlp_ratio: float = 4.0, generator=None,
               device=None) -> Params:
    return _init_block(Draws(generator, device), dim, n_blocks, mlp_ratio)


def init_afno(in_channels: int, dim: int, out_channels: int, *, patch: int = 4,
              n_layers: int = 2, n_blocks: int = 4, mlp_ratio: float = 4.0,
              generator=None, device=None) -> Dict[str, object]:
    """AFNO for (batch, H, W, in_channels) fields: patch embed -> n_layers
    AFNO blocks -> patch de-embed to (batch, H, W, out_channels)."""
    draw = Draws(generator, device)
    pdim = patch * patch * in_channels
    odim = patch * patch * out_channels
    return {
        "embed": {"w": draw(pdim, dim) / pdim, "b": draw.zeros(dim)},
        "blocks": [_init_block(draw, dim, n_blocks, mlp_ratio) for _ in range(n_layers)],
        "head": {"w": draw(dim, odim) / dim, "b": draw.zeros(odim)},
    }


def afno_filter(p: Params, x: Tensor, n_blocks: int, *, sparsity: float = 0.01,
                hard_fraction: float = 1.0,
                config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    """Spectral token mixing: (b, h, w, d) -> (b, h, w, d).

    rfft2 over the token grid, block-diagonal two-layer complex MLP with
    ReLU on the kept modes, soft shrinkage, irfft2.  ``hard_fraction``
    truncates to the lowest |k_h| rows and the first k_w columns."""
    b, h, w, d = x.shape
    bs = d // n_blocks
    # channels first for the spatial transform
    spec = rfft2(torch.movedim(x, -1, 1), config=config)   # (b, d, h, w//2+1) complex
    wb = spec.shape[-1]
    kh = max(1, min(h, int(h * hard_fraction)))
    kw = max(1, min(wb, int(wb * hard_fraction)))
    # kept rows: lowest |freq| along h, [0:ceil(kh/2)] and [h-floor(kh/2):]
    top = -(-kh // 2)
    bot = kh // 2

    def keep(a: Tensor) -> Tensor:
        if bot:
            a = torch.cat([a[..., :top, :kw], a[..., h - bot:, :kw]], dim=-2)
        else:
            a = a[..., :top, :kw]
        return a.reshape(b, n_blocks, bs, kh, kw)

    def cmm(ar, ai, wre, wim, br, bi):
        # complex (…, c) @ (nb, c, o) + bias, on planes
        re = (torch.einsum("bnchw,nco->bnohw", ar, wre)
              - torch.einsum("bnchw,nco->bnohw", ai, wim)
              + br[None, :, :, None, None])
        im = (torch.einsum("bnchw,nco->bnohw", ai, wre)
              + torch.einsum("bnchw,nco->bnohw", ar, wim)
              + bi[None, :, :, None, None])
        return re, im

    o1r, o1i = cmm(keep(spec.real), keep(spec.imag),
                   p["w1_re"], p["w1_im"], p["b1_re"], p["b1_im"])
    o2r, o2i = cmm(F.relu(o1r), F.relu(o1i), p["w2_re"], p["w2_im"], p["b2_re"], p["b2_im"])

    def scatter(lo: Tensor) -> Tensor:
        lo = F.softshrink(lo, sparsity).reshape(b, d, kh, kw)
        z = lo.new_zeros(b, d, h, wb)
        z[..., :top, :kw] = lo[..., :top, :]
        if bot:
            z[..., h - bot:, :kw] = lo[..., top:, :]
        return z

    full = torch.complex(scatter(o2r), scatter(o2i))
    out = irfft2(full, s=(h, w), config=config)
    return torch.movedim(out, 1, -1)


def afno_block(p: Params, x: Tensor, n_blocks: int, *, sparsity: float = 0.01,
               hard_fraction: float = 1.0,
               config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    h = layer_norm(x, p["ln1_s"], p["ln1_b"])
    x = x + afno_filter(p, h, n_blocks, sparsity=sparsity, hard_fraction=hard_fraction,
                        config=config)
    h = layer_norm(x, p["ln2_s"], p["ln2_b"])
    h = gelu(h @ p["mlp_w1"] + p["mlp_b1"])
    return x + (h @ p["mlp_w2"] + p["mlp_b2"])


def apply(params: Dict[str, object], x, *, patch: int = 4, n_blocks: int = 4,
          sparsity: float = 0.01, hard_fraction: float = 1.0,
          config: SpectralConfig = DEFAULT_CONFIG) -> Tensor:
    """(batch, H, W, in_channels) -> (batch, H, W, out_channels); ``patch``
    must divide H and W (pass the value used at init)."""
    x = as_input(x)
    p = int(patch)
    b, H, W, cin = x.shape
    if H % p or W % p:
        raise ValueError(f"patch={p} must divide H={H} and W={W}")
    hp, wp = H // p, W // p
    # patchify: (b, hp, wp, p*p*cin)
    t = x.reshape(b, hp, p, wp, p, cin).permute(0, 1, 3, 2, 4, 5)
    t = t.reshape(b, hp, wp, p * p * cin)
    t = t @ params["embed"]["w"] + params["embed"]["b"]
    for blk in params["blocks"]:
        t = afno_block(blk, t, n_blocks, sparsity=sparsity, hard_fraction=hard_fraction,
                       config=config)
    t = t @ params["head"]["w"] + params["head"]["b"]
    cout = t.shape[-1] // (p * p)
    t = t.reshape(b, hp, wp, p, p, cout).permute(0, 1, 3, 2, 4, 5)
    return t.reshape(b, H, W, cout)


def loss_fn(params, x, target, **kw) -> Tensor:
    y = apply(params, x, **kw)
    return torch.mean((y - as_input(target, y.device)) ** 2)


def train_step(params, x, target, lr: float = 1e-3, **kw):
    """One SGD step: (new parameter tree, loss)."""
    return sgd_step(loss_fn, params, x, target, lr=lr, **kw)


class AFNO(TreeModule):
    """:func:`init_afno` and :func:`apply` as a module, on ``device``
    (default: the card)."""

    def __init__(self, in_channels: int, dim: int, out_channels: int, *, patch: int = 4,
                 n_layers: int = 2, n_blocks: int = 4, mlp_ratio: float = 4.0,
                 sparsity: float = 0.01, hard_fraction: float = 1.0, generator=None,
                 device=None, config: SpectralConfig = DEFAULT_CONFIG):
        super().__init__(init_afno(in_channels, dim, out_channels, patch=patch,
                                   n_layers=n_layers, n_blocks=n_blocks,
                                   mlp_ratio=mlp_ratio, generator=generator, device=device))
        self.options = dict(patch=patch, n_blocks=n_blocks, sparsity=sparsity,
                            hard_fraction=hard_fraction, config=config)

    def forward(self, x: Tensor) -> Tensor:
        return apply(self.param_tree(), x, **self.options)
