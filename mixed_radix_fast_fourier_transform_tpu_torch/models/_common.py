"""What the model families share: random draws for ``init_*``, the
activation and normalisation the JAX package uses, the conversion of its
parameter trees, and a parameter tree as an ``nn.Module``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.config import DTYPE
from ..utils.numerics import as_tensor, resolve_device
from ..utils.tree import tree_from_numpy, tree_leaves, tree_map, tree_map_with_path

Tensor = torch.Tensor


def params_from_jax(params, device=None, dtype=DTYPE):
    """A parameter tree of the JAX package (dicts and lists with numpy
    leaves) as ``dtype`` tensors (fp32, or float64 for parameters made under
    x64) on ``device`` (default: the card), structure unchanged, so that
    both packages compute the same function."""
    return tree_from_numpy(params, device, dtype)


def param_dtype(params) -> torch.dtype:
    """The working dtype of a parameter tree: its first leaf's (fp32 for a
    tree without leaves)."""
    leaves = tree_leaves(params)
    return leaves[0].dtype if leaves else DTYPE


def as_input(x, device=None, dtype=DTYPE) -> Tensor:
    """A model's real input or target as a ``dtype`` tensor (the
    parameters' dtype, fp32 by default): a tensor stays on its own device,
    anything else goes to ``device`` (default: the card, see
    utils.numerics.as_tensor)."""
    return as_tensor(x, device).to(dtype)


def gelu(x: Tensor) -> Tensor:
    """GELU in its tanh approximation, the JAX package's default."""
    return F.gelu(x, approximate="tanh")


def layer_norm(x: Tensor, scale: Tensor, bias: Tensor, eps: float = 1e-6) -> Tensor:
    """Normalisation over the last axis with the biased variance and
    eps = 1e-6, as the JAX models write it out."""
    return F.layer_norm(x, x.shape[-1:], scale, bias, eps)


class Draws:
    """Random draws of ``dtype`` (fp32 by default) from ``generator`` on its
    own device (the CPU when None), placed on ``device`` (default: the
    card)."""

    def __init__(self, generator: Optional[torch.Generator], device, dtype=DTYPE):
        self.generator = generator
        self.source = generator.device if generator is not None else torch.device("cpu")
        self.device = resolve_device(device)
        self.dtype = dtype

    def __call__(self, *shape: int) -> Tensor:
        """N(0, 1)."""
        return torch.randn(*shape, generator=self.generator, dtype=self.dtype,
                           device=self.source).to(self.device)

    def uniform(self, low: float, high: float, *shape: int) -> Tensor:
        u = torch.rand(*shape, generator=self.generator, dtype=self.dtype, device=self.source)
        return (low + (high - low) * u).to(self.device)

    def zeros(self, *shape: int) -> Tensor:
        return torch.zeros(*shape, dtype=self.dtype, device=self.device)

    def ones(self, *shape: int) -> Tensor:
        return torch.ones(*shape, dtype=self.dtype, device=self.device)


class TreeModule(nn.Module):
    """A parameter tree as a module.  Every leaf is an ``nn.Parameter``
    registered under its '/'-joined path (``layers/0/w1``), which is also its
    key in a checkpoint; :meth:`param_tree` gives the functional API's tree
    back.  Subclasses define ``forward``."""

    def __init__(self, params):
        super().__init__()

        def register(path: str, leaf: Tensor) -> str:
            self.register_parameter(path, nn.Parameter(leaf))
            return path

        self._paths = tree_map_with_path(register, params)

    def param_tree(self):
        """The module's parameters as the functional API's tree."""
        return tree_map(self.get_parameter, self._paths)

    def load_param_tree(self, params) -> None:
        """Copy a parameter tree of the same structure into the module."""
        with torch.no_grad():
            tree_map(lambda mine, theirs: mine.copy_(theirs), self.param_tree(), params)
