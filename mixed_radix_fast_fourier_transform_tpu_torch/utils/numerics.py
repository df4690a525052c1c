"""Complex-as-planes helpers.

Counterpart of ``mixed_radix_fast_fourier_transform_tpu/utils/numerics.py``
(the plane helpers; the error-free transforms come with the ops that use
them).  The engine works on separate contiguous fp32 (re, im) planes.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Hashable, Optional, Tuple

import numpy as np
import torch

from .config import DTYPE
from .metrics import incr

Tensor = torch.Tensor


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; None means the card ("cuda").  There is
    no fallback to the CPU: without a card, using the result raises."""
    return torch.device("cuda" if device is None else device)


def as_tensor(x, device=None) -> Tensor:
    """The one place where the package turns a caller's data into a tensor.
    A ``torch.Tensor`` stays as it is, on its own device; a numpy array, a
    list or a scalar becomes a tensor on ``device`` (default: the card, see
    :func:`resolve_device`).  To compute on the CPU, pass a CPU tensor."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(x, device=resolve_device(device))


_TABLES: Dict[tuple, Tensor] = {}
_TABLES_LOCK = threading.Lock()


def _upload(values, device: torch.device, dtype) -> Tensor:
    # a kept table outlives the call that first needs it: made under
    # torch.inference_mode() it would be an inference tensor, which a later
    # call under autograd could not use
    with torch.inference_mode(False):
        return torch.from_numpy(np.ascontiguousarray(values)).to(device=device, dtype=dtype)


def constant(values, like: Tensor, dtype=DTYPE, *, key: Optional[Hashable] = None) -> Tensor:
    """A table computed on the host (a numpy array, float64 as a rule) as a
    ``dtype`` tensor on the device of ``like``.

    With ``key`` (a hashable that names the table and every argument it was
    built from: a window by name and length, DCT twiddles by ``(n, type)``)
    the tensor is uploaded once per (key, device, dtype) and kept until
    :func:`clear_constants` (which ``plan.clear_plan_cache`` calls); the
    counters ``constant_uploads`` / ``constant_hits`` of ``utils.metrics``
    say which happened.  ``values`` may then be a function of no arguments,
    called only when the table is missing.  Without a key (a table built
    from a caller's array) it is uploaded on every call."""
    device = like.device
    if key is None:
        return _upload(values() if callable(values) else values, device, dtype)
    slot = (key, device, dtype)
    with _TABLES_LOCK:
        t = _TABLES.get(slot)
    if t is not None:
        incr("constant_hits")
        return t
    t = _upload(values() if callable(values) else values, device, dtype)
    incr("constant_uploads")
    with _TABLES_LOCK:
        return _TABLES.setdefault(slot, t)


def content_key(name: str, a: np.ndarray) -> tuple:
    """Key of a small device table made from an array the caller owns (a
    window, filter taps, a scale ladder): its contents, so a changed array is
    a new table."""
    a = np.ascontiguousarray(a)
    return (name, a.dtype.str, a.shape, a.tobytes())


def clear_constants() -> None:
    """Drop every kept device table."""
    with _TABLES_LOCK:
        _TABLES.clear()


def working(x) -> Tensor:
    """``x`` (through :func:`as_tensor`) in the working precision: fp32, or
    complex64 for complex data; float64, complex128 and integers are cast,
    as the engine's own entry points cast them."""
    x = as_tensor(x)
    return x.to(torch.complex64 if x.is_complex() else DTYPE)


def as_tensors(*xs) -> Tuple[Tensor, ...]:
    """:func:`as_tensor` for the operands of one call: data that is no
    tensor yet joins the device of the first operand that is one."""
    device = next((x.device for x in xs if isinstance(x, torch.Tensor)), None)
    return tuple(as_tensor(x, device) for x in xs)


def to_planes(x) -> Tuple[Tensor, Tensor]:
    """Split a complex (or real) tensor into contiguous fp32 (re, im) planes
    on its own device (array-likes go through :func:`as_tensor`); float64
    and complex128 are cast down to the working precision here."""
    x = as_tensor(x)
    if x.is_complex():
        return (
            x.real.to(DTYPE).contiguous(),
            x.imag.to(DTYPE).contiguous(),
        )
    x = x.to(DTYPE).contiguous()
    return x, torch.zeros_like(x)


def from_planes(re: Tensor, im: Tensor) -> Tensor:
    """Combine fp32 (re, im) planes into a complex64 tensor."""
    return torch.complex(re, im)


def cmul(ar: Tensor, ai: Tensor, br: Tensor, bi: Tensor) -> Tuple[Tensor, Tensor]:
    """Elementwise complex multiply on planes."""
    return ar * br - ai * bi, ar * bi + ai * br


def conj_planes(re: Tensor, im: Tensor) -> Tuple[Tensor, Tensor]:
    return re, -im


def pad_last(x: Tensor, left: int, right: int, mode: str = "constant", cval=0.0) -> Tensor:
    """numpy.pad of the last axis, any rank, real or complex: "constant"
    (``cval``), "edge", "wrap", "reflect" (even reflection, the edge sample
    not repeated) or "odd" (odd reflection: 2·edge − reflected).  A
    reflection longer than the signal reflects again off the grown signal."""
    lead = x.shape[:-1]
    if mode == "constant":
        return torch.cat([x.new_full((*lead, left), cval), x,
                          x.new_full((*lead, right), cval)], dim=-1)
    if mode == "edge" or (mode in ("reflect", "odd") and x.shape[-1] == 1):
        return torch.cat([x[..., :1].expand(*lead, left), x,
                          x[..., -1:].expand(*lead, right)], dim=-1)
    if mode == "wrap":
        n = x.shape[-1]
        rl, rr = -(-left // n), -(-right // n)
        tiled = x.repeat(*([1] * len(lead)), rl + 1 + rr)
        start = rl * n - left
        return tiled[..., start: start + left + n + right]
    if mode not in ("reflect", "odd"):
        raise ValueError(f"unknown padding mode {mode!r}")
    while left > 0 or right > 0:
        n = x.shape[-1]
        lo, hi = min(left, n - 1), min(right, n - 1)
        lp = torch.flip(x[..., 1: lo + 1], (-1,))
        rp = torch.flip(x[..., n - 1 - hi: n - 1], (-1,))
        if mode == "odd":
            lp = 2 * x[..., :1] - lp
            rp = 2 * x[..., -1:] - rp
        x = torch.cat([lp, x, rp], dim=-1)
        left, right = left - lo, right - hi
    return x


def median(x: Tensor, dim: int = -1, keepdim: bool = False) -> Tensor:
    """numpy's median along ``dim``: the mean of the two middle values of an
    even count (``torch.median`` returns the lower one)."""
    s = torch.sort(x, dim=dim).values
    n = x.shape[dim]
    out = 0.5 * (s.narrow(dim, (n - 1) // 2, 1) + s.narrow(dim, n // 2, 1))
    return out if keepdim else out.squeeze(dim)


@contextlib.contextmanager
def fp32_matmul():
    """Matrix products in full fp32 inside the block, whatever the caller's
    ``torch.backends.cuda.matmul.allow_tf32``: TF32's ~3 decimal digits
    break the library's 1e-5 error budget."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
