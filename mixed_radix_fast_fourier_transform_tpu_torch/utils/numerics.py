"""Complex-as-planes helpers.

Counterpart of ``mixed_radix_fast_fourier_transform_tpu/utils/numerics.py``:
the plane helpers (the engine works on separate contiguous fp32 (re, im)
planes) and the error-free transforms that the NUFFT's phase reduction and
the compensated SHT recurrence build on.
"""

from __future__ import annotations

import threading
from typing import Dict, Hashable, Optional, Tuple

import numpy as np
import torch

from .config import DTYPE, PRECISIONS
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
    if torch.compiler.is_exporting():
        return t   # the tracer's tensor while torch.export traces: not kept
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


def to_host(x, dtype=None) -> np.ndarray:
    """``x`` as a numpy array on the host (``dtype`` if given): a tensor is
    detached and copied from its device; anything else goes through
    ``np.asarray``.  For the stages that the JAX package runs on the host
    in float64 by design (eigen and rooting work, sifting, peak picking)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().resolve_conj().cpu().numpy()
    return np.asarray(x, dtype)


def working(x, dtype=DTYPE) -> Tensor:
    """``x`` (through :func:`as_tensor`) in the working precision ``dtype``
    (fp32 by default, a config's ``dtype`` where the op reads one), or its
    complex counterpart for complex data; other dtypes and integers are
    cast, as the engine's own entry points cast them."""
    x = as_tensor(x)
    return x.to(complex_dtype(dtype) if x.is_complex() else dtype)


def complex_dtype(dtype) -> torch.dtype:
    """The complex dtype of results at working dtype ``dtype``: complex128
    for float64, complex64 otherwise (2-byte planes widen to it)."""
    return torch.complex128 if dtype == torch.float64 else torch.complex64


def as_tensors(*xs) -> Tuple[Tensor, ...]:
    """:func:`as_tensor` for the operands of one call: data that is no
    tensor yet joins the device of the first operand that is one."""
    device = next((x.device for x in xs if isinstance(x, torch.Tensor)), None)
    return tuple(as_tensor(x, device) for x in xs)


def to_planes(x, dtype=DTYPE) -> Tuple[Tensor, Tensor]:
    """Split a complex (or real) tensor into contiguous (re, im) planes of
    ``dtype`` (fp32 by default; complex128 gives float64 planes only when
    ``dtype`` is float64) on its own device (array-likes go through
    :func:`as_tensor`)."""
    x = as_tensor(x)
    if x.is_complex():
        return (
            x.real.to(dtype).contiguous(),
            x.imag.to(dtype).contiguous(),
        )
    x = x.to(dtype).contiguous()
    return x, torch.zeros_like(x)


def from_planes(re: Tensor, im: Tensor) -> Tensor:
    """Combine (re, im) planes into a complex tensor of their precision
    (complex64 for fp32 planes, complex128 for float64).  2-byte planes
    (bf16, fp16) widen to complex64 at this boundary, as the JAX package's
    do: the compute stayed at the working dtype."""
    if re.dtype in (torch.bfloat16, torch.float16):
        re, im = re.float(), im.float()
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
        if left <= n and right <= n:
            return torch.cat([x[..., n - left:], x, x[..., :right]], dim=-1)
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


class matmul_precision:
    """Matrix products and convolutions inside the block at ``precision``,
    as ``jax.lax.Precision`` defines it on a GPU, whatever the caller's
    flags: "highest" is IEEE fp32 (TF32 off), "high" and "default" let fp32
    products on a CUDA tensor run in TF32 (``torch.backends.cuda.matmul.
    allow_tf32`` and ``torch.backends.cudnn.allow_tf32`` on).  Products of
    2-byte operands accumulate in fp32 either way (cuBLAS's reduced-precision
    reductions off), as XLA's ``preferred_element_type`` asks.  On the CPU
    every setting computes in fp32: torch's CPU products ignore the flags.
    The flags are restored on leaving.

    The block writes only the flags that differ, and a block nested in one
    of the same precision on the same thread reads none, so a transform
    sets them once for all its stage products.  The flags are torch's and
    process-wide: while a "high" block runs, fp32 products that other
    threads launch may run in TF32 too."""

    __slots__ = ("precision", "outer", "saved")

    def __init__(self, precision: str = "highest"):
        if precision not in PRECISIONS:
            raise ValueError(
                f"precision must be 'highest', 'high' or 'default', got {precision!r}"
            )
        self.precision = precision

    def __enter__(self):
        self.outer = getattr(_PRECISION, "active", None)
        self.saved = None
        if self.outer == self.precision:
            return self
        mm, dnn = torch.backends.cuda.matmul, torch.backends.cudnn
        saved = (mm.allow_tf32, dnn.allow_tf32, mm.allow_bf16_reduced_precision_reduction,
                 mm.allow_fp16_reduced_precision_reduction)
        tf32 = self.precision != "highest"
        if saved != (tf32, tf32, False, False):
            self.saved = saved
            mm.allow_tf32 = dnn.allow_tf32 = tf32
            mm.allow_bf16_reduced_precision_reduction = False
            mm.allow_fp16_reduced_precision_reduction = False
        _PRECISION.active = self.precision
        return self

    def __exit__(self, *exc) -> None:
        if self.outer == self.precision:
            return
        if self.saved is not None:
            mm, dnn = torch.backends.cuda.matmul, torch.backends.cudnn
            (mm.allow_tf32, dnn.allow_tf32, mm.allow_bf16_reduced_precision_reduction,
             mm.allow_fp16_reduced_precision_reduction) = self.saved
        _PRECISION.active = self.outer


# The precision of the innermost matmul_precision block on each thread.
_PRECISION = threading.local()


# ---------------------------------------------------------------------------
# Error-free transforms (Knuth two-sum, Dekker/Veltkamp split product), the
# JAX package's set.  Each is a chain of separate eager torch ops: one op is
# one kernel, so no compiler can contract a product and a sum into a fused
# multiply-add or reassociate them, and the results are bit-equal to the JAX
# functions'.  Do not rewrite them with addcmul/addcdiv, ``alpha=`` or
# torch.compile.  Dtype-polymorphic; the splitter constants target fp32.
# ---------------------------------------------------------------------------

# 2^12 + 1: Dekker splitter for fp32 (balanced 12/12-bit halves, two_prod)
DW_SPLIT = 4097.0
# 2^16 + 1: Veltkamp splitter for fp32 8-bit-mantissa heads (products of head
# pieces stay exact after a further split: the NUFFT phase chain)
VELTKAMP_SPLIT = 65537.0


def two_sum(a, b):
    """Error-free addition: (s, e) with s + e == a + b exactly (Knuth)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def fast_two_sum(a, b):
    """Error-free addition assuming |a| >= |b| (or a == 0): Dekker."""
    s = a + b
    return s, b - (s - a)


def two_prod(a, b):
    """Error-free product: (p, e) with p + e == a·b exactly (Dekker split)."""
    p = a * b
    ca = DW_SPLIT * a
    ah = ca - (ca - a)
    al = a - ah
    cb = DW_SPLIT * b
    bh = cb - (cb - b)
    bl = b - bh
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def veltkamp(v):
    """Exact fp32 split into an 8-bit-mantissa head and a tail."""
    c = VELTKAMP_SPLIT * v
    hi = c - (c - v)
    return hi, v - hi


def dw_mul(ah, al, bh, bl):
    """Double-word × double-word product, renormalized (hi, lo)."""
    ph, pe = two_prod(ah, bh)
    return fast_two_sum(ph, pe + (ah * bl + al * bh))


def dw_add(ah, al, bh, bl):
    """Double-word + double-word sum, renormalized (hi, lo)."""
    sh, se = two_sum(ah, bh)
    return fast_two_sum(sh, se + al + bl)
