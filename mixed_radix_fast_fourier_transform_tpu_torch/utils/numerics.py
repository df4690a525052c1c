"""Complex-as-planes helpers.

Counterpart of ``mixed_radix_fast_fourier_transform_tpu/utils/numerics.py``:
the plane helpers (the engine works on separate contiguous fp32 (re, im)
planes) and the error-free transforms that the NUFFT's phase reduction and
the compensated SHT recurrence build on; with the port's own device-table
cache, the precision blocks that set torch's matmul flags, and the
operators that carry a product's or a convolution's precision into a
compiled graph.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, Hashable, Optional, Tuple

import numpy as np
import torch

from .config import DTYPE, PRECISIONS
from .metrics import incr, tracing

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


# Reads take no lock (dict.get is atomic in CPython, and torch.compile
# cannot trace a lock); a write is one setdefault, so two threads that
# upload the same table keep the first.
_TABLES: Dict[tuple, Tensor] = {}


def traced(t: Tensor) -> bool:
    """Is ``t`` made while a tracer runs (torch.compile, torch.export, an
    AOTAutograd trace)?  Such a tensor is the tracer's (a fake or
    functional tensor, or dynamo's view of one) and is never kept in a
    cache that outlives the trace: only plain tensors made outside any
    trace are."""
    return tracing() or type(t) is not torch.Tensor


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
    from a caller's array) it is uploaded on every call.  While a tracer
    runs (:func:`traced`) a missing table is made for the trace and not
    kept.  While dynamo traces, the key is looked up on the host, so a kept
    table is held by the graph as it is; a missing one is built in the
    trace, since a closure cannot go to the host: :func:`host_table` is the
    form whose build runs on the host too."""
    device = like.device
    if key is None:
        return _upload(values() if callable(values) else values, device, dtype)
    if torch.compiler.is_dynamo_compiling():
        t = _on_host(None, (), key, device, dtype)[0]
        if t is not None:
            return t
    return _kept(values, key, device, dtype)


def host_table(name: str, build: Callable, *args: Hashable, like,
               dtype=DTYPE) -> Tensor:
    """:func:`constant` of the host table ``build(*args)``, kept under the
    key ``(name, *args)`` on the device of ``like`` (a tensor, or a
    ``torch.device``): ``build`` is a module-level function and ``args``
    are hashable values (lengths, names, keys), so the table is named by
    them alone.  While dynamo traces, the lookup and the build on a miss
    both run on the host: the table is kept as an eager call keeps it, the
    graph holds the kept tensor, and no host work is traced into it, nor is
    the table copied or uploaded per call."""
    key = (name,) + args
    device = like if isinstance(like, torch.device) else like.device
    if torch.compiler.is_dynamo_compiling():
        return _on_host(build, args, key, device, dtype)[0]
    return _kept(lambda: build(*args), key, device, dtype)


@torch.compiler.assume_constant_result
def _on_host(build: Optional[Callable], args: tuple, key: Hashable, device: torch.device,
             dtype) -> Tuple[Optional[Tensor]]:
    # on the host while dynamo traces, as plan.get_plan's lookup is: the
    # graph holds the result.  ``build`` None looks the key up only (None on
    # a miss).  In a tuple, because dynamo names a bare tensor result by
    # this function's name alone, and two tables of one graph would then
    # share a source
    if build is None:
        return (_TABLES.get((key, device, dtype)),)
    return (_kept(lambda: build(*args), key, device, dtype, host=True),)


def _kept(values, key: Hashable, device: torch.device, dtype, host: bool = False) -> Tensor:
    """The kept table of ``key``, made from ``values`` on a miss and kept
    unless a tracer made it; ``host``: made on the host while dynamo traces
    (:func:`_on_host`), a plain tensor that is kept."""
    slot = (key, device, dtype)
    t = _TABLES.get(slot)
    if t is not None:
        incr("constant_hits")
        return t
    t = _upload(values() if callable(values) else values, device, dtype)
    incr("constant_uploads")
    if type(t) is not torch.Tensor if host else traced(t):
        return t
    return _TABLES.setdefault(slot, t)


def content_key(name: str, a) -> tuple:
    """Key of a small device table made from an array the caller owns (a
    window, filter taps, a scale ladder): its contents, so a changed array is
    a new table.  ``a`` is anything ``np.asarray`` takes, a CPU tensor too
    (dynamo hands a caller's array to a host function as one);
    :func:`key_array` gives the array back."""
    a = np.ascontiguousarray(a)
    return (name, a.dtype.str, a.shape, a.tobytes())


def key_array(key: tuple) -> np.ndarray:
    """The array that the :func:`content_key` ``key`` names (a copy)."""
    _, dtype, shape, data = key
    return np.frombuffer(data, dtype).reshape(shape).copy()


def on_host(fn: Callable, *args):
    """``fn(*args)`` on the host, also while dynamo traces: ``fn`` is a
    module-level function whose arguments are hashable values (numbers,
    strings, tuples, content keys) or a caller's host arrays (numpy arrays,
    lists), and whose result is made of such values, never of arrays.  It is
    the host prologue of a traced op: normalising, validating and keying the
    caller's coefficients, angles or taps.  While dynamo traces the call runs
    on the host (``assume_constant_result``; a ValueError it raises reaches
    the caller inside dynamo's own exception) and the graph holds its
    result.  A numpy argument is then guarded by identity, so a compiled
    call over another array traces anew, as ``jax.jit`` of another closure
    does; an array changed in place after a compile is not seen, as
    ``jax.jit`` bakes it too.  A tensor argument is refused there (a
    ValueError): no guard would tell its values apart."""
    if torch.compiler.is_dynamo_compiling():
        for a in args:
            if isinstance(a, np.ndarray):
                id(a)        # dynamo installs an identity guard on the array
            elif isinstance(a, torch.Tensor):
                _host_call(_refuse_tensor)
        return _host_call(fn, *args)
    return fn(*args)


def _refuse_tensor() -> None:
    raise ValueError(
        "a traced call designs its tables from host values (numpy arrays, lists, "
        "numbers); a tensor's values cannot be guarded: pass them as a numpy array")


@torch.compiler.assume_constant_result
def _host_call(fn: Callable, *args):
    return fn(*args)


def clear_constants() -> None:
    """Drop every kept device table."""
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


def real_dtype(dtype) -> torch.dtype:
    """The dtype of the parts of ``dtype`` (a real dtype is its own):
    ``torch.dtype.to_real`` in a form that dynamo traces."""
    return {torch.complex64: torch.float32, torch.complex128: torch.float64,
            torch.complex32: torch.float16}.get(dtype, dtype)


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


def matmul_precision(precision: str = "highest", dtype: Optional[torch.dtype] = None):
    """A block whose matrix products and convolutions run at ``precision``,
    as ``jax.lax.Precision`` defines it on a GPU, whatever the caller's
    flags: "highest" is IEEE fp32 (TF32 off), "high" and "default" let fp32
    products on a CUDA tensor run in TF32 (``torch.backends.cuda.matmul.
    allow_tf32`` and ``torch.backends.cudnn.allow_tf32`` on).  Products of
    2-byte operands accumulate in fp32 either way (cuBLAS's reduced-precision
    reductions off), as XLA's ``preferred_element_type`` asks; ``dtype`` is
    the operands' dtype where the caller knows it, and fp32 or float64
    operands leave those two flags as they are (None: unknown, all four are
    set eagerly, and a trace checks them only for a known 2-byte dtype).
    On the CPU every setting computes in fp32: torch's CPU products ignore
    the flags.  The flags are restored on leaving.

    The block writes only the flags that differ, and a block nested in one
    of the same precision on the same thread reads none, so a transform
    sets them once for all its stage products.  The flags are torch's and
    process-wide: while a "high" block runs, fp32 products that other
    threads launch may run in TF32 too.

    Under ``torch.compile`` or ``torch.export`` no flag is written (a traced
    region cannot change them, and the compiled graph runs at the flags of
    its caller): the block checks that the caller's flags already give
    ``precision`` (:func:`check_compilable`: "highest" only) and is
    otherwise empty.  A product that must compile at another precision or
    on 2-byte operands goes through :func:`product` or :func:`convolution`
    instead, which carry their precision into the graph (the stage
    products of the engine, the direct convolution and ``dwt``'s filter
    banks do)."""
    if precision not in PRECISIONS:
        raise ValueError(
            f"precision must be 'highest', 'high' or 'default', got {precision!r}"
        )
    if tracing():
        check_compilable(precision, dtype)
        return contextlib.nullcontext()
    return _Flags(precision, dtype)


@torch.compiler.assume_constant_result
def check_compilable(precision, dtype: Optional[torch.dtype] = None) -> bool:
    """Raise ValueError unless a traced call at ``precision`` (a config's
    setting: a name, "split6" or a per-stage tuple) on ``dtype`` operands
    computes as eager would at the caller's flags, which a compiled graph
    cannot change: "highest" with cuBLAS's TF32 off
    (``torch.backends.cuda.matmul.allow_tf32`` False and
    ``torch.get_float32_matmul_precision()`` "highest", torch's defaults)
    and, for ``dtype`` bf16 or fp16, its reduced-precision reductions off
    too (a site that may see 2-byte operands passes their dtype; None is
    taken as fp32, the port's working dtype).

    It holds every :func:`matmul_precision` block that a trace enters, and
    the fp32 and float64 "highest" products of :func:`product`.  What
    compiles at every precision and 2-byte dtype, at any caller flags, is
    what carries its precision as an operator node: the engine's stage
    products (``exec_complex``, ``exec_mixed_radix``, Bluestein and Rader,
    so ``fft``/``ifft``/``rfft``/``irfft``, ``fft_convolve`` and the
    spectral filter over them) through :func:`product`, and the direct
    convolution and ``dwt`` through :func:`convolution`.  The other sites
    refuse any precision but "highest" (ROADMAP lists them).  Runs on the
    host while dynamo traces (``assume_constant_result``), never in the
    graph; under torch.compile torch reports the ValueError in its own
    ``InternalTorchDynamoError``, whose message begins "ValueError:"."""
    if precision != "highest":
        raise ValueError(
            f"SpectralConfig.precision={precision!r} cannot be compiled at this "
            f"site yet: a compiled graph runs at the caller's matmul flags, so only "
            f"'highest' (TF32 off) is supported here under torch.compile and "
            f"torch.export (the stage pipeline and the convolutions carry every "
            f"precision)")
    mm = torch.backends.cuda.matmul
    if mm.allow_tf32 or torch.get_float32_matmul_precision() != "highest":
        raise ValueError(
            "SpectralConfig.precision='highest' needs IEEE fp32 products, but the "
            "process's flags let fp32 matmuls run in TF32 "
            "(torch.backends.cuda.matmul.allow_tf32 or "
            "torch.set_float32_matmul_precision); a compiled graph cannot change "
            "them: turn TF32 off before compiling")
    if dtype in TWO_BYTE and (
            mm.allow_bf16_reduced_precision_reduction
            or mm.allow_fp16_reduced_precision_reduction):
        raise ValueError(
            f"SpectralConfig.dtype={dtype} accumulates its products in fp32, but "
            f"the process's flags allow cuBLAS's reduced-precision reductions "
            f"(torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction "
            f"/ allow_fp16_reduced_precision_reduction); a compiled graph cannot "
            f"change them: turn them off before compiling")
    return True


TWO_BYTE = (torch.bfloat16, torch.float16)


def product(a: Tensor, b: Tensor, precision: str = "highest", *,
            carried: bool = False) -> Tensor:
    """``torch.matmul(a, b)`` at ``precision`` (see :func:`matmul_precision`).

    Eagerly the product runs inside a :func:`matmul_precision` block for
    ``a``'s dtype (nested in a transform's own block, it writes no flag).
    Under ``torch.compile`` or ``torch.export`` it is the operator node
    ``mixed_radix_precision::matmul``, which sets torch's flags around its
    product when the graph runs, as ``jax.lax.Precision`` rides a jitted
    JAX product: for every precision but "highest", for 2-byte operands at
    any precision, and for any product with ``carried`` (split6's chunk
    product, IEEE fp32 whatever the caller's flags).  An fp32 or float64
    "highest" product stays a plain ``torch.matmul`` in the graph, held by
    :func:`check_compilable`.  Its gradient is plain products at the
    caller's flags, as eager's backward runs."""
    if tracing() and (carried or precision != "highest" or a.dtype in TWO_BYTE):
        if a.ndim == 1:
            return torch.ops.mixed_radix_precision.matmul(a[None], b, precision)[0]
        return torch.ops.mixed_radix_precision.matmul(a, b, precision)
    with matmul_precision(precision, a.dtype):
        return torch.matmul(a, b)


def _convolve(x: Tensor, w: Tensor, stride, padding, dilation, groups: int) -> Tensor:
    """``F.conv1d``, ``conv2d`` or ``conv3d`` by ``w``'s rank, looked up at
    the call."""
    conv = getattr(torch.nn.functional, f"conv{w.ndim - 2}d")
    return conv(x, w, stride=stride, padding=padding, dilation=dilation, groups=groups)


def convolution(x: Tensor, w: Tensor, *, stride=1, padding=0, dilation=1, groups: int = 1,
                precision: str = "highest") -> Tensor:
    """``F.conv1d``/``conv2d``/``conv3d`` (by ``w``'s rank) of ``x`` with
    ``w`` at ``precision``: eagerly inside a :func:`matmul_precision` block;
    under ``torch.compile`` or ``torch.export`` always the operator node
    ``mixed_radix_precision::convolution``, which sets cuDNN's TF32 flag
    around the convolution when the graph runs (torch turns that flag on by
    default, so a plain convolution in a graph would run in TF32 on a
    card even at "highest").  ``stride``, ``padding`` and ``dilation`` are
    ints or one per spatial axis.  Its gradient is plain convolutions at
    the caller's flags."""
    nd = w.ndim - 2
    stride, padding, dilation = (
        [int(v)] * nd if isinstance(v, int) else [int(u) for u in v]
        for v in (stride, padding, dilation))
    if tracing():
        return torch.ops.mixed_radix_precision.convolution(
            x, w, stride, padding, dilation, groups, precision)
    with matmul_precision(precision, x.dtype):
        return _convolve(x, w, stride, padding, dilation, groups)


# The products that carry their precision are operators (``torch.library``,
# as the fused kernel's is): a graph that dynamo or ``torch.export``
# captures holds each as one opaque node, whose implementation runs the
# product inside the eager flag block when the graph runs, writing only the
# flags that differ and restoring them on leaving, also when it raises.
# One implementation serves the CPU and the card (torch's CPU products
# ignore the flags).
_LIB = torch.library.Library("mixed_radix_precision", "DEF")
_LIB.define("matmul(Tensor a, Tensor b, str precision) -> Tensor")
_LIB.define("convolution(Tensor x, Tensor w, int[] stride, int[] padding, int[] dilation, "
            "int groups, str precision) -> Tensor")


def _check_precision(precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(
            f"precision must be 'highest', 'high' or 'default', got {precision!r}")


def _matmul_at(a: Tensor, b: Tensor, precision: str) -> Tensor:
    _check_precision(precision)
    if a.ndim < 2 or b.ndim < 2:
        raise ValueError(f"the operator multiplies matrices (rank >= 2), got ranks "
                         f"{a.ndim} and {b.ndim}")
    with _Flags(precision, a.dtype):
        return torch.matmul(a, b)


def _convolution_at(x: Tensor, w: Tensor, stride, padding, dilation, groups: int,
                    precision: str) -> Tensor:
    _check_precision(precision)
    with _Flags(precision, x.dtype):
        return _convolve(x, w, stride, padding, dilation, groups)


def _matmul_fake(a: Tensor, b: Tensor, precision: str) -> Tensor:
    return torch.matmul(a, b)


def _convolution_fake(x: Tensor, w: Tensor, stride, padding, dilation, groups: int,
                      precision: str) -> Tensor:
    return _convolve(x, w, stride, padding, dilation, groups)


def _save_operands(ctx, inputs, output) -> None:
    ctx.save_for_backward(inputs[0], inputs[1])
    ctx.args = inputs[2:-1]


def _matmul_backward(ctx, g: Tensor):
    # conjugate transposes: torch.matmul's own rule, which complex operands need
    a, b = ctx.saved_tensors
    ga = torch.matmul(g, b.mH).sum_to_size(a.shape) if ctx.needs_input_grad[0] else None
    gb = torch.matmul(a.mH, g).sum_to_size(b.shape) if ctx.needs_input_grad[1] else None
    return ga, gb, None


def _convolution_backward(ctx, g: Tensor):
    x, w = ctx.saved_tensors
    stride, padding, dilation, groups = ctx.args
    need = ctx.needs_input_grad
    gx, gw, _ = torch.ops.aten.convolution_backward(
        g, x, w, None, stride, padding, dilation, False, [0] * (w.ndim - 2), groups,
        [need[0], need[1], False])
    return gx, gw, None, None, None, None, None


for _name, _impl, _fake, _backward in (
        ("matmul", _matmul_at, _matmul_fake, _matmul_backward),
        ("convolution", _convolution_at, _convolution_fake, _convolution_backward)):
    _LIB.impl(_name, _impl, "CPU")
    _LIB.impl(_name, _impl, "CUDA")
    torch.library.register_fake(f"mixed_radix_precision::{_name}", _fake, lib=_LIB)
    torch.library.register_autograd(f"mixed_radix_precision::{_name}", _backward,
                                    setup_context=_save_operands, lib=_LIB)


class _Flags:
    """The eager block of :func:`matmul_precision`."""

    __slots__ = ("precision", "reductions", "outer", "saved")

    def __init__(self, precision: str, dtype: Optional[torch.dtype]):
        self.precision = precision
        self.reductions = dtype not in (torch.float32, torch.float64)

    def _flags(self):
        mm, dnn = torch.backends.cuda.matmul, torch.backends.cudnn
        flags = (mm.allow_tf32, dnn.allow_tf32)
        if self.reductions:
            flags += (mm.allow_bf16_reduced_precision_reduction,
                      mm.allow_fp16_reduced_precision_reduction)
        return flags

    def _set(self, flags) -> None:
        mm, dnn = torch.backends.cuda.matmul, torch.backends.cudnn
        mm.allow_tf32, dnn.allow_tf32 = flags[:2]
        if self.reductions:
            (mm.allow_bf16_reduced_precision_reduction,
             mm.allow_fp16_reduced_precision_reduction) = flags[2:]

    def __enter__(self):
        self.outer = getattr(_PRECISION, "active", None)
        self.saved = None
        if self.outer == self.precision:
            return self
        saved = self._flags()
        tf32 = self.precision != "highest"
        want = (tf32, tf32, False, False)[:len(saved)]
        if saved != want:
            self.saved = saved
            self._set(want)
        _PRECISION.active = self.precision
        return self

    def __exit__(self, *exc) -> None:
        if self.outer == self.precision:
            return
        if self.saved is not None:
            self._set(self.saved)
        _PRECISION.active = self.outer


# The precision of the innermost matmul_precision block on each thread.
_PRECISION = threading.local()


# ---------------------------------------------------------------------------
# Error-free transforms (Knuth two-sum, Dekker/Veltkamp split product), the
# JAX package's set.  Each is a chain of separate eager torch ops: one op is
# one kernel, so no compiler can contract a product and a sum into a fused
# multiply-add or reassociate them, and the results are bit-equal to the JAX
# functions'.  Do not rewrite them with addcmul/addcdiv, ``alpha=`` or
# torch.compile: each is marked ``torch.compiler.disable``, so a compiled
# caller runs it eagerly (and ``fullgraph=True`` refuses it).
# Dtype-polymorphic; the splitter constants target fp32.
# ---------------------------------------------------------------------------

# 2^12 + 1: Dekker splitter for fp32 (balanced 12/12-bit halves, two_prod)
DW_SPLIT = 4097.0
# 2^16 + 1: Veltkamp splitter for fp32 8-bit-mantissa heads (products of head
# pieces stay exact after a further split: the NUFFT phase chain)
VELTKAMP_SPLIT = 65537.0


@torch.compiler.disable
def two_sum(a, b):
    """Error-free addition: (s, e) with s + e == a + b exactly (Knuth)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


@torch.compiler.disable
def fast_two_sum(a, b):
    """Error-free addition assuming |a| >= |b| (or a == 0): Dekker."""
    s = a + b
    return s, b - (s - a)


@torch.compiler.disable
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


@torch.compiler.disable
def veltkamp(v):
    """Exact fp32 split into an 8-bit-mantissa head and a tail."""
    c = VELTKAMP_SPLIT * v
    hi = c - (c - v)
    return hi, v - hi


@torch.compiler.disable
def dw_mul(ah, al, bh, bl):
    """Double-word × double-word product, renormalized (hi, lo)."""
    ph, pe = two_prod(ah, bh)
    return fast_two_sum(ph, pe + (ah * bl + al * bh))


@torch.compiler.disable
def dw_add(ah, al, bh, bl):
    """Double-word + double-word sum, renormalized (hi, lo)."""
    sh, se = two_sum(ah, bh)
    return fast_two_sum(sh, se + al + bl)
