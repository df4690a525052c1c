"""Scans over a time axis in plain torch ops.

The JAX package runs its recurrences as ``lax.associative_scan`` (the IIR
filters, LTI simulation, the Kalman filter and smoother) or ``lax.scan``
(PCEN's smoother).  Torch has neither; this module holds the two forms the
port uses instead.

:func:`linear_recurrence` gives every state of s[n] = A·s[n−1] + c[n] as a
blocked scan.  Inside a block of L steps the states are one product with
the lower-triangular block-Toeplitz operator of the powers A⁰ … A^(L−1)
(an fp32 matmul with TF32 off); the states at the block ends are the same
recurrence with A^L over n/L steps, solved by the same function, and each
block then adds A^(i+1) times the state it starts from.  So a call costs
a few device kernels per level and log_L(n) levels, whatever n is, and the
backward pass runs through the same ops.  Two things the obvious
alternatives get wrong are avoided: the powers are never inverted (a
prefix sum of c·A⁻ᵏ overflows fp32 within a few thousand steps of a
stable pole), and a time-invariant A is never broadcast over time and
batch (the JAX module's (n, …, p, p) operand).

:func:`associative_scan` is ``lax.associative_scan``'s odd/even recursion
over a tuple of tensors, for combine functions that are not affine maps
(the Kalman filter's elements).

:func:`fori_loop` and :func:`scan` are ``lax.fori_loop`` and ``lax.scan``
for loops of a fixed trip count whose steps depend on each other (VMD's
ADMM sweeps, the beat tracker's dynamic programme and its backtrace).
Eagerly they run the body in a Python loop.  While ``torch.compile`` or
``torch.export`` traces, each is one ``torch._higher_order_ops.while_loop``
node whose body is traced once, so the graph and its compile time do not
grow with the trip count.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Callable, Sequence, Tuple, Union

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .metrics import tracing
from .numerics import host_table, key_array, matmul_precision

Tensor = torch.Tensor


def _block_len(p: int) -> int:
    """Steps per block: the block operator is (L·p) × (L·p), about 128 wide."""
    return max(2, 128 // p)


def _matrix_key(A, p: int) -> tuple:
    """The hashable name of the host (p, p) matrix ``A``: its float64
    entries, or ``A`` itself where it is a content key
    (``utils.numerics.content_key``) of the matrix.  A Python number (p = 1)
    and a content key are read without numpy, so a call that dynamo traces
    (PCEN's fixed smoother, an IIR filter's state matrix keyed on the host)
    names A and the host builds its tables."""
    if isinstance(A, tuple):
        return A
    if isinstance(A, (int, float)) and p == 1:
        return ("matrix", 1, (float(A),))
    return ("matrix", p, tuple(np.asarray(A, np.float64).reshape(p, p).ravel().tolist()))


@functools.lru_cache(maxsize=256)
def _host_matrix(key: tuple) -> np.ndarray:
    """The float64 matrix that ``key`` names: its entries, ("power", base,
    L), A^L of the matrix ``base`` names (the block-end recurrence's
    coefficient, the last power of ``base``'s table), or a content key's
    array."""
    if key[0] == "power":
        return _host_operators(key[1], key[2])[2]
    if key[0] == "matrix":
        return np.asarray(key[2], np.float64).reshape(key[1], key[1])
    return key_array(key).astype(np.float64)


@functools.lru_cache(maxsize=256)
def _host_operators(key: tuple, L: int):
    """(T, P, A^L) for the host matrix A that ``key`` names: T the
    (L·p, L·p) block operator with block (i, j) = A^(i−j) for j <= i; P the
    powers A^(i+1), (L, p, p).  Built once per (A, L): a filter applied to
    many signals reuses them."""
    A = _host_matrix(key)
    p = A.shape[0]
    pw = [np.eye(p)]
    for _ in range(L):
        pw.append(A @ pw[-1])
    pw = np.stack(pw)                                        # (L + 1, p, p)
    lag = np.arange(L)[:, None] - np.arange(L)[None, :]
    T = pw[np.maximum(lag, 0)] * (lag >= 0)[:, :, None, None]  # (L, L, p, p)
    return T.transpose(0, 2, 1, 3).reshape(L * p, L * p), pw[1:], pw[L]


def _operator(key: tuple, L: int, i: int) -> np.ndarray:
    return _host_operators(key, L)[i]


def _scan_host(key: tuple, c: Tensor, s0: Tensor) -> Tensor:
    """c (n, R, p), s0 (R, p); ``key`` names the float64 (p, p) matrix A
    (:func:`_host_matrix`).  The tables are built on the host by key, also
    while dynamo traces (``utils.numerics.host_table``)."""
    n, R, p = c.shape
    L = min(_block_len(p), n)
    nb = -(-n // L)
    Td = host_table("linear_recurrence", _operator, key, L, 0, like=c, dtype=c.dtype)   # T
    Pd = host_table("linear_recurrence", _operator, key, L, 1, like=c, dtype=c.dtype)   # P
    if nb * L > n:
        c = torch.cat([c, c.new_zeros(nb * L - n, R, p)])
    blocks = c.reshape(nb, L, R, p).permute(1, 3, 0, 2).reshape(L * p, nb * R)
    with matmul_precision():
        inner = (Td @ blocks).reshape(L, p, nb, R).permute(2, 0, 3, 1)  # (nb, L, R, p)
        if nb == 1:
            start = s0[None]
        else:
            ends = _scan_host(("power", key, L), inner[:, -1], s0)        # (nb, R, p)
            start = torch.cat([s0[None], ends[:-1]])
        carried = torch.einsum("ipq,nrq->nirp", Pd, start)
    return (inner + carried).reshape(nb * L, R, p)[:n]


def _powers(a: Tensor, L: int) -> Tensor:
    """a^0 … a^L, (G, L + 1), by doubling: products only, so the gradient
    is right at a = 0 (``pow`` gives 0·∞ there) and the backward never waits
    for the device (``cumprod``'s looks for zeros on the host, which a CUDA
    graph cannot capture)."""
    pw, step = torch.ones_like(a)[:, None], a[:, None]
    while pw.shape[1] < L + 1:
        pw = torch.cat([pw, pw * step], dim=1)
        step = step * step
    return pw[:, : L + 1]


def _scan_device(a: Tensor, c: Tensor, s0: Tensor) -> Tensor:
    """c (n, R, G), s0 (R, G); a (G,) device coefficients of a diagonal
    recurrence, which may need a gradient."""
    n, R, G = c.shape
    L = min(_block_len(1), n)
    nb = -(-n // L)
    pw = _powers(a, L)                                                    # (G, L + 1)
    # T[g, i, j] = a^(i−j) for j <= i, else 0: windows of [0 … 0, a^0 … a^(L−1)]
    padded = torch.cat([pw.new_zeros(G, L - 1), pw[:, :L]], dim=1)
    T = padded.unfold(1, L, 1).flip(-1)                                   # (G, L, L)
    if nb * L > n:
        c = torch.cat([c, c.new_zeros(nb * L - n, R, G)])
    blocks = c.reshape(nb, L, R, G)
    with matmul_precision():
        inner = torch.einsum("gij,njrg->nirg", T, blocks)                 # (nb, L, R, G)
    if nb == 1:
        start = s0[None]
    else:
        ends = _scan_device(pw[:, L], inner[:, -1], s0)                   # (nb, R, G)
        start = torch.cat([s0[None], ends[:-1]])
    carried = pw[:, 1:].T[None, :, None, :] * start[:, None]
    return (inner + carried).reshape(nb * L, R, G)[:n]


def linear_recurrence(A: Union[np.ndarray, float, tuple, Tensor], c: Tensor, s0: Tensor) -> Tensor:
    """All states of s[n] = A·s[n−1] + c[n], s[−1] = ``s0``.

    ``c``: (n, …, p) drive terms on the device; ``s0``: (…, p), broadcast
    against c's middle axes.  ``A`` is a (p, p) host matrix (numpy, float64
    as designed; a scalar when p = 1), or the ``utils.numerics.content_key``
    of one (the two forms that compile whole: their tables are built on the
    host), or, for p = 1, a tensor of per-channel coefficients broadcast
    against c's middle axes, which may need a gradient.  Returns the (n, …, p) states after each step, as the
    JAX package's ``iir._recurrence_scan`` does.  Products are fp32 with
    TF32 off, whatever the caller's setting."""
    n, mid, p = c.shape[0], tuple(c.shape[1:-1]), c.shape[-1]
    s0 = s0.to(c.dtype).expand(*mid, p)
    if not isinstance(A, Tensor):
        key = _matrix_key(A, p)
        if n == 0:
            return c
        R = math.prod(mid)
        return _scan_host(key, c.reshape(n, R, p), s0.reshape(R, p)).reshape(c.shape)
    if p != 1:
        raise ValueError(f"a tensor A is a diagonal (p = 1) coefficient; the state has p = {p}")
    a = A.to(c.dtype)
    if a.ndim > len(mid):
        raise ValueError(f"A of shape {tuple(a.shape)} does not broadcast against {mid}")
    a = a.reshape((1,) * (len(mid) - a.ndim) + tuple(a.shape))
    if n == 0:
        return c
    # the axes along which A varies go last and become the channel axis G
    varying = [d for d in range(len(mid)) if a.shape[d] > 1]
    a = a.expand(mid)
    rest = [d for d in range(len(mid)) if d not in varying]
    order = rest + varying
    R = math.prod([mid[d] for d in rest])
    G = math.prod([mid[d] for d in varying])
    cm = c[..., 0].permute(0, *(d + 1 for d in order)).reshape(n, R, G)
    s0m = s0[..., 0].permute(tuple(order)).reshape(R, G)
    am = a.permute(tuple(order)).reshape(R, G)[0]
    out = _scan_device(am, cm, s0m)
    shape = (n,) + tuple(mid[d] for d in order)
    inverse = [0] + [1 + order.index(d) for d in range(len(mid))]
    return out.reshape(shape).permute(*inverse)[..., None]


def _interleave(even: Tensor, odd: Tensor, dim: int) -> Tensor:
    """e0, o0, e1, o1, … along ``dim`` (``even`` as long as ``odd`` or one
    longer)."""
    n_odd = odd.shape[dim]
    pairs = torch.stack([even.narrow(dim, 0, n_odd), odd], dim=dim + 1)
    pairs = pairs.flatten(dim, dim + 1)
    if even.shape[dim] > n_odd:
        pairs = torch.cat([pairs, even.narrow(dim, n_odd, 1)], dim=dim)
    return pairs


def _slice(t: Tensor, dim: int, start: int, stop: int, step: int = 1) -> Tensor:
    index = [slice(None)] * t.ndim
    index[dim] = slice(start, stop, step)
    return t[tuple(index)]


def associative_scan(fn: Callable, elems: Union[Tensor, Sequence[Tensor]], dim: int = 0,
                     reverse: bool = False):
    """Inclusive scan of ``elems`` (a tensor or a tuple of tensors that share
    the length of ``dim``) under the associative ``fn(earlier, later)``,
    which maps two such tuples to one: ``lax.associative_scan``'s odd/even
    recursion, log2(n) levels of batched calls of ``fn``.  ``reverse=True``
    scans from the end, as ``lax.associative_scan`` does: the elements are
    reversed, scanned with the same ``fn``, and the result reversed."""
    single = isinstance(elems, Tensor)
    flat = [elems] if single else list(elems)
    n = flat[0].shape[dim]
    dim = dim % flat[0].ndim
    if any(e.shape[dim] != n for e in flat):
        raise ValueError(f"elements must share the scanned axis' length, got "
                         f"{[tuple(e.shape) for e in flat]}")
    if reverse:
        flat = [torch.flip(e, (dim,)) for e in flat]

    def combine(a, b):
        out = fn(a[0] if single else tuple(a), b[0] if single else tuple(b))
        return [out] if single else list(out)

    def scan(es):
        m = es[0].shape[dim]
        if m < 2:
            return es
        reduced = combine([_slice(e, dim, 0, m - 1, 2) for e in es],
                          [_slice(e, dim, 1, m, 2) for e in es])
        odd = scan(reduced)
        if m % 2 == 0:
            even = combine([_slice(e, dim, 0, odd[0].shape[dim] - 1) for e in odd],
                           [_slice(e, dim, 2, m, 2) for e in es])
        else:
            even = combine(odd, [_slice(e, dim, 2, m, 2) for e in es])
        even = [torch.cat([_slice(e, dim, 0, 1), r], dim=dim) for e, r in zip(es, even)]
        return [_interleave(e, o, dim) for e, o in zip(even, odd)]

    out = scan(flat)
    if reverse:
        out = [torch.flip(e, (dim,)) for e in out]
    return out[0] if single else tuple(out)


def _fresh(outs: list, ins: list) -> list:
    """``outs`` with every tensor that is one of ``ins`` cloned: a loop
    operator's body may not hand back its input as it is."""
    return [o.clone() if any(o is i for i in ins) else o for o in outs]


def fori_loop(lower: int, upper: int, body: Callable[[Any, Any], Any], init: Any) -> Any:
    """``lax.fori_loop``: ``carry = body(i, carry)`` for i in
    range(``lower``, ``upper``), from ``carry = init`` (a tensor or a
    pytree of tensors, whose shapes and dtypes the body keeps); returns the
    last carry.  Eagerly a Python loop, ``i`` an int.  Under a tracer one
    ``while_loop`` node on a 0-d int64 counter beside the carry (on the
    carry's device), ``i`` that counter: the body is traced once.  A
    complex tensor of the carry rides the loop as its (re, im) planes and
    is made whole again around each body call (Inductor cannot carry a
    complex buffer through a loop: torch 2.11 on CUDA), and every tensor
    rides it contiguous."""
    if not tracing():
        carry = init
        for i in range(lower, upper):
            carry = body(i, carry)
        return carry
    flat, spec = pytree.tree_flatten(init)
    cplx = [t.is_complex() for t in flat]

    def split(leaves):
        out = []
        for t, c in zip(leaves, cplx):
            # contiguous: the loop holds its state at one layout
            out += [t.real.contiguous(), t.imag.contiguous()] if c else [t.contiguous()]
        return out

    def join(planes):
        leaves, it = [], iter(planes)
        for c in cplx:
            leaves.append(torch.complex(next(it), next(it)) if c else next(it))
        return leaves

    def cond(i, *state):
        return i < upper

    def step(i, *state):
        out = pytree.tree_leaves(body(i, pytree.tree_unflatten(join(state), spec)))
        return (i + 1, *_fresh(split(out), list(state)))

    counter = torch.full((), lower, dtype=torch.int64, device=flat[0].device)
    # the loop's inputs may not share memory either (two views of one tensor)
    init_state = [t.clone() for t in split(flat)]
    _, *state = torch._higher_order_ops.while_loop(cond, step, (counter, *init_state))
    return pytree.tree_unflatten(join(state), spec)


def scan(step: Callable[[Any, Any], Tuple[Any, Any]], init: Any, xs: Any,
         reverse: bool = False) -> Tuple[Any, Any]:
    """``lax.scan``: ``carry, y = step(carry, x)`` over the slices ``x`` of
    ``xs`` (a tensor or a pytree of tensors) along their first axis, from
    ``carry = init``; returns (the last carry, the ``y`` stacked along a
    new first axis).  ``reverse=True`` runs from the last slice to the
    first, and ``ys[i]`` is still the output of ``xs[i]``'s step, as
    ``lax.scan``'s is.  Eagerly a Python loop.  Under a tracer a
    :func:`fori_loop` (one ``while_loop`` node) whose body reads slice t by
    ``index_select`` and writes ``y`` into preallocated outputs by
    ``index_copy``: torch 2.11's Inductor lowers a ``scan`` node on CUDA
    with a host C++ kernel, which a machine without a working host compiler
    cannot build."""
    leaves, spec = pytree.tree_flatten(xs)
    n = leaves[0].shape[0]
    if not tracing():
        order = range(n - 1, -1, -1) if reverse else range(n)
        carry, ys = init, [None] * n
        for t in order:
            carry, ys[t] = step(carry, pytree.tree_unflatten([x[t] for x in leaves], spec))
        columns = zip(*(pytree.tree_leaves(y) for y in ys))
        return carry, pytree.tree_unflatten([torch.stack(c) for c in columns],
                                            pytree.tree_structure(ys[0]))
    # the outputs' layout from one step (its ops are dead code in the graph:
    # only the shapes, dtypes and devices are read)
    _, y = step(init, pytree.tree_unflatten([x[0] for x in leaves], spec))
    y_leaves, y_spec = pytree.tree_flatten(y)
    outs = [torch.zeros((n,) + tuple(v.shape), dtype=v.dtype, device=v.device) for v in y_leaves]

    def body(i, state):
        carry, outs = state
        t = (n - 1 - i if reverse else i).reshape(1)
        carry, y = step(carry, pytree.tree_unflatten(
            [torch.index_select(x, 0, t)[0] for x in leaves], spec))
        return carry, [o.index_copy(0, t, v[None]) for o, v in zip(outs, pytree.tree_leaves(y))]

    carry, outs = fori_loop(0, n, body, (init, outs))
    return carry, pytree.tree_unflatten(outs, y_spec)
