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
"""

from __future__ import annotations

import functools
from typing import Callable, Sequence, Union

import numpy as np
import torch

from .numerics import constant, content_key, fp32_matmul

Tensor = torch.Tensor


def _block_len(p: int) -> int:
    """Steps per block: the block operator is (L·p) × (L·p), about 128 wide."""
    return max(2, 128 // p)


@functools.lru_cache(maxsize=256)
def _host_operators(key: tuple, L: int):
    """(T, P, A^L) for the host matrix A that ``key`` (``content_key``)
    holds: T the (L·p, L·p) block operator with block (i, j) = A^(i−j) for
    j <= i; P the powers A^(i+1), (L, p, p).  Built once per (A, L): a
    filter applied to many signals reuses them."""
    p = key[2][0]
    A = np.frombuffer(key[3], np.float64).reshape(p, p)
    pw = [np.eye(p)]
    for _ in range(L):
        pw.append(A @ pw[-1])
    pw = np.stack(pw)                                        # (L + 1, p, p)
    lag = np.arange(L)[:, None] - np.arange(L)[None, :]
    T = pw[np.maximum(lag, 0)] * (lag >= 0)[:, :, None, None]  # (L, L, p, p)
    return T.transpose(0, 2, 1, 3).reshape(L * p, L * p), pw[1:], pw[L]


def _scan_host(A: np.ndarray, c: Tensor, s0: Tensor) -> Tensor:
    """c (n, R, p), s0 (R, p); A a float64 (p, p) array."""
    n, R, p = c.shape
    L = min(_block_len(p), n)
    nb = -(-n // L)
    key = content_key("linear_recurrence", A)
    T, P, AL = _host_operators(key, L)
    Td = constant(T, c, c.dtype, key=key + (L, "T"))
    Pd = constant(P, c, c.dtype, key=key + (L, "P"))
    if nb * L > n:
        c = torch.cat([c, c.new_zeros(nb * L - n, R, p)])
    blocks = c.reshape(nb, L, R, p).permute(1, 3, 0, 2).reshape(L * p, nb * R)
    with fp32_matmul():
        inner = (Td @ blocks).reshape(L, p, nb, R).permute(2, 0, 3, 1)  # (nb, L, R, p)
        if nb == 1:
            start = s0[None]
        else:
            ends = _scan_host(AL, inner[:, -1], s0)                       # (nb, R, p)
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
    with fp32_matmul():
        inner = torch.einsum("gij,njrg->nirg", T, blocks)                 # (nb, L, R, G)
    if nb == 1:
        start = s0[None]
    else:
        ends = _scan_device(pw[:, L], inner[:, -1], s0)                   # (nb, R, G)
        start = torch.cat([s0[None], ends[:-1]])
    carried = pw[:, 1:].T[None, :, None, :] * start[:, None]
    return (inner + carried).reshape(nb * L, R, G)[:n]


def linear_recurrence(A: Union[np.ndarray, float, Tensor], c: Tensor, s0: Tensor) -> Tensor:
    """All states of s[n] = A·s[n−1] + c[n], s[−1] = ``s0``.

    ``c``: (n, …, p) drive terms on the device; ``s0``: (…, p), broadcast
    against c's middle axes.  ``A`` is a (p, p) host matrix (numpy, float64
    as designed; a scalar when p = 1), or, for p = 1, a tensor of
    per-channel coefficients broadcast against c's middle axes, which may
    need a gradient.  Returns the (n, …, p) states after each step, as the
    JAX package's ``iir._recurrence_scan`` does.  Products are fp32 with
    TF32 off, whatever the caller's setting."""
    n, mid, p = c.shape[0], tuple(c.shape[1:-1]), c.shape[-1]
    s0 = s0.to(c.dtype).expand(*mid, p)
    if not isinstance(A, Tensor):
        A = np.asarray(A, np.float64).reshape(p, p)
        if n == 0:
            return c
        R = int(np.prod(mid, dtype=np.int64))
        return _scan_host(A, c.reshape(n, R, p), s0.reshape(R, p)).reshape(c.shape)
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
    R = int(np.prod([mid[d] for d in rest], dtype=np.int64))
    G = int(np.prod([mid[d] for d in varying], dtype=np.int64))
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
