"""Distributed transforms on ``torch.distributed``: the four-step
decomposition, pencils, and batch sharding.

Counterpart of ``mixed_radix_fast_fourier_transform_tpu/parallel/distributed.py``.
Two mechanisms, as there:

* **Batch sharding** (:func:`fft_batch_sharded` and the ``*_sharded`` ops):
  independent transforms spread over a mesh axis, no collectives.
* **Transform sharding** (:func:`fft_four_step`): one transform of length
  N = n1·n2 split by the Bailey four-step algorithm over the ``seq`` axis —

      A = x.reshape(n1, n2)                    (row-major)
      1. FFT_n1 along columns (axis -2)
      2. A *= W_N^(±k1·n2)                     (split twiddle)
      3. FFT_n2 along rows (axis -1)
      4. X[k2·n1 + k1] = A[k1, k2]             (global transpose)

  with each layout change one all-to-all: three for natural order.

**Sharded arrays.**  Every function takes either a plain tensor (numpy
input, or a tensor on another device type, goes to the mesh's device), read
as the global array and present on every rank, or a
``torch.distributed.tensor.DTensor``; it returns a DTensor
whose placements are the JAX function's ``out_specs``.  Inside, each rank
works on its local block as fp32 (re, im) planes.  No complex tensor goes
through a collective (gloo's complex support is not to be relied on):
exchanges move planes, reductions move the real view.  Every exchange is
:func:`_all_to_all`, the counterpart of ``jax.lax.all_to_all(...,
tiled=True)``; it is differentiable and its backward is the reverse
exchange.  The local transforms go through ``ops/stockham.py::exec_len``,
the port's one dispatch point, so the fused kernel carries every length it
takes.  Where the JAX package leaves an epilogue to the partitioner (the
real transforms' mirror, the crop of ``mode="same"``), the port gathers the
sequence axis first and returns that axis replicated.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from torch.nn.functional import pad as _pad
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..ops.stockham import exec_len
from ..plan import device_constants, get_plan
from ..utils.config import DEFAULT_CONFIG, DTYPE, SpectralConfig
from ..utils.factorize import is_smooth, next_splittable_len
from ..utils.numerics import content_key, host_table, key_array, on_host, to_host
from ..utils.sharding import (
    Sum as _Sum,
    dtensor as _dtensor,
    global_input as _input,
    local_placed as _local_placed,
    mean_squared_error as _mean_squared_error,
    redistribute as _redistribute,
    replicated as _replicated,
)
from .mesh import DATA_AXIS, SEQ_AXIS, batch_sharding

Tensor = torch.Tensor
# A JAX PartitionSpec: the mesh axis (or None) of every array dimension.
Spec = Tuple[Optional[str], ...]


# ---------------------------------------------------------------------------
# Sharded arrays: placements, local blocks, the global view.
# ---------------------------------------------------------------------------


def _mesh_dim(mesh: DeviceMesh, name: str) -> int:
    names = mesh.mesh_dim_names or ()
    if name not in names:
        raise ValueError(f"mesh has no axis {name!r} (axes {names})")
    return names.index(name)


def _axis_size(mesh: DeviceMesh, name: str) -> int:
    return mesh.shape[_mesh_dim(mesh, name)]


def _axis_index(mesh: DeviceMesh, name: str) -> int:
    return mesh.get_local_rank(_mesh_dim(mesh, name))


def _group(mesh: DeviceMesh, name: str):
    return mesh.get_group(_mesh_dim(mesh, name))


def _placements(mesh: DeviceMesh, spec: Spec):
    out = [Replicate()] * mesh.ndim
    for d, name in enumerate(spec):
        if name is not None:
            out[_mesh_dim(mesh, name)] = Shard(d)
    return out


def _wrap(local: Tensor, mesh: DeviceMesh, spec: Spec, shape) -> DTensor:
    """This rank's block under ``spec`` as the DTensor of the global ``shape``."""
    return _dtensor(local, mesh, _placements(mesh, spec), shape)


def _like(dt: DTensor, local: Tensor) -> DTensor:
    """``local`` as a DTensor laid out as ``dt`` (same mesh, placements, shape)."""
    return _dtensor(local, dt.device_mesh, dt.placements, dt.shape)


def _local(x, mesh: DeviceMesh, spec: Spec) -> Tensor:
    """This rank's block of ``x`` under the PartitionSpec ``spec``."""
    return _local_placed(x, mesh, _placements(mesh, spec))


def _full(x, mesh: DeviceMesh) -> Tensor:
    """The whole of ``x`` on this rank (a DTensor is gathered)."""
    return _local_placed(x, mesh, [Replicate()] * mesh.ndim)


def _planes(x: Tensor, dtype) -> Tuple[Tensor, Tensor]:
    """(re, im) planes of ``x`` in the working ``dtype``."""
    if x.is_complex():
        return x.real.to(dtype), x.imag.to(dtype)
    x = x.to(dtype)
    return x, torch.zeros_like(x)


# ---------------------------------------------------------------------------
# Collectives: the one exchange, and the sum over ranks.
# ---------------------------------------------------------------------------


def _all_to_all(x: Tensor, group, split_axis: int, concat_axis: int) -> Tensor:
    """``jax.lax.all_to_all(x, axis, split_axis, concat_axis, tiled=True)``
    over the ranks of ``group``: ``x`` is split into P blocks along
    ``split_axis``, block j goes to rank j, and the blocks received are
    joined along ``concat_axis`` in the order of the ranks that sent them.
    Only the block index moves to the front (each block stays whole), so on
    a world of one the exchange is the collective's copy alone.  One
    functional collective (``all_to_all_single_autograd``), eagerly and
    under a tracer alike: its backward is the reverse exchange."""
    p = dist.get_world_size(group)
    split_axis %= x.ndim
    concat_axis %= x.ndim
    if x.shape[split_axis] % p:
        raise ValueError(
            f"axis {split_axis} of shape {tuple(x.shape)} does not split over {p} ranks")
    blocks = x.unflatten(split_axis, (p, x.shape[split_axis] // p))
    blocks = blocks.movedim(split_axis, 0).contiguous()     # (P, ..., s/P, ...)
    out = funcol.wait_tensor(funcol.all_to_all_single_autograd(blocks, None, None, group))
    # out[i] is rank i's block: join them along concat_axis, rank i's first
    return out.movedim(0, concat_axis).flatten(concat_axis, concat_axis + 1)


def _psum(x: Tensor, mesh: DeviceMesh, *names: str) -> Tensor:
    return _Sum.apply(x, [_group(mesh, n) for n in names])


# ---------------------------------------------------------------------------
# The four-step transform.
# ---------------------------------------------------------------------------


def choose_split(
    n: int, parts: int, max_stage: int = DEFAULT_CONFIG.max_stage
) -> Tuple[int, int]:
    """Pick N = n1·n2 with P | n1, P | n2, both smooth, as square as possible.

    Both factors must divide by the mesh size so the all-to-alls tile evenly,
    and both must be smooth so each local FFT takes the mixed-radix path.
    """
    best = None
    for n1 in range(1, int(math.isqrt(n)) + 1):
        if n % n1:
            continue
        n2 = n // n1
        for a, b in ((n1, n2), (n2, n1)):
            if a % parts or b % parts:
                continue
            if not (is_smooth(a, max_stage) and is_smooth(b, max_stage)):
                continue
            key = abs(a - b)
            if best is None or key < best[0]:
                best = (key, a, b)
    if best is None:
        raise ValueError(
            f"cannot split N={n} as n1*n2 with both factors divisible by "
            f"{parts} and {max_stage}-smooth; pad the transform length"
        )
    return best[1], best[2]


@functools.lru_cache(maxsize=256)
def _split_twiddle_matrix(n1: int, n2: int, sign: int) -> Tuple[np.ndarray, np.ndarray]:
    """W[k1, n2] = e^(sign·2πi·k1·n2/N), fp64 with exact integer phase mod N."""
    n = n1 * n2
    k1 = np.arange(n1, dtype=np.int64)[:, None]
    j2 = np.arange(n2, dtype=np.int64)[None, :]
    phase = (k1 * j2) % n
    ang = (sign * 2.0 * np.pi / n) * phase.astype(np.float64)
    return np.cos(ang), np.sin(ang)


def _twiddle_part(n1: int, n2: int, sign: int, r: int, p: int, part: int) -> np.ndarray:
    """Rank ``r``'s column block (of ``p``) of the split twiddle's real
    (``part`` 0) or imaginary (1) part."""
    w = n2 // p
    return _split_twiddle_matrix(n1, n2, sign)[part][:, r * w:(r + 1) * w]


def _twiddle_block(n1: int, n2: int, sign: int, mesh: DeviceMesh, seq_axis: str,
                   like: Tensor) -> Tuple[Tensor, Tensor]:
    """This rank's column block of the split twiddle, kept on the device."""
    key = (n1, n2, sign, _axis_index(mesh, seq_axis), _axis_size(mesh, seq_axis))
    return tuple(host_table("four_step_twiddle", _twiddle_part, *key, i, like=like,
                            dtype=like.dtype) for i in (0, 1))


def _local_fft_last(config, n: int, sign: int, xr: Tensor, xi: Tensor):
    return exec_len(config, n, sign, xr.contiguous(), xi.contiguous())


def _local_fft_axis2(config, n: int, sign: int, xr: Tensor, xi: Tensor):
    # the fused kernel takes dense rows: the transposed planes are copied
    zr, zi = exec_len(config, n, sign, xr.transpose(-1, -2).contiguous(),
                      xi.transpose(-1, -2).contiguous())
    return zr.transpose(-1, -2), zi.transpose(-1, -2)


def _fft_axis(config, n: int, sign: int, xr: Tensor, xi: Tensor, axis: int):
    zr, zi = exec_len(config, n, sign, xr.movedim(axis, -1).contiguous(),
                      xi.movedim(axis, -1).contiguous())
    return zr.movedim(-1, axis), zi.movedim(-1, axis)


def _a2a(xr: Tensor, xi: Tensor, group, split_axis: int, concat_axis: int):
    return (_all_to_all(xr, group, split_axis, concat_axis),
            _all_to_all(xi, group, split_axis, concat_axis))


def _chunked(pipeline, chunks: int):
    """Wrap a per-rank (xr, xi) -> (yr, yi) pipeline with leading-batch-axis
    chunking: ``chunks`` independent sub-pipelines, run in turn.  Numerics
    are those of one chunk; collectives are blocking, so nothing overlaps
    (the JAX package leaves the overlap to XLA's scheduler)."""
    if chunks == 1:
        return pipeline

    def body(xr, xi):
        if xr.ndim < 3:
            raise ValueError(
                "overlap_chunks needs a leading batch axis to chunk; "
                "reshape the input to (batch, N) or pass overlap_chunks=1"
            )
        if xr.shape[0] % chunks:
            raise ValueError(
                f"local batch {xr.shape[0]} must divide by overlap_chunks={chunks}"
            )
        outs = [pipeline(cr, ci) for cr, ci in zip(xr.chunk(chunks), xi.chunk(chunks))]
        return (torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs]))

    return body


def _split(n: int, p: int, n1: Optional[int], config: SpectralConfig) -> Tuple[int, int]:
    if n1 is None:
        return choose_split(n, p, config.max_stage)
    n2 = n // n1
    if n1 * n2 != n or n1 % p or n2 % p:
        raise ValueError(f"invalid split {n1}x{n2} of N={n} over {p} devices")
    return n1, n2


def _batch_spec(nbatch: int, data_axis: Optional[str]) -> Spec:
    bspec = [None] * nbatch
    if data_axis is not None and nbatch:
        bspec[0] = data_axis
    return tuple(bspec)


def _flat_rows(xr: Tensor) -> Tensor:
    """(…, a, b) -> (…, a·b)."""
    return xr.reshape(xr.shape[:-2] + (xr.shape[-2] * xr.shape[-1],))


def fft_four_step(
    x,
    mesh: DeviceMesh,
    *,
    seq_axis: str = SEQ_AXIS,
    data_axis: Optional[str] = None,
    inverse: bool = False,
    norm: Optional[str] = "backward",
    n1: Optional[int] = None,
    overlap_chunks: int = 1,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> DTensor:
    """Distributed 1-D FFT along the last axis, natural order in and out.

    ``x``: (..., N) complex or real, N = n1·n2 with mesh[seq_axis] dividing
    both factors.  Input and output are sharded contiguously along the last
    axis over ``seq_axis``; the leading batch axis optionally over
    ``data_axis``.  Three all-to-alls.  For convolution-style pipelines that
    need no natural-order spectrum see :func:`fft_four_step_scrambled` /
    :func:`ifft_four_step_scrambled` (two each).

    ``overlap_chunks > 1`` runs the leading batch axis as that many chunk
    pipelines in turn (numerics identical); it needs a leading batch axis
    whose local size divides by the chunk count.
    """
    from ..ops.fft import _norm_scale

    x = _input(x, mesh)
    shape = tuple(x.shape)
    n = shape[-1]
    p = _axis_size(mesh, seq_axis)
    n1, n2 = _split(n, p, n1, config)
    sign = 1 if inverse else -1
    nbatch = len(shape) - 1
    if overlap_chunks < 1:
        raise ValueError(f"overlap_chunks must be >= 1, got {overlap_chunks}")
    if overlap_chunks > 1 and nbatch == 0:
        raise ValueError(
            "overlap_chunks needs a leading batch axis to chunk; "
            "reshape the input to (batch, N) or pass overlap_chunks=1"
        )
    spec_in = _batch_spec(nbatch, data_axis) + (seq_axis,)
    xr, xi = _planes(_local(x, mesh, spec_in), config.dtype)
    mat = xr.shape[:-1] + (n1 // p, n2)
    twr, twi = _twiddle_block(n1, n2, sign, mesh, seq_axis, xr)
    group = _group(mesh, seq_axis)

    def pipeline(xr, xi):
        # rows (n1/P, n2) -> columns (n1, n2/P); column FFTs; split twiddle
        xr, xi = _a2a(xr, xi, group, -1, -2)
        xr, xi = _local_fft_axis2(config, n1, sign, xr, xi)
        xr, xi = xr * twr - xi * twi, xr * twi + xi * twr
        # back to rows; row FFTs
        xr, xi = _a2a(xr, xi, group, -2, -1)
        xr, xi = _local_fft_last(config, n2, sign, xr, xi)
        # natural order: X[k2·n1 + k1] = A[k1, k2]
        xr, xi = _a2a(xr, xi, group, -1, -2)
        return _flat_rows(xr.transpose(-1, -2)), _flat_rows(xi.transpose(-1, -2))

    zr, zi = _chunked(pipeline, overlap_chunks)(xr.reshape(mat), xi.reshape(mat))
    scale = _norm_scale(n, sign, norm)
    if scale != 1.0:
        zr, zi = zr * scale, zi * scale
    return _wrap(torch.complex(zr, zi), mesh, spec_in, shape)


def ifft_four_step(x, mesh: DeviceMesh, **kw) -> DTensor:
    """Inverse of :func:`fft_four_step` (same sharding contract)."""
    return fft_four_step(x, mesh, inverse=True, **kw)


# ---------------------------------------------------------------------------
# Scrambled-order four-step and distributed convolution: the spectrum stays
# in the four-step's matrix layout Y[k1, k2] (k1 rows sharded), so each
# transform saves one all-to-all and a convolution costs 4 instead of 6.
# ---------------------------------------------------------------------------


def fft_four_step_scrambled(
    x,
    mesh: DeviceMesh,
    *,
    seq_axis: str = SEQ_AXIS,
    data_axis: Optional[str] = None,
    n1: Optional[int] = None,
    overlap_chunks: int = 1,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> DTensor:
    """Forward FFT, output left in four-step matrix order: returns (..., n1, n2)
    with Y[k1, k2] = X[k2·n1 + k1], rows (k1) sharded over ``seq_axis``.
    Two all-to-alls.  ``overlap_chunks``: see :func:`fft_four_step`."""
    x = _input(x, mesh)
    shape = tuple(x.shape)
    n = shape[-1]
    p = _axis_size(mesh, seq_axis)
    n1, n2 = _split(n, p, n1, config)
    bspec = _batch_spec(len(shape) - 1, data_axis)
    xr, xi = _planes(_local(x, mesh, bspec + (seq_axis,)), config.dtype)
    mat = xr.shape[:-1] + (n1 // p, n2)
    twr, twi = _twiddle_block(n1, n2, -1, mesh, seq_axis, xr)
    group = _group(mesh, seq_axis)

    def body(xr, xi):
        xr, xi = _a2a(xr, xi, group, -1, -2)
        xr, xi = _local_fft_axis2(config, n1, -1, xr, xi)
        xr, xi = xr * twr - xi * twi, xr * twi + xi * twr
        xr, xi = _a2a(xr, xi, group, -2, -1)
        return _local_fft_last(config, n2, -1, xr, xi)

    zr, zi = _chunked(body, overlap_chunks)(xr.reshape(mat), xi.reshape(mat))
    return _wrap(torch.complex(zr, zi), mesh, bspec + (seq_axis, None),
                 shape[:-1] + (n1, n2))


def ifft_four_step_scrambled(
    y,
    mesh: DeviceMesh,
    *,
    seq_axis: str = SEQ_AXIS,
    data_axis: Optional[str] = None,
    overlap_chunks: int = 1,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> DTensor:
    """Inverse of :func:`fft_four_step_scrambled`: input (..., n1, n2) in
    Y[k1, k2] layout (rows sharded), output (..., N) natural order with the
    1/N normalization.  Two all-to-alls.

    x[j1·n2 + j2] = 1/N Σ_{k1} W_{n1}^{+j1k1} W_N^{+j2k1} Σ_{k2} W_{n2}^{+j2k2}
    Y[k1, k2]: inverse row FFTs, transpose-reshard, twiddle, inverse column
    FFTs.
    """
    y = _input(y, mesh)
    shape = tuple(y.shape)
    n1, n2 = shape[-2], shape[-1]
    n = n1 * n2
    p = _axis_size(mesh, seq_axis)
    if n1 % p or n2 % p:
        raise ValueError(f"matrix {n1}x{n2} not divisible by mesh size {p}")
    bspec = _batch_spec(len(shape) - 2, data_axis)
    yr, yi = _planes(_local(y, mesh, bspec + (seq_axis, None)), config.dtype)
    twr, twi = _twiddle_block(n1, n2, 1, mesh, seq_axis, yr)
    group = _group(mesh, seq_axis)

    def body(yr, yi):
        # inverse row FFTs (length n2) on k1-sharded rows
        yr, yi = _local_fft_last(config, n2, 1, yr, yi)
        # each rank holds every k1 of its j2 block; twiddle W_N^{+j2·k1}
        yr, yi = _a2a(yr, yi, group, -1, -2)
        yr, yi = yr * twr - yi * twi, yr * twi + yi * twr
        # inverse column FFTs (length n1), back to rows: natural order
        yr, yi = _local_fft_axis2(config, n1, 1, yr, yi)
        yr, yi = _a2a(yr, yi, group, -2, -1)
        s = 1.0 / n
        return _flat_rows(yr * s), _flat_rows(yi * s)

    zr, zi = _chunked(body, overlap_chunks)(yr, yi)
    return _wrap(torch.complex(zr, zi), mesh, bspec + (seq_axis,), shape[:-2] + (n,))


def _taps_key(kernel, ndim: int) -> tuple:
    """Host prologue of the sharded convolutions: the content key of the
    filter taps, checked (made on the host also while dynamo traces,
    ``utils.numerics.on_host``)."""
    kernel = to_host(kernel)
    if kernel.ndim != ndim:
        raise ValueError("kernel must be 1-D filter taps" if ndim == 1 else "kernel must be 2-D")
    return content_key("sharded_conv_kernel", kernel)


def _conv_gain(kkey: tuple, m: int, n1: int, r: int, p: int, part: str) -> np.ndarray:
    """Rank ``r``'s row block of the taps' length-``m`` spectrum in the
    scrambled Y[k1, k2] layout (k = k2·n1 + k1), float64 on the host."""
    kernel = key_array(kkey)
    kpad = np.zeros(m, dtype=np.float64)
    kpad[: len(kernel)] = kernel
    kmat = np.fft.fft(kpad).reshape(m // n1, n1).T
    rows = n1 // p
    return getattr(kmat, part)[r * rows:(r + 1) * rows]


def _conv2_gain(kkey: tuple, hh: int, ww: int, r: int, p: int, part: str) -> np.ndarray:
    """Rank ``r``'s row block of the 2-D taps' (hh, ww) spectrum."""
    kernel = key_array(kkey)
    kh, kw = kernel.shape
    kpad = np.zeros((hh, ww), dtype=np.float64)
    kpad[:kh, :kw] = kernel
    rows = hh // p
    return getattr(np.fft.fft2(kpad), part)[r * rows:(r + 1) * rows]


def fft_convolve_sharded(
    x,
    kernel,
    mesh: DeviceMesh,
    *,
    seq_axis: str = SEQ_AXIS,
    data_axis: Optional[str] = None,
    mode: str = "circular",
    overlap_chunks: int = 1,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> DTensor:
    """Distributed FFT convolution of (..., N) signals with fixed filter
    taps (BASELINE config 5's shape: long transforms, large batch, sharded
    over the mesh).  ``overlap_chunks``: see :func:`fft_four_step`.

    ``mode='circular'``: circular convolution of length N (kernel zero-padded
    to N).  ``mode='same'``: linear convolution truncated to N, by
    zero-padding the signal axis to the next splittable length >= N +
    len(kernel) - 1; the output is then gathered over ``seq_axis`` (the
    centred window crosses shards) and returned replicated on it.

    The kernel's spectrum is computed on the host in float64, in the
    scrambled Y[k1, k2] layout, and kept on the device: 4 all-to-alls.
    """
    x = _input(x, mesh)
    kkey = on_host(_taps_key, kernel, 1)
    taps = kkey[2][0]
    n = x.shape[-1]
    p = _axis_size(mesh, seq_axis)
    if mode == "same":
        m = next_splittable_len(n + taps - 1, p, config.max_stage)
        x = _pad(_full(x, mesh), (0, m - n))
    elif mode != "circular":
        raise ValueError(f"mode must be 'circular' or 'same', got {mode!r}")
    m = x.shape[-1]
    n1, _ = choose_split(m, p, config.max_stage)
    if taps > m:
        raise ValueError("kernel longer than transform length")
    spec = fft_four_step_scrambled(
        x, mesh, seq_axis=seq_axis, data_axis=data_axis, n1=n1,
        overlap_chunks=overlap_chunks, config=config,
    )
    local = spec.to_local()
    key = (kkey, m, n1, _axis_index(mesh, seq_axis), p)
    gain = torch.complex(*(host_table("four_step_conv_gain", _conv_gain, *key, part,
                                      like=local.real, dtype=config.dtype)
                           for part in ("real", "imag")))
    out = ifft_four_step_scrambled(
        _like(spec, local * gain), mesh, seq_axis=seq_axis, data_axis=data_axis,
        overlap_chunks=overlap_chunks, config=config,
    )
    if mode == "same":
        start = (taps - 1) // 2
        bspec = _batch_spec(x.ndim - 1, data_axis)
        whole = _local(out, mesh, bspec + (None,))
        out = _wrap(whole[..., start: start + n], mesh, bspec + (None,), x.shape[:-1] + (n,))
    return out


# ---------------------------------------------------------------------------
# Distributed real transforms: the packed rfft/irfft over the four-step.
# ---------------------------------------------------------------------------


def _real_plan_pq(n: int, sign: int, config, device, stop: Optional[int] = None):
    rp = device_constants(get_plan(n, sign, "real", config), device)
    return (torch.complex(rp["p_re"][:stop], rp["p_im"][:stop]),
            torch.complex(rp["q_re"][:stop], rp["q_im"][:stop]))


def rfft_four_step(
    x,
    mesh: DeviceMesh,
    *,
    seq_axis: str = SEQ_AXIS,
    data_axis: Optional[str] = None,
    n1: Optional[int] = None,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> DTensor:
    """Distributed real-input FFT: (..., N) real, N even, -> (..., N/2+1)
    complex bins.

    The packed scheme of ops/rfft.py on the sharded complex four-step: the
    even/odd interleave is local to a rank (a contiguous shard of the signal
    is a contiguous range of the packed index), the half-length transform
    is the four-step, and the split X = P⊙Z + Q⊙conj(reflect(Z)) runs on
    the spectrum gathered over ``seq_axis``: the N/2+1 bins are returned
    replicated on it (sharded over ``data_axis`` where given).
    """
    x = _input(x, mesh)
    if x.is_complex():
        raise ValueError("rfft_four_step requires real input")
    shape = tuple(x.shape)
    n = shape[-1]
    if n % 2:
        raise ValueError(f"distributed rfft requires even length, got {n}")
    h = n // 2
    bspec = _batch_spec(len(shape) - 1, data_axis)
    xl = _local(x, mesh, bspec + (seq_axis,)).to(config.dtype)
    z = _wrap(torch.complex(xl[..., 0::2], xl[..., 1::2]), mesh, bspec + (seq_axis,),
              shape[:-1] + (h,))
    zc = fft_four_step(z, mesh, seq_axis=seq_axis, data_axis=data_axis, n1=n1,
                       config=config)
    zf = _local(zc, mesh, bspec + (None,))
    a = torch.cat([zf, zf[..., :1]], dim=-1)                                      # Z[k mod h]
    b = torch.conj(torch.cat([zf[..., :1], torch.flip(zf[..., 1:], (-1,)), zf[..., :1]], -1))
    p, q = _real_plan_pq(n, -1, config, zf.device)
    return _wrap(p * a + q * b, mesh, bspec + (None,), shape[:-1] + (h + 1,))


def irfft_four_step(
    spec,
    mesh: DeviceMesh,
    n: Optional[int] = None,
    *,
    seq_axis: str = SEQ_AXIS,
    data_axis: Optional[str] = None,
    n1: Optional[int] = None,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> DTensor:
    """Inverse of :func:`rfft_four_step`: (..., N/2+1) Hermitian bins ->
    (..., N) real, with the 1/N normalization, sharded contiguously over
    ``seq_axis``.  Each rank builds its own block of the packed spectrum
    from the bins (taken whole on every rank of the sequence axis)."""
    spec = _input(spec, mesh)
    shape = tuple(spec.shape)
    if n is None:
        n = 2 * (shape[-1] - 1)
    if n % 2 or shape[-1] != n // 2 + 1:
        raise ValueError(f"need n even and {n//2 + 1} bins, got {shape[-1]}")
    h = n // 2
    p = _axis_size(mesh, seq_axis)
    n1, _ = _split(h, p, n1, config)
    bspec = _batch_spec(len(shape) - 1, data_axis)
    whole = _local(spec, mesh, bspec + (None,))
    w = h // p
    k0 = _axis_index(mesh, seq_axis) * w
    a = whole[..., k0:k0 + w]
    b = torch.conj(torch.flip(whole[..., h - k0 - w + 1:h - k0 + 1], (-1,)))  # conj(X[h-k])
    pc, qc = _real_plan_pq(n, 1, config, whole.device, h)
    z = pc[k0:k0 + w] * a + qc[k0:k0 + w] * b
    g = ifft_four_step(_wrap(z, mesh, bspec + (seq_axis,), shape[:-1] + (h,)), mesh,
                       seq_axis=seq_axis, data_axis=data_axis, n1=n1, config=config)
    gl = g.to_local()
    out = torch.stack([gl.real, gl.imag], dim=-1).reshape(gl.shape[:-1] + (2 * w,))
    return _wrap(out, mesh, bspec + (seq_axis,), shape[:-1] + (n,))


# ---------------------------------------------------------------------------
# Pencil decompositions: distributed fft2 / fftn.
# ---------------------------------------------------------------------------


def fft2_pencil(
    x,
    mesh: DeviceMesh,
    *,
    seq_axis: str = SEQ_AXIS,
    data_axis: Optional[str] = None,
    inverse: bool = False,
    norm: Optional[str] = "backward",
    config: SpectralConfig = DEFAULT_CONFIG,
) -> DTensor:
    """Distributed 2-D FFT of (..., H, W) with rows (H) sharded over
    ``seq_axis``: local row FFTs (length W), one all-to-all transpose,
    local column FFTs (length H), transpose back.  Two all-to-alls; H and W
    must divide by the mesh size.
    """
    from ..ops.fft import _norm_scale

    x = _input(x, mesh)
    shape = tuple(x.shape)
    h, w = shape[-2], shape[-1]
    p = _axis_size(mesh, seq_axis)
    if h % p or w % p:
        raise ValueError(f"H={h} and W={w} must divide by mesh size {p}")
    sign = 1 if inverse else -1
    spec = _batch_spec(len(shape) - 2, data_axis) + (seq_axis, None)
    xr, xi = _planes(_local(x, mesh, spec), config.dtype)
    group = _group(mesh, seq_axis)
    xr, xi = _local_fft_last(config, w, sign, xr, xi)
    xr, xi = _a2a(xr, xi, group, -1, -2)          # (H/P, W) -> (H, W/P)
    xr, xi = _local_fft_axis2(config, h, sign, xr, xi)
    xr, xi = _a2a(xr, xi, group, -2, -1)          # back to row sharding
    scale = _norm_scale(h, sign, norm) * _norm_scale(w, sign, norm)
    if scale != 1.0:
        xr, xi = xr * scale, xi * scale
    return _wrap(torch.complex(xr, xi), mesh, spec, shape)


def ifft2_pencil(x, mesh: DeviceMesh, **kw) -> DTensor:
    """Inverse of :func:`fft2_pencil`."""
    return fft2_pencil(x, mesh, inverse=True, **kw)


def fft_convolve2_sharded(
    x,
    kernel,
    mesh: DeviceMesh,
    *,
    seq_axis: str = SEQ_AXIS,
    data_axis: Optional[str] = None,
    mode: str = "circular",
    config: SpectralConfig = DEFAULT_CONFIG,
) -> DTensor:
    """Distributed 2-D convolution of (..., H, W) images with a fixed host
    kernel, rows sharded over the mesh: fft2_pencil → pointwise gain →
    ifft2_pencil = 4 all-to-alls.

    ``mode='circular'`` wraps at (H, W); ``mode='same'`` zero-pads to the next
    mesh-divisible size >= (H+kh-1, W+kw-1) and crops the centred window,
    gathered over ``seq_axis`` and returned replicated on it.
    """
    x = _input(x, mesh)
    kkey = on_host(_taps_key, kernel, 2)
    h, w = x.shape[-2], x.shape[-1]
    p = _axis_size(mesh, seq_axis)
    kh, kw = kkey[2]
    if mode == "same":
        th = -(-(h + kh - 1) // p) * p
        tw = -(-(w + kw - 1) // p) * p
        x = _pad(_full(x, mesh), (0, tw - w, 0, th - h))
    elif mode != "circular":
        raise ValueError(f"mode must be 'circular' or 'same', got {mode!r}")
    hh, ww = x.shape[-2], x.shape[-1]
    if hh % p or ww % p:
        raise ValueError(f"image {hh}x{ww} must divide by mesh size {p}")
    if kh > hh or kw > ww:
        raise ValueError("kernel larger than (padded) image")
    spec = fft2_pencil(x, mesh, seq_axis=seq_axis, data_axis=data_axis, config=config)
    local = spec.to_local()
    key = (kkey, hh, ww, _axis_index(mesh, seq_axis), p)
    gain = torch.complex(*(host_table("pencil_conv_gain", _conv2_gain, *key, part,
                                      like=local.real, dtype=config.dtype)
                           for part in ("real", "imag")))
    out = ifft2_pencil(_like(spec, local * gain), mesh, seq_axis=seq_axis,
                       data_axis=data_axis, config=config)
    if mode == "same":
        si, sj = (kh - 1) // 2, (kw - 1) // 2
        spec_out = _batch_spec(x.ndim - 2, data_axis) + (None, None)
        whole = _local(out, mesh, spec_out)
        out = _wrap(whole[..., si: si + h, sj: sj + w], mesh, spec_out,
                    x.shape[:-2] + (h, w))
    return out


def fftn_pencil(
    x,
    mesh: DeviceMesh,
    axes: Optional[Tuple[int, ...]] = None,
    *,
    seq_axis: str = SEQ_AXIS,
    data_axis: Optional[str] = None,
    shard_dim: int = -2,
    inverse: bool = False,
    norm: Optional[str] = "backward",
    config: SpectralConfig = DEFAULT_CONFIG,
) -> DTensor:
    """Distributed N-D FFT over ``axes`` with one array dimension
    (``shard_dim``) sharded over ``seq_axis``: the generalized pencil.

    Transform axes other than ``shard_dim`` are local batched transforms;
    ``shard_dim`` (if it is a transform axis) takes one all-to-all
    transpose against the last axis, a local transform, and the transpose
    back: 2 collectives.
    """
    from ..ops.fft import _norm_scale

    x = _input(x, mesh)
    shape = tuple(x.shape)
    ndim = len(shape)
    if axes is None:
        axes = tuple(range(ndim))
    axes = tuple(a % ndim for a in axes)
    shard_dim = shard_dim % ndim
    if shard_dim == ndim - 1:
        raise ValueError("shard_dim must not be the last axis (the transpose partner)")
    p = _axis_size(mesh, seq_axis)
    if shape[shard_dim] % p or shape[-1] % p:
        raise ValueError(
            f"shape[{shard_dim}]={shape[shard_dim]} and last axis "
            f"{shape[-1]} must divide by mesh size {p}"
        )
    sign = 1 if inverse else -1
    bspec = [None] * ndim
    if data_axis is not None:
        if shard_dim == 0 or 0 in axes:
            raise ValueError(
                "data_axis shards array axis 0 as a batch axis, so axis 0 "
                "must be neither shard_dim nor a transform axis (pass axes "
                "that exclude 0, e.g. axes=(1, 2) for batched 2-D transforms)"
            )
        bspec[0] = data_axis
    bspec[shard_dim] = seq_axis
    spec = tuple(bspec)
    xr, xi = _planes(_local(x, mesh, spec), config.dtype)
    for a in axes:
        if a != shard_dim:
            xr, xi = _fft_axis(config, shape[a], sign, xr, xi, a)
    if shard_dim in axes:
        group = _group(mesh, seq_axis)
        xr, xi = _a2a(xr, xi, group, ndim - 1, shard_dim)
        xr, xi = _fft_axis(config, shape[shard_dim], sign, xr, xi, shard_dim)
        xr, xi = _a2a(xr, xi, group, shard_dim, ndim - 1)
    scale = 1.0
    for a in axes:
        scale *= _norm_scale(shape[a], sign, norm)
    if scale != 1.0:
        xr, xi = xr * scale, xi * scale
    return _wrap(torch.complex(xr, xi), mesh, spec, shape)


def ifftn_pencil(x, mesh: DeviceMesh, axes=None, **kw) -> DTensor:
    """Inverse of :func:`fftn_pencil`."""
    return fftn_pencil(x, mesh, axes, inverse=True, **kw)


def fftn_pencil2(
    x,
    mesh: DeviceMesh,
    *,
    data_axis: str = DATA_AXIS,
    seq_axis: str = SEQ_AXIS,
    inverse: bool = False,
    norm: Optional[str] = "backward",
    config: SpectralConfig = DEFAULT_CONFIG,
) -> DTensor:
    """3-D FFT on a 2-D pencil decomposition: both mesh axes shard the
    volume (axis 0 over ``data_axis``, axis 1 over ``seq_axis``; axis 2 is
    the local pencil), the P3DFFT layout.  Four all-to-alls: each axis FFT
    is local after a resharding transpose, and two more restore the input
    layout (natural order).

    Constraints: n0 % P0 == 0, n1 % P1 == 0, n2 % (P0·P1) == 0 with
    P0 = mesh[data_axis], P1 = mesh[seq_axis].
    """
    from ..ops.fft import _norm_scale

    x = _input(x, mesh)
    if x.ndim != 3:
        raise ValueError(f"fftn_pencil2 expects a 3-D volume, got ndim={x.ndim}")
    n0, n1, n2 = x.shape
    p0 = _axis_size(mesh, data_axis)
    p1 = _axis_size(mesh, seq_axis)
    if n0 % p0 or n1 % p1 or n2 % (p0 * p1):
        raise ValueError(
            f"shape {tuple(x.shape)} must satisfy n0 % {p0} == 0, n1 % {p1} == 0, "
            f"n2 % {p0 * p1} == 0 for the ({p0}, {p1}) pencil decomposition"
        )
    sign = 1 if inverse else -1
    spec = (data_axis, seq_axis, None)
    gs, gd = _group(mesh, seq_axis), _group(mesh, data_axis)
    xr, xi = _planes(_local(x, mesh, spec), config.dtype)
    xr, xi = _local_fft_last(config, n2, sign, xr, xi)
    xr, xi = _a2a(xr, xi, gs, 2, 1)               # gather axis 1, FFT it
    xr, xi = _local_fft_axis2(config, n1, sign, xr, xi)
    xr, xi = _a2a(xr, xi, gd, 2, 0)               # gather axis 0, FFT it
    xr, xi = _fft_axis(config, n0, sign, xr, xi, 0)
    xr, xi = _a2a(xr, xi, gd, 0, 2)               # restore the input layout
    xr, xi = _a2a(xr, xi, gs, 1, 2)
    scale = 1.0
    for n in (n0, n1, n2):
        scale *= _norm_scale(n, sign, norm)
    if scale != 1.0:
        xr, xi = xr * scale, xi * scale
    return _wrap(torch.complex(xr, xi), mesh, spec, x.shape)


def ifftn_pencil2(x, mesh: DeviceMesh, **kw) -> DTensor:
    """Inverse of :func:`fftn_pencil2`."""
    return fftn_pencil2(x, mesh, inverse=True, **kw)


def rfftn_pencil2(
    x,
    mesh: DeviceMesh,
    *,
    data_axis: str = DATA_AXIS,
    seq_axis: str = SEQ_AXIS,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> DTensor:
    """Real-input 3-D FFT on the 2-D pencil: (n0, n1, n2) real, axis 0
    sharded over ``data_axis``, axis 1 over ``seq_axis`` → (n0, n1,
    n2//2+1) complex, same sharding.  The rfft runs on the local pencil; the
    n2//2+1 bins are zero-padded to a multiple of P0·P1 for the transposes
    and cut back at the end.  Four all-to-alls."""
    from ..ops.rfft import rfft

    x = _input(x, mesh)
    if x.ndim != 3:
        raise ValueError(f"rfftn_pencil2 expects a 3-D volume, got ndim={x.ndim}")
    if x.is_complex():
        raise ValueError("rfftn_pencil2 requires real input")
    n0, n1, n2 = x.shape
    p0 = _axis_size(mesh, data_axis)
    p1 = _axis_size(mesh, seq_axis)
    if n0 % p0 or n1 % p1 or n2 % 2:
        raise ValueError(
            f"shape {tuple(x.shape)} needs n0 % {p0} == 0, n1 % {p1} == 0, even n2"
        )
    h = n2 // 2 + 1
    pp = p0 * p1
    hp = -(-h // pp) * pp
    spec = (data_axis, seq_axis, None)
    gs, gd = _group(mesh, seq_axis), _group(mesh, data_axis)
    z = rfft(_local(x, mesh, spec).to(config.dtype), config=config)   # local pencil, h bins
    xr, xi = _pad(z.real, (0, hp - h)), _pad(z.imag, (0, hp - h))
    xr, xi = _a2a(xr, xi, gs, 2, 1)               # scatter the bins over both axes
    xr, xi = _a2a(xr, xi, gd, 2, 0)
    xr, xi = _local_fft_axis2(config, n1, -1, xr, xi)
    xr, xi = _fft_axis(config, n0, -1, xr, xi, 0)
    xr, xi = _a2a(xr, xi, gd, 0, 2)               # restore the input layout
    xr, xi = _a2a(xr, xi, gs, 1, 2)
    return _wrap(torch.complex(xr[..., :h], xi[..., :h]), mesh, spec, (n0, n1, h))


def irfftn_pencil2(
    y,
    mesh: DeviceMesh,
    n2: Optional[int] = None,
    *,
    data_axis: str = DATA_AXIS,
    seq_axis: str = SEQ_AXIS,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> DTensor:
    """Inverse of :func:`rfftn_pencil2`: (n0, n1, n2//2+1) complex →
    (n0, n1, n2) real, same pencil sharding, 1/(n0·n1·n2) normalization."""
    from ..ops.rfft import irfft

    y = _input(y, mesh)
    if y.ndim != 3:
        raise ValueError(f"irfftn_pencil2 expects a 3-D spectrum, got ndim={y.ndim}")
    n0, n1, h = y.shape
    n2 = int(n2) if n2 is not None else 2 * (h - 1)
    if n2 // 2 + 1 != h:
        raise ValueError(f"n2={n2} inconsistent with {h} bins")
    p0 = _axis_size(mesh, data_axis)
    p1 = _axis_size(mesh, seq_axis)
    if n0 % p0 or n1 % p1:
        raise ValueError(f"shape {tuple(y.shape)} needs n0 % {p0} == 0, n1 % {p1} == 0")
    pp = p0 * p1
    hp = -(-h // pp) * pp
    spec = (data_axis, seq_axis, None)
    gs, gd = _group(mesh, seq_axis), _group(mesh, data_axis)
    yr, yi = _planes(_local(y, mesh, spec), config.dtype)
    yr, yi = _pad(yr, (0, hp - h)), _pad(yi, (0, hp - h))
    yr, yi = _a2a(yr, yi, gs, 2, 1)
    yr, yi = _a2a(yr, yi, gd, 2, 0)
    # unnormalized inverse transforms over the gathered leading axes
    yr, yi = _local_fft_axis2(config, n1, 1, yr, yi)
    yr, yi = _fft_axis(config, n0, 1, yr, yi, 0)
    yr, yi = _a2a(yr, yi, gd, 0, 2)
    yr, yi = _a2a(yr, yi, gs, 1, 2)
    s = 1.0 / (n0 * n1)
    out = irfft(torch.complex(yr[..., :h] * s, yi[..., :h] * s), n=n2, config=config)
    return _wrap(out, mesh, spec, (n0, n1, n2))


def _periods(period) -> Tuple[float, ...]:
    """Host prologue: the domain's period along each of the three axes."""
    return tuple(float(v) for v in np.broadcast_to(np.asarray(period, np.float64), (3,)))


def _poisson_multiplier(n0: int, n1: int, n2: int, periods, r0: int, b0: int, r1: int,
                        b1: int) -> np.ndarray:
    """−1/|k|² (0 at k = 0) on the rank's (b0, b1, n2//2+1) block of the
    rfftn bins, the block at (r0·b0, r1·b1)."""
    k0 = 2.0 * np.pi * np.fft.fftfreq(n0, 1.0 / n0) / periods[0]
    k1 = 2.0 * np.pi * np.fft.fftfreq(n1, 1.0 / n1) / periods[1]
    k2 = 2.0 * np.pi * np.arange(n2 // 2 + 1, dtype=np.float64) / periods[2]
    ksq = ((k0 ** 2)[r0 * b0:(r0 + 1) * b0, None, None]
           + (k1 ** 2)[None, r1 * b1:(r1 + 1) * b1, None]
           + (k2 ** 2)[None, None, :])
    return np.where(ksq > 0, -1.0 / np.where(ksq > 0, ksq, 1.0), 0.0)


def poisson_solve_pencil2(
    f,
    mesh: DeviceMesh,
    period=2.0 * np.pi,
    *,
    data_axis: str = DATA_AXIS,
    seq_axis: str = SEQ_AXIS,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> DTensor:
    """Distributed periodic Poisson solve ∇²u = f on the 2-D pencil: the
    multiplier −1/|k|² (kept on the device, this rank's block) applies to
    the sharded spectrum of :func:`rfftn_pencil2`, so the solve costs the 8
    all-to-alls of the two transforms.  Mirrors :func:`ops.signal.poisson_solve`
    (zero-mean solution)."""
    f = _input(f, mesh)
    if f.ndim != 3:
        raise ValueError(f"poisson_solve_pencil2 expects a 3-D field, got {f.ndim}-D")
    n0, n1, n2 = f.shape
    periods = on_host(_periods, period)
    spec = rfftn_pencil2(f, mesh, data_axis=data_axis, seq_axis=seq_axis, config=config)
    local = spec.to_local()
    b0, b1 = local.shape[0], local.shape[1]
    r0, r1 = _axis_index(mesh, data_axis), _axis_index(mesh, seq_axis)
    inv = host_table("poisson_pencil2", _poisson_multiplier, n0, n1, n2, periods, r0, b0,
                     r1, b1, like=local.real, dtype=local.real.dtype)
    return irfftn_pencil2(_like(spec, local * inv), mesh, n2=n2, data_axis=data_axis,
                          seq_axis=seq_axis, config=config)


# ---------------------------------------------------------------------------
# Batch sharding: many independent transforms over the mesh, no collectives.
# ---------------------------------------------------------------------------


def shard_batch(x, mesh: DeviceMesh, axis_name: str = DATA_AXIS) -> DTensor:
    """``x`` with its leading axis sharded over ``axis_name`` (replicated over
    the other mesh axes): each rank keeps its own block of the global tensor
    (no collective), or a DTensor is redistributed.  The leading axis must
    divide by the mesh axis, as ``jax.device_put`` requires."""
    x = _input(x, mesh)
    placements = batch_sharding(mesh, axis_name, x.ndim)
    if isinstance(x, DTensor):
        return _redistribute(x, placements)
    return _dtensor(_local_placed(x, mesh, placements), mesh, placements, x.shape)


def _batch_local(x, mesh: DeviceMesh, axis_name: str, ndim: int, what: str) -> Tensor:
    x = _input(x, mesh)
    if x.ndim != ndim:
        raise ValueError(what)
    parts = _axis_size(mesh, axis_name)
    if x.shape[0] % parts != 0:
        raise ValueError(
            f"batch {x.shape[0]} must divide over mesh axis {axis_name!r} ({parts})")
    return _local(x, mesh, (axis_name,) + (None,) * (ndim - 1))


def fft_batch_sharded(
    x,
    mesh: DeviceMesh,
    axis_name: str = DATA_AXIS,
    *,
    inverse: bool = False,
    norm: Optional[str] = "backward",
    config: SpectralConfig = DEFAULT_CONFIG,
) -> DTensor:
    """Batched FFT along the last axis with the batch sharded over the mesh:
    every rank transforms its block, no collectives, and the output keeps the
    batch sharding."""
    from ..ops.fft import fft, ifft

    xs = shard_batch(x, mesh, axis_name)
    fn = ifft if inverse else fft
    return _like(xs, fn(xs.to_local(), norm=norm, config=config))


def kalman_filter_sharded(
    F,
    Q,
    H,
    R,
    m0,
    P0,
    ys,
    mesh: DeviceMesh,
    axis_name: str = DATA_AXIS,
    *,
    smooth: bool = False,
    config: SpectralConfig = DEFAULT_CONFIG,
):
    """Multi-target tracking: the parallel-in-time Kalman filter (or RTS
    smoother with ``smooth=True``) over a batch of independent observation
    sequences ``ys`` (B, T, d_obs), the batch sharded over the mesh.  No
    collectives: each rank runs the log-depth associative scans on its
    tracks, batched (``ops.kalman._parallel_tracks``: one scan for every
    local track, bit-equal to one filter per track); the model (F, Q, H, R,
    m0, P0) is shared.  Returns (means (B, T, d), covs (B, T, d, d)) with
    the batch sharding kept."""
    from ..ops.kalman import _checked, _parallel_tracks

    local = _batch_local(ys, mesh, axis_name, 3, "ys must be (batch, T, d_obs)")
    ms, Ps = _parallel_tracks([_checked(F, Q, H, R, m0, P0, y) for y in local], smooth=smooth)
    batch = local.shape[0] * _axis_size(mesh, axis_name)
    return (_wrap(ms, mesh, (axis_name, None, None), (batch,) + ms.shape[1:]),
            _wrap(Ps, mesh, (axis_name, None, None, None), (batch,) + Ps.shape[1:]))


def pfb_analysis_sharded(
    x,
    n_channels: int,
    mesh: DeviceMesh,
    axis_name: str = DATA_AXIS,
    *,
    taps_per_branch: int = 8,
    window: str = "hamming",
    h: Optional[np.ndarray] = None,
    hop: Optional[int] = None,
    mode: str = "valid",
    config: SpectralConfig = DEFAULT_CONFIG,
) -> DTensor:
    """Batch-sharded K-channel PFB channelization: (batch, T) signals over
    the mesh, each rank channelizing its own block (no collectives: the
    polyphase weighting and the length-K FFT are per signal).  Returns
    (batch, frames, K) with the batch sharding kept."""
    from ..ops.pfb import pfb_analysis

    local = _batch_local(x, mesh, axis_name, 2,
                         "pfb_analysis_sharded expects (batch, T) signals")
    out = pfb_analysis(local, n_channels, taps_per_branch, window, h=h, hop=hop,
                       mode=mode, config=config)
    batch = local.shape[0] * _axis_size(mesh, axis_name)
    return _wrap(out, mesh, (axis_name, None, None), (batch,) + out.shape[1:])


def range_doppler_cfar_sharded(
    rx,
    tx,
    mesh: DeviceMesh,
    axis_name: str = DATA_AXIS,
    *,
    window: Optional[str] = None,
    doppler_window: Optional[str] = "hann",
    normalize: bool = True,
    num_train: int = 8,
    num_guard: int = 2,
    pfa: float = 1e-4,
    method: str = "ca",
    cfar_axes: Tuple[int, ...] = (-2, -1),
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tuple[DTensor, DTensor, DTensor]:
    """Batch-sharded radar CPI chain: (batch, n_pulses, N) coherent
    processing intervals over the mesh, each rank running pulse compression
    → Doppler FFT → CFAR on its own CPIs (no collectives; the transmit
    replica is shared).  Returns (rd_map, detections, threshold), each
    (batch, n_pulses, N−Nt+1) with the batch sharding kept."""
    from ..ops.radar import cfar, range_doppler

    local = _batch_local(rx, mesh, axis_name, 3,
                         "range_doppler_cfar_sharded expects (batch, n_pulses, n_samples)")
    Y = range_doppler(local, tx, window=window, doppler_window=doppler_window,
                      normalize=normalize, config=config)
    det, th = cfar(Y.real ** 2 + Y.imag ** 2, num_train=num_train, num_guard=num_guard,
                   pfa=pfa, method=method, axes=tuple(cfar_axes))
    shape = (local.shape[0] * _axis_size(mesh, axis_name),) + Y.shape[1:]
    spec = (axis_name, None, None)
    return (_wrap(Y, mesh, spec, shape), _wrap(det, mesh, spec, shape),
            _wrap(th, mesh, spec, shape))


# ---------------------------------------------------------------------------
# Distributed NUFFT: the points sharded over the mesh.  Type 1 spreads each
# rank's points, sums the oversampled grid over the mesh axis, and runs the
# small FFT and deconvolution on every rank; type 2 runs them on every rank
# and interpolates only its own points.  Point counts that do not divide the
# mesh are zero-padded (zero strengths spread nothing; padded outputs are
# cut).
# ---------------------------------------------------------------------------


def _padded_points(mesh: DeviceMesh, axis_name: str, *pts):
    """The point arrays zero-padded to a multiple of the mesh axis, whole on
    this rank, and the pad."""
    pts = tuple(_full(p, mesh) for p in pts)
    pad = (-pts[0].shape[0]) % _axis_size(mesh, axis_name)
    return tuple(_pad(p, (0, pad)) for p in pts), pad


def _check_points(pts, c):
    x = pts[0]
    if x.ndim != 1 or x.shape[0] < 1 or any(p.shape != x.shape for p in pts):
        if len(pts) == 1:
            raise ValueError("x must be a non-empty 1-D point array")
        raise ValueError("x and y must be equal-length non-empty 1-D arrays")
    if c is not None and c.shape[-1] != x.shape[0]:
        raise ValueError(
            f"strengths last axis {c.shape[-1]} != number of points {x.shape[0]}")


def nufft1_sharded(
    x,
    c,
    n_modes: int,
    mesh: DeviceMesh,
    axis_name: str = SEQ_AXIS,
    *,
    isign: int = -1,
    eps: float = 1e-6,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> DTensor:
    """Type-1 NUFFT with the point set sharded over ``axis_name``:
    (…, M) strengths + (M,) points -> replicated (…, n_modes) centred modes.
    One collective: a sum of the (…, sigma·N) oversampled grid after local
    spreading."""
    from ..ops.fft import fft
    from ..ops.nufft import _center, _deconv_on, _grid_params, _spread, _values

    x, c = _full(x, mesh), _full(c, mesh)
    _check_points((x,), c)
    if n_modes < 1:
        raise ValueError(f"n_modes must be >= 1, got {n_modes}")
    (xp,), pad = _padded_points(mesh, axis_name, x.to(DTYPE))
    c = _pad(_values(c), (0, pad))
    xl = _local(xp, mesh, (axis_name,))
    cl = _local(c, mesh, (None,) * (c.ndim - 1) + (axis_name,))
    if isign > 0:
        xl = -xl
    mr, tau, msp = _grid_params(n_modes, eps)
    grid = _psum(_spread(xl, cl, mr, tau, msp), mesh, axis_name)
    out = _center(fft(grid, config=config), mr, n_modes) * _deconv_on(xl, (n_modes, mr, tau))
    return _wrap(out, mesh, (None,) * out.ndim, out.shape)


def _cut_padded(out: Tensor, mesh: DeviceMesh, axis_name: str, m_out: int) -> Tensor:
    """This rank's block of a padded point axis, cut to the real points (the
    blocks of ``torch.chunk``, which DTensor's uneven sharding follows)."""
    w = out.shape[-1]
    keep = max(0, min(w, m_out - _axis_index(mesh, axis_name) * w))
    return out[..., :keep]


def nufft2_sharded(
    x,
    f,
    mesh: DeviceMesh,
    axis_name: str = SEQ_AXIS,
    *,
    isign: int = +1,
    eps: float = 1e-6,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> DTensor:
    """Type-2 NUFFT with the evaluation points sharded over ``axis_name``:
    replicated (…, n_modes) modes -> (…, M) values sharded on the point
    axis.  No collectives: every rank runs the same deconvolution and FFT
    and interpolates only its own points."""
    from ..ops.fft import ifft
    from ..ops.nufft import _deconv_on, _grid_params, _interp, _values, _wrap as _wrap_modes

    x, f = _full(x, mesh), _values(_full(f, mesh))
    _check_points((x,), None)
    n_modes = f.shape[-1]
    if n_modes < 1:
        raise ValueError("f must be non-empty along the mode axis")
    m_out = x.shape[0]
    (xp,), _ = _padded_points(mesh, axis_name, x.to(DTYPE))
    xl = _local(xp, mesh, (axis_name,))
    if isign < 0:
        xl = -xl
    mr, tau, msp = _grid_params(n_modes, eps)
    u = ifft(_wrap_modes(f * _deconv_on(xl, (n_modes, mr, tau)), mr), config=config) * mr
    out = _cut_padded(_interp(u, xl, mr, tau, msp), mesh, axis_name, m_out)
    return _wrap(out, mesh, (None,) * (f.ndim - 1) + (axis_name,), f.shape[:-1] + (m_out,))


def nufft1_2d_sharded(
    x,
    y,
    c,
    n_modes,
    mesh: DeviceMesh,
    axis_name: str = SEQ_AXIS,
    *,
    isign: int = -1,
    eps: float = 1e-6,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> DTensor:
    """2-D type-1 NUFFT with the point set sharded over ``axis_name`` (the
    distributed MRI-gridding shape): (…, M) strengths + (M,) x/y ->
    replicated (…, n1, n2) centred modes.  One collective: a sum of the
    oversampled 2-D grid after local spreading."""
    from ..ops.fft import fft2
    from ..ops.nufft import _center, _deconv_on, _grid_params, _spread_2d, _values

    x, y, c = _full(x, mesh), _full(y, mesh), _full(c, mesh)
    _check_points((x, y), c)
    n1, n2 = int(n_modes[0]), int(n_modes[1])
    if n1 < 1 or n2 < 1:
        raise ValueError(f"n_modes must be positive, got {n_modes}")
    (xp, yp), pad = _padded_points(mesh, axis_name, x.to(DTYPE), y.to(DTYPE))
    c = _pad(_values(c), (0, pad))
    xl, yl = _local(xp, mesh, (axis_name,)), _local(yp, mesh, (axis_name,))
    cl = _local(c, mesh, (None,) * (c.ndim - 1) + (axis_name,))
    if isign > 0:
        xl, yl = -xl, -yl
    mr1, tau1, msp = _grid_params(n1, eps)
    mr2, tau2, _ = _grid_params(n2, eps)
    grid = _psum(_spread_2d(xl, yl, cl, (mr1, mr2), (tau1, tau2), msp), mesh, axis_name)
    spec = fft2(grid, config=config)
    out = (_center(_center(spec, mr1, n1, axis=-2), mr2, n2)
           * _deconv_on(xl, (n1, mr1, tau1), (n2, mr2, tau2)))
    return _wrap(out, mesh, (None,) * out.ndim, out.shape)


def nufft2_2d_sharded(
    x,
    y,
    f,
    mesh: DeviceMesh,
    axis_name: str = SEQ_AXIS,
    *,
    isign: int = +1,
    eps: float = 1e-6,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> DTensor:
    """2-D type-2 NUFFT with the evaluation points sharded over
    ``axis_name``: replicated (…, n1, n2) modes -> (…, M) values.  No
    collectives: every rank runs the same deconvolution and fft2 and
    interpolates only its own points."""
    from ..ops.fft import ifft2
    from ..ops.nufft import _deconv_on, _grid_params, _interp_2d, _values, _wrap as _wrap_modes

    x, y, f = _full(x, mesh), _full(y, mesh), _values(_full(f, mesh))
    _check_points((x, y), None)
    if f.ndim < 2 or f.shape[-1] < 1 or f.shape[-2] < 1:
        raise ValueError("f must be (…, n1, n2) with non-empty mode axes")
    n1, n2 = f.shape[-2], f.shape[-1]
    m_out = x.shape[0]
    (xp, yp), _ = _padded_points(mesh, axis_name, x.to(DTYPE), y.to(DTYPE))
    xl, yl = _local(xp, mesh, (axis_name,)), _local(yp, mesh, (axis_name,))
    if isign < 0:
        xl, yl = -xl, -yl
    mr1, tau1, msp = _grid_params(n1, eps)
    mr2, tau2, _ = _grid_params(n2, eps)
    fd = f * _deconv_on(xl, (n1, mr1, tau1), (n2, mr2, tau2))
    u = ifft2(_wrap_modes(_wrap_modes(fd, mr1, axis=-2), mr2), config=config) * (mr1 * mr2)
    out = _cut_padded(_interp_2d(u, xl, yl, (mr1, mr2), (tau1, tau2), msp), mesh,
                      axis_name, m_out)
    return _wrap(out, mesh, (None,) * (f.ndim - 2) + (axis_name,), f.shape[:-2] + (m_out,))


# ---------------------------------------------------------------------------
# Distributed spherical harmonic transform: latitude bands sharded over the
# mesh.  The longitude FFT is per latitude (local to a band); analysis
# contracts the Legendre tables over latitude, so each rank reduces its band
# and one sum over the mesh axis completes the quadrature.  Synthesis needs
# no collective: each rank evaluates its band from the replicated
# coefficients.
# ---------------------------------------------------------------------------


def _band(mesh: DeviceMesh, axis_name: str, nlat: int) -> Tuple[slice, int, int]:
    parts = _axis_size(mesh, axis_name)
    r = _axis_index(mesh, axis_name)
    b = nlat // parts
    return slice(r * b, (r + 1) * b), r, parts


def sht_sharded(
    f,
    mesh: DeviceMesh,
    axis_name: str = SEQ_AXIS,
    *,
    grid: str = "gauss",
    config: SpectralConfig = DEFAULT_CONFIG,
) -> DTensor:
    """Spherical harmonic analysis with latitude sharded over ``axis_name``:
    grid values -> replicated (…, 2L-1, L) coefficients, one sum over the
    mesh axis ((…, L, 2L) for grid="gauss", square (…, 2L, 2L)
    equiangular)."""
    from ..ops.fft import fft
    from ..ops.rfft import rfft
    from ..ops.sht import _analyze, _grid_on, _select_packed_m

    f = _input(f, mesh)
    shape = tuple(f.shape)
    if grid == "equiangular":
        if len(shape) < 2 or shape[-1] < 2 or shape[-2] != shape[-1] or shape[-1] % 2:
            raise ValueError("equiangular f must be even-square (…, 2L, 2L)")
        L = shape[-1] // 2
    else:
        if len(shape) < 2 or shape[-2] < 1 or shape[-1] != 2 * shape[-2]:
            raise ValueError("f must be (…, L, 2L) on the sht_grid")
        L = shape[-2]
    parts = _axis_size(mesh, axis_name)
    if shape[-2] % parts != 0:
        raise ValueError(
            f"mesh axis size {parts} must divide the latitude count {shape[-2]}")
    band, _, _ = _band(mesh, axis_name, shape[-2])
    fl = _local(f, mesh, (None,) * (len(shape) - 2) + (axis_name, None))
    hermitian = not fl.is_complex()
    # a real field rides the Hermitian path (rfft, half the Legendre work):
    # the fold is linear, so folding before the sum over ranks is exact
    if hermitian:
        fsel = rfft(fl.to(DTYPE), config=config)[..., :L]
    else:
        fsel = _select_packed_m(fft(fl, config=config), L)
    wdphi = _grid_on("sht_weights", L, grid, fsel)[band]
    part = _analyze("sht_legendre", fsel, wdphi, L, config, hermitian=hermitian, grid=grid,
                    band=(band.start, band.stop))
    out = _psum(part, mesh, axis_name)
    return _wrap(out, mesh, (None,) * out.ndim, out.shape)


def isht_sharded(
    alm,
    mesh: DeviceMesh,
    axis_name: str = SEQ_AXIS,
    *,
    grid: str = "gauss",
    config: SpectralConfig = DEFAULT_CONFIG,
) -> DTensor:
    """Spherical harmonic synthesis with latitude bands sharded over
    ``axis_name``: replicated (…, 2L-1, L) coefficients -> grid values
    ((…, L, 2L) gauss, (…, 2L, 2L) equiangular) sharded on latitude.  No
    collectives (each rank evaluates its band)."""
    from ..ops.sht import _synthesize

    alm = _full(alm, mesh)
    if alm.ndim < 2 or alm.shape[-1] < 1 or alm.shape[-2] != 2 * alm.shape[-1] - 1:
        raise ValueError("alm must be (…, 2L-1, L) packed coefficients")
    L = alm.shape[-1]
    parts = _axis_size(mesh, axis_name)
    nlat = L if grid == "gauss" else 2 * L
    if nlat % parts != 0:
        raise ValueError(f"mesh axis size {parts} must divide the latitude count {nlat}")
    band, _, _ = _band(mesh, axis_name, nlat)
    out = _synthesize("sht_legendre", alm, config, grid=grid, band=(band.start, band.stop))
    return _wrap(out, mesh, (None,) * (alm.ndim - 2) + (axis_name, None),
                 alm.shape[:-2] + (nlat, 2 * L))


def _rec_weights_band(L: int, r: int, parts: int) -> np.ndarray:
    """The recurrence's analysis quadrature (Gauss weights times the
    longitude step, fp32) on latitude band ``r`` of ``parts``."""
    from ..ops.sht import _rec_weights

    b = L // parts
    return _rec_weights(L)[r * b:(r + 1) * b]


def sht_recurrence_sharded(
    f,
    mesh: DeviceMesh,
    axis_name: str = SEQ_AXIS,
    *,
    compensated: bool = False,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> DTensor:
    """Latitude-sharded recurrence spherical analysis: each rank scans only
    its own latitude band ((L, L/parts) Legendre planes; the recurrence is
    independent per latitude) and one sum over the mesh axis completes the
    quadrature.  The (…, 2L-1, L) coefficient accumulator spans every
    degree and stays O(L²) on each rank."""
    from ..ops.fft import fft
    from ..ops.rfft import rfft
    from ..ops.sht import _fold_neg_last, _rec_analyze_core, _rec_pack, _select_packed_m

    f = _input(f, mesh)
    shape = tuple(f.shape)
    if len(shape) < 2 or shape[-2] < 1 or shape[-1] != 2 * shape[-2]:
        raise ValueError("f must be (…, L, 2L) on the sht_grid")
    L = shape[-2]
    parts = _axis_size(mesh, axis_name)
    if L % parts != 0:
        raise ValueError(f"mesh axis size {parts} must divide the latitude count L={L}")
    band, r, parts = _band(mesh, axis_name, L)
    fl = _local(f, mesh, (None,) * (len(shape) - 2) + (axis_name, None))
    wl = host_table("sht_rec_weights_band", _rec_weights_band, L, r, parts, like=fl.real)
    hermitian = not fl.is_complex()
    if hermitian:
        srcs = (rfft(fl.to(DTYPE), config=config)[..., :L] * wl[:, None])[None]
    else:
        fw = _select_packed_m(fft(fl, config=config), L) * wl[:, None]
        srcs = torch.stack([fw[..., :L], _fold_neg_last(fw, L)])
    acc = _rec_analyze_core(srcs, L, config, lat=(band.start, band.stop),
                            compensated=compensated)
    out = _rec_pack(_psum(acc, mesh, axis_name), L, hermitian)
    return _wrap(out, mesh, (None,) * out.ndim, out.shape)


def isht_recurrence_sharded(
    alm,
    mesh: DeviceMesh,
    axis_name: str = SEQ_AXIS,
    *,
    real_output: bool = False,
    compensated: bool = False,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> DTensor:
    """Latitude-sharded recurrence spherical synthesis: no collectives;
    scan planes are (L, L/parts) per rank, while the replicated coefficient
    input is O(L²)."""
    from ..ops.fft import ifft
    from ..ops.rfft import irfft
    from ..ops.sht import _neg_signs, _rec_synth_core

    alm = _full(alm, mesh)
    if alm.ndim < 2 or alm.shape[-1] < 1 or alm.shape[-2] != 2 * alm.shape[-1] - 1:
        raise ValueError("alm must be (…, 2L-1, L) packed coefficients")
    alm = alm.to(torch.complex64)
    L = alm.shape[-1]
    parts = _axis_size(mesh, axis_name)
    if L % parts != 0:
        raise ValueError(f"mesh axis size {parts} must divide the latitude count L={L}")
    band, _, _ = _band(mesh, axis_name, L)
    apos = alm[..., :L, :]
    if real_output:
        srcs = apos[None]
    else:
        half = torch.flip(alm[..., L:, :], (-2,))
        z = alm.new_zeros(alm.shape[:-2] + (1, L))
        sign = host_table("sht_neg_signs", _neg_signs, L, like=alm.real)
        srcs = torch.stack([apos, torch.cat([z, half], dim=-2) * sign[:, None]])
    g = _rec_synth_core(srcs, L, config, lat=(band.start, band.stop),
                        compensated=compensated)
    nlon = 2 * L
    gpos = g[0]
    zeros = gpos.new_zeros(gpos.shape[:-1] + (1,))
    if real_output:
        out = irfft(torch.cat([gpos, zeros], dim=-1), n=nlon, config=config) * nlon
    else:
        bins = torch.cat([gpos, zeros, torch.flip(g[1][..., 1:], (-1,))], dim=-1)
        out = ifft(bins, config=config) * nlon
    return _wrap(out, mesh, (None,) * (alm.ndim - 2) + (axis_name, None),
                 alm.shape[:-2] + (L, nlon))
