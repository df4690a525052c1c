"""Peak analysis (scipy.signal find_peaks family) + rank filters.

Counterpart of ``mixed_radix_fast_fourier_transform_tpu/ops/peaks.py``.
Peak pickers are data-dependent (output size varies with the input), so
they run on the host on numpy arrays in float64, as the JAX module runs
them: a tensor is brought from its device first, the standard
post-processing step after a device-computed spectrum or envelope.  The
rank filters (``medfilt``/``order_filter``) are device ops: small static
windows gathered by stacked slices of the zero-padded input and reduced by
one sort on the card — no data-dependent shapes there.
"""

from __future__ import annotations

import math

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.numerics import as_tensor, to_host

Tensor = torch.Tensor

__all__ = [
    "argrelmin", "argrelmax", "argrelextrema",
    "find_peaks", "find_peaks_cwt", "peak_prominences", "peak_widths",
    "medfilt", "medfilt2d", "order_filter",
]


# ---------------------------------------------------------------------------
# Relative extrema (host)
# ---------------------------------------------------------------------------


def argrelextrema(data, comparator, axis: int = 0, order: int = 1,
                  mode: str = "clip"):
    """Indices of relative extrema by ``comparator`` against ±1..order
    neighbors (scipy.signal.argrelextrema)."""
    data = to_host(data)
    if order < 1:
        raise ValueError(f"order must be >= 1, got {order}")
    n = data.shape[axis]
    locs = np.arange(n)
    keep = np.ones(data.shape, bool)
    for shift in range(1, order + 1):
        plus = np.take(data, np.clip(locs + shift, 0, n - 1), axis=axis) \
            if mode == "clip" else np.take(data, (locs + shift) % n, axis=axis)
        minus = np.take(data, np.clip(locs - shift, 0, n - 1), axis=axis) \
            if mode == "clip" else np.take(data, (locs - shift) % n, axis=axis)
        keep &= comparator(data, plus)
        keep &= comparator(data, minus)
        if not keep.any():
            break
    return np.nonzero(keep)


def argrelmax(data, axis: int = 0, order: int = 1, mode: str = "clip"):
    """Relative maxima (scipy.signal.argrelmax)."""
    return argrelextrema(data, np.greater, axis=axis, order=order, mode=mode)


def argrelmin(data, axis: int = 0, order: int = 1, mode: str = "clip"):
    """Relative minima (scipy.signal.argrelmin)."""
    return argrelextrema(data, np.less, axis=axis, order=order, mode=mode)


# ---------------------------------------------------------------------------
# find_peaks + prominence/width (host, scipy semantics incl. plateaus)
# ---------------------------------------------------------------------------


def _local_maxima_1d(x: np.ndarray):
    """Midpoints + edges of strict local maxima with plateau handling
    (scipy's _local_maxima_1d contract)."""
    mids, lefts, rights = [], [], []
    i, n = 1, len(x)
    while i < n - 1:
        if x[i - 1] < x[i]:
            ahead = i + 1
            while ahead < n - 1 and x[ahead] == x[i]:
                ahead += 1
            if x[ahead] < x[i]:
                left, right = i, ahead - 1
                mids.append((left + right) // 2)
                lefts.append(left)
                rights.append(right)
                i = ahead
                continue
        i += 1
    return (np.asarray(mids, np.intp), np.asarray(lefts, np.intp),
            np.asarray(rights, np.intp))


def _interval(arg, n_peaks: int, name: str):
    """Normalize a scalar / (min, max) / arrays spec to (vmin, vmax)."""
    if arg is None:
        return None, None
    if np.isscalar(arg) or (isinstance(arg, np.ndarray) and arg.ndim > 0
                            and not isinstance(arg, (tuple, list))):
        return np.asarray(arg), None
    if isinstance(arg, (tuple, list)):
        if len(arg) != 2:
            raise ValueError(f"{name} must be scalar or (min, max)")
        return (None if arg[0] is None else np.asarray(arg[0]),
                None if arg[1] is None else np.asarray(arg[1]))
    return np.asarray(arg), None


def peak_prominences(x, peaks, wlen: Optional[int] = None):
    """Prominence of each peak (scipy.signal.peak_prominences): height above
    the higher of the two deepest valleys to the nearest higher terrain."""
    x = to_host(x, np.float64)
    peaks = to_host(peaks, np.intp)
    if np.any(peaks < 0) or np.any(peaks >= len(x)):
        raise ValueError("peak index out of range")
    prom = np.empty(len(peaks))
    lbase = np.empty(len(peaks), np.intp)
    rbase = np.empty(len(peaks), np.intp)
    if wlen is None:
        half = -1
    else:
        w = int(math.ceil(wlen))
        if w % 2 == 0:
            w += 1  # scipy rounds wlen up to the next odd integer
        half = w // 2
    for k, p in enumerate(peaks):
        lo = 0 if half < 0 else max(0, p - half)
        hi = len(x) - 1 if half < 0 else min(len(x) - 1, p + half)
        # walk left until terrain exceeds the peak, tracking the minimum
        i, lmin, larg = p, x[p], p
        while i > lo and x[i - 1] <= x[p]:
            i -= 1
            if x[i] < lmin:
                lmin, larg = x[i], i
        i, rmin, rarg = p, x[p], p
        while i < hi and x[i + 1] <= x[p]:
            i += 1
            if x[i] < rmin:
                rmin, rarg = x[i], i
        lbase[k], rbase[k] = larg, rarg
        prom[k] = x[p] - max(lmin, rmin)
    return prom, lbase, rbase


def peak_widths(x, peaks, rel_height: float = 0.5,
                prominence_data=None, wlen: Optional[int] = None):
    """Width of each peak at a relative prominence height
    (scipy.signal.peak_widths): linear-interpolated crossings."""
    x = to_host(x, np.float64)
    peaks = to_host(peaks, np.intp)
    if not 0 <= rel_height:
        raise ValueError("rel_height must be >= 0")
    if prominence_data is None:
        prominence_data = peak_prominences(x, peaks, wlen)
    prom, lbase, rbase = prominence_data
    widths = np.empty(len(peaks))
    h_eval = np.empty(len(peaks))
    lips = np.empty(len(peaks))
    rips = np.empty(len(peaks))
    for k, p in enumerate(peaks):
        h = x[p] - prom[k] * rel_height
        h_eval[k] = h
        i = p
        while i > lbase[k] and x[i] > h:
            i -= 1
        lip = float(i)
        if x[i] < h:
            lip = i + (h - x[i]) / (x[i + 1] - x[i])
        i = p
        while i < rbase[k] and x[i] > h:
            i += 1
        rip = float(i)
        if x[i] < h:
            rip = i - (h - x[i]) / (x[i - 1] - x[i])
        lips[k], rips[k] = lip, rip
        widths[k] = rip - lip
    return widths, h_eval, lips, rips


def find_peaks(x, height=None, threshold=None, distance=None,
               prominence=None, width=None, wlen: Optional[int] = None,
               rel_height: float = 0.5, plateau_size=None):
    """Local-maxima picker with scipy.signal.find_peaks filtering semantics:
    conditions are applied in scipy's order (plateau → height → threshold →
    distance → prominence → width) so the surviving set matches."""
    x = to_host(x, np.float64)
    if x.ndim != 1:
        raise ValueError("find_peaks expects a 1-D signal")
    peaks, ledges, redges = _local_maxima_1d(x)
    props = {}

    if plateau_size is not None:
        pmin, pmax = _interval(plateau_size, len(peaks), "plateau_size")
        sizes = redges - ledges + 1
        keep = np.ones(len(peaks), bool)
        if pmin is not None:
            keep &= sizes >= pmin
        if pmax is not None:
            keep &= sizes <= pmax
        peaks, ledges, redges = peaks[keep], ledges[keep], redges[keep]
        props["plateau_sizes"] = redges - ledges + 1
        props["left_edges"], props["right_edges"] = ledges, redges

    if height is not None:
        hmin, hmax = _interval(height, len(peaks), "height")
        hts = x[peaks]
        keep = np.ones(len(peaks), bool)
        if hmin is not None:
            keep &= hts >= hmin
        if hmax is not None:
            keep &= hts <= hmax
        peaks = peaks[keep]
        props = {k: v[keep] for k, v in props.items()}
        props["peak_heights"] = x[peaks]

    if threshold is not None:
        tmin, tmax = _interval(threshold, len(peaks), "threshold")
        lt = x[peaks] - x[peaks - 1]
        rt = x[peaks] - x[peaks + 1]
        keep = np.ones(len(peaks), bool)
        if tmin is not None:
            keep &= np.minimum(lt, rt) >= tmin
        if tmax is not None:
            keep &= np.maximum(lt, rt) <= tmax
        props_new = {"left_thresholds": lt, "right_thresholds": rt}
        peaks = peaks[keep]
        props = {k: v[keep] for k, v in props.items()}
        for k, v in props_new.items():
            props[k] = v[keep]

    if distance is not None:
        if distance < 1:
            raise ValueError("distance must be >= 1")
        # scipy: highest peaks win; kept peaks suppress neighbors in range
        keep = np.ones(len(peaks), bool)
        order = np.argsort(x[peaks])[::-1]
        for idx in order:
            if not keep[idx]:
                continue
            close = np.abs(peaks - peaks[idx]) < distance
            close[idx] = False
            keep[close] = False
        peaks = peaks[keep]
        props = {k: v[keep] for k, v in props.items()}

    if prominence is not None or width is not None:
        prom, lb, rb = peak_prominences(x, peaks, wlen)
        props["prominences"] = prom
        props["left_bases"], props["right_bases"] = lb, rb
    if prominence is not None:
        pmin, pmax = _interval(prominence, len(peaks), "prominence")
        keep = np.ones(len(peaks), bool)
        if pmin is not None:
            keep &= props["prominences"] >= pmin
        if pmax is not None:
            keep &= props["prominences"] <= pmax
        peaks = peaks[keep]
        props = {k: v[keep] for k, v in props.items()}
    if width is not None:
        w, h_eval, lips, rips = peak_widths(
            x, peaks, rel_height,
            (props["prominences"], props["left_bases"], props["right_bases"]))
        props["widths"] = w
        props["width_heights"] = h_eval
        props["left_ips"], props["right_ips"] = lips, rips
        wmin, wmax = _interval(width, len(peaks), "width")
        keep = np.ones(len(peaks), bool)
        if wmin is not None:
            keep &= w >= wmin
        if wmax is not None:
            keep &= w <= wmax
        peaks = peaks[keep]
        props = {k: v[keep] for k, v in props.items()}
    return peaks, props


# ---------------------------------------------------------------------------
# Rank filters (device): static windows via stacked slices + sort
# ---------------------------------------------------------------------------


def order_filter(x, domain, rank: int) -> Tensor:
    """Rank filter over a boolean footprint (scipy.signal.order_filter):
    each output sample is the rank-th smallest of the footprint's samples
    (zero-padded edges).  The footprint is gathered by static slices of
    the padded input and reduced with one vectorized sort over the stack."""
    x = as_tensor(x)
    domain = np.asarray(domain)
    if domain.ndim != x.ndim:
        raise ValueError("domain must have the same rank as the input")
    if np.any(np.asarray(domain.shape) % 2 == 0):
        raise ValueError("each domain dimension must be odd")
    taps = np.argwhere(domain != 0)
    center = np.asarray(domain.shape) // 2
    if not 0 <= rank < len(taps):
        raise ValueError(f"rank must be in [0, {len(taps)}), got {rank}")
    pads = []
    for c in center[::-1]:  # F.pad lists the last axis first
        pads += [int(c), int(c)]
    xp = F.pad(x, pads)
    stack = []
    for t in taps:
        sl = tuple(slice(int(o), int(o) + s) for o, s in zip(t, x.shape))
        stack.append(xp[sl])
    patches = torch.stack(stack, dim=-1)
    return torch.sort(patches, dim=-1).values[..., rank]


def medfilt(x, kernel_size=3) -> Tensor:
    """1-D/N-D median filter (scipy.signal.medfilt, zero-padded)."""
    x = as_tensor(x)
    if np.isscalar(kernel_size):
        kernel_size = (int(kernel_size),) * x.ndim
    kernel_size = tuple(int(k) for k in kernel_size)
    if any(k % 2 == 0 for k in kernel_size):
        raise ValueError(f"kernel_size must be odd, got {kernel_size}")
    domain = np.ones(kernel_size, bool)
    size = int(np.prod(kernel_size))
    return order_filter(x, domain, (size - 1) // 2)


def medfilt2d(x, kernel_size=3) -> Tensor:
    """2-D median filter (scipy.signal.medfilt2d, zero-padded)."""
    x = as_tensor(x)
    if x.ndim != 2:
        raise ValueError("medfilt2d expects a 2-D input")
    return medfilt(x, kernel_size)


def _ridge_lines(mat: np.ndarray, max_distances: np.ndarray,
                 gap_thresh: float):
    """Connect per-row relative maxima of a CWT matrix into ridge lines
    (scipy's wavelet ridge-line tracker, top scale downward)."""
    relmax = np.zeros(mat.shape, bool)
    interior = (mat[:, 1:-1] > mat[:, :-2]) & (mat[:, 1:-1] > mat[:, 2:])
    relmax[:, 1:-1] = interior
    rows_with = np.nonzero(relmax.any(axis=1))[0]
    if len(rows_with) == 0:
        return []
    start = rows_with[-1]
    active = [[[start], [c], 0] for c in np.nonzero(relmax[start])[0]]
    finished = []
    for row in range(start - 1, -1, -1):
        cols_here = np.nonzero(relmax[row])[0]
        for line in active:
            line[2] += 1
        prev_cols = np.array([line[1][-1] for line in active])
        for c in cols_here:
            line = None
            if len(prev_cols):
                d = np.abs(c - prev_cols)
                j = int(np.argmin(d))
                if d[j] <= max_distances[row]:
                    line = active[j]
            if line is not None:
                line[0].append(row)
                line[1].append(c)
                line[2] = 0
            else:
                active.append([[row], [c], 0])
        for i in range(len(active) - 1, -1, -1):
            if active[i][2] > gap_thresh:
                finished.append(active.pop(i))
    out = []
    for rows, cols, _ in finished + active:
        order = np.argsort(rows)
        out.append((np.asarray(rows)[order], np.asarray(cols)[order]))
    return out


def find_peaks_cwt(vector, widths, wavelet=None, max_distances=None,
                   gap_thresh: Optional[float] = None,
                   min_length: Optional[int] = None,
                   min_snr: float = 1.0, noise_perc: float = 10.0,
                   window_size: Optional[int] = None) -> np.ndarray:
    """Wavelet-ridge peak detection (scipy.signal.find_peaks_cwt): ricker
    CWT over ``widths``, ridge lines tracked from coarse to fine scale,
    filtered by length and by SNR against a windowed noise percentile of
    the finest scale.

    This is a host-side ANALYSIS function (data-dependent output size);
    its ridge matrix is a host float64 correlation so that strict relative-
    maxima comparisons are meaningful even on noiseless signals — the
    device :func:`..cwt.cwt` op stays the fp32 compute path."""
    from .cwt import ricker

    vector = to_host(vector, np.float64)
    widths = np.atleast_1d(np.asarray(widths, np.float64))
    if gap_thresh is None:
        gap_thresh = float(np.ceil(widths[0]))
    if max_distances is None:
        max_distances = widths / 4.0
    max_distances = np.asarray(max_distances, np.float64)
    if wavelet is None:
        wavelet = ricker
    n = len(vector)
    mat = np.empty((len(widths), n))
    for i, wd in enumerate(widths):
        points = min(10 * wd, n)
        w = np.conj(np.asarray(wavelet(points, wd), np.float64)[::-1])
        mat[i] = np.convolve(vector, w, mode="same")
    lines = _ridge_lines(mat, max_distances, gap_thresh)

    n = mat.shape[1]
    if min_length is None:
        min_length = int(np.ceil(mat.shape[0] / 4))
    if window_size is None:
        window_size = int(np.ceil(n / 20))
    half, odd = divmod(int(window_size), 2)
    row0 = mat[0]
    noise = np.array([
        np.percentile(row0[max(i - half, 0): min(i + half + odd, n)],
                      noise_perc)
        for i in range(n)
    ])
    locs = []
    for rows, cols in lines:
        if len(rows) < min_length:
            continue
        denom = noise[cols[0]]
        snr = abs(mat[rows[0], cols[0]] / denom) if denom != 0 else np.inf
        if snr < min_snr:
            continue
        locs.append(cols[0])
    return np.sort(np.asarray(locs, np.intp))
