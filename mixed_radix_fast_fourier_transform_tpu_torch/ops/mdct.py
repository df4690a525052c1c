"""Modified DCT (MDCT/IMDCT) with TDAC framing, the audio-codec transform.

Counterpart of ``mixed_radix_fast_fourier_transform_tpu/ops/mdct.py``: the
lapped transform used by MP3/AAC/Opus-CELT/AC-3.  A length-2N frame maps to
N coefficients

    X[k] = sum_{n=0}^{2N-1} w[n] x[n] cos[(pi/N)(n + 1/2 + N/2)(k + 1/2)]

and 50%-overlapped frames reconstruct exactly (time-domain alias
cancellation) whenever the window satisfies the Princen-Bradley condition
w[n]^2 + w[n+N]^2 = 1.

The O(4N^2) cosine sum folds into a length-N DCT-IV
(u = [-rev(c) - d, a - rev(b)] over the frame's quarters a|b|c|d), which
``ops.dct`` evaluates through the FFT engine, so a whole
(batch, frames, 2N) tensor runs as one pipeline: strided framing -> fold
(pure slicing) -> DCT-IV -> scale.  The inverse is the same DCT-IV followed
by the alias-symmetric unfold and an overlap-add that is two pads and one
add (no scatter).

* ``norm=None``: forward is the raw cosine sum above; inverse scales by 2/N
  so windowed overlap-add reconstructs exactly.
* ``norm="ortho"``: both directions scale by sqrt(2/N) (the round-trip
  product is the same 2/N, so TDAC reconstruction is unchanged).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.config import DEFAULT_CONFIG, DTYPE, SpectralConfig
from ..utils.numerics import as_tensor, constant
from .dct import dct

Tensor = torch.Tensor


def mdct_window(window, frame_length: int, dtype=np.float32) -> np.ndarray:
    """Resolve an MDCT analysis/synthesis window to a host numpy array.

    Accepted: ``"sine"`` (the MP3/Vorbis default), ``("kbd", beta)``
    (Kaiser-Bessel-derived, the AAC/AC-3 family), ``None`` (rectangular
    1/sqrt(2) — the trivial Princen-Bradley window), or an explicit array of
    length ``frame_length``.  All built-ins satisfy the Princen-Bradley
    condition w[n]^2 + w[n+N]^2 = 1 required for perfect reconstruction.
    """
    if frame_length % 4 != 0 or frame_length < 4:
        raise ValueError(
            f"frame_length must be a positive multiple of 4, got {frame_length}"
        )
    if window is None:
        return np.full(frame_length, 1.0 / math.sqrt(2.0), dtype=dtype)
    if isinstance(window, str):
        if window != "sine":
            raise ValueError(f"unknown MDCT window {window!r}")
        n = np.arange(frame_length, dtype=np.float64)
        return np.sin(np.pi / frame_length * (n + 0.5)).astype(dtype)
    if isinstance(window, tuple):
        name, *params = window
        if name != "kbd" or len(params) != 1:
            raise ValueError(f"unknown parameterized MDCT window {window!r}")
        beta = float(params[0])
        half = frame_length // 2
        # Kaiser-Bessel-derived: cumulative kaiser(half+1) energy, sqrt-split
        j = np.arange(half + 1, dtype=np.float64)
        ratio = 2.0 * j / half - 1.0
        kais = np.i0(beta * np.sqrt(np.maximum(1.0 - ratio**2, 0.0)))
        cum = np.cumsum(kais)
        left = np.sqrt(cum[:-1] / cum[-1])
        return np.concatenate([left, left[::-1]]).astype(dtype)
    w = np.asarray(window, dtype=dtype)
    if w.shape != (frame_length,):
        raise ValueError(
            f"window length {w.shape} != frame_length {frame_length}"
        )
    return w



def _fold(frames: Tensor, half: int) -> Tensor:
    """(…, 2N) windowed frame -> (…, N) DCT-IV input [-rev(c)-d, a-rev(b)]."""
    q = half // 2
    a = frames[..., :q]
    b = frames[..., q : 2 * q]
    c = frames[..., 2 * q : 3 * q]
    d = frames[..., 3 * q :]
    return torch.cat([-torch.flip(c, (-1,)) - d, a - torch.flip(b, (-1,))], dim=-1)


def _unfold(p: Tensor, half: int) -> Tensor:
    """(…, N) half-DCT-IV output -> (…, 2N) aliased frame (inverse of the
    cosine-sum symmetries: phi(2N-1-m) = -phi(m), phi(m+2N) = -phi(m))."""
    q = half // 2
    return torch.cat([p[..., q:], -torch.flip(p, (-1,)), -p[..., :q]], dim=-1)


def _window_on(window, frame_length: int, like: Tensor, scale: float = 1.0) -> Tensor:
    key = (("mdct.window", window, frame_length, scale)
           if isinstance(window, (str, tuple)) else None)
    return constant(lambda: mdct_window(window, frame_length, dtype=np.float64) * scale,
                    like, key=key)


def mdct(
    signal,
    frame_length: int,
    window="sine",
    *,
    norm: Optional[str] = None,
    pad: bool = True,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """MDCT of ``signal`` (…, L) -> coefficients (…, F, frame_length//2).

    Frames overlap 50% (hop = frame_length//2).  With ``pad=True`` the signal
    is zero-padded by one hop on each side (plus tail padding to a whole hop)
    so ``imdct`` reconstructs every input sample; with ``pad=False`` the
    caller is responsible for edge frames and L must be a multiple of the hop
    with at least one full frame.
    """
    if frame_length % 4 != 0 or frame_length < 4:
        raise ValueError(
            f"frame_length must be a positive multiple of 4, got {frame_length}"
        )
    x = as_tensor(signal)
    if x.shape[-1] < 1:
        raise ValueError("signal must be non-empty")
    x = x.to(DTYPE)  # integer PCM would truncate the window to 0
    if norm not in (None, "ortho"):
        raise ValueError(f"norm must be None or 'ortho', got {norm!r}")
    half = frame_length // 2
    if pad:
        tail = (-x.shape[-1]) % half
        x = F.pad(x, (half, half + tail))
    elif x.shape[-1] % half != 0 or x.shape[-1] < frame_length:
        raise ValueError(
            "with pad=False the signal length must be a multiple of "
            f"frame_length//2 = {half} and >= frame_length"
        )
    frames = x.unfold(-1, frame_length, half) * _window_on(window, frame_length, x)
    coeff = dct(_fold(frames, half), type=4, config=config) * 0.5
    if norm == "ortho":
        coeff = coeff * math.sqrt(2.0 / half)
    return coeff


def imdct(
    mdcts,
    window="sine",
    *,
    norm: Optional[str] = None,
    pad: bool = True,
    length: Optional[int] = None,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """Inverse MDCT with windowed overlap-add: (…, F, N) -> (…, (F-1)·N).

    Exact reconstruction of ``mdct(signal, 2N, window, pad=True)`` for any
    Princen-Bradley window (sine, KBD, rectangular); pass ``length`` to trim
    tail padding back to the original signal length.  With ``pad=False`` the
    untrimmed (F+1)·N overlap-add (edges aliased) is returned.
    """
    X = as_tensor(mdcts)
    if X.ndim < 2:
        raise ValueError("mdcts must be (…, frames, frame_length//2)")
    if norm not in (None, "ortho"):
        raise ValueError(f"norm must be None or 'ortho', got {norm!r}")
    half = X.shape[-1]
    if half % 2 != 0 or half < 2:
        raise ValueError(
            "mdcts last axis must be frame_length//2 with frame_length a "
            f"multiple of 4 (got {half} coefficients — the TDAC quarter "
            "split needs an even count)"
        )
    scale = math.sqrt(2.0 / half) if norm == "ortho" else 2.0 / half
    p = dct(X, type=4, config=config) * 0.5
    frames = _unfold(p, half) * _window_on(window, 2 * half, p, scale)
    first = frames[..., :half].reshape(*frames.shape[:-2], -1)
    second = frames[..., half:].reshape(*frames.shape[:-2], -1)
    out = F.pad(first, (0, half)) + F.pad(second, (half, 0))
    if pad:
        out = out[..., half:-half]
    if length is not None:
        out = out[..., :length]
    return out
