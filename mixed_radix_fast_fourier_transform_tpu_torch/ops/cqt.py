"""Constant-Q transform (CQT) — log-frequency spectral analysis.

Counterpart of ``mixed_radix_fast_fourier_transform_tpu/ops/cqt.py``.
Brown/Puckette spectral-kernel method: each constant-Q band k is a windowed
complex exponential g_k (length N_k ∝ 1/f_k, so every band has the same
Q = f_k/Δf_k).  All kernels are embedded in one n_fft frame and applied in
the frequency domain:

    CQT[t, k] = Σ_n x[t·hop + n]·conj(g_k[n])
              = (1/n_fft)·Σ_b X_t[b]·conj(Ĝ_k[b])   (Parseval)

so the whole transform is one batched frame FFT (the plan engine) followed
by one dense (n_fft, n_bins) complex product (at ``op_precision``).  Kernels are
built on the host in fp64 (exact integer phase reduction like the twiddle
machinery) and kept on the device per band ladder, as is the inverse's dual
kernel.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utils.config import DEFAULT_CONFIG, DTYPE, SpectralConfig
from ..utils.factorize import next_pow2
from ..utils.numerics import (
    as_tensor, complex_dtype, content_key, host_table, key_array, matmul_precision, on_host,
    pad_last,
)
from ..utils.sharding import batch_sharded, last_axis
from .fft import fft, ifft
from .stft import _frame, get_window

Tensor = torch.Tensor
_CDTYPE = torch.complex64


def cqt_frequencies(
    n_bins: int, fmin: float, bins_per_octave: int = 12
) -> np.ndarray:
    """Center frequencies of the constant-Q ladder: fmin·2^(k/B)."""
    if n_bins < 1:
        raise ValueError(f"n_bins must be >= 1, got {n_bins}")
    if fmin <= 0:
        raise ValueError(f"fmin must be > 0, got {fmin}")
    if bins_per_octave < 1:
        raise ValueError(
            f"bins_per_octave must be >= 1, got {bins_per_octave}"
        )
    k = np.arange(n_bins, dtype=np.float64)
    return fmin * 2.0 ** (k / bins_per_octave)


def _kernel_lengths(fs: float, freqs: np.ndarray, bins_per_octave: int,
                    filter_scale: float):
    """Q and the band lengths N_k = max(round(Q·fs/f_k), 1)."""
    Q = filter_scale / (2.0 ** (1.0 / bins_per_octave) - 1.0)
    return Q, [max(int(round(Q * fs / f)), 1) for f in freqs]


def _cqt_kernel_time(
    fs: float,
    freqs: np.ndarray,
    bins_per_octave: int,
    window,
    filter_scale: float,
):
    """Host fp64 time-domain kernels: list of (length N_k, complex) arrays,
    each a symmetric window times exp(2πi·f_k·n/fs), L1-normalized (Brown's
    1/N_k convention, so a unit sinusoid at f_k yields |CQT| ~ window mean)."""
    _, lengths = _kernel_lengths(fs, freqs, bins_per_octave, filter_scale)
    kernels = []
    for f, n_k in zip(freqs, lengths):
        w = get_window(window, n_k, np.float64, sym=True)
        n = np.arange(n_k, dtype=np.float64) - (n_k - 1) / 2.0
        # exact phase reduction: f/fs in fp64, phase mod 1 before the trig
        phase = 2.0 * np.pi * ((f / fs * n) % 1.0)
        g = w * (np.cos(phase) + 1j * np.sin(phase)) / n_k
        kernels.append(g)
    return kernels


def _frame_len(fs: float, fmin: float, n_bins: int, bins_per_octave: int,
               filter_scale: float, n_fft) -> int:
    """The frame length: ``n_fft``, or the next power of two covering the
    longest kernel."""
    freqs = cqt_frequencies(n_bins, fmin, bins_per_octave)
    max_len = max(_kernel_lengths(fs, freqs, bins_per_octave, filter_scale)[1])
    nf = next_pow2(max_len) if n_fft is None else int(n_fft)
    if nf < max_len:
        raise ValueError(
            f"n_fft={nf} shorter than the longest kernel ({max_len}); "
            "raise n_fft or fmin"
        )
    return nf


def _cqt_spectral_kernel(
    fs: float,
    fmin: float,
    n_bins: int,
    bins_per_octave: int,
    window,
    filter_scale: float,
    n_fft,
):
    """Host build of the conjugated spectral kernel: (Khat, nf), Khat
    (n_bins, nf) complex128."""
    freqs = cqt_frequencies(n_bins, fmin, bins_per_octave)
    kernels = _cqt_kernel_time(fs, freqs, bins_per_octave, window, filter_scale)
    nf = _frame_len(fs, fmin, n_bins, bins_per_octave, filter_scale, n_fft)
    # each time kernel centered in the frame, conjugated spectrum, 1/nf
    K = np.zeros((n_bins, nf), np.complex128)
    for i, g in enumerate(kernels):
        start = (nf - g.size) // 2
        K[i, start : start + g.size] = g
    return np.conj(np.fft.fft(K, axis=-1)) / nf, nf


def _ladder_key(fs, fmin, n_bins, bins_per_octave, window, filter_scale, n_fft) -> tuple:
    """The band ladder as hashable values, the name of its device tables;
    an array window is keyed by its contents (:func:`_ladder_args` gives
    the arguments back)."""
    wkey = window if isinstance(window, (str, tuple)) else content_key("window", np.asarray(window))
    return (float(fs), float(fmin), int(n_bins), int(bins_per_octave), wkey,
            float(filter_scale), None if n_fft is None else int(n_fft))


def _ladder_args(ladder: tuple) -> tuple:
    """The arguments of :func:`_cqt_spectral_kernel` that ``ladder`` names."""
    wkey = ladder[4]
    array = isinstance(wkey, tuple) and len(wkey) == 4 and wkey[0] == "window" \
        and isinstance(wkey[3], bytes)
    return ladder[:4] + (key_array(wkey) if array else wkey,) + ladder[5:]


def _cqt_plan(fs, fmin, n_bins, bins_per_octave, window, filter_scale, n_fft,
              message: str) -> tuple:
    """Host prologue (``utils.numerics.on_host``): the ladder checked to lie
    below Nyquist (``message`` otherwise), (its frame length, its key)."""
    freqs = cqt_frequencies(n_bins, fmin, bins_per_octave)
    if freqs[-1] >= fs / 2.0:
        raise ValueError(message.format(top=freqs[-1], nyquist=fs / 2.0))
    nf = _frame_len(fs, fmin, n_bins, bins_per_octave, filter_scale, n_fft)
    return nf, _ladder_key(fs, fmin, n_bins, bins_per_octave, window, filter_scale, n_fft)


def _kernel_table(ladder: tuple) -> np.ndarray:
    """The conjugated spectral kernel, transposed for the product: (nf, n_bins)."""
    return _cqt_spectral_kernel(*_ladder_args(ladder))[0].T


def _dual_table(ladder: tuple, reg: float) -> np.ndarray:
    """The dual kernel, transposed for the product: (n_bins, nf)."""
    return _icqt_dual_kernel(*_ladder_args(ladder), reg)[0].T


def _ola_table(nf: int, hop: int, n_frames: int, which: int) -> np.ndarray:
    """The rectangular overlap-add's sample index of every frame sample
    (``which`` 0), or the inverse of each sample's coverage (1)."""
    starts = np.arange(n_frames) * hop
    if which == 0:
        return (starts[:, None] + np.arange(nf)[None, :]).reshape(-1)
    cover = np.zeros(nf + (n_frames - 1) * hop)
    for s in starts:
        cover[s : s + nf] += 1.0
    return 1.0 / np.maximum(cover, 1.0)


@batch_sharded(last_axis)
def cqt(
    x,
    *,
    fs: float = 22050.0,
    fmin: float = 32.703195662574764,  # C1
    n_bins: int = 84,
    bins_per_octave: int = 12,
    hop: int = 512,
    window="hann",
    filter_scale: float = 1.0,
    center: bool = True,
    n_fft: Optional[int] = None,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """Constant-Q transform of a real (or complex) signal along the last
    axis: (…, T) -> (…, n_frames, n_bins) complex coefficients.

    Band k has center frequency fmin·2^(k/bins_per_octave) and Q-matched
    length N_k = round(Q·fs/f_k), Q = filter_scale/(2^(1/B) − 1); frame t is
    centered on sample t·hop (``center=True`` zero-pads by n_fft//2, so
    every kernel window fits).  All bands must lie strictly below Nyquist.
    ``n_fft`` overrides the frame length (default: next power of two
    covering the longest kernel)."""
    x = as_tensor(x)
    if x.ndim < 1 or x.shape[-1] < 1:
        raise ValueError("cqt needs a non-empty signal")
    if hop < 1:
        raise ValueError(f"hop must be >= 1, got {hop}")
    if fs <= 0:
        raise ValueError(f"fs must be > 0, got {fs}")
    nf, ladder = on_host(_cqt_plan, fs, fmin, n_bins, bins_per_octave, window, filter_scale,
                         n_fft, "highest band {top:.2f} Hz reaches Nyquist ({nyquist:.2f} "
                         "Hz) — lower n_bins or raise fs")
    x = x.to(complex_dtype(config.dtype)) if x.is_complex() else x.to(config.dtype)
    Kt = host_table("cqt.kernel", _kernel_table, ladder, like=x, dtype=complex_dtype(config.dtype))
    if center:
        x = pad_last(x, nf // 2, nf // 2)
    t = x.shape[-1]
    if t < nf:
        x = pad_last(x, 0, nf - t)
    frames = _frame(x, nf, hop)  # (…, n_frames, nf)
    spec = fft(frames, config=config)
    with matmul_precision(config.op_precision):
        return spec @ Kt


def _icqt_dual_kernel(
    fs: float,
    fmin: float,
    n_bins: int,
    bins_per_octave: int,
    window,
    filter_scale: float,
    n_fft,
    reg: float,
):
    """Host dual (synthesis) kernel P = K̂ᴴ(K̂K̂ᴴ + εI)⁻¹: the minimum-norm
    frame spectrum consistent with a CQT row.  (nf, n_bins) complex128 +
    nf."""
    Khat, nf = _cqt_spectral_kernel(
        fs, fmin, n_bins, bins_per_octave, window, filter_scale, n_fft
    )
    G = Khat @ np.conj(Khat.T)  # (n_bins, n_bins) Gram
    G = G + reg * np.eye(n_bins) * np.trace(G).real / n_bins
    P = np.conj(Khat.T) @ np.linalg.inv(G)
    return P, nf


def icqt(
    C,
    *,
    fs: float = 22050.0,
    fmin: float = 32.703195662574764,
    n_bins: Optional[int] = None,
    bins_per_octave: int = 12,
    hop: int = 512,
    window="hann",
    filter_scale: float = 1.0,
    length: Optional[int] = None,
    n_fft: Optional[int] = None,
    reg: float = 1e-6,
    n_iter: int = 0,
    config: SpectralConfig = DEFAULT_CONFIG,
) -> Tensor:
    """Approximate inverse CQT: (…, n_frames, n_bins) coefficients -> real
    signal.

    Per frame, the minimum-norm spectrum consistent with the CQT row is
    recovered through the host-precomputed dual kernel
    P = K̂ᴴ(K̂K̂ᴴ + εI)⁻¹ (one dense product), inverted to a time frame
    (2·Re ifft — the kernels are analytic, so the Hermitian half is
    implied), and frames are averaged by overlap-add.  Exact only on the
    subspace the Q-band kernels span (a log-frequency bandpass): energy
    outside [fmin, fmax] and the sub-frame fine structure the hop discards
    cannot return — same contract as librosa.icqt.  Pass the ``length`` of
    the original signal to crop the centered padding.  ``n_iter`` > 0 runs
    Landweber refinement y <- y + icqt(C - cqt(y)), a plain loop of one
    cqt and one dual product an iteration."""
    C = as_tensor(C)
    if C.ndim < 2:
        raise ValueError("C must be (…, n_frames, n_bins)")
    nb = C.shape[-1] if n_bins is None else int(n_bins)
    if C.shape[-1] != nb:
        raise ValueError(f"C has {C.shape[-1]} bins, expected {nb}")
    if hop < 1:
        raise ValueError(f"hop must be >= 1, got {hop}")
    if not isinstance(window, (str, tuple)):
        raise ValueError("icqt needs a hashable window spec (str or tuple)")
    nf, ladder = on_host(_cqt_plan, fs, fmin, nb, bins_per_octave, window, filter_scale, n_fft,
                         "band ladder reaches Nyquist — see cqt()")
    C = C.to(_CDTYPE)
    Pt = host_table("icqt.dual", _dual_table, ladder, float(reg), like=C, dtype=_CDTYPE)
    n_frames = C.shape[-2]
    with matmul_precision(config.op_precision):
        spec = C @ Pt  # (…, n_frames, nf) analytic spectra
    frames = 2.0 * torch.real(ifft(spec, config=config))  # Hermitian half implied
    # rectangular overlap-add, averaged by per-sample coverage
    t_padded = nf + (n_frames - 1) * hop
    idx = host_table("icqt.ola", _ola_table, nf, hop, n_frames, 0, like=frames, dtype=torch.int64)
    batch = frames.shape[:-2]
    out = frames.new_zeros((*batch, t_padded))
    out = out.index_add(-1, idx, frames.reshape(*batch, -1))
    out = out * host_table("icqt.ola", _ola_table, nf, hop, n_frames, 1, like=frames, dtype=DTYPE)
    out = out[..., nf // 2 : t_padded - nf // 2]  # undo cqt's center pad
    if length is not None:
        out = out[..., : int(length)]
    if n_iter > 0:
        kw = dict(
            fs=fs, fmin=fmin, bins_per_octave=bins_per_octave, hop=hop,
            window=window, filter_scale=filter_scale, n_fft=n_fft,
        )
        for _ in range(n_iter):
            r = C - cqt(out, n_bins=nb, center=True, config=config, **kw)[
                ..., : C.shape[-2], :
            ]
            out = out + icqt(
                r, n_bins=nb, length=out.shape[-1], reg=reg, n_iter=0,
                config=config, **kw,
            )
    return out
