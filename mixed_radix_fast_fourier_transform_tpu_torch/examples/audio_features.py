"""Audio feature pipeline on the engine: CQT, mel/MFCC, multitaper PSD,
Griffin-Lim resynthesis and synchrosqueezing.

Counterpart of the JAX package's ``examples/audio_features.py``, on a
two-note "melody" (A4 with vibrato, then E5) over a noise floor.

Run: python -m mixed_radix_fast_fourier_transform_tpu_torch.examples.audio_features
"""

from __future__ import annotations

import numpy as np
import torch

from .. import cqt, cqt_frequencies, griffinlim, melspectrogram, mfcc, multitaper, ssq_cwt, stft
from ..utils.numerics import resolve_device, to_host

A4, E5 = 440.0, 660.0
SEMITONE = 2.0 ** (1.0 / 12.0)


def melody(fs: float = 22050.0, seconds: float = 2.0) -> np.ndarray:
    """A4 with a 5 Hz vibrato for the first half, E5 for the second, and a
    noise floor from seed 0."""
    t = np.arange(int(seconds * fs)) / fs
    half = seconds / 2
    return (
        np.sin(2 * np.pi * A4 * t + 3 * np.sin(2 * np.pi * 5 * t)) * (t < half)
        + 0.7 * np.sin(2 * np.pi * E5 * t) * (t >= half)
        + 0.02 * np.random.default_rng(0).standard_normal(t.size)
    ).astype(np.float32)


def main(*, device=None, fs: float = 22050.0, seconds: float = 2.0,
         griffinlim_iters: int = 32) -> dict:
    dev = resolve_device(device)
    sig_np = melody(fs, seconds)
    sig = torch.tensor(sig_np, device=dev)
    out = {}

    C = np.abs(to_host(cqt(sig, fs=fs, fmin=55.0, n_bins=60, hop=1024)))
    freqs = cqt_frequencies(60, 55.0, 12)
    first, second = C[: C.shape[0] // 2], C[C.shape[0] // 2:]
    out["cqt_peaks"] = (float(freqs[first.mean(0).argmax()]), float(freqs[second.mean(0).argmax()]))
    print(f"cqt: first half peaks at {out['cqt_peaks'][0]:.1f} Hz (A4=440), "
          f"second at {out['cqt_peaks'][1]:.1f} Hz (E5=660)")
    for got, note in zip(out["cqt_peaks"], (A4, E5)):
        assert note / SEMITONE < got < note * SEMITONE, out["cqt_peaks"]

    M = melspectrogram(sig, fs, n_mels=64)
    F = mfcc(sig, fs, n_mfcc=13)
    out["mel_shape"], out["mfcc_shape"] = tuple(M.shape), tuple(F.shape)
    print(f"melspectrogram {out['mel_shape']}, mfcc {out['mfcc_shape']}")
    assert torch.isfinite(M).all() and torch.isfinite(F).all()

    f, P = multitaper(sig, fs=fs, nw=4.0)
    f, P = to_host(f), to_host(P)
    out["multitaper_peak"] = float(f[P.argmax()])
    print(f"multitaper PSD peak at {out['multitaper_peak']:.1f} Hz")

    S = stft(sig, nperseg=512).abs()
    y = griffinlim(S, n_iter=griffinlim_iters, nperseg=512, length=sig.shape[-1])
    Sy = stft(y, nperseg=512).abs()
    out["griffinlim_convergence"] = float(torch.linalg.norm(Sy - S) / torch.linalg.norm(S))
    print(f"griffinlim resynthesis spectral convergence: {out['griffinlim_convergence']:.3f}")
    assert out["griffinlim_convergence"] < 1.0

    # synchrosqueezing pins each note to a single log-frequency ridge
    dec = sig[::4][:8192]  # fs/4 working rate
    Sq, sfreqs = ssq_cwt(dec, n_scales=96, fmin=0.002, fmax=0.45)
    mag = np.abs(to_host(Sq))
    sfreqs = to_host(sfreqs)
    half = mag.shape[-1] // 2
    k1 = int(mag[:, 400:half - 400].mean(-1).argmax())
    k2 = int(mag[:, half + 400:-400].mean(-1).argmax())
    out["ssq_ridges"] = (float(sfreqs[k1] * fs / 4), float(sfreqs[k2] * fs / 4))
    print(f"ssq_cwt note ridges: {out['ssq_ridges'][0]:.1f} Hz then "
          f"{out['ssq_ridges'][1]:.1f} Hz (440 / 660 expected)")
    for got, note in zip(out["ssq_ridges"], (A4, E5)):
        assert note / SEMITONE < got < note * SEMITONE, out["ssq_ridges"]
    return out


if __name__ == "__main__":
    main()
