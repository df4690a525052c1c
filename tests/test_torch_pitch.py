"""PyTorch port: the pitch path (``yin``, ``pyin`` of ``ops/mel.py`` and
``stft.pitch_shift``) against the JAX package on the same inputs.

The signals have a clear pitch (tones, harmonic stacks, a chirp, tones with
silent gaps), so the argmax/argmin picks and the Viterbi path do not sit on
ties: index outputs (the voicing flags) are equal, f0 agrees to 1e-4
relative (the parabolic refinement divides small fp32 differences), the
voicing probability to 1e-4 absolute.  ``pitch_shift`` runs the phase
vocoder, whose accumulated phase is compared at the vocoder's own tolerance
in ``test_torch_stft``; here it is held to the pitch it produces and, on
noise, to the JAX output at 2e-3."""

import numpy as np
import pytest
import torch

import mixed_radix_fast_fourier_transform_tpu as sp

import mixed_radix_fast_fourier_transform_tpu_torch as tp

torch.set_num_threads(1)

F0_TOL = 1e-4


def _np(v):
    return v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


SR = 8000.0


def _tone(f, n=6000, harmonics=1):
    t = np.arange(n) / SR
    return sum(np.sin(2 * np.pi * f * (h + 1) * t) / (h + 1) for h in range(harmonics)).astype(np.float32)


def _chirp(n=8000):
    t = np.arange(n) / SR
    f = 150.0 + 100.0 * t / t[-1]
    return np.sin(2 * np.pi * np.cumsum(f) / SR).astype(np.float32)


@pytest.mark.parametrize("signal", ["tone", "harmonic", "chirp", "batch"])
def test_yin(signal):
    x = {"tone": _tone(220.0), "harmonic": _tone(180.0, harmonics=4), "chirp": _chirp(),
         "batch": np.stack([_tone(150.0), _tone(310.0, harmonics=3)])}[signal]
    kw = dict(fmin=80.0, fmax=500.0, sr=SR, frame_length=1024)
    want = np.asarray(sp.yin(x, **kw))
    got = _np(tp.yin(_t(x), **kw))
    assert got.shape == want.shape
    assert np.max(np.abs(got - want) / want) <= F0_TOL
    if signal == "tone":
        assert abs(np.median(got) - 220.0) < 1.0
    if signal == "chirp":
        assert abs(got[3] - 155.0) < 12.0 and abs(got[-4] - 245.0) < 12.0


def test_yin_options_and_errors():
    x = _tone(200.0)
    kw = dict(fmin=100.0, fmax=400.0, sr=SR, frame_length=512, win_length=200, hop=100,
              trough_threshold=0.2, center=False)
    want = np.asarray(sp.yin(x, **kw))
    assert np.max(np.abs(_np(tp.yin(_t(x), **kw)) - want) / want) <= F0_TOL
    for bad in (dict(fmin=0.0, fmax=400.0), dict(fmin=100.0, fmax=5000.0),
                dict(fmin=100.0, fmax=400.0, frame_length=512, win_length=512),
                dict(fmin=100.0, fmax=400.0, hop=0), dict(fmin=5.0, fmax=6.0, frame_length=64)):
        with pytest.raises(ValueError):
            tp.yin(_t(x), sr=SR, **bad)
    with pytest.raises(ValueError):
        tp.yin(_t(x).to(torch.complex64), 100.0, 400.0, SR)


@pytest.mark.parametrize("signal", ["gaps", "noisy", "batch"])
def test_pyin(signal):
    rng = np.random.default_rng(3)
    if signal == "gaps":
        x = _tone(220.0, 12000)
        x[3000:5000] = 0.0
        x[9000:10000] = 0.0
    elif signal == "noisy":
        x = _tone(180.0, 10000, harmonics=3) + 0.05 * rng.standard_normal(10000).astype(np.float32)
    else:
        x = np.stack([_tone(150.0, 8000), _chirp(8000)])
    kw = dict(fmin=80.0, fmax=500.0, sr=SR, frame_length=1024, resolution=0.25)
    f0_w, voiced_w, prob_w = (np.asarray(v) for v in sp.pyin(x, **kw))
    f0, voiced, prob = (_np(v) for v in tp.pyin(_t(x), **kw))
    assert voiced.dtype == np.bool_ and np.array_equal(voiced, voiced_w)
    assert np.max(np.abs(prob - prob_w)) <= 1e-4
    assert np.array_equal(np.isnan(f0), np.isnan(f0_w))
    ok = ~np.isnan(f0_w)
    assert ok.any() and np.max(np.abs(f0[ok] - f0_w[ok]) / f0_w[ok]) <= F0_TOL
    if signal == "gaps":
        assert not voiced[..., 17:22].any() and voiced[..., 3:10].all()
        assert abs(np.nanmedian(f0) - 220.0) < 1.5


def test_pyin_options_and_errors():
    x = _tone(300.0, 5000, harmonics=2)
    kw = dict(fmin=100.0, fmax=600.0, sr=SR, frame_length=512, hop=128, switch_prob=0.05,
              max_semitones_per_frame=6.0, fill_unvoiced=0.0, center=False)
    want = [np.asarray(v) for v in sp.pyin(x, **kw)]
    got = [_np(v) for v in tp.pyin(_t(x), **kw)]
    assert np.array_equal(got[1], want[1])
    assert np.max(np.abs(got[0] - want[0]) / np.maximum(want[0], 1.0)) <= F0_TOL
    with pytest.raises(ValueError):
        tp.pyin(_t(x), 100.0, 600.0, SR, switch_prob=0.0)
    with pytest.raises(ValueError):
        tp.pyin(_t(x), 100.0, 600.0, SR, resolution=0.0)


def test_pitch_shift_octave_and_against_jax(rng):
    sr = 22050.0
    t = np.arange(32768) / sr
    x = np.sin(2 * np.pi * 440 * t).astype(np.float32)
    y = _np(tp.pitch_shift(_t(x), sr, 12.0, nperseg=1024))
    assert y.shape == x.shape
    core = y[4096:-4096] * np.hanning(len(y) - 8192)
    f_rec = np.argmax(np.abs(np.fft.rfft(core))) * sr / (len(y) - 8192)
    assert abs(f_rec - 880.0) < 10.0, f_rec
    noise = rng.standard_normal((2, 6000)).astype(np.float32)
    want = np.asarray(sp.pitch_shift(noise, sr, -3.0, nperseg=512))
    got = _np(tp.pitch_shift(_t(noise), sr, -3.0, nperseg=512))
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) / np.max(np.abs(want)) <= 2e-3
    up = _np(tp.pitch_shift(_t(noise), sr, 5.0, bins_per_octave=24, nperseg=512))
    assert up.shape == noise.shape    # a shorter resampled signal is zero-padded back
    with pytest.raises(ValueError):
        tp.pitch_shift(_t(x), sr, 1.0, bins_per_octave=0)
