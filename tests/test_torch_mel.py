"""PyTorch port: ``ops/mel.py`` without the pitch trackers (mel scales and
filterbank, melspectrogram, mfcc and its inverses, mel_to_stft,
mel_to_audio, hpss, pcen, A_weighting) against the JAX package on the same
inputs.

Tolerance: 1e-5 of the output's maximum.  Host tables (scales, filterbank,
A-weighting) are bit-equal.  ``mfcc`` takes 10·log10 of band energies, so
it is compared at 1e-4 absolute dB per coefficient scale (2e-5 of the
maximum); ``mel_to_audio``/``mfcc_to_audio`` run Griffin-Lim from a random
phase drawn by each package's own generator, so they are compared by shape,
finiteness and the spectrum they reconstruct, as the JAX package's own tests
do."""

import jax
import numpy as np
import pytest
import torch

import mixed_radix_fast_fourier_transform_tpu as sp

import mixed_radix_fast_fourier_transform_tpu_torch as tp
from mixed_radix_fast_fourier_transform_tpu_torch.ops import mel as tmel

torch.set_num_threads(1)

TOL = 1e-5
ROUTES = {"kernel": tp.SpectralConfig(use_kernel=True), "pipeline": tp.SpectralConfig(use_kernel=False)}


def _np(v):
    return v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _rel(got, want):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_mel_scales_and_a_weighting_bit_equal():
    f = np.linspace(0, 11025, 57)
    for htk in (False, True):
        assert np.array_equal(tp.hz_to_mel(f, htk), sp.hz_to_mel(f, htk))
        m = sp.hz_to_mel(f, htk)
        assert np.array_equal(tp.mel_to_hz(m, htk), sp.mel_to_hz(m, htk))
        assert np.array_equal(tp.mel_frequencies(40, 20.0, 8000.0, htk),
                              sp.mel_frequencies(40, 20.0, 8000.0, htk))
    with pytest.raises(ValueError):
        tp.mel_frequencies(0)
    assert np.array_equal(tp.A_weighting(f), sp.A_weighting(f))
    assert abs(tp.A_weighting(1000.0)[0]) < 0.01


@pytest.mark.parametrize("kw", [dict(sr=16000.0, n_fft=512, n_mels=40), dict(sr=16000.0, n_fft=400, n_mels=80),
                                dict(sr=22050.0, n_fft=1024, n_mels=64, fmin=50.0, fmax=8000.0, htk=True, norm=None),
                                dict(sr=8000.0, n_fft=255, n_mels=20, dtype=np.float64)], ids=str)
def test_mel_filterbank_bit_equal(kw):
    got, want = tp.mel_filterbank(**kw), sp.mel_filterbank(**kw)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_mel_filterbank_errors():
    for kw in (dict(sr=16000.0, n_fft=1), dict(sr=16000.0, n_fft=512, n_mels=0),
               dict(sr=16000.0, n_fft=512, fmin=5000.0, fmax=100.0), dict(sr=16000.0, n_fft=512, fmax=9000.0),
               dict(sr=16000.0, n_fft=512, norm="bogus")):
        with pytest.raises(ValueError):
            tp.mel_filterbank(**kw)
    with pytest.raises(ValueError):
        tp.melspectrogram(torch.zeros(4000), 16000.0, 512, fmax=9000.0)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("kw", [dict(sr=16000.0, n_fft=512, hop=128, n_mels=40),
                                dict(sr=16000.0, n_fft=400, hop=160, n_mels=80),
                                dict(sr=8000.0, n_fft=256, n_mels=32, power=1.0, window="hamming", center=False,
                                     fmin=100.0, fmax=3500.0, htk=True, norm=None)], ids=["kws", "whisper", "opts"])
def test_melspectrogram(rng, route, kw):
    x = rng.standard_normal((2, 4000)).astype(np.float32)
    want = sp.melspectrogram(x, **kw)
    got = tp.melspectrogram(_t(x), config=ROUTES[route], **kw)
    assert got.dtype == torch.float32 and _rel(got, want) <= TOL


def test_melspectrogram_errors():
    with pytest.raises(ValueError):
        tp.melspectrogram(torch.zeros(4000, dtype=torch.complex64))
    with pytest.raises(ValueError):
        tp.melspectrogram(torch.zeros(4000), hop=0)


@pytest.mark.parametrize("kw", [dict(sr=16000.0, n_mfcc=13, n_fft=512, hop=128, n_mels=40),
                                dict(sr=16000.0, n_mfcc=20, n_fft=400, n_mels=64, lifter=22.0, top_db=None,
                                     fmin=50.0, fmax=7000.0)], ids=["plain", "lifter"])
def test_mfcc(rng, kw):
    x = rng.standard_normal((2, 4000)).astype(np.float32)
    assert _rel(tp.mfcc(_t(x), **kw), sp.mfcc(x, **kw)) <= 2e-5
    for bad in (dict(n_mfcc=0), dict(n_mfcc=200), dict(lifter=-1.0)):
        with pytest.raises(ValueError):
            tp.mfcc(_t(x), **bad)


@pytest.mark.parametrize("lifter,n_mfcc", [(0.0, 40), (22.0, 20), (2.0, 13)])
def test_mfcc_to_mel(rng, lifter, n_mfcc):
    x = rng.standard_normal((2, 4000)).astype(np.float32)
    # coefficients that the forward lifter produced: an exactly-zero lifter
    # entry (lifter 2) zeroed its coefficient, and must invert to 0, not NaN
    C = np.asarray(sp.mfcc(x, 16000.0, n_mfcc=n_mfcc, n_fft=512, n_mels=40, lifter=lifter))
    want = sp.mfcc_to_mel(C, n_mels=40, lifter=lifter)
    got = tp.mfcc_to_mel(_t(C), n_mels=40, lifter=lifter)
    assert torch.isfinite(got).all() and _rel(got, want) <= 5e-5   # 10^(dB/10) of fp32 dB
    with pytest.raises(ValueError):
        tp.mfcc_to_mel(_t(C[0, 0]))
    with pytest.raises(ValueError):
        tp.mfcc_to_mel(_t(C), n_mels=5)
    with pytest.raises(ValueError):
        tp.mfcc_to_mel(_t(C), n_mels=40, lifter=-1.0)


@pytest.mark.parametrize("n_iter,power", [(0, 2.0), (8, 2.0), (16, 1.0)])
def test_mel_to_stft(rng, n_iter, power):
    x = rng.standard_normal((2, 3000)).astype(np.float32)
    kw = dict(sr=16000.0, n_fft=256)
    M = np.asarray(sp.melspectrogram(x, n_mels=48, power=power, **kw))
    want = sp.mel_to_stft(M, power=power, n_iter=n_iter, **kw)
    got = tp.mel_to_stft(_t(M), power=power, n_iter=n_iter, **kw)
    assert _rel(got, want) <= 2e-5   # 2·n_iter fp32 matmuls in another summation order
    with pytest.raises(ValueError):
        tp.mel_to_stft(_t(M).to(torch.complex64))
    with pytest.raises(ValueError):
        tp.mel_to_stft(_t(M[0, 0]))
    with pytest.raises(ValueError):
        tp.mel_to_stft(_t(M), n_iter=-1)


def test_mel_to_audio_and_mfcc_to_audio_reconstruct_the_spectrum():
    sr, n_fft = 8000.0, 256
    t = np.arange(4096) / sr
    x = (np.sin(2 * np.pi * 440 * t) + 0.5 * np.sin(2 * np.pi * 1200 * t)).astype(np.float32)
    M = tp.melspectrogram(_t(x), sr, n_fft, n_mels=64)
    y = tp.mel_to_audio(M, sr, n_fft, n_iter_nnls=16, n_iter_gl=8, length=4096)
    y_jax = np.asarray(sp.mel_to_audio(_np(M), sr, n_fft, n_iter_nnls=16, n_iter_gl=8, length=4096))
    assert y.shape == y_jax.shape == (4096,) and torch.isfinite(y).all()
    spec = np.abs(np.fft.rfft(_np(y) * np.hanning(4096)))
    assert abs(np.argmax(spec) * sr / 4096 - 440.0) < 20.0
    C = tp.mfcc(_t(x), sr, n_mfcc=40, n_fft=n_fft, n_mels=40)
    z = tp.mfcc_to_audio(C, sr, n_fft, n_mels=40, n_iter_nnls=8, n_iter_gl=4)
    assert z.ndim == 1 and torch.isfinite(z).all()
    spec = np.abs(np.fft.rfft(_np(z)))
    assert abs(np.argmax(spec) * sr / z.shape[0] - 440.0) < 40.0


def test_median_filter_matches_the_jax_gather(rng):
    from mixed_radix_fast_fourier_transform_tpu.ops import mel as jmel

    x = rng.standard_normal((2, 9, 14)).astype(np.float32)
    for size, axis in ((3, -1), (7, -2), (17, -2), (27, -1), (4, -1)):
        want = np.asarray(jmel._median_filter_axis(x, size, axis))
        assert np.array_equal(_np(tmel._median_filter_axis(_t(x), size, axis)), want) or \
            _rel(tmel._median_filter_axis(_t(x), size, axis), want) <= 1e-7


@pytest.mark.parametrize("kw", [dict(), dict(kernel_size=(9, 5), power=1.0, margin=(1.0, 2.0)),
                                dict(kernel_size=7, power=np.inf, margin=1.5)], ids=["default", "pairs", "hard"])
def test_hpss(rng, kw):
    S = np.abs(rng.standard_normal((2, 40, 33))).astype(np.float32)
    got, want = tp.hpss(_t(S), **kw), sp.hpss(S, **kw)
    assert _rel(got[0], want[0]) <= TOL and _rel(got[1], want[1]) <= TOL
    Z = (S * np.exp(1j * rng.uniform(0, 6, S.shape))).astype(np.complex64)
    got, want = tp.hpss(_t(Z), **kw), sp.hpss(Z, **kw)
    assert got[0].dtype == torch.complex64
    assert _rel(got[0], want[0]) <= TOL and _rel(got[1], want[1]) <= TOL


def test_hpss_errors():
    S = torch.ones(10, 10)
    for kw in (dict(kernel_size=4), dict(margin=0.5), dict(kernel_size=(3, 0))):
        with pytest.raises(ValueError):
            tp.hpss(S, **kw)
    with pytest.raises(ValueError):
        tp.hpss(torch.ones(10))
    with pytest.raises(ValueError):
        tp.hpss(torch.ones(1, 10))


@pytest.mark.parametrize("kw", [dict(), dict(sr=16000.0, hop=160, gain=0.8, bias=10.0, power=0.25, time_constant=0.06),
                                dict(b=0.025, eps=1e-3)], ids=["default", "options", "b"])
def test_pcen(rng, kw):
    S = (np.abs(rng.standard_normal((2, 60, 20))) * 10).astype(np.float32)
    assert _rel(tp.pcen(_t(S), **kw), sp.pcen(S, **kw)) <= TOL


def test_pcen_per_band_coefficients_first_step_and_gradients(rng):
    S = (np.abs(rng.standard_normal((3, 50, 8))) + 0.1).astype(np.float32)
    per = {k: rng.uniform(lo, hi, 8).astype(np.float32)
           for k, (lo, hi) in dict(gain=(0.5, 1.0), bias=(1.0, 3.0), power=(0.3, 0.7), b=(0.01, 0.2)).items()}
    want = sp.pcen(S, **per)
    tens = {k: _t(v).requires_grad_() for k, v in per.items()}
    St = _t(S).requires_grad_()
    got = tp.pcen(St, **tens)
    assert _rel(got, want) <= TOL
    # the carry starts at the first frame and consumes it too: M[0] = S[0]
    m0 = (S[:, 0] / (1e-6 + S[:, 0]) ** per["gain"] + per["bias"]) ** per["power"] - per["bias"] ** per["power"]
    assert _rel(got[:, 0], m0) <= TOL
    got.sum().backward()
    import jax
    grads = jax.grad(lambda s, p: sp.pcen(s, **p).sum(), argnums=(0, 1))(S, per)
    assert _rel(St.grad, grads[0]) <= 1e-4          # 50 steps of a recurrence, backwards
    for k in per:
        assert _rel(tens[k].grad, grads[1][k]) <= 1e-4, k


@pytest.mark.parametrize("frames", [1, 129, 700])
def test_pcen_smoother_on_the_shared_scan_per_band_gradients(rng, frames, monkeypatch):
    """The smoother is one call of ``utils.scan.linear_recurrence`` whatever
    the number of frames (a frame count past one block of 128 runs two
    levels), with a per-band learned coefficient on the device; the output
    against the JAX ``pcen`` (1e-5) and the gradients of every per-band
    coefficient against a float64 loop (2e-4, the front end's bound)."""
    calls, scan = [], tmel.linear_recurrence
    monkeypatch.setattr(tmel, "linear_recurrence", lambda *a: calls.append(a[0]) or scan(*a))
    S = (np.abs(rng.standard_normal((2, frames, 6))) + 0.1).astype(np.float32)
    per = {k: rng.uniform(lo, hi, 6) for k, (lo, hi) in
           dict(gain=(0.5, 1.0), bias=(1.0, 3.0), power=(0.3, 0.7), b=(0.01, 0.2)).items()}
    leaves = {k: torch.tensor(v, dtype=torch.float32, requires_grad=True) for k, v in per.items()}
    got = tp.pcen(_t(S), **leaves)
    assert len(calls) == 1 and isinstance(calls[0], torch.Tensor)
    per32 = {k: v.astype(np.float32) for k, v in per.items()}
    assert _rel(got, jax.jit(lambda s: sp.pcen(s, **per32))(S)) <= TOL
    w = rng.standard_normal(S.shape)
    (got * _t(w).float()).sum().backward()
    l64 = {k: torch.tensor(v, requires_grad=True) for k, v in per.items()}
    S64 = _t(S).double()
    m, out = S64[:, 0], []
    for t in range(frames):
        m = (1.0 - l64["b"]) * m + l64["b"] * S64[:, t]
        out.append(m)
    M = torch.stack(out, dim=1)
    want = (S64 / (1e-6 + M) ** l64["gain"] + l64["bias"]) ** l64["power"] - l64["bias"] ** l64["power"]
    (want * _t(w)).sum().backward()
    for k in per:
        assert _rel(leaves[k].grad, l64[k].grad) <= 2e-4, k


def test_pcen_autograd_graph_does_not_grow_with_frames(rng):
    """No loop over frames: the backward graph of ``pcen`` with a learned
    coefficient grows with the scan's levels (log of the frames), not with
    the frames: ten times the frames adds a few nodes."""
    def nodes(frames):
        b = torch.full((4,), 0.05, requires_grad=True)
        out = tp.pcen(_t(np.abs(rng.standard_normal((1, frames, 4))).astype(np.float32)), b=b)
        seen, todo = set(), [out.grad_fn]
        while todo:
            fn = todo.pop()
            if fn is not None and fn not in seen:
                seen.add(fn)
                todo.extend(f for f, _ in fn.next_functions)
        return len(seen)

    assert nodes(300) <= nodes(3000) <= nodes(300) + 20


def test_pcen_errors():
    with pytest.raises(ValueError):
        tp.pcen(torch.ones(5))
    with pytest.raises(ValueError):
        tp.pcen(torch.ones(5, 5, dtype=torch.complex64))
    with pytest.raises(ValueError):
        tp.pcen(torch.ones(5, 5), time_constant=0.0)
    with pytest.raises(ValueError):
        tp.pcen(torch.ones(5, 5), hop=0)
