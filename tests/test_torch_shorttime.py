"""PyTorch port: ``ops/shorttime.py`` (ShortTimeFFT, check_COLA, check_NOLA,
closest_STFT_dual_window, the fold algebra) against the JAX package on the
same inputs.

Tolerance: 1e-5 of the output's maximum for every transform; the host
window algebra (fold, canonical dual, closest dual, scale factors, index
geometry) is numpy float64 in both packages and compared bit for bit."""

import numpy as np
import pytest
import scipy.signal as ss
import torch

import mixed_radix_fast_fourier_transform_tpu as sp
from mixed_radix_fast_fourier_transform_tpu.ops import shorttime as jst

import mixed_radix_fast_fourier_transform_tpu_torch as tp
from mixed_radix_fast_fourier_transform_tpu_torch.ops import shorttime as tst

torch.set_num_threads(1)

TOL = 1e-5


def _rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30)


def _pair(win=None, hop=9, fs=100.0, **kw):
    if win is None:
        win = ss.windows.hann(32, sym=False)
    return tp.ShortTimeFFT(win, hop, fs, **kw), sp.ShortTimeFFT(win, hop, fs, **kw)


# ------------------------------------------------------------- window helpers

@pytest.mark.parametrize("window,nperseg,noverlap", [
    ("hann", 64, 32), ("hann", 64, 16), ("boxcar", 64, 0), ("bartlett", 64, 48),
    ("blackman", 60, 20), (("kaiser", 6.0), 48, 36),
])
def test_check_cola_and_nola(window, nperseg, noverlap):
    assert tp.check_COLA(window, nperseg, noverlap) == sp.check_COLA(window, nperseg, noverlap)
    assert tp.check_NOLA(window, nperseg, noverlap) == sp.check_NOLA(window, nperseg, noverlap)


def test_check_nola_failing_window_and_errors():
    w = np.zeros(32)
    w[:8] = 1.0  # hop 16 leaves empty residue classes
    assert tp.check_NOLA(w, 32, 16) is False and sp.check_NOLA(w, 32, 16) is False
    for fn in (tp.check_COLA, tp.check_NOLA):
        with pytest.raises(ValueError):
            fn("hann", 16, 16)
        with pytest.raises(ValueError):
            fn("hann", 0, 0)


@pytest.mark.parametrize("hop", [5, 8, 32])
def test_fold_algebra_bit_equal(rng, hop):
    x = rng.standard_normal(37)
    assert np.array_equal(tst._fold_residues(x, hop), jst._fold_residues(x, hop))
    s = rng.standard_normal(hop)
    assert np.array_equal(tst._expand_residues(s, 37), jst._expand_residues(s, 37))
    win = ss.windows.hann(40, sym=False) + 0.01
    assert np.array_equal(tst._canonical_dual(win, hop), jst._canonical_dual(win, hop))
    cwin = win * np.exp(0.3j * np.arange(40))
    assert np.array_equal(tst._canonical_dual(cwin, hop), jst._canonical_dual(cwin, hop))


def test_canonical_dual_errors():
    with pytest.raises(ValueError):
        tst._canonical_dual(np.ones(8), 9)
    with pytest.raises(ValueError):
        tst._canonical_dual(np.ones(8, np.int64), 4)
    w = np.zeros(32)
    w[:8] = 1.0
    with pytest.raises(ValueError):
        tst._canonical_dual(w, 16)


@pytest.mark.parametrize("scaled", [True, False])
@pytest.mark.parametrize("hop", [8, 12, 16])
def test_closest_dual_window_bit_equal(rng, scaled, hop):
    win = ss.windows.hann(48, sym=False)
    desired = rng.standard_normal(48) * 0.1 + 1.0
    got, a_got = tp.closest_STFT_dual_window(win, hop, desired, scaled=scaled)
    want, a_want = sp.closest_STFT_dual_window(win, hop, desired, scaled=scaled)
    assert np.array_equal(got, want) and a_got == a_want
    got, a_got = tp.closest_STFT_dual_window(win, hop)
    want, a_want = sp.closest_STFT_dual_window(win, hop)
    assert np.array_equal(got, want) and a_got == a_want


# ----------------------------------------------------------------- index math

@pytest.mark.parametrize("case", ["hann", "zero_padded", "hop_eq_win"])
def test_index_geometry_matches_jax(case):
    if case == "hann":
        ours, ref = _pair()
    elif case == "zero_padded":
        win = np.zeros(40)
        win[5:35] = ss.windows.hamming(30, sym=False)
        ours, ref = _pair(win=win, hop=7)
    else:
        ours, ref = _pair(win=ss.windows.hamming(16, sym=False), hop=16)
    n = 200
    for name in ("p_min", "k_min", "m_num", "m_num_mid", "f_pts", "delta_t", "delta_f",
                 "invertible", "fac_magnitude", "fac_psd", "hop", "fs", "T", "mfft",
                 "phase_shift", "fft_mode", "onesided_fft", "scaling"):
        assert getattr(ours, name) == getattr(ref, name), name
    for name in ("p_max", "k_max", "p_num", "upper_border_begin"):
        assert getattr(ours, name)(n) == getattr(ref, name)(n), name
    assert ours.lower_border_end() == ref.lower_border_end()
    assert ours.nearest_k_p(31) == ref.nearest_k_p(31)
    assert ours.nearest_k_p(31, left=False) == ref.nearest_k_p(31, left=False)
    assert ours.p_range(n, 2, 9) == ref.p_range(n, 2, 9)
    assert np.array_equal(ours.f, ref.f) and np.array_equal(ours.t(n), ref.t(n))
    assert ours.extent(n) == ref.extent(n)
    assert ours.extent(n, "ft", True) == ref.extent(n, "ft", True)
    assert np.array_equal(ours.win, ref.win) and np.array_equal(ours.dual_win, ref.dual_win)


def test_scale_to_constructors_and_setters():
    win = ss.windows.hann(32, sym=False)
    ours, ref = _pair(win=win, hop=8, fs=250.0)
    for o in (ours, ref):
        o.scale_to("psd")
    assert np.array_equal(ours.win, ref.win) and np.array_equal(ours.dual_win, ref.dual_win)
    assert ours.scaling == ref.scaling == "psd"
    ours.fs, ref.fs = 10.0, 10.0
    assert ours.T == ref.T
    ours.T, ref.T = 0.5, 0.5
    assert ours.fs == ref.fs == 2.0

    a = tp.ShortTimeFFT.from_window("hann", 1e3, 48, 36, scale_to="magnitude")
    b = sp.ShortTimeFFT.from_window("hann", 1e3, 48, 36, scale_to="magnitude")
    assert np.array_equal(a.win, b.win) and a.hop == b.hop
    dual = ss.windows.hamming(36, sym=False)
    a, b = tp.ShortTimeFFT.from_dual(dual, 9, 1.0), sp.ShortTimeFFT.from_dual(dual, 9, 1.0)
    assert np.array_equal(a.win, b.win) and np.array_equal(a.dual_win, b.dual_win)
    desired = ss.windows.hann(36, sym=False) + 0.1
    for scale in (None, "unitary", "psd"):
        a = tp.ShortTimeFFT.from_win_equals_dual(desired, 9, 1.0, scale_to=scale)
        b = sp.ShortTimeFFT.from_win_equals_dual(desired, 9, 1.0, scale_to=scale)
        assert np.array_equal(a.win, b.win) and np.array_equal(a.dual_win, b.dual_win)
        assert a.scaling == b.scaling


def test_validation_errors():
    win = ss.windows.hann(16, sym=False)
    with pytest.raises(ValueError):
        tp.ShortTimeFFT(win, 0, 1.0)
    with pytest.raises(ValueError):
        tp.ShortTimeFFT(win, 4, 1.0, mfft=8)
    with pytest.raises(ValueError):
        tp.ShortTimeFFT(win, 4, 1.0, fft_mode="bogus")
    with pytest.raises(ValueError):
        tp.ShortTimeFFT(win, 4, 1.0, fft_mode="onesided2X")  # needs scale_to
    with pytest.raises(ValueError):
        tp.ShortTimeFFT(win * 1j, 4, 1.0, fft_mode="onesided")
    s = tp.ShortTimeFFT(win, 4, 1.0)
    with pytest.raises(ValueError):
        s.stft(torch.zeros(100, dtype=torch.complex64))  # complex x with onesided
    with pytest.raises(ValueError):
        s.stft(torch.zeros(100), p0=0, p1=999)
    with pytest.raises(ValueError):
        s.stft(torch.zeros(100), padding="bogus")
    with pytest.raises(ValueError):
        s.istft(torch.zeros((5, 5), dtype=torch.complex64))  # wrong f_pts
    with pytest.raises(ValueError):
        s.stft_detrend(torch.zeros(100), "bogus")


# ------------------------------------------------------------------ transform

@pytest.mark.parametrize("fft_mode", ["twosided", "centered", "onesided", "onesided2X"])
@pytest.mark.parametrize("padding", ["zeros", "edge", "even", "odd"])
def test_stft_and_istft_match_jax(rng, fft_mode, padding):
    x = rng.standard_normal((2, 171)).astype(np.float32)
    kw = dict(fft_mode=fft_mode, scale_to="psd" if fft_mode == "onesided2X" else None)
    ours, ref = _pair(**kw)
    want = np.asarray(ref.stft(x, padding=padding))
    got = ours.stft(torch.from_numpy(x), padding=padding)
    assert got.dtype == torch.complex64 and _rel(got, want) <= TOL
    back_want = np.asarray(ref.istft(want, k1=171))
    back = ours.istft(torch.from_numpy(want), k1=171)
    assert _rel(back, back_want) <= TOL
    if padding == "zeros":
        assert _rel(back, x) <= 5e-5   # the round trip itself


def test_stft_matches_scipy_float64(rng):
    x = rng.standard_normal(171)
    ours = tp.ShortTimeFFT(ss.windows.hann(32, sym=False), 9, 100.0)
    ref = ss.ShortTimeFFT(ss.windows.hann(32, sym=False), 9, 100.0)
    for padding in ("zeros", "edge", "even", "odd"):
        assert _rel(ours.stft(torch.from_numpy(x), padding=padding),
                    ref.stft(x, padding=padding)) <= TOL


@pytest.mark.parametrize("ps", [0, None, 3, -5])
def test_stft_mfft_and_phase_shift(rng, ps):
    x = rng.standard_normal(100).astype(np.float32)
    win = ss.windows.hamming(20, sym=False)
    ours, ref = _pair(win=win, hop=5, fs=10.0, mfft=32, phase_shift=ps)
    want = np.asarray(ref.stft(x))
    assert _rel(ours.stft(torch.from_numpy(x)), want) <= TOL
    assert _rel(ours.istft(torch.from_numpy(want), k1=100),
                np.asarray(ref.istft(want, k1=100))) <= TOL


def test_stft_complex_input_and_complex_window(rng):
    x = (rng.standard_normal(90) + 1j * rng.standard_normal(90)).astype(np.complex64)
    for mode in ("twosided", "centered"):
        ours, ref = _pair(fft_mode=mode)
        want = np.asarray(ref.stft(x))
        assert _rel(ours.stft(torch.from_numpy(x)), want) <= TOL
        assert _rel(ours.istft(torch.from_numpy(want), k1=90),
                    np.asarray(ref.istft(want, k1=90))) <= TOL
    cwin = ss.windows.hann(32, sym=False) * np.exp(0.2j * np.arange(32))
    ours, ref = _pair(win=cwin, fft_mode="twosided")
    assert _rel(ours.stft(torch.from_numpy(x)), np.asarray(ref.stft(x))) <= TOL


def test_stft_slice_range_offset_and_axis(rng):
    x = rng.standard_normal((3, 140, 2)).astype(np.float32)
    ours, ref = _pair()
    want = np.asarray(ref.stft(x, p0=2, p1=10, k_offset=3, axis=1))
    got = ours.stft(torch.from_numpy(x), p0=2, p1=10, k_offset=3, axis=1)
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("detr", ["constant", "linear", "callable"])
def test_stft_detrend(rng, detr):
    x = (rng.standard_normal(130) + np.linspace(0, 4, 130)).astype(np.float32)
    ours, ref = _pair()
    if detr == "callable":
        want = np.asarray(ref.stft_detrend(x, lambda f: f - f[..., :1]))
        got = ours.stft_detrend(torch.from_numpy(x), lambda f: f - f[..., :1])
    else:
        want = np.asarray(ref.stft_detrend(x, detr))
        got = ours.stft_detrend(torch.from_numpy(x), detr)
    assert _rel(got, want) <= TOL


def test_spectrogram_and_cross(rng):
    x = rng.standard_normal(128).astype(np.float32)
    y = rng.standard_normal(128).astype(np.float32)
    ours, ref = _pair()
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    assert _rel(ours.spectrogram(xt), np.asarray(ref.spectrogram(x))) <= TOL
    assert _rel(ours.spectrogram(xt, yt), np.asarray(ref.spectrogram(x, y))) <= TOL
    assert _rel(ours.spectrogram(xt, detr="constant", padding="even"),
                np.asarray(ref.spectrogram(x, detr="constant", padding="even"))) <= TOL


@pytest.mark.parametrize("k0,k1", [(30, 130), (0, 100), (-8, 100), (-15, 150)])
def test_istft_k0_k1_window_batched(rng, k0, k1):
    x = rng.standard_normal((2, 3, 150)).astype(np.float32)
    ours, ref = _pair()
    S = np.asarray(ref.stft(x))
    k0 = max(k0, ref.k_min)
    want = np.asarray(ref.istft(S, k0=k0, k1=k1))
    assert _rel(ours.istft(torch.from_numpy(S), k0=k0, k1=k1), want) <= TOL


def test_istft_f_and_t_axes(rng):
    x = rng.standard_normal((4, 120)).astype(np.float32)
    ours, ref = _pair(fft_mode="twosided")
    S = np.asarray(ref.stft(x))
    Sp = np.ascontiguousarray(np.moveaxis(S, (-2, -1), (0, 1)))    # (f, t, batch)
    want = np.asarray(ref.istft(Sp, k1=120, f_axis=0, t_axis=1))
    assert _rel(ours.istft(torch.from_numpy(Sp), k1=120, f_axis=0, t_axis=1), want) <= TOL


def test_gradient_flows_through_stft(rng):
    x = torch.from_numpy(rng.standard_normal((2, 160)).astype(np.float32)).requires_grad_()
    ours, _ = _pair()
    loss = ours.spectrogram(x).sum()
    loss.backward()
    assert x.grad is not None and torch.isfinite(x.grad).all() and x.grad.abs().max() > 0
