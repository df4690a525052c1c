"""PyTorch port: the short-time family (stft, istft, spectrogram, griffinlim,
phase_vocoder, time_stretch) against the JAX package on the same inputs, on
both ``use_kernel`` routes.

Tolerance: 1e-5 of the output's maximum, except where stated: the phase
vocoder wraps phase differences with a ``round`` and accumulates them over
frames in fp32, so its outputs compare at 2e-4; and where a bin's magnitude
all but vanishes in some frame its angle is rounding noise that the
accumulation carries into every later frame, in either package, so
``time_stretch`` as a whole is compared on noise, whose bins stay well away
from zero, and on tones by its pitch only."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal
import torch

import mixed_radix_fast_fourier_transform_tpu as sp

import mixed_radix_fast_fourier_transform_tpu_torch as tp
from mixed_radix_fast_fourier_transform_tpu_torch.ops import stft as tstft  # the module

torch.set_num_threads(1)

TOL = 1e-5
VOCODER_TOL = 2e-4
ROUTES = {"kernel": tp.SpectralConfig(use_kernel=True), "pipeline": tp.SpectralConfig(use_kernel=False)}


def _rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


def _signal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# (nperseg, noverlap, window, center)
STFT_CASES = [
    (128, 64, "hann", True), (256, 192, "hann", True), (128, 96, "hamming", True),
    (90, 45, ("kaiser", 8.0), True), (64, 0, "boxcar", False), (100, 75, "hamming", False),
    (63, 31, "hann", True),
]


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("nperseg,noverlap,window,center", STFT_CASES,
                         ids=[f"{c[0]}-{c[1]}-{c[3]}" for c in STFT_CASES])
def test_stft_and_istft_match_jax(rng, route, nperseg, noverlap, window, center):
    x = _signal(rng, 2, 1500)
    want = np.asarray(sp.stft(x, nperseg, noverlap, window, center=center))
    got = tp.stft(torch.from_numpy(x), nperseg, noverlap, window, center=center,
                  config=ROUTES[route])
    assert got.dtype == torch.complex64 and _rel(got, want) <= TOL
    back = tp.istft(got, nperseg, noverlap, window, center=center, length=1500,
                    config=ROUTES[route])
    want_back = np.asarray(sp.istft(want, nperseg, noverlap, window, center=center,
                                    length=1500))
    assert _rel(back, want_back) <= TOL


def test_stft_matches_scipy(rng):
    """scipy.signal.stft with no detrending, reflect ("even") padding and
    scaling by the window's sum is this STFT divided by that sum."""
    x = _signal(rng, 2048).astype(np.float64)
    got = tp.stft(torch.from_numpy(x), 256, 192).numpy()
    win = scipy.signal.get_window("hann", 256)
    _, _, want = scipy.signal.stft(x, window=win, nperseg=256, noverlap=192,
                                   boundary="even", padded=True)
    want = want.T * win.sum()
    assert _rel(got[: want.shape[0]], want) <= TOL


def test_round_trip_and_batch(rng):
    x = _signal(rng, 3, 2, 2000)
    s = tp.stft(torch.from_numpy(x), 256, 192)
    assert s.shape == (3, 2, 1 + -(-2000 // 64), 129)
    assert _rel(tp.istft(s, 256, 192, length=2000), x) <= TOL


def test_reflect_padding_longer_than_the_signal(rng):
    x = _signal(rng, 40)
    want = np.asarray(sp.stft(x, 128, 64))
    assert _rel(tp.stft(torch.from_numpy(x), 128, 64), want) <= TOL


@pytest.mark.parametrize("power", [1.0, 2.0, 0.5])
def test_spectrogram_matches_jax(rng, power):
    x = _signal(rng, 2, 1024)
    want = np.asarray(sp.spectrogram(x, 128, power=power))
    got = tp.spectrogram(torch.from_numpy(x), 128, power=power)
    assert got.dtype == torch.float32 and _rel(got, want) <= TOL


def test_errors():
    x = torch.zeros(512)
    with pytest.raises(ValueError):
        tp.stft(x, nperseg=128, noverlap=128)
    with pytest.raises(ValueError):
        tp.stft(torch.zeros(16), nperseg=128, center=False)
    with pytest.raises(ValueError):
        tp.stft(torch.zeros(512, dtype=torch.complex64))
    with pytest.raises(ValueError):
        tp.griffinlim(torch.zeros(4, 100), nperseg=256)
    with pytest.raises(ValueError):
        tp.griffinlim(torch.zeros(4, 129, dtype=torch.complex64), nperseg=256)
    with pytest.raises(ValueError):
        tp.griffinlim(torch.zeros(4, 129), nperseg=256, n_iter=0)
    with pytest.raises(ValueError):
        tp.griffinlim(torch.zeros(4, 129), nperseg=256, momentum=1.0)
    with pytest.raises(ValueError):
        tp.griffinlim(torch.ones(1, 129), nperseg=256)
    with pytest.raises(ValueError):
        tp.griffinlim(torch.ones(33, 129), nperseg=256, length=100)
    with pytest.raises(ValueError):
        tp.griffinlim(torch.ones(33, 129), nperseg=256, length=99999)
    with pytest.raises(ValueError):
        tp.phase_vocoder(torch.zeros(4, 129), 1.5)
    with pytest.raises(ValueError):
        tp.phase_vocoder(torch.zeros(4, 129, dtype=torch.complex64), 0.0)
    with pytest.raises(ValueError):
        tp.time_stretch(torch.zeros(4096), -1.0)
    with pytest.raises(ValueError):   # pitch_shift came with ops/signal.py's resampler
        tstft.pitch_shift(torch.zeros(4096), 22050.0, 1.0, bins_per_octave=0)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("n_iter", [2, 4])
def test_griffinlim_loop_matches_jax_from_its_draw(rng, route, n_iter):
    """The JAX package draws the initial phase with ``jax.random``, which
    torch cannot reproduce: the test makes that draw itself and hands the
    port's loop the same initial spectrum.  Few iterations: every round
    re-normalises by the spectrum's magnitude, which amplifies fp32
    differences between the two packages."""
    nperseg, noverlap = 128, 96
    x = _signal(rng, 2048)
    mag = np.abs(np.asarray(sp.stft(x, nperseg, noverlap)))
    want = np.asarray(sp.griffinlim(mag, n_iter, nperseg, noverlap, seed=3))
    ph = jax.random.uniform(jax.random.PRNGKey(3), mag.shape, jnp.float32, 0.0,
                            2.0 * float(np.pi))
    spec0 = torch.from_numpy(np.asarray(mag * jnp.cos(ph) + 1j * (mag * jnp.sin(ph))))
    magt = torch.from_numpy(mag)
    n_frames = mag.shape[-2]
    config = ROUTES[route]
    sig_len = nperseg + (n_frames - 1) * (nperseg - noverlap) - nperseg

    def invert(spec):
        return tp.istft(spec, nperseg, noverlap, length=sig_len, config=config)

    def project(spec):
        return tp.stft(invert(spec), nperseg, noverlap, config=config)[..., :n_frames, :]

    got = invert(tstft._griffinlim_loop(magt, spec0, n_iter, 0.99, project))
    assert _rel(got, want) <= 1e-4


def test_griffinlim_converges_and_is_deterministic(rng):
    t = np.arange(4096) / 4096.0
    x = (np.sin(2 * np.pi * 220 * t) + 0.5 * np.sin(2 * np.pi * 523 * t)).astype(np.float32)
    mag = torch.abs(tp.stft(torch.from_numpy(x), 256))

    def convergence(n_iter):
        y = tp.griffinlim(mag, n_iter=n_iter, nperseg=256, seed=1)
        err = torch.abs(tp.stft(y, 256))[: mag.shape[0]] - mag
        return float(torch.linalg.norm(err) / torch.linalg.norm(mag))

    few, many = convergence(2), convergence(24)
    assert many < few and many < 0.2
    a = tp.griffinlim(mag, n_iter=3, nperseg=256, seed=5)
    b = tp.griffinlim(mag, n_iter=3, nperseg=256, generator=torch.Generator().manual_seed(5))
    assert torch.equal(a, b) and a.shape == (4096,)
    batched = tp.griffinlim(torch.stack([mag, mag])[:, :17], n_iter=2, nperseg=256,
                            length=2048)
    assert batched.shape == (2, 2048)


@pytest.mark.parametrize("rate", [0.8, 1.0, 1.5])
def test_phase_vocoder_matches_jax(rng, rate):
    t = np.arange(4096) / 4096.0
    x = (np.sin(2 * np.pi * 200 * t) + 0.3 * np.sin(2 * np.pi * 450 * t)).astype(np.float32)
    S = np.asarray(sp.stft(x, 512, 384))
    want = np.asarray(sp.phase_vocoder(S, rate, 128))
    got = tp.phase_vocoder(torch.from_numpy(S), rate, 128)
    assert got.dtype == torch.complex64 and _rel(got, want) <= VOCODER_TOL


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("rate", [0.75, 1.0, 1.25])
def test_time_stretch_matches_jax(route, rate):
    x = _signal(np.random.default_rng(7), 2, 4096)
    want = np.asarray(sp.time_stretch(x, rate, nperseg=512))
    got = tp.time_stretch(torch.from_numpy(x), rate, nperseg=512, config=ROUTES[route])
    assert _rel(got, want) <= VOCODER_TOL


def test_stretch_preserves_pitch():
    sr, f0 = 8192, 440.0
    x = np.sin(2 * np.pi * f0 * np.arange(sr) / sr).astype(np.float32)
    y = tp.time_stretch(torch.from_numpy(x), 1.25, nperseg=1024).numpy()
    spec = np.abs(np.fft.rfft(y * np.hanning(len(y))))
    assert abs(np.argmax(spec) * sr / len(y) - f0) < 5.0


def test_gradient_through_stft_and_istft(rng):
    """istft(stft(x)) is the identity, so d/dx of Σ w·istft(stft(x)) is w;
    the overlap-add's and the framing's backward run through the kernel's."""
    x = torch.from_numpy(_signal(rng, 1024)).requires_grad_(True)
    w = torch.from_numpy(_signal(rng, 1024))
    (tp.istft(tp.stft(x, 128, 96), 128, 96, length=1024) * w).sum().backward()
    assert _rel(x.grad, w.numpy()) <= 1e-4
