"""PyTorch port: ``ops/feature.py`` against the JAX package on the same
inputs.

Tolerance: 1e-5 of the output's maximum for the spectral descriptors,
chroma, onsets, deltas, the dB conversions, ``tonnetz``, ``gcc_phat`` and
the CQT chroma (fp32 sums over one frame in either package); 2e-4 absolute
for ``lpc`` (the JAX package's own test tolerance against its float64 Burg
oracle, ``tests/test_feature.py``).  ``spectral_flatness`` and
``spectral_contrast`` take the log of the weakest bins, whose fp32 error is
relative to their frame's strongest bin: 2e-4.  The chroma filterbank is a
host table, bit-equal.  Data-dependent choices are compared on structured
input (a click track for ``tempo`` and ``beat_track``, tones for
``spectral_rolloff``), where one fp32 evaluation cannot flip them.

Random draws: ``decompose`` and ``specaugment`` take a ``torch.Generator``
where the JAX functions take a PRNG key.  ``decompose`` is held on the same
numbers by handing the JAX function's own initial factors to the port's
``_decompose_from`` (1e-4: 20 multiplicative updates of fp32 products);
``specaugment`` on its mask law (widths within their bounds, at most
``n_masks`` bands an axis, one mask per batch entry) and on applying the JAX
function's own draws through ``_specaugment_masks``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mixed_radix_fast_fourier_transform_tpu as sp

import mixed_radix_fast_fourier_transform_tpu_torch as tp
from mixed_radix_fast_fourier_transform_tpu_torch.ops import feature as tfeat

torch.set_num_threads(1)

TOL = 1e-5
FLATNESS_TOL = 2e-4
DECOMPOSE_TOL = 1e-4
SR = 22050.0


def _np(v):
    return v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _rel(got, want):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _audio(n=8192, rows=2, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    tones = np.sin(2 * np.pi * np.array([[440.0], [1250.0]])[:rows] * t)
    return (tones + 0.05 * rng.standard_normal((rows, n))).astype(np.float32)


def _clicks(bpm=120.0, seconds=4.0):
    n = int(seconds * SR)
    x = np.zeros(n, np.float32)
    for t in np.arange(0.1, seconds, 60.0 / bpm):
        x[int(t * SR): int(t * SR) + 64] = np.hanning(64)
    return x + 0.01 * np.random.default_rng(3).standard_normal(n).astype(np.float32)


DESCRIPTORS = {
    "spectral_centroid": (dict(sr=SR, nperseg=512), TOL),
    "spectral_bandwidth": (dict(sr=SR, nperseg=512, p=3.0), TOL),
    "spectral_rolloff": (dict(sr=SR, nperseg=512, roll_percent=0.9), TOL),
    "spectral_flatness": (dict(nperseg=512), FLATNESS_TOL),
    "spectral_contrast": (dict(sr=SR, nperseg=512, n_bands=4), FLATNESS_TOL),
    "chroma_stft": (dict(sr=SR, nperseg=512, tuning=0.1), TOL),
    "rms": (dict(frame_length=512, hop=128), TOL),
    "zero_crossing_rate": (dict(frame_length=512, hop=128), TOL),
    "onset_strength": (dict(sr=SR, nperseg=512, n_mels=64), TOL),
}


@pytest.mark.parametrize("name", DESCRIPTORS)
def test_descriptors_from_the_signal(name):
    kw, tol = DESCRIPTORS[name]
    x = _audio()
    got = getattr(tp, name)(_t(x), **kw)
    assert got.device.type == "cpu"
    assert _rel(got, jax.jit(lambda v: getattr(sp, name)(v, **kw))(x)) <= tol


@pytest.mark.parametrize("name", ["spectral_centroid", "spectral_rolloff", "spectral_flatness", "chroma_stft",
                                  "rms"])
def test_descriptors_from_a_spectrogram(name):
    S = np.abs(np.random.default_rng(1).standard_normal((2, 20, 257))).astype(np.float32) + 0.01
    kw = {k: v for k, v in DESCRIPTORS[name][0].items() if k in ("sr",)}
    got = getattr(tp, name)(S=_t(S), **kw)
    assert _rel(got, jax.jit(lambda s: getattr(sp, name)(S=s, **kw))(S)) <= DESCRIPTORS[name][1]


def test_chroma_filterbank_bit_equal():
    for args in ((SR, 2048), (16000.0, 512, 24, 0.25), (SR, 1024, 12, 0.0, 4.0, 1.0)):
        got, want = tp.chroma_filterbank(*args), sp.chroma_filterbank(*args)
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_tempo_and_beat_track_of_a_click_track():
    x = _clicks()
    env = tp.onset_strength(_t(x), SR, 2048, 512)
    jenv = jax.jit(lambda v: sp.onset_strength(v, SR, 2048, 512))(x)
    assert _rel(env, jenv) <= TOL
    bpm = tp.tempo(onset_env=env, sr=SR, hop=512)
    assert float(bpm) == float(jax.jit(lambda e: sp.tempo(onset_env=e, sr=SR, hop=512))(jenv))
    got_bpm, beats = tp.beat_track(onset_env=env, sr=SR, hop=512)
    want_bpm, want_beats = jax.jit(lambda e: sp.beat_track(onset_env=e, sr=SR, hop=512))(jenv)
    assert float(got_bpm) == float(want_bpm) and abs(float(got_bpm) - 120.0) / 120.0 < 0.08
    assert np.array_equal(beats.numpy(), np.asarray(want_beats)) and int(beats.sum()) >= 8
    _, silent = tp.beat_track(torch.zeros(44100), SR)
    assert not bool(silent.any())


@pytest.mark.parametrize("kw", [dict(), dict(width=5, order=2, axis=-1)], ids=["default", "order2"])
def test_delta(kw):
    data = np.cumsum(np.random.default_rng(2).standard_normal((3, 40, 13)), axis=1).astype(np.float32)
    assert _rel(tp.delta(_t(data), **kw), jax.jit(lambda d: sp.delta(d, **kw))(data)) <= TOL


def test_decompose_from_the_jax_draws():
    S = np.abs(np.random.default_rng(4).standard_normal((64, 40))).astype(np.float32)
    k, n_iter, eps = 3, 20, 1e-10
    key = jax.random.PRNGKey(5)
    ka, kc = jax.random.split(key)
    scale = jnp.sqrt(jnp.mean(S) / k + eps)
    A0 = np.array(scale * jax.random.uniform(ka, (64, k), jnp.float32, 0.1, 1.0))
    C0 = np.array(scale * jax.random.uniform(kc, (k, 40), jnp.float32, 0.1, 1.0))
    A, C = tfeat._decompose_from(_t(S), _t(A0), _t(C0), n_iter, eps)
    jA, jC = jax.jit(lambda s: sp.decompose(s, k, n_iter, key=key, eps=eps))(S)
    assert _rel(A, jA) <= DECOMPOSE_TOL and _rel(C, jC) <= DECOMPOSE_TOL
    # the public function draws its own start from a torch.Generator
    gA, gC = tp.decompose(_t(S), k, n_iter, generator=torch.Generator().manual_seed(0))
    assert gA.shape == (64, k) and gC.shape == (k, 40) and bool((gA >= 0).all() and (gC >= 0).all())
    with pytest.raises(ValueError):
        tp.decompose(_t(S[None]))
    with pytest.raises(ValueError):
        tp.decompose(_t(S), 0)


def test_specaugment_mask_law_and_the_jax_draws():
    S = np.ones((3, 50, 40), np.float32)
    masked = tp.specaugment(_t(S), torch.Generator().manual_seed(1), n_freq_masks=2, freq_mask_width=6,
                            n_time_masks=1, time_mask_width=9, mask_value=-1.0)
    keep = (masked != -1.0).numpy()
    for b in range(3):
        freq_cut = ~keep[b].any(axis=0)           # bins masked in every frame
        time_cut = ~keep[b].any(axis=1)
        assert freq_cut.sum() <= 2 * 6 and time_cut.sum() <= 9
        assert np.array_equal(keep[b], ~(freq_cut[None, :] | time_cut[:, None]))
    assert not all(np.array_equal(keep[0], keep[b]) for b in (1, 2))   # independent per entry
    # the JAX function's own draws, applied through the port's mask helper
    key = jax.random.PRNGKey(2)
    kf, kt = jax.random.split(key)

    def draws(k, n, width, size):
        @jax.jit
        def draw(k):
            kw, ks = jax.random.split(k)
            w = jax.random.randint(kw, (3, n, 1), 0, width + 1)
            return w, (jax.random.uniform(ks, (3, n, 1))
                       * jnp.maximum(size - w, 1).astype(jnp.float32)).astype(jnp.int32)

        w, s = draw(k)
        return tfeat._specaugment_masks(_t(np.array(w)), _t(np.array(s)), size)

    keep = draws(kf, 2, 6, 40)[..., None, :] & draws(kt, 1, 9, 50)[..., :, None]
    want = jax.jit(lambda s: sp.specaugment(s, key, n_freq_masks=2, freq_mask_width=6, n_time_masks=1,
                                            time_mask_width=9))(S)
    assert np.array_equal(torch.where(keep, _t(S), torch.zeros(())).numpy(), np.asarray(want))
    assert torch.equal(tp.specaugment(_t(S), n_freq_masks=0, n_time_masks=0), _t(S))


def test_db_conversions_and_mu_law(rng):
    p = np.abs(rng.standard_normal((4, 30))).astype(np.float32) + 1e-3
    for fn, kw in (("power_to_db", dict()), ("power_to_db", dict(ref="max", top_db=None)),
                   ("amplitude_to_db", dict(ref=2.0)), ("db_to_power", dict()), ("db_to_amplitude", dict(ref=0.5))):
        want = jax.jit(lambda v: getattr(sp, fn)(v, **kw))(p)
        assert _rel(getattr(tp, fn)(_t(p), **kw), want) <= TOL, fn
    z = (p + 1j * p).astype(np.complex64)
    assert _rel(tp.power_to_db(_t(z)), sp.power_to_db(z)) <= TOL
    x = np.clip(rng.standard_normal(500), -1, 1).astype(np.float32)
    q = tp.mu_law_encode(_t(x))
    assert q.dtype == torch.int32 and np.array_equal(q.numpy(), np.asarray(sp.mu_law_encode(x)))
    assert _rel(tp.mu_law_decode(q), sp.mu_law_decode(np.asarray(q))) <= TOL


def test_trim_and_split_host_results():
    x = np.zeros(60000, np.float32)
    x[8000:18000] = np.sin(np.arange(10000) * 0.05)
    x[30000:35000] = 0.5 * np.sin(np.arange(5000) * 0.1)
    got, (s, e) = tp.trim(_t(x))
    want, (ws, we) = sp.trim(x)
    assert (s, e) == (ws, we) and np.array_equal(_np(got), np.asarray(want))
    assert np.array_equal(tp.split(_t(x)), sp.split(x))


def test_chroma_cqt_and_tonnetz():
    x = _audio(n=16384, rows=1)[0]
    kw = dict(sr=SR, n_octaves=4, fmin=65.40639132514966, bins_per_octave=24)
    got = tp.chroma_cqt(_t(x), **kw)
    assert _rel(got, jax.jit(lambda v: sp.chroma_cqt(v, **kw))(x)) <= TOL
    assert _rel(tp.tonnetz(chroma=got), sp.tonnetz(chroma=got.numpy())) <= TOL


@pytest.mark.parametrize("interp", [True, False])
def test_gcc_phat(rng, interp):
    x = rng.standard_normal((2, 1024)).astype(np.float32)
    y = np.roll(x, 7, axis=-1) + 0.1 * rng.standard_normal((2, 1024)).astype(np.float32)
    lag, cc = tp.gcc_phat(_t(x), _t(y), max_lag=32, interp=interp)
    if interp:
        jlag, jcc = jax.jit(lambda a, b: sp.gcc_phat(a, b, max_lag=32))(x, y)
        assert _rel(cc, jcc) <= TOL and np.max(np.abs(_np(lag) - np.asarray(jlag))) <= 1e-4
    else:   # the integer lag is the correlation's peak
        assert np.array_equal(_np(lag), np.argmax(_np(cc), -1) - 32.0)
    assert np.all(np.abs(_np(lag) - 7.0) < 0.51)


def test_lpc(rng):
    y = rng.standard_normal((2, 3, 400)).astype(np.float32)
    for axis in (-1, 1):
        got = tp.lpc(_t(np.moveaxis(y, -1, axis).copy()), 6, axis=axis)
        want = jax.jit(lambda v: sp.lpc(v, 6, axis=axis))(np.moveaxis(y, -1, axis).copy())
        assert np.max(np.abs(_np(got) - np.asarray(want))) <= 2e-4
    assert np.array_equal(_np(tp.lpc(torch.zeros(64), 3)), [1.0, 0.0, 0.0, 0.0])
