"""PyTorch port: the radar and radio front end's transforms — ``ops/waveforms.py``,
``ops/radar.py`` and ``ops/pfb.py`` — against the JAX package (its
functions under ``jax.jit`` on the CPU) and against float64 numpy.

Tolerances: transforms 1e-5 of the output's maximum; the waveforms'
phases are float64 in both packages, so numpy input gives the JAX module's
float32 values exactly and a tensor (evaluated in float64 by torch) within
one float32 rounding; host constants (windows, prototypes) bit-equal.
CFAR thresholds 1e-5 relative, and detections equal wherever the power is
not within 1e-4 of its threshold.  Inputs come from a generator made for
each case."""

import jax
import numpy as np
import pytest
import torch

from mixed_radix_fast_fourier_transform_tpu.ops import pfb as jpfb
from mixed_radix_fast_fourier_transform_tpu.ops import radar as jradar
from mixed_radix_fast_fourier_transform_tpu.ops import waveforms as jwave

import mixed_radix_fast_fourier_transform_tpu_torch as tp
from mixed_radix_fast_fourier_transform_tpu_torch.ops import pfb as tpfb
from mixed_radix_fast_fourier_transform_tpu_torch.ops import waveforms as twave
from mixed_radix_fast_fourier_transform_tpu_torch.utils import numerics

torch.set_num_threads(1)

TOL = 1e-5


@pytest.fixture
def case_rng(request):
    return np.random.default_rng([ord(ch) for ch in request.node.name])


def _np(v):
    return v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _rel(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


def _cplx(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


# --------------------------------------------------------------------------- waveforms

WAVES = [
    ("chirp", dict(f0=5.0, t1=1.0, f1=200.0)),
    ("chirp", dict(f0=5.0, t1=1.0, f1=200.0, method="quadratic", phi=30.0)),
    ("chirp", dict(f0=5.0, t1=1.0, f1=200.0, method="quadratic", vertex_zero=False)),
    ("chirp", dict(f0=5.0, t1=1.0, f1=200.0, method="logarithmic")),
    ("chirp", dict(f0=5.0, t1=1.0, f1=200.0, method="hyperbolic")),
    ("sweep_poly", dict(poly=[30.0, -4.0, 2.0, 7.0])),
    ("gausspulse", dict(fc=50.0, bw=0.4)),
    ("sawtooth", dict(width=0.3)),
    ("square", dict(duty=0.7)),
]


@pytest.mark.parametrize("name,kw", WAVES, ids=[f"{n}-{i}" for i, (n, _) in enumerate(WAVES)])
def test_waveforms_match_the_jax_module(name, kw, monkeypatch):
    t = np.linspace(-0.2, 1.3, 2001)
    if name in ("sawtooth", "square"):
        t = t * 40.0
    want = np.asarray(getattr(jwave, name)(t, **kw))
    # a tensor is evaluated in float64 by torch on its own device
    got = getattr(tp, name)(torch.from_numpy(t), **kw)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    assert np.max(np.abs(got.numpy() - want)) <= 1.2e-7
    # numpy input: the same host float64 arithmetic as the JAX module,
    # then to the card (the CPU here)
    monkeypatch.setattr(twave, "as_tensor", lambda v: numerics.as_tensor(v, "cpu"))
    assert np.array_equal(getattr(tp, name)(t, **kw).numpy(), want)


def test_gausspulse_options_and_cutoff(monkeypatch):
    monkeypatch.setattr(twave, "as_tensor", lambda v: numerics.as_tensor(v, "cpu"))
    t = np.linspace(-0.05, 0.05, 501)
    got = tp.gausspulse(t, 80.0, 0.5, retquad=True, retenv=True)
    want = jwave.gausspulse(t, 80.0, 0.5, retquad=True, retenv=True)
    assert all(np.array_equal(g.numpy(), np.asarray(w)) for g, w in zip(got, want))
    assert tp.gausspulse("cutoff", 80.0) == jwave.gausspulse("cutoff", 80.0)
    with pytest.raises(ValueError):
        tp.chirp(t, 1.0, 0.0, 2.0)
    with pytest.raises(ValueError):
        tp.square(t, duty=1.5)


@pytest.mark.parametrize("shape,idx", [(8, None), ((4, 6), "mid"), ((5, 5), 2), ((3, 4), (1, 3))])
def test_unit_impulse(shape, idx):
    got = tp.unit_impulse(shape, idx, device="cpu")
    assert np.array_equal(got.numpy(), np.asarray(jwave.unit_impulse(shape, idx)))


# --------------------------------------------------------------------------- radar

def _echoes(rng, n_pulses, n, tx, delays, dopplers, amps):
    """Pulse train: each target a delayed copy of the pulse, phase-rotated
    pulse to pulse by its Doppler (cycles/pulse), plus complex noise."""
    rx = 0.05 * _cplx(rng, (n_pulses, n)).astype(np.complex128)
    for d, f, a in zip(delays, dopplers, amps):
        ph = np.exp(2j * np.pi * f * np.arange(n_pulses))
        rx[:, d: d + tx.size] += a * ph[:, None] * tx[None, :]
    return rx.astype(np.complex64)


def _lfm(nt):
    t = np.arange(nt) / nt
    return np.exp(1j * np.pi * 0.8 * nt * (t - 0.5) ** 2).astype(np.complex64)


@pytest.mark.parametrize("mode,window", [("valid", None), ("valid", "hamming"), ("full", "hann")])
def test_pulse_compression(case_rng, mode, window):
    tx = _lfm(24)
    rx = _cplx(case_rng, (3, 200))
    got = tp.pulse_compression(torch.from_numpy(rx), torch.from_numpy(tx), window, mode)
    want = jax.jit(lambda r: jradar.pulse_compression(r, tx, window, mode))(rx)
    assert _rel(got, want) <= TOL
    # float64: Σ_n rx[n+d]·conj(w·tx[n]) / Σ w·|tx|², every lag
    w = np.ones(24) if window is None else np.asarray(tp.get_window(window, 24), np.float64)
    ref = np.stack([np.correlate(r.astype(np.complex128), (w * tx).astype(np.complex128), "full")
                    for r in rx]) / np.sum(w * np.abs(tx) ** 2)
    ref = ref[:, 23: 200] if mode == "valid" else ref
    assert _rel(got, ref) <= TOL


def test_range_doppler_finds_the_targets(case_rng):
    tx = _lfm(32)
    delays, dops = [40, 150], [0.125, -0.25]
    rx = _echoes(case_rng, 16, 256, tx, delays, dops, [1.0, 0.7])
    got = tp.range_doppler(torch.from_numpy(rx), torch.from_numpy(tx), window="hamming")
    want = jax.jit(lambda r: jradar.range_doppler(r, tx, window="hamming"))(rx)
    assert got.shape == (16, 225) and _rel(got, want) <= TOL
    p = np.abs(got.numpy()) ** 2
    for d, f in zip(delays, dops):
        row = 8 + int(round(f * 16))
        assert p[row, d] == p[:, max(d - 3, 0): d + 4].max()


def _cfar_check(got, want, p):
    det, thr = got
    jdet, jthr = (np.asarray(v) for v in want)
    assert _rel(thr, jthr) <= TOL
    clear = np.abs(p - jthr) > 1e-4 * np.abs(jthr)
    assert np.array_equal(det.numpy()[clear], jdet[clear])


@pytest.mark.parametrize("method", ["ca", "go", "so", "os"])
def test_cfar_1d(case_rng, method):
    p = case_rng.exponential(1.0, (3, 300)).astype(np.float32)
    p[:, 100] += 40.0
    p[:, 220:240] += 5.0  # a clutter edge
    got = tp.cfar(torch.from_numpy(p), 8, 2, 1e-3, method)
    want = jax.jit(lambda q: jradar.cfar(q, 8, 2, 1e-3, method))(p)
    _cfar_check(got, want, p)
    assert got[0][:, 100].all()


def test_cfar_2d_and_options(case_rng):
    p = case_rng.exponential(1.0, (2, 40, 64)).astype(np.float32)
    p[:, 20, 30] += 60.0
    got = tp.cfar(torch.from_numpy(p), 4, 1, 1e-4, axes=(-2, -1))
    want = jax.jit(lambda q: jradar.cfar(q, 4, 1, 1e-4, axes=(-2, -1)))(p)
    _cfar_check(got, want, p)
    got = tp.cfar(torch.from_numpy(p), 4, 0, 1e-4, "os", axes=(-2,), rank=5)
    want = jax.jit(lambda q: jradar.cfar(q, 4, 0, 1e-4, "os", axes=(-2,), rank=5))(p)
    _cfar_check(got, want, p)
    with pytest.raises(ValueError):
        tp.cfar(torch.from_numpy(p), 4, 1, 1e-4, "go", axes=(-2, -1))
    with pytest.raises(ValueError):
        tp.cfar(torch.ones(3, dtype=torch.complex64))


# --------------------------------------------------------------------------- pfb

@pytest.mark.parametrize("K,P,window", [(16, 4, "hamming"), (32, 8, "hann"), (12, 3, "blackman")])
def test_pfb_prototype_is_the_jax_module_s(K, P, window):
    assert np.array_equal(tp.pfb_prototype(K, P, window), jpfb.pfb_prototype(K, P, window))
    assert np.array_equal(tp.pfb_frequencies(K, 3.0), jpfb.pfb_frequencies(K, 3.0))


@pytest.mark.parametrize("K,P,hop,mode,cplx", [
    (16, 4, None, "valid", False),
    (16, 4, None, "full", True),
    (32, 8, 24, "valid", False),
    (12, 3, 8, "full", True),
])
def test_pfb_analysis(case_rng, K, P, hop, mode, cplx):
    x = _cplx(case_rng, (2, 1000)) if cplx else case_rng.standard_normal((2, 1000)).astype(np.float32)
    got = tp.pfb_analysis(torch.from_numpy(x), K, P, hop=hop, mode=mode)
    want = jax.jit(lambda v: jpfb.pfb_analysis(v, K, P, hop=hop, mode=mode))(x)
    assert _rel(got, want) <= TOL
    # float64: frame m, tap p, branch k of the (padded) signal
    h = jpfb.pfb_prototype(K, P)
    xp = x.astype(np.complex128)
    if mode == "full":
        xp = np.pad(xp, [(0, 0), ((P - 1) * K, (P - 1) * K + (-1000) % K)])
    M = hop or K
    F = (xp.shape[-1] - P * K) // M + 1
    idx = np.arange(F)[:, None] * M + np.arange(P * K)[None, :]
    v = (xp[:, idx] * h).reshape(2, F, P, K).sum(-2)
    ref = np.fft.fft(v, axis=-1)
    if M != K:
        ref = ref * np.exp(-2j * np.pi * np.outer((np.arange(F) * M) % K, np.arange(K)) / K)
    assert _rel(got, ref) <= TOL


@pytest.mark.parametrize("K,P,n", [(16, 4, 512), (8, 3, 400)])
def test_pfb_synthesis_inverts_full_mode(case_rng, K, P, n):
    x = case_rng.standard_normal((2, n)).astype(np.float32)
    y = tp.pfb_analysis(torch.from_numpy(x), K, P, mode="full")
    got = tp.pfb_synthesis(y, P)
    want = jax.jit(lambda v: jpfb.pfb_synthesis(v, P))(y.numpy())
    assert _rel(got, want) <= TOL
    # the round trip, as the JAX module states it (~1e-4 in fp32)
    assert np.max(np.abs(got.numpy()[:, :n].real - x)) <= 5e-4
    with pytest.raises(ValueError):
        tpfb.pfb_synthesis(torch.zeros(2, K, dtype=torch.complex64), P)
