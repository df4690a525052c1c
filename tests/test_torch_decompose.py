"""PyTorch port: the adaptive decompositions — ``ops/ewt.py``, ``ops/emd.py``
and ``ops/vmd.py`` — against the JAX package and float64 numpy/scipy.

Tolerances: the host float64 stages copied from the JAX module (EWT
boundaries, EMD/EEMD sifting with the same noise draws) exactly equal;
``ewt`` 1e-5 of the output's maximum and its bands summing to the input;
``hilbert_huang``'s amplitude 1e-5 of its maximum against float64 scipy,
its instantaneous frequency 1e-4 cycles/sample (a phase derivative in
fp32) wherever a row's amplitude is above a tenth of that row's maximum;
``vmd``'s 300-sweep ADMM against a float64 numpy loop of the same
algorithm, to 1e-4 of the modes' maximum, and against the JAX function by
the triangle bound (the port's error plus the JAX result's own error
against float64), with ``init_omega`` pinned or the peaks well apart
(ROADMAP F2).  Inputs come from a generator made for each case."""

import jax
import numpy as np
import pytest
import scipy.signal as ss
import torch

from mixed_radix_fast_fourier_transform_tpu.ops import emd as jemd
from mixed_radix_fast_fourier_transform_tpu.ops import ewt as jewt
from mixed_radix_fast_fourier_transform_tpu.ops import vmd as jvmd

import mixed_radix_fast_fourier_transform_tpu_torch as tp

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


def _tones(rng, freqs, n=1024, amps=None, noise=0.02):
    k = np.arange(n)
    amps = amps or [1.0] * len(freqs)
    x = sum(a * np.sin(2 * np.pi * f * k + 0.4 * i) for i, (a, f) in enumerate(zip(amps, freqs)))
    return (x + noise * rng.standard_normal(n)).astype(np.float32)


@pytest.mark.parametrize("n_bands", [2, 3])
def test_ewt_adaptive(case_rng, n_bands):
    x = _tones(case_rng, [0.04, 0.17, 0.33])
    assert np.array_equal(tp.ewt_boundaries(torch.from_numpy(x), n_bands),
                          jewt.ewt_boundaries(x, n_bands))
    bands, bounds = tp.ewt(torch.from_numpy(x), n_bands)
    jbands, jbounds = jewt.ewt(x, n_bands)
    assert np.array_equal(bounds, jbounds) and _rel(bands, jbands) <= TOL
    assert _rel(bands.sum(0), x) <= TOL


def test_ewt_given_boundaries_batched(case_rng):
    x = np.stack([_tones(case_rng, [0.05, 0.2, 0.4], n=999) for _ in range(3)])
    b = np.array([0.1, 0.3])
    bands, _ = tp.ewt(torch.from_numpy(x), boundaries=b, gamma=0.1)
    jbands = jax.jit(lambda v: jewt.ewt(v, boundaries=b, gamma=0.1)[0])(x)
    assert bands.shape == (3, 3, 999) and _rel(bands, jbands) <= TOL
    with pytest.raises(ValueError):
        tp.ewt(torch.from_numpy(x), boundaries=[0.3, 0.1])


def test_emd_and_eemd_are_the_jax_module_s(case_rng):
    x = _tones(case_rng, [0.01, 0.08], n=600).astype(np.float64)
    assert np.array_equal(tp.emd(torch.from_numpy(x)), jemd.emd(x))
    assert np.array_equal(tp.emd(x, max_imf=2), jemd.emd(x, max_imf=2))
    got = tp.eemd(x[:300], n_ensembles=4, seed=3)
    assert np.array_equal(got, jemd.eemd(x[:300], n_ensembles=4, seed=3))


def test_hilbert_huang(case_rng):
    x = _tones(case_rng, [0.02, 0.11], n=800, amps=[1.0, 0.6], noise=0.0)
    imfs, amp, freq = tp.hilbert_huang(torch.from_numpy(x), fs=2.0)
    jimfs, jamp, jfreq = jemd.hilbert_huang(x, fs=2.0)
    assert np.array_equal(imfs, jimfs) and amp.device.type == "cpu"
    analytic = ss.hilbert(imfs)
    amp64 = np.abs(analytic)
    freq64 = np.gradient(np.unwrap(np.angle(analytic), axis=-1), axis=-1) * (2.0 / (2 * np.pi))
    assert _rel(amp, amp64) <= TOL and _rel(amp, jamp) <= TOL
    live = amp64 > 0.1 * amp64.max(axis=-1, keepdims=True)
    assert np.max(np.abs(freq.numpy() - freq64)[live]) <= 2.0 * 1e-4
    assert np.max(np.abs(freq.numpy() - np.asarray(jfreq))[live]) <= 2.0 * 2e-4


def _vmd64(x, K, alpha, tau, n_iter, omega0):
    """The JAX module's VMD in float64 numpy (pinned initial frequencies)."""
    T0 = x.shape[-1]
    half = T0 // 2
    xm = np.concatenate([x[..., :half][..., ::-1], x, x[..., T0 - half:][..., ::-1]], -1)
    T = xm.shape[-1]
    f_hat = np.fft.fft(xm.astype(np.float64))
    pos = (np.arange(T) <= T // 2).astype(np.float64)
    w = np.abs(np.fft.fftfreq(T))
    f_pos = f_hat * pos
    u = np.zeros(x.shape[:-1] + (K, T), complex)
    omega = np.broadcast_to(np.asarray(omega0, float), x.shape[:-1] + (K,)).copy()
    lam = np.zeros(x.shape[:-1] + (T,), complex)
    for _ in range(n_iter):
        sum_u = u.sum(-2)
        for k in range(K):
            sum_u = sum_u - u[..., k, :]
            u_k = (f_pos - sum_u + lam / 2) / (1 + 2 * alpha * (w - omega[..., k, None]) ** 2) * pos
            p = np.abs(u_k) ** 2
            omega[..., k] = (w * p).sum(-1) / (p.sum(-1) + 1e-30)
            u[..., k, :] = u_k
            sum_u = sum_u + u_k
        lam = lam + tau * (f_pos - sum_u)
    u_full = u + np.conj(np.flip(np.roll(u, -1, -1), -1))
    u_full[..., 0] = u[..., 0].real
    if T % 2 == 0:
        u_full[..., T // 2] = u[..., T // 2].real
    modes = np.fft.ifft(u_full).real[..., half: half + T0]
    order = np.argsort(omega, -1)
    return np.take_along_axis(modes, order[..., None], -2), np.take_along_axis(omega, order, -1)


@pytest.mark.parametrize("init,tau", [("pinned", 0.0), ("pinned", 0.05), ("uniform", 0.0), ("peaks", 0.0)])
def test_vmd_against_float64_and_jax(case_rng, init, tau):
    x = np.stack([_tones(case_rng, [0.03, 0.12, 0.31], n=512, amps=[1.0, 0.7, 0.5]) for _ in range(2)])
    K, alpha = 3, 2000.0
    omega0 = {"pinned": np.array([0.02, 0.15, 0.3]),
              "uniform": 0.5 * (np.arange(K) + 0.5) / K,
              "peaks": np.array([0.03, 0.12, 0.31])}[init]   # the three tones' bins
    init_arg = omega0 if init == "pinned" else init
    modes, omega = tp.vmd(torch.from_numpy(x), K, alpha, tau, init_omega=init_arg)
    jmodes, jomega = jax.jit(lambda v: jvmd.vmd(v, K, alpha, tau, init_omega=init_arg))(x)
    if init == "peaks":   # the pick lands on each tone's bin in both packages
        omega0 = np.asarray(jax.jit(lambda v: jvmd.vmd(v, K, alpha, tau, n_iter=0,
                                                       init_omega="peaks")[1])(x))
    m64, o64 = _vmd64(x.astype(np.float64), K, alpha, tau, 300, omega0)
    scale = np.max(np.abs(m64))
    port_err = np.max(np.abs(modes.numpy() - m64)) / scale
    jax_err = np.max(np.abs(np.asarray(jmodes) - m64)) / scale
    assert port_err <= 1e-4 and jax_err <= 1e-4
    assert np.max(np.abs(modes.numpy() - np.asarray(jmodes))) / scale <= 1e-4 + jax_err
    assert np.max(np.abs(omega.numpy() - o64)) <= 1e-5
