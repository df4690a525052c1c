"""PyTorch port: ``ops/iir.py`` against the JAX package (and scipy) on the
same inputs.

The host design (prototypes, transforms, ``iirfilter`` and its wrappers, the
order selection, notch/peak/comb, conversions, partial fractions, initial
conditions, analog responses) is the JAX module's code line for line, so it
is held bit-equal.  The device part runs the transposed direct-form-II
recurrence on ``utils.scan.linear_recurrence``: held against the JAX
function and against scipy float64 at the JAX package's own test
tolerances against scipy for the same function (``tests/test_iir.py``: 1e-5
for ``sosfilt`` and a Butterworth or FIR ``lfilter``, 2e-4 for a Chebyshev ba
``lfilter``, 5e-4 for ``filtfilt``, 1e-4 for ``sosfiltfilt``), relative to
the output's maximum.  The JAX functions run jitted, as its tests run them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as ss
import torch

import mixed_radix_fast_fourier_transform_tpu as sp
from mixed_radix_fast_fourier_transform_tpu.ops import iir as jiir

import mixed_radix_fast_fourier_transform_tpu_torch as tp
from mixed_radix_fast_fourier_transform_tpu_torch.ops import iir as tiir

torch.set_num_threads(1)

TOL = 1e-5
FILTFILT_TOL = 5e-4
SOSFILTFILT_TOL = 1e-4
CHEBY_BA_TOL = 2e-4


def _np(v):
    return v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _rel(got, want):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bit_equal(got, want):
    if isinstance(want, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(got) == len(want)
        for g, w in zip(got, want):
            _bit_equal(g, w)
        return
    if isinstance(want, (int, float, complex, np.number)) or np.ndim(want) == 0:
        assert np.array_equal(np.asarray(got), np.asarray(want), equal_nan=True), (got, want)
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, want.dtype, got.shape)
    assert np.array_equal(got, want, equal_nan=True)


ZPK = ss.ellip(5, 0.5, 50, [0.2, 0.6], "bandpass", output="zpk")
BA = ss.cheby1(4, 1.0, 0.3)
SOS = ss.butter(6, 0.2, output="sos")
HOST = {
    "buttap": lambda m: m.buttap(5),
    "cheb1ap": lambda m: m.cheb1ap(4, 1.0),
    "cheb2ap": lambda m: m.cheb2ap(6, 40.0),
    "ellipap": lambda m: m.ellipap(7, 0.5, 60.0),
    "besselap": lambda m: [m.besselap(5, norm) for norm in ("phase", "delay", "mag")],
    "lp2lp_zpk": lambda m: m.lp2lp_zpk(*m.buttap(4), 2.0),
    "lp2hp_zpk": lambda m: m.lp2hp_zpk(*m.cheb1ap(3, 1.0), 3.0),
    "lp2bp_zpk": lambda m: m.lp2bp_zpk(*m.buttap(3), 2.0, 0.5),
    "lp2bs_zpk": lambda m: m.lp2bs_zpk(*m.buttap(3), 2.0, 0.5),
    "bilinear_zpk": lambda m: m.bilinear_zpk(*m.buttap(4), 2.0),
    "zpk2tf": lambda m: m.zpk2tf(*ZPK),
    "tf2zpk": lambda m: m.tf2zpk(*BA),
    "sos2zpk": lambda m: m.sos2zpk(SOS),
    "zpk2sos": lambda m: [m.zpk2sos(*ZPK), m.zpk2sos(*ss.butter(5, 0.3, output="zpk"))],
    "tf2sos": lambda m: m.tf2sos(*BA),
    "sos2tf": lambda m: m.sos2tf(SOS),
    "iirfilter": lambda m: m.iirfilter(4, [0.2, 0.4], rs=40.0, btype="bandstop", ftype="cheby2",
                                       output="zpk"),
    "butter": lambda m: [m.butter(4, 0.3), m.butter(3, [0.2, 0.5], "bandstop", output="sos"),
                         m.butter(4, 100.0, fs=1000.0), m.butter(4, 15.0, analog=True)],
    "cheby1": lambda m: [m.cheby1(4, 1.0, [0.25, 0.6], "bandpass"), m.cheby1(8, 0.05, 0.8 / 3, output="sos")],
    "cheby2": lambda m: m.cheby2(6, 50.0, 0.35, "highpass", output="sos"),
    "ellip": lambda m: [m.ellip(5, 0.5, 60.0, 0.3), m.ellip(8, 0.5, 60, [0.2, 0.6], "bandpass", output="sos")],
    "bessel": lambda m: [m.bessel(4, 0.3), m.bessel(5, 0.2, output="zpk")],
    "buttord": lambda m: [m.buttord(0.2, 0.3, 1, 40), m.buttord([0.2, 0.5], [0.1, 0.6], 2, 30),
                          m.buttord([0.2, 0.5], [0.3, 0.4], 2, 30)],
    "cheb1ord": lambda m: [m.cheb1ord(0.3, 0.2, 1, 40), m.cheb1ord([0.2, 0.5], [0.1, 0.6], 2, 30)],
    "cheb2ord": lambda m: [m.cheb2ord(0.2, 0.3, 1, 40), m.cheb2ord([0.2, 0.5], [0.1, 0.6], 2, 30)],
    "ellipord": lambda m: [m.ellipord(0.2, 0.3, 1, 40), m.ellipord([0.2, 0.5], [0.3, 0.4], 2, 30)],
    "iirnotch": lambda m: m.iirnotch(0.3, 30.0),
    "iirpeak": lambda m: m.iirpeak(60.0, 20.0, fs=1000.0),
    "iircomb": lambda m: [m.iircomb(0.1, 30.0, ftype=f, pass_zero=p) for f in ("notch", "peak")
                          for p in (False, True)],
    "lfilter_zi": lambda m: m.lfilter_zi(*BA),
    "sosfilt_zi": lambda m: m.sosfilt_zi(SOS),
    "freqs": lambda m: m.freqs(*ss.butter(4, 10.0, analog=True), worN=np.logspace(0, 2, 64)),
    "freqs_zpk": lambda m: m.freqs_zpk(*ss.butter(4, 10.0, analog=True, output="zpk"), worN=32),
    "normalize": lambda m: m.normalize([2.0, 4.0, 2.0], [2.0, -1.0, 0.5]),
    "bilinear": lambda m: m.bilinear(*ss.butter(3, 10.0, analog=True), fs=100.0),
    "lp2lp": lambda m: m.lp2lp(*BA, 2.0),
    "lp2hp": lambda m: m.lp2hp(*BA, 2.0),
    "lp2bp": lambda m: m.lp2bp(*BA, 2.0, 0.5),
    "lp2bs": lambda m: m.lp2bs(*BA, 2.0, 0.5),
    "freqz_zpk": lambda m: m.freqz_zpk(*ZPK, worN=64),
    "iirdesign": lambda m: m.iirdesign([0.2, 0.5], [0.1, 0.6], 2, 30, ftype="ellip", output="sos"),
    "lfiltic": lambda m: m.lfiltic(*BA, [0.5, -0.2, 0.1], [1.0, 0.3]),
    "unique_roots": lambda m: m.unique_roots([1.0, 1.0005, 2.0, 3.0 + 1j, 3.0 + 1.0001j]),
    "residue": lambda m: m.residue([1.0, 2.0], [1.0, 3.0, 2.0]),
    "residuez": lambda m: m.residuez([1.0, 0.5], [1.0, -0.9, 0.2]),
    "invres": lambda m: m.invres([1.0, -1.0], [-1.0, -2.0], [1.0]),
    "invresz": lambda m: m.invresz([0.5, 0.5], [0.5, 0.4], []),
    "findfreqs": lambda m: m.findfreqs(*ss.butter(3, 10.0, analog=True), 16),
    "band_stop_obj": lambda m: m.band_stop_obj(0.25, 0, np.array([0.2, 0.5]), np.array([0.3, 0.4]),
                                               2.0, 30.0, "butter"),
}


@pytest.mark.parametrize("name", HOST)
def test_host_design_bit_equal(name):
    _bit_equal(HOST[name](tiir), HOST[name](jiir))


@pytest.mark.parametrize("fn", ["sosfreqz", "freqz_sos"])
def test_sosfreqz_on_the_engine(fn):
    w, h = getattr(tp, fn)(SOS, worN=129, device="cpu")
    assert h.device.type == "cpu" and _rel(h, ss.sosfreqz(SOS, worN=129)[1]) <= TOL
    if fn == "sosfreqz":   # freqz_sos is its alias in both packages
        jw, jh = sp.sosfreqz(SOS, worN=129)
        assert np.array_equal(np.asarray(w), np.asarray(jw)) and _rel(h, jh) <= TOL


def test_recurrence_scan_is_the_shared_scan(rng):
    """``_recurrence_scan`` keeps the JAX module's name (``ltisys`` imports
    it) and computes what the JAX function does."""
    A = np.array([[0.5, -0.3], [0.2, 0.9]])
    c = rng.standard_normal((300, 4, 2)).astype(np.float32)
    s0 = rng.standard_normal((4, 2)).astype(np.float32)
    want = jax.jit(lambda c, s0: jiir._recurrence_scan(A, c, s0))(jnp.asarray(c), jnp.asarray(s0))
    assert _rel(tiir._recurrence_scan(A, _t(c), _t(s0)), want) <= TOL


@pytest.mark.parametrize("n", [1, 200])
@pytest.mark.parametrize("design", ["butter6", "cheby1-4", "ellip-bp"])
def test_sosfilt(rng, design, n):
    sos = {"butter6": SOS, "cheby1-4": ss.cheby1(4, 1, 0.3, output="sos"),
           "ellip-bp": ss.ellip(8, 0.5, 60, [0.2, 0.6], "bandpass", output="sos")}[design]
    x = rng.standard_normal((3, n)).astype(np.float32)
    got = tp.sosfilt(sos, _t(x))
    assert got.dtype == torch.float32
    assert _rel(got, jax.jit(lambda v: sp.sosfilt(sos, v))(x)) <= TOL
    assert _rel(got, ss.sosfilt(sos, x.astype(np.float64), axis=-1)) <= TOL
    # a long signal: several levels of blocks (scipy alone: it needs no compile)
    x = rng.standard_normal((2, 20000)).astype(np.float32)
    assert _rel(tp.sosfilt(sos, _t(x)), ss.sosfilt(sos, x.astype(np.float64), axis=-1)) <= TOL


def test_sosfilt_zi_zf_axis_and_streaming(rng):
    sos = ss.butter(4, 0.25, output="sos")
    x = rng.standard_normal((2, 512)).astype(np.float32)
    zi = np.broadcast_to(tp.sosfilt_zi(sos)[:, None, :], (2, 2, 2)).copy()
    y, zf = tp.sosfilt(sos, _t(x), zi=_t(zi).float())
    jy, jzf = jax.jit(lambda v, z: sp.sosfilt(sos, v, zi=z))(x, zi.astype(np.float32))
    assert _rel(y, jy) <= TOL and _rel(zf, jzf) <= TOL
    y1, z1 = tp.sosfilt(sos, _t(x[:, :256]), zi=torch.zeros(2, 2, 2))
    y2, _ = tp.sosfilt(sos, _t(x[:, 256:]), zi=z1)
    assert _rel(torch.cat([y1, y2], -1), tp.sosfilt(sos, _t(x))) <= TOL
    xt = rng.standard_normal((512, 3)).astype(np.float32)
    assert _rel(tp.sosfilt(sos, _t(xt), axis=0), ss.sosfilt(sos, xt.astype(np.float64), axis=0)) <= TOL


@pytest.mark.parametrize("kind", ["cheby1-ba", "butter4-ba", "fir", "fir-int", "zi"])
def test_lfilter(rng, kind):
    x = rng.standard_normal((2, 256)).astype(np.float32)
    if kind == "fir-int":
        x = rng.integers(-5, 5, (2, 256))
    b, a = {"cheby1-ba": BA, "butter4-ba": ss.butter(4, 0.2)}.get(kind, (ss.firwin(33, 0.3), [1.0]))
    if kind == "zi":
        zi = tp.lfilter_zi(*BA) * 0.7
        y, zf = tp.lfilter(*BA, _t(x), zi=_t(zi).float())
        jy, jzf = jax.jit(lambda v, z: sp.lfilter(*BA, v, zi=z))(x, zi.astype(np.float32))
        assert _rel(y, jy) <= CHEBY_BA_TOL and _rel(zf, jzf) <= CHEBY_BA_TOL
        return
    got = tp.lfilter(b, a, _t(x))
    assert got.dtype == torch.float32
    tol = CHEBY_BA_TOL if kind == "cheby1-ba" else TOL
    assert _rel(got, jax.jit(lambda v: sp.lfilter(b, a, v))(x)) <= tol
    assert _rel(got, ss.lfilter(b, a, x.astype(np.float64), axis=-1)) <= tol


@pytest.mark.parametrize("kw", [dict(), dict(padlen=20), dict(padtype=None), dict(axis=0)], ids=str)
def test_filtfilt_and_sosfiltfilt(rng, kw):
    x = rng.standard_normal((2, 300)).astype(np.float32)
    if kw.get("axis") == 0:
        x = x.T.copy()
    b, a = ss.butter(4, 0.2)
    sos = ss.ellip(4, 0.5, 60, [0.2, 0.6], "bandpass", output="sos")
    got = tp.filtfilt(b, a, _t(x), **kw)
    gots = tp.sosfiltfilt(sos, _t(x), **kw)
    assert _rel(got, ss.filtfilt(b, a, x.astype(np.float64), **kw)) <= FILTFILT_TOL
    assert _rel(gots, ss.sosfiltfilt(sos, x.astype(np.float64), **kw)) <= SOSFILTFILT_TOL
    if not kw:   # the options' edge handling is scipy's; one compile of each JAX function
        assert _rel(got, jax.jit(lambda v: sp.filtfilt(b, a, v))(x)) <= FILTFILT_TOL
        assert _rel(gots, jax.jit(lambda v: sp.sosfiltfilt(sos, v))(x)) <= SOSFILTFILT_TOL


def test_gradient_flows_through_the_scan(rng):
    """The recursion is differentiable: the gradient of Σ sosfilt(x)² against
    ``jax.grad`` of the JAX function."""
    sos = ss.butter(2, 0.3, output="sos")
    x = rng.standard_normal(256).astype(np.float32)
    xt = _t(x).requires_grad_()
    (tp.sosfilt(sos, xt) ** 2).sum().backward()
    want = jax.jit(jax.grad(lambda v: jnp.sum(sp.sosfilt(sos, v) ** 2)))(jnp.asarray(x))
    assert _rel(xt.grad, want) <= TOL


def test_odd_extension_and_errors():
    x = torch.arange(10.0)[None]
    assert _rel(tiir._odd_ext(x, 3), jiir._odd_ext(x.numpy(), 3)) == 0.0
    with pytest.raises(ValueError):
        tp.lfilter([1.0], [0.0, 1.0], torch.zeros(8))
    with pytest.raises(ValueError):
        tp.lfilter(np.ones(40), np.ones(40), torch.zeros(128))
    with pytest.raises(ValueError):
        tp.filtfilt([1.0, 0.5], [1.0, -0.5], torch.zeros(4))
    with pytest.raises(ValueError):
        tp.sosfilt(np.zeros((2, 5)), torch.zeros(16))
    with pytest.raises(ValueError):
        tp.lfilter(ss.firwin(5, 0.3), [1.0], torch.zeros(16), zi=torch.zeros(4))
    with pytest.raises(ValueError):
        tp.sosfiltfilt(SOS, torch.zeros(64), padtype="even")
    with pytest.raises(ValueError):
        tp.sosfilt(SOS, torch.zeros(16, dtype=torch.complex64))
