"""PyTorch port: ``ops/ltisys.py`` and ``ops/lticlasses.py`` against the JAX
package and scipy on the same inputs.

The conversions, discretizations, frequency responses, the class layer's
representations and ``place_poles`` are host numpy float64, the JAX
modules' code line for line: held bit-equal.  The simulations (``dlsim``,
``dstep``, ``dimpulse``, ``lsim``, ``step``, ``impulse`` and the classes'
``output``/``step``/``impulse``) run the state recurrence on
``utils.scan.linear_recurrence``: held against the JAX function (jitted, as
its tests run it) and scipy float64 at the JAX package's own test tolerances
for them (``tests/test_ltisys.py``, ``tests/test_lticlasses.py``: 1e-4
absolute for ``dlsim``/``lsim``, 1e-5 for ``dstep``/``dimpulse`` and the
discrete class methods, 2e-4 for the continuous ``output``, 1e-3 for
``step``/``impulse``)."""

import jax
import numpy as np
import pytest
import scipy.signal as ss
import torch

import mixed_radix_fast_fourier_transform_tpu as sp
from mixed_radix_fast_fourier_transform_tpu.ops import lticlasses as jcls, ltisys as jlti

import mixed_radix_fast_fourier_transform_tpu_torch as tp
from mixed_radix_fast_fourier_transform_tpu_torch.ops import lticlasses as tcls, ltisys as tlti

torch.set_num_threads(1)

SYS_C = (np.array([[0.0, 1.0], [-4.0, -0.5]]), np.array([[0.0], [1.0]]),
         np.array([[1.0, 0.0]]), np.array([[0.0]]))
SYS_D = ss.cont2discrete(SYS_C, 0.05, method="zoh")


def _np(v):
    return v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _abs(got, want):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want), initial=0.0))


def _bit_equal(got, want):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _bit_equal(g, w)
        return
    if want is None or isinstance(want, bool):
        assert got is want
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, want.shape)
    assert np.array_equal(got, want, equal_nan=True)


HOST = {
    "tf2ss": lambda m: m.tf2ss(*ss.butter(4, 0.4)),
    "ss2tf": lambda m: m.ss2tf(*m.tf2ss(*ss.butter(4, 0.4))),
    "zpk2ss": lambda m: m.zpk2ss(*ss.butter(3, 0.3, output="zpk")),
    "ss2zpk": lambda m: m.ss2zpk(*SYS_C),
    "abcd_normalize": lambda m: m.abcd_normalize(*SYS_C),
    "cont2discrete": lambda m: [m.cont2discrete(SYS_C, 0.05, method=k) for k in
                                ("zoh", "foh", "bilinear", "euler", "backward_diff", "impulse")]
    + [m.cont2discrete(SYS_C, 0.05, method="gbt", alpha=0.3),
       m.cont2discrete(([1.0], [1.0, 1.0]), 0.1, method="zoh")],
    "dfreqresp": lambda m: m.dfreqresp(SYS_D, n=50),
    "dbode": lambda m: m.dbode(SYS_D, n=40),
    "freqresp": lambda m: m.freqresp(SYS_C, n=40),
    "bode": lambda m: m.bode(SYS_C, n=40),
}


@pytest.mark.parametrize("name", HOST)
def test_host_functions_bit_equal(name):
    _bit_equal(HOST[name](tlti), HOST[name](jlti))


A4 = np.array([[1.380, -0.2077, 6.715, -5.676], [-0.5814, -4.290, 0.0, 0.6750],
               [1.067, 4.273, -6.654, 5.893], [0.0480, 4.273, 1.343, -2.104]])
B4 = np.array([[0.0, 5.679], [1.136, 1.136], [0.0, 0.0], [-3.146, 0.0]])
CLASS_HOST = {
    "lti-tf": lambda m: (lambda s: (s.num, s.den, s.poles, s.zeros, s.dt))(m.lti([1.0, 0.0], [1.0, 3.0, 2.0])),
    "to_zpk-to_ss": lambda m: (lambda s: (s.to_zpk().zeros, s.to_zpk().poles, s.to_zpk().gain, s.to_ss().A,
                                          s.to_ss().B, s.to_ss().C, s.to_ss().D))(
        m.TransferFunction([1.0, 3.0, 3.0], [1.0, 2.0, 1.0])),
    "zpk-to_tf": lambda m: (lambda s: (s.num, s.den))(m.ZerosPolesGain([-1.0], [-2.0, -3.0], 2.0).to_tf()),
    "ss-copy": lambda m: (lambda s: (s.num, s.den))(m.TransferFunction(m.StateSpace(*SYS_C))),
    "to_discrete": lambda m: [(lambda s: (s.num, s.den, s.dt))(
        m.lti([1.0], [1.0, 1.0]).to_discrete(0.1, method="zoh")),
        (lambda s: (s.A, s.B, s.C, s.D))(m.StateSpace([[-1.0]], [[1.0]], [[1.0]], [[0.0]]).to_discrete(0.2))],
    "dlti-freqresp": lambda m: m.dlti([0.2], [1.0, -0.8], dt=0.05).freqresp(n=64),
    "lti-bode": lambda m: m.lti([1.0], [1.0, 2.0, 1.0]).bode(w=np.logspace(-2, 2, 50)),
    "place_poles": lambda m: [(lambda r: (r.gain_matrix, r.computed_poles))(
        m.place_poles(A4, B4, poles, method=method)) for poles, method in
        (([-0.2, -0.5, -5.0566, -8.6659], "YT"), ([-0.2, -0.5, -5.0566, -8.6659], "KNV0"),
         ([-1.0 + 1.0j, -1.0 - 1.0j, -2.0 + 0.5j, -2.0 - 0.5j], "YT"))],
}


@pytest.mark.parametrize("name", CLASS_HOST)
def test_classes_and_place_poles_bit_equal(name):
    _bit_equal(CLASS_HOST[name](tcls), CLASS_HOST[name](jcls))


def test_class_dispatch_and_errors():
    assert isinstance(tp.lti([1.0], [1.0, 1.0]), tp.TransferFunction)
    assert isinstance(tp.lti([], [-1.0], 2.0), tp.ZerosPolesGain)
    assert isinstance(tp.lti([[-1.0]], [[1.0]], [[1.0]], [[0.0]]), tp.StateSpace)
    assert tp.dlti([1.0], [1.0, -0.5]).dt is True and tp.lti([1.0], [1.0, 1.0]).dt is None
    for name in ("TransferFunction", "ZerosPolesGain", "StateSpace"):
        assert issubclass(getattr(tcls, name), tcls.LinearTimeInvariant)
        assert ([c.__name__ for c in getattr(tcls, name).__mro__]
                == [c.__name__ for c in getattr(jcls, name).__mro__])
    with pytest.raises(ValueError):
        tp.lti([1.0])
    with pytest.raises(ValueError):
        tp.TransferFunction([1.0], [1.0, 1.0], dt=0.1).to_discrete(0.1)
    with pytest.raises(ValueError):
        tp.abcd_normalize(np.eye(2), np.zeros((3, 1)), np.zeros((1, 2)), np.zeros((1, 1)))
    with pytest.raises(ValueError):
        tp.cont2discrete(SYS_C, 0.1, method="nope")
    with pytest.raises(ValueError):
        tp.lsim(SYS_C, np.ones(4), np.array([0.0, 0.1, 0.3, 0.35]), device="cpu")
    with pytest.warns(tp.BadCoefficients):
        tp.normalize([0.0, 0.0, 1.0], [1.0, 0.5])


@pytest.mark.parametrize("case", ["zoh", "tf-form", "x0", "static"])
def test_dlsim(rng, case):
    sysd, u, x0, tol = SYS_D, rng.standard_normal(300).astype(np.float32), None, 1e-4
    if case == "tf-form":   # lightly damped poles: the JAX test's 5e-4
        sysd, u, tol = ss.cont2discrete(([1.0, 0.5], [1.0, 0.8, 4.0]), 0.02), np.ones(100, np.float32), 5e-4
    if case == "x0":
        x0 = np.array([0.5, -1.0])
    if case == "static":
        sysd = (np.zeros((0, 0)), np.zeros((0, 1)), np.zeros((1, 0)), np.array([[2.0]]), 0.1)
    got = tp.dlsim(sysd, u, x0=x0, device="cpu")
    want = jax.jit(lambda v: sp.dlsim(sysd, v, x0=x0)[1:])(u)
    ref = ss.dlsim(sysd, u.astype(np.float64), x0=x0)
    assert np.array_equal(got[0], ref[0])
    assert got[1].device.type == "cpu" and got[1].dtype == torch.float32
    for g, w, r in zip(got[1:], want, ref[1:]):
        assert _abs(g, w) <= tol and _abs(g, np.asarray(r).reshape(np.shape(w))) <= tol


@pytest.mark.parametrize("fn", ["dstep", "dimpulse"])
def test_dstep_dimpulse(fn):
    t, ys = getattr(tp, fn)(SYS_D, n=60, device="cpu")
    jt, jys = jax.jit(lambda: getattr(sp, fn)(SYS_D, n=60))()
    rt, rys = getattr(ss, fn)(SYS_D, n=60)
    assert np.allclose(t, rt) and np.allclose(t, np.asarray(jt), rtol=1e-6, atol=0)
    assert _abs(ys[0], jys[0]) <= 1e-5 and _abs(ys[0], rys[0]) <= 1e-5


@pytest.mark.parametrize("interp", [True, False])
def test_lsim(interp):
    T = np.linspace(0, 5, 401)
    U = np.sin(2 * np.pi * 0.7 * T).astype(np.float32)
    t, y, x = tp.lsim(SYS_C, U, T, interp=interp, device="cpu")
    jt, jy, jx = jax.jit(lambda u: sp.lsim(SYS_C, u, T, interp=interp))(U)
    _, ry, rx = ss.lsim(SYS_C, U.astype(np.float64), T, interp=interp)
    assert _abs(y, jy) <= 1e-4 and _abs(x, jx) <= 1e-4
    assert _abs(y[:, 0], ry) <= 1e-4 and _abs(x, rx) <= 1e-4


@pytest.mark.parametrize("fn", ["step", "impulse"])
def test_step_impulse(fn):
    t, y = getattr(tp, fn)(SYS_C, device="cpu")
    jt, jy = jax.jit(lambda: getattr(sp, fn)(SYS_C))()
    rt, ry = getattr(ss, fn)(ss.lti(*SYS_C), T=t)
    assert np.allclose(t, np.asarray(jt), rtol=1e-6, atol=0)
    assert _abs(y, jy) <= 1e-3 and _abs(y, ry) <= 1e-3


def test_class_simulation_methods():
    cont, dcont = tp.lti([1.0], [1.0, 2.0, 1.0]), ss.lti([1.0], [1.0, 2.0, 1.0])
    T = np.linspace(0, 8, 200)
    for m in ("step", "impulse"):
        t, y = getattr(cont, m)(T=T, device="cpu")
        assert y.device.type == "cpu" and _abs(y, getattr(dcont, m)(T=T)[1]) <= 1e-4
    U = np.sin(2 * np.pi * 0.7 * np.linspace(0, 5, 128))
    _, y, _ = tp.lti([1.0, 1.0], [1.0, 1.5, 1.0]).output(U, np.linspace(0, 5, 128), device="cpu")
    _, want, _ = ss.lti([1.0, 1.0], [1.0, 1.5, 1.0]).output(U, np.linspace(0, 5, 128))
    assert _abs(y.ravel(), want.ravel()) <= 2e-4
    disc, ddisc = tp.dlti([0.2], [1.0, -0.8], dt=0.05), ss.dlti([0.2], [1.0, -0.8], dt=0.05)
    for m in ("step", "impulse"):
        t, y = getattr(disc, m)(n=40, device="cpu")
        rt, ry = getattr(ddisc, m)(n=40)
        assert np.allclose(t, rt) and _abs(y[0].ravel(), ry[0].ravel()) <= 1e-5
    u = np.cos(np.arange(50) * 0.3)
    _, y = disc.output(u, None, device="cpu")
    assert _abs(y.ravel(), ddisc.output(u, t=None)[1].ravel()) <= 1e-5
