"""PyTorch port: the ops that the JAX package's tests run under ``jax.jit``,
under ``torch.compile``.  This file holds the IIR filters, the keying of a
caller's arrays and the checks every op gets; the ops with host tables
(``pfb_analysis``, ``radon``/``iradon``, ``multitaper``), ``griffinlim``
and the compiled loss of a ``dwt`` are in ``test_torch_compile_ops_tables.py``,
the time-frequency group and the CQT in ``test_torch_compile_ops_tf.py``.

Each op at its JAX test's call and shape, compiled on the CPU with
``backend="aot_eager"``, ``fullgraph=True, dynamic=False``, on both routes
where it reaches the FFT: zero graph breaks (one graph, by dynamo's
counters), the compiled op against ``jax.jit`` of the JAX op at the
tolerance the port's eager test of that op holds (the triangle bound
against scipy float64 where that test uses it), against the eager port at
1e-6, no recompile on a second call with new data
(``error_on_recompile``), from a cold table cache and again from a warm
one, and no traced tensor kept in a cache.  A caller's coefficient array
is keyed on the host (``utils.numerics.on_host``) and guarded by identity:
two compiled closures over different ``sos``/``theta``/``h`` give their own
answers, never a stale table.  ``griffinlim(generator=...)`` refuses to
compile with its ValueError."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as ss
import torch

import mixed_radix_fast_fourier_transform_tpu as jsp

import mixed_radix_fast_fourier_transform_tpu_torch as tp
from mixed_radix_fast_fourier_transform_tpu_torch import plan as tplan
from mixed_radix_fast_fourier_transform_tpu_torch.ops import cuda_fft
from mixed_radix_fast_fourier_transform_tpu_torch.utils import numerics

torch.set_num_threads(1)

TOL = 1e-5          # the port's eager tests against the JAX functions
EAGER_TOL = 1e-6    # against the eager port: the same ops, traced
ROUTES = {"kernel": tp.SpectralConfig(use_kernel=True),
          "pipeline": tp.SpectralConfig(use_kernel=False)}
SOS6 = ss.butter(6, 0.2, output="sos")
SOS4 = ss.butter(4, 0.25, output="sos")
SOS_ELLIP = ss.ellip(8, 0.5, 60, [0.2, 0.6], "bandpass", output="sos")
BA_CHEBY = ss.cheby1(4, 1, 0.25)
BA_BUTTER = ss.butter(4, 0.2)
FIR = ss.firwin(33, 0.3)


def _np(v):
    return v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _rel(got, want, scale=None):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / (scale or max(np.max(np.abs(want)), 1e-30)))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a)) if isinstance(a, np.ndarray) else a


def _tuple(x):
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


def compiled(fn):
    return torch.compile(fn, backend="aot_eager", fullgraph=True, dynamic=False)


@pytest.fixture(autouse=True)
def fresh_dynamo():
    torch._dynamo.reset()
    yield
    torch._dynamo.reset()


@pytest.fixture
def case_rng(request):
    """A generator made for one test case from its name: its draws do not
    depend on which tests ran before on the worker."""
    return np.random.default_rng([ord(ch) for ch in request.node.name])


def assert_no_traced_tensors(*prefixes):
    """Every tensor in the plan, table and launch caches is a plain one (no
    fake, functional or traced tensor outlives a trace), and the device
    tables whose keys start with ``prefixes`` are among them, kept by key."""
    kept = [t for plan in tplan._CACHE.values() for consts in plan._device.values()
            for v in consts.values() for t in (v if isinstance(v, tuple) else (v,))]
    kept += list(numerics._TABLES.values())
    kept += [r.tw for r in cuda_fft._READY.values()]
    assert all(type(t) is torch.Tensor for t in kept), {type(t) for t in kept}
    names = {slot[0][0] for slot in numerics._TABLES if isinstance(slot[0][0], str)}
    assert set(prefixes) <= names, (prefixes, names)


def close_to_eager(got, eager):
    for g, e in zip(got, eager):
        assert _rel(g, e) <= EAGER_TOL


def hold(port, jfn, args, args2, jax_check, *, eager_check=close_to_eager, tables=(),
         warm=True):
    """Compile ``port`` from a cold table cache and hold it: one graph, no
    traced tensor kept, the eager port (``eager_check``), ``jax.jit(jfn)``
    (``jax_check(got, want)``, where there is one), a second call on
    ``args2`` without a recompile, then (``warm``) a compile from the warm
    cache equal to the first."""
    tp.clear_plan_cache()
    targs = [_t(a) for a in args]
    counters = torch._dynamo.utils.counters
    counters.clear()
    comp = compiled(port)
    got = _tuple(comp(*targs))
    assert not counters["graph_break"] and counters["stats"]["unique_graphs"] == 1
    assert_no_traced_tensors(*tables)
    eager_check(got, _tuple(port(*targs)))
    if jfn is not None:
        jax_check(got, _tuple(jax.jit(jfn)(*args)))
    targs2 = [_t(a) for a in args2]
    with torch._dynamo.config.patch(error_on_recompile=True):
        got2 = _tuple(comp(*targs2))
    eager_check(got2, _tuple(port(*targs2)))
    if not warm:
        return
    torch._dynamo.reset()
    warm = _tuple(compiled(port)(*targs))
    for g, w in zip(got, warm):
        assert np.array_equal(_np(g), _np(w))
    assert_no_traced_tensors(*tables)


def within(tol):
    def check(got, want):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert _rel(g, w) <= tol
    return check


def triangle(tol, r):
    """The port within ``tol`` of the float64 result ``r``, and within
    ``tol`` plus the JAX result's own error against ``r`` of the JAX result
    (the triangle bound the eager tests use where the JAX function sits near
    the tolerance)."""
    def check(got, want):
        (g,), (w,) = got, want
        scale = np.max(np.abs(r))
        jax_err = np.max(np.abs(np.asarray(w) - r)) / scale
        assert _rel(g, r) <= tol and jax_err <= tol
        assert np.max(np.abs(_np(g) - np.asarray(w))) / scale <= tol + jax_err
    return check


# -- the IIR filters (no FFT: one route) -------------------------------------


def _iir_case(name, rng):
    """(port, JAX function, args, second args, JAX check) at the
    JAX test's call (``tests/test_iir.py``)."""
    shape = {"sosfilt": (3, 1024), "sosfilt-zi": (2, 512)}.get(name, (2, 1024))
    x, x2 = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    if name == "sosfilt":
        return ((lambda v: tp.sosfilt(SOS6, v)), (lambda v: jsp.sosfilt(SOS6, v)),
                [x], [x2], within(TOL))
    if name == "sosfilt-zi":
        zi = np.broadcast_to(tp.sosfilt_zi(SOS4)[:, None, :], (SOS4.shape[0], 2, 2)).copy()
        zt, zj = torch.from_numpy(zi).float(), jnp.asarray(zi, jnp.float32)
        return ((lambda v: tp.sosfilt(SOS4, v, zi=zt)), (lambda v: jsp.sosfilt(SOS4, v, zi=zj)),
                [x], [x2], within(TOL))
    if name == "lfilter-iir":
        return ((lambda v: tp.lfilter(*BA_CHEBY, v)), (lambda v: jsp.lfilter(*BA_CHEBY, v)),
                [x], [x2], triangle(2e-4, ss.lfilter(*BA_CHEBY, x.astype(np.float64))))
    if name == "lfilter-fir":
        return ((lambda v: tp.lfilter(FIR, [1.0], v)), (lambda v: jsp.lfilter(FIR, [1.0], v)),
                [x], [x2], triangle(TOL, ss.lfilter(FIR, [1.0], x.astype(np.float64))))
    if name == "filtfilt":
        return ((lambda v: tp.filtfilt(*BA_BUTTER, v)), (lambda v: jsp.filtfilt(*BA_BUTTER, v)),
                [x], [x2], within(5e-4))
    return ((lambda v: tp.sosfiltfilt(SOS_ELLIP, v)), (lambda v: jsp.sosfiltfilt(SOS_ELLIP, v)),
            [x], [x2], within(1e-4))


@pytest.mark.parametrize("name", ["sosfilt", "sosfilt-zi", "lfilter-iir", "lfilter-fir",
                                  "filtfilt", "sosfiltfilt"])
def test_iir_filters_compile_whole(name, case_rng):
    """The design runs on the host (normalised, validated and turned into
    DF2T stages keyed by content), the state matrices reach the scan as
    content keys and its block operators are kept by key."""
    port, jfn, args, args2, check = _iir_case(name, case_rng)
    tables = ("df2t_B",) if name != "lfilter-fir" else ("lfilter_fir",)
    if name != "lfilter-fir":
        tables += ("linear_recurrence",)
    # the warm compile of sosfiltfilt's 16 scans repeats filtfilt's and sosfilt's
    hold(port, jfn, args, args2, check, tables=tables, warm=name != "sosfiltfilt")


def _closures_agree(make, values, x):
    """Compiled closures of ``make`` over each of ``values`` (one code
    object, so dynamo's guards tell them apart) each equal to its eager
    call; returns the compiled functions."""
    comps = [compiled(make(v)) for v in values]
    for v, comp in zip(values, comps):
        assert _rel(comp(x), make(v)(x)) <= EAGER_TOL
    return comps


@pytest.mark.parametrize("what", ["sos", "h", "theta"])
def test_closures_over_other_coefficients_trace_anew(what, case_rng):
    """Two compiled closures over two ``sos`` arrays of one shape, two
    ``h`` prototypes of one length or two angle sets of one count: each
    gives its own eager result (a new graph and new tables for the second
    array, never the first one's).  For ``sos``, the first closure called
    again keeps its own, and a closure over an array made anew with the
    same contents gives the same result."""
    x = torch.from_numpy(case_rng.standard_normal((2, 512)).astype(np.float32))
    if what == "sos":
        def make(sos):
            return lambda v: tp.sosfilt(sos, v)

        first, _ = _closures_agree(make, [SOS6, ss.butter(6, 0.35, output="sos")], x)
        assert _rel(first(x), tp.sosfilt(SOS6, x)) <= EAGER_TOL
        assert _rel(compiled(make(SOS6.copy()))(x), tp.sosfilt(SOS6, x)) <= EAGER_TOL
    elif what == "h":
        def make(h):
            return lambda v: tp.pfb_analysis(v, 16, h=h)

        _closures_agree(make, [tp.pfb_prototype(16, 4, window="hann"),
                               tp.pfb_prototype(16, 4, window="hamming")], x)
    else:
        def make(theta):
            return lambda v: tp.iradon(tp.radon(v, theta), theta)

        img = torch.from_numpy(case_rng.standard_normal((2, 24, 24)).astype(np.float32))
        _closures_agree(make, [np.linspace(0, np.pi, 12, endpoint=False),
                               np.linspace(0.1, 3.0, 12)], img)


def test_a_bad_coefficient_array_raises_under_compile():
    """The host prologue's ValueError reaches a compiled caller (inside
    dynamo's own exception, whose message begins "ValueError:"), and so
    does its refusal of coefficients given as a tensor."""
    bad = np.array([[1.0, 0.0, 0.0, 0.0, 0.5, 0.0]])
    with pytest.raises(Exception, match=r"ValueError: each section needs a\[0\] != 0"):
        compiled(lambda v: tp.sosfilt(bad, v))(torch.ones(2, 64))
    with pytest.raises(ValueError, match=r"each section needs a\[0\] != 0"):
        tp.sosfilt(bad, torch.ones(2, 64))
    # a tensor's values cannot be guarded: refused, where eager takes it
    sos = torch.from_numpy(SOS6)
    with pytest.raises(Exception, match="ValueError: a traced call designs its tables"):
        compiled(lambda v: tp.sosfilt(sos, v))(torch.ones(2, 64))
    assert _rel(tp.sosfilt(sos, torch.ones(2, 64)), tp.sosfilt(SOS6, torch.ones(2, 64))) == 0.0


def test_griffinlim_generator_refuses_to_compile():
    """A caller's generator cannot enter a graph: ``generator=`` under
    compile raises its ValueError, and stays an eager form."""
    m = torch.ones(2, 33, 65)
    g = torch.Generator().manual_seed(1)
    with pytest.raises(Exception, match=r"ValueError: griffinlim\(generator=\.\.\.\) cannot be "
                                        r"compiled") as info:
        compiled(lambda v: tp.griffinlim(v, n_iter=2, nperseg=128, generator=g))(m)
    assert isinstance(info.value, (ValueError, torch._dynamo.exc.TorchDynamoException))
    assert tp.griffinlim(m, n_iter=2, nperseg=128, generator=g).shape == (2, 2048)
