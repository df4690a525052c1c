"""PyTorch port under ``torch.compile``: the transforms of the FFT layer that
the JAX package's tests jit and that once broke their graph on host work,
``fht``/``ifht`` (their FFTLog coefficient and bias tables host builds),
``cwt_tc`` (the caller's scale ladder keyed on the host, its Morlet windows
a host build), ``ewt(boundaries=...)`` (the boundaries keyed on the host,
the partition bank a host build) and ``specaugment`` (its draws made on
the host, ``seed=`` taking the JAX function's key's place), each at its JAX
test's call and shape, with the checks of ``test_torch_compile_ops.py``
(one graph, ``jax.jit`` of the JAX op and the eager port matched, no
recompile, cold and warm table caches, no traced tensor kept); what still
refuses to compile refuses with its ValueError (``specaugment(generator=)``,
the adaptive ``ewt(n_bands=)``); ``fwht``'s dense product compiles at
"high"; ``torch._dynamo.explain`` reads one graph at each JAX test's call.
The type-3 NUFFTs are in ``test_torch_compile_ops_nufft3.py``."""

import jax
import numpy as np
import pytest
import scipy.fft
import torch

import mixed_radix_fast_fourier_transform_tpu as jsp

import mixed_radix_fast_fourier_transform_tpu_torch as tp
from mixed_radix_fast_fourier_transform_tpu_torch.ops import feature as tfeat
from mixed_radix_fast_fourier_transform_tpu_torch.utils import numerics as tnum

from test_torch_compile_ops import (  # noqa: F401  (fixtures)
    EAGER_TOL, ROUTES, TOL, _np, _rel, case_rng, compiled, fresh_dynamo, hold, within,
)

torch.set_num_threads(1)

EWT_BOUNDARIES = np.array([0.1, 0.3])
TC_SCALES = tp.tc_scales(512)


def _op(name, config):
    """(port, JAX function, input shape, tables) at the JAX test's call."""
    if name == "fht":
        return (lambda v: tp.fht(v, 0.1, 2.0, config=config), lambda v: jsp.fht(v, 0.1, 2.0),
                (2, 64), ("fht",))
    if name == "ifht":
        return (lambda v: tp.ifht(v, 0.1, 2.0, config=config), lambda v: jsp.ifht(v, 0.1, 2.0),
                (2, 64), ("fht",))
    if name == "cwt_tc":
        return (lambda v: tp.cwt_tc(v, TC_SCALES, config=config),
                lambda v: jsp.cwt_tc(v, TC_SCALES), (2, 512), ("cwt_tc.psi",))
    return (lambda v: tp.ewt(v, boundaries=EWT_BOUNDARIES, config=config)[0],
            lambda v: jsp.ewt(v, boundaries=EWT_BOUNDARIES)[0], (2, 1024), ("ewt.bank",))


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("name", ["fht", "ifht", "cwt_tc", "ewt"])
def test_transform_compiles_whole(name, route, case_rng):
    """``fht``/``ifht`` at (2, 64), mu = 2 (``tests/test_fht.py``), also
    within 2e-5 of ``scipy.fft`` in float64; ``cwt_tc`` at (2, 512) on
    ``tc_scales(512)`` (``tests/test_cwt.py``); ``ewt`` with boundaries
    (0.1, 0.3) at (2, 1024), its bands summing to the input
    (``tests/test_ewt.py``).  Each reaches K1 (its plain version here) on
    the kernel route, the stage pipeline on the other."""
    port, jfn, shape, tables = _op(name, ROUTES[route])
    args, args2 = ([case_rng.standard_normal(shape).astype(np.float32)] for _ in range(2))
    hold(port, jfn, args, args2, within(TOL), tables=tables, warm=route == "kernel")
    got = _np(compiled(port)(torch.from_numpy(args[0])))
    if name in ("fht", "ifht"):
        assert _rel(got, getattr(scipy.fft, name)(args[0].astype(np.float64), 0.1, 2.0)) < 2e-5
    elif name == "ewt":
        assert got.shape == (2, 3, 1024)
        np.testing.assert_allclose(got.sum(axis=1), args[0], atol=2e-5)


def test_ewt_returns_its_boundaries_compiled_and_refuses_the_adaptive_form(case_rng):
    """The compiled pair: the bands and the boundaries as a host array, as
    eager returns them; the adaptive form (``n_bands``), which finds its
    boundaries on the host from a concrete signal, refuses to compile with
    its ValueError and stays an eager form."""
    x = torch.from_numpy(case_rng.standard_normal((2, 1024)).astype(np.float32))
    bands, bounds = compiled(lambda v: tp.ewt(v, boundaries=EWT_BOUNDARIES))(x)
    eager, ebounds = tp.ewt(x, boundaries=EWT_BOUNDARIES)
    assert isinstance(bounds, np.ndarray) and np.array_equal(bounds, ebounds)
    assert np.array_equal(ebounds, EWT_BOUNDARIES) and _rel(bands, eager) <= EAGER_TOL
    t = np.arange(1024)
    tones = torch.from_numpy((np.cos(2 * np.pi * 0.05 * t) + np.cos(2 * np.pi * 0.25 * t)
                              ).astype(np.float32))
    with pytest.raises(Exception, match=r"ValueError: ewt\(n_bands=\.\.\.\) cannot be "
                                        r"compiled") as info:
        compiled(lambda v: tp.ewt(v, n_bands=2))(tones)
    assert isinstance(info.value, (ValueError, torch._dynamo.exc.TorchDynamoException))
    assert tp.ewt(tones, n_bands=2)[0].shape == (2, 1024)


def _masked_like_jax(out, mag, value, n_cols, n_rows):
    """The JAX test's law of a masked spectrogram (``tests/test_tfr.py``):
    its shape, some and not all cells masked, masked cells forming whole
    rows and columns within the widths, the others untouched."""
    out = _np(out)
    assert out.shape == mag.shape
    masked = out == value
    assert masked.any() and not masked.all()
    for b in range(mag.shape[0]):
        assert len(np.where(masked[b].all(0))[0]) <= n_cols
        assert len(np.where(masked[b].all(1))[0]) <= n_rows
    assert np.array_equal(out[~masked], mag[~masked])


def _equal(got, eager):
    assert all(torch.equal(g, e) for g, e in zip(got, eager))


def test_specaugment_seed_compiles(case_rng):
    """``specaugment`` at the JAX test's call ((3, 40, 65), two frequency
    bands up to 10 wide, one time band up to 8, ``jax.jit`` with
    ``mask_value=-1``): the ``seed`` form and the default form compile
    whole, give the eager call's masks, and mask as the JAX function's law
    says; the seed form's draws are those of
    ``torch.Generator().manual_seed(seed)``."""
    kw = dict(n_freq_masks=2, freq_mask_width=10, n_time_masks=1, time_mask_width=8)
    mag, mag2 = (np.abs(case_rng.standard_normal((3, 40, 65))).astype(np.float32) + 0.1
                 for _ in range(2))
    for form in ({"seed": 3}, {}):
        port = lambda s, form=form: tp.specaugment(s, mask_value=-1.0, **form, **kw)  # noqa: E731
        hold(port, None, [mag], [mag2], None, eager_check=_equal)
        _masked_like_jax(compiled(port)(torch.from_numpy(mag)), mag, -1.0, 20, 8)
    seeded = compiled(lambda s: tp.specaugment(s, seed=3, **kw))(torch.from_numpy(mag))
    drawn = tp.specaugment(torch.from_numpy(mag), torch.Generator().manual_seed(3), **kw)
    assert torch.equal(seeded, drawn)
    key = jax.random.PRNGKey(0)
    want = np.asarray(jax.jit(lambda s, k: jsp.specaugment(s, k, mask_value=-1.0, **kw))(mag, key))
    _masked_like_jax(want, mag, -1.0, 20, 8)


def test_specaugment_seeds_keep_a_bounded_cache():
    """Eager calls with new seeds keep the draws of the eight latest only,
    and compiled calls of two seeds (a trace each) keep none: the kept
    tables stay as they were; a kept seed's masks are a fresh draw's."""
    S = torch.ones(2, 40, 65)
    tables, kept = tnum._TABLES, tfeat._kept_masks
    tp.specaugment(S, seed=0)
    size = len(tables)
    for seed in range(1, 12):
        tp.specaugment(S, seed=seed)
    assert len(tables) == size and kept.cache_info().currsize == 8
    for seed in (12, 13):
        compiled(lambda v, seed=seed: tp.specaugment(v, seed=seed))(S)
    assert len(tables) == size and kept.cache_info().currsize == 8
    mag = torch.rand(2, 40, 65, generator=torch.Generator().manual_seed(5)) + 0.1
    assert torch.equal(tp.specaugment(mag, seed=11),
                       tp.specaugment(mag, torch.Generator().manual_seed(11)))


def test_specaugment_generator_refuses_to_compile():
    """A caller's generator cannot enter a graph: ``generator=`` under
    compile raises its ValueError, and stays an eager form; a seed and a
    generator together are refused eagerly."""
    S = torch.ones(2, 40, 65)
    g = torch.Generator().manual_seed(1)
    with pytest.raises(Exception, match=r"ValueError: specaugment\(generator=\.\.\.\) cannot be "
                                        r"compiled") as info:
        compiled(lambda v: tp.specaugment(v, g))(S)
    assert isinstance(info.value, (ValueError, torch._dynamo.exc.TorchDynamoException))
    assert tp.specaugment(S, g).shape == S.shape
    with pytest.raises(ValueError, match="seed or generator"):
        tp.specaugment(S, g, seed=1)


@pytest.mark.parametrize("n", [64, 256])
def test_fwht_compiles_at_high(n, case_rng):
    """``fwht``'s dense Hadamard product (n <= 128) goes through
    ``utils.numerics.product``, so it compiles at "high" (on the CPU an fp32
    product, as eager's); its butterfly passes (n > 128) have no product.
    Against ``jax.jit`` of the JAX function and the eager port."""
    config = tp.SpectralConfig(precision="high")
    args, args2 = ([case_rng.standard_normal((3, n)).astype(np.float32)] for _ in range(2))
    hold(lambda v: tp.fwht(v, config=config), lambda v: jsp.fwht(v), args, args2, within(TOL),
         tables=("fwht.H",) if n <= 128 else (), warm=False)


EXPLAINED = {
    "fht": (lambda v: tp.fht(v, 0.1, 2.0), (2, 64)),
    "ifht": (lambda v: tp.ifht(v, 0.1, 2.0), (2, 64)),
    "cwt_tc": (lambda v: tp.cwt_tc(v, TC_SCALES), (2, 512)),
    "ewt": (lambda v: tp.ewt(v, boundaries=EWT_BOUNDARIES)[0], (2, 1024)),
    "specaugment": (lambda v: tp.specaugment(v, seed=0, mask_value=-1.0), (3, 40, 65)),
}


@pytest.mark.parametrize("name", EXPLAINED)
def test_explain_reads_one_graph(name, case_rng):
    """``torch._dynamo.explain`` at the JAX test's call: one graph, no
    break (the stage pipeline's route, a CPU tensor's default)."""
    fn, shape = EXPLAINED[name]
    out = torch._dynamo.explain(fn)(torch.from_numpy(
        case_rng.standard_normal(shape).astype(np.float32)))
    assert (out.graph_count, out.graph_break_count) == (1, 0), out.break_reasons
