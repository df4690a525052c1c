"""PyTorch port under ``torch.compile``: the direct convolution, the
compensated SHT recurrence (its degree step the operator
``mixed_radix_sht::dw_step``, which runs the error-free chain op by op), and
what the CPU can show of two repairs for Inductor on a card: the odd
extension of ``sosfiltfilt``/``filtfilt`` as one gather by a kept host index
table (no flipped slice), and ``ssq_cwt``'s bin centres as a kept host
table (no array computed in the graph).

On the CPU with ``backend="aot_eager"``, ``fullgraph=True, dynamic=False``,
at torch's default flags (cuDNN's TF32 on: the convolutions carry their
precision as ``mixed_radix_precision::convolution``), against the eager
port, scipy float64 and the JAX functions under ``jax.jit``.
"""

import jax
import numpy as np
import pytest
import scipy.signal
import torch

from mixed_radix_fast_fourier_transform_tpu.ops import sht as jsht

import mixed_radix_fast_fourier_transform_tpu_torch as tp
from mixed_radix_fast_fourier_transform_tpu_torch.ops import iir as tiir
from mixed_radix_fast_fourier_transform_tpu_torch.utils import numerics

from test_torch_compile_precision import (  # noqa: F401  (default_flags is autouse)
    EAGER_TOL, TOL, _graph_targets, _rel, _whole, case_rng, default_flags,
)

torch.set_num_threads(1)


def test_dw_step_operator_passes_opcheck_and_is_the_chain():
    """The compensated degree step: its schema and fake, and its value the
    double-word chain op by op, bit for bit."""
    g = torch.Generator().manual_seed(4)
    a, a_lo, b, b_lo = (torch.randn(6, 1, generator=g) * s for s in (1, 1e-8, 1, 1e-8))
    mu, mu_lo = torch.rand(1, 5, generator=g), torch.rand(1, 5, generator=g) * 1e-8
    p1, p1_lo, p2, p2_lo = (torch.randn(6, 5, generator=g) * s for s in (1, 1e-8, 1, 1e-8))
    args = (a, a_lo, mu, mu_lo, p1, p1_lo, b, b_lo, p2, p2_lo)
    torch.library.opcheck(torch.ops.mixed_radix_sht.dw_step.default, args)
    ch, cl = numerics.dw_mul(a, a_lo, mu, mu_lo)
    t1 = numerics.dw_mul(ch, cl, p1, p1_lo)
    t2 = numerics.dw_mul(b, b_lo, p2, p2_lo)
    want = numerics.dw_add(t1[0], t1[1], -t2[0], -t2[1])
    got = torch.ops.mixed_radix_sht.dw_step(*args)
    assert all(torch.equal(u, v) for u, v in zip(got, want))


# ---------------------------------------------------------------------------
# The direct convolution and the compensated recurrence


@pytest.mark.parametrize("shapes", [((3, 40), (2, 7)), ((12, 10), (4, 5)),
                                    ((6, 5, 7), (3, 2, 4))], ids=["1d", "2d", "3d"])
def test_direct_convolution_compiles_whole(case_rng, shapes):
    """``convolve(method="direct")`` in every mode, and ``correlate``,
    compiled whole: bit-equal to eager, and against scipy float64."""
    a64, k64 = (case_rng.standard_normal(s) for s in shapes)
    a, k = (torch.from_numpy(v.astype(np.float32)) for v in (a64, k64))

    def run(u, v):
        return tuple(tp.convolve(u, v, mode=m, method="direct") for m in ("full", "same", "valid")
                     ) + (tp.correlate(u, v, method="direct"),)

    got, _ = _whole(run, a, k)
    for g, e in zip(got, run(a, k)):
        assert torch.equal(g, e)
    want = [scipy.signal.convolve(a64, k64, mode=m, method="direct")
            for m in ("full", "same", "valid")]
    want.append(scipy.signal.correlate(a64, k64, method="direct"))
    for g, w in zip(got, want):
        assert _rel(g, w) <= TOL


def test_auto_convolution_that_picks_direct_compiles(case_rng):
    """``method="auto"`` with 16 taps or fewer takes the direct form, and
    compiles whole to eager's values."""
    a, k = (torch.from_numpy(case_rng.standard_normal(s).astype(np.float32))
            for s in ((4, 300), (4, 9)))
    assert tp.choose_conv_method(a, k) == "direct"
    got, _ = _whole(lambda u, v: tp.convolve(u, v, mode="same"), a, k)
    assert torch.equal(got, tp.convolve(a, k, mode="same"))


@pytest.mark.parametrize("direction", ["analysis", "synthesis"])
def test_compensated_recurrences_compile_bit_equal(case_rng, direction):
    """``sht_recurrence(compensated=True)`` of a real field and
    ``isht_recurrence(compensated=True)`` to a complex one at the JAX
    test's L = 16, compiled whole: bit-equal to eager (the degree step is
    one operator node, so nothing contracts its chain), and against the JAX
    functions under ``jax.jit``."""
    L = 16
    f = case_rng.standard_normal((2, L, 2 * L)).astype(np.float32)
    if direction == "analysis":
        arg, fn = f, (lambda u: tp.sht_recurrence(u, compensated=True))
        jfn = lambda u: jsht.sht_recurrence(u, compensated=True)  # noqa: E731
    else:
        arg = np.array(jax.jit(jsht.sht)(f))
        fn = lambda v: tp.isht_recurrence(v, compensated=True)  # noqa: E731
        jfn = lambda v: jsht.isht_recurrence(v, compensated=True)  # noqa: E731
    got, _ = _whole(fn, torch.from_numpy(arg))
    assert torch.equal(got, fn(torch.from_numpy(arg)))
    assert _rel(got, np.asarray(jax.jit(jfn)(arg))) <= TOL


# ---------------------------------------------------------------------------
# The repairs (F17, F18): what the CPU can show


def test_odd_extension_is_a_gather_and_sosfiltfilt_compiles():
    """The odd extension is one gather by a kept index table (no flip in
    its graph), equal to scipy's ``odd_ext``; ``sosfiltfilt`` over it
    compiled equals eager."""
    x = torch.from_numpy(np.random.default_rng(8).standard_normal((3, 64)).astype(np.float32))
    targets = _graph_targets(lambda v: tiir._odd_ext(v, 9), x)
    assert not any("flip" in t for t in targets) and any("where" in t for t in targets)
    want = scipy.signal._arraytools.odd_ext(x.numpy().astype(np.float64), 9)
    assert np.array_equal(tiir._odd_ext(x, 9).numpy(), want.astype(np.float32))
    sos = scipy.signal.butter(6, 0.2, output="sos")
    got, _ = _whole(lambda v: tp.sosfiltfilt(sos, v), x)
    assert _rel(got, tp.sosfiltfilt(sos, x)) <= EAGER_TOL


def test_ssq_cwt_bin_centres_come_from_a_kept_table():
    """Compiled, ``ssq_cwt`` returns the eager bin centres bit for bit, a
    view of the kept host table (no array is computed in the graph);
    eagerly a new array."""
    x = torch.from_numpy(np.random.default_rng(9).standard_normal((2, 256)).astype(np.float32))
    kw = dict(n_scales=16, fmin=0.02, fmax=0.4)
    (S, freqs), _ = _whole(lambda v: tp.ssq_cwt(v, **kw), x)
    eS, efreqs = tp.ssq_cwt(x, **kw)
    assert isinstance(freqs, np.ndarray) and freqs.dtype == np.float64
    assert np.array_equal(freqs, efreqs)
    assert np.array_equal(S.sum(-2).numpy(), eS.sum(-2).numpy())
    key = ("tfr.ssq_cwt_bins", 0.02, 0.4, 16)
    table = numerics._TABLES[(key, torch.device("cpu"), torch.float64)]
    assert np.shares_memory(freqs, table.numpy())
    assert not np.shares_memory(efreqs, table.numpy())
