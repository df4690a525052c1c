"""PyTorch port under ``torch.compile``: the ops whose JAX functions run a
``lax.scan``, the port's loop operators (``utils.scan.fori_loop`` and
``scan``) alone, and the product sites of ``mel.py`` and ``feature.py``.

``tempo`` (its lag grid and prior a host table, the pick a gather) and
``beat_track`` (the dynamic programme a ``scan`` over frames, the
backtrace a reverse ``scan``), each at its JAX test's call and shape, with
the checks of ``test_torch_compile_ops.py`` (one graph, ``jax.jit`` of the
JAX op and the eager port matched, no recompile, cold and warm table
caches, no traced tensor kept), the JAX tests' refusals under compile, and
a graph whose size does not grow with the frame count: the loop's body is
traced once.  ``melspectrogram`` and ``chroma_stft`` compile at "high"
(their products go through ``utils.numerics.product``).  ``vmd`` is in
``test_torch_compile_ops_vmd.py``, ``scattering1d``/``scattering2d`` in
``test_torch_compile_ops_scattering.py``."""

import numpy as np
import pytest
import torch

import mixed_radix_fast_fourier_transform_tpu as jsp

import mixed_radix_fast_fourier_transform_tpu_torch as tp
from mixed_radix_fast_fourier_transform_tpu_torch.utils import scan as tscan

from test_torch_compile_ops import (  # noqa: F401  (fixtures)
    EAGER_TOL, ROUTES, TOL, _np, _rel, case_rng, compiled, fresh_dynamo, hold, within,
)

torch.set_num_threads(1)

SR = 22050.0


def _clicks(period: int, seconds: int = 4) -> np.ndarray:
    """The JAX test's click track: unit clicks every ``period`` samples."""
    x = np.zeros(22050 * seconds, np.float32)
    x[::period] = 1.0
    return x


# ---------------------------------------------------------------------------
# the loop operators alone


def _dp_step(carry, o):
    """A max-plus step with an int64 counter in its carry, shaped as the
    beat tracker's."""
    buf, t = carry
    cand = torch.where(torch.arange(buf.shape[0]) < t, buf - 0.1, torch.full_like(buf, -1e9))
    best, arg = torch.max(cand, dim=0)
    score = o + torch.clamp(best, min=0.0)
    return (torch.cat([score[None], buf[:-1]]), t + 1), (score, arg)


def _python_scan(step, carry, xs, reverse=False):
    order = range(len(xs) - 1, -1, -1) if reverse else range(len(xs))
    ys = [None] * len(xs)
    for t in order:
        carry, ys[t] = step(carry, xs[t])
    return carry, ys


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
def test_scan_equals_the_python_loop_eager_and_compiled(reverse, case_rng):
    """``scan`` eagerly equals the Python loop over the slices (``ys[i]``
    is ``xs[i]``'s output in both directions, as ``lax.scan``'s), and
    compiled (one graph) equals eager exactly."""
    xs = torch.from_numpy(case_rng.standard_normal(40).astype(np.float32))
    init = (torch.full((6,), -1e9), torch.zeros((), dtype=torch.int64))
    carry, (scores, args) = tscan.scan(_dp_step, init, xs, reverse=reverse)
    want_carry, want = _python_scan(_dp_step, init, xs, reverse)
    assert all(torch.equal(a, b) for a, b in zip(carry, want_carry))
    assert torch.equal(scores, torch.stack([y[0] for y in want]))
    assert torch.equal(args, torch.stack([y[1] for y in want]))
    counters = torch._dynamo.utils.counters
    counters.clear()
    got = compiled(lambda v: tscan.scan(_dp_step, init, v, reverse=reverse))(xs)
    assert counters["stats"]["unique_graphs"] == 1 and not counters["graph_break"]
    flat = lambda tree: torch.utils._pytree.tree_leaves(tree)  # noqa: E731
    assert all(torch.equal(g, e) for g, e in zip(flat(got), flat((carry, (scores, args)))))


def _wiener_sweep(i, state):
    """A sweep of complex64 Wiener updates (VMD's shape), with a carry
    handed back as it came (``lam``) and one that reads the counter."""
    u, lam, om = state
    u = (u * 0.5 + lam + 1.0j) / (1.0 + om[..., None] ** 2)
    om = om + 0.01 * torch.sum(u.real ** 2 + u.imag ** 2, dim=-1) / u.shape[-1]
    return u, lam, om + 0.0 * i


def test_fori_loop_equals_the_python_loop_eager_and_compiled(case_rng):
    """``fori_loop`` eagerly equals the Python loop (``i`` an int), and
    compiled (one graph; complex64 and real carries, one of them a
    strided view, one handed back unchanged) equals eager; an empty range
    gives ``init`` back."""
    u0 = torch.from_numpy((case_rng.standard_normal((3, 16))
                           + 1j * case_rng.standard_normal((3, 16))).astype(np.complex64))
    lam = torch.from_numpy(case_rng.standard_normal((3, 16)).astype(np.complex64))
    om = torch.from_numpy(case_rng.standard_normal((3, 2)).astype(np.float32))[:, 0]  # strided
    got = tscan.fori_loop(2, 9, _wiener_sweep, (u0, lam, om))
    want = (u0, lam, om)
    for i in range(2, 9):
        want = _wiener_sweep(i, want)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    counters = torch._dynamo.utils.counters
    counters.clear()
    comp = compiled(lambda a, b, c: tscan.fori_loop(2, 9, _wiener_sweep, (a, b, c)))(u0, lam, om)
    assert counters["stats"]["unique_graphs"] == 1 and not counters["graph_break"]
    assert comp[0].dtype == torch.complex64
    assert all(_rel(c, w) <= EAGER_TOL for c, w in zip(comp, got))
    assert tscan.fori_loop(3, 3, _wiener_sweep, want) is want


# ---------------------------------------------------------------------------
# tempo and beat_track


def _beats_equal(eager: bool):
    """The (bpm, beat mask) pair: the mask equal, the tempo within 1e-6 of
    eager's or, against the JAX function (a pick from one lag grid), equal."""
    def check(got, want):
        bpm, want_bpm = float(_np(got[0])), float(np.asarray(want[0]))
        assert abs(bpm - want_bpm) <= EAGER_TOL * abs(want_bpm) if eager else bpm == want_bpm
        mask, want_mask = _np(got[1]), np.asarray(want[1])
        assert mask.dtype == bool and np.array_equal(mask, want_mask)
    return check


def _jax_beats(v):
    return jsp.beat_track(v, SR)


@pytest.mark.parametrize("route", ROUTES)
def test_beat_track_compiles_whole(route):
    """At the JAX test's call (``tests/test_feature.py``: 4 s of clicks
    every 11,025 samples at 22,050 Hz, 173 frames, ``jax.jit`` of the beat
    mask): one graph, ``tempo`` inside it, the beats and the tempo of the
    JAX function and of eager (the mask boolean, with beats), then without
    a recompile another track (clicks every 8,820) or, on the stage
    pipeline's route, silence, which has no beat (the silence gate, the
    JAX test's other case).  The port's tables (the mel filterbank, the
    tempo grid) are host builds."""
    config = ROUTES[route]
    port = lambda v: tp.beat_track(v, SR, config=config)  # noqa: E731
    second = _clicks(8820) if route == "kernel" else np.zeros(88200, np.float32)
    hold(port, _jax_beats, [_clicks(11025)], [second], _beats_equal(False),
         eager_check=_beats_equal(True), tables=("feature.tempo", "mel.filterbank"),
         warm=route == "kernel")
    mask = port(torch.from_numpy(_clicks(11025)))[1]
    assert mask.dtype == torch.bool and bool(mask.any())
    assert bool(port(torch.from_numpy(second))[1].any()) == (route == "kernel")


def test_beat_track_refusal_compiled():
    """The JAX test's refusal (a batch of signals) raises its ValueError
    under compile as eagerly."""
    fn = lambda v: tp.beat_track(v, SR)  # noqa: E731
    with pytest.raises(ValueError, match="single signal"):
        fn(torch.zeros(2, 8192))
    with pytest.raises(Exception, match="single signal"):
        compiled(fn)(torch.zeros(2, 8192))


def _jax_tempo(v):
    return jsp.tempo(v, SR)


@pytest.mark.parametrize("route", ROUTES)
def test_tempo_compiles_whole(route):
    """``tempo`` of the JAX test's click track (and of a batch of two):
    one graph, the JAX function's tempo exactly (a pick from one grid),
    eager's within 1e-6, no recompile; a BPM window that holds no lag
    raises the JAX function's ValueError from the host, compiled as
    eagerly."""
    config = ROUTES[route]
    port = lambda v: tp.tempo(v, SR, config=config)  # noqa: E731
    batch = np.stack([_clicks(11025), _clicks(7350)])

    def equal(got, want):
        assert np.array_equal(_np(got[0]), np.asarray(want[0]))

    hold(port, _jax_tempo, [batch], [batch[::-1].copy()], equal,
         tables=("feature.tempo",), warm=False)
    narrow = lambda v: tp.tempo(onset_env=v, sr=SR, min_bpm=300.0, max_bpm=301.0)  # noqa: E731
    env = torch.rand(16, generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="BPM window excludes every lag"):
        narrow(env)
    with pytest.raises(Exception, match="ValueError: BPM window excludes every lag"):
        compiled(narrow)(env)


# ---------------------------------------------------------------------------
# the product sites of mel.py and feature.py


HIGH = tp.SpectralConfig(precision="high")


@pytest.mark.parametrize("name", ["melspectrogram", "chroma_stft"])
def test_feature_products_compile_at_high(name, case_rng):
    """``melspectrogram``'s filterbank product and ``chroma_stft``'s
    chroma product go through ``utils.numerics.product``, so a "high"
    config compiles (on the CPU an fp32 product, as eager's), against
    ``jax.jit`` of the JAX function and the eager port."""
    if name == "melspectrogram":
        port = lambda v: tp.melspectrogram(v, 16000.0, 512, n_mels=40, config=HIGH)  # noqa: E731
        jfn = lambda v: jsp.melspectrogram(v, 16000.0, 512, n_mels=40)  # noqa: E731
    else:
        port = lambda v: tp.chroma_stft(v, SR, config=HIGH)  # noqa: E731
        jfn = lambda v: jsp.chroma_stft(v, SR)  # noqa: E731
    args, args2 = ([case_rng.standard_normal((2, 8192)).astype(np.float32)] for _ in range(2))
    hold(port, jfn, args, args2, within(TOL), warm=False)


# ---------------------------------------------------------------------------
# the graph does not grow with the trip count


def graph_nodes(fn, *args) -> int:
    """Nodes of the graph dynamo captures for ``fn``, its loop bodies'
    subgraphs counted too."""
    sizes = []

    def count(gm, example_inputs):
        sizes.append(sum(len(m.graph.nodes) for m in gm.modules()
                         if isinstance(m, torch.fx.GraphModule)))
        return gm.forward

    torch._dynamo.reset()
    torch.compile(fn, backend=count, fullgraph=True, dynamic=False)(*args)
    assert len(sizes) == 1
    return sizes[0]


def test_beat_track_graph_does_not_grow_with_the_frame_count(case_rng):
    """``beat_track`` on envelopes of 173 and of 400 frames captures
    graphs of the same size: the frame step and the backtrace's step are
    loop bodies traced once.  On K1's route, whose transform is one
    operator node at any length (``tempo``'s autocorrelation is 512 long at
    173 frames and 1,024 at 400, and the stage pipeline's graph has a pass
    per radix)."""
    config = ROUTES["kernel"]
    envs = [torch.from_numpy(np.abs(case_rng.standard_normal(n)).astype(np.float32))
            for n in (173, 400)]
    frames = [graph_nodes(lambda e: tp.beat_track(onset_env=e, sr=SR, config=config), e)
              for e in envs]
    assert frames[0] == frames[1]


KERNEL = ROUTES["kernel"]
EXPLAINED = {
    "beat_track": lambda v: tp.beat_track(v, SR, config=KERNEL)[1],
    "tempo": lambda v: tp.tempo(v, SR, config=KERNEL),
}


@pytest.mark.parametrize("name", EXPLAINED)
def test_explain_reads_one_graph(name):
    """``torch._dynamo.explain`` at the JAX test's call: one graph, no
    break, on K1's route (the stage pipeline's route is held to one graph
    by ``hold``'s counters)."""
    out = torch._dynamo.explain(EXPLAINED[name])(torch.from_numpy(_clicks(11025)))
    assert (out.graph_count, out.graph_break_count) == (1, 0), out.break_reasons
