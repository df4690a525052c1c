"""PyTorch port: the framed signal ops on batch-sharded DTensors
(``utils/sharding.py``): ``ops/stft.py``, ``ShortTimeFFT``'s transforms
and ``ops/signal.py``'s estimators, resamplers, cepstra and filters, in a
gloo world of 4 CPU processes on the mesh (4, 1), against ``jax.jit`` of
the JAX functions on the JAX package's sharded 4-device CPU mesh
(``shard_batch``), as ``tests/test_torch_parallel_batch.py`` holds the
transforms.

Each op runs on every rank's block and returns DTensors: sharded along the
batch where an output keeps it (the envelope's one axis later, behind its
(envelope, residual) pair), replicated where it holds none (the
estimators' frequencies, a 1-D filter).  A second signal (``csd``'s ``y``,
``tfestimate``'s output, ``ShortTimeFFT.spectrogram``'s ``y``) and
``icceps``'s delays are sharded alike.  ``deconvolve`` is host work in both
packages (``np.asarray`` gathers the array), so it is held to the JAX
function called eagerly; ``griffinlim`` draws its phases with ``jax.random``
in the JAX package, so its sharded call is held to the port's call on the
whole batch (the seeded draws of the global shape, each rank taking its
block's), which ``test_torch_compile_ops_tables.py`` holds to JAX.  On the
mesh (2, 2) an ``stft`` whose time axis is sharded over ``seq`` gathers it.
The world and its conventions are those of ``test_torch_parallel.py``."""

import numpy as np
import pytest

from test_torch_parallel import TOL, gathered, jax_mesh, real_input, rel, run_world

MESH = (4, 1)
T = 2048
FS = 1000.0


def _x(tag="x"):
    return real_input(f"framed {tag}", (8, T))


def _spec():
    """An STFT (8, 17 frames, 129 bins) of the test signal, made in numpy."""
    x = np.pad(_x(), ((0, 0), (128, 128)), mode="reflect")
    frames = np.lib.stride_tricks.sliding_window_view(x, 256, axis=-1)[:, ::128]
    return np.fft.rfft(frames * np.hanning(256), axis=-1).astype(np.complex64)


def _stfft(M):
    return M.ShortTimeFFT(np.hanning(128), 32, FS)


# name: (inputs (the batch array first), how many of them are sharded (the
# rest are host constants), call(package, *inputs), each output's batch axis
# or None where it has none)
CASES = {
    "stft": (lambda: (_x(),), 1, lambda M, x: M.stft(x, 256), (0,)),
    "istft": (lambda: (_spec(),), 1, lambda M, s: M.istft(s, 256), (0,)),
    "spectrogram": (lambda: (_x(),), 1, lambda M, x: M.spectrogram(x, 256), (0,)),
    "phase_vocoder": (lambda: (_spec(),), 1, lambda M, s: M.phase_vocoder(s, 1.3), (0,)),
    "time_stretch": (lambda: (_x(),), 1, lambda M, x: M.time_stretch(x, 1.25, 256), (0,)),
    "pitch_shift": (lambda: (_x(),), 1, lambda M, x: M.pitch_shift(x, FS, 2, nperseg=256),
                    (0,)),
    "ShortTimeFFT.stft": (lambda: (_x(),), 1, lambda M, x: _stfft(M).stft(x), (0,)),
    "ShortTimeFFT.stft_detrend": (lambda: (_x(),), 1,
                                  lambda M, x: _stfft(M).stft_detrend(x, "linear"), (0,)),
    "ShortTimeFFT.spectrogram": (lambda: (_x(), _x("y")), 2,
                                 lambda M, x, y: _stfft(M).spectrogram(x, y), (0,)),
    "ShortTimeFFT.istft": (lambda: (_x(),), 1,
                           lambda M, x: (lambda st: st.istft(st.stft(x), k1=T))(_stfft(M)),
                           (0,)),
    "spectral_diff": (lambda: (_x(),), 1, lambda M, x: M.spectral_diff(x), (0,)),
    "hilbert": (lambda: (_x(),), 1, lambda M, x: M.hilbert(x), (0,)),
    "hilbert2": (lambda: (real_input("framed image", (8, 16, 24)),), 1,
                 lambda M, x: M.hilbert2(x), (0,)),
    "periodogram": (lambda: (_x(),), 1, lambda M, x: M.periodogram(x, FS), (None, 0)),
    "csd": (lambda: (_x(), _x("y")), 2, lambda M, x, y: M.csd(x, y, FS, nperseg=256),
            (None, 0)),
    "coherence": (lambda: (_x(), _x("y")), 2,
                  lambda M, x, y: M.coherence(x, y, FS, nperseg=256), (None, 0)),
    "tfestimate": (lambda: (_x(), _x("y")), 2,
                   lambda M, x, y: M.tfestimate(x, y, FS, nperseg=256), (None, 0)),
    "welch": (lambda: (_x(),), 1, lambda M, x: M.welch(x, FS, nperseg=256), (None, 0)),
    "resample": (lambda: (_x(),), 1, lambda M, x: M.resample(x, 1500), (0,)),
    "upfirdn": (lambda: (_x(), real_input("framed taps", (11,))), 1,
                lambda M, x, h: M.upfirdn(h, x, 3, 2), (0,)),
    "resample_poly": (lambda: (_x(),), 1, lambda M, x: M.resample_poly(x, 2, 3), (0,)),
    "rceps": (lambda: (_x(),), 1, lambda M, x: M.rceps(x), (0,)),
    "cceps": (lambda: (_x(),), 1, lambda M, x: M.cceps(x), (0, 0)),
    "icceps": (lambda: (0.01 * _x(), np.arange(8, dtype=np.float32) - 4.0), 2,
               lambda M, x, d: M.icceps(x, d), (0,)),
    "minimum_phase": (lambda: (real_input("framed fir", (64,)),), 1,
                      lambda M, h: M.minimum_phase(h), (None,)),
    "detrend": (lambda: (_x(),), 1, lambda M, x: M.detrend(x), (0,)),
    "decimate": (lambda: (_x(),), 1, lambda M, x: M.decimate(x, 4), (0,)),
    "savgol_filter": (lambda: (_x(),), 1, lambda M, x: M.savgol_filter(x, 11, 3), (0,)),
    "envelope": (lambda: (_x(),), 1, lambda M, x: M.envelope(x, (1, 200)), (1,)),
    "goertzel": (lambda: (_x(),), 1,
                 lambda M, x: M.goertzel(x, np.array([50.0, 123.4]), fs=FS), (0,)),
}

# the phase vocoder's ops, held to JAX at test_torch_stft.py's VOCODER_TOL: a
# phase difference wrapped by ``round`` and summed over frames rounds apart in
# fp32 where a bin all but vanishes (the single-device calls differ as much)
VOCODER = {"phase_vocoder", "time_stretch", "pitch_shift"}
VOCODER_TOL = 2e-4

# host work in both packages: called eagerly on the sharded array
EAGER = {
    "deconvolve": (lambda: (real_input("framed poly", (64,)),), 1,
                   lambda M, s: M.deconvolve(s, np.array([1.0, 0.5, 0.25])), (None, None)),
}

# an op sharded along the axis it transforms: (mesh, spec, case)
ACROSS = {"stft_time_axis": ((2, 2), ("data", "seq"), "stft")}


def _outputs(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


def framed_world() -> dict:
    """Every case of this file (runs on each rank)."""
    import torch
    from torch.distributed.tensor import DTensor

    import mixed_radix_fast_fourier_transform_tpu_torch as tp
    from mixed_radix_fast_fourier_transform_tpu_torch import parallel as par
    from mixed_radix_fast_fourier_transform_tpu_torch.parallel.distributed import _local, _wrap

    out = {}
    meshes = {s: par.make_mesh(s, device="cpu") for s in ((4, 1), (2, 2))}
    mesh = meshes[MESH]

    def record(tag, result):
        for i, o in enumerate(_outputs(result)):
            out[f"{tag}/{i}"] = gathered(o) if isinstance(o, torch.Tensor) else np.asarray(o)
            out[f"{tag}/{i}/dims"] = np.array(
                [p.dim for p in o.placements if p.is_shard()] if isinstance(o, DTensor)
                else [-1])

    for name, (inputs, n_sharded, call, _) in {**CASES, **EAGER}.items():
        arrays = [torch.from_numpy(a) for a in inputs()]
        args = [par.shard_batch(a, mesh) for a in arrays[:n_sharded]] + arrays[n_sharded:]
        record(name, call(tp, *args))
        for i, o in enumerate(_outputs(call(tp, *arrays))):
            out[f"{name}/{i}/whole"] = o.numpy() if isinstance(o, torch.Tensor) else o
    for name, (shape, spec, case) in ACROSS.items():
        m = meshes[shape]
        x = torch.from_numpy(CASES[case][0]()[0])
        record(name, CASES[case][2](tp, _wrap(_local(x, m, spec), m, spec, x.shape)))

    mag = np.abs(_spec())
    sharded = tp.griffinlim(par.shard_batch(torch.from_numpy(mag), mesh), n_iter=4, seed=3)
    record("griffinlim", sharded)
    out["griffinlim/whole"] = tp.griffinlim(torch.from_numpy(mag), n_iter=4, seed=3).numpy()
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(__name__, "framed_world", tmp_path_factory.mktemp("batch_framed"))


def _held(world, name, want, axes, tol=TOL, whole=None):
    """Each output within ``tol`` of ``want`` and within 1e-5 of the port's
    call on the whole batch (``whole``'s outputs); sharded along its batch
    axis only, replicated where it holds no batch; the JAX output that
    keeps the batch is not fully replicated."""
    want = _outputs(want)
    assert len(want) == len(axes)
    for i, (w, axis) in enumerate(zip(want, axes)):
        assert rel(world[f"{name}/{i}"], w) <= tol, i
        if whole is not None:
            assert rel(world[f"{name}/{i}"], world[f"{whole}/{i}/whole"]) <= TOL, i
        assert world[f"{name}/{i}/dims"].tolist() == ([] if axis is None else [axis]), i
        if axis is not None:
            assert not w.sharding.is_fully_replicated, i


def _jax_call(call, inputs, n_sharded, jit=True):
    """``call`` of the JAX package on the first ``n_sharded`` inputs
    sharded over its 4-device mesh (``shard_batch``), the rest host
    constants of the call, under ``jax.jit`` (or eagerly)."""
    import jax
    import jax.numpy as jnp

    import mixed_radix_fast_fourier_transform_tpu as jsp
    from mixed_radix_fast_fourier_transform_tpu.parallel import shard_batch

    mesh = jax_mesh(MESH)
    arrays = inputs()
    sharded = [shard_batch(jnp.asarray(a), mesh) for a in arrays[:n_sharded]]
    fn = lambda *s: call(jsp, *s, *arrays[n_sharded:])  # noqa: E731
    return (jax.jit(fn) if jit else fn)(*sharded)


@pytest.mark.parametrize("case", sorted(CASES))
def test_framed_op_on_a_batch_sharded_dtensor_matches_jax(world, case):
    """``jax.jit`` of the JAX function on its sharded mesh (:func:`_held`;
    the phase vocoder's ops at ``VOCODER_TOL``)."""
    inputs, n_sharded, call, axes = CASES[case]
    _held(world, case, _jax_call(call, inputs, n_sharded), axes,
          VOCODER_TOL if case in VOCODER else TOL, whole=case)


def test_deconvolve_gathers_a_dtensor_as_jax_gathers_a_sharded_array(world):
    """``deconvolve`` is host work: a DTensor is gathered, as ``np.asarray``
    gathers the JAX package's sharded array, and the quotient and remainder
    are the JAX function's, exactly."""
    inputs, n_sharded, call, _ = EAGER["deconvolve"]
    for i, w in enumerate(_jax_call(call, inputs, n_sharded, jit=False)):
        np.testing.assert_array_equal(world[f"deconvolve/{i}"], w)
        assert world[f"deconvolve/{i}/dims"].tolist() == [-1]


@pytest.mark.parametrize("name", sorted(ACROSS))
def test_sharding_along_the_time_axis_gathers_it(world, name):
    """A DTensor sharded over ``seq`` along the axis the op frames gives the
    JAX values on the same layout; the batch stays sharded over ``data``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec

    import mixed_radix_fast_fourier_transform_tpu as jsp

    shape, spec, case = ACROSS[name]
    inputs, _, call, axes = CASES[case]
    x = jax.device_put(jnp.asarray(inputs()[0]),
                       NamedSharding(jax_mesh(shape), PartitionSpec(*spec)))
    _held(world, name, jax.jit(lambda v: call(jsp, v))(x), axes, whole=case)


def test_griffinlim_on_a_batch_sharded_dtensor_is_the_whole_batch_call(world):
    """The seeded draws are those of the whole batch, each rank taking its
    block's: the sharded call equals the call on the whole batch within
    1e-5, sharded along the batch."""
    assert rel(world["griffinlim/0"], world["griffinlim/whole"]) <= TOL
    assert world["griffinlim/0/dims"].tolist() == [0]
