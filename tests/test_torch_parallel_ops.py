"""PyTorch port: the batch-sharded and sharded ops of ``parallel/`` (NUFFT,
SHT, Kalman, PFB, radar, the batched FFT) in a gloo world of 4 CPU
processes against the JAX package's single-chip functions on the global
input, as JAX's own tests hold its sharded forms; then the last utilities:
``utils/cache.py``, ``utils/aot.py``, ``enable_logging``, the four-step
memory budget and ``next_splittable_len``.  The world and its conventions
are those of ``test_torch_parallel.py``."""

import logging
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_parallel import (
    MESHES, TOL, complex_input, gathered, jax_mesh, mesh_id, real_input, rel, rng_for,
    run_errors, run_world,
)

import mixed_radix_fast_fourier_transform_tpu_torch as tp
from mixed_radix_fast_fourier_transform_tpu_torch.utils import cache, metrics, profiling

torch.set_num_threads(1)

M_POINTS = 301      # does not divide the mesh axis: the padded path
L = 16


def points(name: str, m: int = M_POINTS) -> np.ndarray:
    return rng_for(name).uniform(0.0, 2.0 * np.pi, m).astype(np.float32)


def kalman_model():
    dt = 0.1
    F = np.array([[1.0, dt], [0.0, 1.0]])
    Q = 0.01 * np.array([[dt ** 3 / 3, dt ** 2 / 2], [dt ** 2 / 2, dt]])
    H = np.array([[1.0, 0.0]])
    R = np.array([[0.05]])
    return F, Q, H, R, np.zeros(2), np.eye(2)


def _tx() -> np.ndarray:
    return complex_input("tx", (32,))


# (port call, JAX single-chip call, inputs): call(P, mesh, *inputs) with P the
# port's parallel module; single(J, *inputs) with J the JAX package.
CASES = {
    "nufft1": (lambda P, m, x, c: P.nufft1_sharded(x, c, 48, m),
               lambda J, x, c: J.nufft1(x, c, 48, method="grid"),
               lambda: (points("n1x"), complex_input("n1c", (2, M_POINTS)))),
    "nufft1_isign": (lambda P, m, x, c: P.nufft1_sharded(x, c, 33, m, isign=1, eps=1e-4),
                     lambda J, x, c: J.nufft1(x, c, 33, isign=1, eps=1e-4, method="grid"),
                     lambda: (points("n1ix"), complex_input("n1ic", (M_POINTS,)))),
    "nufft2": (lambda P, m, x, f: P.nufft2_sharded(x, f, m),
               lambda J, x, f: J.nufft2(x, f, method="grid"),
               lambda: (points("n2x"), complex_input("n2f", (2, 40)))),
    "nufft1_2d": (lambda P, m, x, y, c: P.nufft1_2d_sharded(x, y, c, (16, 12), m),
                  lambda J, x, y, c: J.nufft1_2d(x, y, c, (16, 12), method="grid"),
                  lambda: (points("n12x"), points("n12y"), complex_input("n12c", (M_POINTS,)))),
    "nufft2_2d": (lambda P, m, x, y, f: P.nufft2_2d_sharded(x, y, f, m, isign=-1),
                  lambda J, x, y, f: J.nufft2_2d(x, y, f, isign=-1, method="grid"),
                  lambda: (points("n22x"), points("n22y"), complex_input("n22f", (2, 16, 12)))),
    "sht_real": (lambda P, m, f: P.sht_sharded(f, m),
                 lambda J, f: J.sht(f),
                 lambda: (real_input("shtr", (2, L, 2 * L)),)),
    "sht_complex": (lambda P, m, f: P.sht_sharded(f, m),
                    lambda J, f: J.sht(f),
                    lambda: (complex_input("shtc", (L, 2 * L)),)),
    "sht_equiangular": (lambda P, m, f: P.sht_sharded(f, m, grid="equiangular"),
                        lambda J, f: J.sht(f, grid="equiangular"),
                        lambda: (real_input("shte", (2 * L, 2 * L)),)),
    "isht": (lambda P, m, a: P.isht_sharded(a, m),
             lambda J, a: J.isht(a),
             lambda: (complex_input("isht", (2, 2 * L - 1, L)),)),
    "isht_equiangular": (lambda P, m, a: P.isht_sharded(a, m, grid="equiangular"),
                         lambda J, a: J.isht(a, grid="equiangular"),
                         lambda: (complex_input("ishte", (2 * L - 1, L)),)),
    "sht_recurrence": (lambda P, m, f: P.sht_recurrence_sharded(f, m),
                       lambda J, f: J.sht_recurrence(f),
                       lambda: (complex_input("shtrec", (2, L, 2 * L)),)),
    "sht_recurrence_compensated": (
        lambda P, m, f: P.sht_recurrence_sharded(f, m, compensated=True),
        lambda J, f: J.sht_recurrence(f, compensated=True),
        lambda: (real_input("shtrecc", (L, 2 * L)),)),
    "isht_recurrence": (lambda P, m, a: P.isht_recurrence_sharded(a, m),
                        lambda J, a: J.isht_recurrence(a),
                        lambda: (complex_input("ishtrec", (2 * L - 1, L)),)),
    "isht_recurrence_real": (
        lambda P, m, a: P.isht_recurrence_sharded(a, m, real_output=True, compensated=True),
        lambda J, a: J.isht_recurrence(a, real_output=True, compensated=True),
        lambda: (complex_input("ishtrecr", (2, 2 * L - 1, L)),)),
    "fft_batch_sharded": (lambda P, m, x: P.fft_batch_sharded(x, m),
                          lambda J, x: J.fft(x),
                          lambda: (complex_input("fbs", (8, 360)),)),
    "ifft_batch_sharded": (lambda P, m, x: P.fft_batch_sharded(x, m, inverse=True, norm="ortho"),
                           lambda J, x: J.ifft(x, norm="ortho"),
                           lambda: (complex_input("ifbs", (4, 96)),)),
    "pfb_analysis": (lambda P, m, x: P.pfb_analysis_sharded(x, 16, m, taps_per_branch=4),
                     lambda J, x: J.pfb_analysis(x, 16, 4),
                     lambda: (real_input("pfb", (4, 4096)),)),
}

# the tuple-valued ones: each output compared on its own
KALMAN = ("kalman_filter", "kalman_smoother")


def _radar_rx():
    return complex_input("rx", (4, 32, 256))


ERRORS = {   # name: (mesh shape, call, same message as the JAX function)
    "nufft1_x_2d": ((1, 4), lambda P, m: P.nufft1_sharded(
        np.zeros((2, 3), np.float32), np.zeros(3, np.complex64), 8, m), True),
    "nufft1_strengths": ((1, 4), lambda P, m: P.nufft1_sharded(
        np.zeros(4, np.float32), np.zeros(5, np.complex64), 8, m), True),
    "nufft1_modes": ((1, 4), lambda P, m: P.nufft1_sharded(
        np.zeros(4, np.float32), np.zeros(4, np.complex64), 0, m), True),
    "nufft2_empty": ((1, 4), lambda P, m: P.nufft2_sharded(
        np.zeros(4, np.float32), np.zeros((2, 0), np.complex64), m), True),
    "nufft1_2d_lengths": ((1, 4), lambda P, m: P.nufft1_2d_sharded(
        np.zeros(4, np.float32), np.zeros(5, np.float32), np.zeros(4, np.complex64), (4, 4), m),
        True),
    "nufft1_2d_modes": ((1, 4), lambda P, m: P.nufft1_2d_sharded(
        np.zeros(4, np.float32), np.zeros(4, np.float32), np.zeros(4, np.complex64), (0, 4), m),
        True),
    "nufft2_2d_f": ((1, 4), lambda P, m: P.nufft2_2d_sharded(
        np.zeros(4, np.float32), np.zeros(4, np.float32), np.zeros(4, np.complex64), m), True),
    "sht_shape": ((1, 4), lambda P, m: P.sht_sharded(np.zeros((4, 4), np.float32), m), True),
    "sht_latitudes": ((1, 4), lambda P, m: P.sht_sharded(np.zeros((6, 12), np.float32), m), True),
    "sht_equiangular_odd": ((1, 4), lambda P, m: P.sht_sharded(
        np.zeros((5, 5), np.float32), m, grid="equiangular"), True),
    "isht_alm": ((1, 4), lambda P, m: P.isht_sharded(np.zeros((4, 4), np.complex64), m), True),
    "isht_latitudes": ((1, 4), lambda P, m: P.isht_sharded(np.zeros((11, 6), np.complex64), m),
                       True),
    "sht_recurrence_latitudes": ((1, 4), lambda P, m: P.sht_recurrence_sharded(
        np.zeros((6, 12), np.float32), m), True),
    "isht_recurrence_alm": ((1, 4), lambda P, m: P.isht_recurrence_sharded(
        np.zeros((4, 4), np.complex64), m), True),
    "kalman_ndim": ((4, 1), lambda P, m: P.kalman_filter_sharded(
        *kalman_model(), np.zeros((4, 10)), m), True),
    "pfb_ndim": ((4, 1), lambda P, m: P.pfb_analysis_sharded(np.zeros(64, np.float32), 4, m),
                 True),
    "pfb_batch": ((4, 1), lambda P, m: P.pfb_analysis_sharded(
        np.zeros((3, 64), np.float32), 4, m), True),
    "radar_ndim": ((4, 1), lambda P, m: P.range_doppler_cfar_sharded(
        np.zeros((32, 256), np.complex64), _tx(), m), True),
    "radar_batch": ((4, 1), lambda P, m: P.range_doppler_cfar_sharded(
        np.zeros((3, 32, 256), np.complex64), _tx(), m), True),
    "kalman_batch": ((4, 1), lambda P, m: P.kalman_filter_sharded(
        *kalman_model(), np.zeros((3, 10, 1)), m), False),
}


def ops_world() -> dict:
    """Every case of this file on every mesh (runs on each rank)."""
    from mixed_radix_fast_fourier_transform_tpu_torch import parallel as par

    out = {}
    ys = real_input("tracks", (4, 40, 1))
    for shape in MESHES:
        mesh = par.make_mesh(shape, device="cpu")
        tag = mesh_id(shape)
        for name, (call, _, inputs) in CASES.items():
            out[f"{tag}/{name}"] = gathered(call(par, mesh, *inputs()))
        for name in KALMAN:
            ms, Ps = par.kalman_filter_sharded(*kalman_model(), ys, mesh,
                                               smooth=name == "kalman_smoother")
            out[f"{tag}/{name}_m"], out[f"{tag}/{name}_P"] = gathered(ms), gathered(Ps)
        Y, det, th = par.range_doppler_cfar_sharded(_radar_rx(), _tx(), mesh)
        out[f"{tag}/radar_Y"], out[f"{tag}/radar_det"] = gathered(Y), gathered(det)
        out[f"{tag}/radar_th"] = gathered(th)
        sharded = par.shard_batch(complex_input("fbs", (8, 360)), mesh)
        out[f"{tag}/shard_batch"] = np.array(
            [repr(list(sharded.placements)), str(tuple(sharded.to_local().shape))])
    for shape in {s for s, _, _ in ERRORS.values()}:
        mesh = par.make_mesh(shape, device="cpu")
        calls = {k: c for k, (s, c, _) in ERRORS.items() if s == shape}
        for name, msg in run_errors(calls, mesh, par).items():
            out[f"error/{name}"] = np.array(msg)
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(__name__, "ops_world", tmp_path_factory.mktemp("ops"))


@pytest.mark.parametrize("shape", MESHES, ids=mesh_id)
@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_jax_single_chip(world, case, shape):
    import jax

    import mixed_radix_fast_fourier_transform_tpu as jsp

    _, single, inputs = CASES[case]
    want = np.asarray(jax.jit(lambda *a: single(jsp, *a))(*inputs()))
    assert rel(world[f"{mesh_id(shape)}/{case}"], want) <= TOL


@pytest.mark.parametrize("shape", MESHES, ids=mesh_id)
@pytest.mark.parametrize("name", KALMAN)
def test_kalman_sharded_matches_jax_single_chip(world, name, shape):
    import jax

    import mixed_radix_fast_fourier_transform_tpu as jsp

    fn = jsp.kalman_smoother if name == "kalman_smoother" else jsp.kalman_filter
    ys = real_input("tracks", (4, 40, 1))
    model = kalman_model()
    ms, Ps = jax.jit(jax.vmap(lambda y: fn(*model, y, parallel=True)))(ys)
    tag = mesh_id(shape)
    assert rel(world[f"{tag}/{name}_m"], ms) <= TOL
    assert rel(world[f"{tag}/{name}_P"], Ps) <= TOL


@pytest.mark.parametrize("shape", MESHES, ids=mesh_id)
def test_range_doppler_cfar_sharded_matches_jax_single_chip(world, shape):
    import jax

    import mixed_radix_fast_fourier_transform_tpu as jsp

    def chain(rx):
        Y = jsp.range_doppler(rx, _tx())
        det, th = jsp.cfar(jax.numpy.abs(Y) ** 2, axes=(-2, -1))
        return Y, det, th

    Y, det, th = jax.jit(chain)(_radar_rx())
    tag = mesh_id(shape)
    assert rel(world[f"{tag}/radar_Y"], Y) <= TOL
    assert rel(world[f"{tag}/radar_th"], th) <= TOL
    np.testing.assert_array_equal(world[f"{tag}/radar_det"], np.asarray(det))


@pytest.mark.parametrize("shape", MESHES, ids=mesh_id)
def test_shard_batch_places_the_leading_axis(world, shape):
    placements, local = world[f"{mesh_id(shape)}/shard_batch"]
    assert placements == "[Shard(dim=0), Replicate()]"
    assert local == str((8 // shape[0], 360))


@pytest.mark.parametrize("name", sorted(ERRORS))
def test_value_errors_match_jax(world, name):
    from mixed_radix_fast_fourier_transform_tpu import parallel as jpar

    shape, call, same = ERRORS[name]
    got = str(world[f"error/{name}"])
    want = run_errors({name: call}, jax_mesh(shape), jpar)[name]
    assert got and want
    if same:
        assert got == want


# ---------------------------------------------------------------------------
# The last utilities (no world needed).
# ---------------------------------------------------------------------------


def test_save_load_plans_round_trip(tmp_path):
    from mixed_radix_fast_fourier_transform_tpu.utils import cache as jcache

    import mixed_radix_fast_fourier_transform_tpu as jsp
    from mixed_radix_fast_fourier_transform_tpu_torch import plan

    tp.clear_plan_cache()
    assert cache.warm_plans([360, 1009, 1024], kinds=("complex", "real")) == 10
    tp.get_plan(256, -1, "kernel")
    keys = sorted(k[:3] for k in plan._CACHE)
    saved = cache.save_plans(str(tmp_path / "m.npz"))
    assert saved == len(keys)
    tp.clear_plan_cache()
    assert cache.load_plans(str(tmp_path / "m.npz")) == saved
    assert sorted(k[:3] for k in plan._CACHE) == keys
    # a manifest the JAX package wrote loads into the port
    jsp.clear_plan_cache()
    jcache.warm_plans([96, 128], kinds=("complex", "real"))
    jcount = jcache.save_plans(str(tmp_path / "jax.npz"))
    tp.clear_plan_cache()
    assert cache.load_plans(str(tmp_path / "jax.npz")) == jcount
    assert sorted(k[:3] for k in plan._CACHE) == sorted(
        (kind, n, s) for kind, n, s, _ in jsp.plan._CACHE)
    # clean failures, cache untouched
    with pytest.raises(FileNotFoundError):
        cache.load_plans(str(tmp_path / "missing.npz"))
    (tmp_path / "junk.npz").write_bytes(b"not a zip")
    with pytest.raises(ValueError, match="corrupt plan manifest"):
        cache.load_plans(str(tmp_path / "junk.npz"))
    for rows in ([[3, 8, -1]], [[1, 9, -1]], [[0, 8, 2]], [[0, 0, 1]], [[0, 8]]):
        np.savez(tmp_path / "bad.npz", manifest=np.asarray(rows, np.int64))
        before = dict(plan._CACHE)
        with pytest.raises(ValueError, match="corrupt plan manifest"):
            cache.load_plans(str(tmp_path / "bad.npz"))
        assert dict(plan._CACHE) == before


def test_enable_persistent_cache_moves_the_build_directory(tmp_path):
    from mixed_radix_fast_fourier_transform_tpu_torch.ops import _build

    old = _build.BUILD_DIR
    try:
        path = cache.enable_persistent_cache(str(tmp_path / "kernels"))
        assert path == str(tmp_path / "kernels") and pathlib.Path(path).is_dir()
        assert _build.BUILD_DIR == pathlib.Path(path)
        assert _build.LIB_PATH.parent == _build.PTXAS_LOG.parent == pathlib.Path(path)
    finally:
        _build.set_build_dir(old)
    assert _build.LIB_PATH == old / "libspectral_kernels.so"


LOAD_EXPORTED = """
import sys
sys.modules['mixed_radix_fast_fourier_transform_tpu_torch'] = None
sys.modules['jax'] = None
import numpy as np, torch
fn = torch.export.load(sys.argv[1]).module()
x = torch.from_numpy(np.load(sys.argv[2]))
np.save(sys.argv[3], fn(x).numpy())
assert not [m for m, v in sys.modules.items() if m.startswith('mixed_radix') and v is not None]
print('OK')
"""


def test_exported_fft_reloads_without_the_port(tmp_path):
    """``export_transform`` of ``fft`` at 360 × 4 reloads in a process that
    cannot import the port, and matches the JAX package's ``fft``."""
    import mixed_radix_fast_fourier_transform_tpu as jsp
    from mixed_radix_fast_fourier_transform_tpu_torch.utils import aot

    x = complex_input("export", (4, 360))
    blob = aot.export_transform(lambda v: tp.fft(v), torch.from_numpy(x))
    (tmp_path / "fft.pt2").write_bytes(blob)
    np.save(tmp_path / "x.npy", x)
    done = subprocess.run([sys.executable, "-c", LOAD_EXPORTED, str(tmp_path / "fft.pt2"),
                           str(tmp_path / "x.npy"), str(tmp_path / "y.npy")],
                          capture_output=True, text=True, timeout=120)
    assert done.returncode == 0 and "OK" in done.stdout, done.stderr[-2000:]
    assert rel(np.load(tmp_path / "y.npy"), jsp.fft(x)) <= TOL
    loaded = aot.load_transform(blob)
    other = complex_input("export2", (4, 360))
    assert rel(loaded(torch.from_numpy(other)).numpy(), jsp.fft(other)) <= TOL
    # the trace kept none of its tensors in the plan and table caches
    pipeline = tp.fft(torch.from_numpy(other), config=tp.SpectralConfig(use_kernel=False))
    assert rel(pipeline.numpy(), jsp.fft(other)) <= TOL
    with pytest.raises(ValueError):
        aot.export_transform(lambda v: tp.fft(v), torch.from_numpy(x), platforms=("cpu",))


def test_aot_compile_sets_up_for_the_example_shapes():
    import mixed_radix_fast_fourier_transform_tpu as jsp
    from mixed_radix_fast_fourier_transform_tpu_torch.utils import aot

    x = complex_input("aot", (8, 1000))
    tp.clear_plan_cache()
    fn = aot.aot_compile(tp.fft, torch.from_numpy(x), norm="ortho")
    built = metrics.get_metrics().get("plans_built", 0)
    y = fn(torch.from_numpy(x))
    assert metrics.get_metrics().get("plans_built", 0) == built   # nothing left to build
    assert rel(y.numpy(), jsp.fft(x, norm="ortho")) <= TOL
    with pytest.raises(ValueError, match="example shapes"):
        fn(torch.zeros(8, 999, dtype=torch.complex64))


def test_enable_logging_routes_plan_builds_to_stderr(capsys):
    logger = metrics.logger
    handlers, level = list(logger.handlers), logger.level
    try:
        metrics.enable_logging(logging.DEBUG)
        tp.clear_plan_cache()
        tp.get_plan(77, -1)
        err = capsys.readouterr().err
        assert "[mixed_radix_fft_torch] INFO built complex plan n=77" in err
    finally:
        logger.handlers[:] = handlers
        logger.setLevel(level)
    assert tp.utils.enable_logging is metrics.enable_logging


@pytest.mark.parametrize("n,batch,parts", [(65536, 4096, 1), (65536, 4096, 8), (4096, 64, 2),
                                           (1 << 20, 1024, 4)])
def test_four_step_memory_budget_matches_jax(n, batch, parts):
    from mixed_radix_fast_fourier_transform_tpu.utils import profiling as jprof

    want = jprof.estimate_four_step_hbm(n, batch, parts, copies=6.0)
    got = profiling.estimate_four_step_hbm(n, batch, parts, copies=6.0)
    for key in ("per_copy_bytes", "plan_const_bytes", "total_bytes", "total_gb"):
        assert got[key] == want[key], key
    assert "fits_v5e_16gb" not in got
    assert got["fits_h100_80gb"] == (got["total_bytes"] < 76 * 2 ** 30)


def test_require_four_step_hbm_rejects_over_budget():
    est = profiling.require_four_step_hbm(65536, 4096, 1)     # config 5 on one card
    assert est["fits_h100_80gb"]
    with pytest.raises(profiling.HBMBudgetError, match="n=65536 batch=4096") as e:
        profiling.require_four_step_hbm(65536, 4096, 1, limit_gb=4.0)
    assert isinstance(e.value, ValueError)
    with pytest.raises(profiling.HBMBudgetError):
        profiling.require_four_step_hbm(1 << 20, 8192, 1)     # 64 GiB a copy
    assert profiling._card_budget_gb() == 76.0                 # no card here


def test_next_splittable_len_matches_jax():
    from mixed_radix_fast_fourier_transform_tpu.utils import factorize as jf

    from mixed_radix_fast_fourier_transform_tpu.parallel import choose_split
    from mixed_radix_fast_fourier_transform_tpu_torch.utils.factorize import next_splittable_len

    for n in (1, 7, 1000, 65408 + 128, 99991, 1 << 20):
        for parts in (1, 2, 3, 4, 6, 8):
            m = next_splittable_len(n, parts)
            assert m == jf.next_splittable_len(n, parts) and m >= n
            choose_split(m, parts)
    for parts in (0, 257):
        with pytest.raises(ValueError):
            next_splittable_len(100, parts)
