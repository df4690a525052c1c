"""PyTorch port: ``parallel/`` (the mesh, the all-to-all helper, the
four-step core, convolution, the real forms and the pencils) in a gloo world
of 4 CPU processes, against the JAX package on a 4-device CPU mesh.

One world per file: a module-scoped fixture spawns 4 processes
(``torch.multiprocessing``, a file store under the test's temporary
directory, one thread each), which run every case of the file on the meshes
(1, 4), (2, 2) and (4, 1) and write the gathered outputs to an ``.npz``.
The children never import JAX; the parent never joins a process group.
Inputs come from numpy generators seeded by the case name, so the parent
rebuilds the very same arrays for the JAX function.
"""

import datetime
import importlib
import pathlib
import sys
import time
import zlib

import numpy as np
import pytest
import torch

WORLD = 4
MESHES = ((1, 4), (2, 2), (4, 1))
TOL = 1e-5   # max |got − want| / max |want|, the library's error budget


# ---------------------------------------------------------------------------
# The world: shared with the other test_torch_parallel_* files.
# ---------------------------------------------------------------------------


def _world_main(rank, world, module, func, store, out):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=180))
    try:
        results = getattr(importlib.import_module(module), func)()
        if rank == 0:
            np.savez(out, **results)
    finally:
        dist.destroy_process_group()


def run_world(module: str, func: str, tmp: pathlib.Path, world: int = WORLD,
              timeout: float = 300.0) -> dict:
    """Run ``module.func()`` on every rank of a fresh gloo world of
    ``world`` CPU processes; return rank 0's dict of numpy arrays."""
    import torch.multiprocessing as mp

    out = tmp / f"{func}.npz"
    ctx = mp.start_processes(_world_main, args=(world, module, func, str(tmp / "store"),
                                                str(out)),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=5.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{module}.{func} did not finish in {timeout} s")
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


def mesh_id(shape) -> str:
    return f"{shape[0]}x{shape[1]}"


def rng_for(name: str) -> np.random.Generator:
    return np.random.default_rng(zlib.crc32(name.encode()))


def complex_input(name: str, shape) -> np.ndarray:
    r = rng_for(name)
    return (r.standard_normal(shape) + 1j * r.standard_normal(shape)).astype(np.complex64)


def real_input(name: str, shape) -> np.ndarray:
    return rng_for(name).standard_normal(shape).astype(np.float32)


def gathered(x) -> np.ndarray:
    """A port result (DTensor or tensor) as the global numpy array."""
    from torch.distributed.tensor import DTensor

    from mixed_radix_fast_fourier_transform_tpu_torch.parallel.distributed import _full

    if isinstance(x, DTensor):
        x = _full(x, x.device_mesh)
    return x.detach().numpy()


def rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def jax_mesh(shape):
    import jax

    from mixed_radix_fast_fourier_transform_tpu.parallel import make_mesh

    return make_mesh(shape, devices=jax.devices()[:4])


def run_errors(cases, mesh, P) -> dict:
    """The message of the ValueError each case raises ('' if none)."""
    out = {}
    for name, call in cases.items():
        try:
            call(P, mesh)
            out[name] = ""
        except ValueError as e:
            out[name] = str(e)
    return out


# ---------------------------------------------------------------------------
# Cases: call(P, mesh, x) with P the parallel module of either package.
# ---------------------------------------------------------------------------


def _taps(n: int = 33) -> np.ndarray:
    return rng_for("taps").standard_normal(n)


def _taps2() -> np.ndarray:
    return rng_for("taps2").standard_normal((5, 3))


CASES = {
    "fft_four_step": (lambda: complex_input("fs", (4, 1024)),
                      lambda P, m, x: P.fft_four_step(x, m, data_axis="data")),
    "fft_four_step_real_1d": (lambda: real_input("fsr", (1920,)),
                              lambda P, m, x: P.fft_four_step(x, m)),
    "ifft_four_step_ortho": (lambda: complex_input("ifs", (2, 4096)),
                             lambda P, m, x: P.ifft_four_step(x, m, norm="ortho", n1=32)),
    "fft_four_step_chunks": (lambda: complex_input("fsc", (4, 1024)),
                             lambda P, m, x: P.fft_four_step(x, m, overlap_chunks=2)),
    "fft_four_step_scrambled": (lambda: complex_input("fss", (4, 1024)),
                                lambda P, m, x: P.fft_four_step_scrambled(x, m, data_axis="data")),
    "ifft_four_step_scrambled": (lambda: complex_input("ifss", (4, 32, 64)),
                                 lambda P, m, x: P.ifft_four_step_scrambled(x, m, data_axis="data")),
    "fft_convolve_circular": (lambda: real_input("fcc", (4, 1024)),
                              lambda P, m, x: P.fft_convolve_sharded(x, _taps(), m,
                                                                     data_axis="data")),
    "fft_convolve_same": (lambda: real_input("fcs", (4, 1000)),
                          lambda P, m, x: P.fft_convolve_sharded(x, _taps(), m, mode="same",
                                                                 overlap_chunks=2)),
    "rfft_four_step": (lambda: real_input("rfs", (4, 2048)),
                       lambda P, m, x: P.rfft_four_step(x, m, data_axis="data")),
    "irfft_four_step": (lambda: np.fft.rfft(real_input("irfs", (4, 2048))).astype(np.complex64),
                        lambda P, m, x: P.irfft_four_step(x, m, data_axis="data")),
    "fft2_pencil": (lambda: complex_input("f2p", (4, 32, 48)),
                    lambda P, m, x: P.fft2_pencil(x, m, data_axis="data")),
    "ifft2_pencil_ortho": (lambda: complex_input("if2p", (32, 16)),
                           lambda P, m, x: P.ifft2_pencil(x, m, norm="ortho")),
    "fft_convolve2_circular": (lambda: real_input("fc2c", (2, 32, 16)),
                               lambda P, m, x: P.fft_convolve2_sharded(x, _taps2(), m)),
    "fft_convolve2_same": (lambda: real_input("fc2s", (2, 30, 14)),
                           lambda P, m, x: P.fft_convolve2_sharded(x, _taps2(), m, mode="same")),
    "fftn_pencil": (lambda: complex_input("fnp", (4, 16, 12, 8)),
                    lambda P, m, x: P.fftn_pencil(x, m, axes=(1, 2, 3), data_axis="data",
                                                  shard_dim=1)),
    "ifftn_pencil": (lambda: complex_input("ifnp", (8, 12, 16)),
                     lambda P, m, x: P.ifftn_pencil(x, m)),
    "fftn_pencil2": (lambda: complex_input("fnp2", (8, 12, 16)),
                     lambda P, m, x: P.fftn_pencil2(x, m)),
    "ifftn_pencil2_forward": (lambda: complex_input("ifnp2", (8, 12, 16)),
                              lambda P, m, x: P.ifftn_pencil2(x, m, norm="forward")),
    "rfftn_pencil2": (lambda: real_input("rfnp2", (8, 12, 16)),
                      lambda P, m, x: P.rfftn_pencil2(x, m)),
    "irfftn_pencil2": (lambda: np.fft.rfftn(real_input("irfnp2", (8, 12, 16))).astype(np.complex64),
                       lambda P, m, x: P.irfftn_pencil2(x, m, n2=16)),
    "poisson_solve_pencil2": (lambda: real_input("psp2", (8, 12, 16)),
                              lambda P, m, x: P.poisson_solve_pencil2(x, m, period=(1.0, 2.0, 3.0))),
}

# (split_axis, concat_axis) pairs the bodies exchange on, for a rank-4 block
A2A_PAIRS = ((3, 2), (2, 3), (2, 1), (1, 2), (2, 0), (0, 2), (3, 1), (1, 3))
A2A_BLOCK = (8, 4, 8, 12)


def _a2a_global():
    return real_input("a2a", (WORLD * A2A_BLOCK[0],) + A2A_BLOCK[1:])


ERRORS = {
    "bad_split": lambda P, m: P.fft_four_step(np.zeros(1024, np.complex64), m, n1=6),
    "chunks_zero": lambda P, m: P.fft_four_step(np.zeros((4, 1024), np.complex64), m,
                                                overlap_chunks=0),
    "chunks_no_batch": lambda P, m: P.fft_four_step(np.zeros(1024, np.complex64), m,
                                                    overlap_chunks=2),
    "chunks_indivisible": lambda P, m: P.fft_four_step(np.zeros((3, 1024), np.complex64), m,
                                                       overlap_chunks=2),
    "unsplittable": lambda P, m: P.fft_four_step(np.zeros(16 * 257, np.complex64), m),
    "scrambled_indivisible": lambda P, m: P.ifft_four_step_scrambled(
        np.zeros((30, 32), np.complex64), m),
    "conv_kernel_2d": lambda P, m: P.fft_convolve_sharded(np.zeros((2, 1024), np.float32),
                                                          np.ones((3, 3)), m),
    "conv_mode": lambda P, m: P.fft_convolve_sharded(np.zeros((2, 1024), np.float32),
                                                     np.ones(3), m, mode="valid"),
    "conv_kernel_long": lambda P, m: P.fft_convolve_sharded(np.zeros((2, 64), np.float32),
                                                            np.ones(65), m),
    "rfft_complex": lambda P, m: P.rfft_four_step(np.zeros(1024, np.complex64), m),
    "rfft_odd": lambda P, m: P.rfft_four_step(np.zeros(1023, np.float32), m),
    "irfft_bins": lambda P, m: P.irfft_four_step(np.zeros(513, np.complex64), m, n=1000),
    "fft2_indivisible": lambda P, m: P.fft2_pencil(np.zeros((30, 32), np.complex64), m),
    "conv2_kernel_1d": lambda P, m: P.fft_convolve2_sharded(np.zeros((32, 32), np.float32),
                                                            np.ones(3), m),
    "conv2_mode": lambda P, m: P.fft_convolve2_sharded(np.zeros((32, 32), np.float32),
                                                       np.ones((3, 3)), m, mode="full"),
    "conv2_kernel_large": lambda P, m: P.fft_convolve2_sharded(np.zeros((8, 8), np.float32),
                                                               np.ones((9, 3)), m),
    "fftn_shard_last": lambda P, m: P.fftn_pencil(np.zeros((8, 8), np.complex64), m,
                                                  shard_dim=-1),
    "fftn_indivisible": lambda P, m: P.fftn_pencil(np.zeros((8, 6, 8), np.complex64), m),
    "fftn_data_axis0": lambda P, m: P.fftn_pencil(np.zeros((8, 8, 8), np.complex64), m,
                                                  data_axis="data"),
    "pencil2_ndim": lambda P, m: P.fftn_pencil2(np.zeros((8, 8), np.complex64), m),
    "pencil2_indivisible": lambda P, m: P.fftn_pencil2(np.zeros((8, 8, 6), np.complex64), m),
    "rpencil2_ndim": lambda P, m: P.rfftn_pencil2(np.zeros((8, 8), np.float32), m),
    "rpencil2_complex": lambda P, m: P.rfftn_pencil2(np.zeros((8, 8, 8), np.complex64), m),
    "rpencil2_odd": lambda P, m: P.rfftn_pencil2(np.zeros((8, 8, 7), np.float32), m),
    "irpencil2_ndim": lambda P, m: P.irfftn_pencil2(np.zeros((8, 5), np.complex64), m),
    "irpencil2_bins": lambda P, m: P.irfftn_pencil2(np.zeros((8, 8, 5), np.complex64), m, n2=16),
    "irpencil2_indivisible": lambda P, m: P.irfftn_pencil2(np.zeros((6, 6, 5), np.complex64), m),
    "poisson_ndim": lambda P, m: P.poisson_solve_pencil2(np.zeros((8, 8), np.float32), m),
    "mesh_shape": lambda P, m: P.make_mesh((3, 1), device="cpu"),
}


def parallel_world() -> dict:
    """Every case of this file on every mesh (runs on each rank)."""
    import torch.distributed as dist

    from mixed_radix_fast_fourier_transform_tpu_torch import parallel as par
    from mixed_radix_fast_fourier_transform_tpu_torch.parallel.distributed import (
        _all_to_all, _local, _wrap,
    )

    out = {}
    for shape in MESHES:
        mesh = par.make_mesh(shape, device="cpu")
        tag = mesh_id(shape)
        for name, (inputs, call) in CASES.items():
            out[f"{tag}/{name}"] = gathered(call(par, mesh, inputs()))
        g = _a2a_global()
        block = _local(g, mesh, ("seq",))
        for s, c in A2A_PAIRS:
            y = _all_to_all(block, mesh.get_group("seq"), s, c)
            out[f"{tag}/a2a_{s}{c}"] = gathered(_wrap(y[None], mesh, ("seq",),
                                                      (shape[1],) + tuple(y.shape)))
        # placements and the mesh itself
        out[f"{tag}/mesh"] = np.array([mesh.shape[0], mesh.shape[1],
                                       mesh.get_local_rank(0), mesh.get_local_rank(1),
                                       dist.get_rank()])
        out[f"{tag}/placements"] = np.array(
            [repr(par.batch_sharding(mesh, "seq")), repr(par.replicated(mesh))])
    default = par.make_mesh(device="cpu")
    out["default_mesh"] = np.array(tuple(default.shape) + tuple(default.mesh_dim_names))
    for name, msg in run_errors(ERRORS, par.make_mesh((1, 4), device="cpu"), par).items():
        out[f"error/{name}"] = np.array(msg)
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(__name__, "parallel_world", tmp_path_factory.mktemp("parallel"))


# ---------------------------------------------------------------------------
# Tests (JAX is imported here, in the parent only).
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", MESHES, ids=mesh_id)
@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_jax_on_the_mesh(world, case, shape):
    import jax

    from mixed_radix_fast_fourier_transform_tpu import parallel as jpar

    inputs, call = CASES[case]
    mesh = jax_mesh(shape)
    want = np.asarray(jax.jit(lambda x: call(jpar, mesh, x))(inputs()))
    assert rel(world[f"{mesh_id(shape)}/{case}"], want) <= TOL


@pytest.mark.parametrize("shape", MESHES, ids=mesh_id)
@pytest.mark.parametrize("pair", A2A_PAIRS, ids=lambda p: f"{p[0]}to{p[1]}")
def test_all_to_all_is_jax_tiled_all_to_all(world, pair, shape):
    """Every rank's output of ``_all_to_all`` equals the block
    ``jax.lax.all_to_all(..., tiled=True)`` gives its device, exactly."""
    import jax
    from jax.sharding import PartitionSpec as P

    s, c = pair
    mesh = jax_mesh(shape)

    def body(x):
        return jax.lax.all_to_all(x, "seq", s, c, tiled=True)[None]

    fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=P("seq"), out_specs=P("seq")))
    want = np.asarray(fn(_a2a_global()))
    np.testing.assert_array_equal(world[f"{mesh_id(shape)}/a2a_{s}{c}"], want)


@pytest.mark.parametrize("shape", MESHES, ids=mesh_id)
def test_mesh_and_placements(world, shape):
    got = world[f"{mesh_id(shape)}/mesh"]
    assert tuple(got[:2]) == shape and got[4] == 0        # rank 0's view
    assert tuple(got[2:4]) == (0, 0)
    batch, repl = world[f"{mesh_id(shape)}/placements"]
    assert batch == "[Replicate(), Shard(dim=0)]" and repl == "[Replicate(), Replicate()]"
    assert tuple(world["default_mesh"]) == ("4", "1", "data", "seq")


@pytest.mark.parametrize("name", sorted(ERRORS))
def test_value_errors_match_jax(world, name):
    """The port raises a ValueError wherever the JAX function raises one,
    with the same message."""
    from mixed_radix_fast_fourier_transform_tpu import parallel as jpar

    got = str(world[f"error/{name}"])
    if name == "mesh_shape":     # JAX's make_mesh takes devices, not a device type
        jax_call = {name: lambda P, m: P.make_mesh((3, 1), devices=m.devices.ravel())}
    else:
        jax_call = {name: ERRORS[name]}
    want = run_errors(jax_call, jax_mesh((1, 4)), jpar)[name]
    assert want and got == want


def test_choose_split_and_twiddles_match_jax():
    from mixed_radix_fast_fourier_transform_tpu.parallel import distributed as jd

    from mixed_radix_fast_fourier_transform_tpu_torch.parallel import distributed as td

    for n, p in ((4096, 8), (1920, 4), (65536, 1), (1000, 2), (512, 8)):
        assert td.choose_split(n, p) == jd.choose_split(n, p)
    for n1, n2, sign in ((32, 64, -1), (12, 20, 1)):
        for a, b in zip(td._split_twiddle_matrix(n1, n2, sign),
                        jd._split_twiddle_matrix(n1, n2, sign)):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        td.choose_split(17 * 19, 8)


MULTIHOST = """
import sys
sys.modules['jax'] = None
import numpy as np, torch
from mixed_radix_fast_fourier_transform_tpu_torch.parallel import (
    fft_four_step, initialize_multihost, make_mesh)
from mixed_radix_fast_fourier_transform_tpu_torch.parallel.distributed import _full
torch.set_num_threads(1)
idx, cnt = initialize_multihost(sys.argv[2], 2, int(sys.argv[1]), device="cpu")
assert cnt == 2 and initialize_multihost(device="cpu") == (idx, cnt)
mesh = make_mesh((1, 2), device="cpu")
x = np.random.default_rng(0).standard_normal(1024).astype(np.float32)
y = _full(fft_four_step(x, mesh), mesh).numpy()
want = np.fft.fft(x.astype(np.float64))
err = np.max(np.abs(y - want)) / np.max(np.abs(want))
assert err < 1e-5, err
print(f"proc {idx} OK {err:.2e}", flush=True)
"""


def test_two_process_initialize_multihost(tmp_path):
    """Two processes join one world through ``initialize_multihost`` and run
    the four-step transform across it (the port of test_multihost.py)."""
    import subprocess

    repo = str(pathlib.Path(__file__).resolve().parents[1])
    url = f"file://{tmp_path / 'store'}"
    procs = [subprocess.Popen([sys.executable, "-c", MULTIHOST, str(i), url], cwd=repo,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for i in range(2)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=120)[0].decode())
        finally:
            p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"proc {i} OK" in out, out[-2000:]
