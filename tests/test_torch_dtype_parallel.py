"""PyTorch port: ``parallel/distributed.py`` in float64.

The sharded transforms with ``SpectralConfig(dtype=torch.float64)`` on
float64 data, in a gloo world of 4 CPU processes (the harness of
``test_torch_parallel``) on the meshes (1, 4) and (2, 2), held to numpy or
scipy float64 at 1e-12 of the oracle's largest value: the four-step (both
directions), the scrambled pair as a round trip, the sharded convolution,
the real four-step pair, the 2-D pencil, the 3-D pencils (complex, real,
inverse real) and the Poisson solve on them.  Every result is float64 or
complex128.  The children never import JAX.
"""

import numpy as np
import pytest
import scipy.signal as ss

from test_torch_parallel import gathered, mesh_id, rng_for, run_world

MESHES = ((1, 4), (2, 2))
TOL = 1e-12


def _c(name, shape):
    r = rng_for(name)
    return r.standard_normal(shape) + 1j * r.standard_normal(shape)


def _r(name, shape):
    return rng_for(name).standard_normal(shape)


def _taps():
    return rng_for("taps64").standard_normal(33)


def _poisson64(f, period):
    k = np.meshgrid(*[2.0 * np.pi * np.fft.fftfreq(n, 1.0 / n) / p
                      for n, p in zip(f.shape, period)], indexing="ij")
    k2 = sum(v ** 2 for v in k)
    mult = np.where(k2 > 0, -1.0 / np.where(k2 > 0, k2, 1.0), 0.0)
    return np.fft.ifftn(np.fft.fftn(f) * mult).real


# name: (input, call(P, mesh, x, config), float64 oracle of the input)
CASES = {
    "fft_four_step": (lambda: _c("fs64", (4, 1024)),
                      lambda P, m, x, c: P.fft_four_step(x, m, data_axis="data", config=c),
                      np.fft.fft),
    "ifft_four_step_ortho": (lambda: _c("ifs64", (2, 4096)),
                             lambda P, m, x, c: P.ifft_four_step(x, m, norm="ortho", n1=32,
                                                                 config=c),
                             lambda x: np.fft.ifft(x, norm="ortho")),
    "scrambled_round_trip": (lambda: _c("fss64", (4, 1024)),
                             lambda P, m, x, c: P.ifft_four_step_scrambled(
                                 P.fft_four_step_scrambled(x, m, data_axis="data", config=c),
                                 m, data_axis="data", config=c),
                             lambda x: x),
    "fft_convolve_same": (lambda: _r("fcs64", (4, 1000)),
                          lambda P, m, x, c: P.fft_convolve_sharded(x, _taps(), m, mode="same",
                                                                    config=c),
                          lambda x: ss.fftconvolve(x, _taps()[None], mode="same", axes=-1)),
    "rfft_four_step": (lambda: _r("rfs64", (4, 2048)),
                       lambda P, m, x, c: P.rfft_four_step(x, m, data_axis="data", config=c),
                       np.fft.rfft),
    "irfft_four_step": (lambda: np.fft.rfft(_r("irfs64", (4, 2048))),
                        lambda P, m, x, c: P.irfft_four_step(x, m, data_axis="data", config=c),
                        np.fft.irfft),
    "fft2_pencil": (lambda: _c("f2p64", (4, 32, 48)),
                    lambda P, m, x, c: P.fft2_pencil(x, m, data_axis="data", config=c),
                    np.fft.fft2),
    "fftn_pencil2": (lambda: _c("fnp264", (8, 12, 16)),
                     lambda P, m, x, c: P.fftn_pencil2(x, m, config=c),
                     np.fft.fftn),
    "rfftn_pencil2": (lambda: _r("rfnp264", (8, 12, 16)),
                      lambda P, m, x, c: P.rfftn_pencil2(x, m, config=c),
                      np.fft.rfftn),
    "irfftn_pencil2": (lambda: np.fft.rfftn(_r("irfnp264", (8, 12, 16))),
                       lambda P, m, x, c: P.irfftn_pencil2(x, m, n2=16, config=c),
                       lambda x: np.fft.irfftn(x, s=(8, 12, 16), axes=(0, 1, 2))),
    "poisson_solve_pencil2": (lambda: _r("psp264", (8, 12, 16)),
                              lambda P, m, x, c: P.poisson_solve_pencil2(
                                  x, m, period=(1.0, 2.0, 3.0), config=c),
                              lambda x: _poisson64(x, (1.0, 2.0, 3.0))),
}


def float64_world() -> dict:
    """Every case on every mesh in float64 (runs on each rank)."""
    import torch

    import mixed_radix_fast_fourier_transform_tpu_torch as tp
    from mixed_radix_fast_fourier_transform_tpu_torch import parallel as par

    config = tp.SpectralConfig(dtype=torch.float64)
    out = {}
    for shape in MESHES:
        mesh = par.make_mesh(shape, device="cpu")
        for name, (inputs, call, _) in CASES.items():
            out[f"{mesh_id(shape)}/{name}"] = gathered(call(par, mesh, inputs(), config))
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(__name__, "float64_world", tmp_path_factory.mktemp("float64"))


@pytest.mark.parametrize("shape", MESHES, ids=mesh_id)
@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_transform_in_float64(world, case, shape):
    inputs, _, oracle = CASES[case]
    got = world[f"{mesh_id(shape)}/{case}"]
    want = oracle(inputs())
    assert got.dtype in (np.float64, np.complex128), got.dtype
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.max(np.abs(got - want)) / np.max(np.abs(want)) <= TOL
