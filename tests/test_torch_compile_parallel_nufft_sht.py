"""PyTorch port under ``torch.compile``: the sharded NUFFTs (the grid path:
the points sharded over ``seq``, type 1's grid summed over it) and the
latitude-sharded SHTs (the quadrature and both recurrences, the
compensated one through the ``dw_step`` operator), each given its sharded
array plain and as a DTensor, with the checks and the gloo world of 2 of
``test_torch_compile_parallel.py``."""

import numpy as np
import pytest

from test_torch_compile_parallel import WORLD, one_graph, transforms_world
from test_torch_parallel import complex_input, rng_for, run_world

M = 64           # points
L = 4            # band limit


def points(name):
    return rng_for(name).uniform(0.0, 2.0 * np.pi, M).astype(np.float32)


def field(name, shape):
    return rng_for(name).standard_normal(shape).astype(np.float32)


CASES = {
    "nufft1_sharded": ((1, 2), lambda s: (points(f"x{s}"), complex_input(f"c{s}", (2, M))),
                       lambda P, m, x, c: P.nufft1_sharded(x, c, 16, m)),
    "nufft2_sharded": ((1, 2), lambda s: (points(f"x{s}"), complex_input(f"f{s}", (2, 16))),
                       lambda P, m, x, f: P.nufft2_sharded(x, f, m)),
    "nufft1_2d_sharded": ((1, 2), lambda s: (points(f"x{s}"), points(f"y{s}"),
                                             complex_input(f"c{s}", (2, M))),
                          lambda P, m, x, y, c: P.nufft1_2d_sharded(x, y, c, (8, 8), m)),
    "nufft2_2d_sharded": ((1, 2), lambda s: (points(f"x{s}"), points(f"y{s}"),
                                             complex_input(f"f2{s}", (2, 8, 8))),
                          lambda P, m, x, y, f: P.nufft2_2d_sharded(x, y, f, m)),
    "sht_sharded": ((1, 2), lambda s: (field(f"sht{s}", (2, L, 2 * L)),),
                    lambda P, m, f: P.sht_sharded(f, m)),
    "isht_sharded": ((1, 2), lambda s: (complex_input(f"alm{s}", (2, 2 * L - 1, L)),),
                     lambda P, m, a: P.isht_sharded(a, m)),
    "sht_recurrence_sharded": ((1, 2), lambda s: (field(f"shr{s}", (2, L, 2 * L)),),
                               lambda P, m, f: P.sht_recurrence_sharded(f, m, compensated=True)),
    "isht_recurrence_sharded": ((1, 2), lambda s: (complex_input(f"alr{s}", (2, 2 * L - 1, L)),),
                                lambda P, m, a: P.isht_recurrence_sharded(a, m)),
}


def nufft_sht_world() -> dict:
    import torch

    torch.set_num_threads(1)
    return transforms_world(CASES)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(__name__, "nufft_sht_world", tmp_path_factory.mktemp("compile_nufft_sht"),
                     world=WORLD)


@pytest.mark.parametrize("form", ["plain", "dtensor"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_nufft_sht_compiles_whole(world, case, form):
    """One graph, no break, no recompile on new data, compiled within 1e-6
    of eager, for the sharded array given as a plain tensor and as a
    DTensor."""
    one_graph(world, f"{case}/{form}")
