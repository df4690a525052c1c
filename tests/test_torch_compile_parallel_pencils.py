"""PyTorch port under ``torch.compile``: the N-D pencils of ``parallel/``
(``fftn_pencil``/``ifftn_pencil``, the 2-D pencil decomposition of a volume
``fftn_pencil2``/``ifftn_pencil2``, its real forms and
``poisson_solve_pencil2``), each given the global array plain and as a
DTensor, with the checks and the gloo world of 2 of
``test_torch_compile_parallel.py``."""

import pytest

from test_torch_compile_parallel import WORLD, one_graph, transforms_world
from test_torch_parallel import complex_input, real_input, run_world

CASES = {
    "fftn_pencil": ((1, 2), lambda s: (complex_input(f"pn{s}", (16, 8, 32)),),
                    lambda P, m, x: P.fftn_pencil(x, m, shard_dim=0)),
    "ifftn_pencil": ((2, 1), lambda s: (complex_input(f"ipn{s}", (2, 16, 32)),),
                     lambda P, m, x: P.ifftn_pencil(x, m, axes=(1, 2), data_axis="data",
                                                    seq_axis="data", shard_dim=1)),
    "fftn_pencil2": ((1, 2), lambda s: (complex_input(f"pp{s}", (4, 4, 8)),),
                     lambda P, m, x: P.fftn_pencil2(x, m)),
    "ifftn_pencil2": ((2, 1), lambda s: (complex_input(f"ipp{s}", (4, 4, 8)),),
                      lambda P, m, x: P.ifftn_pencil2(x, m)),
    "rfftn_pencil2": ((1, 2), lambda s: (real_input(f"rpp{s}", (4, 4, 8)),),
                      lambda P, m, x: P.rfftn_pencil2(x, m)),
    "irfftn_pencil2": ((1, 2), lambda s: (complex_input(f"irpp{s}", (4, 4, 5)),),
                       lambda P, m, x: P.irfftn_pencil2(x, m, n2=8)),
    "poisson_solve_pencil2": ((1, 2), lambda s: (real_input(f"poi{s}", (4, 4, 8)),),
                              lambda P, m, x: P.poisson_solve_pencil2(x, m)),
}


def pencils_world() -> dict:
    import torch

    torch.set_num_threads(1)
    return transforms_world(CASES)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(__name__, "pencils_world", tmp_path_factory.mktemp("compile_pencils"),
                     world=WORLD)


@pytest.mark.parametrize("form", ["plain", "dtensor"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_pencil_compiles_whole(world, case, form):
    """One graph, no break, no recompile on new data, compiled within 1e-6
    of eager, for the global array given as a plain tensor and as a
    DTensor."""
    one_graph(world, f"{case}/{form}")
