"""PyTorch port under ``torch.compile``: the framed signal ops that compile
whole on a plain tensor, each on a ``shard_batch`` DTensor, in the gloo
world of 2 on the mesh (2, 1) of ``test_torch_compile_parallel_batch.py``
(which holds ``stft``, ``welch`` and ``resample_poly``, and the families'
steps): one graph, no break, no recompile on new data, within
1e-6 of eager, every output that keeps the batch still sharded.
``griffinlim`` compiles in its ``seed=`` form: the draws of the whole
batch, each rank's block placed beside its block of the magnitude."""

import pytest

from test_torch_compile_parallel import WORLD
from test_torch_compile_parallel_batch import HERE, OPS, op_compiles_whole, ops_world
from test_torch_parallel import run_world

NAMES = tuple(name for name in OPS if name not in HERE)


def framed_world() -> dict:
    """Every case of this file (runs on each rank)."""
    return ops_world(NAMES)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(__name__, "framed_world", tmp_path_factory.mktemp("compile_framed"),
                     world=WORLD)


@pytest.mark.parametrize("name", NAMES)
def test_framed_op_on_a_shard_batch_dtensor_compiles_whole(world, name):
    """:func:`op_compiles_whole`."""
    op_compiles_whole(world, name)
