"""PyTorch port: checkpoints in the JAX package's ``.npz`` format ('/'-joined
keys of dict keys and list indices).  Loading across the two packages with a
model's forward is in test_torch_model_families.py; here the format itself."""

import numpy as np
import pytest
import torch

from mixed_radix_fast_fourier_transform_tpu.models import checkpoint as jckpt

from mixed_radix_fast_fourier_transform_tpu_torch.models import checkpoint as ckpt
from mixed_radix_fast_fourier_transform_tpu_torch.utils.tree import (
    tree_leaves,
    tree_map_with_path,
)

torch.set_num_threads(1)


def _tree(as_leaf):
    rng = np.random.default_rng(0)
    leaf = lambda *shape: as_leaf(rng.standard_normal(shape).astype(np.float32))
    return {
        "zeta": leaf(3),
        "alpha": {"w": leaf(2, 3), "b": leaf(3)},
        "layers": [{"w": leaf(2, 2)} for _ in range(11)],  # index 10 sorts before 2 as text
        "pair": (leaf(1), leaf(4)),
        "scalar": leaf(),
    }


def test_flatten_is_the_jax_packages():
    got = ckpt._flatten(_tree(torch.from_numpy))
    want = jckpt._flatten(_tree(lambda a: a))
    assert list(got) == list(want)  # the same keys in the same order
    assert all(np.array_equal(got[k], want[k]) for k in want)
    assert "layers/10/w" in got and "pair/1" in got and "alpha/b" in got


@pytest.mark.parametrize("writer,reader", [("port", "port"), ("jax", "port"), ("port", "jax")])
def test_round_trip(tmp_path, writer, reader):
    path = str(tmp_path / "tree.npz")
    tree = _tree(torch.from_numpy)
    n = (ckpt.save_checkpoint(path, tree) if writer == "port"
         else jckpt.save_checkpoint(path, _tree(lambda a: a)))
    assert n == len(tree_leaves(tree)) == 17
    if reader == "port":
        back = ckpt.load_checkpoint(path, like=tree, device="cpu")
        assert isinstance(back["pair"], tuple) and isinstance(back["layers"], list)
        flat = ckpt._flatten(back)
    else:
        flat = jckpt._flatten(jckpt.load_checkpoint(path, like=_tree(lambda a: a)))
    want = ckpt._flatten(tree)
    assert list(flat) == list(want)
    assert all(np.array_equal(flat[k], want[k]) for k in want)


def test_load_without_a_template_gives_nested_numpy(tmp_path):
    path = str(tmp_path / "tree.npz")
    ckpt.save_checkpoint(path, _tree(torch.from_numpy))
    nested = ckpt.load_checkpoint(path)
    assert set(nested) == {"zeta", "alpha", "layers", "pair", "scalar"}
    assert set(nested["layers"]) == {str(i) for i in range(11)}  # indices as string keys
    assert isinstance(nested["alpha"]["w"], np.ndarray) and nested["alpha"]["w"].shape == (2, 3)
    jnested = jckpt.load_checkpoint(path)
    assert np.array_equal(jnested["layers"]["10"]["w"], nested["layers"]["10"]["w"])


def test_template_dtypes_and_mismatch(tmp_path):
    path = str(tmp_path / "tree.npz")
    ckpt.save_checkpoint(path, {"a": torch.arange(3.0), "n": torch.tensor([1, 2])})
    like = {"a": torch.zeros(3, dtype=torch.float64), "n": np.zeros(2, np.int32)}
    back = ckpt.load_checkpoint(path, like=like, device="cpu")
    assert back["a"].dtype == torch.float64 and back["n"].dtype == torch.int32
    assert back["n"].tolist() == [1, 2]
    with pytest.raises(ValueError, match="key mismatch"):
        ckpt.load_checkpoint(path, like={"a": torch.zeros(3)}, device="cpu")


def test_leaves_go_to_the_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    path = str(tmp_path / "tree.npz")
    ckpt.save_checkpoint(path, {"a": torch.arange(3.0)})
    with pytest.raises((RuntimeError, AssertionError)):
        ckpt.load_checkpoint(path, like={"a": torch.zeros(3)})


def test_saving_detaches_parameters(tmp_path):
    path = str(tmp_path / "tree.npz")
    tree = {"w": torch.nn.Parameter(torch.ones(2, 2))}
    assert ckpt.save_checkpoint(path, tree) == 1
    paths = tree_map_with_path(lambda p, _: p, tree)
    assert paths == {"w": "w"} and np.array_equal(ckpt.load_checkpoint(path)["w"], np.ones((2, 2)))
