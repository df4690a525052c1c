"""PyTorch port: DCT/DST types 1–4 against the JAX package and scipy.fft on
the same inputs.  Tolerance: 1e-5 of the output's maximum.  The inner
transforms run the stage pipeline on either ``use_kernel`` setting, as the
JAX module's do."""

import numpy as np
import pytest
import scipy.fft
import torch

import mixed_radix_fast_fourier_transform_tpu as sp

import mixed_radix_fast_fourier_transform_tpu_torch as tp
from mixed_radix_fast_fourier_transform_tpu_torch.ops import cuda_fft

torch.set_num_threads(1)

TOL = 1e-5
TYPES = [1, 2, 3, 4]
NORMS = [None, "ortho"]
LENGTHS = [2, 9, 60, 128, 257]   # a prime too: Bluestein inside


def _rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


@pytest.mark.parametrize("norm", NORMS, ids=["none", "ortho"])
@pytest.mark.parametrize("type", TYPES)
@pytest.mark.parametrize("kind", ["dct", "idct", "dst", "idst"])
def test_matches_jax_and_scipy(rng, kind, type, norm):
    for n in LENGTHS:
        x = rng.standard_normal((3, n)).astype(np.float32)
        got = getattr(tp, kind)(torch.from_numpy(x), type, norm=norm)
        assert got.dtype == torch.float32
        assert _rel(got, getattr(sp, kind)(x, type, norm=norm)) <= TOL, n
        want = getattr(scipy.fft, kind)(x.astype(np.float64), type, norm=norm)
        assert _rel(got, want) <= TOL, n


@pytest.mark.parametrize("type", TYPES)
@pytest.mark.parametrize("kind", ["dct", "dst"])
def test_inverse_round_trip(rng, kind, type):
    x = torch.from_numpy(rng.standard_normal((2, 96)).astype(np.float32))
    for norm in NORMS:
        fwd, inv = getattr(tp, kind), getattr(tp, "i" + kind)
        assert _rel(inv(fwd(x, type, norm=norm), type, norm=norm), x.numpy()) <= TOL


@pytest.mark.parametrize("kind", ["dct", "dst"])
def test_n_axis_and_float64_input(rng, kind):
    x = rng.standard_normal((4, 10, 6))
    fn, ref = getattr(tp, kind), getattr(scipy.fft, kind)
    assert _rel(fn(torch.from_numpy(x), axis=1), ref(x, axis=1)) <= TOL
    assert _rel(fn(torch.from_numpy(x), n=16, axis=0), ref(x, n=16, axis=0)) <= TOL
    assert _rel(fn(torch.from_numpy(x), n=4), ref(x, n=4)) <= TOL
    assert fn(torch.from_numpy(x)).dtype == torch.float32   # computed in fp32


@pytest.mark.parametrize("type", TYPES)
@pytest.mark.parametrize("kind", ["dctn", "idctn", "dstn", "idstn"])
def test_nd_matches_scipy(rng, kind, type):
    x = rng.standard_normal((5, 6, 8)).astype(np.float32)
    want = getattr(scipy.fft, kind)(x.astype(np.float64), type)
    assert _rel(getattr(tp, kind)(torch.from_numpy(x), type), want) <= TOL
    want = getattr(scipy.fft, kind)(x.astype(np.float64), type, axes=(0, 2), norm="ortho")
    got = getattr(tp, kind)(torch.from_numpy(x), type, axes=(0, 2), norm="ortho")
    assert _rel(got, want) <= TOL
    assert _rel(got, getattr(sp, kind)(x, type, axes=(0, 2), norm="ortho")) <= TOL


def test_errors():
    x = torch.ones(8)
    for fn in (tp.dct, tp.idct, tp.dst, tp.idst):
        with pytest.raises(ValueError):
            fn(x, type=5)
    with pytest.raises(ValueError):
        tp.dct(x, norm="forward")
    with pytest.raises(ValueError):
        tp.dct(torch.ones(1), type=1)
    with pytest.raises(ValueError):
        tp.dct(torch.ones(3, 0))


def test_routes_agree_and_never_reach_the_kernel(rng):
    """dct goes through the plan's stage pipeline whatever ``use_kernel``
    says (the JAX module calls exec_complex, not the kernel's dispatch)."""
    x = torch.from_numpy(rng.standard_normal((4, 1024)).astype(np.float32))
    seen = []
    real = cuda_fft.exec_kernel
    cuda_fft.exec_kernel = lambda *a: seen.append(a) or real(*a)
    try:
        a = tp.dct(x)
        b = tp.dct(x, config=tp.SpectralConfig(use_kernel=False))
    finally:
        cuda_fft.exec_kernel = real
    assert not seen and torch.equal(a, b)


def test_gradient_of_the_orthonormal_pair(rng):
    """The orthonormal DCT-II is an orthogonal matrix: the gradient of
    Σ w·dct(x) is its transpose applied to w, the orthonormal DCT-III."""
    x = torch.from_numpy(rng.standard_normal(64).astype(np.float32)).requires_grad_(True)
    w = rng.standard_normal(64).astype(np.float32)
    (tp.dct(x, norm="ortho") * torch.from_numpy(w)).sum().backward()
    assert _rel(x.grad, scipy.fft.idct(w.astype(np.float64), norm="ortho")) <= TOL
