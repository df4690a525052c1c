"""PyTorch port: the MDCT with its TDAC reconstruction and the Chebyshev
toolbox against the JAX package, numpy's Chebyshev class and the
definitions.  Tolerance: 1e-5 of the output's maximum unless stated; host
constants (windows, grid points) bit-equal."""

import numpy as np
import pytest
import torch
from numpy.polynomial import chebyshev as npcheb

import mixed_radix_fast_fourier_transform_tpu as sp

import mixed_radix_fast_fourier_transform_tpu_torch as tp

torch.set_num_threads(1)

TOL = 1e-5
WINDOWS = ["sine", ("kbd", 4.0), None]


def _rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


@pytest.mark.parametrize("window", WINDOWS, ids=str)
@pytest.mark.parametrize("frame_length", [4, 64, 120])
def test_mdct_window_is_bit_equal_and_princen_bradley(window, frame_length):
    got = tp.mdct_window(window, frame_length, np.float64)
    assert np.array_equal(got, sp.mdct_window(window, frame_length, np.float64))
    half = frame_length // 2
    assert np.allclose(got[:half] ** 2 + got[half:] ** 2, 1.0, atol=1e-12)
    assert tp.mdct_window(window, frame_length).dtype == np.float32


@pytest.mark.parametrize("norm", [None, "ortho"])
@pytest.mark.parametrize("window", WINDOWS, ids=str)
@pytest.mark.parametrize("frame_length,length", [(64, 1000), (120, 777), (8, 64)])
def test_mdct_matches_jax_and_reconstructs(rng, frame_length, length, window, norm):
    x = rng.standard_normal((2, length)).astype(np.float32)
    coeff = tp.mdct(torch.from_numpy(x), frame_length, window, norm=norm)
    want = np.asarray(sp.mdct(x, frame_length, window, norm=norm))
    assert coeff.dtype == torch.float32 and _rel(coeff, want) <= TOL
    back = tp.imdct(coeff, window, norm=norm, length=length)
    assert _rel(back, np.asarray(sp.imdct(want, window, norm=norm, length=length))) <= TOL
    assert _rel(back, x) <= TOL   # time-domain alias cancellation


def test_mdct_matches_the_cosine_sum(rng):
    n2, half = 32, 16
    x = rng.standard_normal(3 * half)
    w = tp.mdct_window("sine", n2, np.float64)
    n, k = np.arange(n2)[:, None], np.arange(half)[None, :]
    basis = np.cos(np.pi / half * (n + 0.5 + half / 2.0) * (k + 0.5))
    want = np.stack([(w * x[f * half: f * half + n2]) @ basis for f in range(2)])
    got = tp.mdct(torch.from_numpy(x), n2, pad=False)
    assert _rel(got, want) <= TOL
    assert tp.imdct(got, pad=False).shape == (3 * half,)
    assert tp.mdct(torch.arange(64), 16).dtype == torch.float32   # integer PCM


def test_mdct_errors():
    x = torch.zeros(64)
    for bad in (6, 0):
        with pytest.raises(ValueError):
            tp.mdct(x, bad)
    with pytest.raises(ValueError):
        tp.mdct(x, 16, norm="forward")
    with pytest.raises(ValueError):
        tp.mdct(torch.zeros(60), 16, pad=False)
    with pytest.raises(ValueError):
        tp.mdct(x, 16, window="hann")
    with pytest.raises(ValueError):
        tp.mdct(x, 16, window=("kbd",))
    with pytest.raises(ValueError):
        tp.mdct(x, 16, window=np.ones(8))
    with pytest.raises(ValueError):
        tp.imdct(torch.zeros(8))
    with pytest.raises(ValueError):
        tp.imdct(torch.zeros(4, 7))
    with pytest.raises(ValueError):
        tp.imdct(torch.zeros(4, 8), norm="forward")


@pytest.mark.parametrize("n", [2, 9, 33, 128])
def test_cheb_points_and_transforms(rng, n):
    assert np.array_equal(tp.cheb_points(n, np.float64), sp.cheb_points(n, np.float64))
    assert tp.cheb_points(n).dtype == np.float32
    v = rng.standard_normal((3, n)).astype(np.float32)
    c = tp.cheb_transform(torch.from_numpy(v))
    assert _rel(c, sp.cheb_transform(v)) <= TOL
    assert _rel(tp.icheb_transform(c), v) <= TOL
    assert _rel(tp.icheb_transform(c), sp.icheb_transform(np.asarray(c))) <= TOL
    # the coefficients are those of the interpolating polynomial
    x = tp.cheb_points(n, np.float64)
    assert _rel(npcheb.chebval(x, c[0].numpy().astype(np.float64)), v[0]) <= 1e-4


@pytest.mark.parametrize("m", [0, 1, 2])
def test_cheb_diff_of_a_polynomial(m):
    """f = x⁵ − 2x³ + x on 17 points: its derivatives are exact up to fp32."""
    x = tp.cheb_points(17, np.float64)
    poly = np.polynomial.Polynomial([0, 1, 0, -2, 0, 1])
    got = tp.cheb_diff(torch.from_numpy(poly(x)), m)
    assert _rel(got, poly.deriv(m)(x) if m else poly(x)) <= 5e-5
    assert _rel(got, sp.cheb_diff(poly(x).astype(np.float32), m)) <= 5e-5


@pytest.mark.parametrize("n", [1, 2, 7, 32])
def test_cheb_diff_coef_and_eval_match_numpy(rng, n):
    c = rng.standard_normal((2, n)).astype(np.float32)
    got = tp.cheb_diff_coef(torch.from_numpy(c))
    assert got.shape == c.shape
    want = np.stack([np.pad(npcheb.chebder(row.astype(np.float64)), (0, 1))[:n] if n > 1
                     else np.zeros(1) for row in c])
    assert np.max(np.abs(got.numpy() - want)) <= TOL * max(1.0, np.max(np.abs(want)))
    assert np.max(np.abs(got.numpy() - np.asarray(sp.cheb_diff_coef(c)))) <= TOL * max(
        1.0, np.max(np.abs(want)))
    pts = rng.uniform(-1, 1, (4, 3)).astype(np.float32)
    val = tp.cheb_eval(torch.from_numpy(c), torch.from_numpy(pts))
    assert val.shape == (2, 4, 3)
    want = np.stack([npcheb.chebval(pts.astype(np.float64), row.astype(np.float64))
                     for row in c])
    assert _rel(val, want) <= TOL and _rel(val, sp.cheb_eval(c, pts)) <= TOL
    assert tp.cheb_eval(torch.from_numpy(c), torch.tensor(0.5)).shape == (2,)
    assert tp.cheb_eval(torch.from_numpy(c), pts).device.type == "cpu"   # joins c's device


def test_cheb_errors():
    with pytest.raises(ValueError):
        tp.cheb_points(1)
    with pytest.raises(ValueError):
        tp.cheb_transform(torch.ones(1))
    with pytest.raises(ValueError):
        tp.icheb_transform(torch.ones(1))
    with pytest.raises(ValueError):
        tp.cheb_diff(torch.ones(8), -1)
    with pytest.raises(ValueError):
        tp.cheb_diff_coef(torch.ones(3, 0))
    with pytest.raises(ValueError):
        tp.cheb_eval(torch.ones(3, 0), torch.ones(2))
