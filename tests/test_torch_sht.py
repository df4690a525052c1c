"""PyTorch port: ``ops/sht.py`` against the JAX package and a float64
oracle on the same inputs.

The oracle: band-limited random coefficients a_lm (real fields: with
a_{l,-m} = (-1)^m conj(a_lm)) synthesized in float64 with scipy's
``sph_harm_y`` on the grid of ``sht_grid``.  ``sht`` must give back a_lm and
``isht`` the grid values, to 1e-5 of the maximum; the plain recurrence path
to 1e-5 + L·eps (its fp32 carry drifts by ~L·eps, the JAX module's
docstring: 3.2e-5 at L = 256) and the compensated one to 1e-5.  Every
function is held to the JAX function at 1e-5.  Host tables (grids,
recurrence coefficients, Legendre chunks, Wigner-d) are the JAX module's
code and are held bit-equal.  Inputs come from a generator made for each
case; the JAX functions run jitted."""

import jax
import numpy as np
import pytest
import torch
from scipy.special import sph_harm_y

from mixed_radix_fast_fourier_transform_tpu.ops import sht as jsht

import mixed_radix_fast_fourier_transform_tpu_torch as tp
from mixed_radix_fast_fourier_transform_tpu_torch.ops import sht as tsht

torch.set_num_threads(1)

TOL = 1e-5
EPS32 = float(np.finfo(np.float32).eps)


@pytest.fixture
def case_rng(request):
    return np.random.default_rng([ord(ch) for ch in request.node.name])


def _rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


def _packed_m(L):
    return np.concatenate([np.arange(L), np.arange(-(L - 1), 0)])


def _coefficients(rng, L, real, batch=2):
    """Packed (batch, 2L-1, L) coefficients, zero below |m| <= l."""
    ms = _packed_m(L)
    a = rng.standard_normal((batch, 2 * L - 1, L)) + 1j * rng.standard_normal((batch, 2 * L - 1, L))
    a = a * (np.abs(ms)[:, None] <= np.arange(L)[None, :])
    if real:
        a[:, 0, :] = a[:, 0, :].real
        for m in range(1, L):
            a[:, 2 * L - 1 - m, :] = (-1) ** m * np.conj(a[:, m, :])
    return a


def _synth64(a, L, grid):
    """Σ_lm a_lm Y_lm on the grid, float64."""
    theta, phi, _ = tsht.sht_grid(L - 1, grid=grid)
    out = np.zeros(a.shape[:-2] + (theta.size, phi.size), np.complex128)
    for mi, m in enumerate(_packed_m(L)):
        for l in range(abs(m), L):
            out += a[..., mi, l, None, None] * sph_harm_y(l, m, theta[:, None], phi[None, :])
    return out


@pytest.mark.parametrize("grid,L", [("gauss", 16), ("gauss", 32), ("equiangular", 12)])
@pytest.mark.parametrize("real", [True, False], ids=["real", "complex"])
def test_sht_isht_against_jax_and_float64(case_rng, grid, L, real):
    a = _coefficients(case_rng, L, real)
    f64 = _synth64(a, L, grid)
    f = (f64.real if real else f64).astype(np.float32 if real else np.complex64)
    got = tp.sht(torch.from_numpy(f), grid=grid)
    assert got.dtype == torch.complex64 and got.shape == a.shape
    assert _rel(got, jax.jit(lambda v: jsht.sht(v, grid=grid))(f)) <= TOL
    assert _rel(got, a) <= TOL
    a32 = a.astype(np.complex64)
    back = tp.isht(torch.from_numpy(a32), real_output=real, grid=grid)
    want = jax.jit(lambda v: jsht.isht(v, real_output=real, grid=grid))(a32)
    assert _rel(back, want) <= TOL and _rel(back, f64.real if real else f64) <= TOL


def test_host_tables_are_the_jax_modules():
    for L in (1, 5, 16):
        for grid in ("gauss", "equiangular"):
            for mine, theirs in zip(tsht.sht_grid(L - 1, grid=grid), jsht.sht_grid(L - 1, grid=grid)):
                assert np.array_equal(mine, theirs)
            for (m0, P), (j0, Q) in zip(tsht._legendre_chunks(L, grid),
                                        jsht._legendre_chunks(L, grid)):
                assert m0 == j0 and np.array_equal(P, Q)
            for (m0, P), (j0, Q) in zip(tsht._legendre_deriv_chunks(L, grid),
                                        jsht._legendre_deriv_chunks(L, grid)):
                assert m0 == j0 and np.array_equal(P, Q, equal_nan=True)
        for mine, theirs in zip(tsht._recurrence_coeffs(L) + tsht._recurrence_coeffs_dw(L),
                                jsht._recurrence_coeffs(L) + jsht._recurrence_coeffs_dw(L)):
            assert np.array_equal(mine, theirs)
    assert np.array_equal(tsht._wigner_d_stack(6, 0.7), jsht._wigner_d_stack(6, 0.7))
    assert tsht._M_TILE == jsht._M_TILE and tsht._TABLES_MAX_L == jsht._TABLES_MAX_L


def test_chunks_span_several_m_tiles(case_rng, monkeypatch):
    """L above the m tile: the triangular chunks and their padding, with the
    tile narrowed so that L = 20 spans three chunks."""
    monkeypatch.setattr(tsht, "_M_TILE", 8)
    tsht._legendre_chunks.cache_clear()
    try:
        L = 20
        a = _coefficients(case_rng, L, real=False, batch=1)
        f = _synth64(a, L, "gauss").astype(np.complex64)
        assert len(tsht._legendre_chunks(L, "gauss")) == 3
        assert _rel(tp.sht(torch.from_numpy(f), grid="gauss"), a) <= TOL
        assert _rel(tp.isht(torch.from_numpy(a.astype(np.complex64))), f) <= TOL
    finally:
        tsht._legendre_chunks.cache_clear()


@pytest.mark.parametrize("compensated", [False, True], ids=["plain", "compensated"])
@pytest.mark.parametrize("real", [True, False], ids=["real", "complex"])
def test_recurrence_pair(case_rng, compensated, real):
    L = 24
    a = _coefficients(case_rng, L, real)
    f64 = _synth64(a, L, "gauss")
    f = (f64.real if real else f64).astype(np.float32 if real else np.complex64)
    tol = TOL if compensated else TOL + L * EPS32
    got = tp.sht_recurrence(torch.from_numpy(f), compensated=compensated)
    want = jax.jit(lambda v: jsht.sht_recurrence(v, compensated=compensated))(f)
    assert _rel(got, want) <= TOL and _rel(got, a) <= tol
    a32 = a.astype(np.complex64)
    back = tp.isht_recurrence(torch.from_numpy(a32), real_output=real, compensated=compensated)
    want = jax.jit(lambda v: jsht.isht_recurrence(v, real_output=real, compensated=compensated))(a32)
    assert _rel(back, want) <= TOL and _rel(back, f64.real if real else f64) <= tol


def test_large_band_limits_take_the_recurrence(monkeypatch, case_rng):
    monkeypatch.setattr(tsht, "_TABLES_MAX_L", 8)
    L = 10
    a = _coefficients(case_rng, L, real=True, batch=1)
    f = _synth64(a, L, "gauss").real.astype(np.float32)
    assert _rel(tp.sht(torch.from_numpy(f)), a) <= TOL + L * EPS32
    assert _rel(tp.isht(torch.from_numpy(a.astype(np.complex64)), real_output=True), f) <= TOL + L * EPS32
    with pytest.raises(ValueError):
        tp.sht(torch.zeros(2 * L, 2 * L), grid="equiangular")


@pytest.mark.parametrize("grid", ["gauss", "equiangular"])
def test_scalar_operators(case_rng, grid):
    L = 12
    a = _coefficients(case_rng, L, real=True)
    f = _synth64(a, L, grid).real.astype(np.float32)
    ft = torch.from_numpy(f)
    l = np.arange(L)
    lap64 = _synth64(a * -(l * (l + 1)), L, grid).real
    got = tp.sphere_laplacian(ft, grid=grid)
    assert _rel(got, jax.jit(lambda v: jsht.sphere_laplacian(v, grid=grid))(f)) <= TOL
    assert _rel(got, lap64) <= TOL
    inv = np.zeros(L)
    inv[1:] = -1.0 / (l[1:] * (l[1:] + 1))
    got = tp.poisson_solve_sphere(ft, grid=grid)
    assert _rel(got, jax.jit(lambda v: jsht.poisson_solve_sphere(v, grid=grid))(f)) <= TOL
    assert _rel(got, _synth64(a * inv, L, grid).real) <= TOL
    bl = np.exp(-0.05 * l * (l + 1)).astype(np.float32)
    got = tp.sphere_convolve(ft, torch.from_numpy(bl), grid=grid)
    assert _rel(got, jax.jit(lambda v, b: jsht.sphere_convolve(v, b, grid=grid))(f, bl)) <= TOL
    fc = (f + 1j * f[::-1]).astype(np.complex64)
    got = tp.sphere_laplacian(torch.from_numpy(fc), grid=grid)
    assert got.is_complex() and _rel(got, jax.jit(lambda v: jsht.sphere_laplacian(v, grid=grid))(fc)) <= TOL
    with pytest.raises(ValueError):
        tp.sphere_convolve(ft, torch.ones(L + 1), grid=grid)


@pytest.mark.parametrize("grid", ["gauss", "equiangular"])
def test_vector_operators(case_rng, grid):
    """Gradient, divergence, vorticity, the Helmholtz decomposition and the
    vector harmonics against the JAX functions; div(grad f) against the
    float64 Laplacian."""
    L = 12
    a = _coefficients(case_rng, L, real=True)
    f = _synth64(a, L, grid).real.astype(np.float32)
    ft = torch.from_numpy(f)
    gt, gp = tp.sphere_grad(ft, grid=grid)
    jgt, jgp = jax.jit(lambda v: jsht.sphere_grad(v, grid=grid))(f)
    assert _rel(gt, jgt) <= TOL and _rel(gp, jgp) <= TOL
    l = np.arange(L)
    # an analysis and a synthesis through the 1/sinθ of the derivative tables
    assert _rel(tp.sphere_div(gt, gp, grid=grid), _synth64(a * -(l * (l + 1)), L, grid).real) <= 1e-4
    ut = case_rng.standard_normal(f.shape).astype(np.float32)
    up = case_rng.standard_normal(f.shape).astype(np.float32)
    T = torch.from_numpy
    for name in ("sphere_div", "sphere_vort"):
        got = getattr(tp, name)(T(ut), T(up), grid=grid)
        assert _rel(got, jax.jit(lambda u, v: getattr(jsht, name)(u, v, grid=grid))(ut, up)) <= TOL
    for name in ("sphere_helmholtz", "vsht"):
        got = getattr(tp, name)(T(ut), T(up), grid=grid)
        want = jax.jit(lambda u, v: getattr(jsht, name)(u, v, grid=grid))(ut, up)
        assert all(_rel(g, w) <= TOL for g, w in zip(got, want))
    s_lm, t_lm = tp.vsht(T(ut), T(up), grid=grid)
    got = tp.ivsht(s_lm, t_lm, grid=grid)
    want = jax.jit(lambda s, t: jsht.ivsht(s, t, grid=grid))(s_lm.numpy(), t_lm.numpy())
    assert all(_rel(g, w) <= TOL for g, w in zip(got, want))
    with pytest.raises(ValueError):
        tp.sphere_div(T(ut), T(up[:, :-1]), grid=grid)


def test_rotation(case_rng):
    """rotate_sht against the JAX function; the inverse rotation gives the
    coefficients back and every degree keeps its power."""
    L = 10
    a = _coefficients(case_rng, L, real=False, batch=1)
    a32 = a.astype(np.complex64)
    angles = (0.4, 1.1, -0.7)
    got = tp.rotate_sht(torch.from_numpy(a32), *angles)
    assert _rel(got, jax.jit(lambda v: jsht.rotate_sht(v, *angles))(a32)) <= TOL
    back = tp.rotate_sht(got, -angles[2], -angles[1], -angles[0])
    assert _rel(back, a) <= TOL
    power = lambda c: (np.abs(c) ** 2).sum(-2)   # noqa: E731
    assert _rel(power(got.numpy()), power(a)) <= TOL
    with pytest.raises(ValueError):
        tp.rotate_sht(torch.zeros(3, 3, dtype=torch.complex64))


def test_errors():
    with pytest.raises(ValueError):
        tp.sht(torch.zeros(4, 7))
    with pytest.raises(ValueError):
        tp.sht(torch.zeros(4, 8), grid="healpix")
    with pytest.raises(ValueError):
        tp.isht(torch.zeros(4, 4, dtype=torch.complex64))
    with pytest.raises(ValueError):
        tp.sht_recurrence(torch.zeros(4, 7))
    with pytest.raises(ValueError):
        tp.sht_grid(-1)
