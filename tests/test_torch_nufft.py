"""PyTorch port: ``ops/nufft.py`` against the JAX package and a float64
direct sum on the same inputs.

Inputs come from a generator made for each case from its name.  Every
transform is held to the JAX function at 1e-5 of the output's maximum and
to the float64 direct sum (numpy) at 1e-5: the grid path runs at ε = 1e-6
(its Gaussian of 2·8 taps errs by ~1e-8), so its budget is the fp32 floor,
and the type-3 fast path at ε = 1e-6 likewise.  The port spreads by scatter
where the JAX module multiplies block one-hots, so the sums agree to fp32
reordering, not bit for bit; the phase reduction is the same chain of
error-free ops and is held bit-equal.

Points lie in [0, 2π), where that reduction is exact.  For a negative point
both packages lose up to 2^-25 of frac(x/2π) when ``_unit_frac`` adds the
integer part back (u_hi + 1 rounds to the coarser ulp of [0.5, 1)), so a
phase factor of mode k errs by up to 2π·|k|·2^-25 (4.8e-5 at |k| = 256;
ROADMAP's F7): ``test_negative_points_carry_the_reference_phase_error``
holds the port to the JAX function there and to float64 at that bound.  The JAX functions run jitted (type 3
with its extents given, as its fast path needs under jit)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixed_radix_fast_fourier_transform_tpu.ops import nufft as jn

import mixed_radix_fast_fourier_transform_tpu_torch as tp
from mixed_radix_fast_fourier_transform_tpu_torch.ops import nufft as tn

torch.set_num_threads(1)

TOL = 1e-5
# the grid path against float64: ε = 1e-6 plus fp32 rounding of the spread
# and the FFT, which the deconvolution multiplies by up to e^{k²τ} ≈ 8 at the
# band edge (k = n/2, σ = 2, 8 taps a side: k²τ = π·8/(4·2·1.5))
GRID_TOL = 5e-5
M = 300


@pytest.fixture
def case_rng(request):
    return np.random.default_rng([ord(ch) for ch in request.node.name])


def _np(v):
    return v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _rel(got, want):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


def _c(rng, *shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _pts(rng, m=M):
    return rng.uniform(0.0, 2.0 * np.pi, m).astype(np.float32)


def _modes(n):
    return np.arange(-(n // 2), (n + 1) // 2)


def _direct1(pts, c, ns, isign):
    """Type 1 in float64: f[k…] = Σ_j c_j e^{isign·i·k·x_j} over every axis."""
    phase = 0.0
    grids = np.meshgrid(*(_modes(n) for n in ns), indexing="ij")
    for k, x in zip(grids, pts):
        phase = phase + k[..., None] * x.astype(np.float64)
    return np.exp(1j * isign * phase) @ c.astype(np.complex128).T if c.ndim == 1 else \
        np.moveaxis(np.exp(1j * isign * phase) @ c.astype(np.complex128).T, -1, 0)


def _direct2(pts, f, isign):
    """Type 2 in float64: c_j = Σ_k f[k…] e^{isign·i·k·x_j}."""
    ns = f.shape[-len(pts):]
    grids = np.meshgrid(*(_modes(n) for n in ns), indexing="ij")
    phase = 0.0
    for k, x in zip(grids, pts):
        phase = phase + k.reshape(-1)[:, None] * x.astype(np.float64)[None, :]
    flat = f.reshape(f.shape[:-len(pts)] + (-1,)).astype(np.complex128)
    return flat @ np.exp(1j * isign * phase)


def test_phase_reduction_is_bit_equal(case_rng):
    """``_unit_frac`` and the int32 floor modulo of ``_phase_trig`` are the
    JAX module's error-free chain: equal words, negative points included
    (with subnormals flushed, as XLA's CPU backend flushes them: a point of
    1e-30 makes subnormal products)."""
    x = np.concatenate([_pts(case_rng, 500), -_pts(case_rng, 100),
                        np.float32([0.0, -0.0, np.pi, -np.pi, 1e-30, 3e4])])
    assert torch.set_flush_denormal(True)
    try:
        hi, lo = tn._unit_frac(torch.from_numpy(x))
    finally:
        torch.set_flush_denormal(False)
    jhi, jlo = jn._unit_frac(jnp.asarray(x))
    assert np.array_equal(hi.numpy(), np.asarray(jhi)) and np.array_equal(lo.numpy(), np.asarray(jlo))
    k = _modes(4000)
    cos, sin = tn._phase_trig(k, torch.from_numpy(x), -1)
    jcos, jsin = jn._phase_trig(k, jnp.asarray(x), -1)
    assert np.max(np.abs(cos.numpy() - np.asarray(jcos))) <= 1e-6
    assert np.max(np.abs(sin.numpy() - np.asarray(jsin))) <= 1e-6
    want = np.exp(-1j * k[:, None] * x.astype(np.float64)[None, :])
    err = np.abs(cos.numpy() + 1j * sin.numpy() - want)
    assert np.max(err[:, (x >= 0) & (x < 7)]) <= 3e-6
    bound = 3e-6 + 2 * np.pi * np.abs(k)[:, None] * 2.0 ** -25     # F7, negative points
    assert np.all(err[:, x < 0] <= bound)
    with pytest.raises(ValueError):
        tn._phase_trig(np.array([1 << 16]), torch.from_numpy(x), 1)


@pytest.mark.parametrize("method", ["dense", "grid"])
def test_negative_points_carry_the_reference_phase_error(case_rng, method):
    """F7: on [-π, π) the port keeps the JAX module's reduction and so its
    error; held to the JAX function at 1e-5 and to float64 at GRID_TOL plus
    the phase bound 2π·(n/2)·2^-25."""
    n = 512
    x, c = -_pts(case_rng) + np.float32(np.pi), _c(case_rng, M)
    got = tp.nufft1(torch.from_numpy(x), torch.from_numpy(c), n, method=method)
    want = jax.jit(lambda x, c: jn.nufft1(x, c, n, method=method))(x, c)
    assert _rel(got, want) <= TOL
    assert _rel(got, _direct1([x], c, (n,), -1)) <= GRID_TOL + 2 * np.pi * (n // 2) * 2.0 ** -25


def test_grid_helpers_match_the_jax_module(case_rng):
    """The private names the sharded paths import keep their meaning."""
    for n in (1, 64, 100, 513):
        for eps in (1e-3, 1e-6, 1e-9):
            assert tn._grid_params(n, eps) == jn._grid_params(n, eps)
            mr, tau, _ = tn._grid_params(n, eps)
            assert np.array_equal(tn._deconv(n, mr, tau), jn._deconv(n, mr, tau))
    spec = _c(case_rng, 2, 128)
    got = tn._center(torch.from_numpy(spec), 128, 50)
    assert np.array_equal(got.numpy(), np.asarray(jn._center(jnp.asarray(spec), 128, 50)))
    back = tn._wrap(got, 128)
    assert np.array_equal(back.numpy(), np.asarray(jn._wrap(jnp.asarray(got.numpy()), 128)))
    assert np.array_equal(tn._center(torch.from_numpy(spec), 128, 7, axis=0).numpy(),
                          np.asarray(jn._center(jnp.asarray(spec), 128, 7, axis=0)))
    for name in ("_center", "_deconv", "_grid_params", "_spread", "_interp", "_wrap",
                 "_spread_2d", "_interp_2d"):
        assert callable(getattr(tn, name))


@pytest.mark.parametrize("method", ["dense", "grid"])
@pytest.mark.parametrize("n", [64, 512])
def test_1d_types_1_and_2(case_rng, method, n):
    x, c, f = _pts(case_rng), _c(case_rng, 2, M), _c(case_rng, n)
    got1 = tp.nufft1(torch.from_numpy(x), torch.from_numpy(c), n, method=method)
    assert got1.dtype == torch.complex64
    tol64 = GRID_TOL if method == "grid" else TOL
    want1 = jax.jit(lambda x, c: jn.nufft1(x, c, n, method=method))(x, c)
    assert _rel(got1, want1) <= TOL and _rel(got1, _direct1([x], c, (n,), -1)) <= tol64
    got2 = tp.nufft2(torch.from_numpy(x), torch.from_numpy(f), isign=-1, method=method)
    want2 = jax.jit(lambda x, f: jn.nufft2(x, f, isign=-1, method=method))(x, f)
    assert _rel(got2, want2) <= TOL and _rel(got2, _direct2([x], f, -1)) <= tol64


def test_1d_dense_entry_points_and_real_strengths(case_rng):
    x, c = _pts(case_rng), case_rng.standard_normal(M).astype(np.float32)
    got = tp.nudft1(torch.from_numpy(x), torch.from_numpy(c), 33, isign=1)
    assert _rel(got, _direct1([x], c, (33,), 1)) <= TOL
    f = _c(case_rng, 3, 33)
    got = tp.nudft2(torch.from_numpy(x), torch.from_numpy(f))
    assert _rel(got, jax.jit(jn.nudft2)(x, f)) <= TOL and _rel(got, _direct2([x], f, 1)) <= TOL
    with pytest.raises(ValueError):
        tp.nufft1(torch.from_numpy(x), torch.from_numpy(c), 8, method="nope")
    with pytest.raises(ValueError):
        tp.nufft1(torch.from_numpy(x), torch.from_numpy(c[:-1]), 8)
    with pytest.raises(ValueError):
        tp.nudft1(torch.from_numpy(x), torch.from_numpy(c), 0)


@pytest.mark.parametrize("method", ["dense", "grid"])
def test_2d_types_1_and_2(case_rng, method):
    x, y, c, f = _pts(case_rng), _pts(case_rng), _c(case_rng, M), _c(case_rng, 2, 32, 48)
    X, Y = torch.from_numpy(x), torch.from_numpy(y)
    tol64 = GRID_TOL if method == "grid" else TOL
    got1 = tp.nufft1_2d(X, Y, torch.from_numpy(c), (32, 48), method=method)
    want1 = jax.jit(lambda x, y, c: jn.nufft1_2d(x, y, c, (32, 48), method=method))(x, y, c)
    assert _rel(got1, want1) <= TOL and _rel(got1, _direct1([x, y], c, (32, 48), -1)) <= tol64
    got2 = tp.nufft2_2d(X, Y, torch.from_numpy(f), method=method)
    want2 = jax.jit(lambda x, y, f: jn.nufft2_2d(x, y, f, method=method))(x, y, f)
    assert _rel(got2, want2) <= TOL and _rel(got2, _direct2([x, y], f, 1)) <= tol64


@pytest.mark.parametrize("method", ["dense", "grid"])
def test_3d_types_1_and_2(case_rng, method):
    pts = [_pts(case_rng, 120) for _ in range(3)]
    c, f = _c(case_rng, 120), _c(case_rng, 8, 6, 10)
    T = [torch.from_numpy(p) for p in pts]
    tol64 = GRID_TOL if method == "grid" else TOL
    got1 = tp.nufft1_3d(*T, torch.from_numpy(c), (8, 6, 10), method=method)
    want1 = jax.jit(lambda x, y, z, c: jn.nufft1_3d(x, y, z, c, (8, 6, 10), method=method))(*pts, c)
    assert _rel(got1, want1) <= TOL and _rel(got1, _direct1(pts, c, (8, 6, 10), -1)) <= tol64
    got2 = tp.nufft2_3d(*T, torch.from_numpy(f), method=method)
    want2 = jax.jit(lambda x, y, z, f: jn.nufft2_3d(x, y, z, f, method=method))(*pts, f)
    assert _rel(got2, want2) <= TOL and _rel(got2, _direct2(pts, f, 1)) <= tol64


def test_sorted_segment_engine_against_the_scatter(case_rng):
    """The sorted-segment spreaders (never chosen by "auto") compute the
    scatter's sums; the compensated segment sum against float64."""
    x, y, c = _pts(case_rng), _pts(case_rng), _c(case_rng, 2, M)
    X, Y, C = torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(c)
    mr, tau, msp = tn._grid_params(64, 1e-6)
    assert _rel(tn._spread_sorted(X, C, mr, tau, msp), tn._spread(X, C, mr, tau, msp).numpy()) <= TOL
    mrs, taus = (64, 128), (tau, tn._grid_params(64, 1e-6)[1])
    assert _rel(tn._spread_sorted_2d(X, Y, C, mrs, taus, msp),
                tn._spread_2d(X, Y, C, mrs, taus, msp).numpy()) <= TOL
    v = (1e4 + case_rng.standard_normal(5000)).astype(np.float32)
    bnd = np.sort(case_rng.integers(0, 5001, 41))
    got = tn._seg_sum_sorted(torch.from_numpy(v), torch.from_numpy(bnd[:-1]), torch.from_numpy(bnd[1:]))
    cs = np.concatenate([[0.0], np.cumsum(v.astype(np.float64))])
    want = cs[bnd[1:]] - cs[bnd[:-1]]
    assert np.max(np.abs(got.numpy() - want)) <= 1e-6 * np.max(np.abs(want))
    perm, b = tn._sorted_cells(torch.tensor([3, 1, 3, 0, 1]), 5)
    assert perm.tolist() == [3, 1, 4, 0, 2] and b.tolist() == [0, 1, 3, 3, 5, 5]


@pytest.mark.parametrize("method", ["dense", "fast"])
def test_type_3(case_rng, method):
    x, y, z = (_pts(case_rng, 200) for _ in range(3))
    s, t, u = (case_rng.uniform(-20.0, 20.0, 60).astype(np.float32) for _ in range(3))
    c = _c(case_rng, 200)
    ext = dict(x_extent=float(np.pi), s_extent=20.0, x_center=float(np.pi))
    T = lambda a: torch.from_numpy(a)   # noqa: E731
    want64 = np.exp(-1j * np.outer(s.astype(np.float64), x)) @ c.astype(np.complex128)
    got = tp.nufft3(T(x), T(c), T(s), method=method, **ext)
    assert _rel(got, jax.jit(lambda x, c, s: jn.nufft3(x, c, s, method=method, **ext))(x, c, s)) <= TOL
    assert _rel(got, want64) <= TOL
    # the extent read from the points: the JAX function eagerly
    assert _rel(tp.nufft3(T(x), T(c), T(s), method=method), jn.nufft3(x, c, s, method=method)) <= TOL
    ext2 = dict(x_extent=float(np.pi), y_extent=float(np.pi), s_extent=20.0, t_extent=20.0,
                centers=(float(np.pi), float(np.pi), 0.0, 0.0))
    got = tp.nufft3_2d(T(x), T(y), T(c), T(s), T(t), method=method, **ext2)
    want = jax.jit(lambda *a: jn.nufft3_2d(*a, method=method, **ext2))(x, y, c, s, t)
    phase = np.outer(s, x).astype(np.float64) + np.outer(t, y)
    assert _rel(got, want) <= TOL and _rel(got, np.exp(-1j * phase) @ c.astype(np.complex128)) <= TOL
    # 3-D at a quarter of the bandwidth: the inner grid grows as (S·X)³
    s, t, u = s / 4, t / 4, u / 4
    ext3 = dict(extents=(float(np.pi),) * 3 + (5.0,) * 3, centers=(float(np.pi),) * 3 + (0.0,) * 3)
    got = tp.nufft3_3d(T(x), T(y), T(z), T(c), T(s), T(t), T(u), method=method, **ext3)
    want = jax.jit(lambda *a: jn.nufft3_3d(*a, method=method, **ext3))(x, y, z, c, s, t, u)
    phase = np.outer(s, x).astype(np.float64) + np.outer(t, y) + np.outer(u, z)
    assert _rel(got, want) <= TOL and _rel(got, np.exp(-1j * phase) @ c.astype(np.complex128)) <= TOL


def test_type_3_auto_and_centres(case_rng):
    """"auto" takes the JAX module's cost model on the same spans; a
    shifted set of points and frequencies through the centre phases."""
    x = (_pts(case_rng, 200) + 3.0).astype(np.float32)
    s = case_rng.uniform(10.0, 30.0, 50).astype(np.float32)
    c = _c(case_rng, 200)
    T = lambda a: torch.from_numpy(a)   # noqa: E731
    want64 = np.exp(1j * np.outer(s.astype(np.float64), x)) @ c.astype(np.complex128)
    for method in ("auto", "fast"):
        got = tp.nufft3(T(x), T(c), T(s), isign=1, method=method)
        assert _rel(got, jn.nufft3(x, c, s, isign=1, method=method)) <= TOL
        assert _rel(got, want64) <= TOL
    assert tn._type3_fast_wins(1e-6, 1, 10 ** 5, 10 ** 5, (10.0,))
    assert not tn._type3_fast_wins(1e-6, 1, 100, 100, (1e4,))


@pytest.mark.parametrize("dims", [1, 2, 3])
def test_least_squares(case_rng, dims):
    """A fixed number of CG steps on the circulant-embedded normal
    equations: the port against the JAX function after the same steps, and
    the modes of samples made from known modes recovered."""
    ns = {1: (24,), 2: (8, 6), 3: (4, 4, 4)}[dims]
    pts = [_pts(case_rng, 400) for _ in range(dims)]
    truth = _c(case_rng, *ns)
    b = _direct2(pts, truth, 1).astype(np.complex64)
    w = case_rng.uniform(0.5, 1.5, 400).astype(np.float32)
    port = {1: tp.nufft_lsq, 2: tp.nufft_lsq_2d, 3: tp.nufft_lsq_3d}[dims]
    jfn = {1: jn.nufft_lsq, 2: jn.nufft_lsq_2d, 3: jn.nufft_lsq_3d}[dims]
    n_arg = ns[0] if dims == 1 else ns
    got = port(*(torch.from_numpy(p) for p in pts), torch.from_numpy(b), n_arg,
               weights=torch.from_numpy(w), iters=8, damp=1e-3)
    want = jax.jit(lambda *a: jfn(*a[:-1], n_arg, weights=a[-1], iters=8, damp=1e-3))(*pts, b, w)
    assert _rel(got, want) <= 1e-4   # 8 CG steps amplify fp32 rounding on both sides
    solved = port(*(torch.from_numpy(p) for p in pts), torch.from_numpy(b), n_arg, iters=40)
    assert _rel(solved, truth) <= 1e-3


def test_gradients_match_jax(case_rng):
    """The grid path is differentiable (scatter and gather are an adjoint
    pair): gradients of a real loss with respect to the modes' planes and
    the strengths' planes against ``jax.grad``."""
    x, fr, fi = _pts(case_rng), case_rng.standard_normal(64), case_rng.standard_normal(64)
    cr, ci = case_rng.standard_normal(M), case_rng.standard_normal(M)

    def jloss(fr, fi, cr, ci):
        a = jn.nufft2(x, fr + 1j * fi, method="grid")
        b = jn.nufft1(x, cr + 1j * ci, 64, method="grid")
        return jnp.sum(jnp.abs(a) ** 2) + jnp.sum(jnp.real(b) * jnp.arange(64))

    leaves = [torch.tensor(v, dtype=torch.float32, requires_grad=True) for v in (fr, fi, cr, ci)]
    a = tp.nufft2(torch.from_numpy(x), torch.complex(leaves[0], leaves[1]), method="grid")
    b = tp.nufft1(torch.from_numpy(x), torch.complex(leaves[2], leaves[3]), 64, method="grid")
    loss = torch.sum(torch.abs(a) ** 2) + torch.sum(b.real * torch.arange(64))
    grads = torch.autograd.grad(loss, leaves)
    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3)))(
        *(v.astype(np.float32) for v in (fr, fi, cr, ci)))
    for g, w in zip(grads, want):
        assert _rel(g, w) <= TOL
