"""PyTorch port: ``utils/scan.py``, the scans that stand in for
``lax.associative_scan`` and ``lax.scan``.

``linear_recurrence`` is held against a float64 loop of s[n] = A·s[n−1] +
c[n] (relative error 1e-5 of the states' maximum: fp32 sums of a block's
terms) and against the JAX package's ``iir._recurrence_scan`` on the same
inputs (1e-5 plus the JAX result's own error against float64, from a
generator local to the case), for p = 1, 2 and 6, lengths that are shorter than a block,
a block plus one and several levels of blocks; its device-coefficient
form (per-channel p = 1, a learned tensor) against a float64 loop, forward
(1e-5) and gradient (elementwise 1e-5 of the float64 gradient of the loss
with every term made positive).  ``associative_scan`` is held against a sequential
fold and against ``jax.lax.associative_scan`` (reverse included)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixed_radix_fast_fourier_transform_tpu.ops import iir as jiir
from mixed_radix_fast_fourier_transform_tpu_torch.utils import scan

torch.set_num_threads(1)

TOL = 1e-5


def _rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30)


def _loop(A, c, s0):
    s, out = s0, []
    for t in range(c.shape[0]):
        s = np.einsum("ij,...j->...i", A, s) + c[t]
        out.append(s)
    return np.stack(out)


def _stable(rng, p, radius=0.98):
    M = rng.standard_normal((p, p))
    return radius * M / np.max(np.abs(np.linalg.eigvals(M)))


def _case(rng, p, n):
    A = _stable(rng, p)
    c = rng.standard_normal((n, 3, p)).astype(np.float32)
    s0 = rng.standard_normal((3, p)).astype(np.float32)
    got = scan.linear_recurrence(A, torch.from_numpy(c), torch.from_numpy(s0))
    assert got.dtype == torch.float32
    return A, c, s0, got


@pytest.mark.parametrize("p", [1, 2, 6])
@pytest.mark.parametrize("n", [1, 37, 129, 700, 20000])
def test_linear_recurrence_against_float64(rng, p, n):
    A, c, s0, got = _case(rng, p, n)
    assert _rel(got, _loop(A, c.astype(np.float64), s0.astype(np.float64))) <= TOL


@pytest.fixture
def case_rng(request):
    """A generator made for one test case from its parameters: its draws do
    not depend on which tests ran before on the worker, as the session
    ``rng``'s do."""
    return np.random.default_rng([ord(ch) for ch in request.node.name])


@pytest.mark.parametrize("p,n", [(1, 700), (2, 129), (6, 37)])
def test_linear_recurrence_against_jax(case_rng, p, n):
    """The port against float64 at TOL, and against the JAX package at TOL
    plus the JAX result's own error against float64 on the same draw (the
    triangle bound): ``lax.associative_scan`` takes log2(n) levels of fp32
    matrix products and reaches ~5e-6 on some draws, so a bound of TOL on
    port vs JAX alone would sit on the reference's error.  The JAX term is
    held to TOL as well.  Errors are relative to max |float64 states|."""
    A, c, s0, got = _case(case_rng, p, n)
    want = _loop(A, c.astype(np.float64), s0.astype(np.float64))
    ref = np.asarray(jax.jit(lambda c, s0: jiir._recurrence_scan(A, c, s0))(
        jnp.asarray(c), jnp.asarray(s0)))
    scale = np.max(np.abs(want))
    port_err = np.max(np.abs(got.numpy() - want)) / scale
    jax_err = np.max(np.abs(ref - want)) / scale
    assert port_err <= TOL and jax_err <= TOL
    assert np.max(np.abs(got.numpy() - ref)) / scale <= TOL + jax_err


def test_linear_recurrence_broadcasts_the_initial_state_and_keeps_middle_axes(rng):
    A = _stable(rng, 2)
    c = rng.standard_normal((300, 2, 3, 2))
    s0 = rng.standard_normal(2)              # one state for every channel
    want = _loop(A, c, np.broadcast_to(s0, (2, 3, 2)))
    got = scan.linear_recurrence(A, torch.from_numpy(c), torch.from_numpy(s0))
    assert got.shape == c.shape and _rel(got, want) <= 1e-12   # float64 in, float64 out
    empty = torch.zeros(0, 4, 1)
    assert scan.linear_recurrence(0.5, empty, torch.zeros(4, 1)).shape == (0, 4, 1)


@pytest.mark.parametrize("shape,a_shape", [((300, 4, 5), (5,)), ((300, 4, 5), (4, 1)),
                                           ((200,), ()), ((130, 2, 3), (2, 3))],
                         ids=["per-band", "per-row", "scalar", "every-channel"])
def test_linear_recurrence_device_coefficients_and_gradient(case_rng, shape, a_shape):
    """p = 1 with a tensor A that needs a gradient, as pcen's learned
    smoother coefficient does: the forward against a float64 loop in torch
    (TOL of the states' maximum), and each gradient leaf of A, c and s0
    elementwise to TOL of the float64 gradient of the same loss taken with
    |c|, |s0| and |w|.  A's gradient is a sum over every step whose terms
    cancel, so a bound relative to its result would sit on fp32's rounding
    of the terms; with a > 0 every term of the |·| loss is positive, and its
    gradient is the size of the terms that are summed."""
    a = case_rng.uniform(0.5, 0.99, a_shape)
    c = case_rng.standard_normal(shape + (1,))
    s0 = case_rng.standard_normal(shape[1:] + (1,))
    w = case_rng.standard_normal(shape + (1,))

    def loop64(a, c, s0, w):
        leaves = [torch.tensor(v, dtype=torch.float64, requires_grad=True) for v in (a, c, s0)]
        a64, c64, s64 = leaves
        s, out = s64, []
        for t in range(shape[0]):
            s = a64[..., None] * s + c64[t]
            out.append(s)
        want = torch.stack(out)
        (want * torch.from_numpy(w)).sum().backward()
        return want.detach(), [v.grad for v in leaves]

    leaves32 = [torch.tensor(v, dtype=torch.float32, requires_grad=True) for v in (a, c, s0)]
    got = scan.linear_recurrence(*leaves32)
    want, grads64 = loop64(a, c, s0, w)
    _, scale64 = loop64(a, np.abs(c), np.abs(s0), np.abs(w))
    assert _rel(got, want) <= TOL
    (got * torch.from_numpy(w).float()).sum().backward()
    for g, r, bound in zip(leaves32, grads64, scale64):
        assert g.grad.shape == r.shape
        assert torch.all((g.grad.double() - r).abs() <= TOL * bound)


def test_linear_recurrence_gradient_at_a_zero(rng):
    """A coefficient of 0 (the state forgets at once) still has a finite
    gradient: the powers of A are products, not ``pow``."""
    a = torch.tensor([0.0, 0.5, -0.9], dtype=torch.float64, requires_grad=True)
    c = torch.tensor(rng.standard_normal((300, 3, 1)))
    got = scan.linear_recurrence(a, c, torch.ones(3, 1, dtype=torch.float64))
    got.sum().backward()
    s, out, a_ = torch.ones(3, dtype=torch.float64), [], a.detach().clone().requires_grad_(True)
    for t in range(300):
        s = a_ * s + c[t, :, 0]
        out.append(s)
    torch.stack(out).sum().backward()
    assert torch.isfinite(a.grad).all() and _rel(a.grad, a_.grad) <= 1e-12


def test_linear_recurrence_errors():
    with pytest.raises(ValueError):
        scan.linear_recurrence(torch.ones(3), torch.zeros(5, 3, 2), torch.zeros(3, 2))
    with pytest.raises(ValueError):
        scan.linear_recurrence(torch.ones(2, 3), torch.zeros(5, 3, 1), torch.zeros(3, 1))


def _affine(earlier, later):
    (M1, v1), (M2, v2) = earlier, later
    return M2 @ M1, (M2 @ v1[..., None])[..., 0] + v2


@pytest.mark.parametrize("n,reverse", [(1, False), (2, True), (7, False), (16, True), (33, False),
                                       (33, True)])
def test_associative_scan_against_a_fold_and_jax(rng, n, reverse):
    M = (0.5 * rng.standard_normal((n, 3, 3))).astype(np.float32)
    v = rng.standard_normal((n, 3)).astype(np.float32)
    gotM, gotv = scan.associative_scan(_affine, (torch.from_numpy(M), torch.from_numpy(v)),
                                       reverse=reverse)
    order = range(n - 1, -1, -1) if reverse else range(n)
    acc, foldM, foldv = None, np.zeros_like(M, np.float64), np.zeros_like(v, np.float64)
    for i in order:
        e = (M[i].astype(np.float64), v[i].astype(np.float64))
        acc = e if acc is None else (e[0] @ acc[0], e[0] @ acc[1] + e[1])
        foldM[i], foldv[i] = acc
    assert _rel(gotM, foldM) <= TOL and _rel(gotv, foldv) <= TOL
    jaffine = lambda a, b: (b[0] @ a[0], jnp.einsum("...ij,...j->...i", b[0], a[1]) + b[1])
    refM, refv = jax.jit(lambda e: jax.lax.associative_scan(jaffine, e, reverse=reverse))(
        (jnp.asarray(M), jnp.asarray(v)))
    assert _rel(gotM, refM) <= TOL and _rel(gotv, refv) <= TOL


def test_associative_scan_single_tensor_other_axis_and_errors(rng):
    x = rng.standard_normal((4, 9)).astype(np.float32)
    got = scan.associative_scan(torch.add, torch.from_numpy(x), dim=1)
    assert _rel(got, np.cumsum(x.astype(np.float64), axis=1)) <= TOL
    got = scan.associative_scan(torch.maximum, torch.from_numpy(x), dim=-1, reverse=True)
    assert np.array_equal(got.numpy(), np.maximum.accumulate(x[:, ::-1], axis=1)[:, ::-1])
    with pytest.raises(ValueError):
        scan.associative_scan(_affine, (torch.zeros(3, 2, 2), torch.zeros(4, 2)))
