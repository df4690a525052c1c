"""PyTorch port: ``ops/kalman.py`` against the JAX package and a float64
numpy filter on the same inputs.

The parallel form runs ``utils.scan.associative_scan`` with the JAX module's
combine functions (batched fp32 solves), the sequential default a loop in
the scan's order.  Tolerances are the JAX package's own test tolerances
(``tests/test_kalman.py``): means within 3e-4 (filter) and 5e-4 (smoother)
of max(1, max |m|), covariances within 3e-4 / 5e-4 absolute, the parallel
form within 2e-4 of the sequential one."""

import jax
import numpy as np
import pytest
import torch

import mixed_radix_fast_fourier_transform_tpu as sp

import mixed_radix_fast_fourier_transform_tpu_torch as tp
from mixed_radix_fast_fourier_transform_tpu_torch.ops import kalman as tkal

torch.set_num_threads(1)


def _model(d=4, d_obs=2, seed=0):
    rng = np.random.default_rng(seed)
    F = rng.standard_normal((d, d))
    F *= 0.95 / max(np.abs(np.linalg.eigvals(F)))
    Lq = 0.1 * rng.standard_normal((d, d))
    Lr = 0.3 * rng.standard_normal((d_obs, d_obs))
    return (F, Lq @ Lq.T + 0.01 * np.eye(d), rng.standard_normal((d_obs, d)),
            Lr @ Lr.T + 0.05 * np.eye(d_obs), rng.standard_normal(d), np.eye(d))


def _observations(model, T, seed=1):
    F, Q, H, R, m0, P0 = model
    rng = np.random.default_rng(seed)
    x, ys = rng.multivariate_normal(m0, P0), []
    for _ in range(T):
        x = F @ x + rng.multivariate_normal(np.zeros(len(m0)), Q)
        ys.append(H @ x + rng.multivariate_normal(np.zeros(len(R)), R))
    return np.array(ys)


def _oracle(F, Q, H, R, m0, P0, ys):
    """Kalman filter and Rauch-Tung-Striebel smoother in float64 numpy."""
    m, P, ms, Ps = m0, P0, [], []
    for y in ys:
        m, P = F @ m, F @ P @ F.T + Q
        K = P @ H.T @ np.linalg.inv(H @ P @ H.T + R)
        m, P = m + K @ (y - H @ m), (np.eye(len(m)) - K @ H) @ P
        ms.append(m)
        Ps.append(P)
    gs, Ls = [ms[-1]], [Ps[-1]]
    for k in range(len(ys) - 2, -1, -1):
        P_pred = F @ Ps[k] @ F.T + Q
        G = Ps[k] @ F.T @ np.linalg.inv(P_pred)
        gs.append(ms[k] + G @ (gs[-1] - F @ ms[k]))
        Ls.append(Ps[k] + G @ (Ls[-1] - P_pred) @ G.T)
    return np.array(ms), np.array(Ps), np.array(gs[::-1]), np.array(Ls[::-1])


def _close(got, want, tol):
    m, P = (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v) for v in got)
    scale = max(1.0, float(np.max(np.abs(want[0]))))
    assert m.shape == want[0].shape and P.shape == want[1].shape
    assert np.max(np.abs(m - want[0])) <= tol * scale and np.max(np.abs(P - want[1])) <= tol


@pytest.mark.parametrize("fn,tol", [("kalman_filter", 3e-4), ("kalman_smoother", 5e-4)])
@pytest.mark.parametrize("parallel", [True, False], ids=["parallel", "sequential"])
def test_against_jax_and_float64(fn, tol, parallel):
    model = _model(seed=3)
    ys = _observations(model, 100, seed=4)
    fm, fP, sm, sP = _oracle(*model, ys)
    cpu = [torch.tensor(m) for m in model]      # tensors: the result stays on the CPU
    got = getattr(tp, fn)(*cpu, ys, parallel=parallel)
    assert got[0].dtype == torch.float32 and got[0].device.type == "cpu"
    _close(got, (fm, fP) if fn == "kalman_filter" else (sm, sP), tol)
    want = jax.jit(lambda y: getattr(sp, fn)(*model, y, parallel=parallel))(ys)
    _close(got, [np.asarray(w, np.float64) for w in want], tol)


def test_parallel_matches_sequential_on_a_long_track():
    model = _model(d=2, d_obs=1, seed=9)
    ys = _observations(model, 2048, seed=10)
    cpu = [torch.tensor(m) for m in model]
    mp, Pp = tp.kalman_filter(*cpu, ys, parallel=True)
    msq, Psq = tp.kalman_filter(*cpu, ys, parallel=False)
    scale = max(1.0, float(msq.abs().max()))
    assert float((mp - msq).abs().max()) <= 2e-4 * scale and float((Pp - Psq).abs().max()) <= 2e-4


def test_combines_match_the_jax_elements(rng):
    """One combine of random elements: the filter's (A, b, C, η, J) and the
    smoother's (E, g, L), against the JAX module's functions."""
    from mixed_radix_fast_fourier_transform_tpu.ops import kalman as jkal

    def elems(shapes):
        out = []
        for s in shapes:
            v = rng.standard_normal(s).astype(np.float32)
            if len(s) == 3:
                v = 0.3 * v + (np.eye(s[-1], dtype=np.float32) if s in ((5, 3, 3),) else 0.0)
            out.append(v)
        return out

    left = elems([(5, 3, 3), (5, 3), (5, 3, 3), (5, 3), (5, 3, 3)])
    right = elems([(5, 3, 3), (5, 3), (5, 3, 3), (5, 3), (5, 3, 3)])
    got = tkal._filter_combine([torch.tensor(v) for v in left], [torch.tensor(v) for v in right])
    want = jkal._filter_combine(left, right)
    for g, w in zip(got, want):
        assert np.max(np.abs(g.numpy() - np.asarray(w))) <= 1e-5 * max(1.0, np.max(np.abs(np.asarray(w))))
    got = tkal._smoother_combine([torch.tensor(v) for v in right[:3]], [torch.tensor(v) for v in left[:3]])
    want = jkal._smoother_combine(right[:3], left[:3])
    for g, w in zip(got, want):
        assert np.max(np.abs(g.numpy() - np.asarray(w))) <= 1e-5 * max(1.0, np.max(np.abs(np.asarray(w))))


def test_smoothing_reduces_uncertainty_and_validation():
    model = _model(seed=7)
    ys = _observations(model, 300, seed=8)
    cpu = [torch.tensor(m) for m in model]
    fm, fP = tp.kalman_filter(*cpu, ys)
    sm, sP = tp.kalman_smoother(*cpu, ys)
    tr_f = torch.diagonal(fP, dim1=1, dim2=2).sum(-1)
    tr_s = torch.diagonal(sP, dim1=1, dim2=2).sum(-1)
    assert bool((tr_s[:-1] <= tr_f[:-1] + 1e-5).all()) and float(tr_s[:-1].mean()) < 0.95 * float(tr_f[:-1].mean())
    # numpy model, observations in a CPU tensor: everything joins the tensor's device
    m_np, _ = tp.kalman_smoother(*model, torch.tensor(ys))
    assert m_np.device.type == "cpu" and float((m_np - sm).abs().max()) <= 1e-5 * max(1.0, float(sm.abs().max()))
    F, Q, H, R, m0, P0 = cpu
    with pytest.raises(ValueError):
        tp.kalman_filter(F, Q, H, R, m0, P0, torch.zeros(10))
    with pytest.raises(ValueError):
        tp.kalman_filter(F[:3], Q, H, R, m0, P0, torch.zeros(10, 2))
    with pytest.raises(ValueError):
        tp.kalman_filter(F, Q, H[:, :3], R, m0, P0, torch.zeros(10, 2))
    with pytest.raises(ValueError):
        tp.kalman_filter(F, Q, H, R, m0, P0, torch.zeros(10, 3))
