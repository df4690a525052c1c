"""PyTorch port: the fused kernel's autograd Function on the CPU.

On a CPU tensor the Function's forward is the kernel's plain version, and
its backward is the Function itself at the opposite sign, exactly as on the
card, so the gradient formula is checked here.
"""

import numpy as np
import pytest
import torch

from mixed_radix_fast_fourier_transform_tpu_torch.ops import cuda_fft

torch.set_num_threads(1)

TOL = 1e-5  # max |got − want| / max |want|
LENGTHS = [8, 90, 360, 1024, 5040]


def _planes(shape, seed, requires_grad=False):
    rng = np.random.default_rng(seed)
    return tuple(
        torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        .requires_grad_(requires_grad) for _ in range(2))


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("sign", [-1, 1])
@pytest.mark.parametrize("n", LENGTHS)
def test_adjoint_identity(n, sign):
    """⟨F x, g⟩ = ⟨x, Fᴴ g⟩ with Fᴴ g taken from autograd."""
    xr, xi = _planes((3, n), n, requires_grad=True)
    gr, gi = _planes((3, n), n + 1)
    yr, yi = cuda_fft.exec_kernel(xr, xi, n, sign)
    ar, ai = torch.autograd.grad([yr, yi], [xr, xi], [gr, gi])
    lhs = (yr.double() * gr + yi.double() * gi).sum()
    rhs = (xr.double() * ar + xi.double() * ai).sum()
    scale = yr.double().norm() * gr.double().norm()
    assert abs(float((lhs - rhs).detach())) <= TOL * float(scale.detach())
    # and Fᴴ g is the transform of g at the opposite sign
    wr, wi = cuda_fft.exec_kernel_reference(gr, gi, n, -sign)
    assert torch.equal(ar, wr) and torch.equal(ai, wi)


@pytest.mark.parametrize("sign", [-1, 1])
@pytest.mark.parametrize("n", LENGTHS)
def test_equals_autograd_through_the_plain_version(n, sign):
    xr, xi = _planes((2, 3, n), n + 2, requires_grad=True)
    gr, gi = _planes((2, 3, n), n + 3)
    got = torch.autograd.grad(cuda_fft.exec_kernel(xr, xi, n, sign), [xr, xi], [gr, gi])
    want = torch.autograd.grad(
        cuda_fft.exec_kernel_reference(xr, xi, n, sign), [xr, xi], [gr, gi])
    for g, w in zip(got, want):
        assert g.shape == w.shape and _rel(g, w) <= TOL


@pytest.mark.parametrize("case", ["none_im", "none_re", "expanded", "strided", "one_input"])
def test_cotangent_forms(case):
    """Cotangents that are missing, expanded from a scalar, or strided views
    all reach the transform as dense planes."""
    n = 360
    xr, xi = _planes((4, n), 5, requires_grad=True)
    if case == "one_input":
        xi = xi.detach()
    yr, yi = cuda_fft.exec_kernel(xr, xi, n, -1)
    zr, zi = cuda_fft.exec_kernel_reference(xr, xi, n, -1)
    loss = {
        "none_im": lambda r, i: (r * r).sum(),
        "none_re": lambda r, i: (i * i).sum(),
        "expanded": lambda r, i: r.sum() + i.mean(),
        "strided": lambda r, i: (torch.flip(r, (-1,))[..., ::3] ** 2).sum()
        + (i.t()[5:40] ** 3).sum(),
        "one_input": lambda r, i: (r * i).sum(),
    }[case]
    inputs = [t for t in (xr, xi) if t.requires_grad]
    got = torch.autograd.grad(loss(yr, yi), inputs)
    want = torch.autograd.grad(loss(zr, zi), inputs)
    # both planes on one scale: rounding of the large plane leaks into the
    # small one at fp32 epsilon times the large plane's size
    assert _rel(torch.stack(got), torch.stack(want)) <= TOL


def test_unused_outputs_and_no_grad_inputs():
    n = 64
    xr, xi = _planes((2, n), 9, requires_grad=True)
    yr, _ = cuda_fft.exec_kernel(xr, xi, n, 1)
    (g,) = torch.autograd.grad(yr.sum(), [xr], allow_unused=True)
    assert g.shape == xr.shape
    ar, ai = _planes((2, n), 10)
    out = cuda_fft.exec_kernel(ar, ai, n, 1)
    assert not out[0].requires_grad and not out[1].requires_grad
    with pytest.raises(ValueError):
        cuda_fft.exec_kernel(ar, ai, n, 0)


def test_double_backward():
    """The backward is the Function again, so a second derivative exists:
    for L = Σ|F x|², dL/dx = 2n·x, and d/dx ⟨dL/dx, v⟩ = 2n·v."""
    n = 90
    xr, xi = _planes((2, n), 11, requires_grad=True)
    vr, vi = _planes((2, n), 12)
    yr, yi = cuda_fft.exec_kernel(xr, xi, n, -1)
    gr, gi = torch.autograd.grad((yr * yr + yi * yi).sum(), [xr, xi], create_graph=True)
    assert _rel(gr.detach(), 2 * n * xr.detach()) <= TOL
    hr, hi = torch.autograd.grad((gr * vr + gi * vi).sum(), [xr, xi])
    assert _rel(hr, 2 * n * vr) <= TOL and _rel(hi, 2 * n * vi) <= TOL


def test_gradcheck_small():
    def f(a, b):
        yr, yi = cuda_fft.exec_kernel(a.float(), b.float(), 12, 1)
        return yr.double(), yi.double()

    a = torch.randn(2, 12, dtype=torch.double, requires_grad=True,
                    generator=torch.Generator().manual_seed(0))
    b = torch.randn(2, 12, dtype=torch.double, requires_grad=True,
                    generator=torch.Generator().manual_seed(1))
    assert torch.autograd.gradcheck(f, (a, b), eps=1e-2, atol=1e-2, rtol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [360, 2048])
def test_cuda_backward_is_the_kernel_at_the_opposite_sign(n):
    """On the card: python -m pytest tests/test_torch_autograd.py -m cuda
    --noconftest -p no:cacheprovider"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    xr, xi = (t.cuda().requires_grad_(True) for t in _planes((5, n), n))
    gr, gi = (t.cuda() for t in _planes((5, n), n + 1))
    cuda_fft.LAUNCHES = 0
    yr, yi = cuda_fft.exec_kernel(xr, xi, n, -1)
    # an expanded and a strided cotangent, as mean() and flip() hand them over
    loss = yr.mean() + (torch.flip(yi, (-1,)) * gi).sum()
    ar, ai = torch.autograd.grad(loss, [xr, xi])
    assert cuda_fft.LAUNCHES == 2
    cr = torch.full_like(gr, 1.0 / gr.numel())
    wr, wi = cuda_fft.exec_kernel_reference(cr, torch.flip(gi, (-1,)), n, 1)
    assert _rel(torch.stack([ar, ai]), torch.stack([wr, wi])) <= 2e-5
    with torch.no_grad():
        cuda_fft.exec_kernel(xr, xi, n, -1)
    assert cuda_fft.LAUNCHES == 3
