"""PyTorch port: the fused Stockham kernel's wrapper, plain version and dispatch.

On the CPU the wrapper runs the kernel's plain PyTorch version, which is
held against the JAX package's Pallas kernel in interpret mode.  The test
marked ``cuda`` compares the CUDA kernel with its plain version and skips
where there is no CUDA device; on a GPU machine without JAX run

    python -m pytest tests/test_torch_kernel.py -m cuda --noconftest -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

import mixed_radix_fast_fourier_transform_tpu_torch as tp
from mixed_radix_fast_fourier_transform_tpu_torch import plan as tplan
from mixed_radix_fast_fourier_transform_tpu_torch.ops import cuda_fft

torch.set_num_threads(1)

KERNEL_TOL = 2e-5  # max |got − want| / max |want|, the JAX kernel tests' tolerance


@pytest.fixture
def jax_pallas():
    return pytest.importorskip("mixed_radix_fast_fourier_transform_tpu.ops.pallas_fft")


@pytest.fixture
def launches():
    """Reset the launch counter; restore it afterwards."""
    saved = cuda_fft.LAUNCHES
    cuda_fft.LAUNCHES = 0
    yield
    cuda_fft.LAUNCHES = saved


def _rel(got, want):
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


def _inputs(n, batch, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, n)) + 1j * rng.standard_normal((batch, n))
    return x, x.real.astype(np.float32), x.imag.astype(np.float32)


@pytest.mark.parametrize("n", [8, 64, 360, 1024])
@pytest.mark.parametrize("sign", [-1, 1])
def test_reference_matches_pallas_interpret(n, sign, jax_pallas):
    _, xr, xi = _inputs(n, 5, n + sign)
    wr, wi = jax_pallas.exec_pallas(xr, xi, n, sign, interpret=True)
    want = np.asarray(wr) + 1j * np.asarray(wi)
    gr, gi = cuda_fft.exec_kernel_reference(torch.from_numpy(xr), torch.from_numpy(xi), n, sign)
    got = gr.numpy() + 1j * gi.numpy()
    assert got.shape == (5, n)
    assert _rel(got, want) <= KERNEL_TOL


@pytest.mark.parametrize("n", [2, 3, 5, 7, 12, 2048, 5040])
def test_reference_matches_numpy(n):
    x, xr, xi = _inputs(n, 3, n)
    for sign in (-1, 1):
        gr, gi = cuda_fft.exec_kernel_reference(torch.from_numpy(xr), torch.from_numpy(xi), n, sign)
        want = np.fft.fft(x) if sign < 0 else np.fft.ifft(x) * n
        assert _rel(gr.numpy() + 1j * gi.numpy(), want) <= KERNEL_TOL


@pytest.mark.parametrize("n,ok", [(44, False), (8192, True), (12288, True),
                                  (14400, True), (14528, False), (16384, True),
                                  (16800, False), (24576, False), (65536, False)])
def test_supports(n, ok):
    # 14528 = 2^6·227 has a prime above 7; the supported lengths are the
    # 7-smooth ones up to 16,384 (1024 threads of 16 complex registers)
    assert cuda_fft.supports(n, 1) is ok
    assert cuda_fft.supports(n, 10 ** 6) is ok


def _smooth(n):
    for p in (2, 3, 5, 7):
        while n % p == 0:
            n //= p
    return n == 1


SMOOTH = [n for n in range(2, cuda_fft.MAX_N + 1) if _smooth(n)]


def _distinct_per_instruction(banks, valid):
    """banks, valid: (..., 32) per warp instruction; distinct over valid lanes."""
    lanes = np.broadcast_to(np.arange(32), banks.shape)
    banks = np.where(valid, banks, -1 - lanes)  # idle lanes never collide
    banks = np.sort(banks, axis=-1)
    return not np.any(banks[..., 1:] == banks[..., :-1])


@pytest.mark.parametrize("n", SMOOTH)
def test_geometry_covers_every_butterfly_without_bank_conflicts(n):
    # the launch geometry the kernel is given, through the Python mirror of
    # its lane map and shared-memory index: every stage's butterflies run
    # once, the layout is a bijection, and the 32 lanes of each warp's reads
    # and writes hit 32 distinct banks
    g = cuda_fft.kernel_geometry(n)
    assert g is not None
    assert g.smem_bytes <= cuda_fft.SMEM_BYTES == 232_448
    assert g.threads % 32 == 0 and g.threads * g.rows <= g.bound <= 1024
    assert g.bound in cuda_fft.BOUNDS[g.elems]
    assert g.elems * g.threads >= n and g.npad >= n
    assert tuple(st.f for st in g.stages) == cuda_fft.kernel_factors(n)
    words = np.arange(g.npad)
    prev = (0, 0)
    for st in g.stages:
        assert st.slots * st.f <= g.elems
        warp, slot, lane = np.meshgrid(np.arange(g.warps), np.arange(st.slots),
                                       np.arange(32), indexing="ij")
        q, j, valid = cuda_fft.tile_butterflies(st.l, st.mp, st.tile,
                                                slot * g.warps + warp, lane)
        t = (q * st.l + j)[valid]
        np.testing.assert_array_equal(np.sort(t), np.arange(st.mp * st.l))
        assert np.array_equal(np.sort(cuda_fft.smem_index(words, st.swizzle)), words)
        reads, writes = cuda_fft.stage_addresses(st.f, st.l, st.mp, q.ravel(), j.ravel())
        for addrs, swz in ((reads, prev), (writes, st.swizzle)):
            banks = (cuda_fft.smem_index(addrs, swz) % 32).reshape(st.f, *q.shape)
            assert _distinct_per_instruction(banks, valid[None])
        prev = st.swizzle
    assert prev == (0, 0)  # the row leaves unswizzled for the linear store


def _run_schedule(n, sign, x):
    """The kernel's schedule in numpy: each stage reads its butterflies'
    inputs through the lane map and the swizzled index, combines them and
    writes them back in place, as the CUDA kernel does."""
    st = tplan.get_plan(n, sign, "kernel")
    g = st.geometry
    tw = st.tw.astype(np.float64)
    mem = np.zeros(g.npad, complex)
    mem[:n] = x
    prev = (0, 0)
    for sg, off in zip(g.stages, st.offsets):
        f, l, mp = sg.f, sg.l, sg.mp
        warp, slot, lane = np.meshgrid(np.arange(g.warps), np.arange(sg.slots),
                                       np.arange(32), indexing="ij")
        q, j, valid = cuda_fft.tile_butterflies(l, mp, sg.tile, slot * g.warps + warp, lane)
        q, j = q[valid], j[valid]
        reads, writes = cuda_fft.stage_addresses(f, l, mp, q, j)
        z = mem[cuda_fft.smem_index(reads, prev)]
        if off >= 0:
            z = z * (tw[off:off + f * l].reshape(f, l)
                     + 1j * tw[off + f * l:off + 2 * f * l].reshape(f, l))[:, j]
        k = np.arange(f)
        mem[cuda_fft.smem_index(writes, sg.swizzle)] = np.exp(
            sign * 2j * np.pi * np.outer(k, k) / f) @ z
        prev = sg.swizzle
    return mem[:n]


@pytest.mark.parametrize("n", [2, 8, 90, 360, 1024, 1575, 2048, 5040, 12005, 16384])
def test_kernel_schedule_computes_the_fft(n):
    x, _, _ = _inputs(n, 1, n)
    for sign in (-1, 1):
        want = np.fft.fft(x[0]) if sign < 0 else np.fft.ifft(x[0]) * n
        assert _rel(_run_schedule(n, sign, x[0]), want) <= KERNEL_TOL


def test_factors_and_twiddle_layout(jax_pallas):
    for n in (2, 64, 1024, 2048, 5040, 12288):
        assert cuda_fft.kernel_factors(n) == jax_pallas.pallas_factors(n)
    assert cuda_fft.kernel_factors(2048) == (8, 8, 8, 4)
    st = tplan.get_plan(64, -1, "kernel")
    assert st is tplan.get_plan(64, -1, "kernel")
    assert st.factors == (8, 8)
    assert st.offsets == (-1, 0)  # only the second stage has l > 1
    (tr, ti), = cuda_fft.stage_twiddles((8, 8), -1)
    tw = tplan.device_constants(st, "cpu")["tw"]
    assert tw.dtype == torch.float32
    np.testing.assert_array_equal(tw[:64].numpy(), tr.ravel())
    np.testing.assert_array_equal(tw[64:].numpy(), ti.ravel())
    with pytest.raises(ValueError):
        tplan.get_plan(44, -1, "kernel")


def test_clear_plan_cache_drops_the_kernel_plan():
    # the kernel's schedule and twiddles live in the one plan cache, so
    # clearing it drops their device copies as well
    st = tplan.get_plan(2048, 1, "kernel")
    tw = tplan.device_constants(st, "cpu")["tw"]
    tplan.clear_plan_cache()
    fresh = tplan.get_plan(2048, 1, "kernel")
    assert fresh is not st
    assert fresh.factors == st.factors == (8, 8, 8, 4)
    assert tplan.device_constants(fresh, "cpu")["tw"] is not tw
    assert torch.equal(tplan.device_constants(fresh, "cpu")["tw"], tw)


def test_bluestein_10007_takes_the_stage_pipeline():
    plan = tplan.get_plan(10007, -1)
    assert type(plan).__name__ == "BluesteinPlan" and plan.m == 24576
    assert not cuda_fft.supports(plan.m)


def test_cpu_tensors_never_launch(launches):
    _, xr, xi = _inputs(360, 2, 1)
    tr, ti = torch.from_numpy(xr), torch.from_numpy(xi)
    kr, ki = cuda_fft.exec_kernel(tr, ti, 360, -1)
    rr, ri = cuda_fft.exec_kernel_reference(tr, ti, 360, -1)
    assert torch.equal(kr, rr) and torch.equal(ki, ri)
    tp.fft(torch.complex(tr, ti))
    tp.irfft(tp.rfft(torch.randn(3, 4096)))
    assert cuda_fft.LAUNCHES == 0


def test_dispatch(launches):
    _, xr, xi = _inputs(360, 2, 2)
    tr, ti = torch.from_numpy(xr), torch.from_numpy(xi)
    on = tp.SpectralConfig()
    off = tp.SpectralConfig(use_kernel=False)
    assert cuda_fft.maybe_exec_kernel(off, 360, -1, tr, ti) is None
    assert cuda_fft.maybe_exec_kernel(on, 44, -1, tr[:, :44], ti[:, :44]) is None
    assert cuda_fft.maybe_exec_kernel(on, 1, -1, tr[:, :1], ti[:, :1]) is None
    kr, _ = cuda_fft.maybe_exec_kernel(on, 360, -1, tr, ti)
    rr, _ = cuda_fft.exec_kernel_reference(tr, ti, 360, -1)
    assert torch.equal(kr, rr)


def test_wrapper_refuses_other_devices():
    x = torch.empty(2, 64, device="meta")
    with pytest.raises(ValueError):
        cuda_fft.exec_kernel(x, x, 64, -1)


@pytest.mark.cuda
@pytest.mark.parametrize("n,batch", [(8, 3), (90, 3), (360, 3), (2048, 8), (2048, 1024),
                                     (5040, 3), (12005, 3), (12288, 3), (16384, 3)])
def test_cuda_kernel_matches_plain_version(n, batch, launches):
    # (2048, 8) and (2048, 1024) are the spectral filter's inner transforms;
    # n = 90 (n % 4 != 0): rows that are not 16-byte aligned
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, xr, xi = _inputs(n, batch, n)
    tr = torch.from_numpy(xr).cuda()
    ti = torch.from_numpy(xi).cuda()
    for sign in (-1, 1):
        kr, ki = cuda_fft.exec_kernel(tr, ti, n, sign)
        torch.cuda.synchronize()
        rr, ri = cuda_fft.exec_kernel_reference(tr, ti, n, sign)
        got = torch.complex(kr, ki).cpu().numpy()
        want = torch.complex(rr, ri).cpu().numpy()
        assert _rel(got, want) <= KERNEL_TOL
    assert cuda_fft.LAUNCHES == 2
    with pytest.raises(ValueError):
        cuda_fft.exec_kernel(tr[:, ::2], ti[:, ::2], n // 2, -1)
