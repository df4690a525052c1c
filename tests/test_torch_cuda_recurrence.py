"""PyTorch port, on the card only: the recurrences on the shared scan and the
audio remainder.

    python -m pytest tests/test_torch_cuda_recurrence.py -m cuda --noconftest -p no:cacheprovider

``pcen``'s smoother at Whisper's 3001 frames in a few dozen device kernels
(not one a frame), forward and per-band gradients against a float64 loop on
the CPU; the IIR filters and ``decimate(ftype="iir")`` against scipy
float64; the Kalman filter's parallel form against its sequential form; the
scan's forward and backward and the front end's train step captured in CUDA
graphs (nothing in them waits for the host); ``cqt`` and ``scattering1d``
from numpy input landing on the card.  Every test is marked ``cuda`` and
skips where there is no CUDA device.  Imports neither JAX nor the JAX
package."""

import numpy as np
import pytest
import scipy.signal as ss
import torch

import mixed_radix_fast_fourier_transform_tpu_torch as tp
from mixed_radix_fast_fourier_transform_tpu_torch.models import audio_frontend

GRAD_TOL = 2e-4      # the front end's gradients against float64


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False


def _rel(got, want):
    got, want = (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v) for v in (got, want))
    return float(np.max(np.abs(got.astype(np.complex128) - want)) / np.max(np.abs(want)))


def _device_kernels(fn) -> int:
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)


@pytest.mark.cuda
def test_pcen_at_3001_frames_is_a_few_kernels_and_matches_float64():
    _need_card()
    rng = np.random.default_rng(0)
    S = np.abs(rng.standard_normal((4, 3001, 80))).astype(np.float32) + 0.01
    coef = {"gain": 0.98, "bias": 2.0, "power": 0.5, "b": 0.025}
    leaves = {k: torch.full((80,), v, device="cuda", requires_grad=True) for k, v in coef.items()}
    Sd = torch.tensor(S, device="cuda")
    out = tp.pcen(Sd, **leaves)
    w = torch.tensor(rng.standard_normal(S.shape), dtype=torch.float32, device="cuda")
    grads = torch.autograd.grad((out * w).sum(), list(leaves.values()))
    l64 = {k: torch.full((80,), v, dtype=torch.float64, requires_grad=True) for k, v in coef.items()}
    S64 = torch.tensor(S, dtype=torch.float64)
    m, smoothed = S64[:, 0], []
    for t in range(S.shape[1]):
        m = (1.0 - l64["b"]) * m + l64["b"] * S64[:, t]
        smoothed.append(m)
    M = torch.stack(smoothed, dim=1)
    want = (S64 / (1e-6 + M) ** l64["gain"] + l64["bias"]) ** l64["power"] - l64["bias"] ** l64["power"]
    want_grads = torch.autograd.grad((want * w.cpu().double()).sum(), list(l64.values()))
    assert _rel(out, want) <= 5e-5
    assert all(_rel(g, wg) <= GRAD_TOL for g, wg in zip(grads, want_grads))
    with torch.no_grad():
        assert _device_kernels(lambda: tp.pcen(Sd, 16000.0, 160)) <= 150


@pytest.mark.cuda
def test_iir_filters_and_decimate_against_scipy():
    _need_card()
    x = np.random.default_rng(1).standard_normal((4, 65536))
    sos, (b, a) = tp.butter(6, 0.2, output="sos"), tp.butter(4, 0.2)
    for got, want, tol in ((tp.sosfilt(sos, x), ss.sosfilt(sos, x, axis=-1), 1e-5),
                           (tp.sosfiltfilt(sos, x), ss.sosfiltfilt(sos, x, axis=-1), 1e-4),
                           (tp.lfilter(b, a, x), ss.lfilter(b, a, x, axis=-1), 2e-4),
                           (tp.filtfilt(b, a, x), ss.filtfilt(b, a, x, axis=-1), 5e-4),
                           (tp.decimate(x, 3, ftype="iir"), ss.decimate(x, 3, ftype="iir", axis=-1), 1e-3)):
        assert got.device.type == "cuda" and _rel(got, want) <= tol


@pytest.mark.cuda
def test_kalman_parallel_matches_sequential_on_the_card():
    _need_card()
    dt = 0.1
    F = np.eye(4)
    F[0, 2] = F[1, 3] = dt
    Q = np.kron(np.array([[dt ** 3 / 3, dt ** 2 / 2], [dt ** 2 / 2, dt]]), np.eye(2))
    H, R = np.eye(2, 4), 0.25 * np.eye(2)
    ys = np.cumsum(np.random.default_rng(2).standard_normal((2000, 2)), axis=0)
    mp, Pp = tp.kalman_filter(F, Q, H, R, np.zeros(4), np.eye(4), ys, parallel=True)
    ms, Ps = tp.kalman_filter(F, Q, H, R, np.zeros(4), np.eye(4), ys)
    assert mp.device.type == "cuda"
    assert float((mp - ms).abs().max()) <= 3e-4 * max(1.0, float(ms.abs().max()))
    assert float((Pp - Ps).abs().max()) <= 3e-4


@pytest.mark.cuda
def test_scan_forward_backward_and_front_end_step_are_captured_in_cuda_graphs():
    _need_card()
    S = torch.rand(4, 3001, 80, device="cuda") + 0.01
    b = torch.full((80,), 0.025, device="cuda", requires_grad=True)
    gen = torch.Generator().manual_seed(0)
    params = audio_frontend.init_params(40, 35, generator=gen, device="cuda")
    x = (0.1 * torch.randn(8, 4000, generator=gen)).cuda()
    labels = torch.randint(0, 35, (8,), generator=gen).cuda()
    calls = {"pcen forward + backward": lambda: torch.autograd.grad(tp.pcen(S, b=b).sum(), [b])[0],
             "front end train step": lambda: audio_frontend.train_step(params, x, labels)[1]}
    for name, fn in calls.items():
        want = fn()
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            fn()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=stream):
                got = fn()
        torch.cuda.synchronize()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.allclose(got, want, rtol=1e-6, atol=0), name


@pytest.mark.cuda
def test_audio_remainder_from_numpy_lands_on_the_card():
    _need_card()
    x = np.random.default_rng(3).standard_normal((2, 22050)).astype(np.float32)
    outs = [tp.cqt(x), tp.chroma_cqt(x), tp.scattering1d(x[:, :16384])[1], tp.stockwell(x[:, :1024])[0],
            tp.wigner_ville(x[:, :512]), tp.ssq_stft(x)[0], tp.onset_strength(x), tp.spectral_centroid(x)]
    assert all(o.device.type == "cuda" and bool(torch.isfinite(torch.view_as_real(o) if o.is_complex() else o).all())
               for o in outs)
    cpu = tp.cqt(torch.from_numpy(x))
    assert _rel(outs[0], cpu) <= 2e-5
