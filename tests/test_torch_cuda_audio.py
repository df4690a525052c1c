"""PyTorch port, on the card only: the audio path through the fused kernel.

    python -m pytest tests/test_torch_cuda_audio.py -m cuda --noconftest -p no:cacheprovider

The trainable PCEN front end on the kernel route against the stage pipeline
(logits, loss, every gradient leaf), the kernel against its plain version on
the planes the front end and Whisper's ``melspectrogram`` hand it, the new
ops from numpy input landing on the card, and ``dct``/``stft``/the front end
captured in CUDA graphs now that host tables stay on the card.  Every test
is marked ``cuda`` and skips where there is no CUDA device.  Imports neither
JAX nor the JAX package."""

import contextlib

import numpy as np
import pytest
import torch

import mixed_radix_fast_fourier_transform_tpu_torch as tp
from mixed_radix_fast_fourier_transform_tpu_torch.models import audio_frontend
from mixed_radix_fast_fourier_transform_tpu_torch.ops import cuda_fft
from mixed_radix_fast_fourier_transform_tpu_torch.utils.metrics import get_metrics
from mixed_radix_fast_fourier_transform_tpu_torch.utils.tree import tree_leaves, tree_map

KERNEL_TOL = 2e-5   # kernel vs its plain version
ROUTES_TOL = 2e-5   # kernel route vs stage pipeline
PIPELINE = tp.SpectralConfig(use_kernel=False)


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False


@contextlib.contextmanager
def _recorded():
    """Every call of the kernel's wrapper inside the block, with copies of
    the planes it was handed."""
    seen, launch = [], cuda_fft.exec_kernel

    def recording(xr, xi, n, sign):
        seen.append((xr.detach().clone(), xi.detach().clone(), n, sign))
        return launch(xr, xi, n, sign)

    cuda_fft.exec_kernel = recording
    try:
        yield seen
    finally:
        cuda_fft.exec_kernel = launch


def _front_end(batch=32, samples=16000, n_mels=40, n_classes=35):
    gen = torch.Generator().manual_seed(0)
    params = audio_frontend.init_params(n_mels, n_classes, generator=gen, device="cuda")
    x = (0.1 * torch.randn(batch, samples, generator=gen)).cuda()
    labels = torch.randint(0, n_classes, (batch,), generator=gen).cuda()
    return params, x, labels


@pytest.mark.cuda
def test_front_end_on_the_kernel_route_against_the_stage_pipeline():
    _need_card()
    params, x, labels = _front_end()
    cuda_fft.LAUNCHES = 0
    with _recorded() as seen, torch.no_grad():
        logits = audio_frontend.apply(params, x)
    assert cuda_fft.LAUNCHES == 1 and logits.device.type == "cuda"
    with torch.no_grad():
        assert _rel(logits, audio_frontend.apply(params, x, config=PIPELINE)) <= ROUTES_TOL
    grads = {}
    for name, config in (("kernel", tp.DEFAULT_CONFIG), ("pipeline", PIPELINE)):
        leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
        xg = x.clone().requires_grad_(True)
        cuda_fft.LAUNCHES = 0
        with _recorded() as seen_step:
            loss = audio_frontend.loss_fn(leaves, xg, labels, config=config)
            grads[name] = (loss.detach(),) + torch.autograd.grad(loss, tree_leaves(leaves) + [xg])
        if name == "kernel":
            assert cuda_fft.LAUNCHES == 2   # the transform and its backward
            seen += seen_step
    for g, gp in zip(grads["kernel"], grads["pipeline"]):
        assert _rel(g, gp) <= ROUTES_TOL
    # one train step launches once: the waveform needs no gradient
    cuda_fft.LAUNCHES = 0
    new, loss = audio_frontend.train_step(params, x, labels)
    assert cuda_fft.LAUNCHES == 1 and torch.isfinite(loss)
    # the kernel against its plain version on every recorded plane pair
    assert [(r[2], r[0].numel() // r[2], r[3]) for r in seen] == [
        (256, 32 * 126, -1), (256, 32 * 126, -1), (256, 32 * 126, 1)]
    for xr, xi, n, sign in seen:
        kr, ki = cuda_fft.exec_kernel(xr, xi, n, sign)
        rr, ri = cuda_fft.exec_kernel_reference(xr, xi, n, sign)
        assert _rel(torch.complex(kr, ki), torch.complex(rr, ri)) <= KERNEL_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("n,rows", [(256, 32256), (200, 48016)])
def test_kernel_at_the_front_ends_shapes(n, rows):
    """Many short rows: 126 frames x 256 clips of n_fft 512, and 3001 frames
    x 16 clips of Whisper's n_fft 400 (whose packed real transform is 200)."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(n)
    xr, xi = (torch.randn(rows, n, device="cuda", generator=gen) for _ in range(2))
    for sign in (-1, 1):
        kr, ki = cuda_fft.exec_kernel(xr, xi, n, sign)
        rr, ri = cuda_fft.exec_kernel_reference(xr, xi, n, sign)
        assert _rel(torch.complex(kr, ki), torch.complex(rr, ri)) <= KERNEL_TOL


@pytest.mark.cuda
def test_whisper_melspectrogram_hands_the_kernel_rows_of_200():
    _need_card()
    x = np.random.default_rng(0).standard_normal((2, 48000)).astype(np.float32)
    cuda_fft.LAUNCHES = 0
    with _recorded() as seen:
        mel = tp.melspectrogram(x, 16000.0, 400, 160, n_mels=80)
    assert mel.device.type == "cuda" and tuple(mel.shape) == (2, 301, 80)
    assert [(r[2], r[0].numel() // r[2]) for r in seen] == [(200, 602)]
    assert _rel(mel, tp.melspectrogram(x, 16000.0, 400, 160, n_mels=80, config=PIPELINE)) <= ROUTES_TOL


@pytest.mark.cuda
def test_new_ops_from_numpy_land_on_the_card():
    _need_card()
    x = np.random.default_rng(1).standard_normal((2, 4096)).astype(np.float32)
    st = tp.ShortTimeFFT(np.hanning(65)[:64], 16, 8000.0)
    outs = [tp.welch(x, nperseg=256)[1], tp.hilbert(x), tp.resample(x, 1000), tp.resample_poly(x, 2, 3),
            tp.pcen(np.abs(x).reshape(2, 64, 64)), tp.cwt(x, tp.ricker, [2.0, 4.0]),
            tp.bispectrum(x, 64), tp.gammatonegram(x, 8000.0, 8), tp.yin(x, 100.0, 400.0, 8000.0, 512),
            st.stft(x), st.istft(st.stft(x)), tp.envelope(x), tp.savgol_filter(x, 7, 2),
            tp.freqz(np.ones(8), 1.0, 64)[1], tp.goertzel(x, [0.1, 0.2]), tp.mfcc(x, 8000.0, 13, 256, n_mels=32)]
    assert all(o.device.type == "cuda" and torch.isfinite(torch.view_as_real(o) if o.is_complex() else o).all()
               for o in outs)


@pytest.mark.cuda
def test_dct_stft_and_the_front_end_are_captured_in_cuda_graphs():
    """Host tables stay on the card after the first call, so a second call
    uploads nothing and a CUDA graph captures the whole call."""
    _need_card()
    params, x, _ = _front_end(batch=8, samples=4000)
    xd = torch.randn(256, 1024, device="cuda")
    calls = {
        "dct": lambda: tp.dct(xd),
        "stft": lambda: tp.stft(x, 512, 384),
        "melspectrogram": lambda: tp.melspectrogram(x, 16000.0, 400, 160, n_mels=80),
        "front end": lambda: audio_frontend.apply(params, x),
        "resample_poly": lambda: tp.resample_poly(x, 1, 3),
    }
    for name, fn in calls.items():
        with torch.no_grad():
            want = fn()
            before = get_metrics().get("constant_uploads", 0)
            stream = torch.cuda.Stream()
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream):
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph, stream=stream):
                    got = fn()
            torch.cuda.synchronize()
            graph.replay()
            torch.cuda.synchronize()
        assert get_metrics().get("constant_uploads", 0) == before, name
        assert torch.equal(got, want), name
