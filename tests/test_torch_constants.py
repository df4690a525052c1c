"""PyTorch port: the device-table cache of ``utils.numerics.constant``.

A table that a host function builds from hashable arguments is uploaded once
per (key, device, dtype), counted by ``constant_uploads`` /
``constant_hits`` of ``utils.metrics``, emptied by ``clear_plan_cache``, and
made outside ``torch.inference_mode()`` so that a later training call can
use it.  A table from a caller's array is uploaded on every call."""

import numpy as np
import pytest
import scipy.signal as ss
import torch

import mixed_radix_fast_fourier_transform_tpu_torch as tp
from mixed_radix_fast_fourier_transform_tpu_torch.utils import numerics
from mixed_radix_fast_fourier_transform_tpu_torch.utils.metrics import get_metrics, reset_metrics

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def fresh():
    tp.clear_plan_cache()
    reset_metrics()
    yield
    tp.clear_plan_cache()


def _counts():
    m = get_metrics()
    return m.get("constant_uploads", 0), m.get("constant_hits", 0)


def test_keyed_table_is_uploaded_once_per_key_device_and_dtype():
    like = torch.zeros(1)
    calls = []

    def build():
        calls.append(1)
        return np.arange(4.0)

    a = numerics.constant(build, like, key=("t", 4))
    b = numerics.constant(build, like, key=("t", 4))
    assert a is b and len(calls) == 1 and _counts() == (1, 1)
    assert a.dtype == torch.float32 and a.device == like.device
    c = numerics.constant(build, like, torch.float64, key=("t", 4))
    assert c is not a and c.dtype == torch.float64 and _counts() == (2, 1)
    numerics.constant(build, like, key=("t", 5))
    assert _counts() == (3, 1)
    meta = numerics.constant(build, torch.zeros(1, device="meta"), key=("t", 4))
    assert meta.device.type == "meta" and _counts() == (4, 1)


def test_unkeyed_table_is_uploaded_on_every_call():
    like = torch.zeros(1)
    a = numerics.constant(np.ones(3), like)
    b = numerics.constant(np.ones(3), like)
    assert a is not b and _counts() == (0, 0)
    assert len(numerics._TABLES) == 0


def test_clear_plan_cache_empties_the_tables():
    x = torch.randn(2, 256)
    tp.dct(x)
    assert len(numerics._TABLES) > 0
    tp.clear_plan_cache()
    assert len(numerics._TABLES) == 0
    reset_metrics()
    tp.dct(x)
    assert _counts()[0] > 0


CALLS = {
    "stft": lambda x: tp.stft(x, 128),
    "istft": lambda x: tp.istft(tp.stft(x, 128), 128),
    "dct2": lambda x: tp.dct(x, norm="ortho"),
    "dct4": lambda x: tp.dct(x, type=4),
    "dst1": lambda x: tp.dst(x, type=1),
    "mdct": lambda x: tp.mdct(x, 64),
    "cheb": lambda x: tp.cheb_diff(x),
    "fht": lambda x: tp.fht(x, 0.1, 0.5, bias=0.2),
    "fwht": lambda x: tp.fwht(x[..., :64]),
    "czt": lambda x: tp.czt(x, 100),
    "frft": lambda x: tp.frft(x, 0.6),
    "phase_vocoder": lambda x: tp.phase_vocoder(tp.stft(x, 128), 1.3),
    "shorttime": lambda x: tp.ShortTimeFFT(ss.windows.hann(64, sym=False), 16, 1.0).stft(x),
    "shorttime_istft": lambda x: (lambda s: s.istft(s.stft(x)))(
        tp.ShortTimeFFT(ss.windows.hann(64, sym=False), 16, 1.0)),
    "melspectrogram": lambda x: tp.melspectrogram(x, 8000.0, 128, n_mels=20),
    "mfcc": lambda x: tp.mfcc(x, 8000.0, 13, 128, n_mels=20, lifter=22.0),
    "welch": lambda x: tp.welch(x, nperseg=64),
    "csd": lambda x: tp.csd(x, x, nperseg=64),
    "hilbert": lambda x: tp.hilbert(x),
    "periodogram": lambda x: tp.periodogram(x, window="hann", detrend="linear"),
    "multitaper": lambda x: tp.multitaper(x, nw=2.5),
    "resample": lambda x: tp.resample(x, 300, window="hann"),
    "envelope": lambda x: tp.envelope(x, (2, 40)),
    "savgol": lambda x: tp.savgol_filter(x, 7, 2),
    "spectral_diff": lambda x: tp.spectral_diff(x),
    "minimum_phase": lambda x: tp.minimum_phase(x[0, :31], n_fft=256),
    "cceps": lambda x: tp.cceps(x),
    "poisson": lambda x: tp.poisson_solve(x),
    "bispectrum": lambda x: tp.bispectrum(x, 64),
    "cwt_tc": lambda x: tp.cwt_tc(x, tp.tc_scales(512, dj=0.5)),
    "wct": lambda x: tp.wct(x, x, dj=0.5),
    "gammatonegram": lambda x: tp.gammatonegram(x, 8000.0, 8),
    "yin": lambda x: tp.yin(x, 100.0, 400.0, 8000.0, 256),
    "pyin": lambda x: tp.pyin(x, 100.0, 400.0, 8000.0, 256, resolution=1.0),
}


@pytest.mark.parametrize("name", CALLS)
def test_second_call_uploads_nothing(name):
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 512)).astype(np.float32))
    CALLS[name](x)
    first = _counts()
    assert first[0] > 0, "the first call uploads its tables"
    CALLS[name](x)
    second = _counts()
    assert second[0] == first[0], f"{name}: {second[0] - first[0]} uploads on the second call"
    assert second[1] > first[1]


def test_caller_arrays_are_uploaded_per_call():
    x = torch.randn(2, 512)
    w = np.hanning(128).astype(np.float32)
    tp.stft(x, 128, window=w)
    before = len(numerics._TABLES)
    tp.stft(x, 128, window=w)
    assert len(numerics._TABLES) == before
    assert not any("stft.window" in str(k) for k in numerics._TABLES)


@pytest.mark.parametrize("name", ["stft", "dct2", "melspectrogram", "welch", "shorttime"])
def test_table_made_under_inference_mode_serves_a_training_call(name):
    x = torch.randn(2, 512)
    with torch.inference_mode():
        CALLS[name](x)
    assert all(not t.is_inference() for t in numerics._TABLES.values())
    xg = x.clone().requires_grad_()
    out = CALLS[name](xg)
    out = out[1] if isinstance(out, tuple) else out
    (out.abs() ** 2).sum().backward()
    assert xg.grad is not None and torch.isfinite(xg.grad).all()


def test_pad_last_matches_numpy():
    x = torch.arange(5.0) + 1
    modes = {"reflect": dict(mode="reflect"), "odd": dict(mode="reflect", reflect_type="odd"),
             "edge": dict(mode="edge"), "wrap": dict(mode="wrap"),
             "constant": dict(mode="constant", constant_values=2.0)}
    for mode, kw in modes.items():
        for left, right in ((0, 0), (2, 3), (4, 4), (0, 3)):
            got = numerics.pad_last(x, left, right, mode, 2.0).numpy()
            assert np.array_equal(got, np.pad(x.numpy(), (left, right), **kw)), (mode, left, right)
    assert np.array_equal(numerics.pad_last(x, 7, 9, "wrap").numpy(), np.pad(x.numpy(), (7, 9), mode="wrap"))
    z = torch.complex(x, -x)
    assert np.array_equal(numerics.pad_last(z[None], 2, 2, "odd").numpy(),
                          np.pad(z.numpy()[None], ((0, 0), (2, 2)), mode="reflect", reflect_type="odd"))
    with pytest.raises(ValueError):
        numerics.pad_last(x, 1, 1, "bogus")


def test_median_averages_the_middle_pair_and_fp32_matmul_restores_the_flag():
    x = torch.tensor([[1.0, 4.0, 2.0, 3.0], [5.0, 1.0, 1.0, 9.0]])
    assert torch.equal(numerics.median(x), torch.tensor([2.5, 3.0]))
    assert numerics.median(x, dim=0, keepdim=True).shape == (1, 4)
    odd = torch.tensor([3.0, 1.0, 2.0])
    assert float(numerics.median(odd)) == 2.0
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with numerics.fp32_matmul():
            assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
