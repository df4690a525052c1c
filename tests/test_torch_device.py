"""PyTorch port: where data that is no tensor yet goes.

A tensor stays on its own device.  A numpy array, a list or a scalar goes
to the card, as the JAX package puts such input on its default device; so
do the arrays the library creates, unless given a device.  There is no
fallback to the CPU: without a card the call raises.
"""

import ast
import json
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import mixed_radix_fast_fourier_transform_tpu_torch as tp
from mixed_radix_fast_fourier_transform_tpu_torch import compat
from mixed_radix_fast_fourier_transform_tpu_torch.models import spectral_filter
from mixed_radix_fast_fourier_transform_tpu_torch.utils import numerics

torch.set_num_threads(1)

PACKAGE = pathlib.Path(tp.__file__).parent
NO_CARD = (RuntimeError, AssertionError)  # torch's own "no CUDA" errors


def test_resolve_device_is_shared():
    assert numerics.resolve_device(None) == torch.device("cuda")
    assert numerics.resolve_device("cpu") == torch.device("cpu")
    assert spectral_filter.resolve_device is numerics.resolve_device
    assert tp.utils.resolve_device is numerics.resolve_device


def test_as_tensor_keeps_tensors_and_places_arrays():
    t = torch.arange(4.0)
    assert numerics.as_tensor(t) is t
    for data in (np.arange(4.0), [0.0, 1.0, 2.0, 3.0]):
        got = numerics.as_tensor(data, device="cpu")
        assert got.device.type == "cpu" and torch.equal(got.to(t.dtype), t)
    assert numerics.as_tensor(2.5, "cpu").shape == ()
    a, b = numerics.as_tensors(np.ones(3), t)  # joins the tensor's device
    assert a.device == t.device and b is t


@pytest.mark.parametrize("call", [
    lambda x: tp.fft(x),
    lambda x: tp.ifftn(x),
    lambda x: tp.rfft(x),
    lambda x: tp.irfft(x),
    lambda x: tp.rfftn(x),
    lambda x: tp.fftshift(x),
    lambda x: tp.dht(x),
    lambda x: tp.hfft(x),
    lambda x: tp.fft_convolve(x, x),
    lambda x: tp.convolve(x, x, method="direct"),
    lambda x: tp.fft_oaconvolve(x, x[:3]),
    lambda x: tp.models.apply({}, x),
    lambda x: compat.fft_exec(compat.fft_init(8, 1), x),
    lambda x: compat.fft_r2c_exec(compat.fft_real_init(8, 1), x),
    lambda x: compat.fft_convolve("full", "linear", x, x),
    lambda x: tp.fftfreq(8),
    lambda x: tp.rfftfreq(8),
    lambda x: compat.generate_signal(8),
    lambda x: compat.generate_real_signal(8),
    lambda x: tp.models.fno.init_fno(1, 4, 1),
    lambda x: tp.stft(x, 4),
    lambda x: tp.istft(np.ones((3, 3), np.complex64), 4),
    lambda x: tp.spectrogram(x, 4),
    lambda x: tp.griffinlim(np.ones((5, 3), np.float32), 2, 4),
    lambda x: tp.phase_vocoder(np.ones((5, 3), np.complex64), 1.5),
    lambda x: tp.time_stretch(np.ones(64, np.float32), 1.5, 8),
    lambda x: tp.dct(x),
    lambda x: tp.idct(x, 4),
    lambda x: tp.dctn(x),
    lambda x: tp.dst(x, 1),
    lambda x: tp.idstn(x),
    lambda x: tp.mdct(x, 4),
    lambda x: tp.imdct(np.ones((3, 2), np.float32)),
    lambda x: tp.cheb_transform(x),
    lambda x: tp.icheb_transform(x),
    lambda x: tp.cheb_diff_coef(x),
    lambda x: tp.cheb_diff(x),
    lambda x: tp.cheb_eval(x, 0.5),
    lambda x: tp.fht(x, 0.1, 0.0),
    lambda x: tp.ifht(x, 0.1, 0.0),
    lambda x: tp.fwht(x),
    lambda x: tp.ifwht(x),
    lambda x: tp.czt(x),
    lambda x: tp.zoom_fft(x, 0.5),
    lambda x: tp.CZT(8)(x),
    lambda x: tp.frft(x, 0.5),
    lambda x: tp.ifrft(x, 1.0),
    lambda x: tp.frft2(np.ones((4, 4), np.float32), 2.0),
    lambda x: tp.models.s4d.init_s4d_model(4),
    lambda x: tp.models.fnet.init_fnet(4),
    lambda x: tp.models.fnet.fourier_mix(np.ones((2, 4, 4), np.float32)),
    lambda x: tp.models.afno.init_afno(1, 4, 1),
    lambda x: tp.models.init_koopman(3),
    lambda x: tp.models.koopman_encode({"enc": []}, x),
    lambda x: tp.ShortTimeFFT(np.hanning(4), 2, 1.0).stft(x),
    lambda x: tp.ShortTimeFFT(np.hanning(4), 2, 1.0).spectrogram(x),
    lambda x: tp.ShortTimeFFT(np.hanning(4) + 0.1, 2, 1.0).istft(np.ones((3, 6), np.complex64)),
    lambda x: tp.spectral_diff(x),
    lambda x: tp.hilbert(x),
    lambda x: tp.hilbert2(np.ones((4, 4), np.float32)),
    lambda x: tp.periodogram(x),
    lambda x: tp.welch(x),
    lambda x: tp.csd(x, x),
    lambda x: tp.coherence(x, x),
    lambda x: tp.tfestimate(x, x),
    lambda x: tp.multitaper(x, nw=2.0),
    lambda x: tp.lombscargle(x, x, x),
    lambda x: tp.goertzel(x, 0.25),
    lambda x: tp.envelope(x),
    lambda x: tp.rceps(x),
    lambda x: tp.cceps(x),
    lambda x: tp.icceps(x),
    lambda x: tp.minimum_phase(x),
    lambda x: tp.detrend(x),
    lambda x: tp.poisson_solve(x),
    lambda x: tp.thd(np.ones(64, np.float32)),
    lambda x: tp.sinad(np.ones(64, np.float32)),
    lambda x: tp.sfdr(np.ones(64, np.float32)),
    lambda x: tp.enob(np.ones(64, np.float32)),
    lambda x: tp.freqz(x),
    lambda x: tp.freqz(x, worN=np.linspace(0, 3, 5)),
    lambda x: tp.group_delay((x, 1.0), 16),
    lambda x: tp.savgol_filter(x, 5, 2),
    lambda x: tp.upfirdn([1.0, 1.0], x, 2, 3),
    lambda x: tp.resample_poly(x, 2, 3),
    lambda x: tp.resample(x, 5),
    lambda x: tp.decimate(x, 2),
    lambda x: tp.pitch_shift(np.ones(64, np.float32), 8000.0, 2.0, nperseg=8),
    lambda x: tp.bispectrum(x, 4),
    lambda x: tp.bicoherence(x, 4),
    lambda x: tp.cwt(x, tp.ricker, [1.0, 2.0]),
    lambda x: tp.cwt_tc(x, [2.0, 4.0]),
    lambda x: tp.xwt(x, x),
    lambda x: tp.wct(x, x),
    lambda x: tp.gammatonegram(np.ones(200, np.float32), 8000.0, 4),
    lambda x: tp.modulation_spectrum(np.ones(200, np.float32), 8000.0, 4),
    lambda x: tp.melspectrogram(x, 8000.0, 4, n_mels=2),
    lambda x: tp.mfcc(x, 8000.0, 2, 4, n_mels=2),
    lambda x: tp.mfcc_to_mel(np.ones((3, 2), np.float32), 4),
    lambda x: tp.mfcc_to_audio(np.ones((5, 2), np.float32), 8000.0, 4, n_mels=2, n_iter_gl=1),
    lambda x: tp.mel_to_stft(np.ones((5, 2), np.float32), 8000.0, 4),
    lambda x: tp.mel_to_audio(np.ones((5, 2), np.float32), 8000.0, 4, n_iter_gl=1),
    lambda x: tp.hpss(np.ones((4, 4), np.float32), 3),
    lambda x: tp.yin(np.ones(64, np.float32), 500.0, 2000.0, 8000.0, 32),
    lambda x: tp.pyin(np.ones(64, np.float32), 500.0, 2000.0, 8000.0, 32),
    lambda x: tp.pcen(np.ones((4, 2), np.float32)),
    lambda x: tp.models.audio_frontend.init_params(4, 2),
    lambda x: tp.models.audio_frontend.init_frontend(4),
    lambda x: tp.models.audio_frontend.init_classifier(4, 2),
    lambda x: tp.models.audio_frontend.AudioFrontend(4, 2),
    lambda x: tp.sosfilt(tp.butter(2, 0.3, output="sos"), x),
    lambda x: tp.lfilter([1.0, 0.5], [1.0], x),
    lambda x: tp.filtfilt(*tp.butter(2, 0.3), np.ones(32, np.float32)),
    lambda x: tp.decimate(np.ones(64, np.float32), 2, ftype="iir"),
    lambda x: tp.dlsim(([[0.5]], [[1.0]], [[1.0]], [[0.0]], 1.0), x),
    lambda x: tp.lsim(([[-1.0]], [[1.0]], [[1.0]], [[0.0]]), x, np.arange(8.0)),
    lambda x: tp.dlti([1.0], [1.0, -0.5], dt=1.0).output(x, None),
    lambda x: tp.cspline1d(x),
    lambda x: tp.symiirorder2(np.ones(64, np.float32), 0.5, 0.3),
    lambda x: tp.kalman_filter(np.eye(1), np.eye(1), np.eye(1), np.eye(1), np.zeros(1), np.eye(1), x[:, None]),
    lambda x: tp.wigner_ville(x),
    lambda x: tp.stockwell(x),
    lambda x: tp.ssq_stft(np.ones(512, np.float32), nperseg=64),
    lambda x: tp.scattering1d(np.ones(64, np.float32), J=2),
    lambda x: tp.cqt(np.ones(4096, np.float32), fs=8000.0, fmin=100.0, n_bins=12),
    lambda x: tp.spectral_centroid(np.ones(1024, np.float32), nperseg=256),
    lambda x: tp.specaugment(np.ones((4, 4), np.float32)),
    lambda x: tp.decompose(np.ones((4, 4), np.float32), 2, 2),
    lambda x: tp.beat_track(np.ones(8192, np.float32)),
    lambda x: tp.nufft1(x, x, 4),
    lambda x: tp.nufft2(x, np.ones(4, np.complex64), method="grid"),
    lambda x: tp.nudft1(x, x, 4),
    lambda x: tp.nufft3(x, x, x, method="fast"),
    lambda x: tp.nufft1_2d(x, x, x, (4, 4), method="grid"),
    lambda x: tp.nufft2_3d(x, x, x, np.ones((2, 2, 2), np.complex64)),
    lambda x: tp.nufft_lsq(x, x, 4, iters=1),
    lambda x: tp.radon(np.ones((8, 8), np.float32)),
    lambda x: tp.iradon(np.ones((4, 8), np.float32)),
    lambda x: tp.sht(np.ones((4, 8), np.float32)),
    lambda x: tp.isht(np.ones((7, 4), np.complex64)),
    lambda x: tp.sht_recurrence(np.ones((4, 8), np.float32)),
    lambda x: tp.sphere_laplacian(np.ones((4, 8), np.float32)),
    lambda x: tp.sphere_grad(np.ones((4, 8), np.float32)),
    lambda x: tp.rotate_sht(np.ones((7, 4), np.complex64), 0.1, 0.2, 0.3),
    lambda x: tp.models.sfno.init_sfno(1, 2, 1, 3),
    lambda x: tp.models.sfno.SFNO(1, 2, 1, 3),
    lambda x: tp.chirp(x, 1.0, 1.0, 4.0),
    lambda x: tp.sweep_poly(x, [1.0, 2.0]),
    lambda x: tp.gausspulse(x),
    lambda x: tp.sawtooth(x),
    lambda x: tp.square(x),
    lambda x: tp.unit_impulse(8),
    lambda x: tp.pulse_compression(x, x[:3]),
    lambda x: tp.range_doppler(np.ones((4, 8), np.complex64), x[:3]),
    lambda x: tp.cfar(np.ones(32, np.float32), 2, 1),
    lambda x: tp.pfb_analysis(np.ones(64, np.float32), 4, 2),
    lambda x: tp.pfb_synthesis(np.ones((4, 4), np.complex64), 2),
    lambda x: tp.spatial_covariance(np.ones((2, 4), np.complex64)),
    lambda x: tp.bartlett_spectrum(np.eye(2, dtype=np.complex64), 2),
    lambda x: tp.mvdr_spectrum(np.eye(2, dtype=np.complex64), 2),
    lambda x: tp.mvdr_weights(np.eye(2, dtype=np.complex64), 2, 0.0),
    lambda x: tp.corr_matrix(x, 2),
    lambda x: tp.music(np.ones(16, np.float32), 1),
    lambda x: tp.root_music(np.ones(16, np.float32), 1),
    lambda x: tp.esprit(np.ones(16, np.float32), 1),
    lambda x: tp.pisarenko(np.ones(16, np.float32), 1),
    lambda x: tp.medfilt(x),
    lambda x: tp.medfilt2d(np.ones((4, 4), np.float32)),
    lambda x: tp.order_filter(x, np.ones(3), 1),
    lambda x: tp.dwt(x),
    lambda x: tp.idwt(x[:4], x[:4]),
    lambda x: tp.dwt2(np.ones((4, 4), np.float32)),
    lambda x: tp.idwt2(np.ones((2, 2), np.float32), [np.ones((2, 2), np.float32)] * 3),
    lambda x: tp.wavedec(x, "haar", 2),
    lambda x: tp.waverec([x[:2], x[:2], x[:4]], "haar"),
    lambda x: tp.wavedec2(np.ones((4, 4), np.float32), "haar"),
    lambda x: tp.waverec2([np.ones((2, 2), np.float32), [np.ones((2, 2), np.float32)] * 3], "haar"),
    lambda x: tp.swt(x, "haar"),
    lambda x: tp.iswt([(x, x)], "haar"),
    lambda x: tp.swt2(np.ones((4, 4), np.float32), "haar"),
    lambda x: tp.iswt2([(np.ones((4, 4), np.float32), [np.ones((4, 4), np.float32)] * 3)], "haar"),
    lambda x: tp.wpdec(x, "haar"),
    lambda x: tp.wprec([x[:4], x[:4]], "haar"),
    lambda x: tp.wpdec2(np.ones((4, 4), np.float32), "haar"),
    lambda x: tp.wprec2([[np.ones((2, 2), np.float32)] * 2] * 2, "haar"),
    lambda x: tp.wavelet_denoise(x, "haar"),
    lambda x: tp.wavelet_denoise2(np.ones((8, 8), np.float32), "haar"),
    lambda x: tp.cycle_spin(x, lambda v: v, 1),
    lambda x: tp.dtcwt(x, 2),
    lambda x: tp.idtcwt(np.ones((2, 2), np.float32), [np.ones(4, np.complex64), np.ones(2, np.complex64)]),
    lambda x: tp.dtcwt2(np.ones((8, 8), np.float32), 2),
    lambda x: tp.idtcwt2(np.ones((4, 4, 4), np.float32), [np.ones((6, 4, 4), np.complex64)]),
    lambda x: tp.ewt(np.ones(64, np.float32), boundaries=[0.2]),
    lambda x: tp.hilbert_huang(np.sin(np.arange(64.0))),
    lambda x: tp.vmd(x, 2, n_iter=1),
    lambda x: tp.phase_cross_correlation(np.ones((4, 4), np.float32), np.ones((4, 4), np.float32)),
    lambda x: tp.fourier_shift(np.ones((4, 4), np.float32), [1.0, 0.0]),
    lambda x: tp.unwrap_phase_2d(np.ones((4, 4), np.float32)),
    lambda x: tp.fourier_gaussian(x, 1.0),
    lambda x: tp.fourier_uniform(x, 1.0),
    lambda x: tp.fourier_ellipsoid(x, 1.0),
    lambda x: tp.wiener(x),
    lambda x: tp.lms_filter(x, x, 2),
    lambda x: tp.nlms_filter(x, x, 2),
    lambda x: tp.rls_filter(x, x, 2),
    lambda x: tp.ar_psd(np.array([1.0, -0.5]), 1.0, 8),
], ids=lambda f: None)
def test_numpy_input_without_a_device_needs_the_card(call):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(NO_CARD):
        call(np.ones(8, dtype=np.float32))


def test_cpu_tensor_and_cpu_device_work():
    x = np.arange(8, dtype=np.float32)
    xt = torch.from_numpy(x)
    assert tp.fft(xt).device.type == "cpu"
    # numpy beside a CPU tensor computes on the CPU
    assert tp.fft_convolve(xt, x).device.type == "cpu"
    assert tp.fftfreq(8, device="cpu").device.type == "cpu"
    assert compat.generate_signal(8, device="cpu").device.type == "cpu"
    assert compat.fft_exec(compat.fft_init(8, 1), xt).device.type == "cpu"
    # numpy beside a CPU tensor, and the tables these ops keep, on the CPU
    assert tp.nufft1(xt, x, 4, method="grid").device.type == "cpu"
    assert tp.nufft2_2d(xt, xt, np.ones((4, 4), np.complex64)).device.type == "cpu"
    assert tp.radon(torch.ones(8, 8), [0.0, 1.0]).device.type == "cpu"
    assert tp.sht(torch.ones(4, 8)).device.type == "cpu"
    assert tp.isht_recurrence(torch.ones(7, 4, dtype=torch.complex64)).device.type == "cpu"
    params = tp.models.sfno.init_sfno(1, 2, 1, 3, device="cpu")
    assert tp.models.sfno.apply(params, torch.ones(1, 1, 4, 8)).device.type == "cpu"


_CPU = torch.arange(16, dtype=torch.float32) % 5
_IMG = (torch.arange(64, dtype=torch.float32) % 7).reshape(8, 8)


@pytest.mark.parametrize("call", [
    lambda: tp.chirp(torch.linspace(0, 1, 8), 1.0, 1.0, 4.0),
    lambda: tp.square(torch.linspace(0, 9, 8)),
    lambda: tp.unit_impulse(8, device="cpu"),
    lambda: tp.pulse_compression(_CPU, np.ones(3, np.float32)),
    lambda: tp.range_doppler(_IMG, np.ones(3, np.float32)),
    lambda: tp.cfar(_CPU, 2, 1)[1],
    lambda: tp.pfb_analysis(_CPU.repeat(4), 4, 2),
    lambda: tp.pfb_synthesis(tp.pfb_analysis(_CPU.repeat(4), 4, 2, mode="full"), 2),
    lambda: tp.spatial_covariance(_IMG[:4]),
    lambda: tp.mvdr_spectrum(torch.eye(4, dtype=torch.complex64), 4)[1],
    lambda: tp.mvdr_weights(torch.eye(4, dtype=torch.complex64), 4, 10.0),
    lambda: tp.bartlett_spectrum(torch.eye(4, dtype=torch.complex64), 4)[1],
    lambda: tp.medfilt2d(_IMG),
    lambda: tp.wavedec(_CPU, "db2", 2)[0],
    lambda: tp.wavedec2(_IMG, "haar", 2)[0],
    lambda: tp.swt(_CPU, "db2", 2)[0][0],
    lambda: tp.dtcwt(_CPU, 2)[0],
    lambda: tp.dtcwt2(_IMG, 2)[1][0],
    lambda: tp.wavelet_denoise(_CPU, "haar"),
    lambda: tp.ewt(_CPU.repeat(4), boundaries=[0.2])[0],
    lambda: tp.hilbert_huang(torch.sin(torch.arange(64.0)))[1],
    lambda: tp.vmd(_CPU, 2, n_iter=2)[0],
    lambda: tp.phase_cross_correlation(_IMG, torch.roll(_IMG, 1, 0), 4)[0],
    lambda: tp.fourier_shift(_IMG, torch.tensor([0.5, 1.0])),
    lambda: tp.unwrap_phase_2d(_IMG),
    lambda: tp.fourier_ellipsoid(_IMG, 2.0),
    lambda: tp.wiener(_IMG),
    lambda: tp.lms_filter(_CPU, _CPU, 2)[2],
    lambda: tp.rls_filter(_CPU, _CPU, 2)[2],
    lambda: tp.ar_psd(torch.tensor([1.0, -0.5]), 1.0, 8)[1],
], ids=lambda f: None)
def test_the_radar_wavelet_and_image_ops_keep_cpu_tensors_on_the_cpu(call):
    """A CPU tensor in, every tensor out on the CPU: the host tables these
    ops keep follow the data."""
    out = call()
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"


@pytest.mark.cuda
@pytest.mark.parametrize("call", [
    lambda: tp.chirp(np.linspace(0, 1, 8), 1.0, 1.0, 4.0),
    lambda: tp.unit_impulse(8),
    lambda: tp.range_doppler(np.ones((4, 8), np.complex64), np.ones(3, np.complex64)),
    lambda: tp.pfb_analysis(np.ones(64, np.float32), 4, 2),
    lambda: tp.spatial_covariance(np.ones((4, 8), np.complex64)),
    lambda: tp.medfilt(np.ones(16, np.float32)),
    lambda: tp.wavedec(np.ones(16, np.float32), "db2", 2)[0],
    lambda: tp.dtcwt2(np.ones((8, 8), np.float32), 2)[0],
    lambda: tp.ewt(np.sin(np.arange(64.0)), boundaries=[0.2])[0],
    lambda: tp.hilbert_huang(np.sin(np.arange(64.0)))[1],
    lambda: tp.vmd(np.ones(16, np.float32), 2, n_iter=2)[0],
    lambda: tp.phase_cross_correlation(np.ones((4, 4), np.float32), np.ones((4, 4), np.float32))[0],
    lambda: tp.wiener(np.ones((4, 4), np.float32)),
    lambda: tp.lms_filter(np.ones(16, np.float32), np.ones(16, np.float32), 2)[2],
    lambda: tp.ar_psd(np.array([1.0, -0.5]), 1.0, 8)[1],
], ids=lambda f: None)
def test_the_radar_wavelet_and_image_ops_put_numpy_input_on_the_card(call):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    assert call().device.type == "cuda"


def test_meshes_and_the_distributed_filter_go_to_the_card_by_default():
    """``make_mesh``, ``initialize_multihost`` and ``init_params_complex``
    default to the card (NCCL for the collectives), and numpy input to a
    sharded entry point goes to the mesh's device.  Without a card each
    raises torch's own error; ``make_mesh`` runs in a process of its own,
    since it would start a process group."""
    import types

    from mixed_radix_fast_fourier_transform_tpu_torch.parallel import distributed, mesh

    assert mesh._backend(numerics.resolve_device(None)) == "nccl"
    assert mesh._backend(numerics.resolve_device("cpu")) == "gloo"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(NO_CARD):
        spectral_filter.init_params_complex(8)
    card_mesh = types.SimpleNamespace(device_type="cuda")
    with pytest.raises(NO_CARD):
        distributed._input(np.ones(8, np.float32), card_mesh)
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "from mixed_radix_fast_fourier_transform_tpu_torch.parallel import make_mesh\n"
            "try:\n"
            "    make_mesh()\n"
            "except RuntimeError as e:\n"
            "    print('refused:', e)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=str(PACKAGE.parent))
    assert out.returncode == 0 and "refused:" in out.stdout and "NCCL" in out.stdout, out


def test_only_the_helper_calls_torch_as_tensor():
    """No module of the port turns caller data into a tensor on its own:
    ``torch.as_tensor`` appears in ``utils/numerics.py::as_tensor`` only."""
    hits = []
    for path in sorted(PACKAGE.rglob("*.py")):
        for i, line in enumerate(path.read_text().splitlines(), 1):
            if re.search(r"torch\.as_tensor\(", line):
                hits.append(f"{path.relative_to(PACKAGE)}:{i}")
    assert len(hits) == 1 and hits[0].startswith("utils/numerics.py:"), hits


def test_every_module_imports_with_jax_blocked():
    """Every module of the port imports with ``jax`` and the JAX package
    made unimportable: the port keeps its own copy of what it needs."""
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['mixed_radix_fast_fourier_transform_tpu'] = None\n"
        "import mixed_radix_fast_fourier_transform_tpu_torch as tp\n"
        "names = [m.name for m in pkgutil.walk_packages(tp.__path__, tp.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "wanted = ['models.s4d', 'models.fnet', 'models.afno', 'models.koopman',\n"
        "          'models.checkpoint', 'ops.stft', 'ops.windows', 'ops.dct', 'ops.mdct',\n"
        "          'ops.chebyshev', 'ops.fht', 'ops.czt', 'ops.frft', 'ops.shorttime',\n"
        "          'ops.signal', 'ops.hos', 'ops.cwt', 'ops.auditory', 'ops.mel',\n"
        "          'models.audio_frontend', 'utils.scan', 'ops.iir', 'ops.ltisys',\n"
        "          'ops.lticlasses', 'ops.splines', 'ops.kalman', 'ops.tfr', 'ops.scattering',\n"
        "          'ops.cqt', 'ops.feature', 'ops.nufft', 'ops.tomo', 'ops.sht',\n"
        "          'models.sfno', 'ops.waveforms', 'ops.radar', 'ops.pfb', 'ops.beamform',\n"
        "          'ops.subspace', 'ops.peaks', 'ops.dwt', 'ops.dtcwt', 'ops.ewt', 'ops.emd',\n"
        "          'ops.vmd', 'ops.register', 'ops.ndimage', 'ops.adaptive', 'ops.ar',\n"
        "          'ops.datadriven', 'parallel.mesh', 'parallel.distributed', 'utils.cache',\n"
        "          'utils.aot', 'tools.tune', 'examples.serving_export', 'examples.fno_train',\n"
        "          'examples.pde_spectral', 'examples.sphere_advection', 'examples.mri_recon',\n"
        "          'examples.radar_array', 'examples.audio_features', 'examples.signal_toolbox',\n"
        "          'examples.demo']\n"
        "assert all(tp.__name__ + '.' + w in names for w in wanted), names\n"
        "print('OK', len(names))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=str(PACKAGE.parent))
    assert out.returncode == 0 and "OK" in out.stdout, out.stderr


# Every module of the JAX package but two, which have no file of their own
# in the port by design: ``utils/native.py`` (the port loads no native
# library) and ``ops/pallas_fft.py`` (the fused kernel is ops/cuda_fft.py).
# An ops module is named by its stem, any other by its path.
JAX_MODULES = [
    "iir", "ltisys", "lticlasses", "splines", "kalman", "tfr", "scattering", "cqt", "feature",
    "nufft", "tomo", "sht", "waveforms", "radar", "pfb", "beamform", "subspace", "peaks", "dwt",
    "dtcwt", "ewt", "emd", "vmd", "register", "ndimage", "adaptive", "ar", "datadriven",
    "auditory", "chebyshev", "convolve", "cwt", "czt", "dct", "fft", "fht", "frft", "hos", "mdct",
    "mel", "rfft", "shorttime", "signal", "stft", "stockham", "windows",
    "compat", "plan",
    "models/afno", "models/audio_frontend", "models/checkpoint", "models/fnet", "models/fno",
    "models/koopman", "models/s4d", "models/sfno", "models/spectral_filter",
    "parallel/distributed", "parallel/mesh",
    "utils/aot", "utils/cache", "utils/config", "utils/factorize", "utils/metrics",
    "utils/numerics", "utils/profiling", "utils/twiddle",
]


def test_the_name_check_covers_every_jax_module():
    jax_pkg = PACKAGE.parent / "mixed_radix_fast_fourier_transform_tpu"
    found = {str(p.relative_to(jax_pkg))[:-3] for p in jax_pkg.rglob("*.py")
             if p.name != "__init__.py"}
    named = {m if "/" in m or m in ("compat", "plan") else f"ops/{m}" for m in JAX_MODULES}
    assert found - named == {"utils/native", "ops/pallas_fft"}
    assert named <= found


@pytest.fixture(scope="module")
def port_exports():
    """The public names of the port's package and subpackages, read in a
    process where ``jax`` and the JAX package cannot be imported."""
    code = (
        "import importlib, json, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['mixed_radix_fast_fourier_transform_tpu'] = None\n"
        "out = {}\n"
        "for sub in ('', 'ops', 'models', 'parallel', 'utils'):\n"
        "    name = 'mixed_radix_fast_fourier_transform_tpu_torch' + ('.' + sub if sub else '')\n"
        "    out[sub] = sorted(n for n in dir(importlib.import_module(name)) if n[:1] != '_')\n"
        "print(json.dumps(out))\n"
    )
    done = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=str(PACKAGE.parent))
    assert done.returncode == 0, done.stderr
    return {k: set(v) for k, v in json.loads(done.stdout).items()}


@pytest.mark.parametrize("module", JAX_MODULES)
def test_every_public_name_of_the_jax_module_is_ported(module, port_exports):
    """Every public function and class of the JAX module (read from its
    source, without importing it) is defined in the port's module of the
    same path and exported by the port's package and subpackage wherever
    the JAX package's ``__init__`` exports it; the port's side is read with
    ``jax`` blocked."""
    def public(path):
        tree = ast.parse(path.read_text())
        return {n.name for n in tree.body if isinstance(n, (ast.FunctionDef, ast.ClassDef))
                and not n.name.startswith("_")}

    rel = module if "/" in module or module in ("compat", "plan") else f"ops/{module}"
    jax_pkg = PACKAGE.parent / "mixed_radix_fast_fourier_transform_tpu"
    want = public(jax_pkg / f"{rel}.py")
    got = public(PACKAGE / f"{rel}.py")
    assert want and want <= got, want - got
    sub = rel.split("/")[0] if "/" in rel else ""
    for pkg in {"", sub}:
        init = jax_pkg / pkg / "__init__.py"
        exported = set(re.findall(r"\b(\w+)\b", init.read_text()))
        missing = sorted(n for n in want if n in exported and n not in port_exports[pkg])
        assert not missing, (pkg, missing)


# Argument names and dataclass fields that the port renames or drops on
# purpose, each with its reason; nothing else of the JAX package may be
# missing from the port.
RENAMED_ARGUMENTS = {
    # randomness takes a torch.Generator where the JAX function takes a PRNG key
    "key": "generator",
    # the fused kernel's switch: the Pallas kernel became ops/cuda_fft.py's
    "use_pallas": "use_kernel",
    # a mesh spans the process group's ranks: make_mesh takes one device type
    "devices": "device",
}
# nothing is dropped: ``precision`` (SpectralConfig, MixedRadixPlan) is
# ported too
DROPPED_ARGUMENTS = set()


def _signatures(path):
    """{name: argument names} of a module's public functions (the names a
    caller can pass: not ``*args``/``**kwargs``) and {name: field names} of
    its public dataclasses, read from the source."""
    out = {}
    for node in ast.parse(path.read_text()).body:
        if getattr(node, "name", "_").startswith("_"):
            continue
        if isinstance(node, ast.FunctionDef):
            a = node.args
            out[node.name] = {v.arg for v in a.posonlyargs + a.args + a.kwonlyargs}
        elif isinstance(node, ast.ClassDef) and any(
                "dataclass" in ast.unparse(d) for d in node.decorator_list):
            out[node.name] = {v.target.id for v in node.body
                              if isinstance(v, ast.AnnAssign) and isinstance(v.target, ast.Name)}
    return out


@pytest.mark.parametrize("module", JAX_MODULES)
def test_every_argument_and_field_of_the_jax_module_is_ported(module):
    """Every argument name of every public function, and every field of
    every public dataclass, of the JAX module (read from its source) is one
    of the port's function or dataclass of the same name, but for the
    renamed and dropped names above; the working dtype (``dtype`` of
    ``SpectralConfig``, ``to_planes`` and the model initialisers) among
    them."""
    rel = module if "/" in module or module in ("compat", "plan") else f"ops/{module}"
    want = _signatures(PACKAGE.parent / "mixed_radix_fast_fourier_transform_tpu" / f"{rel}.py")
    got = _signatures(PACKAGE / f"{rel}.py")
    missing = {}
    for name, names in want.items():
        need = {RENAMED_ARGUMENTS.get(v, v) for v in names} - DROPPED_ARGUMENTS
        if need - got.get(name, set()):
            missing[name] = sorted(need - got.get(name, set()))
    assert not missing, missing


def test_pyproject_lists_every_package_of_the_port():
    """A wheel holds every directory of the port that has an ``__init__.py``
    (``tools`` and ``examples`` too), and the kernel sources."""
    import tomllib

    conf = tomllib.loads((PACKAGE.parent / "pyproject.toml").read_text())["tool"]["setuptools"]
    on_disk = {".".join(p.parent.relative_to(PACKAGE.parent).parts)
               for p in PACKAGE.rglob("__init__.py")}
    listed = {p for p in conf["packages"] if p.startswith(PACKAGE.name)}
    assert on_disk == listed, (on_disk - listed, listed - on_disk)
    assert {f"{PACKAGE.name}.tools", f"{PACKAGE.name}.examples"} <= listed
    assert conf["package-data"][PACKAGE.name] == ["csrc/*.cu", "csrc/*.cuh"]
    assert list((PACKAGE / "csrc").glob("*.cu")) and list((PACKAGE / "csrc").glob("*.cuh"))


def test_no_library_fft_in_the_port():
    """No result of the port comes from a library FFT: ``torch.fft``,
    ``torch.stft``, ``torch.istft``, ``torchaudio`` and the framework's
    convolutions in place of an engine transform appear in no module of the
    package (``ops/convolve.py`` calls ``F.conv*`` for its direct method,
    and ``ops/dwt.py`` for the wavelet filter banks, which are short FIR
    filters and no transform), and numpy's float64 FFT only where host
    design constants are made (Bluestein and chirp-z kernel spectra, the
    Chebyshev window, DPSS ratios, the taps of ``firwin2`` and ``remez``,
    the reassignment's derivative window, the CQT's spectral kernel, the
    PFB's branch spectra, the dual-tree bank's analyticity check, the
    sharded convolutions' kernel spectra), where
    the JAX module itself runs a float64 transform on the host
    (``compat.fft_exec`` on host input, ``ewt_boundaries``' spectrum) or a
    host frequency grid is laid out (``np.fft.fftfreq``/``rfftfreq``/
    ``fftshift``).  The programs that drive the package, ``tools/`` and
    ``examples/``, compute no result of it: they hold it against float64
    numpy oracles, and ``tools/tune.py`` times it against ``torch.fft``, the
    one library FFT among them."""
    torch_hits, numpy_files, numpy_transforms = [], set(), set()
    drivers = sorted(p for d in ("tools", "examples") for p in (PACKAGE / d).rglob("*.py"))
    assert {str(p.relative_to(PACKAGE)) for p in drivers
            if re.search(r"torch\.(fft\b|stft\(|istft\()|torchaudio", p.read_text())} \
        == {"tools/tune.py"}
    for path in sorted(set(PACKAGE.rglob("*.py")) - set(drivers)):
        rel = str(path.relative_to(PACKAGE))
        for i, line in enumerate(path.read_text().splitlines(), 1):
            if re.search(r"torch\.(fft\b|stft\(|istft\()|torchaudio", line):
                torch_hits.append(f"{rel}:{i}")
            if re.search(r"\bF\.conv\w*\(|functional\.conv", line) and rel not in (
                    "ops/convolve.py", "ops/dwt.py"):
                torch_hits.append(f"{rel}:{i}")
            if re.search(r"\bnp\.fft\.i?r?fft[2n]?\(", line):
                numpy_transforms.add(rel)
            if re.search(r"\bnp\.fft\.\w+\(", line):
                numpy_files.add(rel)
    assert not torch_hits, torch_hits
    assert numpy_files == {"plan.py", "ops/czt.py", "ops/stft.py", "ops/shorttime.py",
                           "ops/signal.py", "ops/cwt.py", "ops/auditory.py", "ops/mel.py",
                           "ops/tfr.py", "ops/scattering.py", "ops/feature.py",
                           "ops/cqt.py", "compat.py", "ops/pfb.py", "ops/vmd.py",
                           "ops/register.py", "ops/ndimage.py", "ops/ewt.py",
                           "ops/dtcwt.py", "parallel/distributed.py"}, numpy_files
    # a float64 transform on the host: plan and window constants, the two
    # filter designs that end in an inverse DFT of their sampled response, the
    # derivative window of the reassignment, and the CQT's spectral kernel
    assert numpy_transforms == {"plan.py", "ops/czt.py", "ops/stft.py", "ops/signal.py",
                                "ops/tfr.py", "ops/cqt.py", "compat.py", "ops/pfb.py",
                                "ops/ewt.py", "ops/dtcwt.py", "parallel/distributed.py"}, \
        numpy_transforms
    text = (PACKAGE / "ops/signal.py").read_text()
    assert len(re.findall(r"np\.fft\.i?r?fft[2n]?\(", text)) == 2   # remez, firwin2
