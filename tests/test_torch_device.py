"""PyTorch port: where data that is no tensor yet goes.

A tensor stays on its own device.  A numpy array, a list or a scalar goes
to the card, as the JAX package puts such input on its default device; so
do the arrays the library creates, unless given a device.  There is no
fallback to the CPU: without a card the call raises.
"""

import ast
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
        "          'ops.cqt', 'ops.feature']\n"
        "assert all(tp.__name__ + '.' + w in names for w in wanted), names\n"
        "print('OK', len(names))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=str(PACKAGE.parent))
    assert out.returncode == 0 and "OK" in out.stdout, out.stderr


@pytest.mark.parametrize("module", ["iir", "ltisys", "lticlasses", "splines", "kalman", "tfr",
                                    "scattering", "cqt", "feature"])
def test_every_public_name_of_the_jax_module_is_ported(module):
    """Every public function and class of the JAX module (read from its
    source, without importing it) is defined in the port's module of the
    same path and exported by the package where the JAX package exports it."""
    def public(path):
        tree = ast.parse(path.read_text())
        return {n.name for n in tree.body if isinstance(n, (ast.FunctionDef, ast.ClassDef))
                and not n.name.startswith("_")}

    jax_ops = PACKAGE.parent / "mixed_radix_fast_fourier_transform_tpu" / "ops"
    want = public(jax_ops / f"{module}.py")
    assert want and want <= public(PACKAGE / "ops" / f"{module}.py"), want - public(PACKAGE / "ops" / f"{module}.py")
    exported = re.findall(r"\b(\w+)\b", (jax_ops.parent / "__init__.py").read_text())
    missing = sorted(n for n in want if n in exported and not hasattr(tp, n))
    assert not missing, missing


def test_no_library_fft_in_the_port():
    """No result of the port comes from a library FFT: ``torch.fft``,
    ``torch.stft``, ``torch.istft``, ``torchaudio`` and the framework's
    convolutions in place of an engine transform appear in no module of the
    package (``ops/convolve.py`` alone calls ``F.conv*``, for its direct
    method), and numpy's float64 FFT only where host design constants are made
    (Bluestein and chirp-z kernel spectra, the Chebyshev window, DPSS ratios,
    the taps of ``firwin2`` and ``remez``, the reassignment's derivative
    window, the CQT's spectral kernel) or a host frequency grid is laid
    out (``np.fft.fftfreq``/``rfftfreq``/``fftshift``)."""
    torch_hits, numpy_files, numpy_transforms = [], set(), set()
    for path in sorted(PACKAGE.rglob("*.py")):
        rel = str(path.relative_to(PACKAGE))
        for i, line in enumerate(path.read_text().splitlines(), 1):
            if re.search(r"torch\.(fft\b|stft\(|istft\()|torchaudio", line):
                torch_hits.append(f"{rel}:{i}")
            if re.search(r"\bF\.conv\w*\(|functional\.conv", line) and rel != "ops/convolve.py":
                torch_hits.append(f"{rel}:{i}")
            if re.search(r"\bnp\.fft\.i?r?fft[2n]?\(", line):
                numpy_transforms.add(rel)
            if re.search(r"\bnp\.fft\.\w+\(", line):
                numpy_files.add(rel)
    assert not torch_hits, torch_hits
    assert numpy_files == {"plan.py", "ops/czt.py", "ops/stft.py", "ops/shorttime.py",
                           "ops/signal.py", "ops/cwt.py", "ops/auditory.py", "ops/mel.py",
                           "ops/tfr.py", "ops/scattering.py", "ops/feature.py",
                           "ops/cqt.py"}, numpy_files
    # a float64 transform on the host: plan and window constants, the two
    # filter designs that end in an inverse DFT of their sampled response, the
    # derivative window of the reassignment, and the CQT's spectral kernel
    assert numpy_transforms == {"plan.py", "ops/czt.py", "ops/stft.py", "ops/signal.py",
                                "ops/tfr.py", "ops/cqt.py"}, numpy_transforms
    text = (PACKAGE / "ops/signal.py").read_text()
    assert len(re.findall(r"np\.fft\.i?r?fft[2n]?\(", text)) == 2   # remez, firwin2
