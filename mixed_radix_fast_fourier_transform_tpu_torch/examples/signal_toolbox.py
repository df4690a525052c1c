"""Signal-processing toolbox walkthrough: the scipy.signal-class workflow.

Counterpart of the JAX package's ``examples/signal_toolbox.py``: spec-driven
IIR design -> zero-phase filtering -> ShortTimeFFT spectrogram -> wavelet
denoising -> empirical mode decomposition -> quadratic-phase-coupling
detection via the bicoherence -> LTI simulation and pole placement ->
root-MUSIC -> Kalman smoothing -> EMD, VMD and EWT on one mixture.  Data
are drawn from seed 0 in the JAX example's order.

Run: python -m mixed_radix_fast_fourier_transform_tpu_torch.examples.signal_toolbox
"""

from __future__ import annotations

import numpy as np
import scipy.signal as ss
import torch

from .. import (ShortTimeFFT, StateSpace, bicoherence, butter, buttord, emd, ewt, goertzel,
                hilbert_huang, kalman_smoother, place_poles, root_music, sosfiltfilt, vmd,
                wavelet_denoise)
from ..utils.numerics import resolve_device, to_host


def main(*, device=None, fs: float = 8000.0, seconds: float = 2.0) -> dict:
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    t = np.arange(int(seconds * fs)) / fs
    out = {}

    def on_dev(a):
        return torch.tensor(a, device=dev)

    # a messy measurement: speech-band tone + mains hum + wideband noise
    signal = (np.sin(2 * np.pi * 440.0 * t)
              + 0.8 * np.sin(2 * np.pi * 50.0 * t)          # mains hum
              + 0.3 * rng.standard_normal(len(t))).astype(np.float32)

    # 1. design a hum band-stop from a spec, apply it zero-phase
    n, wn = buttord([30 / (fs / 2), 80 / (fs / 2)], [45 / (fs / 2), 60 / (fs / 2)], 3, 30)
    sos = butter(n, wn, btype="bandstop", output="sos")
    clean = sosfiltfilt(sos, on_dev(signal))

    def hum_power(x):
        return float(goertzel(x, 50.0, fs=fs).abs())

    out["hum"] = (hum_power(on_dev(signal)), hum_power(clean))
    print(f"[filter] band-stop order {n}; 50 Hz power {out['hum'][0]:.1f} -> {out['hum'][1]:.1f}")
    assert out["hum"][1] < 0.1 * out["hum"][0]

    # 2. ShortTimeFFT spectrogram of the cleaned signal
    SFT = ShortTimeFFT(ss.windows.hann(256, sym=False), hop=64, fs=fs, scale_to="magnitude")
    S = SFT.spectrogram(clean)
    out["stft_ridge_hz"] = float(SFT.f[int(to_host(S.mean(dim=-1)).argmax())])
    print(f"[stft] spectrogram {tuple(S.shape)}, dominant ridge at "
          f"{out['stft_ridge_hz']:.0f} Hz (expect 440)")
    assert abs(out["stft_ridge_hz"] - 440.0) <= fs / 256

    # 3. wavelet denoising takes out the wideband noise
    denoised = to_host(wavelet_denoise(clean, "db4", method="bayes"))
    tone = np.sin(2 * np.pi * 440.0 * t)

    def snr(y):
        return 10 * np.log10(float(np.sum(tone ** 2) / np.sum((y - tone) ** 2)))

    out["snr_db"] = (snr(to_host(clean)), snr(denoised))
    print(f"[wavelet] SNR vs the 440 Hz tone: {out['snr_db'][0]:.1f} -> {out['snr_db'][1]:.1f} dB")
    assert out["snr_db"][1] > out["snr_db"][0]

    # 4. EMD splits residual trends from oscillations
    imfs, amp, freq = hilbert_huang(on_dev(denoised[:4096]), fs=fs)
    out["imf1_hz"] = float(np.median(to_host(freq)[0][256:-256]))
    print(f"[emd] {imfs.shape[0] - 1} IMFs + residue; IMF-1 instantaneous "
          f"frequency ~{out['imf1_hz']:.0f} Hz")
    assert np.isfinite(out["imf1_hz"])

    # 5. nonlinearity check: bicoherence of a quadratically coupled triad
    k = np.arange(256 * 32)
    coupled = np.zeros(len(k), np.float32)
    for s in range(0, len(k), 256):
        p1, p2 = rng.uniform(0, 2 * np.pi, 2)
        kk = np.arange(256)
        coupled[s:s + 256] = (np.cos(2 * np.pi * 24 / 128 * kk + p1)
                              + np.cos(2 * np.pi * 8 / 128 * kk + p2)
                              + np.cos(2 * np.pi * 32 / 128 * kk + p1 + p2))
    out["bicoherence"] = float(bicoherence(on_dev(coupled), nperseg=128)[24, 8])
    print(f"[hos] bicoherence at the coupled pair: {out['bicoherence']:.2f} "
          "(≈1 = quadratic phase coupling)")
    assert out["bicoherence"] > 0.9

    # 6. LTI: place poles on a double integrator, check the step response
    A = np.array([[0.0, 1.0], [0.0, 0.0]])
    B = np.array([[0.0], [1.0]])
    res = place_poles(A, B, [-2.0, -3.0])
    K = res.gain_matrix
    cl = StateSpace(A - B @ K, B, np.array([[1.0, 0.0]]), np.array([[0.0]]))
    _, y = cl.step(T=np.linspace(0, 4, 120), device=dev)
    out["step_final"] = float(to_host(y)[-1])
    print(f"[lti] closed-loop poles {np.round(res.computed_poles.real, 2)}, "
          f"step settles to {out['step_final']:.3f} (expect 1/6)")
    assert abs(out["step_final"] - 1 / 6) < 0.01

    # 7. super-resolution: two tones one FFT bin apart
    kk = np.arange(512)
    two = (np.cos(2 * np.pi * 0.102 * kk) + 0.8 * np.cos(2 * np.pi * 0.118 * kk)
           + 0.05 * rng.standard_normal(512))
    f_est = np.asarray(root_music(on_dev(two), p=4, m=32))
    out["root_music"] = np.sort(f_est[f_est > 0])
    print(f"[subspace] root-MUSIC resolves {out['root_music']} "
          "(0.016 apart, under the 32-tap window's FFT limit)")
    assert np.allclose(out["root_music"], [0.102, 0.118], atol=2e-3)

    # 8. parallel-in-time Kalman smoothing of a noisy track
    F = np.array([[1.0, 1.0], [0.0, 1.0]])
    Qk, Hk, Rk = 0.01 * np.eye(2), np.array([[1.0, 0.0]]), np.array([[0.25]])
    truth = np.cumsum(0.05 * rng.standard_normal(256))
    meas = (truth + 0.5 * rng.standard_normal(256))[:, None].astype(np.float32)
    sm, _ = kalman_smoother(F, Qk, Hk, Rk, np.zeros(2), np.eye(2), on_dev(meas))

    def mse(y):
        return float(np.mean((np.asarray(y) - truth) ** 2))

    out["kalman_mse"] = (mse(meas[:, 0]), mse(to_host(sm)[:, 0]))
    print(f"[kalman] track MSE: raw {out['kalman_mse'][0]:.3f} -> smoothed "
          f"{out['kalman_mse'][1]:.3f}")
    assert out["kalman_mse"][1] < out["kalman_mse"][0]

    # 9. adaptive decompositions: EMD vs VMD vs EWT on the same mixture
    kk2 = np.arange(2048)
    mix = on_dev((np.cos(2 * np.pi * 0.04 * kk2)
                  + 0.7 * np.cos(2 * np.pi * 0.17 * kk2)).astype(np.float32))
    imfs = emd(mix, max_imf=3)
    _, vfreq = vmd(mix, K=2)
    _, ebound = ewt(mix, n_bands=2)
    out["vmd_centers"] = np.sort(to_host(vfreq))
    out["ewt_boundary"] = float(to_host(ebound)[0])
    print(f"[adaptive] EMD {imfs.shape[0] - 1} IMFs; VMD centers "
          f"{np.round(out['vmd_centers'], 3)}; EWT boundary {out['ewt_boundary']:.3f} "
          "(truth: tones at 0.040/0.170)")
    assert np.allclose(out["vmd_centers"], [0.04, 0.17], atol=5e-3)
    assert 0.04 < out["ewt_boundary"] < 0.17
    print("signal_toolbox demo complete.")
    return out


if __name__ == "__main__":
    main()
