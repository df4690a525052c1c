"""End-to-end demo harness.

Counterpart of the JAX package's ``examples/demo.py``: the working version
of the C reference's commented-out ``main`` (sine signals through complex
and real transforms forward and back, MSE < 1e-10), at the lengths the
reference crashes or is silently wrong on, and then a tour of the library:
convolution, gradients, lapped transforms and wavelets, NUFFT, spherical
harmonics, Chebyshev, denoising, estimation, the audio toolbox, MIR and
tomography, and a sharded transform on a mesh (a world of one when the
process has no group).  Each section is a function of its own that asserts
what it prints and returns it.

Run: python -m mixed_radix_fast_fourier_transform_tpu_torch.examples.demo
"""

from __future__ import annotations

import numpy as np
import torch

from .. import (
    chroma_stft, cheb_diff, cheb_points, chirp, compat, cqt, cqt_frequencies, cwt, dtcwt, dwt,
    fft, fft_convolve, freqz, frft, hpss, idwt, ifft, imdct, iradon, irfft, isht, istockwell,
    iswt, lombscargle, mdct, multitaper, nufft1, nufft2, pitch_shift, pyin, radon,
    reassigned_spectrogram, remez, rfft, ricker, rotate_sht, sht, sht_grid, spectral_centroid,
    spectral_flatness, sphere_div, sphere_grad, sphere_laplacian, stft, stockwell, swt, yin,
)
from .. import beat_track, parallel
from ..utils.numerics import resolve_device, to_host

ROUND_TRIP_MSE = 1e-10   # the C reference demo's bound


def _on(dev):
    return lambda a: torch.tensor(np.asarray(a), device=dev)


def demo_complex(sizes=(4, 8, 15, 20, 64, 13, 257, 360, 1024, 5040), *, device=None) -> dict:
    """Complex round trips: the reference demo's sizes {4, 8, 15, 20, 64}
    and the sizes that break the reference."""
    dev = resolve_device(device)
    print("== complex FFT round trips ==")
    out = {}
    for n in sizes:
        x = compat.generate_signal(n, device=dev)
        back = ifft(fft(x))
        out[n] = compat.compute_mse(back, x)
        print(f"  N={n:5d}: round-trip MSE {out[n]:.3e}  "
              f"[{'ok' if out[n] < ROUND_TRIP_MSE else 'FAIL'}]")
    assert all(v < ROUND_TRIP_MSE for v in out.values()), out
    return out


def demo_real(sizes=(4, 8, 16, 32, 64, 4096), *, device=None) -> dict:
    """Real transform round trips (the reference demo's second part)."""
    dev = resolve_device(device)
    print("== real FFT round trips ==")
    out = {}
    for n in sizes:
        x = compat.generate_real_signal(n, device=dev)
        back = irfft(rfft(x), n=n)
        out[n] = compat.compute_mse_real(back, x)
        print(f"  N={n:5d}: round-trip MSE {out[n]:.3e}  "
              f"[{'ok' if out[n] < ROUND_TRIP_MSE else 'FAIL'}]")
    assert all(v < ROUND_TRIP_MSE for v in out.values()), out
    return out


def demo_convolution(*, device=None) -> dict:
    print("== FFT convolution vs direct ==")
    on = _on(resolve_device(device))
    rng = np.random.default_rng(0)
    a, b = rng.standard_normal(100), rng.standard_normal(31)
    out = {}
    for mode in ("full", "same", "valid"):
        got = to_host(fft_convolve(on(a), on(b), mode=mode))
        out[mode] = float(np.max(np.abs(got - np.convolve(a, b, mode=mode))))
        print(f"  mode={mode:7s}: max err {out[mode]:.3e}")
    assert max(out.values()) < 1e-4, out
    return out


def demo_batched_and_grad(*, device=None) -> dict:
    print("== batched transform and gradient ==")
    on = _on(resolve_device(device))
    x = np.random.default_rng(1).standard_normal((32, 1024)).astype(np.float32)
    spec = rfft(on(x))
    print(f"  batched rfft: {x.shape} -> {tuple(spec.shape)}")
    v = on(x[0]).requires_grad_(True)
    fft(v).abs().sum().backward()
    finite = bool(torch.isfinite(v.grad).all())
    print(f"  grad through fft: shape {tuple(v.grad.shape)}, finite={finite}")
    assert tuple(spec.shape) == (32, 513) and finite
    return {"spec_shape": tuple(spec.shape), "grad": to_host(v.grad)}


def demo_sharded(*, device=None) -> dict:
    """The four-step FFT and the latitude-sharded SHT on a (1, ranks) mesh
    of the process group; a world of one when the process has none (started
    here and left at the end)."""
    import torch.distributed as dist

    dev = resolve_device(device)
    own = not dist.is_initialized()
    try:
        mesh = parallel.make_mesh((1, dist.get_world_size() if not own else 1), device=dev)
        ranks = mesh.size()
        x = np.random.default_rng(2).standard_normal(4096).astype(np.float32)
        got = to_host(parallel.distributed._full(parallel.fft_four_step(_on(dev)(x), mesh), mesh))
        want = np.fft.fft(x)
        err = float(np.max(np.abs(got - want)) / np.max(np.abs(want)))
        print(f"== sharded four-step over {ranks} rank(s): rel err {err:.3e} ==")
        L = 16
        f = np.random.default_rng(3).standard_normal((L, 2 * L)).astype(np.float32)
        a = to_host(parallel.distributed._full(parallel.sht_sharded(_on(dev)(f), mesh, "seq"),
                                               mesh))
        ref = to_host(sht(_on(dev)(f)))
        serr = float(np.max(np.abs(a - ref)) / max(1.0, np.abs(ref).max()))
        print(f"   latitude-sharded SHT: rel err {serr:.3e}")
    finally:
        if own and dist.is_initialized():
            dist.destroy_process_group()
    assert err < 1e-5 and serr < 1e-5, (err, serr)
    return {"ranks": ranks, "four_step_err": err, "sht_err": serr}


def demo_lapped_and_wavelets(*, device=None) -> dict:
    print("== MDCT (TDAC) and CWT ==")
    on = _on(resolve_device(device))
    x = np.random.default_rng(3).standard_normal(1000).astype(np.float32)
    back = to_host(imdct(mdct(on(x), 128), length=1000))
    err = float(np.max(np.abs(back - x)))
    print(f"  mdct/imdct perfect reconstruction: max err {err:.3e}")
    w = cwt(on(x[:256]), ricker, [2, 8, 32])
    print(f"  cwt scalogram: {tuple(w.shape)} (3 scales, one batched FFT convolution)")
    assert err < 1e-4 and tuple(w.shape) == (3, 256)
    return {"mdct_err": err, "cwt_shape": tuple(w.shape)}


def demo_nufft(*, device=None) -> dict:
    print("== non-uniform FFT ==")
    on = _on(resolve_device(device))
    rng = np.random.default_rng(4)
    m, n = 200, 64
    x = rng.uniform(0, 2 * np.pi, m).astype(np.float32)
    c = (rng.standard_normal(m) + 1j * rng.standard_normal(m)).astype(np.complex64)
    f = nufft1(on(x), on(c), n)
    k = np.arange(-(n // 2), (n + 1) // 2)
    want = np.exp(-1j * np.outer(k, x.astype(np.float64))) @ c.astype(np.complex128)
    rel = float(np.max(np.abs(to_host(f) - want)) / np.max(np.abs(want)))
    print(f"  type 1, {m} points -> {n} modes: rel err {rel:.3e}")
    back = nufft2(on(x), f)
    print(f"  type 2 back to points: shape {tuple(back.shape)}")
    assert rel < 1e-4 and tuple(back.shape) == (m,)
    return {"type1_err": rel}


def demo_sphere(*, device=None) -> dict:
    print("== spherical harmonics ==")
    on = _on(resolve_device(device))
    L = 16
    f = np.random.default_rng(5).standard_normal((L, 2 * L)).astype(np.float32)
    back = isht(sht(on(f))).real
    # analysis->synthesis projects onto the band-limited subspace: the
    # projection is idempotent
    twice = isht(sht(back)).real
    idem = float((twice - back).abs().max())
    print(f"  sht/isht projection idempotent: max err {idem:.3e}")
    ut, up = sphere_grad(back)
    div = sphere_div(ut, up)
    lap = sphere_laplacian(back)
    dl = float((div - lap).abs().max())
    print(f"  div(grad f) == laplacian f: max err {dl:.3e}")
    assert idem < 1e-4 and dl < 1e-2 * float(lap.abs().max()), (idem, dl)
    return {"idempotent_err": idem, "div_grad_err": dl}


def demo_chebyshev(*, device=None) -> dict:
    print("== Chebyshev spectral derivative (non-periodic) ==")
    on = _on(resolve_device(device))
    n = 64
    pts = cheb_points(n, dtype=np.float64)
    d = to_host(cheb_diff(on(np.exp(pts).astype(np.float32))))
    rel = float(np.max(np.abs(d - np.exp(pts))) / np.e)
    print(f"  d/dx exp(x) on {n} Gauss-Lobatto points: rel err {rel:.3e}")
    assert rel < 1e-3
    return {"err": rel}


def demo_dwt_denoise(*, device=None) -> dict:
    """Biorthogonal stationary-wavelet soft-threshold denoising and a
    symmetric-mode DWT round trip."""
    print("== wavelet denoising (bior4.4 swt, symmetric dwt) ==")
    on = _on(resolve_device(device))
    rng = np.random.default_rng(0)
    t = np.linspace(0, 1, 256, endpoint=False)
    clean = np.sin(2 * np.pi * 5 * t) + 0.5 * np.sign(np.sin(2 * np.pi * 2 * t))
    noisy = (clean + 0.3 * rng.standard_normal(256)).astype(np.float32)
    coeffs = swt(on(noisy), "bior4.4", level=3)
    thr = 3 * 0.3 / np.sqrt(2)
    den = [(a, torch.sign(d) * torch.clamp(d.abs() - thr, min=0)) for a, d in coeffs]
    rec = to_host(iswt(den, "bior4.4"))
    snr_in = float(10 * np.log10(np.mean(clean ** 2) / np.mean((noisy - clean) ** 2)))
    snr_out = float(10 * np.log10(np.mean(clean ** 2) / np.mean((rec - clean) ** 2)))
    print(f"  swt soft-threshold: SNR {snr_in:.1f} dB -> {snr_out:.1f} dB")
    a, d = dwt(on(noisy), "db4", "symmetric")
    back = to_host(idwt(a, d, "db4", "symmetric"))[:256]
    err = float(np.max(np.abs(back - noisy)))
    print(f"  symmetric-mode dwt round trip: max err {err:.3e}")
    assert snr_out > snr_in and err < 1e-4
    return {"snr_in": snr_in, "snr_out": snr_out, "dwt_err": err}


def demo_dtcwt_frft(*, device=None) -> dict:
    """Dual-tree complex wavelets (shift-invariant magnitudes) and the
    fractional Fourier transform (a chirp compressed at its matched order)."""
    print("== dual-tree complex wavelets and fractional Fourier ==")
    on = _on(resolve_device(device))
    x = np.zeros(256, np.float32)
    x[100] = 1.0
    _, y1 = dtcwt(on(x), levels=3)
    _, y2 = dtcwt(on(np.roll(x, 1)), levels=3)
    e1 = float((y1[0].abs() ** 2).sum())
    e2 = float((y2[0].abs() ** 2).sum())
    ratio = min(e1, e2) / max(e1, e2)
    print(f"  dtcwt level-1 energy under 1-sample shift: ratio {ratio:.6f} (plain DWT scrambles)")
    # a linear chirp concentrates under the FrFT order matching its sweep:
    # phase pi*r*u^2 rotates to a spike at alpha = arccot(-r)
    n = 256
    u = (np.arange(n) - n // 2) / np.sqrt(n)
    sig = (np.exp(-np.pi * (u / 3) ** 2) * np.cos(np.pi * 1.0 * u * u)).astype(np.float32)
    conc = []
    for order in (1.0, 1.5):
        y = frft(on(sig), order).abs()
        conc.append(float(y.max() / torch.linalg.norm(y)))
    print(f"  chirp peak concentration |F_a x|: a=1.0 {conc[0]:.3f} vs matched a=1.5 {conc[1]:.3f}")
    assert ratio > 0.9 and conc[1] > conc[0]
    return {"shift_energy_ratio": ratio, "concentration": conc}


def demo_estimation_rotation(*, device=None) -> dict:
    """Constant-Q analysis, the multitaper PSD of a noisy tone, Lomb-Scargle
    on irregular samples, and the Wigner-D rotation moving a spherical bump
    to a prescribed centre."""
    print("== spectral estimation + rotation ==")
    on = _on(resolve_device(device))
    rng = np.random.default_rng(7)
    fs = 8000.0
    freqs = cqt_frequencies(48, 55.0, 12)
    tone = np.cos(2 * np.pi * freqs[30] * np.arange(8192) / fs).astype(np.float32)
    C = to_host(cqt(on(tone), fs=fs, fmin=55.0, n_bins=48, hop=512))
    band = int(np.abs(C[C.shape[0] // 2]).argmax())
    print(f"  cqt: {freqs[30]:.1f} Hz tone peaks at band {band} (expect 30)")
    n = 2048
    x = np.sin(2 * np.pi * 12.5 * np.arange(n) / 100.0) + rng.standard_normal(n)
    f, P = multitaper(on(x.astype(np.float32)), fs=100.0, nw=4.0)
    f, P = to_host(f), to_host(P)
    mt_peak = float(f[P.argmax()])
    print(f"  multitaper: noisy 12.5 Hz tone -> PSD peak at {mt_peak:.2f} Hz")
    t = np.sort(rng.uniform(0, 20, 300))
    y = np.sin(3.3 * t) + 0.3 * rng.standard_normal(t.size)
    w = np.linspace(0.5, 10, 256)
    pg = to_host(lombscargle(on(t.astype(np.float32)), on(y.astype(np.float32)),
                             on(w.astype(np.float32))))
    ls_peak = float(w[pg.argmax()])
    print(f"  lombscargle: irregular 3.3 rad/s tone -> peak at {ls_peak:.2f} rad/s")
    L = 24
    zon = np.zeros((2 * L - 1, L), np.complex64)
    zon[0, :] = np.exp(-0.05 * np.arange(L) * (np.arange(L) + 1))  # smooth bump at the pole
    beta, alpha = 1.1, 0.7
    fgrid = to_host(isht(rotate_sht(on(zon), alpha, beta, 0.0).to(torch.complex64)).real)
    theta, phi, _ = sht_grid(L - 1)
    i, j = np.unravel_index(np.argmax(fgrid), fgrid.shape)
    centre = (float(theta[i]), float(phi[j]))
    print(f"  rotate_sht: polar bump moved to (theta, phi) = ({centre[0]:.2f}, {centre[1]:.2f})"
          f" — prescribed ({beta:.2f}, {alpha:.2f})")
    assert band == 30 and abs(mt_peak - 12.5) < 0.1 and abs(ls_peak - 3.3) < 0.1
    assert abs(centre[0] - beta) < 0.1 and abs(centre[1] - alpha) < 0.15
    return {"cqt_band": band, "multitaper_peak": mt_peak, "lombscargle_peak": ls_peak,
            "rotated_centre": centre}


def demo_audio_toolbox(*, device=None) -> dict:
    """Generators, vocoder, separation, pitch, features, S-transform and
    equiripple design."""
    print("audio toolbox:")
    dev = resolve_device(device)
    on = _on(dev)
    fs = 8000.0
    t = np.arange(16384) / fs
    x = to_host(chirp(on(t), 200.0, t[-1], 1200.0))  # swept tone, float64 phases
    S, _ = stockwell(on(x[:1024]))
    s_err = float(np.max(np.abs(to_host(istockwell(S)) - x[:1024])))
    print(f"  stockwell: lossless inverse err {s_err:.2e}")
    y = pitch_shift(on(x), fs, 12.0, nperseg=1024)
    f_in = to_host(yin(on(x), 100, 3000, fs, frame_length=1024))
    f_out = to_host(yin(y, 100, 3500, fs, frame_length=1024))
    mid = slice(len(f_in) // 3, 2 * len(f_in) // 3)
    ratio = float(np.median(f_out[mid] / f_in[mid]))
    print(f"  pitch_shift +12 semitones: yin ratio {ratio:.3f} (expect 2.0)")
    mix = np.sin(2 * np.pi * 440 * t).astype(np.float32)
    mix[1000::2000] += 2.5
    Sm = stft(on(mix), nperseg=512, noverlap=384)
    H, P = hpss(Sm, kernel_size=17)
    eh = float((H.abs() ** 2).sum())
    ep = float((P.abs() ** 2).sum())
    print(f"  hpss: tone+clicks split, harmonic/percussive energy "
          f"{eh / (eh + ep):.2f}/{ep / (eh + ep):.2f}")
    cen = float(np.median(to_host(spectral_centroid(on(mix), fs, nperseg=1024))))
    flat = float(np.median(to_host(spectral_flatness(on(mix), nperseg=1024))))
    print(f"  features: centroid {cen:.0f} Hz, flatness {flat:.1e} (tone-dominated)")
    b = remez(73, [0, 0.18, 0.24, 0.5], [1, 0])
    w, h = freqz(b.astype(np.float32), worN=512, device=dev)
    w, h = to_host(w), to_host(h)
    stop_db = float(20 * np.log10(np.max(np.abs(h[w >= 0.49 * np.pi]))))
    print(f"  remez 73-tap lowpass: stopband {stop_db:.0f} dB")
    E, fg = reassigned_spectrogram(on(mix[:4096]), nperseg=256)
    E, fg = to_host(E), to_host(fg)
    ridge = float(fg[int(np.argmax(E[E.shape[0] // 2]))] * fs)
    print(f"  reassigned spectrogram: tone ridge at {ridge:.0f} Hz (expect 440)")
    assert s_err < 1e-3 and abs(ratio - 2.0) < 0.1 and eh > ep and stop_db < -30
    assert abs(ridge - 440.0) < 50
    return {"stockwell_err": s_err, "pitch_ratio": ratio, "harmonic_share": eh / (eh + ep),
            "centroid": cen, "flatness": flat, "stopband_db": stop_db, "ridge_hz": ridge}


def demo_mir_tomo(*, device=None, seconds: float = 4.0) -> dict:
    """Beat tracking, chroma, pYIN, and filtered backprojection."""
    print("MIR + tomography:")
    on = _on(resolve_device(device))
    sr, hop = 22050.0, 512
    t = np.arange(int(22050 * seconds)) / sr
    x = np.zeros(t.size, np.float32)
    x[:: int(0.5 * sr)] = 1.0  # 120 BPM clicks
    x += 0.3 * to_host(chirp(on(t), 200.0, t[-1], 400.0))
    bpm, beats = beat_track(on(x), sr, hop=hop)
    bpm = float(to_host(bpm))
    n_beats = int(to_host(beats).sum())
    print(f"  beat_track: {bpm:.1f} BPM, {n_beats} beats on a 120 BPM click bed")
    tri = sum(np.sin(2 * np.pi * f * t) for f in (261.63, 329.63, 392.0))
    C = to_host(chroma_stft(on(tri.astype(np.float32)), sr, nperseg=4096))
    names = np.array(list("C.D.EF.G.A.B"))
    top = sorted(int(i) for i in np.argsort(C[4:-4].mean(0))[-3:])
    print(f"  chroma: C-major triad lights {'/'.join(names[top])} (bins {top})")
    melody = np.sin(2 * np.pi * 220.0 * t[:44100]).astype(np.float32)
    f0, voiced, _ = pyin(on(melody), 110.0, 880.0, sr)
    f0m = float(np.nanmedian(to_host(f0)))
    voiced_share = float(to_host(voiced).mean())
    print(f"  pyin: 220 Hz tone tracked at {f0m:.1f} Hz, {voiced_share:.0%} voiced")
    n = 96
    yy, xx = np.mgrid[:n, :n].astype(np.float64) - n // 2
    phantom = (((xx - 8) ** 2 + (yy + 5) ** 2) <= 15 ** 2).astype(np.float32)
    theta = np.linspace(0, np.pi, 90, endpoint=False)
    rec = to_host(iradon(radon(on(phantom), theta), theta, filter_name="hann"))
    corr = float(np.corrcoef(rec.ravel(), phantom.ravel())[0, 1])
    print(f"  radon/iradon: 90-view FBP of a disk phantom, corr {corr:.3f}")
    assert abs(bpm - 120.0) < 5 and top == [0, 4, 7] and abs(f0m - 220.0) < 2 and corr > 0.9
    return {"bpm": bpm, "beats": n_beats, "chroma_top": top, "pyin_f0": f0m,
            "voiced": voiced_share, "fbp_corr": corr}


SECTIONS = (demo_complex, demo_real, demo_convolution, demo_batched_and_grad,
            demo_lapped_and_wavelets, demo_nufft, demo_sphere, demo_chebyshev,
            demo_dwt_denoise, demo_dtcwt_frft, demo_estimation_rotation, demo_audio_toolbox,
            demo_mir_tomo, demo_sharded)


def main(*, device=None) -> dict:
    return {section.__name__: section(device=device) for section in SECTIONS}


if __name__ == "__main__":
    main()
