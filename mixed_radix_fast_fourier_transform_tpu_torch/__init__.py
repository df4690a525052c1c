"""mixed_radix_fast_fourier_transform_tpu_torch — the spectral library on PyTorch and CUDA.

A port of ``mixed_radix_fast_fourier_transform_tpu`` (JAX) that imports
``torch`` and numpy and never ``jax``.  Module paths and public names mirror
the JAX package.  Functions take tensors and compute on the tensor's own
device; data that is no tensor yet (numpy arrays, lists) and data the
library creates go to the card unless a ``device`` is given.  On an NVIDIA
GPU the fused Stockham FFT kernel (``csrc/``, built with ``nvcc`` at first
use) carries every length it supports, forward and backward, and the
plan-based stage pipeline carries the rest.

Public API (numpy.fft-flavoured):
    fft, ifft, fft2, ifft2, fftn, ifftn, dht, idht
    rfft, irfft, rfftn, irfftn, rfft2, irfft2, hfft, ihfft, hfftn, ihfftn,
    hfft2, ihfft2
    fftfreq, rfftfreq, fftshift, ifftshift
    fft_convolve, fft_correlate, fft_oaconvolve, fft_convolve2, fft_convolven,
    convolve, correlate, fftconvolve, oaconvolve, convolve2d, correlate2d,
    choose_conv_method
    stft, istft, spectrogram, griffinlim, phase_vocoder, time_stretch,
    pitch_shift, get_window, dpss, windows
    ShortTimeFFT, check_COLA, check_NOLA, closest_STFT_dual_window
    hilbert, hilbert2, periodogram, welch, csd, coherence, tfestimate, multitaper,
    lombscargle, goertzel, envelope, rceps, cceps, icceps, minimum_phase, detrend,
    spectral_diff, poisson_solve, thd, sinad, sfdr, enob, vectorstrength,
    correlation_lags, firwin, firwin2, firls, remez, kaiser_atten, kaiser_beta,
    kaiserord, savgol_coeffs, savgol_filter, firwin_2d, gammatone, max_len_seq,
    freqz, group_delay, deconvolve, upfirdn, resample_poly, resample, decimate
    bispectrum, bicoherence, cwt, ricker, morlet2, cwt_tc, tc_scales, xwt, wct
    erb_space, gammatone_filterbank, gammatonegram, modulation_spectrum
    mel_filterbank, mel_frequencies, hz_to_mel, mel_to_hz, melspectrogram, mfcc,
    mfcc_to_mel, mfcc_to_audio, mel_to_stft, mel_to_audio, hpss, yin, pyin, pcen,
    A_weighting
    dct, idct, dctn, idctn, dst, idst, dstn, idstn, mdct, imdct, mdct_window
    cheb_points, cheb_transform, icheb_transform, cheb_diff_coef, cheb_diff,
    cheb_eval
    fht, ifht, fhtoffset, fwht, ifwht, czt, zoom_fft, czt_points, CZT, ZoomFFT,
    frft, ifrft, frft2
    cqt, icqt, chroma_cqt, wigner_ville, ssq_cwt, ssq_stft, stockwell,
    reassigned_spectrogram, scattering1d, scattering2d, spectral and rhythm
    features (onset_strength, tempo, beat_track, decompose, ...)
    IIR design and filtering (butter, ..., lfilter, sosfilt, filtfilt,
    sosfiltfilt), LTI systems (lti, dlti, dlsim, lsim, ...), B-splines
    (cspline1d, ...), kalman_filter, kalman_smoother
    non-uniform FFTs (nudft1/2, nufft1/2/3 in 1-D, 2-D and 3-D, nufft_lsq*),
    radon, iradon
    spherical harmonics (sht, isht, sht_grid, sht_recurrence, isht_recurrence,
    sphere_laplacian, poisson_solve_sphere, sphere_convolve, sphere_grad,
    sphere_div, sphere_vort, sphere_helmholtz, vsht, ivsht, rotate_sht)
    the radar and radio front end (chirp and the other waveforms,
    pulse_compression, range_doppler, cfar, pfb_analysis, pfb_synthesis,
    steering_vector, spatial_covariance, bartlett_spectrum, mvdr_spectrum,
    mvdr_weights, music_doa, corr_matrix, music, root_music, esprit, prony,
    pisarenko, find_peaks and the peak family, medfilt, medfilt2d,
    order_filter)
    wavelets and decompositions (dwt, idwt, wavedec, waverec and the 2-D,
    stationary and packet transforms, wavelet_denoise, cycle_spin, dtcwt,
    idtcwt, dtcwt2, idtcwt2, ewt, emd, eemd, hilbert_huang, vmd)
    images (phase_cross_correlation, fourier_shift, unwrap_phase_2d,
    fourier_gaussian, fourier_uniform, fourier_ellipsoid, wiener), adaptive
    filters (lms_filter, nlms_filter, rls_filter), AR estimation (levinson,
    aryule, arburg, ar_psd), ssa, dmd, dmd_reconstruct
    plan-level: get_plan, build_complex_plan, build_real_plan, clear_plan_cache
    models: init_params, apply, loss_fn, train_step, params_from_jax,
    SpectralFilter, models.fno, models.s4d, models.fnet, models.afno,
    models.koopman, models.audio_frontend, models.sfno, models.save_checkpoint, models.load_checkpoint

Reference-compatible API (plan objects, unnormalized inverse, C-style names):
    from mixed_radix_fast_fourier_transform_tpu_torch import compat
"""

from .ops.fft import (
    fft,
    ifft,
    fft2,
    ifft2,
    fftn,
    ifftn,
    fftfreq,
    rfftfreq,
    fftshift,
    ifftshift,
    dht,
    idht,
)
from .ops.rfft import rfft, irfft, rfftn, irfftn, rfft2, irfft2, hfft, ihfft
from .ops.rfft import hfft2, ihfft2, hfftn, ihfftn
from .ops.convolve import fft_convolve, fft_convolve2, fft_convolven, fft_correlate, fft_oaconvolve
from .ops.convolve import convolve, correlate, fftconvolve, oaconvolve, convolve2d, correlate2d
from .ops.convolve import choose_conv_method
from .ops.stft import (
    stft, istft, spectrogram, get_window, dpss, griffinlim, phase_vocoder, time_stretch,
    pitch_shift,
)
from .ops.dct import dct, idct, dst, idst, dctn, idctn, dstn, idstn
from .ops.mdct import mdct, imdct, mdct_window
from .ops.chebyshev import (
    cheb_diff,
    cheb_diff_coef,
    cheb_eval,
    cheb_points,
    cheb_transform,
    icheb_transform,
)
from .ops.fht import fht, ifht, fhtoffset, fwht, ifwht
from .ops.czt import czt, zoom_fft, czt_points, CZT, ZoomFFT
from .ops.frft import frft, frft2, ifrft
from .ops import windows
from .ops.mel import (
    mel_filterbank, mel_frequencies, melspectrogram, mfcc, hz_to_mel, mel_to_hz, mel_to_stft,
    mel_to_audio, hpss, yin, pyin, pcen, A_weighting, mfcc_to_mel, mfcc_to_audio,
)
from .ops.hos import bispectrum, bicoherence
from .ops.auditory import erb_space, gammatone_filterbank, gammatonegram, modulation_spectrum
from .ops.cwt import cwt, ricker, morlet2, cwt_tc, tc_scales, xwt, wct
from .ops.shorttime import ShortTimeFFT, check_COLA, check_NOLA, closest_STFT_dual_window
from .ops.signal import (
    hilbert, periodogram, welch, csd, coherence, tfestimate, spectral_diff, poisson_solve,
    resample, resample_poly, upfirdn, lombscargle, multitaper, rceps, cceps, icceps,
    minimum_phase, firwin, freqz, kaiser_atten, kaiser_beta, hilbert2, remez, detrend,
    decimate, savgol_coeffs, savgol_filter, group_delay, deconvolve, goertzel,
    thd, sinad, sfdr, enob, kaiserord, firwin2, firls, gammatone, max_len_seq,
    correlation_lags, vectorstrength, envelope, firwin_2d,
)
from .ops.cqt import cqt, cqt_frequencies, icqt
from .ops.tfr import (
    wigner_ville, ssq_cwt, ssq_stft, issq_cwt, issq_stft,
    reassigned_spectrogram, stockwell, istockwell, ambiguity,
    cohen_class, choi_williams, xwigner_ville,
)
from .ops.scattering import scattering1d, scattering2d
from .ops.feature import (
    spectral_centroid, spectral_bandwidth, spectral_rolloff,
    spectral_flatness, spectral_contrast, zero_crossing_rate, rms,
    specaugment, chroma_filterbank, chroma_stft, onset_strength, tempo,
    delta, beat_track, decompose, trim, split, mu_law_encode, mu_law_decode,
    power_to_db, db_to_power, amplitude_to_db, db_to_amplitude,
    chroma_cqt, tonnetz, gcc_phat, lpc,
)
from .ops.iir import (
    butter, cheby1, cheby2, ellip, bessel, iirfilter,
    buttap, cheb1ap, cheb2ap, ellipap, besselap,
    buttord, cheb1ord, cheb2ord, ellipord,
    iirnotch, iirpeak, iircomb,
    bilinear_zpk, lp2lp_zpk, lp2hp_zpk, lp2bp_zpk, lp2bs_zpk,
    zpk2tf, tf2zpk, zpk2sos, sos2zpk, tf2sos, sos2tf,
    lfilter, sosfilt, filtfilt, sosfiltfilt, lfilter_zi, sosfilt_zi,
    freqs, freqs_zpk, sosfreqz,
    normalize, bilinear, lp2lp, lp2hp, lp2bp, lp2bs,
    freqz_zpk, freqz_sos, iirdesign, lfiltic, findfreqs,
    unique_roots, residue, residuez, invres, invresz, BadCoefficients,
    band_stop_obj,
)
from .ops.lticlasses import (
    lti, dlti, TransferFunction, ZerosPolesGain, StateSpace, place_poles,
)
from .ops.kalman import kalman_filter, kalman_smoother
from .ops.splines import (
    gauss_spline, cspline1d, qspline1d, cspline1d_eval, qspline1d_eval,
    cspline2d, qspline2d, symiirorder1, symiirorder2, sepfir2d, spline_filter,
)
from .ops.ltisys import (
    tf2ss, ss2tf, zpk2ss, ss2zpk, abcd_normalize, cont2discrete,
    dlsim, dstep, dimpulse, dfreqresp, dbode,
    lsim, step, impulse, freqresp, bode,
)
from .ops.nufft import (
    nudft1, nudft2, nudft1_2d, nudft2_2d, nudft1_3d, nudft2_3d,
    nufft1, nufft2, nufft3, nufft1_2d, nufft2_2d, nufft3_2d, nufft1_3d, nufft2_3d, nufft3_3d,
    nufft_lsq, nufft_lsq_2d, nufft_lsq_3d,
)
from .ops.tomo import radon, iradon
from .ops.sht import (
    sht, isht, sht_grid, sht_recurrence, isht_recurrence, sphere_laplacian,
    poisson_solve_sphere, sphere_convolve, sphere_grad, sphere_div, sphere_vort,
    sphere_helmholtz, vsht, ivsht, rotate_sht,
)
from .ops.register import phase_cross_correlation, fourier_shift, unwrap_phase_2d
from .ops.ndimage import fourier_gaussian, fourier_uniform, fourier_ellipsoid, wiener
from .ops.radar import pulse_compression, range_doppler, cfar
from .ops.beamform import (
    steering_vector, spatial_covariance, bartlett_spectrum,
    mvdr_spectrum, mvdr_weights, music_doa,
)
from .ops.waveforms import chirp, sweep_poly, gausspulse, sawtooth, square, unit_impulse
from .ops.emd import emd, eemd, hilbert_huang
from .ops.vmd import vmd
from .ops.ewt import ewt, ewt_boundaries
from .ops.dwt import wavelet_denoise, wavelet_denoise2, cycle_spin
from .ops.subspace import corr_matrix, music, root_music, esprit, prony, pisarenko
from .ops.datadriven import ssa, dmd, dmd_reconstruct
from .ops.adaptive import lms_filter, nlms_filter, rls_filter
from .ops.ar import levinson, aryule, arburg, ar_psd
from .ops.peaks import (
    find_peaks, find_peaks_cwt, peak_prominences, peak_widths,
    argrelmin, argrelmax, argrelextrema,
    medfilt, medfilt2d, order_filter,
)
from .ops.pfb import pfb_analysis, pfb_synthesis, pfb_prototype, pfb_frequencies
from .ops.dwt import (dwt, dwt2, dwt_max_level, idwt, idwt2, iswt, iswt2,
                      swt, swt2, wavedec, wavedec2, waverec, waverec2,
                      wpdec, wprec, wpdec2, wprec2)
from .ops.dtcwt import dtcwt, dtcwt2, idtcwt, idtcwt2
from .plan import (
    BluesteinPlan,
    ComplexPlan,
    MixedRadixPlan,
    RaderPlan,
    RealPlan,
    build_bluestein_plan,
    build_complex_plan,
    build_mixed_radix_plan,
    build_rader_plan,
    build_real_plan,
    clear_plan_cache,
    get_plan,
)
from .utils.config import DEFAULT_CONFIG, SpectralConfig
from .utils.factorize import (
    dividebyN,
    next_fast_len,
    next_pow2,
    plan_stages,
    prev_fast_len,
    prime_factors,
)
from . import compat, models, ops, utils

__all__ = [
    "fft", "ifft", "fft2", "ifft2", "fftn", "ifftn",
    "rfft", "rfft2", "irfft2", "hfft", "ihfft", "irfft", "rfftn", "irfftn",
    "hfft2", "ihfft2", "hfftn", "ihfftn",
    "fft_convolve", "fft_convolve2", "fft_convolven", "fft_correlate", "fft_oaconvolve",
    "convolve", "correlate", "fftconvolve", "oaconvolve", "convolve2d", "correlate2d",
    "choose_conv_method",
    "stft", "istft", "spectrogram", "get_window", "dpss", "griffinlim", "phase_vocoder",
    "time_stretch", "pitch_shift", "windows",
    "mel_filterbank", "mel_frequencies", "melspectrogram", "mfcc", "hz_to_mel", "mel_to_hz",
    "mel_to_stft", "mel_to_audio", "hpss", "yin", "pyin", "pcen", "A_weighting", "mfcc_to_mel",
    "mfcc_to_audio", "bispectrum", "bicoherence", "erb_space", "gammatone_filterbank",
    "gammatonegram", "modulation_spectrum", "cwt", "ricker", "morlet2", "cwt_tc", "tc_scales",
    "xwt", "wct",
    "ShortTimeFFT", "check_COLA", "check_NOLA", "closest_STFT_dual_window",
    "hilbert", "periodogram", "welch", "csd", "coherence", "tfestimate", "spectral_diff",
    "poisson_solve", "resample", "resample_poly", "upfirdn", "lombscargle", "multitaper",
    "rceps", "cceps", "icceps", "minimum_phase", "firwin", "freqz", "kaiser_atten",
    "kaiser_beta", "hilbert2", "remez", "detrend", "decimate", "savgol_coeffs",
    "savgol_filter", "group_delay", "deconvolve", "goertzel", "thd", "sinad", "sfdr", "enob",
    "kaiserord", "firwin2", "firls", "gammatone", "max_len_seq", "correlation_lags",
    "vectorstrength", "envelope", "firwin_2d",
    "dct", "idct", "dst", "idst", "dctn", "idctn", "dstn", "idstn",
    "mdct", "imdct", "mdct_window",
    "cheb_points", "cheb_transform", "icheb_transform", "cheb_diff_coef", "cheb_diff",
    "cheb_eval",
    "fht", "ifht", "fhtoffset", "fwht", "ifwht",
    "czt", "zoom_fft", "czt_points", "CZT", "ZoomFFT", "frft", "ifrft", "frft2",
    "fftfreq", "rfftfreq", "fftshift", "ifftshift", "prev_fast_len", "dht", "idht",
    "cqt", "cqt_frequencies", "icqt",
    "wigner_ville", "ssq_cwt", "ssq_stft", "issq_cwt", "issq_stft", "reassigned_spectrogram",
    "stockwell", "istockwell", "ambiguity", "cohen_class", "choi_williams", "xwigner_ville",
    "scattering1d", "scattering2d",
    "spectral_centroid", "spectral_bandwidth", "spectral_rolloff", "spectral_flatness",
    "spectral_contrast", "zero_crossing_rate", "rms", "specaugment", "chroma_filterbank",
    "chroma_stft", "onset_strength", "tempo", "delta", "beat_track", "decompose", "trim",
    "split", "mu_law_encode", "mu_law_decode", "power_to_db", "db_to_power",
    "amplitude_to_db", "db_to_amplitude", "chroma_cqt", "tonnetz", "gcc_phat", "lpc",
    "butter", "cheby1", "cheby2", "ellip", "bessel", "iirfilter",
    "buttap", "cheb1ap", "cheb2ap", "ellipap", "besselap",
    "buttord", "cheb1ord", "cheb2ord", "ellipord", "iirnotch", "iirpeak", "iircomb",
    "bilinear_zpk", "lp2lp_zpk", "lp2hp_zpk", "lp2bp_zpk", "lp2bs_zpk",
    "zpk2tf", "tf2zpk", "zpk2sos", "sos2zpk", "tf2sos", "sos2tf",
    "lfilter", "sosfilt", "filtfilt", "sosfiltfilt", "lfilter_zi", "sosfilt_zi",
    "freqs", "freqs_zpk", "sosfreqz", "normalize", "bilinear", "lp2lp", "lp2hp", "lp2bp",
    "lp2bs", "freqz_zpk", "freqz_sos", "iirdesign", "lfiltic", "findfreqs", "unique_roots",
    "residue", "residuez", "invres", "invresz", "BadCoefficients", "band_stop_obj",
    "lti", "dlti", "TransferFunction", "ZerosPolesGain", "StateSpace", "place_poles",
    "kalman_filter", "kalman_smoother",
    "gauss_spline", "cspline1d", "qspline1d", "cspline1d_eval", "qspline1d_eval",
    "cspline2d", "qspline2d", "symiirorder1", "symiirorder2", "sepfir2d", "spline_filter",
    "tf2ss", "ss2tf", "zpk2ss", "ss2zpk", "abcd_normalize", "cont2discrete",
    "dlsim", "dstep", "dimpulse", "dfreqresp", "dbode", "lsim", "step", "impulse",
    "freqresp", "bode",
    "nudft1", "nudft2", "nudft1_2d", "nudft2_2d", "nudft1_3d", "nudft2_3d",
    "nufft1", "nufft2", "nufft3", "nufft1_2d", "nufft2_2d", "nufft3_2d", "nufft1_3d",
    "nufft2_3d", "nufft3_3d", "nufft_lsq", "nufft_lsq_2d", "nufft_lsq_3d", "radon", "iradon",
    "sht", "isht", "sht_grid", "sht_recurrence", "isht_recurrence", "sphere_laplacian",
    "poisson_solve_sphere", "sphere_convolve", "sphere_grad", "sphere_div", "sphere_vort",
    "sphere_helmholtz", "vsht", "ivsht", "rotate_sht",
    "chirp", "sweep_poly", "gausspulse", "sawtooth", "square", "unit_impulse",
    "phase_cross_correlation", "fourier_shift", "unwrap_phase_2d",
    "fourier_gaussian", "fourier_uniform", "fourier_ellipsoid", "wiener",
    "pulse_compression", "range_doppler", "cfar",
    "steering_vector", "spatial_covariance", "bartlett_spectrum", "mvdr_spectrum",
    "mvdr_weights", "music_doa",
    "pfb_analysis", "pfb_synthesis", "pfb_prototype", "pfb_frequencies",
    "dwt", "idwt", "dwt2", "idwt2", "wavedec", "waverec", "wavedec2", "waverec2",
    "swt", "iswt", "swt2", "iswt2", "wpdec", "wprec", "wpdec2", "wprec2", "dwt_max_level",
    "dtcwt", "idtcwt", "dtcwt2", "idtcwt2",
    "emd", "eemd", "hilbert_huang", "vmd", "ewt", "ewt_boundaries",
    "wavelet_denoise", "wavelet_denoise2", "cycle_spin",
    "corr_matrix", "music", "root_music", "esprit", "prony", "pisarenko",
    "ssa", "dmd", "dmd_reconstruct", "lms_filter", "nlms_filter", "rls_filter",
    "levinson", "aryule", "arburg", "ar_psd",
    "find_peaks", "find_peaks_cwt", "peak_prominences", "peak_widths",
    "argrelmin", "argrelmax", "argrelextrema", "medfilt", "medfilt2d", "order_filter",
    "BluesteinPlan", "ComplexPlan", "MixedRadixPlan", "RaderPlan", "RealPlan",
    "build_bluestein_plan", "build_complex_plan", "build_mixed_radix_plan",
    "build_rader_plan", "build_real_plan", "clear_plan_cache", "get_plan",
    "DEFAULT_CONFIG", "SpectralConfig",
    "prime_factors", "plan_stages", "dividebyN", "next_pow2", "next_fast_len",
    "compat", "models", "ops", "utils",
]
