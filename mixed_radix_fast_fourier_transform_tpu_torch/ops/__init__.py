"""Transform ops: complex/real FFT, convolution, the short-time, cosine,
Chebyshev, Hankel, chirp-z and fractional transforms, the signal-analysis,
wavelet, auditory and mel families, IIR filters, LTI systems, splines, the
Kalman filter, time-frequency representations, scattering, the constant-Q
transform and audio features, the stage pipeline and the fused Stockham
kernel."""

from .fft import (
    fft, ifft, fft2, ifft2, fftn, ifftn,
    fftfreq, rfftfreq, fftshift, ifftshift, dht, idht,
)
from .rfft import (
    rfft, irfft, rfftn, irfftn, rfft2, irfft2,
    hfft, ihfft, hfftn, ihfftn, hfft2, ihfft2,
)
from .convolve import (
    fft_convolve, fft_convolve2, fft_convolven, fft_correlate, fft_oaconvolve,
    correlate, fftconvolve, oaconvolve, convolve2d, correlate2d,
    choose_conv_method,
)
# ``convolve`` the function stays out of this namespace, where it would hide
# the module of the same name; it is exported by the package itself.
from .stockham import exec_bluestein, exec_complex, exec_mixed_radix
# The modules added after these (stft, dct, mdct, chebyshev, fht, czt, frft,
# windows, cwt, ...) share their names with their main functions, which the
# package itself exports; here they stay modules.
from . import (
    auditory, chebyshev, cqt, cwt, czt, dct, feature, fht, frft, hos, iir, kalman, lticlasses,
    ltisys, mdct, mel, scattering, shorttime, signal, splines, stft, tfr, windows,
)
