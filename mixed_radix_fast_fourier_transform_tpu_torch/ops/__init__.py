"""Transform ops: complex/real FFT, convolution, the stage pipeline and the
fused Stockham kernel."""

from .fft import fft, ifft, fft2, ifft2, fftn, ifftn
from .rfft import rfft, irfft, rfftn, irfftn
from .convolve import fft_convolve
from .stockham import exec_bluestein, exec_complex, exec_mixed_radix
