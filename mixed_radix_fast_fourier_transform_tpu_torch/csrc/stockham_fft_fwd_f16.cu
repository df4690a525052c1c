// The forward (sign -1) instantiations of the fused Stockham FFT kernel on
// fp16 planes.

#include "stockham_fft.cuh"

namespace spectral {

SPECTRAL_LAUNCH_SIGN(__half, -1);

}  // namespace spectral
