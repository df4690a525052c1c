// The forward (sign -1) instantiations of the fused Stockham FFT kernel on
// bf16 planes.

#include "stockham_fft.cuh"

namespace spectral {

SPECTRAL_LAUNCH_SIGN(__nv_bfloat16, -1);

}  // namespace spectral
