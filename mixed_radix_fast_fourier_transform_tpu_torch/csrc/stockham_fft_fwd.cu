// The forward (sign -1) instantiations of the fused Stockham FFT kernel.

#include "stockham_fft.cuh"

namespace spectral {

template cudaError_t launch_sign<-1>(const float*, const float*, float*, float*,
                                   int, const Params&, cudaStream_t);

}  // namespace spectral
