// Fused Stockham FFT for Hopper (sm_90a): all radix stages of one transform
// row in one thread block, resident in shared memory.
//
// Replaces mixed_radix_fast_fourier_transform_tpu/ops/pallas_fft.py::_kernel
// (the fused Pallas kernel).  It computes the same thing: an unnormalized
// batched complex FFT over the last axis, sign +-1, on separate fp32 (re, im)
// planes, running every stage of kernel_factors(n) (radix 8/4/2 for the
// power of two, then 7/5/3) as a Stockham autosort
//
//     X: (f, m', l)  ->  Y[q', k, j] = sum_p W_f[k, p] * T[p, j] * X[p, q', j]
//     (m = f * m', l *= f each stage, T[p, j] = e^(sign*2*pi*i*p*j/(f*l)))
//
// What bounds it on this card: device-memory bytes.  A length-n transform
// does about 5*n*log2(n) flops against 16*n bytes (one fp32 read and one
// write of each plane): 5*log2(n)/16, about 4 flops per byte at n = 8192,
// where the H100's fp32 units (67 TFLOP/s against 3.35 TB/s) would need
// about 20 to be the limit.  What the design does
// about that bound: every stage runs in shared memory, ping-ponging between
// two plane pairs (16*n bytes per row), so device memory sees exactly one
// read and one write per plane however many stages the length has.  The
// stage pipeline (ops/stockham.py) instead reads and writes device memory
// once per stage.
//
// Layout: one row per block, loaded contiguously.  The TPU kernel's
// batch-on-lanes transpose and 128-row batch padding were lane-tiling
// artifacts and are gone.  Each stage has the block's threads stride over
// the n/f butterflies (q', j); a butterfly reads x[p*m'*l + q'*l + j] for
// p < f, applies the twiddle for p > 0 when l > 1, combines, and writes
// y[q'*f*l + k*l + j].  Combine coefficients that are exact quarter turns
// become swaps and sign flips; the others are fp32 constants rounded from
// fp64 cos/sin, as the TPU kernel's _coeff does.
//
// Interface: a plain C function, bound from Python with ctypes.  It launches
// on the caller's stream, does not synchronise, allocates nothing, and
// returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include <atomic>
#include <mutex>

namespace {

constexpr int kMaxStages = 16;
constexpr int kThreads = 256;
constexpr size_t kDefaultSmem = 48 * 1024;

struct StagePlan {
  int n_stages;
  int radix[kMaxStages];
  // Offset of the stage's twiddle planes in the twiddle buffer: re at
  // tw_off, im at tw_off + f*l, each (f, l) row-major.  -1 when l == 1.
  int tw_off[kMaxStages];
};

// (cos, sin) of 2*pi*r/f for the roots that are not quarter turns, rounded
// to fp32 from fp64.  Called with compile-time f and r after unrolling, so
// the switch folds to constants.
__device__ __forceinline__ void root(int f, int r, float& c, float& s) {
  switch ((f << 3) | r) {
    case (3 << 3) | 1: c = -0.5f; s = 0.8660254f; return;
    case (3 << 3) | 2: c = -0.5f; s = -0.8660254f; return;
    case (5 << 3) | 1: c = 0.309017f; s = 0.95105654f; return;
    case (5 << 3) | 2: c = -0.809017f; s = 0.58778524f; return;
    case (5 << 3) | 3: c = -0.809017f; s = -0.58778524f; return;
    case (5 << 3) | 4: c = 0.309017f; s = -0.95105654f; return;
    case (7 << 3) | 1: c = 0.6234898f; s = 0.7818315f; return;
    case (7 << 3) | 2: c = -0.22252093f; s = 0.9749279f; return;
    case (7 << 3) | 3: c = -0.90096885f; s = 0.43388373f; return;
    case (7 << 3) | 4: c = -0.90096885f; s = -0.43388373f; return;
    case (7 << 3) | 5: c = -0.22252093f; s = -0.9749279f; return;
    case (7 << 3) | 6: c = 0.6234898f; s = -0.7818315f; return;
    case (8 << 3) | 1: c = 0.70710677f; s = 0.70710677f; return;
    case (8 << 3) | 3: c = -0.70710677f; s = 0.70710677f; return;
    case (8 << 3) | 5: c = -0.70710677f; s = -0.70710677f; return;
    case (8 << 3) | 7: c = 0.70710677f; s = -0.70710677f; return;
    default: c = 1.0f; s = 0.0f; return;
  }
}

// out = e^(SIGN*2*pi*i*r/F) * z, exact at quarter turns.
template <int F, int SIGN>
__device__ __forceinline__ void mul_root(int r, float zr, float zi,
                                         float& outr, float& outi) {
  if (r == 0) {
    outr = zr;
    outi = zi;
  } else if (2 * r == F) {  // -1
    outr = -zr;
    outi = -zi;
  } else if (4 * r == F) {  // SIGN * i
    outr = SIGN > 0 ? -zi : zi;
    outi = SIGN > 0 ? zr : -zr;
  } else if (4 * r == 3 * F) {  // -SIGN * i
    outr = SIGN > 0 ? zi : -zi;
    outi = SIGN > 0 ? -zr : zr;
  } else {
    float c, s;
    root(F, r, c, s);
    if (SIGN < 0) s = -s;
    outr = c * zr - s * zi;
    outi = c * zi + s * zr;
  }
}

// One radix-F Stockham stage from (sr, si) into (dr, di).
template <int F, int SIGN>
__device__ __forceinline__ void stage(const float* __restrict__ sr,
                                      const float* __restrict__ si,
                                      float* __restrict__ dr,
                                      float* __restrict__ di, int mp, int l,
                                      const float* __restrict__ tw) {
  const int nb = mp * l;  // butterflies in this stage
  for (int t = threadIdx.x; t < nb; t += blockDim.x) {
    const int q = t / l;
    const int j = t - q * l;
    float zr[F], zi[F];
#pragma unroll
    for (int p = 0; p < F; ++p) {
      const float a = sr[p * nb + t];
      const float b = si[p * nb + t];
      if (tw != nullptr && p > 0) {
        const float c = tw[p * l + j];
        const float s = tw[(F + p) * l + j];
        zr[p] = a * c - b * s;
        zi[p] = a * s + b * c;
      } else {
        zr[p] = a;
        zi[p] = b;
      }
    }
    float* yr = dr + q * F * l + j;
    float* yi = di + q * F * l + j;
#pragma unroll
    for (int k = 0; k < F; ++k) {
      float accr = zr[0];
      float acci = zi[0];
#pragma unroll
      for (int p = 1; p < F; ++p) {
        float tr, ti;
        mul_root<F, SIGN>((k * p) % F, zr[p], zi[p], tr, ti);
        accr += tr;
        acci += ti;
      }
      yr[k * l] = accr;
      yi[k * l] = acci;
    }
  }
}

template <int SIGN>
__global__ void __launch_bounds__(kThreads)
stockham_fft_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                    float* __restrict__ yr, float* __restrict__ yi,
                    const float* __restrict__ tw, int n, StagePlan plan) {
  extern __shared__ float smem[];
  float* sr = smem;
  float* si = smem + n;
  float* dr = smem + 2 * n;
  float* di = smem + 3 * n;
  const size_t row = static_cast<size_t>(blockIdx.x) * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    sr[i] = xr[row + i];
    si[i] = xi[row + i];
  }
  __syncthreads();
  int l = 1;
  int m = n;
  for (int s = 0; s < plan.n_stages; ++s) {
    const int f = plan.radix[s];
    const int mp = m / f;
    const float* tws = plan.tw_off[s] >= 0 ? tw + plan.tw_off[s] : nullptr;
    switch (f) {
      case 2: stage<2, SIGN>(sr, si, dr, di, mp, l, tws); break;
      case 3: stage<3, SIGN>(sr, si, dr, di, mp, l, tws); break;
      case 4: stage<4, SIGN>(sr, si, dr, di, mp, l, tws); break;
      case 5: stage<5, SIGN>(sr, si, dr, di, mp, l, tws); break;
      case 7: stage<7, SIGN>(sr, si, dr, di, mp, l, tws); break;
      case 8: stage<8, SIGN>(sr, si, dr, di, mp, l, tws); break;
      default: break;  // the host accepts only the radices above
    }
    __syncthreads();
    float* t = sr; sr = dr; dr = t;
    t = si; si = di; di = t;
    l *= f;
    m = mp;
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    yr[row + i] = sr[i];
    yi[row + i] = si[i];
  }
}

// Largest dynamic shared memory each (device, sign) kernel has been allowed,
// so that cudaFuncSetAttribute runs once per new maximum, not per launch.
constexpr int kMaxDevices = 64;
std::atomic<int> g_smem_allowed[kMaxDevices][2];
std::mutex g_smem_mutex;

template <int SIGN>
cudaError_t allow_smem(int smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::atomic<int>& allowed = g_smem_allowed[dev][SIGN > 0];
  if (smem <= allowed.load(std::memory_order_acquire)) return cudaSuccess;
  std::lock_guard<std::mutex> lock(g_smem_mutex);
  if (smem <= allowed.load(std::memory_order_relaxed)) return cudaSuccess;
  err = cudaFuncSetAttribute(stockham_fft_kernel<SIGN>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) allowed.store(smem, std::memory_order_release);
  return err;
}

template <int SIGN>
cudaError_t launch(const float* xr, const float* xi, float* yr, float* yi,
                   const float* tw, int rows, int n, const StagePlan& plan,
                   cudaStream_t stream) {
  const size_t smem = 4 * static_cast<size_t>(n) * sizeof(float);
  if (smem > kDefaultSmem) {
    const cudaError_t err = allow_smem<SIGN>(static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  stockham_fft_kernel<SIGN><<<rows, kThreads, smem, stream>>>(xr, xi, yr, yi,
                                                              tw, n, plan);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Batched unnormalized FFT of `rows` contiguous rows of length n.
// radix / tw_off: host int arrays of n_stages entries.
int spectral_stockham_fft(const void* xr, const void* xi, void* yr, void* yi,
                          const void* tw, int rows, int n, int sign,
                          const void* radix, const void* tw_off, int n_stages,
                          void* stream) {
  if (rows < 1 || n < 2 || n_stages < 1 || n_stages > kMaxStages ||
      (sign != 1 && sign != -1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  StagePlan plan;
  plan.n_stages = n_stages;
  for (int s = 0; s < kMaxStages; ++s) {
    plan.radix[s] = s < n_stages ? static_cast<const int*>(radix)[s] : 1;
    plan.tw_off[s] = s < n_stages ? static_cast<const int*>(tw_off)[s] : -1;
  }
  const auto* fxr = static_cast<const float*>(xr);
  const auto* fxi = static_cast<const float*>(xi);
  auto* fyr = static_cast<float*>(yr);
  auto* fyi = static_cast<float*>(yi);
  const auto* ftw = static_cast<const float*>(tw);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      sign > 0 ? launch<1>(fxr, fxi, fyr, fyi, ftw, rows, n, plan, st)
               : launch<-1>(fxr, fxi, fyr, fyi, ftw, rows, n, plan, st);
  return static_cast<int>(err);
}

const char* spectral_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
