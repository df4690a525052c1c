// Fused Stockham FFT for Hopper (sm_90a): all radix stages of one transform
// row in shared memory, the row's butterflies in registers.
//
// Replaces mixed_radix_fast_fourier_transform_tpu/ops/pallas_fft.py::_kernel
// (the fused Pallas kernel).  It computes the same thing: an unnormalized
// batched complex FFT over the last axis, sign +-1, on separate (re, im)
// planes of fp32, bf16 or fp16 (the Pallas kernel takes the planes' dtype as
// it finds them), running every stage of kernel_factors(n) (radix 8/4/2 for
// the power of two, then 7/5/3) as a Stockham autosort
//
//     X: (f, m', l)  ->  Y[q', k, j] = sum_p W_f[k, p] * T[p, j] * X[p, q', j]
//     (m = f * m', l *= f each stage, T[p, j] = e^(sign*2*pi*i*p*j/(f*l)))
//
// What bounds it on this card: device-memory bytes.  A length-n transform
// does about 5*n*log2(n) flops against 16*n bytes (one fp32 read and one
// write of each plane; 8*n for 2-byte planes): about 4 flops per byte at
// n = 8192, where the H100's fp32 units (67 TFLOP/s against 3.35 TB/s) would
// need about 20.  What the design does about that bound:
//
// * 2-byte planes (bf16, fp16) halve the bytes: a load widens each value to
//   fp32 into the shared-memory row, and the store rounds it back.  Stages,
//   twiddles and butterflies are fp32 for every plane type, so the shared
//   memory, the geometry and the error (one rounding at the store, where the
//   Pallas kernel rounds at every stage) do not depend on it.
//
// * One plane pair per row in shared memory (8*n bytes), updated in place.
//   Each stage reads its butterflies' inputs into registers, combines them
//   there, waits on the row's barrier, and writes the outputs back, so one
//   copy of the row suffices: half the shared memory of a ping-pong pair.
// * The host (ops/cuda_fft.py::kernel_geometry) picks threads per row, rows
//   per block, and per stage which butterflies each warp runs and how the
//   stage's output is swizzled in shared memory, such that the 32 lanes of
//   every read and write hit 32 distinct banks.  The kernel only follows
//   that table; the CPU tests check the table.
// * Rows move between device and shared memory in coalesced per-thread
//   loads and stores; every thread issues all its loads of the row before
//   it waits on the first.  (1-D bulk copies, cp.async.bulk on an mbarrier,
//   measured up to 8% slower on the card: PERF.md, Findings.)
// * Twiddles come from one table laid out (f, l) per stage, so lanes along j
//   read one contiguous run; where a thread holds 8 values (every n up to
//   8192) a stage's loads are issued before the barrier that precedes its
//   reads.
// * Rows of one block synchronise on their own named barrier, so a block
//   holding several short rows runs them independently.
//
// What the card taught (PERF.md, Findings): a stage's code runs once per
// thread, straight through, so its length sets the time as much as the data.
// Threads hold 8 values, not 16, wherever 1024 threads a row allow it; each
// radix's stages run in a loop of their own (no switch over radices, which
// made ptxas merge every radix's registers and spill); and the launch bounds
// hold every instantiation to 64 registers, so that 1024 threads fit an SM.
//
// Interface: a plain C function, bound from Python with ctypes.  It launches
// on the caller's stream, does not synchronise, allocates nothing, and
// returns cudaGetLastError() after the launch.

#include "stockham_fft.cuh"

#include <atomic>
#include <mutex>

namespace spectral {

// Largest dynamic shared memory each (device, instantiation) has been
// allowed, so that cudaFuncSetAttribute runs once per new maximum.
constexpr int kMaxDevices = 64;
constexpr int kVariants = 96;  // launch<>'s kVariant
std::atomic<int> g_smem_allowed[kMaxDevices][kVariants];
std::mutex g_smem_mutex;

cudaError_t allow_smem(const void* func, int variant, int smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::atomic<int>& allowed = g_smem_allowed[dev][variant];
  if (smem <= allowed.load(std::memory_order_acquire)) return cudaSuccess;
  std::lock_guard<std::mutex> lock(g_smem_mutex);
  if (smem <= allowed.load(std::memory_order_relaxed)) return cudaSuccess;
  err = cudaFuncSetAttribute(func, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err == cudaSuccess) allowed.store(smem, std::memory_order_release);
  return err;
}

// One launch on planes of element type T, either sign.
template <typename T>
cudaError_t launch_dtype(const void* xr, const void* xi, void* yr, void* yi,
                         int rows, const Params& p, cudaStream_t st) {
  const auto* txr = static_cast<const T*>(xr);
  const auto* txi = static_cast<const T*>(xi);
  auto* tyr = static_cast<T*>(yr);
  auto* tyi = static_cast<T*>(yi);
  return p.sign > 0 ? launch_sign<T, 1>(txr, txi, tyr, tyi, rows, p, st)
                    : launch_sign<T, -1>(txr, txi, tyr, tyi, rows, p, st);
}

}  // namespace spectral

extern "C" {

// Batched unnormalized FFT of `rows` contiguous rows of length n; `dtype`
// is the planes' element type (0 fp32, 1 bf16, 2 fp16:
// ops/cuda_fft.py::PLANE_DTYPES); `params` points to a host Params
// (ops/cuda_fft.py::KernelPlan.params).
int spectral_stockham_fft(const void* xr, const void* xi, void* yr, void* yi,
                          int rows, int dtype, void* stream,
                          const void* params) {
  using namespace spectral;
  const Params& p = *static_cast<const Params*>(params);
  if (rows < 1 || p.n < 2 || p.n_stages < 1 || p.n_stages > kMaxStages ||
      p.threads < 32 || p.threads % 32 != 0 || p.rows < 1 ||
      p.threads * p.rows > p.bound || (p.sign != 1 && p.sign != -1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0: err = launch_dtype<float>(xr, xi, yr, yi, rows, p, st); break;
    case 1: err = launch_dtype<__nv_bfloat16>(xr, xi, yr, yi, rows, p, st); break;
    case 2: err = launch_dtype<__half>(xr, xi, yr, yi, rows, p, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* spectral_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
