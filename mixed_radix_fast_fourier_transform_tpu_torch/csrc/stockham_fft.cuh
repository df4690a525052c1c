// Fused Stockham FFT for Hopper: the kernel and its launch templates.
// Included by stockham_fft.cu (the C entry point) and by the six
// stockham_fft_{fwd,inv}{,_bf16,_f16}.cu, which instantiate one sign and one
// plane type each so that nvcc builds them in parallel.  The design notes
// are in stockham_fft.cu.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace spectral {

constexpr int kMaxStages = 16;
constexpr size_t kDefaultSmem = 48 * 1024;

// Mirrors ops/cuda_fft.py::_StageParams and _Params field for field.
struct StageParams {
  int f, l, mp;
  int tile;   // lane map: 0 = linear, else c consecutive j by 32/c q
  int slots;  // tiles each warp runs
  int tw;     // offset of the stage's twiddles (re plane, then im), -1: none
  int swz_src, swz_mask;  // swizzle of the layout this stage writes
};

struct Params {
  const float* tw;
  int n, npad, sign, threads, rows, n_stages, smem, elems, bound;
  StageParams st[kMaxStages];
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
    default: c = 1.0f; s = 0.0f; return;
  }
}

// In-place DFT of F points, e^(SIGN*2*pi*i*k*p/F).
template <int F, int SIGN>
struct Dft;

template <int SIGN>
struct Dft<2, SIGN> {
  static __device__ __forceinline__ void run(float (&r)[2], float (&i)[2]) {
    const float ar = r[0], ai = i[0];
    r[0] = ar + r[1]; i[0] = ai + i[1];
    r[1] = ar - r[1]; i[1] = ai - i[1];
  }
};

template <int SIGN>
struct Dft<4, SIGN> {
  static __device__ __forceinline__ void run(float (&r)[4], float (&i)[4]) {
    const float t0r = r[0] + r[2], t0i = i[0] + i[2];
    const float t1r = r[0] - r[2], t1i = i[0] - i[2];
    const float t2r = r[1] + r[3], t2i = i[1] + i[3];
    // (a1 - a3) * SIGN*i
    const float t3r = -SIGN * (i[1] - i[3]), t3i = SIGN * (r[1] - r[3]);
    r[0] = t0r + t2r; i[0] = t0i + t2i;
    r[2] = t0r - t2r; i[2] = t0i - t2i;
    r[1] = t1r + t3r; i[1] = t1i + t3i;
    r[3] = t1r - t3r; i[3] = t1i - t3i;
  }
};

template <int SIGN>
struct Dft<8, SIGN> {
  // Two radix-4 DFTs of the even and odd points, then one radix-2 layer.
  static __device__ __forceinline__ void run(float (&r)[8], float (&i)[8]) {
    constexpr float h = 0.70710677f;
    float er[4] = {r[0], r[2], r[4], r[6]}, ei[4] = {i[0], i[2], i[4], i[6]};
    float odr[4] = {r[1], r[3], r[5], r[7]}, odi[4] = {i[1], i[3], i[5], i[7]};
    Dft<4, SIGN>::run(er, ei);
    Dft<4, SIGN>::run(odr, odi);
    // w^k * O[k], w = e^(SIGN*2*pi*i/8)
    float wr[4], wi[4];
    wr[0] = odr[0]; wi[0] = odi[0];
    wr[1] = h * (odr[1] - SIGN * odi[1]); wi[1] = h * (odi[1] + SIGN * odr[1]);
    wr[2] = -SIGN * odi[2]; wi[2] = SIGN * odr[2];
    wr[3] = h * (-odr[3] - SIGN * odi[3]); wi[3] = h * (-odi[3] + SIGN * odr[3]);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      r[k] = er[k] + wr[k]; i[k] = ei[k] + wi[k];
      r[k + 4] = er[k] - wr[k]; i[k + 4] = ei[k] - wi[k];
    }
  }
};

// Odd F: pair p with F - p, X[k] = z0 + sum_p c*(z_p + z_-p) + i*s*(z_p - z_-p).
template <int F, int SIGN>
struct DftOdd {
  static __device__ __forceinline__ void run(float (&r)[F], float (&i)[F]) {
    constexpr int H = (F - 1) / 2;
    float sr[H], si[H], dr[H], di[H];
#pragma unroll
    for (int p = 1; p <= H; ++p) {
      sr[p - 1] = r[p] + r[F - p]; si[p - 1] = i[p] + i[F - p];
      dr[p - 1] = r[p] - r[F - p]; di[p - 1] = i[p] - i[F - p];
    }
    float outr[F], outi[F];
    outr[0] = r[0]; outi[0] = i[0];
#pragma unroll
    for (int p = 0; p < H; ++p) { outr[0] += sr[p]; outi[0] += si[p]; }
#pragma unroll
    for (int k = 1; k < F; ++k) {
      float accr = r[0], acci = i[0];
#pragma unroll
      for (int p = 1; p <= H; ++p) {
        float c, s;
        root(F, (k * p) % F, c, s);
        if (SIGN < 0) s = -s;
        accr += c * sr[p - 1] - s * di[p - 1];
        acci += c * si[p - 1] + s * dr[p - 1];
      }
      outr[k] = accr; outi[k] = acci;
    }
#pragma unroll
    for (int k = 0; k < F; ++k) { r[k] = outr[k]; i[k] = outi[k]; }
  }
};

template <int SIGN> struct Dft<3, SIGN> : DftOdd<3, SIGN> {};
template <int SIGN> struct Dft<5, SIGN> : DftOdd<5, SIGN> {};
template <int SIGN> struct Dft<7, SIGN> : DftOdd<7, SIGN> {};

// The planes' element type in device memory: float, __nv_bfloat16 or
// __half.  A load widens to fp32 (exact), a store rounds to nearest even;
// everything between them is fp32.
template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static __device__ __forceinline__ float load(const float* p) { return __ldg(p); }
  static __device__ __forceinline__ void store(float* p, float v) { *p = v; }
};

template <>
struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    const unsigned short bits = __ldg(reinterpret_cast<const unsigned short*>(p));
    return __bfloat162float(__ushort_as_bfloat16(bits));
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
};

template <>
struct Elem<__half> {
  static __device__ __forceinline__ float load(const __half* p) {
    const unsigned short bits = __ldg(reinterpret_cast<const unsigned short*>(p));
    return __half2float(__ushort_as_half(bits));
  }
  static __device__ __forceinline__ void store(__half* p, float v) {
    *p = __float2half_rn(v);
  }
};

// Index of each element type in the C entry point's `dtype` argument
// (ops/cuda_fft.py::PLANE_DTYPES).
template <typename T> struct DtypeCode;
template <> struct DtypeCode<float> { static constexpr int value = 0; };
template <> struct DtypeCode<__nv_bfloat16> { static constexpr int value = 1; };
template <> struct DtypeCode<__half> { static constexpr int value = 2; };

// ops/cuda_fft.py::smem_index
__device__ __forceinline__ int swz(int i, int src, int mask) {
  return i ^ ((i >> src) & mask);
}

// A named barrier for the `threads` threads of one row (bar.sync id, n).
__device__ __forceinline__ void row_sync(int id, int threads) {
  __barrier_sync_count(id, threads);
}

// One radix-F stage of one row, in place.  B = E / F tiles a thread holds.
template <int F, int SIGN, int E, bool PREFETCH>
__device__ __forceinline__ void stage(float* __restrict__ sre,
                                      float* __restrict__ sim,
                                      const StageParams sp, int in_src,
                                      int in_mask, const float* __restrict__ tw,
                                      int warp, int lane, int warps,
                                      int sync_id, int threads) {
  constexpr int B = E / F;
  const int l = sp.l, mp = sp.mp, nb = mp * l, tile = sp.tile;
  const bool has_tw = sp.tw >= 0;
  const float* __restrict__ tws = tw + (has_tw ? sp.tw : 0);
  // ops/cuda_fft.py::tile_butterflies
  int q[B], j[B];
  bool ok[B];
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const int g = b * warps + warp;
    q[b] = 0; j[b] = 0; ok[b] = false;
    if (b < sp.slots) {
      if (tile == 0) {
        const int t = g * 32 + lane;
        q[b] = t / l;
        j[b] = t - q[b] * l;
        ok[b] = t < nb;
      } else {
        const int shift = __ffs(tile) - 1;
        const int jb = (l + tile - 1) >> shift;
        const int qb = g / jb;
        q[b] = (qb << (5 - shift)) + (lane >> shift);
        j[b] = ((g - qb * jb) << shift) + (lane & (tile - 1));
        ok[b] = q[b] < mp && j[b] < l;
      }
    }
  }
  float twr[B][F - 1], twi[B][F - 1];
  if (PREFETCH && has_tw) {
#pragma unroll
    for (int b = 0; b < B; ++b) {
      if (ok[b]) {
#pragma unroll
        for (int p = 1; p < F; ++p) {
          twr[b][p - 1] = __ldg(tws + p * l + j[b]);
          twi[b][p - 1] = __ldg(tws + (F + p) * l + j[b]);
        }
      }
    }
  }
  row_sync(sync_id, threads);  // the layout this stage reads is complete
  float zr[B][F], zi[B][F];
#pragma unroll
  for (int b = 0; b < B; ++b) {
    if (!ok[b]) continue;
    const int base = q[b] * l + j[b];
#pragma unroll
    for (int p = 0; p < F; ++p) {
      const int at = swz(p * nb + base, in_src, in_mask);
      const float a = sre[at];
      const float c = sim[at];
      if (p > 0 && has_tw) {
        float wr, wi;
        if (PREFETCH) {
          wr = twr[b][p - 1];
          wi = twi[b][p - 1];
        } else {
          wr = __ldg(tws + p * l + j[b]);
          wi = __ldg(tws + (F + p) * l + j[b]);
        }
        zr[b][p] = a * wr - c * wi;
        zi[b][p] = a * wi + c * wr;
      } else {
        zr[b][p] = a;
        zi[b][p] = c;
      }
    }
    Dft<F, SIGN>::run(zr[b], zi[b]);
  }
  row_sync(sync_id, threads);  // every read is done: write in place
#pragma unroll
  for (int b = 0; b < B; ++b) {
    if (!ok[b]) continue;
    const int base = q[b] * F * l + j[b];
#pragma unroll
    for (int k = 0; k < F; ++k) {
      const int at = swz(base + k * l, sp.swz_src, sp.swz_mask);
      sre[at] = zr[b][k];
      sim[at] = zi[b][k];
    }
  }
}

// At most 64 registers a thread: BOUND threads a block, 1024 / BOUND blocks.
template <typename T, int SIGN, int E, int BOUND>
__global__ void __launch_bounds__(BOUND, 1024 / BOUND)
stockham_fft_kernel(const T* __restrict__ xr, const T* __restrict__ xi,
                    T* __restrict__ yr, T* __restrict__ yi, int rows,
                    const __grid_constant__ Params p) {
  constexpr bool kPrefetch = E == 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const int threads = p.threads;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int row = blockIdx.x * p.rows + ty;
  // A row's threads are whole warps and sync on their own barrier, so the
  // threads of a row past the batch may leave at once.
  if (row >= rows) return;
  const int n = p.n;
  const int sync_id = 1 + ty;
  float* sre = reinterpret_cast<float*>(smem) +
               static_cast<size_t>(ty) * 2 * p.npad;
  float* sim = sre + p.npad;
  const size_t off = static_cast<size_t>(row) * n;

  // every load of the row is issued before the first is waited on
  float vr[E], vi[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = tx + e * threads;
    if (i < n) {
      vr[e] = Elem<T>::load(xr + off + i);
      vi[e] = Elem<T>::load(xi + off + i);
    }
  }
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = tx + e * threads;
    if (i < n) {
      sre[i] = vr[e];
      sim[i] = vi[e];
    }
  }

  const int warp = tx >> 5;
  const int lane = tx & 31;
  const int warps = threads >> 5;
  int in_src = 0, in_mask = 0;
  // kernel_factors orders the stages 8, 4, 2, 7, 5, 3: one loop per radix
  // keeps each radix's code and registers apart.
  int s = 0;
#define SPECTRAL_RUN(F)                                                     \
  for (; s < p.n_stages && p.st[s].f == F; ++s) {                           \
    const StageParams sp = p.st[s];                                         \
    stage<F, SIGN, E, kPrefetch>(sre, sim, sp, in_src, in_mask, p.tw, warp, \
                                 lane, warps, sync_id, threads);            \
    in_src = sp.swz_src;                                                    \
    in_mask = sp.swz_mask;                                                  \
  }
  SPECTRAL_RUN(8)
  SPECTRAL_RUN(4)
  SPECTRAL_RUN(2)
  SPECTRAL_RUN(7)
  SPECTRAL_RUN(5)
  SPECTRAL_RUN(3)
#undef SPECTRAL_RUN

  row_sync(sync_id, threads);
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = tx + e * threads;
    if (i < n) {
      Elem<T>::store(yr + off + i, sre[i]);
      Elem<T>::store(yi + off + i, sim[i]);
    }
  }
}

// Raises the kernel's dynamic shared-memory limit to smem, once per device,
// instantiation and new maximum (stockham_fft.cu).
cudaError_t allow_smem(const void* func, int variant, int smem);

template <typename T, int SIGN, int E, int BOUND>
cudaError_t launch(const T* xr, const T* xi, T* yr, T* yi, int rows,
                   const Params& p, cudaStream_t stream) {
  constexpr int kVariant = DtypeCode<T>::value * 32 + (SIGN > 0 ? 16 : 0) +
                           (E / 16) * 4 + BOUND / 512;
  auto* kernel = stockham_fft_kernel<T, SIGN, E, BOUND>;
  if (static_cast<size_t>(p.smem) > kDefaultSmem) {
    const cudaError_t err =
        allow_smem(reinterpret_cast<const void*>(kernel), kVariant, p.smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 block(p.threads, p.rows);
  const dim3 grid((rows + p.rows - 1) / p.rows);
  kernel<<<grid, block, p.smem, stream>>>(xr, xi, yr, yi, rows, p);
  return cudaGetLastError();
}

// The instantiations ops/cuda_fft.py::BOUNDS names: (elems, launch bound).
template <typename T, int SIGN>
cudaError_t launch_sign(const T* xr, const T* xi, T* yr, T* yi, int rows,
                        const Params& p, cudaStream_t stream) {
  switch (p.elems * 10000 + p.bound) {
    case 80256: return launch<T, SIGN, 8, 256>(xr, xi, yr, yi, rows, p, stream);
    case 80512: return launch<T, SIGN, 8, 512>(xr, xi, yr, yi, rows, p, stream);
    case 81024: return launch<T, SIGN, 8, 1024>(xr, xi, yr, yi, rows, p, stream);
    case 160512: return launch<T, SIGN, 16, 512>(xr, xi, yr, yi, rows, p, stream);
    case 161024: return launch<T, SIGN, 16, 1024>(xr, xi, yr, yi, rows, p, stream);
    case 321024: return launch<T, SIGN, 32, 1024>(xr, xi, yr, yi, rows, p, stream);
    default: return cudaErrorInvalidValue;
  }
}

#define SPECTRAL_LAUNCH_SIGN(T, SIGN)                                        \
  template cudaError_t launch_sign<T, SIGN>(const T*, const T*, T*, T*, int, \
                                            const Params&, cudaStream_t)

extern SPECTRAL_LAUNCH_SIGN(float, 1);
extern SPECTRAL_LAUNCH_SIGN(float, -1);
extern SPECTRAL_LAUNCH_SIGN(__nv_bfloat16, 1);
extern SPECTRAL_LAUNCH_SIGN(__nv_bfloat16, -1);
extern SPECTRAL_LAUNCH_SIGN(__half, 1);
extern SPECTRAL_LAUNCH_SIGN(__half, -1);

}  // namespace spectral
