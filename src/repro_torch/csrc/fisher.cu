// Fused Fisher-information reduction (paper Eq. 2) for Hopper (sm_90a), CUDA
// C++ with a plain C entry point loaded through ctypes.
//
// Replaces: src/repro/kernels/fisher.py::fisher_pallas (_fisher_kernel), the
// Pallas TPU kernel behind repro.kernels.ops.fisher, fisher_auto and
// fisher_tapgrads.  On the adaptation path it scores every channel of the
// Fisher probe from its tap gradients, once per task and per stack group.
//
// Contract, per output channel (f32 or bf16 inputs, float32 sums, float32
// output; row-major and contiguous):
//   u[n]   = sum_d a[n, d, c] * g[n, d, c]        (a == nullptr means a = 1)
//   out[c] = scale * sum_n w[n] * u[n]^2 / (mask_norm ? max(sum_n m[n], 1) : 1)
// with w[n] = m[n]^2 for a mask m (nullptr: w = 1).  A row with m[n] == 0 is
// skipped, never read, so garbage (even NaN) in a padded row cannot reach
// the output.  Two layouts:
//   * D == 1, the tap-gradient route: g (L, N, C) -> out (L, C), each of the
//     L layers reduced over its own N rows.  The TPU route viewed (L, B, C)
//     as (B, 1, L*C) through a transposed copy; this kernel reads (L, B, C)
//     in place, and with a == nullptr reads no activation operand at all,
//     which halves the bytes of the only route the main path takes.
//   * D > 1, materialised activations: a, g (N, D, C) -> out (C,).
// Ragged edges in C and D are masked in the kernel, so every shape goes
// through it: no block-divisor gate and no fallback to a plain version.
//
// What bounds it on this card: bytes.  Each input element feeds one or two
// multiply-adds, far below the ~20 operations per float32 byte where an H100
// stops being limited by its 3.35 TB/s memory.  So the design reads each
// needed element once, coalesced, with many loads in flight:
//   * the TPU kernel carried u across a sequential d grid axis in VMEM
//     scratch and the output across a sequential n axis.  Here one thread
//     owns its output columns outright and loops over n (and d) itself, so
//     nothing is carried between blocks and there are no atomics;
//   * D == 1: a thread owns RV columns RT apart (neighbouring threads on
//     neighbouring addresses), so each warp load is one 128-byte line, and
//     the n loop is unrolled for more loads in flight;
//   * D > 1: a 32 x 8 block splits d over its 8 warps, each warp on 32
//     neighbouring columns, and reduces the 8 partial sums of u in shared
//     memory once per row n.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int RT = 256;  // threads per block, D == 1 kernel
constexpr int RV = 2;    // columns per thread, D == 1 kernel
constexpr int GX = 32;   // columns per block, D > 1 kernel
constexpr int GY = 8;    // d lanes per block, D > 1 kernel

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T, bool HAS_A>
__global__ void __launch_bounds__(RT)
fisher_rows_kernel(const T* __restrict__ a, const T* __restrict__ g,
                   const float* __restrict__ mask, float* __restrict__ out,
                   long long L, int N, long long C, float scale,
                   int mask_norm) {
  const long long total = L * C;
  const long long base = (long long)blockIdx.x * (RT * RV) + threadIdx.x;
  long long off[RV];  // element offset of (l, 0, c) for each owned column
  bool live[RV];
  float acc[RV];
#pragma unroll
  for (int k = 0; k < RV; ++k) {
    const long long j = base + (long long)k * RT;
    live[k] = j < total;
    const long long l = live[k] ? j / C : 0;
    const long long c = live[k] ? j - l * C : 0;
    off[k] = l * (long long)N * C + c;
    acc[k] = 0.f;
  }
  float msum = 0.f;
#pragma unroll 4
  for (int n = 0; n < N; ++n) {
    float w = 1.f;
    if (mask != nullptr) {
      const float m = mask[n];
      msum += m;
      if (m == 0.f) continue;  // padded row: never read
      w = m * m;
    }
    const long long row = (long long)n * C;
#pragma unroll
    for (int k = 0; k < RV; ++k) {
      if (live[k]) {
        float u = to_f(g[off[k] + row]);
        if (HAS_A) u *= to_f(a[off[k] + row]);
        acc[k] += w * (u * u);
      }
    }
  }
  const float s = mask_norm ? scale / fmaxf(msum, 1.f) : scale;
#pragma unroll
  for (int k = 0; k < RV; ++k) {
    if (live[k]) out[base + (long long)k * RT] = acc[k] * s;
  }
}

template <typename T>
__global__ void __launch_bounds__(GX * GY)
fisher_general_kernel(const T* __restrict__ a, const T* __restrict__ g,
                      const float* __restrict__ mask, float* __restrict__ out,
                      int N, int D, long long C, float scale, int mask_norm) {
  __shared__ float part[GY][GX + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const long long c = (long long)blockIdx.x * GX + tx;
  const bool live = c < C;
  float acc = 0.f, msum = 0.f;
  for (int n = 0; n < N; ++n) {
    float w = 1.f;
    if (mask != nullptr) {
      const float m = mask[n];  // the same for every thread: uniform branch
      msum += m;
      if (m == 0.f) continue;
      w = m * m;
    }
    float p = 0.f;
    if (live) {
      const long long row = (long long)n * D * C + c;
      for (int d = ty; d < D; d += GY) {
        const long long i = row + (long long)d * C;
        p += to_f(a[i]) * to_f(g[i]);
      }
    }
    part[ty][tx] = p;
    __syncthreads();
    if (ty == 0) {
      float u = 0.f;
#pragma unroll
      for (int y = 0; y < GY; ++y) u += part[y][tx];
      acc += w * (u * u);
    }
    __syncthreads();
  }
  if (ty == 0 && live) {
    out[c] = acc * (mask_norm ? scale / fmaxf(msum, 1.f) : scale);
  }
}

template <typename T>
int launch(const void* a, const void* g, const void* mask, void* out,
           long long L, int N, int D, long long C, float scale,
           int mask_norm, cudaStream_t stream) {
  const T* a_ = static_cast<const T*>(a);
  const T* g_ = static_cast<const T*>(g);
  const float* m_ = static_cast<const float*>(mask);
  float* o_ = static_cast<float*>(out);
  if (D == 1) {
    const long long blocks = (L * C + RT * RV - 1) / (RT * RV);
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    if (a_ != nullptr) {
      fisher_rows_kernel<T, true><<<(unsigned)blocks, RT, 0, stream>>>(
          a_, g_, m_, o_, L, N, C, scale, mask_norm);
    } else {
      fisher_rows_kernel<T, false><<<(unsigned)blocks, RT, 0, stream>>>(
          a_, g_, m_, o_, L, N, C, scale, mask_norm);
    }
  } else {
    if (L != 1 || a_ == nullptr) return (int)cudaErrorInvalidValue;
    const long long blocks = (C + GX - 1) / GX;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    fisher_general_kernel<T><<<(unsigned)blocks, dim3(GX, GY), 0, stream>>>(
        a_, g_, m_, o_, N, D, C, scale, mask_norm);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// a: nullptr or the activation operand, with g's dtype and shape; g: (L, N, C)
// when D == 1, else (N, D, C) with L == 1; mask: nullptr or (N,) float32;
// out: (L, C) float32.  dtype 0 = float32, 1 = bfloat16.  Launches on
// `stream` without synchronising; returns the launch's cudaError_t.
extern "C" int fisher_fwd(const void* a, const void* g, const void* mask,
                          void* out, long long L, int N, int D, long long C,
                          float scale, int mask_norm, int dtype,
                          void* stream) {
  if (L < 1 || N < 1 || D < 1 || C < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(a, g, mask, out, L, N, D, C, scale, mask_norm, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(a, g, mask, out, L, N, D, C, scale,
                                 mask_norm, s);
  return (int)cudaErrorInvalidValue;
}
