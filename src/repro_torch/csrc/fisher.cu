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
// the output.  Two entries:
//   * fisher_tapgrads_fwd, the tap-gradient route (D == 1, no activation
//     operand): g (T, L, N, C), mask (T, N), n (T,) -> out (T, L, C), each
//     task's L layers reduced over its own N rows and scaled by 1 / (2 n[t])
//     read on the device, so a fleet's probe reduces every task of a group
//     in one launch with no host read (the TPU route is a vmap of the
//     pallas_call, which adds a grid axis), and one task's probe is T = 1.
//     The TPU route viewed (L, B, C) as (B, 1, L*C) through a transposed
//     copy; this kernel reads (T, L, B, C) in place and reads no activation
//     operand, which halves the bytes of the only route the main path
//     takes.  The task is the grid's y axis: a block never spans two tasks,
//     so each block compacts its own task's valid rows.
//   * fisher_fwd, materialised activations: a, g (N, D, C) -> out (C,).
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
//   * D == 1 (the probe's route): a thread owns VEC neighbouring columns of
//     one layer (16 bytes: 4 float32 or 8 bf16 values, when C and the
//     pointers allow it, else 1), neighbouring threads on neighbouring
//     columns, so a warp reads 512 contiguous bytes a row.  Each block
//     first compacts the valid rows of the device mask into a list in
//     shared memory (one warp, a ballot a 32 rows; no host read), so the
//     row loop holds no branch on the mask: RU rows' loads are issued
//     back to back, independent of each other, before their sums.  At
//     qwen2-1.5b's d_ff group (28, 48, 8960) f32 that is 62,720 threads,
//     490 blocks of 128, resident at once on the 132 SMs (one wave), with
//     RU x 16 = 128 bytes in flight a thread;
//   * D > 1: a 32 x 8 block splits d over its 8 warps, each warp on 32
//     neighbouring columns, and reduces the 8 partial sums of u in shared
//     memory once per row n.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int RT = 128;    // threads per block, D == 1 kernel
constexpr int RU = 8;      // rows loaded ahead a thread, D == 1 kernel
constexpr int RCH = 1024;  // rows compacted into shared memory a pass
constexpr int GX = 32;     // columns per block, D > 1 kernel
constexpr int GY = 8;      // d lanes per block, D > 1 kernel

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// VEC neighbouring elements at p as float32: one 16-byte load when VEC * the
// element size is 16 (p then 16-byte aligned), else VEC scalar loads
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&x)[VEC]) {
  if constexpr (sizeof(T) * VEC == 16 && sizeof(T) == 4) {
    const float4 r = __ldcs(reinterpret_cast<const float4*>(p));
    x[0] = r.x;
    x[1] = r.y;
    x[2] = r.z;
    x[3] = r.w;
  } else if constexpr (sizeof(T) * VEC == 16) {
    const uint4 r = __ldcs(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // two bf16 a word, the low one first
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int v = 0; v < VEC; ++v) x[v] = to_f(p[v]);
  }
}

template <typename T, int VEC, bool HAS_A>
__global__ void __launch_bounds__(RT)
fisher_rows_kernel(const T* __restrict__ a, const T* __restrict__ g,
                   const float* __restrict__ mask, float* __restrict__ out,
                   long long L, int N, long long C, float scale,
                   int mask_norm, const float* __restrict__ ntask) {
  __shared__ int s_row[RCH];   // the chunk's valid rows, in order
  __shared__ float s_w[RCH];   // their weights m^2 (1 without a mask)
  __shared__ int s_cnt;
  __shared__ float s_msum;
  // task blockIdx.y of a (T, L, N, C) stack, scaled by 1 / (2 ntask[task])
  // when ntask is given
  const long long task = blockIdx.y;
  g += task * L * (long long)N * C;
  if (HAS_A) a += task * L * (long long)N * C;
  if (mask != nullptr) mask += task * N;
  out += task * L * C;
  if (ntask != nullptr) scale = 1.f / (2.f * ntask[task]);
  const long long groups = C / VEC;  // VEC divides C
  const long long j = (long long)blockIdx.x * RT + threadIdx.x;
  const bool live = j < L * groups;
  const long long l = live ? j / groups : 0;
  const long long c0 = live ? (j - l * groups) * VEC : 0;
  const long long base = l * (long long)N * C + c0;  // (l, 0, c0)
  float acc[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) acc[v] = 0.f;
  float msum = 0.f;
  for (int r0 = 0; r0 < N; r0 += RCH) {
    const int rows = min(RCH, N - r0);
    __syncthreads();  // every thread is done with the previous chunk's list
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      int cnt = 0;
      float ms = 0.f;
      for (int i0 = 0; i0 < rows; i0 += 32) {
        const int i = i0 + lane;
        const float m = (i < rows && mask != nullptr) ? mask[r0 + i] : 1.f;
        const bool keep = i < rows && m != 0.f;  // padded rows: never read
        const unsigned bal = __ballot_sync(0xffffffffu, keep);
        if (keep) {
          const int at = cnt + __popc(bal & ((1u << lane) - 1u));
          s_row[at] = r0 + i;
          s_w[at] = m * m;
        }
        cnt += __popc(bal);
        if (i < rows && mask != nullptr) ms += m;
      }
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        ms += __shfl_xor_sync(0xffffffffu, ms, off);
      if (lane == 0) {
        s_cnt = cnt;
        s_msum = ms;
      }
    }
    __syncthreads();
    const int cnt = s_cnt;
    msum += s_msum;
    if (!live) continue;
    int i = 0;
    for (; i + RU <= cnt; i += RU) {  // RU independent loads, then the sums
      float x[RU][VEC], y[RU][VEC];
#pragma unroll
      for (int u = 0; u < RU; ++u) {
        const long long off = base + (long long)s_row[i + u] * C;
        load_vec<T, VEC>(g + off, x[u]);
        if (HAS_A) load_vec<T, VEC>(a + off, y[u]);
      }
#pragma unroll
      for (int u = 0; u < RU; ++u) {
        const float w = s_w[i + u];
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          const float uu = HAS_A ? x[u][v] * y[u][v] : x[u][v];
          acc[v] += w * (uu * uu);
        }
      }
    }
    for (; i < cnt; ++i) {
      float x[VEC], y[VEC];
      const long long off = base + (long long)s_row[i] * C;
      load_vec<T, VEC>(g + off, x);
      if (HAS_A) load_vec<T, VEC>(a + off, y);
      const float w = s_w[i];
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const float uu = HAS_A ? x[v] * y[v] : x[v];
        acc[v] += w * (uu * uu);
      }
    }
  }
  if (!live) return;
  const float s = mask_norm ? scale / fmaxf(msum, 1.f) : scale;
#pragma unroll
  for (int v = 0; v < VEC; ++v) out[l * C + c0 + v] = acc[v] * s;
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

// the D == 1 kernel's columns a thread: 16 bytes when C and the pointers
// allow it, else 1 (a choice by shape and alignment, never by failure)
template <typename T>
int rows_vec(const void* a, const void* g, long long C) {
  constexpr int V = 16 / sizeof(T);
  const bool ok = C % V == 0 && (reinterpret_cast<uintptr_t>(g) & 15) == 0 &&
                  (reinterpret_cast<uintptr_t>(a) & 15) == 0;
  return ok ? V : 1;
}

// The D == 1 kernel over `tasks` stacks of (L, N, C), grid (blocks of one
// stack, tasks); with `plan`, writes the launch's plan[0..4] (blocks of one
// stack, threads a block, columns a thread, rows loaded ahead a thread, rows
// compacted a pass) instead of launching.
template <typename T>
int launch_rows(const T* a, const T* g, const float* m, float* o, long long L,
                int N, long long C, float scale, int mask_norm,
                cudaStream_t stream, int* plan, long long tasks,
                const float* ntask) {
  const int vec = rows_vec<T>(a, g, C);
  const long long blocks = (L * (C / vec) + RT - 1) / RT;
  if (blocks > 0x7fffffffLL || tasks > 65535)
    return (int)cudaErrorInvalidConfiguration;
  if (plan) {
    plan[0] = (int)blocks;
    plan[1] = RT;
    plan[2] = vec;
    plan[3] = RU;
    plan[4] = RCH;
    return 0;
  }
  constexpr int V = 16 / sizeof(T);
  const dim3 grid((unsigned)blocks, (unsigned)tasks);
  if (a != nullptr && vec == V)
    fisher_rows_kernel<T, V, true><<<grid, RT, 0, stream>>>(
        a, g, m, o, L, N, C, scale, mask_norm, ntask);
  else if (a != nullptr)
    fisher_rows_kernel<T, 1, true><<<grid, RT, 0, stream>>>(
        a, g, m, o, L, N, C, scale, mask_norm, ntask);
  else if (vec == V)
    fisher_rows_kernel<T, V, false><<<grid, RT, 0, stream>>>(
        a, g, m, o, L, N, C, scale, mask_norm, ntask);
  else
    fisher_rows_kernel<T, 1, false><<<grid, RT, 0, stream>>>(
        a, g, m, o, L, N, C, scale, mask_norm, ntask);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* a, const void* g, const void* mask, void* out, int N,
           int D, long long C, float scale, int mask_norm,
           cudaStream_t stream) {
  const T* a_ = static_cast<const T*>(a);
  const T* g_ = static_cast<const T*>(g);
  const float* m_ = static_cast<const float*>(mask);
  float* o_ = static_cast<float*>(out);
  if (D == 1)
    return launch_rows<T>(a_, g_, m_, o_, 1, N, C, scale, mask_norm, stream,
                          nullptr, 1, nullptr);
  const long long blocks = (C + GX - 1) / GX;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  fisher_general_kernel<T><<<(unsigned)blocks, dim3(GX, GY), 0, stream>>>(
      a_, g_, m_, o_, N, D, C, scale, mask_norm);
  return (int)cudaGetLastError();
}

}  // namespace

// The materialised-activation form: a, g (N, D, C) with one dtype, mask
// nullptr or (N,) float32, out (C,) float32.  dtype 0 = float32, 1 =
// bfloat16.  Launches on `stream` without synchronising; returns the
// launch's cudaError_t.
extern "C" int fisher_fwd(const void* a, const void* g, const void* mask,
                          void* out, int N, int D, long long C, float scale,
                          int mask_norm, int dtype, void* stream) {
  if (a == nullptr || N < 1 || D < 1 || C < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(a, g, mask, out, N, D, C, scale, mask_norm, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(a, g, mask, out, N, D, C, scale, mask_norm,
                                 s);
  return (int)cudaErrorInvalidValue;
}

// The tap-gradient route: g (T, L, N, C) f32 or bf16, mask nullptr or (T, N)
// float32, n (T,) float32 valid counts on the device, out (T, L, C) float32
// = sum_n m[t, n]^2 g[t, l, n, c]^2 / (2 n[t]).  One launch, grid (blocks of
// one task, T): a block never spans two tasks, so task t's scores are the
// same launch's with T = 1 on g[t], bit for bit.  With `plan` non-null
// (g: only its alignment is read), writes the launch's plan[0..4] for the
// blocks of one task instead of launching.  Returns the launch's
// cudaError_t.
extern "C" int fisher_tapgrads_fwd(const void* g, const void* mask,
                                   const void* n, void* out, long long T,
                                   long long L, int N, long long C, int dtype,
                                   void* stream, int* plan) {
  if (T < 1 || L < 1 || N < 1 || C < 1 || (n == nullptr && plan == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m_ = static_cast<const float*>(mask);
  const float* n_ = static_cast<const float*>(n);
  float* o_ = static_cast<float*>(out);
  if (dtype == 0)
    return launch_rows<float>(nullptr, static_cast<const float*>(g), m_, o_,
                              L, N, C, 0.f, 0, s, plan, T, n_);
  if (dtype == 1)
    return launch_rows<__nv_bfloat16>(
        nullptr, static_cast<const __nv_bfloat16*>(g), m_, o_, L, N, C, 0.f,
        0, s, plan, T, n_);
  return (int)cudaErrorInvalidValue;
}
