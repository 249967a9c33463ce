// Cached block flash attention for Hopper (sm_90a), CUDA C++ with a plain C
// entry point loaded through ctypes.
//
// Replaces: src/repro/kernels/flash_attention.py::_flash_cached_kernel, the
// Pallas TPU kernel behind flash_attention_pallas's cached mode.  It serves
// block prefill: a block of Sq prompt tokens per slot attends to that slot's
// contiguous KV cache from its own cursor.
//
// Contract (the same as the TPU kernel's): q (B, Sq, Hq, D), k/v
// (B, Sk, Hkv, D), f32 or bf16, row-major and contiguous; q_offset and
// kv_len (B,) int32.  Query i of sample b sits at absolute position
// q_offset[b] + i and sees cache rows kpos with kpos < kv_len[b], plus
// kpos <= qpos when causal and kpos > qpos - window when window > 0.  Query
// head h reads kv head h / (Hq / Hkv).  Scale 1/sqrt(D); softmax statistics
// and the accumulator are float32; out = acc / max(l, 1e-30), so a row that
// sees no key gives 0; the output has q's dtype.  Cache rows outside
// [max(0, q_offset - window + 1), min(kv_len, q_offset + Sq)) are never
// read, so a non-finite stale row there cannot reach the output.
//
// What bounds it on this card: bytes.  At Sq = 8 each K or V element read
// feeds group * Sq multiply-adds (48 at qwen2-1.5b's group of 6), about 48
// operations per bf16 byte, far below the ~295 operations per byte where an
// H100 stops being limited by its 3.35 TB/s memory.  So the design reads
// each needed K/V row once:
//   * one CTA per (tile of BM query rows, kv head, sample).  The rows of a
//     tile are the group * Sq (query head, token) pairs that share one kv
//     head, so all query heads of a GQA group read each K/V row from shared
//     memory, not from device memory, once per CTA;
//   * the TPU kernel carried acc/m/l across a sequential kv grid axis in
//     VMEM scratch.  Here a loop inside the CTA walks BN-row kv tiles staged
//     in shared memory, with m/l in shared memory and acc in registers;
//   * the loop covers only [max(0, q_offset - window + 1), min(kv_len,
//     q_offset + Sq)): the run-time block skip of the TPU kernel, so a slot
//     with a short cache reads only its own rows of the max_len stripe.
// The products are plain float FMA loops.  Tensor cores (mma.sync/wgmma),
// TMA and a split over the kv axis (B * Hkv = 16 CTAs at the main path's
// shapes leave most of the 132 SMs idle) are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int BM = 64;   // query rows per CTA
constexpr int BN = 64;   // cache rows per kv tile
constexpr int NT = 256;  // threads per CTA: 16 x 16, each owning 4 rows
constexpr float NEG_INIT = -1e30f;  // running max before any key

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int D>
constexpr size_t smem_bytes() {
  // sQ, sK, sV: BM/BN rows of D + 1 floats (the pad makes column reads
  // across rows conflict-free); sP: BM x (BN + 1); m, l, corr: BM each
  return sizeof(float) * (size_t)(3 * BM * (D + 1) + BM * (BN + 1) + 3 * BM);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_cached_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ o,
                    const int* __restrict__ q_offset,
                    const int* __restrict__ kv_len, int Sq, int Sk, int Hq,
                    int Hkv, int causal, int window, float scale) {
  constexpr int LD = D + 1;
  constexpr int LP = BN + 1;
  constexpr int NJ = D / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BM * LD;
  float* sV = sK + BN * LD;
  float* sP = sV + BN * LD;
  float* sM = sP + BM * LP;
  float* sL = sM + BM;
  float* sC = sL + BM;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int group = Hq / Hkv;
  const int rows = group * Sq;
  const int r0 = blockIdx.x * BM;
  const int qoff = q_offset[b];
  const int klen = kv_len[b];

  // Q tile: row r of the tile is (local head rr / Sq, token rr % Sq)
  for (int idx = tid; idx < BM * D; idx += NT) {
    const int r = idx / D, d = idx % D;
    const int rr = r0 + r;
    float val = 0.f;
    if (rr < rows) {
      const int h = kvh * group + rr / Sq, i = rr % Sq;
      val = to_f(q[(((size_t)b * Sq + i) * Hq + h) * D + d]);
    }
    sQ[r * LD + d] = val;
  }
  if (tid < BM) {
    sM[tid] = NEG_INIT;
    sL[tid] = 0.f;
  }

  // the cache rows any query of this sample can see
  int kv_hi = min(klen, Sk);
  if (causal) kv_hi = min(kv_hi, qoff + Sq);
  int kv_lo = 0;
  if (window > 0) kv_lo = max(0, qoff - window + 1);

  float acc[4][NJ];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[a][j] = 0.f;

  for (int kt = (kv_lo / BN) * BN; kt < kv_hi; kt += BN) {
    __syncthreads();  // the previous tile's sK/sV/sP reads are done
    for (int idx = tid; idx < BN * D; idx += NT) {
      const int c = idx / D, d = idx % D;
      const int s = kt + c;
      float kval = 0.f, vval = 0.f;
      if (s >= kv_lo && s < kv_hi) {  // rows no query sees are never read
        const size_t off = (((size_t)b * Sk + s) * Hkv + kvh) * D + d;
        kval = to_f(k[off]);
        vval = to_f(v[off]);
      }
      sK[c * LD + d] = kval;
      sV[c * LD + d] = vval;
    }
    __syncthreads();

    // scores for rows ty*4 + a, columns tx + 16*j
    float sc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[a][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) qv[a] = sQ[(ty * 4 + a) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[a][j] = fmaf(qv[a], kv[j], sc[a][j]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = ty * 4 + a;
      const int rr = r0 + r;
      const int qpos = qoff + rr % Sq;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int kpos = kt + c;
        bool ok = rr < rows && kpos < kv_hi && kpos >= kv_lo;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        sP[r * LP + c] = ok ? sc[a][j] * scale : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax, four threads per row
    {
      const int r = tid / 4, part = tid % 4;
      float mx = -INFINITY;
      for (int c = part; c < BN; c += 4) mx = fmaxf(mx, sP[r * LP + c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = sM[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int c = part; c < BN; c += 4) {
        const float sv = sP[r * LP + c];
        const float p = sv == -INFINITY ? 0.f : expf(sv - m_new);
        sP[r * LP + c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float corr = expf(m_old - m_new);
        sC[r] = corr;
        sL[r] = sL[r] * corr + sum;
        sM[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V for rows ty*4 + a, columns tx + 16*j
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float corr = sC[ty * 4 + a];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[a][j] *= corr;
    }
#pragma unroll 4
    for (int c = 0; c < BN; ++c) {
      float p[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) p[a] = sP[(ty * 4 + a) * LP + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float vv = sV[c * LD + tx + 16 * j];
#pragma unroll
        for (int a = 0; a < 4; ++a) acc[a][j] = fmaf(p[a], vv, acc[a][j]);
      }
    }
  }
  __syncthreads();  // sL final (also when no tile ran)

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty * 4 + a;
    const int rr = r0 + r;
    if (rr >= rows) continue;
    const int h = kvh * group + rr / Sq, i = rr % Sq;
    const float l = fmaxf(sL[r], 1e-30f);
    T* orow = o + (((size_t)b * Sq + i) * Hq + h) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) orow[tx + 16 * j] = from_f<T>(acc[a][j] / l);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   const void* q_offset, const void* kv_len, int B, int Sq,
                   int Sk, int Hq, int Hkv, int causal, int window,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_cached_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Hq / Hkv * Sq + BM - 1) / BM, Hkv, B);
  flash_cached_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      static_cast<const int*>(q_offset), static_cast<const int*>(kv_len), Sq,
      Sk, Hq, Hkv, causal, window, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o,
                       const void* q_offset, const void* kv_len, int B, int Sq,
                       int Sk, int Hq, int Hkv, int D, int causal, int window,
                       cudaStream_t s) {
#define FC_CASE(DD) \
  case DD:          \
    return launch<T, DD>(q, k, v, o, q_offset, kv_len, B, Sq, Sk, Hq, Hkv, causal, window, s);
  switch (D) {
    FC_CASE(16) FC_CASE(32) FC_CASE(48) FC_CASE(64)
    FC_CASE(80) FC_CASE(96) FC_CASE(112) FC_CASE(128)
    FC_CASE(144) FC_CASE(160) FC_CASE(176) FC_CASE(192)
    FC_CASE(208) FC_CASE(224) FC_CASE(240) FC_CASE(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef FC_CASE
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the launch's cudaError_t
// (cudaGetLastError() right after it); 0 means launched.
extern "C" int flash_cached_fwd(const void* q, const void* k, const void* v,
                                void* o, const void* q_offset,
                                const void* kv_len, int B, int Sq, int Sk,
                                int Hq, int Hkv, int D, int causal, int window,
                                int dtype, void* stream) {
  if (B < 1 || B > 65535 || Sq < 1 || Sk < 1 || Hkv < 1 || Hkv > 65535 ||
      Hq % Hkv != 0 || D % 16 != 0 || D < 16 || D > 256)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_d<float>(q, k, v, o, q_offset, kv_len, B, Sq, Sk, Hq,
                                  Hkv, D, causal, window, s);
  if (dtype == 1)
    return (int)dispatch_d<__nv_bfloat16>(q, k, v, o, q_offset, kv_len, B, Sq,
                                          Sk, Hq, Hkv, D, causal, window, s);
  return (int)cudaErrorInvalidValue;
}
