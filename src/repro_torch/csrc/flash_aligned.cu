// Aligned flash attention for Hopper (sm_90a), CUDA C++ with a plain C entry
// point loaded through ctypes.
//
// Replaces: src/repro/kernels/flash_attention.py::_flash_kernel, the Pallas
// TPU kernel behind flash_attention_pallas's aligned mode (no q_offset, no
// kv_len): softmax(q k^T / sqrt(D)) v over a whole sequence.
//
// Contract (the same as the TPU kernel's, with Sq and Sk free): q (B, Sq, Hq,
// D), k/v (B, Sk, Hkv, D), f32 or bf16, row-major and contiguous, D a
// multiple of 16 in [16, 256], Hq a multiple of Hkv.  Query head h reads kv
// head h / (Hq / Hkv).  Positions run from 0 on both axes: query i sees key
// j when j <= i (causal) and j > i - window (window > 0).  Scale 1/sqrt(D);
// the running max, sum and accumulator are float32; out = acc / max(l,
// 1e-30), so a row that sees no key gives 0; the output has q's dtype.
//
// What bounds it on this card: operations.  Each K/V row feeds every query
// row of its band, so at the bench shapes the work is 4 D flops a visible
// (query, key) pair against 2 bytes an element read once: at (1, 4096, 12,
// 2, 128) bf16 causal, 51.5 GFLOP and 29.4 MB, 0.052 ms on the tensor cores
// (989 TFLOP/s) against 0.009 ms for the bytes; at (2, 2048, 8, 2, 128) f32,
// 17.2 GFLOP on CUDA cores (67 TFLOP/s), 0.257 ms.  The design:
//   * one CTA per (64 query rows, query head, sample): at Sq = Sk there are
//     Sq / 64 * Hq * B CTAs (768 at qwen2-1.5b's width and S = 4096), enough
//     to fill the 132 SMs without splitting the kv axis;
//   * kv tiles of 64 rows wholly outside the causal or window band of the
//     CTA's query rows are skipped by their tile index, as the TPU kernel's
//     `relevant` test skips its kv blocks: a causal pass does about half the
//     products, a window of W about W / Sk of them;
//   * bf16 with D <= 128: four warps each own 16 query rows; S = Q K^T and
//     O += P V run on the tensor cores (mma.sync m16n8k16, bf16 in, f32
//     accumulate) with Q and the accumulator in registers and each K/V tile
//     staged once in shared memory (V transposed, so a B fragment is one
//     32-bit load), P rounded to bf16 for the second product;
//   * f32, and bf16 with D > 128: plain FMA loops over 64 x 64 tiles in
//     shared memory, the cached kernel's scheme, in full float32 (f32 inputs
//     are held to 1e-4, which TF32 tensor cores would not meet).
// pack_bf16 and mma_bf16 are flash_block.cuh's, shared with kernels 2 and 4.
// Not yet: wgmma, TMA, a producer warp and double-buffered tiles; sharing a
// K/V tile between the query heads of a GQA group (L2 serves the repeats).

#include "flash_block.cuh"

namespace {

using flash::from_f;
using flash::mma_bf16;
using flash::pack_bf16;
using flash::to_f;

constexpr int BM = 64;  // query rows per CTA
constexpr int BN = 64;  // kv rows per tile

// the kv tiles [lo, hi) some query row of [q0, q0 + BM) can see
__device__ __forceinline__ void kv_band(int q0, int Sq, int Sk, int causal,
                                        int window, int* lo, int* hi) {
  const int q_last = min(q0 + BM, Sq) - 1;
  *hi = causal ? min(Sk, q_last + 1) : Sk;
  *lo = window > 0 ? max(0, q0 - window + 1) : 0;
  *lo = (*lo / BN) * BN;
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int Sk, int causal,
                                        int window) {
  bool ok = kpos < Sk;
  if (causal) ok = ok && kpos <= qpos;
  if (window > 0) ok = ok && kpos > qpos - window;
  return ok;
}

// ---------------------------------------------------------------------------
// FMA path: f32 (any D), bf16 with D > 128
// ---------------------------------------------------------------------------

constexpr int NT = 256;  // 16 x 16 threads, each owning 4 query rows

template <int D>
constexpr size_t fma_smem_bytes() {
  // sQ, sK, sV: BM/BN rows of D + 1 floats; sP: BM x (BN + 1); m, l, corr
  return sizeof(float) * (size_t)(3 * BM * (D + 1) + BM * (BN + 1) + 3 * BM);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_aligned_fma(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk,
                  int Hq, int Hkv, int causal, int window, float scale) {
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
  const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (Hq / Hkv);

  for (int idx = tid; idx < BM * D; idx += NT) {
    const int r = idx / D, d = idx % D;
    const int i = q0 + r;
    sQ[r * LD + d] = i < Sq ? to_f(q[(((size_t)b * Sq + i) * Hq + h) * D + d]) : 0.f;
  }
  if (tid < BM) {
    sM[tid] = -INFINITY;
    sL[tid] = 0.f;
  }
  int lo, hi;
  kv_band(q0, Sq, Sk, causal, window, &lo, &hi);

  float acc[4][NJ];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[a][j] = 0.f;

  for (int kt = lo; kt < hi; kt += BN) {
    __syncthreads();  // the previous tile's sK/sV/sP reads are done
    for (int idx = tid; idx < BN * D; idx += NT) {
      const int c = idx / D, d = idx % D;
      const int s = kt + c;
      float kval = 0.f, vval = 0.f;
      if (s < Sk) {
        const size_t off = (((size_t)b * Sk + s) * Hkv + kvh) * D + d;
        kval = to_f(k[off]);
        vval = to_f(v[off]);
      }
      sK[c * LD + d] = kval;
      sV[c * LD + d] = vval;
    }
    __syncthreads();

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
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        sP[r * LP + c] = visible(q0 + r, kt + c, Sk, causal, window)
                             ? sc[a][j] * scale : -INFINITY;
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
      const float base = m_new == -INFINITY ? 0.f : m_new;
      float sum = 0.f;
      for (int c = part; c < BN; c += 4) {
        const float p = expf(sP[r * LP + c] - base);  // exp(-inf) = 0
        sP[r * LP + c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float corr = expf(m_old - base);
        sC[r] = corr;
        sL[r] = sL[r] * corr + sum;
        sM[r] = m_new;
      }
    }
    __syncthreads();

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
    const int i = q0 + r;
    if (i >= Sq) continue;
    const float l = fmaxf(sL[r], 1e-30f);
    T* orow = o + (((size_t)b * Sq + i) * Hq + h) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) orow[tx + 16 * j] = from_f<T>(acc[a][j] / l);
  }
}

// ---------------------------------------------------------------------------
// Tensor-core path: bf16, D <= 128
// ---------------------------------------------------------------------------

constexpr int MT = 128;  // four warps, 16 query rows each

template <int D>
__global__ void __launch_bounds__(MT)
flash_aligned_mma(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ o, int Sq, int Sk, int Hq,
                  int Hkv, int causal, int window, float scale) {
  constexpr int KD = D / 16;   // k-steps of Q K^T
  constexpr int ND = D / 8;    // n-tiles of the output
  constexpr int NS = BN / 8;   // n-tiles of a score tile
  constexpr int LDK = D + 8;   // sK row: the pad makes B loads conflict-free
  constexpr int LDV = BN + 8;  // sVt row (one feature, BN keys)
  __shared__ __align__(16) __nv_bfloat16 sK[BN * LDK];
  __shared__ __align__(16) __nv_bfloat16 sVt[D * LDV];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // mma group and thread in group
  const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (Hq / Hkv);
  const int ra = q0 + warp * 16 + g, rb = ra + 8;  // this thread's rows

  // Q fragments for all of D, straight from device memory
  uint32_t qf[KD][4];
  {
    const uint32_t* qa = reinterpret_cast<const uint32_t*>(
        q + (((size_t)b * Sq + min(ra, Sq - 1)) * Hq + h) * D);
    const uint32_t* qb = reinterpret_cast<const uint32_t*>(
        q + (((size_t)b * Sq + min(rb, Sq - 1)) * Hq + h) * D);
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      qf[kk][0] = ra < Sq ? qa[kk * 8 + t] : 0u;
      qf[kk][1] = rb < Sq ? qb[kk * 8 + t] : 0u;
      qf[kk][2] = ra < Sq ? qa[kk * 8 + 4 + t] : 0u;
      qf[kk][3] = rb < Sq ? qb[kk * 8 + 4 + t] : 0u;
    }
  }

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

  int lo, hi;
  kv_band(q0, Sq, Sk, causal, window, &lo, &hi);
  for (int kt = lo; kt < hi; kt += BN) {
    __syncthreads();  // the previous tile's reads are done
    // stage K (row-major) and V (transposed), 8 features a thread a step;
    // consecutive threads take consecutive keys, so the transposed stores
    // of a warp land in distinct banks
    for (int idx = tid; idx < BN * (D / 8); idx += MT) {
      const int r = idx % BN, c8 = idx / BN;
      const int s = kt + r;
      uint4 kv4 = make_uint4(0u, 0u, 0u, 0u), vv4 = kv4;
      if (s < Sk) {
        const size_t off = (((size_t)b * Sk + s) * Hkv + kvh) * D + c8 * 8;
        kv4 = *reinterpret_cast<const uint4*>(k + off);
        vv4 = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(&sK[r * LDK + c8 * 8]) = kv4;
      const __nv_bfloat16* vp = reinterpret_cast<const __nv_bfloat16*>(&vv4);
#pragma unroll
      for (int j = 0; j < 8; ++j) sVt[(c8 * 8 + j) * LDV + r] = vp[j];
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const __nv_bfloat16* kr = &sK[(n * 8 + g) * LDK + kk * 16 + 2 * t];
        mma_bf16(s[n], qf[kk], *reinterpret_cast<const uint32_t*>(kr),
                 *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }

    // mask, scale, online softmax over rows ra (s[.][0..1]) and rb ([2..3])
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = kt + n * 8 + 2 * t + (e & 1);
        const int qpos = e < 2 ? ra : rb;
        s[n][e] = visible(qpos, kpos, Sk, causal, window) ? s[n][e] * scale
                                                          : -INFINITY;
      }
      mx_a = fmaxf(mx_a, fmaxf(s[n][0], s[n][1]));
      mx_b = fmaxf(mx_b, fmaxf(s[n][2], s[n][3]));
    }
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float base_a = mn_a == -INFINITY ? 0.f : mn_a;
    const float base_b = mn_b == -INFINITY ? 0.f : mn_b;
    const float corr_a = expf(m_a - base_a), corr_b = expf(m_b - base_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      s[n][0] = expf(s[n][0] - base_a);
      s[n][1] = expf(s[n][1] - base_a);
      s[n][2] = expf(s[n][2] - base_b);
      s[n][3] = expf(s[n][3] - base_b);
      sum_a += s[n][0] + s[n][1];
      sum_b += s[n][2] + s[n][3];
    }
    l_a = l_a * corr_a + sum_a;  // this thread's columns; summed at the end
    l_b = l_b * corr_b + sum_b;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= corr_a;
      acc[n][1] *= corr_a;
      acc[n][2] *= corr_b;
      acc[n][3] *= corr_b;
    }

    // O += P V: two score n-tiles make one A fragment of 16 keys
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const __nv_bfloat16* vr = &sVt[(n * 8 + g) * LDV + kk * 16 + 2 * t];
        mma_bf16(acc[n], pa, *reinterpret_cast<const uint32_t*>(vr),
                 *reinterpret_cast<const uint32_t*>(vr + 8));
      }
    }
  }

  l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
  const float inv_a = 1.f / fmaxf(l_a, 1e-30f), inv_b = 1.f / fmaxf(l_b, 1e-30f);
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int col = n * 8 + 2 * t;
    if (ra < Sq)
      *reinterpret_cast<uint32_t*>(o + (((size_t)b * Sq + ra) * Hq + h) * D + col) =
          pack_bf16(acc[n][0] * inv_a, acc[n][1] * inv_a);
    if (rb < Sq)
      *reinterpret_cast<uint32_t*>(o + (((size_t)b * Sq + rb) * Hq + h) * D + col) =
          pack_bf16(acc[n][2] * inv_b, acc[n][3] * inv_b);
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

template <typename T, int D>
cudaError_t launch_fma(const void* q, const void* k, const void* v, void* o,
                       int B, int Sq, int Sk, int Hq, int Hkv, int causal,
                       int window, cudaStream_t stream) {
  constexpr size_t smem = fma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_aligned_fma<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BM - 1) / BM, Hq, B);
  flash_aligned_fma<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, Hq, Hkv, causal,
      window, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o,
                       int B, int Sq, int Sk, int Hq, int Hkv, int causal,
                       int window, cudaStream_t stream) {
  const dim3 grid((Sq + BM - 1) / BM, Hq, B);
  flash_aligned_mma<D><<<grid, MT, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), Sq,
      Sk, Hq, Hkv, causal, window, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

#define FA_ARGS q, k, v, o, B, Sq, Sk, Hq, Hkv, causal, window, s

cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     int B, int Sq, int Sk, int Hq, int Hkv, int D, int causal,
                     int window, int dtype, cudaStream_t s) {
#define F32_CASE(DD) \
  case DD:           \
    return launch_fma<float, DD>(FA_ARGS);
#define MMA_CASE(DD) \
  case DD:           \
    return launch_mma<DD>(FA_ARGS);
#define BF16_FMA_CASE(DD) \
  case DD:                \
    return launch_fma<__nv_bfloat16, DD>(FA_ARGS);
  if (dtype == 0) {
    switch (D) {
      F32_CASE(16) F32_CASE(32) F32_CASE(48) F32_CASE(64)
      F32_CASE(80) F32_CASE(96) F32_CASE(112) F32_CASE(128)
      F32_CASE(144) F32_CASE(160) F32_CASE(176) F32_CASE(192)
      F32_CASE(208) F32_CASE(224) F32_CASE(240) F32_CASE(256)
      default: return cudaErrorInvalidValue;
    }
  }
  switch (D) {
    MMA_CASE(16) MMA_CASE(32) MMA_CASE(48) MMA_CASE(64)
    MMA_CASE(80) MMA_CASE(96) MMA_CASE(112) MMA_CASE(128)
    BF16_FMA_CASE(144) BF16_FMA_CASE(160) BF16_FMA_CASE(176) BF16_FMA_CASE(192)
    BF16_FMA_CASE(208) BF16_FMA_CASE(224) BF16_FMA_CASE(240) BF16_FMA_CASE(256)
    default: return cudaErrorInvalidValue;
  }
#undef F32_CASE
#undef MMA_CASE
#undef BF16_FMA_CASE
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  bf16 pointers must be 16-byte aligned
// (the K/V tiles load 16 bytes at a time).  Returns the launch's cudaError_t
// (cudaGetLastError() right after it); 0 means launched.
extern "C" int flash_aligned_fwd(const void* q, const void* k, const void* v,
                                 void* o, int B, int Sq, int Sk, int Hq,
                                 int Hkv, int D, int causal, int window,
                                 int dtype, void* stream) {
  if (B < 1 || B > 65535 || Sq < 1 || Sk < 1 || Hkv < 1 || Hq < 1 ||
      Hq > 65535 || Hq % Hkv != 0 || D % 16 != 0 || D < 16 || D > 256 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  return (int)dispatch(q, k, v, o, B, Sq, Sk, Hq, Hkv, D, causal, window, dtype,
                       static_cast<cudaStream_t>(stream));
}
