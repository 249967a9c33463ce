// Paged block flash attention for Hopper (sm_90a), CUDA C++ with a plain C
// entry point loaded through ctypes.
//
// Replaces: src/repro/kernels/flash_attention.py::_flash_paged_kernel, the
// Pallas TPU kernel behind flash_attention_paged_pallas.  It serves block
// prefill over the paged KV cache (serving/paging.py): a block of Sq prompt
// tokens per slot attends causally to that slot's rows, which live in pages
// of a flat arena shared by all slots.
//
// Contract: q (B, Sq, Hq, D); k/v pages (n_pages, page_size, Hkv, D); f32
// or bf16, row-major and contiguous; page_table (B, max_pages) int32 with -1
// for unmapped; q_offset and kv_len (B,) int32.  Logical cache row r of
// sample b is row r % page_size of page page_table[b, r / page_size].  Query
// i sits at absolute position q_offset[b] + i and sees rows kpos with
// kpos < kv_len[b] and kpos <= qpos; a row behind an unmapped entry (or an
// entry outside [0, n_pages)) counts as masked and is never read.  Query
// head h reads kv head h / (Hq / Hkv).  Scale 1/sqrt(D); float32 statistics
// and accumulator; out = acc / max(l, 1e-30), so a row that sees no key
// gives 0; the output has q's dtype.  No row at or past min(kv_len,
// q_offset + Sq) is read, so a stale or non-finite row of a recycled page
// cannot reach the output.
//
// Design.  On the TPU the kv block had to *be* the page, because the
// BlockSpec index map walks the table one grid step per page.  Here the
// kernel keeps the CTA layout and the tile walk of flash_cached.cu (one CTA
// per 64 query rows of a GQA group, kv head and sample; 64-row *logical* kv
// tiles over [0, min(kv_len, q_offset + Sq))) and changes one thing: row r
// of a tile is staged into shared memory from page page_table[b, r /
// page_size].  The table row is read into shared memory once per CTA.  Any
// page size works, and the arithmetic is the cached kernel's in the same
// order, so on rows laid out in pages it gives bit for bit the cached
// kernel's output on the same rows laid out contiguously.
//
// What bounds it on this card: bytes, as for the cached kernel (about 48
// operations per bf16 byte of K/V at Sq = 8 and qwen2-1.5b's group of 6,
// far below the ~295 where an H100 stops being memory-bound).  The products
// are plain float FMA loops and each element is loaded on its own; tensor
// cores, TMA, a split over the kv axis and whole-page vector loads are
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int BM = 64;   // query rows per CTA
constexpr int BN = 64;   // logical cache rows per kv tile
constexpr int NT = 256;  // threads per CTA: 16 x 16, each owning 4 rows
constexpr float NEG_INIT = -1e30f;  // running max before any key
constexpr size_t SMEM_MAX = 232448;  // dynamic shared memory of one block

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// sQ, sK, sV: BM/BN rows of D + 1 floats (the pad makes column reads across
// rows conflict-free); sP: BM x (BN + 1); m, l, corr: BM each; then the
// tile's row flags (BN ints) and the CTA's page-table row (max_pages ints)
size_t smem_bytes(int D, int max_pages) {
  return sizeof(float) * (size_t)(3 * BM * (D + 1) + BM * (BN + 1) + 3 * BM) +
         sizeof(int) * (size_t)(BN + max_pages);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_paged_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                   const T* __restrict__ vp, T* __restrict__ o,
                   const int* __restrict__ page_table,
                   const int* __restrict__ q_offset,
                   const int* __restrict__ kv_len, int Sq, int Hq, int Hkv,
                   int n_pages, int page_size, int max_pages, float scale) {
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
  int* sOK = reinterpret_cast<int*>(sC + BM);  // row r of the tile exists
  int* sPT = sOK + BN;                         // this sample's table row

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int group = Hq / Hkv;
  const int rows = group * Sq;
  const int r0 = blockIdx.x * BM;
  const int qoff = q_offset[b];
  const int klen = kv_len[b];

  for (int i = tid; i < max_pages; i += NT)
    sPT[i] = page_table[(size_t)b * max_pages + i];

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

  // the logical rows any query of this sample can see (causal)
  const int kv_hi = min(min(klen, max_pages * page_size), qoff + Sq);
  const size_t row_stride = (size_t)Hkv * D;  // elements between page rows

  float acc[4][NJ];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[a][j] = 0.f;

  for (int kt = 0; kt < kv_hi; kt += BN) {
    __syncthreads();  // the previous tile's reads are done; sPT is loaded
    for (int idx = tid; idx < BN * D; idx += NT) {
      const int c = idx / D, d = idx % D;
      const int s = kt + c;
      float kval = 0.f, vval = 0.f;
      int ok = 0;
      if (s < kv_hi) {  // rows no query sees are never read
        const int pg = sPT[s / page_size];
        if (pg >= 0 && pg < n_pages) {
          const size_t off =
              ((size_t)pg * page_size + s % page_size) * row_stride +
              (size_t)kvh * D + d;
          kval = to_f(kp[off]);
          vval = to_f(vp[off]);
          ok = 1;
        }
      }
      sK[c * LD + d] = kval;
      sV[c * LD + d] = vval;
      if (d == 0) sOK[c] = ok;
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
        const bool ok = rr < rows && kpos < kv_hi && sOK[c] && kpos <= qpos;
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

struct Args {
  const void *q, *kp, *vp;
  void* o;
  const void *page_table, *q_offset, *kv_len;
  int B, Sq, Hq, Hkv, n_pages, page_size, max_pages;
};

template <typename T, int D>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(D, a.max_pages);
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_paged_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Hq / a.Hkv * a.Sq + BM - 1) / BM, a.Hkv, a.B);
  flash_paged_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.kp),
      static_cast<const T*>(a.vp), static_cast<T*>(a.o),
      static_cast<const int*>(a.page_table),
      static_cast<const int*>(a.q_offset), static_cast<const int*>(a.kv_len),
      a.Sq, a.Hq, a.Hkv, a.n_pages, a.page_size, a.max_pages,
      1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const Args& a, int D, cudaStream_t s) {
#define FP_CASE(DD) \
  case DD:          \
    return launch<T, DD>(a, s);
  switch (D) {
    FP_CASE(16) FP_CASE(32) FP_CASE(48) FP_CASE(64)
    FP_CASE(80) FP_CASE(96) FP_CASE(112) FP_CASE(128)
    FP_CASE(144) FP_CASE(160) FP_CASE(176) FP_CASE(192)
    FP_CASE(208) FP_CASE(224) FP_CASE(240) FP_CASE(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef FP_CASE
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the launch's cudaError_t
// (cudaGetLastError() right after it); 0 means launched.  A page table too
// wide for the CTA's shared memory (beside the tiles: ~28k columns at
// D = 128) is refused with cudaErrorInvalidValue.
extern "C" int flash_paged_fwd(const void* q, const void* k_pages,
                               const void* v_pages, void* o,
                               const void* page_table, const void* q_offset,
                               const void* kv_len, int B, int Sq, int Hq,
                               int Hkv, int D, int n_pages, int page_size,
                               int max_pages, int dtype, void* stream) {
  if (B < 1 || B > 65535 || Sq < 1 || Hkv < 1 || Hkv > 65535 ||
      Hq % Hkv != 0 || D % 16 != 0 || D < 16 || D > 256 || n_pages < 1 ||
      page_size < 1 || max_pages < 1)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k_pages, v_pages, o, page_table, q_offset, kv_len,
               B, Sq, Hq, Hkv, n_pages, page_size, max_pages};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_d<float>(a, D, s);
  if (dtype == 1) return (int)dispatch_d<__nv_bfloat16>(a, D, s);
  return (int)cudaErrorInvalidValue;
}
