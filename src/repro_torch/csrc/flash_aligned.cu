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
//   * one CTA per (query tile, query head, sample): 64 rows a tile on the
//     FMA path, 128 on the Hopper path (384 CTAs at qwen2-
//     1.5b's width and S = 4096), enough to fill the 132 SMs without
//     splitting the kv axis;
//   * kv tiles (64 or 128 rows) wholly outside the causal or window band of
//     the CTA's query rows are skipped by their tile index, as the TPU
//     kernel's `relevant` test skips its kv blocks: a causal pass does about
//     half the products, a window of W about W / Sk of them;
//   * bf16 with D 64 or 128 (the Hopper path, `wg` below): a CTA of three
//     warpgroups owns 128 query rows of one head.  One thread of the third
//     (the producer, setmaxnreg down to 24 registers) loads Q once and
//     keeps a ring of two K and two V stages of 128 rows full with TMA
//     (cp.async.bulk.tensor from 4-D (D, H, S, B) maps, 128-byte swizzle,
//     a D-128 row arriving as two 64-column boxes), each stage completing
//     on an mbarrier; the consumers release a stage through an "empty"
//     mbarrier as soon as their product has read it.  The two consumer
//     warpgroups (setmaxnreg up to 240) own 64 rows each: S = Q K^T is
//     wgmma m64n128k16 with Q and K from shared memory, O += P V is wgmma
//     with P from registers (the score accumulator repacked to bf16) and V
//     read MN-major through the descriptor's transpose bit, so V is never
//     transposed.  The softmax runs in base 2 with log2(e) folded into the
//     scale, and masks only a tile that straddles the diagonal, the window
//     edge or Sk (TMA zero-fills rows past Sk; the mask sets them to
//     -inf).  Query tiles are launched longest band first, heads fastest,
//     so the query heads of a GQA group run side by side and read their
//     shared K/V tiles from L2 (no explicit sharing);
//   * f32 (any D), and bf16 with any other D (16 .. 256; no configuration
//     of the repo has a bf16 head dim of 16 to 112 other than 64): plain
//     FMA loops over 64 x 64 tiles in shared memory, the cached kernel's
//     scheme, in full float32 (f32 inputs are held to 1e-4, which TF32
//     tensor cores would not meet).
// The choice is by dtype and D alone.  pack_bf16 is flash_block.cuh's,
// shared with kernels 2 and 4.  The tensor maps are
// encoded on the host through cudaGetDriverEntryPoint, so the build links
// no driver library.

#include <cuda.h>

#include "flash_block.cuh"

namespace {

using flash::from_f;
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
// FMA path: f32 (any D), bf16 with D other than 64 and 128
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
// Hopper path: bf16 with D = 64 or 128, TMA + wgmma, warp-specialised
// ---------------------------------------------------------------------------

namespace wg {

constexpr int BM = 128;       // query rows a CTA: two consumer warpgroups of 64
constexpr int BN = 128;       // kv rows a tile
constexpr int STAGES = 2;     // K/V ring depth
constexpr int THREADS = 384;  // warpgroups 0 and 1 consume, 2 produces
constexpr int CONSUMERS = 256;
constexpr int PRODUCER_REGS = 24;   // setmaxnreg: 128 x 24 + 256 x 240 <= 64K
constexpr int CONSUMER_REGS = 240;
constexpr int ROW_BYTES = 128;      // one 64-column box row, 128-byte swizzle

// Shared memory from a 1024-byte aligned base: Q (BM rows), then STAGES K
// and STAGES V tiles (BN rows), each stored as D / 64 boxes of 64 columns
// (rows x 128 bytes, swizzled by TMA), then the mbarriers.
template <int D>
struct Smem {
  static constexpr int Q_BYTES = BM * D * 2;
  static constexpr int KV_BYTES = BN * D * 2;
  static constexpr int OFF_K = Q_BYTES;
  static constexpr int OFF_V = OFF_K + STAGES * KV_BYTES;
  static constexpr int OFF_BAR = OFF_V + STAGES * KV_BYTES;
  static constexpr int BARS = 1 + 4 * STAGES;  // q_full, k/v full, k/v empty
  static constexpr int BYTES = OFF_BAR + 8 * BARS + 1024;  // + align slack
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// one box of a 4-D (D, H, S, B) bf16 map into shared memory; rows past S
// (or B) arrive as zeros, and the barrier counts the whole box's bytes
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int d0, int h, int s,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(d0), "r"(h),
      "r"(s), "r"(b)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout B128
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving reads of an accumulator across the wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x 128, f32) (+)= A (64 x 16, K-major) B (16 x 128, K-major), both from
// shared memory through descriptors; scale_d 0 overwrites D
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
      "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
      "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
      "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 128, f32) += A (64 x 16, bf16 fragments in registers) B (16 x 128,
// MN-major in shared memory: the descriptor's transpose bit)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
      "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
      "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
      "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 64, f32) += A (64 x 16, bf16 fragments in registers) B (16 x 64,
// MN-major in shared memory: the descriptor's transpose bit)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
      "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// the kv band [lo, lo + n * BN) the CTA's query rows [q0, q0 + BM) can see
__device__ __forceinline__ int band(int q0, int Sq, int Sk, int causal,
                                    int window, int* lo) {
  const int q_last = min(q0 + BM, Sq) - 1;
  const int hi = causal ? min(Sk, q_last + 1) : Sk;
  const int first = window > 0 ? max(0, q0 - window + 1) : 0;
  *lo = (first / BN) * BN;
  return hi > first ? (hi - *lo + BN - 1) / BN : 0;  // 0: no row sees a key
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_aligned_wgmma(__grid_constant__ const CUtensorMap tq,
                    __grid_constant__ const CUtensorMap tk,
                    __grid_constant__ const CUtensorMap tv,
                    __nv_bfloat16* __restrict__ o, int Sq, int Sk, int Hq,
                    int Hkv, int causal, int window, float scale_log2) {
  using L = Smem<D>;
  constexpr int HALVES = D / 64;
  constexpr int NO = D / 2;  // output accumulator floats a thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::OFF_BAR);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* k_empty = v_full + STAGES;
  uint64_t* v_empty = k_empty + STAGES;

  const int tid = threadIdx.x;
  const int h = blockIdx.x % Hq, b = blockIdx.x / Hq;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;  // longest bands first
  const int kvh = h / (Hq / Hkv);
  int lo;
  const int n = band(q0, Sq, Sk, causal, window, &lo);

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], CONSUMERS);
      mbar_init(&v_empty[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ---- producer warpgroup: one thread keeps the K/V ring full ----------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (tid == CONSUMERS) {
      mbar_expect_tx(q_full, L::Q_BYTES);
#pragma unroll
      for (int c = 0; c < HALVES; ++c)
        tma_load(smem + c * BM * ROW_BYTES, &tq, q_full, c * 64, h, q0, b);
      for (int i = 0; i < n; ++i) {
        const int s = i % STAGES, ph = (i / STAGES) & 1, kt = lo + i * BN;
        uint8_t* sk = smem + L::OFF_K + s * L::KV_BYTES;
        uint8_t* sv = smem + L::OFF_V + s * L::KV_BYTES;
        mbar_wait(&k_empty[s], ph ^ 1);
        mbar_expect_tx(&k_full[s], L::KV_BYTES);
#pragma unroll
        for (int c = 0; c < HALVES; ++c)
          tma_load(sk + c * BN * ROW_BYTES, &tk, &k_full[s], c * 64, kvh, kt,
                   b);
        mbar_wait(&v_empty[s], ph ^ 1);
        mbar_expect_tx(&v_full[s], L::KV_BYTES);
#pragma unroll
        for (int c = 0; c < HALVES; ++c)
          tma_load(sv + c * BN * ROW_BYTES, &tv, &v_full[s], c * 64, kvh, kt,
                   b);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each --------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int wgi = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int ra = q0 + wgi * 64 + warp * 16 + g, rb = ra + 8;  // my rows
    const uint8_t* sq = smem + wgi * 64 * ROW_BYTES;
    float acc[NO];
#pragma unroll
    for (int j = 0; j < NO; ++j) acc[j] = 0.f;
    float m_a = -1e30f, m_b = -1e30f, l_a = 0.f, l_b = 0.f;

    mbar_wait(q_full, 0);
    for (int i = 0; i < n; ++i) {
      const int s = i % STAGES, ph = (i / STAGES) & 1, kt = lo + i * BN;
      const uint8_t* sk = smem + L::OFF_K + s * L::KV_BYTES;
      const uint8_t* sv = smem + L::OFF_V + s * L::KV_BYTES;

      // S = Q K^T over D in k-steps of 16 columns (32 bytes inside a box)
      float sc[BN / 2];
      mbar_wait(&k_full[s], ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c = kk / 4, off = (kk % 4) * 32;
        wgmma_ss_n128(sc, desc_sw128(sq + c * BM * ROW_BYTES + off, 16, 1024),
                      desc_sw128(sk + c * BN * ROW_BYTES + off, 16, 1024),
                      kk > 0);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(sc);
      mbar_arrive(&k_empty[s]);

      // mask only a tile that straddles the diagonal, the window edge or Sk
      const bool full = kt + BN <= Sk && (!causal || kt + BN - 1 <= q0) &&
                        (window <= 0 || kt > q0 + BM - 1 - window);
      if (!full) {
#pragma unroll
        for (int j = 0; j < BN / 2; ++j) {
          const int kpos = kt + (j / 4) * 8 + 2 * t + (j & 1);
          if (!visible((j & 2) ? rb : ra, kpos, Sk, causal, window))
            sc[j] = -INFINITY;
        }
      }

      // online softmax in base 2; m starts at -1e30, so a row with no
      // visible key never forms exp(-inf - -inf) and keeps l = 0
      float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
      for (int j = 0; j < BN / 2; j += 4) {
        mx_a = fmaxf(mx_a, fmaxf(sc[j], sc[j + 1]));
        mx_b = fmaxf(mx_b, fmaxf(sc[j + 2], sc[j + 3]));
      }
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
      const float mn_a = fmaxf(m_a, mx_a * scale_log2);
      const float mn_b = fmaxf(m_b, mx_b * scale_log2);
      const float corr_a = exp2f(m_a - mn_a), corr_b = exp2f(m_b - mn_b);
      m_a = mn_a;
      m_b = mn_b;
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int j = 0; j < BN / 2; j += 4) {
        sc[j] = exp2f(fmaf(sc[j], scale_log2, -mn_a));
        sc[j + 1] = exp2f(fmaf(sc[j + 1], scale_log2, -mn_a));
        sc[j + 2] = exp2f(fmaf(sc[j + 2], scale_log2, -mn_b));
        sc[j + 3] = exp2f(fmaf(sc[j + 3], scale_log2, -mn_b));
        sum_a += sc[j] + sc[j + 1];
        sum_b += sc[j + 2] + sc[j + 3];
      }
      l_a = l_a * corr_a + sum_a;  // this thread's columns; summed at the end
      l_b = l_b * corr_b + sum_b;
#pragma unroll
      for (int j = 0; j < NO; j += 4) {
        acc[j] *= corr_a;
        acc[j + 1] *= corr_a;
        acc[j + 2] *= corr_b;
        acc[j + 3] *= corr_b;
      }

      // O += P V: P from registers (two score n-blocks make one A fragment
      // of 16 keys), V from shared memory as it arrived, MN-major
      uint32_t pa[BN / 16][4];
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
        pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
      mbar_wait(&v_full[s], ph);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        // 16 keys = two 8-row groups (SBO 1024 B); the D / 64 boxes are
        // BN rows apart (LBO)
        const uint64_t dv = desc_sw128(sv + kk * 16 * ROW_BYTES,
                                       BN * ROW_BYTES, 1024);
        if constexpr (D == 128)
          wgmma_rs_n128(acc, pa[kk], dv);
        else
          wgmma_rs_n64(acc, pa[kk], dv);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(acc);
      mbar_arrive(&v_empty[s]);
    }

    l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
    l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
    const float inv_a = 1.f / fmaxf(l_a, 1e-30f);
    const float inv_b = 1.f / fmaxf(l_b, 1e-30f);
#pragma unroll
    for (int j = 0; j < NO; j += 4) {
      const int col = (j / 4) * 8 + 2 * t;
      if (ra < Sq)
        *reinterpret_cast<uint32_t*>(o + (((size_t)b * Sq + ra) * Hq + h) * D +
                                     col) =
            pack_bf16(acc[j] * inv_a, acc[j + 1] * inv_a);
      if (rb < Sq)
        *reinterpret_cast<uint32_t*>(o + (((size_t)b * Sq + rb) * Hq + h) * D +
                                     col) =
            pack_bf16(acc[j + 2] * inv_b, acc[j + 3] * inv_b);
    }
  }
}

// ---- host: tensor maps through the driver's entry point (no -lcuda) -------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

cudaError_t encoder(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  static cudaError_t status = cudaErrorNotReady;
  if (status == cudaErrorNotReady) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    status = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p,
                                              12000, cudaEnableDefault, &q);
#else
    status = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                     cudaEnableDefault, &q);
#endif
    if (status == cudaSuccess && (q != cudaDriverEntryPointSuccess || !p))
      status = cudaErrorSymbolNotFound;
    cached = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = cached;
  return status;
}

// (B, S, H, D) bf16, contiguous, as a 4-D map (D, H, S, B) read in boxes of
// 64 columns x `rows` rows of one head and sample, 128-byte swizzled
cudaError_t make_map(CUtensorMap* map, const void* base, int B, int S, int H,
                     int D, int rows) {
  EncodeTiled enc;
  const cudaError_t err = encoder(&enc);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)S * H * D * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                         const_cast<void*>(base), dims, strides, box, elem,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace wg

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

// plan[0..5] = {CTAs, cluster size, threads a CTA, dynamic shared memory
// bytes, registers a thread, stages}; with a plan nothing is launched
template <typename K>
cudaError_t fill_plan(K kern, dim3 grid, int threads, size_t smem, int stages,
                      int* plan) {
  cudaFuncAttributes fa;
  const cudaError_t err = cudaFuncGetAttributes(&fa, kern);
  if (err != cudaSuccess) return err;
  plan[0] = (int)(grid.x * grid.y * grid.z);
  plan[1] = 1;
  plan[2] = threads;
  plan[3] = (int)smem;
  plan[4] = fa.numRegs;
  plan[5] = stages;
  return cudaSuccess;
}

template <typename T, int D>
cudaError_t launch_fma(const void* q, const void* k, const void* v, void* o,
                       int B, int Sq, int Sk, int Hq, int Hkv, int causal,
                       int window, cudaStream_t stream, int* plan) {
  constexpr size_t smem = fma_smem_bytes<D>();
  const dim3 grid((Sq + BM - 1) / BM, Hq, B);
  if (plan) return fill_plan(flash_aligned_fma<T, D>, grid, NT, smem, 1, plan);
  cudaError_t err = cudaFuncSetAttribute(
      flash_aligned_fma<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  flash_aligned_fma<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, Hq, Hkv, causal,
      window, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o,
                         int B, int Sq, int Sk, int Hq, int Hkv, int causal,
                         int window, cudaStream_t stream, int* plan) {
  constexpr size_t smem = wg::Smem<D>::BYTES;
  const dim3 grid((unsigned)(Hq * B), (Sq + wg::BM - 1) / wg::BM, 1);
  if (plan)
    return fill_plan(wg::flash_aligned_wgmma<D>, grid, wg::THREADS, smem,
                     wg::STAGES, plan);
  // once per instantiation (and process), not once per launch
  static const cudaError_t attr = cudaFuncSetAttribute(
      wg::flash_aligned_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (attr != cudaSuccess) return attr;
  CUtensorMap tq, tk, tv;
  cudaError_t err = wg::make_map(&tq, q, B, Sq, Hq, D, wg::BM);
  if (err == cudaSuccess) err = wg::make_map(&tk, k, B, Sk, Hkv, D, wg::BN);
  if (err == cudaSuccess) err = wg::make_map(&tv, v, B, Sk, Hkv, D, wg::BN);
  if (err != cudaSuccess) return err;
  wg::flash_aligned_wgmma<D><<<grid, wg::THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), Sq, Sk, Hq, Hkv, causal,
      window, 1.4426950408889634f / sqrtf((float)D));
  return cudaGetLastError();
}

#define FA_ARGS q, k, v, o, B, Sq, Sk, Hq, Hkv, causal, window, s, plan

// By shape, not by failure: bf16 with D 64 or 128 runs the TMA + wgmma
// kernel; f32, and bf16 with any other D, the FMA loops.
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     int B, int Sq, int Sk, int Hq, int Hkv, int D, int causal,
                     int window, int dtype, cudaStream_t s, int* plan) {
#define F32_CASE(DD) \
  case DD:           \
    return launch_fma<float, DD>(FA_ARGS);
#define WGMMA_CASE(DD) \
  case DD:             \
    return launch_wgmma<DD>(FA_ARGS);
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
    BF16_FMA_CASE(16) BF16_FMA_CASE(32) BF16_FMA_CASE(48) WGMMA_CASE(64)
    BF16_FMA_CASE(80) BF16_FMA_CASE(96) BF16_FMA_CASE(112) WGMMA_CASE(128)
    BF16_FMA_CASE(144) BF16_FMA_CASE(160) BF16_FMA_CASE(176) BF16_FMA_CASE(192)
    BF16_FMA_CASE(208) BF16_FMA_CASE(224) BF16_FMA_CASE(240) BF16_FMA_CASE(256)
    default: return cudaErrorInvalidValue;
  }
#undef F32_CASE
#undef WGMMA_CASE
#undef BF16_FMA_CASE
}

bool dims_ok(int B, int Sq, int Sk, int Hq, int Hkv, int D, int dtype) {
  return B >= 1 && B <= 65535 && Sq >= 1 && Sk >= 1 && Hkv >= 1 && Hq >= 1 &&
         Hq <= 65535 && Hq % Hkv == 0 && D % 16 == 0 && D >= 16 && D <= 256 &&
         (dtype == 0 || dtype == 1);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  bf16 pointers must be 16-byte aligned
// (the K/V tiles load 16 bytes at a time; a TMA map's base).  Returns the
// launch's cudaError_t (cudaGetLastError() right after it, or the tensor
// map's encoding error); 0 means launched.
extern "C" int flash_aligned_fwd(const void* q, const void* k, const void* v,
                                 void* o, int B, int Sq, int Sk, int Hq,
                                 int Hkv, int D, int causal, int window,
                                 int dtype, void* stream) {
  if (!dims_ok(B, Sq, Sk, Hq, Hkv, D, dtype)) return (int)cudaErrorInvalidValue;
  return (int)dispatch(q, k, v, o, B, Sq, Sk, Hq, Hkv, D, causal, window, dtype,
                       static_cast<cudaStream_t>(stream), nullptr);
}

// The launch flash_aligned_fwd would make for these shapes, without making
// it: plan[0..5] = CTAs, cluster size, threads a CTA, dynamic shared memory
// bytes, registers a thread, stages.
extern "C" int flash_aligned_plan(int B, int Sq, int Sk, int Hq, int Hkv, int D,
                                  int dtype, int* plan) {
  if (!dims_ok(B, Sq, Sk, Hq, Hkv, D, dtype) || !plan)
    return (int)cudaErrorInvalidValue;
  return (int)dispatch(nullptr, nullptr, nullptr, nullptr, B, Sq, Sk, Hq, Hkv,
                       D, 0, 0, dtype, nullptr, plan);
}
