// Block flash attention for Hopper (sm_90a): the device code shared by the
// cached kernel (flash_cached.cu, kernel 2) and the paged kernel
// (flash_paged.cu, kernel 4), and the tensor-core helpers of the aligned
// kernel (flash_aligned.cu, kernel 3).
//
// One kernel template over a *row source*: ContigRows reads logical cache
// row s of sample b from a contiguous (B, Sk, Hkv, D) cache, PagedRows from
// page table[b, s / page_size] of a flat (n_pages, page_size, Hkv, D) arena,
// with the slice of the sample's table row that the CTA's tiles span read
// into shared memory once per CTA.  Both kernels run the same tiles, the
// same arithmetic and the same combine in the same order, so on the same
// rows the paged kernel gives the cached kernel's output bit for bit, at any
// page size.
//
// Layout of a launch (Sq query tokens a sample, a GQA group of Hq / Hkv query
// heads per kv head):
//   * the rows of a query tile are up to BM = 64 (query head, token) pairs of
//     one GQA group, so each K/V row staged in shared memory feeds every query
//     head of its group;
//   * the kv axis is split.  Logical BN = 64-row tiles count from row 0, so
//     their boundaries never depend on the page size.  The n tiles of a
//     sample's band [max(0, q_offset - window + 1), min(kv_len, cap,
//     q_offset + Sq)) are dealt out in runs of ceil(n / MAX_SPLIT) to the S
//     CTAs of a thread-block cluster (S = 1, 2, 4 or 8, the smallest power of
//     two that covers the cache's tiles, up to 8).  A rank whose run is empty
//     still takes part in the cluster barriers and contributes the sentinel
//     (m = -1e30, l = 0, acc = 0);
//   * each CTA keeps a running (m, l, acc) over its tiles (an online softmax
//     in base 2), writes it to its shared memory, and after a cluster barrier
//     every CTA combines the partials of all S ranks through distributed
//     shared memory, in rank order, for its share of the output elements:
//     M = max_j m_j, e_j = 2^(m_j - M), out = sum_j e_j acc_j / max(sum_j
//     e_j l_j, 1e-30).  m is never -inf, so no exp(-inf - -inf) is formed; a
//     row that sees no key has every l_j = 0 and gives exactly 0.  An empty
//     rank adds exact zeros, so the result does not depend on S beyond the
//     tiles' runs, which depend only on the band.  One launch, no workspace,
//     no atomics: the same inputs give the same bits;
//   * K/V rows arrive as 16-byte cp.async copies into shared memory kept in
//     the input dtype, double-buffered when a CTA walks more than one tile;
//     rows outside the band (or behind an unmapped page) are zero-filled and
//     never read, so a non-finite stale row cannot reach the output;
//   * bf16, every D from 16 to 256: four warps, each owning 16 query rows of
//     the tile (a warp with no live row does no product); S = Q K^T and O +=
//     P V on the tensor cores (mma.sync m16n8k16, f32 accumulate), the
//     accumulator in registers, K read with ldmatrix, V with ldmatrix.trans,
//     P rounded to bf16 for the second product.  Past D 128 only the k-steps
//     (D / 16) and the output's n-tiles (D / 8) grow; the arithmetic, the
//     base-2 online softmax, the masks and the combine are the D <= 128 ones;
//   * where Q's A fragments live.  A thread's share of the accumulator is
//     D / 2 floats and its scores 32; Q's fragments add D / 4 registers.
//     At D <= 128 that is at most 128 and all of it fits (ptxas: 227
//     registers at D 128 with contiguous rows, 207 with paged ones, no
//     spill), so Q stays in registers, loaded once.  Q read from shared
//     memory there too (below) drops them to 170 and 162 but costs kernel
//     2 time: on an H100 80GB HBM3 at 700 W (benchmarks_torch/
//     redesign_bench.py --only block, device time a call in a CUDA graph,
//     two runs each) 0.0093-0.0094 -> 0.0099-0.0100 ms at qwen2-1.5b's
//     block prefill (Hq 12 over 2) and 0.0195-0.0196 -> 0.0206-0.0207 at
//     mixtral-8x7b's (32 over 8), where kernel 4 gains at most 2 % (0.0110-
//     0.0111 -> 0.0111-0.0112, 0.0233-0.0235 -> 0.0230).
//     At D 256 it is 224 before any address or fragment of K and V, and
//     the build below already takes 246 without Q's 64: they would not fit
//     the 255 a thread may hold.  So past D 128 the CTA's 64 query rows
//     are staged once in shared memory, bf16, in rows padded by 16 bytes
//     (the K/V rows' layout: eight ldmatrix rows fall in eight distinct
//     16-byte bank groups at every D that is a multiple of 16), and each
//     k-step's A fragment is read with ldmatrix.x4, as FlashAttention-2
//     does at this head dim: one ldmatrix a k-step and 64 (D + 8) x 2
//     bytes of shared memory (33,792 at D 256) for D / 4 registers.  Two
//     warps a 16-row band, each with half of D's columns, would halve the
//     accumulator too, but need P and the row statistics exchanged through
//     shared memory every tile; wgmma would need the paged rows in its
//     swizzled layout.  Neither is needed: ptxas (CUDA 12.8, sm_90a) fits
//     the one-warp band in 213 registers at D 160 and 246 at D 256 with
//     contiguous rows, 168 and 243 with paged ones, with no spill store
//     (chip_smoke.py's [geometry] lines print them);
//   * f32 (held to 1e-4) alone runs FMA loops over the same tiles, 256
//     threads each owning 4 rows, in the same split layout.  One TF32
//     product would miss 1e-4, but three of split operands meet it, as
//     kernel 3's float32 path (flash_aligned.cu) and the SSD scan show: a
//     tensor-core f32 path here is open work, not a limit of the format.
//
// Shared memory (bf16): two K/V stages of 2 x 64 x (D + 8) x 2 bytes
// (67,584 at D 256), the Q tile past D 128, the row statistics, the
// combine's weights and the stages' row flags: 172,544 bytes at D 256 plus
// the page table's run, within the 232,448 a block may have; the f32
// partial accumulator (64 x (D + 4) x 4 bytes) aliases the stages after the
// tile walk.  What bounds the work is bytes: at gemma-2b's block prefill
// (8 slots of 8 tokens, 8 heads of 256 over one kv head, chip_smoke.py's
// cursors) the K/V rows some query sees, Q and the output are 1.93 MB,
// 0.58 us at 3.35 TB/s, against 89 MFLOP of products, 0.09 us at the
// tensor cores' bf16 peak; at stablelm-12b's (32 heads of 160 over 8)
// 8.3 MB and 0.22 GFLOP, 2.5 us and 0.22 us.  What is left is latency:
// the CTAs in flight, each walking one or two tiles.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace flash {

namespace cg = cooperative_groups;

// ---------------------------------------------------------------------------
// Helpers (also used by flash_aligned.cu)
// ---------------------------------------------------------------------------

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // .x = lo, low half
  return *reinterpret_cast<uint32_t*>(&p);
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8 x 8 b16 matrices: lanes 8m..8m+7 give the row addresses of matrix
// m, and r[m] receives its fragment (lane l: row l / 4, columns 2 (l % 4)
// and 2 (l % 4) + 1)
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* row) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// four 8 x 8 b16 matrices, transposed: lanes 8m..8m+7 give the row addresses
// of matrix m, and r[m] receives its transpose's fragment
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* row) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// 16 bytes global -> shared, asynchronous; zero-filled (nothing read) when
// !pred, and src must still be a valid address then
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b,
                                       float c, float d) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(a, b), pack_bf16(c, d));
}

// ---------------------------------------------------------------------------
// Row sources
// ---------------------------------------------------------------------------

// cap(): logical rows a sample can hold.  load_table() stages what row()
// needs for the rows [s0, s1) a CTA walks (run_ints(s1 - s0) ints at most)
// and returns its first page.  row(): the index of logical cache row s of
// sample b in the (rows, Hkv, D) array, or -1 when the row does not exist
// (masked, never read).
struct ContigRows {
  int Sk;
  __host__ __device__ int cap() const { return Sk; }
  __host__ __device__ int run_ints(int) const { return 0; }
  __device__ int load_table(int*, int, int, int, int, int) const { return 0; }
  __device__ long long row(const int*, int, int b, int s) const {
    return (long long)b * Sk + s;
  }
};

struct PagedRows {
  const int* table;  // (B, max_pages), -1 = unmapped
  int n_pages, page_size, max_pages;
  __host__ __device__ int cap() const { return max_pages * page_size; }
  __host__ __device__ int run_ints(int rows) const {
    const int n = (rows + page_size - 1) / page_size + 1;
    return n < max_pages ? n : max_pages;
  }
  __device__ int load_table(int* sPT, int b, int s0, int s1, int tid,
                            int nt) const {
    const int p0 = s0 / page_size;
    const int p1 = min(max_pages, (s1 + page_size - 1) / page_size);
    for (int i = p0 + tid; i < p1; i += nt)
      sPT[i - p0] = table[(size_t)b * max_pages + i];
    return p0;
  }
  __device__ long long row(const int* sPT, int p0, int, int s) const {
    const int pg = sPT[s / page_size - p0];
    return pg >= 0 && pg < n_pages ? (long long)pg * page_size + s % page_size
                                   : -1;
  }
};

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

constexpr int BM = 64;         // query rows per CTA
constexpr int BN = 64;         // cache rows per logical kv tile
constexpr int MAX_SPLIT = 8;   // CTAs per cluster at most (the portable size)
constexpr float NEG_INIT = -1e30f;  // running max before any key
constexpr float LOG2E = 1.4426950408889634f;
constexpr size_t SMEM_MAX = 232448;  // dynamic shared memory of one block

struct Params {
  const void *q, *k, *v;
  void* o;
  const int *q_offset, *kv_len;
  int Sq, Hq, Hkv, causal, window;
  int split;         // S, the cluster size
  float scale_log2;  // log2(e) / sqrt(D)
};

template <typename T, int D, bool MMA>
struct Cfg {
  static constexpr int NT = MMA ? 128 : 256;
  // MMA: Q's A fragments read from a shared tile, not held in registers
  static constexpr bool QSM = MMA && D > 128;
  static constexpr int LDK = D + 16 / (int)sizeof(T);  // staged K/V row (+16 B)
  static constexpr int LDA = D + 4;                     // partial acc row, f32
  static constexpr int LDQ = D + 1;                     // FMA: Q row, f32
  static constexpr int LDP = BN + 1;                    // FMA: score row, f32
  static constexpr size_t stage_bytes = 2 * BN * LDK * sizeof(T);  // K + V
  // QSM: the Q tile in K/V's row layout; FMA: sQ, sP
  static constexpr size_t q_bytes =
      MMA ? (QSM ? sizeof(T) * (size_t)(BM * LDK) : 0)
          : sizeof(float) * (size_t)(BM * LDQ + BM * LDP);
  // the Q tile (or sQ, sP); m, l, corr, l_total (BM each), e (MAX_SPLIT x
  // BM), the row flags of each stage (BN ints)
  static constexpr size_t fixed_bytes(int stages) {
    return q_bytes + sizeof(float) * (size_t)(4 * BM + MAX_SPLIT * BM) +
           sizeof(int) * (size_t)(stages * BN);
  }
  static constexpr int STAGES =
      (MMA || 2 * stage_bytes + fixed_bytes(2) <= 200 * 1024) ? 2 : 1;
  static constexpr size_t stage_area = STAGES * stage_bytes;
  static constexpr size_t base_bytes = stage_area + fixed_bytes(STAGES);
  static_assert(sizeof(float) * BM * LDA <= stage_area,
                "the partial accumulator aliases the staging buffers");
  static_assert(base_bytes <= SMEM_MAX, "tiles exceed shared memory");
};

template <typename T, int D, bool MMA, class Rows>
__global__ void __launch_bounds__(Cfg<T, D, MMA>::NT)
flash_block_kernel(const Params p, const Rows rows) {
  using C = Cfg<T, D, MMA>;
  constexpr int NT = C::NT, LDK = C::LDK, LDA = C::LDA;
  extern __shared__ __align__(16) unsigned char smem[];
  T* const stage0 = reinterpret_cast<T*>(smem);
  float* const sAcc = reinterpret_cast<float*>(smem);  // after the tile loop
  T* const sQt = reinterpret_cast<T*>(smem + C::stage_area);         // QSM
  float* const sQ = reinterpret_cast<float*>(smem + C::stage_area);  // FMA
  float* const sP = sQ + BM * C::LDQ;                                // FMA
  float* const sM =
      reinterpret_cast<float*>(smem + C::stage_area + C::q_bytes);
  float* const sL = sM + BM;
  float* const sC = sL + BM;
  float* const sLt = sC + BM;
  float* const sE = sLt + BM;
  int* const sOK = reinterpret_cast<int*>(sE + MAX_SPLIT * BM);
  int* const sPT = sOK + C::STAGES * BN;

  cg::cluster_group cluster = cg::this_cluster();
  const int S = p.split;
  const int rank = (int)cluster.block_rank();  // blockIdx.x % S
  const int r0 = (blockIdx.x / S) * BM;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int Sq = p.Sq, group = p.Hq / p.Hkv;
  const int live = min(BM, group * Sq - r0);  // query rows of this CTA
  const int qoff = p.q_offset[b], klen = p.kv_len[b];

  // the sample's band, its tiles, and this rank's run of them
  int hi = min(klen, rows.cap());
  if (p.causal) hi = min(hi, qoff + Sq);
  const int lo = p.window > 0 ? max(0, qoff - p.window + 1) : 0;
  const int t_lo = lo / BN;
  const int n = hi > lo ? (hi + BN - 1) / BN - t_lo : 0;
  const int per = (n + MAX_SPLIT - 1) / MAX_SPLIT;
  const int t0 = t_lo + min(n, rank * per);
  const int ntiles = t_lo + min(n, (rank + 1) * per) - t0;

  const int p0 = rows.load_table(sPT, b, t0 * BN, (t0 + ntiles) * BN, tid, NT);
  if (tid < BM) {
    sM[tid] = NEG_INIT;
    sL[tid] = 0.f;
  }

  const size_t rstride = (size_t)p.Hkv * D;  // elements between cache rows
  const T* const kb = static_cast<const T*>(p.k) + (size_t)kvh * D;
  const T* const vb = static_cast<const T*>(p.v) + (size_t)kvh * D;
  __syncthreads();  // sPT

  auto load_tile = [&](int tile, int st) {
    constexpr int EPC = 16 / (int)sizeof(T);  // elements per 16-byte copy
    constexpr int CH = D / EPC;               // copies per row
    T* const dK = stage0 + (size_t)st * 2 * BN * LDK;
    T* const dV = dK + BN * LDK;
    int* const ok = sOK + st * BN;
    const int s0 = tile * BN;
    for (int idx = tid; idx < BN * CH; idx += NT) {
      const int c = idx / CH, x = idx % CH;
      const int s = s0 + c;
      const long long r = s >= lo && s < hi ? rows.row(sPT, p0, b, s) : -1;
      const size_t off = r >= 0 ? (size_t)r * rstride + x * EPC : 0;
      cp_async16(dK + c * LDK + x * EPC, kb + off, r >= 0);
      cp_async16(dV + c * LDK + x * EPC, vb + off, r >= 0);
      if (x == 0) ok[c] = r >= 0;
    }
    cp_async_commit();
  };

  // the absolute position of query row r of the tile, and its mask
  auto qpos_of = [&](int r) { return qoff + (r0 + r) % Sq; };
  auto visible = [&](int r, int kpos, int qpos, const int* ok, int c) {
    bool vis = r < live && ok[c];
    if (p.causal) vis = vis && kpos <= qpos;
    if (p.window > 0) vis = vis && kpos > qpos - p.window;
    return vis;
  };

  // ---- per-thread state of the two compute paths --------------------------
  const int warp = tid / 32, lane = tid % 32;
  // MMA: warp w owns rows 16w + g and 16w + g + 8
  const int g = lane / 4, t = lane % 4;
  const int ra = warp * 16 + g, rb = ra + 8;
  const bool wlive = MMA ? warp * 16 < live : warp * 8 < live;
  uint32_t qf[MMA && !C::QSM ? D / 16 : 1][4];
  float acc_m[MMA ? D / 8 : 1][4];
  float m_a = NEG_INIT, m_b = NEG_INIT, l_a = 0.f, l_b = 0.f;
  // FMA: thread (tx, ty) owns rows 4 ty + a, columns tx + 16 j
  const int tx = tid % 16, ty = tid / 16;
  float acc_f[MMA ? 1 : 4][MMA ? 1 : D / 16];

  if constexpr (MMA) {
#pragma unroll
    for (int nn = 0; nn < D / 8; ++nn)
      acc_m[nn][0] = acc_m[nn][1] = acc_m[nn][2] = acc_m[nn][3] = 0.f;
    if constexpr (C::QSM) {
      // the live warps' rows as 16-byte copies, committed with the first
      // tile's; rows past `live` zero-filled (read by ldmatrix, never stored)
      constexpr int EPC = 16 / (int)sizeof(T), CH = D / EPC;
      const int nrows = ntiles > 0 ? min(BM, (live + 15) & ~15) : 0;
      for (int idx = tid; idx < nrows * CH; idx += NT) {
        const int r = idx / CH, x = idx % CH;
        const int rr = r0 + min(r, live - 1);
        cp_async16(sQt + r * LDK + x * EPC,
                   static_cast<const T*>(p.q) +
                       (((size_t)b * Sq + rr % Sq) * p.Hq + kvh * group +
                        rr / Sq) * D + x * EPC,
                   r < live);
      }
    } else if (wlive) {
      auto qrow = [&](int r) {
        const int rr = r0 + min(r, live - 1);
        return reinterpret_cast<const uint32_t*>(
            static_cast<const T*>(p.q) +
            (((size_t)b * Sq + rr % Sq) * p.Hq + kvh * group + rr / Sq) * D);
      };
      const uint32_t* qa = qrow(ra);
      const uint32_t* qb = qrow(rb);
      const bool la = ra < live, lb = rb < live;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        qf[kk][0] = la ? qa[kk * 8 + t] : 0u;
        qf[kk][1] = lb ? qb[kk * 8 + t] : 0u;
        qf[kk][2] = la ? qa[kk * 8 + 4 + t] : 0u;
        qf[kk][3] = lb ? qb[kk * 8 + 4 + t] : 0u;
      }
    }
  } else {
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc_f[a][j] = 0.f;
    for (int idx = tid; idx < BM * D; idx += NT) {
      const int r = idx / D, d = idx % D;
      float val = 0.f;
      if (r < live) {
        const int rr = r0 + r;
        val = to_f(static_cast<const T*>(p.q)[
            (((size_t)b * Sq + rr % Sq) * p.Hq + kvh * group + rr / Sq) * D + d]);
      }
      sQ[r * C::LDQ + d] = val;
    }
  }

  // ---- the tile walk ------------------------------------------------------
  for (int i = 0; i < ntiles; ++i) {
    const int st = C::STAGES == 2 ? (i & 1) : 0;
    if (i == 0 || C::STAGES == 1) load_tile(t0 + i, st);
    if (C::STAGES == 2 && i + 1 < ntiles) {
      load_tile(t0 + i + 1, st ^ 1);  // read by iteration i - 1, now free
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* const cK = stage0 + (size_t)st * 2 * BN * LDK;
    const T* const cV = cK + BN * LDK;
    const int* const ok = sOK + st * BN;
    const int kt = (t0 + i) * BN;

    if constexpr (MMA) {
      if (wlive) {
        constexpr int NS = BN / 8;
        float s[NS][4];
#pragma unroll
        for (int nn = 0; nn < NS; ++nn) s[nn][0] = s[nn][1] = s[nn][2] = s[nn][3] = 0.f;
        // ldmatrix rows: Q's A fragment (rows 0-7 / 8-15 x columns 0-7 /
        // 8-15 of the warp's band), K's B fragments of n-tiles nn, nn + 1
        // (keys 0-7 / 8-15 x features 0-7 / 8-15 of the k-step)
        const T* const qr =
            sQt + (warp * 16 + (lane & 15)) * LDK + (lane >> 4) * 8;
        const T* const kr =
            cK + ((lane >> 4) * 8 + (lane & 7)) * LDK + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t af[4];
          if constexpr (C::QSM) {
            ldsm_x4(af, qr + kk * 16);
          } else {
            af[0] = qf[kk][0], af[1] = qf[kk][1], af[2] = qf[kk][2],
            af[3] = qf[kk][3];
          }
#pragma unroll
          for (int nn = 0; nn < NS; nn += 2) {
            uint32_t bk[4];
            ldsm_x4(bk, kr + nn * 8 * LDK + kk * 16);
            mma_bf16(s[nn], af, bk[0], bk[1]);
            mma_bf16(s[nn + 1], af, bk[2], bk[3]);
          }
        }
        const int qa = qpos_of(ra), qb = qpos_of(rb);
        float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
        for (int nn = 0; nn < NS; ++nn) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = nn * 8 + 2 * t + (e & 1);
            const bool vis = e < 2 ? visible(ra, kt + c, qa, ok, c)
                                   : visible(rb, kt + c, qb, ok, c);
            s[nn][e] = vis ? s[nn][e] * p.scale_log2 : -INFINITY;
          }
          mx_a = fmaxf(mx_a, fmaxf(s[nn][0], s[nn][1]));
          mx_b = fmaxf(mx_b, fmaxf(s[nn][2], s[nn][3]));
        }
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
        const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
        const float corr_a = exp2f(m_a - mn_a), corr_b = exp2f(m_b - mn_b);
        m_a = mn_a;
        m_b = mn_b;
        float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
        for (int nn = 0; nn < NS; ++nn) {
          s[nn][0] = exp2f(s[nn][0] - mn_a);  // exp2(-inf) = 0
          s[nn][1] = exp2f(s[nn][1] - mn_a);
          s[nn][2] = exp2f(s[nn][2] - mn_b);
          s[nn][3] = exp2f(s[nn][3] - mn_b);
          sum_a += s[nn][0] + s[nn][1];
          sum_b += s[nn][2] + s[nn][3];
        }
        l_a = l_a * corr_a + sum_a;  // this thread's columns; summed at the end
        l_b = l_b * corr_b + sum_b;
#pragma unroll
        for (int nn = 0; nn < D / 8; ++nn) {
          acc_m[nn][0] *= corr_a;
          acc_m[nn][1] *= corr_a;
          acc_m[nn][2] *= corr_b;
          acc_m[nn][3] *= corr_b;
        }
        // O += P V: two score n-tiles make one A fragment of 16 keys
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) {
          const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                  pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                  pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                  pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
          const T* vr = &cV[(kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LDK +
                            (lane >> 4) * 8];
#pragma unroll
          for (int nn = 0; nn < D / 8; nn += 2) {
            uint32_t bv[4];
            ldsm_x4_trans(bv, vr + nn * 8);
            mma_bf16(acc_m[nn], pa, bv[0], bv[1]);
            mma_bf16(acc_m[nn + 1], pa, bv[2], bv[3]);
          }
        }
      }
    } else {
      constexpr int LDQ = C::LDQ, LDP = C::LDP;
      if (wlive) {  // scores for rows 4 ty + a, columns tx + 16 j
        float sc[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[a][j] = 0.f;
#pragma unroll 4
        for (int d = 0; d < D; ++d) {
          float qv[4], kv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) qv[a] = sQ[(ty * 4 + a) * LDQ + d];
#pragma unroll
          for (int j = 0; j < 4; ++j) kv[j] = to_f(cK[(tx + 16 * j) * LDK + d]);
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int j = 0; j < 4; ++j) sc[a][j] = fmaf(qv[a], kv[j], sc[a][j]);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int r = ty * 4 + a;
          const int qpos = qpos_of(r);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = tx + 16 * j;
            sP[r * LDP + c] = visible(r, kt + c, qpos, ok, c)
                                  ? sc[a][j] * p.scale_log2 : -INFINITY;
          }
        }
      }
      __syncthreads();
      if (wlive) {  // online softmax, four threads a row
        const int r = tid / 4, part = tid % 4;
        float mx = -INFINITY;
        for (int c = part; c < BN; c += 4) mx = fmaxf(mx, sP[r * LDP + c]);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_old = sM[r];
        const float m_new = fmaxf(m_old, mx);
        float sum = 0.f;
        for (int c = part; c < BN; c += 4) {
          const float pr = exp2f(sP[r * LDP + c] - m_new);  // exp2(-inf) = 0
          sP[r * LDP + c] = pr;
          sum += pr;
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        if (part == 0) {
          const float corr = exp2f(m_old - m_new);
          sC[r] = corr;
          sL[r] = sL[r] * corr + sum;
          sM[r] = m_new;
        }
      }
      __syncthreads();
      if (wlive) {  // acc = acc * corr + P V
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float corr = sC[ty * 4 + a];
#pragma unroll
          for (int j = 0; j < D / 16; ++j) acc_f[a][j] *= corr;
        }
#pragma unroll 4
        for (int c = 0; c < BN; ++c) {
          float pr[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) pr[a] = sP[(ty * 4 + a) * LDP + c];
#pragma unroll
          for (int j = 0; j < D / 16; ++j) {
            const float vv = to_f(cV[c * LDK + tx + 16 * j]);
#pragma unroll
            for (int a = 0; a < 4; ++a) acc_f[a][j] = fmaf(pr[a], vv, acc_f[a][j]);
          }
        }
      }
    }
    __syncthreads();  // this stage's reads are done before it is refilled
  }
  __syncthreads();  // the staging area becomes sAcc

  // ---- this rank's partial (m, l, acc) ------------------------------------
  if constexpr (MMA) {
    if (wlive) {
      l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
      l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
      if (t == 0) {
        sM[ra] = m_a;
        sL[ra] = l_a;
        sM[rb] = m_b;
        sL[rb] = l_b;
      }
#pragma unroll
      for (int nn = 0; nn < D / 8; ++nn) {
        const int col = nn * 8 + 2 * t;
        *reinterpret_cast<float2*>(&sAcc[ra * LDA + col]) =
            make_float2(acc_m[nn][0], acc_m[nn][1]);
        *reinterpret_cast<float2*>(&sAcc[rb * LDA + col]) =
            make_float2(acc_m[nn][2], acc_m[nn][3]);
      }
    }
  } else {
    if (wlive) {
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int j = 0; j < D / 16; ++j)
          sAcc[(ty * 4 + a) * LDA + tx + 16 * j] = acc_f[a][j];
    }
  }
  cluster.sync();  // every rank's partial is written and visible

  // ---- the combine, in rank order ------------------------------------------
  for (int r = tid; r < live; r += NT) {
    float mj[MAX_SPLIT];
    float M = NEG_INIT;
#pragma unroll
    for (int j = 0; j < MAX_SPLIT; ++j) {
      if (j < S) {
        mj[j] = *cluster.map_shared_rank(sM + r, j);
        M = fmaxf(M, mj[j]);
      }
    }
    float L = 0.f;
#pragma unroll
    for (int j = 0; j < MAX_SPLIT; ++j) {
      if (j < S) {
        const float e = exp2f(mj[j] - M);
        sE[j * BM + r] = e;
        L = fmaf(*cluster.map_shared_rank(sL + r, j), e, L);
      }
    }
    sLt[r] = fmaxf(L, 1e-30f);
  }
  __syncthreads();
  constexpr int D4 = D / 4;
  T* const out = static_cast<T*>(p.o);
  for (int idx = rank * NT + tid; idx < live * D4; idx += S * NT) {
    const int r = idx / D4, c = (idx % D4) * 4;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int j = 0; j < MAX_SPLIT; ++j) {
      if (j < S) {
        const float4 a = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(sAcc + r * LDA + c, j));
        const float e = sE[j * BM + r];
        o.x = fmaf(a.x, e, o.x);
        o.y = fmaf(a.y, e, o.y);
        o.z = fmaf(a.z, e, o.z);
        o.w = fmaf(a.w, e, o.w);
      }
    }
    const float l = sLt[r];
    const int rr = r0 + r;
    store4(out + (((size_t)b * Sq + rr % Sq) * p.Hq + kvh * group + rr / Sq) * D + c,
           o.x / l, o.y / l, o.z / l, o.w / l);
  }
  cluster.sync();  // no rank leaves while another still reads its memory
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

// plan (when not null) receives {CTAs, cluster size, threads a CTA, dynamic
// shared memory bytes, registers a thread, stages} and nothing is launched
template <typename T, int D, class Rows>
cudaError_t launch(Params p, const Rows& rows, int B, cudaStream_t stream,
                   int* plan) {
  constexpr bool MMA = std::is_same<T, __nv_bfloat16>::value;  // f32: FMA
  using C = Cfg<T, D, MMA>;
  void (*kern)(const Params, const Rows) = flash_block_kernel<T, D, MMA, Rows>;
  // once per instantiation (and process), not once per launch
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_MAX);
  if (attr != cudaSuccess) return attr;
  const int tiles = (rows.cap() + BN - 1) / BN;
  const int per_max = (tiles + MAX_SPLIT - 1) / MAX_SPLIT;  // tiles a rank
  const size_t smem =
      C::base_bytes + sizeof(int) * (size_t)rows.run_ints(per_max * BN);
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  int S = 1;
  while (S < MAX_SPLIT && S < tiles) S *= 2;
  p.split = S;
  const int qrows = p.Hq / p.Hkv * p.Sq;
  const dim3 grid((unsigned)(((qrows + BM - 1) / BM) * S), p.Hkv, B);
  if (plan) {
    cudaFuncAttributes fa;
    const cudaError_t err = cudaFuncGetAttributes(&fa, kern);
    if (err != cudaSuccess) return err;
    plan[0] = (int)(grid.x * grid.y * grid.z);
    plan[1] = S;
    plan[2] = C::NT;
    plan[3] = (int)smem;
    plan[4] = fa.numRegs;
    plan[5] = C::STAGES;
    return cudaSuccess;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(C::NT, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = S;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kern, p, rows);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, class Rows>
cudaError_t dispatch_d(const Params& p, const Rows& rows, int B, int D,
                       cudaStream_t s, int* plan) {
#define FB_CASE(DD) \
  case DD:          \
    return launch<T, DD>(p, rows, B, s, plan);
  switch (D) {
    FB_CASE(16) FB_CASE(32) FB_CASE(48) FB_CASE(64)
    FB_CASE(80) FB_CASE(96) FB_CASE(112) FB_CASE(128)
    FB_CASE(144) FB_CASE(160) FB_CASE(176) FB_CASE(192)
    FB_CASE(208) FB_CASE(224) FB_CASE(240) FB_CASE(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef FB_CASE
}

// dtype: 0 = float32, 1 = bfloat16
template <class Rows>
cudaError_t dispatch(const Params& p, const Rows& rows, int B, int D, int dtype,
                     cudaStream_t s, int* plan) {
  if (dtype == 0) return dispatch_d<float>(p, rows, B, D, s, plan);
  if (dtype == 1) return dispatch_d<__nv_bfloat16>(p, rows, B, D, s, plan);
  return cudaErrorInvalidValue;
}

}  // namespace flash
