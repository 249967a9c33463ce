// Mamba2 SSD scan for Hopper (sm_90a), forward and backward, CUDA C++ with
// plain C entry points loaded through ctypes.
//
// Replaces: src/repro/kernels/ssd_scan.py::ssd_scan_pallas (body
// _ssd_kernel), the fused chunk scan whose XLA twin is
// repro.models.ssm.ssd_chunked.  The port's models/ssm.ssd_chunked calls
// it on every cache-free forward of a mamba2 layer (Fisher probe, sparse
// fine-tune, pooled features, evaluation).  The backward has no TPU
// counterpart: the JAX package never differentiates the Pallas kernel and
// takes its gradients from XLA's autodiff of ssd_chunked.  Here the
// gradient is this file's second kernel, so the plain version never runs
// on the card's training path.
//
// Contract, per batch row b and head h, over tokens t = 0..S-1, with the
// (P, N) state S_{-1} = init (zeros when null):
//   S_t = exp(dt_t a_h) S_{t-1} + (x_t dt_t) (x) B_t     y_t = S_t C_t
// x (B,S,H,P) and B, C (B,S,N) share one dtype (float32 or bfloat16);
// dt (B,S,H), a (H,), init (B,H,P,N) and every output are float32.
//
// Forward (ssd_fwd_kernel).  The Pallas grid walks the chunk axis in order
// and keeps the state in VMEM; on Hopper blocks run in no order, so one CTA
// takes HPC consecutive heads of one batch row and loops over the sequence
// in tiles of FT = 64 tokens, whatever the model's chunk (the chunk is only
// a blocking of the same recurrence).  Per tile, with each head's cum =
// cumsum(dt a) inside the tile:
//   G   = C B^T                      once a CTA: B and C are the same for
//                                    every head of a batch row
//   W'  = G . L . dt_j,  L_ij = exp(cum_i - cum_j) for j <= i, else 0
//   y   = W' x + exp(cum) . (C S^T)
//   S  <- S exp(cum_last) + x^T (B . dt exp(cum_last - cum))
// dt goes into W' and into B, so x is used as it came: with bf16 inputs x,
// B and C are exact in TF32.  How it runs:
//   * Every product is on the tensor cores (mm_sum/tile_mm: mma.sync
//     m16n8k8 TF32).  An operand exact in TF32 is used once; any other is
//     split into a TF32 head and a TF32 residual, both rounded to nearest
//     (cvt.rna), and the products that matter are summed.  bf16 inputs:
//     C B^T one product, W' x two (W' split), C S^T two (S split), the
//     update two (B . dt decay split); float32 inputs: three products
//     everywhere (3xTF32).  Both meet float32's 1e-4 bar, which one product
//     of rounded operands everywhere (the backward's bf16 choice) misses;
//     tests/test_torch_ssd_scan.py emulates both.
//   * HPC, the heads of a CTA, is set by shared-memory arithmetic: the
//     largest power of two up to 8 dividing H whose CTA fits twice in an
//     SM (233,472 B, 1 KB of it reserved a CTA), else the largest that fits
//     once (fwd_geometry).  8 warps a CTA, 8 / HPC a head: a warp a head
//     forms its cum and decays, all warps form G's ten lower 16 x 16
//     blocks, then a head's warps take its 16-row blocks of y in snake
//     order (block r sums 16 (r + 1) tokens of W' x) and its 16 x 16 blocks
//     of the state update.  At the adapt shape (B 48, S 64, H 64, P 64,
//     N 128, bf16): HPC 4, 768 CTAs of 91,136 B, two an SM.
//   * A head's state lives in shared memory only when some tile needs it:
//     one tile with no initial state and no final state asked for (the
//     adapt shape, S 64) has none.  Otherwise work no output needs is
//     skipped as before: the state terms of tile 0 without an initial
//     state, the update after the last tile without a final state.
//   * B, C, the CTA's heads of x (contiguous in a token) and dt are copied
//     with cp.async straight into padded tiles of the inputs' own type (16
//     bytes a copy when the widths and pointers allow, else 4; rows past
//     the sequence are zero-filled, so they add nothing and leave cum
//     flat), double-buffered when there are two tiles or more and both
//     stages fit: tile t + 1 is in flight while t computes.  Rows are
//     padded to 4 words past a multiple of 32 where a fragment reads them
//     as A (row g, column t) and 8 words past where it reads them as B
//     (row t, column g), so a fragment load meets no bank twice.
//   * W' is formed inside the fragment loads, one exp an element and once a
//     head: a warp holds all 64 columns of its row block of y (NB 8).
//   * EXACT (P a multiple of 64, N of 16) drops the bounds checks; other
//     widths (multiples of 4) take the checked instantiation (NB 2): a
//     choice by shape.
// The final state is an optional output: the cache-free path does not ask
// for it (it would be 100.7 MB of float32 a call at the adapt shape).
//
// Backward (ssd_bwd_kernel, then reduce_groups).  Given dy (the final
// state is not differentiable), one CTA per (b, h) walks the tiles in
// reverse with the adjoint dS of the state leaving the tile in shared
// memory, and recomputes the tile's W and L.  With u = x dt:
//   du_j  = sum_{i>=j} W_ij dy_i + exp(cum_last - cum_j) dS B_j
//   dC_i  = sum_{j<=i} (dy_i.u_j) L_ij B_j + exp(cum_i) S_in^T dy_i
//   dB_j  = sum_{i>=j} (dy_i.u_j) L_ij C_i + exp(cum_last - cum_j) dS^T u_j
//   dcum  from L, from exp(cum) in the inter-tile term and from the two
//         decays of the state update; d(dt a) is its reverse cumulative
//         sum inside the tile (the carry across tiles flows through dS)
//   dx = dt du,  d(dt) = x.du + a d(dt a),
//   dS <- exp(cum_last) dS + sum_i exp(cum_i) dy_i (x) C_i
// How it runs (the Hopper design):
//   * S_in is recomputed by the CTA itself: before the reverse walk it walks
//     the tiles forward from the initial state (zeros when null) through
//     the state update alone.  The state entering the last tile stays in
//     shared memory; only the states entering tiles 1 .. nt-2 go to a
//     scratch (B, H, nt-2, P, N), so a sequence of at most two tiles (the
//     adapt shape's 64 tokens) writes none.  Longer sequences (the Pallas
//     chunk of 256, the five-tile tests) keep that scratch, read back once
//     each in the reverse walk.  No forward launch, no 201 MB round trip.
//   * dB and dC sum over heads.  The CTAs of a (b, h) are launched in
//     thread-block clusters of CL consecutive heads (CL the largest divisor
//     of H up to 8: 8 at mamba2's 64 heads).  Each CTA leaves its head's
//     dB and dC tile in shared memory; after a cluster barrier rank r sums
//     rows [r T / CL, (r + 1) T / CL) of both over the CL ranks, in rank
//     order, through distributed shared memory, and writes one partial per
//     (b, group of CL heads, s); a second barrier keeps its memory alive.
//     reduce_groups then sums the H / CL group partials in group order (2 x
//     12.6 MB at the adapt shape, against 2 x 100.7 MB of per-head partials
//     before); with one group the cluster writes dB and dC itself.
//   * Every tile product runs on the tensor cores (tile_mm: mma.sync
//     m16n8k8 TF32, a warp a 16 x 16 output block, one A fragment feeding
//     two products; C B^T and dy u^T run side by side on the two halves of
//     the warps).  With float32 inputs each operand is split into a TF32
//     head and a TF32 residual and three products are summed (3xTF32:
//     float32 accuracy, the 1e-4 bar); with bf16 inputs (held to 2e-2) one
//     TF32 product, its operands rounded to nearest (not truncated).  Rows are padded to 4 words past a multiple of 32, so a
//     fragment load meets at most two lanes a bank.  Row sums of an
//     epilogue (x.du, the decay terms of dcum) go to per-block partials
//     summed in a fixed order, so no (T, P) or (T, N) buffer holds them.
//     EXACT (P and N multiples of 16) drops the bounds checks; other widths
//     (multiples of 4) take the checked instantiation: a choice by shape.
//   * The next tile's x, dt, B, C and dy are copied into a staging area
//     with cp.async while the CTA computes on the current one.
//   * 512 threads (16 warps) a CTA and 208,960 B of shared memory at P 64,
//     N 128 in bf16 (the state and its adjoint alone take 66 KB), so one
//     CTA an SM: two would need half of that.
// Every sum runs in a fixed order (no atomics), so the gradients and the
// Fisher scores built on them are the same from run to run.  a and init
// get no gradient (the wrapper refuses them).
//
// The forward too sums in a fixed order, so y is the same from run to
// run.  Both kernels take P and N in multiples of 4.
//
// What bounds it on this card.  At the adapt shape the forward must move
// 77.9 MB (0.023 ms at 3.35 TB/s); its TF32 products, splits included,
// are about 2.5 GFLOP (0.005 ms at the TF32 rate): bytes bound it, so the
// design reads each input once, keeps G, W' and the states on the SM and
// keeps loads in flight (two CTAs an SM, cp.async).  The backward moves
// 105.4 MB and does about 13 GFLOP (the in-CTA recomputation included),
// 0.03 ms at the bytes' rate.  With the products on TF32 tensor cores,
// what remains around them is the barriers of each 32-token tile, the
// staging, the cluster combine and the row sums, with one CTA an SM to
// hide them.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "tf32.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int TILE = 32;      // backward: tokens per tile, a lane a row
constexpr int FT = 64;        // forward: tokens per tile
constexpr int THREADS = 256;  // forward (8 warps) and the group reduction
constexpr int FWARPS = THREADS / 32;
constexpr int MAX_HPC = 8;    // forward: heads a CTA at most
constexpr int BT = 512;       // backward: 16 warps
constexpr int BWARPS = BT / 32;
constexpr int MAX_CLUSTER = 8;  // CTAs (heads) a cluster, the portable size

// A row of n words padded to r more than a multiple of 32 words: r = 4 for
// rows a fragment reads as A (lanes 4g + t at row g, column t), r = 8 for
// rows it reads as B (row t, column g); either way a load meets no bank
// twice.  The backward pads every row to 4 (at most two lanes a bank).
__host__ __device__ constexpr int ldw(int n, int r) {
  return n + (r + 32 - n % 32) % 32;
}
__host__ __device__ constexpr int ld4(int n) { return ldw(n, 4); }
constexpr int TB = ld4(TILE);  // 36
constexpr long long MAX_SMEM = 232448;
// a CTA that fits twice in an SM: its 233,472 B less 1 KB reserved a CTA
constexpr long long HALF_SM_SMEM = 233472 / 2 - 1024;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Forward: the dynamic shared memory of a CTA of hpc heads for inputs of
// elt bytes: `stages` staging areas (the B and C tiles and the heads' x in
// the inputs' type, dt in float32), G, three per-head vectors and, with
// `state`, the heads' (P, N) states in float32
long long fwd_smem(int P, int N, int elt, int hpc, int stages, bool state) {
  const long long wb = ldw(N * elt / 4, 4), wx = ldw(hpc * P * elt / 4, 8);
  return 4LL * stages * FT * (2 * wb + wx + hpc) + 4LL * FT * ld4(FT) +
         4LL * 3 * hpc * FT + (state ? 4LL * hpc * P * ld4(N) : 0);
}

struct FwdGeo {
  int hpc, stages;
  bool state;
  long long smem;
};

// The forward's launch at these dims (false when no CTA fits): a state
// when some tile needs one, two stages when there are two tiles or more
// and they fit, and the most heads a CTA (a power of two up to 8 dividing
// H) that fit twice in an SM, else once.
bool fwd_geometry(int S, int H, int P, int N, int elt, bool init, bool fin,
                  FwdGeo* geo) {
  const int nt = (S + FT - 1) / FT;
  const bool state = nt > 1 || init || fin;
  const long long caps[2] = {HALF_SM_SMEM, MAX_SMEM};
  for (int stages = nt > 1 ? 2 : 1; stages >= 1; --stages)
    for (long long cap : caps)
      for (int c = MAX_HPC; c >= 1; c /= 2) {
        const long long sm = fwd_smem(P, N, elt, c, stages, state);
        if (H % c == 0 && sm <= cap) {
          *geo = {c, stages, state, sm};
          return true;
        }
      }
  return false;
}

// state and adjoint, B, C and the dB/dC tiles, x, u and dy, W, G and R, the
// row-sum partials of the du and dC epilogues, seven per-row vectors and
// one slot a warp
// + the staging area of the next tile's inputs (elt bytes an input element)
long long bwd_smem(int P, int N, int elt) {
  const long long ctp = (P + 7) / 8, ctn = (N + 7) / 8;
  return 4LL * (2LL * P * ld4(N) + 4LL * TILE * ld4(N) +
                3LL * TILE * ld4(P) + 3LL * TILE * TB +
                TILE * (2 * ctp + ctn) + 7 * TILE + BWARPS) +
         TILE * (P + 2LL * N) * elt + TILE * P * 4LL + TILE * 4LL;
}

// the cluster of a backward launch: the largest divisor of H up to 8
int bwd_cluster(int H) {
  int cl = MAX_CLUSTER < H ? MAX_CLUSTER : H;
  while (H % cl) --cl;
  return cl;
}

// Inclusive cumsum of dt a over the tile's 32 rows, by warp 0.
__device__ __forceinline__ void tile_cumsum(const float* dts, float av,
                                            float* cum) {
  const int lane = threadIdx.x;
  if (lane < 32) {
    float v = dts[lane] * av;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += o;
    }
    cum[lane] = v;
  }
}

// ---------------------------------------------------------------------------
// Tile products on the tensor cores (TF32 mma.sync), for both kernels
// ---------------------------------------------------------------------------

using tc::mma_tf32;  // tf32.cuh
using tc::tf32;

// d[e] += a b[e] for one k-step of 8 and NB B column blocks, the A
// fragment split once.  Every operand is rounded to its nearest TF32 value
// (cvt.rna): handed the raw float bits, the unit would drop the low 13
// mantissa bits, a truncation toward zero that biases every product the
// same way.  SA (SB) 2: the A (B) operand is a TF32 head plus a TF32
// residual, and the residual's product with the other head is added, small
// terms first; 1: the head alone, which is exact for an operand that is
// exact in TF32 (a bf16 value).  2 and 2 is 3xTF32, float32's accuracy.
template <int SA, int SB, int NB>
__device__ __forceinline__ void mma_step(float (&d)[NB][4],
                                         const float (&a)[4],
                                         const float (&b)[NB][2]) {
  uint32_t ah[4], al[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    ah[i] = tf32(a[i]);
    if constexpr (SA == 2) al[i] = tf32(a[i] - __uint_as_float(ah[i]));
  }
#pragma unroll
  for (int e = 0; e < NB; ++e) {
    const uint32_t bh[2] = {tf32(b[e][0]), tf32(b[e][1])};
    if constexpr (SA == 2) mma_tf32(d[e], al, bh);
    if constexpr (SB == 2) {
      const uint32_t bl[2] = {tf32(b[e][0] - __uint_as_float(bh[0])),
                              tf32(b[e][1] - __uint_as_float(bh[1]))};
      mma_tf32(d[e], ah, bl);
    }
    mma_tf32(d[e], ah, bh);
  }
}

// s[e] += sum_k a(row, k) b(k, col) over k < K for a warp's 16 x 8 NB
// block: this lane's rows ra, rb = ra + 8 and B columns cn + 8 e, in the
// m16n8k8 fragment layout (A: rows g, g + 8 at k = t, t + 4; B: k = t,
// t + 4 at column g).  Operands outside R, C or K read as 0, so any size
// works; EXACT (R a multiple of 16, C of 8 NB, K of 8) drops the checks.
template <int SA, int SB, bool EXACT, int NB, typename A, typename Bf>
__device__ __forceinline__ void mm_sum(float (&s)[NB][4], int K, A a, Bf bf,
                                       int ra, int rb, int cn, int R, int C,
                                       int t) {
#pragma unroll 2
  for (int k = 0; k < K; k += 8) {
    const int k0 = k + t, k1 = k0 + 4;
    const bool i0 = EXACT || k0 < K, i1 = EXACT || k1 < K;
    const bool ia = EXACT || ra < R, ib = EXACT || rb < R;
    const float av[4] = {ia && i0 ? a(ra, k0) : 0.f, ib && i0 ? a(rb, k0) : 0.f,
                         ia && i1 ? a(ra, k1) : 0.f, ib && i1 ? a(rb, k1) : 0.f};
    float bv[NB][2];
#pragma unroll
    for (int e = 0; e < NB; ++e) {
      const bool ic = EXACT || cn + 8 * e < C;
      bv[e][0] = ic && i0 ? bf(k0, cn + 8 * e) : 0.f;
      bv[e][1] = ic && i1 ? bf(k1, cn + 8 * e) : 0.f;
    }
    mma_step<SA, SB, NB>(s, av, bv);
  }
}

// An R x C product of shared-memory operands on the tensor cores: warps w0
// .. w0 + nw - 1 take 16 x 8 NB output blocks in turn (an A fragment feeds
// NB products), sum s1 = sum_{k<K1} a1(row, k) b1(k, col) and s2 over K2
// in k order, and hand each element to out(row, col, s1, s2), which returns
// two values to be summed along the row.  The four lanes of a quad hold whole rows of an
// 8-column block: they add their values in a fixed pattern, and part0 /
// part1 (when not null) receive one partial a (row, 8-column block), at
// row * ceil(C / 8) + block, which a warp adds up in a fixed pattern.
template <int SA, int SB, bool EXACT, int NB = 2, typename A1, typename B1,
          typename A2, typename B2, typename O>
__device__ __forceinline__ void tile_mm(int R, int C, int K1, A1 a1, B1 b1,
                                        int K2, A2 a2, B2 b2, O out,
                                        float* part0, float* part1,
                                        int w0 = 0, int nw = BWARPS) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) - w0;
  const int g = lane >> 2, t = lane & 3;
  const int RT = (R + 15) / 16, CT = (C + 7) / 8, CTB = (CT + NB - 1) / NB;
  for (int w = warp; w < RT * CTB; w += nw) {
    const int ct0 = (w % CTB) * NB, ra = (w / CTB) * 16 + g, rb = ra + 8;
    float s1[NB][4] = {}, s2[NB][4] = {};
    mm_sum<SA, SB, EXACT, NB>(s1, K1, a1, b1, ra, rb, ct0 * 8 + g, R, C, t);
    mm_sum<SA, SB, EXACT, NB>(s2, K2, a2, b2, ra, rb, ct0 * 8 + g, R, C, t);
#pragma unroll
    for (int e = 0; e < NB; ++e) {
      const int ct = ct0 + e, c0 = ct * 8 + 2 * t, c1 = c0 + 1;
      if (!EXACT && ct >= CT) break;  // the same for the whole warp
      float2 va = make_float2(0.f, 0.f), vb = va;
      if (EXACT || (ra < R && c0 < C)) {
        const float2 v = out(ra, c0, s1[e][0], s2[e][0]);
        va.x += v.x;
        va.y += v.y;
      }
      if (EXACT || (ra < R && c1 < C)) {
        const float2 v = out(ra, c1, s1[e][1], s2[e][1]);
        va.x += v.x;
        va.y += v.y;
      }
      if (EXACT || (rb < R && c0 < C)) {
        const float2 v = out(rb, c0, s1[e][2], s2[e][2]);
        vb.x += v.x;
        vb.y += v.y;
      }
      if (EXACT || (rb < R && c1 < C)) {
        const float2 v = out(rb, c1, s1[e][3], s2[e][3]);
        vb.x += v.x;
        vb.y += v.y;
      }
      if (part0 || part1) {
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          va.x += __shfl_xor_sync(0xffffffffu, va.x, off);
          va.y += __shfl_xor_sync(0xffffffffu, va.y, off);
          vb.x += __shfl_xor_sync(0xffffffffu, vb.x, off);
          vb.y += __shfl_xor_sync(0xffffffffu, vb.y, off);
        }
        if (t == 0) {
          if (part0 && ra < R) part0[ra * CT + ct] = va.x;
          if (part0 && rb < R) part0[rb * CT + ct] = vb.x;
          if (part1 && ra < R) part1[ra * CT + ct] = va.y;
          if (part1 && rb < R) part1[rb * CT + ct] = vb.y;
        }
      }
    }
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

// cp.async of BYTES (4 or 16) from src to dst, or zeros there when !in
template <int BYTES>
__device__ __forceinline__ void cp_async_z(void* dst, const void* src,
                                           bool in) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(in ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(in ? 4 : 0)
                 : "memory");
}

// FT rows of rb bytes (a multiple of BYTES), gs bytes apart in device
// memory, to rows ss bytes apart in shared memory; rows from `rows` on are
// zeros (their copies read nothing)
template <int BYTES>
__device__ __forceinline__ void copy_rows(char* dst, int ss, const char* src,
                                          long long gs, int rb, int rows) {
  const int per = rb / BYTES;
  for (int idx = threadIdx.x; idx < FT * per; idx += THREADS) {
    const int i = idx / per, c = idx - i * per;
    const bool in = i < rows;
    cp_async_z<BYTES>(dst + i * ss + c * BYTES,
                      src + (in ? i * gs : 0) + c * BYTES, in);
  }
}

// Starts copying the tile of rows [s0, s0 + rows) of batch row b into a
// staging area (B, C, the heads h0 .. h0 + hpc - 1 of x, their dt) as one
// cp.async group; wb and wx are the padded row widths in words.
template <typename T>
__device__ void fwd_stage(char* dst, const T* __restrict__ x,
                          const float* __restrict__ dt,
                          const T* __restrict__ bm, const T* __restrict__ cm,
                          int b, int h0, int s0, int rows, int S, int H, int P,
                          int N, int hpc, int wb, int wx, bool vec16) {
  constexpr int E = (int)sizeof(T);
  const long long row0 = (long long)b * S + s0;
  char* sb = dst;
  char* sc = sb + 4 * FT * wb;
  char* sx = sc + 4 * FT * wb;
  char* sd = sx + 4 * FT * wx;
  const char* gb = reinterpret_cast<const char*>(bm + row0 * N);
  const char* gc = reinterpret_cast<const char*>(cm + row0 * N);
  const char* gx = reinterpret_cast<const char*>(x + (row0 * H + h0) * P);
  if (vec16) {
    copy_rows<16>(sb, 4 * wb, gb, (long long)N * E, N * E, rows);
    copy_rows<16>(sc, 4 * wb, gc, (long long)N * E, N * E, rows);
    copy_rows<16>(sx, 4 * wx, gx, (long long)H * P * E, hpc * P * E, rows);
  } else {
    copy_rows<4>(sb, 4 * wb, gb, (long long)N * E, N * E, rows);
    copy_rows<4>(sc, 4 * wb, gc, (long long)N * E, N * E, rows);
    copy_rows<4>(sx, 4 * wx, gx, (long long)H * P * E, hpc * P * E, rows);
  }
  copy_rows<4>(sd, 4 * hpc,
               reinterpret_cast<const char*>(dt + row0 * H + h0), 4LL * H,
               4 * hpc, rows);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// One CTA per (b, group of hpc consecutive heads); see the header.  NBY is
// the 8-column blocks of y a warp holds (8 with EXACT: all of P 64).
template <typename T, bool EXACT, int NBY>
__global__ void __launch_bounds__(THREADS, 2)
ssd_fwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ a, const T* __restrict__ bm,
               const T* __restrict__ cm, const float* __restrict__ init,
               float* __restrict__ y, float* __restrict__ final_state,
               int S, int H, int P, int N, int hpc, int stages, int vec16) {
  extern __shared__ __align__(16) char fsm[];
  constexpr int E = (int)sizeof(T);
  // x, B and C as operands: bf16 values are exact in TF32, float32 split
  constexpr int SX = std::is_same<T, float>::value ? 2 : 1;
  const int wb = ldw(N * E / 4, 4), wx = ldw(hpc * P * E / 4, 8);
  const int LB = wb * 4 / E, LX = wx * 4 / E;  // row strides in elements
  const int NS = ld4(N), GS = ld4(FT);
  const int stage_bytes = 4 * FT * (2 * wb + wx + hpc);
  float* G = reinterpret_cast<float*>(fsm + stages * stage_bytes);  // FT x GS
  float* cum = G + FT * GS;          // hpc x FT
  float* ecum = cum + hpc * FT;      // hpc x FT  exp(cum)
  float* fdec = ecum + hpc * FT;     // hpc x FT  dt exp(cum_last - cum)
  float* st = fdec + hpc * FT;       // hpc x P x NS  the states
  const int groups = H / hpc, b = blockIdx.x / groups;
  const int h0 = (blockIdx.x % groups) * hpc;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  // this warp's head and its rank among the head's warps
  const int wph = FWARPS / hpc, hh = warp / wph, part = warp % wph;
  const int nt = (S + FT - 1) / FT;
  float* sth = st + hh * P * NS;
  const float* ch = cum + hh * FT;

  auto load = [&](int t) {
    const int s0 = t * FT;
    fwd_stage<T>(fsm + (t % stages) * stage_bytes, x, dt, bm, cm, b, h0, s0,
                 min(FT, S - s0), S, H, P, N, hpc, wb, wx, vec16 != 0);
  };
  load(0);
  if (init) {  // the heads' states are contiguous
    const float* src = init + ((long long)b * H + h0) * P * N;
    for (int idx = tid; idx < hpc * P * N; idx += THREADS) {
      const int r = idx / N;
      st[r * NS + idx - r * N] = src[idx];
    }
  }
  for (int t = 0; t < nt; ++t) {
    const int s0 = t * FT, rows = min(FT, S - s0);
    const bool zero = t == 0 && init == nullptr;  // the entering state is 0
    // the state leaving the last tile is needed only as the final state
    const bool update = t + 1 < nt || final_state != nullptr;
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    if (t + 1 < nt && stages == 2) load(t + 1);
    const char* sg = fsm + (t % stages) * stage_bytes;
    const T* Bt = reinterpret_cast<const T*>(sg);
    const T* Ct = reinterpret_cast<const T*>(sg + 4 * FT * wb);
    const T* Xh = reinterpret_cast<const T*>(sg + 8 * FT * wb) + hh * P;
    const float* Dt =
        reinterpret_cast<const float*>(sg + 4 * FT * (2 * wb + wx));

    // each head's cum, exp(cum) and dt exp(cum_last - cum): a warp a head,
    // two rows a lane
    if (warp < hpc) {
      const float av = a[h0 + warp];
      const float d0 = Dt[2 * lane * hpc + warp];
      const float d1 = Dt[(2 * lane + 1) * hpc + warp];
      const float v0 = d0 * av, v1 = d1 * av;
      float v = v0 + v1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += o;
      }
      float ex = __shfl_up_sync(0xffffffffu, v, 1);
      if (lane == 0) ex = 0.f;
      const float c0 = ex + v0, c1 = c0 + v1;
      const float cl = __shfl_sync(0xffffffffu, c1, 31);
      const int o = warp * FT + 2 * lane;
      cum[o] = c0;
      cum[o + 1] = c1;
      ecum[o] = expf(c0);
      ecum[o + 1] = expf(c1);
      fdec[o] = d0 * expf(cl - c0);
      fdec[o + 1] = d1 * expf(cl - c1);
    }
    // G = C B^T, the same for every head: its ten 16 x 16 blocks on or
    // below the diagonal (W' is 0 above it), over all warps
    for (int item = warp; item < 10; item += FWARPS) {
      int r = 0;
      while ((r + 1) * (r + 2) / 2 <= item) ++r;
      const int c = item - r * (r + 1) / 2;
      const int ra = 16 * r + g, rb = ra + 8;
      float s[2][4] = {};
      mm_sum<SX, SX, EXACT, 2>(
          s, N, [=](int i, int n) { return to_f(Ct[i * LB + n]); },
          [=](int n, int j) { return to_f(Bt[j * LB + n]); }, ra, rb,
          16 * c + g, FT, FT, t4);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c0 = 16 * c + 8 * e + 2 * t4;
        G[ra * GS + c0] = s[e][0];
        G[ra * GS + c0 + 1] = s[e][1];
        G[rb * GS + c0] = s[e][2];
        G[rb * GS + c0 + 1] = s[e][3];
      }
    }
    __syncthreads();

    // y = W' x + exp(cum) . (C S^T): the head's 16-row blocks, each with
    // all its columns in groups of 8 NBY, in snake order over the head's
    // warps (block r sums 16 (r + 1) tokens of W' x)
    const int cgs = (P + 8 * NBY - 1) / (8 * NBY);
    for (int it = 0; it < 4 * cgs; ++it) {
      const int m = it % (2 * wph);
      if ((m < wph ? m : 2 * wph - 1 - m) != part) continue;
      const int r = it / cgs, col0 = (it % cgs) * 8 * NBY;
      const int ra = 16 * r + g, rb = ra + 8;
      float s[NBY][4] = {};
      if (!zero) {
        mm_sum<SX, 2, EXACT, NBY>(
            s, N, [=](int i, int n) { return to_f(Ct[i * LB + n]); },
            [=](int n, int p) { return sth[p * NS + n]; }, ra, rb, col0 + g,
            FT, P, t4);
        const float ea = ecum[hh * FT + ra], eb = ecum[hh * FT + rb];
#pragma unroll
        for (int e = 0; e < NBY; ++e) {
          s[e][0] *= ea;
          s[e][1] *= ea;
          s[e][2] *= eb;
          s[e][3] *= eb;
        }
      }
      mm_sum<2, SX, EXACT, NBY>(
          s, 16 * (r + 1),
          [=](int i, int j) {
            return j <= i ? G[i * GS + j] * expf(ch[i] - ch[j]) *
                                Dt[j * hpc + hh]
                          : 0.f;
          },
          [=](int j, int p) { return to_f(Xh[j * LX + p]); }, ra, rb,
          col0 + g, FT, P, t4);
      const long long rs = (long long)H * P;  // y's row stride
      float* yb = y + (((long long)b * S + s0) * H + h0 + hh) * P;
#pragma unroll
      for (int e = 0; e < NBY; ++e) {
        const int c0 = col0 + 8 * e + 2 * t4;  // P is even: c0 + 1 < P too
        if (!EXACT && c0 >= P) continue;
        if (ra < rows)
          *reinterpret_cast<float2*>(yb + ra * rs + c0) =
              make_float2(s[e][0], s[e][1]);
        if (rb < rows)
          *reinterpret_cast<float2*>(yb + rb * rs + c0) =
              make_float2(s[e][2], s[e][3]);
      }
    }

    // S <- S exp(cum_last) + x^T (B . dt exp(cum_last - cum)), each state
    // element by one lane of the head's warps
    if (update) {
      __syncthreads();  // no warp still reads a state
      const float dec = expf(ch[FT - 1]);
      const float* fh = fdec + hh * FT;
      tile_mm<SX, 2, EXACT>(
          P, N, FT, [=](int p, int j) { return to_f(Xh[j * LX + p]); },
          [=](int j, int n) { return to_f(Bt[j * LB + n]) * fh[j]; }, 0,
          [](int, int) { return 0.f; }, [](int, int) { return 0.f; },
          [=](int p, int n, float acc, float) {
            sth[p * NS + n] = (zero ? 0.f : sth[p * NS + n] * dec) + acc;
            return make_float2(0.f, 0.f);
          },
          nullptr, nullptr, hh * wph, wph);
    }
    if (t + 1 < nt && stages == 1) {
      __syncthreads();  // the one staging area is free
      load(t + 1);
    }
  }
  if (final_state) {
    __syncthreads();
    float* dst = final_state + ((long long)b * H + h0) * P * N;
    for (int idx = tid; idx < hpc * P * N; idx += THREADS) {
      const int r = idx / N;
      dst[idx] = st[r * NS + idx - r * N];
    }
  }
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

// f(r, c) for r < R, c < C: a warp a row, its lanes along the row (no
// integer division in the index arithmetic)
template <typename F>
__device__ __forceinline__ void for_rows(int R, int C, F f) {
  for (int r = threadIdx.x >> 5; r < R; r += BWARPS)
    for (int c = threadIdx.x & 31; c < C; c += 32) f(r, c);
}

// Starts copying the rows [s0, s0 + rows) of one tile for (b, h) into the
// staging area with cp.async (4 bytes a copy, any width): x, dt and B, and
// with `full` dy and C too.  The CTA computes on the tile before while the
// copies fly; unstage_tile waits for them.
template <typename T>
__device__ void stage_tile(const float* __restrict__ dy,
                           const T* __restrict__ x,
                           const float* __restrict__ dt,
                           const T* __restrict__ bm,
                           const T* __restrict__ cm, int b, int h, int s0,
                           int rows, int S, int H, int P, int N, bool full,
                           char* stage) {
  const int tid = threadIdx.x, E = (int)sizeof(T), wx = P * E / 4;
  char* sx = stage;
  char* sb = sx + TILE * P * E;
  char* sc = sb + TILE * N * E;
  char* sy = sc + TILE * N * E;
  char* sd = sy + TILE * P * 4;
  const long long row0 = (long long)b * S + s0;
  for_rows(rows, wx, [&](int i, int c) {
    cp_async4(sx + 4 * (i * wx + c),
              reinterpret_cast<const char*>(x + ((row0 + i) * H + h) * P) +
                  4 * c);
  });
  const int wbn = rows * N * E / 4;  // B and C rows of a tile are contiguous
  const char* gb = reinterpret_cast<const char*>(bm + row0 * N);
  const char* gc = reinterpret_cast<const char*>(cm + row0 * N);
  for (int w = tid; w < wbn; w += BT) {
    cp_async4(sb + 4 * w, gb + 4 * w);
    if (full) cp_async4(sc + 4 * w, gc + 4 * w);
  }
  if (full)
    for_rows(rows, P, [&](int i, int p) {
      cp_async4(sy + 4 * (i * P + p), dy + ((row0 + i) * H + h) * P + p);
    });
  if (tid < rows) cp_async4(sd + 4 * tid, dt + (row0 + tid) * H + h);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits for the staged tile and spreads it into the padded tiles: u = x dt
// and B (with `full` also x, dy and C), dt into dts; rows past the sequence
// are zero, so they add nothing and leave cum flat.  Ends in a barrier, so
// the staging area is free again.
template <typename T>
__device__ void unstage_tile(const char* stage, int rows, int P, int N,
                             bool full, float* dts, float* dYs, float* Xs,
                             float* Us, float* Bs, float* Cs) {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  const int tid = threadIdx.x, NS = ld4(N), PS = ld4(P);
  const T* sx = reinterpret_cast<const T*>(stage);
  const T* sb = sx + TILE * P;
  const T* sc = sb + TILE * N;
  const float* sy = reinterpret_cast<const float*>(sc + TILE * N);
  const float* sd = sy + TILE * P;
  if (tid < TILE) dts[tid] = tid < rows ? sd[tid] : 0.f;
  for_rows(TILE, P, [&](int i, int p) {
    const bool in = i < rows;
    const float v = in ? to_f(sx[i * P + p]) : 0.f;
    Us[i * PS + p] = v * (in ? sd[i] : 0.f);
    if (full) {
      Xs[i * PS + p] = v;
      dYs[i * PS + p] = in ? sy[i * P + p] : 0.f;
    }
  });
  for_rows(TILE, N, [&](int j, int n) {
    const bool in = j < rows;
    Bs[j * NS + n] = in ? to_f(sb[j * N + n]) : 0.f;
    if (full) Cs[j * NS + n] = in ? to_f(sc[j * N + n]) : 0.f;
  });
  __syncthreads();
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// A (P, N) state from device memory into its padded shared-memory copy
__device__ void load_state(const float* __restrict__ src, float* dst, int P,
                           int N) {
  const int NS = ld4(N);
  for_rows(P, N, [&](int p, int n) { dst[p * NS + n] = src[p * N + n]; });
}

// One CTA per (b, h) in clusters of CL consecutive heads: the forward walk
// that rebuilds the entering states, then the reverse walk (see the header)
template <typename T, int SP, bool EXACT>
__global__ void __launch_bounds__(BT, 1)
ssd_bwd_kernel(const float* __restrict__ dy, const T* __restrict__ x,
               const float* __restrict__ dt, const float* __restrict__ a,
               const T* __restrict__ bm, const T* __restrict__ cm,
               const float* __restrict__ init, float* __restrict__ states,
               float* __restrict__ dx, float* __restrict__ ddt,
               float* __restrict__ part_b, float* __restrict__ part_c, int S,
               int H, int P, int N) {
  extern __shared__ float smem[];
  const int NS = ld4(N), PS = ld4(P), CTP = (P + 7) / 8, CTN = (N + 7) / 8;
  float* Sin = smem;                 // P x NS   state entering the tile
  float* dS = Sin + P * NS;          // P x NS   adjoint of the leaving state
  float* Bs = dS + P * NS;           // TILE x NS
  float* Cs = Bs + TILE * NS;        // TILE x NS
  float* OB = Cs + TILE * NS;        // TILE x NS  this head's dB tile
  float* OC = OB + TILE * NS;        // TILE x NS  this head's dC tile
  float* Xs = OC + TILE * NS;        // TILE x PS
  float* Us = Xs + TILE * PS;        // TILE x PS  u = x dt
  float* dYs = Us + TILE * PS;       // TILE x PS
  float* Ws = dYs + TILE * PS;       // TILE x TB  (C B^T) . L
  float* Gs = Ws + TILE * TB;        // TILE x TB  (dy_i.u_j) L_ij
  float* Rs = Gs + TILE * TB;        // TILE x TB  (dy_i.u_j) W_ij
  float* pX = Rs + TILE * TB;        // TILE x CTP  x.du row partials
  float* pQ = pX + TILE * CTP;       // TILE x CTP  u (dS B) decay partials
  float* pE = pQ + TILE * CTP;       // TILE x CTN  C (S_in^T dy) partials
  float* dts = pE + TILE * CTN;      // TILE each below
  float* cum = dts + TILE;
  float* ecum = cum + TILE;
  float* decay = ecum + TILE;
  float* ddt_u = decay + TILE;
  float* qv = ddt_u + TILE;
  float* dcum = qv + TILE;
  float* red = dcum + TILE;          // BWARPS
  char* stage = reinterpret_cast<char*>(red + BWARPS);  // the next tile

  cg::cluster_group cluster = cg::this_cluster();
  const int CL = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int h = blockIdx.x % H, b = blockIdx.x / H, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int groups = H / CL, grp = h / CL;
  const float av = a[h];
  const int nt = (S + TILE - 1) / TILE;
  const long long PN = (long long)P * N, bh = (long long)b * H + h;

  // The CTA reads 2 nt - 1 tiles: 0 .. nt-2 forward (x, dt, B), then nt-1
  // .. 0 in reverse (all inputs).  Load k + 1 is staged while load k is
  // computed on.
  const int loads = 2 * nt - 1;
  auto stage_load = [&](int k) {
    if (k >= loads) return;
    const bool fwd = k < nt - 1;
    const int t = fwd ? k : loads - 1 - k, s0 = t * TILE;
    stage_tile(dy, x, dt, bm, cm, b, h, s0, min(TILE, S - s0), S, H, P, N,
               !fwd, stage);
  };
  stage_load(0);

  // ---- forward walk: the state entering every tile -----------------------
  // (a zero initial state is never read: the first update and tile 0's
  // terms skip it)
  if (init) load_state(init + bh * PN, Sin, P, N);
  for (int t = 0; t + 1 < nt; ++t) {
    const int s0 = t * TILE, rows = min(TILE, S - s0);
    unstage_tile<T>(stage, rows, P, N, false, dts, nullptr, nullptr, Us, Bs,
                    nullptr);
    stage_load(t + 1);
    tile_cumsum(dts, av, cum);
    __syncthreads();
    const float clast = cum[TILE - 1];
    for_rows(TILE, P,
             [&](int i, int p) { Us[i * PS + p] *= expf(clast - cum[i]); });
    __syncthreads();
    const float dec = expf(clast);
    const bool zero = t == 0 && init == nullptr;
    // S <- S exp(cum_last) + (u . decay)^T B, each element by one lane
    tile_mm<SP, SP, EXACT>(
        P, N, TILE, [=](int p, int j) { return Us[j * PS + p]; },
        [=](int j, int n) { return Bs[j * NS + n]; }, 0,
        [](int, int) { return 0.f; }, [](int, int) { return 0.f; },
        [=](int p, int n, float acc, float) {
          Sin[p * NS + n] = (zero ? 0.f : Sin[p * NS + n] * dec) + acc;
          return make_float2(0.f, 0.f);
        },
        nullptr, nullptr);
    __syncthreads();
    if (t + 2 < nt) {  // entering tile t + 1 < nt - 1: to the scratch
      float* dst = states + (bh * (nt - 2) + t) * PN;
      for_rows(P, N, [&](int p, int n) { dst[p * N + n] = Sin[p * NS + n]; });
    }
  }

  // ---- reverse walk ------------------------------------------------------
  bool ds_zero = true;  // the final state has no gradient
  for (int t = nt - 1; t >= 0; --t) {
    const int s0 = t * TILE, rows = min(TILE, S - s0);
    const bool sin_zero = t == 0 && init == nullptr;
    if (t + 1 < nt && !sin_zero)  // the last tile's state is in place
      load_state(t > 0 ? states + (bh * (nt - 2) + t - 1) * PN
                       : init + bh * PN, Sin, P, N);
    unstage_tile<T>(stage, rows, P, N, true, dts, dYs, Xs, Us, Bs, Cs);
    stage_load(loads - t);  // this tile was load loads - 1 - t
    tile_cumsum(dts, av, cum);
    __syncthreads();
    const float clast = cum[TILE - 1];
    if (tid < TILE) {
      ecum[tid] = expf(cum[tid]);
      decay[tid] = expf(clast - cum[tid]);
    }
    // C B^T on the first half of the warps, dy u^T on the second (into Ws
    // and Gs), then W = (C B^T) . L, G = (dy u^T) . L and R = (dy u^T) . W,
    // 0 above the diagonal
    if (warp < BWARPS / 2)
      tile_mm<SP, SP, EXACT, 1>(
          TILE, TILE, N, [=](int i, int n) { return Cs[i * NS + n]; },
          [=](int n, int j) { return Bs[j * NS + n]; }, 0,
          [](int, int) { return 0.f; }, [](int, int) { return 0.f; },
          [=](int i, int j, float g, float) {
            Ws[i * TB + j] = g;
            return make_float2(0.f, 0.f);
          },
          nullptr, nullptr, 0, BWARPS / 2);
    else
      tile_mm<SP, SP, EXACT, 1>(
          TILE, TILE, P, [=](int i, int p) { return dYs[i * PS + p]; },
          [=](int p, int j) { return Us[j * PS + p]; }, 0,
          [](int, int) { return 0.f; }, [](int, int) { return 0.f; },
          [=](int i, int j, float d, float) {
            Gs[i * TB + j] = d;
            return make_float2(0.f, 0.f);
          },
          nullptr, nullptr, BWARPS / 2, BWARPS / 2);
    __syncthreads();
    for_rows(TILE, TILE, [&](int i, int j) {
      const bool on = j <= i;
      const float l = on ? expf(cum[i] - cum[j]) : 0.f;
      const float g = Ws[i * TB + j], d = Gs[i * TB + j];
      Ws[i * TB + j] = on ? g * l : 0.f;
      Gs[i * TB + j] = on ? d * l : 0.f;
      Rs[i * TB + j] = on ? d * g * l : 0.f;
    });
    __syncthreads();
    // du and dx; row partials of x.du and of u (dS B) decay for dcum
    tile_mm<SP, SP, EXACT>(
        TILE, P, TILE, [=](int j, int i) { return Ws[i * TB + j]; },
        [=](int i, int p) { return dYs[i * PS + p]; }, ds_zero ? 0 : N,
        [=](int j, int n) { return Bs[j * NS + n]; },
        [=](int n, int p) { return dS[p * NS + n]; },
        [=](int j, int p, float acc, float z) {
          const float du = acc + decay[j] * z;
          if (j < rows)
            dx[(((long long)b * S + s0 + j) * H + h) * P + p] = dts[j] * du;
          return make_float2(Xs[j * PS + p] * du,
                             Us[j * PS + p] * z * decay[j]);
        },
        pX, pQ);
    // this head's dC tile; row partials of C (S_in^T dy).  The ranks have
    // read the tile before out of OB and OC.
    if (t + 1 < nt) cluster_wait();
    tile_mm<SP, SP, EXACT>(
        TILE, N, TILE, [=](int i, int j) { return Gs[i * TB + j]; },
        [=](int j, int n) { return Bs[j * NS + n]; }, sin_zero ? 0 : P,
        [=](int i, int p) { return dYs[i * PS + p]; },
        [=](int p, int n) { return Sin[p * NS + n]; },
        [=](int i, int n, float acc, float w) {
          OC[i * NS + n] = acc + ecum[i] * w;
          return make_float2(Cs[i * NS + n] * w, 0.f);
        },
        pE, nullptr);
    // this head's dB tile
    tile_mm<SP, SP, EXACT>(
        TILE, N, TILE, [=](int j, int i) { return Gs[i * TB + j]; },
        [=](int i, int n) { return Cs[i * NS + n]; }, ds_zero ? 0 : P,
        [=](int j, int p) { return Us[j * PS + p]; },
        [=](int p, int n) { return dS[p * NS + n]; },
        [=](int j, int n, float acc, float z) {
          OB[j * NS + n] = acc + decay[j] * z;
          return make_float2(0.f, 0.f);
        },
        nullptr, nullptr);
    // <dS, S_in>, block-reduced in a fixed order
    float part = 0.f;
    if (!ds_zero && !sin_zero)
      for_rows(P, N, [&](int p, int n) {
        part += dS[p * NS + n] * Sin[p * NS + n];
      });
    part = warp_sum(part);
    if (lane == 0) red[warp] = part;
    cluster.sync();  // every rank's dB/dC tile and partials are written
    // rank r sums its rows of the cluster's dB and dC tiles over the ranks,
    // in rank order, and writes the group's partial
    {
      const int per = (TILE + CL - 1) / CL, r0 = rank * per;
      const int nr = max(0, min(rows, r0 + per) - r0);
      const long long base = ((long long)b * groups + grp) * S + s0;
      const int n4 = N / 4;  // four columns a thread, 16-byte reads
      for (int idx = tid; idx < nr * n4; idx += BT) {
        const int i = r0 + idx / n4, n = (idx % n4) * 4;
        float4 sb = make_float4(0.f, 0.f, 0.f, 0.f), sc = sb;
#pragma unroll
        for (int q = 0; q < MAX_CLUSTER; ++q)
          if (q < CL) {
            const float4 vb = *reinterpret_cast<const float4*>(
                cluster.map_shared_rank(OB + i * NS + n, q));
            const float4 vc = *reinterpret_cast<const float4*>(
                cluster.map_shared_rank(OC + i * NS + n, q));
            sb.x += vb.x;
            sb.y += vb.y;
            sb.z += vb.z;
            sb.w += vb.w;
            sc.x += vc.x;
            sc.y += vc.y;
            sc.z += vc.z;
            sc.w += vc.w;
          }
        *reinterpret_cast<float4*>(part_b + (base + i) * N + n) = sb;
        *reinterpret_cast<float4*>(part_c + (base + i) * N + n) = sc;
      }
    }
    cluster_arrive();  // this CTA is done reading the ranks' tiles
    // per-row sums, one warp a row
    for (int r = warp; r < TILE; r += BWARPS) {
      const float rs = warp_sum(lane <= r ? Rs[r * TB + lane] : 0.f);
      const float cs = warp_sum(lane >= r ? Rs[lane * TB + r] : 0.f);
      float s1 = 0.f, s2 = 0.f, s3 = 0.f;
      for (int c = lane; c < CTP; c += 32) {
        s1 += pX[r * CTP + c];
        s2 += pQ[r * CTP + c];
      }
      for (int c = lane; c < CTN; c += 32) s3 += pE[r * CTN + c];
      s1 = warp_sum(s1);
      s2 = warp_sum(s2);
      s3 = warp_sum(s3);
      if (lane == 0) {
        ddt_u[r] = s1;
        qv[r] = s2;
        dcum[r] = rs - cs + ecum[r] * s3 - s2;
      }
    }
    __syncthreads();
    // dS for the tile before: exp(cum_last) dS + sum_i exp(cum_i) dy_i C_i
    const float eclast = expf(clast);
    if (t > 0)  // tile 0's leaving-state adjoint feeds nothing
      tile_mm<SP, SP, EXACT>(
          P, N, TILE, [=](int p, int i) { return ecum[i] * dYs[i * PS + p]; },
          [=](int i, int n) { return Cs[i * NS + n]; }, 0,
          [](int, int) { return 0.f; }, [](int, int) { return 0.f; },
          [=](int p, int n, float acc, float) {
            dS[p * NS + n] = (ds_zero ? 0.f : dS[p * NS + n] * eclast) + acc;
            return make_float2(0.f, 0.f);
          },
          nullptr, nullptr);
    if (warp == 0) {
      float sdot = 0.f;
      for (int w = 0; w < BWARPS; ++w) sdot += red[w];
      const float qsum = warp_sum(qv[lane]);
      float v = dcum[lane];
      if (lane == TILE - 1) v += eclast * sdot + qsum;
      // reverse cumulative sum: d(dt a)_k = sum_{i >= k} dcum_i
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_down_sync(0xffffffffu, v, off);
        if (lane + off < 32) v += o;
      }
      if (lane < rows)
        ddt[((long long)b * S + s0 + lane) * H + h] = ddt_u[lane] + av * v;
    }
    ds_zero = false;
    __syncthreads();  // red, qv, dcum and the tiles are free
  }
  cluster_wait();  // no rank still reads this CTA's tiles
}

// out[g2, s, n] = sum_g part[g2, g, s, n], g in order: the dB and dC sums
// over the cluster groups, deterministic (g2 runs over dB's and dC's
// batch rows)
__global__ void __launch_bounds__(THREADS)
reduce_groups(const float* __restrict__ part, float* __restrict__ out,
              long long total, long long per_b, int G) {
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
       idx < total; idx += stride) {
    const long long b = idx / per_b, rem = idx % per_b;
    const float* src = part + b * G * per_b + rem;
    float acc = 0.f;
    for (int g = 0; g < G; ++g) acc += src[g * per_b];
    out[idx] = acc;
  }
}

// plan (when not null) receives {CTAs, heads a CTA, threads a CTA, dynamic
// shared memory bytes, registers a thread, staging areas, state kept} and
// nothing is launched
template <typename T>
int fwd_launch(const void* x, const float* dt, const float* a, const void* bm,
               const void* cm, const float* init, float* y, float* fin,
               int Bsz, int S, int H, int P, int N, bool has_init,
               bool has_fin, cudaStream_t s, int* plan) {
  constexpr int E = (int)sizeof(T);
  // by shape: y's 16-row blocks whole groups of 64 columns, G and the
  // update whole 16 x 16 blocks
  void (*kern)(const T*, const float*, const float*, const T*, const T*,
               const float*, float*, float*, int, int, int, int, int, int,
               int) = P % 64 == 0 && N % 16 == 0 ? ssd_fwd_kernel<T, true, 8>
                                                 : ssd_fwd_kernel<T, false, 2>;
  FwdGeo geo;
  if (!fwd_geometry(S, H, P, N, E, has_init, has_fin, &geo))
    return (int)cudaErrorInvalidValue;
  const int ctas = Bsz * (H / geo.hpc);
  if (plan) {
    cudaFuncAttributes fa;
    const cudaError_t err = cudaFuncGetAttributes(&fa, kern);
    if (err != cudaSuccess) return (int)err;
    plan[0] = ctas;
    plan[1] = geo.hpc;
    plan[2] = THREADS;
    plan[3] = (int)geo.smem;
    plan[4] = fa.numRegs;
    plan[5] = geo.stages;
    plan[6] = geo.state ? 1 : 0;
    return 0;
  }
  static const cudaError_t attr[2] = {
      cudaFuncSetAttribute(ssd_fwd_kernel<T, false, 2>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)MAX_SMEM),
      cudaFuncSetAttribute(ssd_fwd_kernel<T, true, 8>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)MAX_SMEM)};
  if (attr[0] != cudaSuccess) return (int)attr[0];
  if (attr[1] != cudaSuccess) return (int)attr[1];
  // 16-byte copies when every row of B, C and x starts on 16 bytes
  const bool vec16 =
      (P * E) % 16 == 0 && (N * E) % 16 == 0 &&
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(bm) |
        reinterpret_cast<uintptr_t>(cm)) % 16) == 0;
  kern<<<ctas, THREADS, geo.smem, s>>>(
      static_cast<const T*>(x), dt, a, static_cast<const T*>(bm),
      static_cast<const T*>(cm), init, y, fin, S, H, P, N, geo.hpc,
      geo.stages, vec16 ? 1 : 0);
  return (int)cudaGetLastError();
}

// plan (when not null) receives {CTAs, cluster size, threads a CTA, dynamic
// shared memory bytes, registers a thread, tile states in the scratch}
// and nothing is launched
template <typename T>
int bwd_launch(const float* dy, const void* x, const float* dt, const float* a,
               const void* bm, const void* cm, const float* init,
               float* states, float* dx, float* ddt, float* part, float* dbc,
               int Bsz, int S, int H, int P, int N, cudaStream_t s,
               int* plan, int* launched) {
  constexpr int SP = std::is_same<T, float>::value ? 2 : 1;
  // by shape: every tile product is whole 16 x 16 blocks and 8-deep steps
  void (*kern)(const float*, const T*, const float*, const float*, const T*,
               const T*, const float*, float*, float*, float*, float*, float*,
               int, int, int, int) =
      P % 16 == 0 && N % 16 == 0 ? ssd_bwd_kernel<T, SP, true>
                                : ssd_bwd_kernel<T, SP, false>;
  const long long smem = bwd_smem(P, N, (int)sizeof(T));
  const int CL = bwd_cluster(H), G = H / CL;
  const int nt = (S + TILE - 1) / TILE;
  if (plan) {
    cudaFuncAttributes fa;
    const cudaError_t err = cudaFuncGetAttributes(&fa, kern);
    if (err != cudaSuccess) return (int)err;
    plan[0] = Bsz * H;
    plan[1] = CL;
    plan[2] = BT;
    plan[3] = (int)smem;
    plan[4] = fa.numRegs;
    plan[5] = nt > 2 ? nt - 2 : 0;
    return 0;
  }
  static const cudaError_t attr[2] = {
      cudaFuncSetAttribute(ssd_bwd_kernel<T, SP, false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)MAX_SMEM),
      cudaFuncSetAttribute(ssd_bwd_kernel<T, SP, true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)MAX_SMEM)};
  if (attr[0] != cudaSuccess) return (int)attr[0];
  if (attr[1] != cudaSuccess) return (int)attr[1];
  const long long per = (long long)Bsz * S * N;  // one of dB, dC
  float* pb = G > 1 ? part : dbc;                // (B, G, S, N) each
  float* pc = G > 1 ? part + per * G : dbc + per;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(Bsz * H), 1, 1);
  cfg.blockDim = dim3(BT, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = s;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = CL;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, kern, dy, static_cast<const T*>(x), dt, a,
      static_cast<const T*>(bm), static_cast<const T*>(cm), init, states, dx,
      ddt, pb, pc, S, H, P, N);
  if (e != cudaSuccess) return (int)e;
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  *launched = 1;
  if (G == 1) return 0;
  // dB and dC: 2 B batch rows of S N each, G group partials apiece
  const long long per_b = (long long)S * N, total = 2 * per;
  const long long want = (total + THREADS - 1) / THREADS;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  reduce_groups<<<blocks, THREADS, 0, s>>>(part, dbc, total, per_b, G);
  e = cudaGetLastError();
  if (e == cudaSuccess) *launched = 2;
  return (int)e;
}

bool dims_ok(int Bsz, int S, int H, int P, int N, long long smem) {
  return Bsz >= 1 && S >= 1 && H >= 1 && P >= 4 && N >= 4 && P % 4 == 0 &&
         N % 4 == 0 &&
         (long long)Bsz * H < (1LL << 31) && smem <= MAX_SMEM;
}

// The least forward CTA: one head, one staging area, a state
long long fwd_smem_least(int P, int N) {
  return fwd_smem(P, N, 4, 1, 1, true);
}

}  // namespace

// Dynamic shared memory (bytes) a CTA of the forward (backward = 0) or
// backward (1) kernel needs at least for state width P and N with float32
// inputs (the forward's least CTA: one head, one staging area, a state).
extern "C" long long ssd_scan_smem(int P, int N, int backward) {
  return backward ? bwd_smem(P, N, 4) : fwd_smem_least(P, N);
}

// x, bm, cm: dtype (0 float32, 1 bfloat16); dt, a, init, y, final_state
// float32; init and final_state may be null.  Launches on `stream` and
// returns a cudaError_t (0 on success) without synchronising.
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* a,
                            const void* bm, const void* cm, const void* init,
                            void* y, void* final_state, int Bsz, int S, int H,
                            int P, int N, int dtype, void* stream) {
  if (!dims_ok(Bsz, S, H, P, N, fwd_smem_least(P, N)) || y == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* d = static_cast<const float*>(dt);
  const float* av = static_cast<const float*>(a);
  const float* in = static_cast<const float*>(init);
  float* yy = static_cast<float*>(y);
  float* fs = static_cast<float*>(final_state);
  if (dtype == 0)
    return fwd_launch<float>(x, d, av, bm, cm, in, yy, fs, Bsz, S, H, P, N,
                             in != nullptr, fs != nullptr, s, nullptr);
  if (dtype == 1)
    return fwd_launch<__nv_bfloat16>(x, d, av, bm, cm, in, yy, fs, Bsz, S, H,
                                     P, N, in != nullptr, fs != nullptr, s,
                                     nullptr);
  return (int)cudaErrorInvalidValue;
}

// The forward launch ssd_scan_fwd would make for these dims, with or
// without an initial state and a final state, without making it:
// plan[0..6] = CTAs, heads a CTA, threads a CTA, dynamic shared memory
// bytes, registers a thread, staging areas, 1 when the states are kept.
extern "C" int ssd_scan_fwd_plan(int Bsz, int S, int H, int P, int N,
                                 int dtype, int has_init, int want_state,
                                 int* plan) {
  if (!dims_ok(Bsz, S, H, P, N, fwd_smem_least(P, N)) || !plan)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return fwd_launch<float>(nullptr, nullptr, nullptr, nullptr, nullptr,
                             nullptr, nullptr, nullptr, Bsz, S, H, P, N,
                             has_init != 0, want_state != 0, nullptr, plan);
  if (dtype == 1)
    return fwd_launch<__nv_bfloat16>(nullptr, nullptr, nullptr, nullptr,
                                     nullptr, nullptr, nullptr, nullptr, Bsz,
                                     S, H, P, N, has_init != 0,
                                     want_state != 0, nullptr, plan);
  return (int)cudaErrorInvalidValue;
}

// dy, dx (B,S,H,P), ddt (B,S,H), dbc (2,B,S,N) = (dB, dC): float32.  x, bm,
// cm, dt, a and init (may be null) are the forward's inputs.  Scratch, all
// float32: states (B, H, ceil(S/32) - 2, P, N) for the states entering the
// middle tiles, null when S <= 64; part (2, B, H / CL, S, N) for the
// cluster groups' dB and dC partials, null when H <= 8 (one group).
// Launches the backward kernel and, with more than one group, the group
// reduction on `stream`, and sets *launched to the kernels it launched;
// returns a cudaError_t without synchronising.
extern "C" int ssd_scan_bwd(const void* dy, const void* x, const void* dt,
                            const void* a, const void* bm, const void* cm,
                            const void* init, void* states, void* dx,
                            void* ddt, void* part, void* dbc, int Bsz, int S,
                            int H, int P, int N, int dtype, void* stream,
                            int* launched) {
  const int nt = (S + TILE - 1) / TILE;
  if (launched) *launched = 0;
  if (!launched ||
      !dims_ok(Bsz, S, H, P, N, bwd_smem(P, N, dtype ? 2 : 4)) ||
      (states == nullptr) != (nt <= 2) ||
      (part == nullptr) != (bwd_cluster(H) == H))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(dy);
  const float* d = static_cast<const float*>(dt);
  const float* av = static_cast<const float*>(a);
  const float* in = static_cast<const float*>(init);
  float* o[5] = {static_cast<float*>(states), static_cast<float*>(dx),
                 static_cast<float*>(ddt), static_cast<float*>(part),
                 static_cast<float*>(dbc)};
  if (dtype == 0)
    return bwd_launch<float>(g, x, d, av, bm, cm, in, o[0], o[1], o[2], o[3],
                             o[4], Bsz, S, H, P, N, s, nullptr, launched);
  if (dtype == 1)
    return bwd_launch<__nv_bfloat16>(g, x, d, av, bm, cm, in, o[0], o[1],
                                     o[2], o[3], o[4], Bsz, S, H, P, N, s,
                                     nullptr, launched);
  return (int)cudaErrorInvalidValue;
}

// The backward launch ssd_scan_bwd would make for these dims, without
// making it: plan[0..5] = CTAs, cluster size, threads a CTA, dynamic shared
// memory bytes, registers a thread, tile states in the scratch.
extern "C" int ssd_scan_bwd_plan(int Bsz, int S, int H, int P, int N,
                                 int dtype, int* plan) {
  if (!dims_ok(Bsz, S, H, P, N, bwd_smem(P, N, dtype ? 2 : 4)) || !plan)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return bwd_launch<float>(nullptr, nullptr, nullptr, nullptr, nullptr,
                             nullptr, nullptr, nullptr, nullptr, nullptr,
                             nullptr, nullptr, Bsz, S, H, P, N, nullptr, plan,
                             nullptr);
  if (dtype == 1)
    return bwd_launch<__nv_bfloat16>(nullptr, nullptr, nullptr, nullptr,
                                     nullptr, nullptr, nullptr, nullptr,
                                     nullptr, nullptr, nullptr, nullptr, Bsz,
                                     S, H, P, N, nullptr, plan, nullptr);
  return (int)cudaErrorInvalidValue;
}
