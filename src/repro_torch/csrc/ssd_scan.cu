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
// per (b, h) loops over the sequence and keeps the (P, N) state in shared
// memory (32 KB at mamba2-1.3b's P 64, N 128).  It walks tiles of TILE = 32
// tokens, whatever the model's chunk: the chunk is only a blocking of the
// same recurrence, and at the Pallas chunk of 256 the B and C rows of a
// whole chunk would not fit beside the state in 227 KB.  Per tile, with
// cum = cumsum(dt a) inside the tile:
//   W   = (C B^T) . L,  L_ij = exp(cum_i - cum_j) for j <= i, else 0
//   y   = W (x dt) + (C . exp(cum)) S^T
//   S  <- S exp(cum_last) + (x dt)^T (B . exp(cum_last - cum))
// The final state is an optional output: the cache-free path does not ask
// for it (it would be 100.7 MB of float32 a call at the adapt shape).  With
// y null the kernel only writes the state entering every tile (`states`,
// (B, H, ceil(S/32), P, N)): the backward's recomputation.
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
// The forward's products are small matrix products of shared-memory
// operands on float32 CUDA cores (block_mm): each thread accumulates a 2x2,
// 2x4 or 4x4 block of outputs in registers, so a loaded operand feeds
// several multiply-adds; the triangular sums run over the whole tile, since
// W holds zeros above the diagonal.  The kernels take P and N in multiples
// of 4.  Work that no output needs is skipped: the state update after the
// last tile when no final state is asked for, the state terms of a tile
// whose entering state is zero, the adjoint of the state entering tile 0.
//
// What bounds it on this card.  At the adapt shape (B 48, S 64, H 64, P
// 64, N 128, bf16 x, B, C) the forward must move 77.9 MB (0.023 ms at
// 3.35 TB/s) and its loops do 4.5 GFLOP, 0.067 ms on float32 CUDA cores
// (the tensor cores are idle here): bytes bound the work, but float32
// FMAs fed from shared memory bound this kernel.  The design keeps every
// operand of a tile in shared memory (rows padded to odd strides, so the
// lanes of a warp hit distinct banks), reads each input once, and never
// lets the state leave the SM.  The backward moves 105.4 MB and does
// about 13 GFLOP (the in-CTA recomputation included), 0.03 ms at the bytes'
// rate.  With the products on TF32 tensor cores, what remains around them
// is the barriers of each 32-token tile, the staging, the cluster combine
// and the row sums, with one CTA an SM to hide them.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int TILE = 32;      // tokens per tile: one warp lane per row
constexpr int THREADS = 256;  // forward
constexpr int BT = 512;       // backward: 16 warps
constexpr int BWARPS = BT / 32;
constexpr int MAX_CLUSTER = 8;  // CTAs (heads) a cluster, the portable size
constexpr int TS = TILE + 1;  // padded row stride of the TILE x TILE tiles

// The backward's row strides: a width padded to 4 more than a multiple of
// 32 words, so the fragment loads of mma.sync (lanes 4g + t) hit 32
// distinct banks along a row and at most two lanes a bank down a column.
__host__ __device__ constexpr int ld4(int n) { return n + (36 - n % 32) % 32; }
constexpr int TB = ld4(TILE);  // 36
constexpr long long MAX_SMEM = 232448;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

long long fwd_smem(int P, int N) {
  return 4LL * ((long long)P * (N + 1) + 2LL * TILE * (N + 1) +
                (long long)TILE * (P + 1) + TILE * TS + 2 * TILE);
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

// Loads rows [s0, s0 + rows) of one tile of x (scaled by dt into u), B
// and C for (b, h); rows past the end of the sequence are zero, so they
// add nothing and leave cum flat.  Xs may be null.
template <typename T>
__device__ void load_tile(const T* __restrict__ x, const float* __restrict__ dt,
                          const T* __restrict__ bm, const T* __restrict__ cm,
                          int b, int h, int s0, int rows, int S, int H, int P,
                          int N, float* dts, float* Xs, float* Us, float* Bs,
                          float* Cs) {
  const int tid = threadIdx.x, NS = N + 1, PS = P + 1;
  if (tid < TILE)
    dts[tid] = tid < rows ? dt[((long long)b * S + s0 + tid) * H + h] : 0.f;
  for (int idx = tid; idx < TILE * P; idx += THREADS) {
    const int i = idx / P, p = idx % P;
    float v = 0.f;
    if (i < rows) v = to_f(x[(((long long)b * S + s0 + i) * H + h) * P + p]);
    if (Xs) Xs[i * PS + p] = v;
    Us[i * PS + p] = v;
  }
  for (int idx = tid; idx < TILE * N; idx += THREADS) {
    const int i = idx / N, n = idx % N;
    const long long off = ((long long)b * S + s0 + i) * N + n;
    Bs[i * NS + n] = i < rows ? to_f(bm[off]) : 0.f;
    Cs[i * NS + n] = i < rows ? to_f(cm[off]) : 0.f;
  }
  __syncthreads();
  for (int idx = tid; idx < TILE * P; idx += THREADS) {
    const int i = idx / P, p = idx % P;
    Us[i * PS + p] *= dts[i];
  }
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

// A register-blocked product of shared-memory operands.  Each thread owns
// BR x BC outputs of an R x C result (R % BR == C % BC == 0), at rows
// rb + r R/BR and columns cb + c C/BC: strided, so the lanes of a warp read
// neighbouring columns of one or two rows, which the odd row strides of the
// tiles keep free of bank conflicts.  It sums s1 = sum_{k<K1} a1(row, k)
// b1(k, col) and s2 = sum_{k<K2} a2(row, k) b2(k, col) in registers, in k
// order, and hands both to out(row, col, s1, s2).  Each loaded operand feeds
// BR or BC multiply-adds, where a thread per output would load two a FMA.
template <int BR, int BC, typename A1, typename B1, typename A2, typename B2,
          typename O>
__device__ __forceinline__ void block_mm(int R, int C, int K1, A1 a1, B1 b1,
                                         int K2, A2 a2, B2 b2, O out) {
  const int RB = R / BR, CB = C / BC;
  for (int q = threadIdx.x; q < RB * CB; q += THREADS) {
    const int rb = q / CB, cb = q % CB;
    float s1[BR][BC], s2[BR][BC];
#pragma unroll
    for (int r = 0; r < BR; ++r)
#pragma unroll
      for (int c = 0; c < BC; ++c) s1[r][c] = s2[r][c] = 0.f;
    for (int k = 0; k < K1; ++k) {
      float av[BR], bv[BC];
#pragma unroll
      for (int r = 0; r < BR; ++r) av[r] = a1(rb + r * RB, k);
#pragma unroll
      for (int c = 0; c < BC; ++c) bv[c] = b1(k, cb + c * CB);
#pragma unroll
      for (int r = 0; r < BR; ++r)
#pragma unroll
        for (int c = 0; c < BC; ++c) s1[r][c] += av[r] * bv[c];
    }
    for (int k = 0; k < K2; ++k) {
      float av[BR], bv[BC];
#pragma unroll
      for (int r = 0; r < BR; ++r) av[r] = a2(rb + r * RB, k);
#pragma unroll
      for (int c = 0; c < BC; ++c) bv[c] = b2(k, cb + c * CB);
#pragma unroll
      for (int r = 0; r < BR; ++r)
#pragma unroll
        for (int c = 0; c < BC; ++c) s2[r][c] += av[r] * bv[c];
    }
#pragma unroll
    for (int r = 0; r < BR; ++r)
#pragma unroll
      for (int c = 0; c < BC; ++c)
        out(rb + r * RB, cb + c * CB, s1[r][c], s2[r][c]);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_fwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ a, const T* __restrict__ bm,
               const T* __restrict__ cm, const float* __restrict__ init,
               float* __restrict__ y, float* __restrict__ final_state,
               int S, int H, int P, int N) {
  extern __shared__ float smem[];
  const int NS = N + 1, PS = P + 1;
  float* st = smem;                  // P x NS   the state
  float* Bs = st + P * NS;           // TILE x NS
  float* Cs = Bs + TILE * NS;        // TILE x NS
  float* Us = Cs + TILE * NS;        // TILE x PS  u = x dt
  float* Ws = Us + TILE * PS;        // TILE x TS  (C B^T) . L
  float* cum = Ws + TILE * TS;       // TILE
  float* dts = cum + TILE;           // TILE
  const int h = blockIdx.x % H, b = blockIdx.x / H, tid = threadIdx.x;
  const float av = a[h];
  const int nt = (S + TILE - 1) / TILE;
  const long long PN = (long long)P * N, bh = (long long)b * H + h;

  for (int idx = tid; idx < P * N; idx += THREADS)
    st[(idx / N) * NS + idx % N] = init ? init[bh * PN + idx] : 0.f;
  __syncthreads();
  for (int t = 0; t < nt; ++t) {
    const int s0 = t * TILE, rows = min(TILE, S - s0);
    const bool zero_state = t == 0 && init == nullptr;
    // the state leaving the last tile is needed only as the final state
    const bool update = t < nt - 1 || final_state != nullptr;
    load_tile(x, dt, bm, cm, b, h, s0, rows, S, H, P, N, dts, nullptr, Us, Bs,
              Cs);
    tile_cumsum(dts, av, cum);
    __syncthreads();
    auto c_in = [=](int i, int n) { return Cs[i * NS + n]; };
    // W = (C B^T) . L
    block_mm<2, 2>(
        TILE, TILE, N, c_in, [=](int n, int j) { return Bs[j * NS + n]; },
        0, c_in, c_in, [=](int i, int j, float g, float) {
          Ws[i * TS + j] = j <= i ? g * expf(cum[i] - cum[j]) : 0.f;
        });
    __syncthreads();
    // y = W u + exp(cum) . (C S^T); W is 0 above the diagonal
    block_mm<2, 4>(
        TILE, P, TILE, [=](int i, int j) { return Ws[i * TS + j]; },
        [=](int j, int p) { return Us[j * PS + p]; }, zero_state ? 0 : N,
        c_in, [=](int n, int p) { return st[p * NS + n]; },
        [=](int i, int p, float intra, float inter) {
          if (i < rows)
            y[(((long long)b * S + s0 + i) * H + h) * P + p] =
                intra + expf(cum[i]) * inter;
        });
    if (!update) break;
    __syncthreads();
    const float clast = cum[TILE - 1];
    for (int idx = tid; idx < TILE * P; idx += THREADS) {
      const int i = idx / P, p = idx % P;
      Us[i * PS + p] *= expf(clast - cum[i]);
    }
    __syncthreads();
    const float dec = expf(clast);
    // S <- S exp(cum_last) + (u . decay)^T B; each thread writes only the
    // state elements it owns, and the sum reads no state
    block_mm<4, 4>(
        P, N, TILE, [=](int p, int j) { return Us[j * PS + p]; },
        [=](int j, int n) { return Bs[j * NS + n]; }, 0, c_in, c_in,
        [=](int p, int n, float acc, float) {
          st[p * NS + n] = (zero_state ? 0.f : st[p * NS + n] * dec) + acc;
        });
    __syncthreads();
  }
  if (final_state)
    for (int idx = tid; idx < P * N; idx += THREADS)
      final_state[bh * PN + idx] = st[(idx / N) * NS + idx % N];
}

// ---------------------------------------------------------------------------
// Backward: loads, and its tile products on the tensor cores (TF32 mma.sync)
// ---------------------------------------------------------------------------

// f(r, c) for r < R, c < C: a warp a row, its lanes along the row (no
// integer division in the index arithmetic)
template <typename F>
__device__ __forceinline__ void for_rows(int R, int C, F f) {
  for (int r = threadIdx.x >> 5; r < R; r += BWARPS)
    for (int c = threadIdx.x & 31; c < C; c += 32) f(r, c);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
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

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d[e] += a b[e] for one k-step of 8 and NB B column blocks, the A
// fragment split once.  Every operand is rounded to its nearest TF32 value
// (cvt.rna): handed the raw float bits, the unit would drop the low 13
// mantissa bits, a truncation toward zero that biases every product the
// same way.  SPLIT 3 (float32 inputs): each operand is a TF32 head plus a
// TF32 residual and the three products that matter are summed, small terms
// first (float32 accuracy); SPLIT 1: one TF32 product of the rounded heads
// (bf16 inputs, held to 2e-2; x, B and C are exact in TF32, dy and the
// tile's intermediates W, G, dS and the decay-scaled terms are rounded).
template <int SPLIT, int NB>
__device__ __forceinline__ void mma_step(float (&d)[NB][4],
                                         const float (&a)[4],
                                         const float (&b)[NB][2]) {
  uint32_t ah[4], al[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    ah[i] = tf32(a[i]);
    if constexpr (SPLIT == 3) al[i] = tf32(a[i] - __uint_as_float(ah[i]));
  }
#pragma unroll
  for (int e = 0; e < NB; ++e) {
    const uint32_t bh[2] = {tf32(b[e][0]), tf32(b[e][1])};
    if constexpr (SPLIT == 3) {
      const uint32_t bl[2] = {tf32(b[e][0] - __uint_as_float(bh[0])),
                              tf32(b[e][1] - __uint_as_float(bh[1]))};
      mma_tf32(d[e], al, bh);
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
template <int SPLIT, bool EXACT, int NB, typename A, typename Bf>
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
    mma_step<SPLIT, NB>(s, av, bv);
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
template <int SPLIT, bool EXACT, int NB = 2, typename A1, typename B1,
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
    mm_sum<SPLIT, EXACT, NB>(s1, K1, a1, b1, ra, rb, ct0 * 8 + g, R, C, t);
    mm_sum<SPLIT, EXACT, NB>(s2, K2, a2, b2, ra, rb, ct0 * 8 + g, R, C, t);
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

// One CTA per (b, h) in clusters of CL consecutive heads: the forward walk
// that rebuilds the entering states, then the reverse walk (see the header)
template <typename T, int SPLIT, bool EXACT>
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
    tile_mm<SPLIT, EXACT>(
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
      tile_mm<SPLIT, EXACT, 1>(
          TILE, TILE, N, [=](int i, int n) { return Cs[i * NS + n]; },
          [=](int n, int j) { return Bs[j * NS + n]; }, 0,
          [](int, int) { return 0.f; }, [](int, int) { return 0.f; },
          [=](int i, int j, float g, float) {
            Ws[i * TB + j] = g;
            return make_float2(0.f, 0.f);
          },
          nullptr, nullptr, 0, BWARPS / 2);
    else
      tile_mm<SPLIT, EXACT, 1>(
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
    tile_mm<SPLIT, EXACT>(
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
    tile_mm<SPLIT, EXACT>(
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
    tile_mm<SPLIT, EXACT>(
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
      tile_mm<SPLIT, EXACT>(
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

template <typename T>
int fwd_launch(const void* x, const float* dt, const float* a, const void* bm,
               const void* cm, const float* init, float* y, float* fin,
               int Bsz, int S, int H, int P, int N, cudaStream_t s) {
  const long long smem = fwd_smem(P, N);
  cudaError_t e = cudaFuncSetAttribute(
      ssd_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  ssd_fwd_kernel<T><<<Bsz * H, THREADS, smem, s>>>(
      static_cast<const T*>(x), dt, a, static_cast<const T*>(bm),
      static_cast<const T*>(cm), init, y, fin, S, H, P, N);
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
  constexpr int SPLIT = std::is_same<T, float>::value ? 3 : 1;
  // by shape: every tile product is whole 16 x 16 blocks and 8-deep steps
  void (*kern)(const float*, const T*, const float*, const float*, const T*,
               const T*, const float*, float*, float*, float*, float*, float*,
               int, int, int, int) =
      P % 16 == 0 && N % 16 == 0 ? ssd_bwd_kernel<T, SPLIT, true>
                                : ssd_bwd_kernel<T, SPLIT, false>;
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
      cudaFuncSetAttribute(ssd_bwd_kernel<T, SPLIT, false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)MAX_SMEM),
      cudaFuncSetAttribute(ssd_bwd_kernel<T, SPLIT, true>,
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

}  // namespace

// Dynamic shared memory (bytes) a CTA of the forward (backward = 0) or
// backward (1) kernel needs for state width P and N.
extern "C" long long ssd_scan_smem(int P, int N, int backward) {
  return backward ? bwd_smem(P, N, 4) : fwd_smem(P, N);
}

// x, bm, cm: dtype (0 float32, 1 bfloat16); dt, a, init, y, final_state
// float32; init and final_state may be null.  Launches on `stream` and
// returns a cudaError_t (0 on success) without synchronising.
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* a,
                            const void* bm, const void* cm, const void* init,
                            void* y, void* final_state, int Bsz, int S, int H,
                            int P, int N, int dtype, void* stream) {
  if (!dims_ok(Bsz, S, H, P, N, fwd_smem(P, N)) || y == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* d = static_cast<const float*>(dt);
  const float* av = static_cast<const float*>(a);
  const float* in = static_cast<const float*>(init);
  float* yy = static_cast<float*>(y);
  float* fs = static_cast<float*>(final_state);
  if (dtype == 0)
    return fwd_launch<float>(x, d, av, bm, cm, in, yy, fs, Bsz, S, H, P, N, s);
  if (dtype == 1)
    return fwd_launch<__nv_bfloat16>(x, d, av, bm, cm, in, yy, fs, Bsz, S, H,
                                     P, N, s);
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
