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
// Backward (ssd_bwd_kernel, then reduce_heads).  Given dy (the final
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
// S_in is recomputed: the backward entry first runs the forward without y
// into a scratch of tile states (nothing is kept between the forward and
// the backward but the inputs, which autograd holds anyway), or takes zero
// when the sequence is one tile with no initial state.  dB and dC sum over
// heads, which no (b, h) CTA owns: each CTA writes its head's partial, and
// reduce_heads sums the H partials in a fixed order.  Every sum in both
// kernels runs in a fixed order (no atomics), so the gradients and the
// Fisher scores built on them are the same from run to run.  a and init
// get no gradient (the wrapper refuses them).
//
// Every product of a tile is a small matrix product of shared-memory
// operands (block_mm): each thread accumulates a 2x2, 2x4 or 4x4 block of
// outputs in registers, so a loaded operand feeds several multiply-adds;
// the triangular sums run over the whole tile, since W and G hold zeros
// above the diagonal.  The kernels take P and N in multiples of 4.  Work
// that no output needs is skipped: the state update after the last tile
// when no final state is asked for, the state terms of a tile whose
// entering state is zero, the adjoint of the state entering tile 0.
//
// What bounds it on this card.  At the adapt shape (B 48, S 64, H 64, P
// 64, N 128, bf16 x, B, C) the forward must move 77.9 MB (0.023 ms at
// 3.35 TB/s) and its loops do 4.5 GFLOP, 0.067 ms on float32 CUDA cores
// (the tensor cores are idle here): bytes bound the work, but float32
// FMAs fed from shared memory bound this kernel.  The design keeps every
// operand of a tile in shared memory (rows padded to odd strides, so the
// lanes of a warp hit distinct banks), reads each input once, and never
// lets the state leave the SM.  The backward moves 105.4 MB and does
// 11.4 GFLOP, plus 2 x 100.7 MB of per-head partials at the adapt shape.
// Tensor cores (mma.sync / wgmma over the tile's products, which needs a
// float32-accurate split at the f32 bar) and a head-blocked dB/dC are
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 32;      // tokens per tile: one warp lane per row
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TS = TILE + 1;  // padded row stride of the TILE x TILE tiles
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

long long bwd_smem(int P, int N) {
  return 4LL * (2LL * P * (N + 1) + 3LL * TILE * (N + 1) +
                5LL * TILE * (P + 1) + 3LL * TILE * TS + 7 * TILE + WARPS);
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
               float* __restrict__ states, int S, int H, int P, int N) {
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
    if (states) {
      float* dst = states + (bh * nt + t) * PN;
      for (int idx = tid; idx < P * N; idx += THREADS)
        dst[idx] = st[(idx / N) * NS + idx % N];
    }
    if (!y && !update) break;
    load_tile(x, dt, bm, cm, b, h, s0, rows, S, H, P, N, dts, nullptr, Us, Bs,
              Cs);
    tile_cumsum(dts, av, cum);
    __syncthreads();
    auto c_in = [=](int i, int n) { return Cs[i * NS + n]; };
    if (y) {
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
    }
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

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_kernel(const float* __restrict__ dy, const T* __restrict__ x,
               const float* __restrict__ dt, const float* __restrict__ a,
               const T* __restrict__ bm, const T* __restrict__ cm,
               const float* __restrict__ states, float* __restrict__ dx,
               float* __restrict__ ddt, float* __restrict__ db_part,
               float* __restrict__ dc_part, int S, int H, int P, int N) {
  extern __shared__ float smem[];
  const int NS = N + 1, PS = P + 1;
  float* Sin = smem;                 // P x NS   state entering the tile
  float* dS = Sin + P * NS;          // P x NS   adjoint of the leaving state
  float* Bs = dS + P * NS;           // TILE x NS
  float* Cs = Bs + TILE * NS;        // TILE x NS
  float* Es = Cs + TILE * NS;        // TILE x NS  C_i[n] (S_in^T dy_i)[n]
  float* Xs = Es + TILE * NS;        // TILE x PS
  float* Us = Xs + TILE * PS;        // TILE x PS  u = x dt
  float* dYs = Us + TILE * PS;       // TILE x PS
  float* dUs = dYs + TILE * PS;      // TILE x PS
  float* Qs = dUs + TILE * PS;       // TILE x PS  u_j[p] (dS B_j)[p] decay_j
  float* Ws = Qs + TILE * PS;        // TILE x TS  (C B^T) . L
  float* Gs = Ws + TILE * TS;        // TILE x TS  (dy_i.u_j) L_ij
  float* Rs = Gs + TILE * TS;        // TILE x TS  (dy_i.u_j) W_ij
  float* dts = Rs + TILE * TS;       // TILE each below
  float* cum = dts + TILE;
  float* ecum = cum + TILE;
  float* decay = ecum + TILE;
  float* ddt_u = decay + TILE;
  float* qv = ddt_u + TILE;
  float* dcum = qv + TILE;
  float* red = dcum + TILE;          // WARPS
  const int h = blockIdx.x % H, b = blockIdx.x / H, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const float av = a[h];
  const int nt = (S + TILE - 1) / TILE;
  const long long PN = (long long)P * N, bh = (long long)b * H + h;
  const bool sin_zero = states == nullptr;  // one tile, zero initial state
  bool ds_zero = true;                      // the final state has no grad

  for (int idx = tid; idx < P * N; idx += THREADS) {
    dS[(idx / N) * NS + idx % N] = 0.f;
    Sin[(idx / N) * NS + idx % N] = 0.f;
  }
  for (int t = nt - 1; t >= 0; --t) {
    const int s0 = t * TILE, rows = min(TILE, S - s0);
    if (!sin_zero) {
      const float* src = states + (bh * nt + t) * PN;
      for (int idx = tid; idx < P * N; idx += THREADS)
        Sin[(idx / N) * NS + idx % N] = src[idx];
    }
    for (int idx = tid; idx < TILE * P; idx += THREADS) {
      const int i = idx / P, p = idx % P;
      dYs[i * PS + p] =
          i < rows ? dy[(((long long)b * S + s0 + i) * H + h) * P + p] : 0.f;
    }
    load_tile(x, dt, bm, cm, b, h, s0, rows, S, H, P, N, dts, Xs, Us, Bs, Cs);
    tile_cumsum(dts, av, cum);
    __syncthreads();
    const float clast = cum[TILE - 1];
    if (tid < TILE) {
      ecum[tid] = expf(cum[tid]);
      decay[tid] = expf(clast - cum[tid]);
    }
    // W = (C B^T) . L, G = (dy u^T) . L and R = (dy u^T) . W, 0 above the
    // diagonal
    block_mm<2, 2>(
        TILE, TILE, N, [=](int i, int n) { return Cs[i * NS + n]; },
        [=](int n, int j) { return Bs[j * NS + n]; }, P,
        [=](int i, int p) { return dYs[i * PS + p]; },
        [=](int p, int j) { return Us[j * PS + p]; },
        [=](int i, int j, float g, float d) {
          const bool on = j <= i;
          const float l = on ? expf(cum[i] - cum[j]) : 0.f;
          Ws[i * TS + j] = on ? g * l : 0.f;
          Gs[i * TS + j] = on ? d * l : 0.f;
          Rs[i * TS + j] = on ? d * g * l : 0.f;
        });
    __syncthreads();
    // du, dx and the decay term of dcum
    block_mm<2, 4>(
        TILE, P, TILE, [=](int j, int i) { return Ws[i * TS + j]; },
        [=](int i, int p) { return dYs[i * PS + p]; }, ds_zero ? 0 : N,
        [=](int j, int n) { return Bs[j * NS + n]; },
        [=](int n, int p) { return dS[p * NS + n]; },
        [=](int j, int p, float acc, float z) {
          const float du = acc + decay[j] * z;
          dUs[j * PS + p] = du;
          Qs[j * PS + p] = Us[j * PS + p] * z * decay[j];
          if (j < rows)
            dx[(((long long)b * S + s0 + j) * H + h) * P + p] = dts[j] * du;
        });
    // this head's dC
    block_mm<4, 4>(
        TILE, N, TILE, [=](int i, int j) { return Gs[i * TS + j]; },
        [=](int j, int n) { return Bs[j * NS + n]; }, sin_zero ? 0 : P,
        [=](int i, int p) { return dYs[i * PS + p]; },
        [=](int p, int n) { return Sin[p * NS + n]; },
        [=](int i, int n, float acc, float w) {
          Es[i * NS + n] = Cs[i * NS + n] * w;
          if (i < rows)
            dc_part[(bh * S + s0 + i) * N + n] = acc + ecum[i] * w;
        });
    // this head's dB
    block_mm<4, 4>(
        TILE, N, TILE, [=](int j, int i) { return Gs[i * TS + j]; },
        [=](int i, int n) { return Cs[i * NS + n]; }, ds_zero ? 0 : P,
        [=](int j, int p) { return Us[j * PS + p]; },
        [=](int p, int n) { return dS[p * NS + n]; },
        [=](int j, int n, float acc, float z) {
          if (j < rows)
            db_part[(bh * S + s0 + j) * N + n] = acc + decay[j] * z;
        });
    __syncthreads();
    // per-row sums, one warp a row, lanes in a fixed pattern
    for (int r = warp; r < TILE; r += WARPS) {
      float s1 = 0.f, s2 = 0.f, s3 = 0.f;
      for (int p = lane; p < P; p += 32) {
        s1 += Xs[r * PS + p] * dUs[r * PS + p];
        s2 += Qs[r * PS + p];
      }
      for (int n = lane; n < N; n += 32) s3 += Es[r * NS + n];
      const float s4 = lane <= r ? Rs[r * TS + lane] : 0.f;   // row sum
      const float s5 = lane >= r ? Rs[lane * TS + r] : 0.f;   // column sum
      s1 = warp_sum(s1);
      s2 = warp_sum(s2);
      s3 = warp_sum(s3);
      const float rs = warp_sum(s4), cs = warp_sum(s5);
      if (lane == 0) {
        ddt_u[r] = s1;
        qv[r] = s2;
        dcum[r] = rs - cs + ecum[r] * s3 - s2;
      }
    }
    // <dS, S_in>, block-reduced in a fixed order
    float part = 0.f;
    if (!ds_zero && !sin_zero)
      for (int idx = tid; idx < P * N; idx += THREADS) {
        const int o = (idx / N) * NS + idx % N;
        part += dS[o] * Sin[o];
      }
    part = warp_sum(part);
    if (lane == 0) red[warp] = part;
    __syncthreads();
    // dS for the tile before: exp(cum_last) dS + sum_i exp(cum_i) dy_i C_i
    const float eclast = expf(clast);
    if (t > 0)  // tile 0's leaving-state adjoint feeds nothing
      block_mm<4, 4>(
          P, N, TILE, [=](int p, int i) { return ecum[i] * dYs[i * PS + p]; },
          [=](int i, int n) { return Cs[i * NS + n]; }, 0,
          [](int, int) { return 0.f; }, [](int, int) { return 0.f; },
          [=](int p, int n, float acc, float) {
            dS[p * NS + n] = (ds_zero ? 0.f : dS[p * NS + n] * eclast) + acc;
          });
    if (warp == 0) {
      float sdot = 0.f;
      for (int w = 0; w < WARPS; ++w) sdot += red[w];
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
    __syncthreads();
  }
}

// out[b, s, n] = sum_h part[b, h, s, n], h in order: the dB and dC sums
// over heads, deterministic.
__global__ void __launch_bounds__(THREADS)
reduce_heads(const float* __restrict__ part, float* __restrict__ out,
             long long total, long long per_b, int H) {
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
       idx < total; idx += stride) {
    const long long b = idx / per_b, rem = idx % per_b;
    const float* src = part + b * H * per_b + rem;
    float acc = 0.f;
    for (int h = 0; h < H; ++h) acc += src[h * per_b];
    out[idx] = acc;
  }
}

int reduce_launch(const float* part, float* out, int Bsz, int S, int H,
                  int N, cudaStream_t s) {
  const long long per_b = (long long)S * N, total = per_b * Bsz;
  long long want = (total + THREADS - 1) / THREADS;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  reduce_heads<<<blocks, THREADS, 0, s>>>(part, out, total, per_b, H);
  return (int)cudaGetLastError();
}

template <typename T>
int fwd_launch(const void* x, const float* dt, const float* a, const void* bm,
               const void* cm, const float* init, float* y, float* fin,
               float* states, int Bsz, int S, int H, int P, int N,
               cudaStream_t s) {
  const long long smem = fwd_smem(P, N);
  cudaError_t e = cudaFuncSetAttribute(
      ssd_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  ssd_fwd_kernel<T><<<Bsz * H, THREADS, smem, s>>>(
      static_cast<const T*>(x), dt, a, static_cast<const T*>(bm),
      static_cast<const T*>(cm), init, y, fin, states, S, H, P, N);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd_launch(const float* dy, const void* x, const float* dt, const float* a,
               const void* bm, const void* cm, const float* init,
               float* states, float* dx, float* ddt, float* db_part,
               float* dc_part, float* db, float* dc, int Bsz, int S, int H,
               int P, int N, cudaStream_t s) {
  if (states) {
    // recompute the state entering each tile (the forward, without y)
    int rc = fwd_launch<T>(x, dt, a, bm, cm, init, nullptr, nullptr, states,
                           Bsz, S, H, P, N, s);
    if (rc) return rc;
  }
  const long long smem = bwd_smem(P, N);
  cudaError_t e = cudaFuncSetAttribute(
      ssd_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  ssd_bwd_kernel<T><<<Bsz * H, THREADS, smem, s>>>(
      dy, static_cast<const T*>(x), dt, a, static_cast<const T*>(bm),
      static_cast<const T*>(cm), states, dx, ddt, db_part, dc_part, S, H, P,
      N);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  int rc = reduce_launch(db_part, db, Bsz, S, H, N, s);
  if (rc) return rc;
  return reduce_launch(dc_part, dc, Bsz, S, H, N, s);
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
  return backward ? bwd_smem(P, N) : fwd_smem(P, N);
}

// x, bm, cm: dtype (0 float32, 1 bfloat16); dt, a, init, y, final_state
// float32; init and final_state may be null.  Launches on `stream` and
// returns a cudaError_t (0 on success) without synchronising.
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* a,
                            const void* bm, const void* cm, const void* init,
                            void* y, void* final_state, int Bsz, int S, int H,
                            int P, int N, int dtype, void* stream) {
  if (!dims_ok(Bsz, S, H, P, N, fwd_smem(P, N)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* d = static_cast<const float*>(dt);
  const float* av = static_cast<const float*>(a);
  const float* in = static_cast<const float*>(init);
  float* yy = static_cast<float*>(y);
  float* fs = static_cast<float*>(final_state);
  if (y == nullptr) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return fwd_launch<float>(x, d, av, bm, cm, in, yy, fs, nullptr, Bsz, S,
                             H, P, N, s);
  if (dtype == 1)
    return fwd_launch<__nv_bfloat16>(x, d, av, bm, cm, in, yy, fs, nullptr,
                                     Bsz, S, H, P, N, s);
  return (int)cudaErrorInvalidValue;
}

// dy, dx (B,S,H,P), ddt (B,S,H), db, dc (B,S,N), db_part, dc_part
// (B,H,S,N) scratch: all float32.  x, bm, cm, dt, a and init (may be null)
// are the forward's inputs.  states is (B, H, ceil(S/32), P, N) float32
// scratch for the recomputed tile states, or null when S <= 32 and init
// is null (every tile then enters with a zero state).  Launches up to four
// kernels on `stream`; returns a cudaError_t without synchronising.
extern "C" int ssd_scan_bwd(const void* dy, const void* x, const void* dt,
                            const void* a, const void* bm, const void* cm,
                            const void* init, void* states, void* dx,
                            void* ddt, void* db_part, void* dc_part, void* db,
                            void* dc, int Bsz, int S, int H, int P, int N,
                            int dtype, void* stream) {
  if (!dims_ok(Bsz, S, H, P, N, bwd_smem(P, N)) ||
      !dims_ok(Bsz, S, H, P, N, fwd_smem(P, N)) ||
      (states == nullptr && (S > TILE || init != nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(dy);
  const float* d = static_cast<const float*>(dt);
  const float* av = static_cast<const float*>(a);
  const float* in = static_cast<const float*>(init);
  float* st = static_cast<float*>(states);
  float* o[6] = {static_cast<float*>(dx), static_cast<float*>(ddt),
                 static_cast<float*>(db_part), static_cast<float*>(dc_part),
                 static_cast<float*>(db), static_cast<float*>(dc)};
  if (dtype == 0)
    return bwd_launch<float>(g, x, d, av, bm, cm, in, st, o[0], o[1], o[2],
                             o[3], o[4], o[5], Bsz, S, H, P, N, s);
  if (dtype == 1)
    return bwd_launch<__nv_bfloat16>(g, x, d, av, bm, cm, in, st, o[0], o[1],
                                     o[2], o[3], o[4], o[5], Bsz, S, H, P, N,
                                     s);
  return (int)cudaErrorInvalidValue;
}
