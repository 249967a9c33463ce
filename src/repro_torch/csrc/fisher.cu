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
//   * D > 1, the (N, D, C) kernel.  What it must beat is too few CTAs and
//     too few bytes in flight (a CTA a 32-column tile walking every row
//     with two barriers a row put 32 CTAs on the 132 SMs at (16, 2048,
//     1024) and ran 3.2x slower than the plain version).  A column tile is
//     a thread-block cluster of S <= 8 CTAs: sn row-ranks split the valid rows
//     (first, a whole chunk of rows a rank) and sd D-ranks split d (where
//     the rows run out, each keeping at least GDMIN values).  general_plan
//     takes the widest tile, then the smallest cluster, whose grid fills a
//     wave of the SMs (a function of the shape, dtype and alignment, never
//     of a failed launch).  A thread owns VEC neighbouring columns (16-byte
//     loads when C and the pointers allow it) and a stride of d; it walks
//     its rank's rows NB at a time (NB * VEC = 16 floats), issuing every
//     row's loads for one d before their sums.  Registers are held to 85 a
//     thread, so three CTAs of 256 share an SM: against two at 128, that
//     took the kernel bench's shape from 0.1263-0.1345 to 0.1030-0.1039 ms
//     in f32 and 0.1000-0.1014 to 0.0606-0.0612 in bf16 (8 rows a chunk in
//     f32 and 4 in bf16 before; redesign_bench.py --only general, same
//     card).  The TY d lanes' partials of a chunk meet in shared memory and
//     are summed in lane order; with sd > 1 each rank's u goes to shared
//     memory, and after one cluster barrier D-rank j % sd squares row j of
//     the chunk from the sd partials read over distributed shared memory in
//     rank order (the square needs the whole sum over d).  At the end each
//     CTA sums its columns over its row slots, and the cluster over its
//     ranks in rank order.  No atomics and no workspace: the same inputs
//     give the same bits, and one launch reads each valid element once.
//     One launch was chosen over two (partials to an (S, N, C) workspace,
//     then a reduction kernel): no scratch for the wrapper to allocate, and
//     no second launch gap at the edge CNNs' shapes, where the whole kernel
//     takes 9-26 us (the two-launch form was not built or timed).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int RT = 128;    // threads per block, D == 1 kernel
constexpr int RU = 8;      // rows loaded ahead a thread, D == 1 kernel
constexpr int RCH = 1024;  // rows compacted into shared memory a pass
constexpr int GT = 256;    // threads a CTA at most, (N, D, C) kernel
constexpr int GCH = 256;   // valid rows compacted a pass, (N, D, C) kernel
constexpr int GSPLIT = 8;  // CTAs a cluster at most (the portable size)
constexpr int GWAVE = 132; // SMs of an H100 SXM: the grid's least CTAs
constexpr int GDMIN = 128; // d values a D-rank keeps at least
constexpr int GMINB = 3;   // CTAs of GT threads an SM: at most 85 registers
// shared floats: the (ty, row, column) partials of a chunk, NB * VEC <= 16
// floats a thread and 4 floats of padding a ty lane; a chunk's u, NB rows
// x up to 32 column groups x VEC
constexpr int GPART = GT * 16 + 4 * GT;
constexpr int GU = 16 * 32;

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

// ---------------------------------------------------------------------------
// The (N, D, C) kernel
// ---------------------------------------------------------------------------

// Its launch for a shape and alignment: a function of (N, D, C, dtype,
// aligned) only.  kernels/fisher.py::general_plan is its Python mirror.
struct GPlan {
  long long tiles;  // column tiles, one cluster each
  int S;            // CTAs a cluster: sd D-ranks x sn row-ranks
  int sd, sn;
  int tx, ty;       // threads a CTA: tx column groups x ty d lanes
  int vec;          // neighbouring columns a thread (16 bytes' worth, or 1)
  int nb;           // rows a chunk
  int dc;           // d values a D-rank
  int red;          // threads that sum one (row, column) of a chunk
};

template <typename T>
GPlan general_plan(int N, int D, long long C, bool aligned) {
  constexpr int V = 16 / sizeof(T);
  GPlan p;
  p.vec = (C % V == 0 && aligned) ? V : 1;
  p.nb = p.vec > 1 ? 16 / p.vec : 8;  // 16 or 8 floats a thread a d
  const long long groups = C / p.vec;
  // the most D-ranks (each keeping at least GDMIN d values) and row-ranks
  // (no more than N asks for) a cluster could use
  int sd_max = 1;
  while (sd_max < GSPLIT && (D + 2LL * sd_max - 1) / (2LL * sd_max) >= GDMIN)
    sd_max *= 2;
  int sn_max = 1;
  while (sn_max < N && sn_max < GSPLIT) sn_max *= 2;
  const int s_max = sd_max * sn_max < GSPLIT ? sd_max * sn_max : GSPLIT;
  // the widest column tile (up to 32 groups, at least 4), then the smallest
  // cluster, whose grid fills a wave of the SMs; the narrowest tile and the
  // largest cluster when none does
  int hi = 1;
  while (hi < 32 && hi < groups) hi *= 2;
  const int lo = hi < 4 ? hi : 4;
  p.tx = lo;
  p.S = s_max;
  bool found = false;
  for (int tx = hi; tx >= lo && !found; tx /= 2)
    for (int s = 1; s <= s_max; s *= 2)
      if ((groups + tx - 1) / tx * s >= GWAVE) {
        p.tx = tx;
        p.S = s;
        found = true;
        break;
      }
  // rows first, a row-rank per whole chunk of rows; then D-ranks; the rest
  // of the cluster on rows
  int sn = 1;
  while (2 * sn <= p.S && 2LL * sn * p.nb <= N) sn *= 2;
  p.sd = p.S / sn < sd_max ? p.S / sn : sd_max;
  p.sn = p.S / p.sd;
  p.dc = (D + p.sd - 1) / p.sd;
  int f = 1;  // the largest power of two <= dc
  while (2 * f <= p.dc && 2 * f <= GT) f *= 2;
  p.ty = GT / p.tx < f ? GT / p.tx : f;
  if (p.ty < p.vec) p.ty = p.vec;          // a thread a (row slot, column)
  if (p.tx * p.ty < 32) p.ty = 32 / p.tx;  // a whole warp compacts the rows
  p.tiles = (groups + p.tx - 1) / p.tx;
  p.red = p.ty / (p.nb * p.vec) > 1 ? p.ty / (p.nb * p.vec) : 1;
  return p;
}

struct GArgs {
  const void* a;
  const void* g;
  const float* mask;
  float* out;
  long long C;
  int N, D;
  float scale;
  int mask_norm;
  int S, sd, sn, tx, ty, dc, red;
};

// One cluster of S CTAs a column tile of CT = tx * VEC columns; rank
// (rn, rd) = (rank / sd, rank % sd) reads d in [rd * dc, rd * dc + dc) of
// the valid rows k = rn, rn + sn, ... of each pass's compacted list, NB
// rows a chunk.  Thread (tx, ty) owns VEC neighbouring columns and the d
// values d_lo + ty, d_lo + ty + TY, ...; for each d it issues the loads of
// every row of the chunk before their sums.
template <typename T, int VEC, int NB>
__global__ void __launch_bounds__(GT, GMINB)
fisher_general_kernel(const GArgs p) {
  __shared__ __align__(16) float s_part[GPART];  // (ty, row, column) sums
  __shared__ float s_u[2][GU];  // a chunk's u over this rank's d (sd > 1)
  __shared__ int s_row[GCH];    // the pass's valid rows, in order
  __shared__ float s_w[GCH];    // their weights m^2 (1 without a mask)
  __shared__ int s_cnt;
  __shared__ float s_msum;

  cg::cluster_group cluster = cg::this_cluster();
  const int S = p.S, sd = p.sd, sn = p.sn, TX = p.tx, TY = p.ty, R = p.red;
  const int rank = (int)cluster.block_rank();  // blockIdx.x % S
  const int rn = rank / sd, rd = rank % sd;
  const long long tile = blockIdx.x / S;
  const int NT = TX * TY, CT = TX * VEC, LDP = NB * CT + 4;
  const int t = threadIdx.x, tx = t % TX, ty = t / TX;
  const long long c0 = tile * CT + (long long)tx * VEC;
  const bool live = c0 < p.C;
  const int d_lo = rd * p.dc;
  const int d_hi = min(p.D, d_lo + p.dc);
  const T* const a = static_cast<const T*>(p.a);
  const T* const g = static_cast<const T*>(p.g);
  const long long DC = (long long)p.D * p.C;
  // the sums' roles: entry e0 of a chunk's NB x CT (row, column) values,
  // summed by R neighbouring threads (lane r); a thread keeps column c and
  // the rows js, js + slots, ... of every chunk
  const int e0 = t / R, r = t % R, c = e0 % CT, js = e0 / CT;
  const int slots = NT / (R * CT);
  const int per = TY / R;  // ty lanes a summing thread adds
  float acc = 0.f, msum = 0.f;
  int buf = 0;
  for (int r0 = 0; r0 < p.N; r0 += GCH) {
    const int rows = min(GCH, p.N - r0);
    __syncthreads();  // every thread is done with the previous pass's list
    if (t < 32) {
      int cnt = 0;
      float ms = 0.f;
      for (int i0 = 0; i0 < rows; i0 += 32) {
        const int i = i0 + t;
        const float m =
            (i < rows && p.mask != nullptr) ? p.mask[r0 + i] : 1.f;
        const bool keep = i < rows && m != 0.f;  // padded rows: never read
        const unsigned bal = __ballot_sync(0xffffffffu, keep);
        if (keep) {
          const int at = cnt + __popc(bal & ((1u << t) - 1u));
          s_row[at] = r0 + i;
          s_w[at] = m * m;
        }
        cnt += __popc(bal);
        if (i < rows && p.mask != nullptr) ms += m;
      }
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        ms += __shfl_xor_sync(0xffffffffu, ms, off);
      if (t == 0) {
        s_cnt = cnt;
        s_msum = ms;
      }
    }
    __syncthreads();
    const int cnt = s_cnt;
    msum += s_msum;
    // every rank of the cluster walks the same number of chunks, so the
    // cluster barriers below match
    const int nch = ((cnt + sn - 1) / sn + NB - 1) / NB;
    for (int ch = 0; ch < nch; ++ch) {
      const int k0 = rn + sn * ch * NB;  // row i of the chunk: k0 + sn * i
      const int nv = k0 < cnt ? min(NB, (cnt - k0 + sn - 1) / sn) : 0;
      long long off[NB];
#pragma unroll
      for (int i = 0; i < NB; ++i)
        off[i] = i < nv ? (long long)s_row[k0 + sn * i] * DC + c0 : 0;
      float pv[NB][VEC];
#pragma unroll
      for (int i = 0; i < NB; ++i)
#pragma unroll
        for (int v = 0; v < VEC; ++v) pv[i][v] = 0.f;
      if (live) {
        for (int d = d_lo + ty; d < d_hi; d += TY) {
          const long long dof = (long long)d * p.C;
          float x[NB][VEC], y[NB][VEC];
#pragma unroll
          for (int i = 0; i < NB; ++i) {  // the chunk's loads, then sums
            if (i < nv) {
              load_vec<T, VEC>(a + off[i] + dof, x[i]);
              load_vec<T, VEC>(g + off[i] + dof, y[i]);
            }
          }
#pragma unroll
          for (int i = 0; i < NB; ++i) {
            if (i < nv) {
#pragma unroll
              for (int v = 0; v < VEC; ++v)
                pv[i][v] = fmaf(x[i][v], y[i][v], pv[i][v]);
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        float* const dst = s_part + ty * LDP + i * CT + tx * VEC;
        if constexpr (VEC % 4 == 0) {
#pragma unroll
          for (int q = 0; q < VEC / 4; ++q)
            reinterpret_cast<float4*>(dst)[q] =
                make_float4(pv[i][4 * q], pv[i][4 * q + 1], pv[i][4 * q + 2],
                            pv[i][4 * q + 3]);
        } else {
#pragma unroll
          for (int v = 0; v < VEC; ++v) dst[v] = pv[i][v];
        }
      }
      __syncthreads();
      // u over this CTA's d: the ty lanes in order, R threads an entry,
      // each over a run of TY / R lanes, then a butterfly over the R
      // (commutative adds: the same bits on every lane of the entry)
      for (int j = js; j < NB; j += slots) {
        float u = 0.f;
        for (int yy = r * per; yy < (r + 1) * per; ++yy)
          u += s_part[yy * LDP + j * CT + c];
        for (int o = R / 2; o > 0; o /= 2)
          u += __shfl_xor_sync(0xffffffffu, u, o);
        if (r != 0) continue;
        if (sd == 1) {
          if (j < nv) acc += s_w[k0 + sn * j] * (u * u);
        } else {
          s_u[buf][j * CT + c] = u;
        }
      }
      if (sd > 1) {
        cluster.sync();  // every D-rank's u of the chunk is written
        // row j of the chunk is squared by D-rank j % sd: its u is the
        // D-ranks' partials in rank order, read over DSMEM
        if (r == 0) {
          for (int j = js; j < NB; j += slots) {
            if (j % sd != rd || j >= nv) continue;
            float u = 0.f;
            for (int q = 0; q < sd; ++q)
              u += *cluster.map_shared_rank(&s_u[buf][j * CT + c],
                                            rn * sd + q);
            acc += s_w[k0 + sn * j] * (u * u);
          }
        }
        buf ^= 1;  // the ranks read buf until the next chunk's barrier
      } else {
        __syncthreads();  // s_part is read before the next chunk writes it
      }
    }
  }
  // the CTA's sum of each column over its row slots, in order, then the
  // cluster's over its ranks, in rank order, over DSMEM
  __syncthreads();
  if (r == 0) s_part[js * CT + c] = acc;
  __syncthreads();
  float* const s_fin = s_part + GT;
  if (t < CT) {
    float s = 0.f;
    for (int q = 0; q < slots; ++q) s += s_part[q * CT + t];
    s_fin[t] = s;
  }
  cluster.sync();  // every rank's column sums are written
  const float sc = p.mask_norm ? p.scale / fmaxf(msum, 1.f) : p.scale;
  for (int cc = rank + S * t; cc < CT; cc += S * NT) {
    const long long col = tile * CT + cc;
    if (col < p.C) {
      float o = 0.f;
      for (int q = 0; q < S; ++q) o += *cluster.map_shared_rank(s_fin + cc, q);
      p.out[col] = o * sc;
    }
  }
  cluster.sync();  // no rank leaves while another still reads its memory
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

// The (N, D, C) kernel's launch; with `plan`, writes plan[0..10] (CTAs,
// cluster size, threads_x, threads_y, columns a thread, rows a chunk,
// D-ranks, row-ranks, d values a D-rank, threads a sum, registers a
// thread) instead of launching.
template <typename T>
int launch_general(const T* a, const T* g, const float* m, float* o, int N,
                   int D, long long C, float scale, int mask_norm,
                   cudaStream_t stream, int* plan) {
  const bool aligned = (reinterpret_cast<uintptr_t>(a) & 15) == 0 &&
                       (reinterpret_cast<uintptr_t>(g) & 15) == 0;
  const GPlan q = general_plan<T>(N, D, C, aligned);
  const long long blocks = q.tiles * q.S;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  constexpr int V = 16 / sizeof(T);
  void (*kern)(const GArgs) = q.vec == V ? fisher_general_kernel<T, V, 16 / V>
                                         : fisher_general_kernel<T, 1, 8>;
  if (plan) {
    cudaFuncAttributes fa;
    const cudaError_t err = cudaFuncGetAttributes(&fa, kern);
    if (err != cudaSuccess) return (int)err;
    const int vals[11] = {(int)blocks, q.S,  q.tx, q.ty, q.vec,      q.nb,
                          q.sd,        q.sn, q.dc, q.red, fa.numRegs};
    for (int i = 0; i < 11; ++i) plan[i] = vals[i];
    return 0;
  }
  const GArgs args{a,         g,    m,    o,    C,    N,    D,    scale,
                   mask_norm, q.S,  q.sd, q.sn, q.tx, q.ty, q.dc, q.red};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks, 1, 1);
  cfg.blockDim = dim3((unsigned)(q.tx * q.ty), 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = q.S;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kern, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* a, const void* g, const void* mask, void* out, int N,
           int D, long long C, float scale, int mask_norm,
           cudaStream_t stream, int* plan) {
  const T* a_ = static_cast<const T*>(a);
  const T* g_ = static_cast<const T*>(g);
  const float* m_ = static_cast<const float*>(mask);
  float* o_ = static_cast<float*>(out);
  if (D == 1 && plan == nullptr)
    return launch_rows<T>(a_, g_, m_, o_, 1, N, C, scale, mask_norm, stream,
                          nullptr, 1, nullptr);
  return launch_general<T>(a_, g_, m_, o_, N, D, C, scale, mask_norm, stream,
                           plan);
}

}  // namespace

// The materialised-activation form: a, g (N, D, C) with one dtype, mask
// nullptr or (N,) float32, out (C,) float32.  dtype 0 = float32, 1 =
// bfloat16.  D == 1 goes to the row kernel (with the activation operand),
// every other D to the (N, D, C) kernel.  Launches on `stream` without
// synchronising; returns the launch's cudaError_t.
extern "C" int fisher_fwd(const void* a, const void* g, const void* mask,
                          void* out, int N, int D, long long C, float scale,
                          int mask_norm, int dtype, void* stream) {
  if (a == nullptr || N < 1 || D < 1 || C < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(a, g, mask, out, N, D, C, scale, mask_norm, s,
                         nullptr);
  if (dtype == 1)
    return launch<__nv_bfloat16>(a, g, mask, out, N, D, C, scale, mask_norm,
                                 s, nullptr);
  return (int)cudaErrorInvalidValue;
}

// The launch the (N, D, C) kernel makes for a, g (N, D, C) (only their
// alignment is read), at any D, without making it: plan[0..10] as
// launch_general writes them.  Returns a cudaError_t.
extern "C" int fisher_general_plan(const void* a, const void* g, int N, int D,
                                   long long C, int dtype, int* plan) {
  if (plan == nullptr || N < 1 || D < 1 || C < 1)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(a, g, nullptr, nullptr, N, D, C, 0.f, 0, nullptr,
                         plan);
  if (dtype == 1)
    return launch<__nv_bfloat16>(a, g, nullptr, nullptr, N, D, C, 0.f, 0,
                                 nullptr, plan);
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
