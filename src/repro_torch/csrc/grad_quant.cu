// Int8 error-feedback quantisation of one tensor for Hopper (sm_90a), CUDA
// C++ with a plain C entry point loaded through ctypes.
//
// Replaces: src/repro/kernels/grad_quant.py::grad_quant_pallas
// (_absmax_kernel, then _quant_kernel), the Pallas TPU twin of
// repro.optim.compress.int8_compress.  On the personalisation path it packs
// every leaf of every refreshed user's delta set before the hot swap.
//
// Contract, over the n elements of g (f32 or bf16) and err (f32), both
// flat and contiguous:
//   g32     = float(g) + err
//   absmax  = max |g32|                 (NaN if any g32 is NaN)
//   scale   = absmax / 127 + 1e-12      (float32 scalar)
//   q       = clip(round_half_even(g32 / scale), -127, 127) as int8
//   new_err = g32 - float(q) * scale
// The arithmetic is the plain version's (kernels/ref.py::grad_quant_ref)
// and the JAX package's XLA path step for step, so the result is bit-exact:
//   * every add, divide and multiply is an _rn intrinsic, which nvcc never
//     contracts into an FMA (the build keeps nvcc's default -fmad=true, so a
//     plain `g32 - q * scale` would become one fused op and round once);
//   * g32 is divided by scale, as the XLA path and the oracle do (the Pallas
//     kernel multiplies by 1/scale, which rounds some ties the other way);
//   * rintf rounds half to even, as torch.round and jnp.round do;
//   * the clip lets NaN through and the int8 conversion (cvt, NaN -> 0)
//     matches PyTorch's float -> int8 cast on the card; new_err is formed
//     from the converted code, as the plain version forms it from q.float().
//
// One launch, no memset, no atomics and no host read: the scale never
// leaves the device.  A thread takes units of 16 consecutive elements (g
// and err read 16 bytes a load, q written 16 codes a store, new_err 16
// bytes a store); the ragged tail, a unit past n, goes element by element.
// Three paths, chosen by n (gq_geometry; grad_quant_plan reports it):
//   0. one CTA (n <= MIN_PER_CTA): g32 stays in its shared memory, a
//      block barrier between the absmax and the quantisation;
//   1. on chip (n up to the SMs x CAP floats the SMs' shared memory holds):
//      a cooperative grid of min(SMs, ceil(n / MIN_PER_CTA)) CTAs of 512
//      threads, one an SM, each over a contiguous slice of n in units of
//      16.  Phase 1 reads its slice of g and err once, keeps g32 in shared
//      memory and writes its block absmax to its own slot; a grid-wide
//      barrier (cg::this_grid().sync()); phase 2 reads the slots in a fixed
//      order, forms the scale, and quantises from shared memory;
//   2. two passes (larger n): a cooperative grid of 2 CTAs an SM strides
//      over the units, reading g and err once for the absmax (kept in L2
//      where it can be) and once more after the barrier for the codes,
//      walking the units backwards, so that what phase 1 read last, the
//      likeliest to be still in L2, is read first.
// Every absmax is a max, exact whatever the order, with NaN propagating
// (a NaN anywhere gives a NaN scale, as torch.amax and jnp.max do), so the
// result is the same from run to run.  The grid is held to
// cudaOccupancyMaxActiveBlocksPerMultiprocessor (asked once a dtype and
// path), so it is resident whole, as a cooperative launch requires.
//
// What bounds it on this card: bytes.  Read once, g and err and the
// writes of q and new_err are 11 bytes an element for bf16 g (15 for f32),
// against a handful of operations, far below the ~20 operations per byte
// where an H100 stops being limited by its 3.35 TB/s memory.  The main
// path's largest leaf (6.9M elements, bf16 g) fits the on-chip path: 52,144
// floats (208,576 B) a CTA on 132 SMs, where reading the inputs twice
// would cost a second pass through memory (41 MB, most of it past the 50
// MB L2 by the time the second pass reaches it).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int U = 16;                  // elements a unit
constexpr int MIN_PER_CTA = 8192;      // at most this many: one CTA
constexpr long long MAX_SMEM = 232448;
// floats of g32 a CTA holds: its shared memory less the static slots, in
// whole units
constexpr long long CAP = (MAX_SMEM - 256) / 4 / U * U;
constexpr int TWO_PASS_PER_SM = 2;     // CTAs an SM on the two-pass path
constexpr int MAX_CTAS = 1024;         // slots in the wrapper's scratch

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// max that keeps a NaN once it has seen one
__device__ __forceinline__ float nan_max(float a, float b) {
  return (b > a || b != b) ? b : a;
}

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// a 16-byte load: LAST marks the element's last read (evict first from
// L2), else it stays cached for the two-pass path's second read
template <bool LAST, typename V>
__device__ __forceinline__ V ld16(const V* p) {
  return LAST ? __ldcs(p) : __ldg(p);
}

// g32 of the whole unit at i0 (16-byte aligned): four float4 chunks
template <bool LAST>
__device__ __forceinline__ void load_unit(const float* g, const float* err,
                                          long long i0, float4 (&v)[4]) {
  const float4* g4 = reinterpret_cast<const float4*>(g + i0);
  const float4* e4 = reinterpret_cast<const float4*>(err + i0);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float4 a = ld16<LAST>(g4 + c), e = ld16<LAST>(e4 + c);
    v[c] = make_float4(__fadd_rn(a.x, e.x), __fadd_rn(a.y, e.y),
                       __fadd_rn(a.z, e.z), __fadd_rn(a.w, e.w));
  }
}
template <bool LAST>
__device__ __forceinline__ void load_unit(const __nv_bfloat16* g,
                                          const float* err, long long i0,
                                          float4 (&v)[4]) {
  const uint4* g4 = reinterpret_cast<const uint4*>(g + i0);
  const float4* e4 = reinterpret_cast<const float4*>(err + i0);
  const uint4 ga = ld16<LAST>(g4), gb = ld16<LAST>(g4 + 1);
  const uint32_t w[8] = {ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, gb.z, gb.w};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float4 e = ld16<LAST>(e4 + c);
    v[c] = make_float4(__fadd_rn(bf16_lo(w[2 * c]), e.x),
                       __fadd_rn(bf16_hi(w[2 * c]), e.y),
                       __fadd_rn(bf16_lo(w[2 * c + 1]), e.z),
                       __fadd_rn(bf16_hi(w[2 * c + 1]), e.w));
  }
}

__device__ __forceinline__ float abs_max4(float m, float4 v) {
  m = nan_max(m, fabsf(v.x));
  m = nan_max(m, fabsf(v.y));
  m = nan_max(m, fabsf(v.z));
  return nan_max(m, fabsf(v.w));
}

__device__ __forceinline__ int code(float g32, float scale) {
  float qf = rintf(__fdiv_rn(g32, scale));
  qf = qf < -127.f ? -127.f : (qf > 127.f ? 127.f : qf);  // NaN passes
  return __float2int_rz(qf);
}

__device__ __forceinline__ float residual(float g32, int qi, float scale) {
  return __fsub_rn(g32, __fmul_rn(__int2float_rn(qi), scale));
}

// q and new_err of the whole unit at i0: 16 codes in one store
__device__ __forceinline__ void store_unit(const float4 (&v)[4], float scale,
                                           long long i0, signed char* q,
                                           float* new_err) {
  uint32_t packed[4];
  float4* e4 = reinterpret_cast<float4*>(new_err + i0);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int a = code(v[c].x, scale), b = code(v[c].y, scale);
    const int d = code(v[c].z, scale), f = code(v[c].w, scale);
    packed[c] = (uint32_t)(a & 0xff) | ((uint32_t)(b & 0xff) << 8) |
                ((uint32_t)(d & 0xff) << 16) | ((uint32_t)(f & 0xff) << 24);
    __stcs(e4 + c, make_float4(residual(v[c].x, a, scale),
                               residual(v[c].y, b, scale),
                               residual(v[c].z, d, scale),
                               residual(v[c].w, f, scale)));
  }
  __stcs(reinterpret_cast<uint4*>(q + i0),
         make_uint4(packed[0], packed[1], packed[2], packed[3]));
}

// A unit into / out of shared memory at `u` (16 floats, chunk c at 4 c): a
// lane moves its chunks in the order (k + lane / 2) % 4, so the eight lanes
// of a quarter-warp, 64 bytes apart, meet eight distinct 16-byte bank groups
__device__ __forceinline__ float4 pick(const float4 (&v)[4], int c) {
  return c == 0 ? v[0] : c == 1 ? v[1] : c == 2 ? v[2] : v[3];
}
__device__ __forceinline__ void put_unit(float* u, const float4 (&v)[4]) {
  const int r = (threadIdx.x & 31) >> 1;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int c = (k + r) & 3;
    reinterpret_cast<float4*>(u)[c] = pick(v, c);
  }
}
__device__ __forceinline__ void get_unit(const float* u, float4 (&v)[4]) {
  const int r = (threadIdx.x & 31) >> 1;
  float4 w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    w[k] = reinterpret_cast<const float4*>(u)[(k + r) & 3];
  // w[k] holds chunk (k + r) & 3
#pragma unroll
  for (int c = 0; c < 4; ++c) v[c] = pick(w, (c - r) & 3);
}

// the block's max of m (NaN propagating), returned to every thread
__device__ float block_max(float m, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < WARPS ? red[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (lane == 0) red[WARPS] = m;
  }
  __syncthreads();
  return red[WARPS];
}

// PATH 0 and 1: the CTA's slice [lo, hi) of n, g32 in shared memory.  PATH
// 2: units strided over the grid, read twice.  slots = scratch + 2 (one a
// CTA), scratch[1] receives the scale.
template <typename T, int PATH>
__global__ void __launch_bounds__(THREADS, 2)
grad_quant_kernel(const T* __restrict__ g, const float* __restrict__ err,
                  long long n, long long per, signed char* __restrict__ q,
                  float* __restrict__ new_err, float* __restrict__ scratch) {
  extern __shared__ __align__(16) float g32s[];
  __shared__ float red[WARPS + 1];
  const int tid = threadIdx.x;
  const long long lo = PATH == 2 ? 0 : (long long)blockIdx.x * per;
  const long long hi = PATH == 2 ? n : (lo + per < n ? lo + per : n);
  // the units this thread owns, the same in both phases
  const long long first = PATH == 2 ? (long long)blockIdx.x * THREADS + tid
                                    : tid;
  const long long step = PATH == 2 ? (long long)gridDim.x * THREADS : THREADS;
  const long long units = hi > lo ? (hi - lo + U - 1) / U : 0;

  float m = 0.f;
  for (long long u = first; u < units; u += step) {
    const long long i0 = lo + u * U;
    float4 v[4];
    if (i0 + U <= hi) {
      load_unit<PATH != 2>(g, err, i0, v);
    } else {  // the ragged tail
      float t[U];
#pragma unroll
      for (int e = 0; e < U; ++e)
        t[e] = i0 + e < hi ? __fadd_rn(to_f(g[i0 + e]), err[i0 + e]) : 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        v[c] = make_float4(t[4 * c], t[4 * c + 1], t[4 * c + 2], t[4 * c + 3]);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) m = abs_max4(m, v[c]);
    if (PATH != 2) put_unit(g32s + u * U, v);
  }
  m = block_max(m, red);

  float absmax = m;
  if (PATH != 0) {
    if (tid == 0) scratch[2 + blockIdx.x] = m;
    cg::this_grid().sync();
    if (tid < 32) {  // every slot, in a fixed order
      float s = 0.f;
      for (int c = tid; c < (int)gridDim.x; c += 32)
        s = nan_max(s, scratch[2 + c]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s = nan_max(s, __shfl_xor_sync(0xffffffffu, s, off));
      if (tid == 0) red[WARPS] = s;
    }
    __syncthreads();
    absmax = red[WARPS];
  }
  const float scale = __fadd_rn(__fdiv_rn(absmax, 127.f), 1e-12f);
  if (blockIdx.x == 0 && tid == 0) scratch[1] = scale;

  // backwards: on the two-pass path the units phase 1 read last are the
  // likeliest to be still in L2
  const long long last =
      first < units ? first + (units - 1 - first) / step * step : -1;
  for (long long u = last; u >= first; u -= step) {
    const long long i0 = lo + u * U;
    float4 v[4];
    if (i0 + U <= hi) {
      if (PATH == 2)
        load_unit<true>(g, err, i0, v);
      else
        get_unit(g32s + u * U, v);
      store_unit(v, scale, i0, q, new_err);
    } else {
      for (long long i = i0; i < hi; ++i) {
        const float x = PATH == 2 ? __fadd_rn(to_f(g[i]), err[i])
                                  : g32s[u * U + (i - i0)];
        const int qi = code(x, scale);
        q[i] = static_cast<signed char>(qi);
        new_err[i] = residual(x, qi, scale);
      }
    }
  }
}

struct Geo {
  int path, ctas;
  long long per, smem;
};

int sm_count() {
  static int sms = -1;
  if (sms < 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 0;
  }
  return sms;
}

// The path and grid for n elements on `sms` SMs (see the header)
Geo gq_geometry(long long n, int sms) {
  if (n <= MIN_PER_CTA) return {0, 1, n, 4 * ((n + U - 1) / U * U)};
  if (n <= sms * CAP) {
    const long long want = (n + MIN_PER_CTA - 1) / MIN_PER_CTA;
    const int ctas = (int)(want < sms ? want : sms);
    const long long per = ((n + ctas - 1) / ctas + U - 1) / U * U;
    return {1, ctas, per, 4 * per};
  }
  return {2, sms * TWO_PASS_PER_SM, 0, 0};
}

struct Occupancy {
  cudaError_t err;
  int per_sm[3];  // CTAs an SM holds, by path (path 0 is one CTA)
};

template <typename T>
Occupancy occupancy() {
  Occupancy o{cudaSuccess, {1, 0, 0}};
  o.err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &o.per_sm[1], grad_quant_kernel<T, 1>, THREADS, (size_t)(4 * CAP));
  if (o.err == cudaSuccess)
    o.err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &o.per_sm[2], grad_quant_kernel<T, 2>, THREADS, 0);
  return o;
}

template <typename T>
int launch(const void* g, const float* err, long long n, signed char* q,
           float* new_err, float* scratch, cudaStream_t s, int* plan) {
  const int sms = sm_count();
  if (sms < 1) return (int)cudaErrorNoDevice;
  const Geo geo = gq_geometry(n, sms);
  void (*kern)(const T*, const float*, long long, long long, signed char*,
               float*, float*) =
      geo.path == 0   ? grad_quant_kernel<T, 0>
      : geo.path == 1 ? grad_quant_kernel<T, 1>
                      : grad_quant_kernel<T, 2>;
  static const cudaError_t attr[2] = {
      cudaFuncSetAttribute(grad_quant_kernel<T, 0>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)(4 * MIN_PER_CTA)),
      cudaFuncSetAttribute(grad_quant_kernel<T, 1>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)(4 * CAP))};
  if (attr[0] != cudaSuccess) return (int)attr[0];
  if (attr[1] != cudaSuccess) return (int)attr[1];
  // the cooperative grid must be resident whole: CTAs an SM holds, once
  // for each path, path 1 at its largest slice (a smaller one fits as many)
  static const Occupancy occ = occupancy<T>();
  if (occ.err != cudaSuccess) return (int)occ.err;
  if (geo.path != 0 &&
      (geo.ctas > occ.per_sm[geo.path] * sms || geo.ctas > MAX_CTAS))
    return (int)cudaErrorCooperativeLaunchTooLarge;
  if (plan) {
    cudaFuncAttributes fa;
    const cudaError_t e = cudaFuncGetAttributes(&fa, kern);
    if (e != cudaSuccess) return (int)e;
    plan[0] = geo.path;
    plan[1] = geo.ctas;
    plan[2] = THREADS;
    plan[3] = (int)geo.smem;
    plan[4] = fa.numRegs;
    plan[5] = sms;
    return 0;
  }
  const T* gt = static_cast<const T*>(g);
  if (geo.path == 0) {
    kern<<<1, THREADS, geo.smem, s>>>(gt, err, n, geo.per, q, new_err,
                                      scratch);
    return (int)cudaGetLastError();
  }
  long long per = geo.per;
  void* args[] = {(void*)&gt, (void*)&err, (void*)&n, (void*)&per,
                  (void*)&q, (void*)&new_err, (void*)&scratch};
  const cudaError_t e =
      cudaLaunchCooperativeKernel((const void*)kern, dim3(geo.ctas),
                                  dim3(THREADS), args, (size_t)geo.smem, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// g: n elements of dtype (0 float32, 1 bfloat16); err, new_err: n float32;
// q: n int8; every pointer on 16 bytes.  scratch: 2 + 1024 float32
// (scratch[1] receives the scale, scratch[2 ..] the CTAs' slots).  One
// launch on `stream`; returns a cudaError_t (0 on success) without
// synchronising.
extern "C" int grad_quant_fwd(const void* g, const void* err, void* q,
                              void* new_err, void* scratch, long long n,
                              int dtype, void* stream) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(g) |
                          reinterpret_cast<uintptr_t>(err) |
                          reinterpret_cast<uintptr_t>(q) |
                          reinterpret_cast<uintptr_t>(new_err);
  if (n < 1 || align % 16) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* e = static_cast<const float*>(err);
  signed char* qq = static_cast<signed char*>(q);
  float* ne = static_cast<float*>(new_err);
  float* sc = static_cast<float*>(scratch);
  if (dtype == 0) return launch<float>(g, e, n, qq, ne, sc, s, nullptr);
  if (dtype == 1)
    return launch<__nv_bfloat16>(g, e, n, qq, ne, sc, s, nullptr);
  return (int)cudaErrorInvalidValue;
}

// The launch grad_quant_fwd would make for n elements, without making it:
// plan[0..5] = path (0 one CTA, 1 on chip, 2 two passes), CTAs, threads a
// CTA, dynamic shared memory bytes, registers a thread, SMs.
extern "C" int grad_quant_plan(long long n, int dtype, int* plan) {
  if (n < 1 || !plan) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(nullptr, nullptr, n, nullptr, nullptr, nullptr,
                         nullptr, plan);
  if (dtype == 1)
    return launch<__nv_bfloat16>(nullptr, nullptr, n, nullptr, nullptr,
                                 nullptr, nullptr, plan);
  return (int)cudaErrorInvalidValue;
}
