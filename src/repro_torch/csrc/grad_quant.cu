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
// Two launches and no host read: the scale never leaves the device.
//   1. absmax_kernel: a grid-stride loop takes |g32|, a warp-shuffle max
//      and then a block max in shared memory reduce it, and one atomicMax
//      per block on the float's bit pattern folds it into a device scalar
//      the wrapper's memset zeroed.  Every value is non-negative, so the
//      bit patterns order as the floats do, and +NaN's bits order above
//      +inf: a NaN anywhere gives a NaN absmax, as torch.amax and jnp.max
//      do.  Max is exact and does not depend on order, so the result is
//      deterministic whatever the order of the atomics.
//   2. quant_kernel: each thread reads the absmax from device memory,
//      forms the scale itself, and writes q and new_err; block 0's first
//      thread also writes the scale out.
// The ragged tail is masked by the loop bound: no padding copy.
//
// What bounds it on this card: bytes.  g and err are read twice (once a
// pass) and q and new_err written once: 21 bytes an element for f32 g, 17
// for bf16, against a handful of operations, far below the ~20 operations
// per byte where an H100 stops being limited by its 3.35 TB/s memory.  The
// design keeps the loads coalesced (neighbouring threads on neighbouring
// elements) with enough blocks in flight to fill the 132 SMs; the second
// read of g and err mostly misses the 50 MB L2 at the main path's largest
// leaf (6.9M elements, 55-83 MB), so two passes cost about two reads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 8;  // 8 resident blocks on each of 132 SMs

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// max that keeps a NaN once it has seen one
__device__ __forceinline__ float nan_max(float a, float b) {
  return (b > a || b != b) ? b : a;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
absmax_kernel(const T* __restrict__ g, const float* __restrict__ err,
              long long n, unsigned int* __restrict__ absmax_bits) {
  float m = 0.f;
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += stride) {
    m = nan_max(m, fabsf(__fadd_rn(to_f(g[i]), err[i])));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
  __shared__ float warp_max[THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < THREADS / 32 ? warp_max[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (lane == 0) atomicMax(absmax_bits, __float_as_uint(m));
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
quant_kernel(const T* __restrict__ g, const float* __restrict__ err,
             long long n, const unsigned int* __restrict__ absmax_bits,
             signed char* __restrict__ q, float* __restrict__ new_err,
             float* __restrict__ scale_out) {
  const float scale =
      __fadd_rn(__fdiv_rn(__uint_as_float(*absmax_bits), 127.f), 1e-12f);
  if (blockIdx.x == 0 && threadIdx.x == 0) *scale_out = scale;
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += stride) {
    const float g32 = __fadd_rn(to_f(g[i]), err[i]);
    float qf = rintf(__fdiv_rn(g32, scale));
    qf = qf < -127.f ? -127.f : (qf > 127.f ? 127.f : qf);  // NaN passes
    const int qi = __float2int_rz(qf);
    q[i] = static_cast<signed char>(qi);
    new_err[i] = __fsub_rn(g32, __fmul_rn(__int2float_rn(qi), scale));
  }
}

template <typename T>
int launch(const void* g, const float* err, long long n, signed char* q,
           float* new_err, float* scratch, cudaStream_t s) {
  // scratch[0] holds the absmax bits, scratch[1] receives the scale
  unsigned int* bits = reinterpret_cast<unsigned int*>(scratch);
  cudaError_t e = cudaMemsetAsync(bits, 0, sizeof(unsigned int), s);
  if (e != cudaSuccess) return (int)e;
  long long want = (n + THREADS - 1) / THREADS;
  const int blocks = (int)(want < MAX_BLOCKS ? want : MAX_BLOCKS);
  const T* gt = static_cast<const T*>(g);
  absmax_kernel<T><<<blocks, THREADS, 0, s>>>(gt, err, n, bits);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  quant_kernel<T><<<blocks, THREADS, 0, s>>>(gt, err, n, bits, q, new_err,
                                             scratch + 1);
  return (int)cudaGetLastError();
}

}  // namespace

// g: n elements of dtype (0 float32, 1 bfloat16); err, new_err: n float32;
// q: n int8; scratch: 2 float32 (the absmax, then the scale).  Launches on
// `stream` and returns a cudaError_t (0 on success) without synchronising.
extern "C" int grad_quant_fwd(const void* g, const void* err, void* q,
                              void* new_err, void* scratch, long long n,
                              int dtype, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* e = static_cast<const float*>(err);
  signed char* qq = static_cast<signed char*>(q);
  float* ne = static_cast<float*>(new_err);
  float* sc = static_cast<float*>(scratch);
  if (dtype == 0) return launch<float>(g, e, n, qq, ne, sc, s);
  if (dtype == 1) return launch<__nv_bfloat16>(g, e, n, qq, ne, sc, s);
  return (int)cudaErrorInvalidValue;
}
