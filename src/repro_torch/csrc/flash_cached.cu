// Cached block flash attention for Hopper (sm_90a), CUDA C++ with a plain C
// entry point loaded through ctypes.
//
// Replaces: src/repro/kernels/flash_attention.py::_flash_cached_kernel, the
// Pallas TPU kernel behind flash_attention_pallas's cached mode.  It serves
// block prefill: a block of Sq prompt tokens per slot attends to that slot's
// contiguous KV cache from its own cursor.
//
// Contract (the same as the TPU kernel's): q (B, Sq, Hq, D), k/v
// (B, Sk, Hkv, D), f32 or bf16, row-major, contiguous and 16-byte aligned, D
// a multiple of 16 in [16, 256]; q_offset and kv_len (B,) int32.  Query i of
// sample b sits at absolute position q_offset[b] + i and sees cache rows
// kpos with kpos < kv_len[b], plus kpos <= qpos when causal and kpos > qpos -
// window when window > 0.  Query head h reads kv head h / (Hq / Hkv).  Scale
// 1/sqrt(D); softmax statistics and the accumulator are float32; out = acc /
// max(l, 1e-30), so a row that sees no key gives 0; the output has q's
// dtype.  Cache rows outside [max(0, q_offset - window + 1), min(kv_len,
// q_offset + Sq)) are never read, so a non-finite stale row there cannot
// reach the output.
//
// What bounds it on this card: bytes.  At Sq = 8 each K or V element read
// feeds group * Sq multiply-adds (48 at qwen2-1.5b's group of 6), about 48
// operations per bf16 byte, far below the ~295 operations per byte where an
// H100 stops being limited by its 3.35 TB/s memory; at the serving shapes
// the bytes are ~1.8 MB, 0.54 us, so what is left is latency: enough CTAs in
// flight, and each reading its rows with few, wide, overlapped loads.  The
// design (flash_block.cuh, shared with the paged kernel): a cluster of up to
// 8 CTAs per (64 query rows of a GQA group, kv head, sample) splits the
// band's 64-row tiles and combines its partial softmax states through
// distributed shared memory in rank order (128 CTAs at B 8, Hkv 2, Sk 512,
// against 16 before the split); K/V rows arrive as 16-byte cp.async copies
// into bf16 shared memory, double-buffered; bf16 products on the tensor
// cores (mma.sync m16n8k16) at every head dim, the 48 live rows of a group
// at Sq 8 as 3 m16 tiles, Q from shared memory past D 128; f32 on FMA loops
// in the same layout.

#include "flash_block.cuh"

// dtype: 0 = float32, 1 = bfloat16.  Returns the launch's cudaError_t
// (cudaGetLastError() right after it); 0 means launched.  No host read and
// no allocation: the launch can be captured in a CUDA graph.
extern "C" int flash_cached_fwd(const void* q, const void* k, const void* v,
                                void* o, const void* q_offset,
                                const void* kv_len, int B, int Sq, int Sk,
                                int Hq, int Hkv, int D, int causal, int window,
                                int dtype, void* stream) {
  if (B < 1 || B > 65535 || Sq < 1 || Sk < 1 || Hkv < 1 || Hkv > 65535 ||
      Hq % Hkv != 0 || D % 16 != 0 || D < 16 || D > 256)
    return (int)cudaErrorInvalidValue;
  const flash::Params p{q, k, v, o,
                        static_cast<const int*>(q_offset),
                        static_cast<const int*>(kv_len),
                        Sq, Hq, Hkv, causal, window, 1,
                        flash::LOG2E / sqrtf((float)D)};
  return (int)flash::dispatch(p, flash::ContigRows{Sk}, B, D, dtype,
                              static_cast<cudaStream_t>(stream), nullptr);
}

// The launch flash_cached_fwd would make for these shapes, without making
// it: plan[0..5] = CTAs, cluster size, threads a CTA, dynamic shared memory
// bytes, registers a thread (as ptxas allocated them), stages.
extern "C" int flash_cached_plan(int B, int Sq, int Sk, int Hq, int Hkv, int D,
                                 int dtype, int* plan) {
  if (B < 1 || B > 65535 || Sq < 1 || Sk < 1 || Hkv < 1 || Hkv > 65535 ||
      Hq % Hkv != 0 || D % 16 != 0 || D < 16 || D > 256 || !plan)
    return (int)cudaErrorInvalidValue;
  const flash::Params p{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                        Sq, Hq, Hkv, 1, 0, 1, 0.f};
  return (int)flash::dispatch(p, flash::ContigRows{Sk}, B, D, dtype, nullptr,
                              plan);
}
