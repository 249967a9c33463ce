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
// or bf16, row-major, contiguous and 16-byte aligned, D a multiple of 16 in
// [16, 256]; page_table (B, max_pages) int32 with -1 for unmapped; q_offset
// and kv_len (B,) int32.  Logical cache row r of sample b is row r %
// page_size of page page_table[b, r / page_size].  Query i sits at absolute
// position q_offset[b] + i and sees rows kpos with kpos < kv_len[b] and kpos
// <= qpos; a row behind an unmapped entry (or an entry outside [0, n_pages))
// counts as masked and is never read.  Query head h reads kv head h / (Hq /
// Hkv).  Scale 1/sqrt(D); float32 statistics and accumulator; out = acc /
// max(l, 1e-30), so a row that sees no key gives 0; the output has q's
// dtype.  No row at or past min(kv_len, q_offset + Sq) is read, so a stale
// or non-finite row of a recycled page cannot reach the output.
//
// Design.  On the TPU the kv block had to *be* the page, because the
// BlockSpec index map walks the table one grid step per page.  Here the
// kernel is the cached kernel's (flash_block.cuh: a cluster of up to 8 CTAs
// per query tile, kv head and sample splits the band's 64-row *logical*
// tiles, cp.async staging, tensor-core bf16 products, a rank-ordered combine
// through distributed shared memory) over another row source: the CTA reads
// the slice of its sample's table row that its tiles span into shared memory
// once, and row r of a tile is copied from page table[b, r / page_size].  A
// row is contiguous within its page, so the same 16-byte copies serve any
// page size, and the arithmetic is the cached kernel's in the same order: on
// rows laid out in pages it gives bit for bit the cached kernel's output on
// the same rows laid out contiguously.
//
// What bounds it on this card: bytes, as for the cached kernel (about 48
// operations per bf16 byte of K/V at Sq = 8 and qwen2-1.5b's group of 6,
// far below the ~295 where an H100 stops being memory-bound), and below
// that latency, which the split over the kv axis and the overlapped wide
// loads address.

#include <limits.h>

#include "flash_block.cuh"

namespace {

bool bad_shape(int B, int Sq, int Hq, int Hkv, int D, int n_pages,
               int page_size, int max_pages) {
  return B < 1 || B > 65535 || Sq < 1 || Hkv < 1 || Hkv > 65535 ||
         Hq % Hkv != 0 || D % 16 != 0 || D < 16 || D > 256 || n_pages < 1 ||
         page_size < 1 || max_pages < 1 ||
         (long long)max_pages * page_size > INT_MAX;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the launch's cudaError_t
// (cudaGetLastError() right after it); 0 means launched.  A table slice too
// wide for a CTA's shared memory beside the tiles (at D = 128 and page size
// 1: a cache of more than ~87k rows in f32, ~318k in bf16) is refused with
// cudaErrorInvalidValue.  No host read and no allocation: the launch can be
// captured in a CUDA graph.
extern "C" int flash_paged_fwd(const void* q, const void* k_pages,
                               const void* v_pages, void* o,
                               const void* page_table, const void* q_offset,
                               const void* kv_len, int B, int Sq, int Hq,
                               int Hkv, int D, int n_pages, int page_size,
                               int max_pages, int dtype, void* stream) {
  if (bad_shape(B, Sq, Hq, Hkv, D, n_pages, page_size, max_pages))
    return (int)cudaErrorInvalidValue;
  const flash::Params p{q, k_pages, v_pages, o,
                        static_cast<const int*>(q_offset),
                        static_cast<const int*>(kv_len),
                        Sq, Hq, Hkv, 1, 0, 1,
                        flash::LOG2E / sqrtf((float)D)};
  const flash::PagedRows rows{static_cast<const int*>(page_table), n_pages,
                              page_size, max_pages};
  return (int)flash::dispatch(p, rows, B, D, dtype,
                              static_cast<cudaStream_t>(stream), nullptr);
}

// The launch flash_paged_fwd would make for these shapes, without making it:
// plan[0..5] = CTAs, cluster size, threads a CTA, dynamic shared memory
// bytes, registers a thread (as ptxas allocated them), stages.
extern "C" int flash_paged_plan(int B, int Sq, int Hq, int Hkv, int D,
                                int n_pages, int page_size, int max_pages,
                                int dtype, int* plan) {
  if (bad_shape(B, Sq, Hq, Hkv, D, n_pages, page_size, max_pages) || !plan)
    return (int)cudaErrorInvalidValue;
  const flash::Params p{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                        Sq, Hq, Hkv, 1, 0, 1, 0.f};
  const flash::PagedRows rows{nullptr, n_pages, page_size, max_pages};
  return (int)flash::dispatch(p, rows, B, D, dtype, nullptr, plan);
}
