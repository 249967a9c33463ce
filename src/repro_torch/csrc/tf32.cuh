// TF32 tensor-core helpers shared by the SSD scan (ssd_scan.cu) and the
// aligned flash attention's float32 path (flash_aligned.cu): rounding to
// TF32 and one mma.sync m16n8k8 product with float32 accumulation.
//
// Fragment layout of m16n8k8 (lane = 4 g + t): A (16 x 8, row-major) a0 =
// (g, t), a1 = (g + 8, t), a2 = (g, t + 4), a3 = (g + 8, t + 4); B (8 x 8,
// column-major) b0 = (t, g), b1 = (t + 4, g); C/D (16 x 8) c0 = (g, 2 t),
// c1 = (g, 2 t + 1), c2 = (g + 8, 2 t), c3 = (g + 8, 2 t + 1).

#pragma once

#include <stdint.h>

namespace tc {

// x rounded to its nearest TF32 value (cvt.rna): handed the raw float bits,
// the unit would drop the low 13 mantissa bits, a truncation toward zero
// that biases every product the same way
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// d += a b, TF32 operands, float32 accumulator
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

}  // namespace tc
