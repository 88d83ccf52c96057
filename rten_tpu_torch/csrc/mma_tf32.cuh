// 3xTF32 products on the tensor cores, shared by mha.cu (f32 attention at
// D <= 128) and decode_heads_tf32.cuh (decode_mha's per-head form on f32
// caches): an f32 operand x is split as big = cvt.rna.tf32(x) (11
// significant bits) and small = cvt.rna.tf32(x - big) (x - big is exact in
// f32), about 22 bits together, and a product is big.big + big.small +
// small.big (the small.small term, 2^-22 of it, is dropped).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// c += a . b: A 16 x 8 tf32 (row), B 8 x 8 tf32 (col), C 16 x 8 f32.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x as TF32 parts: big = x rounded to 11 significant bits (to nearest, ties
// away), small = the same rounding of x - big (exact in f32).
__device__ __forceinline__ void split_tf32(uint32_t x, uint32_t& big, uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(__uint_as_float(x)));
  const float rest = __uint_as_float(x) - __uint_as_float(big);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(rest));
}

// c += a . b in 3xTF32: a_big.b_big + a_big.b_small + a_small.b_big, the
// small terms first.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4], uint32_t bb0, uint32_t bb1,
                                           uint32_t bs0, uint32_t bs1) {
  mma_tf32(c, as, bb0, bb1);
  mma_tf32(c, ab, bs0, bs1);
  mma_tf32(c, ab, bb0, bb1);
}

}  // namespace
