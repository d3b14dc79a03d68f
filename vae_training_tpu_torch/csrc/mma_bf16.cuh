// bf16 products on Hopper's tensor cores, shared by the training kernels'
// bf16-dot instantiations (csrc/linear_vae.cu, csrc/mlp_vae.cu): packing
// operand pairs and mma.sync m16n8k16 with bf16 operands and f32 sums.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma {

// lo and hi (lo at the lower k) rounded to bfloat16, round to nearest even,
// packed as one b32 operand register of mma.sync.
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t bf16x2(float2 z) { return bf16x2(z.x, z.y); }

// d += A·B on the tensor cores: one m16n8k16 tile, bf16 operands (a: 16 × 16
// row-major, b: 16 × 8 column-major, in mma.sync's fragments), f32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace mma
