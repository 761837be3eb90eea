// Tensor-core building blocks shared by the bf16 paths of seed_eval_full.cu
// and motion_column.cu: the bf16 type, 32-bit fragment loads and one
// mma.sync m16n8k16 product with fp32 accumulators (bf16 operands with
// fp32 sums, the kernels' arithmetic contract).

#pragma once

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c += a b for one m16n8k16 bf16 tile, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace
