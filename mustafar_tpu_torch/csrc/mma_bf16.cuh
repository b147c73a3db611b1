// bf16 tensor-core helpers shared by the segment kernels (q_segment.cu,
// sp_segment.cu): mma.sync m16n8k16 with f32 accumulators, fragment loads
// from shared memory with ldmatrix, bf16 packing and the reductions over
// the four lanes that hold one accumulator row.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t ld32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d += a . b for one m16n8k16 tile: bf16 inputs, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Four 8 x 8 tiles of 16-bit elements from shared memory, one ldmatrix.x4:
// lane l gives the address of row l % 8 of tile l / 8 (8 elements, 16
// bytes, 16-byte aligned).  r[m] is tile m's fragment of lane l = 4 gid +
// tig: elements (gid, 2 tig) and (gid, 2 tig + 1) of the tile, low half
// first; with TRANS those of its transpose, (2 tig, gid) and (2 tig + 1,
// gid).
template <bool TRANS>
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(row);
  if constexpr (TRANS)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(a));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(a));
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
