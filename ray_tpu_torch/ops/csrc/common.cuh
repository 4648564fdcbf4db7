// Shared helpers for the port's hand-written Hopper kernels.
//
// Every C entry point launches on the stream it is given, allocates
// nothing (the Python wrapper passes outputs and scratch), and returns
// cudaGetLastError() so that a refused launch is reported at once.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define RT_EXPORT extern "C" __attribute__((visibility("default")))

namespace rt {

// D += A(16x16, row) * B(16x8, col), bf16 in, f32 accumulate, on the
// tensor cores (mma.sync; wgmma is for a later, faster version).
// Fragment layouts (PTX ISA, m16n8k16): with g = lane / 4 and
// t = lane % 4,
//   a[0] = A[g][2t..2t+1]      a[1] = A[g+8][2t..2t+1]
//   a[2] = A[g][2t+8..2t+9]    a[3] = A[g+8][2t+8..2t+9]
//   b[0] = B[2t..2t+1][g]      b[1] = B[2t+8..2t+9][g]
//   d[0..1] = D[g][2t..2t+1]   d[2..3] = D[g+8][2t..2t+1]
__device__ __forceinline__ void mma_bf16_16816(float d[4], const uint32_t a[4],
                                               const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two f32 values rounded to bf16 and packed, the lower index in the low
// half (the order of two neighbouring bf16 in memory).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two neighbouring bf16 (4-byte aligned) as one register.
__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The B fragment of m16n8k16 from a row-major [k][n] tile in shared
// memory (rows 16-byte aligned), transposed on the way: lane l passes
// the address of row (l & 15) of the 16 x 8 block.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t r[2],
                                                  const __nv_bfloat16* p) {
  unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(addr));
}

// Two int8 values converted to bf16 (exact: |v| <= 127) and packed.
__device__ __forceinline__ uint32_t pack_i8_bf16(int8_t lo, int8_t hi) {
  return pack_bf16(static_cast<float>(lo), static_cast<float>(hi));
}

__host__ __device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

}  // namespace rt
