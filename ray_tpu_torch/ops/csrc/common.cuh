// Shared helpers for the port's hand-written Hopper kernels.
//
// Every C entry point launches on the stream it is given, allocates
// nothing (the Python wrapper passes outputs and scratch), and returns
// cudaGetLastError() so that a refused launch is reported at once.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define RT_EXPORT extern "C" __attribute__((visibility("default")))

namespace rt {

// D += A(16x16, row) * B(16x8, col), bf16 in, f32 accumulate, on the
// tensor cores (mma.sync, one warp).
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

// ---------------------------------------------------------------------------
// Hopper: mbarriers, TMA, wgmma, setmaxnreg
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Makes the barriers' initialisation visible to the async (TMA) proxy.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// One arrival that also tells the barrier to wait for `bytes` of TMA.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Waits until the barrier has completed the phase of the given parity.
// A barrier that never completes traps after about ten seconds (an
// error the host sees) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > (1ll << 34)) {
      __trap();
    }
  }
}

// TMA: the box at coordinates (c0 innermost .. c3) of a 4-D tensor map
// into shared memory, completing `bytes` on the barrier.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor for a 128-byte-swizzled tile (as TMA
// writes it with CU_TENSOR_MAP_SWIZZLE_128B into 1024-byte aligned
// memory): start address, leading and stride byte offsets (PTX ISA,
// "Matrix Descriptor Format"; the offsets in 16-byte units).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most N committed wgmma groups are still running (they
// complete in commit order).
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins accumulator registers at this point of the program, so that the
// compiler moves no read of them across a wgmma wait or issue.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// D(64 x 64, f32) += A B over k 16, both operands in shared memory,
// K-major (the reduced dim contiguous), 128-byte swizzle.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// D(64 x 64, f32) = A B over k 16 (D's old value is not read: the
// first k step of a product), operands as for wgmma_ss_n64.
__device__ __forceinline__ void wgmma_ss_n64_first(float (&d)[32], uint64_t da,
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "l"(da), "l"(db), "r"(0));
}

// D(64 x 64, f32) += A B over k 16: A (bf16) from registers in the
// m16n8k16 A layout per warp, B from shared memory MN-major (N
// contiguous), 128-byte swizzle.
__device__ __forceinline__ void wgmma_rs_n64_tb(float (&d)[32],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D(64 x 128, f32) += A B over k 16: A (bf16) from registers in the
// m16n8k16 A layout per warp, B from shared memory MN-major (N
// contiguous), 128-byte swizzle.
__device__ __forceinline__ void wgmma_rs_n128_tb(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The 64 accumulator operands of an m64n128 wgmma, read-write, and
// their place holders %0 .. %63.
#define RT_ACC_RW(i) "+f"(d[i])
#define RT_ACC8(M, i) \
  M(i), M(i + 1), M(i + 2), M(i + 3), M(i + 4), M(i + 5), M(i + 6), M(i + 7)
#define RT_ACC64(M)                                                        \
  RT_ACC8(M, 0), RT_ACC8(M, 8), RT_ACC8(M, 16), RT_ACC8(M, 24),            \
      RT_ACC8(M, 32), RT_ACC8(M, 40), RT_ACC8(M, 48), RT_ACC8(M, 56)
#define RT_REGS64                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43,"  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57,"  \
  "%58, %59, %60, %61, %62, %63}"

// ---------------------------------------------------------------------------
// Tiles of the attention kernels: [rows, D] bf16 tiles that TMA writes
// 128-byte swizzled in D / 64 blocks of rows x 128 bytes
// ---------------------------------------------------------------------------

template <int D>
__host__ __device__ constexpr int tile_bytes(int rows) {
  return rows * D * 2;
}

// Loads rows [r0, r0 + ROWS) of head hh, batch b into a swizzled tile.
template <int D, int ROWS>
__device__ __forceinline__ void tma_tile(unsigned char* dst,
                                         const CUtensorMap* map,
                                         uint64_t* bar, int r0, int hh,
                                         int b) {
#pragma unroll
  for (int c = 0; c < D / 64; ++c)
    tma_load_4d(dst + c * ROWS * 128, map, bar, c * 64, r0, hh, b);
}

// K-major operand rows [row0, row0 + 64) x k [16 kk, 16 kk + 16) of a
// swizzled tile of ROWS rows.
template <int ROWS>
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int row0, int kk) {
  return sw128_desc(tile + (kk / 4) * ROWS * 128 + row0 * 128 + (kk % 4) * 32,
                    16, 1024);
}

// MN-major operand: rows [16 kk, 16 kk + 16) of a swizzled tile of ROWS
// rows as the k of the product, all D columns as its n.
template <int ROWS>
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int kk) {
  return sw128_desc(tile + kk * 16 * 128, ROWS * 128, 1024);
}

// D(64 x N) += A B, A from registers, B MN-major, for N = D 64 or 128.
template <int N>
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[N / 2],
                                            const uint32_t (&a)[4],
                                            uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs_tb<64>(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t db) {
  wgmma_rs_n64_tb(d, a, db);
}

template <>
__device__ __forceinline__ void wgmma_rs_tb<128>(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db) {
  wgmma_rs_n128_tb(d, a, db);
}

// The A operand of k step kk (16 columns) from a 64 x N f32
// accumulator, rounded to bf16: the accumulator's layout of two
// neighbouring n8 blocks is the register-A layout of one k16 step.
template <int N>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&s)[N],
                                         int kk) {
  a[0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
  a[1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
  a[2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
  a[3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
}

// The value, opaque to the compiler: descriptors derived from it are
// rebuilt in each loop trip (one add each) instead of being hoisted into
// registers for the whole loop.
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

template <int N>
__device__ __forceinline__ void zero(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.f;
}

// Barrier `id` (1-15) over `count` threads (a multiple of 32).
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ---------------------------------------------------------------------------
// Host: TMA tensor maps
// ---------------------------------------------------------------------------

// cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint so
// that the library needs no -lcuda.
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                   cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) != cudaSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess)
      p = nullptr;
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiledFn>(p)
                                            : nullptr;
  }();
  return fn;
}

// A 4-D map over a bf16 [B, S, H, D] tensor with element strides
// (sb, ss, sh) and a contiguous last dim, read in boxes of `rows` x 64
// (a 128-byte row, the swizzle's width) with 128-byte swizzle; rows past
// S, and columns past D in a tile wider than D (head dim 72 in tiles of
// 128 columns), read as zeros. Returns false if the map is refused.
inline bool make_map_bshd(CUtensorMap* map, const void* base, int64_t B,
                          int64_t S, int64_t H, int64_t D, int64_t sb,
                          int64_t ss, int64_t sh, int rows) {
  EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr) return false;
  // a dim of size 1 is never stepped over: give it a stride TMA takes
  const int64_t bss = S == 1 ? D * 2 : ss * 2;
  const int64_t bsh = H == 1 ? bss * S : sh * 2;
  const int64_t bsb = B == 1 ? bsh * H : sb * 2;
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(S),
                        static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  cuuint64_t strides[3] = {static_cast<cuuint64_t>(bss),
                           static_cast<cuuint64_t>(bsh),
                           static_cast<cuuint64_t>(bsb)};
  cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

__host__ __device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

}  // namespace rt
