// K5: weight-only int8 GEMM, out[M, N] = bf16((x[M, K] @ w8[K, N]) *
// scale[N]), x bf16, w8 int8, f32 accumulation.
//
// Replaces: ray_tpu/ops/quant_matmul.py, _kernel under
// _int8_matmul_impl. Same arithmetic: each int8 weight tile is turned
// into bf16 in registers right before the matrix unit (the values
// -127..127 are exact in bf16), the sum is f32, the per-output-channel
// scale is applied once in the epilogue.
//
// Bound on the H100: at decode (M = max_batch = 8) by the bytes of w8,
// K x N, e.g. 4096 x 14336 = 59 MB per FFN projection (0.0176 ms at
// 3.35 TB/s) against 0.9 GFLOP; at prefill (M 512-2048) by the tensor
// cores (0.061 ms of products at M 512).
//
// Design. The product runs transposed, out^T = w8^T x^T: output
// channels are the M side of every product and tokens its N side, so
// no row of a product is padding at decode. Weights and x stream through
// a ring of shared memory by 16-byte cp.async with zero fill past the
// ragged edges; rows that are not 16-byte aligned (N or K not a
// multiple of 16 / 8, or an unaligned base) are staged by plain masked
// loads into the same ring, in the same kernels. int8 becomes bf16 four
// bytes at a time, by a magic number (byte ^ 0x80 under the exponent of
// 2^23, minus 2^23 + 128: exact), never by byte loads. Two block shapes:
// - Decode (M <= 32), bound by the weight bytes: blocks of 128 channels
//   by 8, 16 or 32 tokens on mma.sync m16n8k16. Each thread reads its weight
//   fragments as 16-byte words from four k rows of the staged tile
//   (thread g owns 16 neighbouring channels; rows g / g + 8 of m tile j
//   are channels 2 j / 2 j + 1 of them), one __byte_perm pairs two k
//   rows and the conversion yields the A fragments in registers; x's
//   fragments come from ldmatrix. The four warps split each 64-deep
//   stage by k step and add their sums through shared memory in a fixed
//   order. K is split over blocks until the grid holds two blocks per SM.
// - Prefill (M > 32), bound by the tensor cores: two consumer warpgroups
//   own 128 channels each of 256, by 128 tokens, on wgmma m64n128k16
//   (int8 weights are cheaper to stage than bf16 x, so the channel side
//   is the wide one). The weights are wgmma's A operand in registers,
//   converted from 32-bit words of the staged int8 tile as at decode, so
//   they never cross shared memory as bf16; x lands 128-byte swizzled as
//   B. The next stage's A is converted while this stage's wgmmas run.
// A split-K call writes f32 partials [splits, M, N] and a second launch
// (one thread per 8 channels) sums them in split order, so the result
// does not depend on which block finishes first. A last-block ticket sum
// in the same launch measured no faster at decode, 3-6 % slower at M 32,
// 64 and 512 where K is split, and needed a counter buffer shared by the
// calls.
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   rt::smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(rt::smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(rt::smem_u32(p)));
}

// One int8 byte (i of the word u, already ^ 0x80) as a float, exactly.
template <int I>
__device__ __forceinline__ float i8_as_float(uint32_t u) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + I)) -
         8388736.f;
}

// Four int8 [b0 b1 b2 b3] -> bf16 pairs (b0, b1) and (b2, b3).
__device__ __forceinline__ void i8x4_to_bf16(uint32_t w, uint32_t& lo,
                                             uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  lo = rt::pack_bf16(i8_as_float<0>(u), i8_as_float<1>(u));
  hi = rt::pack_bf16(i8_as_float<2>(u), i8_as_float<3>(u));
}

// 16 bytes of w8 row gk from channel gn into shared memory, zeros past
// ke and N: cp.async, or masked plain loads for unaligned rows.
template <bool VEC>
__device__ __forceinline__ void stage_w8(unsigned char* dst,
                                         const int8_t* __restrict__ w, int gk,
                                         int gn, int ke, int N) {
  if constexpr (VEC) {
    const bool ok = gk < ke && gn < N;
    cp_async16(dst, ok ? w + static_cast<int64_t>(gk) * N + gn : w, ok);
  } else {
    uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int e = 0; e < 16; ++e)
      if (gk < ke && gn + e < N)
        v[e / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(
                        w[static_cast<int64_t>(gk) * N + gn + e]))
                    << (8 * (e % 4));
    *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
  }
}

// 8 bf16 of x row gm from column gk, zeros past M and ke.
template <bool VEC>
__device__ __forceinline__ void stage_x(unsigned char* dst,
                                        const bf16* __restrict__ x, int gm,
                                        int gk, int M, int K, int ke) {
  if constexpr (VEC) {
    const bool ok = gm < M && gk < ke;
    cp_async16(dst, ok ? x + static_cast<int64_t>(gm) * K + gk : x, ok);
  } else {
    const uint16_t* xb = reinterpret_cast<const uint16_t*>(x);
    uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (gm < M && gk + e < ke)
        v[e / 2] |= static_cast<uint32_t>(
                        xb[static_cast<int64_t>(gm) * K + gk + e])
                    << (16 * (e % 2));
    *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
  }
}

// out[tok, ch .. ch + 7] = bf16(scale * the sum over the splits, in split
// order, of ws[sp, tok, ch ..]), the partials of four splits in flight.
template <bool VEC>
__device__ __forceinline__ void sum_chunk(const float* __restrict__ ws,
                                          const float* __restrict__ scale,
                                          bf16* __restrict__ out, int M, int N,
                                          int splits, int tok, int ch) {
  const int64_t plane = static_cast<int64_t>(M) * N;
  const float* p = ws + static_cast<int64_t>(tok) * N + ch;
  bf16* dst = out + static_cast<int64_t>(tok) * N + ch;
  float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if constexpr (VEC) {
    int sp = 0;
    for (; sp + 4 <= splits; sp += 4) {
      float4 a[4][2];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4* q = reinterpret_cast<const float4*>(p + (sp + u) * plane);
        a[u][0] = __ldcg(q);
        a[u][1] = __ldcg(q + 1);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        v[0] += a[u][0].x; v[1] += a[u][0].y; v[2] += a[u][0].z; v[3] += a[u][0].w;
        v[4] += a[u][1].x; v[5] += a[u][1].y; v[6] += a[u][1].z; v[7] += a[u][1].w;
      }
    }
    for (; sp < splits; ++sp) {
      const float4* q = reinterpret_cast<const float4*>(p + sp * plane);
      const float4 a0 = __ldcg(q), a1 = __ldcg(q + 1);
      v[0] += a0.x; v[1] += a0.y; v[2] += a0.z; v[3] += a0.w;
      v[4] += a1.x; v[5] += a1.y; v[6] += a1.z; v[7] += a1.w;
    }
    uint32_t h[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      h[e] = rt::pack_bf16(v[2 * e] * scale[ch + 2 * e],
                           v[2 * e + 1] * scale[ch + 2 * e + 1]);
    *reinterpret_cast<uint4*>(dst) = make_uint4(h[0], h[1], h[2], h[3]);
  } else {
    for (int sp = 0; sp < splits; ++sp)
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (ch + e < N) v[e] += __ldcg(p + sp * plane + e);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (ch + e < N) dst[e] = __float2bfloat16(v[e] * scale[ch + e]);
  }
}

// The split sum: one thread per 8 channels.
template <bool VEC>
__global__ void __launch_bounds__(256)
    sum_splits_kernel(const float* __restrict__ ws,
                      const float* __restrict__ scale, bf16* __restrict__ out,
                      int M, int N, int splits) {
  const int chunks = (N + 7) / 8;
  const int64_t c = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (c >= static_cast<int64_t>(M) * chunks) return;
  sum_chunk<VEC>(ws, scale, out, M, N, splits, static_cast<int>(c / chunks),
                 static_cast<int>(c % chunks) * 8);
}

// ---------------------------------------------------------------------------
// Decode: mma.sync on fragments converted in registers
// ---------------------------------------------------------------------------

// Four warps own the block's 128 channels x 8 NT tokens together, each
// taking one k step of 16 of each 64-deep stage; thread g of a warp owns
// channels 16 g .. 16 g + 15, m tile j's rows g / g + 8 being its
// channels 2 j / 2 j + 1.
constexpr int kDWarps = 4;
constexpr int kDThreads = 32 * kDWarps;
constexpr int kDBN = 128;
constexpr int kDBK = 64;
constexpr int kDStages = 4;

template <int NT>
struct Dec {
  static constexpr int kBM = 8 * NT;          // tokens per block
  static constexpr int kWld = kDBN + 16;      // bytes per staged w8 row
  static constexpr int kXld = kDBK * 2 + 16;  // bytes per staged x row
  static constexpr int kWStage = kDBK * kWld;
  static constexpr int kStage = kWStage + kBM * kXld;
  static constexpr int kRed = (kDWarps - 1) * 32 * 8 * NT * 4 * 4;
  static constexpr int kBytes =
      kDStages * kStage > kRed ? kDStages * kStage : kRed;
  static_assert(kDBK % (16 * kDWarps) == 0, "whole k steps per warp");
};

// The split grid may hold more than two blocks per SM (336 at M 32 K4096
// N14336), so the aligned path keeps to the registers of three per SM:
// with 192, ptxas's own choice at NT 4, the grid ran in two waves.
template <int NT, bool VEC>
__global__ void __launch_bounds__(kDThreads, VEC ? 3 : 1)
    int8_mm_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ scale, bf16* __restrict__ out,
                   float* __restrict__ ws, int M, int K, int N,
                   int k_per_split) {
  using L = Dec<NT>;
  constexpr int kBM = L::kBM;
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int n0 = blockIdx.x * kDBN, m0 = blockIdx.y * kBM;
  const int kb = blockIdx.z * k_per_split;
  const int ke = min(K, kb + k_per_split);
  const int n_k = (ke - kb + kDBK - 1) / kDBK;

  auto load = [&](int s, int k0) {
    unsigned char* wsm = smem + s * L::kStage;
    unsigned char* xsm = wsm + L::kWStage;
#pragma unroll
    for (int i = 0; i < kDBK * kDBN / 16 / kDThreads; ++i) {
      const int c = tid + i * kDThreads;
      const int row = c / (kDBN / 16), cc = c % (kDBN / 16) * 16;
      stage_w8<VEC>(wsm + row * L::kWld + cc, w, k0 + row, n0 + cc, ke, N);
    }
    for (int c = tid; c < kBM * kDBK / 8; c += kDThreads) {
      const int row = c / (kDBK / 8), kc = c % (kDBK / 8) * 8;
      stage_x<VEC>(xsm + row * L::kXld + kc * 2, x, m0 + row, k0 + kc, M, K,
                   ke);
    }
  };

  float acc[8][NT][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      acc[j][nt][0] = acc[j][nt][1] = acc[j][nt][2] = acc[j][nt][3] = 0.f;

  auto compute = [&](int s) {
    const unsigned char* wsm = smem + s * L::kStage;
    const unsigned char* xsm = wsm + L::kWStage;
#pragma unroll
    for (int i = 0; i < kDBK / 16 / kDWarps; ++i) {
      const int kk = i * kDWarps + warp;
      // k rows 2t, 2t + 1, 2t + 8, 2t + 9 of this thread's 16 channels
      const unsigned char* wr = wsm + (kk * 16 + 2 * t) * L::kWld + 16 * g;
      const uint4 r0 = *reinterpret_cast<const uint4*>(wr);
      const uint4 r1 = *reinterpret_cast<const uint4*>(wr + L::kWld);
      const uint4 r2 = *reinterpret_cast<const uint4*>(wr + 8 * L::kWld);
      const uint4 r3 = *reinterpret_cast<const uint4*>(wr + 9 * L::kWld);
      const uint32_t w0[4] = {r0.x, r0.y, r0.z, r0.w};
      const uint32_t w1[4] = {r1.x, r1.y, r1.z, r1.w};
      const uint32_t w2[4] = {r2.x, r2.y, r2.z, r2.w};
      const uint32_t w3[4] = {r3.x, r3.y, r3.z, r3.w};
      // x fragments: tokens as the n side, k step kk
      uint32_t bf[NT][2];
      const unsigned char* xr = xsm + kk * 32;
#pragma unroll
      for (int nt = 0; nt + 1 < NT; nt += 2) {
        uint32_t v[4];
        ldmatrix_x4(v, xr + (nt * 8 + lane % 8 + lane / 16 * 8) * L::kXld +
                           (lane / 8 % 2) * 16);
        bf[nt][0] = v[0];
        bf[nt][1] = v[1];
        bf[nt + 1][0] = v[2];
        bf[nt + 1][1] = v[3];
      }
      if constexpr (NT % 2 == 1) {
        uint32_t v[2];
        ldmatrix_x2(v, xr + ((NT - 1) * 8 + lane % 8) * L::kXld +
                           (lane / 8 % 2) * 16);
        bf[NT - 1][0] = v[0];
        bf[NT - 1][1] = v[1];
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        // word q of a row holds channels 4q .. 4q + 3: m tiles 2q, 2q + 1
        uint32_t a[4];
        i8x4_to_bf16(__byte_perm(w0[q], w1[q], 0x5140), a[0], a[1]);
        i8x4_to_bf16(__byte_perm(w2[q], w3[q], 0x5140), a[2], a[3]);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          rt::mma_bf16_16816(acc[2 * q][nt], a, bf[nt]);
        i8x4_to_bf16(__byte_perm(w0[q], w1[q], 0x7362), a[0], a[1]);
        i8x4_to_bf16(__byte_perm(w2[q], w3[q], 0x7362), a[2], a[3]);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          rt::mma_bf16_16816(acc[2 * q + 1][nt], a, bf[nt]);
      }
    }
  };

#pragma unroll
  for (int s = 0; s < kDStages - 1; ++s) {
    if (s < n_k) load(s, kb + s * kDBK);
    cp_async_commit();
  }
  for (int it = 0; it < n_k; ++it) {
    cp_async_wait<kDStages - 2>();
    __syncthreads();  // stage it landed; every warp is done with it - 1
    const int nxt = it + kDStages - 1;
    if (nxt < n_k) load(nxt % kDStages, kb + nxt * kDBK);
    cp_async_commit();
    compute(it % kDStages);
  }
  cp_async_wait<0>();
  __syncthreads();

  // the four warps' sums, added in warp order by warp 0
  constexpr int E = 8 * NT * 4;
  float* red = reinterpret_cast<float*>(smem);
  if (warp > 0) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          red[((warp - 1) * E + (j * NT + nt) * 4 + e) * 32 + lane] =
              acc[j][nt][e];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int o = 0; o < kDWarps - 1; ++o)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[j][nt][e] += red[(o * E + (j * NT + nt) * 4 + e) * 32 + lane];
  }

  // element (j, nt, e): channel c0 + 2j + e / 2, token m_t + 2t + e % 2
  const int c0 = n0 + 16 * g;
  const int mt0 = m0 + 2 * t;
  if (gridDim.z > 1) {
    if (warp == 0) {
      float* part = ws + static_cast<int64_t>(blockIdx.z) * M * N;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int ch = c0 + 2 * j + e / 2, tok = mt0 + nt * 8 + e % 2;
            if (ch < N && tok < M)
              part[static_cast<int64_t>(tok) * N + ch] = acc[j][nt][e];
          }
    }
    return;
  }
  if (warp > 0) return;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int ch = c0 + 2 * j;
    if (ch >= N) continue;
    const float s0 = scale[ch], s1 = ch + 1 < N ? scale[ch + 1] : 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int tok = mt0 + nt * 8 + e;
        if (tok >= M) continue;
        const float v0 = acc[j][nt][e] * s0, v1 = acc[j][nt][e + 2] * s1;
        bf16* dst = out + static_cast<int64_t>(tok) * N + ch;
        if constexpr (VEC) {
          *reinterpret_cast<uint32_t*>(dst) = rt::pack_bf16(v0, v1);
        } else {
          dst[0] = __float2bfloat16(v0);
          if (ch + 1 < N) dst[1] = __float2bfloat16(v1);
        }
      }
  }
}

// ---------------------------------------------------------------------------
// Prefill: wgmma with the weights converted into its A registers
// ---------------------------------------------------------------------------

// Two consumer warpgroups own 128 channels each of the block's 256 (two
// m64 halves); the block's 128 tokens are the n of one m64n128 wgmma per
// half and k step. The A operand (weights) comes from registers: each
// thread reads one 32-bit word (4 channels) from each of four k rows of
// the staged int8 tile and converts it as the decode path does, half h's
// rows g / g + 8 of warp w being channels 4 (8 w + g) + 2 h / + 1 of
// the warpgroup's 128. x lands 128-byte swizzled, K-major, as B. The
// next stage's A is built while the wgmmas of this one run.
constexpr int kPThreads = 256;
constexpr int kPBN = 256, kPBM = 128, kPBK = 64, kPStages = 5;

struct Pre {
  static constexpr int kWld = kPBN + 16;  // staged w8 row bytes (padded)
  static constexpr int kW8 = 0;           // + s * kW8Stage
  static constexpr int kW8Stage = kPBK * kWld;
  static constexpr int kX =
      (kW8 + kPStages * kW8Stage + 1023) / 1024 * 1024;  // + s * 16 KB
  static constexpr int kXStage = kPBM * 128;
  static constexpr int kBytes = kX + kPStages * kXStage + 1024;
  static constexpr int kOutLd = kPBN * 2 + 16;  // staged output row bytes
  static_assert(kPBM * kOutLd <= kPStages * kXStage, "output stage");
};

// D(64 x 128, f32) += A B over k 16: A (bf16) from registers in the
// m16n8k16 A layout per warp, B K-major from shared memory, 128-byte
// swizzle.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " RT_REGS64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : RT_ACC64(RT_ACC_RW)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Makes this thread's shared-memory writes (cp.async included) visible
// to wgmma's reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <bool VEC>
__global__ void __launch_bounds__(kPThreads, 1)
    int8_mm_wgmma_kernel(const bf16* __restrict__ x,
                         const int8_t* __restrict__ w,
                         const float* __restrict__ scale,
                         bf16* __restrict__ out, float* __restrict__ ws,
                         int M, int K, int N, int k_per_split) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;
  const int w4 = tid % 128 / 32, g = lane / 4, t = lane % 4;
  const int n0 = blockIdx.x * kPBN, m0 = blockIdx.y * kPBM;
  const int kb = blockIdx.z * k_per_split;
  const int ke = min(K, kb + k_per_split);
  const int n_k = (ke - kb + kPBK - 1) / kPBK;
  // this thread's 4 channels of the block's 256
  const int c4 = 128 * wg + 4 * (8 * w4 + g);

  // stage s <- w8 rows [k0, k0 + 64) x channels [n0, n0 + 256) (padded
  // rows) and x tokens [m0, m0 + 128) x the same k (swizzled)
  auto load = [&](int s, int k0) {
    unsigned char* wsm = smem + Pre::kW8 + s * Pre::kW8Stage;
    unsigned char* xsm = smem + Pre::kX + s * Pre::kXStage;
#pragma unroll
    for (int i = 0; i < kPBK * kPBN / 16 / kPThreads; ++i) {
      const int c = tid + i * kPThreads;
      const int row = c / (kPBN / 16), cc = c % (kPBN / 16) * 16;
      stage_w8<VEC>(wsm + row * Pre::kWld + cc, w, k0 + row, n0 + cc, ke, N);
    }
#pragma unroll
    for (int i = 0; i < kPBM * kPBK / 8 / kPThreads; ++i) {
      const int c = tid + i * kPThreads;
      const int row = c / 8, j = c % 8;
      stage_x<VEC>(xsm + row * 128 + ((j ^ (row & 7)) * 16), x, m0 + row,
                   k0 + 8 * j, M, K, ke);
    }
  };

  // A fragments of stage s: k step kk, half h
  auto convert = [&](uint32_t (&a)[kPBK / 16][2][4], int s) {
    const unsigned char* wr =
        smem + Pre::kW8 + s * Pre::kW8Stage + 2 * t * Pre::kWld + c4;
#pragma unroll
    for (int kk = 0; kk < kPBK / 16; ++kk) {
      const unsigned char* r = wr + 16 * kk * Pre::kWld;
      const uint32_t w0 = *reinterpret_cast<const uint32_t*>(r);
      const uint32_t w1 = *reinterpret_cast<const uint32_t*>(r + Pre::kWld);
      const uint32_t w2 =
          *reinterpret_cast<const uint32_t*>(r + 8 * Pre::kWld);
      const uint32_t w3 =
          *reinterpret_cast<const uint32_t*>(r + 9 * Pre::kWld);
      i8x4_to_bf16(__byte_perm(w0, w1, 0x5140), a[kk][0][0], a[kk][0][1]);
      i8x4_to_bf16(__byte_perm(w2, w3, 0x5140), a[kk][0][2], a[kk][0][3]);
      i8x4_to_bf16(__byte_perm(w0, w1, 0x7362), a[kk][1][0], a[kk][1][1]);
      i8x4_to_bf16(__byte_perm(w2, w3, 0x7362), a[kk][1][2], a[kk][1][3]);
    }
  };

  float acc[2][64];
  rt::zero(acc[0]);
  rt::zero(acc[1]);
  const uint32_t x_sm = rt::smem_u32(smem + Pre::kX);
  // one stage: its A from the int8 tile, then its wgmmas, issued; the
  // wgmmas of the stage before are waited for (their A registers are
  // the other set)
  auto step = [&](uint32_t (&a)[kPBK / 16][2][4], int it) {
    cp_async_wait<kPStages - 3>();
    fence_proxy_async();
    // stage it landed for every thread; both warpgroups are done with
    // the wgmmas of it - 2, so its ring slot is free
    __syncthreads();
    const int nxt = it + kPStages - 2;
    if (nxt < n_k) load(nxt % kPStages, kb + nxt * kPBK);
    cp_async_commit();
    convert(a, it % kPStages);
    const uint32_t b_sm = rt::opaque(x_sm + (it % kPStages) * Pre::kXStage);
    rt::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kPBK / 16; ++kk)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        wgmma_rs_n128(acc[h], a[kk][h], rt::kmajor<kPBM>(b_sm, 0, kk));
    rt::wgmma_commit();
    rt::wgmma_wait<1>();
  };

#pragma unroll
  for (int s = 0; s < kPStages - 2; ++s) {
    if (s < n_k) load(s, kb + s * kPBK);
    cp_async_commit();
  }
  uint32_t a0[kPBK / 16][2][4], a1[kPBK / 16][2][4];
  int it = 0;
  for (; it + 1 < n_k; it += 2) {
    step(a0, it);
    step(a1, it + 1);
  }
  if (it < n_k) step(a0, it);
  rt::wgmma_wait<0>();
  rt::fence_regs(acc[0]);
  rt::fence_regs(acc[1]);

  // acc[h][i]: channel c4 + 2 h + (i & 2 ? 1 : 0), token 8 (i / 4) + 2 t
  // + (i & 1), within the block's tile
  if (gridDim.z > 1) {
    float* part = ws + static_cast<int64_t>(blockIdx.z) * M * N;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int ch = n0 + c4 + 2 * h + ((i & 2) ? 1 : 0);
        const int tok = m0 + 8 * (i / 4) + 2 * t + (i & 1);
        if (ch < N && tok < M)
          part[static_cast<int64_t>(tok) * N + ch] = acc[h][i];
      }
    return;
  }

  // scaled, rounded, staged as [token][channel] rows, then whole rows out
  float sc[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) sc[e] = n0 + c4 + e < N ? scale[n0 + c4 + e] : 0.f;
  __syncthreads();  // the x ring is free: every wgmma is done
  unsigned char* st = smem + Pre::kX;
#pragma unroll
  for (int r = 0; r < 16; ++r)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      // token 8 r + 2 t + e: this thread's 4 channels, as one 8-byte word
      const int j = 4 * r + e;
      uint2 v;
      v.x = rt::pack_bf16(acc[0][j] * sc[0], acc[0][j + 2] * sc[1]);
      v.y = rt::pack_bf16(acc[1][j] * sc[2], acc[1][j + 2] * sc[3]);
      *reinterpret_cast<uint2*>(st + (8 * r + 2 * t + e) * Pre::kOutLd +
                                c4 * 2) = v;
    }
  __syncthreads();
#pragma unroll 4
  for (int c = tid; c < kPBM * kPBN / 8; c += kPThreads) {
    const int row = c / (kPBN / 8), cc = c % (kPBN / 8) * 8;
    const int tok = m0 + row, ch = n0 + cc;
    if (tok >= M || ch >= N) continue;
    const uint4 v =
        *reinterpret_cast<const uint4*>(st + row * Pre::kOutLd + cc * 2);
    bf16* dst = out + static_cast<int64_t>(tok) * N + ch;
    if constexpr (VEC) {
      *reinterpret_cast<uint4*>(dst) = v;
    } else {
      const bf16* h = reinterpret_cast<const bf16*>(&v);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (ch + e < N) dst[e] = h[e];
    }
  }
}

template <typename Kernel>
int launch(Kernel kernel, int threads, int smem, int bm, int bn,
           const bf16* x, const int8_t* w, const float* scale, bf16* out,
           float* ws, int64_t M, int64_t K, int64_t N,
           int64_t splits, int64_t k_per_split, bool vec, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(static_cast<unsigned>((N + bn - 1) / bn),
            static_cast<unsigned>((M + bm - 1) / bm),
            static_cast<unsigned>(splits));
  kernel<<<grid, threads, smem, s>>>(
      x, w, scale, out, ws, static_cast<int>(M), static_cast<int>(K),
      static_cast<int>(N), static_cast<int>(k_per_split));
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const int64_t chunks = M * ((N + 7) / 8);
  auto* sum = vec ? sum_splits_kernel<true> : sum_splits_kernel<false>;
  sum<<<static_cast<unsigned>((chunks + 255) / 256), 256, 0, s>>>(
      ws, scale, out, static_cast<int>(M), static_cast<int>(N),
      static_cast<int>(splits));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: [M, K] bf16, w8: [K, N] int8, scale: [N] f32, out: [M, N] bf16, all
// contiguous. block_m: tokens per block, 8, 16 or 32 (decode, 128
// channels a block) or 128 (prefill, 256 channels a block). With
// splits > 1, K is cut into splits ranges of k_per_split (a multiple of
// the stage depth, 64); ws is [splits, M, N] f32 scratch, which a second
// launch sums in split order. vec_ok: K % 8 == 0, N % 16 == 0 and
// 16-byte aligned bases, so rows may be copied as 16-byte vectors.
RT_EXPORT int rt_int8_matmul(const void* x, const void* w8,
                             const void* scale, void* out, void* ws,
                             int64_t M, int64_t K, int64_t N,
                             int64_t block_m, int64_t splits,
                             int64_t k_per_split, int vec_ok, void* stream) {
  if (M == 0 || N == 0) return 0;
  const int64_t lim = int64_t(1) << 31;
  if (M * K >= lim || K * N >= lim || splits * M * N >= lim || splits < 1 ||
      (splits > 1 && ws == nullptr) ||
      (K > 0 && (splits - 1) * k_per_split >= K))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const bf16*>(x);
  const auto* wp = static_cast<const int8_t*>(w8);
  const auto* sp = static_cast<const float*>(scale);
  auto* op = static_cast<bf16*>(out);
  auto* wsp = static_cast<float*>(ws);
  const int64_t kps = splits > 1 ? k_per_split : (K > 0 ? K : 1);
  if (block_m == 8)
    return launch(vec_ok ? int8_mm_kernel<1, true> : int8_mm_kernel<1, false>,
                  kDThreads, Dec<1>::kBytes, 8, kDBN, xp, wp, sp, op, wsp,
                  M, K, N, splits, kps, vec_ok != 0, s);
  if (block_m == 16)
    return launch(vec_ok ? int8_mm_kernel<2, true> : int8_mm_kernel<2, false>,
                  kDThreads, Dec<2>::kBytes, 16, kDBN, xp, wp, sp, op, wsp,
                  M, K, N, splits, kps, vec_ok != 0, s);
  if (block_m == 32)
    return launch(vec_ok ? int8_mm_kernel<4, true> : int8_mm_kernel<4, false>,
                  kDThreads, Dec<4>::kBytes, 32, kDBN, xp, wp, sp, op, wsp,
                  M, K, N, splits, kps, vec_ok != 0, s);
  if (block_m == 128)
    return launch(vec_ok ? int8_mm_wgmma_kernel<true>
                         : int8_mm_wgmma_kernel<false>,
                  kPThreads, Pre::kBytes, kPBM, kPBN, xp, wp, sp, op, wsp,
                  M, K, N, splits, kps, vec_ok != 0, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
