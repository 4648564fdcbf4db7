// K1: causal flash-attention forward (FlashAttention-2 style online
// softmax), O = softmax(Q K^T * D^-0.5 + mask) V and the row logsumexp.
//
// Replaces: ray_tpu/ops/attention.py, _fwd_kernel under _flash_forward.
// Same arithmetic: scores in f32 from bf16 operands, mask
// q_pos + (Sk - Sq) >= k_pos with -1e30, running max / sum /
// accumulator in f32, P rounded to V's dtype (bf16) before P.V, the
// l == 0 guard, lse = m + log(l) written in f32.
//
// Bound on the H100: at the engine's prefill buckets (S <= 2048, D 128)
// the work is ~4 S^2 D H / 2 flops over ~4 S H D bytes, i.e. hundreds
// of flops per byte, so the tensor cores bound it. Design: one block of
// four warps per (64-row Q tile, head, batch); each warp owns 16 Q rows
// whose fragments stay in registers for the whole pass. K/V tiles of 64
// keys are staged through shared memory up to the causal limit of the
// tile (later tiles are never loaded); Q K^T and P V run on the tensor
// cores with mma.sync m16n8k16 (bf16 in, f32 accumulate). The score
// fragment of Q K^T is already in the A-operand layout of P V, so P
// never leaves registers; V's B operand comes from ldmatrix.trans, so V
// is not transposed in memory. Ragged Sq and Sk (any length) are masked
// in the kernel: keys >= Sk score -inf (and their rows are zero-filled),
// rows >= Sq are computed and not stored. Q/K/V are read in the model's
// [B, S, H, D] layout through their strides; GQA maps head h to KV head
// h / (H / KVH). Not yet: wgmma, TMA, a load/compute pipeline.
#include "common.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 128;

using rt::ld32;
using rt::ldmatrix_x2_trans;

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                     int64_t H, int64_t KVH, int64_t Sq, int64_t Sk,
                     int64_t qsb, int64_t qss, int64_t qsh, int64_t ksb,
                     int64_t kss, int64_t ksh, int64_t vsb, int64_t vss,
                     int64_t vsh, int causal, float sm_scale) {
  constexpr int LD = D + 8;  // padded rows: conflict-free fragment reads
  __shared__ __align__(16) __nv_bfloat16 Ks[kBK][LD];
  __shared__ __align__(16) __nv_bfloat16 Vs[kBK][LD];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * kBQ;
  const int64_t h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int64_t kvh = h / (H / KVH);
  const int64_t offset = Sk - Sq;
  const int64_t r0 = q0 + warp * 16 + g;  // this thread's two rows
  const int64_t r1 = r0 + 8;

  // Q fragments for the warp's 16 rows, held for the whole pass.
  uint32_t qf[D / 16][4];
  const __nv_bfloat16* qb = q + b * qsb + h * qsh;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    qf[kk][0] = r0 < Sq ? ld32(qb + r0 * qss + c) : 0u;
    qf[kk][1] = r1 < Sq ? ld32(qb + r1 * qss + c) : 0u;
    qf[kk][2] = r0 < Sq ? ld32(qb + r0 * qss + c + 8) : 0u;
    qf[kk][3] = r1 < Sq ? ld32(qb + r1 * qss + c + 8) : 0u;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  const int64_t q_last = rt::min64(q0 + kBQ - 1, Sq - 1);
  const int64_t kv_end = causal ? rt::min64(Sk, q_last + offset + 1) : Sk;
  const int n_tiles = static_cast<int>((kv_end + kBK - 1) / kBK);
  const __nv_bfloat16* kb = k + b * ksb + kvh * ksh;
  const __nv_bfloat16* vb = v + b * vsb + kvh * vsh;

  for (int j = 0; j < n_tiles; ++j) {
    const int64_t k0 = static_cast<int64_t>(j) * kBK;
    __syncthreads();  // every warp is done with the previous tile
    for (int c = threadIdx.x; c < kBK * D / 8; c += kThreads) {
      const int r = c / (D / 8);
      const int cc = (c % (D / 8)) * 8;
      const int64_t key = k0 + r;
      uint4 kv4 = make_uint4(0, 0, 0, 0), vv4 = make_uint4(0, 0, 0, 0);
      if (key < Sk) {
        kv4 = *reinterpret_cast<const uint4*>(kb + key * kss + cc);
        vv4 = *reinterpret_cast<const uint4*>(vb + key * vss + cc);
      }
      *reinterpret_cast<uint4*>(&Ks[r][cc]) = kv4;
      *reinterpret_cast<uint4*>(&Vs[r][cc]) = vv4;
    }
    __syncthreads();

    // S = Q K^T for 16 rows x 64 keys.
    float s[kBK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt)
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int nt = 0; nt < kBK / 8; ++nt) {
        uint32_t bf[2];
        bf[0] = *reinterpret_cast<const uint32_t*>(&Ks[nt * 8 + g][kk * 16 + 2 * t]);
        bf[1] = *reinterpret_cast<const uint32_t*>(&Ks[nt * 8 + g][kk * 16 + 2 * t + 8]);
        rt::mma_bf16_16816(s[nt], qf[kk], bf);
      }
    }

    // scale, mask, row max (each row is spread over the 4 threads of a
    // quad: reduce with xor-shuffles 1 and 2)
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int64_t key = k0 + nt * 8 + 2 * t + (e & 1);
        const int64_t row = e < 2 ? r0 : r1;
        float val = s[nt][e] * sm_scale;
        if (key >= Sk)
          val = -__int_as_float(0x7f800000);  // ragged tail: -inf, not a key
        else if (causal && key > row + offset)
          val = kNegInf;
        s[nt][e] = val;
        if (e < 2)
          mx0 = fmaxf(mx0, val);
        else
          mx1 = fmaxf(mx1, val);
      }
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = expf(m0 - mn0), a1 = expf(m1 - mn1);
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
      s[nt][0] = expf(s[nt][0] - mn0);
      s[nt][1] = expf(s[nt][1] - mn0);
      s[nt][2] = expf(s[nt][2] - mn1);
      s[nt][3] = expf(s[nt][3] - mn1);
      ps0 += s[nt][0] + s[nt][1];
      ps1 += s[nt][2] + s[nt][3];
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      ps0 += __shfl_xor_sync(0xffffffffu, ps0, off);
      ps1 += __shfl_xor_sync(0xffffffffu, ps1, off);
    }
    l0 = a0 * l0 + ps0;
    l1 = a1 * l1 + ps1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      acc[dt][0] *= a0;
      acc[dt][1] *= a0;
      acc[dt][2] *= a1;
      acc[dt][3] *= a1;
    }

    // O += P V, P rounded to bf16 (the S accumulator layout of two
    // neighbouring n8 tiles is the A layout of one k16 step).
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = rt::pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = rt::pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = rt::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = rt::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        uint32_t bf[2];
        ldmatrix_x2_trans(bf, &Vs[kk * 16 + (lane & 15)][dt * 8]);
        rt::mma_bf16_16816(acc[dt], pa, bf);
      }
    }
  }

  // normalise and store; fully masked rows keep l == 0 -> divide by 1
  const float inv0 = 1.f / (l0 == 0.f ? 1.f : l0);
  const float inv1 = 1.f / (l1 == 0.f ? 1.f : l1);
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int c = dt * 8 + 2 * t;
    if (r0 < Sq)
      *reinterpret_cast<uint32_t*>(o + ((b * Sq + r0) * H + h) * D + c) =
          rt::pack_bf16(acc[dt][0] * inv0, acc[dt][1] * inv0);
    if (r1 < Sq)
      *reinterpret_cast<uint32_t*>(o + ((b * Sq + r1) * H + h) * D + c) =
          rt::pack_bf16(acc[dt][2] * inv1, acc[dt][3] * inv1);
  }
  if (t == 0) {
    float* lb = lse + (b * H + h) * Sq;
    if (r0 < Sq) lb[r0] = m0 + logf(l0 == 0.f ? 1.f : l0);
    if (r1 < Sq) lb[r1] = m1 + logf(l1 == 0.f ? 1.f : l1);
  }
}

}  // namespace

// q: [B, Sq, H, D], k/v: [B, Sk, KVH, D] bf16 through strides (in
// elements; the last dim contiguous, strides multiples of 8 and 16-byte
// aligned bases, checked by the wrapper). o: [B, Sq, H, D] contiguous
// bf16; lse: [B, H, Sq] f32. D is 64 or 128.
RT_EXPORT int rt_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int64_t B, int64_t H, int64_t KVH, int64_t Sq, int64_t Sk, int64_t D,
    int64_t qsb, int64_t qss, int64_t qsh, int64_t ksb, int64_t kss,
    int64_t ksh, int64_t vsb, int64_t vss, int64_t vsh, int causal,
    float sm_scale, void* stream) {
  if (B == 0 || Sq == 0) return 0;
  dim3 grid(static_cast<unsigned>((Sq + kBQ - 1) / kBQ),
            static_cast<unsigned>(H), static_cast<unsigned>(B));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* op = static_cast<__nv_bfloat16*>(o);
  auto* lp = static_cast<float*>(lse);
  if (D == 128) {
    flash_fwd_kernel<128><<<grid, kThreads, 0, s>>>(
        qp, kp, vp, op, lp, H, KVH, Sq, Sk, qsb, qss, qsh, ksb, kss, ksh,
        vsb, vss, vsh, causal, sm_scale);
  } else if (D == 64) {
    flash_fwd_kernel<64><<<grid, kThreads, 0, s>>>(
        qp, kp, vp, op, lp, H, KVH, Sq, Sk, qsb, qss, qsh, ksb, kss, ksh,
        vsb, vss, vsh, causal, sm_scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
