// K2 and K3: flash-attention backward (FlashAttention-2 style), from the
// row logsumexp that K1 writes and delta = rowsum(dO * O) (f32, computed
// by the wrapper, as the reference computes it outside its kernels).
//
// Replaces: ray_tpu/ops/attention.py, _dq_kernel (K2) and _dkv_kernel
// (K3) under _flash_backward. Same arithmetic: scores in f32 from bf16
// operands, P = exp(S * scale - lse), dP = dO V^T, dS = P * (dP - delta)
// * scale; P and dS are f32 and rounded to bf16 only as operands of the
// products that take them (P^T dO, dS K, dS^T Q); dQ, dK and dV sum in
// f32 and are written once in bf16. A masked (query, key) pair gets
// P = 0 exactly, not exp(-1e30 - lse), so a row with no live key (or a
// padding row of a ragged tile) adds nothing anywhere and never NaN.
//
// Bound on the H100: at the training shapes (S 2048, D 128) each pair of
// a query and a live key costs 6 D flops in K2 and 8 D in K3 against a
// few bytes per row, so the tensor cores bound both. Design, as K1: four
// warps of mma.sync m16n8k16 (bf16 in, f32 accumulate), 64-row tiles,
// no pipeline (wgmma, TMA and a load/compute pipeline come later).
//
// K2: one block per (64 query rows, head, batch); each warp owns 16
// rows. Q and dO are staged once in shared memory, K/V tiles of 64 keys
// up to the causal limit of the block. S = Q K^T and dP = dO V^T land in
// the accumulator layout, which is the A layout of dS K, so dS never
// leaves registers; K's B operand comes from ldmatrix.trans.
//
// K3: one block per (64 keys, KV head, batch); each warp owns 16 keys,
// whose dK/dV stay in registers while the block walks every query head
// of its GQA group and, for each, the live query tiles of 32 rows (from
// the first one that sees the block's first key). That sum over the
// group is the VJP of the reference's jnp.repeat of K/V, without atomics,
// so the result is deterministic. The block computes S^T = K Q^T and
// dP^T = V dO^T with keys as rows: P^T and dS^T then sit in the A layout
// of P^T dO and dS^T Q, and dO and Q reach them as B operands through
// ldmatrix.trans, so nothing is transposed in memory.
//
// Inputs are read in the model's [B, S, H, D] layout through strides;
// ragged Sq and Sk are masked in the kernels; causal offset Sk - Sq.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kBQ2 = 64;  // K2: query rows per block
constexpr int kBK2 = 64;  // K2: keys per tile
constexpr int kBK3 = 64;  // K3: keys per block
constexpr int kBQ3 = 32;  // K3: query rows per tile

using bf16 = __nv_bfloat16;
using rt::ld32;
using rt::ldmatrix_x2_trans;

// Rows [r0, r0 + ROWS) of a [S, D] slab with row stride rs (elements)
// into a shared tile with rows of D + 8; rows >= S are zero-filled so
// that 0 * garbage cannot make NaN.
template <int ROWS, int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          int64_t rs, int64_t r0,
                                          int64_t S) {
  constexpr int LD = D + 8;
  for (int c = threadIdx.x; c < ROWS * D / 8; c += kThreads) {
    const int r = c / (D / 8);
    const int cc = (c % (D / 8)) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < S)
      val = *reinterpret_cast<const uint4*>(src + (r0 + r) * rs + cc);
    *reinterpret_cast<uint4*>(dst + r * LD + cc) = val;
  }
}

// The A fragment (16 x 16) at rows row0.., columns col0.. of a shared
// tile with rows of LD elements.
template <int LD>
__device__ __forceinline__ void load_a(uint32_t a[4], const bf16* tile,
                                       int row0, int col0, int g, int t) {
  const bf16* p = tile + (row0 + g) * LD + col0 + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * LD);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * LD + 8);
}

// The B fragment (16 x 8) of X^T for X a row-major tile: rows n0.. of X
// are the columns of B, columns k0.. of X its rows.
template <int LD>
__device__ __forceinline__ void load_bt(uint32_t b[2], const bf16* tile,
                                        int n0, int k0, int g, int t) {
  const bf16* p = tile + (n0 + g) * LD + k0 + 2 * t;
  b[0] = ld32(p);
  b[1] = ld32(p + 8);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        bf16* __restrict__ dq, int64_t H, int64_t KVH,
                        int64_t Sq, int64_t Sk, int64_t qsb, int64_t qss,
                        int64_t qsh, int64_t ksb, int64_t kss, int64_t ksh,
                        int64_t vsb, int64_t vss, int64_t vsh, int64_t dsb,
                        int64_t dss, int64_t dsh, int causal,
                        float sm_scale) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ds = Qs + kBQ2 * LD;
  bf16* Ks = Ds + kBQ2 * LD;
  bf16* Vs = Ks + kBK2 * LD;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * kBQ2;
  const int64_t h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int64_t kvh = h / (H / KVH);
  const int64_t offset = Sk - Sq;
  const int wr = warp * 16;       // the warp's first row in the tile
  const int64_t r0 = q0 + wr + g;  // this thread's two rows
  const int64_t r1 = r0 + 8;

  load_tile<kBQ2, D>(Qs, q + b * qsb + h * qsh, qss, q0, Sq);
  load_tile<kBQ2, D>(Ds, dout + b * dsb + h * dsh, dss, q0, Sq);
  const float* lb = lse + (b * H + h) * Sq;
  const float* db = delta + (b * H + h) * Sq;
  const float lse0 = r0 < Sq ? lb[r0] : 0.f, lse1 = r1 < Sq ? lb[r1] : 0.f;
  const float dl0 = r0 < Sq ? db[r0] : 0.f, dl1 = r1 < Sq ? db[r1] : 0.f;

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  const int64_t q_last = rt::min64(q0 + kBQ2 - 1, Sq - 1);
  const int64_t kv_end = causal ? rt::min64(Sk, q_last + offset + 1) : Sk;
  const int n_tiles =
      kv_end > 0 ? static_cast<int>((kv_end + kBK2 - 1) / kBK2) : 0;
  const bf16* kb = k + b * ksb + kvh * ksh;
  const bf16* vb = v + b * vsb + kvh * vsh;

  for (int j = 0; j < n_tiles; ++j) {
    const int64_t k0 = static_cast<int64_t>(j) * kBK2;
    __syncthreads();  // every warp is done with the previous tile
    load_tile<kBK2, D>(Ks, kb, kss, k0, Sk);
    load_tile<kBK2, D>(Vs, vb, vss, k0, Sk);
    __syncthreads();

    // S = Q K^T and dP = dO V^T for 16 rows x 64 keys.
    float s[kBK2 / 8][4], dp[kBK2 / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBK2 / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4], da[4];
      load_a<LD>(qa, Qs, wr, kk * 16, g, t);
      load_a<LD>(da, Ds, wr, kk * 16, g, t);
#pragma unroll
      for (int nt = 0; nt < kBK2 / 8; ++nt) {
        uint32_t bk[2], bv[2];
        load_bt<LD>(bk, Ks, nt * 8, kk * 16, g, t);
        load_bt<LD>(bv, Vs, nt * 8, kk * 16, g, t);
        rt::mma_bf16_16816(s[nt], qa, bk);
        rt::mma_bf16_16816(dp[nt], da, bv);
      }
    }

    // P from lse (0 where masked), then dS = P (dP - delta) scale, in s.
#pragma unroll
    for (int nt = 0; nt < kBK2 / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int64_t key = k0 + nt * 8 + 2 * t + (e & 1);
        const int64_t row = e < 2 ? r0 : r1;
        const bool live = key < Sk && row < Sq && (!causal || key <= row + offset);
        const float p =
            live ? expf(s[nt][e] * sm_scale - (e < 2 ? lse0 : lse1)) : 0.f;
        s[nt][e] = p * (dp[nt][e] - (e < 2 ? dl0 : dl1)) * sm_scale;
      }
    }

    // dQ += dS K, dS rounded to bf16.
#pragma unroll
    for (int kk = 0; kk < kBK2 / 16; ++kk) {
      uint32_t sa[4];
      sa[0] = rt::pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      sa[1] = rt::pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      sa[2] = rt::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      sa[3] = rt::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        uint32_t bf[2];
        ldmatrix_x2_trans(bf, Ks + (kk * 16 + (lane & 15)) * LD + dt * 8);
        rt::mma_bf16_16816(acc[dt], sa, bf);
      }
    }
  }

#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int c = dt * 8 + 2 * t;
    if (r0 < Sq)
      *reinterpret_cast<uint32_t*>(dq + ((b * Sq + r0) * H + h) * D + c) =
          rt::pack_bf16(acc[dt][0], acc[dt][1]);
    if (r1 < Sq)
      *reinterpret_cast<uint32_t*>(dq + ((b * Sq + r1) * H + h) * D + c) =
          rt::pack_bf16(acc[dt][2], acc[dt][3]);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv,
                         int64_t H, int64_t KVH, int64_t Sq, int64_t Sk,
                         int64_t qsb, int64_t qss, int64_t qsh, int64_t ksb,
                         int64_t kss, int64_t ksh, int64_t vsb, int64_t vss,
                         int64_t vsh, int64_t dsb, int64_t dss, int64_t dsh,
                         int causal, float sm_scale) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + kBK3 * LD;
  bf16* Qs = Vs + kBK3 * LD;
  bf16* Ds = Qs + kBQ3 * LD;
  float* Ls = reinterpret_cast<float*>(Ds + kBQ3 * LD);
  float* Dl = Ls + kBQ3;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int64_t k0 = static_cast<int64_t>(blockIdx.x) * kBK3;
  const int64_t kvh = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int64_t n_rep = H / KVH;
  const int64_t offset = Sk - Sq;
  const int wk = warp * 16;        // the warp's first key in the block
  const int64_t key0 = k0 + wk + g;  // this thread's two keys
  const int64_t key1 = key0 + 8;

  load_tile<kBK3, D>(Ks, k + b * ksb + kvh * ksh, kss, k0, Sk);
  load_tile<kBK3, D>(Vs, v + b * vsb + kvh * vsh, vss, k0, Sk);

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;

  // Query rows before k0 - offset see none of the block's keys.
  const int64_t first = causal ? (k0 - offset > 0 ? k0 - offset : 0) : 0;
  const int64_t q_start = first / kBQ3 * kBQ3;

  for (int64_t hr = 0; hr < n_rep; ++hr) {
    const int64_t h = kvh * n_rep + hr;
    const bf16* qb = q + b * qsb + h * qsh;
    const bf16* db = dout + b * dsb + h * dsh;
    const float* lb = lse + (b * H + h) * Sq;
    const float* deb = delta + (b * H + h) * Sq;
    for (int64_t q0 = q_start; q0 < Sq; q0 += kBQ3) {
      __syncthreads();  // every warp is done with the previous tile
      load_tile<kBQ3, D>(Qs, qb, qss, q0, Sq);
      load_tile<kBQ3, D>(Ds, db, dss, q0, Sq);
      if (threadIdx.x < kBQ3) {
        const int64_t r = q0 + threadIdx.x;
        Ls[threadIdx.x] = r < Sq ? lb[r] : 0.f;
        Dl[threadIdx.x] = r < Sq ? deb[r] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T for 16 keys x 32 rows.
      float st[kBQ3 / 8][4], dpt[kBQ3 / 8][4];
#pragma unroll
      for (int nt = 0; nt < kBQ3 / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[nt][e] = dpt[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ka[4], va[4];
        load_a<LD>(ka, Ks, wk, kk * 16, g, t);
        load_a<LD>(va, Vs, wk, kk * 16, g, t);
#pragma unroll
        for (int nt = 0; nt < kBQ3 / 8; ++nt) {
          uint32_t bq[2], bd[2];
          load_bt<LD>(bq, Qs, nt * 8, kk * 16, g, t);
          load_bt<LD>(bd, Ds, nt * 8, kk * 16, g, t);
          rt::mma_bf16_16816(st[nt], ka, bq);
          rt::mma_bf16_16816(dpt[nt], va, bd);
        }
      }

      // P^T (0 where masked) in st, dS^T in dpt.
#pragma unroll
      for (int nt = 0; nt < kBQ3 / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = nt * 8 + 2 * t + (e & 1);
          const int64_t row = q0 + col;
          const int64_t key = e < 2 ? key0 : key1;
          const bool live =
              row < Sq && key < Sk && (!causal || key <= row + offset);
          const float p = live ? expf(st[nt][e] * sm_scale - Ls[col]) : 0.f;
          st[nt][e] = p;
          dpt[nt][e] = p * (dpt[nt][e] - Dl[col]) * sm_scale;
        }
      }

      // dV += P^T dO and dK += dS^T Q, P^T and dS^T rounded to bf16.
#pragma unroll
      for (int kk = 0; kk < kBQ3 / 16; ++kk) {
        uint32_t pa[4], sa[4];
        pa[0] = rt::pack_bf16(st[2 * kk][0], st[2 * kk][1]);
        pa[1] = rt::pack_bf16(st[2 * kk][2], st[2 * kk][3]);
        pa[2] = rt::pack_bf16(st[2 * kk + 1][0], st[2 * kk + 1][1]);
        pa[3] = rt::pack_bf16(st[2 * kk + 1][2], st[2 * kk + 1][3]);
        sa[0] = rt::pack_bf16(dpt[2 * kk][0], dpt[2 * kk][1]);
        sa[1] = rt::pack_bf16(dpt[2 * kk][2], dpt[2 * kk][3]);
        sa[2] = rt::pack_bf16(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]);
        sa[3] = rt::pack_bf16(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3]);
#pragma unroll
        for (int dt = 0; dt < D / 8; ++dt) {
          uint32_t bd[2], bq[2];
          ldmatrix_x2_trans(bd, Ds + (kk * 16 + (lane & 15)) * LD + dt * 8);
          ldmatrix_x2_trans(bq, Qs + (kk * 16 + (lane & 15)) * LD + dt * 8);
          rt::mma_bf16_16816(dv_acc[dt], pa, bd);
          rt::mma_bf16_16816(dk_acc[dt], sa, bq);
        }
      }
    }
  }

#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int c = dt * 8 + 2 * t;
    if (key0 < Sk) {
      const int64_t o = ((b * Sk + key0) * KVH + kvh) * D + c;
      *reinterpret_cast<uint32_t*>(dk + o) =
          rt::pack_bf16(dk_acc[dt][0], dk_acc[dt][1]);
      *reinterpret_cast<uint32_t*>(dv + o) =
          rt::pack_bf16(dv_acc[dt][0], dv_acc[dt][1]);
    }
    if (key1 < Sk) {
      const int64_t o = ((b * Sk + key1) * KVH + kvh) * D + c;
      *reinterpret_cast<uint32_t*>(dk + o) =
          rt::pack_bf16(dk_acc[dt][2], dk_acc[dt][3]);
      *reinterpret_cast<uint32_t*>(dv + o) =
          rt::pack_bf16(dv_acc[dt][2], dv_acc[dt][3]);
    }
  }
}

template <int D>
constexpr int dq_smem() {
  return (2 * kBQ2 + 2 * kBK2) * (D + 8) * 2;
}

template <int D>
constexpr int dkv_smem() {
  return (2 * kBK3 + 2 * kBQ3) * (D + 8) * 2 + 2 * kBQ3 * 4;
}

template <int D>
int launch_dq(dim3 grid, cudaStream_t s, const bf16* qp, const bf16* kp,
              const bf16* vp, const bf16* dp, const float* lp,
              const float* dlp, bf16* dqp, int64_t H, int64_t KVH,
              int64_t Sq, int64_t Sk, const int64_t* st, int causal,
              float sm_scale) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      dq_smem<D>());
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_kernel<D><<<grid, kThreads, dq_smem<D>(), s>>>(
      qp, kp, vp, dp, lp, dlp, dqp, H, KVH, Sq, Sk, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
      causal, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(dim3 grid, cudaStream_t s, const bf16* qp, const bf16* kp,
               const bf16* vp, const bf16* dp, const float* lp,
               const float* dlp, bf16* dkp, bf16* dvp, int64_t H,
               int64_t KVH, int64_t Sq, int64_t Sk, const int64_t* st,
               int causal, float sm_scale) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      dkv_smem<D>());
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkv_kernel<D><<<grid, kThreads, dkv_smem<D>(), s>>>(
      qp, kp, vp, dp, lp, dlp, dkp, dvp, H, KVH, Sq, Sk, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
      st[11], causal, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, dout: [B, Sq, H, D]; k, v: [B, Sk, KVH, D], bf16 through strides
// (in elements, batch / seq / head; the last dim contiguous, strides
// multiples of 8 and 16-byte aligned bases, checked by the wrapper).
// lse, delta: [B, H, Sq] f32 contiguous. dq: [B, Sq, H, D] contiguous
// bf16. D is 64 or 128.
RT_EXPORT int rt_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int64_t B, int64_t H,
    int64_t KVH, int64_t Sq, int64_t Sk, int64_t D, int64_t qsb,
    int64_t qss, int64_t qsh, int64_t ksb, int64_t kss, int64_t ksh,
    int64_t vsb, int64_t vss, int64_t vsh, int64_t dsb, int64_t dss,
    int64_t dsh, int causal, float sm_scale, void* stream) {
  if (B == 0 || Sq == 0) return 0;
  const int64_t st[12] = {qsb, qss, qsh, ksb, kss, ksh,
                          vsb, vss, vsh, dsb, dss, dsh};
  dim3 grid(static_cast<unsigned>((Sq + kBQ2 - 1) / kBQ2),
            static_cast<unsigned>(H), static_cast<unsigned>(B));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const bf16*>(q);
  const auto* kp = static_cast<const bf16*>(k);
  const auto* vp = static_cast<const bf16*>(v);
  const auto* dp = static_cast<const bf16*>(dout);
  const auto* lp = static_cast<const float*>(lse);
  const auto* dlp = static_cast<const float*>(delta);
  auto* dqp = static_cast<bf16*>(dq);
  if (D == 128)
    return launch_dq<128>(grid, s, qp, kp, vp, dp, lp, dlp, dqp, H, KVH, Sq,
                          Sk, st, causal, sm_scale);
  if (D == 64)
    return launch_dq<64>(grid, s, qp, kp, vp, dp, lp, dlp, dqp, H, KVH, Sq,
                         Sk, st, causal, sm_scale);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Same inputs as rt_flash_attention_bwd_dq; dk, dv: [B, Sk, KVH, D]
// contiguous bf16, each the sum over the H / KVH query heads of a group.
RT_EXPORT int rt_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int64_t B,
    int64_t H, int64_t KVH, int64_t Sq, int64_t Sk, int64_t D, int64_t qsb,
    int64_t qss, int64_t qsh, int64_t ksb, int64_t kss, int64_t ksh,
    int64_t vsb, int64_t vss, int64_t vsh, int64_t dsb, int64_t dss,
    int64_t dsh, int causal, float sm_scale, void* stream) {
  if (B == 0 || Sk == 0) return 0;
  const int64_t st[12] = {qsb, qss, qsh, ksb, kss, ksh,
                          vsb, vss, vsh, dsb, dss, dsh};
  dim3 grid(static_cast<unsigned>((Sk + kBK3 - 1) / kBK3),
            static_cast<unsigned>(KVH), static_cast<unsigned>(B));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const bf16*>(q);
  const auto* kp = static_cast<const bf16*>(k);
  const auto* vp = static_cast<const bf16*>(v);
  const auto* dp = static_cast<const bf16*>(dout);
  const auto* lp = static_cast<const float*>(lse);
  const auto* dlp = static_cast<const float*>(delta);
  auto* dkp = static_cast<bf16*>(dk);
  auto* dvp = static_cast<bf16*>(dv);
  if (D == 128)
    return launch_dkv<128>(grid, s, qp, kp, vp, dp, lp, dlp, dkp, dvp, H,
                           KVH, Sq, Sk, st, causal, sm_scale);
  if (D == 64)
    return launch_dkv<64>(grid, s, qp, kp, vp, dp, lp, dlp, dkp, dvp, H,
                          KVH, Sq, Sk, st, causal, sm_scale);
  return static_cast<int>(cudaErrorInvalidValue);
}
