// K1: flash-attention forward for Hopper, O = softmax(Q K^T * D^-0.5 +
// mask) V and the row logsumexp (natural log, f32), which K2 and K3 read.
//
// Replaces: ray_tpu/ops/attention.py, _fwd_kernel under _flash_forward.
// Same arithmetic: scores in f32 from bf16 operands, mask
// q_pos + (Sk - Sq) >= k_pos with -1e30, running max / sum /
// accumulator in f32, P rounded to V's dtype (bf16) before P V, the
// l == 0 guard, lse = m + log(l).
//
// Bound on the H100: at the training and prefill shapes (S 512-2048,
// D 128) each live (query, key) pair costs 4 D flops against a few bytes
// per row, so the tensor cores bound it (S 2048 H32: 0.035 ms of
// products); below S ~300 the bytes of Q, K, V and O do.
//
// Design. Warp-specialised, as K2: one consumer warpgroup (setmaxnreg
// up) owns the block's 64 query rows; one producer warp (setmaxnreg 24)
// loads the block's Q tile once and streams K/V tiles of 64 keys
// through a ring of two stages of shared memory, with a full and an
// empty mbarrier per stage. Tiles land 128-byte swizzled from 4-D
// tensor maps over the strided [B, S, H, D] inputs. S = Q K^T is one
// wgmma chain with both operands in shared memory; the online softmax
// runs on the accumulator fragments in base 2 (exp2f, the scale folded
// into D^-0.5 log2 e), each thread keeping its own partial row sums
// until the end; P is packed to bf16 in registers as the A operand of
// O += P V, with V read MN-major, so P never touches memory. Only
// diagonal and ragged tiles take the per-element mask (a key row that
// TMA filled with zeros scores -1e30, never 0); the running max starts
// at -1e30, so no -inf - -inf reaches exp2f. The epilogue stages O
// through the Q tile and writes whole rows. Two blocks run on each SM,
// so one block's softmax overlaps the other's products, and the short
// prefills get twice the blocks of 128-row ones (measured as fast or
// faster at S 128-2048). The launch plan (attention._fwd_plan) sets the
// grid and the query tile order, heaviest first under the causal mask,
// where the last query tiles see the most keys.
//
// Head dims. The tiles are D = 64 or 128 columns wide; the tensors' head
// dim DT may be narrower (DT 72, DiT-XL/2's 1152 / 16, runs in D 128
// tiles). The tensor maps declare DT columns, so TMA fills columns DT ..
// D - 1 of every tile with zeros: they add nothing to Q K^T, and P V
// leaves them 0 in O, which is never stored past DT. Q K^T runs only the
// (DT + 15) / 16 k steps that hold a live column (5 of 8 at DT 72).
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using rt::acc_to_a;
using rt::kmajor;
using rt::mnmajor;
using rt::opaque;
using rt::tile_bytes;
using rt::tma_tile;
using rt::zero;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

constexpr int kRows = 64;         // query rows per block
constexpr int kKeys = 64;         // keys per K/V tile
constexpr int kStages = 2;        // K/V ring depth
constexpr int kThreads = 256;     // consumer warpgroup + producer
constexpr int kBlocksPerSm = 2;
// registers: the launch gives 65536 / (kThreads * kBlocksPerSm) each;
// the producer warpgroup gives most of its share to the consumers
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 232;
static_assert(kProducerRegs * 128 + kConsumerRegs * 128 <=
                  65536 / kBlocksPerSm,
              "setmaxnreg budget");

template <int D>
struct Fwd {
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + tile_bytes<D>(kRows);  // + s * stage
  static constexpr int kV = kK + kStages * tile_bytes<D>(kKeys);
  static constexpr int kBars = kV + kStages * tile_bytes<D>(kKeys);
  static constexpr int kBytes = kBars + (1 + 2 * kStages) * 8 + 1024;
};

// Block i takes query tile first + step * (i / (H B)), head i % H and
// batch i / H % B (the plan's order).
template <int D, int DT>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     bf16* __restrict__ o, float* __restrict__ lse, int B,
                     int H, int KVH, int Sq, int Sk, int causal,
                     float sm_scale, int first, int step) {
  static_assert(DT <= D && DT % 8 == 0, "head dim within the tile");
  using L = Fwd<D>;
  constexpr int kSteps = (DT + 15) / 16;  // k steps of Q K^T
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int per_tile = H * B;
  const int qt = first + step * (static_cast<int>(blockIdx.x) / per_tile);
  const int h = static_cast<int>(blockIdx.x) % per_tile % H;
  const int b = static_cast<int>(blockIdx.x) % per_tile / H;
  const int kvh = h / (H / KVH);
  const int q0 = qt * kRows;
  const int offset = Sk - Sq;
  const int q_last = min(q0 + kRows - 1, Sq - 1);
  const int kv_end = causal ? min(Sk, q_last + offset + 1) : Sk;
  const int n_tiles = (kv_end + kKeys - 1) / kKeys;

  if (threadIdx.x == 0) {
    rt::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      rt::mbar_init(&full[s], 1);
      rt::mbar_init(&empty[s], 128);
    }
    rt::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // producer: one thread issues every TMA load
    rt::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x != 128) return;
    rt::mbar_arrive_expect_tx(q_full, tile_bytes<D>(kRows));
    tma_tile<D, kRows>(smem + L::kQ, &tq, q_full, q0, h, b);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages;
      rt::mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
      rt::mbar_arrive_expect_tx(&full[s], 2 * tile_bytes<D>(kKeys));
      tma_tile<D, kKeys>(smem + L::kK + s * tile_bytes<D>(kKeys), &tk,
                         &full[s], it * kKeys, kvh, b);
      tma_tile<D, kKeys>(smem + L::kV + s * tile_bytes<D>(kKeys), &tv,
                         &full[s], it * kKeys, kvh, b);
    }
    return;
  }

  // consumers: the warpgroup owns query rows [q0, q0 + 64)
  rt::setmaxnreg_inc<kConsumerRegs>();
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int r0 = q0 + 16 * warp + lane / 4;  // this thread's rows r0, r0 + 8
  const int r1 = r0 + 8;
  const float scale_log2 = sm_scale * kLog2e;

  float acc[D / 2];
  zero(acc);
  float m0 = kNegInf, m1 = kNegInf;  // running max, base 2 (never -inf)
  float l0 = 0.f, l1 = 0.f;          // this thread's part of the row sums
  const uint32_t q_sm = rt::smem_u32(smem + L::kQ);
  rt::mbar_wait(q_full, 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages;
    rt::mbar_wait(&full[s], (it / kStages) & 1);
    const int k0 = it * kKeys;
    const uint32_t k_sm =
        rt::smem_u32(smem + L::kK + s * tile_bytes<D>(kKeys));
    const uint32_t v_sm =
        rt::smem_u32(smem + L::kV + s * tile_bytes<D>(kKeys));
    const uint32_t qw_sm = opaque(q_sm);
    float sc[kKeys / 2];
    rt::wgmma_fence();
    rt::wgmma_ss_n64_first(sc, kmajor<kRows>(qw_sm, 0, 0),
                           kmajor<kKeys>(k_sm, 0, 0));
#pragma unroll
    for (int kk = 1; kk < kSteps; ++kk)
      rt::wgmma_ss_n64(sc, kmajor<kRows>(qw_sm, 0, kk),
                       kmajor<kKeys>(k_sm, 0, kk));
    rt::wgmma_commit();
    rt::wgmma_wait<0>();
    rt::fence_regs(sc);

    // scores in base 2; diagonal and ragged tiles masked per element
    const bool interior =
        k0 + kKeys <= Sk && (!causal || k0 + kKeys - 1 <= q0 + offset);
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int i = 0; i < kKeys / 2; ++i) {
      float x = sc[i] * scale_log2;
      if (!interior) {
        const int key = k0 + 8 * (i / 4) + 2 * (lane % 4) + (i & 1);
        const int row = (i & 2) ? r1 : r0;
        if (key >= Sk || (causal && key > row + offset)) x = kNegInf;
      }
      sc[i] = x;
      if (i & 2)
        mx1 = fmaxf(mx1, x);
      else
        mx0 = fmaxf(mx0, x);
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float a0 = exp2f(m0 - mx0), a1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int i = 0; i < kKeys / 2; ++i) {
      const float p = exp2f(sc[i] - ((i & 2) ? m1 : m0));
      sc[i] = p;
      if (i & 2)
        ps1 += p;
      else
        ps0 += p;
    }
    l0 = l0 * a0 + ps0;
    l1 = l1 * a1 + ps1;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= (i & 2) ? a1 : a0;

    // O += P V, P rounded to bf16 (all of it before the first wgmma
    // reads it), V read MN-major
    uint32_t pa[kKeys / 16][4];
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) acc_to_a(pa[kk], sc, kk);
    rt::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk)
      rt::wgmma_rs_tb<D>(acc, pa[kk], mnmajor<kKeys>(v_sm, kk));
    rt::wgmma_commit();
    rt::wgmma_wait<0>();
    rt::fence_regs(acc);
    rt::mbar_arrive(&empty[s]);
  }

  // row sums over the quad; a row with no key keeps l == 0 -> 1
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / (l0 == 0.f ? 1.f : l0);
  const float inv1 = 1.f / (l1 == 0.f ? 1.f : l1);

  // O through the Q tile (no wgmma reads it any more), 16-byte chunks
  // swizzled by row, then whole rows of DT columns out
  unsigned char* ow = smem + L::kQ;
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int row = 16 * warp + lane / 4 + ((i & 2) ? 8 : 0);
    const int col = 8 * (i / 4) + 2 * (lane % 4);  // 0 .. D - 1
    const int chunk = (col % 64) / 8;
    const float inv = (i & 2) ? inv1 : inv0;
    *reinterpret_cast<uint32_t*>(ow + (col / 64) * kRows * 128 + row * 128 +
                                 ((chunk ^ (row & 7)) * 16) +
                                 (col % 8) * 2) =
        rt::pack_bf16(acc[i] * inv, acc[i + 1] * inv);
  }
  rt::named_sync(1, 128);
  constexpr int kChunks = DT / 8;  // 16-byte chunks per row
#pragma unroll
  for (int c = tid; c < kRows * kChunks; c += 128) {
    const int row = c / kChunks, col = (c % kChunks) * 8;
    const int chunk = (col % 64) / 8;
    if (q0 + row < Sq)
      *reinterpret_cast<uint4*>(
          o + ((static_cast<int64_t>(b) * Sq + q0 + row) * H + h) * DT +
          col) =
          *reinterpret_cast<const uint4*>(ow + (col / 64) * kRows * 128 +
                                          row * 128 +
                                          ((chunk ^ (row & 7)) * 16));
  }
  if (lane % 4 == 0) {
    float* lb = lse + (static_cast<int64_t>(b) * H + h) * Sq;
    if (r0 < Sq) lb[r0] = l0 == 0.f ? kNegInf : m0 * kLn2 + logf(l0);
    if (r1 < Sq) lb[r1] = l1 == 0.f ? kNegInf : m1 * kLn2 + logf(l1);
  }
}

// No key at all (Sk == 0): o = 0 and lse = -1e30, as the plain version.
__global__ void no_key_kernel(bf16* __restrict__ o, float* __restrict__ lse,
                              int64_t n_o, int64_t n_lse) {
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n_o) o[i] = __float2bfloat16(0.f);
  if (i < n_lse) lse[i] = kNegInf;
}

template <int D, int DT>
int launch(const void* q, const void* k, const void* v, bf16* op, float* lp,
           int64_t B, int64_t H, int64_t KVH, int64_t Sq, int64_t Sk,
           const int64_t* st, int causal, float sm_scale, int64_t blocks,
           int first, int step, cudaStream_t s) {
  using L = Fwd<D>;
  CUtensorMap tq, tk, tv;
  if (!rt::make_map_bshd(&tq, q, B, Sq, H, DT, st[0], st[1], st[2], kRows) ||
      !rt::make_map_bshd(&tk, k, B, Sk, KVH, DT, st[3], st[4], st[5], kKeys) ||
      !rt::make_map_bshd(&tv, v, B, Sk, KVH, DT, st[6], st[7], st[8], kKeys))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D, DT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_fwd_kernel<D, DT><<<static_cast<unsigned>(blocks), kThreads, L::kBytes,
                        s>>>(
      tq, tk, tv, op, lp, static_cast<int>(B), static_cast<int>(H),
      static_cast<int>(KVH), static_cast<int>(Sq), static_cast<int>(Sk),
      causal, sm_scale, first, step);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: [B, Sq, H, D], k/v: [B, Sk, KVH, D] bf16 through strides (in
// elements, batch / seq / head; the last dim contiguous, strides
// multiples of 8 and 16-byte aligned bases, checked by the wrapper).
// o: [B, Sq, H, D] contiguous bf16; lse: [B, H, Sq] f32. D is 64, 72 or
// 128.
// The launch plan: blocks, one per (64-row query tile, head, batch), and
// the query tile order, first_tile + tile_step * i for i = 0, 1, ...
// (tile_step 1 from tile 0, or -1 from the last tile).
RT_EXPORT int rt_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int64_t B, int64_t H, int64_t KVH, int64_t Sq, int64_t Sk, int64_t D,
    int64_t qsb, int64_t qss, int64_t qsh, int64_t ksb, int64_t kss,
    int64_t ksh, int64_t vsb, int64_t vss, int64_t vsh, int causal,
    float sm_scale, int64_t blocks, int first_tile, int tile_step,
    void* stream) {
  if (B == 0 || Sq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* op = static_cast<bf16*>(o);
  auto* lp = static_cast<float*>(lse);
  if (Sk == 0) {
    const int64_t n_o = B * Sq * H * D, n_lse = B * H * Sq;
    no_key_kernel<<<static_cast<unsigned>((n_o + 255) / 256), 256, 0, s>>>(
        op, lp, n_o, n_lse);
    return static_cast<int>(cudaGetLastError());
  }
  // block indices and positions are 32-bit in the kernel; the plan must
  // cover every query tile once
  const int64_t lim = int64_t(1) << 30;
  const int64_t n_qt = (Sq + kRows - 1) / kRows;
  if (B * H * n_qt >= lim || Sq >= lim || Sk >= lim ||
      blocks != B * H * n_qt ||
      !((tile_step == 1 && first_tile == 0) ||
        (tile_step == -1 && first_tile == n_qt - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t st[9] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
  if (D == 128)
    return launch<128, 128>(q, k, v, op, lp, B, H, KVH, Sq, Sk, st, causal,
                            sm_scale, blocks, first_tile, tile_step, s);
  if (D == 72)
    return launch<128, 72>(q, k, v, op, lp, B, H, KVH, Sq, Sk, st, causal,
                           sm_scale, blocks, first_tile, tile_step, s);
  if (D == 64)
    return launch<64, 64>(q, k, v, op, lp, B, H, KVH, Sq, Sk, st, causal,
                          sm_scale, blocks, first_tile, tile_step, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
