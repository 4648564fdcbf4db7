// K2 and K3: flash-attention backward for Hopper, from the row
// logsumexp that K1 writes and delta = rowsum(dO * O) (f32, computed by
// the wrapper, as the reference computes it outside its kernels).
//
// Replaces: ray_tpu/ops/attention.py, _dq_kernel (K2) and _dkv_kernel
// (K3) under _flash_backward. Same arithmetic: scores in f32 from bf16
// operands, P = exp(S * scale - lse), dP = dO V^T, dS = P * (dP - delta)
// * scale; P and dS are f32 and rounded to bf16 only as operands of the
// products that take them (P^T dO, dS K, dS^T Q); dQ, dK and dV sum in
// f32 and are written once in bf16. A masked (query, key) pair gets
// P = 0 exactly (a select, not exp(-1e30 - lse)), so a row with no live
// key, or a padding row of a ragged tile that TMA filled with zeros,
// adds nothing anywhere and never NaN. The grads are deterministic: no
// float atomics anywhere, and dQ has a kernel of its own.
//
// Bound on the H100: at the training shapes (S 2048, D 128) each pair of
// a query and a live key costs 6 D flops in K2 and 8 D in K3 (S and dP
// are computed in both) against a few bytes per row, so the tensor
// cores bound both.
//
// Design. Both kernels are warp-specialised: two consumer warpgroups
// (setmaxnreg 240) each own 64 rows of the block's tile and run every
// product with wgmma; one producer warp (setmaxnreg 24) keeps TMA loads
// in flight through a ring of kStages stages of shared memory, with a
// full and an empty mbarrier per stage. Tiles land 128-byte swizzled in
// blocks of 64 columns, which is the layout the wgmma descriptors read,
// both K-major (the reduced dim contiguous) and MN-major (transposed B).
// Inputs are read in the model's [B, S, H, D] layout through 4-D tensor
// maps over their strides; rows past S come back as zeros and are
// masked. Blocks are launched heaviest first along the causal triangle.
//
// K2 (dQ): one block per (128 query rows, head, batch), the last query
// tiles (which see the most keys) first. Q and dO are loaded once; K/V
// tiles of 64 keys stream through the ring. S = Q K^T and dP = dO V^T
// take both operands from shared memory; dS stays in registers as the A
// operand of dQ += dS K, with the K tile read MN-major.
//
// K3 (dK/dV): one block per (128 keys, query head, batch), the first key
// tiles (which see the most queries) first: the GQA group is split
// across blocks, H / KVH times as many blocks as KV heads. K/V are loaded
// once; Q, dO, lse and delta tiles of 64 query rows stream through the
// ring. S^T = K Q^T and dP^T = V dO^T come from shared memory; P^T and
// dS^T stay in registers as the A operands of dV += P^T dO and dK += dS^T
// Q, with dO and Q read MN-major. With one query head per KV head the
// block writes bf16 dK/dV; otherwise it writes f32 partials per query
// head to a scratch [B, Sk, H, D] and a second pass sums each group in
// a fixed head order and writes bf16 (the VJP of jnp.repeat, with no
// atomics). Two other deterministic sums measured slower on the H100: a
// thread-block cluster per group summing through distributed shared
// memory, and the group's last block (by an integer ticket) summing the
// partials from L2, which is the kernel's tail when the grid is one wave.
//
// Head dims. As in K1 (attention.cu): the tiles are D = 64 or 128 columns
// wide and the tensors' head dim DT may be narrower (DT 72 in D 128
// tiles). TMA fills columns DT .. D - 1 with zeros, so S = Q K^T and
// dP = dO V^T, which run only the (DT + 15) / 16 k steps that hold a
// live column, are exact, and dQ, dK, dV (and the GQA partials) come out
// 0 there and are stored only up to DT.
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kConsumerThreads = 256;  // two warpgroups
constexpr int kThreads = 384;          // + the producer warpgroup
constexpr int kStages = 3;
constexpr int kQ2 = 128;  // K2: query rows per block
constexpr int kK2 = 64;   // K2: keys per tile
constexpr int kK3 = 128;  // K3: keys per block
constexpr int kQ3 = 64;   // K3: query rows per tile
constexpr float kLog2e = 1.4426950408889634f;

using rt::acc_to_a;
using rt::kmajor;
using rt::mnmajor;
using rt::opaque;
using rt::tile_bytes;
using rt::tma_tile;
using rt::wgmma_rs_tb;
using rt::zero;

// ---------------------------------------------------------------------------
// K2: dQ
// ---------------------------------------------------------------------------

template <int D>
struct DqSmem {
  static constexpr int kQ = 0;
  static constexpr int kDo = kQ + tile_bytes<D>(kQ2);
  static constexpr int kK = kDo + tile_bytes<D>(kQ2);  // + s * stage
  static constexpr int kV = kK + kStages * tile_bytes<D>(kK2);
  static constexpr int kBars = kV + kStages * tile_bytes<D>(kK2);
  static constexpr int kBytes = kBars + (1 + 2 * kStages) * 8 + 1024;
};

// Live key tiles of K2's block at query rows [q0, q0 + kQ2).
__device__ __forceinline__ int dq_tiles(int q0, int Sq, int Sk, int causal) {
  const int q_last = min(q0 + kQ2 - 1, Sq - 1);
  const int kv_end = causal ? min(Sk, q_last + (Sk - Sq) + 1) : Sk;
  return (kv_end + kK2 - 1) / kK2;
}

template <int D, int DT>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tdo,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        bf16* __restrict__ dq, int B, int H, int KVH, int Sq,
                        int Sk, int causal, float sm_scale) {
  static_assert(DT <= D && DT % 8 == 0, "head dim within the tile");
  using L = DqSmem<D>;
  constexpr int kSteps = (DT + 15) / 16;  // k steps of S and dP
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  // heaviest first: the last query tiles see the most keys
  const int n_qt = (Sq + kQ2 - 1) / kQ2;
  const int per_tile = H * B;
  const int qt = causal ? n_qt - 1 - static_cast<int>(blockIdx.x) / per_tile
                        : static_cast<int>(blockIdx.x) / per_tile;
  const int h = static_cast<int>(blockIdx.x) % per_tile % H;
  const int b = static_cast<int>(blockIdx.x) % per_tile / H;
  const int kvh = h / (H / KVH);
  const int q0 = qt * kQ2;
  const int offset = Sk - Sq;
  const int n_tiles = dq_tiles(q0, Sq, Sk, causal);

  if (threadIdx.x == 0) {
    rt::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      rt::mbar_init(&full[s], 1);
      rt::mbar_init(&empty[s], kConsumerThreads);
    }
    rt::mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // producer: one thread issues every TMA load
    rt::setmaxnreg_dec<24>();
    if (threadIdx.x != 256) return;
    rt::mbar_arrive_expect_tx(q_full, 2 * tile_bytes<D>(kQ2));
    tma_tile<D, kQ2>(smem + L::kQ, &tq, q_full, q0, h, b);
    tma_tile<D, kQ2>(smem + L::kDo, &tdo, q_full, q0, h, b);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages;
      rt::mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
      rt::mbar_arrive_expect_tx(&full[s], 2 * tile_bytes<D>(kK2));
      tma_tile<D, kK2>(smem + L::kK + s * tile_bytes<D>(kK2), &tk, &full[s],
                       it * kK2, kvh, b);
      tma_tile<D, kK2>(smem + L::kV + s * tile_bytes<D>(kK2), &tv, &full[s],
                       it * kK2, kvh, b);
    }
    return;
  }

  // consumers: warpgroup wg owns query rows [qw, qw + 64)
  rt::setmaxnreg_inc<240>();
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int qw = q0 + 64 * wg;
  const int r0 = qw + 16 * warp + lane / 4;  // this thread's rows r0, r0 + 8
  const int r1 = r0 + 8;
  const float scale_log2 = sm_scale * kLog2e;
  const float* lb = lse + (static_cast<int64_t>(b) * H + h) * Sq;
  const float* db = delta + (static_cast<int64_t>(b) * H + h) * Sq;
  const float lse0 = r0 < Sq ? lb[r0] * kLog2e : 0.f;
  const float lse1 = r1 < Sq ? lb[r1] * kLog2e : 0.f;
  const float dl0 = r0 < Sq ? db[r0] : 0.f;
  const float dl1 = r1 < Sq ? db[r1] : 0.f;
  const int q_last = min(qw + 63, Sq - 1);

  float acc[D / 2];
  zero(acc);
  const uint32_t q_sm = rt::smem_u32(smem + L::kQ);
  const uint32_t do_sm = rt::smem_u32(smem + L::kDo);
  rt::mbar_wait(q_full, 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages;
    rt::mbar_wait(&full[s], (it / kStages) & 1);
    const int k0 = it * kK2;
    const bool skip = qw >= Sq || (causal && k0 > q_last + offset);
    if (!skip) {
      const uint32_t k_sm =
          rt::smem_u32(smem + L::kK + s * tile_bytes<D>(kK2));
      const uint32_t v_sm =
          rt::smem_u32(smem + L::kV + s * tile_bytes<D>(kK2));
      const uint32_t qw_sm = opaque(q_sm + 64 * wg * 128);
      const uint32_t dw_sm = opaque(do_sm + 64 * wg * 128);
      float s_acc[32], dp_acc[32];
      rt::wgmma_fence();
      rt::wgmma_ss_n64_first(s_acc, kmajor<kQ2>(qw_sm, 0, 0),
                             kmajor<kK2>(k_sm, 0, 0));
#pragma unroll
      for (int kk = 1; kk < kSteps; ++kk)
        rt::wgmma_ss_n64(s_acc, kmajor<kQ2>(qw_sm, 0, kk),
                         kmajor<kK2>(k_sm, 0, kk));
      rt::wgmma_commit();
      rt::wgmma_ss_n64_first(dp_acc, kmajor<kQ2>(dw_sm, 0, 0),
                             kmajor<kK2>(v_sm, 0, 0));
#pragma unroll
      for (int kk = 1; kk < kSteps; ++kk)
        rt::wgmma_ss_n64(dp_acc, kmajor<kQ2>(dw_sm, 0, kk),
                         kmajor<kK2>(v_sm, 0, kk));
      rt::wgmma_commit();

      // P from lse (0 where masked) while dP = dO V^T still runs
      rt::wgmma_wait<1>();
      rt::fence_regs(s_acc);
      const bool interior = qw + 63 < Sq && k0 + kK2 - 1 < Sk &&
                            (!causal || k0 + kK2 - 1 <= qw + offset);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const bool hi = (i & 2) != 0;
        float p = exp2f(s_acc[i] * scale_log2 - (hi ? lse1 : lse0));
        if (!interior) {
          const int key = k0 + 8 * (i / 4) + 2 * (lane % 4) + (i & 1);
          const int row = hi ? r1 : r0;
          const bool live =
              row < Sq && key < Sk && (!causal || key <= row + offset);
          p = live ? p : 0.f;
        }
        s_acc[i] = p;
      }

      // then dS = P (dP - delta) scale
      rt::wgmma_wait<0>();
      rt::fence_regs(dp_acc);
#pragma unroll
      for (int i = 0; i < 32; ++i)
        s_acc[i] *= (dp_acc[i] - ((i & 2) ? dl1 : dl0)) * sm_scale;

      // dQ += dS K, dS rounded to bf16 (all of it before the first
      // wgmma reads it), K read MN-major
      uint32_t a[kK2 / 16][4];
#pragma unroll
      for (int kk = 0; kk < kK2 / 16; ++kk) acc_to_a(a[kk], s_acc, kk);
      rt::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kK2 / 16; ++kk)
        wgmma_rs_tb<D>(acc, a[kk], mnmajor<kK2>(k_sm, kk));
      rt::wgmma_commit();
      rt::wgmma_wait<0>();
      rt::fence_regs(acc);
    }
    rt::mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int row = (i & 2) ? r1 : r0;
    const int c = 8 * (i / 4) + 2 * (lane % 4);
    if (row < Sq && c < DT)
      *reinterpret_cast<uint32_t*>(
          dq + ((static_cast<int64_t>(b) * Sq + row) * H + h) * DT + c) =
          rt::pack_bf16(acc[i], acc[i + 1]);
  }
}

// ---------------------------------------------------------------------------
// K3: dK, dV
// ---------------------------------------------------------------------------

template <int D>
struct DkvSmem {
  static constexpr int kK = 0;
  static constexpr int kV = kK + tile_bytes<D>(kK3);
  static constexpr int kQ = kV + tile_bytes<D>(kK3);  // + s * stage
  static constexpr int kDo = kQ + kStages * tile_bytes<D>(kQ3);
  static constexpr int kLse = kDo + kStages * tile_bytes<D>(kQ3);
  static constexpr int kDelta = kLse + kStages * kQ3 * 4;
  static constexpr int kBars = kDelta + kStages * kQ3 * 4;
  static constexpr int kBytes = kBars + (1 + 2 * kStages) * 8 + 1024;
};

// First live query tile of K3's block at keys [k0, k0 + kK3): rows
// before k0 - (Sk - Sq) see none of its keys.
__device__ __forceinline__ int dkv_q_start(int k0, int Sq, int Sk,
                                           int causal) {
  const int first = causal ? max(0, k0 - (Sk - Sq)) : 0;
  return first / kQ3 * kQ3;
}

template <int D, int DT>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv,
                         float* __restrict__ pk, float* __restrict__ pv,
                         int B, int H, int KVH, int Sq, int Sk, int causal,
                         float sm_scale) {
  static_assert(DT <= D && DT % 8 == 0, "head dim within the tile");
  using L = DkvSmem<D>;
  constexpr int kSteps = (DT + 15) / 16;  // k steps of S^T and dP^T
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* lse_sm = reinterpret_cast<float*>(smem + L::kLse);
  float* delta_sm = reinterpret_cast<float*>(smem + L::kDelta);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;

  // heaviest first: the first key tiles see the most queries
  const int per_tile = H * B;
  const int kt = static_cast<int>(blockIdx.x) / per_tile;
  const int h = static_cast<int>(blockIdx.x) % per_tile % H;
  const int b = static_cast<int>(blockIdx.x) % per_tile / H;
  const int n_rep = H / KVH;
  const int kvh = h / n_rep;
  const int k0 = kt * kK3;
  const int offset = Sk - Sq;
  const int q_start = dkv_q_start(k0, Sq, Sk, causal);
  const int n_tiles = (Sq - q_start + kQ3 - 1) / kQ3;

  if (threadIdx.x == 0) {
    rt::mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      // the TMA thread's arrival and the producer warp's lse/delta
      rt::mbar_init(&full[s], 2);
      rt::mbar_init(&empty[s], kConsumerThreads);
    }
    rt::mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // producer warp: lane 0 issues the TMA loads, the warp loads lse and
    // delta (scaled to base 2) for each query tile
    rt::setmaxnreg_dec<24>();
    if (threadIdx.x >= 288) return;
    const int lane = threadIdx.x % 32;
    if (lane == 0) {
      rt::mbar_arrive_expect_tx(kv_full, 2 * tile_bytes<D>(kK3));
      tma_tile<D, kK3>(smem + L::kK, &tk, kv_full, k0, kvh, b);
      tma_tile<D, kK3>(smem + L::kV, &tv, kv_full, k0, kvh, b);
    }
    const int64_t rows = (static_cast<int64_t>(b) * H + h) * Sq;
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages;
      const int q0 = q_start + it * kQ3;
      rt::mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
      if (lane == 0) {
        rt::mbar_arrive_expect_tx(&full[s], 2 * tile_bytes<D>(kQ3));
        tma_tile<D, kQ3>(smem + L::kQ + s * tile_bytes<D>(kQ3), &tq,
                         &full[s], q0, h, b);
        tma_tile<D, kQ3>(smem + L::kDo + s * tile_bytes<D>(kQ3), &tdo,
                         &full[s], q0, h, b);
      }
#pragma unroll
      for (int r = lane; r < kQ3; r += 32) {
        const bool in = q0 + r < Sq;
        lse_sm[s * kQ3 + r] = in ? lse[rows + q0 + r] * kLog2e : 0.f;
        delta_sm[s * kQ3 + r] = in ? delta[rows + q0 + r] : 0.f;
      }
      __syncwarp();
      if (lane == 0) rt::mbar_arrive(&full[s]);
    }
    return;
  }

  // consumers: warpgroup wg owns keys [kw, kw + 64)
  rt::setmaxnreg_inc<240>();
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int kw = k0 + 64 * wg;
  const int key0 = kw + 16 * warp + lane / 4;  // this thread's keys key0, +8
  const bool wg_live = kw < Sk;
  const float scale_log2 = sm_scale * kLog2e;

  float dv_acc[D / 2], dk_acc[D / 2];
  zero(dv_acc);
  zero(dk_acc);
  const uint32_t k_sm = rt::smem_u32(smem + L::kK);
  const uint32_t v_sm = rt::smem_u32(smem + L::kV);
  rt::mbar_wait(kv_full, 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages;
    rt::mbar_wait(&full[s], (it / kStages) & 1);
    const int q0 = q_start + it * kQ3;
    const bool skip = !wg_live || (causal && kw > q0 + kQ3 - 1 + offset);
    if (!skip) {
      const uint32_t q_sm =
          rt::smem_u32(smem + L::kQ + s * tile_bytes<D>(kQ3));
      const uint32_t do_sm =
          rt::smem_u32(smem + L::kDo + s * tile_bytes<D>(kQ3));
      const uint32_t kw_sm = opaque(k_sm + 64 * wg * 128);
      const uint32_t vw_sm = opaque(v_sm + 64 * wg * 128);
      float st[32], dpt[32];
      rt::wgmma_fence();
      rt::wgmma_ss_n64_first(st, kmajor<kK3>(kw_sm, 0, 0),
                             kmajor<kQ3>(q_sm, 0, 0));
#pragma unroll
      for (int kk = 1; kk < kSteps; ++kk)
        rt::wgmma_ss_n64(st, kmajor<kK3>(kw_sm, 0, kk),
                         kmajor<kQ3>(q_sm, 0, kk));
      rt::wgmma_commit();
      rt::wgmma_ss_n64_first(dpt, kmajor<kK3>(vw_sm, 0, 0),
                             kmajor<kQ3>(do_sm, 0, 0));
#pragma unroll
      for (int kk = 1; kk < kSteps; ++kk)
        rt::wgmma_ss_n64(dpt, kmajor<kK3>(vw_sm, 0, kk),
                         kmajor<kQ3>(do_sm, 0, kk));
      rt::wgmma_commit();

      // P^T (0 where masked) while dP^T = V dO^T still runs; each k step
      // of 16 query columns rounded to bf16 as soon as it is done, as the
      // A operand of dV += P^T dO (dO read MN-major), issued at once
      rt::wgmma_wait<1>();
      rt::fence_regs(st);
      const float* ls = lse_sm + s * kQ3;
      const float* ds = delta_sm + s * kQ3;
      const bool interior = q0 + kQ3 - 1 < Sq && kw + 63 < Sk &&
                            (!causal || kw + 63 <= q0 + offset);
      uint32_t pa[kQ3 / 16][4];
#pragma unroll
      for (int kk = 0; kk < kQ3 / 16; ++kk) {
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int j = 2 * kk + jj;
          const int col = 8 * j + 2 * (lane % 4);
          const float2 l2 = *reinterpret_cast<const float2*>(ls + col);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * j + e;
            float p = exp2f(st[i] * scale_log2 - ((e & 1) ? l2.y : l2.x));
            if (!interior) {
              const int q = q0 + col + (e & 1);
              const int key = key0 + 8 * (e >> 1);
              const bool live =
                  q < Sq && key < Sk && (!causal || key <= q + offset);
              p = live ? p : 0.f;
            }
            st[i] = p;
          }
        }
        acc_to_a(pa[kk], st, kk);
      }
      rt::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kQ3 / 16; ++kk)
        wgmma_rs_tb<D>(dv_acc, pa[kk], mnmajor<kQ3>(do_sm, kk));
      rt::wgmma_commit();

      // dS^T = P^T (dP^T - delta) scale while dV's products run, then
      // dK += dS^T Q (Q read MN-major)
      rt::wgmma_wait<1>();
      rt::fence_regs(dpt);
      uint32_t sa[kQ3 / 16][4];
#pragma unroll
      for (int kk = 0; kk < kQ3 / 16; ++kk) {
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int j = 2 * kk + jj;
          const float2 d2 = *reinterpret_cast<const float2*>(
              ds + 8 * j + 2 * (lane % 4));
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * j + e;
            dpt[i] = st[i] * (dpt[i] - ((e & 1) ? d2.y : d2.x)) * sm_scale;
          }
        }
        acc_to_a(sa[kk], dpt, kk);
      }
      rt::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kQ3 / 16; ++kk)
        wgmma_rs_tb<D>(dk_acc, sa[kk], mnmajor<kQ3>(q_sm, kk));
      rt::wgmma_commit();
      rt::wgmma_wait<0>();
      rt::fence_regs(dv_acc);
      rt::fence_regs(dk_acc);
    }
    rt::mbar_arrive(&empty[s]);
  }

  if (!wg_live) return;
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int key = key0 + ((i & 2) ? 8 : 0);
    const int c = 8 * (i / 4) + 2 * (lane % 4);
    if (key >= Sk || c >= DT) continue;
    if (n_rep == 1) {
      const int64_t o =
          ((static_cast<int64_t>(b) * Sk + key) * KVH + kvh) * DT + c;
      *reinterpret_cast<uint32_t*>(dk + o) =
          rt::pack_bf16(dk_acc[i], dk_acc[i + 1]);
      *reinterpret_cast<uint32_t*>(dv + o) =
          rt::pack_bf16(dv_acc[i], dv_acc[i + 1]);
    } else {
      const int64_t o =
          ((static_cast<int64_t>(b) * Sk + key) * H + h) * DT + c;
      *reinterpret_cast<float2*>(pk + o) =
          make_float2(dk_acc[i], dk_acc[i + 1]);
      *reinterpret_cast<float2*>(pv + o) =
          make_float2(dv_acc[i], dv_acc[i + 1]);
    }
  }
}

// dk/dv [rows, D] bf16 = the sum over r = 0 .. n_rep - 1, in that order,
// of the partials [rows, n_rep, D] f32 (rows = B Sk KVH: the scratch
// [B, Sk, H, D] read with each GQA group's heads side by side).
__global__ void gqa_sum_kernel(const float* __restrict__ pk,
                               const float* __restrict__ pv,
                               bf16* __restrict__ dk, bf16* __restrict__ dv,
                               int64_t n4, int n_rep, int D) {
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  const int64_t row = i / (D / 4);
  const int64_t c = i % (D / 4) * 4;
  float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
  for (int r = 0; r < n_rep; ++r) {
    const int64_t o = (row * n_rep + r) * D + c;
    const float4 a = *reinterpret_cast<const float4*>(pk + o);
    const float4 v = *reinterpret_cast<const float4*>(pv + o);
    sk.x += a.x; sk.y += a.y; sk.z += a.z; sk.w += a.w;
    sv.x += v.x; sv.y += v.y; sv.z += v.z; sv.w += v.w;
  }
  const int64_t o = row * D + c;
  *reinterpret_cast<uint2*>(dk + o) =
      make_uint2(rt::pack_bf16(sk.x, sk.y), rt::pack_bf16(sk.z, sk.w));
  *reinterpret_cast<uint2*>(dv + o) =
      make_uint2(rt::pack_bf16(sv.x, sv.y), rt::pack_bf16(sv.z, sv.w));
}

struct Maps {
  CUtensorMap q, k, v, dout;
};

// Tensor maps of the four operands, Q/dO in boxes of q_rows rows and
// K/V in boxes of k_rows; false if cuTensorMapEncodeTiled refuses one.
bool make_maps(Maps* m, const void* q, const void* k, const void* v,
               const void* dout, int64_t B, int64_t H, int64_t KVH,
               int64_t Sq, int64_t Sk, int64_t D, const int64_t* st,
               int q_rows, int k_rows) {
  return rt::make_map_bshd(&m->q, q, B, Sq, H, D, st[0], st[1], st[2],
                           q_rows) &&
         rt::make_map_bshd(&m->k, k, B, Sk, KVH, D, st[3], st[4], st[5],
                           k_rows) &&
         rt::make_map_bshd(&m->v, v, B, Sk, KVH, D, st[6], st[7], st[8],
                           k_rows) &&
         rt::make_map_bshd(&m->dout, dout, B, Sq, H, D, st[9], st[10],
                           st[11], q_rows);
}

template <int D, int DT>
int launch_dq(const Maps& m, cudaStream_t s, const float* lp,
              const float* dlp, bf16* dqp, int64_t B, int64_t H, int64_t KVH,
              int64_t Sq, int64_t Sk, int causal, float sm_scale) {
  constexpr int smem = DqSmem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D, DT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>((Sq + kQ2 - 1) / kQ2 * H * B);
  flash_bwd_dq_kernel<D, DT><<<grid, kThreads, smem, s>>>(
      m.q, m.k, m.v, m.dout, lp, dlp, dqp, static_cast<int>(B),
      static_cast<int>(H), static_cast<int>(KVH), static_cast<int>(Sq),
      static_cast<int>(Sk), causal, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int DT>
int launch_dkv(const Maps& m, cudaStream_t s, const float* lp,
               const float* dlp, bf16* dkp, bf16* dvp, float* pk, float* pv,
               int64_t B, int64_t H, int64_t KVH, int64_t Sq, int64_t Sk,
               int causal, float sm_scale) {
  constexpr int smem = DkvSmem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D, DT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>((Sk + kK3 - 1) / kK3 * H * B);
  flash_bwd_dkv_kernel<D, DT><<<grid, kThreads, smem, s>>>(
      m.q, m.k, m.v, m.dout, lp, dlp, dkp, dvp, pk, pv, static_cast<int>(B),
      static_cast<int>(H), static_cast<int>(KVH), static_cast<int>(Sq),
      static_cast<int>(Sk), causal, sm_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || H == KVH) return static_cast<int>(err);
  const int64_t n4 = B * Sk * KVH * DT / 4;
  gqa_sum_kernel<<<static_cast<unsigned>((n4 + 255) / 256), 256, 0, s>>>(
      pk, pv, dkp, dvp, n4, static_cast<int>(H / KVH), DT);
  return static_cast<int>(cudaGetLastError());
}

bool sizes_ok(int64_t B, int64_t H, int64_t Sq, int64_t Sk) {
  // block indices and positions are 32-bit in the kernels
  const int64_t lim = int64_t(1) << 30;
  return B * H * ((Sq + kQ2 - 1) / kQ2) < lim &&
         B * H * ((Sk + kK3 - 1) / kK3) < lim && Sq < lim && Sk < lim;
}

}  // namespace

// q, dout: [B, Sq, H, D]; k, v: [B, Sk, KVH, D], bf16 through strides
// (in elements, batch / seq / head; the last dim contiguous, strides
// multiples of 8 and 16-byte aligned bases, checked by the wrapper).
// lse, delta: [B, H, Sq] f32 contiguous. dq: [B, Sq, H, D] contiguous
// bf16. D is 64, 72 or 128.
RT_EXPORT int rt_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int64_t B, int64_t H,
    int64_t KVH, int64_t Sq, int64_t Sk, int64_t D, int64_t qsb,
    int64_t qss, int64_t qsh, int64_t ksb, int64_t kss, int64_t ksh,
    int64_t vsb, int64_t vss, int64_t vsh, int64_t dsb, int64_t dss,
    int64_t dsh, int causal, float sm_scale, void* stream) {
  if (B == 0 || Sq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Sk == 0)  // no key: dq is 0
    return static_cast<int>(
        cudaMemsetAsync(dq, 0, B * Sq * H * D * sizeof(bf16), s));
  if ((D != 64 && D != 72 && D != 128) || !sizes_ok(B, H, Sq, Sk))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t st[12] = {qsb, qss, qsh, ksb, kss, ksh,
                          vsb, vss, vsh, dsb, dss, dsh};
  Maps m;
  if (!make_maps(&m, q, k, v, dout, B, H, KVH, Sq, Sk, D, st, kQ2, kK2))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* lp = static_cast<const float*>(lse);
  const auto* dlp = static_cast<const float*>(delta);
  auto* dqp = static_cast<bf16*>(dq);
  if (D == 128)
    return launch_dq<128, 128>(m, s, lp, dlp, dqp, B, H, KVH, Sq, Sk, causal,
                               sm_scale);
  if (D == 72)
    return launch_dq<128, 72>(m, s, lp, dlp, dqp, B, H, KVH, Sq, Sk, causal,
                              sm_scale);
  return launch_dq<64, 64>(m, s, lp, dlp, dqp, B, H, KVH, Sq, Sk, causal,
                           sm_scale);
}

// Same inputs as rt_flash_attention_bwd_dq; dk, dv: [B, Sk, KVH, D]
// contiguous bf16, each the sum over the H / KVH query heads of a group.
// pk, pv: f32 scratch [B, Sk, H, D] for the per-head partials, used when
// H > KVH (may be null when H == KVH).
RT_EXPORT int rt_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, void* pk,
    void* pv, int64_t B, int64_t H, int64_t KVH, int64_t Sq, int64_t Sk,
    int64_t D, int64_t qsb, int64_t qss, int64_t qsh, int64_t ksb,
    int64_t kss, int64_t ksh, int64_t vsb, int64_t vss, int64_t vsh,
    int64_t dsb, int64_t dss, int64_t dsh, int causal, float sm_scale,
    void* stream) {
  if (B == 0 || Sk == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Sq == 0) {  // no query: dk and dv are 0
    const size_t n = B * Sk * KVH * D * sizeof(bf16);
    cudaError_t err = cudaMemsetAsync(dk, 0, n, s);
    if (err == cudaSuccess) err = cudaMemsetAsync(dv, 0, n, s);
    return static_cast<int>(err);
  }
  if ((D != 64 && D != 72 && D != 128) || !sizes_ok(B, H, Sq, Sk) ||
      (H != KVH && (pk == nullptr || pv == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t st[12] = {qsb, qss, qsh, ksb, kss, ksh,
                          vsb, vss, vsh, dsb, dss, dsh};
  Maps m;
  if (!make_maps(&m, q, k, v, dout, B, H, KVH, Sq, Sk, D, st, kQ3, kK3))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* lp = static_cast<const float*>(lse);
  const auto* dlp = static_cast<const float*>(delta);
  auto* dkp = static_cast<bf16*>(dk);
  auto* dvp = static_cast<bf16*>(dv);
  auto* pkp = static_cast<float*>(pk);
  auto* pvp = static_cast<float*>(pv);
  if (D == 128)
    return launch_dkv<128, 128>(m, s, lp, dlp, dkp, dvp, pkp, pvp, B, H, KVH,
                                Sq, Sk, causal, sm_scale);
  if (D == 72)
    return launch_dkv<128, 72>(m, s, lp, dlp, dkp, dvp, pkp, pvp, B, H, KVH,
                               Sq, Sk, causal, sm_scale);
  return launch_dkv<64, 64>(m, s, lp, dlp, dkp, dvp, pkp, pvp, B, H, KVH, Sq,
                            Sk, causal, sm_scale);
}
