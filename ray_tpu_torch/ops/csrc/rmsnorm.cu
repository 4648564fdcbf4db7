// K4: fused RMSNorm, out = x * rsqrt(mean(x^2) + eps) * w, in f32,
// cast to x's dtype (bf16, fp16 or f32).
//
// Replaces: ray_tpu/ops/rmsnorm.py, _rms_kernel under _rms_pallas (the
// TPU kernel holds a 512-row block in VMEM).
//
// Bound on the H100: bytes, and at decode latency. Each element is read
// and written once for a handful of flops. At decode (8 rows of 4096)
// the call moves 136 KB, far less than one HBM round trip can carry, so
// its time is the launch plus the number of dependent trips to memory.
// Design: the row stays in registers. Each thread owns `VPT` slots of
// `W` elements (one 16-byte vector, or W masked scalar loads on the
// ragged or unaligned path), strided `threads` slots apart so that a
// warp reads contiguous 512-byte runs, and issues every load of x and w
// before any arithmetic: one trip to memory per call. The sum of
// squares is reduced in f32 with warp shuffles, then through shared
// memory when a row spans several warps, and the same registers are
// scaled and stored. A block owns one row: at decode, 8 rows put their
// loads in flight on 8 SMs at once. The launch plan (rmsnorm._rms_plan)
// sets threads per row and VPT, four slots a thread where the row
// allows (measured against one and two, and against several rows a
// block: PERF.md). A row wider than 512 x 4 slots is cut into chunks:
// the sum pass and the scale pass each walk them, and the second reads
// x again.
#include <cuda_fp16.h>

#include "common.cuh"

namespace {

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int kWidth = 4;
  __device__ static float to(float v) { return v; }
  __device__ static float from(float f) { return f; }
};

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kWidth = 8;
  __device__ static float to(__nv_bfloat16 v) { return __bfloat162float(v); }
  __device__ static __nv_bfloat16 from(float f) { return __float2bfloat16(f); }
};

template <>
struct Elem<__half> {
  static constexpr int kWidth = 8;
  __device__ static float to(__half v) { return __half2float(v); }
  __device__ static __half from(float f) { return __float2half(f); }
};

// Slot of W elements at columns [c, c + W) of a row: one 16-byte load
// (VEC: c + W <= d whenever c < d, and 16-byte aligned), or W masked
// scalar loads. Columns past d read 0.
template <typename T, bool VEC>
__device__ __forceinline__ uint4 load_slot(const T* __restrict__ p, int64_t c,
                                           int64_t d) {
  constexpr int W = Elem<T>::kWidth;
  uint4 v = make_uint4(0, 0, 0, 0);
  if (VEC) {
    if (c < d) v = *reinterpret_cast<const uint4*>(p + c);
  } else {
    T* e = reinterpret_cast<T*>(&v);
#pragma unroll
    for (int i = 0; i < W; ++i)
      if (c + i < d) e[i] = p[c + i];
  }
  return v;
}

template <typename T, bool VEC>
__device__ __forceinline__ void store_slot(T* __restrict__ p, int64_t c,
                                           int64_t d, const uint4& v) {
  constexpr int W = Elem<T>::kWidth;
  if (VEC) {
    if (c < d) *reinterpret_cast<uint4*>(p + c) = v;
  } else {
    const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
    for (int i = 0; i < W; ++i)
      if (c + i < d) p[c + i] = e[i];
  }
}

template <typename T>
__device__ __forceinline__ float sum_squares(const uint4& v) {
  const T* e = reinterpret_cast<const T*>(&v);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < Elem<T>::kWidth; ++i) {
    const float f = Elem<T>::to(e[i]);
    s += f * f;
  }
  return s;
}

// (x * r) * w per element, in f32, rounded to T.
template <typename T>
__device__ __forceinline__ uint4 scale_slot(const uint4& xv, const uint4& wv,
                                            float r) {
  uint4 o;
  const T* xe = reinterpret_cast<const T*>(&xv);
  const T* we = reinterpret_cast<const T*>(&wv);
  T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
  for (int i = 0; i < Elem<T>::kWidth; ++i)
    oe[i] = Elem<T>::from((Elem<T>::to(xe[i]) * r) * Elem<T>::to(we[i]));
  return o;
}

// The sum of `s` over the block's threads (one row), in a fixed order.
__device__ __forceinline__ float row_sum(float s, float* part) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  const int warps = blockDim.x >> 5;
  if (warps == 1) return s;
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = s;
  __syncthreads();
  float t = 0.f;
  for (int i = 0; i < warps; ++i) t += part[i];
  return t;
}

constexpr int kMaxThreads = 512;

template <typename T, int VPT, bool VEC>
__global__ void __launch_bounds__(kMaxThreads)
    rms_norm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    T* __restrict__ out, int64_t d, float eps, int chunks) {
  constexpr int W = Elem<T>::kWidth;
  __shared__ float part[kMaxThreads / 32];
  const int64_t row = blockIdx.x;
  const T* xr = x + row * d;
  T* orow = out + row * d;
  const int64_t step = static_cast<int64_t>(blockDim.x) * W;  // slot stride
  const int64_t span = step * VPT;                             // a chunk
  const int64_t c0 = static_cast<int64_t>(threadIdx.x) * W;

  uint4 xv[VPT], wv[VPT];
  float ss = 0.f;
  if (chunks == 1) {
    // every load in flight before any arithmetic: one trip to memory
#pragma unroll
    for (int v = 0; v < VPT; ++v) {
      xv[v] = load_slot<T, VEC>(xr, c0 + v * step, d);
      wv[v] = load_slot<T, VEC>(w, c0 + v * step, d);
    }
#pragma unroll
    for (int v = 0; v < VPT; ++v) ss += sum_squares<T>(xv[v]);
  } else {
    for (int k = 0; k < chunks; ++k) {
#pragma unroll
      for (int v = 0; v < VPT; ++v)
        xv[v] = load_slot<T, VEC>(xr, k * span + c0 + v * step, d);
#pragma unroll
      for (int v = 0; v < VPT; ++v) ss += sum_squares<T>(xv[v]);
    }
  }
  const float r = rsqrtf(row_sum(ss, part) / static_cast<float>(d) + eps);
  if (chunks == 1) {
#pragma unroll
    for (int v = 0; v < VPT; ++v)
      store_slot<T, VEC>(orow, c0 + v * step, d,
                         scale_slot<T>(xv[v], wv[v], r));
  } else {
    for (int k = 0; k < chunks; ++k) {
#pragma unroll
      for (int v = 0; v < VPT; ++v) {
        const int64_t c = k * span + c0 + v * step;
        xv[v] = load_slot<T, VEC>(xr, c, d);
        wv[v] = load_slot<T, VEC>(w, c, d);
      }
#pragma unroll
      for (int v = 0; v < VPT; ++v)
        store_slot<T, VEC>(orow, k * span + c0 + v * step, d,
                           scale_slot<T>(xv[v], wv[v], r));
    }
  }
}

template <typename T, int VPT>
int launch(const void* x, const void* w, void* out, int64_t rows, int64_t d,
           float eps, int threads, int vector, int chunks, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>(rows));
  auto* xp = static_cast<const T*>(x);
  auto* wp = static_cast<const T*>(w);
  auto* op = static_cast<T*>(out);
  if (vector)
    rms_norm_kernel<T, VPT, true><<<grid, threads, 0, s>>>(xp, wp, op, d, eps,
                                                           chunks);
  else
    rms_norm_kernel<T, VPT, false><<<grid, threads, 0, s>>>(xp, wp, op, d,
                                                            eps, chunks);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_vpt(const void* x, const void* w, void* out, int64_t rows,
               int64_t d, float eps, int threads, int vecs, int vector,
               int chunks, cudaStream_t s) {
  switch (vecs) {
    case 1: return launch<T, 1>(x, w, out, rows, d, eps, threads, vector,
                                chunks, s);
    case 2: return launch<T, 2>(x, w, out, rows, d, eps, threads, vector,
                                chunks, s);
    default: return launch<T, 4>(x, w, out, rows, d, eps, threads, vector,
                                 chunks, s);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// x, out: [rows, d] contiguous; w: [d]; dtype 0 f32, 1 bf16, 2 fp16.
// The plan: a block per row of `threads` threads (a multiple of 32, at
// most 512), each holding `vecs` (1, 2 or 4) slots of 16 / sizeof(T)
// elements per chunk, over `chunks` chunks; `vector` selects 16-byte
// loads (d a multiple of the slot, every pointer 16-byte aligned) over
// masked scalar ones. A plan that breaks these, or does not cover each
// column once with no empty chunk, is refused (cudaErrorInvalidValue).
RT_EXPORT int rt_rms_norm(const void* x, const void* w, void* out,
                          int64_t rows, int64_t d, float eps, int dtype,
                          int threads, int vecs, int vector, int chunks,
                          void* stream) {
  const int width = dtype == 0 ? 4 : 8;
  const int64_t span = static_cast<int64_t>(threads) * vecs * width;
  const bool plan_ok =
      dtype >= 0 && dtype <= 2 && rows >= 0 && rows < (1ll << 31) && d > 0 &&
      threads >= 32 && threads % 32 == 0 && threads <= kMaxThreads &&
      (vecs == 1 || vecs == 2 || vecs == 4) && chunks >= 1 &&
      span * chunks >= d && span * (chunks - 1) < d &&
      (!vector || (d % width == 0 && aligned16(x) && aligned16(w) &&
                   aligned16(out)));
  if (!plan_ok) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_vpt<float>(x, w, out, rows, d, eps, threads, vecs,
                                     vector, chunks, s);
    case 1: return launch_vpt<__nv_bfloat16>(x, w, out, rows, d, eps, threads,
                                             vecs, vector, chunks, s);
    default: return launch_vpt<__half>(x, w, out, rows, d, eps, threads, vecs,
                                       vector, chunks, s);
  }
}
