// K4: fused inverted dropout, one pass, mask regenerated rather than stored.
//
// Replaces proqa_tpu/ops/pallas_dropout.py:_kernel (launched by _call,
// pallas_dropout.py:41). y[n] = keep(n) ? x[n] * (1 / (1 - rate)) : 0, the
// product in f32 and rounded once to x's dtype (pallas_dropout.py:37). The
// backward is the same kernel on the cotangent with the same keys: dropout is
// linear given its mask, so nothing but the keys is saved.
//
// What bounds it on the H100: it reads x once and writes y once, one
// multiply a element: memory-bound, 2 * numel * sizeof(elem) bytes at the
// published 3.35 TB/s of the H100 SXM at 700 W (0.0376 ms at [80, 512,
// 768] bf16). The mask's hash, ~20 integer
// operations an element, comes second. What the design does about it: a
// grid of 8 blocks for each SM, each thread in a grid-stride loop over
// groups of kUnroll 16-byte vectors (8 bf16 or 4 f32 elements each), all
// loads of a group issued before any is used, so several lines are in
// flight per thread; a warp's loads and stores are whole 512-byte lines. A
// vector's elements have the counters n0 + o, n0 a multiple of the vector
// width and o below it, so the part of the hash they share is computed once
// (random.cuh:ProqaKeepRow, the identity the attention kernels use); the
// mask is the same function of (seed, element index) as proqa_keep's.
// Unaligned pointers take the element-at-a-time loop.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "random.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;  // 2,048 threads: a full SM
constexpr int kUnroll = 4;       // 16-byte vectors in flight per thread

__device__ inline float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ inline float to_f32(float x) { return x; }
__device__ inline void from_f32(bf16* p, float x) { *p = __float2bfloat16_rn(x); }
__device__ inline void from_f32(float* p, float x) { *p = x; }

__device__ inline float drop(float x, bool keep, float inv_keep) {
  return keep ? __fmul_rn(x, inv_keep) : 0.0f;
}

// The VEC elements of 16-byte vector i (element indices VEC i .. VEC i + VEC - 1).
template <typename Elem>
__device__ inline uint4 drop_vector(uint4 v, uint64_t i, const DropoutParams& d) {
  constexpr int VEC = 16 / sizeof(Elem);
  const ProqaKeepRow row(d.k0, d.k1, i * VEC);
  alignas(16) Elem e[VEC];
  *reinterpret_cast<uint4*>(e) = v;
#pragma unroll
  for (int o = 0; o < VEC; ++o)
    from_f32(e + o, drop(to_f32(e[o]), row.keep(o, d.threshold), d.inv_keep));
  return *reinterpret_cast<const uint4*>(e);
}

template <typename Elem>
__global__ void __launch_bounds__(kThreads)
dropout_vec_kernel(const uint4* __restrict__ x, uint4* __restrict__ y, uint64_t nvec,
                   DropoutParams d) {
  const uint64_t step = (uint64_t)gridDim.x * kThreads * kUnroll;
  for (uint64_t base = (uint64_t)blockIdx.x * kThreads * kUnroll + threadIdx.x; base < nvec;
       base += step) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const uint64_t i = base + (uint64_t)u * kThreads;
      if (i < nvec) v[u] = __ldcs(x + i);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const uint64_t i = base + (uint64_t)u * kThreads;
      if (i < nvec) y[i] = drop_vector<Elem>(v[u], i, d);
    }
  }
}

// Elements first .. n - 1 one at a time: the tail after the vectors, or
// all of an unaligned tensor.
template <typename Elem>
__global__ void __launch_bounds__(kThreads)
dropout_scalar_kernel(const Elem* __restrict__ x, Elem* __restrict__ y, uint64_t first,
                      uint64_t n, DropoutParams d) {
  const uint64_t stride = (uint64_t)gridDim.x * kThreads;
  for (uint64_t i = first + (uint64_t)blockIdx.x * kThreads + threadIdx.x; i < n; i += stride)
    from_f32(y + i, drop(to_f32(x[i]), proqa_keep(d.k0, d.k1, i, d.threshold), d.inv_keep));
}

int grid_for(uint64_t work, int per_block) {
  int device = 0, sms = 132;
  if (cudaGetDevice(&device) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const uint64_t blocks = (work + per_block - 1) / per_block;
  const uint64_t most = (uint64_t)sms * kBlocksPerSm;
  return (int)(blocks < most ? blocks : most);
}

template <typename Elem>
cudaError_t launch(const void* x, void* y, uint64_t n, DropoutParams d, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(Elem);
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) % 16) == 0;
  const uint64_t nvec = aligned ? n / kVec : 0;
  if (nvec > 0)
    dropout_vec_kernel<Elem><<<grid_for(nvec, kThreads * kUnroll), kThreads, 0, stream>>>(
        static_cast<const uint4*>(x), static_cast<uint4*>(y), nvec, d);
  if (nvec * kVec < n)
    dropout_scalar_kernel<Elem><<<grid_for(n - nvec * kVec, kThreads), kThreads, 0, stream>>>(
        static_cast<const Elem*>(x), static_cast<Elem*>(y), nvec * kVec, n, d);
  return cudaGetLastError();
}

}  // namespace

// x, y: n contiguous elements (bf16 when is_bf16, else f32; y may not alias
// x). The keys come from `seed` and the dropout masks' stream id 0
// (ops/dropout.py:STREAM) as ops/random.py:keys derives them, here rather
// than in Python to keep the host path short; threshold and 1/(1-rate) as
// ops/random.py computes them. Returns a cudaError_t code.
extern "C" int proqa_dropout(const void* x, void* y, long long n, uint64_t seed,
                             uint32_t threshold, float inv_keep, int is_bf16, void* stream) {
  if (n < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  DropoutParams d{0, 0, threshold, inv_keep, 1};
  proqa_keys(seed, 0, &d.k0, &d.k1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<bf16>(x, y, (uint64_t)n, d, s) : launch<float>(x, y, (uint64_t)n, d, s);
}
