// K4: fused inverted dropout, one pass, mask regenerated rather than stored.
//
// Replaces proqa_tpu/ops/pallas_dropout.py:_kernel (launched by _call,
// pallas_dropout.py:41). y[n] = keep(n) ? x[n] * (1 / (1 - rate)) : 0, the
// product in f32 and rounded once to x's dtype (pallas_dropout.py:37). The
// backward is the same kernel on the cotangent with the same keys: dropout is
// linear given its mask, so nothing but the keys is saved.
//
// What bounds it on the H100: it reads x once and writes y once, one
// multiply a element: memory-bound, 2 * numel * sizeof(elem) bytes at
// 3.35 TB/s. What the design does about it: each thread moves 16 bytes at a
// time (8 bf16 or 4 f32 elements) in a grid-stride loop, so a warp's loads
// and stores are whole 512-byte lines; the mask costs two integer hashes per
// element (random.cuh) and no memory traffic. Unaligned pointers take the
// element-at-a-time loop.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "random.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

__device__ inline float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ inline float to_f32(float x) { return x; }
__device__ inline void from_f32(bf16* p, float x) { *p = __float2bfloat16_rn(x); }
__device__ inline void from_f32(float* p, float x) { *p = x; }

template <typename Elem>
__device__ inline void drop_one(const Elem* x, Elem* y, uint64_t n, const DropoutParams& d) {
  const float v = proqa_keep(d.k0, d.k1, n, d.threshold) ? __fmul_rn(to_f32(x[n]), d.inv_keep)
                                                          : 0.0f;
  from_f32(y + n, v);
}

// VEC elements (16 bytes) per thread per step; VEC == 1 for unaligned data.
template <typename Elem, int VEC>
__global__ void __launch_bounds__(kThreads)
dropout_kernel(const Elem* __restrict__ x, Elem* __restrict__ y, uint64_t n, DropoutParams d) {
  const uint64_t stride = (uint64_t)gridDim.x * kThreads;
  const uint64_t first = (uint64_t)blockIdx.x * kThreads + threadIdx.x;
  const uint64_t nvec = n / VEC;
  for (uint64_t i = first; i < nvec; i += stride) {
    if constexpr (VEC == 1) {
      drop_one(x, y, i, d);
    } else {
      alignas(16) Elem in[VEC];
      alignas(16) Elem out[VEC];
      *reinterpret_cast<uint4*>(in) = reinterpret_cast<const uint4*>(x)[i];
      for (int e = 0; e < VEC; ++e) {
        const uint64_t idx = i * VEC + e;
        const float v = proqa_keep(d.k0, d.k1, idx, d.threshold)
                            ? __fmul_rn(to_f32(in[e]), d.inv_keep) : 0.0f;
        from_f32(out + e, v);
      }
      reinterpret_cast<uint4*>(y)[i] = *reinterpret_cast<const uint4*>(out);
    }
  }
  for (uint64_t i = nvec * VEC + first; i < n; i += stride) drop_one(x, y, i, d);
}

template <typename Elem>
cudaError_t launch(const void* x, void* y, uint64_t n, DropoutParams d, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(Elem);
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) % 16) == 0;
  const uint64_t work = aligned ? n / kVec : n;
  const int blocks = (int)(work / kThreads + 1 < (uint64_t)kMaxBlocks ? work / kThreads + 1
                                                                      : kMaxBlocks);
  const Elem* xe = static_cast<const Elem*>(x);
  Elem* ye = static_cast<Elem*>(y);
  if (aligned)
    dropout_kernel<Elem, kVec><<<blocks, kThreads, 0, stream>>>(xe, ye, n, d);
  else
    dropout_kernel<Elem, 1><<<blocks, kThreads, 0, stream>>>(xe, ye, n, d);
  return cudaGetLastError();
}

}  // namespace

// x, y: n contiguous elements (bf16 when is_bf16, else f32; y may not alias
// x). Keys, threshold and 1/(1-rate) as ops/random.py computes them. Returns a
// cudaError_t code.
extern "C" int proqa_dropout(const void* x, void* y, long long n, uint32_t k0, uint32_t k1,
                             uint32_t threshold, float inv_keep, int is_bf16, void* stream) {
  if (n < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const DropoutParams d{k0, k1, threshold, inv_keep, 1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<bf16>(x, y, (uint64_t)n, d, s) : launch<float>(x, y, (uint64_t)n, d, s);
}
