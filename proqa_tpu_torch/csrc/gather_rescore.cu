// K6 / K9: scores of each query's candidate corpus blocks, gathered in the
// kernel (the exact-MIPS rescore stage).
//
// Replaces proqa_tpu/ops/pallas_rescore.py:_kernel (K6, gather_rescore,
// launched by _gather_rescore_1 :151) and
// proqa_tpu/ops/pallas_gather_score.py:_kernel (K9, gather_score :53). The
// two TPU kernels are two layouts of one function,
//   out[q, j * block + b] = corpus[ids[q, j] * block + b] . queries[q]   (f32),
// for the kb candidate blocks of each query, so one kernel serves both. The
// TPU versions exist to stream the slabs instead of materializing the
// [Q, kb, block, D] gather; here too each candidate row is read from device
// memory once, dotted with its query in registers, and only the
// [Q, kb * block] f32 scores are written.
//
// What bounds it on the H100: bytes. Each row (256 bytes in bf16) is used by
// one query once, 2 * D = 256 FLOP per row, about one FLOP per byte, far
// below the ~295 where arithmetic would be the limit. Q = 2048, kb = 80,
// block = 16 reads 0.67 GB, 0.2 ms at 3.35 TB/s.
//
// What the design does about it: a CUDA block scores 128 candidate rows of
// one query. A row is read by 16 threads (bf16; 32 for f32), 16 bytes each,
// so a warp reads two or one whole 256-byte rows per load and the rows of a
// candidate block, which are contiguous, arrive as contiguous 4 KB (block =
// 16) runs. Each thread issues its loads for 8 rows before it does any
// arithmetic, to keep enough bytes in flight; the dot products reduce across
// the row's threads with warp shuffles. The query slice each thread needs is
// the same for every row, so it stays in registers.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDim = 128;          // embedding width the kernel takes
constexpr int kThreads = 256;
constexpr int kRowsPerCta = 128;   // candidate rows of one query per CUDA block
constexpr int kUnroll = 8;         // row loads in flight per thread
constexpr int kMaxGrid = 65535;

template <typename T>
__device__ void widen(const uint4& v, float* out) {
  if constexpr (sizeof(T) == 2) {
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&v);
    for (int i = 0; i < 8; ++i) out[i] = __bfloat162float(h[i]);
  } else {
    const float* f = reinterpret_cast<const float*>(&v);
    for (int i = 0; i < 4; ++i) out[i] = f[i];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_score_kernel(const T* __restrict__ queries, const T* __restrict__ corpus,
                    const int64_t* __restrict__ ids, float* __restrict__ out, int kb,
                    int block) {
  constexpr int kVec = 16 / sizeof(T);                // elements per 16-byte load
  constexpr int kLanes = kDim / kVec;                 // threads per row: 16 or 32
  constexpr int kRowsPerPass = kThreads / kLanes;     // rows per CUDA block per load
  constexpr int kPasses = kRowsPerCta / kRowsPerPass;
  static_assert(kPasses % kUnroll == 0, "whole unrolled steps");

  const int q = blockIdx.x;
  const int lane = threadIdx.x % kLanes, sub = threadIdx.x / kLanes;
  const int width = kb * block;
  const int64_t* qids = ids + (size_t)q * kb;
  float* qout = out + (size_t)q * width;

  float qv[kVec];
  widen<T>(*reinterpret_cast<const uint4*>(queries + (size_t)q * kDim + lane * kVec), qv);

  for (int p0 = 0; p0 < kPasses; p0 += kUnroll) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = blockIdx.y * kRowsPerCta + (p0 + u) * kRowsPerPass + sub;
      v[u] = make_uint4(0, 0, 0, 0);
      if (r < width) {
        const int64_t row = qids[r / block] * block + r % block;
        v[u] = *reinterpret_cast<const uint4*>(corpus + row * kDim + lane * kVec);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float c[kVec];
      widen<T>(v[u], c);
      float s = 0.0f;
      for (int i = 0; i < kVec; ++i) s = fmaf(c[i], qv[i], s);
      for (int off = kLanes / 2; off > 0; off /= 2) s += __shfl_xor_sync(0xffffffffu, s, off);
      const int r = blockIdx.y * kRowsPerCta + (p0 + u) * kRowsPerPass + sub;
      if (lane == 0 && r < width) qout[r] = s;
    }
  }
}

template <typename T>
cudaError_t launch(const void* queries, const void* corpus, const void* ids, void* out,
                   int num_q, int kb, int block, cudaStream_t stream) {
  const dim3 grid(num_q, (kb * block + kRowsPerCta - 1) / kRowsPerCta);
  gather_score_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(queries), static_cast<const T*>(corpus),
      static_cast<const int64_t*>(ids), static_cast<float*>(out), kb, block);
  return cudaGetLastError();
}

}  // namespace

// queries [num_q, dim] and corpus [nb * block, dim] (both bf16 when is_bf16,
// else f32, row-major, 16-byte aligned); ids [num_q, kb] int64, each in
// [0, nb); out [num_q, kb * block] f32. Returns a cudaError_t code.
extern "C" int proqa_gather_score(const void* queries, const void* corpus, const void* ids,
                                  void* out, int num_q, int nb, int kb, int block, int dim,
                                  int is_bf16, void* stream) {
  if (dim != kDim || num_q <= 0 || nb <= 0 || kb <= 0 || block <= 0 ||
      (long long)kb * block > (long long)kMaxGrid * kRowsPerCta)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(queries, corpus, ids, out, num_q, kb, block, s)
                 : launch<float>(queries, corpus, ids, out, num_q, kb, block, s);
}
