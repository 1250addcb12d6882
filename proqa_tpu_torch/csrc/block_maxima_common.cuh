// What the two Hopper block-maxima kernels share: block_maxima_wgmma.cu (K1
// over bf16, K5 and K7 over int8 codes, K8 block-major) and
// block_maxima_f32.cu (K1 over f32). Both stream corpus chunks by TMA into a
// ring of shared-memory stages guarded by mbarriers, and both take the block
// maxima on registers, finishing them with exchanges of halves between lanes.
// gather_rescore.cu (K6/K9) feeds its ring with the 1D bulk copy and the same
// mbarriers.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (the encoder is found at run time)
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace bmax {

// Every search kernel (K1, K5, K7, K8, the simple body, K6/K9) takes the
// embedding widths that are multiples of this: a row of int8 codes is then
// whole 16-byte vectors, as TMA's global strides and the bulk copies need.
// ops/rescore.py:DIM_MULTIPLE holds the same rule.
constexpr int kDimMultiple = 16;

// ---------------------------------------------------------------------------
// TMA and mbarriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Arrives and announces `bytes` that TMA copies will complete on the barrier.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// Waits for the completion of the barrier's phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}
// One box of a tensor map, element (x, y) at its corner, into shared memory;
// completes `bytes` on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int x, int y,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar)
      : "memory");
}

// `bytes` (a multiple of 16) from global `src` to shared `dst`, both 16-byte
// aligned, as one 1D bulk copy (no tensor map); completes `bytes` on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// A warpgroup's register budget, moved to kRegs (setmaxnreg): a producer
// warpgroup gives most of its registers back so that the FMA or wgmma
// warpgroups can hold their accumulators without spilling.
template <bool kInc, int kRegs>
__device__ __forceinline__ void set_max_registers() {
  if constexpr (kInc)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
  else
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// cuTensorMapEncodeTiled, found through the runtime so that nothing links
// against the driver library
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// A row-major [rows, cols] tensor of `type` (elements of `bytes` bytes, rows
// cols * bytes apart, a multiple of 16) as TMA boxes of box_rows rows x
// box_cols columns with the 128-byte swizzle (box_cols * bytes == 128), boxes
// of 1024-byte-aligned stages: byte b of row r of a box lies at r * 128 +
// (b ^ (r % 8) * 16). Elements past either edge arrive as zeros, and a copy
// completes the whole box's bytes on its barrier all the same.
inline cudaError_t tile_map(CUtensorMap* map, CUtensorMapDataType type, int bytes,
                            const void* base, long long cols, long long rows, int box_cols,
                            int box_rows) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                                    cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult res = encode(map, type, 2, const_cast<void*>(base), dims, strides, box, steps,
                              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A corpus [n, 128] of `type` as boxes of 128 rows x 128 bytes (tile_map).
inline cudaError_t corpus_map(CUtensorMap* map, CUtensorMapDataType type, int bytes,
                              const void* corpus, int n) {
  return tile_map(map, type, bytes, corpus, 128, n, 128 / bytes, 128);
}

// ---------------------------------------------------------------------------
// Block maxima on registers
// ---------------------------------------------------------------------------

// An exchange of halves between a lane and its partner across `bit`: a lane
// whose `bit` is clear keeps values [0, K/2) and sends [K/2, K), its partner
// keeps the upper half; each kept value becomes the maximum over both lanes.
template <int K>
__device__ __forceinline__ void exchange_halves(const float (&v)[K], float (&w)[K / 2], bool upper,
                                                int bit) {
#pragma unroll
  for (int k = 0; k < K / 2; ++k) {
    const float send = upper ? v[k] : v[k + K / 2];
    const float keep = upper ? v[k + K / 2] : v[k];
    w[k] = fmaxf(keep, __shfl_xor_sync(0xffffffffu, send, bit));
  }
}

// A lane's run of N consecutive values as vector stores.
template <int N>
__device__ __forceinline__ void store_run(float* p, const float (&u)[N]) {
  if constexpr (N == 8) {
    *reinterpret_cast<float4*>(p) = make_float4(u[0], u[1], u[2], u[3]);
    *reinterpret_cast<float4*>(p + 4) = make_float4(u[4], u[5], u[6], u[7]);
  } else if constexpr (N == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(u[0], u[1], u[2], u[3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(u[0], u[1]);
  } else {
    *p = u[0];
  }
}

inline cudaError_t multiprocessors(int* sms) {
  int device = 0;
  const cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
}

}  // namespace bmax
