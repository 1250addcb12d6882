// Counter-based random bits shared by the dropout kernels (K2, K3, K4).
//
// The same function as proqa_tpu_torch/ops/random.py:bits, which computes it
// with torch integer ops, so each kernel and its plain version draw the same
// mask: element n of a tensor gets
//   bits(n) = mix32(mix32(lo32(n) ^ k0) ^ hi32(n) ^ k1)
// with (k0, k1) derived on the host from a 64-bit seed and a stream id
// (ops/random.py:keys). An element is kept where bits(n) >= threshold, so
// P(keep) = 1 - threshold / 2^32. Nothing is stored: a backward kernel
// regenerates the forward's mask from the same keys.
#pragma once

#include <cstdint>

// mix32 after its first step, x ^= x >> 16
__device__ __forceinline__ uint32_t proqa_mix32_tail(uint32_t x) {
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t proqa_mix32(uint32_t x) {
  return proqa_mix32_tail(x ^ (x >> 16));
}

__device__ __forceinline__ bool proqa_keep(uint32_t k0, uint32_t k1, uint64_t n,
                                           uint32_t threshold) {
  const uint32_t bits =
      proqa_mix32(proqa_mix32(static_cast<uint32_t>(n) ^ k0) ^ static_cast<uint32_t>(n >> 32) ^ k1);
  return bits >= threshold;
}

// proqa_keep of the counters n0 + o for offsets o < 2^16 whose set bits are
// clear in n0 (a thread's elements of one row of a 64-key tile), with what
// they share computed once: the addition carries nothing, so
// lo32(n0 + o) = lo32(n0) ^ o, hi32(n0 + o) = hi32(n0), and the first mix's
// x >> 16 is the same for all of them.
struct ProqaKeepRow {
  uint32_t x;  // lo32(n0) ^ k0 after the first mix's first step
  uint32_t y;  // hi32(n0) ^ k1

  __device__ __forceinline__ ProqaKeepRow(uint32_t k0, uint32_t k1, uint64_t n0) {
    const uint32_t v = static_cast<uint32_t>(n0) ^ k0;
    x = v ^ (v >> 16);
    y = static_cast<uint32_t>(n0 >> 32) ^ k1;
  }
  __device__ __forceinline__ bool keep(uint32_t o, uint32_t threshold) const {
    return proqa_mix32(proqa_mix32_tail(x ^ o) ^ y) >= threshold;
  }
};

// Dropout parameters as the wrappers pass them: `active` is 0 at rate 0
// (then nothing is drawn and nothing is scaled).
struct DropoutParams {
  uint32_t k0, k1, threshold;
  float inv_keep;  // 1 / (1 - rate), rounded to f32 as the plain versions round it
  int active;
};
