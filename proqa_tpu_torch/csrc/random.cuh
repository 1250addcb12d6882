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

__device__ __forceinline__ uint32_t proqa_mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ bool proqa_keep(uint32_t k0, uint32_t k1, uint64_t n,
                                           uint32_t threshold) {
  const uint32_t bits =
      proqa_mix32(proqa_mix32(static_cast<uint32_t>(n) ^ k0) ^ static_cast<uint32_t>(n >> 32) ^ k1);
  return bits >= threshold;
}

// Dropout parameters as the wrappers pass them: `active` is 0 at rate 0
// (then nothing is drawn and nothing is scaled).
struct DropoutParams {
  uint32_t k0, k1, threshold;
  float inv_keep;  // 1 / (1 - rate), rounded to f32 as the plain versions round it
  int active;
};
