// Exactness checks of two shortcuts the attention kernels take, on the card.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//     -o attention_exactness attention_exactness.cu && ./attention_exactness
//
// 1. div_rn (attention_tiles.cuh) against __fdiv_rn on 8,589,934,592 pairs:
//    e in [0, 1) with an exponent drawn uniformly from the 127 binades below 1
//    (and e = 1 on one pair in 1,000), sum in [1, 1024), as the softmax gives
//    them. Every quotient in the normal range must be equal; subnormal ones
//    (probabilities under 2^-126) are counted apart.
// 2. ProqaKeepRow (random.cuh) against proqa_keep on 4,294,967,296 draws:
//    random keys and thresholds, tile-row counters n0 = 64 m + c over the
//    full 64-bit range, c in {0, 2, 4, 6}, offsets 8 n + e (n < 8, e < 2).
// Exits 1 when a normal quotient or a draw differs. Not part of the kernel
// library (_build.py compiles csrc/*.cu only).
#include <cstdio>

#include "../attention_tiles.cuh"
#include "../random.cuh"

namespace {

__device__ uint32_t scramble(uint32_t x) { return proqa_mix32(x + 0x9e3779b9u); }

__global__ void check_division(unsigned long long* counts, uint32_t round) {
  const uint32_t tid = blockIdx.x * blockDim.x + threadIdx.x;
  unsigned long long normal = 0, subnormal = 0;
  for (int it = 0; it < 64; ++it) {
    const uint32_t r1 = scramble(tid * 64 + it + round * 0x85ebca6bu), r2 = scramble(r1);
    const float e = r1 % 1000 == 0
                        ? 1.0f
                        : __uint_as_float((126u - (r1 >> 23) % 127u) << 23 | (r2 & 0x7fffffu));
    const float sum = __uint_as_float((127u + (r2 >> 23) % 10u) << 23 | (scramble(r2) & 0x7fffffu));
    const float want = __fdiv_rn(e, sum), got = attn::div_rn(e, sum, __frcp_rn(sum));
    if (__float_as_uint(want) != __float_as_uint(got)) {
      if (fabsf(want) < 1.17549435e-38f)
        ++subnormal;
      else
        ++normal;
    }
  }
  atomicAdd(counts, normal);
  atomicAdd(counts + 1, subnormal);
}

__global__ void check_keep_row(unsigned long long* count, uint32_t round) {
  const uint32_t tid = blockIdx.x * blockDim.x + threadIdx.x;
  const uint32_t r1 = scramble(tid ^ round * 0x9e3779b9u), r2 = scramble(r1 + 7);
  const uint32_t k0 = scramble(r2 + 11), k1 = scramble(k0 + 13), threshold = scramble(k1 + 17);
  const uint64_t n0 = ((uint64_t)r1 << 32 | r2) & ~63ull;
  const uint32_t c = 2 * (k0 % 4);
  const ProqaKeepRow row(k0, k1, n0 + c);
  unsigned long long differ = 0;
  for (int n = 0; n < 8; ++n)
    for (int e = 0; e < 2; ++e)
      differ += row.keep(8 * n + e, threshold) != proqa_keep(k0, k1, n0 + c + 8 * n + e, threshold);
  atomicAdd(count, differ);
}

}  // namespace

int main() {
  unsigned long long* d;
  unsigned long long h[3] = {};
  if (cudaMalloc(&d, sizeof(h)) != cudaSuccess) return 2;
  cudaMemset(d, 0, sizeof(h));
  for (uint32_t round = 0; round < 64; ++round) check_division<<<8192, 256>>>(d, round);
  for (uint32_t round = 0; round < 16; ++round) check_keep_row<<<65536, 256>>>(d + 2, round);
  const cudaError_t err = cudaMemcpy(h, d, sizeof(h), cudaMemcpyDeviceToHost);
  if (err != cudaSuccess) {
    printf("CUDA error: %s\n", cudaGetErrorString(err));
    return 2;
  }
  printf("div_rn vs __fdiv_rn: %llu pairs, %llu differ with a normal quotient, %llu with a "
         "subnormal one\n", 64ull * 8192 * 256 * 64, h[0], h[1]);
  printf("ProqaKeepRow vs proqa_keep: %llu draws, %llu differ\n", 16ull * 65536 * 256 * 16, h[2]);
  return h[0] == 0 && h[2] == 0 ? 0 : 1;
}
