// The second stage of the backward kernels' column sums (the bias gradient of
// F1, the scale and bias gradients of F2): out[c] = the sum over s of
// partials[s, c], for per-block f32 partials [slabs, cols]. A block takes 32
// columns side by side and 8 lanes of slabs; lane j adds slabs j, j + 8, ...
// in order, and lane 0 adds the 8 lane sums in order, so two launches on the
// same partials give the same bits (no atomics). The first stage fixes the
// slabs from the row count and the card alone, which makes the whole sum
// deterministic. Each kernel file wraps `sum_slabs` in a kernel of its own
// name, so that a trace tells F1's sums from F2's.
#pragma once

#include <cuda_runtime.h>

namespace column_sums {

constexpr int kCols = 32;   // columns a block takes
constexpr int kLanes = 8;   // slab lanes a column takes
constexpr int kThreads = kCols * kLanes;

// The body of the second stage, for a block of dim3(kCols, kLanes) threads.
__device__ inline void sum_slabs(const float* __restrict__ partials, float* __restrict__ out,
                                 int slabs, int cols) {
  __shared__ float lane_sums[kLanes][kCols];
  const int c = blockIdx.x * kCols + threadIdx.x;
  float sum = 0.0f;
  if (c < cols) {
#pragma unroll 4
    for (int s = threadIdx.y; s < slabs; s += kLanes)
      sum = __fadd_rn(sum, partials[(long long)s * cols + c]);
  }
  lane_sums[threadIdx.y][threadIdx.x] = sum;
  __syncthreads();
  if (threadIdx.y == 0 && c < cols) {
    float total = lane_sums[0][threadIdx.x];
#pragma unroll
    for (int j = 1; j < kLanes; ++j) total = __fadd_rn(total, lane_sums[j][threadIdx.x]);
    out[c] = total;
  }
}

inline dim3 grid(int cols) { return dim3((cols + kCols - 1) / kCols); }
inline dim3 block() { return dim3(kCols, kLanes); }

}  // namespace column_sums
