// The last step of the backward kernels' column sums (the bias gradient of
// F1, the scale and bias gradients of F2), inside the same launch and
// without atomics on the sums: each block of a set of `rows` blocks writes
// its f32 partial row of partials[rows, cols], takes a ticket of its group of
// kGroupRows rows, and the group's last block adds the group's rows in row
// order into the group's row of group_sums; the last group to finish adds the
// group rows in group order into the output. The order of every sum is fixed
// by `rows` alone, so two launches give the same bits, and the callers fix
// `rows` from the row count, the width and the card. Only the last blocks of
// a group wait for nothing: no block ever waits for another, so the grid
// needs no residency guarantee. Partials written by other blocks in this
// launch are read through L2 (ld.global.cg).
//
// The scratch both kernels take, one buffer a stream, laid out by `layout`:
// kTicketBytes of ticket counters, zero before a launch and left at zero by
// it (the kernels reset what they take), then the partials, then the group
// sums.
#pragma once

#include <cuda_runtime.h>

namespace column_sums {

constexpr int kThreads = 256;               // the blocks' size
constexpr int kGroupRows = 16;              // partial rows a group's last block adds
constexpr int kTicketBytes = 4096;          // 1,024 counters
constexpr int kLoadAhead = 8;               // rows add_rows loads before it adds

__host__ __device__ inline int groups(int rows) { return (rows + kGroupRows - 1) / kGroupRows; }

// The counters `sets` sets of `rows` blocks take: a group's, then the set's
__host__ __device__ inline int tickets(int sets, int rows) { return sets * (groups(rows) + 1); }

// The scratch's bytes for `sets` sets of `rows` blocks over `cols` columns
// in all (each set owns a range of them), or 0 where the counters do not fit
__host__ __device__ inline long long workspace_bytes(int sets, int rows, int cols) {
  if (tickets(sets, rows) * 4 > kTicketBytes) return 0;
  return kTicketBytes + (long long)(rows + groups(rows)) * cols * 4;
}

struct Layout {
  unsigned* tickets;
  float* partials;    // [rows, cols]
  float* group_sums;  // [groups(rows), cols]
};

__host__ __device__ inline Layout layout(void* workspace, int rows, int cols) {
  unsigned char* base = static_cast<unsigned char*>(workspace);
  float* partials = reinterpret_cast<float*>(base + kTicketBytes);
  return {reinterpret_cast<unsigned*>(base), partials, partials + (long long)rows * cols};
}

// dst[c] = the sum of rows 0 .. n - 1 of src (row stride `stride`) in row
// order, for c < cols. The loads of kLoadAhead rows are issued before any is
// added, 16 bytes each where the columns allow (cols and stride multiples of
// 4, 16-byte aligned rows): a thread takes 4 columns, kThreads * 4 apart.
__device__ inline void add_rows(const float* src, long long stride, int n, int cols,
                                float* dst) {
  const int tid = threadIdx.x + blockDim.x * threadIdx.y;
  if (cols % 4 == 0 && stride % 4 == 0) {
    for (int q = tid; q < cols / 4; q += kThreads) {
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int r0 = 0; r0 < n; r0 += kLoadAhead) {
        float4 v[kLoadAhead];
#pragma unroll
        for (int i = 0; i < kLoadAhead; ++i)
          if (r0 + i < n)
            v[i] = __ldcg(reinterpret_cast<const float4*>(src + (r0 + i) * stride) + q);
#pragma unroll
        for (int i = 0; i < kLoadAhead; ++i) {
          if (r0 + i < n) {
            acc.x = __fadd_rn(acc.x, v[i].x);
            acc.y = __fadd_rn(acc.y, v[i].y);
            acc.z = __fadd_rn(acc.z, v[i].z);
            acc.w = __fadd_rn(acc.w, v[i].w);
          }
        }
      }
      reinterpret_cast<float4*>(dst)[q] = acc;
    }
    return;
  }
  for (int c = tid; c < cols; c += kThreads) {
    float acc = 0.0f;
    for (int r0 = 0; r0 < n; r0 += kLoadAhead) {
      float v[kLoadAhead];
#pragma unroll
      for (int i = 0; i < kLoadAhead; ++i)
        if (r0 + i < n) v[i] = __ldcg(src + (r0 + i) * stride + c);
#pragma unroll
      for (int i = 0; i < kLoadAhead; ++i)
        if (r0 + i < n) acc = __fadd_rn(acc, v[i]);
    }
    dst[c] = acc;
  }
}

// Called by every thread of block `row` of a set of `rows` blocks once the
// block has written its row of partials (columns [0, cols) of a matrix of
// row stride `stride`); group_sums and out are the set's columns likewise;
// tickets: the set's groups(rows) + 1 counters. Returns in every block but
// the last, which has written out[0 .. cols).
__device__ inline void finish(const float* partials, float* group_sums, long long stride,
                              int rows, int cols, int row, unsigned* tickets, float* out) {
  __shared__ int last;
  const int tid = threadIdx.x + blockDim.x * threadIdx.y;
  const int g = row / kGroupRows, ngroups = groups(rows);
  const int in_group = rows - g * kGroupRows < kGroupRows ? rows - g * kGroupRows : kGroupRows;
  __threadfence();  // this block's partials before its ticket
  __syncthreads();
  if (tid == 0) last = atomicAdd(&tickets[g], 1u) == (unsigned)(in_group - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();  // the group's partials after the last ticket
  float* dst = ngroups == 1 ? out : group_sums + g * stride;
  add_rows(partials + (long long)g * kGroupRows * stride, stride, in_group, cols, dst);
  if (tid == 0) tickets[g] = 0;
  if (ngroups == 1) return;
  __threadfence();  // the group's sums before the set's ticket
  __syncthreads();
  if (tid == 0) last = atomicAdd(&tickets[ngroups], 1u) == (unsigned)(ngroups - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  add_rows(group_sums, stride, ngroups, cols, out);
  if (tid == 0) tickets[ngroups] = 0;
}

}  // namespace column_sums
