// Tile helpers shared by the attention kernels K2 (attention_fwd.cu) and K3
// (attention_bwd.cu). A CUDA block of kThreads threads works on kRows rows
// of one (batch, head) slice; every [kRows, seq] score tile is f32 in shared
// memory. bf16 products use nvcuda::wmma (16x16x16, f32 accumulators); f32
// products use plain FMA, since the references pin f32 to full precision.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>

namespace attn {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kRows = 16;        // rows of a tile (query rows in K2)
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxSeq = 1024;
constexpr int kMaxGrid = 65535;
constexpr float kMaskBias = -1e30f;  // pallas_attention.py:32

__device__ inline float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ inline float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ inline void store(bf16* p, float x) { *p = __float2bfloat16_rn(x); }
__device__ inline void store(float* p, float x) { *p = x; }

// s[r][c] = a[r] . b[c] for the tile's kRows rows of `a` (row-major, DH wide,
// in device memory) and all `seq` rows of `b`.
template <int DH>
__device__ void score_rows(const bf16* a, const bf16* b, float* s, int s_ld, int seq) {
  const int warp = threadIdx.x / 32;
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[DH / 16];
  for (int d = 0; d < DH / 16; ++d) wmma::load_matrix_sync(fa[d], a + d * 16, DH);
  wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
  for (int kt = warp; kt < seq / 16; kt += kWarps) {
    wmma::fill_fragment(acc, 0.0f);
    for (int d = 0; d < DH / 16; ++d) {
      // B[d][c] = b[c][d]: the tile of b read column-major
      wmma::load_matrix_sync(fb, b + (size_t)kt * 16 * DH + d * 16, DH);
      wmma::mma_sync(acc, fa[d], fb, acc);
    }
    wmma::store_matrix_sync(s + kt * 16, acc, s_ld, wmma::mem_row_major);
  }
}

// f32 version; `as` holds the tile's kRows rows of `a` already in shared memory.
template <int DH>
__device__ void score_rows(const float* as, const float* b, float* s, int s_ld, int seq) {
  for (int c = threadIdx.x; c < seq; c += kThreads) {
    float acc[kRows] = {};
    const float* br = b + (size_t)c * DH;
    for (int d = 0; d < DH; ++d) {
      const float bv = br[d];
      for (int r = 0; r < kRows; ++r) acc[r] = fmaf(as[r * DH + d], bv, acc[r]);
    }
    for (int r = 0; r < kRows; ++r) s[r * s_ld + c] = acc[r];
  }
}

// o[r][d] = sum_c p[r][c] v[c][d] with f32 accumulation; p in shared memory,
// v [seq, DH] row-major in device memory.
template <int DH>
__device__ void weigh_values(const bf16* p, int p_ld, const bf16* v, float* o, int o_ld,
                             int seq) {
  const int warp = threadIdx.x / 32;
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
  for (int n = warp; n < DH / 16; n += kWarps) {
    wmma::fill_fragment(acc, 0.0f);
    for (int c = 0; c < seq; c += 16) {
      wmma::load_matrix_sync(fa, p + c, p_ld);
      wmma::load_matrix_sync(fb, v + (size_t)c * DH + n * 16, DH);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(o + n * 16, acc, o_ld, wmma::mem_row_major);
  }
}

template <int DH>
__device__ void weigh_values(const float* p, int p_ld, const float* v, float* o, int o_ld,
                             int seq) {
  for (int i = threadIdx.x; i < kRows * DH; i += kThreads) {
    const int r = i / DH, d = i % DH;
    float acc = 0.0f;
    for (int c = 0; c < seq; ++c) acc = fmaf(p[r * p_ld + c], v[(size_t)c * DH + d], acc);
    o[r * o_ld + d] = acc;
  }
}

// Copies the tile's kRows x DH rows of `a` into shared memory (f32 path).
template <int DH, typename Elem>
__device__ void stage_rows(const Elem* a, Elem* as) {
  for (int i = threadIdx.x; i < kRows * DH; i += kThreads) as[i] = a[i];
}

// Writes a [kRows][o_ld] f32 tile to kRows x DH rows of `out`, rounded.
template <int DH, typename Elem>
__device__ void write_rows(const float* o, int o_ld, Elem* out) {
  for (int i = threadIdx.x; i < kRows * DH; i += kThreads)
    store(out + i, o[(i / DH) * o_ld + i % DH]);
}

}  // namespace attn
