// K1, K5, K7 and K8: fused corpus scoring with block maxima, for exact MIPS.
// Every search path runs a Hopper kernel (ops/mips_kernel.py:kernel_for):
// block_maxima_wgmma.cu for bf16 queries (K1 over bf16, K5 and K7 over
// int8, K8 block-major over bf16) and block_maxima_f32.cu for K1 over f32.
// This simple body serves only what neither takes: K8 over f32, f32 queries
// over int8 codes, and blocks outside 16-256 or groups of group * block not
// a multiple of 128 rows (for K8, tile_n not a multiple of 128).
//
// Replaces the four block-max kernels of proqa_tpu/ops/pallas_mips.py:
//   K1 _bmax3_kernel (:83): for a tile of queries and one group of `group`
//      consecutive corpus blocks of `block` rows each, score every row
//      against every query in f32 and keep only the maximum of each block
//      (bmax3[cg, q, g]) and of the whole group (gmax[cg, 0, q]);
//   K5 _bmax3_kernel_scaled (:97): the same over an int8 corpus, each block
//      maximum multiplied by its block's f32 scale after the max-reduce and
//      before the group maximum (a per-block scale is constant inside the
//      reduce, so it commutes with the max: every emitted value is still an
//      achieved quantized score);
//   K7 _bmax3_kernel_bounded (:111): an int8 corpus with per-row scales; the
//      epilogue turns each raw block maximum m into the sign-aware bound
//      m >= 0 ? m * smax[b] : m * smin[b] (a heuristic bound, as in JAX);
//   K8 _bmax_kernel (:32): block maxima only, written block-major [NB, Q],
//      with no group level (block_maxima, pallas_mips.py:45).
// One kernel body serves all four: the corpus storage type is a template
// argument (int8 codes are widened in shared memory), the epilogue is a
// launch argument, and the output layout picks one of two kernel names
// (bmax3_kernel, bmax_block_major_kernel). The [Q, N] score matrix never
// reaches device memory.
//
// What bounds it on the H100: at the main path's shapes (Q = 2048, D = 128)
// each corpus row (256 bytes in bf16, 128 in int8) meets every query,
// 2 * Q * D = 512K FLOP per row, far above the ~295 FLOP per byte where device
// memory stops being the limit. So the kernel is bound by arithmetic: by
// tensor-core throughput in principle, and in this simple version by the
// shared-memory traffic that feeds wmma and by the score round trip through
// shared memory. The one large write is the block maxima, N / block * Q * 4
// bytes.
//
// What the design does about it: one CUDA block per (64-query tile, corpus
// group). The grid's fast axis is the query tile, so the CUDA blocks that read
// one group run at about the same time: the group comes from device memory
// about once and from L2 after that. bf16 inputs go through nvcuda::wmma
// (16x16x16 tiles, f32 accumulators). f32 inputs go through plain FMA, since
// the reference pins f32 scoring to full precision. int8 codes convert to the
// query type while they are copied to shared memory: integers of magnitude
// <= 256 are exact in bf16, so the products and their f32 sums are exact
// integer arithmetic times the query. Each 64-row chunk's scores land in
// shared memory and are reduced in 16-row segments. As block % 16 == 0, no
// segment straddles two blocks. The segments fold into a per-tile
// [64, group] block-max table, to which the epilogue is applied before it is
// written out. Every emitted maximum is the maximum of its own block's scores
// (times its scale), so the exactness argument of pallas_mips.py:295-298
// holds unchanged.
//
// Widths: the body above is built for D = 128 and whole groups. Every other
// width that is a multiple of 16 (no upper limit), and a last group cut
// short by n, runs bmax_sliced_kernel: the same tiles, each chunk's scores
// summed over 128-column slices (the query tile's slice copied in beside
// the chunk's when there is more than one), rows past n loaded as zeros.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "block_maxima_common.cuh"

namespace {

using namespace nvcuda;

constexpr int kDim = 128;               // embedding width the kernel takes
constexpr int kTileQ = 64;              // queries per CUDA block
constexpr int kChunk = 64;              // corpus rows scored per step
constexpr int kSeg = 16;                // rows per reduction segment
constexpr int kThreads = 256;
constexpr int kScoreLd = kTileQ + 4;    // f32 score row stride (wmma: % 4 == 0)
constexpr int kMaxGrid = 65535;

static_assert(kThreads == kTileQ * (kChunk / kSeg), "one thread per (segment, query)");

// Shared-memory row stride of a [rows, kDim] tile, in elements.
template <typename T> struct Layout;
// 272-byte rows: 16-byte aligned for vector stores, wmma ldm % 8 == 0.
template <> struct Layout<__nv_bfloat16> { static constexpr int ld = kDim + 8; };
// Odd stride: the FMA loop reads columns without bank conflicts.
template <> struct Layout<float> { static constexpr int ld = kDim + 1; };

// Copies the first `valid` rows of a row-major [*, kDim] array of S into a
// shared tile of T with `rows` rows, and zero-fills the rest. S is T, or int8
// codes widened to T.
template <typename T, typename S>
__device__ void load_rows(T* dst, const S* __restrict__ src, int rows, int valid) {
  constexpr int per_row = kDim * sizeof(S) / 16;   // 16-byte vectors per row
  constexpr int elems = 16 / sizeof(S);            // elements per vector
  constexpr int ld = Layout<T>::ld;
  for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
    const int r = i / per_row, c = (i % per_row) * elems;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < valid) v = *reinterpret_cast<const uint4*>(src + (size_t)r * kDim + c);
    T* out = dst + r * ld + c;
    if constexpr (std::is_same<S, T>::value && sizeof(T) == 2) {
      *reinterpret_cast<uint4*>(out) = v;
    } else if constexpr (std::is_same<S, T>::value) {
      const float* f = reinterpret_cast<const float*>(&v);
      for (int j = 0; j < 4; ++j) out[j] = f[j];
    } else if constexpr (sizeof(T) == 2) {  // 16 int8 codes -> 16 bf16, exact
      const int8_t* b = reinterpret_cast<const int8_t*>(&v);
      __align__(16) __nv_bfloat16 w[16];
      for (int j = 0; j < 16; ++j) w[j] = __float2bfloat16_rn(static_cast<float>(b[j]));
      reinterpret_cast<uint4*>(out)[0] = reinterpret_cast<const uint4*>(w)[0];
      reinterpret_cast<uint4*>(out)[1] = reinterpret_cast<const uint4*>(w)[1];
    } else {                                // 16 int8 codes -> 16 f32
      const int8_t* b = reinterpret_cast<const int8_t*>(&v);
      for (int j = 0; j < 16; ++j) out[j] = static_cast<float>(b[j]);
    }
  }
}

// ss[r][q] = dot(chunk row r, query q) in f32, for the 64 x 64 chunk tile.
__device__ void score_chunk(const __nv_bfloat16* qs, const __nv_bfloat16* cs, float* ss) {
  constexpr int ld = Layout<__nv_bfloat16>::ld;
  const int warp = threadIdx.x / 32;     // 8 warps: 4 row tiles x 2 pairs of query tiles
  const int tr = warp / 2, tc = (warp % 2) * 2;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.0f);
  wmma::fill_fragment(acc[1], 0.0f);
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
  for (int k = 0; k < kDim; k += 16) {
    wmma::load_matrix_sync(a, cs + tr * 16 * ld + k, ld);
    for (int j = 0; j < 2; ++j) {
      // B[k][q] = qs[q][k]: the query tile read column-major
      wmma::load_matrix_sync(b, qs + (tc + j) * 16 * ld + k, ld);
      wmma::mma_sync(acc[j], a, b, acc[j]);
    }
  }
  for (int j = 0; j < 2; ++j)
    wmma::store_matrix_sync(ss + tr * 16 * kScoreLd + (tc + j) * 16, acc[j], kScoreLd,
                            wmma::mem_row_major);
}

__device__ void score_chunk(const float* qs, const float* cs, float* ss) {
  constexpr int ld = Layout<float>::ld;
  const int tr = threadIdx.x / 16, tq = threadIdx.x % 16;  // rows 4*tr.., queries tq + 16*j
  float acc[4][4] = {};
  for (int d = 0; d < kDim; ++d) {
    float c[4], q[4];
    for (int i = 0; i < 4; ++i) c[i] = cs[(tr * 4 + i) * ld + d];
    for (int j = 0; j < 4; ++j) q[j] = qs[(tq + 16 * j) * ld + d];
    for (int i = 0; i < 4; ++i)
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(c[i], q[j], acc[i][j]);
  }
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) ss[(tr * 4 + i) * kScoreLd + tq + 16 * j] = acc[i][j];
}

template <typename T>
size_t smem_bytes(int group) {
  return (size_t)(kTileQ + kChunk) * Layout<T>::ld * sizeof(T)   // query tile, corpus chunk
         + (size_t)kChunk * kScoreLd * sizeof(float)              // chunk scores
         + (size_t)(kChunk / kSeg) * kTileQ * sizeof(float)       // segment maxima
         + (size_t)kTileQ * (group + 1) * sizeof(float);          // block-max table
}

// scale_a == nullptr: raw block maxima (K1, K8). scale_a only: times the
// block's scale (K5). Both: the sign-aware bound with smax = scale_a and
// smin = scale_b (K7). kBlockMajor: block-major output [NB, num_q] (K8);
// otherwise bmax3 [CG, num_q, group] and gmax [CG, 1, num_q].
template <typename T, typename S, bool kBlockMajor>
__device__ __forceinline__ void bmax_body(const T* __restrict__ queries,
                                          const S* __restrict__ corpus,
                                          const float* __restrict__ scale_a,
                                          const float* __restrict__ scale_b,
                                          float* __restrict__ bmax, float* __restrict__ gmax,
                                          int num_q, int block, int group) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int ld = Layout<T>::ld;
  T* qs = reinterpret_cast<T*>(smem);
  T* cs = qs + kTileQ * ld;
  float* ss = reinterpret_cast<float*>(cs + kChunk * ld);
  float* seg = ss + kChunk * kScoreLd;                 // [kChunk / kSeg][kTileQ]
  float* bm = seg + (kChunk / kSeg) * kTileQ;          // [kTileQ][group + 1]
  const int bm_ld = group + 1;                         // odd: conflict-free rows

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kTileQ;
  const int valid_q = min(kTileQ, num_q - q0);
  const size_t cg = blockIdx.y;
  const int rows = group * block;
  const S* group_rows = corpus + cg * rows * kDim;

  load_rows(qs, queries + (size_t)q0 * kDim, kTileQ, valid_q);
  for (int i = tid; i < kTileQ * bm_ld; i += kThreads) bm[i] = -INFINITY;

  for (int r0 = 0; r0 < rows; r0 += kChunk) {
    __syncthreads();  // the previous chunk's readers of cs, ss and seg are done
    load_rows(cs, group_rows + (size_t)r0 * kDim, kChunk, kChunk);
    __syncthreads();
    score_chunk(qs, cs, ss);
    __syncthreads();
    {
      const int q = tid % kTileQ, s = tid / kTileQ;
      const float* col = ss + s * kSeg * kScoreLd + q;
      float m = col[0];
      for (int i = 1; i < kSeg; ++i) m = fmaxf(m, col[i * kScoreLd]);
      seg[s * kTileQ + q] = m;
    }
    __syncthreads();
    if (tid < kTileQ) {
      for (int s = 0; s < kChunk / kSeg; ++s) {
        float* slot = bm + tid * bm_ld + (r0 + s * kSeg) / block;
        *slot = fmaxf(*slot, seg[s * kTileQ + tid]);
      }
    }
  }
  __syncthreads();
  if (scale_a != nullptr) {  // K5 / K7 epilogue, before the group maximum
    for (int i = tid; i < valid_q * group; i += kThreads) {
      const int q = i / group, g = i % group;
      const size_t b = cg * group + g;
      const float m = bm[q * bm_ld + g];
      bm[q * bm_ld + g] = (scale_b == nullptr || m >= 0.0f) ? m * scale_a[b] : m * scale_b[b];
    }
    __syncthreads();
  }
  if constexpr (kBlockMajor) {  // K8: block-major, consecutive queries side by side
    for (int i = tid; i < valid_q * group; i += kThreads) {
      const int g = i / valid_q, q = i % valid_q;
      bmax[(cg * group + g) * num_q + q0 + q] = bm[q * bm_ld + g];
    }
  } else {
    for (int i = tid; i < valid_q * group; i += kThreads) {
      const int q = i / group, g = i % group;
      bmax[(cg * num_q + q0 + q) * group + g] = bm[q * bm_ld + g];
    }
    if (tid < valid_q) {
      float m = -INFINITY;
      for (int g = 0; g < group; ++g) m = fmaxf(m, bm[tid * bm_ld + g]);
      gmax[cg * num_q + q0 + tid] = m;
    }
  }
}

// The grouped store (K1, K5, K7) and the block-major one (K8) as kernels of
// their own names, so that a profiler tells them apart.
template <typename T, typename S>
__global__ void __launch_bounds__(kThreads)
bmax3_kernel(const T* __restrict__ queries, const S* __restrict__ corpus,
             const float* __restrict__ scale_a, const float* __restrict__ scale_b,
             float* __restrict__ bmax, float* __restrict__ gmax, int num_q, int block,
             int group) {
  bmax_body<T, S, false>(queries, corpus, scale_a, scale_b, bmax, gmax, num_q, block, group);
}
template <typename T, typename S>
__global__ void __launch_bounds__(kThreads)
bmax_block_major_kernel(const T* __restrict__ queries, const S* __restrict__ corpus,
                        const float* __restrict__ scale_a, const float* __restrict__ scale_b,
                        float* __restrict__ bmax, float* __restrict__ gmax, int num_q,
                        int block, int group) {
  bmax_body<T, S, true>(queries, corpus, scale_a, scale_b, bmax, gmax, num_q, block, group);
}

template <typename T, typename S>
cudaError_t launch(const void* queries, const void* corpus, const void* scale_a,
                   const void* scale_b, void* bmax, void* gmax, int num_q, int n, int block,
                   int group, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(group);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  auto kernel = gmax == nullptr ? bmax_block_major_kernel<T, S> : bmax3_kernel<T, S>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((num_q + kTileQ - 1) / kTileQ, n / (group * block));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(queries), static_cast<const S*>(corpus),
      static_cast<const float*>(scale_a), static_cast<const float*>(scale_b),
      static_cast<float*>(bmax), static_cast<float*>(gmax), num_q, block, group);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Every other width, and a partial last group: the same body over slices
// ---------------------------------------------------------------------------

// Columns [c0, c0 + kDim) of rows [0, valid) of a row-major [*, dim] array
// of S (dim a multiple of 16) into a shared tile of T with `rows` rows, as
// load_rows stores them; zeros past `valid` rows and past column dim.
template <typename T, typename S>
__device__ void load_slice(T* dst, const S* __restrict__ src, int rows, int valid, int dim,
                           int c0) {
  constexpr int per_row = kDim * sizeof(S) / 16;
  constexpr int elems = 16 / sizeof(S);
  constexpr int ld = Layout<T>::ld;
  for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
    const int r = i / per_row, c = (i % per_row) * elems;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < valid && c0 + c < dim)
      v = *reinterpret_cast<const uint4*>(src + (size_t)r * dim + c0 + c);
    T* out = dst + r * ld + c;
    if constexpr (std::is_same<S, T>::value && sizeof(T) == 2) {
      *reinterpret_cast<uint4*>(out) = v;
    } else if constexpr (std::is_same<S, T>::value) {
      const float* f = reinterpret_cast<const float*>(&v);
      for (int j = 0; j < 4; ++j) out[j] = f[j];
    } else if constexpr (sizeof(T) == 2) {  // 16 int8 codes -> 16 bf16, exact
      const int8_t* b = reinterpret_cast<const int8_t*>(&v);
      __align__(16) __nv_bfloat16 w[16];
      for (int j = 0; j < 16; ++j) w[j] = __float2bfloat16_rn(static_cast<float>(b[j]));
      reinterpret_cast<uint4*>(out)[0] = reinterpret_cast<const uint4*>(w)[0];
      reinterpret_cast<uint4*>(out)[1] = reinterpret_cast<const uint4*>(w)[1];
    } else {                                // 16 int8 codes -> 16 f32
      const int8_t* b = reinterpret_cast<const int8_t*>(&v);
      for (int j = 0; j < 16; ++j) out[j] = static_cast<float>(b[j]);
    }
  }
}

// score_chunk split in three, so that a chunk's scores sum over its slices:
// the accumulators, one slice's products into them, and their store.
template <typename T>
struct SliceScores;
template <>
struct SliceScores<__nv_bfloat16> {
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  __device__ void zero() {
    wmma::fill_fragment(acc[0], 0.0f);
    wmma::fill_fragment(acc[1], 0.0f);
  }
  __device__ void add(const __nv_bfloat16* qs, const __nv_bfloat16* cs) {
    constexpr int ld = Layout<__nv_bfloat16>::ld;
    const int warp = threadIdx.x / 32;
    const int tr = warp / 2, tc = (warp % 2) * 2;
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
    for (int k = 0; k < kDim; k += 16) {
      wmma::load_matrix_sync(a, cs + tr * 16 * ld + k, ld);
      for (int j = 0; j < 2; ++j) {
        wmma::load_matrix_sync(b, qs + (tc + j) * 16 * ld + k, ld);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
  }
  __device__ void store(float* ss) const {
    const int warp = threadIdx.x / 32;
    const int tr = warp / 2, tc = (warp % 2) * 2;
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(ss + tr * 16 * kScoreLd + (tc + j) * 16, acc[j], kScoreLd,
                              wmma::mem_row_major);
  }
};
template <>
struct SliceScores<float> {
  float acc[4][4];
  __device__ void zero() {
    for (int i = 0; i < 4; ++i)
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  }
  __device__ void add(const float* qs, const float* cs) {
    constexpr int ld = Layout<float>::ld;
    const int tr = threadIdx.x / 16, tq = threadIdx.x % 16;
    for (int d = 0; d < kDim; ++d) {
      float c[4], q[4];
      for (int i = 0; i < 4; ++i) c[i] = cs[(tr * 4 + i) * ld + d];
      for (int j = 0; j < 4; ++j) q[j] = qs[(tq + 16 * j) * ld + d];
      for (int i = 0; i < 4; ++i)
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(c[i], q[j], acc[i][j]);
    }
  }
  __device__ void store(float* ss) const {
    const int tr = threadIdx.x / 16, tq = threadIdx.x % 16;
    for (int i = 0; i < 4; ++i)
      for (int j = 0; j < 4; ++j) ss[(tr * 4 + i) * kScoreLd + tq + 16 * j] = acc[i][j];
  }
};

// bmax_body at any width D (a multiple of 16) and any n (a multiple of
// block, the last group partial): a chunk's scores sum over ceil(D / 128)
// slices of 128 columns, each slice of the chunk and (with more than one)
// of the query tile copied in before its products; rows past n load as
// zeros, as zero padding rows would. The same sum order as bmax_body at
// D = 128.
template <typename T, typename S, bool kBlockMajor>
__global__ void __launch_bounds__(kThreads)
bmax_sliced_kernel(const T* __restrict__ queries, const S* __restrict__ corpus,
                   const float* __restrict__ scale_a, const float* __restrict__ scale_b,
                   float* __restrict__ bmax, float* __restrict__ gmax, int num_q, int n, int dim,
                   int block, int group) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int ld = Layout<T>::ld;
  T* qs = reinterpret_cast<T*>(smem);
  T* cs = qs + kTileQ * ld;
  float* ss = reinterpret_cast<float*>(cs + kChunk * ld);
  float* seg = ss + kChunk * kScoreLd;
  float* bm = seg + (kChunk / kSeg) * kTileQ;
  const int bm_ld = group + 1;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kTileQ;
  const int valid_q = min(kTileQ, num_q - q0);
  const size_t cg = blockIdx.y;
  const int rows = group * block;
  const long long first_row = (long long)cg * rows;
  const S* group_rows = corpus + first_row * dim;
  const T* tile = queries + (size_t)q0 * dim;
  const int slices = (dim + kDim - 1) / kDim;

  if (slices == 1) load_slice(qs, tile, kTileQ, valid_q, dim, 0);
  for (int i = tid; i < kTileQ * bm_ld; i += kThreads) bm[i] = -INFINITY;

  for (int r0 = 0; r0 < rows; r0 += kChunk) {
    const long long left = n - first_row - r0;
    const int valid = left < kChunk ? (left < 0 ? 0 : (int)left) : kChunk;
    SliceScores<T> sc;
    sc.zero();
    for (int sl = 0; sl < slices; ++sl) {
      __syncthreads();  // the previous readers of qs, cs, ss and seg are done
      if (slices > 1) load_slice(qs, tile, kTileQ, valid_q, dim, sl * kDim);
      load_slice(cs, group_rows + (size_t)r0 * dim, kChunk, valid, dim, sl * kDim);
      __syncthreads();
      sc.add(qs, cs);
    }
    sc.store(ss);
    __syncthreads();
    {
      const int q = tid % kTileQ, s = tid / kTileQ;
      const float* col = ss + s * kSeg * kScoreLd + q;
      float m = col[0];
      for (int i = 1; i < kSeg; ++i) m = fmaxf(m, col[i * kScoreLd]);
      seg[s * kTileQ + q] = m;
    }
    __syncthreads();
    if (tid < kTileQ) {
      for (int s = 0; s < kChunk / kSeg; ++s) {
        float* slot = bm + tid * bm_ld + (r0 + s * kSeg) / block;
        *slot = fmaxf(*slot, seg[s * kTileQ + tid]);
      }
    }
  }
  __syncthreads();
  if (scale_a != nullptr) {
    for (int i = tid; i < valid_q * group; i += kThreads) {
      const int q = i / group, g = i % group;
      const size_t b = cg * group + g;
      const float m = bm[q * bm_ld + g];
      bm[q * bm_ld + g] = (scale_b == nullptr || m >= 0.0f) ? m * scale_a[b] : m * scale_b[b];
    }
    __syncthreads();
  }
  if constexpr (kBlockMajor) {
    for (int i = tid; i < valid_q * group; i += kThreads) {
      const int g = i / valid_q, q = i % valid_q;
      bmax[(cg * group + g) * num_q + q0 + q] = bm[q * bm_ld + g];
    }
  } else {
    for (int i = tid; i < valid_q * group; i += kThreads) {
      const int q = i / group, g = i % group;
      bmax[(cg * num_q + q0 + q) * group + g] = bm[q * bm_ld + g];
    }
    if (tid < valid_q) {
      float m = -INFINITY;
      for (int g = 0; g < group; ++g) m = fmaxf(m, bm[tid * bm_ld + g]);
      gmax[cg * num_q + q0 + tid] = m;
    }
  }
}

template <typename T, typename S>
cudaError_t launch_sliced(const void* queries, const void* corpus, const void* scale_a,
                          const void* scale_b, void* bmax, void* gmax, int num_q, int n, int dim,
                          int block, int group, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(group);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  auto kernel = gmax == nullptr ? bmax_sliced_kernel<T, S, true> : bmax_sliced_kernel<T, S, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((num_q + kTileQ - 1) / kTileQ, (n + group * block - 1) / (group * block));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(queries), static_cast<const S*>(corpus),
      static_cast<const float*>(scale_a), static_cast<const float*>(scale_b),
      static_cast<float*>(bmax), static_cast<float*>(gmax), num_q, n, dim, block, group);
  return cudaGetLastError();
}

// The form a call takes: bmax_body where it was built for the shape (D =
// 128, whole groups), bmax_sliced_kernel else.
template <typename T, typename S>
cudaError_t launch_any(const void* queries, const void* corpus, const void* scale_a,
                       const void* scale_b, void* bmax, void* gmax, int num_q, int n, int dim,
                       int block, int group, cudaStream_t stream) {
  if (dim == kDim && n % (group * block) == 0)
    return launch<T, S>(queries, corpus, scale_a, scale_b, bmax, gmax, num_q, n, block, group,
                        stream);
  return launch_sliced<T, S>(queries, corpus, scale_a, scale_b, bmax, gmax, num_q, n, dim, block,
                             group, stream);
}

}  // namespace

// queries [num_q, dim] (bf16 when is_bf16, else f32) and corpus [n, dim] (int8
// codes when corpus_int8, else the queries' type), row-major and 16-byte
// aligned, dim a multiple of 16 and n of block. scale_a, scale_b: null, or
// f32 [CG * group] (see bmax3_kernel), CG = ceil(n / (group * block)). gmax
// null: bmax is [CG * group, num_q]; otherwise bmax is [CG, num_q, group] and
// gmax [CG, 1, num_q]. Returns a cudaError_t code.
extern "C" int proqa_block_maxima(const void* queries, const void* corpus, const void* scale_a,
                                  const void* scale_b, void* bmax, void* gmax, int num_q, int n,
                                  int dim, int block, int group, int is_bf16, int corpus_int8,
                                  void* stream) {
  if (dim <= 0 || dim % bmax::kDimMultiple != 0 || num_q <= 0 || n <= 0 || block <= 0 ||
      group <= 0 || block % kSeg != 0 || (group * block) % kChunk != 0 || n % block != 0 ||
      (n + group * block - 1) / (group * block) > kMaxGrid ||
      (scale_b != nullptr && scale_a == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return corpus_int8
        ? launch_any<__nv_bfloat16, int8_t>(queries, corpus, scale_a, scale_b, bmax, gmax, num_q,
                                            n, dim, block, group, s)
        : launch_any<__nv_bfloat16, __nv_bfloat16>(queries, corpus, scale_a, scale_b, bmax, gmax,
                                                   num_q, n, dim, block, group, s);
  return corpus_int8
      ? launch_any<float, int8_t>(queries, corpus, scale_a, scale_b, bmax, gmax, num_q, n, dim,
                                  block, group, s)
      : launch_any<float, float>(queries, corpus, scale_a, scale_b, bmax, gmax, num_q, n, dim,
                                 block, group, s);
}
