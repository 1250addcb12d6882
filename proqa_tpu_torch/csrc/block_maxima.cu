// K1: fused corpus scoring with block and group maxima, for exact MIPS.
//
// Replaces proqa_tpu/ops/pallas_mips.py:_bmax3_kernel (launched by
// block_maxima_grouped, pallas_mips.py:155). For a tile of queries and one
// group of `group` consecutive corpus blocks of `block` rows each, it scores
// every row against every query in f32 and keeps only the maximum of each
// block (bmax3[cg, q, g]) and of the whole group (gmax[cg, 0, q]). The [Q, N]
// score matrix never reaches device memory.
//
// What bounds it on the H100: at the main path's shapes (Q = 2048, D = 128)
// each 256-byte bf16 corpus row meets every query, 2 * Q * D = 512K FLOP per
// row, far above the ~295 FLOP per byte where device memory stops being the
// limit. So the kernel is bound by arithmetic: by tensor-core throughput in
// principle, and in this simple version by the shared-memory traffic that
// feeds wmma and by the score round trip through shared memory. The one large
// write is bmax3, N / block * Q * 4 bytes.
//
// What the design does about it: one CUDA block per (64-query tile, corpus
// group). The grid's fast axis is the query tile, so the CUDA blocks that read
// one group run at about the same time: the group comes from device memory
// about once and from L2 after that. bf16 inputs go through nvcuda::wmma
// (16x16x16 tiles, f32 accumulators). f32 inputs go through plain FMA, since
// the reference pins f32 scoring to full precision. Each 64-row chunk's scores
// land in shared memory and are reduced in 16-row segments. As block % 16 == 0,
// no segment straddles two blocks. The segments fold into a per-tile
// [64, group] block-max table, written out one contiguous row per query.
// Every emitted maximum is the maximum of its own block's scores, so the
// exactness argument of pallas_mips.py:295-298 holds unchanged.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

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

// Copies the first `valid` rows of a row-major [*, kDim] array into a shared
// tile of `rows` rows and zero-fills the rest.
template <typename T>
__device__ void load_rows(T* dst, const T* __restrict__ src, int rows, int valid) {
  constexpr int per_row = kDim * sizeof(T) / 16;   // 16-byte vectors per row
  constexpr int elems = 16 / sizeof(T);
  constexpr int ld = Layout<T>::ld;
  for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
    const int r = i / per_row, c = (i % per_row) * elems;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < valid) v = *reinterpret_cast<const uint4*>(src + (size_t)r * kDim + c);
    if constexpr (sizeof(T) == 2) {
      *reinterpret_cast<uint4*>(dst + r * ld + c) = v;
    } else {
      const float* f = reinterpret_cast<const float*>(&v);
      for (int j = 0; j < 4; ++j) dst[r * ld + c + j] = f[j];
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
bmax3_kernel(const T* __restrict__ queries, const T* __restrict__ corpus,
             float* __restrict__ bmax3, float* __restrict__ gmax,
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
  const T* group_rows = corpus + cg * rows * kDim;

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
  for (int i = tid; i < valid_q * group; i += kThreads) {
    const int q = i / group, g = i % group;
    bmax3[(cg * num_q + q0 + q) * group + g] = bm[q * bm_ld + g];
  }
  if (tid < valid_q) {
    float m = -INFINITY;
    for (int g = 0; g < group; ++g) m = fmaxf(m, bm[tid * bm_ld + g]);
    gmax[cg * num_q + q0 + tid] = m;
  }
}

template <typename T>
cudaError_t launch(const void* queries, const void* corpus, void* bmax3, void* gmax,
                   int num_q, int n, int block, int group, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(group);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      bmax3_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((num_q + kTileQ - 1) / kTileQ, n / (group * block));
  bmax3_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(queries), static_cast<const T*>(corpus),
      static_cast<float*>(bmax3), static_cast<float*>(gmax), num_q, block, group);
  return cudaGetLastError();
}

}  // namespace

// queries [num_q, dim], corpus [n, dim] (both bf16 when is_bf16, else f32,
// row-major, 16-byte aligned); bmax3 [n / (group * block), num_q, group] and
// gmax [n / (group * block), 1, num_q], f32. Returns a cudaError_t code.
extern "C" int proqa_block_maxima(const void* queries, const void* corpus, void* bmax3,
                                  void* gmax, int num_q, int n, int dim, int block,
                                  int group, int is_bf16, void* stream) {
  if (dim != kDim || num_q <= 0 || n <= 0 || block <= 0 || group <= 0 ||
      block % kSeg != 0 || (group * block) % kChunk != 0 || n % (group * block) != 0 ||
      n / (group * block) > kMaxGrid)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(queries, corpus, bmax3, gmax, num_q, n, block, group, s)
                 : launch<float>(queries, corpus, bmax3, gmax, num_q, n, block, group, s);
}
