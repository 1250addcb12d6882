// F2: residual add, LayerNorm and rounding in one pass, a warp a row.
//
// Replaces the XLA fusion of proqa_tpu/models/bert.py:137-144 (`_layer_norm`
// in f32 whatever the activation dtype) with the residual add before it at
// :277 and :286 (`x + attn`, `x + mlp` in the activation dtype), and the
// embedding LayerNorm at :241 (no residual). It is not a Pallas kernel: on
// the TPU XLA fuses the add, the two reductions and the affine map. The
// reference's numerics are kept: the sum f32(x) + f32(r) is rounded to the
// activation dtype first, as the activation-dtype add is; the mean, then the
// mean of squared deviations from it (two passes, as jnp.var; not
// E[x^2] - E[x]^2), each over the rounded row in f32; then
// ((s - mean) * rsqrt(var + eps)) * scale + bias in f32, each operation
// rounded on its own as the plain PyTorch chain's kernels round it
// (ops/fused_bert.py:add_layer_norm_reference), and one rounding to the
// activation dtype. Only the order of the two row sums differs from ATen's,
// so the output is within one ulp of the plain chain's.
//
// What bounds it on the H100: bytes. Two rows read and one written: 6 B an
// element in bf16 with a residual, 4 B without; 0.18 ms for [262,144, 768]
// bf16 with a residual at the published 3.35 TB/s of the H100 SXM at 700 W.
// The ~10 operations an element are far below the f32 rate. What the design
// does about it: a warp takes a row (H <= 1,024) and keeps it in registers
// after one read, so both passes and the output run without touching memory
// again; each lane loads 16-byte vectors (8 bf16 or 4 f32), a warp's loads
// whole 512-byte lines, all of a row's loads issued before any is used; the
// sums reduce by butterfly shuffles. Eight warps a block and eight blocks an
// SM keep 64 rows in flight an SM. Widths that are not a multiple of the
// vector, and unaligned pointers, take an element-at-a-time body.
//
// Rows wider than 1,024 (kMaxWidth; BERT-xlarge's 2,048, ALBERT-xxlarge's
// 4,096) take a block a row. Up to 8,192 (kRowWidth) each of its 256 threads
// holds its vectors t, t + 256, ... in registers, 8 to 32 floats, loaded
// once, and the two row sums meet in shared memory (block_sum: each warp's
// butterfly, then the 8 warp sums in order). Past 8,192 the stream form
// reads the row three times (the sum, the squared deviations, the output;
// again mostly from L2), so no width is too wide. The same rounding points
// in the same order; only the row sums' order differs again. The wrapper
// names the form (ops/fused_bert.py:layer_norm_form), and the entry point
// refuses any other.
//
// Training: the forward also writes each row's f32 mean and rsqrt(var + eps)
// when asked (8 B a row). The backward, `proqa_add_layer_norm_bwd`, is the
// transpose of the same fusion. It recomputes the rounded sum s = round(x + r)
// from x and the residual (bit-equal to the forward's; the model keeps both
// alive, where a saved s would cost the forward a store), and with
// x^ = (s - mean) * rstd and g = f32(dy) * scale it writes
// dx = round(rstd * (g - mean(g) - x^ * mean(g * x^))), the one gradient of
// both x and the residual (the add's backward), and the column sums
// dscale = sum of dy * x^ and dbias = sum of dy over the rows.
//
// What bounds the backward on the H100: bytes. dy, x and r read and dx
// written, 8 B an element in bf16 (6 B without a residual): 0.075 ms for
// [40,960, 768] at 3.35 TB/s; ~20 operations an element are far below the
// f32 rate. A warp a row with each lane carrying its columns' sums across
// its rows needs 48 sums a lane at width 768 and spills; a second launch for
// the sums costs a launch. What the design does about it:
//   - each reduction has its own owner. A block stages a tile of R rows of
//     dy, x and the residual (R = tile_rows: 8 at [*, 768] bf16) in shared
//     memory; warps take the tile's rows (the two row means by warp
//     reductions, one rounding of dx, 16-byte stores), then each thread adds
//     the tile's dy x^ and dy down its own h / 256 columns (3 at 768) in row
//     order. A thread carries 2 x 4 column sums, not 48;
//   - a ring of two stages: thread 0 copies each tile's three row blocks by
//     1D bulk copies (cp.async.bulk, completing on the stage's mbarrier, as
//     gather_rescore.cu's ring does), so the next tile arrives while this one
//     is reduced;
//   - the warps also leave each element's dy x^ in shared memory, so the
//     column pass reads two values an element and adds, nothing more;
//   - a persistent grid of two blocks an SM over fixed slabs of tiles;
//   - the column sums end in the same launch: each block writes its slab's
//     f32 partial row and takes a ticket; the last block of each group of 16
//     adds its group's rows in order, and the last group's the group sums
//     (column_sums.cuh). No block waits on another.
// The slabs and the order of every sum follow from the row count, the width,
// the dtype and the SM count alone, so two launches give the same bits. Odd
// widths and unaligned pointers stage the same tiles by plain loads: the
// same slabs and the same order of sums.
//
// Rows wider than 1,024 would leave a stage fewer than one tile's rows, and
// a thread h / 256 column sums of each gradient. Up to 4,096 (kBwdRowWidth)
// a block takes its slab's rows one at a time: its threads hold a row's
// vectors of dy, x and the residual in registers (the next row's loads in
// flight while this one is summed, where 32 bytes of each a thread allow),
// the two row means come from block_sum, and each thread adds the terms of
// its own columns, 8 or 16 of each gradient, in row order. Past 4,096 the
// stream form first sums each row of a sub-slab of 16 for its two means,
// then walks its columns down those rows, carrying the column sums from one
// sub-slab to the next in its row of the partials. Both end in the same
// ticketed column sums, over two blocks an SM at most one a row, so the
// order again follows from the row count and the card alone.
//
// The RMSNorm form (`proqa_add_rms_norm`, forward only) serves the pre-norm
// decoder (models/mistral.py): s = round(x + r) is written out as the next
// residual, and round((s * rsqrt(mean(s^2) + eps)) * scale) in f32, with no
// mean taken out and no bias, and the scale in the activation dtype (the
// decoder holds its weights in bf16). Bound by bytes as LayerNorm is: x and
// r read, the output and s written, 8 B an element in bf16 (0.32 ms for
// [32,256, 4,096] at 3.35 TB/s). LayerNorm's row layout, a block a row in
// registers, up to 8,192 (E5-Mistral's 4,096 among them); the one row sum
// meets in block_sum. No configuration has a wider decoder, so no streamed
// form is built: the entry point refuses wider rows.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

#include "block_maxima_common.cuh"  // mbarriers and the 1D bulk copy
#include "column_sums.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;  // rows a block holds at a time
constexpr int kBlocksPerSm = 8;        // 2,048 threads: a full SM
constexpr int kMaxWidth = 1024;        // 32 floats a lane

__device__ inline float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ inline float to_f32(float x) { return x; }
template <typename Elem>
__device__ inline Elem from_f32(float x);
template <>
__device__ inline bf16 from_f32<bf16>(float x) { return __float2bfloat16_rn(x); }
template <>
__device__ inline float from_f32<float>(float x) { return x; }

__device__ inline float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The rounded sum of x and the residual, as f32 (x alone without one).
template <typename Elem>
__device__ inline float rounded_sum(Elem x, const Elem* r, long long i) {
  return r == nullptr ? to_f32(x) : to_f32(from_f32<Elem>(__fadd_rn(to_f32(x), to_f32(r[i]))));
}

struct RowStats {
  float mean, rstd;
};

// The mean and rsqrt(var + eps) of a row whose elements the warp's lanes
// hold, `count` of them in v[0 .. count) (count may differ between lanes).
template <int kPer>
__device__ inline RowStats row_stats(const float (&v)[kPer], int count, float inv_h, float eps) {
  float sum = 0.0f;
#pragma unroll
  for (int j = 0; j < kPer; ++j)
    if (j < count) sum = __fadd_rn(sum, v[j]);
  const float mean = __fmul_rn(warp_sum(sum), inv_h);
  float sq = 0.0f;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if (j < count) {
      const float d = __fsub_rn(v[j], mean);
      sq = __fadd_rn(sq, __fmul_rn(d, d));
    }
  }
  const float var = __fmul_rn(warp_sum(sq), inv_h);
  return {mean, rsqrtf(__fadd_rn(var, eps))};
}

// x^ = (v - mean) * rstd, rounded as the forward rounds it
__device__ inline float normalized(float v, float mean, float rstd) {
  return __fmul_rn(__fsub_rn(v, mean), rstd);
}

__device__ inline float normalize(float v, RowStats s, float scale, float bias) {
  return __fadd_rn(__fmul_rn(normalized(v, s.mean, s.rstd), scale), bias);
}

// The row's mean and rstd for the backward, when asked (mean not null)
__device__ inline void save_stats(float* mean, float* rstd, long long row, RowStats s,
                                  int lane) {
  if (mean != nullptr && lane == 0) {
    mean[row] = s.mean;
    rstd[row] = s.rstd;
  }
}

// h % (16 / sizeof(Elem)) == 0, every row pointer 16-byte aligned: lane l
// holds the row's vectors l, l + 32, ..., kVecs of them at most.
template <typename Elem, int kVecs>
__global__ void __launch_bounds__(kThreads)
add_layer_norm_vec_kernel(const Elem* __restrict__ x, const Elem* __restrict__ r,
                          const float* __restrict__ scale, const float* __restrict__ bias,
                          Elem* __restrict__ out, float* __restrict__ mean,
                          float* __restrict__ rstd, long long rows, int h, float inv_h,
                          float eps) {
  constexpr int kVec = 16 / sizeof(Elem);
  constexpr int kPer = kVecs * kVec;
  const int lane = threadIdx.x & 31;
  const int nvec = h / kVec;
  // vectors this lane holds
  const int mine = nvec > lane ? (nvec - lane + 31) / 32 : 0;
  const int count = (mine < kVecs ? mine : kVecs) * kVec;
  const long long warps = (long long)gridDim.x * kWarps;
  for (long long row = (long long)blockIdx.x * kWarps + threadIdx.x / 32; row < rows;
       row += warps) {
    const uint4* xr = reinterpret_cast<const uint4*>(x + row * h);
    const uint4* rr = r == nullptr ? nullptr : reinterpret_cast<const uint4*>(r + row * h);
    uint4 xv[kVecs] = {}, rv[kVecs] = {};
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      const int i = lane + 32 * j;
      if (i < nvec) {
        xv[j] = __ldcs(xr + i);
        if (rr != nullptr) rv[j] = __ldcs(rr + i);
      }
    }
    float v[kPer];
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      alignas(16) Elem a[kVec], b[kVec];
      *reinterpret_cast<uint4*>(a) = xv[j];
      *reinterpret_cast<uint4*>(b) = rv[j];
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        v[j * kVec + e] = rr == nullptr
                              ? to_f32(a[e])
                              : to_f32(from_f32<Elem>(__fadd_rn(to_f32(a[e]), to_f32(b[e]))));
    }
    const RowStats s = row_stats<kPer>(v, count, inv_h, eps);
    save_stats(mean, rstd, row, s, lane);
    uint4* orow = reinterpret_cast<uint4*>(out + row * h);
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      const int i = lane + 32 * j;
      if (i < nvec) {
        const float4* sc = reinterpret_cast<const float4*>(scale + i * kVec);
        const float4* bi = reinterpret_cast<const float4*>(bias + i * kVec);
        alignas(16) float scv[kVec], biv[kVec];
#pragma unroll
        for (int q = 0; q < kVec / 4; ++q) {
          reinterpret_cast<float4*>(scv)[q] = __ldg(sc + q);
          reinterpret_cast<float4*>(biv)[q] = __ldg(bi + q);
        }
        alignas(16) Elem o[kVec];
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          o[e] = from_f32<Elem>(normalize(v[j * kVec + e], s, scv[e], biv[e]));
        orow[i] = *reinterpret_cast<const uint4*>(o);
      }
    }
  }
}

// Any width up to kMaxWidth, any alignment: lane l holds the row's elements
// l, l + 32, ... (32 at most).
template <typename Elem>
__global__ void __launch_bounds__(kThreads)
add_layer_norm_scalar_kernel(const Elem* __restrict__ x, const Elem* __restrict__ r,
                             const float* __restrict__ scale, const float* __restrict__ bias,
                             Elem* __restrict__ out, float* __restrict__ mean,
                             float* __restrict__ rstd, long long rows, int h, float inv_h,
                             float eps) {
  constexpr int kPer = kMaxWidth / 32;
  const int lane = threadIdx.x & 31;
  const int count = h > lane ? (h - lane + 31) / 32 : 0;
  const long long warps = (long long)gridDim.x * kWarps;
  for (long long row = (long long)blockIdx.x * kWarps + threadIdx.x / 32; row < rows;
       row += warps) {
    const long long base = row * h;
    float v[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int c = lane + 32 * j;
      v[j] = c < h ? rounded_sum<Elem>(x[base + c], r, base + c) : 0.0f;
    }
    const RowStats s = row_stats<kPer>(v, count, inv_h, eps);
    save_stats(mean, rstd, row, s, lane);
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int c = lane + 32 * j;
      if (c < h) out[base + c] = from_f32<Elem>(normalize(v[j], s, scale[c], bias[c]));
    }
  }
}

int grid_for(long long rows) {
  int device = 0, sms = 132;
  if (cudaGetDevice(&device) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long blocks = (rows + kWarps - 1) / kWarps;
  const long long most = (long long)sms * kBlocksPerSm;
  return (int)(blocks < most ? blocks : most);
}

template <typename Elem, int kVecs>
void launch_vec(const Elem* x, const Elem* r, const float* scale, const float* bias, Elem* out,
                float* mean, float* rstd, long long rows, int h, float inv_h, float eps,
                cudaStream_t stream) {
  add_layer_norm_vec_kernel<Elem, kVecs><<<grid_for(rows), kThreads, 0, stream>>>(
      x, r, scale, bias, out, mean, rstd, rows, h, inv_h, eps);
}

template <typename Elem>
cudaError_t launch(const void* xp, const void* rp, const float* scale, const float* bias,
                   void* outp, float* mean, float* rstd, long long rows, int h, float eps,
                   cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(Elem);
  const Elem* x = static_cast<const Elem*>(xp);
  const Elem* r = static_cast<const Elem*>(rp);
  Elem* out = static_cast<Elem*>(outp);
  const float inv_h = 1.0f / (float)h;
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(r) |
                         reinterpret_cast<uintptr_t>(out) | reinterpret_cast<uintptr_t>(scale) |
                         reinterpret_cast<uintptr_t>(bias)) % 16) == 0;
  if (!aligned || h % kVec != 0) {
    add_layer_norm_scalar_kernel<Elem><<<grid_for(rows), kThreads, 0, stream>>>(
        x, r, scale, bias, out, mean, rstd, rows, h, inv_h, eps);
    return cudaGetLastError();
  }
#define PROQA_LN_VEC(n) \
  launch_vec<Elem, n>(x, r, scale, bias, out, mean, rstd, rows, h, inv_h, eps, stream)
  switch ((h / kVec + 31) / 32) {  // vectors a lane holds
    case 1: PROQA_LN_VEC(1); break;
    case 2: PROQA_LN_VEC(2); break;
    case 3: PROQA_LN_VEC(3); break;
    case 4: PROQA_LN_VEC(4); break;
    case 5: PROQA_LN_VEC(5); break;
    case 6: PROQA_LN_VEC(6); break;
    case 7: PROQA_LN_VEC(7); break;
    default: PROQA_LN_VEC(8); break;
  }
#undef PROQA_LN_VEC
  return cudaGetLastError();
}

// --- the backward ---

constexpr int kBwdBlocksPerSm = 2;  // the backward's ring and products allow two blocks an SM
constexpr int kStages = 2;          // tiles in a block's ring
constexpr int kStageBytes = 40 * 1024;  // a tile's rows of dy, x and the residual
// the ring (each row block rounded up to 16 bytes), then the tile's f32
// products dy x^ (at most 4 / (3 * 2) of a stage, in bf16)
constexpr int kRingBytes = kStages * (kStageBytes + 48);
constexpr int kSharedBytes = kRingBytes + kStageBytes * 2 / 3 + 16;
constexpr int kMaxTileRows = 16;
constexpr int kMinTilesPerBlock = 2;  // where the rows allow: the ring has a tile in flight
constexpr int kColsPerThread = kMaxWidth / kThreads;  // column sums a thread owns
constexpr int kMaxDevices = 64;
static_assert(kThreads == column_sums::kThreads, "column_sums' block");

// The rows of the backward's tiles: as many as three rows (dy, x and the
// residual) of h elements of `elem` bytes fit in a stage, at most
// kMaxTileRows, a multiple of kWarps where that is at least kWarps.
int tile_rows(int h, int elem) {
  int rows = kStageBytes / (3 * h * elem);
  if (rows > kMaxTileRows) rows = kMaxTileRows;
  if (rows >= kWarps) rows -= rows % kWarps;
  return rows;
}

// The bytes one tensor's rows of a tile take in a stage, rounded up to 16
// (the bulk copy's alignment)
__host__ __device__ inline int row_block_bytes(int rows, int h, int elem) {
  return (rows * h * elem + 15) / 16 * 16;
}

__device__ inline uint32_t shared_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// kVec elements from shared memory as f32: one 16-byte load (kVec > 1), or
// one element
template <typename Elem, int kVec>
__device__ inline void load_vec(const Elem* p, float (&v)[kVec]) {
  if constexpr (kVec == 1) {
    v[0] = to_f32(*p);
  } else {
    alignas(16) Elem a[kVec];
    *reinterpret_cast<uint4*>(a) = *reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int e = 0; e < kVec; ++e) v[e] = to_f32(a[e]);
  }
}

// kVec f32 parameters, as float4 loads (kVec > 1) or one
template <int kVec>
__device__ inline void load_params(const float* p, float (&v)[kVec]) {
  if constexpr (kVec == 1) {
    v[0] = __ldg(p);
  } else {
#pragma unroll
    for (int q = 0; q < kVec / 4; ++q)
      reinterpret_cast<float4*>(v)[q] = __ldg(reinterpret_cast<const float4*>(p) + q);
  }
}

// kVec f32 values into shared memory: 16-byte stores, or one
template <int kVec>
__device__ inline void store_f32(float* p, const float (&v)[kVec]) {
  if constexpr (kVec == 1) {
    *p = v[0];
  } else {
#pragma unroll
    for (int q = 0; q < kVec / 4; ++q)
      reinterpret_cast<float4*>(p)[q] = reinterpret_cast<const float4*>(v)[q];
  }
}

// kVec values rounded to Elem into global memory: one 16-byte store, or one
template <typename Elem, int kVec>
__device__ inline void store_vec(Elem* p, const float (&v)[kVec]) {
  if constexpr (kVec == 1) {
    *p = from_f32<Elem>(v[0]);
  } else {
    alignas(16) Elem a[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) a[e] = from_f32<Elem>(v[e]);
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(a);
  }
}

// round(a + b) to Elem, as f32
template <typename Elem>
__device__ inline float rounded_add(float a, float b) {
  return to_f32(from_f32<Elem>(__fadd_rn(a, b)));
}

// rstd * (g - mean(g) - x^ * mean(g x^))
__device__ inline float input_grad(float g, float xh, float rstd, float mean_g, float mean_gx) {
  return __fmul_rn(rstd, __fsub_rn(__fsub_rn(g, mean_g), __fmul_rn(xh, mean_gx)));
}

// A tile's n rows (the first is row0), from the tile in shared memory (sr
// null without a residual): warp w takes the tile's rows w, w + kWarps, ...;
// lane l holds the row's vectors l, l + 32, ... of kVec elements, kVecs of
// them at most. It writes dx (when dx is not null) and, when prod is not
// null, the products dy x^ into prod [n, h] for the column sums.
template <typename Elem, int kVec, int kVecs>
__device__ inline void tile_rows_backward(const Elem* sdy, const Elem* sx, const Elem* sr,
                                          const float* __restrict__ mean,
                                          const float* __restrict__ rstd,
                                          const float* __restrict__ scale, Elem* __restrict__ dx,
                                          float* prod, long long row0, int n, int h,
                                          float inv_h) {
  constexpr int kPer = kVec * kVecs;
  const int lane = threadIdx.x & 31;
  const int nvec = h / kVec;
  for (int j = threadIdx.x / 32; j < n; j += kWarps) {
    const long long row = row0 + j;
    const float m = __ldg(mean + row), rs = __ldg(rstd + row);
    const Elem* dyj = sdy + j * h;
    const Elem* xj = sx + j * h;
    float xh[kPer], g[kPer], sum_g = 0.0f, sum_gx = 0.0f;
#pragma unroll
    for (int v = 0; v < kVecs; ++v) {
      const int i = lane + 32 * v;
      if (i < nvec) {
        float d[kVec], s[kVec];
        alignas(16) float sc[kVec];
        load_vec<Elem, kVec>(dyj + i * kVec, d);
        load_vec<Elem, kVec>(xj + i * kVec, s);
        if (sr != nullptr) {
          float b[kVec];
          load_vec<Elem, kVec>(sr + j * h + i * kVec, b);
#pragma unroll
          for (int e = 0; e < kVec; ++e) s[e] = rounded_add<Elem>(s[e], b[e]);
        }
        load_params<kVec>(scale + i * kVec, sc);
        alignas(16) float dxh[kVec];
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const int k = v * kVec + e;
          xh[k] = normalized(s[e], m, rs);
          g[k] = __fmul_rn(d[e], sc[e]);
          sum_g = __fadd_rn(sum_g, g[k]);
          sum_gx = __fadd_rn(sum_gx, __fmul_rn(g[k], xh[k]));
          dxh[e] = __fmul_rn(d[e], xh[k]);
        }
        if (prod != nullptr) store_f32<kVec>(prod + j * h + i * kVec, dxh);
      }
    }
    if (dx == nullptr) continue;
    const float mean_g = __fmul_rn(warp_sum(sum_g), inv_h);
    const float mean_gx = __fmul_rn(warp_sum(sum_gx), inv_h);
#pragma unroll
    for (int v = 0; v < kVecs; ++v) {
      const int i = lane + 32 * v;
      if (i < nvec) {
        float o[kVec];
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const int k = v * kVec + e;
          o[e] = input_grad(g[k], xh[k], rs, mean_g, mean_gx);
        }
        store_vec<Elem, kVec>(dx + row * h + i * kVec, o);
      }
    }
  }
}

// A tile's terms of the scale and bias gradients, added in row order to the
// thread's columns threadIdx.x + kThreads * k: ds += dy x^ (the products the
// rows' warps left in prod), db += dy.
template <typename Elem>
__device__ inline void tile_column_sums(const Elem* sdy, const float* prod, int n, int h,
                                        float (&ds)[kColsPerThread],
                                        float (&db)[kColsPerThread]) {
  for (int j = 0; j < n; ++j) {
#pragma unroll
    for (int k = 0; k < kColsPerThread; ++k) {
      const int c = threadIdx.x + kThreads * k;
      if (c < h) {
        ds[k] = __fadd_rn(ds[k], prod[j * h + c]);
        db[k] = __fadd_rn(db[k], to_f32(sdy[j * h + c]));
      }
    }
  }
}

// The backward. Block b takes the tiles [tiles * b / grid, tiles * (b + 1) /
// grid) of tile_rows(h) rows each, in order, through a ring of kStages
// stages in shared memory: kVec > 1 (h a multiple of the 16-byte vector,
// every pointer 16-byte aligned) copies a tile's rows of dy, x and the
// residual by one bulk copy each, thread 0 issuing the copies kStages tiles
// ahead; kVec = 1 stages the tile by plain loads into one stage. The rows'
// warps write dx (null when no input wants it) and, with kParams, the
// products dy x^ into shared memory; then each thread adds its columns'
// terms over the block's rows, the block writes them to its row of the
// partials [blocks, 2, h] in `workspace`, and the last blocks add the
// partials in block order into dparams [2, h] (column_sums.cuh).
template <typename Elem, int kVec, int kVecs, bool kParams>
__global__ void __launch_bounds__(kThreads, kBwdBlocksPerSm)
add_layer_norm_bwd_kernel(const Elem* __restrict__ dy, const Elem* __restrict__ x,
                          const Elem* __restrict__ r, const float* __restrict__ mean,
                          const float* __restrict__ rstd, const float* __restrict__ scale,
                          Elem* __restrict__ dx, void* workspace, float* dparams, long long rows,
                          int h, float inv_h, int tile) {
  constexpr bool kBulk = kVec > 1;
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t full[kStages];
  const int block_bytes = row_block_bytes(tile, h, (int)sizeof(Elem));
  const int stage_bytes = 3 * block_bytes;
  float* prod =
      kParams ? reinterpret_cast<float*>(ring + (kBulk ? kStages : 1) * stage_bytes) : nullptr;
  const long long tiles = (rows + tile - 1) / tile;
  const long long first = tiles * blockIdx.x / gridDim.x;
  const long long last = tiles * (blockIdx.x + 1) / gridDim.x;
  if constexpr (kBulk) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < kStages; ++s) bmax::mbar_init(shared_address(&full[s]), 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
  // thread 0: tile t's rows of dy, x (and the residual) into stage `stage`
  auto issue = [&](long long t, int stage) {
    const long long row0 = t * tile;
    const long long n = rows - row0 < tile ? rows - row0 : tile;
    const uint32_t bytes = (uint32_t)(n * h * (long long)sizeof(Elem));
    const uint32_t bar = shared_address(&full[stage]);
    const uint32_t dst = shared_address(ring + stage * stage_bytes);
    bmax::mbar_expect_tx(bar, bytes * (r != nullptr ? 3 : 2));
    bmax::bulk_load(dst, dy + row0 * h, bytes, bar);
    bmax::bulk_load(dst + block_bytes, x + row0 * h, bytes, bar);
    if (r != nullptr) bmax::bulk_load(dst + 2 * block_bytes, r + row0 * h, bytes, bar);
  };
  if (kBulk && threadIdx.x == 0)
    for (int s = 0; s < kStages && first + s < last; ++s) issue(first + s, s);

  float ds[kColsPerThread] = {}, db[kColsPerThread] = {};
  for (long long t = first; t < last; ++t) {
    const int i = (int)(t - first);
    const int stage = kBulk ? i % kStages : 0;
    const long long row0 = t * tile;
    const int n = (int)(rows - row0 < tile ? rows - row0 : tile);
    unsigned char* st = ring + stage * stage_bytes;
    const Elem* sdy = reinterpret_cast<const Elem*>(st);
    const Elem* sx = reinterpret_cast<const Elem*>(st + block_bytes);
    const Elem* sr = r == nullptr ? nullptr : reinterpret_cast<const Elem*>(st + 2 * block_bytes);
    if constexpr (kBulk) {
      bmax::mbar_wait(shared_address(&full[stage]), (i / kStages) & 1);
    } else {
      Elem* w = reinterpret_cast<Elem*>(st);
      const int stride = block_bytes / (int)sizeof(Elem);
      const long long at = row0 * h;
      for (int e = threadIdx.x; e < n * h; e += kThreads) {
        w[e] = dy[at + e];
        w[stride + e] = x[at + e];
        if (r != nullptr) w[2 * stride + e] = r[at + e];
      }
      __syncthreads();
    }
    tile_rows_backward<Elem, kVec, kVecs>(sdy, sx, sr, mean, rstd, scale, dx, prod, row0, n, h,
                                          inv_h);
    if constexpr (kParams) {
      __syncthreads();  // the products of every row
      tile_column_sums<Elem>(sdy, prod, n, h, ds, db);
    }
    __syncthreads();  // the stage and the products are read: free for the next tiles
    if (kBulk && threadIdx.x == 0 && t + kStages < last) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue(t + kStages, stage);
    }
  }
  if constexpr (kParams) {
    const column_sums::Layout ws = column_sums::layout(workspace, gridDim.x, 2 * h);
    float* mine = ws.partials + (long long)blockIdx.x * 2 * h;
#pragma unroll
    for (int k = 0; k < kColsPerThread; ++k) {
      const int c = threadIdx.x + kThreads * k;
      if (c < h) {
        mine[c] = ds[k];
        mine[h + c] = db[k];
      }
    }
    column_sums::finish(ws.partials, ws.group_sums, 2 * h, gridDim.x, 2 * h, blockIdx.x,
                        ws.tickets, dparams);
  }
}

// The SM count of `device`, read once a device
int sm_count(int device) {
  static int counts[kMaxDevices] = {};
  if (device >= 0 && device < kMaxDevices && counts[device] > 0) return counts[device];
  int sms = 132;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (device >= 0 && device < kMaxDevices) counts[device] = sms;
  return sms;
}

// The backward's blocks on `device`: one a kMinTilesPerBlock tiles of
// tile_rows(h, elem) rows, at most kBwdBlocksPerSm an SM (a persistent
// grid). The row count, the width, the dtype and the card alone fix them,
// and with them the order of the scale and bias gradients' sums.
int bwd_blocks(long long rows, int h, int elem, int device) {
  const int tile = tile_rows(h, elem);
  const long long rows_a_block = (long long)tile * kMinTilesPerBlock;
  const long long blocks = (rows + rows_a_block - 1) / rows_a_block;
  const long long most = (long long)sm_count(device) * kBwdBlocksPerSm;
  return blocks < 1 ? 1 : (int)(blocks < most ? blocks : most);
}

template <typename Elem, int kVec, int kVecs, bool kParams>
cudaError_t launch_bwd_kernel(const Elem* dy, const Elem* x, const Elem* r, const float* mean,
                              const float* rstd, const float* scale, Elem* dx, void* workspace,
                              float* dparams, long long rows, int h, int blocks, int device,
                              cudaStream_t stream) {
  const auto kernel = add_layer_norm_bwd_kernel<Elem, kVec, kVecs, kParams>;
  static bool allowed[kMaxDevices] = {};  // the ring's shared memory, once a device
  if (device < 0 || device >= kMaxDevices || !allowed[device]) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSharedBytes);
    if (err != cudaSuccess) return err;
    if (device >= 0 && device < kMaxDevices) allowed[device] = true;
  }
  const int tile = tile_rows(h, (int)sizeof(Elem));
  const int block_bytes = row_block_bytes(tile, h, (int)sizeof(Elem));
  const size_t smem = (size_t)(kVec > 1 ? kStages : 1) * 3 * block_bytes +
                      (kParams ? row_block_bytes(tile, h, 4) : 0);
  kernel<<<blocks, kThreads, smem, stream>>>(dy, x, r, mean, rstd, scale, dx, workspace, dparams,
                                             rows, h, 1.0f / (float)h, tile);
  return cudaGetLastError();
}

template <typename Elem, int kVec, int kVecs>
cudaError_t launch_bwd_body(const Elem* dy, const Elem* x, const Elem* r, const float* mean,
                            const float* rstd, const float* scale, Elem* dx, void* workspace,
                            float* dparams, long long rows, int h, int blocks, int device,
                            cudaStream_t stream) {
  return dparams != nullptr
             ? launch_bwd_kernel<Elem, kVec, kVecs, true>(dy, x, r, mean, rstd, scale, dx,
                                                          workspace, dparams, rows, h, blocks,
                                                          device, stream)
             : launch_bwd_kernel<Elem, kVec, kVecs, false>(dy, x, r, mean, rstd, scale, dx,
                                                           workspace, dparams, rows, h, blocks,
                                                           device, stream);
}

template <typename Elem>
cudaError_t launch_bwd(const void* dyp, const void* xp, const void* rp, const float* mean,
                       const float* rstd, const float* scale, void* dxp, void* workspace,
                       float* dparams, long long rows, int h, int blocks, int device,
                       cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(Elem);
  const Elem* dy = static_cast<const Elem*>(dyp);
  const Elem* x = static_cast<const Elem*>(xp);
  const Elem* r = static_cast<const Elem*>(rp);
  Elem* dx = static_cast<Elem*>(dxp);
  const bool aligned = ((reinterpret_cast<uintptr_t>(dy) | reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(r) | reinterpret_cast<uintptr_t>(dx) |
                         reinterpret_cast<uintptr_t>(scale)) % 16) == 0;
#define PROQA_LN_BWD(vec, n)                                                                  \
  return launch_bwd_body<Elem, vec, n>(dy, x, r, mean, rstd, scale, dx, workspace, dparams,  \
                                       rows, h, blocks, device, stream)
  if (!aligned || h % kVec != 0) PROQA_LN_BWD(1, kMaxWidth / 32);
  // vectors a lane holds: 1-4 in bf16 (3 at 768); in f32 an even count up to 8
  const int vecs = (h / kVec + 31) / 32;
  if constexpr (kVec == 8) {
    switch (vecs) {
      case 1: PROQA_LN_BWD(8, 1);
      case 2: PROQA_LN_BWD(8, 2);
      case 3: PROQA_LN_BWD(8, 3);
      default: PROQA_LN_BWD(8, 4);
    }
  } else {
    switch ((vecs + 1) / 2) {
      case 1: PROQA_LN_BWD(kVec, 2);
      case 2: PROQA_LN_BWD(kVec, 4);
      case 3: PROQA_LN_BWD(kVec, 6);
      default: PROQA_LN_BWD(kVec, 8);
    }
  }
#undef PROQA_LN_BWD
}

// --- rows wider than a warp holds: a block a row ---

constexpr int kRowWidth = 8192;     // forward: a block holds a row, 32 floats a thread
constexpr int kBwdRowWidth = 4096;  // backward: a block holds a row, 16 floats a thread
constexpr int kWideBwdBlocksPerSm = 2;
constexpr int kSubRows = 16;        // streamed backward: rows whose means a block keeps at once
constexpr int kUnrollStream = 4;    // streamed passes: vectors (or rows) loaded before any is used
static_assert(kUnrollStream == 4, "the streamed loops' #pragma unroll 4");

// The forms, as ops/fused_bert.py names them (LN_FORMS, LN_BWD_FORMS): the
// layout (a warp a row / the backward's tiles; a block a row in registers;
// a block a row streamed) times two, plus one for the element body
enum Layout { kWarp = 0, kRow = 1, kStream = 2 };
int form_of(int h, bool vector, bool backward) {
  const int layout = h <= kMaxWidth ? kWarp : h <= (backward ? kBwdRowWidth : kRowWidth) ? kRow
                                                                                        : kStream;
  return 2 * layout + (vector ? 0 : 1);
}

// The sum of every thread's v over the block: butterflies within the warps,
// then the kWarps warp sums in warp order, read by every thread. red: kWarps
// floats of shared memory; a block that calls this with two buffers in turn
// may call it again at once (each call's barrier orders the other buffer's
// reads before its next writes).
__device__ inline float block_sum(float v, float* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float s = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) s = __fadd_rn(s, red[w]);
  return s;
}

// kVec elements at p (one 16-byte load when kVec > 1)
template <typename Elem, int kVec>
__device__ inline void load_raw(const Elem* p, Elem (&a)[kVec]) {
  if constexpr (kVec == 1) {
    a[0] = *p;
  } else {
    *reinterpret_cast<uint4*>(a) = *reinterpret_cast<const uint4*>(p);
  }
}

// The rounded sums of x's and the residual's kVec elements (x's alone when
// there is no residual), as f32
template <typename Elem, int kVec>
__device__ inline void rounded_sums(const Elem (&a)[kVec], const Elem (&b)[kVec], bool residual,
                                    float (&v)[kVec]) {
#pragma unroll
  for (int e = 0; e < kVec; ++e)
    v[e] = residual ? rounded_add<Elem>(to_f32(a[e]), to_f32(b[e])) : to_f32(a[e]);
}

// The row's kVec rounded sums at element `at` (x alone without a residual)
template <typename Elem, int kVec>
__device__ inline void load_sums(const Elem* x, const Elem* r, long long at, float (&v)[kVec]) {
  alignas(16) Elem a[kVec], b[kVec];
  load_raw<Elem, kVec>(x + at, a);
  if (r != nullptr) load_raw<Elem, kVec>(r + at, b);
  rounded_sums<Elem, kVec>(a, b, r != nullptr, v);
}

// The row's mean and rstd from the block's sums (thread 0 saves them when
// asked), the two passes of row_stats with block_sum in place of warp_sum
__device__ inline RowStats finish_stats(float sq, float mean_v, float inv_h, float eps,
                                        float* red, float* mean, float* rstd, long long row) {
  const float var = __fmul_rn(block_sum(sq, red), inv_h);
  const RowStats s = {mean_v, rsqrtf(__fadd_rn(var, eps))};
  if (mean != nullptr && threadIdx.x == 0) {
    mean[row] = s.mean;
    rstd[row] = s.rstd;
  }
  return s;
}

// kMaxWidth < h <= kRowWidth: a block a row (the blocks walk the rows by a
// grid stride); thread t holds the row's vectors t, t + kThreads, ... of
// kVec elements (kVec = 1: elements), kVecs of them at most, loaded before
// any is used and kept in registers through both sums and the output.
template <typename Elem, int kVec, int kVecs>
__global__ void __launch_bounds__(kThreads)
add_layer_norm_row_kernel(const Elem* __restrict__ x, const Elem* __restrict__ r,
                          const float* __restrict__ scale, const float* __restrict__ bias,
                          Elem* __restrict__ out, float* __restrict__ mean,
                          float* __restrict__ rstd, long long rows, int h, float inv_h,
                          float eps) {
  constexpr int kPer = kVec * kVecs;
  __shared__ float red[2][kWarps];
  const int nvec = h / kVec;
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const long long base = row * h;
    alignas(16) Elem a[kVecs][kVec], b[kVecs][kVec];
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      const int i = threadIdx.x + kThreads * j;
      if (i < nvec) {
        load_raw<Elem, kVec>(x + base + (long long)i * kVec, a[j]);
        if (r != nullptr) load_raw<Elem, kVec>(r + base + (long long)i * kVec, b[j]);
      }
    }
    float v[kVecs][kVec], sum = 0.0f;
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      if (threadIdx.x + kThreads * j < nvec) {
        rounded_sums<Elem, kVec>(a[j], b[j], r != nullptr, v[j]);
#pragma unroll
        for (int e = 0; e < kVec; ++e) sum = __fadd_rn(sum, v[j][e]);
      }
    }
    const float m = __fmul_rn(block_sum(sum, red[0]), inv_h);
    float sq = 0.0f;
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      if (threadIdx.x + kThreads * j < nvec) {
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const float d = __fsub_rn(v[j][e], m);
          sq = __fadd_rn(sq, __fmul_rn(d, d));
        }
      }
    }
    const RowStats s = finish_stats(sq, m, inv_h, eps, red[1], mean, rstd, row);
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      const int i = threadIdx.x + kThreads * j;
      if (i < nvec) {
        alignas(16) float sc[kVec], bi[kVec], o[kVec];
        load_params<kVec>(scale + i * kVec, sc);
        load_params<kVec>(bias + i * kVec, bi);
#pragma unroll
        for (int e = 0; e < kVec; ++e) o[e] = normalize(v[j][e], s, sc[e], bi[e]);
        store_vec<Elem, kVec>(out + base + (long long)i * kVec, o);
      }
    }
  }
}

// h > kRowWidth: a block a row, the row read three times (its sum, its
// squared deviations, the output; the second and third reads mostly from
// L2), thread t taking vectors t, t + kThreads, ..., kUnrollStream loaded
// before any is used. No width is too wide.
template <typename Elem, int kVec>
__global__ void __launch_bounds__(kThreads)
add_layer_norm_stream_kernel(const Elem* __restrict__ x, const Elem* __restrict__ r,
                             const float* __restrict__ scale, const float* __restrict__ bias,
                             Elem* __restrict__ out, float* __restrict__ mean,
                             float* __restrict__ rstd, long long rows, int h, float inv_h,
                             float eps) {
  __shared__ float red[2][kWarps];
  const int nvec = h / kVec;
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const long long base = row * h;
    float sum = 0.0f;
#pragma unroll 4
    for (int i = threadIdx.x; i < nvec; i += kThreads) {
      float v[kVec];
      load_sums<Elem, kVec>(x, r, base + (long long)i * kVec, v);
#pragma unroll
      for (int e = 0; e < kVec; ++e) sum = __fadd_rn(sum, v[e]);
    }
    const float m = __fmul_rn(block_sum(sum, red[0]), inv_h);
    float sq = 0.0f;
#pragma unroll 4
    for (int i = threadIdx.x; i < nvec; i += kThreads) {
      float v[kVec];
      load_sums<Elem, kVec>(x, r, base + (long long)i * kVec, v);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float d = __fsub_rn(v[e], m);
        sq = __fadd_rn(sq, __fmul_rn(d, d));
      }
    }
    const RowStats s = finish_stats(sq, m, inv_h, eps, red[1], mean, rstd, row);
#pragma unroll 4
    for (int i = threadIdx.x; i < nvec; i += kThreads) {
      alignas(16) float v[kVec], sc[kVec], bi[kVec], o[kVec];
      load_sums<Elem, kVec>(x, r, base + (long long)i * kVec, v);
      load_params<kVec>(scale + i * kVec, sc);
      load_params<kVec>(bias + i * kVec, bi);
#pragma unroll
      for (int e = 0; e < kVec; ++e) o[e] = normalize(v[e], s, sc[e], bi[e]);
      store_vec<Elem, kVec>(out + base + (long long)i * kVec, o);
    }
  }
}

// The wide forms' grid: a block a row, up to what a grid holds
int row_grid(long long rows) { return (int)(rows < (1LL << 30) ? rows : (1LL << 30)); }

template <typename Elem>
cudaError_t launch_wide(const Elem* x, const Elem* r, const float* scale, const float* bias,
                        Elem* out, float* mean, float* rstd, long long rows, int h, float eps,
                        int form, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(Elem);
  const float inv_h = 1.0f / (float)h;
  const int grid = row_grid(rows);
#define PROQA_LN_ROW(vec, n)                                                             \
  add_layer_norm_row_kernel<Elem, vec, n><<<grid, kThreads, 0, stream>>>(x, r, scale, bias, \
                                                                       out, mean, rstd,   \
                                                                       rows, h, inv_h, eps)
  if (form == 2 * kRow + 1) {
    PROQA_LN_ROW(1, kRowWidth / kThreads);
  } else if (form == 2 * kRow) {
    // vectors a thread holds: 1-4 in bf16, 2-8 in f32 (8 to 32 elements)
    const int vecs = (h / kVec + kThreads - 1) / kThreads;
    if (vecs <= 8 / kVec) PROQA_LN_ROW(kVec, 8 / kVec);
    else if (vecs <= 16 / kVec) PROQA_LN_ROW(kVec, 16 / kVec);
    else PROQA_LN_ROW(kVec, 32 / kVec);
  } else if (form == 2 * kStream) {
    add_layer_norm_stream_kernel<Elem, kVec><<<grid, kThreads, 0, stream>>>(
        x, r, scale, bias, out, mean, rstd, rows, h, inv_h, eps);
  } else {
    add_layer_norm_stream_kernel<Elem, 1><<<grid, kThreads, 0, stream>>>(
        x, r, scale, bias, out, mean, rstd, rows, h, inv_h, eps);
  }
#undef PROQA_LN_ROW
  return cudaGetLastError();
}

// The wide backward's blocks on `device`: kWideBwdBlocksPerSm an SM, at
// most one a row. The row count and the card alone fix them, and with them
// the order of the scale and bias gradients' sums.
int wide_bwd_blocks(long long rows, int device) {
  const long long most = (long long)sm_count(device) * kWideBwdBlocksPerSm;
  return rows < 1 ? 1 : (int)(rows < most ? rows : most);
}

// The row's f32 sums of g = dy * scale and of g x^ (x^ = (s - mean) * rstd),
// and with kParams the terms of dscale (dy x^) and dbias (dy) at kVec
// columns, added to ds and db
template <typename Elem, int kVec, bool kParams>
__device__ inline void backward_terms(const Elem (&d)[kVec], const float (&s)[kVec],
                                      const float (&sc)[kVec], float m, float rs, float& sum_g,
                                      float& sum_gx, float (&ds)[kVec], float (&db)[kVec]) {
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    const float dy = to_f32(d[e]), xh = normalized(s[e], m, rs), g = __fmul_rn(dy, sc[e]);
    sum_g = __fadd_rn(sum_g, g);
    sum_gx = __fadd_rn(sum_gx, __fmul_rn(g, xh));
    if constexpr (kParams) {
      ds[e] = __fadd_rn(ds[e], __fmul_rn(dy, xh));
      db[e] = __fadd_rn(db[e], dy);
    }
  }
}

// dx at kVec columns of a row whose two means are known
template <typename Elem, int kVec>
__device__ inline void store_input_grad(Elem* p, const Elem (&d)[kVec], const float (&s)[kVec],
                                        const float (&sc)[kVec], float m, float rs, float mean_g,
                                        float mean_gx) {
  float o[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e)
    o[e] = input_grad(__fmul_rn(to_f32(d[e]), sc[e]), normalized(s[e], m, rs), rs, mean_g,
                      mean_gx);
  store_vec<Elem, kVec>(p, o);
}

// The block's row of partials [blocks, 2, h] for column_sums, then its finish
template <int kVec>
__device__ inline void write_partials(float* mine, int i, int h, const float (&ds)[kVec],
                                      const float (&db)[kVec]) {
  if constexpr (kVec == 1) {
    mine[i] = ds[0];
    mine[h + i] = db[0];
  } else {
    store_f32<kVec>(mine + i * kVec, ds);
    store_f32<kVec>(mine + h + i * kVec, db);
  }
}

// kMaxWidth < h <= kBwdRowWidth: block b takes the rows [rows * b / grid,
// rows * (b + 1) / grid) one at a time; thread t holds the row's vectors t,
// t + kThreads, ... (kVecs at most) of dy, x and the residual. With
// kPrefetch the next row's loads are issued before this row's sums. The
// two row means come from block_sum (only where dx is wanted); with kParams
// each thread adds its columns' terms in row order, writes them to the
// block's row of the partials [blocks, 2, h] in `workspace`, and the last
// blocks add the partials in block order into dparams (column_sums.cuh).
template <typename Elem, int kVec, int kVecs, bool kParams>
__global__ void __launch_bounds__(kThreads, kWideBwdBlocksPerSm)
add_layer_norm_bwd_row_kernel(const Elem* __restrict__ dy, const Elem* __restrict__ x,
                              const Elem* __restrict__ r, const float* __restrict__ mean,
                              const float* __restrict__ rstd, const float* __restrict__ scale,
                              Elem* __restrict__ dx, void* workspace, float* dparams,
                              long long rows, int h, float inv_h) {
  // the next row in registers where they allow: 16-byte loads of at most 32
  // bytes of each tensor a thread
  constexpr bool kPrefetch = kVec > 1 && kVec * kVecs * sizeof(Elem) <= 32;
  constexpr int kNext = kPrefetch ? kVecs : 1;
  __shared__ float red[2][kWarps];
  const int nvec = h / kVec;
  const long long first = rows * blockIdx.x / gridDim.x;
  const long long last = rows * (blockIdx.x + 1) / gridDim.x;
  alignas(16) float ds[kVecs][kVec] = {}, db[kVecs][kVec] = {};
  alignas(16) Elem d[kVecs][kVec], a[kVecs][kVec], b[kVecs][kVec];
  alignas(16) Elem nd[kNext][kVec], na[kNext][kVec], nb[kNext][kVec];
  auto load = [&](long long row, Elem (&pd)[kVecs][kVec], Elem (&pa)[kVecs][kVec],
                  Elem (&pb)[kVecs][kVec]) {
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      const int i = threadIdx.x + kThreads * j;
      if (i < nvec) {
        const long long at = row * h + (long long)i * kVec;
        load_raw<Elem, kVec>(dy + at, pd[j]);
        load_raw<Elem, kVec>(x + at, pa[j]);
        if (r != nullptr) load_raw<Elem, kVec>(r + at, pb[j]);
      }
    }
  };
  if (first < last) load(first, d, a, b);
  for (long long row = first; row < last; ++row) {
    if constexpr (kPrefetch) {
      if (row + 1 < last) load(row + 1, nd, na, nb);
    }
    const float m = __ldg(mean + row), rs = __ldg(rstd + row);
    float sum_g = 0.0f, sum_gx = 0.0f;
    // the rounded sums and the scale are made again for dx, not kept
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      const int i = threadIdx.x + kThreads * j;
      if (i < nvec) {
        float s[kVec];
        alignas(16) float sc[kVec];
        rounded_sums<Elem, kVec>(a[j], b[j], r != nullptr, s);
        load_params<kVec>(scale + i * kVec, sc);
        backward_terms<Elem, kVec, kParams>(d[j], s, sc, m, rs, sum_g, sum_gx, ds[j], db[j]);
      }
    }
    if (dx != nullptr) {
      const float mean_g = __fmul_rn(block_sum(sum_g, red[0]), inv_h);
      const float mean_gx = __fmul_rn(block_sum(sum_gx, red[1]), inv_h);
#pragma unroll
      for (int j = 0; j < kVecs; ++j) {
        const int i = threadIdx.x + kThreads * j;
        if (i < nvec) {
          float s[kVec];
          alignas(16) float sc[kVec];
          rounded_sums<Elem, kVec>(a[j], b[j], r != nullptr, s);
          load_params<kVec>(scale + i * kVec, sc);
          store_input_grad<Elem, kVec>(dx + row * h + (long long)i * kVec, d[j], s, sc, m, rs,
                                       mean_g, mean_gx);
        }
      }
    }
    if constexpr (kPrefetch) {
#pragma unroll
      for (int j = 0; j < kVecs; ++j) {
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          d[j][e] = nd[j][e];
          a[j][e] = na[j][e];
          b[j][e] = nb[j][e];
        }
      }
    } else if (row + 1 < last) {
      load(row + 1, d, a, b);
    }
  }
  if constexpr (kParams) {
    const column_sums::Layout ws = column_sums::layout(workspace, gridDim.x, 2 * h);
    float* mine = ws.partials + (long long)blockIdx.x * 2 * h;
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      const int i = threadIdx.x + kThreads * j;
      if (i < nvec) write_partials<kVec>(mine, i, h, ds[j], db[j]);
    }
    column_sums::finish(ws.partials, ws.group_sums, 2 * h, gridDim.x, 2 * h, blockIdx.x,
                        ws.tickets, dparams);
  }
}

// h > kBwdRowWidth: block b takes the same rows as above, kSubRows at a
// time. Where dx is wanted, a first pass over each row gives its two means
// (block_sum); then thread t walks its vectors t, t + kThreads, ... and for
// each the sub-slab's rows in order (kUnrollStream rows' loads at a time):
// dx, and with kParams its columns' terms of dscale and dbias, carried from
// one sub-slab to the next in the block's row of the partials. No width is
// too wide.
template <typename Elem, int kVec, bool kParams>
__global__ void __launch_bounds__(kThreads, kWideBwdBlocksPerSm)
add_layer_norm_bwd_stream_kernel(const Elem* __restrict__ dy, const Elem* __restrict__ x,
                                 const Elem* __restrict__ r, const float* __restrict__ mean,
                                 const float* __restrict__ rstd, const float* __restrict__ scale,
                                 Elem* __restrict__ dx, void* workspace, float* dparams,
                                 long long rows, int h, float inv_h) {
  __shared__ float red[2][kWarps];
  __shared__ float4 stats[kSubRows];  // mean, rstd, mean(g), mean(g x^) of the sub-slab's rows
  const int nvec = h / kVec;
  const long long first = rows * blockIdx.x / gridDim.x;
  const long long last = rows * (blockIdx.x + 1) / gridDim.x;
  float* mine = nullptr;
  column_sums::Layout ws{};
  if constexpr (kParams) {
    ws = column_sums::layout(workspace, gridDim.x, 2 * h);
    mine = ws.partials + (long long)blockIdx.x * 2 * h;
  }
  for (long long r0 = first; r0 < last; r0 += kSubRows) {
    const int n = (int)(last - r0 < kSubRows ? last - r0 : kSubRows);
    if (threadIdx.x < n)
      stats[threadIdx.x] = make_float4(__ldg(mean + r0 + threadIdx.x),
                                       __ldg(rstd + r0 + threadIdx.x), 0.0f, 0.0f);
    __syncthreads();
    if (dx != nullptr) {
      for (int k = 0; k < n; ++k) {
        const long long base = (r0 + k) * h;
        const float m = stats[k].x, rs = stats[k].y;
        float sum_g = 0.0f, sum_gx = 0.0f;
#pragma unroll 4
        for (int i = threadIdx.x; i < nvec; i += kThreads) {
          alignas(16) Elem d[kVec];
          alignas(16) float s[kVec], sc[kVec], unused[kVec];
          load_raw<Elem, kVec>(dy + base + (long long)i * kVec, d);
          load_sums<Elem, kVec>(x, r, base + (long long)i * kVec, s);
          load_params<kVec>(scale + i * kVec, sc);
          backward_terms<Elem, kVec, false>(d, s, sc, m, rs, sum_g, sum_gx, unused, unused);
        }
        const float mean_g = __fmul_rn(block_sum(sum_g, red[0]), inv_h);
        const float mean_gx = __fmul_rn(block_sum(sum_gx, red[1]), inv_h);
        if (threadIdx.x == 0) {
          stats[k].z = mean_g;
          stats[k].w = mean_gx;
        }
      }
      __syncthreads();
    }
    for (int i = threadIdx.x; i < nvec; i += kThreads) {
      alignas(16) float ds[kVec] = {}, db[kVec] = {}, sc[kVec];
      if (kParams && r0 != first) {  // this thread's sums of the earlier sub-slabs
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          ds[e] = mine[i * kVec + e];
          db[e] = mine[h + i * kVec + e];
        }
      }
      load_params<kVec>(scale + i * kVec, sc);
      for (int k0 = 0; k0 < n; k0 += kUnrollStream) {
        alignas(16) Elem d[kUnrollStream][kVec];
        float s[kUnrollStream][kVec];
#pragma unroll
        for (int u = 0; u < kUnrollStream; ++u) {
          if (k0 + u < n) {
            const long long at = (r0 + k0 + u) * h + (long long)i * kVec;
            load_raw<Elem, kVec>(dy + at, d[u]);
            load_sums<Elem, kVec>(x, r, at, s[u]);
          }
        }
#pragma unroll
        for (int u = 0; u < kUnrollStream; ++u) {
          if (k0 + u >= n) break;
          const float4 st = stats[k0 + u];
          float unused_g = 0.0f, unused_gx = 0.0f;
          backward_terms<Elem, kVec, kParams>(d[u], s[u], sc, st.x, st.y, unused_g, unused_gx,
                                              ds, db);
          if (dx != nullptr)
            store_input_grad<Elem, kVec>(dx + (r0 + k0 + u) * h + (long long)i * kVec, d[u],
                                         s[u], sc, st.x, st.y, st.z, st.w);
        }
      }
      if constexpr (kParams) write_partials<kVec>(mine, i, h, ds, db);
    }
    __syncthreads();  // the sub-slab's stats are read: free for the next
  }
  if constexpr (kParams) {
    if (first == last)  // no rows: a zero partial row
      for (int c = threadIdx.x; c < 2 * h; c += kThreads) mine[c] = 0.0f;
    column_sums::finish(ws.partials, ws.group_sums, 2 * h, gridDim.x, 2 * h, blockIdx.x,
                        ws.tickets, dparams);
  }
}

template <typename Elem, int kVec, int kVecs>
cudaError_t launch_bwd_row(const Elem* dy, const Elem* x, const Elem* r, const float* mean,
                           const float* rstd, const float* scale, Elem* dx, void* workspace,
                           float* dparams, long long rows, int h, int blocks,
                           cudaStream_t stream) {
  const float inv_h = 1.0f / (float)h;
  if (dparams != nullptr)
    add_layer_norm_bwd_row_kernel<Elem, kVec, kVecs, true><<<blocks, kThreads, 0, stream>>>(
        dy, x, r, mean, rstd, scale, dx, workspace, dparams, rows, h, inv_h);
  else
    add_layer_norm_bwd_row_kernel<Elem, kVec, kVecs, false><<<blocks, kThreads, 0, stream>>>(
        dy, x, r, mean, rstd, scale, dx, workspace, dparams, rows, h, inv_h);
  return cudaGetLastError();
}

template <typename Elem, int kVec>
cudaError_t launch_bwd_stream(const Elem* dy, const Elem* x, const Elem* r, const float* mean,
                              const float* rstd, const float* scale, Elem* dx, void* workspace,
                              float* dparams, long long rows, int h, int blocks,
                              cudaStream_t stream) {
  const float inv_h = 1.0f / (float)h;
  if (dparams != nullptr)
    add_layer_norm_bwd_stream_kernel<Elem, kVec, true><<<blocks, kThreads, 0, stream>>>(
        dy, x, r, mean, rstd, scale, dx, workspace, dparams, rows, h, inv_h);
  else
    add_layer_norm_bwd_stream_kernel<Elem, kVec, false><<<blocks, kThreads, 0, stream>>>(
        dy, x, r, mean, rstd, scale, dx, workspace, dparams, rows, h, inv_h);
  return cudaGetLastError();
}

template <typename Elem>
cudaError_t launch_bwd_wide(const Elem* dy, const Elem* x, const Elem* r, const float* mean,
                            const float* rstd, const float* scale, Elem* dx, void* workspace,
                            float* dparams, long long rows, int h, int form, int blocks,
                            cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(Elem);
#define PROQA_LN_BWD_WIDE(kind, ...)                                                        \
  return launch_bwd_##kind<Elem, __VA_ARGS__>(dy, x, r, mean, rstd, scale, dx, workspace, \
                                             dparams, rows, h, blocks, stream)
  if (form == 2 * kRow + 1) PROQA_LN_BWD_WIDE(row, 1, kBwdRowWidth / kThreads);
  if (form == 2 * kRow) {
    // vectors a thread holds: 1-2 in bf16, 2-4 in f32 (8 or 16 elements)
    if ((h / kVec + kThreads - 1) / kThreads <= 8 / kVec) PROQA_LN_BWD_WIDE(row, kVec, 8 / kVec);
    PROQA_LN_BWD_WIDE(row, kVec, 16 / kVec);
  }
  if (form == 2 * kStream) PROQA_LN_BWD_WIDE(stream, kVec);
  PROQA_LN_BWD_WIDE(stream, 1);
#undef PROQA_LN_BWD_WIDE
}

// Whether every pointer is 16-byte aligned
bool aligned16(std::initializer_list<const void*> ptrs) {
  uintptr_t bits = 0;
  for (const void* p : ptrs) bits |= reinterpret_cast<uintptr_t>(p);
  return bits % 16 == 0;
}

// The backward's blocks for [rows, h] (elem bytes an element) on `device`
int blocks_for(long long rows, int h, int elem, int device) {
  return h <= kMaxWidth ? bwd_blocks(rows, h, elem, device) : wide_bwd_blocks(rows, device);
}

// --- F2's RMSNorm form: the residual add and RMSNorm of a pre-norm decoder ---

// The index of "rms_row" in ops/fused_bert.py's LN_FORMS: the RMSNorm form
// follows LayerNorm's six, a block a row in registers up to kRowWidth, with
// its element body after it
constexpr int kRmsForms = 6;

int rms_form_of(bool vector) { return kRmsForms + (vector ? 0 : 1); }

// round((s * rstd) * scale), each product rounded on its own, scale in Elem
template <typename Elem, int kVec>
__device__ inline void rms_out(const float (&v)[kVec], float rstd, const Elem* scale, Elem* out) {
  alignas(16) Elem sc[kVec];
  load_raw<Elem, kVec>(scale, sc);
  float o[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) o[e] = __fmul_rn(__fmul_rn(v[e], rstd), to_f32(sc[e]));
  store_vec<Elem, kVec>(out, o);
}

// A block a row (the blocks walk the rows by a grid stride);
// thread t holds the row's vectors t, t + kThreads, ... of kVec elements
// (kVec = 1: elements), kVecs of them at most, loaded before any is used and
// kept in registers from the sum of squares to the output.
template <typename Elem, int kVec, int kVecs>
__global__ void __launch_bounds__(kThreads)
add_layer_norm_rms_row_kernel(const Elem* __restrict__ x, const Elem* __restrict__ r,
                              const Elem* __restrict__ scale, Elem* __restrict__ out,
                              Elem* __restrict__ sum_out, long long rows, int h, float inv_h,
                              float eps) {
  __shared__ float red[2][kWarps];  // alternate rows: block_sum's buffers in turn
  const int nvec = h / kVec;
  int turn = 0;
  for (long long row = blockIdx.x; row < rows; row += gridDim.x, turn ^= 1) {
    const long long base = row * h;
    alignas(16) Elem a[kVecs][kVec], b[kVecs][kVec];
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      const int i = threadIdx.x + kThreads * j;
      if (i < nvec) {
        load_raw<Elem, kVec>(x + base + (long long)i * kVec, a[j]);
        if (r != nullptr) load_raw<Elem, kVec>(r + base + (long long)i * kVec, b[j]);
      }
    }
    float v[kVecs][kVec], sq = 0.0f;
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      const int i = threadIdx.x + kThreads * j;
      if (i < nvec) {
        rounded_sums<Elem, kVec>(a[j], b[j], r != nullptr, v[j]);
        if (sum_out != nullptr) store_vec<Elem, kVec>(sum_out + base + (long long)i * kVec, v[j]);
#pragma unroll
        for (int e = 0; e < kVec; ++e) sq = __fadd_rn(sq, __fmul_rn(v[j][e], v[j][e]));
      }
    }
    const float rstd = rsqrtf(__fadd_rn(__fmul_rn(block_sum(sq, red[turn]), inv_h), eps));
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      const int i = threadIdx.x + kThreads * j;
      if (i < nvec)
        rms_out<Elem, kVec>(v[j], rstd, scale + i * kVec, out + base + (long long)i * kVec);
    }
  }
}

template <typename Elem>
cudaError_t launch_rms(const Elem* x, const Elem* r, const Elem* scale, Elem* out, Elem* sum_out,
                       long long rows, int h, float eps, int form, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(Elem);
  const float inv_h = 1.0f / (float)h;
  const int grid = row_grid(rows);
#define PROQA_RMS_ROW(vec, n)                                                        \
  add_layer_norm_rms_row_kernel<Elem, vec, n><<<grid, kThreads, 0, stream>>>(        \
      x, r, scale, out, sum_out, rows, h, inv_h, eps)
  if (form == kRmsForms + 1) {
    PROQA_RMS_ROW(1, kRowWidth / kThreads);
  } else {
    // vectors a thread holds: 1-4 in bf16, 2-8 in f32 (8 to 32 elements)
    const int vecs = (h / kVec + kThreads - 1) / kThreads;
    if (vecs <= 8 / kVec) PROQA_RMS_ROW(kVec, 8 / kVec);
    else if (vecs <= 16 / kVec) PROQA_RMS_ROW(kVec, 16 / kVec);
    else PROQA_RMS_ROW(kVec, 32 / kVec);
  }
#undef PROQA_RMS_ROW
  return cudaGetLastError();
}

}  // namespace

// x, residual (nullptr for none), out: [rows, h] contiguous, bf16 when
// is_bf16, else f32 (out may not alias x or residual); scale, bias: [h] f32;
// mean, rstd: [rows] f32 for the backward, or both nullptr. h >= 1. form:
// the index of the form in ops/fused_bert.py's LN_FORMS, which must be the
// one form_of gives for h and the pointers' alignment (the vector bodies
// want h a multiple of the 16-byte vector and every pointer aligned to 16).
// Returns a cudaError_t code.
extern "C" int proqa_add_layer_norm(const void* x, const void* residual, const void* scale,
                                    const void* bias, void* out, void* mean, void* rstd,
                                    long long rows, int h, float eps, int is_bf16, int form,
                                    void* stream) {
  if (rows < 0 || h < 1 || ((mean == nullptr) != (rstd == nullptr)))
    return cudaErrorInvalidValue;
  const bool vector = aligned16({x, residual, scale, bias, out}) && h % (is_bf16 ? 8 : 4) == 0;
  if (form != form_of(h, vector, false)) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  float* m = static_cast<float*>(mean);
  float* rs = static_cast<float*>(rstd);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (h > kMaxWidth) {
    return is_bf16 ? launch_wide<bf16>(static_cast<const bf16*>(x),
                                       static_cast<const bf16*>(residual), sc, bi,
                                       static_cast<bf16*>(out), m, rs, rows, h, eps, form, s)
                   : launch_wide<float>(static_cast<const float*>(x),
                                        static_cast<const float*>(residual), sc, bi,
                                        static_cast<float*>(out), m, rs, rows, h, eps, form, s);
  }
  return is_bf16 ? launch<bf16>(x, residual, sc, bi, out, m, rs, rows, h, eps, s)
                 : launch<float>(x, residual, sc, bi, out, m, rs, rows, h, eps, s);
}

// The bytes of scratch the backward's scale and bias gradients take for
// [rows, h] inputs (bf16 when is_bf16, else f32) on CUDA device `device`:
// ticket counters and [blocks, 2, h] f32 partials (column_sums.cuh). The
// scratch must be zero the first time; each launch leaves it fit for the
// next on the same stream.
extern "C" long long proqa_add_layer_norm_bwd_workspace(long long rows, int h, int is_bf16,
                                                        int device) {
  if (h < 1) return 0;
  if (rows < 1) return column_sums::kTicketBytes;  // nothing to add up
  return column_sums::workspace_bytes(1, blocks_for(rows, h, is_bf16 ? 2 : 4, device), 2 * h);
}

// The backward, on the current device. dy, x, residual (nullptr for none),
// dx: [rows, h] contiguous, bf16 when is_bf16, else f32; mean, rstd: [rows]
// f32 from the forward; scale: [h] f32. dx (nullptr when no input wants it)
// receives the gradient of x and of the residual; dparams (nullptr for
// none): [2, h] f32, the scale's gradient then the bias's; workspace: the
// scratch for it (nullptr with dparams), of at least the bytes
// proqa_add_layer_norm_bwd_workspace gives. h >= 1. form: the index of the
// form in ops/fused_bert.py's LN_BWD_FORMS, which must be form_of's for h
// and the alignment of dy, x, the residual, dx and scale. Returns a
// cudaError_t code.
extern "C" int proqa_add_layer_norm_bwd(const void* dy, const void* x, const void* residual,
                                        const void* mean, const void* rstd, const void* scale,
                                        void* dx, void* workspace, void* dparams, long long rows,
                                        int h, int is_bf16, int form, void* stream) {
  if (rows < 0 || h < 1 || ((workspace == nullptr) != (dparams == nullptr)))
    return cudaErrorInvalidValue;
  const bool vector = aligned16({dy, x, residual, dx, scale}) && h % (is_bf16 ? 8 : 4) == 0;
  if (form != form_of(h, vector, true)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows == 0 && dparams != nullptr)
    return cudaMemsetAsync(dparams, 0, 2 * h * sizeof(float), s);
  if (rows == 0 || (dx == nullptr && dparams == nullptr)) return cudaSuccess;
  int device = 0;
  const cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const int blocks = blocks_for(rows, h, is_bf16 ? 2 : 4, device);
  const float* m = static_cast<const float*>(mean);
  const float* rs = static_cast<const float*>(rstd);
  const float* sc = static_cast<const float*>(scale);
  if (dparams != nullptr && column_sums::workspace_bytes(1, blocks, 2 * h) == 0)
    return cudaErrorInvalidValue;
  float* dp = static_cast<float*>(dparams);
  if (h > kMaxWidth) {
    return is_bf16
               ? launch_bwd_wide<bf16>(static_cast<const bf16*>(dy), static_cast<const bf16*>(x),
                                       static_cast<const bf16*>(residual), m, rs, sc,
                                       static_cast<bf16*>(dx), workspace, dp, rows, h, form,
                                       blocks, s)
               : launch_bwd_wide<float>(static_cast<const float*>(dy),
                                        static_cast<const float*>(x),
                                        static_cast<const float*>(residual), m, rs, sc,
                                        static_cast<float*>(dx), workspace, dp, rows, h, form,
                                        blocks, s);
  }
  return is_bf16 ? launch_bwd<bf16>(dy, x, residual, m, rs, sc, dx, workspace, dp, rows, h,
                                    blocks, device, s)
                 : launch_bwd<float>(dy, x, residual, m, rs, sc, dx, workspace, dp, rows, h,
                                     blocks, device, s);
}

// F2's RMSNorm form. x, residual (nullptr for none), scale, out, sum_out
// (nullptr for none): [rows, h] contiguous ([h] for scale), bf16 when
// is_bf16, else f32; out and sum_out may not alias x or residual. Writes
// out = round((s * rsqrt(mean(s^2) + eps)) * scale), s = round(x + residual)
// (x without a residual) in f32, and s into sum_out. 1 <= h <= 8,192. form:
// the index of the form in ops/fused_bert.py's LN_FORMS, which must be the
// one rms_form_of gives for the pointers' alignment. Returns a cudaError_t
// code.
extern "C" int proqa_add_rms_norm(const void* x, const void* residual, const void* scale,
                                  void* out, void* sum_out, long long rows, int h, float eps,
                                  int is_bf16, int form, void* stream) {
  if (rows < 0 || h < 1 || h > kRowWidth) return cudaErrorInvalidValue;
  const bool vector = aligned16({x, residual, scale, out, sum_out}) && h % (is_bf16 ? 8 : 4) == 0;
  if (form != rms_form_of(vector)) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_rms<bf16>(static_cast<const bf16*>(x),
                                    static_cast<const bf16*>(residual),
                                    static_cast<const bf16*>(scale), static_cast<bf16*>(out),
                                    static_cast<bf16*>(sum_out), rows, h, eps, form, s)
                 : launch_rms<float>(static_cast<const float*>(x),
                                     static_cast<const float*>(residual),
                                     static_cast<const float*>(scale), static_cast<float*>(out),
                                     static_cast<float*>(sum_out), rows, h, eps, form, s);
}
