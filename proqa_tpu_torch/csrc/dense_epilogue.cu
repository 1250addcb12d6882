// F1: the dense layer's epilogue. The f32 product plus the f32 bias, rounded
// once to the output dtype; with GELU, exact GELU in f32 on that rounded
// value, rounded again.
//
// Replaces the XLA fusion of proqa_tpu/models/bert.py:147-150 (`_dense`: the
// einsum's f32 result plus the f32 bias, cast to the activation dtype) and,
// for `mlp_in`, of :273-274 (jax.nn.gelu(approximate=False) in f32 on the
// rounded dense output, cast again). It is not a Pallas kernel: on the TPU
// XLA fuses this work into the product's output. Both rounding points of the
// GELU variant are kept, so the result is the plain PyTorch chain's
// (ops/fused_bert.py:dense_epilogue_reference) bit for bit: one IEEE f32 add,
// round-to-nearest-even, and ATen's exact-GELU expression
// (ActivationGeluKernel.cu: x * 0.5 * (1 + erf(x * M_SQRT1_2)) in f32).
//
// What bounds it on the H100: bytes. It reads the f32 product once (4 B an
// element) and writes the output once (2 B bf16, 4 B f32): 6 B an element in
// bf16, 1.44 ms for [262,144, 3,072] at the published 3.35 TB/s of the H100
// SXM at 700 W. One add (and with GELU one erff) an element is far below the
// f32 rate. What the design does about it: each thread takes groups of 8
// elements of one row, two 16-byte loads of the product (streamed past L1)
// and one 16-byte store of bf16 (two of f32); a grid of a few blocks an SM
// walks the groups in a grid-stride loop, the column advanced by the
// stride's remainder so that no division runs in the loop; the bias row is
// staged in shared memory once a block. Widths that are not a multiple of 8
// (the span head's 2, the selection head's 1) and unaligned pointers take the
// element-at-a-time loop. Past 12,288 columns (kMaxCols: the bias row in the
// 48 KB of shared memory a block takes without opting in; ALBERT-xxlarge's
// feed-forward has 16,384) the wide forms take the same groups and read the
// bias through the read-only cache instead: a row of 64 KB at 16,384 stays
// in L1, and no width is too wide. The wrapper names the form
// (ops/fused_bert.py:dense_form), and the entry point refuses any other.
//
// Training adds two things. The forward with GELU also stores the rounded
// pre-activation z = round(y + b) (2 B an element more in bf16), which the
// backward needs in place of the f32 input that autograd would keep. The
// backward, `proqa_dense_epilogue_bwd`, is the transpose of the same fusion
// (XLA fuses it into the backward products on the TPU): with GELU,
// dz = round(f32(dout) * (cdf + x * pdf)) on x = f32(z), ATen's exact-GELU
// backward expression in ATen's order (ActivationGeluKernel.cu,
// GeluBackwardCUDAKernelImpl, each operation rounded on its own), so dz is
// the plain chain's aten::gelu_backward bit for bit; and
// the bias gradient, the column sum of f32(dz) (of f32(dout) without GELU).
//
// What bounds the backward on the H100: bytes. The sum alone reads dout, 2 B
// an element in bf16 (0.019 ms for [40,960, 768] at 3.35 TB/s). With GELU it
// reads dout and z and writes dz, 6 B an element (0.225 ms for [40,960,
// 3,072]); ATen's unfused order (erff, expf and ~10 more operations, each
// rounded on its own, no fast math) costs ~46 SASS instructions an element,
// an issue bound of ~0.17 ms there, close behind (chip_smoke.py counts the
// loop's SASS and gives both bounds). What the design does about it:
//   - a block takes 32 column groups of 8 side by side and 8 row lanes over a
//     slab of rows; each thread issues the loads of kUnroll rows (16 without
//     GELU, 4 with; fewer in f32 and in the element body) before it uses
//     any, the slab's last rows in one guarded step of the same kind;
//   - a persistent grid of two blocks an SM, the rows cut into as few slabs
//     as fill it (88 at width 768, 22 at 3,072), and fewer where the sum
//     alone would get under 64 rows a slab: few partials, and every thread
//     with loads enough in flight;
//   - the sum ends in the same launch: each block adds its 8 row lanes in
//     order into its slab's f32 partial and takes a ticket; the last block
//     of each group of 16 slabs adds its group's partials in order, and the
//     last group's the group sums (column_sums.cuh). No block waits.
// The slabs and the order of every sum follow from the row count, the width,
// the form (GELU or not) and the SM count alone, so two launches give the
// same bits; odd widths and unaligned pointers load element by element in
// the same groups, slabs and order. The slabs take any width up to 131,072
// columns (kMaxSlabCols, where the column blocks' ticket counters fill their
// 4 KB); past it the column blocks alone fill the card, so the direct form
// takes every row in one slab and writes each column's sum with no partials.
//
// The SwiGLU form (`proqa_dense_swiglu`, forward only) is the gated MLP's
// epilogue in the pre-norm decoder (models/mistral.py): one product of the
// gate and up projections side by side, [rows, 2 I] in the activation dtype
// (no bias; cuBLAS rounds each f32 sum once), gives round(silu(gate) * up)
// in f32, ATen's silu expression, [rows, I]. Bound by bytes: 4 B read and
// 2 B written an output element in bf16 (0.83 ms for [32,256, 14,336] at
// 3.35 TB/s). The staged kernels' groups of 8 a thread, two 16-byte loads
// (the gate's and the up's, I columns apart) and one store a group, in the
// same grid-stride loop; odd widths and unaligned pointers take the element
// body.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "column_sums.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;     // 2,048 threads: a full SM
constexpr int kGroup = 8;           // elements a thread takes at a time
constexpr int kMaxCols = 12288;     // the bias row in at most 48 KB of shared memory
// ATen's kAlpha: the double M_SQRT1_2 converted to float
constexpr float kSqrt1_2 = static_cast<float>(0.70710678118654752440);
// ATen's kBeta of the GELU backward: M_2_SQRTPI * M_SQRT1_2 * 0.5 in double,
// converted to float
constexpr float kGeluBeta =
    static_cast<float>(1.12837916709551257390 * 0.70710678118654752440 * 0.5);
constexpr int kColThreads = 32;  // backward: column groups a block takes side by side
constexpr int kRowThreads = 8;   // backward: rows a block takes at a time
constexpr int kBwdBlocksPerSm = 2;  // backward: blocks an SM (its registers allow two)
constexpr int kMinSlabRows = 64;    // backward, the sum alone: rows a slab takes at least
// backward: the widest the slabs take, where the column blocks' ticket
// counters (two a column block at one slab) fill column_sums' 4 KB
constexpr int kMaxSlabCols = kColThreads * kGroup * (column_sums::kTicketBytes / 4 / 2);
constexpr int kMaxDevices = 64;

template <typename Out>
__device__ inline Out to_out(float x);
template <>
__device__ inline bf16 to_out<bf16>(float x) { return __float2bfloat16_rn(x); }
template <>
__device__ inline float to_out<float>(float x) { return x; }

__device__ inline float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ inline float to_f32(float x) { return x; }

// ATen's exact GELU in f32, each operation rounded on its own (no fused
// multiply-add), in ATen's order: (x * 0.5) * (1 + erf(x * kAlpha))
__device__ inline float gelu_erf(float x) {
  return __fmul_rn(__fmul_rn(x, 0.5f), __fadd_rn(1.0f, erff(__fmul_rn(x, kSqrt1_2))));
}

// ATen's exact-GELU backward in f32, each operation rounded on its own (no
// fused multiply-add: ATen's compiled kernel has none there, which an H100
// showed over 4M inputs), in ATen's order: dy * (cdf + x * pdf),
// cdf = 0.5 * (1 + erf(x * kAlpha)), pdf = exp(-0.5 * x * x) * kBeta
__device__ inline float gelu_erf_grad(float dy, float x) {
  const float cdf = __fmul_rn(0.5f, __fadd_rn(1.0f, erff(__fmul_rn(x, kSqrt1_2))));
  const float pdf = __fmul_rn(expf(__fmul_rn(__fmul_rn(-0.5f, x), x)), kGeluBeta);
  return __fmul_rn(dy, __fadd_rn(cdf, __fmul_rn(x, pdf)));
}

// The rounded pre-activation t = round(acc + bias) into *z, and the output:
// t, or round(gelu(t)) with GELU
template <typename Out, bool kGelu>
__device__ inline Out epilogue(float acc, float bias, Out* z) {
  const Out t = to_out<Out>(__fadd_rn(acc, bias));
  *z = t;
  return kGelu ? to_out<Out>(gelu_erf(to_f32(t))) : t;
}

__device__ inline void stage_bias(const float* __restrict__ bias, float* sbias, int cols) {
  for (int c = threadIdx.x; c < cols; c += kThreads) sbias[c] = bias[c];
  __syncthreads();
}

// cols % 8 == 0 and every pointer 16-byte aligned: group g is elements
// 8 g .. 8 g + 7 of the flat [rows, cols] product, all in one row.
// With kSaveZ the pre-activation goes to z as well (the training forward).
template <typename Out, bool kGelu, bool kSaveZ>
__global__ void __launch_bounds__(kThreads)
dense_epilogue_vec_kernel(const float4* __restrict__ y, const float* __restrict__ bias,
                          Out* __restrict__ out, Out* __restrict__ z, long long groups,
                          int cols) {
  extern __shared__ float4 sbias4[];
  stage_bias(bias, reinterpret_cast<float*>(sbias4), cols);
  const int per_row = cols / kGroup;
  const long long stride = (long long)gridDim.x * kThreads;
  long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  int col = (int)(g % per_row);            // the group's column, in groups
  const int step = (int)(stride % per_row);
  for (; g < groups; g += stride) {
    const float4 a = __ldcs(y + 2 * g), b = __ldcs(y + 2 * g + 1);
    const float4 ba = sbias4[2 * col], bb = sbias4[2 * col + 1];
    const float acc[kGroup] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    const float bs[kGroup] = {ba.x, ba.y, ba.z, ba.w, bb.x, bb.y, bb.z, bb.w};
    alignas(16) Out o[kGroup], t[kGroup];
#pragma unroll
    for (int e = 0; e < kGroup; ++e) o[e] = epilogue<Out, kGelu>(acc[e], bs[e], &t[e]);
    uint4* dst = reinterpret_cast<uint4*>(out + kGroup * g);
#pragma unroll
    for (int s = 0; s < (int)(kGroup * sizeof(Out) / 16); ++s)
      dst[s] = reinterpret_cast<const uint4*>(o)[s];
    if constexpr (kSaveZ) {
      uint4* zdst = reinterpret_cast<uint4*>(z + kGroup * g);
#pragma unroll
      for (int s = 0; s < (int)(kGroup * sizeof(Out) / 16); ++s)
        zdst[s] = reinterpret_cast<const uint4*>(t)[s];
    }
    col += step;
    if (col >= per_row) col -= per_row;
  }
}

// Any width, any alignment: one element at a time.
template <typename Out, bool kGelu, bool kSaveZ>
__global__ void __launch_bounds__(kThreads)
dense_epilogue_scalar_kernel(const float* __restrict__ y, const float* __restrict__ bias,
                             Out* __restrict__ out, Out* __restrict__ z, long long n, int cols) {
  extern __shared__ float4 sbias4[];
  float* sbias = reinterpret_cast<float*>(sbias4);
  stage_bias(bias, sbias, cols);
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n; i += stride) {
    Out t;
    out[i] = epilogue<Out, kGelu>(y[i], sbias[i % cols], &t);
    if constexpr (kSaveZ) z[i] = t;
  }
}

// cols > kMaxCols (the bias row would not fit the shared memory a block
// takes without opting in): the vector body with the bias read through the
// read-only cache, element by element, where the staged kernels read shared
// memory. The same groups, the same arithmetic, the same bits.
template <typename Out, bool kGelu, bool kSaveZ>
__global__ void __launch_bounds__(kThreads)
dense_epilogue_wide_vec_kernel(const float4* __restrict__ y, const float* __restrict__ bias,
                               Out* __restrict__ out, Out* __restrict__ z, long long groups,
                               int cols) {
  const int per_row = cols / kGroup;
  const long long stride = (long long)gridDim.x * kThreads;
  long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  int col = (int)(g % per_row);  // the group's column, in groups
  const int step = (int)(stride % per_row);
  for (; g < groups; g += stride) {
    const float4 a = __ldcs(y + 2 * g), b = __ldcs(y + 2 * g + 1);
    const float acc[kGroup] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    alignas(16) Out o[kGroup], t[kGroup];
#pragma unroll
    for (int e = 0; e < kGroup; ++e)
      o[e] = epilogue<Out, kGelu>(acc[e], __ldg(bias + kGroup * col + e), &t[e]);
    uint4* dst = reinterpret_cast<uint4*>(out + kGroup * g);
#pragma unroll
    for (int s = 0; s < (int)(kGroup * sizeof(Out) / 16); ++s)
      dst[s] = reinterpret_cast<const uint4*>(o)[s];
    if constexpr (kSaveZ) {
      uint4* zdst = reinterpret_cast<uint4*>(z + kGroup * g);
#pragma unroll
      for (int s = 0; s < (int)(kGroup * sizeof(Out) / 16); ++s)
        zdst[s] = reinterpret_cast<const uint4*>(t)[s];
    }
    col += step;
    if (col >= per_row) col -= per_row;
  }
}

// cols > kMaxCols, any width and alignment: one element at a time, the bias
// through the read-only cache.
template <typename Out, bool kGelu, bool kSaveZ>
__global__ void __launch_bounds__(kThreads)
dense_epilogue_wide_scalar_kernel(const float* __restrict__ y, const float* __restrict__ bias,
                                  Out* __restrict__ out, Out* __restrict__ z, long long n,
                                  int cols) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n; i += stride) {
    Out t;
    out[i] = epilogue<Out, kGelu>(y[i], __ldg(bias + i % cols), &t);
    if constexpr (kSaveZ) z[i] = t;
  }
}

// A group of kGroup elements of one row at p: one 16-byte load a 16 bytes
// (kVector: the group is whole and aligned), else the first `width` element
// by element. Raw: the loads of several rows are issued before any is used.
template <typename T, bool kVector>
__device__ inline void load_group(const T* p, int width, T (&v)[kGroup]) {
  if constexpr (kVector) {
#pragma unroll
    for (int s = 0; s < (int)(kGroup * sizeof(T) / 16); ++s)
      reinterpret_cast<uint4*>(v)[s] = __ldcs(reinterpret_cast<const uint4*>(p) + s);
  } else {
#pragma unroll
    for (int e = 0; e < kGroup; ++e)
      if (e < width) v[e] = p[e];
  }
}

template <typename T, bool kVector>
__device__ inline void store_group(T* p, int width, const T (&v)[kGroup]) {
  if constexpr (kVector) {
#pragma unroll
    for (int s = 0; s < (int)(kGroup * sizeof(T) / 16); ++s)
      reinterpret_cast<uint4*>(p)[s] = reinterpret_cast<const uint4*>(v)[s];
  } else {
#pragma unroll
    for (int e = 0; e < kGroup; ++e)
      if (e < width) p[e] = v[e];
  }
}

// kUnroll rows of the backward, rows row, row + 8, ... (kFull: all in the
// slab; else those before `last`): the loads of all of them first, then for
// each in order dz = round(gelu'(z) dout) (with GELU), stored when kDz, and
// its terms added to the column sums (with kSum): f32 of the rounded dz, or
// of dout without GELU.
template <typename T, bool kVector, bool kGelu, bool kDz, bool kSum, int kUnroll, bool kFull>
__device__ inline void backward_rows(const T* __restrict__ dout, const T* __restrict__ z,
                                     T* __restrict__ dz, long long row, long long last, int cols,
                                     int c0, int width, float (&sum)[kGroup]) {
  alignas(16) T d[kUnroll][kGroup], x[kUnroll][kGroup];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long at = (row + (long long)kRowThreads * u) * cols + c0;
    if (kFull || row + kRowThreads * u < last) {
      load_group<T, kVector>(dout + at, width, d[u]);
      if constexpr (kGelu) load_group<T, kVector>(z + at, width, x[u]);
    }
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    if (!kFull && row + kRowThreads * u >= last) break;
    if constexpr (kGelu) {
#pragma unroll
      for (int e = 0; e < kGroup; ++e)
        d[u][e] = to_out<T>(gelu_erf_grad(to_f32(d[u][e]), to_f32(x[u][e])));
      if constexpr (kDz)
        store_group<T, kVector>(dz + (row + (long long)kRowThreads * u) * cols + c0, width,
                                d[u]);
    }
    if constexpr (kSum) {
#pragma unroll
      for (int e = 0; e < kGroup; ++e) sum[e] = __fadd_rn(sum[e], to_f32(d[u][e]));
    }
  }
}

// The backward. Thread (tx, ty) of block (bx, slab) takes the columns
// c0 = (bx * 32 + tx) * 8 .. c0 + 7 (fewer at the right edge) over rows
// slab_start + ty, + 8, ... of its slab, kUnroll rows at a time, the rest in
// one more such step: with GELU it writes dz (kDz), and with kSum it adds f32(dz)
// (f32(dout) without GELU) per column in row order. The block adds its 8 row
// lanes in order into its row of the partials [slabs, cols] in `workspace`,
// and the last blocks of each column block add the slabs' partials in slab
// order into dbias (column_sums.cuh).
template <typename T, bool kVector, bool kGelu, bool kDz, bool kSum>
__global__ void __launch_bounds__(kColThreads * kRowThreads, kBwdBlocksPerSm)
dense_epilogue_bwd_kernel(const T* __restrict__ dout, const T* __restrict__ z,
                          T* __restrict__ dz, void* workspace, float* dbias, long long rows,
                          int cols) {
  // rows in flight a thread: 16-byte loads pack 8 bf16 in 4 registers, the
  // element body keeps one a register, so it takes fewer
  constexpr int kUnroll = (kVector ? (kGelu ? 4 : 16) : (kGelu ? 2 : 4)) * 2 / (int)sizeof(T);
  const int c0 = (blockIdx.x * kColThreads + threadIdx.x) * kGroup;
  const int width = cols - c0 < kGroup ? cols - c0 : kGroup;  // <= 0: no columns
  const long long per_slab = (rows + gridDim.y - 1) / gridDim.y;
  const long long first = (long long)blockIdx.y * per_slab;
  const long long last = first + per_slab < rows ? first + per_slab : rows;
  float sum[kGroup] = {};
  if (width > 0) {
    long long row = first + threadIdx.y;
    for (; row + (long long)kRowThreads * (kUnroll - 1) < last; row += kRowThreads * kUnroll)
      backward_rows<T, kVector, kGelu, kDz, kSum, kUnroll, true>(dout, z, dz, row, last, cols,
                                                                 c0, width, sum);
    if (row < last)
      backward_rows<T, kVector, kGelu, kDz, kSum, kUnroll, false>(dout, z, dz, row, last, cols,
                                                                  c0, width, sum);
  }
  if constexpr (kSum) {
    __shared__ float lane_sums[kRowThreads][kColThreads * kGroup];
#pragma unroll
    for (int e = 0; e < kGroup; ++e) lane_sums[threadIdx.y][threadIdx.x * kGroup + e] = sum[e];
    __syncthreads();
    // the block's kColThreads * kGroup columns, one thread a column
    const int tid = threadIdx.y * kColThreads + threadIdx.x;
    const int col0 = blockIdx.x * kColThreads * kGroup;
    const int ncols = cols - col0 < kColThreads * kGroup ? cols - col0 : kColThreads * kGroup;
    const column_sums::Layout ws = column_sums::layout(workspace, gridDim.y, cols);
    if (tid < ncols) {
      float total = lane_sums[0][tid];
#pragma unroll
      for (int j = 1; j < kRowThreads; ++j) total = __fadd_rn(total, lane_sums[j][tid]);
      ws.partials[(long long)blockIdx.y * cols + col0 + tid] = total;
    }
    column_sums::finish(ws.partials + col0, ws.group_sums + col0, cols, gridDim.y, ncols,
                        blockIdx.y,
                        ws.tickets + blockIdx.x * (column_sums::groups(gridDim.y) + 1),
                        dbias + col0);
  }
}

static_assert(kColThreads * kRowThreads == column_sums::kThreads && kGroup == kRowThreads,
              "a block's threads: column_sums' block, and one a column of its columns");

// cols > kMaxSlabCols: the rows in one slab (the column blocks alone fill
// the card, and the ticket counters of column_sums would not fit), so the
// block's 8 row lanes, added in order, are the column's sum: it goes to
// dbias with no partials. The element body, the same rows a thread, the
// same order of sums as a slab of the kernel above.
template <typename T, bool kGelu, bool kDz, bool kSum>
__global__ void __launch_bounds__(kColThreads * kRowThreads, kBwdBlocksPerSm)
dense_epilogue_bwd_direct_kernel(const T* __restrict__ dout, const T* __restrict__ z,
                                 T* __restrict__ dz, float* __restrict__ dbias, long long rows,
                                 int cols) {
  constexpr int kUnroll = (kGelu ? 2 : 4) * 2 / (int)sizeof(T);
  const int c0 = (blockIdx.x * kColThreads + threadIdx.x) * kGroup;
  const int width = cols - c0 < kGroup ? cols - c0 : kGroup;  // <= 0: no columns
  float sum[kGroup] = {};
  if (width > 0) {
    long long row = threadIdx.y;
    for (; row + (long long)kRowThreads * (kUnroll - 1) < rows; row += kRowThreads * kUnroll)
      backward_rows<T, false, kGelu, kDz, kSum, kUnroll, true>(dout, z, dz, row, rows, cols, c0,
                                                               width, sum);
    if (row < rows)
      backward_rows<T, false, kGelu, kDz, kSum, kUnroll, false>(dout, z, dz, row, rows, cols,
                                                                c0, width, sum);
  }
  if constexpr (kSum) {
    __shared__ float lane_sums[kRowThreads][kColThreads * kGroup];
#pragma unroll
    for (int e = 0; e < kGroup; ++e) lane_sums[threadIdx.y][threadIdx.x * kGroup + e] = sum[e];
    __syncthreads();
    const int tid = threadIdx.y * kColThreads + threadIdx.x;
    const int col0 = blockIdx.x * kColThreads * kGroup;
    if (tid < cols - col0) {
      float total = lane_sums[0][tid];
#pragma unroll
      for (int j = 1; j < kRowThreads; ++j) total = __fadd_rn(total, lane_sums[j][tid]);
      dbias[col0 + tid] = total;
    }
  }
}

int grid_for(long long work) {
  int device = 0, sms = 132;
  if (cudaGetDevice(&device) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long blocks = (work + kThreads - 1) / kThreads;
  const long long most = (long long)sms * kBlocksPerSm;
  return (int)(blocks < most ? blocks : most);
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

// The backward's blocks across the columns: 32 groups of 8 columns a block
int bwd_across(int cols) {
  return ((cols + kGroup - 1) / kGroup + kColThreads - 1) / kColThreads;
}

// The backward's slabs of rows on `device`: kBwdBlocksPerSm blocks an SM over
// the column blocks (a persistent grid), fewer where that would leave a slab
// under its least rows: kMinSlabRows for the sum alone (few rows: each
// thread still has rows enough to keep its loads in flight, and the
// partials stay few), a row a row lane with GELU (its arithmetic wants every
// thread it can get). The row count, the width, the form and the card alone
// fix them, and with them the order of the bias gradient's sum.
int bwd_slabs(long long rows, int cols, int gelu, int device) {
  long long most = (long long)sm_count(device) * kBwdBlocksPerSm / bwd_across(cols);
  if (most < 1) most = 1;
  const int least = gelu ? kRowThreads : kMinSlabRows;
  const long long slabs = (rows + least - 1) / least;
  return slabs < 1 ? 1 : (int)(slabs < most ? slabs : most);
}

// The forms, as ops/fused_bert.py names them (DENSE_FORMS, DENSE_BWD_FORMS)
enum Form { kStagedVec = 0, kStagedScalar = 1, kWideVec = 2, kWideScalar = 3 };
enum BwdForm { kSlabsVec = 0, kSlabsScalar = 1, kDirect = 2 };

// The vector bodies want the width a multiple of the group and every pointer
// 16-byte aligned
bool vector_body(int cols, const void* a, const void* b, const void* c) {
  return cols % kGroup == 0 && ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
                                 reinterpret_cast<uintptr_t>(c)) % 16) == 0;
}

int form_of(int cols, bool vector) {
  return (cols <= kMaxCols ? kStagedVec : kWideVec) + (vector ? 0 : 1);
}

int bwd_form_of(int cols, bool vector) {
  return cols > kMaxSlabCols ? kDirect : vector ? kSlabsVec : kSlabsScalar;
}

template <typename Out, bool kGelu, bool kSaveZ>
cudaError_t launch(const float* y, const float* bias, Out* out, Out* z, long long rows, int cols,
                   int form, cudaStream_t stream) {
  const long long n = rows * cols;
  if (form == kWideVec) {
    const long long groups = n / kGroup;
    dense_epilogue_wide_vec_kernel<Out, kGelu, kSaveZ><<<grid_for(groups), kThreads, 0, stream>>>(
        reinterpret_cast<const float4*>(y), bias, out, z, groups, cols);
    return cudaGetLastError();
  }
  if (form == kWideScalar) {
    dense_epilogue_wide_scalar_kernel<Out, kGelu, kSaveZ><<<grid_for(n), kThreads, 0, stream>>>(
        y, bias, out, z, n, cols);
    return cudaGetLastError();
  }
  const size_t smem = (size_t)cols * sizeof(float);
  const bool aligned = ((reinterpret_cast<uintptr_t>(y) | reinterpret_cast<uintptr_t>(out) |
                         reinterpret_cast<uintptr_t>(z)) % 16) == 0;
  if (aligned && cols % kGroup == 0) {
    const long long groups = n / kGroup;
    dense_epilogue_vec_kernel<Out, kGelu, kSaveZ><<<grid_for(groups), kThreads, smem, stream>>>(
        reinterpret_cast<const float4*>(y), bias, out, z, groups, cols);
  } else {
    dense_epilogue_scalar_kernel<Out, kGelu, kSaveZ><<<grid_for(n), kThreads, smem, stream>>>(
        y, bias, out, z, n, cols);
  }
  return cudaGetLastError();
}

template <typename Out>
cudaError_t launch_gelu(const void* y, const void* bias, void* out, void* z, long long rows,
                        int cols, int gelu, int form, cudaStream_t stream) {
  const float* yf = static_cast<const float*>(y);
  const float* bf = static_cast<const float*>(bias);
  Out* o = static_cast<Out*>(out);
  Out* zo = static_cast<Out*>(z);
  if (!gelu) return launch<Out, false, false>(yf, bf, o, nullptr, rows, cols, form, stream);
  return zo != nullptr ? launch<Out, true, true>(yf, bf, o, zo, rows, cols, form, stream)
                       : launch<Out, true, false>(yf, bf, o, nullptr, rows, cols, form, stream);
}

template <typename T, bool kVector, bool kGelu, bool kDz, bool kSum>
cudaError_t launch_bwd_kernel(const T* dout, const T* z, T* dz, void* workspace, float* dbias,
                              long long rows, int cols, int slabs, cudaStream_t stream) {
  const dim3 grid(bwd_across(cols), slabs);
  const dim3 block(kColThreads, kRowThreads);
  dense_epilogue_bwd_kernel<T, kVector, kGelu, kDz, kSum><<<grid, block, 0, stream>>>(
      dout, z, dz, workspace, dbias, rows, cols);
  return cudaGetLastError();
}

// The forms the backward takes: with GELU, dz and the sum, dz alone, or the
// sum alone (dz not wanted); without, the sum alone
template <typename T, bool kVector>
cudaError_t launch_bwd_form(const T* dout, const T* z, T* dz, void* workspace, float* dbias,
                            long long rows, int cols, int slabs, int gelu, cudaStream_t stream) {
  if (!gelu)
    return launch_bwd_kernel<T, kVector, false, false, true>(dout, z, dz, workspace, dbias, rows,
                                                             cols, slabs, stream);
  if (dz == nullptr)
    return launch_bwd_kernel<T, kVector, true, false, true>(dout, z, dz, workspace, dbias, rows,
                                                            cols, slabs, stream);
  if (dbias == nullptr)
    return launch_bwd_kernel<T, kVector, true, true, false>(dout, z, dz, workspace, dbias, rows,
                                                            cols, slabs, stream);
  return launch_bwd_kernel<T, kVector, true, true, true>(dout, z, dz, workspace, dbias, rows,
                                                         cols, slabs, stream);
}

// The direct forms (one slab): with GELU, dz and the sum, dz alone, or the
// sum alone; without, the sum alone
template <typename T, bool kGelu, bool kDz, bool kSum>
cudaError_t launch_bwd_direct_kernel(const T* dout, const T* z, T* dz, float* dbias,
                                     long long rows, int cols, cudaStream_t stream) {
  const dim3 grid(bwd_across(cols));
  const dim3 block(kColThreads, kRowThreads);
  dense_epilogue_bwd_direct_kernel<T, kGelu, kDz, kSum><<<grid, block, 0, stream>>>(
      dout, z, dz, dbias, rows, cols);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd_direct(const T* dout, const T* z, T* dz, float* dbias, long long rows,
                              int cols, int gelu, cudaStream_t stream) {
  if (!gelu)
    return launch_bwd_direct_kernel<T, false, false, true>(dout, z, dz, dbias, rows, cols,
                                                           stream);
  if (dz == nullptr)
    return launch_bwd_direct_kernel<T, true, false, true>(dout, z, dz, dbias, rows, cols,
                                                          stream);
  if (dbias == nullptr)
    return launch_bwd_direct_kernel<T, true, true, false>(dout, z, dz, dbias, rows, cols,
                                                          stream);
  return launch_bwd_direct_kernel<T, true, true, true>(dout, z, dz, dbias, rows, cols, stream);
}

template <typename T>
cudaError_t launch_bwd(const void* doutp, const void* zp, void* dzp, void* workspace,
                       float* dbias, long long rows, int cols, int slabs, int gelu, int form,
                       cudaStream_t stream) {
  const T* dout = static_cast<const T*>(doutp);
  const T* z = static_cast<const T*>(zp);
  T* dz = static_cast<T*>(dzp);
  if (form == kDirect) return launch_bwd_direct<T>(dout, z, dz, dbias, rows, cols, gelu, stream);
  const bool aligned = ((reinterpret_cast<uintptr_t>(dout) | reinterpret_cast<uintptr_t>(z) |
                         reinterpret_cast<uintptr_t>(dz)) % 16) == 0;
  return aligned && cols % kGroup == 0
             ? launch_bwd_form<T, true>(dout, z, dz, workspace, dbias, rows, cols, slabs, gelu,
                                        stream)
             : launch_bwd_form<T, false>(dout, z, dz, workspace, dbias, rows, cols, slabs, gelu,
                                         stream);
}

// --- F1's SwiGLU form: the gated MLP of a decoder ---

// The forms' indices in ops/fused_bert.py's DENSE_FORMS
enum SwigluForm { kSwigluVec = 4, kSwigluScalar = 5 };

int swiglu_form_of(bool vector) { return vector ? kSwigluVec : kSwigluScalar; }

// ATen's silu in f32, each operation rounded on its own, in ATen's order
// (ActivationSiluKernel.cu: x / (1 + exp(-x))), times the up value, rounded
// on its own
__device__ inline float swiglu(float g, float u) {
  return __fmul_rn(__fdiv_rn(g, __fadd_rn(1.0f, expf(-g))), u);
}

// y: [rows, 2 cols], the gate product in columns [0, cols) and the up
// product in [cols, 2 cols) of each row; out: [rows, cols]. kVector (cols %
// 8 == 0, y and out 16-byte aligned): group g is output elements 8 g .. 8 g
// + 7, all in one row, its gate and up values one 16-byte load each in bf16
// (two in f32), streamed past L1, and one store; else one element at a time
// in the same order. A grid-stride loop, the column advanced by the
// stride's remainder as the staged kernels advance it.
template <typename T, bool kVector>
__global__ void __launch_bounds__(kThreads)
dense_epilogue_swiglu_kernel(const T* __restrict__ y, T* __restrict__ out, long long groups,
                             int cols) {
  constexpr int kPer = kVector ? kGroup : 1;  // elements a step takes
  const int per_row = cols / kPer;
  const long long stride = (long long)gridDim.x * kThreads;
  long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  long long row = g / per_row;
  int col = (int)(g % per_row);
  const long long row_step = stride / per_row;
  const int col_step = (int)(stride % per_row);
  for (; g < groups; g += stride) {
    const T* src = y + row * 2 * cols + (long long)col * kPer;
    alignas(16) T gate[kGroup], up[kGroup], o[kGroup];
    load_group<T, kVector>(src, kPer, gate);
    load_group<T, kVector>(src + cols, kPer, up);
#pragma unroll
    for (int e = 0; e < kPer; ++e) o[e] = to_out<T>(swiglu(to_f32(gate[e]), to_f32(up[e])));
    store_group<T, kVector>(out + row * cols + (long long)col * kPer, kPer, o);
    row += row_step;
    col += col_step;
    if (col >= per_row) {
      col -= per_row;
      ++row;
    }
  }
}

template <typename T>
cudaError_t launch_swiglu(const void* y, void* out, long long rows, int cols, int form,
                          cudaStream_t stream) {
  const T* yt = static_cast<const T*>(y);
  T* o = static_cast<T*>(out);
  const long long n = rows * cols;
  if (form == kSwigluVec) {
    dense_epilogue_swiglu_kernel<T, true><<<grid_for(n / kGroup), kThreads, 0, stream>>>(
        yt, o, n / kGroup, cols);
  } else {
    dense_epilogue_swiglu_kernel<T, false><<<grid_for(n), kThreads, 0, stream>>>(yt, o, n, cols);
  }
  return cudaGetLastError();
}

}  // namespace

// y: [rows, cols] f32 contiguous (the product), bias: [cols] f32, out:
// [rows, cols] bf16 when out_bf16, else f32 (may not alias y). gelu applies
// the exact GELU after the first rounding and rounds again; z (nullptr for
// none; only with gelu), like out, receives the rounded pre-activation.
// cols >= 1. form: the index of the form in ops/fused_bert.py's DENSE_FORMS,
// which must be form_of's for cols and the alignment of y, out and z.
// Returns a cudaError_t code.
extern "C" int proqa_dense_epilogue(const void* y, const void* bias, void* out, void* z,
                                    long long rows, int cols, int out_bf16, int gelu, int form,
                                    void* stream) {
  if (rows < 0 || cols < 1 || (z != nullptr && !gelu) ||
      form != form_of(cols, vector_body(cols, y, out, z)))
    return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_bf16 ? launch_gelu<bf16>(y, bias, out, z, rows, cols, gelu, form, s)
                  : launch_gelu<float>(y, bias, out, z, rows, cols, gelu, form, s);
}

// The bytes of scratch the backward's bias gradient takes for [rows, cols]
// (with GELU when gelu) on CUDA device `device`: ticket counters and [slabs,
// cols] f32 partials (column_sums.cuh); past kMaxSlabCols the counters'
// bytes alone, which the direct form leaves untouched. The scratch must be
// zero the first time; each launch leaves it fit for the next on the same
// stream. cols >= 1.
extern "C" long long proqa_dense_epilogue_bwd_workspace(long long rows, int cols, int gelu,
                                                        int device) {
  if (cols < 1) return 0;
  if (rows < 1 || cols > kMaxSlabCols) return column_sums::kTicketBytes;  // nothing to add up
  return column_sums::workspace_bytes(bwd_across(cols), bwd_slabs(rows, cols, gelu, device),
                                     cols);
}

// The backward of the epilogue, on the current device. dout, z, dz: [rows,
// cols] contiguous, bf16 when is_bf16, else f32. With gelu: dz =
// round(gelu'(z) * dout) (dz nullptr when no product needs it; z is the
// forward's pre-activation); without, dz is dout itself and is not written
// (dz and z nullptr). dbias: [cols] f32, the column sum of f32(dz) (f32(dout)
// without gelu), nullptr for none; workspace: the scratch for it (nullptr
// with dbias), of at least the bytes proqa_dense_epilogue_bwd_workspace
// gives. form: the index of the form in ops/fused_bert.py's
// DENSE_BWD_FORMS, which must be bwd_form_of's for cols and the alignment of
// dout, z and dz. Returns a cudaError_t code.
extern "C" int proqa_dense_epilogue_bwd(const void* dout, const void* z, void* dz,
                                        void* workspace, void* dbias, long long rows, int cols,
                                        int is_bf16, int gelu, int form, void* stream) {
  if (rows < 0 || cols < 1 || (gelu && z == nullptr) ||
      (!gelu && (z != nullptr || dz != nullptr)) ||
      ((dbias == nullptr) != (workspace == nullptr)) ||
      form != bwd_form_of(cols, vector_body(cols, dout, z, dz)))
    return cudaErrorInvalidValue;
  if (rows == 0 && dbias != nullptr) return cudaMemsetAsync(dbias, 0, cols * sizeof(float),
                                                            static_cast<cudaStream_t>(stream));
  if (rows == 0 || (dz == nullptr && dbias == nullptr)) return cudaSuccess;
  int device = 0;
  const cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const int slabs = form == kDirect ? 1 : bwd_slabs(rows, cols, gelu, device);
  if (dbias != nullptr && form != kDirect &&
      column_sums::workspace_bytes(bwd_across(cols), slabs, cols) == 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* db = static_cast<float*>(dbias);
  return is_bf16
             ? launch_bwd<bf16>(dout, z, dz, workspace, db, rows, cols, slabs, gelu, form, s)
             : launch_bwd<float>(dout, z, dz, workspace, db, rows, cols, slabs, gelu, form, s);
}

// F1's SwiGLU form. y: [rows, 2 cols] contiguous, the gate and up products
// (each rounded once from its f32 sum), bf16 when is_bf16, else f32; out:
// [rows, cols] of the same dtype, out = round(silu(gate) * up) in f32 (may
// not alias y). cols >= 1. form: the index of the form in
// ops/fused_bert.py's DENSE_FORMS, which must be swiglu_form_of's for cols
// and the alignment of y and out. Returns a cudaError_t code.
extern "C" int proqa_dense_swiglu(const void* y, void* out, long long rows, int cols,
                                  int is_bf16, int form, void* stream) {
  if (rows < 0 || cols < 1 || form != swiglu_form_of(vector_body(cols, y, out, nullptr)))
    return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_swiglu<bf16>(y, out, rows, cols, form, s)
                 : launch_swiglu<float>(y, out, rows, cols, form, s);
}
