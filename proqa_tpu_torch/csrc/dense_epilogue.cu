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
// element-at-a-time loop.
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
// Bound by bytes: with GELU it reads dout and z and writes dz, 6 B an element
// in bf16 (0.225 ms for [40,960, 3,072] at 3.35 TB/s); the sum alone reads
// dout, 2 B. The column sum is deterministic: a block takes 32 column groups
// of 8 side by side and 8 rows at a time over a slab of rows, each thread
// keeps its 8 sums in registers over the slab, the block adds its 8 row lanes
// in order into one f32 partial per slab, and a second kernel
// (column_sums.cuh) adds the slabs in order. No atomics: two launches give
// the same bits.
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
constexpr int kBwdBlocksPerSm = 8;
constexpr int kMaxSlabs = 65535;  // gridDim.y

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

// kG elements of one row from p to f32: one 16-byte load a 16 bytes (kG = 8),
// or element by element (kG = 1)
template <int kG>
__device__ inline void load_f32(const bf16* p, float (&v)[kG]) {
  if constexpr (kG == 8) {
    const uint4 u = __ldcs(reinterpret_cast<const uint4*>(p));
    const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = __bfloat162float(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < kG; ++i) v[i] = __bfloat162float(p[i]);
  }
}
template <int kG>
__device__ inline void load_f32(const float* p, float (&v)[kG]) {
  if constexpr (kG == 8) {
    const float4 a = __ldcs(reinterpret_cast<const float4*>(p));
    const float4 b = __ldcs(reinterpret_cast<const float4*>(p) + 1);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int i = 0; i < kG; ++i) v[i] = p[i];
  }
}
template <typename T, int kG>
__device__ inline void store(T* p, const T (&v)[kG]) {
  if constexpr (kG * sizeof(T) % 16 == 0) {
#pragma unroll
    for (int s = 0; s < (int)(kG * sizeof(T) / 16); ++s)
      reinterpret_cast<uint4*>(p)[s] = reinterpret_cast<const uint4*>(v)[s];
  } else {
#pragma unroll
    for (int i = 0; i < kG; ++i) p[i] = v[i];
  }
}

// The backward. Thread (tx, ty) of block (bx, slab) takes column group
// bx * 32 + tx (kG columns) over rows slab_start + ty, + 8, ... of its slab:
// with GELU it writes dz there (when dz is not null), and with kSum it adds
// f32(dz) (f32(dout) without GELU) per column over those rows; the block then
// adds its 8 row lanes in order into partials[slab, column].
template <typename T, int kG, bool kGelu, bool kSum>
__global__ void __launch_bounds__(kColThreads * kRowThreads)
dense_epilogue_bwd_kernel(const T* __restrict__ dout, const T* __restrict__ z,
                          T* __restrict__ dz, float* __restrict__ partials, long long rows,
                          int cols) {
  __shared__ float lane_sums[kRowThreads][kColThreads * kG];
  const int groups = cols / kG;
  const int group = blockIdx.x * kColThreads + threadIdx.x;
  const long long per_slab = (rows + gridDim.y - 1) / gridDim.y;
  const long long first = (long long)blockIdx.y * per_slab;
  const long long last = first + per_slab < rows ? first + per_slab : rows;
  float sum[kG] = {};
  if (group < groups) {
    for (long long row = first + threadIdx.y; row < last; row += kRowThreads) {
      const long long at = row * cols + (long long)group * kG;
      float d[kG];
      load_f32<kG>(dout + at, d);
      if constexpr (kGelu) {
        float x[kG];
        load_f32<kG>(z + at, x);
        alignas(16) T g[kG];
#pragma unroll
        for (int e = 0; e < kG; ++e) {
          g[e] = to_out<T>(gelu_erf_grad(d[e], x[e]));
          d[e] = to_f32(g[e]);  // the sum adds the rounded dz
        }
        if (dz != nullptr) store<T, kG>(dz + at, g);
      }
      if constexpr (kSum) {
#pragma unroll
        for (int e = 0; e < kG; ++e) sum[e] = __fadd_rn(sum[e], d[e]);
      }
    }
  }
  if constexpr (kSum) {
#pragma unroll
    for (int e = 0; e < kG; ++e) lane_sums[threadIdx.y][threadIdx.x * kG + e] = sum[e];
    __syncthreads();
    // the block's kColThreads * kG columns, one thread a column
    const int tid = threadIdx.y * kColThreads + threadIdx.x;
    for (int c = tid; c < kColThreads * kG; c += kColThreads * kRowThreads) {
      const int col = blockIdx.x * kColThreads * kG + c;
      if (col < cols) {
        float total = lane_sums[0][c];
#pragma unroll
        for (int j = 1; j < kRowThreads; ++j) total = __fadd_rn(total, lane_sums[j][c]);
        partials[(long long)blockIdx.y * cols + col] = total;
      }
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

// The backward's slabs of rows on `device`: enough blocks to fill the card,
// at least kRowThreads rows a slab. The row count, the width and the card
// alone fix them, and with them the order of the bias gradient's sum.
int bwd_slabs(long long rows, int cols, int device) {
  int sms = 132;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long groups = cols % kGroup == 0 ? cols / kGroup : cols;
  const long long across = (groups + kColThreads - 1) / kColThreads;
  const long long most = (long long)sms * kBwdBlocksPerSm / across;
  long long slabs = (rows + kRowThreads - 1) / kRowThreads;
  if (slabs > most) slabs = most;
  if (slabs > kMaxSlabs) slabs = kMaxSlabs;
  return slabs > 1 ? (int)slabs : 1;
}

template <typename Out, bool kGelu, bool kSaveZ>
cudaError_t launch(const float* y, const float* bias, Out* out, Out* z, long long rows, int cols,
                   cudaStream_t stream) {
  const long long n = rows * cols;
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
                        int cols, int gelu, cudaStream_t stream) {
  const float* yf = static_cast<const float*>(y);
  const float* bf = static_cast<const float*>(bias);
  Out* o = static_cast<Out*>(out);
  Out* zo = static_cast<Out*>(z);
  if (!gelu) return launch<Out, false, false>(yf, bf, o, nullptr, rows, cols, stream);
  return zo != nullptr ? launch<Out, true, true>(yf, bf, o, zo, rows, cols, stream)
                       : launch<Out, true, false>(yf, bf, o, nullptr, rows, cols, stream);
}

// The second stage of the bias gradient (column_sums.cuh)
__global__ void __launch_bounds__(column_sums::kThreads)
dense_epilogue_bwd_sums_kernel(const float* __restrict__ partials, float* __restrict__ out,
                               int slabs, int cols) {
  column_sums::sum_slabs(partials, out, slabs, cols);
}

template <typename T, int kG, bool kGelu>
void launch_bwd_body(const T* dout, const T* z, T* dz, float* partials, long long rows,
                     int cols, int slabs, cudaStream_t stream) {
  const dim3 grid((cols / kG + kColThreads - 1) / kColThreads, slabs);
  const dim3 block(kColThreads, kRowThreads);
  if (partials != nullptr)
    dense_epilogue_bwd_kernel<T, kG, kGelu, true><<<grid, block, 0, stream>>>(
        dout, z, dz, partials, rows, cols);
  else
    dense_epilogue_bwd_kernel<T, kG, kGelu, false><<<grid, block, 0, stream>>>(
        dout, z, dz, partials, rows, cols);
}

template <typename T>
cudaError_t launch_bwd(const void* doutp, const void* zp, void* dzp, float* partials,
                       float* dbias, long long rows, int cols, int slabs, int gelu,
                       cudaStream_t stream) {
  const T* dout = static_cast<const T*>(doutp);
  const T* z = static_cast<const T*>(zp);
  T* dz = static_cast<T*>(dzp);
  const bool aligned = ((reinterpret_cast<uintptr_t>(dout) | reinterpret_cast<uintptr_t>(z) |
                         reinterpret_cast<uintptr_t>(dz)) % 16) == 0;
  if (aligned && cols % kGroup == 0) {
    if (gelu) launch_bwd_body<T, kGroup, true>(dout, z, dz, partials, rows, cols, slabs, stream);
    else launch_bwd_body<T, kGroup, false>(dout, z, dz, partials, rows, cols, slabs, stream);
  } else {
    if (gelu) launch_bwd_body<T, 1, true>(dout, z, dz, partials, rows, cols, slabs, stream);
    else launch_bwd_body<T, 1, false>(dout, z, dz, partials, rows, cols, slabs, stream);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || dbias == nullptr) return err;
  dense_epilogue_bwd_sums_kernel<<<column_sums::grid(cols), column_sums::block(), 0,
                                   stream>>>(partials, dbias, slabs, cols);
  return cudaGetLastError();
}

}  // namespace

// y: [rows, cols] f32 contiguous (the product), bias: [cols] f32, out:
// [rows, cols] bf16 when out_bf16, else f32 (may not alias y). gelu applies
// the exact GELU after the first rounding and rounds again; z (nullptr for
// none; only with gelu), like out, receives the rounded pre-activation.
// cols in 1 .. 12,288. Returns a cudaError_t code.
extern "C" int proqa_dense_epilogue(const void* y, const void* bias, void* out, void* z,
                                    long long rows, int cols, int out_bf16, int gelu,
                                    void* stream) {
  if (rows < 0 || cols < 1 || cols > kMaxCols || (z != nullptr && !gelu))
    return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_bf16 ? launch_gelu<bf16>(y, bias, out, z, rows, cols, gelu, s)
                  : launch_gelu<float>(y, bias, out, z, rows, cols, gelu, s);
}

// The number of slabs the backward's bias gradient takes partials of, on
// CUDA device `device`: its partials are [slabs, cols] f32.
extern "C" int proqa_dense_epilogue_bwd_slabs(long long rows, int cols, int device) {
  return bwd_slabs(rows, cols, device);
}

// The backward of the epilogue, on the current device. dout, z, dz: [rows,
// cols] contiguous, bf16 when is_bf16, else f32. With gelu: dz =
// round(gelu'(z) * dout) (dz nullptr when no product needs it; z is the
// forward's pre-activation); without, dz is dout itself and is not written
// (dz and z nullptr). dbias: [cols] f32, the column sum of f32(dz) (f32(dout)
// without gelu), nullptr for none; partials: f32 scratch for it, of the size
// proqa_dense_epilogue_bwd_slabs gives. Returns a cudaError_t code.
extern "C" int proqa_dense_epilogue_bwd(const void* dout, const void* z, void* dz,
                                        void* partials, void* dbias, long long rows, int cols,
                                        int is_bf16, int gelu, void* stream) {
  if (rows < 0 || cols < 1 || (gelu && z == nullptr) ||
      (!gelu && (z != nullptr || dz != nullptr)) || ((dbias == nullptr) != (partials == nullptr)))
    return cudaErrorInvalidValue;
  if (rows == 0 && dbias != nullptr) return cudaMemsetAsync(dbias, 0, cols * sizeof(float),
                                                            static_cast<cudaStream_t>(stream));
  if (rows == 0 || (dz == nullptr && dbias == nullptr)) return cudaSuccess;
  int device = 0;
  const cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const int slabs = bwd_slabs(rows, cols, device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partials);
  float* db = static_cast<float*>(dbias);
  return is_bf16 ? launch_bwd<bf16>(dout, z, dz, p, db, rows, cols, slabs, gelu, s)
                 : launch_bwd<float>(dout, z, dz, p, db, rows, cols, slabs, gelu, s);
}
