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
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;     // 2,048 threads: a full SM
constexpr int kGroup = 8;           // elements a thread takes at a time
constexpr int kMaxCols = 12288;     // the bias row in at most 48 KB of shared memory
// ATen's kAlpha: the double M_SQRT1_2 converted to float
constexpr float kSqrt1_2 = static_cast<float>(0.70710678118654752440);

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

template <typename Out, bool kGelu>
__device__ inline Out epilogue(float acc, float bias) {
  const Out t = to_out<Out>(__fadd_rn(acc, bias));
  return kGelu ? to_out<Out>(gelu_erf(to_f32(t))) : t;
}

__device__ inline void stage_bias(const float* __restrict__ bias, float* sbias, int cols) {
  for (int c = threadIdx.x; c < cols; c += kThreads) sbias[c] = bias[c];
  __syncthreads();
}

// cols % 8 == 0 and every pointer 16-byte aligned: group g is elements
// 8 g .. 8 g + 7 of the flat [rows, cols] product, all in one row.
template <typename Out, bool kGelu>
__global__ void __launch_bounds__(kThreads)
dense_epilogue_vec_kernel(const float4* __restrict__ y, const float* __restrict__ bias,
                          Out* __restrict__ out, long long groups, int cols) {
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
    alignas(16) Out o[kGroup];
#pragma unroll
    for (int e = 0; e < kGroup; ++e) o[e] = epilogue<Out, kGelu>(acc[e], bs[e]);
    uint4* dst = reinterpret_cast<uint4*>(out + kGroup * g);
#pragma unroll
    for (int s = 0; s < (int)(kGroup * sizeof(Out) / 16); ++s)
      dst[s] = reinterpret_cast<const uint4*>(o)[s];
    col += step;
    if (col >= per_row) col -= per_row;
  }
}

// Any width, any alignment: one element at a time.
template <typename Out, bool kGelu>
__global__ void __launch_bounds__(kThreads)
dense_epilogue_scalar_kernel(const float* __restrict__ y, const float* __restrict__ bias,
                             Out* __restrict__ out, long long n, int cols) {
  extern __shared__ float4 sbias4[];
  float* sbias = reinterpret_cast<float*>(sbias4);
  stage_bias(bias, sbias, cols);
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n; i += stride)
    out[i] = epilogue<Out, kGelu>(y[i], sbias[i % cols]);
}

int grid_for(long long work) {
  int device = 0, sms = 132;
  if (cudaGetDevice(&device) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long blocks = (work + kThreads - 1) / kThreads;
  const long long most = (long long)sms * kBlocksPerSm;
  return (int)(blocks < most ? blocks : most);
}

template <typename Out, bool kGelu>
cudaError_t launch(const float* y, const float* bias, Out* out, long long rows, int cols,
                   cudaStream_t stream) {
  const long long n = rows * cols;
  const size_t smem = (size_t)cols * sizeof(float);
  const bool aligned = ((reinterpret_cast<uintptr_t>(y) | reinterpret_cast<uintptr_t>(out)) % 16) == 0;
  if (aligned && cols % kGroup == 0) {
    const long long groups = n / kGroup;
    dense_epilogue_vec_kernel<Out, kGelu><<<grid_for(groups), kThreads, smem, stream>>>(
        reinterpret_cast<const float4*>(y), bias, out, groups, cols);
  } else {
    dense_epilogue_scalar_kernel<Out, kGelu><<<grid_for(n), kThreads, smem, stream>>>(
        y, bias, out, n, cols);
  }
  return cudaGetLastError();
}

template <typename Out>
cudaError_t launch_gelu(const void* y, const void* bias, void* out, long long rows, int cols,
                        int gelu, cudaStream_t stream) {
  const float* yf = static_cast<const float*>(y);
  const float* bf = static_cast<const float*>(bias);
  Out* o = static_cast<Out*>(out);
  return gelu ? launch<Out, true>(yf, bf, o, rows, cols, stream)
              : launch<Out, false>(yf, bf, o, rows, cols, stream);
}

}  // namespace

// y: [rows, cols] f32 contiguous (the product), bias: [cols] f32, out:
// [rows, cols] bf16 when out_bf16, else f32 (may not alias y). gelu applies
// the exact GELU after the first rounding and rounds again. cols in
// 1 .. 12,288. Returns a cudaError_t code.
extern "C" int proqa_dense_epilogue(const void* y, const void* bias, void* out, long long rows,
                                    int cols, int out_bf16, int gelu, void* stream) {
  if (rows < 0 || cols < 1 || cols > kMaxCols) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_bf16 ? launch_gelu<bf16>(y, bias, out, rows, cols, gelu, s)
                  : launch_gelu<float>(y, bias, out, rows, cols, gelu, s);
}
