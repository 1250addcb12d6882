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
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

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

__device__ inline float normalize(float v, RowStats s, float scale, float bias) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v, s.mean), s.rstd), scale), bias);
}

// h % (16 / sizeof(Elem)) == 0, every row pointer 16-byte aligned: lane l
// holds the row's vectors l, l + 32, ..., kVecs of them at most.
template <typename Elem, int kVecs>
__global__ void __launch_bounds__(kThreads)
add_layer_norm_vec_kernel(const Elem* __restrict__ x, const Elem* __restrict__ r,
                          const float* __restrict__ scale, const float* __restrict__ bias,
                          Elem* __restrict__ out, long long rows, int h, float inv_h, float eps) {
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
                             Elem* __restrict__ out, long long rows, int h, float inv_h,
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
                long long rows, int h, float inv_h, float eps, cudaStream_t stream) {
  add_layer_norm_vec_kernel<Elem, kVecs><<<grid_for(rows), kThreads, 0, stream>>>(
      x, r, scale, bias, out, rows, h, inv_h, eps);
}

template <typename Elem>
cudaError_t launch(const void* xp, const void* rp, const float* scale, const float* bias,
                   void* outp, long long rows, int h, float eps, cudaStream_t stream) {
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
        x, r, scale, bias, out, rows, h, inv_h, eps);
    return cudaGetLastError();
  }
  switch ((h / kVec + 31) / 32) {  // vectors a lane holds
    case 1: launch_vec<Elem, 1>(x, r, scale, bias, out, rows, h, inv_h, eps, stream); break;
    case 2: launch_vec<Elem, 2>(x, r, scale, bias, out, rows, h, inv_h, eps, stream); break;
    case 3: launch_vec<Elem, 3>(x, r, scale, bias, out, rows, h, inv_h, eps, stream); break;
    case 4: launch_vec<Elem, 4>(x, r, scale, bias, out, rows, h, inv_h, eps, stream); break;
    case 5: launch_vec<Elem, 5>(x, r, scale, bias, out, rows, h, inv_h, eps, stream); break;
    case 6: launch_vec<Elem, 6>(x, r, scale, bias, out, rows, h, inv_h, eps, stream); break;
    case 7: launch_vec<Elem, 7>(x, r, scale, bias, out, rows, h, inv_h, eps, stream); break;
    default: launch_vec<Elem, 8>(x, r, scale, bias, out, rows, h, inv_h, eps, stream); break;
  }
  return cudaGetLastError();
}

}  // namespace

// x, residual (nullptr for none), out: [rows, h] contiguous, bf16 when
// is_bf16, else f32 (out may not alias x or residual); scale, bias: [h] f32.
// h in 1 .. 1,024. Returns a cudaError_t code.
extern "C" int proqa_add_layer_norm(const void* x, const void* residual, const void* scale,
                                    const void* bias, void* out, long long rows, int h, float eps,
                                    int is_bf16, void* stream) {
  if (rows < 0 || h < 1 || h > kMaxWidth) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<bf16>(x, residual, sc, bi, out, rows, h, eps, s)
                 : launch<float>(x, residual, sc, bi, out, rows, h, eps, s);
}
