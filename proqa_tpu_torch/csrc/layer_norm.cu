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
// Training: the forward also writes each row's f32 mean and rsqrt(var + eps)
// when asked (8 B a row). The backward, `proqa_add_layer_norm_bwd`, is the
// transpose of the same fusion. It recomputes the rounded sum s = round(x + r)
// from x and the residual (bit-equal to the forward's; the model keeps both
// alive, where a saved s would cost the forward a store), and with
// x^ = (s - mean) * rstd and g = f32(dy) * scale it writes
// dx = round(rstd * (g - mean(g) - x^ * mean(g * x^))), the one gradient of
// both x and the residual (the add's backward), and the column sums
// dscale = sum of dy * x^ and dbias = sum of dy over the rows. Bound by bytes:
// dy, x and r read and dx written, 8 B an element in bf16 (6 B without a
// residual): 0.075 ms for [40,960, 768] at 3.35 TB/s. The design is the
// forward's: a warp a row with the row in registers, the two means by two
// warp reductions, one rounding of dx. The column sums are deterministic: a
// warp keeps its lanes' columns' sums in registers over the rows it takes,
// the block adds its warps' sums in warp order through shared memory into
// one f32 partial per block, and a second kernel (column_sums.cuh) adds the
// blocks in order. No atomics: two launches give the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "column_sums.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;  // rows a block holds at a time
constexpr int kBlocksPerSm = 8;        // 2,048 threads: a full SM
constexpr int kMaxWidth = 1024;        // 32 floats a lane
constexpr int kBwdBlocksPerSm = 2;     // the backward's registers allow two blocks an SM

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

// One element of a row's backward, as it is loaded: x^ = (s - mean) * rstd
// into *xh, the column sums' terms dy x^ and dy, and g = dy * scale, which it
// returns and adds to the row sums of g and g x^.
template <bool kParams>
__device__ inline float element_backward(float s, float dy, float scale, float mean, float rstd,
                                         float* xh, float& ds, float& db, float& sum_g,
                                         float& sum_gx) {
  const float x = normalized(s, mean, rstd);
  if constexpr (kParams) {
    ds = __fadd_rn(ds, __fmul_rn(dy, x));
    db = __fadd_rn(db, dy);
  }
  const float g = __fmul_rn(dy, scale);
  sum_g = __fadd_rn(sum_g, g);
  sum_gx = __fadd_rn(sum_gx, __fmul_rn(g, x));
  *xh = x;
  return g;
}

// rstd * (g - mean(g) - x^ * mean(g x^))
__device__ inline float input_grad(float g, float xh, float rstd, float mean_g, float mean_gx) {
  return __fmul_rn(rstd, __fsub_rn(__fsub_rn(g, mean_g), __fmul_rn(xh, mean_gx)));
}

// The block's column sums: slot k of lane l holds column
// (l + 32 (k / kVec)) kVec + k % kVec when l + 32 (k / kVec) < nvec. The
// warps add theirs in warp order through shared [2, h] (every warp holds
// every column), which goes to partials[block, 2, h].
template <int kPer, int kVec>
__device__ inline void block_column_sums(const float (&ds)[kPer], const float (&db)[kPer],
                                         float* shared, float* __restrict__ partials, int h,
                                         int nvec) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int i = lane + 32 * (k / kVec);
        if (i < nvec) {
          const int c = i * kVec + k % kVec;
          shared[c] = w == 0 ? ds[k] : __fadd_rn(shared[c], ds[k]);
          shared[h + c] = w == 0 ? db[k] : __fadd_rn(shared[h + c], db[k]);
        }
      }
    }
    __syncthreads();
  }
  float* out = partials + (long long)blockIdx.x * 2 * h;
  for (int c = threadIdx.x; c < 2 * h; c += kThreads) out[c] = shared[c];
}

// h % (16 / sizeof(Elem)) == 0, every pointer 16-byte aligned: lane l holds
// the row's vectors l, l + 32, ... as the forward does. dx may be null (no
// input wants it); with kParams the block writes partials[block, 2, h].
template <typename Elem, int kVecs, bool kParams>
__global__ void __launch_bounds__(kThreads, kBwdBlocksPerSm)
add_layer_norm_bwd_vec_kernel(const Elem* __restrict__ dy, const Elem* __restrict__ x,
                              const Elem* __restrict__ r, const float* __restrict__ mean,
                              const float* __restrict__ rstd, const float* __restrict__ scale,
                              Elem* __restrict__ dx, float* __restrict__ partials, long long rows,
                              int h, float inv_h) {
  constexpr int kVec = 16 / sizeof(Elem);
  constexpr int kPer = kVecs * kVec;
  extern __shared__ float shared[];
  const int lane = threadIdx.x & 31;
  const int nvec = h / kVec;
  float ds[kPer] = {}, db[kPer] = {};
  const long long warps = (long long)gridDim.x * kWarps;
  for (long long row = (long long)blockIdx.x * kWarps + threadIdx.x / 32; row < rows;
       row += warps) {
    const uint4* dyr = reinterpret_cast<const uint4*>(dy + row * h);
    const uint4* xr = reinterpret_cast<const uint4*>(x + row * h);
    const uint4* rr = r == nullptr ? nullptr : reinterpret_cast<const uint4*>(r + row * h);
    uint4 dv[kVecs] = {}, xv[kVecs] = {}, rv[kVecs] = {};
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      const int i = lane + 32 * j;
      if (i < nvec) {
        dv[j] = __ldcs(dyr + i);
        xv[j] = __ldcs(xr + i);
        if (rr != nullptr) rv[j] = __ldcs(rr + i);
      }
    }
    const float m = mean[row], rs = rstd[row];
    float xh[kPer], g[kPer], sum_g = 0.0f, sum_gx = 0.0f;
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      const int i = lane + 32 * j;
      if (i < nvec) {
        alignas(16) Elem a[kVec], b[kVec], d[kVec];
        alignas(16) float sc[kVec];
        *reinterpret_cast<uint4*>(a) = xv[j];
        *reinterpret_cast<uint4*>(b) = rv[j];
        *reinterpret_cast<uint4*>(d) = dv[j];
        const float4* scv = reinterpret_cast<const float4*>(scale + i * kVec);
#pragma unroll
        for (int q = 0; q < kVec / 4; ++q) reinterpret_cast<float4*>(sc)[q] = __ldg(scv + q);
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const int k = j * kVec + e;
          const float s = rr == nullptr
                              ? to_f32(a[e])
                              : to_f32(from_f32<Elem>(__fadd_rn(to_f32(a[e]), to_f32(b[e]))));
          g[k] = element_backward<kParams>(s, to_f32(d[e]), sc[e], m, rs, &xh[k], ds[k], db[k],
                                           sum_g, sum_gx);
        }
      }
    }
    const float mean_g = __fmul_rn(warp_sum(sum_g), inv_h);
    const float mean_gx = __fmul_rn(warp_sum(sum_gx), inv_h);
    if (dx != nullptr) {
      uint4* dxr = reinterpret_cast<uint4*>(dx + row * h);
#pragma unroll
      for (int j = 0; j < kVecs; ++j) {
        const int i = lane + 32 * j;
        if (i < nvec) {
          alignas(16) Elem o[kVec];
#pragma unroll
          for (int e = 0; e < kVec; ++e) {
            const int k = j * kVec + e;
            o[e] = from_f32<Elem>(input_grad(g[k], xh[k], rs, mean_g, mean_gx));
          }
          dxr[i] = *reinterpret_cast<const uint4*>(o);
        }
      }
    }
  }
  if constexpr (kParams) block_column_sums<kPer, kVec>(ds, db, shared, partials, h, nvec);
}

// Any width up to kMaxWidth, any alignment: lane l holds the row's elements
// l, l + 32, ... (32 at most).
template <typename Elem, bool kParams>
__global__ void __launch_bounds__(kThreads)
add_layer_norm_bwd_scalar_kernel(const Elem* __restrict__ dy, const Elem* __restrict__ x,
                                 const Elem* __restrict__ r, const float* __restrict__ mean,
                                 const float* __restrict__ rstd,
                                 const float* __restrict__ scale, Elem* __restrict__ dx,
                                 float* __restrict__ partials, long long rows, int h,
                                 float inv_h) {
  constexpr int kPer = kMaxWidth / 32;
  extern __shared__ float shared[];
  const int lane = threadIdx.x & 31;
  float ds[kPer] = {}, db[kPer] = {};
  const long long warps = (long long)gridDim.x * kWarps;
  for (long long row = (long long)blockIdx.x * kWarps + threadIdx.x / 32; row < rows;
       row += warps) {
    const long long base = row * h;
    const float m = mean[row], rs = rstd[row];
    float xh[kPer], g[kPer], sum_g = 0.0f, sum_gx = 0.0f;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int c = lane + 32 * k;
      if (c < h)
        g[k] = element_backward<kParams>(rounded_sum<Elem>(x[base + c], r, base + c),
                                         to_f32(dy[base + c]), scale[c], m, rs, &xh[k], ds[k],
                                         db[k], sum_g, sum_gx);
    }
    const float mean_g = __fmul_rn(warp_sum(sum_g), inv_h);
    const float mean_gx = __fmul_rn(warp_sum(sum_gx), inv_h);
    if (dx != nullptr) {
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int c = lane + 32 * k;
        if (c < h) dx[base + c] = from_f32<Elem>(input_grad(g[k], xh[k], rs, mean_g, mean_gx));
      }
    }
  }
  if constexpr (kParams) block_column_sums<kPer, 1>(ds, db, shared, partials, h, h);
}

// The second stage of the scale and bias gradients (column_sums.cuh)
__global__ void __launch_bounds__(column_sums::kThreads)
add_layer_norm_bwd_sums_kernel(const float* __restrict__ partials, float* __restrict__ out,
                               int slabs, int cols) {
  column_sums::sum_slabs(partials, out, slabs, cols);
}

// The backward's blocks on `device`: kBwdBlocksPerSm an SM, or fewer where
// the rows do not fill them. The row count and the card alone fix them, and
// with them the order of the scale and bias gradients' sums.
int bwd_blocks(long long rows, int device) {
  int sms = 132;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long most = (long long)sms * kBwdBlocksPerSm;
  const long long blocks = (rows + kWarps - 1) / kWarps;
  return blocks < 1 ? 1 : (int)(blocks < most ? blocks : most);
}

template <typename Elem, int kVecs>
void launch_bwd_vec(const Elem* dy, const Elem* x, const Elem* r, const float* mean,
                    const float* rstd, const float* scale, Elem* dx, float* partials,
                    long long rows, int h, int blocks, cudaStream_t stream) {
  const size_t smem = partials != nullptr ? 2 * h * sizeof(float) : 0;
  if (partials != nullptr)
    add_layer_norm_bwd_vec_kernel<Elem, kVecs, true><<<blocks, kThreads, smem, stream>>>(
        dy, x, r, mean, rstd, scale, dx, partials, rows, h, 1.0f / (float)h);
  else
    add_layer_norm_bwd_vec_kernel<Elem, kVecs, false><<<blocks, kThreads, smem, stream>>>(
        dy, x, r, mean, rstd, scale, dx, partials, rows, h, 1.0f / (float)h);
}

template <typename Elem>
cudaError_t launch_bwd(const void* dyp, const void* xp, const void* rp, const float* mean,
                       const float* rstd, const float* scale, void* dxp, float* partials,
                       float* dparams, long long rows, int h, int blocks, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(Elem);
  const Elem* dy = static_cast<const Elem*>(dyp);
  const Elem* x = static_cast<const Elem*>(xp);
  const Elem* r = static_cast<const Elem*>(rp);
  Elem* dx = static_cast<Elem*>(dxp);
  const bool aligned = ((reinterpret_cast<uintptr_t>(dy) | reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(r) | reinterpret_cast<uintptr_t>(dx) |
                         reinterpret_cast<uintptr_t>(scale)) % 16) == 0;
  if (!aligned || h % kVec != 0) {
    const size_t smem = partials != nullptr ? 2 * h * sizeof(float) : 0;
    if (partials != nullptr)
      add_layer_norm_bwd_scalar_kernel<Elem, true><<<blocks, kThreads, smem, stream>>>(
          dy, x, r, mean, rstd, scale, dx, partials, rows, h, 1.0f / (float)h);
    else
      add_layer_norm_bwd_scalar_kernel<Elem, false><<<blocks, kThreads, smem, stream>>>(
          dy, x, r, mean, rstd, scale, dx, partials, rows, h, 1.0f / (float)h);
  } else {
#define PROQA_LN_BWD(n) \
  launch_bwd_vec<Elem, n>(dy, x, r, mean, rstd, scale, dx, partials, rows, h, blocks, stream)
    switch ((h / kVec + 31) / 32) {
      case 1: PROQA_LN_BWD(1); break;
      case 2: PROQA_LN_BWD(2); break;
      case 3: PROQA_LN_BWD(3); break;
      case 4: PROQA_LN_BWD(4); break;
      case 5: PROQA_LN_BWD(5); break;
      case 6: PROQA_LN_BWD(6); break;
      case 7: PROQA_LN_BWD(7); break;
      default: PROQA_LN_BWD(8); break;
    }
#undef PROQA_LN_BWD
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || partials == nullptr) return err;
  add_layer_norm_bwd_sums_kernel<<<column_sums::grid(2 * h), column_sums::block(), 0,
                                   stream>>>(partials, dparams, blocks, 2 * h);
  return cudaGetLastError();
}

}  // namespace

// x, residual (nullptr for none), out: [rows, h] contiguous, bf16 when
// is_bf16, else f32 (out may not alias x or residual); scale, bias: [h] f32;
// mean, rstd: [rows] f32 for the backward, or both nullptr. h in 1 .. 1,024.
// Returns a cudaError_t code.
extern "C" int proqa_add_layer_norm(const void* x, const void* residual, const void* scale,
                                    const void* bias, void* out, void* mean, void* rstd,
                                    long long rows, int h, float eps, int is_bf16,
                                    void* stream) {
  if (rows < 0 || h < 1 || h > kMaxWidth || ((mean == nullptr) != (rstd == nullptr)))
    return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  float* m = static_cast<float*>(mean);
  float* rs = static_cast<float*>(rstd);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<bf16>(x, residual, sc, bi, out, m, rs, rows, h, eps, s)
                 : launch<float>(x, residual, sc, bi, out, m, rs, rows, h, eps, s);
}

// The number of blocks the backward's scale and bias gradients take partials
// of, on CUDA device `device`: its partials are [blocks, 2, h] f32.
extern "C" int proqa_add_layer_norm_bwd_blocks(long long rows, int device) {
  return bwd_blocks(rows, device);
}

// The backward, on the current device. dy, x, residual (nullptr for none),
// dx: [rows, h] contiguous, bf16 when is_bf16, else f32; mean, rstd: [rows]
// f32 from the forward; scale: [h] f32. dx (nullptr when no input wants it)
// receives the gradient of x and of the residual; dparams (nullptr for
// none): [2, h] f32, the scale's gradient then the bias's; partials: f32
// scratch for it (nullptr with dparams), of the size
// proqa_add_layer_norm_bwd_blocks gives. h in 1 .. 1,024. Returns a
// cudaError_t code.
extern "C" int proqa_add_layer_norm_bwd(const void* dy, const void* x, const void* residual,
                                        const void* mean, const void* rstd, const void* scale,
                                        void* dx, void* partials, void* dparams, long long rows,
                                        int h, int is_bf16, void* stream) {
  if (rows < 0 || h < 1 || h > kMaxWidth || ((partials == nullptr) != (dparams == nullptr)))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows == 0 && dparams != nullptr)
    return cudaMemsetAsync(dparams, 0, 2 * h * sizeof(float), s);
  if (rows == 0 || (dx == nullptr && dparams == nullptr)) return cudaSuccess;
  int device = 0;
  const cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const int blocks = bwd_blocks(rows, device);
  const float* m = static_cast<const float*>(mean);
  const float* rs = static_cast<const float*>(rstd);
  const float* sc = static_cast<const float*>(scale);
  float* p = static_cast<float*>(partials);
  float* dp = static_cast<float*>(dparams);
  return is_bf16 ? launch_bwd<bf16>(dy, x, residual, m, rs, sc, dx, p, dp, rows, h, blocks, s)
                 : launch_bwd<float>(dy, x, residual, m, rs, sc, dx, p, dp, rows, h, blocks, s);
}
