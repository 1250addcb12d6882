// K2: fused attention forward for BERT encoding, at dropout rate 0.
//
// Replaces proqa_tpu/ops/pallas_attention.py:_fwd_kernel (launched by
// _fused_attention, pallas_attention.py:150). Per (batch, head):
// out = softmax(q k^T * scale + key-padding bias) v, with the scores and the
// softmax in f32, the probabilities rounded to the input dtype for p v, f32
// accumulation, and the output in the input dtype.
//
// What bounds it on the H100: a (batch, head) slice moves 4 * T * Dh elements
// (q, k, v, out) for 4 * T^2 * Dh FLOP, about T / 2 FLOP per bf16 byte, so at
// T >= 256 the slice is arithmetic-bound in principle. This simple version is
// bound instead by the f32 score rows' round trip through shared memory and by
// wmma fragment loads of k and v, which come from L2 once per 16 query rows.
//
// What the design does about it: one CUDA block (4 warps) per (batch, head,
// 16 query rows). The block keeps the whole f32 score row in shared memory
// (T <= 1024 keys, at most 64 KB for 16 rows) and takes an exact row softmax
// there: max, exp, sum, divide, in the order of jax.nn.softmax. Only then are
// the probabilities rounded to the input dtype, as the TPU kernel rounds
// them. There is no online rescaling, so the rounding points match the
// reference. The scale and the bias are applied with explicit round-to-nearest
// multiply and add, so the compiler cannot fuse them into one FMA that the
// reference does not do. The mask bias is -1e30, not -inf: a row whose keys
// are all padding gets the uniform softmax the reference gives, never NaN.
// bf16 inputs use nvcuda::wmma (16x16x16, f32 accumulators). f32 inputs use
// plain FMA, since the reference pins f32 to full precision.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <type_traits>

namespace {

using namespace nvcuda;

constexpr int kRows = 16;        // query rows per CUDA block
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxSeq = 1024;
constexpr int kMaxGrid = 65535;
constexpr float kMaskBias = -1e30f;  // pallas_attention.py:32

using bf16 = __nv_bfloat16;

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

// s[r][c] = q[r] . k[c] for the tile's 16 query rows and all `seq` keys.
template <int DH>
__device__ void score_rows(const bf16* q, const bf16* k, float* s, int s_ld, int seq) {
  const int warp = threadIdx.x / 32;
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[DH / 16];
  for (int d = 0; d < DH / 16; ++d) wmma::load_matrix_sync(a[d], q + d * 16, DH);
  wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
  for (int kt = warp; kt < seq / 16; kt += kWarps) {
    wmma::fill_fragment(acc, 0.0f);
    for (int d = 0; d < DH / 16; ++d) {
      // B[d][c] = k[c][d]: the key tile read column-major
      wmma::load_matrix_sync(b, k + (size_t)kt * 16 * DH + d * 16, DH);
      wmma::mma_sync(acc, a[d], b, acc);
    }
    wmma::store_matrix_sync(s + kt * 16, acc, s_ld, wmma::mem_row_major);
  }
}

// f32 version; qs is the tile's query rows already in shared memory.
template <int DH>
__device__ void score_rows(const float* qs, const float* k, float* s, int s_ld, int seq) {
  for (int c = threadIdx.x; c < seq; c += kThreads) {
    float acc[kRows] = {};
    const float* kr = k + (size_t)c * DH;
    for (int d = 0; d < DH; ++d) {
      const float kv = kr[d];
      for (int r = 0; r < kRows; ++r) acc[r] = fmaf(qs[r * DH + d], kv, acc[r]);
    }
    for (int r = 0; r < kRows; ++r) s[r * s_ld + c] = acc[r];
  }
}

// Row softmax of (s * scale + bias) in f32; p receives the probabilities in the
// input dtype (p may alias s when that dtype is f32).
template <typename Elem>
__device__ void softmax_rows(float* s, int s_ld, const float* bias, float scale,
                             Elem* p, int p_ld, int seq) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < kRows; r += kWarps) {
    float* row = s + r * s_ld;
    float m = -INFINITY;
    for (int c = lane; c < seq; c += 32) {
      const float x = __fadd_rn(__fmul_rn(row[c], scale), bias[c]);
      row[c] = x;
      m = fmaxf(m, x);
    }
    m = warp_max(m);
    float sum = 0.0f;
    for (int c = lane; c < seq; c += 32) {
      const float e = expf(row[c] - m);
      row[c] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    Elem* prow = p + r * p_ld;
    for (int c = lane; c < seq; c += 32) store(prow + c, row[c] / sum);
  }
}

// o[r][d] = sum_c p[r][c] v[c][d], f32 accumulation.
template <int DH>
__device__ void weigh_values(const bf16* p, int p_ld, const bf16* v, float* o, int o_ld,
                             int seq) {
  const int warp = threadIdx.x / 32;
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
  for (int n = warp; n < DH / 16; n += kWarps) {
    wmma::fill_fragment(acc, 0.0f);
    for (int c = 0; c < seq; c += 16) {
      wmma::load_matrix_sync(a, p + c, p_ld);
      wmma::load_matrix_sync(b, v + (size_t)c * DH + n * 16, DH);
      wmma::mma_sync(acc, a, b, acc);
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

template <typename Elem, int DH>
size_t smem_bytes(int seq) {
  size_t bytes = (size_t)kRows * (seq + 4) * sizeof(float)   // scores
                 + (size_t)seq * sizeof(float)               // key bias
                 + (size_t)kRows * (DH + 4) * sizeof(float); // output tile
  if constexpr (std::is_same_v<Elem, bf16>)
    bytes += (size_t)kRows * (seq + 8) * sizeof(bf16);       // probabilities
  else
    bytes += (size_t)kRows * DH * sizeof(float);             // query rows
  return bytes;
}

template <typename Elem, int DH>
__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel(const Elem* __restrict__ q, const Elem* __restrict__ k,
                     const Elem* __restrict__ v, const int* __restrict__ key_mask,
                     Elem* __restrict__ out, int heads, int seq, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int b = blockIdx.z, h = blockIdx.y, row0 = blockIdx.x * kRows;
  const size_t slice = ((size_t)b * heads + h) * seq * DH;
  const int s_ld = seq + 4, o_ld = DH + 4;
  // every region below starts on a 128-byte boundary: seq % 128 == 0, DH % 16 == 0
  float* s = reinterpret_cast<float*>(smem);        // [kRows][s_ld]
  float* bias = s + kRows * s_ld;                    // [seq]
  float* o = bias + seq;                             // [kRows][o_ld]
  unsigned char* rest = reinterpret_cast<unsigned char*>(o + kRows * o_ld);

  for (int c = threadIdx.x; c < seq; c += kThreads)
    bias[c] = key_mask[(size_t)b * seq + c] != 0 ? 0.0f : kMaskBias;
  const Elem* qt = q + slice + (size_t)row0 * DH;
  const Elem* kt = k + slice;
  const Elem* vt = v + slice;

  Elem* p;
  int p_ld;
  if constexpr (std::is_same_v<Elem, bf16>) {
    score_rows<DH>(qt, kt, s, s_ld, seq);
    p = reinterpret_cast<Elem*>(rest);               // [kRows][seq + 8]
    p_ld = seq + 8;
  } else {
    float* qs = reinterpret_cast<float*>(rest);      // [kRows][DH]
    for (int i = threadIdx.x; i < kRows * DH; i += kThreads) qs[i] = qt[i];
    __syncthreads();
    score_rows<DH>(qs, kt, s, s_ld, seq);
    p = s;                                           // normalised in place
    p_ld = s_ld;
  }
  __syncthreads();
  softmax_rows(s, s_ld, bias, scale, p, p_ld, seq);
  __syncthreads();
  weigh_values<DH>(p, p_ld, vt, o, o_ld, seq);
  __syncthreads();
  Elem* ot = out + slice + (size_t)row0 * DH;
  for (int i = threadIdx.x; i < kRows * DH; i += kThreads)
    store(ot + i, o[(i / DH) * o_ld + i % DH]);
}

template <typename Elem, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const void* key_mask,
                   void* out, int batch, int heads, int seq, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<Elem, DH>(seq);
  cudaError_t err = cudaFuncSetAttribute(attention_fwd_kernel<Elem, DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(seq / kRows, heads, batch);
  attention_fwd_kernel<Elem, DH><<<grid, kThreads, smem, stream>>>(
      static_cast<const Elem*>(q), static_cast<const Elem*>(k), static_cast<const Elem*>(v),
      static_cast<const int*>(key_mask), static_cast<Elem*>(out), heads, seq, scale);
  return cudaGetLastError();
}

template <typename Elem>
cudaError_t launch_dh(const void* q, const void* k, const void* v, const void* key_mask,
                      void* out, int batch, int heads, int seq, int head_dim, float scale,
                      cudaStream_t stream) {
  switch (head_dim) {
    case 16: return launch<Elem, 16>(q, k, v, key_mask, out, batch, heads, seq, scale, stream);
    case 64: return launch<Elem, 64>(q, k, v, key_mask, out, batch, heads, seq, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, out [batch, heads, seq, head_dim] row-major (bf16 when is_bf16,
// else f32; 32-byte aligned); head_dim 16 or 64; key_mask int32 [batch, seq],
// nonzero = attend. Returns a cudaError_t code.
extern "C" int proqa_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* key_mask, void* out, int batch, int heads,
                                   int seq, int head_dim, float scale, int is_bf16,
                                   void* stream) {
  if (batch <= 0 || heads <= 0 || batch > kMaxGrid || heads > kMaxGrid || seq <= 0 ||
      seq % 128 != 0 || seq > kMaxSeq)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16
             ? launch_dh<bf16>(q, k, v, key_mask, out, batch, heads, seq, head_dim, scale, s)
             : launch_dh<float>(q, k, v, key_mask, out, batch, heads, seq, head_dim, scale, s);
}
