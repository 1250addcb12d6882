// K2: fused attention forward for BERT, with in-kernel attention dropout.
//
// Replaces proqa_tpu/ops/pallas_attention.py:_fwd_kernel (launched by
// _fused_attention, pallas_attention.py:150). Per (batch, head):
// out = dropout(softmax(q k^T * scale + key-padding bias)) v, with the scores
// and the softmax in f32, the dropout mask and its 1/(1-rate) scale applied
// to the normalised f32 probabilities, then the probabilities rounded to the
// input dtype for p v, f32 accumulation, and the output in the input dtype:
// the rounding points of pallas_attention.py:73-80.
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
// there: max, exp, sum, divide, in the order of jax.nn.softmax. Only then is
// the dropout mask applied and are the probabilities rounded to the input
// dtype, as the TPU kernel does. There is no online rescaling, so the
// rounding points match the reference. The scale and the bias are applied
// with explicit round-to-nearest multiply and add, so the compiler cannot
// fuse them into one FMA that the reference does not do. The mask bias is
// -1e30, not -inf: a row whose keys are all padding gets the uniform softmax
// the reference gives, never NaN. The dropout mask of element (b, h, i, j) is
// the counter-based hash of its flat index ((b * H + h) * T + i) * T + j
// (random.cuh), so K3 and the plain version regenerate it exactly.
#include <type_traits>

#include "attention_tiles.cuh"
#include "random.cuh"

namespace {

using namespace attn;

// Row softmax of (s * scale + bias) in f32, then dropout; p receives the
// probabilities in the input dtype (p may alias s when that dtype is f32).
// `counter0` is the flat [B, H, T, T] index of the tile's element (0, 0).
template <typename Elem>
__device__ void softmax_rows(float* s, int s_ld, const float* bias, float scale,
                             Elem* p, int p_ld, int seq, DropoutParams drop,
                             uint64_t counter0) {
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
    const uint64_t counter = counter0 + (uint64_t)r * seq;
    for (int c = lane; c < seq; c += 32) {
      float pr = row[c] / sum;
      if (drop.active)
        pr = proqa_keep(drop.k0, drop.k1, counter + c, drop.threshold)
                 ? __fmul_rn(pr, drop.inv_keep) : 0.0f;
      store(prow + c, pr);
    }
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
                     Elem* __restrict__ out, int heads, int seq, float scale,
                     DropoutParams drop) {
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
    stage_rows<DH>(qt, qs);
    __syncthreads();
    score_rows<DH>(qs, kt, s, s_ld, seq);
    p = s;                                           // normalised in place
    p_ld = s_ld;
  }
  __syncthreads();
  const uint64_t counter0 = (((uint64_t)b * heads + h) * seq + row0) * (uint64_t)seq;
  softmax_rows(s, s_ld, bias, scale, p, p_ld, seq, drop, counter0);
  __syncthreads();
  weigh_values<DH>(p, p_ld, vt, o, o_ld, seq);
  __syncthreads();
  write_rows<DH>(o, o_ld, out + slice + (size_t)row0 * DH);
}

template <typename Elem, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const void* key_mask,
                   void* out, int batch, int heads, int seq, float scale,
                   DropoutParams drop, cudaStream_t stream) {
  const size_t smem = smem_bytes<Elem, DH>(seq);
  cudaError_t err = cudaFuncSetAttribute(attention_fwd_kernel<Elem, DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(seq / kRows, heads, batch);
  attention_fwd_kernel<Elem, DH><<<grid, kThreads, smem, stream>>>(
      static_cast<const Elem*>(q), static_cast<const Elem*>(k), static_cast<const Elem*>(v),
      static_cast<const int*>(key_mask), static_cast<Elem*>(out), heads, seq, scale, drop);
  return cudaGetLastError();
}

template <typename Elem>
cudaError_t launch_dh(const void* q, const void* k, const void* v, const void* key_mask,
                      void* out, int batch, int heads, int seq, int head_dim, float scale,
                      DropoutParams drop, cudaStream_t stream) {
  switch (head_dim) {
    case 16:
      return launch<Elem, 16>(q, k, v, key_mask, out, batch, heads, seq, scale, drop, stream);
    case 64:
      return launch<Elem, 64>(q, k, v, key_mask, out, batch, heads, seq, scale, drop, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, out [batch, heads, seq, head_dim] row-major (bf16 when is_bf16,
// else f32; 32-byte aligned); head_dim 16 or 64; key_mask int32 [batch, seq],
// nonzero = attend. Dropout on the probabilities when `dropout` is nonzero,
// with the keys, threshold and 1/(1-rate) of ops/random.py. Returns a
// cudaError_t code.
extern "C" int proqa_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* key_mask, void* out, int batch, int heads,
                                   int seq, int head_dim, float scale, int is_bf16,
                                   int dropout, uint32_t k0, uint32_t k1, uint32_t threshold,
                                   float inv_keep, void* stream) {
  if (batch <= 0 || heads <= 0 || batch > kMaxGrid || heads > kMaxGrid || seq <= 0 ||
      seq % 128 != 0 || seq > kMaxSeq)
    return cudaErrorInvalidValue;
  const DropoutParams drop{k0, k1, threshold, inv_keep, dropout};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16
             ? launch_dh<bf16>(q, k, v, key_mask, out, batch, heads, seq, head_dim, scale, drop, s)
             : launch_dh<float>(q, k, v, key_mask, out, batch, heads, seq, head_dim, scale, drop,
                                s);
}
