// K3: fused attention backward, with the forward's dropout mask regenerated.
//
// Replaces proqa_tpu/ops/pallas_attention.py:_bwd_kernel (launched by _fa_bwd,
// pallas_attention.py:175). Per (batch, head), with p the forward's f32
// probabilities and keep its dropout mask (formulas of :97-124):
//   pd  = keep ? p / (1 - rate) : 0, rounded to the input dtype
//   dv  = pd^T do                        (f32 accumulation, rounded)
//   dpd = do v^T                         (f32)
//   dp  = keep ? dpd / (1 - rate) : 0
//   ds  = p * (dp - rowsum(p * dp)) * scale, rounded to the input dtype
//   dq  = ds k,  dk = ds^T q             (f32 accumulation, rounded)
// Only q, k, v, the key mask and the dropout keys come in: s and p are
// recomputed and the mask is regenerated from the keys (random.cuh).
//
// What bounds it on the H100: per (batch, head) 10 T^2 Dh FLOP for 7 T Dh
// elements moved (q, k, v, do in; dq, dk, dv out), so it is arithmetic-bound
// in principle. This simple version recomputes the scores twice (14 T^2 Dh
// FLOP in all) and is bound by f32 tiles in shared memory and wmma fragment
// loads from L2, like K2.
//
// What the design does about it: the TPU kernel keeps a whole (batch, head)
// in VMEM; at T = 512 and Dh = 64, q, k, v and do alone exceed a block's
// 227 KB of shared memory, so the work is split into two passes that need no
// atomics, and the result is the same from run to run.
//   Pass 1, one block per 16 query rows: recomputes the f32 score rows and
//   their softmax exactly as K2 does (max, exp, sum, divide, in K2's order),
//   computes dpd, dp, D = rowsum(p * dp) and ds, writes dq, and writes each
//   row's (max, sum, D) to a scratch array.
//   Pass 2, one block per 16 keys: recomputes the transposed score tile
//   k q^T and p = exp(x - max) / sum from pass 1's row statistics (the
//   forward's own arithmetic, not a stored log-sum-exp), regenerates the
//   mask, and writes dv and dk.
#include <type_traits>

#include "attention_tiles.cuh"
#include "random.cuh"

namespace {

using namespace attn;

template <typename Elem, int DH>
size_t smem_bytes(int seq) {
  // two f32 score tiles, the key bias (pass 1) or the row statistics (pass 2),
  // two output tiles, and either two dtype tiles (bf16) or staged rows (f32)
  size_t bytes = 2 * (size_t)kRows * (seq + 4) * sizeof(float)
                 + 3 * (size_t)seq * sizeof(float)
                 + 2 * (size_t)kRows * (DH + 4) * sizeof(float);
  if constexpr (std::is_same_v<Elem, bf16>)
    bytes += 2 * (size_t)kRows * (seq + 8) * sizeof(bf16);
  else
    bytes += 2 * (size_t)kRows * DH * sizeof(float);
  return bytes;
}

struct Tiles {
  float* s;      // [kRows][s_ld] scores, then p (pass 1) or pd (pass 2, f32)
  float* dpd;    // [kRows][s_ld] do v^T, then ds (f32)
  float* vec;    // [3][seq]: key bias (pass 1) or max, sum, D per query (pass 2)
  float* o1;     // [kRows][o_ld]
  float* o2;     // [kRows][o_ld]
  unsigned char* rest;
};

template <int DH>
__device__ Tiles carve(unsigned char* smem, int seq) {
  // every region starts on a 128-byte boundary: seq % 128 == 0, DH % 16 == 0
  Tiles t;
  const int s_ld = seq + 4, o_ld = DH + 4;
  t.s = reinterpret_cast<float*>(smem);
  t.dpd = t.s + kRows * s_ld;
  t.vec = t.dpd + kRows * s_ld;
  t.o1 = t.vec + 3 * seq;
  t.o2 = t.o1 + kRows * o_ld;
  t.rest = reinterpret_cast<unsigned char*>(t.o2 + kRows * o_ld);
  return t;
}

// a_tile . b^T for the tile's rows of `a` against every row of `b`, into s.
template <typename Elem, int DH>
__device__ void scores(const Elem* a_tile, const Elem* b, float* s, int s_ld, int seq,
                       Elem* stage) {
  if constexpr (std::is_same_v<Elem, bf16>) {
    score_rows<DH>(a_tile, b, s, s_ld, seq);
  } else {
    stage_rows<DH>(a_tile, stage);
    __syncthreads();
    score_rows<DH>(stage, b, s, s_ld, seq);
  }
}

// Pass 1: one block per (batch, head, 16 query rows); writes dq and the rows'
// statistics.
template <typename Elem, int DH>
__global__ void __launch_bounds__(kThreads)
attention_bwd_rows_kernel(const Elem* __restrict__ q, const Elem* __restrict__ k,
                          const Elem* __restrict__ v, const Elem* __restrict__ dout,
                          const int* __restrict__ key_mask, Elem* __restrict__ dq,
                          float* __restrict__ stats, int heads, int seq, float scale,
                          DropoutParams drop) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int b = blockIdx.z, h = blockIdx.y, row0 = blockIdx.x * kRows;
  const size_t bh = (size_t)b * heads + h, slice = bh * seq * DH;
  const size_t rows_total = (size_t)gridDim.z * heads * seq;
  const int s_ld = seq + 4, o_ld = DH + 4;
  Tiles t = carve<DH>(smem, seq);
  float* bias = t.vec;
  for (int c = threadIdx.x; c < seq; c += kThreads)
    bias[c] = key_mask[(size_t)b * seq + c] != 0 ? 0.0f : kMaskBias;

  Elem* stage = reinterpret_cast<Elem*>(t.rest);   // f32: [kRows][DH] staged rows
  scores<Elem, DH>(q + slice + (size_t)row0 * DH, k + slice, t.s, s_ld, seq, stage);
  __syncthreads();
  scores<Elem, DH>(dout + slice + (size_t)row0 * DH, v + slice, t.dpd, s_ld, seq,
                   stage + kRows * DH);
  __syncthreads();

  Elem* ds;
  int ds_ld;
  if constexpr (std::is_same_v<Elem, bf16>) {
    ds = reinterpret_cast<Elem*>(t.rest);          // [kRows][seq + 8]
    ds_ld = seq + 8;
  } else {
    ds = t.s;                                      // in place of p
    ds_ld = s_ld;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < kRows; r += kWarps) {
    float* srow = t.s + r * s_ld;
    float* drow = t.dpd + r * s_ld;
    // the forward's softmax, step for step (attention_fwd.cu:softmax_rows)
    float m = -INFINITY;
    for (int c = lane; c < seq; c += 32) {
      const float x = __fadd_rn(__fmul_rn(srow[c], scale), bias[c]);
      srow[c] = x;
      m = fmaxf(m, x);
    }
    m = warp_max(m);
    float sum = 0.0f;
    for (int c = lane; c < seq; c += 32) {
      const float e = expf(srow[c] - m);
      srow[c] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    const uint64_t counter = (bh * seq + row0 + r) * (uint64_t)seq;
    float dsum = 0.0f;
    for (int c = lane; c < seq; c += 32) {
      const float p = srow[c] / sum;
      float dp = drow[c];
      if (drop.active)
        dp = proqa_keep(drop.k0, drop.k1, counter + c, drop.threshold)
                 ? __fmul_rn(dp, drop.inv_keep) : 0.0f;
      srow[c] = p;
      drow[c] = dp;
      dsum = __fadd_rn(dsum, __fmul_rn(p, dp));
    }
    const float dsum_row = warp_sum(dsum);
    Elem* dsrow = ds + r * ds_ld;
    for (int c = lane; c < seq; c += 32)
      store(dsrow + c, __fmul_rn(__fmul_rn(srow[c], __fsub_rn(drow[c], dsum_row)), scale));
    if (lane == 0) {
      const size_t i = bh * seq + row0 + r;
      stats[i] = m;
      stats[rows_total + i] = sum;
      stats[2 * rows_total + i] = dsum_row;
    }
  }
  __syncthreads();
  weigh_values<DH>(ds, ds_ld, k + slice, t.o1, o_ld, seq);
  __syncthreads();
  write_rows<DH>(t.o1, o_ld, dq + slice + (size_t)row0 * DH);
}

// Pass 2: one block per (batch, head, 16 keys); writes dv and dk.
template <typename Elem, int DH>
__global__ void __launch_bounds__(kThreads)
attention_bwd_cols_kernel(const Elem* __restrict__ q, const Elem* __restrict__ k,
                          const Elem* __restrict__ v, const Elem* __restrict__ dout,
                          const int* __restrict__ key_mask, const float* __restrict__ stats,
                          Elem* __restrict__ dk, Elem* __restrict__ dv, int heads, int seq,
                          float scale, DropoutParams drop) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int b = blockIdx.z, h = blockIdx.y, key0 = blockIdx.x * kRows;
  const size_t bh = (size_t)b * heads + h, slice = bh * seq * DH;
  const size_t rows_total = (size_t)gridDim.z * heads * seq;
  const int s_ld = seq + 4, o_ld = DH + 4;
  Tiles t = carve<DH>(smem, seq);
  float* row_max = t.vec;
  float* row_sum = t.vec + seq;
  float* row_d = t.vec + 2 * seq;
  for (int c = threadIdx.x; c < seq; c += kThreads) {
    const size_t i = bh * seq + c;
    row_max[c] = stats[i];
    row_sum[c] = stats[rows_total + i];
    row_d[c] = stats[2 * rows_total + i];
  }

  Elem* stage = reinterpret_cast<Elem*>(t.rest);   // f32: [kRows][DH] staged rows
  // transposed tiles: row r is key key0 + r, column c is query c
  scores<Elem, DH>(k + slice + (size_t)key0 * DH, q + slice, t.s, s_ld, seq, stage);
  __syncthreads();
  scores<Elem, DH>(v + slice + (size_t)key0 * DH, dout + slice, t.dpd, s_ld, seq,
                   stage + kRows * DH);
  __syncthreads();

  Elem *pd, *ds;
  int ld;
  if constexpr (std::is_same_v<Elem, bf16>) {
    pd = reinterpret_cast<Elem*>(t.rest);          // [kRows][seq + 8]
    ds = pd + kRows * (seq + 8);
    ld = seq + 8;
  } else {
    pd = t.s;                                      // in place
    ds = t.dpd;
    ld = s_ld;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < kRows; r += kWarps) {
    const int j = key0 + r;
    const float bias = key_mask[(size_t)b * seq + j] != 0 ? 0.0f : kMaskBias;
    float* srow = t.s + r * s_ld;
    float* drow = t.dpd + r * s_ld;
    Elem* pdrow = pd + r * ld;
    Elem* dsrow = ds + r * ld;
    for (int c = lane; c < seq; c += 32) {
      const float x = __fadd_rn(__fmul_rn(srow[c], scale), bias);
      const float p = expf(x - row_max[c]) / row_sum[c];
      float pdv = p, dp = drow[c];
      if (drop.active) {
        const bool keep =
            proqa_keep(drop.k0, drop.k1, (bh * seq + c) * (uint64_t)seq + j, drop.threshold);
        pdv = keep ? __fmul_rn(p, drop.inv_keep) : 0.0f;
        dp = keep ? __fmul_rn(dp, drop.inv_keep) : 0.0f;
      }
      const float dsv = __fmul_rn(__fmul_rn(p, __fsub_rn(dp, row_d[c])), scale);
      store(pdrow + c, pdv);   // f32: in place of s[r][c], read above
      store(dsrow + c, dsv);   // f32: in place of dpd[r][c], read above
    }
  }
  __syncthreads();
  weigh_values<DH>(pd, ld, dout + slice, t.o1, o_ld, seq);
  weigh_values<DH>(ds, ld, q + slice, t.o2, o_ld, seq);
  __syncthreads();
  write_rows<DH>(t.o1, o_ld, dv + slice + (size_t)key0 * DH);
  write_rows<DH>(t.o2, o_ld, dk + slice + (size_t)key0 * DH);
}

template <typename Elem, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const void* key_mask, void* dq, void* dk, void* dv, void* stats, int batch,
                   int heads, int seq, float scale, DropoutParams drop, cudaStream_t stream) {
  const size_t smem = smem_bytes<Elem, DH>(seq);
  cudaError_t err = cudaFuncSetAttribute(attention_bwd_rows_kernel<Elem, DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(attention_bwd_cols_kernel<Elem, DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(seq / kRows, heads, batch);
  const Elem* qe = static_cast<const Elem*>(q);
  const Elem* ke = static_cast<const Elem*>(k);
  const Elem* ve = static_cast<const Elem*>(v);
  const Elem* de = static_cast<const Elem*>(dout);
  const int* mask = static_cast<const int*>(key_mask);
  float* st = static_cast<float*>(stats);
  attention_bwd_rows_kernel<Elem, DH><<<grid, kThreads, smem, stream>>>(
      qe, ke, ve, de, mask, static_cast<Elem*>(dq), st, heads, seq, scale, drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_bwd_cols_kernel<Elem, DH><<<grid, kThreads, smem, stream>>>(
      qe, ke, ve, de, mask, st, static_cast<Elem*>(dk), static_cast<Elem*>(dv), heads, seq,
      scale, drop);
  return cudaGetLastError();
}

template <typename Elem>
cudaError_t launch_dh(const void* q, const void* k, const void* v, const void* dout,
                      const void* key_mask, void* dq, void* dk, void* dv, void* stats,
                      int batch, int heads, int seq, int head_dim, float scale,
                      DropoutParams drop, cudaStream_t stream) {
  switch (head_dim) {
    case 16:
      return launch<Elem, 16>(q, k, v, dout, key_mask, dq, dk, dv, stats, batch, heads, seq,
                              scale, drop, stream);
    case 64:
      return launch<Elem, 64>(q, k, v, dout, key_mask, dq, dk, dv, stats, batch, heads, seq,
                              scale, drop, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, dout, dq, dk, dv [batch, heads, seq, head_dim] row-major (bf16
// when is_bf16, else f32; 32-byte aligned); head_dim 16 or 64; key_mask int32
// [batch, seq], nonzero = attend; stats f32 scratch [3, batch * heads * seq].
// Dropout as in proqa_attention_fwd. Returns a cudaError_t code.
extern "C" int proqa_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* dout, const void* key_mask, void* dq, void* dk,
                                   void* dv, void* stats, int batch, int heads, int seq,
                                   int head_dim, float scale, int is_bf16, int dropout,
                                   uint32_t k0, uint32_t k1, uint32_t threshold, float inv_keep,
                                   void* stream) {
  if (batch <= 0 || heads <= 0 || batch > kMaxGrid || heads > kMaxGrid || seq <= 0 ||
      seq % 128 != 0 || seq > kMaxSeq)
    return cudaErrorInvalidValue;
  const DropoutParams drop{k0, k1, threshold, inv_keep, dropout};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_dh<bf16>(q, k, v, dout, key_mask, dq, dk, dv, stats, batch, heads,
                                   seq, head_dim, scale, drop, s)
                 : launch_dh<float>(q, k, v, dout, key_mask, dq, dk, dv, stats, batch, heads,
                                    seq, head_dim, scale, drop, s);
}
