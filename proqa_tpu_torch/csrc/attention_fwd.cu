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
// What bounds it on the H100: a (batch, head) slice moves 4 T Dh elements
// (q, k, v, out) for 4 T^2 Dh FLOP, T / 2 FLOP per bf16 byte, under the
// card's 295 FLOP a byte: at T <= 1024 the bound is bytes, whatever Dh. What
// the kernel spends instead is issue slots: per score two exps (the sum, then
// p), a correctly rounded division and, at a dropout rate above 0, the
// mask hash's integer operations (random.cuh), against 6 Dh tensor-core FLOP.
//
// What the design does about it (bf16): one block per (batch, head, 128
// query rows), two warpgroups of 64 rows each. A warpgroup's q tile is loaded
// once into shared memory; the slice's k and v tiles stream through a ring
// of kStages buffers filled by cp.async one item ahead and shared by both
// warpgroups, so each k and v tile crosses L2 once per 128 query rows. Every
// product is a wgmma with f32 accumulators in registers. Sweep 1 computes
// s = q k^T, 128 keys an item, and keeps each row's maximum and the sum of
// exp(x - max), the sum rescaled by exp(old max - new max) when the maximum
// grows (RowStats). Sweep 2 recomputes s 64 keys at a time, forms
// p = exp(x - max) / sum with a correctly rounded division (div_rn), applies
// the mask and 1/(1-rate), rounds p to bf16 in registers and feeds it as the
// register A operand of p v, with v from shared memory. So the
// probabilities are normalised and dropped out in f32 before their
// rounding, as the reference does, never rescaled after the product as an
// online softmax would: the price is computing q k^T twice, 1.5x the
// minimal FLOP. The scale and the bias are applied with explicit
// round-to-nearest multiply and add, never one FMA. The mask bias is -1e30,
// not -inf: a row whose keys are all padding gets the uniform softmax the
// reference gives, never NaN. The dropout mask of element (b, h, i, j) is the
// counter-based hash of its flat index ((b H + h) T + i) T + j (random.cuh),
// so K3 and the plain version draw it exactly; the work a row of a tile
// shares is done once (ProqaKeepRow). Head dims 16, 32, 64, 128 and 256 each
// have their instantiation (p v is one m64nDHk16 wgmma a k-step, two of n128
// at 256); the per-score softmax work does not shrink with Dh, so Dh = 32
// sits further from its bytes bound than Dh = 64.
//
// Dh = 256: the q tiles (64 KB) and three stages of (k, v) tiles (192 KB)
// pass the 227 KB a block may hold, so the ring has two stages (196 KB in
// all): each item waits for its own products, so the copy of item t + 1
// into the stage item t - 1 used is the only overlap a ring needs. The
// output accumulator is 128 registers a thread (one block an SM, as at
// Dh = 128), beside the 64 x 64 score tile.
//
// Past Dh = 256 (the loop form, any multiple of kChunk = 128): a scores
// kernel and a slice kernel. In the scores kernel the scores contract over
// Dh in 128-column chunks, each item one chunk of the two warpgroups' q rows
// and of 64 keys, accumulated in the score tile until the last chunk
// completes it; sweep 1 keeps the row statistics, sweep 2 forms p and writes
// it, rounded to bf16, as wgmma A fragments to a scratch array. The slice
// kernel (attention_tiles.cuh), a block a 64-row, 128-column slice of the
// output, sums p v over the key tiles. So q k^T runs twice, whatever Dh, and
// the slices' accumulators live in different blocks.
//
// f32 runs one simple body at every head dim (attention_tiles.cuh): 16 query
// rows a block, whole f32 score rows in shared memory, plain FMA products
// over q, k and v read from device memory, the output written there.
#include "attention_tiles.cuh"
#include "random.cuh"

namespace {

using namespace attn;

// ---------------------------------------------------------------------------
// bf16: staged tiles and wgmma
// ---------------------------------------------------------------------------

constexpr int kFwdGroups = 2;  // warpgroups of 64 query rows a block

// The blocks an SM should hold, which caps a thread's registers (65,536 /
// (256 threads x blocks)). Two up to Dh = 64 (at most 128 registers). At
// Dh = 128 a block's tiles take 132 KB of shared memory, so one block fits
// an SM anyway, and the cap of 255 lets a thread keep o[64] beside a score
// tile without spilling; Dh = 256 keeps o[128] there.
__host__ __device__ constexpr int fwd_blocks_per_sm(int dh) { return dh <= 64 ? 2 : 1; }
// stages of the ring: two at Dh = 256 (see the header)
__host__ __device__ constexpr int fwd_stages(int dh) { return dh == 256 ? 2 : kStages; }

template <int DH>
size_t fwd_smem_bytes(int seq) {
  // q tiles, the ring of two-tile stages, the key bias
  return (kFwdGroups + 2 * fwd_stages(DH)) * Tile<DH>::kBytes + (size_t)seq * sizeof(float);
}

template <int DH, bool DROP>
__global__ void __launch_bounds__(kFwdGroups * kWarpgroup, fwd_blocks_per_sm(DH))
attention_fwd_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const int* __restrict__ key_mask,
                           bf16* __restrict__ out, int heads, int seq, float scale,
                           DropoutParams drop) {
  constexpr int NT = kFwdGroups * kWarpgroup, kStagesHere = fwd_stages(DH);
  constexpr uint32_t kBytes = Tile<DH>::kBytes;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, wg = tid / kWarpgroup, t = tid % kWarpgroup;
  const int b = blockIdx.z, h = blockIdx.y, row0 = blockIdx.x * kFwdGroups * kTile;
  const size_t bh = (size_t)b * heads + h, slice = bh * seq * DH;
  // q tiles, then the ring: a stage holds two tiles, 128 keys of k (sweep 1)
  // or 64 keys of k and of v (sweep 2)
  const uint32_t q_tiles = smem_addr(smem);
  const uint32_t ring = q_tiles + kFwdGroups * kBytes;
  float* bias = reinterpret_cast<float*>(smem + (kFwdGroups + 2 * kStagesHere) * kBytes);

  for (int c = tid; c < seq; c += NT)
    bias[c] = key_mask[(size_t)b * seq + c] != 0 ? 0.0f : kMaskBias;
  for (int w = 0; w < kFwdGroups; ++w)
    load_tile<DH, NT>(q_tiles + w * kBytes, q + slice + (size_t)(row0 + w * kTile) * DH, tid);

  // items 0 .. n1-1: sweep 1, 128 keys each; n1 .. n1+n2-1: sweep 2, 64 keys each
  const int n1 = seq / (2 * kTile), n2 = seq / kTile;
  auto issue = [&](int item) {
    if (item < n1 + n2) {
      const uint32_t stage = ring + (item % kStagesHere) * 2 * kBytes;
      if (item < n1) {
        const size_t off = slice + (size_t)item * 2 * kTile * DH;
        load_tile<DH, NT>(stage, k + off, tid);
        load_tile<DH, NT>(stage + kBytes, k + off + kTile * DH, tid);
      } else {
        const size_t off = slice + (size_t)(item - n1) * kTile * DH;
        load_tile<DH, NT>(stage, k + off, tid);
        load_tile<DH, NT>(stage + kBytes, v + off, tid);
      }
    }
    cp_async_commit();
  };
  issue(0);

  const uint32_t q_tile = q_tiles + wg * kBytes;
  const int c = frag_col(t);
  const int i0 = row0 + wg * kTile + frag_row(t);  // the thread's rows: i0 and i0 + 8
  const uint64_t counter0 = (bh * seq + i0) * (uint64_t)seq;  // flat index of (i0, 0)
  const uint64_t counter1 = counter0 + 8 * (uint64_t)seq;

  RowStats stats;
  int item = 0;
  for (; item < n1; ++item) {
    stage_ready();
    issue(item + 1);
    const uint32_t stage = ring + (item % kStagesHere) * 2 * kBytes;
    float sa[32], sb[32];
    wgmma_fence();
    issue_scores<DH>(sa, q_tile, stage);
    issue_scores<DH>(sb, q_tile, stage + kBytes);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sa);
    fence_regs(sb);
    add_logits(sa, bias, item * 2 * kTile, c, scale);
    add_logits(sb, bias, item * 2 * kTile + kTile, c, scale);
    stats.update(sa);
    stats.update(sb);
  }
  stats.finish();

  float o[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.0f;
  for (; item < n1 + n2; ++item) {
    stage_ready();
    issue(item + 1);
    const int key0 = (item - n1) * kTile;
    const uint32_t k_tile = ring + (item % kStagesHere) * 2 * kBytes;
    float s[32];
    wgmma_fence();
    issue_scores<DH>(s, q_tile, k_tile);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    add_logits(s, bias, key0, c, scale);
    // the mask of the thread's elements (row, key0 + 8 n + c + e): offsets
    // 8 n + e from key0 + c, whose bits are clear in it
    const ProqaKeepRow mask[2] = {ProqaKeepRow(drop.k0, drop.k1, counter0 + key0 + c),
                                  ProqaKeepRow(drop.k0, drop.k1, counter1 + key0 + c)};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i / 2) % 2;
      float p = stats.prob(s[i], r);
      if constexpr (DROP)
        p = apply_keep(p, mask[r].keep(8 * (i / 4) + i % 2, drop.threshold), drop.inv_keep);
      s[i] = p;
    }
    uint32_t pa[4][4];
    pack_rows(s, pa);
    wgmma_fence();
    issue_weigh<DH>(o, pa, k_tile + kBytes);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
  }

  bf16* os = out + slice;
#pragma unroll
  for (int i = 0; i < DH / 2; i += 2) {
    const int row = i0 + 8 * ((i / 2) % 2), col = 8 * (i / 4) + c;
    *reinterpret_cast<__nv_bfloat162*>(os + (size_t)row * DH + col) =
        __floats2bfloat162_rn(o[i], o[i + 1]);
  }
}

template <int DH, bool DROP>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, const void* key_mask,
                         void* out, int batch, int heads, int seq, float scale,
                         DropoutParams drop, cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes<DH>(seq);
  cudaError_t err = cudaFuncSetAttribute(attention_fwd_wgmma_kernel<DH, DROP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(seq / (kFwdGroups * kTile), heads, batch);
  attention_fwd_wgmma_kernel<DH, DROP><<<grid, kFwdGroups * kWarpgroup, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(key_mask), static_cast<bf16*>(out), heads, seq, scale, drop);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 past Dh = 256: the loop form
// ---------------------------------------------------------------------------

// A stage of the scores kernel's ring: the two warpgroups' q chunks and a k
// chunk, 16 KB each.
constexpr uint32_t kScoresStage = 3 * kChunkBytes;

size_t scores_loop_smem_bytes(int seq) {
  return kLoopStages * kScoresStage + (size_t)seq * sizeof(float);  // the ring, the key bias
}

// One block per (batch, head, 128 query rows): sweep 1 (the row statistics)
// and sweep 2 (p) each run over the key tiles, and each key tile's scores
// over the head dim's chunks. Sweep 2 writes p, normalised and dropped out
// in f32 and rounded to bf16 (the rounding p v takes), as A fragments
// (frag_tile); attention_slice_kernel then sums p v, 128 output columns a
// block.
template <bool DROP>
__global__ void __launch_bounds__(kFwdGroups * kWarpgroup, 1)
attention_fwd_scores_loop_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                 const int* __restrict__ key_mask, uint32_t* __restrict__ frags,
                                 int heads, int seq, int dh, float scale, DropoutParams drop) {
  constexpr int NT = kFwdGroups * kWarpgroup;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, wg = tid / kWarpgroup, t = tid % kWarpgroup;
  const int nc = dh / kChunk;  // the chunks of the contraction
  const int row0 = blockIdx.x * kFwdGroups * kTile;
  const int b = blockIdx.z, h = blockIdx.y;
  const size_t bh = (size_t)b * heads + h, slice = bh * seq * dh;
  const uint32_t ring = smem_addr(smem);
  float* bias = reinterpret_cast<float*>(smem + kLoopStages * kScoresStage);

  for (int c = tid; c < seq; c += NT)
    bias[c] = key_mask[(size_t)b * seq + c] != 0 ? 0.0f : kMaskBias;

  // item kt * nc + cc: chunk cc of key tile kt, in sweep 1; n1 + the same in sweep 2
  const int nt = seq / kTile, n1 = nt * nc, items = 2 * n1;
  auto issue = [&](int item) {
    if (item < items) {
      const int it = item < n1 ? item : item - n1, kt = it / nc, cc = it % nc;
      const uint32_t stage = ring + (item % kLoopStages) * kScoresStage;
      for (int w = 0; w < kFwdGroups; ++w)
        load_tile<kChunk, NT>(stage + w * kChunkBytes,
                              q + slice + (size_t)(row0 + w * kTile) * dh + cc * kChunk, tid, dh);
      load_tile<kChunk, NT>(stage + 2 * kChunkBytes,
                            k + slice + (size_t)kt * kTile * dh + cc * kChunk, tid, dh);
    }
    cp_async_commit();
  };
  issue(0);

  const int c = frag_col(t);
  const int i0 = row0 + wg * kTile + frag_row(t);  // the thread's rows: i0 and i0 + 8
  const uint64_t counter0 = (bh * seq + i0) * (uint64_t)seq;  // flat index of (i0, 0)
  const uint64_t counter1 = counter0 + 8 * (uint64_t)seq;

  RowStats stats;
  float s[32];
  for (int item = 0; item < items; ++item) {
    stage_ready();
    issue(item + 1);
    const bool sweep2 = item >= n1;
    const int it = sweep2 ? item - n1 : item, kt = it / nc, cc = it % nc;
    const uint32_t stage = ring + (item % kLoopStages) * kScoresStage;
    wgmma_fence();
    issue_scores<kChunk>(s, stage + wg * kChunkBytes, stage + 2 * kChunkBytes, cc > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    if (cc < nc - 1) continue;  // the tile's scores are not complete yet
    const int key0 = kt * kTile;
    add_logits(s, bias, key0, c, scale);
    if (!sweep2) {
      stats.update(s);
      if (kt == nt - 1) stats.finish();
      continue;
    }
    const ProqaKeepRow mask[2] = {ProqaKeepRow(drop.k0, drop.k1, counter0 + key0 + c),
                                  ProqaKeepRow(drop.k0, drop.k1, counter1 + key0 + c)};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i / 2) % 2;
      float p = stats.prob(s[i], r);
      if constexpr (DROP)
        p = apply_keep(p, mask[r].keep(8 * (i / 4) + i % 2, drop.threshold), drop.inv_keep);
      s[i] = p;
    }
    uint32_t pa[4][4];
    pack_rows(s, pa);
    store_frags(frags + frag_tile(bh, nt, row0 / kTile + wg, kt), pa, t);
  }
}

template <bool DROP>
cudaError_t launch_loop(const void* q, const void* k, const void* v, const void* key_mask,
                        void* out, void* frags, int batch, int heads, int seq, int dh,
                        float scale, DropoutParams drop, cudaStream_t stream) {
  const size_t smem = scores_loop_smem_bytes(seq);
  cudaError_t err = cudaFuncSetAttribute(attention_fwd_scores_loop_kernel<DROP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  uint32_t* fr = static_cast<uint32_t*>(frags);
  const dim3 grid(seq / (kFwdGroups * kTile), heads, batch);
  attention_fwd_scores_loop_kernel<DROP><<<grid, kFwdGroups * kWarpgroup, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const int*>(key_mask), fr, heads, seq, dh, scale, drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_slices<false>(static_cast<const bf16*>(v), fr, static_cast<bf16*>(out), batch,
                              heads, seq, dh, stream);
}

// ---------------------------------------------------------------------------
// f32: the simple body
// ---------------------------------------------------------------------------

// Row softmax of (s * scale + bias) in f32, then dropout, in place.
// `counter0` is the flat [B, H, T, T] index of the block's element (0, 0).
__device__ void softmax_rows(float* s, int s_ld, const float* bias, float scale, int seq,
                             DropoutParams drop, uint64_t counter0) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < kRows; r += kWarps) {
    float* row = s + r * s_ld;
    float m = -INFINITY;
    for (int c = lane; c < seq; c += 32) {
      const float x = logit(row[c], scale, bias[c]);
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
    const uint64_t counter = counter0 + (uint64_t)r * seq;
    for (int c = lane; c < seq; c += 32) {
      float pr = row[c] / sum;
      if (drop.active)
        pr = proqa_keep(drop.k0, drop.k1, counter + c, drop.threshold)
                 ? __fmul_rn(pr, drop.inv_keep) : 0.0f;
      row[c] = pr;
    }
  }
}

// One block per (batch, head, 16 query rows); shared memory holds only the
// score rows and the key bias.
__global__ void __launch_bounds__(kThreads)
attention_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const int* __restrict__ key_mask,
                         float* __restrict__ out, int heads, int seq, int dh, float scale,
                         DropoutParams drop) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int b = blockIdx.z, h = blockIdx.y, row0 = blockIdx.x * kRows;
  const size_t slice = ((size_t)b * heads + h) * seq * dh;
  const int s_ld = seq + 4;
  float* s = reinterpret_cast<float*>(smem);  // [kRows][s_ld]
  float* bias = s + kRows * s_ld;             // [seq]
  for (int c = threadIdx.x; c < seq; c += kThreads)
    bias[c] = key_mask[(size_t)b * seq + c] != 0 ? 0.0f : kMaskBias;
  score_rows(q + slice + (size_t)row0 * dh, k + slice, s, s_ld, seq, dh);
  __syncthreads();
  const uint64_t counter0 = (((uint64_t)b * heads + h) * seq + row0) * (uint64_t)seq;
  softmax_rows(s, s_ld, bias, scale, seq, drop, counter0);
  __syncthreads();
  weigh_rows(s, s_ld, v + slice, out + slice + (size_t)row0 * dh, seq, dh);
}

cudaError_t launch_f32(const void* q, const void* k, const void* v, const void* key_mask,
                       void* out, int batch, int heads, int seq, int dh, float scale,
                       DropoutParams drop, cudaStream_t stream) {
  const size_t smem = ((size_t)kRows * (seq + 4) + seq) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(attention_fwd_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  attention_fwd_f32_kernel<<<dim3(seq / kRows, heads, batch), kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int*>(key_mask), static_cast<float*>(out), heads, seq, dh, scale, drop);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const void* key_mask, void* out,
                   int batch, int heads, int seq, float scale, int is_bf16, DropoutParams drop,
                   cudaStream_t stream) {
  if (!is_bf16)
    return launch_f32(q, k, v, key_mask, out, batch, heads, seq, DH, scale, drop, stream);
  return drop.active
             ? launch_wgmma<DH, true>(q, k, v, key_mask, out, batch, heads, seq, scale, drop, stream)
             : launch_wgmma<DH, false>(q, k, v, key_mask, out, batch, heads, seq, scale, drop,
                                       stream);
}

}  // namespace

// q, k, v, out [batch, heads, seq, head_dim] row-major (bf16 when is_bf16,
// else f32; 32-byte aligned); head_dim 16, 32, 64, 128, 256 or a larger
// multiple of 128 (ops/attention.py pads any other head dim to the next of
// these with zero columns); key_mask int32 [batch, seq],
// nonzero = attend; frags u32 scratch [batch * heads * (seq / 64)^2 * 2048],
// needed by bf16 past head dim 256 (else may be null). Dropout on the
// probabilities when `dropout` is nonzero, with the keys, threshold and
// 1/(1-rate) of ops/random.py. Returns a cudaError_t code.
extern "C" int proqa_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* key_mask, void* out, void* frags, int batch,
                                   int heads,
                                   int seq, int head_dim, float scale, int is_bf16,
                                   int dropout, uint32_t k0, uint32_t k1, uint32_t threshold,
                                   float inv_keep, void* stream) {
  if (batch <= 0 || heads <= 0 || batch > kMaxGrid || heads > kMaxGrid || seq <= 0 ||
      seq % 128 != 0 || seq > kMaxSeq)
    return cudaErrorInvalidValue;
  const DropoutParams drop{k0, k1, threshold, inv_keep, dropout};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16: return launch<16>(q, k, v, key_mask, out, batch, heads, seq, scale, is_bf16, drop, s);
    case 32: return launch<32>(q, k, v, key_mask, out, batch, heads, seq, scale, is_bf16, drop, s);
    case 64: return launch<64>(q, k, v, key_mask, out, batch, heads, seq, scale, is_bf16, drop, s);
    case 128:
      return launch<128>(q, k, v, key_mask, out, batch, heads, seq, scale, is_bf16, drop, s);
    case 256:
      return launch<256>(q, k, v, key_mask, out, batch, heads, seq, scale, is_bf16, drop, s);
    default:
      if (head_dim <= 256 || head_dim % kChunk != 0) return cudaErrorInvalidValue;
      if (!is_bf16)
        return launch_f32(q, k, v, key_mask, out, batch, heads, seq, head_dim, scale, drop, s);
      if (frags == nullptr) return cudaErrorInvalidValue;
      return drop.active ? launch_loop<true>(q, k, v, key_mask, out, frags, batch, heads, seq,
                                             head_dim, scale, drop, s)
                         : launch_loop<false>(q, k, v, key_mask, out, frags, batch, heads, seq,
                                              head_dim, scale, drop, s);
  }
}
