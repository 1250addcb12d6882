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
// elements moved (q, k, v, do in; dq, dk, dv out), so at T >= 256 it is
// operations-bound in principle. The reference's rounding points add work:
// D = rowsum(p * dp) must be complete, from f32 p and dp, before ds can be
// rounded, so no row of ds exists before a sweep over all keys, and every
// score costs exps, a correctly rounded division and, at a dropout rate
// above 0, the mask hash's integer operations, which compete with the
// products for issue slots. Measured, the two kernels are bound by the
// latency of that per-score work: the tensor cores are busy a small part of
// the time.
//
// What the design does about it (bf16): two kernels (three launches at
// Dh = 128, see ColPart) with no atomics, each a block of two warpgroups
// (128 threads each) that own a 64-row tile apiece and share the streamed
// tiles. Every product is a wgmma with f32 accumulators in registers. The
// resident tiles are loaded once into shared memory; the streamed tiles of
// 64 rows go through a ring of kStages buffers filled by cp.async one item
// ahead. The softmax, the mask, dp, ds and the bf16 rounding happen in
// registers on the accumulator fragments; the rounded pd or ds is the
// register A operand of the next product. No float atomics, so two launches
// on the same inputs give the same bits.
//   Row kernel, one block per (batch, head, 128 query rows), q and do
//   resident, k and v streamed, three sweeps over the keys: (0) q k^T, 128
//   keys an item, for each row's maximum and sum in K2's arithmetic
//   (RowStats); (1) q k^T and do v^T for D = rowsum(p * dp), drawing the
//   dropout mask once (random.cuh) and keeping it as bits, one per score, in
//   shared memory and in a scratch array; (2) both products again for ds
//   and dq += ds k, the mask read back from the bits. It writes dq and each
//   row's (max, sum, 1/sum, D) to a second scratch array.
//   Column kernel, one block per (batch, head, 128 keys), k and v resident,
//   q, do, the rows' statistics and their mask bits streamed: the
//   transposed tiles k q^T and v do^T give p = exp(x - max) / sum from the
//   row kernel's statistics (the forward's own arithmetic, not a stored
//   log-sum-exp), pd and ds, then dv += pd^T do and dk += ds^T q, whose wait
//   runs on into the next item.
// Head dims 16, 32, 64 and 128 each have their instantiations; at Dh = 128
// (and at Dh = 32 with dropout) the row kernel runs one block an SM
// (rows_blocks_per_sm), and at Dh = 128 the column kernel runs as two
// launches, dv then dk (ColPart).
//
// From Dh = 256 (the loop forms, any multiple of kChunk = 128), a scores
// kernel and three slice kernels. The scores kernel runs the row kernel's
// three sweeps once a (batch, head, 64 query rows), one warpgroup a block,
// q, do, k and v streamed in 128-column chunks through a two-stage ring, q
// k^T and do v^T accumulated over the chunks in the wgmma accumulators, the
// mask drawn once and kept as bits in shared memory; its last sweep writes
// each (query tile, key tile)'s ds, ds^T and pd^T as bf16 wgmma A
// fragments to a scratch array (the transposes through shared memory). The
// slice kernels (attention_tiles.cuh), a block a 64-row, 128-column slice
// of dq, dk or dv, only sum those fragments' products with k, q or do: so
// the scores are computed once, not once a slice, and the work grows as
// Dh, not Dh^2. At Dh = 256 this form took 3.4 ms where a native form with
// a block a 128-column half of each output took 4.8 ([80, 3, 512, 256],
// rate 0.1, H100), so 256 has no native form.
//
// f32 runs one simple body at every head dim (attention_tiles.cuh): 16 rows a
// block, whole f32 score rows in shared memory, plain FMA products over
// operands read from device memory, the same two passes, the mask
// regenerated in both.
#include "attention_tiles.cuh"
#include "random.cuh"

namespace {

using namespace attn;

// ---------------------------------------------------------------------------
// bf16: staged tiles and wgmma
// ---------------------------------------------------------------------------

// The row statistics scratch, f32 [kStats][batch * heads * seq]: each query
// row's maximum logit, sum of exp(x - max), its reciprocal, and D.
constexpr int kStats = 4;
enum Stat { kMax = 0, kSum = 1, kRcp = 2, kD = 3 };

// warpgroups of 64 rows a block (sharing the streamed tiles), and the blocks
// an SM should hold, which bounds the registers a thread may use
constexpr int kRowGroups = 2, kRowBlocksPerSM = 2;
constexpr int kColGroups = 2, kColBlocksPerSM = 1;
// The row kernel's blocks an SM for the head dims added after 16 and 64: at
// Dh = 128 its tiles take up to 180 KB of shared memory (T = 1,024 with
// dropout), so one block fits an SM, and acc[64] beside the s and dp tiles
// needs more than the 128 registers of two blocks. At Dh = 32 with dropout,
// ptxas spilled 4 bytes under the 128-register cap of two blocks, and one
// block fits: one block, 255 registers, no spill.
__host__ __device__ constexpr int rows_blocks_per_sm(int dh, bool drop) {
  return dh == 128 || (dh == 32 && drop) ? 1 : kRowBlocksPerSM;
}
// Which of dv and dk a column kernel launch accumulates: both up to Dh = 64.
// At Dh = 128, acc_v[64] and acc_k[64] beside the s and dp tiles and the
// products' register operands pass 255 registers (ptxas spilled), so two
// launches take one each; the dk launch recomputes p.
enum ColPart { kBoth = 0, kDv = 1, kDk = 2 };

template <int DH, bool DROP>
size_t rows_smem_bytes(int seq) {
  // q and do tiles, the ring of (k, v) tiles, the key bias, and with dropout
  // the keep bits of the block's rows
  return (2 * kRowGroups + 2 * kStages) * Tile<DH>::kBytes + (size_t)seq * sizeof(float) +
         (DROP ? (size_t)kRowGroups * seq * sizeof(uint64_t) : 0);
}

template <int DH>
__host__ __device__ constexpr uint32_t cols_stage_bytes() {
  // a q tile, a do tile, the statistics of its 64 rows, and their keep bits
  // against each warpgroup's 64 keys
  return 2 * Tile<DH>::kBytes + kStats * kTile * sizeof(float) +
         kColGroups * kTile * sizeof(uint64_t);
}

template <int DH>
size_t cols_smem_bytes() {
  // k and v tiles, the ring
  return 2 * kColGroups * Tile<DH>::kBytes + kStages * cols_stage_bytes<DH>();
}

// The dropout mask as bits, u64 [batch * heads][seq / 64][seq]: word
// [bh][kt][i] holds the keep flags of query row i against keys 64 kt ..
// 64 kt + 63, bit o for key 64 kt + o. The row kernel draws them (random.cuh)
// in its D sweep; its dq sweep and the column kernel read them.
__device__ __forceinline__ size_t bits_index(size_t bh, int nt, int kt, int seq, int row) {
  return (bh * nt + kt) * seq + row;
}

// Is the thread's element i of a 64 x 64 tile (row r = (i / 2) % 2, key
// 8 (i / 4) + c + i % 2) kept? `words[r]`: its row's keep bits shifted right
// by c; halves: 0 for keys 0 .. 31, 1 for 32 .. 63.
__device__ __forceinline__ bool kept(const uint32_t (&words)[2][2], int i) {
  const int n = i / 4;
  return (words[(i / 2) % 2][n / 4] >> (8 * (n % 4) + i % 2)) & 1u;
}

template <int DH, bool DROP>
__global__ void __launch_bounds__(kRowGroups * kWarpgroup, rows_blocks_per_sm(DH, DROP))
attention_bwd_rows_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ dout,
                          const int* __restrict__ key_mask, bf16* __restrict__ dq,
                          float* __restrict__ stats, uint64_t* __restrict__ keep_bits, int heads,
                          int seq, float scale, DropoutParams drop) {
  constexpr int NT = kRowGroups * kWarpgroup;
  constexpr uint32_t kBytes = Tile<DH>::kBytes;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, wg = tid / kWarpgroup, t = tid % kWarpgroup;
  const int b = blockIdx.z, h = blockIdx.y, row0 = blockIdx.x * kRowGroups * kTile;
  const size_t bh = (size_t)b * heads + h, slice = bh * seq * DH;
  // q tiles, do tiles, then the ring: a stage holds two tiles, 128 keys of k
  // (sweep 0) or 64 keys of k and of v (sweeps 1 and 2)
  const uint32_t q_tiles = smem_addr(smem), do_tiles = q_tiles + kRowGroups * kBytes;
  const uint32_t ring = do_tiles + kRowGroups * kBytes;
  float* bias = reinterpret_cast<float*>(smem + (2 * kRowGroups + 2 * kStages) * kBytes);
  // with dropout, [kRowGroups][nt][kTile] keep-bit words of the block's rows
  uint64_t* row_bits = reinterpret_cast<uint64_t*>(bias + seq);

  for (int c = tid; c < seq; c += NT)
    bias[c] = key_mask[(size_t)b * seq + c] != 0 ? 0.0f : kMaskBias;
  for (int w = 0; w < kRowGroups; ++w) {
    const size_t off = slice + (size_t)(row0 + w * kTile) * DH;
    load_tile<DH, NT>(q_tiles + w * kBytes, q + off, tid);
    load_tile<DH, NT>(do_tiles + w * kBytes, dout + off, tid);
  }

  // items 0 .. n0-1: sweep 0, 128 keys each; then nt items of sweep 1 and nt
  // of sweep 2, 64 keys each
  const int nt = seq / kTile, n0 = nt / 2, items = n0 + 2 * nt;
  auto issue = [&](int item) {
    if (item < items) {
      const uint32_t stage = ring + (item % kStages) * 2 * kBytes;
      if (item < n0) {
        const size_t off = slice + (size_t)item * 2 * kTile * DH;
        load_tile<DH, NT>(stage, k + off, tid);
        load_tile<DH, NT>(stage + kBytes, k + off + kTile * DH, tid);
      } else {
        const size_t off = slice + (size_t)((item - n0) % nt) * kTile * DH;
        load_tile<DH, NT>(stage, k + off, tid);
        load_tile<DH, NT>(stage + kBytes, v + off, tid);
      }
    }
    cp_async_commit();
  };
  issue(0);

  const uint32_t q_tile = q_tiles + wg * kBytes, do_tile = do_tiles + wg * kBytes;
  const int c = frag_col(t);
  const int i0 = row0 + wg * kTile + frag_row(t);  // the thread's rows: i0 and i0 + 8
  const uint64_t counter0 = (bh * seq + i0) * (uint64_t)seq;
  const int row_word = wg * nt * kTile + frag_row(t);  // + kt * kTile + 8 r: row_bits' index

  // sweep 0: each row's maximum and sum, in K2's arithmetic
  RowStats st;
  int item = 0;
  for (; item < n0; ++item) {
    stage_ready();
    issue(item + 1);
    const uint32_t stage = ring + (item % kStages) * 2 * kBytes;
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
    st.update(sa);
    st.update(sb);
  }
  st.finish();

  // sweeps 1 and 2 share this: the tile's probabilities and do v^T
  float s[32], dp[32];
  auto tile = [&](int key0, uint32_t k_tile) {
    wgmma_fence();
    issue_scores<DH>(s, q_tile, k_tile);
    issue_scores<DH>(dp, do_tile, k_tile + kBytes);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    add_logits(s, bias, key0, c, scale);
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = st.prob(s[i], (i / 2) % 2);
  };

  // sweep 1: D = rowsum(p * dp), drawing the mask and keeping it as bits
  float dsum[2] = {0.0f, 0.0f};
  for (; item < n0 + nt; ++item) {
    stage_ready();
    issue(item + 1);
    const int kt = item - n0, key0 = kt * kTile;
    tile(key0, ring + (item % kStages) * 2 * kBytes);
    if constexpr (DROP) {
      // offsets 8 n + e from key0 + c, whose bits are clear in it
      const uint64_t n0c = counter0 + key0 + c;
      const ProqaKeepRow mask[2] = {ProqaKeepRow(drop.k0, drop.k1, n0c),
                                    ProqaKeepRow(drop.k0, drop.k1, n0c + 8 * (uint64_t)seq)};
      uint32_t words[2][2] = {};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i / 2) % 2, n = i / 4;
        const bool keep = mask[r].keep(8 * n + i % 2, drop.threshold);
        dp[i] = apply_keep(dp[i], keep, drop.inv_keep);
        if (keep) words[r][n / 4] |= 1u << (8 * (n % 4) + i % 2);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        uint32_t half[2];
#pragma unroll
        for (int a = 0; a < 2; ++a) {  // the quad's 4 x 16 bits make the row's word
          half[a] = words[r][a] << c;
          half[a] |= __shfl_xor_sync(0xffffffffu, half[a], 1);
          half[a] |= __shfl_xor_sync(0xffffffffu, half[a], 2);
        }
        if (c == 0) {
          const uint64_t word = half[0] | (uint64_t)half[1] << 32;
          row_bits[row_word + kt * kTile + 8 * r] = word;
          keep_bits[bits_index(bh, nt, kt, seq, i0 + 8 * r)] = word;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i / 2) % 2;
      dsum[r] = __fadd_rn(dsum[r], __fmul_rn(s[i], dp[i]));
    }
  }
  dsum[0] = quad_sum(dsum[0]);
  dsum[1] = quad_sum(dsum[1]);

  // sweep 2: ds and dq += ds k
  float acc[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.0f;
  for (; item < items; ++item) {
    stage_ready();
    issue(item + 1);
    const int kt = item - n0 - nt;
    const uint32_t k_tile = ring + (item % kStages) * 2 * kBytes;
    tile(kt * kTile, k_tile);
    if constexpr (DROP) {  // the mask sweep 1 drew
      uint32_t words[2][2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const uint64_t word = row_bits[row_word + kt * kTile + 8 * r] >> c;
        words[r][0] = static_cast<uint32_t>(word);
        words[r][1] = static_cast<uint32_t>(word >> 32);
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) dp[i] = apply_keep(dp[i], kept(words, i), drop.inv_keep);
    }
#pragma unroll
    for (int i = 0; i < 32; ++i)  // ds
      s[i] = __fmul_rn(__fmul_rn(s[i], __fsub_rn(dp[i], dsum[(i / 2) % 2])), scale);
    uint32_t da[4][4];
    pack_rows(s, da);
    wgmma_fence();
    issue_weigh<DH>(acc, da, k_tile);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  }

  bf16* out = dq + slice;
#pragma unroll
  for (int i = 0; i < DH / 2; i += 2) {
    const int row = i0 + 8 * ((i / 2) % 2), col = 8 * (i / 4) + c;
    *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * DH + col) =
        __floats2bfloat162_rn(acc[i], acc[i + 1]);
  }
  if (c == 0) {
    const size_t rows_total = (size_t)gridDim.z * heads * seq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const size_t i = bh * seq + i0 + 8 * r;
      stats[kMax * rows_total + i] = st.max_x[r];
      stats[kSum * rows_total + i] = st.sum_e[r];
      stats[kRcp * rows_total + i] = st.rcp[r];
      stats[kD * rows_total + i] = dsum[r];
    }
  }
}

template <int DH, bool DROP, int PART>
__global__ void __launch_bounds__(kColGroups * kWarpgroup, kColBlocksPerSM)
attention_bwd_cols_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ dout,
                          const int* __restrict__ key_mask, const float* __restrict__ stats,
                          const uint64_t* __restrict__ keep_bits, bf16* __restrict__ dk,
                          bf16* __restrict__ dv, int heads, int seq, float scale,
                          DropoutParams drop) {
  constexpr int NT = kColGroups * kWarpgroup;
  constexpr uint32_t kBytes = Tile<DH>::kBytes, kStage = cols_stage_bytes<DH>();
  constexpr uint32_t kRing = 2 * kColGroups * kBytes;  // the ring's offset
  constexpr bool kV = PART != kDk, kK = PART != kDv;    // accumulates dv, dk
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, wg = tid / kWarpgroup, t = tid % kWarpgroup;
  const int b = blockIdx.z, h = blockIdx.y, key_block = blockIdx.x * kColGroups * kTile;
  const size_t bh = (size_t)b * heads + h, slice = bh * seq * DH;
  const size_t rows_total = (size_t)gridDim.z * heads * seq;
  // k tiles, v tiles, then the ring; stage s: q tile, do tile, statistics
  const uint32_t base = smem_addr(smem);
  const uint32_t k_tiles = base, v_tiles = base + kColGroups * kBytes;

  for (int w = 0; w < kColGroups; ++w) {
    const size_t off = slice + (size_t)(key_block + w * kTile) * DH;
    load_tile<DH, NT>(k_tiles + w * kBytes, k + off, tid);
    if constexpr (kK) load_tile<DH, NT>(v_tiles + w * kBytes, v + off, tid);
  }
  const int nt = seq / kTile;
  auto issue = [&](int item) {
    if (item < nt) {
      const size_t row = bh * seq + (size_t)item * kTile;
      const uint32_t stage = base + kRing + (item % kStages) * kStage;
      load_tile<DH, NT>(stage, q + row * DH, tid);
      load_tile<DH, NT>(stage + kBytes, dout + row * DH, tid);
      for (int a = 0; a < kStats; ++a)
        load_floats<NT>(stage + 2 * kBytes + a * kTile * 4, stats + a * rows_total + row, kTile,
                        tid);
      if constexpr (DROP)
        for (int w = 0; w < kColGroups; ++w)
          load_floats<NT>(stage + 2 * kBytes + (kStats + 2 * w) * kTile * 4,
                          reinterpret_cast<const float*>(keep_bits + bits_index(
                              bh, nt, key_block / kTile + w, seq, item * kTile)),
                          2 * kTile, tid);
    }
    cp_async_commit();
  };
  issue(0);

  // accumulator rows are keys (j0 and j0 + 8), columns are queries
  const uint32_t k_tile = k_tiles + wg * kBytes, v_tile = v_tiles + wg * kBytes;
  const int c = frag_col(t);
  const int j0 = key_block + wg * kTile + frag_row(t);
  const float bias[2] = {key_mask[(size_t)b * seq + j0] != 0 ? 0.0f : kMaskBias,
                         key_mask[(size_t)b * seq + j0 + 8] != 0 ? 0.0f : kMaskBias};
  float acc_v[DH / 2], acc_k[DH / 2];  // the one a part does not take is never used
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc_v[i] = acc_k[i] = 0.0f;

  for (int item = 0; item < nt; ++item) {
    stage_ready();
    issue(item + 1);
    const uint32_t stage = kRing + (item % kStages) * kStage;
    const uint32_t q_tile = base + stage, do_tile = q_tile + kBytes;
    // the statistics of the item's 64 query rows, [kStats][kTile], then
    // their keep bits against the warpgroup's keys
    const float* row_stats = reinterpret_cast<const float*>(smem + stage + 2 * kBytes);
    const uint64_t* bits = reinterpret_cast<const uint64_t*>(row_stats + kStats * kTile) +
                           wg * kTile;

    float s[32], dp[32];
    wgmma_fence();
    issue_scores<DH>(s, k_tile, q_tile);
    if constexpr (kK) issue_scores<DH>(dp, v_tile, do_tile);
    wgmma_commit();
    wgmma_wait<0>();  // these scores, and the previous tile's products
    fence_regs(s);
    if constexpr (kK) fence_regs(dp);
    if constexpr (kV) fence_regs(acc_v);
    if constexpr (kK) fence_regs(acc_k);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = 8 * n + c;
      const float2 m = *reinterpret_cast<const float2*>(row_stats + kMax * kTile + col);
      const float2 l = *reinterpret_cast<const float2*>(row_stats + kSum * kTile + col);
      const float2 rl = *reinterpret_cast<const float2*>(row_stats + kRcp * kTile + col);
      const float2 dd = *reinterpret_cast<const float2*>(row_stats + kD * kTile + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * n + e, r = e / 2;
        const bool odd = e % 2;
        const float x = logit(s[i], scale, bias[r]);
        const float p = div_rn(expf(x - (odd ? m.y : m.x)), odd ? l.y : l.x, odd ? rl.y : rl.x);
        float pd = p, d = kK ? dp[i] : 0.0f;
        if constexpr (DROP) {  // bit j0 + 8 r - (the tile's first key) of query row col + odd
          const bool keep = (bits[col + odd] >> (frag_row(t) + 8 * r)) & 1u;
          pd = apply_keep(p, keep, drop.inv_keep);
          d = apply_keep(d, keep, drop.inv_keep);
        }
        s[i] = pd;
        if constexpr (kK)
          dp[i] = __fmul_rn(__fmul_rn(p, __fsub_rn(d, odd ? dd.y : dd.x)), scale);  // ds
      }
    }
    uint32_t pa[4][4], da[4][4];
    if constexpr (kV) pack_rows(s, pa);
    if constexpr (kK) pack_rows(dp, da);
    wgmma_fence();
    // waited for in the next item, or below
    if constexpr (kV) issue_weigh<DH>(acc_v, pa, do_tile);
    if constexpr (kK) issue_weigh<DH>(acc_k, da, q_tile);
    wgmma_commit();
  }
  wgmma_wait<0>();
  if constexpr (kV) fence_regs(acc_v);
  if constexpr (kK) fence_regs(acc_k);

#pragma unroll
  for (int i = 0; i < DH / 2; i += 2) {
    const size_t at = slice + (size_t)(j0 + 8 * ((i / 2) % 2)) * DH + 8 * (i / 4) + c;
    if constexpr (kV)
      *reinterpret_cast<__nv_bfloat162*>(dv + at) = __floats2bfloat162_rn(acc_v[i], acc_v[i + 1]);
    if constexpr (kK)
      *reinterpret_cast<__nv_bfloat162*>(dk + at) = __floats2bfloat162_rn(acc_k[i], acc_k[i + 1]);
  }
}

template <int DH, bool DROP, int PART>
cudaError_t launch_cols(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
                        const int* key_mask, const float* stats, const uint64_t* keep_bits,
                        void* dk, void* dv, int batch, int heads, int seq, float scale,
                        DropoutParams drop, cudaStream_t stream) {
  const size_t smem = cols_smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(attention_bwd_cols_kernel<DH, DROP, PART>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  attention_bwd_cols_kernel<DH, DROP, PART>
      <<<dim3(seq / (kColGroups * kTile), heads, batch), kColGroups * kWarpgroup, smem,
         stream>>>(q, k, v, dout, key_mask, stats, keep_bits, static_cast<bf16*>(dk),
                   static_cast<bf16*>(dv), heads, seq, scale, drop);
  return cudaGetLastError();
}

template <int DH, bool DROP>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, const void* dout,
                         const void* key_mask, void* dq, void* dk, void* dv, void* stats,
                         void* keep_bits, int batch, int heads, int seq, float scale,
                         DropoutParams drop, cudaStream_t stream) {
  const size_t rows_smem = rows_smem_bytes<DH, DROP>(seq);
  cudaError_t err = cudaFuncSetAttribute(attention_bwd_rows_kernel<DH, DROP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)rows_smem);
  if (err != cudaSuccess) return err;
  const bf16* qe = static_cast<const bf16*>(q);
  const bf16* ke = static_cast<const bf16*>(k);
  const bf16* ve = static_cast<const bf16*>(v);
  const bf16* de = static_cast<const bf16*>(dout);
  const int* mask = static_cast<const int*>(key_mask);
  float* st = static_cast<float*>(stats);
  uint64_t* bits = static_cast<uint64_t*>(keep_bits);
  attention_bwd_rows_kernel<DH, DROP>
      <<<dim3(seq / (kRowGroups * kTile), heads, batch), kRowGroups * kWarpgroup, rows_smem,
         stream>>>(qe, ke, ve, de, mask, static_cast<bf16*>(dq), st, bits, heads, seq, scale,
                   drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if constexpr (DH <= 64) {
    return launch_cols<DH, DROP, kBoth>(qe, ke, ve, de, mask, st, bits, dk, dv, batch, heads,
                                        seq, scale, drop, stream);
  } else {
    err = launch_cols<DH, DROP, kDv>(qe, ke, ve, de, mask, st, bits, dk, dv, batch, heads, seq,
                                     scale, drop, stream);
    if (err != cudaSuccess) return err;
    return launch_cols<DH, DROP, kDk>(qe, ke, ve, de, mask, st, bits, dk, dv, batch, heads, seq,
                                      scale, drop, stream);
  }
}

// ---------------------------------------------------------------------------
// bf16 from Dh = 256: the loop forms
// ---------------------------------------------------------------------------

// The scores kernel's ring: stages of a q, a do, a k and a v chunk tile.
constexpr uint32_t kScoresStage = 4 * kChunkBytes;
// A 64 x 64 bf16 tile staged for its transpose, rows padded to 72 elements
// (144 bytes: a warp's 4-byte writes and 2-byte transposed reads fall in
// distinct banks).
constexpr int kTransLd = kTile + 8;
constexpr uint32_t kTransBytes = kTile * kTransLd * sizeof(bf16);

// The scores kernel's scratch, three of frag_tile's arrays: ds (rows
// queries, for dq = ds k), ds^T and pd^T (rows keys, for dk = ds^T q and
// dv = pd^T do), each of `tiles` = batch * heads * nt^2 tiles.
enum FragKind { kDs = 0, kDsT = 1, kPdT = 2 };

// The A fragments of the transpose of the 64 x 64 tile whose fragments are
// `a`, through `buf` (kTransBytes of shared memory): register a[ks][r] holds
// row frag_row(t) + 8 (r % 2), columns 16 ks + 8 (r / 2) + frag_col(t) and
// the next (low half first); the transpose's element (j, i) is (i, j).
__device__ __forceinline__ void transpose_frags(const uint32_t (&a)[4][4], uint32_t (&at)[4][4],
                                                bf16* buf, int t) {
  const int row = frag_row(t), col = frag_col(t);
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      *reinterpret_cast<uint32_t*>(buf + (row + 8 * (r % 2)) * kTransLd + 16 * ks +
                                   8 * (r / 2) + col) = a[ks][r];
  __syncthreads();
  const uint16_t* b16 = reinterpret_cast<const uint16_t*>(buf);
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = row + 8 * (r % 2), i = 16 * ks + 8 * (r / 2) + col;
      at[ks][r] = b16[i * kTransLd + j] | (uint32_t)b16[(i + 1) * kTransLd + j] << 16;
    }
}

template <bool DROP>
size_t scores_loop_smem_bytes(int seq) {
  // the ring, two transpose buffers, the key bias, the row bits
  return kLoopStages * kScoresStage + 2 * kTransBytes + (size_t)seq * sizeof(float) +
         (DROP ? (size_t)seq * sizeof(uint64_t) : 0);
}

// One block per (batch, head, 64 query rows): the sweeps of the native row
// kernel, each key tile's scores and do v^T accumulated over the head dim's
// chunks, once. Sweep 2 writes each key tile's ds (bf16, the rounding K3's
// products take) as dq's A fragments, and ds^T and the dropped-out pd^T as
// dk's and dv's (FragKind); attention_slice_kernel then does only the
// products.
template <bool DROP>
__global__ void __launch_bounds__(kWarpgroup, 1)
attention_bwd_scores_loop_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                                 const int* __restrict__ key_mask, uint32_t* __restrict__ frags,
                                 int heads, int seq, int dh, float scale, DropoutParams drop) {
  constexpr int NT = kWarpgroup;
  extern __shared__ __align__(128) unsigned char smem[];
  const int t = threadIdx.x;
  const int nc = dh / kChunk, nt = seq / kTile;
  const int row_tile = blockIdx.x, row0 = row_tile * kTile;
  const int b = blockIdx.z, h = blockIdx.y;
  const size_t bh = (size_t)b * heads + h, slice = bh * seq * dh;
  const size_t tiles = (size_t)gridDim.z * heads * nt * nt;
  const uint32_t ring = smem_addr(smem);
  bf16* trans = reinterpret_cast<bf16*>(smem + kLoopStages * kScoresStage);
  float* bias = reinterpret_cast<float*>(smem + kLoopStages * kScoresStage + 2 * kTransBytes);
  uint64_t* row_bits = reinterpret_cast<uint64_t*>(bias + seq);  // [nt][kTile], with dropout

  for (int c = t; c < seq; c += NT)
    bias[c] = key_mask[(size_t)b * seq + c] != 0 ? 0.0f : kMaskBias;

  // item sweep * n + kt * nc + cc: chunk cc of key tile kt in sweep 0, 1 or 2
  const int n = nt * nc, items = 3 * n;
  auto issue = [&](int item) {
    if (item < items) {
      const int sweep = item / n, kt = item % n / nc, cc = item % nc;
      const uint32_t stage = ring + (item % kLoopStages) * kScoresStage;
      const size_t rows = slice + (size_t)row0 * dh + cc * kChunk;
      const size_t keys = slice + (size_t)kt * kTile * dh + cc * kChunk;
      load_tile<kChunk, NT>(stage, q + rows, t, dh);
      load_tile<kChunk, NT>(stage + 2 * kChunkBytes, k + keys, t, dh);
      if (sweep > 0) {
        load_tile<kChunk, NT>(stage + kChunkBytes, dout + rows, t, dh);
        load_tile<kChunk, NT>(stage + 3 * kChunkBytes, v + keys, t, dh);
      }
    }
    cp_async_commit();
  };
  issue(0);

  const int c = frag_col(t);
  const int i0 = row0 + frag_row(t);  // the thread's rows: i0 and i0 + 8
  const uint64_t counter0 = (bh * seq + i0) * (uint64_t)seq;

  RowStats st;
  float s[32], dp[32], dsum[2] = {0.0f, 0.0f};
  for (int item = 0; item < items; ++item) {
    stage_ready();
    issue(item + 1);
    const int sweep = item / n, kt = item % n / nc, cc = item % nc, key0 = kt * kTile;
    const uint32_t stage = ring + (item % kLoopStages) * kScoresStage;
    wgmma_fence();
    issue_scores<kChunk>(s, stage, stage + 2 * kChunkBytes, cc > 0);
    if (sweep > 0)
      issue_scores<kChunk>(dp, stage + kChunkBytes, stage + 3 * kChunkBytes, cc > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    if (cc < nc - 1) continue;  // the tile's products are not complete yet
    add_logits(s, bias, key0, c, scale);
    if (sweep == 0) {  // each row's maximum and sum, in K2's arithmetic
      st.update(s);
      if (kt == nt - 1) st.finish();
      continue;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = st.prob(s[i], (i / 2) % 2);
    if (sweep == 1) {  // D = rowsum(p * dp), drawing the mask and keeping it as bits
      if constexpr (DROP) {
        const uint64_t n0c = counter0 + key0 + c;
        const ProqaKeepRow mask[2] = {ProqaKeepRow(drop.k0, drop.k1, n0c),
                                      ProqaKeepRow(drop.k0, drop.k1, n0c + 8 * (uint64_t)seq)};
        uint32_t words[2][2] = {};
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int r = (i / 2) % 2, m = i / 4;
          const bool keep = mask[r].keep(8 * m + i % 2, drop.threshold);
          dp[i] = apply_keep(dp[i], keep, drop.inv_keep);
          if (keep) words[r][m / 4] |= 1u << (8 * (m % 4) + i % 2);
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          uint32_t half[2];
#pragma unroll
          for (int a = 0; a < 2; ++a) {  // the quad's 4 x 16 bits make the row's word
            half[a] = words[r][a] << c;
            half[a] |= __shfl_xor_sync(0xffffffffu, half[a], 1);
            half[a] |= __shfl_xor_sync(0xffffffffu, half[a], 2);
          }
          if (c == 0)
            row_bits[kt * kTile + frag_row(t) + 8 * r] = half[0] | (uint64_t)half[1] << 32;
        }
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i / 2) % 2;
        dsum[r] = __fadd_rn(dsum[r], __fmul_rn(s[i], dp[i]));
      }
      if (kt == nt - 1) {
        dsum[0] = quad_sum(dsum[0]);
        dsum[1] = quad_sum(dsum[1]);
      }
      continue;
    }
    // sweep 2: pd and ds, as fragments
    float pd[32];
    if constexpr (DROP) {  // the mask sweep 1 drew
      uint32_t words[2][2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const uint64_t word = row_bits[kt * kTile + frag_row(t) + 8 * r] >> c;
        words[r][0] = static_cast<uint32_t>(word);
        words[r][1] = static_cast<uint32_t>(word >> 32);
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const bool keep = kept(words, i);
        dp[i] = apply_keep(dp[i], keep, drop.inv_keep);
        pd[i] = apply_keep(s[i], keep, drop.inv_keep);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) pd[i] = s[i];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i)  // ds
      s[i] = __fmul_rn(__fmul_rn(s[i], __fsub_rn(dp[i], dsum[(i / 2) % 2])), scale);
    uint32_t a[4][4], at[4][4];
    pack_rows(s, a);
    const size_t at_tile = frag_tile(bh, nt, row_tile, kt);
    store_frags(frags + kDs * tiles * kFragWords + at_tile, a, t);
    transpose_frags(a, at, trans, t);
    store_frags(frags + kDsT * tiles * kFragWords + at_tile, at, t);
    pack_rows(pd, a);
    transpose_frags(a, at, trans + kTile * kTransLd, t);
    store_frags(frags + kPdT * tiles * kFragWords + at_tile, at, t);
  }
}

template <bool DROP>
cudaError_t launch_loop(const void* q, const void* k, const void* v, const void* dout,
                        const void* key_mask, void* dq, void* dk, void* dv, void* frags,
                        int batch, int heads, int seq, int dh, float scale, DropoutParams drop,
                        cudaStream_t stream) {
  const bf16* qe = static_cast<const bf16*>(q);
  const bf16* ke = static_cast<const bf16*>(k);
  const bf16* de = static_cast<const bf16*>(dout);
  uint32_t* fr = static_cast<uint32_t*>(frags);
  const size_t smem = scores_loop_smem_bytes<DROP>(seq);
  cudaError_t err = cudaFuncSetAttribute(attention_bwd_scores_loop_kernel<DROP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  attention_bwd_scores_loop_kernel<DROP><<<dim3(seq / kTile, heads, batch), kWarpgroup, smem,
                                           stream>>>(
      qe, ke, static_cast<const bf16*>(v), de, static_cast<const int*>(key_mask), fr, heads, seq,
      dh, scale, drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t words = (size_t)batch * heads * (seq / kTile) * (seq / kTile) * kFragWords;
  err = launch_slices<false>(ke, fr + kDs * words, static_cast<bf16*>(dq), batch, heads, seq, dh,
                             stream);
  if (err != cudaSuccess) return err;
  err = launch_slices<true>(qe, fr + kDsT * words, static_cast<bf16*>(dk), batch, heads, seq, dh,
                            stream);
  if (err != cudaSuccess) return err;
  return launch_slices<true>(de, fr + kPdT * words, static_cast<bf16*>(dv), batch, heads, seq,
                             dh, stream);
}

// ---------------------------------------------------------------------------
// f32: the simple body
// ---------------------------------------------------------------------------

// Pass 1: one block per (batch, head, 16 query rows); writes dq and the rows'
// statistics. q, k, v and do are read from device memory and dq written there,
// so shared memory holds the two score tiles and the row vectors.
__global__ void __launch_bounds__(kThreads)
attention_bwd_f32_rows_kernel(const float* __restrict__ q, const float* __restrict__ k,
                               const float* __restrict__ v, const float* __restrict__ dout,
                               const int* __restrict__ key_mask, float* __restrict__ dq,
                               float* __restrict__ stats, int heads, int seq, int dh, float scale,
                               DropoutParams drop) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int b = blockIdx.z, h = blockIdx.y, row0 = blockIdx.x * kRows;
  const size_t bh = (size_t)b * heads + h, slice = bh * seq * dh;
  const size_t rows_total = (size_t)gridDim.z * heads * seq;
  const int s_ld = seq + 4;
  float* s = reinterpret_cast<float*>(smem);  // [kRows][s_ld]: scores, then p, then ds
  float* dpd = s + kRows * s_ld;              // [kRows][s_ld]: do v^T, then dp
  float* bias = dpd + kRows * s_ld;           // [seq]
  for (int c = threadIdx.x; c < seq; c += kThreads)
    bias[c] = key_mask[(size_t)b * seq + c] != 0 ? 0.0f : kMaskBias;
  score_rows(q + slice + (size_t)row0 * dh, k + slice, s, s_ld, seq, dh);
  score_rows(dout + slice + (size_t)row0 * dh, v + slice, dpd, s_ld, seq, dh);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < kRows; r += kWarps) {
    float* srow = s + r * s_ld;
    float* drow = dpd + r * s_ld;
    // the forward's softmax, step for step (attention_fwd.cu:softmax_rows)
    float m = -INFINITY;
    for (int c = lane; c < seq; c += 32) {
      const float x = logit(srow[c], scale, bias[c]);
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
    for (int c = lane; c < seq; c += 32)  // ds, in place of p
      srow[c] = __fmul_rn(__fmul_rn(srow[c], __fsub_rn(drow[c], dsum_row)), scale);
    if (lane == 0) {
      const size_t i = bh * seq + row0 + r;
      stats[kMax * rows_total + i] = m;
      stats[kSum * rows_total + i] = sum;
      stats[kD * rows_total + i] = dsum_row;
    }
  }
  __syncthreads();
  weigh_rows(s, s_ld, k + slice, dq + slice + (size_t)row0 * dh, seq, dh);
}

// Pass 2: one block per (batch, head, 16 keys); writes dv and dk.
__global__ void __launch_bounds__(kThreads)
attention_bwd_f32_cols_kernel(const float* __restrict__ q, const float* __restrict__ k,
                               const float* __restrict__ v, const float* __restrict__ dout,
                               const int* __restrict__ key_mask, const float* __restrict__ stats,
                               float* __restrict__ dk, float* __restrict__ dv, int heads, int seq,
                               int dh, float scale, DropoutParams drop) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int b = blockIdx.z, h = blockIdx.y, key0 = blockIdx.x * kRows;
  const size_t bh = (size_t)b * heads + h, slice = bh * seq * dh;
  const size_t rows_total = (size_t)gridDim.z * heads * seq;
  const int s_ld = seq + 4;
  float* s = reinterpret_cast<float*>(smem);  // [kRows][s_ld]: k q^T, then pd
  float* dpd = s + kRows * s_ld;              // [kRows][s_ld]: v do^T, then ds
  float* row_max = dpd + kRows * s_ld;        // [3][seq]
  float* row_sum = row_max + seq;
  float* row_d = row_sum + seq;
  for (int c = threadIdx.x; c < seq; c += kThreads) {
    const size_t i = bh * seq + c;
    row_max[c] = stats[kMax * rows_total + i];
    row_sum[c] = stats[kSum * rows_total + i];
    row_d[c] = stats[kD * rows_total + i];
  }
  // transposed tiles: row r is key key0 + r, column c is query c
  score_rows(k + slice + (size_t)key0 * dh, q + slice, s, s_ld, seq, dh);
  score_rows(v + slice + (size_t)key0 * dh, dout + slice, dpd, s_ld, seq, dh);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < kRows; r += kWarps) {
    const int j = key0 + r;
    const float bias = key_mask[(size_t)b * seq + j] != 0 ? 0.0f : kMaskBias;
    float* srow = s + r * s_ld;
    float* drow = dpd + r * s_ld;
    for (int c = lane; c < seq; c += 32) {
      const float x = logit(srow[c], scale, bias);
      const float p = expf(x - row_max[c]) / row_sum[c];
      float pdv = p, dp = drow[c];
      if (drop.active) {
        const bool keep =
            proqa_keep(drop.k0, drop.k1, (bh * seq + c) * (uint64_t)seq + j, drop.threshold);
        pdv = keep ? __fmul_rn(p, drop.inv_keep) : 0.0f;
        dp = keep ? __fmul_rn(dp, drop.inv_keep) : 0.0f;
      }
      srow[c] = pdv;  // pd
      drow[c] = __fmul_rn(__fmul_rn(p, __fsub_rn(dp, row_d[c])), scale);  // ds
    }
  }
  __syncthreads();
  weigh_rows(s, s_ld, dout + slice, dv + slice + (size_t)key0 * dh, seq, dh);
  weigh_rows(dpd, s_ld, q + slice, dk + slice + (size_t)key0 * dh, seq, dh);
}

cudaError_t launch_f32(const void* q, const void* k, const void* v, const void* dout,
                       const void* key_mask, void* dq, void* dk, void* dv, void* stats, int batch,
                       int heads, int seq, int dh, float scale, DropoutParams drop,
                       cudaStream_t stream) {
  const size_t smem = (2 * (size_t)kRows * (seq + 4) + 3 * (size_t)seq) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(attention_bwd_f32_rows_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(attention_bwd_f32_cols_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(seq / kRows, heads, batch);
  const float* qe = static_cast<const float*>(q);
  const float* ke = static_cast<const float*>(k);
  const float* ve = static_cast<const float*>(v);
  const float* de = static_cast<const float*>(dout);
  const int* mask = static_cast<const int*>(key_mask);
  float* st = static_cast<float*>(stats);
  attention_bwd_f32_rows_kernel<<<grid, kThreads, smem, stream>>>(
      qe, ke, ve, de, mask, static_cast<float*>(dq), st, heads, seq, dh, scale, drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_bwd_f32_cols_kernel<<<grid, kThreads, smem, stream>>>(
      qe, ke, ve, de, mask, st, static_cast<float*>(dk), static_cast<float*>(dv), heads, seq, dh,
      scale, drop);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const void* key_mask, void* dq, void* dk, void* dv, void* stats,
                   void* keep_bits, int batch, int heads, int seq, float scale, int is_bf16,
                   DropoutParams drop, cudaStream_t stream) {
  if (!is_bf16)
    return launch_f32(q, k, v, dout, key_mask, dq, dk, dv, stats, batch, heads, seq, DH, scale,
                      drop, stream);
  if (!drop.active)
    return launch_wgmma<DH, false>(q, k, v, dout, key_mask, dq, dk, dv, stats, keep_bits, batch,
                                   heads, seq, scale, drop, stream);
  if (keep_bits == nullptr) return cudaErrorInvalidValue;
  return launch_wgmma<DH, true>(q, k, v, dout, key_mask, dq, dk, dv, stats, keep_bits, batch,
                                heads, seq, scale, drop, stream);
}

}  // namespace

// q, k, v, dout, dq, dk, dv [batch, heads, seq, head_dim] row-major (bf16
// when is_bf16, else f32; 32-byte aligned); head_dim 16, 32, 64, 128, 256 or a
// larger multiple of 128 (ops/attention.py pads any other head dim to the
// next of these); key_mask int32
// [batch, seq], nonzero = attend; stats f32 scratch [4, batch * heads * seq];
// keep_bits u64 scratch [batch * heads * seq / 64 * seq], needed by bf16 with
// dropout up to head dim 128 (else may be null); frags u32 scratch [3 * batch
// * heads * (seq / 64)^2 * 2048], needed by bf16 from head dim 256 (else may
// be null). Dropout as in proqa_attention_fwd. Returns a cudaError_t code.
extern "C" int proqa_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* dout, const void* key_mask, void* dq, void* dk,
                                   void* dv, void* stats, void* keep_bits, void* frags,
                                   int batch, int heads,
                                   int seq, int head_dim, float scale, int is_bf16, int dropout,
                                   uint32_t k0, uint32_t k1, uint32_t threshold, float inv_keep,
                                   void* stream) {
  if (batch <= 0 || heads <= 0 || batch > kMaxGrid || heads > kMaxGrid || seq <= 0 ||
      seq % 128 != 0 || seq > kMaxSeq)
    return cudaErrorInvalidValue;
  const DropoutParams drop{k0, k1, threshold, inv_keep, dropout};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16:
      return launch<16>(q, k, v, dout, key_mask, dq, dk, dv, stats, keep_bits, batch, heads, seq,
                        scale, is_bf16, drop, s);
    case 32:
      return launch<32>(q, k, v, dout, key_mask, dq, dk, dv, stats, keep_bits, batch, heads, seq,
                        scale, is_bf16, drop, s);
    case 64:
      return launch<64>(q, k, v, dout, key_mask, dq, dk, dv, stats, keep_bits, batch, heads, seq,
                        scale, is_bf16, drop, s);
    case 128:
      return launch<128>(q, k, v, dout, key_mask, dq, dk, dv, stats, keep_bits, batch, heads,
                         seq, scale, is_bf16, drop, s);
    default:
      if (head_dim < 256 || head_dim % kChunk != 0) return cudaErrorInvalidValue;
      if (!is_bf16)
        return launch_f32(q, k, v, dout, key_mask, dq, dk, dv, stats, batch, heads, seq,
                          head_dim, scale, drop, s);
      if (frags == nullptr) return cudaErrorInvalidValue;
      return drop.active ? launch_loop<true>(q, k, v, dout, key_mask, dq, dk, dv, frags, batch,
                                             heads, seq, head_dim, scale, drop, s)
                         : launch_loop<false>(q, k, v, dout, key_mask, dq, dk, dv, frags,
                                              batch, heads, seq, head_dim, scale, drop, s);
  }
}
