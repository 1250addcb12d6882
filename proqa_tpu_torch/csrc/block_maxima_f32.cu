// K1 over an f32 corpus and f32 queries on Hopper: block maxima for exact
// MIPS, with the products in full f32 on the FMA pipe and the maxima taken
// on the registers.
//
// Replaces, on the port's f32 search path (`--f32`: DenseIndex(dtype=
// float32), mips_topk_v2, block_maxima_grouped), the f32 case of
// proqa_tpu/ops/pallas_mips.py:83 _bmax3_kernel (pallas_call at :228), which
// the JAX package runs at HIGHEST precision (:129-149): for a tile of queries
// and one group of `group` consecutive corpus blocks of `block` rows, the
// maximum f32 score of each block (bmax3 [CG, Q, G]) and of the group (gmax
// [CG, 1, Q]). The reference pins f32 scoring to full precision
// (proqa_tpu/ops/mips.py:38-42, ops/dot.py here), so the tensor cores, whose
// f32 inputs are TF32, are not used: 3xTF32 or a bf16 split would change
// the numerics of the path its users run for parity. Every emitted value is
// the maximum of its own block's f32 scores, so the exactness certificate of
// pallas_mips.py:295-298 holds unchanged.
//
// What bounds it on the H100 (SXM, 700 W published peaks): operations,
// 2 * Q * N * 128 at the f32 FMA rate of 67 TFLOP/s (32.8 ms at Q = 2,048,
// N = 4,194,304); the bytes, the corpus once (2.15 GB) and bmax3 (2.15 GB at
// block 16), take 1.28 ms at 3.35 TB/s. Each of an SM's four schedulers
// issues one warp instruction a clock, so the FMAs must be nearly all of the
// instruction stream; and the shared-memory loads that feed them are the
// other limit: in development runs on the H100, each 16-byte-a-lane load
// cost the same whatever its addresses (2 or 16 distinct rows, a warp
// broadcast or not), and loading one operand from registers instead sped
// the kernel up by far more than the loads' share of the issue slots. So
// the design counts loads per FMA. What it does about each:
// - Register tiles fed by vector loads: 256 FMA threads (two warpgroups,
//   232 registers a thread, which a producer warpgroup that keeps 40 leaves
//   them), thread (qg, rg) = (2 w + l / 16, l % 16) for lane l of warp w,
//   each with a QT x 8 tile of f32 accumulators: queries qg + 16 j (j < QT)
//   and corpus rows rg + 16 i (i < 8). Per four columns of D a thread
//   issues QT + 8 LDS.128 and 32 QT FFMA. QT = 16 (256-query tiles, Q >
//   128): 24 loads per 512 FMAs, 128 accumulators; QT = 8 (128-query tiles,
//   Q <= 128, where a larger tile would only add work): 16 per 256, as the
//   simple body's 8 scalar loads per 16 FMAs never could. 16 x 16 would
//   halve the loads again but needs 256 accumulators, more than a thread's
//   255 registers.
// - Bank pattern: both operands lie in shared memory as TMA lays out f32
//   boxes of 32 columns (128 bytes) with the 128-byte swizzle, 16-byte unit
//   u of row r at r * 128 + ((u ^ r % 8) * 16). A warp's corpus load reads
//   rows rg + 16 i for rg = 0..15, whose swizzle phases rg % 8 differ within
//   each half: each quarter warp hits 8 distinct bank groups. Its query load
//   reads rows qg + 16 j of two adjacent qg (phases differ). Rows 16 apart
//   share a phase, so a thread's addresses of one load are immediates 2,048
//   bytes apart from one XOR of its base (tests/test_torch_bmax_fragments.py
//   mirrors them). Interleaved rows are the price: 8 consecutive rows a
//   thread would put a quarter warp's rows 8 apart, on one bank group at any
//   padding that keeps 16-byte rows.
// - Queries resident, corpus streamed: the query tile (16 QT rows, 64 or 128
//   KB) is copied into shared memory once a CUDA block; the producer
//   warpgroup's first thread copies the corpus by TMA, one box (128 rows x
//   32 columns, 16 KB) a stage, four stages a 128-row chunk, into a ring of
//   as many stages as the rest of the 227 KB holds (6 at QT = 16, 10 at
//   QT = 8), each with a full and an empty mbarrier, so the copies run ahead
//   of the products. The FMA threads hand a stage back as soon as their
//   products have read it: no block barrier in the loop.
// - Maxima on the registers: after a chunk's four stages a thread folds its
//   rows of one block (block / 16 of them; 8 from block 128 on), then the 16
//   lanes of a half warp, which share queries and hold every row of the
//   chunk between them, finish the maxima with exchanges of halves across
//   lane bits 1, 2, 4 and 8 (each lane keeps half of what it holds and takes
//   its partner's other half), a few hundred shuffles against 16,384 FMAs at
//   QT = 16. At QT = 16 that leaves each lane one query and all the chunk's
//   blocks; at QT = 8 one query and half of them. A lane stores its run of
//   consecutive blocks as vectors; block 256 spans two chunks through
//   `part`, and the group maximum is a running register value. No score
//   touches shared memory.
// - Reuse: the grid is persistent as K1's bf16 kernel's, (query tiles, ~132 /
//   tiles); block (x, y) walks groups y, y + gridDim.y, ..., so the blocks
//   that read one group are resident together and a chunk comes from device
//   memory once and from L2 after that.
// Widths: the above is the D = 128 form (bmax_f32_kernel). Every other width
// that is a multiple of 16, with no upper limit, runs bmax_f32_wide_kernel:
// the query tile moves from resident shared memory into the ring, each stage
// one 32-column box of the chunk beside the same box of the tile, and a
// chunk's products loop over ceil(D / 32) boxes (the FMA pipe still bounds
// it; the tile's boxes add a third of a stage's bytes at QT = 16, from L2).
// The last group may be partial (n a multiple of block): its rows past n
// arrive as zeros.
#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "block_maxima_common.cuh"

namespace {

using namespace bmax;

constexpr int kDim = 128;           // embedding width the kernel takes
constexpr int kChunk = 128;         // corpus rows a chunk
constexpr int kConsumers = 256;     // FMA threads: thread (qg, rg), 16 x 16
constexpr int kThreads = kConsumers + 128;  // and a producer warpgroup
// the register split (setmaxnreg): an SM sub-partition's 16K registers hold
// one producer warp and two FMA warps, 40 + 2 x 232 registers a thread
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr uint32_t kBoxBytes = 128 * 128;  // one corpus stage: 128 rows x 32 f32 columns
constexpr uint32_t kRowsApart = 16 * 128;  // bytes between rows r and r + 16 of a box
constexpr size_t kSmemLimit = 232448;      // 227 KB a block
constexpr int kMaxGrid = 65535;

// The query tile of QT queries a thread, and the ring the rest of shared
// memory holds: the tile, then the stages (both 1024-byte aligned for the
// swizzle), then a full and an empty barrier a stage.
template <int QT>
struct Tile {
  static constexpr int kQueries = 16 * QT;                      // a CUDA block's queries
  static constexpr uint32_t kQueryBoxBytes = kQueries * 128;    // its 32 columns of D
  static constexpr uint32_t kQueryBytes = 4 * kQueryBoxBytes;
  static constexpr int kStages = (kSmemLimit - 1024 - 256 - kQueryBytes) / kBoxBytes;
  static constexpr size_t kSmem = kQueryBytes + kStages * kBoxBytes + 1024 + 16 * kStages;
  static constexpr int kUnroll = 16 / QT;  // u-steps a loop body: ~540 instructions at QT = 16
  static_assert(kStages >= 4 && kSmem <= kSmemLimit, "the ring must hold a chunk");
};

__device__ __forceinline__ float4 lds128(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
}
__device__ __forceinline__ void sts128(uint32_t addr, float4 v) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "f"(v.x), "f"(v.y),
               "f"(v.z), "f"(v.w)
               : "memory");
}
// The FMA threads' own barrier (the producer warpgroup has returned).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// Byte of 16-byte unit u (columns 4 u .. 4 u + 3 of its box) of row r in a
// box of TMA's 128-byte swizzle.
__device__ __forceinline__ uint32_t swizzled(int r, int u) {
  return r * 128 + ((u ^ (r % 8)) * 16);
}

// The query tile: rows q0 .. q0 + 16 QT - 1 of queries, zero past num_q,
// in the layout TMA gives a corpus box (four boxes of 32 columns), by the
// 256 FMA threads.
template <int QT>
__device__ __forceinline__ void load_queries(uint32_t qs, const float* __restrict__ queries,
                                             int q0, int num_q, int t) {
#pragma unroll 4
  for (int e = t; e < Tile<QT>::kQueries * kDim / 4; e += kConsumers) {
    const int r = e / 32, col = e % 32;  // 16-byte unit col of row r: box col / 8, unit col % 8
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < num_q)
      v = __ldg(reinterpret_cast<const float4*>(queries + (size_t)(q0 + r) * kDim) + col);
    sts128(qs + (col / 8) * Tile<QT>::kQueryBoxBytes + swizzled(r, col % 8), v);
  }
}

// acc[j][i] += dot over the 32 columns of one box of (query qg + 16 j, chunk
// row rg + 16 i), in column order. qa and ca: the bytes of unit 0 of row qg
// (rg) in the query box and the corpus stage, i.e. box + row * 128 + phase *
// 16; unit u of row + 16 k lies at (base ^ 16 u) + 2048 k.
template <int QT>
__device__ __forceinline__ void products(float (&acc)[QT][8], uint32_t qa, uint32_t ca) {
#pragma unroll Tile<QT>::kUnroll
  for (int u = 0; u < 8; ++u) {
    const uint32_t qu = qa ^ (u * 16), cu = ca ^ (u * 16);
    float4 c[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) c[i] = lds128(cu + i * kRowsApart);
#pragma unroll
    for (int j = 0; j < QT; ++j) {
      const float4 q = lds128(qu + j * kRowsApart);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[j][i] = fmaf(q.x, c[i].x, acc[j][i]);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[j][i] = fmaf(q.y, c[i].y, acc[j][i]);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[j][i] = fmaf(q.z, c[i].z, acc[j][i]);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[j][i] = fmaf(q.w, c[i].w, acc[j][i]);
    }
  }
}

template <int BLOCK, int QT>
struct Blocks {
  static constexpr int kFold = BLOCK >= kChunk ? 8 : BLOCK / 16;  // a thread's rows of a block
  static constexpr int kNb = 8 / kFold;                // blocks a chunk (1 from block 128 on)
  static constexpr int kSpan = BLOCK > kChunk ? BLOCK / kChunk : 1;  // chunks a block
  static constexpr int kValues = QT * kNb;             // (query, block) maxima a thread folds
  // blocks a lane finishes a chunk: QT = 16, all kNb (four exchanges split
  // the queries); QT = 8, half of them (the fourth splits the blocks), or
  // the one block, which lanes l and l ^ 8 then both hold
  static constexpr int kRun = QT == 16 ? kNb : (kNb >= 2 ? kNb / 2 : 1);
};

// The query (of its thread tile) a lane's maxima belong to after the
// exchanges across lane bits 1, 2, 4 (and 8 at QT = 16), each of which
// halves the queries the lane holds, top index bit first.
template <int QT>
__device__ __forceinline__ int lane_query(int l) {
  const int j = 4 * (l & 1) + 2 * (l >> 1 & 1) + (l >> 2 & 1);
  return QT == 16 ? 2 * j + (l >> 3 & 1) : j;
}

// The block maxima of chunk c (of its group) from a thread's accumulators.
// Lane l (of its half warp) ends with query lane_query(l) of its thread tile
// and a run of Blocks::kRun blocks from c kNb (+ kNb / 2 for bit 8 at QT = 8;
// from block 128 on the one block c / kSpan, stored by the lane with bit 8
// clear at QT = 8). `out`: the query's row of bmax3 for its group, null past
// the last query. `part` carries a 256-row block's maxima from its first
// chunk to its second; `gm` is the query's running group maximum.
template <int BLOCK, int QT>
__device__ __forceinline__ void take_maxima(const float (&acc)[QT][8], int c, float* out, int l,
                                            float (&part)[Blocks<BLOCK, QT>::kValues],
                                            float& gm) {
  using B = Blocks<BLOCK, QT>;
  constexpr int kNb = B::kNb, kFold = B::kFold, kK = B::kValues;
  // v[j * kNb + b]: the maximum of this thread's rows of block b, query j
  float v[kK];
#pragma unroll
  for (int j = 0; j < QT; ++j)
#pragma unroll
    for (int b = 0; b < kNb; ++b) {
      float m = acc[j][b * kFold];
#pragma unroll
      for (int i = b * kFold + 1; i < (b + 1) * kFold; ++i) m = fmaxf(m, acc[j][i]);
      v[j * kNb + b] = m;
    }
  if constexpr (B::kSpan > 1) {
    const int step = c % B::kSpan;
#pragma unroll
    for (int k = 0; k < kK; ++k) part[k] = step == 0 ? v[k] : fmaxf(part[k], v[k]);
    if (step != B::kSpan - 1) return;
#pragma unroll
    for (int k = 0; k < kK; ++k) v[k] = part[k];
  }
  float w1[kK / 2], w2[kK / 4], w3[kK / 8], u[B::kRun];
  exchange_halves<kK>(v, w1, l & 1, 1);
  exchange_halves<kK / 2>(w1, w2, l & 2, 2);
  exchange_halves<kK / 4>(w2, w3, l & 4, 4);
  if constexpr (QT == 16 || kNb >= 2) {
    exchange_halves<kK / 8>(w3, u, l & 8, 8);
  } else {
    u[0] = fmaxf(w3[0], __shfl_xor_sync(0xffffffffu, w3[0], 8));
  }
#pragma unroll
  for (int k = 0; k < B::kRun; ++k) gm = fmaxf(gm, u[k]);
  if (out == nullptr) return;
  if constexpr (QT == 16) {
    store_run<B::kRun>(out + c / B::kSpan * kNb, u);
  } else if constexpr (kNb >= 2) {
    store_run<B::kRun>(out + c * kNb + (l & 8 ? kNb / 2 : 0), u);
  } else if ((l & 8) == 0) {
    out[c / B::kSpan] = u[0];
  }
}

// Grid (query tiles of 16 QT, gy); block (x, y) scores its query tile
// against groups y, y + gy, ... < num_groups, whose `group` blocks of BLOCK
// rows each are contiguous f32 corpus rows. Warpgroups 0 and 1 multiply and
// take maxima; the first thread of warpgroup 2 feeds the ring by TMA.
template <int BLOCK, int QT>
__global__ void __launch_bounds__(kThreads, 1)
bmax_f32_kernel(const __grid_constant__ CUtensorMap corpus, const float* __restrict__ queries,
                float* __restrict__ bmax, float* __restrict__ gmax, int num_q, int group,
                int num_groups) {
  using T = Tile<QT>;
  constexpr int kStages = T::kStages;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t qs = (static_cast<uint32_t>(__cvta_generic_to_shared(smem)) + 1023) & ~1023u;
  const uint32_t ring = qs + T::kQueryBytes;
  const uint32_t full = ring + kStages * kBoxBytes, empty = full + 8 * kStages;
  const int tid = threadIdx.x, warp = tid / 32, l = tid % 32;
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int per_group = group * BLOCK / kChunk;  // chunks a group
  const int total = (num_groups - 1 - (int)blockIdx.y) / (int)gridDim.y * per_group + per_group;
  // chunk s of this block: chunk s % per_group of group y + (s / per_group) gy;
  // its box b (columns 32 b ..) is stage use t = 4 s + b of the ring
  auto group_of = [&](int s) { return (int)blockIdx.y + s / per_group * (int)gridDim.y; };

  if (tid >= kConsumers) {  // the producer: stage t % kStages, once its last reader is done
    set_max_registers<false, kProducerRegs>();
    if (tid == kConsumers)
      for (int t = 0; t < 4 * total; ++t) {
        const int stage = t % kStages, s = t / 4;
        mbar_wait(empty + 8 * stage, ((t / kStages) & 1) ^ 1);
        mbar_expect_tx(full + 8 * stage, kBoxBytes);
        tma_load(ring + stage * kBoxBytes, &corpus, 32 * (t % 4),
                 (group_of(s) * per_group + s % per_group) * kChunk, full + 8 * stage);
      }
    return;
  }

  set_max_registers<true, kConsumerRegs>();
  const int q0 = (int)blockIdx.x * T::kQueries;
  load_queries<QT>(qs, queries, q0, num_q, tid);
  consumers_sync();
  const int qg = 2 * warp + l / 16, rg = l % 16;
  const uint32_t qa = qs + swizzled(qg, 0), ca = swizzled(rg, 0);
  const int my_q = q0 + qg + 16 * lane_query<QT>(rg);
  const bool q_valid = my_q < num_q;

  float part[Blocks<BLOCK, QT>::kValues];
  float gm = -INFINITY;
  for (int s = 0; s < total; ++s) {
    float acc[QT][8];
#pragma unroll
    for (int j = 0; j < QT; ++j)
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[j][i] = 0.0f;
#pragma unroll 1
    for (int b = 0; b < 4; ++b) {
      const int t = 4 * s + b, stage = t % kStages;
      mbar_wait(full + 8 * stage, (t / kStages) & 1);
      products<QT>(acc, qa + b * T::kQueryBoxBytes, ring + stage * kBoxBytes + ca);
      mbar_arrive(empty + 8 * stage);
    }
    const int c = s % per_group;
    const size_t row = (size_t)group_of(s) * num_q + my_q;
    take_maxima<BLOCK, QT>(acc, c, q_valid ? bmax + row * group : nullptr, rg, part, gm);
    if (c == per_group - 1) {
      if constexpr (QT == 8) gm = fmaxf(gm, __shfl_xor_sync(0xffffffffu, gm, 8));
      if (q_valid && (QT == 16 || (rg & 8) == 0)) gmax[row] = gm;
      gm = -INFINITY;
    }
  }
}

// ---------------------------------------------------------------------------
// Every other width: the K loop (bmax_f32_wide_kernel)
// ---------------------------------------------------------------------------

// The wide form's ring: step t is box t % boxes (32 columns) of a chunk, its
// stage that corpus box and then the query tile's box of the same columns
// (16 QT rows x 32 columns, the layout load_queries gives one box).
template <int QT>
struct WideTile {
  static constexpr uint32_t kQueryBox = Tile<QT>::kQueryBoxBytes;
  static constexpr uint32_t kStageBytes = kBoxBytes + kQueryBox;
  static constexpr int kStages = (kSmemLimit - 1024 - 256) / kStageBytes;
  static constexpr size_t kSmem = kStages * kStageBytes + 1024 + 16 * kStages;
  static_assert(kStages >= 4 && kSmem <= kSmemLimit, "the ring must hold four steps");
};

// bmax_f32_kernel at any width D (a multiple of 16): the query tile (16 QT
// rows x D f32, 1 MB at D = 1,024 and QT = 16) no longer fits in shared
// memory, so it moves into the ring: each step's stage holds one 32-column
// box of the chunk and the same box of the tile, both copied by TMA (a box
// past D arrives zero-filled, and zeros add nothing). A chunk's products run
// over ceil(D / 32) steps into the same accumulators, in column order; the
// maxima, the stores and the walk are bmax_f32_kernel's.
template <int BLOCK, int QT>
__global__ void __launch_bounds__(kThreads, 1)
bmax_f32_wide_kernel(const __grid_constant__ CUtensorMap corpus,
                     const __grid_constant__ CUtensorMap queries, float* __restrict__ bmax,
                     float* __restrict__ gmax, int num_q, int group, int num_groups, int boxes) {
  using W = WideTile<QT>;
  constexpr int kStages = W::kStages;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t ring = (static_cast<uint32_t>(__cvta_generic_to_shared(smem)) + 1023) & ~1023u;
  const uint32_t full = ring + kStages * W::kStageBytes, empty = full + 8 * kStages;
  const int tid = threadIdx.x, warp = tid / 32, l = tid % 32;
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int per_group = group * BLOCK / kChunk;  // chunks a group
  const int total = (num_groups - 1 - (int)blockIdx.y) / (int)gridDim.y * per_group + per_group;
  auto group_of = [&](int s) { return (int)blockIdx.y + s / per_group * (int)gridDim.y; };
  const int q0 = (int)blockIdx.x * Tile<QT>::kQueries;

  if (tid >= kConsumers) {  // the producer: step t into stage t % kStages
    set_max_registers<false, kProducerRegs>();
    if (tid == kConsumers)
      for (int t = 0; t < boxes * total; ++t) {
        const int stage = t % kStages, s = t / boxes, col = 32 * (t % boxes);
        const uint32_t dst = ring + stage * W::kStageBytes, bar = full + 8 * stage;
        mbar_wait(empty + 8 * stage, ((t / kStages) & 1) ^ 1);
        mbar_expect_tx(bar, W::kStageBytes);
        tma_load(dst, &corpus, col, (group_of(s) * per_group + s % per_group) * kChunk, bar);
        tma_load(dst + kBoxBytes, &queries, col, q0, bar);
      }
    return;
  }

  set_max_registers<true, kConsumerRegs>();
  const int qg = 2 * warp + l / 16, rg = l % 16;
  const uint32_t qa = kBoxBytes + swizzled(qg, 0), ca = swizzled(rg, 0);
  const int my_q = q0 + qg + 16 * lane_query<QT>(rg);
  const bool q_valid = my_q < num_q;

  float part[Blocks<BLOCK, QT>::kValues];
  float gm = -INFINITY;
  for (int s = 0; s < total; ++s) {
    float acc[QT][8];
#pragma unroll
    for (int j = 0; j < QT; ++j)
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[j][i] = 0.0f;
#pragma unroll 1
    for (int b = 0; b < boxes; ++b) {
      const int t = boxes * s + b, stage = t % kStages;
      const uint32_t st = ring + stage * W::kStageBytes;
      mbar_wait(full + 8 * stage, (t / kStages) & 1);
      products<QT>(acc, st + qa, st + ca);
      mbar_arrive(empty + 8 * stage);
    }
    const int c = s % per_group;
    const size_t row = (size_t)group_of(s) * num_q + my_q;
    take_maxima<BLOCK, QT>(acc, c, q_valid ? bmax + row * group : nullptr, rg, part, gm);
    if (c == per_group - 1) {
      if constexpr (QT == 8) gm = fmaxf(gm, __shfl_xor_sync(0xffffffffu, gm, 8));
      if (q_valid && (QT == 16 || (rg & 8) == 0)) gmax[row] = gm;
      gm = -INFINITY;
    }
  }
}

struct Args {
  const void *queries, *corpus;
  void *bmax, *gmax;
  int num_q, n, dim, group, num_groups;
  cudaStream_t stream;
};

template <int BLOCK, int QT>
cudaError_t launch(const Args& x) {
  using T = Tile<QT>;
  auto kernel = bmax_f32_kernel<BLOCK, QT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)T::kSmem);
  if (err != cudaSuccess) return err;
  CUtensorMap map;
  if ((err = corpus_map(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, x.corpus, x.n)) != cudaSuccess)
    return err;
  int sms = 0;
  if ((err = multiprocessors(&sms)) != cudaSuccess) return err;
  const int tiles = (x.num_q + T::kQueries - 1) / T::kQueries;
  int gy = sms / tiles;
  gy = gy < 1 ? 1 : (gy > x.num_groups ? x.num_groups : gy);
  kernel<<<dim3(tiles, gy), kThreads, T::kSmem, x.stream>>>(
      map, static_cast<const float*>(x.queries), static_cast<float*>(x.bmax),
      static_cast<float*>(x.gmax), x.num_q, x.group, x.num_groups);
  return cudaGetLastError();
}

template <int BLOCK, int QT>
cudaError_t launch_wide(const Args& x) {
  using W = WideTile<QT>;
  auto kernel = bmax_f32_wide_kernel<BLOCK, QT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)W::kSmem);
  if (err != cudaSuccess) return err;
  CUtensorMap cmap, qmap;
  if ((err = tile_map(&cmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, x.corpus, x.dim, x.n, 32,
                      kChunk)) != cudaSuccess ||
      (err = tile_map(&qmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, x.queries, x.dim, x.num_q, 32,
                      Tile<QT>::kQueries)) != cudaSuccess)
    return err;
  int sms = 0;
  if ((err = multiprocessors(&sms)) != cudaSuccess) return err;
  const int tiles = (x.num_q + Tile<QT>::kQueries - 1) / Tile<QT>::kQueries;
  int gy = sms / tiles;
  gy = gy < 1 ? 1 : (gy > x.num_groups ? x.num_groups : gy);
  kernel<<<dim3(tiles, gy), kThreads, W::kSmem, x.stream>>>(
      cmap, qmap, static_cast<float*>(x.bmax), static_cast<float*>(x.gmax), x.num_q, x.group,
      x.num_groups, (x.dim + 31) / 32);
  return cudaGetLastError();
}

// D = 128: bmax_f32_kernel (the query tile resident); any other width:
// bmax_f32_wide_kernel
template <int BLOCK>
cudaError_t launch_tile(const Args& x) {
  if (x.dim != kDim) return x.num_q > 128 ? launch_wide<BLOCK, 16>(x) : launch_wide<BLOCK, 8>(x);
  return x.num_q > 128 ? launch<BLOCK, 16>(x) : launch<BLOCK, 8>(x);
}

}  // namespace

// queries [num_q, dim] and corpus [n, dim] f32, row-major and 16-byte
// aligned, dim a multiple of 16; bmax [CG, num_q, group] and gmax
// [CG, 1, num_q] f32, CG = ceil(n / (group * block)): n is a multiple of
// block, and the last group's rows past n arrive as zeros (TMA's fill).
// block in {16, 32, 64, 128, 256}, group * block a multiple of 128
// (ops/mips_kernel.py:kernel_for). Returns a cudaError_t code.
extern "C" int proqa_block_maxima_f32(const void* queries, const void* corpus, void* bmax,
                                      void* gmax, int num_q, int n, int dim, int block,
                                      int group, void* stream) {
  if (dim <= 0 || dim % kDimMultiple != 0 || num_q <= 0 || n <= 0 || block <= 0 || group <= 0 ||
      (group * block) % kChunk != 0 || n % block != 0 ||
      (n + group * block - 1) / (group * block) > kMaxGrid)
    return cudaErrorInvalidValue;
  const Args x{queries, corpus, bmax, gmax, num_q, n, dim, group,
               (n + group * block - 1) / (group * block), static_cast<cudaStream_t>(stream)};
  switch (block) {
    case 16: return launch_tile<16>(x);
    case 32: return launch_tile<32>(x);
    case 64: return launch_tile<64>(x);
    case 128: return launch_tile<128>(x);
    case 256: return launch_tile<256>(x);
    default: return cudaErrorInvalidValue;
  }
}
