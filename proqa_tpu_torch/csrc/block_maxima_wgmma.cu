// K1, K5, K7 and K8 on Hopper: block maxima of a bf16 or int8 corpus against
// bf16 queries, for exact MIPS, with wgmma products and the maxima taken on
// the accumulators.
//
// Replaces, on the port's search paths (bf16 queries), four kernels of
// proqa_tpu/ops/pallas_mips.py. Three are launched by block_maxima_grouped
// (pallas_call at :228) through _bmax3_body (:129-149) and store the grouped
// output, bmax3 [CG, Q, G] (the maximum of each block of `block` rows, the G
// blocks of a group contiguous per query) and gmax [CG, 1, Q] (the maximum
// of each group):
//   K1 _bmax3_kernel (:83): a bf16 corpus, the raw block maxima;
//   K5 _bmax3_kernel_scaled (:97): int8 codes, each block maximum times its
//      block's f32 scale after the max-reduce and before the group maximum;
//   K7 _bmax3_kernel_bounded (:111): int8 codes with per-row scales, each raw
//      block maximum m turned into the bound m >= 0 ? m * smax : m * smin.
// The fourth, launched by block_maxima (pallas_call at :64) for the v1
// pipeline, stores block-major:
//   K8 _bmax_kernel (:32): a bf16 corpus, the raw block maxima as bmax
//      [N / block, Q], with no group level; tile_n keeps its meaning, the
//      corpus rows of one unit of the persistent walk (group = tile_n /
//      block).
// The corpus storage type, the epilogue and the output layout are template
// arguments (bmax_wgmma_kernel<BLOCK, NWG, S, E, L>, E one of RawMaxima,
// BlockScales, RowBounds, L one of Grouped, BlockMajor, so a profiler tells
// the four apart by name). f32 K1 runs block_maxima_f32.cu; f32 K8, f32
// queries over int8 codes and other shapes keep block_maxima.cu's simple
// body. Every emitted value is the epilogue of the maximum of its own
// block's f32 scores, as in pallas_mips.py:129-149, so the exactness
// certificate of pallas_mips.py:295-298 holds unchanged.
//
// What bounds it on the H100 (SXM, 700 W published peaks): operations,
// 2 * Q * N * 128 at the bf16 tensor-core rate of 989 TFLOP/s (2.22 ms at
// Q = 2,048, N = 4,194,304). int8 codes are products at that rate too: the
// queries are bf16 and the codes are widened to them, exactly, as
// pallas_mips.py:133-139 does (an s8 product would need quantized queries
// and change every score). The bytes it must move, the corpus once (1.07 GB
// bf16, 0.54 GB int8) and bmax3 (2.15 GB at block 16), take 0.96 ms (bf16)
// at 3.35 TB/s. What the design does about each:
// - Products: wgmma.m64n128k16, queries on the M side, corpus rows on the N
//   side. A warpgroup (128 threads) owns 64 queries; it loads their A
//   fragments once from device memory and keeps them in registers for the
//   CUDA block's life, so shared memory feeds only the B operand, a chunk of
//   128 corpus rows, K-major as the corpus is stored (nothing is
//   transposed), in the 128-byte swizzle layout.
// - Block maxima on the accumulators: 16 consecutive corpus rows are 16
//   accumulator columns, which the four threads of a quad hold for their two
//   query rows. A thread folds its own columns of each block with fmaxf,
//   then the quad exchanges halves twice (each lane keeps half the values it
//   holds and takes its partner's other half), which leaves each lane the
//   finished maxima of one query row and a run of consecutive blocks: no
//   score touches shared memory. Blocks of 32-128 rows fold across fragments
//   first, blocks of 256 across two chunks; the group maximum is a running
//   value in registers.
// - Epilogues on those registers: a lane's run of blocks is consecutive, so
//   it loads their scales (K5) or their smax and smin (K7) as one vector,
//   issued before the wait for the products it applies to, and applies them
//   in f32 to its finished maxima before they fold into the group maximum
//   and are stored. K7 tests the sign of the raw maximum (-0.0 >= 0 holds).
// - Streaming, bf16: one producer thread, in a warpgroup of its own that
//   hands its registers to the others (setmaxnreg 40; the consumers take
//   232), copies chunks by TMA into a ring of 6 stages of 32 KB, each with a
//   full and an empty mbarrier; the consumer warpgroups wait on a stage's
//   full barrier and hand it back once their products have read it. No block
//   barrier and no proxy fence in the loop: TMA writes through the async
//   proxy that wgmma reads, and the warpgroups run apart. Two accumulator
//   sets: chunk c's products run on the tensor cores while chunk c - 1's
//   maxima are taken.
// - Streaming, int8: the same consumers. The producer thread copies each
//   int8 chunk (128 rows x 128 bytes, one TMA box, 128-byte swizzle) into a
//   raw ring of its own (kRawStages of 16 KB); all 128 producer threads then
//   widen it into a bf16 stage in exactly the layout TMA gives a bf16 chunk
//   (widen_chunk), run fence.proxy.async (their stores go through the
//   generic proxy, wgmma reads through the async one) and arrive on the
//   stage's full barrier (128 arrivals, no transaction count); the raw stage
//   goes back to the producer thread through its own empty barrier. So the
//   conversion stays off the tensor cores' critical path, and the chunk
//   crosses from L2 to the SM in half the bytes. Shared memory: 6 bf16
//   stages, as K1's ring, and 2 raw stages, 224 KB of the 227 KB a block
//   may take; in development runs on the H100 a deeper bf16 ring counted
//   for more than a deeper raw one (5 + 4 and 4 + 6 stages were slower),
//   and producer threads loading the codes from device memory into
//   registers, with no raw ring, were slower still (the load latency showed).
//   Registers: the widening keeps four 16-byte loads and 16 widened bytes
//   live, so the producer warpgroup keeps 56 registers and the consumers
//   take 224 (56 x 128 + 224 x 256 fills the 64K registers the launch gets;
//   ptxas reports no spill, and 64 / 216 was no faster). What bounds it
//   now is the shared memory traffic (a chunk is written by TMA, read and
//   written widened by the producer, and read by both consumer warpgroups:
//   128 KB against K1's 96 KB) and the conversion's issue slots. The
//   conversion of a pair of codes is 4 instructions, no int-to-float
//   conversion (those issue at a quarter of the rate): a byte permute puts
//   codes b0, b1 in the low bytes of two bf16 whose high bytes are 0x43,
//   then (b & 0x7F | 0x4300) - (b & 0x80 | 0x4300) in bf16x2 is
//   (128 + (b & 127)) - (128 or 256) = b, exact for every byte value.
// - Reuse: two warpgroups, 128 queries a CUDA block (64 when Q <= 64), so a
//   corpus chunk crosses from L2 to the SMs Q / 128 times, half as often as
//   in the simple body. The blocks are persistent: the grid is (query tiles,
//   ~132 / tiles) and block (x, y) walks the groups y, y + gridDim.y, ...
//   with its ring running across them, so the blocks that read one group
//   are resident together and march through the groups in step.
// - Output: each lane stores its maxima from registers in runs of
//   consecutive blocks (16 bytes at block 16) while the next chunk's
//   products run. Block-major (K8), block b of a lane's query lies num_q
//   floats after block b - 1, so a run is num_q-strided scalar stores; the
//   16 lanes of a warp that hold one block store 16 consecutive queries
//   side by side (64 bytes), and at K8's block 256 a lane stores one value
//   every two chunks (bmax is 16x smaller than K1's bmax3 at block 16), so
//   the strided store costs no staging through shared memory.
// Widths. The design above is the D = 128 form (bmax_wgmma_kernel). Every
// other width D that is a multiple of 16, with no upper limit, runs
// bmax_wgmma_wide_kernel (the JAX package's Pallas kernel takes d % 128 ==
// 0, its XLA path any d): at D = 768 the queries' fragments would take 192
// registers a thread and 128 queries 192 KB of shared memory, so a chunk's
// products run as a K loop over 128-column slices, each ring stage carrying
// one slice of the chunk (its corpus part in the layout above) and the same
// slice of the CUDA block's queries, both read by wgmma from shared memory
// (m64n128k16, A and B by descriptor). The accumulators persist across a
// chunk's slices, the maxima are taken after its last, and the epilogues,
// stores and walk are the D = 128 form's. The queries' slices cross from L2
// once a chunk, as many bytes as the corpus's at 128 queries a block: at
// 64 FLOP a byte of L2 traffic against 128 at D = 128. int8 codes keep K5's
// raw ring: one raw box is one slice of 128 codes, widened as at D = 128.
// The last group may be partial (n a multiple of block, not of group *
// block): TMA fills its rows past n with zeros, so a search needs no padded
// copy of the corpus (ops/mips_kernel.py:mips_topk_v2).
// The TMA and mbarrier helpers, the tensor maps and the exchange of halves
// are shared with block_maxima_f32.cu (block_maxima_common.cuh).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_tiles.cuh"
#include "block_maxima_common.cuh"

namespace {

using attn::bf16;
using namespace bmax;

constexpr int kDim = 128;                        // embedding width the kernel takes
constexpr int kChunk = 128;                      // corpus rows a chunk: the wgmma N
constexpr uint32_t kChunkBytes = kChunk * kDim * 2;
constexpr uint32_t kHalfBytes = kChunkBytes / 2;  // one bf16 TMA box: 128 rows x 64 columns
constexpr uint32_t kRawBytes = kChunk * kDim;     // one int8 chunk, one TMA box
constexpr int kMaxGrid = 65535;

// The rings and the register split of each corpus storage type.
template <typename S>
struct Ring;
template <>
struct Ring<bf16> {  // TMA writes the chunks straight into the bf16 ring
  static constexpr int kStages = 6, kRawStages = 0, kProducerRegs = 40, kConsumerRegs = 232;
  static constexpr uint32_t kFullCount = 1;  // the TMA thread's expect_tx
};
template <>
struct Ring<int8_t> {  // TMA fills the raw ring; the producer warpgroup widens
  static constexpr int kStages = 6, kRawStages = 2, kProducerRegs = 56, kConsumerRegs = 224;
  static constexpr uint32_t kFullCount = 128;  // every producer thread, after its stores
};
template <typename S>
constexpr size_t smem_bytes() {
  return Ring<S>::kStages * kChunkBytes + Ring<S>::kRawStages * kRawBytes + 1024 +
         16 * (Ring<S>::kStages + Ring<S>::kRawStages);
}
static_assert(smem_bytes<bf16>() <= 232448 && smem_bytes<int8_t>() <= 232448,
              "a block may take 227 KB of shared memory");

// The B descriptor of k-step ks (columns 16 ks ..) of a chunk as TMA lays it
// out with the 128-byte swizzle: two boxes of 64 columns, each 128 rows of
// 128 bytes in 8-row atoms of 1024 bytes (the stride between 8-row groups);
// a k-step of 16 columns starts 32 bytes further into the atom.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t stage, int ks) {
  return attn::make_desc(stage + (ks / 4) * kHalfBytes + (ks % 4) * 32, 16, 1024) | (1ull << 62);
}

// d[64 x 128] (+)= a[64 x 16] b[16 x 128]: a in registers (the accumulator
// layout of a 64 x 16 tile, packed bf16 pairs), b K-major in shared memory.
__device__ __forceinline__ void wgmma_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d[64 x 128] (+)= a[64 x 16] b[16 x 128], a and b K-major in shared memory
// (the wide form streams the queries beside the corpus).
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// ---------------------------------------------------------------------------
// Widening an int8 chunk into the bf16 ring (the producer warpgroup)
// ---------------------------------------------------------------------------

// Two codes, bytes `sel` of w, as a bf16x2 pair: the permute gives each
// code's byte b a high byte 0x43; (b & 0x7F | 0x4300) is 128 + (b & 127) and
// (b & 0x80 | 0x4300) is 128 or 256, and their bf16 difference is b, exact.
__device__ __forceinline__ uint32_t widen_pair(uint32_t w, uint32_t sel) {
  const uint32_t p = __byte_perm(w, 0x43434343u, sel);
  uint32_t d;
  asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(p & 0xFF7FFF7Fu), "r"(p & 0xFF80FF80u));
  return d;
}

// Producer thread p's share of each chunk: in pass i (0..7), rows 16 i + 2
// (p / 16) + (e >= 4), e = p % 8, and its 16 codes in 16-byte unit v = e % 4
// + 4 ((e >= 4) ^ (p / 8) % 2) of the row. A quarter warp so reads half of
// one row and the other half of the next, whose swizzle phases differ in
// the lowest bit, so its reads from the raw stage and its two stores into
// the bf16 stage each hit 8 distinct 16-byte bank groups (the layout is
// mirrored in tests/test_torch_bmax_fragments.py).
struct WidenShare {
  uint32_t src;     // byte of the raw stage read in pass 0 (pass i: + 2048 i)
  uint32_t dst_lo;  // byte of the bf16 stage that takes codes 0-7 (+ 2048 i)
  uint32_t dst_hi;  // and codes 8-15
};
__device__ __forceinline__ WidenShare widen_share(int p) {
  const int e = p % 8, second = e >= 4;
  const int row = 2 * (p / 16) + second;           // of pass 0
  const int v = e % 4 + 4 * (second ^ ((p / 8) % 2));
  const int sw = row % 8;                          // the row's swizzle phase, every pass
  // raw stage: TMA's 128-byte swizzle of 128-byte rows
  const uint32_t src = row * 128 + ((v ^ sw) * 16);
  // bf16 stage: column 16 v lies in half v / 4, 16-byte units 2 (v % 4) and
  // the next; row `row` of pass i lies in 8-row atom 2 i + row / 8
  const uint32_t base = (v / 4) * kHalfBytes + (row / 8) * 1024 + sw * 128;
  return {src, base + (((2 * (v % 4)) ^ sw) * 16), base + (((2 * (v % 4) + 1) ^ sw) * 16)};
}

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}
__device__ __forceinline__ void sts128(uint32_t addr, uint32_t a, uint32_t b, uint32_t c,
                                       uint32_t d) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(a), "r"(b), "r"(c),
               "r"(d)
               : "memory");
}

// One producer thread's share of an int8 chunk at raw stage `raw`, widened
// into the bf16 stage `wide`: four passes' loads are issued together, so
// their latency is paid twice a chunk.
__device__ __forceinline__ void widen_chunk(uint32_t raw, uint32_t wide, const WidenShare& sh) {
#pragma unroll
  for (int i0 = 0; i0 < 8; i0 += 4) {
    uint4 x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = lds128(raw + sh.src + 2048 * (i0 + i));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t at = wide + 2048 * (i0 + i);
      sts128(at + sh.dst_lo, widen_pair(x[i].x, 0x4140), widen_pair(x[i].x, 0x4342),
             widen_pair(x[i].y, 0x4140), widen_pair(x[i].y, 0x4342));
      sts128(at + sh.dst_hi, widen_pair(x[i].z, 0x4140), widen_pair(x[i].z, 0x4342),
             widen_pair(x[i].w, 0x4140), widen_pair(x[i].w, 0x4342));
    }
  }
}

// ---------------------------------------------------------------------------
// Block maxima on the accumulators, and their epilogues
// ---------------------------------------------------------------------------

template <int N>
__device__ __forceinline__ void load_run(const float* __restrict__ p, float (&u)[N]) {
  if constexpr (N == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    u[0] = v.x, u[1] = v.y, u[2] = v.z, u[3] = v.w;
  } else if constexpr (N == 2) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(p));
    u[0] = v.x, u[1] = v.y;
  } else {
    u[0] = __ldg(p);
  }
}

// The epilogues, each over a lane's run of N consecutive blocks: `load`
// fetches what it needs for the run that starts at block b (of the whole
// corpus), `apply` turns the run's raw maxima into the values stored.
template <int N>
struct RawMaxima {  // K1
  __device__ __forceinline__ void load(const float*, const float*, int) {}
  __device__ __forceinline__ void apply(float (&)[N]) const {}
};
template <int N>
struct BlockScales {  // K5: scale_a [NB]
  float s[N];
  __device__ __forceinline__ void load(const float* a, const float*, int b) { load_run(a + b, s); }
  __device__ __forceinline__ void apply(float (&u)[N]) const {
#pragma unroll
    for (int k = 0; k < N; ++k) u[k] *= s[k];
  }
};
template <int N>
struct RowBounds {  // K7: smax = scale_a, smin = scale_b [NB]
  float hi[N], lo[N];
  __device__ __forceinline__ void load(const float* a, const float* b_, int b) {
    load_run(a + b, hi);
    load_run(b_ + b, lo);
  }
  __device__ __forceinline__ void apply(float (&u)[N]) const {
#pragma unroll
    for (int k = 0; k < N; ++k) u[k] = u[k] >= 0.0f ? u[k] * hi[k] : u[k] * lo[k];
  }
};

template <int BLOCK>
struct Blocks {
  static constexpr int kPerChunk = BLOCK >= kChunk ? 1 : kChunk / BLOCK;  // blocks a chunk
  static constexpr int kSpan = BLOCK > kChunk ? BLOCK / kChunk : 1;       // chunks a block
  static constexpr int kValues = 2 * kPerChunk;  // (row, block) maxima a thread folds
  static constexpr int kRun = kValues >= 4 ? kValues / 4 : 1;  // blocks a lane finishes
  // the first block of lane `lane`'s run in chunk c of its group
  static __device__ __forceinline__ int first(int c, int lane) {
    return c / kSpan * kPerChunk + (kValues >= 4 ? (lane >> 1) * kRun : 0);
  }
};

// The two output layouts, a template argument of the kernel and so part of
// its name. Grouped: bmax3 [CG, Q, G] and gmax [CG, 1, Q] (K1, K5, K7); a
// lane's run of blocks is one vector store. BlockMajor: bmax [NB, Q] with no
// group level (K8); block b of a lane's query lies num_q floats after block
// b - 1, so a lane's run is num_q-strided scalar stores (16 lanes of a warp
// store 16 consecutive queries of one block side by side).
struct Grouped {
  static constexpr bool kBlockMajor = false;
};
struct BlockMajor {
  static constexpr bool kBlockMajor = true;
};

// Block-major, a lane's finished run u of N blocks, the first b blocks
// after `out` (its query's column of bmax at the group's first block).
template <int N>
__device__ __forceinline__ void store_strided(float* out, int b, const float (&u)[N],
                                              int num_q) {
#pragma unroll
  for (int k = 0; k < N; ++k) out[(size_t)(b + k) * num_q] = u[k];
}

// The block maxima of chunk c (of its group) from the accumulators d of a
// 64-query x 128-row score tile. Lane `lane` of its quad ends with query
// row frag_row + 8 (lane & 1) and the run of blocks Blocks::first(c, lane);
// the epilogue `ep` turns their maxima into the values that go to `out`
// (the query's row of bmax3 for its group, or for BlockMajor its column of
// bmax at the group's first block; null past the last query) and into `gm`.
// `part` carries a 256-row block's maxima from its first chunk to its
// second.
template <int BLOCK, typename L, typename E>
__device__ __forceinline__ void take_maxima(const float (&d)[64], int c, float* out, int num_q,
                                            int lane, float (&part)[Blocks<BLOCK>::kValues],
                                            float& gm, const E& ep) {
  constexpr int kNb = Blocks<BLOCK>::kPerChunk, kK = Blocks<BLOCK>::kValues;
  constexpr int kSpan = Blocks<BLOCK>::kSpan, kJ = 16 / kNb;  // 8-column groups a block
  // v[h * kNb + b]: this thread's maximum of block b in its row h; its
  // columns of 8-column group j are d[4 j + 2 h] and d[4 j + 2 h + 1]
  float v[kK];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int b = 0; b < kNb; ++b) {
      float m = fmaxf(d[4 * b * kJ + 2 * h], d[4 * b * kJ + 2 * h + 1]);
#pragma unroll
      for (int j = b * kJ + 1; j < (b + 1) * kJ; ++j)
        m = fmaxf(m, fmaxf(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]));
      v[h * kNb + b] = m;
    }
  if constexpr (kSpan > 1) {
    const int step = c % kSpan;
#pragma unroll
    for (int i = 0; i < kK; ++i) part[i] = step == 0 ? v[i] : fmaxf(part[i], v[i]);
    if (step != kSpan - 1) return;
#pragma unroll
    for (int i = 0; i < kK; ++i) v[i] = part[i];
  }
  // after the first exchange a lane holds row h = lane & 1, every block
  float w[kK / 2];
  exchange_halves<kK>(v, w, lane & 1, 1);
  if constexpr (kK >= 4) {
    // after the second, blocks (lane >> 1) * kK / 4 + k of that row
    float u[kK / 4];
    exchange_halves<kK / 2>(w, u, lane >> 1, 2);
    ep.apply(u);
#pragma unroll
    for (int k = 0; k < kK / 4; ++k) gm = fmaxf(gm, u[k]);
    if constexpr (L::kBlockMajor) {
      if (out != nullptr) store_strided(out, c * kNb + (lane >> 1) * (kK / 4), u, num_q);
    } else {
      if (out != nullptr) store_run<kK / 4>(out + c * kNb + (lane >> 1) * (kK / 4), u);
    }
  } else {
    float u[1] = {fmaxf(w[0], __shfl_xor_sync(0xffffffffu, w[0], 2))};
    ep.apply(u);
    gm = fmaxf(gm, u[0]);
    if constexpr (L::kBlockMajor) {
      if (out != nullptr && (lane >> 1) == 0) store_strided(out, c / kSpan, u, num_q);
    } else {
      if (out != nullptr && (lane >> 1) == 0) out[c / kSpan] = u[0];
    }
  }
}

// The consumer warpgroups and the producer's. With two consumers, 384
// threads start with 168 registers each; the producer gives most of its own
// back (setmaxnreg) so that a consumer thread can hold two accumulator sets
// and its queries' fragments (~190 registers) without spilling.
template <int NWG>
constexpr int kThreads = (NWG + 1) * 128;

// Grid (query tiles of 64 NWG, gy); block (x, y) scores its query tile
// against groups y, y + gy, ... < num_groups, whose `group` blocks of BLOCK
// rows each are contiguous corpus rows of storage type S (bf16, or int8
// codes). Warpgroups 0 .. NWG - 1 multiply, take maxima, apply the epilogue
// E and store in layout L (gmax is not read for BlockMajor); the last
// warpgroup feeds the ring: its first thread by TMA, and for int8 all its
// threads widen the raw chunks.
template <int BLOCK, int NWG, typename S, template <int> class E, typename L>
__global__ void __launch_bounds__(kThreads<NWG>, 1)
bmax_wgmma_kernel(const __grid_constant__ CUtensorMap corpus, const bf16* __restrict__ queries,
                  const float* __restrict__ scale_a, const float* __restrict__ scale_b,
                  float* __restrict__ bmax, float* __restrict__ gmax, int num_q, int group,
                  int num_groups) {
  using R = Ring<S>;
  constexpr int kStages = R::kStages, kRawStages = R::kRawStages;
  extern __shared__ __align__(1024) unsigned char smem[];
  // the swizzled boxes want 1024-byte alignment: the bf16 ring, the raw
  // ring, then a full and an empty barrier for each stage of each
  const uint32_t ring = (attn::smem_addr(smem) + 1023) & ~1023u;
  const uint32_t raw = ring + kStages * kChunkBytes;
  const uint32_t full = raw + kRawStages * kRawBytes, empty = full + 8 * kStages;
  const uint32_t raw_full = empty + 8 * kStages, raw_empty = raw_full + 8 * kRawStages;
  const int tid = threadIdx.x, t = tid % 128, lane = t % 4;
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full + 8 * i, R::kFullCount);
      mbar_init(empty + 8 * i, NWG * 128);
    }
    for (int i = 0; i < kRawStages; ++i) {
      mbar_init(raw_full + 8 * i, 1);
      mbar_init(raw_empty + 8 * i, 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int per_group = group * BLOCK / kChunk;  // chunks a group
  const int total = (num_groups - 1 - (int)blockIdx.y) / (int)gridDim.y * per_group + per_group;
  // chunk s of this block: chunk s % per_group of group y + (s / per_group) gy
  auto group_of = [&](int s) { return (int)blockIdx.y + s / per_group * (int)gridDim.y; };
  auto row_of = [&](int s) { return (group_of(s) * per_group + s % per_group) * kChunk; };

  if (tid >= NWG * 128) {  // the producer: stage s % kStages, once its last reader is done
    if constexpr (NWG == 2) set_max_registers<false, R::kProducerRegs>();
    if constexpr (sizeof(S) == 2) {
      if (tid == NWG * 128) {
        for (int s = 0; s < total; ++s) {
          const int stage = s % kStages;
          mbar_wait(empty + 8 * stage, ((s / kStages) & 1) ^ 1);
          mbar_expect_tx(full + 8 * stage, kChunkBytes);
          const int row = row_of(s);
          const uint32_t dst = ring + stage * kChunkBytes;
          tma_load(dst, &corpus, 0, row, full + 8 * stage);
          tma_load(dst + kHalfBytes, &corpus, 64, row, full + 8 * stage);
        }
      }
    } else {
      // the first thread copies chunk s into raw stage s % kRawStages once
      // the stage's last reader is done; every thread widens it into bf16
      // stage s % kStages once that stage's last reader is done
      const bool copier = tid == NWG * 128;
      auto copy = [&](int s) {
        const int stage = s % kRawStages;
        mbar_expect_tx(raw_full + 8 * stage, kRawBytes);
        tma_load(raw + stage * kRawBytes, &corpus, 0, row_of(s), raw_full + 8 * stage);
      };
      if (copier)
        for (int s = 0; s < kRawStages && s < total; ++s) copy(s);
      const WidenShare share = widen_share(t);
      for (int s = 0; s < total; ++s) {
        const int rs = s % kRawStages, stage = s % kStages;
        mbar_wait(raw_full + 8 * rs, (s / kRawStages) & 1);
        mbar_wait(empty + 8 * stage, ((s / kStages) & 1) ^ 1);
        widen_chunk(raw + rs * kRawBytes, ring + stage * kChunkBytes, share);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(full + 8 * stage);
        mbar_arrive(raw_empty + 8 * rs);
        if (copier && s + kRawStages < total) {
          mbar_wait(raw_empty + 8 * rs, (s / kRawStages) & 1);
          copy(s + kRawStages);
        }
      }
    }
    return;
  }

  if constexpr (NWG == 2) set_max_registers<true, R::kConsumerRegs>();
  // this warpgroup's 64 queries as wgmma A fragments, k-step ks in a[ks]:
  // register r holds row frag_row + 8 (r % 2), columns 16 ks + 8 (r / 2) +
  // 2 (t % 4) and the next (zero past the last query)
  const int row0 = (int)blockIdx.x * 64 * NWG + tid / 128 * 64 + attn::frag_row(t);
  uint32_t a[8][4];
#pragma unroll
  for (int ks = 0; ks < 8; ++ks)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = row0 + 8 * (r % 2), col = 16 * ks + 8 * (r / 2) + 2 * lane;
      a[ks][r] = row < num_q
                     ? *reinterpret_cast<const uint32_t*>(queries + (size_t)row * kDim + col)
                     : 0u;
    }
  const int my_q = row0 + 8 * (lane & 1);  // the query row whose maxima this lane stores
  const bool q_valid = my_q < num_q;

  using Ep = E<Blocks<BLOCK>::kRun>;
  float part[Blocks<BLOCK>::kValues];
  float gm = -INFINITY;
  // the epilogue's operands of chunk s, loaded before the products it
  // applies to are waited for
  auto operands = [&](int s) {
    Ep ep;
    ep.load(scale_a, scale_b, group_of(s) * group + Blocks<BLOCK>::first(s % per_group, lane));
    return ep;
  };
  auto epilogue = [&](const float (&d)[64], int s, const Ep& ep) {
    const int c = s % per_group;
    if constexpr (L::kBlockMajor) {
      const size_t col = (size_t)group_of(s) * group * num_q + my_q;
      take_maxima<BLOCK, L>(d, c, q_valid ? bmax + col : nullptr, num_q, lane, part, gm, ep);
    } else {
      const size_t row = (size_t)group_of(s) * num_q + my_q;
      take_maxima<BLOCK, L>(d, c, q_valid ? bmax + row * group : nullptr, num_q, lane, part, gm,
                            ep);
      if (c == per_group - 1) {
        gm = fmaxf(gm, __shfl_xor_sync(0xffffffffu, gm, 2));
        if (q_valid && (lane >> 1) == 0) gmax[row] = gm;
        gm = -INFINITY;
      }
    }
  };
  // chunk s's products into `acc` once its stage is full; issued, not
  // waited for
  auto issue = [&](float (&acc)[64], int s) {
    const int stage = s % kStages;
    mbar_wait(full + 8 * stage, (s / kStages) & 1);
    attn::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 8; ++ks)
      wgmma_n128(acc, a[ks], desc_sw128(ring + stage * kChunkBytes, ks), ks);
    attn::wgmma_commit();
  };
  // chunk s's maxima from `prev` once all but the last issued products are
  // done; its stage goes back to the producer
  auto take = [&](float (&prev)[64], int s, const Ep& ep) {
    attn::wgmma_wait<1>();
    attn::fence_regs(prev);
    mbar_arrive(empty + 8 * (s % kStages));
    epilogue(prev, s, ep);
  };

  // Chunk s + 1's products run while chunk s's maxima are taken. The loop
  // body has no branch around a product or a take, so at its back edge the
  // products in flight are always acc0's (ptxas serialises wgmma when it
  // cannot tell which accumulators are in flight).
  float acc0[64], acc1[64];
  issue(acc0, 0);
  int s = 1;
  for (; s + 1 < total; s += 2) {
    const Ep ep0 = operands(s - 1);
    issue(acc1, s);
    take(acc0, s - 1, ep0);
    const Ep ep1 = operands(s);
    issue(acc0, s + 1);
    take(acc1, s, ep1);
  }
  if (s < total) {
    const Ep ep0 = operands(s - 1);
    issue(acc1, s);
    take(acc0, s - 1, ep0);
    const Ep ep1 = operands(s);
    attn::wgmma_wait<0>();
    attn::fence_regs(acc1);
    epilogue(acc1, s, ep1);
  } else {
    const Ep ep0 = operands(s - 1);
    attn::wgmma_wait<0>();
    attn::fence_regs(acc0);
    epilogue(acc0, s - 1, ep0);
  }
}

// ---------------------------------------------------------------------------
// Every other width: the K loop (bmax_wgmma_wide_kernel)
// ---------------------------------------------------------------------------

constexpr int kSlice = 128;  // columns of D a step of the wide form carries

// The wide form's ring. A step is one 128-column slice of one chunk: its
// stage holds the corpus part (128 rows x 128 columns as two boxes of 64
// columns, a D = 128 chunk's layout: desc_sw128) and then the queries' part
// (64 NWG rows x 128 columns as two boxes of 64: desc_query). int8 keeps
// K5's raw ring of two stages beside it.
template <typename S, int NWG>
struct WideRing {
  static constexpr uint32_t kQueryHalf = 64 * NWG * 128;  // one query box
  static constexpr uint32_t kStageBytes = kChunkBytes + 2 * kQueryHalf;
  static constexpr int kRawStages = sizeof(S) == 1 ? 2 : 0;
  static constexpr int kStages =
      (232448 - 1024 - 16 * 4 - kRawStages * (int)kRawBytes) / (int)kStageBytes;
  static constexpr size_t kSmem =
      kStages * kStageBytes + kRawStages * kRawBytes + 1024 + 16 * (kStages + kRawStages);
  // bf16: the TMA thread's expect_tx; int8: every producer thread after its
  // stores, and the TMA thread's expect_tx for the queries' part
  static constexpr uint32_t kFullCount = sizeof(S) == 1 ? 129 : 1;
  static_assert(kStages >= 3 && kSmem <= 232448, "a block may take 227 KB of shared memory");
};

// The A descriptor of warpgroup wg's 64 queries at k-step ks of a wide stage
// (the 128-byte swizzle of the corpus part; 64 rows are 8 atoms of 1024 bytes).
template <int NWG>
__device__ __forceinline__ uint64_t desc_query(uint32_t stage, int wg, int ks) {
  return attn::make_desc(stage + kChunkBytes + (ks / 4) * (64 * NWG * 128) + wg * 8192 +
                             (ks % 4) * 32,
                         16, 1024) |
         (1ull << 62);
}

// bmax_wgmma_kernel at any width D (a multiple of 16), each chunk's products
// summed over ceil(D / 128) steps. The queries no longer fit in registers
// (D / 4 a thread) nor whole in shared memory beside a ring (128 x 768 x 2
// bytes is 192 KB), so each step's stage carries the queries' slice beside
// the corpus's and wgmma reads both from shared memory. Columns past D
// arrive zero-filled by TMA, so every step runs its 8 k-steps: the zeros add
// nothing (a width that is not a multiple of 128 pays for the rest of its
// last slice). A chunk's accumulators persist across its steps; while chunk
// c's first step runs, chunk c - 1's maxima are taken (two accumulator sets,
// as at D = 128); a step's stage goes back to the producer once the next
// step is issued and all products but that step's are done. The epilogues,
// the output layouts and the walk are bmax_wgmma_kernel's.
template <int BLOCK, int NWG, typename S, template <int> class E, typename L>
__global__ void __launch_bounds__(kThreads<NWG>, 1)
bmax_wgmma_wide_kernel(const __grid_constant__ CUtensorMap corpus,
                       const __grid_constant__ CUtensorMap queries,
                       const float* __restrict__ scale_a, const float* __restrict__ scale_b,
                       float* __restrict__ bmax, float* __restrict__ gmax, int num_q, int group,
                       int num_groups, int slices) {
  using W = WideRing<S, NWG>;
  using R = Ring<S>;
  constexpr int kStages = W::kStages, kRawStages = W::kRawStages;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t ring = (attn::smem_addr(smem) + 1023) & ~1023u;
  const uint32_t raw = ring + kStages * W::kStageBytes;
  const uint32_t full = raw + kRawStages * kRawBytes, empty = full + 8 * kStages;
  const uint32_t raw_full = empty + 8 * kStages, raw_empty = raw_full + 8 * kRawStages;
  const int tid = threadIdx.x, t = tid % 128, lane = t % 4;
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full + 8 * i, W::kFullCount);
      mbar_init(empty + 8 * i, NWG * 128);
    }
    for (int i = 0; i < kRawStages; ++i) {
      mbar_init(raw_full + 8 * i, 1);
      mbar_init(raw_empty + 8 * i, 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int per_group = group * BLOCK / kChunk;  // chunks a group
  const int total = (num_groups - 1 - (int)blockIdx.y) / (int)gridDim.y * per_group + per_group;
  const int steps = total * slices;  // step g: slice g % slices of chunk g / slices
  auto group_of = [&](int s) { return (int)blockIdx.y + s / per_group * (int)gridDim.y; };
  auto row_of = [&](int s) { return (group_of(s) * per_group + s % per_group) * kChunk; };
  const int q0 = (int)blockIdx.x * 64 * NWG;

  if (tid >= NWG * 128) {  // the producer
    if constexpr (NWG == 2) set_max_registers<false, R::kProducerRegs>();
    // the queries' part of step g's stage at dst
    auto copy_queries = [&](uint32_t dst, int g, uint32_t bar) {
      const int col = g % slices * kSlice;
      tma_load(dst + kChunkBytes, &queries, col, q0, bar);
      tma_load(dst + kChunkBytes + W::kQueryHalf, &queries, col + 64, q0, bar);
    };
    if constexpr (sizeof(S) == 2) {
      if (tid == NWG * 128) {
        for (int g = 0; g < steps; ++g) {
          const int stage = g % kStages, col = g % slices * kSlice, row = row_of(g / slices);
          mbar_wait(empty + 8 * stage, ((g / kStages) & 1) ^ 1);
          mbar_expect_tx(full + 8 * stage, W::kStageBytes);
          const uint32_t dst = ring + stage * W::kStageBytes;
          tma_load(dst, &corpus, col, row, full + 8 * stage);
          tma_load(dst + kHalfBytes, &corpus, col + 64, row, full + 8 * stage);
          copy_queries(dst, g, full + 8 * stage);
        }
      }
    } else {
      // bmax_wgmma_kernel's int8 producer, step by step: a raw box is one
      // slice's 128 codes of 128 rows; the TMA thread also copies the
      // queries' part once the stage is free
      const bool copier = tid == NWG * 128;
      auto copy = [&](int g) {
        const int stage = g % kRawStages;
        mbar_expect_tx(raw_full + 8 * stage, kRawBytes);
        tma_load(raw + stage * kRawBytes, &corpus, g % slices * kSlice, row_of(g / slices),
                 raw_full + 8 * stage);
      };
      if (copier)
        for (int g = 0; g < kRawStages && g < steps; ++g) copy(g);
      const WidenShare share = widen_share(t);
      for (int g = 0; g < steps; ++g) {
        const int rs = g % kRawStages, stage = g % kStages;
        const uint32_t dst = ring + stage * W::kStageBytes;
        mbar_wait(raw_full + 8 * rs, (g / kRawStages) & 1);
        mbar_wait(empty + 8 * stage, ((g / kStages) & 1) ^ 1);
        if (copier) {
          mbar_expect_tx(full + 8 * stage, 2 * W::kQueryHalf);
          copy_queries(dst, g, full + 8 * stage);
        }
        widen_chunk(raw + rs * kRawBytes, dst, share);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(full + 8 * stage);
        mbar_arrive(raw_empty + 8 * rs);
        if (copier && g + kRawStages < steps) {
          mbar_wait(raw_empty + 8 * rs, (g / kRawStages) & 1);
          copy(g + kRawStages);
        }
      }
    }
    return;
  }

  if constexpr (NWG == 2) set_max_registers<true, R::kConsumerRegs>();
  const int wg = tid / 128;
  const int row0 = q0 + wg * 64 + attn::frag_row(t);
  const int my_q = row0 + 8 * (lane & 1);  // the query row whose maxima this lane stores
  const bool q_valid = my_q < num_q;

  using Ep = E<Blocks<BLOCK>::kRun>;
  float part[Blocks<BLOCK>::kValues];
  float gm = -INFINITY;
  auto operands = [&](int s) {
    Ep ep;
    ep.load(scale_a, scale_b, group_of(s) * group + Blocks<BLOCK>::first(s % per_group, lane));
    return ep;
  };
  auto epilogue = [&](const float (&d)[64], int s, const Ep& ep) {
    const int c = s % per_group;
    if constexpr (L::kBlockMajor) {
      const size_t col = (size_t)group_of(s) * group * num_q + my_q;
      take_maxima<BLOCK, L>(d, c, q_valid ? bmax + col : nullptr, num_q, lane, part, gm, ep);
    } else {
      const size_t row = (size_t)group_of(s) * num_q + my_q;
      take_maxima<BLOCK, L>(d, c, q_valid ? bmax + row * group : nullptr, num_q, lane, part, gm,
                            ep);
      if (c == per_group - 1) {
        gm = fmaxf(gm, __shfl_xor_sync(0xffffffffu, gm, 2));
        if (q_valid && (lane >> 1) == 0) gmax[row] = gm;
        gm = -INFINITY;
      }
    }
  };
  // step g's products into acc once its stage is full (a chunk's first step
  // overwrites acc); issued, not waited for
  auto issue = [&](float (&acc)[64], int g) {
    const int stage = g % kStages;
    const uint32_t st = ring + stage * W::kStageBytes;
    mbar_wait(full + 8 * stage, (g / kStages) & 1);
    attn::wgmma_fence();
    const int fresh = g % slices == 0;
#pragma unroll
    for (int ks = 0; ks < 8; ++ks)
      wgmma_ss_n128(acc, desc_query<NWG>(st, wg, ks), desc_sw128(st, ks), !(fresh && ks == 0));
    attn::wgmma_commit();
  };
  // all but the last issued products are done: step g - 1's stage goes back
  auto retire = [&](int g) {
    attn::wgmma_wait<1>();
    mbar_arrive(empty + 8 * ((g - 1) % kStages));
  };
  // chunk s (>= 1) into acc; chunk s - 1's maxima from prev once its last
  // step is done, while chunk s's first step runs
  auto chunk = [&](float (&acc)[64], float (&prev)[64], int s) {
    const Ep ep = operands(s - 1);
    const int g = s * slices;
    issue(acc, g);
    retire(g);
    attn::fence_regs(prev);
    epilogue(prev, s - 1, ep);
    for (int j = 1; j < slices; ++j) {
      issue(acc, g + j);
      retire(g + j);
    }
  };
  // the last chunk s, in acc
  auto finish = [&](float (&acc)[64], int s) {
    const Ep ep = operands(s);
    attn::wgmma_wait<0>();
    attn::fence_regs(acc);
    mbar_arrive(empty + 8 * ((steps - 1) % kStages));
    epilogue(acc, s, ep);
  };

  float acc0[64], acc1[64];
  issue(acc0, 0);
  for (int j = 1; j < slices; ++j) {
    issue(acc0, j);
    retire(j);
  }
  int s = 1;
  for (; s + 1 < total; s += 2) {
    chunk(acc1, acc0, s);
    chunk(acc0, acc1, s + 1);
  }
  if (s < total) {
    chunk(acc1, acc0, s);
    finish(acc1, s);
  } else {
    finish(acc0, s - 1);
  }
}

struct Args {
  const void *queries, *corpus, *scale_a, *scale_b;
  void *bmax, *gmax;
  int num_q, n, dim, group, num_groups;
  cudaStream_t stream;
};

template <int BLOCK, int NWG, typename S, template <int> class E, typename L>
cudaError_t launch(const Args& x) {
  constexpr size_t smem = smem_bytes<S>();
  auto kernel = bmax_wgmma_kernel<BLOCK, NWG, S, E, L>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  CUtensorMap map;
  err = sizeof(S) == 1 ? corpus_map(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, x.corpus, x.n)
                       : corpus_map(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x.corpus, x.n);
  if (err != cudaSuccess) return err;
  int sms = 0;
  if ((err = multiprocessors(&sms)) != cudaSuccess) return err;
  const int tiles = (x.num_q + 64 * NWG - 1) / (64 * NWG);
  int gy = sms / tiles;
  gy = gy < 1 ? 1 : (gy > x.num_groups ? x.num_groups : gy);
  kernel<<<dim3(tiles, gy), kThreads<NWG>, smem, x.stream>>>(
      map, static_cast<const bf16*>(x.queries), static_cast<const float*>(x.scale_a),
      static_cast<const float*>(x.scale_b), static_cast<float*>(x.bmax),
      static_cast<float*>(x.gmax), x.num_q, x.group, x.num_groups);
  return cudaGetLastError();
}

template <int BLOCK, int NWG, typename S, template <int> class E, typename L>
cudaError_t launch_wide(const Args& x) {
  using W = WideRing<S, NWG>;
  auto kernel = bmax_wgmma_wide_kernel<BLOCK, NWG, S, E, L>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)W::kSmem);
  if (err != cudaSuccess) return err;
  CUtensorMap cmap, qmap;
  err = sizeof(S) == 1
            ? tile_map(&cmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, x.corpus, x.dim, x.n, 128, kChunk)
            : tile_map(&cmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x.corpus, x.dim, x.n, 64,
                       kChunk);
  if (err != cudaSuccess) return err;
  err = tile_map(&qmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x.queries, x.dim, x.num_q, 64,
                 64 * NWG);
  if (err != cudaSuccess) return err;
  int sms = 0;
  if ((err = multiprocessors(&sms)) != cudaSuccess) return err;
  const int tiles = (x.num_q + 64 * NWG - 1) / (64 * NWG);
  int gy = sms / tiles;
  gy = gy < 1 ? 1 : (gy > x.num_groups ? x.num_groups : gy);
  kernel<<<dim3(tiles, gy), kThreads<NWG>, W::kSmem, x.stream>>>(
      cmap, qmap, static_cast<const float*>(x.scale_a), static_cast<const float*>(x.scale_b),
      static_cast<float*>(x.bmax), static_cast<float*>(x.gmax), x.num_q, x.group, x.num_groups,
      (x.dim + kSlice - 1) / kSlice);
  return cudaGetLastError();
}

// D = 128: bmax_wgmma_kernel (the queries' fragments in registers); any
// other width: bmax_wgmma_wide_kernel
template <int BLOCK, int NWG, typename S, template <int> class E, typename L>
cudaError_t launch_dim(const Args& x) {
  return x.dim == kDim ? launch<BLOCK, NWG, S, E, L>(x) : launch_wide<BLOCK, NWG, S, E, L>(x);
}

template <typename S, template <int> class E, typename L = Grouped>
cudaError_t launch_block(int block, const Args& x) {
  const bool two = x.num_q > 64;  // two consumer warpgroups
  switch (block) {
    case 16: return two ? launch_dim<16, 2, S, E, L>(x) : launch_dim<16, 1, S, E, L>(x);
    case 32: return two ? launch_dim<32, 2, S, E, L>(x) : launch_dim<32, 1, S, E, L>(x);
    case 64: return two ? launch_dim<64, 2, S, E, L>(x) : launch_dim<64, 1, S, E, L>(x);
    case 128: return two ? launch_dim<128, 2, S, E, L>(x) : launch_dim<128, 1, S, E, L>(x);
    case 256: return two ? launch_dim<256, 2, S, E, L>(x) : launch_dim<256, 1, S, E, L>(x);
    default: return cudaErrorInvalidValue;
  }
}

// n a multiple of block; the last group may be partial: its rows past n
// arrive as zeros (TMA's fill), so they score 0, as zero padding rows would,
// and its blocks past n are stored like any other
bool valid_shape(int num_q, int n, int dim, int block, int group) {
  return dim > 0 && dim % kDimMultiple == 0 && num_q > 0 && n > 0 && block > 0 && group > 0 &&
         (group * block) % kChunk == 0 && n % block == 0 &&
         (n + group * block - 1) / (group * block) <= kMaxGrid;
}

int num_groups(int n, int block, int group) { return (n + group * block - 1) / (group * block); }

}  // namespace

// queries [num_q, dim] and corpus [n, dim] bf16, row-major and 16-byte
// aligned, dim a multiple of 16; bmax [CG, num_q, group] and gmax
// [CG, 1, num_q] f32, CG = ceil(n / (group * block)). block in {16, 32, 64,
// 128, 256}, group * block a multiple of 128 (ops/mips_kernel.py:kernel_for),
// n a multiple of block. Returns a cudaError_t code.
extern "C" int proqa_block_maxima_wgmma(const void* queries, const void* corpus, void* bmax,
                                        void* gmax, int num_q, int n, int dim, int block,
                                        int group, void* stream) {
  if (!valid_shape(num_q, n, dim, block, group)) return cudaErrorInvalidValue;
  const Args x{queries, corpus, nullptr, nullptr, bmax, gmax, num_q, n, dim, group,
               num_groups(n, block, group), static_cast<cudaStream_t>(stream)};
  return launch_block<bf16, RawMaxima>(block, x);
}

// K8: as proqa_block_maxima_wgmma, the block maxima stored block-major,
// bmax [CG * group, num_q] f32, with no group level. group = tile_n / block,
// the blocks of one unit of the persistent walk.
extern "C" int proqa_block_maxima_wgmma_block_major(const void* queries, const void* corpus,
                                                    void* bmax, int num_q, int n, int dim,
                                                    int block, int group, void* stream) {
  if (!valid_shape(num_q, n, dim, block, group)) return cudaErrorInvalidValue;
  const Args x{queries, corpus, nullptr, nullptr, bmax, nullptr, num_q, n, dim, group,
               num_groups(n, block, group), static_cast<cudaStream_t>(stream)};
  return launch_block<bf16, RawMaxima, BlockMajor>(block, x);
}

// As proqa_block_maxima_wgmma over int8 codes [n, dim], with the epilogue
// of K5 (scale_a [CG * group] f32, scale_b null: each block maximum times its
// scale) or of K7 (scale_a = smax and scale_b = smin [CG * group] f32: the
// bound m >= 0 ? m * smax : m * smin); both 16-byte aligned.
extern "C" int proqa_block_maxima_wgmma_int8(const void* queries, const void* corpus,
                                             const void* scale_a, const void* scale_b,
                                             void* bmax, void* gmax, int num_q, int n, int dim,
                                             int block, int group, void* stream) {
  if (!valid_shape(num_q, n, dim, block, group) || scale_a == nullptr)
    return cudaErrorInvalidValue;
  const Args x{queries, corpus, scale_a, scale_b, bmax, gmax, num_q, n, dim, group,
               num_groups(n, block, group), static_cast<cudaStream_t>(stream)};
  return scale_b == nullptr ? launch_block<int8_t, BlockScales>(block, x)
                            : launch_block<int8_t, RowBounds>(block, x);
}
