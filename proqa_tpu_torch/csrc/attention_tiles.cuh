// Tile helpers shared by the attention kernels K2 (attention_fwd.cu, which
// replaces proqa_tpu/ops/pallas_attention.py:_fwd_kernel) and K3
// (attention_bwd.cu, which replaces _bwd_kernel).
//
// What bounds them on the H100: not bytes and not the tensor cores, but the
// per-score softmax work the reference's rounding points demand (exps, a
// correctly rounded division, the mask hash) and the latency of each
// streamed tile's round trip: copy, block barrier, wgmma, wait. The TPU
// kernels kept a whole (batch, head) in VMEM; here a tile of 64 rows per
// warpgroup is what registers and 227 KB of shared memory allow.
//
// bf16, the kernels the train step and the encoder run: a warpgroup (four
// warps, 128 threads) owns a 64-row tile of one (batch, head) slice and runs
// its products with Hopper's wgmma. Its resident operand tile (q and do in the
// row kernels, k and v in K3's column kernel) sits in shared memory for the
// whole block; the streamed operand tiles of 64 rows go through a ring of
// kStages buffers filled by cp.async while the warpgroup computes on an
// earlier one. Every tile is stored in wgmma's no-swizzle "core matrix"
// layout (8 rows of 16 bytes, 128 contiguous bytes), so one stored tile
// serves both as a K-major operand (the contraction runs along Dh: q k^T,
// do v^T) and as a transposed MN-major B operand (the contraction runs along
// the rows: p v, ds k, pd^T do, ds^T q). Scores, softmax, the dropout mask
// and the bf16 rounding stay in the accumulator registers: no f32 score row
// is ever stored.
//
// Head dims past 128 (bf16): K2 at Dh = 256 keeps this shape with tiles of
// 256 columns. K3 from 256 and K2 past it take the loop forms of
// attention_fwd.cu and attention_bwd.cu: the head dim is a multiple of
// kChunk, every operand streams in chunks of kChunk columns, the scores
// accumulate over the chunks in the wgmma accumulators, and a scores kernel
// writes the rounded p (or ds, ds^T, pd^T) as A fragments for a slice kernel
// (below) that sums their products a kChunk-wide output slice at a time.
//
// f32, reached only by the full-precision parity runs: the references pin f32
// products to full precision, which no tensor core offers, so f32 runs one
// simple body at every head dim (16 rows a block, f32 score rows in shared
// memory, plain FMA products over q, k and v read from device memory, the
// head dim a runtime argument) selected by dtype. It is not a fallback: a
// bf16 tensor never reaches it.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace attn {

using bf16 = __nv_bfloat16;

constexpr int kMaxSeq = 1024;
constexpr int kMaxGrid = 65535;
constexpr float kMaskBias = -1e30f;  // pallas_attention.py:32

// ---------------------------------------------------------------------------
// bf16 on Hopper: staged tiles and wgmma
// ---------------------------------------------------------------------------

constexpr int kTile = 64;          // rows of a warpgroup's tile and of a streamed tile
constexpr int kChunk = 128;        // columns of a streamed chunk in the loop forms
constexpr int kWarpgroup = 128;    // threads
// Stages of the ring of streamed tiles. Item t's tiles are copied into stage
// t % kStages during item t - 1, and K3's column kernel lets the products
// that read item t's stage run on into item t + 1: three stages keep the
// copies and those reads apart.
constexpr int kStages = 3;

// A [kTile][DH] bf16 tile in the no-swizzle core-matrix layout: element
// (row j, column d) at byte (j / 8) * kRowBlock + (d / 8) * 128 + (j % 8) * 16
// + (d % 8) * 2.
template <int DH>
struct Tile {
  static constexpr uint32_t kGroup = 128;          // between column groups of 8
  static constexpr uint32_t kRowBlock = 16 * DH;   // between row blocks of 8
  static constexpr uint32_t kBytes = kTile * DH * 2;
  // a wgmma product takes N = DH in one instruction up to n128 (two at 256),
  // and a descriptor's offsets are 14-bit counts of 16 bytes: kRowBlock at
  // DH = 256 is 4,096 bytes, 256 units
  static_assert(DH == 16 || DH == 32 || DH == 64 || DH == 128 || DH == 256,
                "head dims 16, 32, 64, 128, 256");
  static_assert(kRowBlock / 16 < (1u << 14), "descriptor offset out of range");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// cp.async writes shared memory through the generic proxy, wgmma reads it
// through the async proxy: this orders the two (before the block barrier).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Copies kTile rows of DH bf16 (src, row stride ld: DH for contiguous rows,
// the head dim for a chunk of wider rows) into a Tile at dst, by NT threads.
// Chunk c of 16 bytes lands at byte 16 * c of the tile, so the shared-memory
// writes are contiguous; consecutive threads read the same 16-byte column
// group of 8 consecutive rows.
template <int DH, int NT>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src, int tid, int ld = DH) {
  constexpr int kChunks = kTile * DH / 8, kGroups = DH / 8;
#pragma unroll
  for (int c = tid; c < kChunks; c += NT) {
    const int rest = c / 8, row = (rest / kGroups) * 8 + c % 8, group = rest % kGroups;
    cp_async16(dst + 16 * c, src + row * ld + group * 8);
  }
}

// Copies n contiguous f32 values (n % 4 == 0, 16-byte aligned) by NT threads.
template <int NT>
__device__ __forceinline__ void load_floats(uint32_t dst, const float* src, int n, int tid) {
  for (int c = tid; c < n / 4; c += NT) cp_async16(dst + 16 * c, src + 4 * c);
}

// The top of a pipeline item: this thread's copies for the item have landed
// and are ordered before wgmma's reads, and then every thread's have; every
// warpgroup has also waited for its products of the item before last, whose
// stage the next copies overwrite.
__device__ __forceinline__ void stage_ready() {
  cp_async_wait<0>();
  fence_async_smem();
  __syncthreads();
}

// wgmma shared-memory matrix descriptor, no swizzle: start address, leading
// byte offset (between core matrices along the contraction), stride byte
// offset (between core matrices along M or N), each in 16-byte units.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32);
}

// A Tile as a K-major operand, the contraction along DH; k-step `ks` covers
// columns 16 ks .. 16 ks + 15.
template <int DH>
__device__ __forceinline__ uint64_t desc_k_major(uint32_t tile, int ks) {
  return make_desc(tile + ks * 2 * Tile<DH>::kGroup, Tile<DH>::kGroup, Tile<DH>::kRowBlock);
}

// A Tile as a transposed (MN-major) B operand, the contraction along its
// rows; k-step `ks` covers rows 16 ks .. 16 ks + 15, N = DH.
template <int DH>
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t tile, int ks) {
  return make_desc(tile + ks * 2 * Tile<DH>::kRowBlock, Tile<DH>::kRowBlock, Tile<DH>::kGroup);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of accumulator registers
// across a wgmma wait (the hardware writes them asynchronously).
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 64] (+)= a[64 x 16] b[16 x 64], a and b K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[64 x 64] += a[64 x 16] b[16 x 64], a in registers, b MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[64 x 16] += a[64 x 16] b[16 x 16], a in registers, b MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[64 x 32] += a[64 x 16] b[16 x 32], a in registers, b MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[64 x 128] += a[64 x 16] b[16 x 128], a in registers, b MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[64 x 128] += a[64 x 16] b[16 x 128] into accumulators O .. O + 63 of a
// 64 x 256 tile's d[128] (its columns 128 (O / 64) .. + 127): a in registers,
// b MN-major in shared memory.
template <int O>
__device__ __forceinline__ void wgmma_rs_n128_at(float (&d)[128], const uint32_t (&a)[4],
                                                 uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[O + 0]), "+f"(d[O + 1]), "+f"(d[O + 2]), "+f"(d[O + 3]), "+f"(d[O + 4]),
        "+f"(d[O + 5]), "+f"(d[O + 6]), "+f"(d[O + 7]), "+f"(d[O + 8]), "+f"(d[O + 9]),
        "+f"(d[O + 10]), "+f"(d[O + 11]), "+f"(d[O + 12]), "+f"(d[O + 13]), "+f"(d[O + 14]),
        "+f"(d[O + 15]), "+f"(d[O + 16]), "+f"(d[O + 17]), "+f"(d[O + 18]), "+f"(d[O + 19]),
        "+f"(d[O + 20]), "+f"(d[O + 21]), "+f"(d[O + 22]), "+f"(d[O + 23]), "+f"(d[O + 24]),
        "+f"(d[O + 25]), "+f"(d[O + 26]), "+f"(d[O + 27]), "+f"(d[O + 28]), "+f"(d[O + 29]),
        "+f"(d[O + 30]), "+f"(d[O + 31]), "+f"(d[O + 32]), "+f"(d[O + 33]), "+f"(d[O + 34]),
        "+f"(d[O + 35]), "+f"(d[O + 36]), "+f"(d[O + 37]), "+f"(d[O + 38]), "+f"(d[O + 39]),
        "+f"(d[O + 40]), "+f"(d[O + 41]), "+f"(d[O + 42]), "+f"(d[O + 43]), "+f"(d[O + 44]),
        "+f"(d[O + 45]), "+f"(d[O + 46]), "+f"(d[O + 47]), "+f"(d[O + 48]), "+f"(d[O + 49]),
        "+f"(d[O + 50]), "+f"(d[O + 51]), "+f"(d[O + 52]), "+f"(d[O + 53]), "+f"(d[O + 54]),
        "+f"(d[O + 55]), "+f"(d[O + 56]), "+f"(d[O + 57]), "+f"(d[O + 58]), "+f"(d[O + 59]),
        "+f"(d[O + 60]), "+f"(d[O + 61]), "+f"(d[O + 62]), "+f"(d[O + 63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// s[64 x 64] = a b^T for two K-major Tiles in shared memory (a: the 64 rows
// of the accumulator, b: its 64 columns), contraction over DH; with
// `accumulate`, s += a b^T (a later chunk of a wider head dim). Issued, not
// waited for.
template <int DH>
__device__ __forceinline__ void issue_scores(float (&s)[32], uint32_t a, uint32_t b,
                                             bool accumulate = false) {
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks)
    wgmma_ss_n64(s, desc_k_major<DH>(a, ks), desc_k_major<DH>(b, ks), accumulate || ks > 0);
}

// o[64 x DH] += p[64 x 64] b for p as bf16 A fragments (see pack_rows) and a
// Tile b whose 64 rows are the contraction: one m64nDHk16 wgmma a k-step (the
// wgmma_rs overload of DH / 2 accumulators), two of n128 at DH = 256. Issued,
// not waited for.
template <int DH>
__device__ __forceinline__ void issue_weigh(float (&o)[DH / 2], const uint32_t (&p)[4][4],
                                            uint32_t b) {
  if constexpr (DH <= 128) {
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) wgmma_rs(o, p[ks], desc_mn_major<DH>(b, ks));
  } else {
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      wgmma_rs_n128_at<0>(o, p[ks], desc_mn_major<DH>(b, ks));
      wgmma_rs_n128_at<64>(o, p[ks], desc_mn_major<DH>(b + 16 * Tile<DH>::kGroup, ks));
    }
  }
}

// The wgmma accumulator layout of a 64 x N f32 tile: thread t of the
// warpgroup holds d[i] at row 16 (t / 32) + (t % 32) / 4 + 8 ((i / 2) % 2),
// column 8 (i / 4) + 2 (t % 4) + i % 2.
__device__ __forceinline__ int frag_row(int t) { return 16 * (t / 32) + (t % 32) / 4; }
__device__ __forceinline__ int frag_col(int t) { return 2 * (t % 4); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Rounds a 64 x 64 f32 accumulator tile to bf16 A fragments of four k-steps
// of 16 columns: the accumulator layout of columns 16 ks .. 16 ks + 15 is the
// register layout of a wgmma A operand.
__device__ __forceinline__ void pack_rows(const float (&s)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[ks][r] = pack_bf16(s[8 * ks + 2 * r], s[8 * ks + 2 * r + 1]);
}

// Reductions over the four threads that share an accumulator row.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// x = s * scale + bias with two roundings, never one FMA: the reference's
// order (attention.py:_probs, pallas_attention.py:73).
__device__ __forceinline__ float logit(float s, float scale, float bias) {
  return __fadd_rn(__fmul_rn(s, scale), bias);
}

// The logits of a 64 x 64 score tile whose columns are keys key0 .. key0 + 63,
// in place; `bias` is the slice's key bias in shared memory, c = frag_col(t).
__device__ __forceinline__ void add_logits(float (&s)[32], const float* bias, int key0, int c,
                                           float scale) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const float2 bb = *reinterpret_cast<const float2*>(bias + key0 + 8 * n + c);
    s[4 * n] = logit(s[4 * n], scale, bb.x);
    s[4 * n + 1] = logit(s[4 * n + 1], scale, bb.y);
    s[4 * n + 2] = logit(s[4 * n + 2], scale, bb.x);
    s[4 * n + 3] = logit(s[4 * n + 3], scale, bb.y);
  }
}

// e / sum rounded to nearest, as __fdiv_rn rounds it, from rcp = __frcp_rn(sum)
// and without __fdiv_rn's per-call branch to a slow path, which keeps the
// compiler from interleaving the 32 quotients of a tile. For e in [0, 1] and
// sum >= 1: a = e 2^64 is exact, q = a rcp is within one ulp of a / sum, the
// residual a - q sum is exact by FMA (2^64 keeps it out of the subnormal
// range), and one correction step gives the correctly rounded quotient
// (Markstein's theorem); the scaling back by 2^-64 is exact for every normal
// result. A probability under 2^-126 may differ from __fdiv_rn's in its last
// subnormal bit.
__device__ __forceinline__ float div_rn(float e, float sum, float rcp) {
  const float a = __fmul_rn(e, 0x1p64f);
  const float q = __fmul_rn(a, rcp);
  return __fmul_rn(__fmaf_rn(__fmaf_rn(-q, sum, a), rcp, q), 0x1p-64f);
}

// x kept (times 1/(1-rate)) or dropped, as torch.where(keep, x * inv_keep, 0)
// gives it for a finite x >= 0 (a finite x < 0 gets -0, equal in every use
// here): a multiply by a selected factor, never a branch.
__device__ __forceinline__ float apply_keep(float x, bool keep, float inv_keep) {
  return __fmul_rn(x, keep ? inv_keep : 0.0f);
}

// Row statistics of a softmax over streamed 64-key tiles, for the thread's
// two accumulator rows: the running maximum and the sum of exp(x - max),
// rescaled when the maximum grows. `sum_e` is the thread's partial sum (its 16
// columns of each tile) until `finish` adds the quad's partials.
struct RowStats {
  float max_x[2] = {-INFINITY, -INFINITY};
  float sum_e[2] = {0.0f, 0.0f};
  float rcp[2];  // 1 / sum_e, after finish

  // x: a tile of logits in the accumulator layout
  __device__ __forceinline__ void update(const float (&x)[32]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float m = -INFINITY;
#pragma unroll
      for (int n = 0; n < 8; ++n) m = fmaxf(m, fmaxf(x[4 * n + 2 * h], x[4 * n + 2 * h + 1]));
      m = fmaxf(max_x[h], quad_max(m));
      float s = sum_e[h] * expf(max_x[h] - m);  // 0 on the first tile: max_x[h] is -inf
#pragma unroll
      for (int n = 0; n < 8; ++n)
        s += expf(x[4 * n + 2 * h] - m) + expf(x[4 * n + 2 * h + 1] - m);
      sum_e[h] = s;
      max_x[h] = m;
    }
  }
  __device__ __forceinline__ void finish() {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum_e[h] = quad_sum(sum_e[h]);
      rcp[h] = __frcp_rn(sum_e[h]);
    }
  }
  // the softmax probability of logit x in row h (0: the thread's first row)
  __device__ __forceinline__ float prob(float x, int h) const {
    return div_rn(expf(x - max_x[h]), sum_e[h], rcp[h]);
  }
};

// ---------------------------------------------------------------------------
// bf16 loop forms: tiles passed between kernels as wgmma A fragments
// ---------------------------------------------------------------------------

constexpr uint32_t kChunkBytes = Tile<kChunk>::kBytes;  // a 64 x 128 chunk tile
constexpr int kLoopStages = 2;  // every item waits for its own products
// A scratch of 64 x 64 bf16 tiles as wgmma A fragments, u32 [batch * heads]
// [nt][nt][16][128] (nt = seq / 64): tile (it, kt), it a tile of 64 query
// rows and kt of 64 keys, in the register layout of pack_rows, register r of
// thread t at [r][t] (a warp's loads of a register are 128 contiguous bytes).
constexpr int kFragWords = 16 * kWarpgroup;

__device__ __forceinline__ size_t frag_tile(size_t bh, int nt, int it, int kt) {
  return ((bh * nt + it) * nt + kt) * kFragWords;
}

__device__ __forceinline__ void store_frags(uint32_t* dst, const uint32_t (&a)[4][4], int t) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int r = 0; r < 4; ++r) dst[(4 * ks + r) * kWarpgroup + t] = a[ks][r];
}

// One block per (batch, head, 64 output rows, 128 output columns): out =
// the sum over the 64-row tiles `item` of src of A(item) src[item], A the
// fragments of tile (row tile, item) (BY_KEYS false: K2's o = p v, K3's dq =
// ds k) or of tile (item, row tile) (BY_KEYS true: the rows are keys, K3's
// dk = ds^T q and dv = pd^T do). The 128-column slice of each src tile
// streams through a two-stage ring; the next item's fragments load while the
// product runs. Sums in the order of the key (or query) tiles, f32.
template <bool BY_KEYS>
__global__ void __launch_bounds__(kWarpgroup, 2)
attention_slice_kernel(const bf16* __restrict__ src, const uint32_t* __restrict__ frags,
                       bf16* __restrict__ out, int heads, int seq, int dh) {
  constexpr int NT = kWarpgroup;
  extern __shared__ __align__(128) unsigned char smem[];
  const int t = threadIdx.x;
  const int nc = dh / kChunk, nt = seq / kTile;
  const int part = blockIdx.x % nc, tile = blockIdx.x / nc;
  const size_t bh = (size_t)blockIdx.z * heads + blockIdx.y, slice = bh * seq * dh;
  const uint32_t ring = smem_addr(smem);

  auto issue = [&](int item) {
    if (item < nt)
      load_tile<kChunk, NT>(ring + (item % kLoopStages) * kChunkBytes,
                            src + slice + (size_t)item * kTile * dh + part * kChunk, t, dh);
    cp_async_commit();
  };
  auto fetch = [&](int item, uint32_t (&f)[4][4]) {
    const uint32_t* at =
        frags + (BY_KEYS ? frag_tile(bh, nt, item, tile) : frag_tile(bh, nt, tile, item));
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int r = 0; r < 4; ++r) f[ks][r] = at[(4 * ks + r) * kWarpgroup + t];
  };
  issue(0);

  float acc[kChunk / 2];
#pragma unroll
  for (int i = 0; i < kChunk / 2; ++i) acc[i] = 0.0f;
  uint32_t a[4][4], next[4][4];
  fetch(0, a);
  for (int item = 0; item < nt; ++item) {
    stage_ready();
    issue(item + 1);
    wgmma_fence();
    issue_weigh<kChunk>(acc, a, ring + (item % kLoopStages) * kChunkBytes);
    wgmma_commit();
    const bool more = item + 1 < nt;
    if (more) fetch(item + 1, next);
    wgmma_wait<0>();
    fence_regs(acc);
    if (more)
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int r = 0; r < 4; ++r) a[ks][r] = next[ks][r];
  }

  const int row0 = tile * kTile + frag_row(t), c = frag_col(t);
#pragma unroll
  for (int i = 0; i < kChunk / 2; i += 2) {
    const size_t at = slice + (size_t)(row0 + 8 * ((i / 2) % 2)) * dh + part * kChunk +
                      8 * (i / 4) + c;
    *reinterpret_cast<__nv_bfloat162*>(out + at) = __floats2bfloat162_rn(acc[i], acc[i + 1]);
  }
}

template <bool BY_KEYS>
cudaError_t launch_slices(const bf16* src, const uint32_t* frags, bf16* out, int batch,
                          int heads, int seq, int dh, cudaStream_t stream) {
  const size_t smem = kLoopStages * kChunkBytes;
  cudaError_t err = cudaFuncSetAttribute(attention_slice_kernel<BY_KEYS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(seq / kTile * (dh / kChunk), heads, batch);
  attention_slice_kernel<BY_KEYS><<<grid, kWarpgroup, smem, stream>>>(src, frags, out, heads,
                                                                      seq, dh);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: the simple body (16 rows a block, score rows in shared memory)
// ---------------------------------------------------------------------------

constexpr int kRows = 16;        // rows of a block (query rows in K2)
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

__device__ inline float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ inline float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// s[r][c] = a[r] . b[c] for the block's kRows rows of `a` and all `seq`
// rows of `b` (both row-major, dh wide, in device memory).
__device__ inline void score_rows(const float* a, const float* b, float* s, int s_ld, int seq,
                                  int dh) {
  for (int c = threadIdx.x; c < seq; c += kThreads) {
    float acc[kRows] = {};
    const float* br = b + (size_t)c * dh;
    for (int d = 0; d < dh; ++d) {
      const float bv = br[d];
      for (int r = 0; r < kRows; ++r) acc[r] = fmaf(a[(size_t)r * dh + d], bv, acc[r]);
    }
    for (int r = 0; r < kRows; ++r) s[r * s_ld + c] = acc[r];
  }
}

// out[r][d] = sum_c p[r][c] v[c][d] for the block's kRows rows; p in shared
// memory, v [seq, dh] row-major and the kRows output rows in device memory.
__device__ inline void weigh_rows(const float* p, int p_ld, const float* v, float* out, int seq,
                                  int dh) {
  for (int i = threadIdx.x; i < kRows * dh; i += kThreads) {
    const int r = i / dh, d = i % dh;
    float acc = 0.0f;
    for (int c = 0; c < seq; ++c) acc = fmaf(p[r * p_ld + c], v[(size_t)c * dh + d], acc);
    out[i] = acc;
  }
}

}  // namespace attn
