// K1 on Hopper: block maxima of a bf16 corpus against bf16 queries, for
// exact MIPS, with wgmma products and the maxima taken on the accumulators.
//
// Replaces proqa_tpu/ops/pallas_mips.py:_bmax3_kernel (:83; launched by
// block_maxima_grouped, pallas_call at :228) on the port's search path: bf16
// queries and corpus, grouped output bmax3 [CG, Q, G] (the maximum of each
// block of `block` rows, the G blocks of a group contiguous per query) and
// gmax [CG, 1, Q] (the maximum of each group). The int8 (K5, K7),
// block-major (K8) and f32 cases keep block_maxima.cu's simple body. Every
// emitted value is the maximum of its own block's f32 scores, as in
// pallas_mips.py:129-149, so the exactness certificate of
// pallas_mips.py:295-298 holds unchanged.
//
// What bounds it on the H100 (SXM, 700 W published peaks): operations,
// 2 * Q * N * 128 at the bf16 tensor-core rate of 989 TFLOP/s (2.22 ms at
// Q = 2,048, N = 4,194,304). The bytes it must move, the corpus once (1.07
// GB) and bmax3 (2.15 GB at block 16), take 0.96 ms at 3.35 TB/s. What the
// design does about each:
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
// - Streaming: one producer thread, in a warpgroup of its own that hands
//   its registers to the others (setmaxnreg), copies chunks by TMA into a
//   ring of 6 stages of 32 KB, each with a full and an empty mbarrier; the
//   consumer warpgroups wait on a stage's full barrier and hand it back once
//   their products have read it. No block barrier and no proxy fence in the
//   loop: TMA writes through the async proxy that wgmma reads, and the
//   warpgroups run apart. Two accumulator sets: chunk c's products run on
//   the tensor cores while chunk c - 1's maxima are taken. (Copies by
//   cp.async from every thread, with a block barrier a chunk, kept the
//   copies and not the products on the critical path.)
// - Reuse: two warpgroups, 128 queries a CUDA block (64 when Q <= 64), so a
//   corpus chunk crosses from L2 to the SMs Q / 128 times, half as often as
//   in the simple body. The blocks are persistent: the grid is (query tiles,
//   ~132 / tiles) and block (x, y) walks the groups y, y + gridDim.y, ...
//   with its ring running across them, so the blocks that read one group
//   are resident together and march through the groups in step.
// - Output: each lane stores its maxima from registers in runs of
//   consecutive blocks (16 bytes at block 16) while the next chunk's
//   products run.
#include <cuda.h>  // CUtensorMap and its enums (the encoder is found at run time)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_tiles.cuh"

namespace {

using attn::bf16;

constexpr int kDim = 128;                        // embedding width the kernel takes
constexpr int kChunk = 128;                      // corpus rows a chunk: the wgmma N
constexpr int kStages = 6;                       // ring of chunks (192 KB)
constexpr uint32_t kChunkBytes = kChunk * kDim * 2;
constexpr uint32_t kHalfBytes = kChunkBytes / 2;  // one TMA box: 128 rows x 64 columns
constexpr int kMaxGrid = 65535;

// ---------------------------------------------------------------------------
// TMA and mbarriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Arrives and announces `bytes` that TMA copies will complete on the barrier.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// Waits for the completion of the barrier's phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}
// One box of the corpus's tensor map, element (x, y) at its corner, into
// shared memory; completes `bytes` on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int x, int y,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar)
      : "memory");
}

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

template <int N>
__device__ __forceinline__ void store_run(float* p, const float (&u)[N]) {
  if constexpr (N == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(u[0], u[1], u[2], u[3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(u[0], u[1]);
  } else {
    *p = u[0];
  }
}

// A quad's exchange of halves: a lane whose `bit` is clear keeps values
// [0, K/2) and sends [K/2, K) to its partner across `bit`, which keeps the
// upper half; each kept value becomes the maximum over both lanes.
template <int K>
__device__ __forceinline__ void exchange_halves(const float (&v)[K], float (&w)[K / 2], bool upper,
                                                int bit) {
#pragma unroll
  for (int k = 0; k < K / 2; ++k) {
    const float send = upper ? v[k] : v[k + K / 2];
    const float keep = upper ? v[k + K / 2] : v[k];
    w[k] = fmaxf(keep, __shfl_xor_sync(0xffffffffu, send, bit));
  }
}

template <int BLOCK>
struct Blocks {
  static constexpr int kPerChunk = BLOCK >= kChunk ? 1 : kChunk / BLOCK;  // blocks a chunk
  static constexpr int kSpan = BLOCK > kChunk ? BLOCK / kChunk : 1;       // chunks a block
  static constexpr int kValues = 2 * kPerChunk;  // (row, block) maxima a thread folds
};

// The block maxima of chunk c (of its group) from the accumulators d of a
// 64-query x 128-row score tile. Lane `lane` of its quad ends with query
// row frag_row + 8 (lane & 1); its maxima go to `out` (that row of bmax3,
// or null past the last query), and their maximum into `gm`. `part` carries
// a 256-row block's maxima from its first chunk to its second.
template <int BLOCK>
__device__ __forceinline__ void take_maxima(const float (&d)[64], int c, float* out, int lane,
                                            float (&part)[Blocks<BLOCK>::kValues], float& gm) {
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
#pragma unroll
    for (int k = 0; k < kK / 4; ++k) gm = fmaxf(gm, u[k]);
    if (out != nullptr) store_run<kK / 4>(out + c * kNb + (lane >> 1) * (kK / 4), u);
  } else {
    const float u = fmaxf(w[0], __shfl_xor_sync(0xffffffffu, w[0], 2));
    gm = fmaxf(gm, u);
    if (out != nullptr && (lane >> 1) == 0) out[c / kSpan] = u;
  }
}

// The consumer warpgroups and the producer's. With two consumers, 384
// threads start with 168 registers each; the producer gives most of its own
// back (setmaxnreg) so that a consumer thread can hold two accumulator sets
// and its queries' fragments (~190 registers) without spilling.
template <int NWG>
constexpr int kThreads = (NWG + 1) * 128;
template <bool kInc, int kRegs>
__device__ __forceinline__ void set_max_registers() {
  if constexpr (kInc)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
  else
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// Grid (query tiles of 64 NWG, gy); block (x, y) scores its query tile
// against groups y, y + gy, ... < num_groups, whose `group` blocks of BLOCK
// rows each are contiguous corpus rows. Warpgroups 0 .. NWG - 1 multiply and
// take maxima; the first thread of the last warpgroup feeds the ring by TMA.
template <int BLOCK, int NWG>
__global__ void __launch_bounds__(kThreads<NWG>, 1)
bmax_wgmma_kernel(const __grid_constant__ CUtensorMap corpus, const bf16* __restrict__ queries,
                  float* __restrict__ bmax, float* __restrict__ gmax, int num_q, int group,
                  int num_groups) {
  extern __shared__ __align__(1024) unsigned char smem[];
  // the swizzled boxes want 1024-byte alignment; then a full and an empty
  // barrier for each stage
  const uint32_t ring = (attn::smem_addr(smem) + 1023) & ~1023u;
  const uint32_t full = ring + kStages * kChunkBytes, empty = full + 8 * kStages;
  const int tid = threadIdx.x, t = tid % 128, lane = t % 4;
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, NWG * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int per_group = group * BLOCK / kChunk;  // chunks a group
  const int total = (num_groups - 1 - (int)blockIdx.y) / (int)gridDim.y * per_group + per_group;
  // chunk s of this block: chunk s % per_group of group y + (s / per_group) gy
  auto group_of = [&](int s) { return (int)blockIdx.y + s / per_group * (int)gridDim.y; };

  if (tid >= NWG * 128) {  // the producer: stage s % kStages, once its last reader is done
    if constexpr (NWG == 2) set_max_registers<false, 40>();
    if (tid == NWG * 128) {
      for (int s = 0; s < total; ++s) {
        const int stage = s % kStages;
        mbar_wait(empty + 8 * stage, ((s / kStages) & 1) ^ 1);
        mbar_expect_tx(full + 8 * stage, kChunkBytes);
        const int row = (group_of(s) * per_group + s % per_group) * kChunk;
        const uint32_t dst = ring + stage * kChunkBytes;
        tma_load(dst, &corpus, 0, row, full + 8 * stage);
        tma_load(dst + kHalfBytes, &corpus, 64, row, full + 8 * stage);
      }
    }
    return;
  }

  if constexpr (NWG == 2) set_max_registers<true, 232>();
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

  float part[Blocks<BLOCK>::kValues];
  float gm = -INFINITY;
  auto epilogue = [&](const float (&d)[64], int s) {
    const int c = s % per_group;
    const size_t row = (size_t)group_of(s) * num_q + my_q;
    take_maxima<BLOCK>(d, c, q_valid ? bmax + row * group : nullptr, lane, part, gm);
    if (c == per_group - 1) {
      gm = fmaxf(gm, __shfl_xor_sync(0xffffffffu, gm, 2));
      if (q_valid && (lane >> 1) == 0) gmax[row] = gm;
      gm = -INFINITY;
    }
  };
  // chunk s's products into `acc` once its copy has landed; issued, not
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
  auto take = [&](float (&prev)[64], int s) {
    attn::wgmma_wait<1>();
    attn::fence_regs(prev);
    mbar_arrive(empty + 8 * (s % kStages));
    epilogue(prev, s);
  };

  // Chunk s + 1's products run while chunk s's maxima are taken. The loop
  // body has no branch around a product or a take, so at its back edge the
  // products in flight are always acc0's (ptxas serialises wgmma when it
  // cannot tell which accumulators are in flight).
  float acc0[64], acc1[64];
  issue(acc0, 0);
  int s = 1;
  for (; s + 1 < total; s += 2) {
    issue(acc1, s);
    take(acc0, s - 1);
    issue(acc0, s + 1);
    take(acc1, s);
  }
  if (s < total) {
    issue(acc1, s);
    take(acc0, s - 1);
    attn::wgmma_wait<0>();
    attn::fence_regs(acc1);
    epilogue(acc1, s);
  } else {
    attn::wgmma_wait<0>();
    attn::fence_regs(acc0);
    epilogue(acc0, s - 1);
  }
}

// cuTensorMapEncodeTiled, found through the runtime so that nothing links
// against the driver library
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The corpus [n, 128] bf16 as TMA boxes of 128 rows x 64 columns with the
// 128-byte swizzle that wgmma's B descriptor reads (desc_sw128).
cudaError_t corpus_map(CUtensorMap* map, const void* corpus, int n) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                                    cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[2] = {kDim, (cuuint64_t)n};
  const cuuint64_t strides[1] = {kDim * sizeof(bf16)};
  const cuuint32_t box[2] = {64, kChunk};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(corpus),
                              dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int BLOCK, int NWG>
cudaError_t launch(const void* queries, const void* corpus, void* bmax, void* gmax, int num_q,
                   int n, int group, int num_groups, cudaStream_t stream) {
  constexpr size_t smem = kStages * kChunkBytes + 1024 + 16 * kStages;
  auto kernel = bmax_wgmma_kernel<BLOCK, NWG>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  CUtensorMap map;
  if ((err = corpus_map(&map, corpus, n)) != cudaSuccess) return err;
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  const int tiles = (num_q + 64 * NWG - 1) / (64 * NWG);
  int gy = sms / tiles;
  gy = gy < 1 ? 1 : (gy > num_groups ? num_groups : gy);
  kernel<<<dim3(tiles, gy), kThreads<NWG>, smem, stream>>>(
      map, static_cast<const bf16*>(queries), static_cast<float*>(bmax),
      static_cast<float*>(gmax), num_q, group, num_groups);
  return cudaGetLastError();
}

template <int BLOCK>
cudaError_t launch_block(const void* queries, const void* corpus, void* bmax, void* gmax,
                         int num_q, int n, int group, int num_groups, cudaStream_t stream) {
  return num_q > 64
      ? launch<BLOCK, 2>(queries, corpus, bmax, gmax, num_q, n, group, num_groups, stream)
      : launch<BLOCK, 1>(queries, corpus, bmax, gmax, num_q, n, group, num_groups, stream);
}

}  // namespace

// queries [num_q, 128] and corpus [n, 128] bf16, row-major and 16-byte
// aligned; bmax [n / (group * block), num_q, group] and gmax
// [n / (group * block), 1, num_q] f32. block in {16, 32, 64, 128, 256},
// group * block a multiple of 128 (ops/mips_kernel.py:kernel_for). Returns a
// cudaError_t code.
extern "C" int proqa_block_maxima_wgmma(const void* queries, const void* corpus, void* bmax,
                                        void* gmax, int num_q, int n, int dim, int block,
                                        int group, void* stream) {
  if (dim != kDim || num_q <= 0 || n <= 0 || group <= 0 || (group * block) % kChunk != 0 ||
      n % (group * block) != 0 || n / (group * block) > kMaxGrid)
    return cudaErrorInvalidValue;
  const int num_groups = n / (group * block);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (block) {
    case 16:
      return launch_block<16>(queries, corpus, bmax, gmax, num_q, n, group, num_groups, s);
    case 32:
      return launch_block<32>(queries, corpus, bmax, gmax, num_q, n, group, num_groups, s);
    case 64:
      return launch_block<64>(queries, corpus, bmax, gmax, num_q, n, group, num_groups, s);
    case 128:
      return launch_block<128>(queries, corpus, bmax, gmax, num_q, n, group, num_groups, s);
    case 256:
      return launch_block<256>(queries, corpus, bmax, gmax, num_q, n, group, num_groups, s);
    default: return cudaErrorInvalidValue;
  }
}
