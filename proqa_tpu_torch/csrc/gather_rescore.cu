// K6 / K9: scores of each query's candidate corpus blocks, gathered in the
// kernel (the exact-MIPS rescore stage of the bf16 and f32 searches).
//
// Replaces proqa_tpu/ops/pallas_rescore.py:_kernel (K6, gather_rescore,
// launched by _gather_rescore_1 :151) and
// proqa_tpu/ops/pallas_gather_score.py:_kernel (K9, gather_score :53). The
// two TPU kernels are two layouts of one function,
//   out[q, j * block + b] = corpus[ids[q, j] * block + b] . queries[q]   (f32),
// for the kb candidate blocks of each query, so one kernel serves both. Each
// candidate row is read from device memory once and only the [Q, kb * block]
// f32 scores are written: the [Q, kb, block, D] gather of the `take` rescore
// never exists. ops/mips.py:rescore_block_candidates runs this kernel for
// every CUDA search over a bf16 or f32 corpus (DenseIndex.search, the
// eval-retrieval and retrieve commands, mips_topk_v1).
//
// What bounds it on the H100: bytes. Each candidate row (256 bytes in bf16,
// 512 in f32) meets one query once, 2 * D = 256 FLOP a row: about one FLOP
// per byte, far below the ~295 where the tensor cores would be the limit, so
// the products run on the FMA pipe and no tensor cores are used. At Q =
// 2,048, kb = 80, block 16 over 4.2M x 128 bf16 the queries ask for 0.67 GB
// of rows (0.49 GB of distinct blocks); what must move is the distinct
// blocks once and the 10.5 MB of scores.
//
// What the design does about it. A row of the old kernel waited on three
// dependent loads (the query slice, the candidate id, then the row) and its
// CUDA block exited after 32 KB; here nothing waits on an id at row time:
//   - a persistent grid (the SM count times the CTAs that fit on an SM)
//     walks work items in turn: item `it` is query q's run of at most 32
//     consecutive candidate blocks (kb split into ceil(kb / 32) runs of
//     near-equal length, so no CTA is left with the short runs);
//   - one producer warp loads the run's ids once, coalesced, one id a lane
//     (the next item's ids are loaded while this item's copies go out), and
//     fills a ring of kStages shared-memory stages: each stage holds up to
//     16 KB of the run's rows (64 bf16 or 32 f32 rows) and the query's row,
//     each contiguous piece of a candidate block arriving by one 1D bulk
//     copy (cp.async.bulk: no tensor map, 16-byte aligned sizes that are
//     multiples of 16, which 128-element rows always are) that completes
//     bytes on the stage's full mbarrier; a block larger than a stage is
//     split over stages. Eight 16 KB stages keep up to 128 KB in flight on
//     each SM, well above the ~30 KB that covers HBM latency at 3.35 TB/s;
//   - consumer warp w takes the stages w, w + 4, ...: a lane reads 16 bytes
//     of a row (8 bf16 or 4 f32), widens and multiplies them by its slice
//     of the query in f32, and after 32 rows the warp's lanes exchange
//     halves of their partial sums (4 or 5 steps, ~one shuffle a row) so
//     that each lane ends with the whole sum of one row; the 32 lanes store
//     32 consecutive scores. The warp then frees the stage (empty mbarrier).
// The products of bf16 values are exact in f32; the sums run in another
// order than the plain version's (tests/test_torch_cuda.py: 1e-4).
// Widths: the above is the D = 128 form (gather_score_ring_kernel). Every
// other width that is a multiple of 16, with a row of at most 16 KB (D <=
// 8,192 in bf16, 4,096 in f32: a stage holds two beside the query's),
// runs gather_score_wide_kernel: four 48 KB stages, one a consumer warp, of
// as many whole rows as fit beside the query's (at most 64; 31 at D = 768 in
// bf16), a lane summing its 16-byte vectors of a row in order and the warp's
// exchange of halves finishing 32 rows at once, whatever the row's length.
// tests/test_torch_gather_rescore_split.py mirrors the work split, the
// ring's slots and phases and every lane's rows thread by thread.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_maxima_common.cuh"

namespace {

using bmax::bulk_load;
using bmax::mbar_arrive;
using bmax::mbar_expect_tx;
using bmax::mbar_init;
using bmax::mbar_wait;

constexpr int kDim = 128;        // embedding width the kernel takes
constexpr int kRunBlocks = 32;   // candidate blocks of one work item at most: one id a lane
constexpr int kConsumers = 4;    // consumer warps; warp w reads the stages w, w + 4, ...
constexpr int kStages = 8;       // ring stages, a multiple of kConsumers
constexpr int kThreads = (kConsumers + 1) * 32;  // the producer warp last
constexpr int kTileBytes = 16384;                // candidate rows of one stage

static_assert(kStages % kConsumers == 0, "a consumer warp owns whole ring slots");

template <typename T>
struct Tile {
  static constexpr int kRowBytes = kDim * (int)sizeof(T);     // 256 or 512
  static constexpr int kRows = kTileBytes / kRowBytes;        // 64 or 32 rows a stage
  static constexpr int kStageBytes = kTileBytes + kRowBytes;  // the rows, then the query
  static constexpr int kVec = 16 / (int)sizeof(T);            // elements a lane reads of a row
  static constexpr int kLanes = kDim / kVec;                  // lanes a row: 16 or 32
  static constexpr int kRowsPerLoad = 32 / kLanes;            // rows one warp load covers: 2 or 1
  static constexpr int kSteps = kRows / 32;                   // 32-row warp steps a stage
  static constexpr int kSmem = kStages * kStageBytes + 2 * kStages * 8;
};

// Work item `it` of num_q * per_q: query q's candidate blocks [first,
// first + nblk), kb split into per_q = ceil(kb / 32) runs whose lengths
// differ by at most one.
struct Item {
  int q, first, nblk;
};

__device__ __forceinline__ Item work_item(int it, int kb, int per_q) {
  const int q = it / per_q, i = it - q * per_q;
  const int base = kb / per_q, extra = kb - base * per_q;
  return {q, i * base + min(i, extra), base + (i < extra ? 1 : 0)};
}

// 16 bytes of a row as f32: 8 bf16 (a bf16 is the top half of its f32) or
// 4 f32
template <typename T>
__device__ __forceinline__ void widen(const uint4& v, float* out) {
  if constexpr (sizeof(T) == 2) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  } else {
    out[0] = __uint_as_float(v.x);
    out[1] = __uint_as_float(v.y);
    out[2] = __uint_as_float(v.z);
    out[3] = __uint_as_float(v.w);
  }
}

// p[k] is a lane's partial sum of row k of its row group (the K lanes that
// share lane / K). Exchanges of halves across bits K/2 .. 1: a lane whose
// bit is set keeps the upper half of its rows and adds its partner's partial
// sums of them; after log2(K) steps lane l holds the whole sum of row l % K.
// One step a template instance, so every index is a constant and p stays in
// registers.
template <int BIT, int K>
__device__ __forceinline__ float sum_rows(float (&p)[K], int lane) {
  const bool upper = lane & BIT;
#pragma unroll
  for (int k = 0; k < BIT; ++k) {
    const float send = upper ? p[k] : p[k + BIT];
    const float keep = upper ? p[k + BIT] : p[k];
    p[k] = keep + __shfl_xor_sync(0xffffffffu, send, BIT);
  }
  if constexpr (BIT > 1) {
    return sum_rows<BIT / 2>(p, lane);
  } else {
    return p[0];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
gather_score_ring_kernel(const T* __restrict__ queries, const T* __restrict__ corpus,
                         const int64_t* __restrict__ ids, float* __restrict__ out, int num_q,
                         int kb, int block) {
  using G = Tile<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t ring = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t full = ring + kStages * G::kStageBytes, empty = full + 8 * kStages;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full + 8 * i, 1);   // the producer's arrival with its bytes
      mbar_init(empty + 8 * i, 1);  // the consumer warp's first lane
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int per_q = (kb + kRunBlocks - 1) / kRunBlocks;
  const int num_items = num_q * per_q;

  if (warp == kConsumers) {  // the producer: tile n into stage n % kStages
    const char* qbase = reinterpret_cast<const char*>(queries);
    const char* cbase = reinterpret_cast<const char*>(corpus);
    auto load_ids = [&](int it) -> int64_t {
      if (it >= num_items) return 0;
      const Item w = work_item(it, kb, per_q);
      return lane < w.nblk ? ids[(int64_t)w.q * kb + w.first + lane] : 0;
    };
    int n = 0;
    int64_t next = load_ids(blockIdx.x);
    for (int it = blockIdx.x; it < num_items; it += gridDim.x) {
      const Item w = work_item(it, kb, per_q);
      const int64_t id = next;  // lane i: the id of candidate block first + i
      next = load_ids(it + gridDim.x);
      const int rows = w.nblk * block;
      const char* qrow = qbase + (int64_t)w.q * G::kRowBytes;
      for (int r0 = 0; r0 < rows; r0 += G::kRows, ++n) {
        const int stage = n % kStages;
        const uint32_t dst = ring + stage * G::kStageBytes, bar = full + 8 * stage;
        const int nrows = min(G::kRows, rows - r0);
        // the tile's rows [r0, r0 + nrows) of the run lie in its blocks
        // b0 .. b0 + pieces - 1; lane p copies the piece of block b0 + p
        const int b0 = r0 / block, pieces = (r0 + nrows - 1) / block - b0 + 1;
        const long long cand =
            __shfl_sync(0xffffffffu, (long long)id, min(b0 + lane, kRunBlocks - 1));
        if (lane == 0) {
          mbar_wait(empty + 8 * stage, ((n / kStages) & 1) ^ 1);
          mbar_expect_tx(bar, (uint32_t)(nrows + 1) * G::kRowBytes);
          bulk_load(dst + kTileBytes, qrow, G::kRowBytes, bar);
        }
        __syncwarp();
        if (lane < pieces) {
          const int b = b0 + lane;
          const int lo = max(r0, b * block), hi = min(r0 + nrows, (b + 1) * block);
          const char* src = cbase + (cand * block + (lo - b * block)) * G::kRowBytes;
          bulk_load(dst + (lo - r0) * G::kRowBytes, src, (uint32_t)(hi - lo) * G::kRowBytes,
                    bar);
        }
      }
    }
    return;
  }

  // a consumer warp: rows of its stages, 32 at a time
  const int sub = lane % G::kLanes, half = lane / G::kLanes;
  int n = 0;
  for (int it = blockIdx.x; it < num_items; it += gridDim.x) {
    const Item w = work_item(it, kb, per_q);
    const int rows = w.nblk * block;
    float* qout = out + ((int64_t)w.q * kb + w.first) * block;
    for (int r0 = 0; r0 < rows; r0 += G::kRows, ++n) {
      if (n % kConsumers != warp) continue;
      const int stage = n % kStages;
      const int nrows = min(G::kRows, rows - r0);
      const unsigned char* st = smem + stage * G::kStageBytes;
      mbar_wait(full + 8 * stage, (n / kStages) & 1);
      float qv[G::kVec];
      widen<T>(*reinterpret_cast<const uint4*>(st + kTileBytes + sub * 16), qv);
      float sums[G::kSteps];
#pragma unroll
      for (int s = 0; s < G::kSteps; ++s) {
        float p[G::kLanes];
#pragma unroll
        for (int k = 0; k < G::kLanes; ++k) {
          const int row = s * 32 + k * G::kRowsPerLoad + half;
          float c[G::kVec];
          widen<T>(*reinterpret_cast<const uint4*>(st + row * G::kRowBytes + sub * 16), c);
          float acc = 0.0f;
#pragma unroll
          for (int i = 0; i < G::kVec; ++i) acc = fmaf(c[i], qv[i], acc);
          p[k] = acc;
        }
        sums[s] = sum_rows<G::kLanes / 2>(p, lane);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * stage);
#pragma unroll
      for (int s = 0; s < G::kSteps; ++s) {
        const int row = s * 32 + sub * G::kRowsPerLoad + half;
        if (row < nrows) qout[r0 + row] = sums[s];
      }
    }
  }
}

// The persistent grid's size on the current device: its SMs times the CTAs
// that fit on one. Found once a device, with the shared-memory limit raised
// for the kernel there, so a call's host path is only the launch.
template <typename T>
cudaError_t grid_cap(int* cap) {
  constexpr int kMaxDevices = 64;
  static int caps[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < kMaxDevices && caps[device] > 0) {
    *cap = caps[device];
    return cudaSuccess;
  }
  auto kernel = gather_score_ring_kernel<T>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Tile<T>::kSmem);
  if (err != cudaSuccess) return err;
  int sms = 0, per_sm = 0;
  if ((err = bmax::multiprocessors(&sms)) != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, Tile<T>::kSmem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *cap = sms * per_sm;
  if (device < kMaxDevices) caps[device] = *cap;
  return cudaSuccess;
}

template <typename T>
cudaError_t launch(const void* queries, const void* corpus, const void* ids, void* out,
                   int num_q, int kb, int block, cudaStream_t stream) {
  int cap = 0;
  const cudaError_t err = grid_cap<T>(&cap);
  if (err != cudaSuccess) return err;
  const long long items = (long long)num_q * ((kb + kRunBlocks - 1) / kRunBlocks);
  const int grid = (int)(items < cap ? items : cap);
  gather_score_ring_kernel<T><<<grid, kThreads, Tile<T>::kSmem, stream>>>(
      static_cast<const T*>(queries), static_cast<const T*>(corpus),
      static_cast<const int64_t*>(ids), static_cast<float*>(out), num_q, kb, block);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Every other width: gather_score_wide_kernel
// ---------------------------------------------------------------------------

constexpr int kWideStageBytes = 49152;  // a wide stage: its rows, then the query's row
constexpr int kWideStages = 4;          // ring stages: 192 KB, one CUDA block an SM
constexpr int kWideMaxRows = 64;        // rows a wide stage holds at most
constexpr int kWideSmem = kWideStages * kWideStageBytes + 2 * kWideStages * 8;
// the widest row a stage takes, two of them beside the query's: 16 KB (D <=
// 8,192 in bf16, 4,096 in f32)
constexpr int kWideMaxRowBytes = kWideStageBytes / 3;

// Consumer warp w takes the tiles n with n % kConsumers == w and tile n lies
// in stage n % kWideStages, so each stage must have one reader. Were a stage
// shared by two warps (6 stages, 4 warps: tile n on warp w, tile n + 6 on
// warp w + 2), the warp of tile n + 6 could wait on the stage while tile n's
// copies are still in flight: its parity is then that of the phase already
// completed, the wait passes at once, and it reads stale rows.
static_assert(kWideStages % kConsumers == 0, "a consumer warp owns whole ring slots");

// gather_score_ring_kernel at any width D (a multiple of 16): a stage holds
// `rows` candidate rows of row_bytes (at most 64, as many as 48 KB holds
// beside the query's row), copied as at D = 128, one bulk copy a piece of a
// candidate block. A consumer warp takes a stage's rows 32 at a time: for
// each row every lane sums the products of its 16-byte vectors v = lane,
// lane + 32, ... of the row with the query's same vectors (in f32, vectors
// in order), then the 32 lanes' partial sums of the 32 rows finish by
// exchanges of halves (sum_rows over 5 bits), which leaves lane l the sum of
// row l, and the warp stores 32 consecutive scores.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
gather_score_wide_kernel(const T* __restrict__ queries, const T* __restrict__ corpus,
                         const int64_t* __restrict__ ids, float* __restrict__ out, int num_q,
                         int kb, int block, int row_bytes, int rows_per_stage) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t ring = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t full = ring + kWideStages * kWideStageBytes, empty = full + 8 * kWideStages;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kWideStages; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int per_q = (kb + kRunBlocks - 1) / kRunBlocks;
  const int num_items = num_q * per_q;
  const int query_at = rows_per_stage * row_bytes;  // the query's row in a stage

  if (warp == kConsumers) {  // the producer: tile n into stage n % kWideStages
    const char* qbase = reinterpret_cast<const char*>(queries);
    const char* cbase = reinterpret_cast<const char*>(corpus);
    auto load_ids = [&](int it) -> int64_t {
      if (it >= num_items) return 0;
      const Item w = work_item(it, kb, per_q);
      return lane < w.nblk ? ids[(int64_t)w.q * kb + w.first + lane] : 0;
    };
    int n = 0;
    int64_t next = load_ids(blockIdx.x);
    for (int it = blockIdx.x; it < num_items; it += gridDim.x) {
      const Item w = work_item(it, kb, per_q);
      const int64_t id = next;
      next = load_ids(it + gridDim.x);
      const int rows = w.nblk * block;
      const char* qrow = qbase + (int64_t)w.q * row_bytes;
      for (int r0 = 0; r0 < rows; r0 += rows_per_stage, ++n) {
        const int stage = n % kWideStages;
        const uint32_t dst = ring + stage * kWideStageBytes, bar = full + 8 * stage;
        const int nrows = min(rows_per_stage, rows - r0);
        const int b0 = r0 / block, pieces = (r0 + nrows - 1) / block - b0 + 1;
        const long long cand =
            __shfl_sync(0xffffffffu, (long long)id, min(b0 + lane, kRunBlocks - 1));
        if (lane == 0) {
          mbar_wait(empty + 8 * stage, ((n / kWideStages) & 1) ^ 1);
          mbar_expect_tx(bar, (uint32_t)(nrows + 1) * row_bytes);
          bulk_load(dst + query_at, qrow, row_bytes, bar);
        }
        __syncwarp();
        if (lane < pieces) {
          const int b = b0 + lane;
          const int lo = max(r0, b * block), hi = min(r0 + nrows, (b + 1) * block);
          const char* src = cbase + (cand * block + (lo - b * block)) * row_bytes;
          bulk_load(dst + (lo - r0) * row_bytes, src, (uint32_t)(hi - lo) * row_bytes, bar);
        }
      }
    }
    return;
  }

  constexpr int kVec = 16 / (int)sizeof(T);
  const int vecs = row_bytes / 16;  // 16-byte vectors a row
  int n = 0;
  for (int it = blockIdx.x; it < num_items; it += gridDim.x) {
    const Item w = work_item(it, kb, per_q);
    const int rows = w.nblk * block;
    float* qout = out + ((int64_t)w.q * kb + w.first) * block;
    for (int r0 = 0; r0 < rows; r0 += rows_per_stage, ++n) {
      if (n % kConsumers != warp) continue;
      const int stage = n % kWideStages;
      const int nrows = min(rows_per_stage, rows - r0);
      const unsigned char* st = smem + stage * kWideStageBytes;
      const unsigned char* qv = st + query_at;
      mbar_wait(full + 8 * stage, (n / kWideStages) & 1);
      float sums[kWideMaxRows / 32];
#pragma unroll
      for (int g = 0; g < kWideMaxRows / 32; ++g) {
        float p[32];
#pragma unroll
        for (int k = 0; k < 32; ++k) {
          const int row = 32 * g + k;
          float acc = 0.0f;
          if (row < nrows)
            for (int v = lane; v < vecs; v += 32) {
              float c[kVec], q[kVec];
              widen<T>(*reinterpret_cast<const uint4*>(st + row * row_bytes + 16 * v), c);
              widen<T>(*reinterpret_cast<const uint4*>(qv + 16 * v), q);
#pragma unroll
              for (int i = 0; i < kVec; ++i) acc = fmaf(c[i], q[i], acc);
            }
          p[k] = acc;
        }
        sums[g] = 32 * g < nrows ? sum_rows<16>(p, lane) : 0.0f;
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * stage);
#pragma unroll
      for (int g = 0; g < kWideMaxRows / 32; ++g)
        if (32 * g + lane < nrows) qout[r0 + 32 * g + lane] = sums[g];
    }
  }
}

template <typename T>
cudaError_t launch_wide(const void* queries, const void* corpus, const void* ids, void* out,
                        int num_q, int kb, int block, int dim, cudaStream_t stream) {
  constexpr int kMaxDevices = 64;
  static int caps[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  auto kernel = gather_score_wide_kernel<T>;
  int cap = device < kMaxDevices ? caps[device] : 0;
  if (cap == 0) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kWideSmem);
    if (err != cudaSuccess) return err;
    int sms = 0, per_sm = 0;
    if ((err = bmax::multiprocessors(&sms)) != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, kWideSmem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    cap = sms * per_sm;
    if (device < kMaxDevices) caps[device] = cap;
  }
  const int row_bytes = dim * (int)sizeof(T);
  int rows = (kWideStageBytes - row_bytes) / row_bytes;
  rows = rows > kWideMaxRows ? kWideMaxRows : rows;
  const long long items = (long long)num_q * ((kb + kRunBlocks - 1) / kRunBlocks);
  const int grid = (int)(items < cap ? items : cap);
  kernel<<<grid, kThreads, kWideSmem, stream>>>(
      static_cast<const T*>(queries), static_cast<const T*>(corpus),
      static_cast<const int64_t*>(ids), static_cast<float*>(out), num_q, kb, block, row_bytes,
      rows);
  return cudaGetLastError();
}

}  // namespace

// queries [num_q, dim] and corpus [nb * block, dim] (both bf16 when is_bf16,
// else f32, row-major, 16-byte aligned; dim a multiple of 16, its row at most
// 16 KB: dim <= 8,192 in bf16, 4,096 in f32); ids [num_q, kb] int64, each in
// [0, nb); out [num_q, kb * block] f32. Returns a cudaError_t code.
extern "C" int proqa_gather_score(const void* queries, const void* corpus, const void* ids,
                                  void* out, int num_q, int nb, int kb, int block, int dim,
                                  int is_bf16, void* stream) {
  if (dim <= 0 || dim % bmax::kDimMultiple != 0 || dim * (is_bf16 ? 2 : 4) > kWideMaxRowBytes ||
      num_q <= 0 || nb <= 0 || kb <= 0 || block <= 0 ||
      (long long)num_q * ((kb + kRunBlocks - 1) / kRunBlocks) > 0x7fffffffLL ||
      block > (1 << 20))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dim != kDim)
    return is_bf16
               ? launch_wide<__nv_bfloat16>(queries, corpus, ids, out, num_q, kb, block, dim, s)
               : launch_wide<float>(queries, corpus, ids, out, num_q, kb, block, dim, s);
  return is_bf16 ? launch<__nv_bfloat16>(queries, corpus, ids, out, num_q, kb, block, s)
                 : launch<float>(queries, corpus, ids, out, num_q, kb, block, s);
}
