// The decoder's q, k and v copy with rotary positions (models/mistral.py,
// ops/rope.py): one pass from the fused q/k/v projection of a batch's real
// tokens to the padded layouts the grouped-query attention products read.
//
// qkv: [N, (nq + 2 nkv) hd], the B right-padded rows' real tokens laid end
// to end (row b's token t at packed row cu_seqlens[b] + t), each row the q
// heads, then the k heads, then the v heads, as the one product writes them.
// Out, padded to T positions a row:
//   q [B, nkv, g T, hd], row i T + t of kv head j the query head j g + i at
//     position t, rotated: the g query heads of a kv head stacked along the
//     rows of one product (g = nq / nkv), so k and v are never repeated;
//   k [B, nkv, T, hd], rotated; v [B, nkv, T, hd], copied.
// Rotation is HF Mistral's rotate-half form at positions 0..T-1 in f32 with
// f32 cos and sin tables [T, hd], each operation rounded on its own in the
// plain chain's order (x cos + (-x2, x1) sin: two products, one sum) and
// rounded once to the activation dtype, so the output is the plain
// version's (ops/rope.py:rope_qkv_packed_reference) bit for bit.
//
// The loop runs over the padded outputs: position t of row b reads its
// packed row and is rotated at position t, and a position past the row's
// length (t >= cu_seqlens[b + 1] - cu_seqlens[b]) writes zeros to q, k and v,
// reading nothing. So no pad slot is left holding what the allocator held: a
// non-finite k or v there would reach the real rows through p v and the
// masked scores. The row offsets, B + 1 of them, come through the read-only
// cache.
//
// What bounds it on the H100: bytes. The N real rows of qkv read once and
// the three outputs written once at every padded position, 2 B an element
// each way in bf16 (3.35 TB/s). What the design does about it: a thread
// takes 8 elements of a head's first half and the 8 they pair with in its
// second half (hd / 2 apart), two 16-byte loads and two 16-byte stores in
// bf16 (four in f32), the tables through the read-only cache (a row's 2 hd
// floats, shared by every head at position t); a grid-stride loop over
// (padded row, head, pair group). Head dims that are not a multiple of 16,
// and unaligned pointers, take the element body, one pair at a time.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr int kGroup = 8;  // elements of each half a thread takes in the vector body

__device__ inline float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ inline float to_f32(float x) { return x; }
template <typename T>
__device__ inline T from_f32(float x);
template <>
__device__ inline bf16 from_f32<bf16>(float x) { return __float2bfloat16_rn(x); }
template <>
__device__ inline float from_f32<float>(float x) { return x; }

template <typename T, int kN>
__device__ inline void load(const T* p, T (&v)[kN]) {
  if constexpr (kN == 1) {
    v[0] = *p;
  } else {
#pragma unroll
    for (int s = 0; s < (int)(kN * sizeof(T) / 16); ++s)
      reinterpret_cast<uint4*>(v)[s] = __ldcs(reinterpret_cast<const uint4*>(p) + s);
  }
}

template <typename T, int kN>
__device__ inline void store(T* p, const T (&v)[kN]) {
  if constexpr (kN == 1) {
    *p = v[0];
  } else {
#pragma unroll
    for (int s = 0; s < (int)(kN * sizeof(T) / 16); ++s)
      reinterpret_cast<uint4*>(p)[s] = reinterpret_cast<const uint4*>(v)[s];
  }
}

// kN elements of each half: pair group c of head `head` at padded row `row`
// (= b T + t). Heads [0, nq) are q, [nq, nq + nkv) k, the rest v. qkv holds
// the real rows alone, row b's starting at cu_seqlens[b]; a pad position
// writes zeros.
template <typename T, int kN>
__global__ void __launch_bounds__(kThreads)
rope_qkv_kernel(const T* __restrict__ qkv, const long long* __restrict__ cu_seqlens,
                const float* __restrict__ cos, const float* __restrict__ sin,
                T* __restrict__ q, T* __restrict__ k, T* __restrict__ v, long long items,
                int t_len, int nq, int nkv, int hd) {
  const int half = hd / 2, groups = half / kN, heads = nq + 2 * nkv, g = nq / nkv;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < items; i += stride) {
    const int c = (int)(i % groups);
    const long long rest = i / groups;
    const int head = (int)(rest % heads);
    const long long row = rest / heads;
    const int t = (int)(row % t_len);
    const long long b = row / t_len;
    const int d = c * kN;
    T* dst;
    if (head < nq) {  // query head j g + i of kv head j: row i T + t
      const int kv = head / g;
      dst = q + (((b * nkv + kv) * g + head % g) * t_len + t) * hd + d;
    } else if (head < nq + nkv) {
      dst = k + ((b * nkv + head - nq) * t_len + t) * hd + d;
    } else {
      dst = v + ((b * nkv + head - nq - nkv) * t_len + t) * hd + d;
    }
    const long long first = __ldg(cu_seqlens + b);
    if (t >= __ldg(cu_seqlens + b + 1) - first) {  // past row b's last token
      alignas(16) T zero[kN];
#pragma unroll
      for (int e = 0; e < kN; ++e) zero[e] = from_f32<T>(0.0f);
      store<T, kN>(dst, zero);
      store<T, kN>(dst + half, zero);
      continue;
    }
    const T* src = qkv + ((first + t) * heads + head) * hd + d;
    alignas(16) T x1[kN], x2[kN];
    load<T, kN>(src, x1);
    load<T, kN>(src + half, x2);
    if (head < nq + nkv) {
      const float* cr = cos + (long long)t * hd + d;
      const float* sr = sin + (long long)t * hd + d;
      alignas(16) T o1[kN], o2[kN];
#pragma unroll
      for (int e = 0; e < kN; ++e) {
        const float a = to_f32(x1[e]), z = to_f32(x2[e]);
        // (x cos)[d] + (-x2 sin)[d], and (x cos)[d + half] + (x1 sin)[d + half]
        o1[e] = from_f32<T>(__fadd_rn(__fmul_rn(a, __ldg(cr + e)), __fmul_rn(-z, __ldg(sr + e))));
        o2[e] = from_f32<T>(
            __fadd_rn(__fmul_rn(z, __ldg(cr + half + e)), __fmul_rn(a, __ldg(sr + half + e))));
      }
      store<T, kN>(dst, o1);
      store<T, kN>(dst + half, o2);
    } else {
      store<T, kN>(dst, x1);
      store<T, kN>(dst + half, x2);
    }
  }
}

int grid_for(long long work) {
  int device = 0, sms = 132;
  if (cudaGetDevice(&device) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long blocks = (work + kThreads - 1) / kThreads;
  const long long most = (long long)sms * kBlocksPerSm;
  return (int)(blocks < most ? blocks : most);
}

// The forms, as ops/rope.py names them (ROPE_FORMS)
enum Form { kVec = 0, kScalar = 1 };

int form_of(int hd, const void* a, const void* b, const void* c, const void* d) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
                         reinterpret_cast<uintptr_t>(c) | reinterpret_cast<uintptr_t>(d);
  return hd % (2 * kGroup) == 0 && bits % 16 == 0 ? kVec : kScalar;
}

template <typename T>
cudaError_t launch(const void* qkv, const long long* cu_seqlens, const float* cos,
                   const float* sin, void* q, void* k, void* v, long long rows, int t_len,
                   int nq, int nkv, int hd, int form, cudaStream_t stream) {
  const int per = form == kVec ? kGroup : 1;
  const long long items = rows * (nq + 2 * nkv) * (long long)(hd / 2 / per);
  const T* x = static_cast<const T*>(qkv);
  T *qo = static_cast<T*>(q), *ko = static_cast<T*>(k), *vo = static_cast<T*>(v);
  if (form == kVec) {
    rope_qkv_kernel<T, kGroup><<<grid_for(items), kThreads, 0, stream>>>(
        x, cu_seqlens, cos, sin, qo, ko, vo, items, t_len, nq, nkv, hd);
  } else {
    rope_qkv_kernel<T, 1><<<grid_for(items), kThreads, 0, stream>>>(
        x, cu_seqlens, cos, sin, qo, ko, vo, items, t_len, nq, nkv, hd);
  }
  return cudaGetLastError();
}

}  // namespace

// qkv: [N, (nq + 2 nkv) hd] contiguous, the real rows of a right-padded batch
// laid end to end, bf16 when is_bf16, else f32; cu_seqlens: [batch + 1]
// int64 on the device, ascending from 0, cu_seqlens[batch] = N and each row
// at most t_len long; cos, sin: [t_len, hd] f32; q: [batch, nkv, (nq / nkv)
// t_len, hd], k and v: [batch, nkv, t_len, hd], of qkv's dtype (none may
// alias qkv), zeros at every position past a row's length. hd even, nq a
// multiple of nkv. form: the index of the form in ops/rope.py's ROPE_FORMS,
// which must be form_of's for hd and the alignment of qkv, q, k and v.
// Returns a cudaError_t code.
extern "C" int proqa_rope_qkv_packed(const void* qkv, const void* cu_seqlens, const void* cos,
                                     const void* sin, void* q, void* k, void* v, int batch,
                                     int t_len, int nq, int nkv, int hd, int is_bf16, int form,
                                     void* stream) {
  if (batch < 0 || t_len < 0 || nq < 1 || nkv < 1 || nq % nkv != 0 || hd < 2 || hd % 2 != 0 ||
      form != form_of(hd, qkv, q, k, v) || cu_seqlens == nullptr)
    return cudaErrorInvalidValue;
  const long long rows = (long long)batch * t_len;
  if (rows == 0) return cudaSuccess;
  const long long* cu = static_cast<const long long*>(cu_seqlens);
  const float* c = static_cast<const float*>(cos);
  const float* s = static_cast<const float*>(sin);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<bf16>(qkv, cu, c, s, q, k, v, rows, t_len, nq, nkv, hd, form, st)
                 : launch<float>(qkv, cu, c, s, q, k, v, rows, t_len, nq, nkv, hd, form, st);
}
