// Fused tf*idf scoring + per-document top-k over the sorted triples.
//
// Replaces: tfidf_tpu/ops/pallas_kernels.py, fused_score_topk_pallas
//   (kernel body _fused_score_topk_kernel).
// Contract (the sparse_topk contract of tfidf_tpu/ops/sparse.py):
//   score[d,i] = float(counts[d,i]) / float(max(len[d],1)) * idf[ids[d,i]]
//   at head slots, finfo(dtype).min elsewhere, each op rounded in the
//   score dtype; then k = min(k, L) picks in order (score desc, slot asc)
//   — lax.top_k's tie order; a pick that is not above finfo.min decodes
//   to (0, -1).
// Bound on this card: memory. Each row's ids, counts (int32) and head
//   (bool) are read once; the [V] idf table (256 KB at 2^16 float32)
//   stays in L2; outputs are 8 bytes per pick. The arithmetic is a few
//   operations per slot and k warp reductions per row.
// Design: one warp per row. The warp scores its row once into its own
//   slice of shared memory, then runs k selection rounds, each a strided
//   scan plus a warp-shuffle argmax. A round takes the best slot AFTER
//   the previous pick in the (score desc, slot asc) order, so nothing is
//   written back to mask a pick and the rounds read shared memory only.
//   Rows too long for shared memory (L > 12288) rescore their slots from
//   global memory (L2) in every round instead; the result is the same.

#include <limits.h>

#include "common.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kMaxWarps = 8;
constexpr size_t kSmemBudget = 48 * 1024;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kNone = INT_MAX;

// finfo(dtype).min as a float.
template <typename T>
__device__ __forceinline__ float lowest();
template <>
__device__ __forceinline__ float lowest<float>() {
  return __uint_as_float(0xff7fffffu);
}
template <>
__device__ __forceinline__ float lowest<__nv_bfloat16>() {
  return __uint_as_float(0xff7f0000u);
}
template <>
__device__ __forceinline__ float lowest<__half>() {
  return -65504.f;
}

template <typename T>
__device__ __forceinline__ float slot_score(const int* __restrict__ ids,
                                            const int* __restrict__ counts,
                                            const uint8_t* __restrict__ head,
                                            const T* __restrict__ idf,
                                            size_t at, float len, float neg,
                                            int V) {
  if (!head[at]) return neg;
  // Clamp like jnp indexing: a head id is a vocab id by construction.
  const int id = min(max(ids[at], 0), V - 1);
  const float tf = round_to<T>(round_to<T>((float)counts[at]) / len);
  return round_to<T>(tf * to_float(idf[id]));
}

template <typename T>
__global__ void fused_score_topk_kernel(
    const int* __restrict__ ids, const int* __restrict__ counts,
    const uint8_t* __restrict__ head, const int* __restrict__ lengths,
    const T* __restrict__ idf, T* __restrict__ vals, int* __restrict__ tids,
    int D, int L, int k, int V, int cached) {
  extern __shared__ float scores[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const long long row = (long long)blockIdx.x * (blockDim.x / kWarp) + warp;
  if (row >= D) return;  // uniform across the warp
  const size_t base = (size_t)row * L;
  const float len = round_to<T>((float)max(lengths[row], 1));
  const float neg = lowest<T>();
  float* sc = scores + (size_t)warp * L;
  if (cached) {
    for (int i = lane; i < L; i += kWarp)
      sc[i] = slot_score(ids, counts, head, idf, base + i, len, neg, V);
    __syncwarp();
  }
  float prev_s = 0.f;
  int prev_i = -1;
  for (int r = 0; r < k; ++r) {
    float best_s = 0.f;
    int best_i = kNone;
    // Lane-local scan in ascending slot order: a strict > keeps the
    // lower slot among equal scores.
    for (int i = lane; i < L; i += kWarp) {
      const float s = cached
          ? sc[i] : slot_score(ids, counts, head, idf, base + i, len, neg, V);
      const bool after = r == 0 || s < prev_s || (s == prev_s && i > prev_i);
      if (after && (best_i == kNone || s > best_s)) {
        best_s = s;
        best_i = i;
      }
    }
    // Butterfly argmax on (score desc, slot asc): every lane ends with
    // the same pick.
    for (int off = kWarp / 2; off > 0; off >>= 1) {
      const float o_s = __shfl_xor_sync(kFullMask, best_s, off);
      const int o_i = __shfl_xor_sync(kFullMask, best_i, off);
      if (o_i != kNone &&
          (best_i == kNone || o_s > best_s || (o_s == best_s && o_i < best_i))) {
        best_s = o_s;
        best_i = o_i;
      }
    }
    if (lane == 0) {
      // k <= L, so round r always finds one of the L - r remaining slots.
      const bool ok = best_s > neg;
      vals[(size_t)row * k + r] = from_float<T>(ok ? best_s : 0.f);
      tids[(size_t)row * k + r] = ok ? ids[base + best_i] : -1;
    }
    prev_s = best_s;
    prev_i = best_i;
  }
}

template <typename T>
int launch(const void* ids, const void* counts, const void* head,
           const void* lengths, const void* idf, void* vals, void* tids,
           int D, int L, int k, int V, cudaStream_t stream) {
  const size_t per_warp = (size_t)L * sizeof(float);
  int warps = kMaxWarps;
  int cached = 1;
  if (per_warp * kMaxWarps > kSmemBudget) {
    warps = (int)(kSmemBudget / per_warp);
    if (warps < 1) {
      warps = kMaxWarps;
      cached = 0;
    }
  }
  const size_t smem = cached ? per_warp * warps : 0;
  const int blocks = (int)(((long long)D + warps - 1) / warps);
  fused_score_topk_kernel<T><<<blocks, warps * kWarp, smem, stream>>>(
      static_cast<const int*>(ids), static_cast<const int*>(counts),
      static_cast<const uint8_t*>(head), static_cast<const int*>(lengths),
      static_cast<const T*>(idf), static_cast<T*>(vals),
      static_cast<int*>(tids), D, L, k, V, cached);
  return (int)cudaGetLastError();
}

}  // namespace

// ids, counts: int32 [D, L]; head: bool [D, L]; lengths: int32 [D];
// idf: [V] in the score dtype (idf_dtype: ScoreCode); vals: [D, k] in
// the score dtype; tids: int32 [D, k]. Requires 1 <= k <= L, D >= 1,
// V >= 1. Returns cudaGetLastError() after the launch.
extern "C" int tfidf_fused_score_topk(const void* ids, const void* counts,
                                      const void* head, const void* lengths,
                                      const void* idf, int idf_dtype,
                                      void* vals, void* tids, int D, int L,
                                      int k, int V, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (idf_dtype) {
    case kFloat32:
      return launch<float>(ids, counts, head, lengths, idf, vals, tids, D, L,
                           k, V, s);
    case kBFloat16:
      return launch<__nv_bfloat16>(ids, counts, head, lengths, idf, vals,
                                   tids, D, L, k, V, s);
    case kFloat16:
      return launch<__half>(ids, counts, head, lengths, idf, vals, tids, D,
                            L, k, V, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
