// Dense TF histogram + DF in one pass.
//
// Replaces: tfidf_tpu/ops/pallas_kernels.py, tf_df_pallas (kernel bodies
//   _hist_kernel, _hist_kernel_counts_only, _tile_counts).
// Contract: counts[d, v] = number of slots pos < len[d] whose
//   id - id_offset == v, for v in [0, V); other ids are dropped.
//   df[v] = number of docs with counts[d, v] > 0 (skipped when df is
//   null, the with_df=False variant). Ids are widened to 64 bits before
//   the offset is subtracted, so a uint16 id cannot wrap.
// Bound on this card: memory. The D x V x 4 bytes of counts are written
//   (and zero-filled by the wrapper first), the D x L token ids read once.
//   The TPU kernel's compare-and-reduce does O(L x V) work per doc; here
//   each valid token is one integer atomic, O(L) per doc.
// Design: one block per doc; each thread takes strided token slots and
//   adds 1 to counts[d, id] with an atomic. The atomic returns the old
//   count, so the thread that finds 0 is the doc's first occurrence of
//   the word and adds exactly one to df[id]. Integer atomics make the
//   result exact and independent of order. Known cost: the DF atomics of
//   the Zipf-head words contend across docs, and counts take a separate
//   zero-fill pass; a per-block shared-memory row would remove both.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;

template <typename Tok>
__global__ void tf_df_kernel(const Tok* __restrict__ tokens,
                             const int* __restrict__ lengths,
                             int* __restrict__ counts, int* __restrict__ df,
                             int L, int V, long long id_offset) {
  const size_t d = blockIdx.x;
  const int len = min(lengths[d], L);
  const Tok* row = tokens + d * (size_t)L;
  int* crow = counts + d * (size_t)V;
  for (int i = threadIdx.x; i < len; i += blockDim.x) {
    const long long local = (long long)row[i] - id_offset;
    if (local < 0 || local >= V) continue;
    const int old = atomicAdd(crow + local, 1);
    if (df != nullptr && old == 0) atomicAdd(df + local, 1);
  }
}

template <typename Tok>
int launch(const void* tokens, const void* lengths, void* counts, void* df,
           int D, int L, int V, long long id_offset, cudaStream_t stream) {
  tf_df_kernel<Tok><<<D, kThreads, 0, stream>>>(
      static_cast<const Tok*>(tokens), static_cast<const int*>(lengths),
      static_cast<int*>(counts), static_cast<int*>(df), L, V, id_offset);
  return (int)cudaGetLastError();
}

}  // namespace

// tokens: [D, L] int32 or uint16 (token_dtype: TokenCode); lengths:
// int32 [D]; counts: int32 [D, V] and df: int32 [V] (or null), both
// zero-filled by the caller. Requires D >= 1. Returns cudaGetLastError().
extern "C" int tfidf_tf_df(const void* tokens, int token_dtype,
                           const void* lengths, void* counts, void* df,
                           int D, int L, int V, long long id_offset,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (token_dtype) {
    case kInt32:
      return launch<int>(tokens, lengths, counts, df, D, L, V, id_offset, s);
    case kUInt16:
      return launch<uint16_t>(tokens, lengths, counts, df, D, L, V, id_offset,
                              s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
