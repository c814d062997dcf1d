// Tile scores: one doc tile's retrieval similarities against a query block,
//   sims[r, q] = sum over l of data[r, l] * qmat[cols[r, l], q].
//
// Replaces: tfidf_tpu/ops/pallas_kernels.py, tile_scores_pallas (kernel
//   body _tile_scores_kernel): the BCOO sparse x dense dot of one score
//   tile inside ops.sparse.score_topk_tiled, for every scorer (the face
//   decides what data and cols hold) and on the untiled path too.
// Contract: data float32 [R, L], cols int32 [R, L] with every value in
//   [0, V) (not checked on the device), qmat float32 [V, Q] -> out float32
//   [R, Q]. Dead slots carry data == 0 and add nothing, so no head mask is
//   needed; a row of zeros (padding, a ragged last tile) scores exactly 0.
//   The sum runs over l in ascending order as __fadd_rn(acc, __fmul_rn(w,
//   q)): two roundings per slot and no FMA contraction, so the result
//   equals the plain version (ops/kernels.py tile_scores_plain, one
//   multiply and one add per slot in l order) bit for bit. Skipping a
//   slot whose weight is 0 is exact for finite qmat: 0 * q = +-0, the sum
//   starts at +0 and never becomes -0, and acc + +-0 = acc.
// Bound on this card: memory. Each live slot gathers one qmat row strip
//   (Q floats) for one multiply-add per float, so the operations are one
//   FMA per 4 bytes gathered; the TPU kernel keeps the whole [V, Q] block
//   in VMEM, which at V = 2^16 and Q = 256 is 64 MB, past any shared
//   memory and past the 50 MB L2. Here qmat stays in device memory and is
//   read through L2, where the columns that many rows share (Zipf head
//   terms) stay resident.
// Design: one warp per row, its lanes on 32 consecutive query columns (a
//   grid axis walks the Q strips), so each gathered strip qmat[c, q0:q0+32]
//   is one coalesced 128-byte read. The lanes load 32 (data, cols) slots
//   at a time, coalesced; a ballot of the non-zero weights gives the live
//   slots, which the warp visits in ascending l, broadcasting each slot
//   with __shfl_sync (the branch is warp-uniform). The sum stays in a
//   register and is stored once. At Q < 32 most lanes idle (a later PR
//   puts several rows on one warp there).

#include "common.cuh"

namespace {

constexpr int kWarps = 8;  // rows per block
constexpr unsigned kFull = 0xffffffffu;

__global__ void tile_scores_kernel(const float* __restrict__ data,
                                   const int* __restrict__ cols,
                                   const float* __restrict__ qmat,
                                   float* __restrict__ out, int rows,
                                   int length, int q) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves together
  const int col = blockIdx.y * 32 + lane;
  const bool in_q = col < q;
  const float* drow = data + (long long)row * length;
  const int* crow = cols + (long long)row * length;
  float acc = 0.0f;
  for (int l0 = 0; l0 < length; l0 += 32) {
    const int l = l0 + lane;
    float w = 0.0f;
    int c = 0;
    if (l < length) {
      w = drow[l];
      c = crow[l];
    }
    unsigned live = __ballot_sync(kFull, w != 0.0f);  // NaN counts as live
    while (live) {
      const int j = __ffs(live) - 1;
      live &= live - 1;
      const float wj = __shfl_sync(kFull, w, j);
      const int cj = __shfl_sync(kFull, c, j);
      if (in_q) {
        const float qv = __ldg(qmat + (long long)cj * q + col);
        acc = __fadd_rn(acc, __fmul_rn(wj, qv));
      }
    }
  }
  if (in_q) out[(long long)row * q + col] = acc;
}

}  // namespace

// data: float32 [rows, length]; cols: int32 [rows, length]; qmat: float32
// [V, q]; out: float32 [rows, q]. Requires rows >= 1, q >= 1, length >= 0.
// Returns cudaGetLastError().
extern "C" int tfidf_tile_scores(const void* data, const void* cols,
                                 const void* qmat, void* out, int rows,
                                 int length, int q, void* stream) {
  if (rows < 1 || q < 1 || length < 0) return (int)cudaErrorInvalidValue;
  const unsigned strips = (unsigned)((q + 31) / 32);
  if (strips > 65535u) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)((rows + kWarps - 1) / kWarps), strips);
  tile_scores_kernel<<<grid, kWarps * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(data), static_cast<const int*>(cols),
      static_cast<const float*>(qmat), static_cast<float*>(out), rows,
      length, q);
  return (int)cudaGetLastError();
}
