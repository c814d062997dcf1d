// Ragged rebuild: granule-aligned flat id stream -> padded int32 [D, L].
//
// Replaces: tfidf_tpu/ops/pallas_kernels.py, ragged_rebuild_pallas
//   (kernel body _rebuild_kernel), and the XLA granule gather it stands
//   beside (tfidf_tpu/ingest.py _ragged_to_padded).
// Contract: the flat stream holds each doc's ids from granule offg[d] on,
//   offg = exclusive prefix sum of ceil(max(len, 0) / G) (computed by the
//   wrapper, ops/kernels.py). out[d, j] = flat[min(offg[d] + j / G,
//   ngran - 1) * G + j % G], widened to int32, for EVERY j < L: the
//   padding slots carry the same clamped values as the XLA lowering, so
//   the whole [D, L] equals it, not only the live slots. G is any power
//   of two from 1 (the legacy back-to-back layout) up.
// Bound on this card: memory. Each output element is one 2- or 4-byte
//   read and one 4-byte write; there is no arithmetic to speak of.
// Design: one thread per output element, row-major, so a warp reads a
//   granule-contiguous run of the stream and writes 32 consecutive ids
//   (both coalesced); the uint16 -> int32 widening happens in registers.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void ragged_rebuild_kernel(const T* __restrict__ flat,
                                      const int* __restrict__ offg,
                                      int* __restrict__ out, int length,
                                      int shift, long long ngran,
                                      long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int row = (int)(i / length);
  const int j = (int)(i - (long long)row * length);
  long long gran = (long long)offg[row] + (j >> shift);
  if (gran > ngran - 1) gran = ngran - 1;
  const long long src = (gran << shift) + (j & ((1 << shift) - 1));
  out[i] = (int)flat[src];
}

template <typename T>
int launch(const void* flat, const void* offg, void* out, int d, int length,
           int shift, long long ngran, cudaStream_t stream) {
  const long long total = (long long)d * length;
  const long long blocks = (total + kThreads - 1) / kThreads;
  ragged_rebuild_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(flat), static_cast<const int*>(offg),
      static_cast<int*>(out), length, shift, ngran, total);
  return (int)cudaGetLastError();
}

}  // namespace

// flat: [ngran * align] int32 or uint16 (flat_dtype: TokenCode); offg:
// int32 [D]; out: int32 [D, L]. align must be a power of two; requires
// D >= 1, L >= 1, ngran >= 1. Returns cudaGetLastError().
extern "C" int tfidf_ragged_rebuild(const void* flat, int flat_dtype,
                                    const void* offg, void* out, int d,
                                    int length, int align, long long ngran,
                                    void* stream) {
  if (align < 1 || (align & (align - 1)) != 0) return (int)cudaErrorInvalidValue;
  int shift = 0;
  while ((1 << shift) < align) ++shift;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (flat_dtype) {
    case kInt32:
      return launch<int>(flat, offg, out, d, length, shift, ngran, s);
    case kUInt16:
      return launch<uint16_t>(flat, offg, out, d, length, shift, ngran, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
