// Packed result words: one uint32 per top-k slot.
//
// Replaces: tfidf_tpu/ops/pallas_kernels.py, pack_words_pallas (kernel
//   body _pack_words_kernel).
// Contract (tfidf_tpu/ops/downlink.py): word = (16-bit score bits) << 16
//   | uint16(tid). float32 scores round to float16 to nearest even
//   (overflow becomes inf, NaN stays NaN); float16 and bfloat16 scores
//   keep their bits. tid < 0 packs the bits of score -1 (0xBC00 float16,
//   0xBF80 bfloat16) and id 0.
// Bound on this card: memory, 12 bytes per word (8 read, 4 written). At
//   the main path's 32,768 x 16 words that is about 6 MB, a couple of
//   microseconds, so the launch itself dominates; folding the pack into
//   the score+top-k kernel's epilogue is the way to remove it.
// Design: one thread per word.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t bits16(float v) {
  return __half_as_ushort(__float2half_rn(v));
}
__device__ __forceinline__ uint32_t bits16(__nv_bfloat16 v) {
  return __bfloat16_as_ushort(v);
}
__device__ __forceinline__ uint32_t bits16(__half v) {
  return __half_as_ushort(v);
}

template <typename T>
__device__ __forceinline__ uint32_t minus_one_bits();
template <>
__device__ __forceinline__ uint32_t minus_one_bits<float>() { return 0xBC00u; }
template <>
__device__ __forceinline__ uint32_t minus_one_bits<__nv_bfloat16>() {
  return 0xBF80u;
}
template <>
__device__ __forceinline__ uint32_t minus_one_bits<__half>() { return 0xBC00u; }

template <typename T>
__global__ void pack_words_kernel(const T* __restrict__ vals,
                                  const int* __restrict__ tids,
                                  uint32_t* __restrict__ words, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int t = tids[i];
  const uint32_t hi = t >= 0 ? bits16(vals[i]) : minus_one_bits<T>();
  const uint32_t lo = t >= 0 ? ((uint32_t)t & 0xFFFFu) : 0u;
  words[i] = (hi << 16) | lo;
}

template <typename T>
int launch(const void* vals, const void* tids, void* words, long long n,
           cudaStream_t stream) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  pack_words_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(vals), static_cast<const int*>(tids),
      static_cast<uint32_t*>(words), n);
  return (int)cudaGetLastError();
}

}  // namespace

// vals: [n] float32, bfloat16 or float16 (val_dtype: ScoreCode); tids: int32 [n];
// words: uint32 [n]. Requires n >= 1. Returns cudaGetLastError().
extern "C" int tfidf_pack_words(const void* vals, int val_dtype,
                                const void* tids, void* words, long long n,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (val_dtype) {
    case kFloat32:
      return launch<float>(vals, tids, words, n, s);
    case kBFloat16:
      return launch<__nv_bfloat16>(vals, tids, words, n, s);
    case kFloat16:
      return launch<__half>(vals, tids, words, n, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
