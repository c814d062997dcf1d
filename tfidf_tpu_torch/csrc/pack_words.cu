// Packed result words: one uint32 per top-k slot.
//
// Replaces: tfidf_tpu/ops/pallas_kernels.py, pack_words_pallas (kernel
//   body _pack_words_kernel).
// Contract (tfidf_tpu/ops/downlink.py): word = (16-bit score bits) << 16
//   | uint16(tid). float32 scores round to float16 to nearest even
//   (overflow becomes inf, NaN stays NaN); float16 and bfloat16 scores
//   keep their bits. tid < 0 packs the bits of score -1 (0xBC00 float16,
//   0xBF80 bfloat16) and id 0.
// Bound on this card: memory, 12 bytes per word (8 read, 4 written; 10
//   for 16-bit scores). At the main path's 32,768 x 16 words that is
//   about 6 MB, under two microseconds, so the launch and one round trip
//   to memory are most of the time; folding the pack into the score+top-k
//   kernel's epilogue is the way to remove those.
// Design: one thread packs 4 consecutive words: one 16-byte load of tids,
//   one 16-byte (float32) or 8-byte (16-bit) load of scores, one 16-byte
//   store, so a warp moves 512 contiguous bytes of words per instruction.
//   The grid is one wave (ops/kernels.pack_words_plan), striding when n
//   is larger. The words before the first group whose three addresses are
//   all aligned (head) and the n % 4 after the last (tail) are packed one
//   at a time; when the three pointers are misaligned from each other,
//   every word is (head = n).

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// The score's 16 bits: float32 rounds to float16; float16 and bfloat16
// scores (or their raw bits, as the vector path loads them) as stored.
__device__ __forceinline__ uint32_t bits16(float v) {
  return __half_as_ushort(__float2half_rn(v));
}
__device__ __forceinline__ uint32_t bits16(__nv_bfloat16 v) {
  return __bfloat16_as_ushort(v);
}
__device__ __forceinline__ uint32_t bits16(__half v) {
  return __half_as_ushort(v);
}
__device__ __forceinline__ uint32_t bits16(uint16_t v) { return v; }

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
__device__ __forceinline__ uint32_t word(uint32_t score_bits, int t) {
  return t >= 0 ? (score_bits << 16) | ((uint32_t)t & 0xFFFFu)
                : minus_one_bits<T>() << 16;
}

// Four consecutive scores from a group-aligned address: float32 as one
// 16-byte load, 16-bit scores as their raw bits in one 8-byte load.
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}
template <typename T>
__device__ __forceinline__ void load4(const T* p, uint16_t (&v)[4]) {
  const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
  v[0] = (uint16_t)(x.x & 0xFFFFu); v[1] = (uint16_t)(x.x >> 16);
  v[2] = (uint16_t)(x.y & 0xFFFFu); v[3] = (uint16_t)(x.y >> 16);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
pack_words_kernel(const T* __restrict__ vals, const int* __restrict__ tids,
                  uint32_t* __restrict__ words, long long n, long long head,
                  long long groups) {
  using S = typename std::conditional<std::is_same<T, float>::value, float,
                                      uint16_t>::type;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long step = (long long)gridDim.x * kThreads;
  for (long long g = first; g < groups; g += step) {
    const long long i = head + 4 * g;
    S v[4];
    load4(vals + i, v);
    const int4 t = __ldg(reinterpret_cast<const int4*>(tids + i));
    const uint4 w = make_uint4(
        word<T>(bits16(v[0]), t.x), word<T>(bits16(v[1]), t.y),
        word<T>(bits16(v[2]), t.z), word<T>(bits16(v[3]), t.w));
    *reinterpret_cast<uint4*>(words + i) = w;
  }
  const long long tail0 = head + 4 * groups;
  for (long long e = first; e < head; e += step)
    words[e] = word<T>(bits16(vals[e]), tids[e]);
  for (long long e = tail0 + first; e < n; e += step)
    words[e] = word<T>(bits16(vals[e]), tids[e]);
}

template <typename T>
int launch(const void* vals, const void* tids, void* words, long long n,
           long long head, long long groups, int blocks, cudaStream_t stream) {
  if (groups > 0) {
    // The plan's groups must start on aligned addresses.
    const uintptr_t v =
        reinterpret_cast<uintptr_t>(static_cast<const T*>(vals) + head);
    const uintptr_t t =
        reinterpret_cast<uintptr_t>(static_cast<const int*>(tids) + head);
    const uintptr_t w =
        reinterpret_cast<uintptr_t>(static_cast<uint32_t*>(words) + head);
    if (v % (4 * sizeof(T)) != 0 || t % 16 != 0 || w % 16 != 0)
      return (int)cudaErrorMisalignedAddress;
  }
  pack_words_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(vals), static_cast<const int*>(tids),
      static_cast<uint32_t*>(words), n, head, groups);
  return (int)cudaGetLastError();
}

}  // namespace

// vals: [n] float32, bfloat16 or float16 (val_dtype: ScoreCode); tids:
// int32 [n]; words: uint32 [n]. The plan (ops/kernels.pack_words_plan):
// head words packed one at a time, then groups of 4 from word head on
// (their addresses aligned), then the tail; blocks of 256 threads.
// Requires n >= 1. Returns cudaGetLastError() (cudaErrorMisalignedAddress
// when the groups' addresses are not aligned).
extern "C" int tfidf_pack_words(const void* vals, int val_dtype,
                                const void* tids, void* words, long long n,
                                long long head, long long groups, int blocks,
                                void* stream) {
  if (n < 1 || head < 0 || groups < 0 || head + 4 * groups > n || blocks < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (val_dtype) {
    case kFloat32:
      return launch<float>(vals, tids, words, n, head, groups, blocks, s);
    case kBFloat16:
      return launch<__nv_bfloat16>(vals, tids, words, n, head, groups, blocks,
                                   s);
    case kFloat16:
      return launch<__half>(vals, tids, words, n, head, groups, blocks, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
