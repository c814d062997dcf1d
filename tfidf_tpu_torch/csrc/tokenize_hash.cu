// Tokenize+hash: per-token seeded FNV-1a64 over a raw byte slab.
//
// Replaces: tfidf_tpu/ops/pallas_kernels.py, tokenize_hash_pallas
//   (kernel body _tokenize_hash_kernel), and the XLA while_loop it stands
//   beside (tfidf_tpu/ops/device_tokenize.py hash_tokens_xla).
// Contract (native/tokenize_common.h HashWord / FoldToVocab): for slot
//   j < lengths[d] of doc d, h = FNV_OFFSET ^ seed, then for each byte
//   from starts[d, j] on: stop at whitespace (32, 9..13), at the slab's
//   end, or after truncate_at bytes when truncate_at > 0; else
//   h ^= byte; h *= FNV_PRIME (mod 2^64). The id is (h ^ (h >> 32)) %
//   vocab_size. Slots at or past lengths[d] are 0. Bytes are read as
//   unsigned (uint8 slab as shipped) or as the int32 values of the JAX
//   signature's upcast slab.
// Bound on this card: memory. The work per byte is one xor and one
//   64-bit multiply by a constant (about three 32-bit integer
//   multiply-adds); the slab, the [D, L] starts and the [D, L] ids cost
//   more time to move than that arithmetic does.
// Design: one thread per (doc, slot) runs the token's byte loop in
//   native uint64_t arithmetic (the TPU kernel emulates it in uint32
//   limbs). A warp's 32 slots are 32 neighbouring tokens, so its byte
//   reads fall in a few cache lines of the slab.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr uint64_t kFnvPrime = 1099511628211ull;

__device__ __forceinline__ bool is_space(int b) {
  return b == 32 || (b >= 9 && b <= 13);
}

template <typename T>
__global__ void tokenize_hash_kernel(const T* __restrict__ slab, long long n,
                                     const int* __restrict__ starts,
                                     const int* __restrict__ lengths,
                                     int* __restrict__ ids, int length,
                                     uint64_t seed_state, int vocab_size,
                                     int truncate_at, long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int row = (int)(i / length);
  const int j = (int)(i - (long long)row * length);
  if (j >= lengths[row]) {
    ids[i] = 0;
    return;
  }
  const long long start = starts[i];
  uint64_t h = seed_state;
  for (long long k = 0;; ++k) {
    if (truncate_at > 0 && k >= truncate_at) break;
    const long long pos = start + k;
    if (pos >= n) break;
    const int b = (int)slab[pos];
    if (is_space(b)) break;
    h ^= (uint64_t)(uint32_t)b;
    h *= kFnvPrime;
  }
  const uint64_t folded = h ^ (h >> 32);
  ids[i] = (int)(folded % (uint64_t)vocab_size);
}

template <typename T>
int launch(const void* slab, long long n, const void* starts,
           const void* lengths, void* ids, int d, int length,
           uint64_t seed_state, int vocab_size, int truncate_at,
           cudaStream_t stream) {
  const long long total = (long long)d * length;
  const long long blocks = (total + kThreads - 1) / kThreads;
  tokenize_hash_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(slab), n, static_cast<const int*>(starts),
      static_cast<const int*>(lengths), static_cast<int*>(ids), length,
      seed_state, vocab_size, truncate_at, total);
  return (int)cudaGetLastError();
}

}  // namespace

// Slab dtype codes (ops/kernels.py _SLAB_CODES).
enum SlabCode { kSlabUInt8 = 0, kSlabInt32 = 1 };

// slab: [n] uint8 or int32 (slab_dtype: SlabCode); starts: int32 [D, L];
// lengths: int32 [D]; ids: int32 [D, L]. seed_state = FNV_OFFSET ^ seed.
// Requires D >= 1, L >= 1, n >= 1, vocab_size >= 1. Returns
// cudaGetLastError().
extern "C" int tfidf_tokenize_hash(const void* slab, int slab_dtype,
                                   long long n, const void* starts,
                                   const void* lengths, void* ids, int d,
                                   int length, uint64_t seed_state,
                                   int vocab_size, int truncate_at,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (slab_dtype) {
    case kSlabUInt8:
      return launch<uint8_t>(slab, n, starts, lengths, ids, d, length,
                             seed_state, vocab_size, truncate_at, s);
    case kSlabInt32:
      return launch<int>(slab, n, starts, lengths, ids, d, length,
                         seed_state, vocab_size, truncate_at, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
