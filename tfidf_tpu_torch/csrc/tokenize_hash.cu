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
// Bound on this card: memory. The int32 [D, L] ids written, the starts
//   of live slots and the slab read cost more time than the hash, about
//   three 32-bit multiply-adds a byte. What holds the kernel above that
//   bound is latency: each pass waits on lengths, then starts, then the
//   windows, and the hash's byte loop runs as long as the pass's longest
//   token (PERF.md).
// Design (ops/kernels.tokenize_hash_plan sets the launch):
//   * A warp per row: no division, lengths[row] read once. Lane l hashes
//     slots pass * 32 + l: a pass reads the starts of its live slots and
//     writes 32 ids (0 in dead slots) as one 128-byte warp access each,
//     and a pass past the row's length only writes zeros, so a row costs
//     ceil(len / 32) passes of hashing. (Lanes that own 4 consecutive
//     slots, for 16-byte starts and ids, measured slower on the card: a
//     lane then hashes 4 tokens one after the other, and a short row's
//     pass waits for all four.)
//   * Bytes are read as words. Each live token's first window (uint8: the
//     16 bytes from the 8-aligned address at or below its start, two
//     8-byte loads, so at least 9 bytes of the token; int32: the 4
//     elements of its 16-aligned address, one 16-byte load) is shifted so
//     the token's first byte is element 0 (funnel shifts), then hashed
//     from registers at constant extraction positions, the first 9 bytes
//     with no bound test. A token longer than its window loads the next
//     aligned window. Where a window would run past the slab's end, or
//     the slab pointer is not 16-byte aligned, the walk reads one element
//     at a time; no load reads past the slab.
//   * The fold has no 64-bit division: a mask for a power-of-two vocab
//     (the main path's 2^16), else the limb form of
//     ops/device_tokenize.fold_mod, ((f_hi % V) * (2^32 % V) + f_lo % V)
//     % V, each 32-bit remainder by Lemire's multiply with the wrapper's
//     constant ceil(2^64 / V) (exact for every 32-bit operand).
//   * The hash stays native uint64_t FNV-1a64.

#include "common.cuh"

namespace {

constexpr uint64_t kFnvPrime = 1099511628211ull;

__device__ __forceinline__ bool is_space(uint32_t b) {
  return b == 32u || b - 9u <= 4u;
}

// A window: 16 bytes in four little-endian words, element 0 lowest.
template <typename T>
struct Window;

template <>
struct Window<uint8_t> {
  static constexpr int kElems = 16;  // elements a full window holds
  static constexpr int kAlign = 8;   // a window starts at a multiple of it
  static constexpr int kBits = 8;
  __device__ static void load(const uint8_t* p, uint32_t (&w)[4]) {
    const uint2 a = __ldg(reinterpret_cast<const uint2*>(p));
    const uint2 b = __ldg(reinterpret_cast<const uint2*>(p + 8));
    w[0] = a.x; w[1] = a.y; w[2] = b.x; w[3] = b.y;
  }
  __device__ static uint32_t elem(const uint32_t (&w)[4], int i) {
    return (w[i >> 2] >> ((i & 3) * 8)) & 0xffu;
  }
};

template <>
struct Window<int> {
  static constexpr int kElems = 4;
  static constexpr int kAlign = 4;
  static constexpr int kBits = 32;
  __device__ static void load(const int* p, uint32_t (&w)[4]) {
    const int4 a = __ldg(reinterpret_cast<const int4*>(p));
    w[0] = (uint32_t)a.x; w[1] = (uint32_t)a.y;
    w[2] = (uint32_t)a.z; w[3] = (uint32_t)a.w;
  }
  __device__ static uint32_t elem(const uint32_t (&w)[4], int i) {
    return w[i];
  }
};

// w >>= sh bits as one 128-bit value, 0 <= sh < 128.
__device__ __forceinline__ void shift_right(uint32_t (&w)[4], int sh) {
  if (sh & 64) { w[0] = w[2]; w[1] = w[3]; w[2] = 0; w[3] = 0; }
  if (sh & 32) { w[0] = w[1]; w[1] = w[2]; w[2] = w[3]; w[3] = 0; }
  const int r = sh & 31;
  w[0] = __funnelshift_r(w[0], w[1], r);
  w[1] = __funnelshift_r(w[1], w[2], r);
  w[2] = __funnelshift_r(w[2], w[3], r);
  w[3] >>= r;
}

// The token's first window: the aligned window covering slab[s], shifted
// so slab[s] is element 0. Returns the elements it holds from s on, or
// 0 (nothing loaded) when the window would run past n or vec is off.
template <typename T>
__device__ __forceinline__ int first_window(const T* __restrict__ slab,
                                            long long n, long long s,
                                            bool vec, uint32_t (&w)[4]) {
  using W = Window<T>;
  const long long p = s & ~(long long)(W::kAlign - 1);
  if (!vec || p < 0 || p + W::kElems > n) return 0;
  W::load(slab + p, w);
  const int o = (int)(s - p);
  shift_right(w, o * W::kBits);
  return W::kElems - o;
}

// FNV-1a64 of the token at slab[pos], w holding its first avail
// elements (avail may be 0).
template <typename T>
__device__ __forceinline__ uint64_t hash_token(const T* __restrict__ slab,
                                               long long n, long long pos,
                                               uint32_t (&w)[4], int avail,
                                               uint64_t h, int trunc,
                                               bool vec) {
  using W = Window<T>;
  int k = 0;  // elements hashed so far
  // A first window from an aligned load holds at least kSure elements
  // (uint8: 9): hash those with no bound test, then go on as below.
  constexpr int kSure = W::kElems - W::kAlign + 1;
  if (avail >= kSure && (trunc <= 0 || trunc >= kSure)) {
#pragma unroll
    for (int i = 0; i < kSure; ++i) {
      const uint32_t b = W::elem(w, i);
      if (is_space(b)) return h;
      h = (h ^ (uint64_t)b) * kFnvPrime;
    }
    shift_right(w, kSure * W::kBits);
    avail -= kSure;
    k = kSure;
    pos += kSure;
  }
  for (;;) {
    int lim = avail;
    if (trunc > 0 && trunc - k < lim) lim = trunc - k;
#pragma unroll
    for (int i = 0; i < W::kElems; ++i) {
      if (i >= lim) break;
      const uint32_t b = W::elem(w, i);
      if (is_space(b)) return h;
      h = (h ^ (uint64_t)b) * kFnvPrime;
    }
    k += lim;
    pos += lim;
    if (lim < avail || (trunc > 0 && k >= trunc) || pos >= n) return h;
    if (vec && (pos & (W::kAlign - 1)) == 0 && pos + W::kElems <= n) {
      W::load(slab + pos, w);
      avail = W::kElems;
    } else {
      w[0] = (uint32_t)slab[pos];
      avail = 1;
    }
  }
}

struct Fold {
  uint32_t mask;    // V - 1 when V is a power of two, else 0
  uint32_t v;       // V
  uint32_t m32;     // 2^32 % V
  uint64_t magic;   // ceil(2^64 / V) mod 2^64 (Lemire's fastmod)
};

// a % V for any 32-bit a (Lemire, Kaser and Kurz, "Faster remainder by
// direct computation", 2019).
__device__ __forceinline__ uint32_t fastmod(uint32_t a, const Fold& f) {
  return (uint32_t)__umul64hi(f.magic * a, (uint64_t)f.v);
}

__device__ __forceinline__ int fold(uint64_t h, const Fold& f) {
  const uint32_t f_hi = (uint32_t)(h >> 32);
  const uint32_t f_lo = (uint32_t)h ^ f_hi;
  if (f.mask || f.v == 1) return (int)(f_lo & f.mask);
  // a, m32, b < V <= 2^16: a * m32 + b < 2^32
  return (int)fastmod(fastmod(f_hi, f) * f.m32 + fastmod(f_lo, f), f);
}

// A warp per row: lane l hashes slots j = pass * 32 + l, so each warp
// load of starts and store of ids covers 128 contiguous bytes, and a pass
// past the row's length only stores zeros.
template <typename T>
__global__ void tokenize_hash_kernel(const T* __restrict__ slab, long long n,
                                     const int* __restrict__ starts,
                                     const int* __restrict__ lengths,
                                     int* __restrict__ ids, int d,
                                     int length, uint64_t seed_state,
                                     Fold f, int trunc, int vec_flag) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (blockDim.x >> 5) +
                        (threadIdx.x >> 5);
  if (row >= d) return;
  const bool vec = vec_flag != 0;
  const int len = lengths[row];
  const int* __restrict__ srow = starts + row * length;
  int* __restrict__ orow = ids + row * length;
  for (int j = lane; j < length; j += 32) {
    int id = 0;
    if (j < len) {
      const int s = __ldg(srow + j);
      uint32_t w[4];
      const int avail = first_window(slab, n, s, vec, w);
      id = fold(hash_token(slab, n, s, w, avail, seed_state, trunc, vec), f);
    }
    orow[j] = id;
  }
}

}  // namespace

// Slab dtype codes (ops/kernels.py _SLAB_CODES).
enum SlabCode { kSlabUInt8 = 0, kSlabInt32 = 1 };

// slab: [n] uint8 or int32 (slab_dtype: SlabCode); starts: int32 [D, L];
// lengths: int32 [D]; ids: int32 [D, L]. seed_state = FNV_OFFSET ^ seed;
// m32 = 2^32 % V and magic = ceil(2^64 / V) mod 2^64
// (ops/kernels.tokenize_fold_constants). warps (rows per block) and vec
// (1: window loads; the slab is 16-byte aligned) come from
// ops/kernels.tokenize_hash_plan. Requires D >= 1, L >= 1, n >= 1,
// 1 <= vocab_size <= 2^16. Returns cudaGetLastError().
extern "C" int tfidf_tokenize_hash(const void* slab, int slab_dtype,
                                   long long n, const void* starts,
                                   const void* lengths, void* ids, int d,
                                   int length, uint64_t seed_state,
                                   int vocab_size, unsigned int m32,
                                   unsigned long long magic, int truncate_at,
                                   int warps, int vec, void* stream) {
  if (vocab_size < 1 || vocab_size > (1 << 16) || warps < 1 || warps > 32)
    return (int)cudaErrorInvalidValue;
  const uint32_t v = (uint32_t)vocab_size;
  const Fold f{(v & (v - 1)) == 0 ? v - 1 : 0u, v, m32, (uint64_t)magic};
  const unsigned blocks = (unsigned)((d + warps - 1) / warps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (slab_dtype) {
    case kSlabUInt8:
      tokenize_hash_kernel<uint8_t><<<blocks, warps * 32, 0, s>>>(
          static_cast<const uint8_t*>(slab), n,
          static_cast<const int*>(starts), static_cast<const int*>(lengths),
          static_cast<int*>(ids), d, length, seed_state, f, truncate_at, vec);
      break;
    case kSlabInt32:
      tokenize_hash_kernel<int><<<blocks, warps * 32, 0, s>>>(
          static_cast<const int*>(slab), n, static_cast<const int*>(starts),
          static_cast<const int*>(lengths), static_cast<int*>(ids), d, length,
          seed_state, f, truncate_at, vec);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
