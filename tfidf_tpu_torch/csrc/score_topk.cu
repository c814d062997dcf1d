// Fused tf*idf scoring + per-document top-k over the sorted triples.
//
// Replaces: tfidf_tpu/ops/pallas_kernels.py, fused_score_topk_pallas
//   (kernel body _fused_score_topk_kernel).
// Contract (the sparse_topk contract of tfidf_tpu/ops/sparse.py):
//   score[d,i] = float(counts[d,i]) / float(max(len[d],1)) * idf[ids[d,i]]
//   at head slots, finfo(dtype).min elsewhere, each op rounded in the
//   score dtype; then k = min(k, L) picks in order (score desc, slot asc)
//   — lax.top_k's tie order, and torch.sort(descending, stable)'s, which
//   the plain version uses: NaN first, -0.0 equal to +0.0; a pick that is
//   not above finfo.min decodes to (0, -1).
// Bound on this card: memory. Each row's head (bool) is read once and
//   its ids and counts at head slots only; the [V] idf table (256 KB at
//   2^16 float32) stays in L2; outputs are 8 bytes per pick. In all
//   21.7 MB, 6.5 us, at D 32,768, L 256, k 16 on the Zipf batch (34 head
//   slots a row).
//   So the work that counts is per head slot, not per slot: a selection
//   that scans all L slots per pick (16 x 256 compares a row) or reads
//   head a byte at a time cannot come near it.
// Design: one warp per row, two rows a block.
//   * Compact first. The lanes read head 8 or 16 bytes at a time (HV
//     slots per lane) and turn it into a bit mask; a warp prefix of the
//     masks' popcounts gives each head slot its place, in slot order, in
//     the warp's slice of shared memory. Only head slots load their ids
//     and counts and gather idf; the score keeps the rounding chain
//     (round_to<T> after every op). Rows with no head slot write k x
//     (0, -1) and leave.
//   * Select from a total order packed into integers: order_key maps a
//     score to a uint32 that sorts like torch.sort (ops/kernels.py
//     topk_order_key, mirrored line for line), and the 64-bit composite
//     (key << 32 | ~pos) makes "larger" mean (score desc, slot asc), with
//     pos the compacted position (ascending with the slot).
//     - n <= 32 head slots (58% of the Zipf batch's rows): one candidate
//       per lane, a 32-wide bitonic sort by shuffles, and lane j writes
//       pick j.
//     - 32 < n <= cap: each lane scores and sorts its strided candidates
//       in its own column of shared memory (insertion sort; no other lane
//       touches it), then each round takes the warp maximum of the lanes'
//       heads with __reduce_max_sync on the key and __reduce_min_sync on
//       the position among the lanes that hold it; the winner pops, and
//       lane r % 32 keeps pick r, so picks are written 32 at a time.
//     - n > cap, rows read 16 slots a lane (L >= 512, L % 16 == 0,
//       16-byte aligned; there cap = max(32 k, 512), 10 KB a warp at
//       k 16, so an SM holds four times the warps of a 2,048 list) and
//       k <= 64: one more pass over the row, each lane loading its
//       16 slots' ids and counts in 16-byte loads, gathering every head
//       slot's idf at once and keeping the top k of what it read in a
//       sorted column of the composite buffer (a candidate below the
//       column's k-th is dropped after one compare); then the rounds of
//       warp max and pop above over those columns, a pick's score and
//       id recomputed from its slot. The global top k lies in the union
//       of the lanes'. Otherwise every round rescans the row's head
//       slots from global memory (L2) for the largest composite below
//       the last pick (cap = 2,048, 40 KB a warp). The narrower reads
//       keep the short-row kernels' registers (and occupancy) as they
//       were.
//   Picks past the row's head count, and picks not above finfo.min, are
//   (0, -1).
//   What is left: chip_smoke.py times B1 with no head slot at all (one
//   256-byte head read and the picks' writes per warp: the loads'
//   latency, not their bytes) and at k 1 and 64 (the rounds of the rows
//   over 32 head slots); PERF.md has the split. Tried on the card and
//   dropped: persistent warps that load the next row's head while the
//   current one is selected (slower than the hardware's own block
//   scheduling), and 4 or 8 warps a block. cp.async/TMA staging does not
//   fit: each row's bytes are read once, straight into registers.

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
// Warps (rows) per block: 2 ran as fast as 1 and faster than 4 or 8 on
// the card.
constexpr int kMaxWarps = 2;
constexpr int kCapMax = 2048;
// The list of rows that have the column path (below): 10 KB a warp.
constexpr int kColumnCap = 512;
constexpr size_t kEntry = sizeof(unsigned long long) + sizeof(float) +
                          2 * sizeof(int);  // composite, score, id, slot
constexpr size_t kSmemBudget = 48 * 1024;

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

// An order-preserving uint32 of a score: larger key = earlier in
// torch.sort(descending=True). NaN sorts first; -0.0 and +0.0 are equal.
__device__ __forceinline__ unsigned order_key(float s) {
  if (s != s) return 0xffffffffu;
  const unsigned b = __float_as_uint(s == 0.0f ? 0.0f : s);
  return b ^ ((b & 0x80000000u) ? 0xffffffffu : 0x80000000u);
}

__device__ __forceinline__ unsigned long long composite(float s, int pos) {
  return ((unsigned long long)order_key(s) << 32) |
         (0xffffffffu - (unsigned)pos);
}

template <typename T>
__device__ __forceinline__ float head_score(int id, int count, float len,
                                            const T* __restrict__ idf,
                                            int V) {
  // Clamp like jnp indexing: a head id is a vocab id by construction.
  id = min(max(id, 0), V - 1);
  const float tf = round_to<T>(round_to<T>((float)count) / len);
  return round_to<T>(tf * to_float(idf[id]));
}

// Bit j set where head[j] != 0, for HV consecutive bools (HV-aligned).
template <int HV>
__device__ __forceinline__ unsigned head_bits(const uint8_t* p) {
  if constexpr (HV == 1) {
    return p[0] != 0;
  } else {
    unsigned w[HV / 4];
    if constexpr (HV == 16) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
      w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    } else if constexpr (HV == 8) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
      w[0] = v.x; w[1] = v.y;
    } else {
      w[0] = __ldg(reinterpret_cast<const unsigned*>(p));
    }
    unsigned bits = 0;
#pragma unroll
    for (int i = 0; i < HV / 4; ++i) {
      // Fold each byte's bits into its bit 0, then gather the four bit 0s
      // into bits 24..27 with one multiply (no carries: the products land
      // on distinct bits).
      unsigned x = w[i] | (w[i] >> 4);
      x |= x >> 2;
      x |= x >> 1;
      bits |= (((x & 0x01010101u) * 0x01020408u) >> 24 & 0xfu) << (4 * i);
    }
    return bits;
  }
}

template <typename T>
__device__ __forceinline__ void write_pick(float s, int id, float neg, T* v,
                                           int* t, int j) {
  const bool ok = s > neg;  // false for NaN and finfo.min
  v[j] = from_float<T>(ok ? s : 0.f);  // s is already a T value
  t[j] = ok ? id : -1;
}

template <typename T>
__device__ __forceinline__ void write_none(T* v, int* t, int j) {
  v[j] = from_float<T>(0.f);
  t[j] = -1;
}

template <typename T, int HV>
__global__ void fused_score_topk_kernel(
    const int* __restrict__ ids, const int* __restrict__ counts,
    const uint8_t* __restrict__ head, const int* __restrict__ lengths,
    const T* __restrict__ idf, T* __restrict__ vals, int* __restrict__ tids,
    int D, int L, int k, int V, int cap) {
  extern __shared__ unsigned long long smem[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * warps + warp;
  if (row >= D) return;  // uniform across the warp
  // Per warp: composites, scores, ids and head slots, cap of each.
  unsigned long long* comp = smem + (size_t)warp * cap;
  float* sc = reinterpret_cast<float*>(smem + (size_t)warps * cap) +
              (size_t)warp * cap;
  int* sid = reinterpret_cast<int*>(sc - (size_t)warp * cap +
                                    (size_t)warps * cap) +
             (size_t)warp * cap;
  int* slot = sid + (size_t)warps * cap;
  const size_t base = (size_t)row * L;
  const float len = round_to<T>((float)max(lengths[row], 1));
  const float neg = lowest<T>();
  T* vrow = vals + (size_t)row * k;
  int* trow = tids + (size_t)row * k;

  // --- compact the head slots, in slot order ------------------------
  int n = 0;
  for (int l0 = 0; l0 < L; l0 += 32 * HV) {
    const int l = l0 + lane * HV;
    unsigned mask = l < L ? head_bits<HV>(head + base + l) : 0u;
    const int cnt = __popc(mask);
    int incl = cnt;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += o;
    }
    for (int p = n + incl - cnt; mask; mask &= mask - 1, ++p)
      if (p < cap) slot[p] = l + __ffs(mask) - 1;
    n += __shfl_sync(kFull, incl, 31);
  }
  __syncwarp();

  if (n == 0) {
    for (int j = lane; j < k; j += 32) write_none(vrow, trow, j);
    return;
  }

  if (n <= 32) {
    // --- one candidate per lane: bitonic sort, descending ------------
    float s = 0.f;
    int id = -1;
    unsigned long long c = 0ull;
    if (lane < n) {
      const int at = slot[lane];
      id = ids[base + at];
      s = head_score<T>(id, counts[base + at], len, idf, V);
      c = composite(s, lane);
    }
#pragma unroll
    for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        const unsigned long long o = __shfl_xor_sync(kFull, c, stride);
        const bool keep_max = ((lane & stride) == 0) == ((lane & size) == 0);
        c = keep_max ? (c > o ? c : o) : (c < o ? c : o);
      }
    }
    // Lane j now holds pick j's composite; its score and id are in the
    // lane of its position.
    const int src = lane < n ? (int)(0xffffffffu - (unsigned)c) : lane;
    const float ps = __shfl_sync(kFull, s, src);
    const int pid = __shfl_sync(kFull, id, src);
    for (int j = lane; j < k; j += 32) {
      if (j < n)
        write_pick(ps, pid, neg, vrow, trow, j);
      else
        write_none(vrow, trow, j);
    }
    return;
  }

  if (n <= cap) {
    // --- per-lane sorted columns, k rounds of warp max and pop ------
    // Lane l owns positions l, l + 32, ...: it scores them, sorts its
    // column (no other lane touches it), and keeps its head in a register.
    const int mine = (n - lane + 31) / 32;  // n > 32: at least 1
#pragma unroll 4
    for (int a = 0; a < mine; ++a) {
      const int p = lane + 32 * a;
      const int at = slot[p];
      const int id = ids[base + at];
      const float s = head_score<T>(id, counts[base + at], len, idf, V);
      comp[p] = composite(s, p);
      sc[p] = s;
      sid[p] = id;
    }
    for (int a = 1; a < mine; ++a) {
      const unsigned long long x = comp[lane + 32 * a];
      int b = a - 1;
      while (b >= 0 && comp[lane + 32 * b] < x) {
        comp[lane + 32 * (b + 1)] = comp[lane + 32 * b];
        --b;
      }
      comp[lane + 32 * (b + 1)] = x;
    }
    // Lane r % 32 keeps pick r; each block of 32 picks is written at
    // once, coalesced.
    int top = 0;
    unsigned long long c = comp[lane];
    float ps = 0.f;
    int pid = -1;
    int r = 0;
    for (; r < k; ++r) {
      const unsigned key = (unsigned)(c >> 32);
      const unsigned best_key = __reduce_max_sync(kFull, key);
      if (best_key == 0u) break;  // every candidate picked
      // Positions are unique; a lane with no candidate left holds none.
      const unsigned pos = 0xffffffffu - (unsigned)c;
      const unsigned best_pos =
          __reduce_min_sync(kFull, key == best_key ? pos : 0xffffffffu);
      if (lane == (r & 31)) {
        ps = sc[best_pos];
        pid = sid[best_pos];
      }
      if (pos == best_pos) c = ++top < mine ? comp[lane + 32 * top] : 0ull;
      if ((r & 31) == 31) write_pick(ps, pid, neg, vrow, trow, r - 31 + lane);
    }
    // The last partial block of picks, then (0, -1) past the head count.
    if (lane < (r & 31)) write_pick(ps, pid, neg, vrow, trow, (r & ~31) + lane);
    for (int j = r + lane; j < k; j += 32) write_none(vrow, trow, j);
    return;
  }

  if constexpr (HV == 16) {
    if (k * 32 <= cap) {
      // --- n > cap: each lane's top k in its column, then pop --------
      // A lane's 16 slots: ids and counts in four 16-byte loads each,
      // every head slot's idf gathered at once, then the column insert.
      int cnt = 0;
      for (int l0 = 0; l0 < L; l0 += 32 * HV) {
        const int l = l0 + lane * HV;
        const unsigned mask = l < L ? head_bits<HV>(head + base + l) : 0u;
        if (!mask) continue;
        int id[HV], ct[HV];
        const int4* ip = reinterpret_cast<const int4*>(ids + base + l);
        const int4* cp = reinterpret_cast<const int4*>(counts + base + l);
#pragma unroll
        for (int q = 0; q < HV / 4; ++q) {
          const int4 a = __ldg(ip + q), c = __ldg(cp + q);
          id[4 * q] = a.x; id[4 * q + 1] = a.y;
          id[4 * q + 2] = a.z; id[4 * q + 3] = a.w;
          ct[4 * q] = c.x; ct[4 * q + 1] = c.y;
          ct[4 * q + 2] = c.z; ct[4 * q + 3] = c.w;
        }
        float sv[HV];
#pragma unroll
        for (int j = 0; j < HV; ++j)
          sv[j] = (mask >> j & 1u) ? head_score<T>(id[j], ct[j], len, idf, V)
                                   : 0.f;
#pragma unroll
        for (int j = 0; j < HV; ++j) {
          if (!(mask >> j & 1u)) continue;
          const unsigned long long c = composite(sv[j], l + j);
          if (cnt == k && c <= comp[lane + 32 * (k - 1)]) continue;
          int at = cnt < k ? cnt++ : k - 1;
          for (; at > 0 && comp[lane + 32 * (at - 1)] < c; --at)
            comp[lane + 32 * at] = comp[lane + 32 * (at - 1)];
          comp[lane + 32 * at] = c;
        }
      }
      int top = 0;
      unsigned long long c = cnt > 0 ? comp[lane] : 0ull;
      int pslot = 0;
      int r = 0;
      for (; r < k; ++r) {
        const unsigned key = (unsigned)(c >> 32);
        const unsigned best_key = __reduce_max_sync(kFull, key);
        if (best_key == 0u) break;  // every candidate picked
        const unsigned lo = (unsigned)c;  // ~slot: larger = lower slot
        const unsigned best_lo =
            __reduce_max_sync(kFull, key == best_key ? lo : 0u);
        if (lane == (r & 31)) pslot = (int)(0xffffffffu - best_lo);
        if (key == best_key && lo == best_lo)
          c = ++top < cnt ? comp[lane + 32 * top] : 0ull;
        if ((r & 31) == 31) {
          const int pid = ids[base + pslot];
          write_pick(head_score<T>(pid, counts[base + pslot], len, idf, V),
                     pid, neg, vrow, trow, r - 31 + lane);
        }
      }
      if (lane < (r & 31)) {
        const int pid = ids[base + pslot];
        write_pick(head_score<T>(pid, counts[base + pslot], len, idf, V),
                   pid, neg, vrow, trow, (r & ~31) + lane);
      }
      for (int j = r + lane; j < k; j += 32) write_none(vrow, trow, j);
      return;
    }
  }

  // --- n > cap otherwise: rescore the row's head slots every round ---
  unsigned long long prev = 0ull;
  for (int r = 0; r < k; ++r) {
    unsigned long long best = 0ull;
    float best_s = 0.f;
    int best_id = -1;
    for (int i = lane; i < L; i += 32) {
      if (!head[base + i]) continue;
      const int id = ids[base + i];
      const float s = head_score<T>(id, counts[base + i], len, idf, V);
      const unsigned long long c = composite(s, i);
      if ((r == 0 || c < prev) && c > best) {
        best = c;
        best_s = s;
        best_id = id;
      }
    }
    const unsigned key = (unsigned)(best >> 32);
    const unsigned best_key = __reduce_max_sync(kFull, key);
    if (best_key == 0u) {
      for (int j = r + lane; j < k; j += 32) write_none(vrow, trow, j);
      break;
    }
    const unsigned lo = (unsigned)best;
    const unsigned best_lo =
        __reduce_max_sync(kFull, key == best_key ? lo : 0u);
    if (key == best_key && lo == best_lo) {
      write_pick(best_s, best_id, neg, vrow, trow, r);
    }
    prev = ((unsigned long long)best_key << 32) | best_lo;
  }
}

template <typename T, int HV>
int launch(const void* ids, const void* counts, const void* head,
           const void* lengths, const void* idf, void* vals, void* tids,
           int D, int L, int k, int V, cudaStream_t stream) {
  int cap = min((L + 31) / 32 * 32, kCapMax);
  // Rows read 16 slots a lane have the column path past cap: a smaller
  // list (but room for 32 columns of k) gives more warps an SM.
  if (HV == 16 && 32 * k <= kCapMax) cap = min(cap, max(32 * k, kColumnCap));
  const int warps =
      max(1, min(kMaxWarps, (int)(kSmemBudget / ((size_t)cap * kEntry))));
  const size_t smem = (size_t)warps * cap * kEntry;
  const int blocks = (int)(((long long)D + warps - 1) / warps);
  fused_score_topk_kernel<T, HV><<<blocks, warps * 32, smem, stream>>>(
      static_cast<const int*>(ids), static_cast<const int*>(counts),
      static_cast<const uint8_t*>(head), static_cast<const int*>(lengths),
      static_cast<const T*>(idf), static_cast<T*>(vals),
      static_cast<int*>(tids), D, L, k, V, cap);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hv(const void* ids, const void* counts, const void* head,
              const void* lengths, const void* idf, void* vals, void* tids,
              int D, int L, int k, int V, cudaStream_t s) {
  // head rows start at row * L bytes: vector width by L and alignment
  // (16 also loads ids and counts 16 bytes at a time).
  const uintptr_t a = reinterpret_cast<uintptr_t>(head);
  const uintptr_t w = reinterpret_cast<uintptr_t>(ids) |
                      reinterpret_cast<uintptr_t>(counts);
  if (L >= 512 && L % 16 == 0 && a % 16 == 0 && w % 16 == 0)
    return launch<T, 16>(ids, counts, head, lengths, idf, vals, tids, D, L,
                         k, V, s);
  if (L % 8 == 0 && a % 8 == 0)
    return launch<T, 8>(ids, counts, head, lengths, idf, vals, tids, D, L,
                        k, V, s);
  if (L % 4 == 0 && a % 4 == 0)
    return launch<T, 4>(ids, counts, head, lengths, idf, vals, tids, D, L,
                        k, V, s);
  return launch<T, 1>(ids, counts, head, lengths, idf, vals, tids, D, L, k,
                      V, s);
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
  if (D < 1 || k < 1 || k > L || V < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (idf_dtype) {
    case kFloat32:
      return launch_hv<float>(ids, counts, head, lengths, idf, vals, tids, D,
                              L, k, V, s);
    case kBFloat16:
      return launch_hv<__nv_bfloat16>(ids, counts, head, lengths, idf, vals,
                                      tids, D, L, k, V, s);
    case kFloat16:
      return launch_hv<__half>(ids, counts, head, lengths, idf, vals, tids,
                               D, L, k, V, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
