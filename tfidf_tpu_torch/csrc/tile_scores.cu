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
// Bound on this card: memory latency more than bandwidth. Each live slot
//   gathers one qmat row strip (Q floats) for one multiply-add per float;
//   the bytes a tile needs (data, live cols, the distinct qmat rows, the
//   output: 7.4 MB at 4,096 x 256 slots, Q 64) take 2.2 us at 3.35 TB/s,
//   and the FMAs far less. The TPU kernel keeps the whole [V, Q] block in
//   VMEM, which at V = 2^16 and Q = 256 is 64 MB, past any shared memory
//   and past the 50 MB L2: here qmat stays in device memory and is read
//   through L2, where the Zipf-head columns many rows share stay resident.
//   What costs time is the gathers' L2 round trips: with one gather in
//   flight per warp, or every row re-read once per 32-column strip, a
//   tile runs at 11-13x the bound.
// Design (the launch plan is ops/kernels.py tile_scores_plan; the
//   indexing below mirrors it):
//   * A group of G lanes (G a power of two, 1..32) owns one row, so a
//     warp holds 32 / G rows; each lane owns NV vectors of V consecutive
//     columns per pass (V = 4, 2 or 1 by Q's alignment: float4, float2 or
//     scalar gathers), column ((pass * NV + i) * G + sub) * V. At Q 64 a
//     group of 16 lanes covers the 256-byte qmat row with one float4
//     each; at Q 256 a warp covers the 1 KB row with two float4 per lane;
//     at Q 1 every lane walks its own row. Q past 32 * V * NV loops over
//     column passes of the same compacted list.
//   * Each row is read once with 16-byte loads (SV = 4 slots of data and
//     of cols per lane) and its live slots are compacted, in ascending l,
//     into the group's slice of shared memory as (w, c) pairs: one
//     ballot per slot position and a __popc of the group's lanes below
//     give each live slot its place. Rows longer than the slice are
//     walked in windows of `cap` slots (re-compacted per pass when Q
//     needs more than one pass).
//   * The group walks its list in batches of U slots: it issues all U
//     qmat gathers into registers first, then applies the U two-rounding
//     adds in l order. The additions keep their order, so the bits do not
//     change; only the loads move earlier, so up to U * NV vector gathers
//     per lane are in flight instead of one per warp.
//   What is left: the gathers' traffic from L2 to
//   the SMs, live slots x Q x 4 bytes (36 MB at Q 64 on the 4,096-row
//   tile, 142 MB at Q 256), not the device-memory bytes the bound counts;
//   a shared-memory stage of the Zipf-head qmat rows would cut it. Rows
//   compacted in windows of 64 slots ran slower than whole rows.
//   Not done, on purpose: tensor cores (each row gathers different qmat
//   rows, the kernel does one FMA per 4 bytes gathered, and the l-order
//   two-rounding sum that makes it bit-equal to the plain version forbids
//   a wgmma's reassociation); cp.async/TMA staging of the raw row (each
//   slot is read once and goes straight from registers to the compacted
//   list, so a staging copy would add a shared-memory round trip; the
//   warps in flight hide the row loads, and the gathers are what wait).

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

struct Slot {
  float w;
  int c;
};

// V consecutive floats as one load or store.
template <int V>
__device__ __forceinline__ void load_vec(const float* p, float* a) {
  if constexpr (V == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    a[0] = v.x; a[1] = v.y; a[2] = v.z; a[3] = v.w;
  } else if constexpr (V == 2) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(p));
    a[0] = v.x; a[1] = v.y;
  } else {
    a[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* p, const float* a) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(a[0], a[1]);
  } else {
    *p = a[0];
  }
}

// Slots per batch U, by the floats a slot gathers per lane (V * NV):
// 16 for one, 8 for two, 4 from four up. Chosen on the card over U in
// {4, 8, 16}: past 4 floats a lane, more slots per batch cost registers
// (up to 127) and occupancy and ran slower.
template <int V, int NV>
__host__ __device__ constexpr int batch_slots() {
  return V * NV >= 4 ? 4 : (V * NV == 2 ? 8 : 16);
}

// V: floats per gathered vector; NV: vectors per lane per pass; SV: slots
// of data/cols each lane loads per step (4 = one 16-byte load of each).
// g_log2: log2 of the lanes per row; cap: list slots per row (a multiple
// of G * SV); passes: column passes.
template <int V, int NV, int SV>
__global__ void tile_scores_kernel(const float* __restrict__ data,
                                   const int* __restrict__ cols,
                                   const float* __restrict__ qmat,
                                   float* __restrict__ out, int rows,
                                   int length, int q, int g_log2, int cap,
                                   int passes) {
  constexpr int U = batch_slots<V, NV>();
  extern __shared__ Slot lists[];
  const int G = 1 << g_log2;
  const int rpw = 32 >> g_log2;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int grp = lane >> g_log2;
  const int sub = lane & (G - 1);
  const long long row =
      ((long long)blockIdx.x * (blockDim.x >> 5) + warp) * rpw + grp;
  const bool row_ok = row < rows;
  const unsigned gmask =
      G == 32 ? kFull : ((1u << G) - 1u) << (grp << g_log2);
  const unsigned below = gmask & ((1u << lane) - 1u);
  Slot* list = lists + ((size_t)warp * rpw + grp) * cap;
  const float* drow = data + (row_ok ? row : 0) * length;
  const int* crow = cols + (row_ok ? row : 0) * length;
  const int step = G * SV;
  const bool one_window = length <= cap;
  int n = 0;

  for (int pass = 0; pass < passes; ++pass) {
    int col[NV];
    bool col_ok[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      col[i] = ((pass * NV + i) * G + sub) * V;
      col_ok[i] = col[i] < q;
    }
    float acc[NV * V];
#pragma unroll
    for (int e = 0; e < NV * V; ++e) acc[e] = 0.0f;

    for (int w0 = 0; w0 < length; w0 += cap) {
      if (pass == 0 || !one_window) {
        // Compact the window's live slots, in ascending l, into the list.
        n = 0;
        const int w1 = min(w0 + cap, length);
        for (int l0 = w0; l0 < w1; l0 += step) {
          const int l = l0 + sub * SV;
          float w[SV];
          int c[SV];
#pragma unroll
          for (int j = 0; j < SV; ++j) {
            w[j] = 0.0f;
            c[j] = 0;
          }
          if (row_ok && l < w1) {
            if constexpr (SV == 4) {
              const float4 wv = __ldg(reinterpret_cast<const float4*>(drow + l));
              const int4 cv = __ldg(reinterpret_cast<const int4*>(crow + l));
              w[0] = wv.x; w[1] = wv.y; w[2] = wv.z; w[3] = wv.w;
              c[0] = cv.x; c[1] = cv.y; c[2] = cv.z; c[3] = cv.w;
            } else {
              w[0] = __ldg(drow + l);
              c[0] = __ldg(crow + l);
            }
          }
          int before = 0, total = 0;
#pragma unroll
          for (int j = 0; j < SV; ++j) {
            const unsigned b = __ballot_sync(kFull, w[j] != 0.0f);  // NaN is live
            before += __popc(b & below);
            total += __popc(b & gmask);
          }
          int p = n + before;
#pragma unroll
          for (int j = 0; j < SV; ++j) {
            if (w[j] != 0.0f) list[p++] = Slot{w[j], c[j]};
          }
          n += total;
        }
        __syncwarp();
      }
      // Walk the list U slots at a time: all gathers first, then the
      // adds in l order.
      for (int i0 = 0; i0 < n; i0 += U) {
        float wv[U];
        float qv[U][NV * V];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const bool ok = i0 + u < n;
          const Slot s = ok ? list[i0 + u] : Slot{0.0f, 0};
          wv[u] = s.w;
          const float* qrow = qmat + (size_t)s.c * q;
#pragma unroll
          for (int i = 0; i < NV; ++i) {
            if (ok && col_ok[i]) {
              load_vec<V>(qrow + col[i], &qv[u][i * V]);
            } else {
#pragma unroll
              for (int e = 0; e < V; ++e) qv[u][i * V + e] = 0.0f;
            }
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (i0 + u < n) {
#pragma unroll
            for (int e = 0; e < NV * V; ++e)
              acc[e] = __fadd_rn(acc[e], __fmul_rn(wv[u], qv[u][e]));
          }
        }
      }
      if (!one_window) __syncwarp();  // the next window rewrites the list
    }
    if (row_ok) {
#pragma unroll
      for (int i = 0; i < NV; ++i)
        if (col_ok[i]) store_vec<V>(out + row * q + col[i], &acc[i * V]);
    }
  }
}

template <int V, int NV, int SV>
int launch(const void* data, const void* cols, const void* qmat, void* out,
           int rows, int length, int q, int g_log2, int cap, int passes,
           int warps, int blocks, size_t smem, cudaStream_t stream) {
  tile_scores_kernel<V, NV, SV><<<blocks, warps * 32, smem, stream>>>(
      static_cast<const float*>(data), static_cast<const int*>(cols),
      static_cast<const float*>(qmat), static_cast<float*>(out), rows,
      length, q, g_log2, cap, passes);
  return (int)cudaGetLastError();
}

template <int SV>
int dispatch(int v, int nv, const void* data, const void* cols,
             const void* qmat, void* out, int rows, int length, int q,
             int g_log2, int cap, int passes, int warps, int blocks,
             size_t smem, cudaStream_t s) {
#define TS_CASE(V_, NV_)                                                    \
  if (v == V_ && nv == NV_)                                                 \
    return launch<V_, NV_, SV>(data, cols, qmat, out, rows, length, q,      \
                               g_log2, cap, passes, warps, blocks, smem, s);
  TS_CASE(4, 1) TS_CASE(4, 2)
  TS_CASE(2, 1) TS_CASE(2, 2) TS_CASE(2, 4)
  TS_CASE(1, 1) TS_CASE(1, 2) TS_CASE(1, 4) TS_CASE(1, 8)
#undef TS_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// data: float32 [rows, length]; cols: int32 [rows, length]; qmat: float32
// [V, q]; out: float32 [rows, q]. The plan (ops/kernels.py
// tile_scores_plan): g_log2 (lanes per row = 2^g_log2), v (floats per
// gathered vector), nv (vectors per lane per pass), passes, sv (slots per
// lane load: 4 needs length % 4 == 0 and 16-byte aligned rows), warps per
// block, cap (list slots per row), blocks. v must divide q, and qmat and
// out must be aligned to 4 * v bytes. Returns cudaGetLastError().
extern "C" int tfidf_tile_scores(const void* data, const void* cols,
                                 const void* qmat, void* out, int rows,
                                 int length, int q, int g_log2, int v,
                                 int nv, int passes, int sv, int warps,
                                 int cap, int blocks, void* stream) {
  if (rows < 1 || q < 1 || length < 0 || g_log2 < 0 || g_log2 > 5 ||
      warps < 1 || warps > 32 || cap < 1 || blocks < 1 || passes < 1 ||
      q % v != 0 || cap % ((1 << g_log2) * sv) != 0 ||
      (sv == 4 && length % 4 != 0))
    return (int)cudaErrorInvalidValue;
  const long long covered = (long long)passes * nv * (1 << g_log2) * v;
  if (covered < q ||
      (long long)blocks * warps * (32 >> g_log2) < rows)
    return (int)cudaErrorInvalidConfiguration;
  const size_t smem = (size_t)warps * (32 >> g_log2) * cap * sizeof(Slot);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sv == 4)
    return dispatch<4>(v, nv, data, cols, qmat, out, rows, length, q, g_log2,
                       cap, passes, warps, blocks, smem, s);
  if (sv == 1)
    return dispatch<1>(v, nv, data, cols, qmat, out, rows, length, q, g_log2,
                       cap, passes, warps, blocks, smem, s);
  return (int)cudaErrorInvalidValue;
}
