// Ragged rebuild: granule-aligned flat id stream -> padded int32 [D, L].
//
// Replaces: tfidf_tpu/ops/pallas_kernels.py, ragged_rebuild_pallas
//   (kernel body _rebuild_kernel), and the XLA granule gather it stands
//   beside (tfidf_tpu/ingest.py _ragged_to_padded).
// Contract: the flat stream holds each doc's ids from granule offg[d] on,
//   offg = exclusive prefix sum of ceil(max(len, 0) / G).
//   out[d, j] = flat[min(offg[d] + j / G, ngran - 1) * G + j % G], widened
//   to int32, for EVERY j < L: the padding slots carry the same clamped
//   values as the XLA lowering, so the whole [D, L] equals it, not only
//   the live slots. G is any power of two from 1 (the legacy back-to-back
//   layout) up.
// Bound on this card: memory. Each output slot is one 2- or 4-byte read
//   and one 4-byte write, and the int32 [D, L] output is most of the
//   bytes; there is no arithmetic to speak of.
// Design: one call, two launches on the stream, in place of the six
//   torch launches that computed offg before.
//   1. granule_scan_kernel: a block of 1,024 threads per tile of 1,024
//      rows scans ceil(max(len, 0) / G) (warp shuffles, then the warp
//      totals) into tile-local exclusive offsets, and writes the tile's
//      total after them in the scratch buffer. Many blocks, so the
//      lengths stream in at the card's rate (one block alone, scanning
//      all of D, was as slow as the torch chain: a single SM cannot keep
//      enough loads in flight). It lets the rebuild launch at once
//      (griddepcontrol.launch_dependents).
//   2. ragged_rebuild_kernel, launched as a programmatic dependent of the
//      scan, so its blocks are resident and waiting (griddepcontrol.wait)
//      when the scan ends. A warp per row: no division; the row's offset
//      is its tile-local offset plus the totals of the tiles before it
//      (one load a lane, a warp sum), read once per warp. A lane owns
//      groups of 4 consecutive slots, group (pass * 32 + lane), so each
//      warp store instruction writes 512 contiguous bytes of the row.
//      When G is a multiple of 4 a group lies inside one granule: its
//      source is contiguous, one 8-byte (uint16) or 16-byte (int32) load
//      widened in registers, and it goes out as one 16-byte store. G
//      below 4, an L that is not a multiple of 4 and unaligned pointers
//      take the scalar path (groups of 1 slot); the launch plan
//      (ops/kernels.ragged_rebuild_plan) chooses.

#include "common.cuh"

namespace {

constexpr int kTile = 1024;  // rows per scan block, one per thread
constexpr int kTileShift = 10;

__device__ __forceinline__ int granules(int len, int g_minus_1, int shift) {
  return (int)(((long long)max(len, 0) + g_minus_1) >> shift);
}

// scratch[row] = granules before row within its tile;
// scratch[d + tile] = the tile's total.
__global__ void __launch_bounds__(kTile)
granule_scan_kernel(const int* __restrict__ lengths, int* __restrict__ scratch,
                    int d, int g_minus_1, int shift) {
  asm volatile("griddepcontrol.launch_dependents;");
  __shared__ int warp_off[kTile / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long row = (long long)blockIdx.x * kTile + threadIdx.x;
  const int c = row < d ? granules(lengths[row], g_minus_1, shift) : 0;
  int x = c;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) warp_off[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const int t = warp_off[lane];
    int w = t;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += y;
    }
    warp_off[lane] = w - t;
    if (lane == 31) scratch[d + blockIdx.x] = w;
  }
  __syncthreads();
  if (row < d) scratch[row] = warp_off[warp] + x - c;
}

// Four consecutive ids from a 4-aligned source index, widened.
__device__ __forceinline__ int4 load4(const uint16_t* __restrict__ p) {
  const uint2 w = __ldg(reinterpret_cast<const uint2*>(p));
  return make_int4((int)(w.x & 0xffffu), (int)(w.x >> 16),
                   (int)(w.y & 0xffffu), (int)(w.y >> 16));
}
__device__ __forceinline__ int4 load4(const int* __restrict__ p) {
  return __ldg(reinterpret_cast<const int4*>(p));
}

template <typename T, int V>
__global__ void ragged_rebuild_kernel(const T* __restrict__ flat,
                                      const int* __restrict__ scratch,
                                      int* __restrict__ out, int d,
                                      int length, int shift,
                                      long long ngran) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (blockDim.x >> 5) +
                        (threadIdx.x >> 5);
  // The scan's writes are visible past this point (a no-op when no scan
  // was launched before this grid).
  asm volatile("griddepcontrol.wait;" ::: "memory");
  if (row >= d) return;
  const int tile = (int)(row >> kTileShift);
  int before = 0;
  for (int t = lane; t < tile; t += 32) before += scratch[d + t];
  const long long first =
      (long long)scratch[row] + __reduce_add_sync(0xffffffffu, before);
  const int gmask = (1 << shift) - 1;
  int* __restrict__ orow = out + row * length;
#pragma unroll 2
  for (int j = lane * V; j < length; j += 32 * V) {
    long long gran = first + (j >> shift);
    if (gran > ngran - 1) gran = ngran - 1;
    const long long src = (gran << shift) + (j & gmask);
    if constexpr (V == 4) {
      *reinterpret_cast<int4*>(orow + j) = load4(flat + src);
    } else {
      orow[j] = (int)flat[src];
    }
  }
}

template <typename T, int V>
cudaError_t launch_rebuild(const T* flat, const int* scratch, int* out, int d,
                           int length, int shift, long long ngran, int warps,
                           bool dependent, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((d + warps - 1) / warps));
  cfg.blockDim = dim3((unsigned)(warps * 32));
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = dependent ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, ragged_rebuild_kernel<T, V>, flat, scratch,
                            out, d, length, shift, ngran);
}

template <typename T>
int launch(const void* flat, const void* lengths, void* scratch, void* out,
           int d, int length, int shift, long long ngran, int group,
           int warps, int scan, cudaStream_t stream) {
  int* sc = static_cast<int*>(scratch);
  if (scan) {
    const unsigned tiles = (unsigned)((d + kTile - 1) / kTile);
    granule_scan_kernel<<<tiles, kTile, 0, stream>>>(
        static_cast<const int*>(lengths), sc, d, (1 << shift) - 1, shift);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const T* f = static_cast<const T*>(flat);
  int* dst = static_cast<int*>(out);
  const cudaError_t err =
      group == 4 ? launch_rebuild<T, 4>(f, sc, dst, d, length, shift, ngran,
                                        warps, scan != 0, stream)
                 : launch_rebuild<T, 1>(f, sc, dst, d, length, shift, ngran,
                                        warps, scan != 0, stream);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

}  // namespace

// flat: [ngran * align] int32 or uint16 (flat_dtype: TokenCode); lengths:
// int32 [D]; scratch: int32 [D + ceil(D / 1024)], the tile-local offsets
// then the tile totals, written by the scan when scan is 1, else read as
// given; out: int32 [D, L]. align must be a power of two; group (1 or 4)
// and warps (rows per block) come from ops/kernels.ragged_rebuild_plan,
// and group 4 needs align % 4 == 0 (the plan also checks L and the
// pointers' alignment). Requires D >= 1, L >= 1, ngran >= 1. Returns the
// first launch error, or 0.
extern "C" int tfidf_ragged_rebuild(const void* flat, int flat_dtype,
                                    const void* lengths, void* scratch,
                                    void* out, int d, int length, int align,
                                    long long ngran, int group, int warps,
                                    int scan, void* stream) {
  if (align < 1 || (align & (align - 1)) != 0) return (int)cudaErrorInvalidValue;
  if (!(group == 1 || (group == 4 && align % 4 == 0)) || warps < 1 ||
      warps > 32)
    return (int)cudaErrorInvalidValue;
  int shift = 0;
  while ((1 << shift) < align) ++shift;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (flat_dtype) {
    case kInt32:
      return launch<int>(flat, lengths, scratch, out, d, length, shift, ngran,
                         group, warps, scan, s);
    case kUInt16:
      return launch<uint16_t>(flat, lengths, scratch, out, d, length, shift,
                              ngran, group, warps, scan, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
