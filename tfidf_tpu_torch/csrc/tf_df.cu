// Dense TF histogram + DF, one shared-memory row per doc.
//
// Replaces: tfidf_tpu/ops/pallas_kernels.py, tf_df_pallas (kernel bodies
//   _hist_kernel, _hist_kernel_counts_only, _tile_counts).
// Contract: counts[d, v] = number of slots pos < clamp(len[d], 0, L) whose
//   id - id_offset == v, for v in [0, V); other ids are dropped. Every
//   cell of counts is written, so the caller passes it uninitialised.
//   df[v] = number of docs with counts[d, v] > 0 (skipped when df is null,
//   the with_df=False variant); the launcher zeroes it. Ids are widened to
//   64 bits before the offset is subtracted, so a uint16 id cannot wrap.
// Bound on this card: memory. The D x V x 4 bytes of counts are written
//   once, the live token ids and the lengths read once; each live token
//   is one shared-memory atomic.
// Design (ops/kernels.tf_df_plan picks the numbers):
//   * A 2-D grid: blockIdx.y is a vocab tile of VT columns, and the
//     blocks of one tile (about as many as the card holds at once) walk
//     the docs with a grid stride, so each block builds many rows.
//   * Per doc the block builds the tile's row in shared memory with
//     shared atomics, then writes it out once. Two row buffers alternate:
//     while some threads still write out doc i's buffer, others build
//     doc i + 1's histogram in the other one.
//   * A row starts at byte (d * V + c0) * 4, which is not 16-byte aligned
//     when V % 4 != 0. The buffer holds column k at position shift + k,
//     shift = the row's misalignment in ints, so the row's 16-byte
//     aligned stretch is 16-byte aligned in shared memory too: a scalar
//     head of up to 3 columns, 16-byte vectors, a scalar tail.
//   * Write-out: the threads load each 16-byte vector from shared memory,
//     store it to counts (streaming store) and clear it where they read
//     it, so no second pass or barrier clears the buffer. (A bulk copy
//     shared -> global, cp.async.bulk, was measured on the H100 and was no
//     faster: PERF.md.)
//   * DF without global contention: a shared atomic that returns 0 is the
//     doc's first occurrence of the word, and adds 1 to the block's DF
//     partial in shared memory. Each block adds its nonzero partials to
//     df once, at its end (one global atomic per word it saw), after
//     griddepcontrol.wait: df is zeroed by a small kernel launched just
//     before, of which this one is a programmatic dependent, so the
//     zeroing overlaps the histograms. Integer atomics keep the result
//     exact and independent of order.
//   * V past one tile (VT columns, so that two row buffers and the DF
//     partial fit the shared memory budget): more tiles on blockIdx.y,
//     each re-reading the doc's ids.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;  // 256 measured 1.7% slower (PERF.md)

__global__ void df_zero_kernel(int* __restrict__ df, int V) {
  asm volatile("griddepcontrol.launch_dependents;");
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < V;
       i += gridDim.x * blockDim.x)
    df[i] = 0;
}

// The columns of one (doc, tile) row: a scalar head up to the first
// 16-byte boundary of counts, nvec 16-byte vectors, a scalar tail.
struct RowSplit {
  int shift;  // the row's first column sits at this int of its buffer
  int head;
  int nvec;
  int tail;
};

__device__ __forceinline__ RowSplit split_row(const int* crow, int w) {
  RowSplit r;
  r.shift = (int)((reinterpret_cast<uintptr_t>(crow) >> 2) & 3);
  r.head = min((4 - r.shift) & 3, w);
  r.nvec = (w - r.head) >> 2;
  r.tail = w - r.head - 4 * r.nvec;
  return r;
}

__device__ __forceinline__ void add_token(long long local, int w, int* row,
                                          int* part) {
  if (local >= 0 && local < w) {
    const int old = atomicAdd(row + local, 1);
    if (part != nullptr && old == 0) atomicAdd(part + local, 1);
  }
}

// One doc's live tokens (its length clamped to [0, L]) into its row, and
// first occurrences into the DF partial. Each thread's first slot is
// loaded together with the length, so the two loads wait as one.
template <typename Tok>
__device__ __forceinline__ void histogram(const Tok* __restrict__ trow,
                                         const int* __restrict__ len_p, int L,
                                         long long base, int w, int* row,
                                         int* part) {
  const int raw = *len_p;
  const Tok first = (int)threadIdx.x < L ? trow[threadIdx.x] : Tok(0);
  const int len = min(max(raw, 0), L);
  if ((int)threadIdx.x < len) add_token((long long)first - base, w, row, part);
  for (int j = threadIdx.x + kThreads; j < len; j += kThreads)
    add_token((long long)trow[j] - base, w, row, part);
}

// The scalar head and tail of a row: stored and cleared by a few threads.
__device__ __forceinline__ void write_edges(int* __restrict__ crow, int* row,
                                            const RowSplit& r) {
  const int t = threadIdx.x;
  if (t < r.head) {
    crow[t] = row[t];
    row[t] = 0;
  } else if (t >= 32 && t < 32 + r.tail) {
    const int k = r.head + 4 * r.nvec + (t - 32);
    crow[k] = row[k];
    row[k] = 0;
  }
}

template <typename Tok>
__global__ void __launch_bounds__(kThreads)
tf_df_kernel(const Tok* __restrict__ tokens, const int* __restrict__ lengths,
             int* __restrict__ counts, int* __restrict__ df, int D, int L,
             int V, int VT, long long id_offset) {
  extern __shared__ int4 smem4[];
  int* smem = reinterpret_cast<int*>(smem4);
  const int stride = VT + 4;  // a row buffer: VT columns + up to 3 of shift
  int* part = df != nullptr ? smem + 2 * stride : nullptr;
  const int c0 = blockIdx.y * VT;
  const int w = min(VT, V - c0);
  const long long base = id_offset + c0;
  const int4 zero = make_int4(0, 0, 0, 0);
  for (int i = threadIdx.x; i < (2 * stride + (part ? VT : 0)) / 4;
       i += kThreads)
    smem4[i] = zero;
  __syncthreads();

  int it = 0;
  for (long long d = blockIdx.x; d < D; d += gridDim.x, ++it) {
    int* crow = counts + d * (long long)V + c0;
    const RowSplit r = split_row(crow, w);
    int* row = smem + (it & 1) * stride + r.shift;
    // Buffer (it & 1) was cleared before the last barrier.
    histogram(tokens + d * (long long)L, lengths + d, L, base, w, row, part);
    __syncthreads();
    // Read, store and clear each 16-byte vector; the other buffer takes
    // the next doc's histogram meanwhile, and the barrier after it orders
    // these clears before this buffer's next use.
    int4* rv = reinterpret_cast<int4*>(row + r.head);
    int4* gv = reinterpret_cast<int4*>(crow + r.head);
    for (int m = threadIdx.x; m < r.nvec; m += kThreads) {
      __stcs(gv + m, rv[m]);
      rv[m] = zero;
    }
    write_edges(crow, row, r);
  }
  if (part != nullptr) {
    __syncthreads();
    // df's zeroing (the grid this one depends on) is complete past here.
    asm volatile("griddepcontrol.wait;" ::: "memory");
    for (int v = threadIdx.x; v < w; v += kThreads) {
      const int c = part[v];
      if (c != 0) atomicAdd(df + c0 + v, c);
    }
  }
}

template <typename Tok>
cudaError_t launch(const void* tokens, const void* lengths, void* counts,
                   void* df, int D, int L, int V, int VT, int blocks,
                   long long id_offset, cudaStream_t stream) {
  auto kernel = tf_df_kernel<Tok>;
  const int smem = 4 * (2 * (VT + 4) + (df != nullptr ? VT : 0));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks, (unsigned)((V + VT - 1) / VT));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = df != nullptr ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<const Tok*>(tokens),
                            static_cast<const int*>(lengths),
                            static_cast<int*>(counts), static_cast<int*>(df),
                            D, L, V, VT, id_offset);
}

}  // namespace

// tokens: [D, L] int32 or uint16 (token_dtype: TokenCode); lengths: int32
// [D]; counts: int32 [D, V], every cell written; df: int32 [V] (or null),
// zeroed here. The plan (ops/kernels.tf_df_plan): vt columns per vocab
// tile (a multiple of 4), blocks per tile. Requires D, V >= 1, L >= 0.
// Returns the first launch error, or 0.
extern "C" int tfidf_tf_df(const void* tokens, int token_dtype,
                           const void* lengths, void* counts, void* df, int D,
                           int L, int V, long long id_offset, int vt,
                           int blocks, void* stream) {
  if (vt < 4 || vt % 4 != 0 || blocks < 1 || D < 1 || L < 0 || V < 1)
    return (int)cudaErrorInvalidValue;
  if (token_dtype != kInt32 && token_dtype != kUInt16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (df != nullptr) {
    const int zb = (V + 255) / 256;
    df_zero_kernel<<<zb < 132 ? zb : 132, 256, 0, s>>>(static_cast<int*>(df),
                                                        V);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const cudaError_t err =
      token_dtype == kInt32
          ? launch<int>(tokens, lengths, counts, df, D, L, V, vt, blocks,
                        id_offset, s)
          : launch<uint16_t>(tokens, lengths, counts, df, D, L, V, vt,
                             blocks, id_offset, s);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}
