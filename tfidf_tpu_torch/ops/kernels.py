"""The port's hand-written Hopper kernels: wrappers, plain versions and
launch counts (port of ``tfidf_tpu/ops/pallas_kernels.py``'s main-path
kernels).

=========================  =============================================
wrapper                    replaces (tfidf_tpu/ops/pallas_kernels.py)
=========================  =============================================
:func:`fused_score_topk`   ``fused_score_topk_pallas`` — csrc/score_topk.cu
:func:`tf_df`              ``tf_df_pallas`` — csrc/tf_df.cu
:func:`pack_words`         ``pack_words_pallas`` — csrc/pack_words.cu
:func:`ragged_rebuild`     ``ragged_rebuild_pallas`` — csrc/ragged_rebuild.cu
:func:`tokenize_hash`      ``tokenize_hash_pallas`` — csrc/tokenize_hash.cu
:func:`tile_scores`        ``tile_scores_pallas`` — csrc/tile_scores.cu
=========================  =============================================

Each wrapper has the JAX function's signature (less ``interpret``). On
tensors that lie on the CPU it runs its plain PyTorch version, defined
beside it; on CUDA tensors it checks dtypes, shapes and contiguity,
allocates its outputs, launches the kernel on the current stream and
raises if the launch reports an error. It never falls back from one to
the other. :data:`LAUNCHES` counts kernel launches per wrapper (plain
runs do not count); :func:`reset_launches` zeroes it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from tfidf_tpu_torch.ops import device_tokenize as dt
from tfidf_tpu_torch.ops._build import load
from tfidf_tpu_torch.ops.histogram import (df_from_counts, tf_counts_masked,
                                           valid_mask)
from tfidf_tpu_torch.ops.sparse import sparse_scores, sparse_topk

LAUNCHES: Dict[str, int] = {"fused_score_topk": 0, "tf_df": 0, "pack_words": 0,
                            "ragged_rebuild": 0, "tokenize_hash": 0,
                            "tile_scores": 0}
# The __global__ function of csrc/ each wrapper launches once a count
# (its name in a profiler's device-op table).
KERNEL_FUNCTIONS: Dict[str, str] = {
    "fused_score_topk": "fused_score_topk_kernel", "tf_df": "tf_df_kernel",
    "pack_words": "pack_words_kernel",
    "ragged_rebuild": "ragged_rebuild_kernel",
    "tokenize_hash": "tokenize_hash_kernel",
    "tile_scores": "tile_scores_kernel"}

# dtype codes of csrc/common.cuh and csrc/tokenize_hash.cu
_SCORE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_TOKEN_CODES = {torch.int32: 0, torch.uint16: 1}
_SLAB_CODES = {torch.uint8: 0, torch.int32: 1}


def reset_launches() -> None:
    """Zero every kernel's launch count."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_cpu(name: str, *tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU, False when all lie on one
    CUDA device; raises for anything else (mixed or other devices)."""
    devices = {t.device for t in tensors}
    kinds = {d.type for d in devices}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"} and len(devices) == 1:
        if not torch.cuda.is_available():
            raise RuntimeError(f"{name}: CUDA tensors but no CUDA device")
        return False
    raise ValueError(f"{name}: tensors on {sorted(map(str, devices))}; "
                     f"expected all on the CPU or all on one CUDA device")


def _check(name: str, what: str, t: torch.Tensor, dtypes, ndim: int) -> None:
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: {what} has dtype {t.dtype}, "
                        f"the kernel takes {sorted(map(str, dtypes))}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: {what} must be {ndim}-D, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: {what} must be contiguous")


def _ptr(t: Optional[torch.Tensor]):
    return ctypes.c_void_p(t.data_ptr() if t is not None else None)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (for the launch plans
    that size their grid to what the card holds at once)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch(name: str, fn, device: torch.device, *args) -> None:
    """Call a C launcher on ``device``'s current stream, raise on a
    launch error, count the launch."""
    with torch.cuda.device(device):
        stream = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed (cudaError {rc})")
    LAUNCHES[name] += 1


# --- B1: fused score + top-k -----------------------------------------

def fused_score_topk_plain(ids, counts, head, lengths, idf, *, k: int):
    """Plain version: :func:`sparse_scores` then :func:`sparse_topk`."""
    return sparse_topk(sparse_scores(ids, counts, head, lengths, idf),
                       ids, head, k)


def topk_order_key(scores: torch.Tensor) -> torch.Tensor:
    """The fused kernel's selection order as integers (csrc/score_topk.cu
    ``order_key``, line for line): int64 values in [0, 2^32) such that a
    larger key comes earlier in ``torch.sort(descending=True,
    stable=True)``: NaN first, -0.0 equal to +0.0, the float bits' sign
    flipped (positive) or inverted (negative). Scores of any float dtype;
    bfloat16 and float16 widen to float32 exactly."""
    s = scores.to(torch.float32)
    s = torch.where(s == 0, torch.zeros((), dtype=s.dtype, device=s.device), s)
    b = s.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    key = torch.where(b >= 0x80000000, b ^ 0xFFFFFFFF, b ^ 0x80000000)
    return torch.where(torch.isnan(s), 0xFFFFFFFF, key)


def fused_score_topk(ids: torch.Tensor, counts: torch.Tensor,
                     head: torch.Tensor, lengths: torch.Tensor,
                     idf: torch.Tensor, *, k: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tf*idf scoring + per-doc top-k over sorted triples ([D, L] ids,
    counts, head; [D] lengths; [V] idf) -> (vals [D, k'], tids [D, k']),
    k' = min(k, L), per the ``sparse_topk`` contract: ties to the lower
    slot, missing picks (0, -1)."""
    name = "fused_score_topk"
    if head.dtype != torch.bool:
        head = head != 0
    if _on_cpu(name, ids, counts, head, lengths, idf):
        return fused_score_topk_plain(ids, counts, head, lengths, idf, k=k)
    for what, t, dtypes, ndim in (("ids", ids, {torch.int32}, 2),
                                  ("counts", counts, {torch.int32}, 2),
                                  ("head", head, {torch.bool}, 2),
                                  ("lengths", lengths, {torch.int32}, 1),
                                  ("idf", idf, set(_SCORE_CODES), 1)):
        _check(name, what, t, dtypes, ndim)
    d, length = ids.shape
    if counts.shape != ids.shape or head.shape != ids.shape \
            or lengths.shape != (d,):
        raise ValueError(f"{name}: shapes ids {tuple(ids.shape)}, counts "
                         f"{tuple(counts.shape)}, head {tuple(head.shape)}, "
                         f"lengths {tuple(lengths.shape)} disagree")
    if idf.numel() == 0:
        raise ValueError(f"{name}: empty idf table")
    k = max(min(k, length), 0)
    vals = torch.empty((d, k), dtype=idf.dtype, device=ids.device)
    tids = torch.empty((d, k), dtype=torch.int32, device=ids.device)
    if d == 0 or k == 0:
        return vals, tids
    _launch(name, load().tfidf_fused_score_topk, ids.device,
            _ptr(ids), _ptr(counts), _ptr(head), _ptr(lengths), _ptr(idf),
            _SCORE_CODES[idf.dtype], _ptr(vals), _ptr(tids),
            d, length, k, idf.numel())
    return vals, tids


# --- B2: dense TF + DF ------------------------------------------------

def tf_df_plain(token_ids, lengths, *, vocab_size: int, id_offset: int = 0,
                with_df: bool = True):
    """Plain version: masked scatter-add histogram, DF from presence."""
    valid = valid_mask(lengths, token_ids.shape[1])
    counts = tf_counts_masked(token_ids, valid, vocab_size, id_offset)
    return counts, (df_from_counts(counts) if with_df else None)


def tf_df(token_ids: torch.Tensor, lengths: torch.Tensor, *, vocab_size: int,
          id_offset: int = 0, with_df: bool = True
          ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """TF histogram + DF: counts[d, v] = valid tokens of doc d with
    ``id - id_offset == v`` (int32 [D, V]); df[v] = docs with
    counts > 0 (int32 [V]), or None when ``with_df=False``."""
    name = "tf_df"
    if _on_cpu(name, token_ids, lengths):
        return tf_df_plain(token_ids, lengths, vocab_size=vocab_size,
                           id_offset=id_offset, with_df=with_df)
    _check(name, "token_ids", token_ids, set(_TOKEN_CODES), 2)
    _check(name, "lengths", lengths, {torch.int32}, 1)
    d = token_ids.shape[0]
    if lengths.shape != (d,):
        raise ValueError(f"{name}: lengths {tuple(lengths.shape)} vs "
                         f"token_ids {tuple(token_ids.shape)}")
    if vocab_size <= 0:
        raise ValueError(f"{name}: vocab_size must be positive")
    dev = token_ids.device
    counts = torch.empty((d, vocab_size), dtype=torch.int32, device=dev)
    df = torch.empty(vocab_size, dtype=torch.int32, device=dev) \
        if with_df else None
    if d == 0:
        return counts, None if df is None else df.zero_()
    tf_df_launch(token_ids, lengths, counts, df, id_offset=id_offset)
    return counts, df


_TF_DF_THREADS = 128          # threads per block of csrc/tf_df.cu
_TF_DF_TILE = 8192            # vocab columns per tile, at most
_SMEM_PER_BLOCK = 227 * 1024  # the H100's opt-in limit for one block
_SMEM_PER_SM = 228 * 1024     # an H100 SM's, less 1 KB a block the runtime keeps
_THREADS_PER_SM = 2048        # resident threads an H100 SM holds
_H100_SMS = 132


def tf_df_plan(d: int, length: int, vocab_size: int, *, with_df: bool = True,
               sms: int = _H100_SMS, max_tile: int = _TF_DF_TILE
               ) -> Dict[str, int]:
    """The launch plan of the TF/DF kernel (csrc/tf_df.cu) for D docs of L
    slots over a V-word vocab.

    * ``vt``: vocab columns per tile, V rounded up to a multiple of 4, at
      most ``max_tile``; ``tiles`` = ceil(V / vt) (grid y). Tile t holds
      columns ``[t * vt, min((t + 1) * vt, V))``.
    * ``smem_bytes``: two row buffers of ``vt + 4`` ints (the row and its
      up-to-3-int shift, see :func:`tf_df_row_split`) and, with df, the
      DF partial of ``vt`` ints; within ``_SMEM_PER_BLOCK``.
    * ``blocks`` per tile (grid x): as many as the card holds at once
      (``blocks_per_sm`` by shared memory and threads, times ``sms``),
      shared among the tiles, at most D. Block x of tile t builds the
      rows of docs ``x, x + blocks, ...``.
    """
    d, length, v = int(d), int(length), int(vocab_size)
    if d < 1 or length < 0 or v < 1 or max_tile < 4 or max_tile % 4:
        raise ValueError(f"tf_df_plan: d {d}, length {length}, vocab {v}, "
                         f"max_tile {max_tile}")
    vt = min(-(-v // 4) * 4, max_tile)
    tiles = -(-v // vt)
    smem = 4 * (2 * (vt + 4) + (vt if with_df else 0))
    if smem > _SMEM_PER_BLOCK:
        raise ValueError(f"tf_df_plan: a {vt}-column tile needs {smem} bytes "
                         f"of shared memory, over {_SMEM_PER_BLOCK}")
    per_sm = min(_THREADS_PER_SM // _TF_DF_THREADS,
                 _SMEM_PER_SM // (smem + 1024))
    blocks = max(1, min(d, -(-sms * per_sm // tiles)))
    return {"vt": vt, "tiles": tiles, "smem_bytes": smem,
            "blocks_per_sm": per_sm, "blocks": blocks}


def tf_df_row_split(row_addr: int, width: int) -> Dict[str, int]:
    """How csrc/tf_df.cu writes one (doc, tile) row of ``width`` columns
    whose first count sits at byte address ``row_addr`` (4-aligned): the
    row buffer holds column k at int ``shift + k``, ``shift`` the row's
    misalignment in ints, so a ``head`` of up to 3 scalar columns reaches
    the first 16-byte boundary, then ``nvec`` 16-byte vectors (aligned in
    both memories), then a scalar ``tail``."""
    shift = (row_addr >> 2) & 3
    head = min((4 - shift) & 3, width)
    nvec = (width - head) >> 2
    return {"shift": shift, "head": head, "nvec": nvec,
            "tail": width - head - 4 * nvec}


def tf_df_launch(token_ids: torch.Tensor, lengths: torch.Tensor,
                 counts: torch.Tensor, df: Optional[torch.Tensor], *,
                 id_offset: int = 0) -> None:
    """:func:`tf_df`'s device work: one C call that zeroes ``df`` [V] (or
    None) and writes every cell of ``counts`` [D, V] (no fill needed),
    with the plan of :func:`tf_df_plan`. CUDA tensors that :func:`tf_df`
    has checked, D at least 1."""
    d, length = token_ids.shape
    v = counts.shape[1]
    p = tf_df_plan(d, length, v, with_df=df is not None,
                   sms=_sm_count(counts.device))
    _launch("tf_df", load().tfidf_tf_df, token_ids.device,
            _ptr(token_ids), _TOKEN_CODES[token_ids.dtype], _ptr(lengths),
            _ptr(counts), _ptr(df), d, length, v, int(id_offset),
            p["vt"], p["blocks"])


# --- B3: packed result words -----------------------------------------

def pack_words_plain(vals: torch.Tensor, tids: torch.Tensor) -> torch.Tensor:
    """Plain version: the 16-bit score bits shifted over the uint16 id."""
    w16 = torch.bfloat16 if vals.dtype == torch.bfloat16 else torch.float16
    ok = tids >= 0
    v16 = torch.where(ok, vals, -1).to(w16)
    hi = v16.view(torch.int16).to(torch.int64) & 0xFFFF
    lo = torch.where(ok, tids.to(torch.int64), 0) & 0xFFFF
    return ((hi << 16) | lo).to(torch.uint32)


def pack_words(vals: torch.Tensor, tids: torch.Tensor,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(vals [D, K], tids [D, K]) -> uint32 words [D, K]: score bits
    (float16, or bfloat16 for bfloat16 scores) in the high half, uint16
    id in the low half; tid < 0 packs as (score -1, id 0). The port's
    counterpart of the JAX package's ``downlink.pack_result_words``.
    ``out`` (a contiguous uint32 tensor of the same shape and device)
    receives the words in place: the scan finish packs every chunk
    straight into its slice of one result buffer."""
    name = "pack_words"
    if _on_cpu(name, vals, tids):
        words = pack_words_plain(vals, tids)
        return words if out is None else out.copy_(words)
    _check(name, "vals", vals, set(_SCORE_CODES), vals.dim())
    _check(name, "tids", tids, {torch.int32}, vals.dim())
    if vals.shape != tids.shape:
        raise ValueError(f"{name}: vals {tuple(vals.shape)} vs tids "
                         f"{tuple(tids.shape)}")
    if out is None:
        words = torch.empty(vals.shape, dtype=torch.uint32, device=vals.device)
    else:
        _check(name, "out", out, {torch.uint32}, vals.dim())
        if out.shape != vals.shape or out.device != vals.device:
            raise ValueError(f"{name}: out {tuple(out.shape)} on {out.device} "
                             f"vs vals {tuple(vals.shape)} on {vals.device}")
        words = out
    if words.numel() == 0:
        return words
    p = pack_words_plan(words.numel(), itemsize=vals.element_size(),
                        vals_addr=vals.data_ptr(), tids_addr=tids.data_ptr(),
                        out_addr=words.data_ptr(), sms=_sm_count(vals.device))
    _launch(name, load().tfidf_pack_words, vals.device,
            _ptr(vals), _SCORE_CODES[vals.dtype], _ptr(tids), _ptr(words),
            words.numel(), p["head"], p["groups"], p["blocks"])
    return words


_PACK_THREADS = 256  # threads per block of csrc/pack_words.cu


def pack_words_plan(n: int, *, itemsize: int = 4, vals_addr: int = 0,
                    tids_addr: int = 0, out_addr: int = 0,
                    sms: int = _H100_SMS) -> Dict[str, int]:
    """The launch plan of the pack kernel (csrc/pack_words.cu) for n
    words from ``itemsize``-byte scores, given the three byte addresses.

    * ``groups`` of 4 consecutive words from word ``head`` on: word i of
      a group is aligned in all three arrays (16 bytes for tids and
      words, 4 x itemsize for the scores). That needs the three addresses
      to sit equally far, in words, past such a boundary; ``head`` words
      are packed one at a time up to it. When they differ, every word is
      packed alone (``head`` = n, ``groups`` 0).
    * ``tail``: the n - head - 4 * groups words after the last group, one
      at a time.
    * ``blocks`` of ``_PACK_THREADS``: a thread a group, at most one wave
      (``sms`` SMs of ``_THREADS_PER_SM`` threads), striding past it.
    """
    n, itemsize = int(n), int(itemsize)
    if n < 1 or itemsize not in (2, 4):
        raise ValueError(f"pack_words_plan: n {n}, itemsize {itemsize}")
    lanes = {(tids_addr % 16, 4), (out_addr % 16, 4),
             (vals_addr % (4 * itemsize), itemsize)}
    offsets = {off // size if off % size == 0 else -1 for off, size in lanes}
    if len(offsets) == 1 and -1 not in offsets:
        head = min((4 - offsets.pop()) % 4, n)
        groups = (n - head) // 4
    else:
        head, groups = n, 0
    tail = n - head - 4 * groups
    work = max(groups, head, tail)
    wave = sms * (_THREADS_PER_SM // _PACK_THREADS)
    return {"head": head, "groups": groups, "tail": tail,
            "blocks": max(1, min(-(-work // _PACK_THREADS), wave))}


# --- B4: ragged rebuild -----------------------------------------------

def granule_offsets(lengths: torch.Tensor, align: int) -> torch.Tensor:
    """offg[d] = sum over e < d of ceil(max(len[e], 0) / align): the
    granule where doc d's ids start in the aligned flat stream (int32
    [D]). Negative lengths count as 0."""
    al = torch.div(lengths.clamp_min(0) + (align - 1), align,
                   rounding_mode="floor").to(torch.int32)
    return torch.cumsum(al, 0, dtype=torch.int32) - al


def ragged_rebuild_plain(flat: torch.Tensor, lengths: torch.Tensor, *,
                         length: int, align: int) -> torch.Tensor:
    """Plain version: the JAX package's XLA granule gather
    (``ingest._ragged_to_padded``) in torch, padding slots included."""
    g = align
    lg = -(-length // g)
    gran = flat.to(torch.int32).reshape(-1, g)
    idx = granule_offsets(lengths, g)[:, None] + torch.arange(
        lg, dtype=torch.int32, device=flat.device)[None, :]
    tok = gran[idx.clamp_max(gran.shape[0] - 1).long()]
    return tok.reshape(lengths.shape[0], lg * g)[:, :length].contiguous()


def ragged_rebuild(flat: torch.Tensor, lengths: torch.Tensor, *,
                   length: int, align: int) -> torch.Tensor:
    """Granule-aligned flat id stream (uint16 or int32 [N], N a multiple
    of ``align``) + lengths int32 [D] -> int32 [D, length]:
    ``out[d, j] = flat[min(offg[d] + j // G, N/G - 1) * G + j % G]`` with
    ``offg`` from :func:`granule_offsets`. Every slot, padding included,
    equals the JAX package's ``rebuild_padded``. ``align`` is any power
    of two (1 = the legacy back-to-back layout)."""
    name = "ragged_rebuild"
    if align < 1 or align & (align - 1):
        raise ValueError(f"{name}: align must be a power of two, got {align}")
    if flat.dim() != 1 or flat.numel() == 0 or flat.numel() % align:
        raise ValueError(f"{name}: flat must be a non-empty 1-D stream of "
                         f"whole {align}-id granules, got {tuple(flat.shape)}")
    if _on_cpu(name, flat, lengths):
        return ragged_rebuild_plain(flat, lengths, length=length, align=align)
    _check(name, "flat", flat, set(_TOKEN_CODES), 1)
    _check(name, "lengths", lengths, {torch.int32}, 1)
    d = lengths.shape[0]
    out = torch.empty((d, length), dtype=torch.int32, device=flat.device)
    if d == 0 or length == 0:
        return out
    ragged_rebuild_launch(flat, lengths, out, align=align)
    return out


_ROW_WARPS = 4  # rows per block of the warp-per-row kernels (B4, B5)
_SCAN_TILE = 1024  # rows per block of B4's offset scan


def _warp_per_row_plan(d: int, length: int, group: int) -> Dict[str, int]:
    """A warp per row, ``warps`` rows a block; lane l owns the groups
    ``pass * 32 + l`` of ``group`` consecutive slots: row
    ``block * warps + warp``, slots ``[(pass * 32 + lane) * group,
    ... + group)``."""
    return {"group": group, "warps": _ROW_WARPS,
            "blocks": -(-d // _ROW_WARPS),
            "passes": -(-length // (32 * group))}


def ragged_rebuild_plan(d: int, length: int, align: int, *, itemsize: int,
                        flat_align: int = 16,
                        out_align: int = 16) -> Dict[str, int]:
    """The launch plan of the rebuild kernel (csrc/ragged_rebuild.cu) for
    D rows of L slots from a stream of ``itemsize``-byte ids in granules
    of ``align``: :func:`_warp_per_row_plan`'s ownership, and

    * ``group`` 4 (the vector path: one 8- or 16-byte load of a
      granule-contiguous source, one 16-byte store) when G and L are
      multiples of 4, ``flat_align`` (the byte alignment of the stream)
      covers 4 ids and ``out_align`` 16 bytes; else 1 (the scalar path).
      A group of 4 never straddles a granule: its first slot is a
      multiple of 4 and G a multiple of 4;
    * ``shift`` = log2 G;
    * ``scratch``: the int32 scratch the offset scan writes, the
      tile-local offsets of the D rows then one total per tile of
      ``_SCAN_TILE`` rows (a row's offset is its local offset plus the
      totals of the tiles before it).
    """
    d, length, align = int(d), int(length), int(align)
    if d < 1 or length < 1 or align < 1 or align & (align - 1):
        raise ValueError(f"ragged_rebuild_plan: d {d}, length {length}, "
                         f"align {align}")
    vector = (align % 4 == 0 and length % 4 == 0
              and flat_align % (4 * itemsize) == 0 and out_align % 16 == 0)
    return {**_warp_per_row_plan(d, length, 4 if vector else 1),
            "shift": align.bit_length() - 1,
            "scratch": d + -(-d // _SCAN_TILE)}


def ragged_rebuild_launch(flat: torch.Tensor, lengths: torch.Tensor,
                          out: torch.Tensor, *, align: int,
                          scratch: Optional[torch.Tensor] = None,
                          scan: bool = True) -> None:
    """:func:`ragged_rebuild`'s device work: one C call that launches the
    granule-offset scan into ``scratch`` (int32, the plan's ``scratch``
    size; allocated when None) and then the rebuild into ``out`` [D, L],
    with the plan of :func:`ragged_rebuild_plan`. ``scan=False`` skips
    the scan and reads ``scratch`` as given (for example the offsets of
    :func:`granule_offsets` followed by zero tile totals), so a benchmark
    can time the rebuild alone. CUDA tensors that :func:`ragged_rebuild`
    has checked."""
    d, length = out.shape
    p = ragged_rebuild_plan(d, length, align, itemsize=flat.element_size(),
                            flat_align=_alignment(flat),
                            out_align=_alignment(out))
    if scratch is None:
        scratch = torch.empty(p["scratch"], dtype=torch.int32,
                              device=out.device)
    _launch("ragged_rebuild", load().tfidf_ragged_rebuild, flat.device,
            _ptr(flat), _TOKEN_CODES[flat.dtype], _ptr(lengths),
            _ptr(scratch), _ptr(out), d, length, align, flat.numel() // align,
            p["group"], p["warps"], int(scan))


# --- B5: tokenize + hash ----------------------------------------------

_M64 = (1 << 64) - 1


def tokenize_hash_plain(slab: torch.Tensor, starts: torch.Tensor,
                        lengths: torch.Tensor, *, vocab_size: int,
                        seed: int = 0, truncate_at: int = 0) -> torch.Tensor:
    """Plain version: the JAX package's ``hash_tokens_xla`` in torch, the
    byte loop vectorised over [D, L] and the FNV-1a64 state held in two
    32-bit limbs (:mod:`ops.device_tokenize`)."""
    n = slab.shape[0]
    b = slab.to(torch.int64)
    valid = valid_mask(lengths, starts.shape[1])
    hi0, lo0 = dt.seed_state(seed)
    hi = torch.full(starts.shape, hi0, dtype=torch.int64, device=slab.device)
    lo = torch.full(starts.shape, lo0, dtype=torch.int64, device=slab.device)
    pos0 = starts.to(torch.int64)
    alive, j = valid, 0
    while bool(alive.any()):
        pos = pos0 + j
        byte = b[pos.clamp_max(n - 1)]
        consume = alive & ~dt.is_space(byte) & (pos < n)
        if truncate_at:
            consume &= j < truncate_at
        nhi, nlo = dt.fnv1a_step(hi, lo, byte & dt.MASK32)
        hi = torch.where(consume, nhi, hi)
        lo = torch.where(consume, nlo, lo)
        alive, j = consume, j + 1
    ids = dt.fold_mod(hi, lo, vocab_size)
    return torch.where(valid, ids, 0).to(torch.int32)


def tokenize_hash(slab: torch.Tensor, starts: torch.Tensor,
                  lengths: torch.Tensor, *, vocab_size: int, seed: int = 0,
                  truncate_at: Optional[int] = 0) -> torch.Tensor:
    """Byte slab (uint8 as shipped, or the int32 upcast) + token starts
    int32 [D, L] + lengths int32 [D] -> int32 ids [D, L]: seeded
    FNV-1a64 over each live token's bytes up to whitespace (and
    ``truncate_at`` bytes when > 0), xor-folded, mod ``vocab_size``;
    padding slots 0. Keeps the JAX package's ``vocab_size <= 2^16``
    bound (``ops.device_tokenize.fold_mod``)."""
    name = "tokenize_hash"
    truncate_at = int(truncate_at or 0)
    dt.check_vocab(vocab_size)
    if slab.dim() != 1 or slab.numel() == 0:
        raise ValueError(f"{name}: slab must be a non-empty 1-D byte "
                         f"stream, got {tuple(slab.shape)}")
    if _on_cpu(name, slab, starts, lengths):
        return tokenize_hash_plain(slab, starts, lengths,
                                   vocab_size=vocab_size, seed=seed,
                                   truncate_at=truncate_at)
    _check(name, "slab", slab, set(_SLAB_CODES), 1)
    _check(name, "starts", starts, {torch.int32}, 2)
    _check(name, "lengths", lengths, {torch.int32}, 1)
    d, length = starts.shape
    if lengths.shape != (d,):
        raise ValueError(f"{name}: lengths {tuple(lengths.shape)} vs starts "
                         f"{tuple(starts.shape)}")
    ids = torch.empty((d, length), dtype=torch.int32, device=slab.device)
    if d == 0 or length == 0:
        return ids
    hi, lo = dt.seed_state(seed)
    m32, magic = tokenize_fold_constants(vocab_size)
    p = tokenize_hash_plan(d, length, slab_align=_alignment(slab))
    _launch(name, load().tfidf_tokenize_hash, slab.device,
            _ptr(slab), _SLAB_CODES[slab.dtype], slab.numel(), _ptr(starts),
            _ptr(lengths), _ptr(ids), d, length,
            ctypes.c_uint64((hi << 32) | lo), vocab_size, m32, magic,
            truncate_at, p["warps"], int(p["vec"]))
    return ids


def tokenize_hash_plan(d: int, length: int, *,
                       slab_align: int = 16) -> Dict[str, int]:
    """The launch plan of the tokenize+hash kernel (csrc/tokenize_hash.cu)
    for D rows of L slots: :func:`_warp_per_row_plan`'s ownership with
    groups of one slot (lane l hashes slots ``pass * 32 + l``), and
    ``vec`` when ``slab_align`` is 16 (the byte walk loads aligned
    windows; else it reads one byte at a time)."""
    d, length = int(d), int(length)
    if d < 1 or length < 1:
        raise ValueError(f"tokenize_hash_plan: d {d}, length {length}")
    return {**_warp_per_row_plan(d, length, 1), "vec": slab_align % 16 == 0}


def tokenize_fold_constants(vocab_size: int) -> Tuple[int, int]:
    """The fold's constants (csrc/tokenize_hash.cu ``Fold``): ``2^32 % V``
    and Lemire's ``ceil(2^64 / V)`` mod 2^64, for 1 <= V <= 2^16."""
    dt.check_vocab(vocab_size)
    return (1 << 32) % vocab_size, (_M64 // vocab_size + 1) & _M64


def tokenize_fold(h: int, vocab_size: int) -> int:
    """csrc/tokenize_hash.cu's ``fold`` of a 64-bit hash, line for line
    on Python ints: ``(h ^ (h >> 32)) % V`` as a mask for a power-of-two
    V, else as the limbs' ``((f_hi % V) * (2^32 % V) + f_lo % V) % V``
    with each 32-bit remainder by ``fastmod``."""
    m32, magic = tokenize_fold_constants(vocab_size)
    v = vocab_size
    f_hi = h >> 32
    f_lo = (h & 0xFFFFFFFF) ^ f_hi
    if v & (v - 1) == 0:
        return f_lo & (v - 1)

    def fastmod(a: int) -> int:  # __umul64hi(magic * a mod 2^64, V)
        return ((magic * a & _M64) * v) >> 64

    return fastmod(fastmod(f_hi) * m32 + fastmod(f_lo))


# --- B6: tile scores ----------------------------------------------------

def tile_scores_plain(data: torch.Tensor, cols: torch.Tensor,
                      qmat: torch.Tensor) -> torch.Tensor:
    """Plain version: ``acc = acc + data[:, l] * qmat[cols[:, l]]`` for l
    ascending, one multiply and one add per slot (two roundings, no
    fused multiply-add), from zeros."""
    acc = torch.zeros((data.shape[0], qmat.shape[1]), dtype=qmat.dtype,
                      device=qmat.device)
    for sl in range(data.shape[1]):
        acc = acc + data[:, sl, None] * qmat.index_select(0, cols[:, sl])
    return acc


def tile_scores(data: torch.Tensor, cols: torch.Tensor, qmat: torch.Tensor,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Row-sparse tile (data float32 [R, L], cols int32 [R, L] in
    [0, V)) x query block (float32 [V, Q]) -> similarities float32
    [R, Q]: ``out[r, q] = sum_l data[r, l] * qmat[cols[r, l], q]``,
    summed in l order, bit-equal to :func:`tile_scores_plain` for finite
    ``qmat``. Dead slots carry data 0. ``out`` (contiguous float32
    [R, Q] on the same device) receives the scores in place: the tiled
    search reuses one buffer for every tile."""
    name = "tile_scores"
    extra = () if out is None else (out,)
    if _on_cpu(name, data, cols, qmat, *extra):
        scores = tile_scores_plain(data, cols, qmat)
        return scores if out is None else out.copy_(scores)
    _check(name, "data", data, {torch.float32}, 2)
    _check(name, "cols", cols, {torch.int32}, 2)
    _check(name, "qmat", qmat, {torch.float32}, 2)
    rows, length = data.shape
    nq = qmat.shape[1]
    if cols.shape != data.shape:
        raise ValueError(f"{name}: cols {tuple(cols.shape)} vs data "
                         f"{tuple(data.shape)}")
    if rows * length >= (1 << 31) or qmat.numel() >= (1 << 31):
        raise ValueError(f"{name}: {rows} x {length} slots or a "
                         f"{tuple(qmat.shape)} query block overflows int32 "
                         f"indices (>= 2^31)")
    if out is None:
        out = torch.empty((rows, nq), dtype=torch.float32, device=data.device)
    else:
        _check(name, "out", out, {torch.float32}, 2)
        if out.shape != (rows, nq):
            raise ValueError(f"{name}: out {tuple(out.shape)}, expected "
                             f"{(rows, nq)}")
    if rows == 0 or nq == 0:
        return out
    tile_scores_launch(data, cols, qmat, out)
    return out


_SMEM_DEFAULT = 48 * 1024   # dynamic shared memory without the opt-in
_TILE_WARPS = 4             # warps per block when the grid is large
_TILE_MIN_BLOCKS = 2 * 132  # two blocks per H100 SM
_TILE_MIN_WARPS = 4 * 132   # four warps per H100 SM


def _pow2_at_least(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length()


def _alignment(*tensors: torch.Tensor) -> int:
    """The largest power of two that divides every tensor's address."""
    return min(t.data_ptr() & -t.data_ptr() for t in tensors)


def tile_scores_plan(rows: int, length: int, q: int, *,
                     slot_align: int = 16, col_align: int = 16) -> Dict[str, int]:
    """The launch plan of the tile-scores kernel (csrc/tile_scores.cu)
    for a [rows, length] tile against Q query columns.

    * ``v``: floats per gathered vector (4, 2 or 1 by Q's alignment and
      ``col_align``, the byte alignment of qmat and out);
    * ``g``: lanes per row, a power of two covering Q / v (at most 32),
      and wide enough that a small tile still fills four warps per SM;
      a warp holds ``rows_per_warp = 32 / g`` rows;
    * ``nv``: vectors per lane per pass (a power of two, ``v * nv <= 8``
      accumulators); ``passes``: column passes, so every column is owned
      by exactly one (pass, vector, lane): column
      ``((pass * nv + i) * g + sub) * v + e``;
    * ``sv``: slots of data and cols a lane loads at once (4 = one
      16-byte load each, when ``length % 4 == 0`` and the rows are
      16-byte aligned, ``slot_align``), so a group reads ``g * sv`` slots
      per step;
    * ``warps`` per block (4, or 1 when fewer than two blocks per SM
      would result), ``blocks``, ``cap`` (list slots per row: the whole
      row when it fits the 48 KB default, else a window of it) and
      ``smem_bytes`` (8 bytes per list slot).
    Row ``(block * warps + warp) * rows_per_warp + lane // g``.
    """
    rows, length, q = int(rows), int(length), int(q)
    if rows < 1 or q < 1 or length < 0:
        raise ValueError(f"tile_scores_plan: rows {rows}, length {length}, "
                         f"q {q}")
    v = next(w for w in (4, 2, 1) if q % w == 0 and col_align % (4 * w) == 0)
    # Enough lanes per row to cover Q / v, and enough rows' groups that
    # the tile fills _TILE_MIN_WARPS warps (idle lanes still share the
    # row's loads).
    g = min(32, max(_pow2_at_least(-(-q // v)),
                    _pow2_at_least(-(-_TILE_MIN_WARPS * 32 // rows))))
    rpw = 32 // g
    chunks = -(-q // (g * v))
    nv = min(_pow2_at_least(chunks), 8 // v)
    passes = -(-chunks // nv)
    sv = 4 if length % 4 == 0 and slot_align % 16 == 0 else 1
    step = g * sv
    warps = _TILE_WARPS if -(-rows // (_TILE_WARPS * rpw)) >= _TILE_MIN_BLOCKS \
        else 1
    fit = (_SMEM_DEFAULT // (warps * rpw * 8)) // step * step
    cap = max(step, min(-(-max(length, 1) // step) * step, fit))
    return {"g": g, "rows_per_warp": rpw, "v": v, "nv": nv,
            "passes": passes, "sv": sv, "warps": warps,
            "blocks": -(-rows // (warps * rpw)), "cap": cap,
            "smem_bytes": warps * rpw * cap * 8}


def tile_scores_launch(data: torch.Tensor, cols: torch.Tensor,
                       qmat: torch.Tensor, out: torch.Tensor) -> None:
    """:func:`tile_scores`'s kernel launch alone, into ``out``, with the
    plan of :func:`tile_scores_plan`. CUDA tensors that
    :func:`tile_scores` has checked; lets a benchmark time the kernel
    without the output allocation."""
    rows, length = data.shape
    q = qmat.shape[1]
    p = tile_scores_plan(rows, length, q, slot_align=_alignment(data, cols),
                         col_align=_alignment(qmat, out))
    _launch("tile_scores", load().tfidf_tile_scores, data.device,
            _ptr(data), _ptr(cols), _ptr(qmat), _ptr(out), rows, length, q,
            p["g"].bit_length() - 1, p["v"], p["nv"], p["passes"], p["sv"],
            p["warps"], p["cap"], p["blocks"])
