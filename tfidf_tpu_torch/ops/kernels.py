"""The port's hand-written Hopper kernels: wrappers, plain versions and
launch counts (port of ``tfidf_tpu/ops/pallas_kernels.py``'s main-path
kernels).

=========================  =============================================
wrapper                    replaces (tfidf_tpu/ops/pallas_kernels.py)
=========================  =============================================
:func:`fused_score_topk`   ``fused_score_topk_pallas`` — csrc/score_topk.cu
:func:`tf_df`              ``tf_df_pallas`` — csrc/tf_df.cu
:func:`pack_words`         ``pack_words_pallas`` — csrc/pack_words.cu
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
from typing import Dict, Optional, Tuple

import torch

from tfidf_tpu_torch.ops._build import load
from tfidf_tpu_torch.ops.histogram import (df_from_counts, tf_counts_masked,
                                           valid_mask)
from tfidf_tpu_torch.ops.sparse import sparse_scores, sparse_topk

LAUNCHES: Dict[str, int] = {"fused_score_topk": 0, "tf_df": 0, "pack_words": 0}

# dtype codes of csrc/common.cuh
_SCORE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_TOKEN_CODES = {torch.int32: 0, torch.uint16: 1}


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
    d, length = token_ids.shape
    if lengths.shape != (d,):
        raise ValueError(f"{name}: lengths {tuple(lengths.shape)} vs "
                         f"token_ids {tuple(token_ids.shape)}")
    if vocab_size <= 0:
        raise ValueError(f"{name}: vocab_size must be positive")
    counts = torch.zeros((d, vocab_size), dtype=torch.int32,
                         device=token_ids.device)
    df = (torch.zeros(vocab_size, dtype=torch.int32, device=token_ids.device)
          if with_df else None)
    if d == 0:
        return counts, df
    _launch(name, load().tfidf_tf_df, token_ids.device,
            _ptr(token_ids), _TOKEN_CODES[token_ids.dtype], _ptr(lengths),
            _ptr(counts), _ptr(df), d, length, vocab_size, int(id_offset))
    return counts, df


# --- B3: packed result words -----------------------------------------

def pack_words_plain(vals: torch.Tensor, tids: torch.Tensor) -> torch.Tensor:
    """Plain version: the 16-bit score bits shifted over the uint16 id."""
    w16 = torch.bfloat16 if vals.dtype == torch.bfloat16 else torch.float16
    ok = tids >= 0
    v16 = torch.where(ok, vals, -1).to(w16)
    hi = v16.view(torch.int16).to(torch.int64) & 0xFFFF
    lo = torch.where(ok, tids.to(torch.int64), 0) & 0xFFFF
    return ((hi << 16) | lo).to(torch.uint32)


def pack_words(vals: torch.Tensor, tids: torch.Tensor) -> torch.Tensor:
    """(vals [D, K], tids [D, K]) -> uint32 words [D, K]: score bits
    (float16, or bfloat16 for bfloat16 scores) in the high half, uint16
    id in the low half; tid < 0 packs as (score -1, id 0). The port's
    counterpart of the JAX package's ``downlink.pack_result_words``."""
    name = "pack_words"
    if _on_cpu(name, vals, tids):
        return pack_words_plain(vals, tids)
    _check(name, "vals", vals, set(_SCORE_CODES), vals.dim())
    _check(name, "tids", tids, {torch.int32}, vals.dim())
    if vals.shape != tids.shape:
        raise ValueError(f"{name}: vals {tuple(vals.shape)} vs tids "
                         f"{tuple(tids.shape)}")
    words = torch.empty(vals.shape, dtype=torch.uint32, device=vals.device)
    if words.numel() == 0:
        return words
    _launch(name, load().tfidf_pack_words, vals.device,
            _ptr(vals), _SCORE_CODES[vals.dtype], _ptr(tids), _ptr(words),
            words.numel())
    return words
