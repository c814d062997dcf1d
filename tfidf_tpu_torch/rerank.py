"""Exact-string top-k terms from a device selection (port of
``tfidf_tpu/rerank.py``): the exact-terms mode of ``cli run``.

The hashed vocab's per-doc top-k is a set of *bucket* ids: two words
colliding into one bucket are scored on their merged counts and DF. The
reference keys everything by exact strings (``TFIDF.c:26-42``), so its
top-k is exact. Two engines close the gap, both on the device:

* **device-exact** (:func:`exact_topk_from_wire`, the native
  ``exact_emit`` finish in :func:`exact_terms_lines`): the native intern
  table gives every distinct word its own id at pack time
  (``ingest.run_overlapped_exact``), so the device's integer counts, DF
  and top-k are word-exact and the host rescores in float64 from the
  wire's integers, re-reading only the documents whose tie group runs
  past the wire.
* **hashed-rerank** (:func:`exact_topk`): a hashed run keeps a margin of
  candidate buckets per doc (``wire_vals=False``); the host re-tokenizes
  the documents, keeps the words whose bucket made the doc's selection,
  counts their exact DF over the corpus and rescores them. A word whose
  bucket was pushed out of the selection by a collision partner stays
  lost; a wider margin shrinks that window (:func:`margin_check`).

The entry points choose the device-exact engine and switch to the
hashed one when the corpus holds more distinct words than the vocab
(``ExactVocabOverflow``), the native intern table is not built, or the
corpus is past the resident budget: the JAX package's engine choice,
logged as an ``exact_engine_fallback`` event. Every entry point that
runs the device takes ``device=None`` (CUDA unless named).
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from tfidf_tpu_torch.config import PipelineConfig, TokenizerKind
from tfidf_tpu_torch.io import fast_tokenizer
from tfidf_tpu_torch.obs import log as obs_log
from tfidf_tpu_torch.ops.hashing import words_to_ids
from tfidf_tpu_torch.ops.tokenize import whitespace_tokenize

DocTerms = List[Tuple[bytes, float]]


def margin_check(df, margin: int, *, occupied: Optional[int] = None,
                 vocab_size: Optional[int] = None) -> Optional[str]:
    """Collision-pressure guard for the exact-terms margin: estimates
    the vocab load factor from the occupied-bucket fraction (alpha =
    -ln(1 - B/V) under uniform hashing) and returns a warning when
    ``margin`` is below the measured-safe level for it (margin 4 up to
    alpha 0.25, 8 beyond), else None. Takes a DF vector ``df`` or the
    ``occupied``/``vocab_size`` pair (``IngestResult.df_occupied``)."""
    if df is not None:
        df = np.asarray(df)
        occupied, vocab_size = int((df > 0).sum()), df.size
    occ = float(occupied) / vocab_size
    alpha = -math.log(max(1.0 - min(occ, 0.999999), 1e-12))
    suggested = 4 if alpha <= 0.25 else 8
    if margin >= suggested:
        return None
    return (f"vocab load factor ~{alpha:.2f} (occupancy {occ:.2f}): "
            f"exact-terms margin {margin} may miss exact top-k words — "
            f"measured-safe margin here is {suggested} (docs/EXACT.md)")


def exact_topk_from_wire(exact, k: int, input_dir: str,
                         cfg: PipelineConfig,
                         max_tokens: Optional[int] = None
                         ) -> Dict[str, DocTerms]:
    """Float64 rescore of a device-exact selection (an
    ``ingest.ExactIngest``): tf = count/docSize, idf = ln(N/df) in the
    reference's op order (``TFIDF.c:202,243``), from the wire's
    integers. Returns name -> ``[(word, score), ...]``, score descending
    then word ascending, at most k entries, positive scores only.

    Boundary ties: a tie group (equal scores, e.g. a doc's corpus-hapax
    words) can run past the device's K' candidates, and its word-ascending
    members cannot then be chosen from the wire. Such docs (a full wire
    whose last positive score lies within float32 rounding of the k-th,
    in a doc longer than K' tokens) are resolved from the document
    itself: tokenize it, join its counts with the wire's exact [V] DF."""
    lens = np.maximum(exact.lengths.astype(np.float64), 1.0)
    valid = exact.topk_counts > 0
    tf = exact.topk_counts.astype(np.float64) / lens[:, None]
    dfsel = np.where(valid, exact.df[np.maximum(exact.topk_ids, 0)], 1)
    idf = np.log(float(exact.num_docs) / dfsel.astype(np.float64))
    scores = np.where(valid, tf * idf, 0.0)
    # (score desc, word asc): each id's rank in byte order, then one
    # lexsort per row.
    words = exact.words
    rank = np.empty(max(len(words), 1), dtype=np.int64)
    rank[np.asarray(sorted(range(len(words)), key=words.__getitem__),
                    dtype=np.int64)] = np.arange(len(words))
    wr = rank[np.maximum(exact.topk_ids, 0)]
    sel = np.lexsort((wr, -scores), axis=1)
    sc = np.take_along_axis(scores, sel, axis=1)
    ids = np.take_along_axis(exact.topk_ids, sel, axis=1)
    kprime = sc.shape[1]
    kk = min(k, kprime)
    full = valid.all(axis=1)
    if kprime > 0:
        near = (sc[:, kk - 1] - sc[:, kprime - 1]) <= sc[:, kk - 1] * 4e-6
        tied = full & near & (sc[:, kprime - 1] > 0.0) \
            & (exact.lengths > kprime)
    else:
        tied = np.zeros(sc.shape[0], bool)
    sc_l = sc[:, :kk].tolist()
    id_l = ids[:, :kk].tolist()
    out: Dict[str, DocTerms] = {}
    for d, name in enumerate(exact.names):
        if tied[d]:
            continue  # resolved below from the document itself
        row_sc, row_id, row = sc_l[d], id_l[d], []
        for j in range(kk):
            s = row_sc[j]
            if s <= 0.0:
                break  # sorted descending: the rest are zero or invalid
            row.append((words[row_id[j]], s))
        out[name] = row
    if tied.any():
        word2id = {w: i for i, w in enumerate(words)}
        n = float(exact.num_docs)
        for d in np.flatnonzero(tied):
            name = exact.names[d]
            toks, size = _doc_words(input_dir, name, cfg, max_tokens)
            counts: Dict[bytes, int] = {}
            for w in toks:
                counts[w] = counts.get(w, 0) + 1
            scored = []
            for w, c in counts.items():
                s = (c / max(size, 1)) \
                    * float(np.log(n / exact.df[word2id[w]]))
                if s > 0.0:
                    scored.append((w, s))
            scored.sort(key=lambda t: (-t[1], t[0]))
            out[name] = scored[:k]
    return out


def _log_fallback(why: str, error: str) -> None:
    obs_log.log_event("info", "exact_engine_fallback",
                      msg=f"exact-terms: {why}; using hashed re-rank engine",
                      error=error)


def exact_terms(input_dir: str, cfg: PipelineConfig, k: int, *,
                doc_len: Optional[int] = None, chunk_docs: int = 8192,
                strict: bool = True, device=None):
    """Exact-terms mode with the engine choice: the device-exact engine
    (``ingest.run_overlapped_exact`` + :func:`exact_topk_from_wire`),
    else the hashed re-rank engine. ``cfg.topk`` is the hashed engine's
    margin selection; the device-exact engine uses :func:`_device_cfg`'s.
    Returns ``(per_doc, engine)``, engine "device-exact" or
    "hashed-rerank"."""
    length = doc_len or cfg.max_doc_len  # the ingest's truncation
    exact = None
    if fast_tokenizer.intern_available():
        from tfidf_tpu_torch.ingest import run_overlapped_exact
        try:
            # Only the ingest may switch engines; a fault in the rescore
            # below must surface.
            exact = run_overlapped_exact(input_dir, _device_cfg(cfg, k),
                                         chunk_docs=chunk_docs,
                                         doc_len=doc_len, strict=strict,
                                         device=device)
        except (fast_tokenizer.ExactVocabOverflow, ValueError) as e:
            _log_fallback(f"device-exact path unavailable ({e})", str(e))
    else:
        _log_fallback("native intern table not built", "no-intern")
    if exact is not None:
        return (exact_topk_from_wire(exact, k, input_dir, cfg,
                                     max_tokens=length), "device-exact")
    return _exact_terms_fallback(input_dir, cfg, k, doc_len=doc_len,
                                 chunk_docs=chunk_docs, strict=strict,
                                 device=device)


def _device_cfg(cfg: PipelineConfig, k: int) -> PipelineConfig:
    """The device-exact selection: margin k+8 (at least k+1, at most
    ``cfg.topk``). With collision-free ids the spare slots only expose a
    boundary tie, which then resolves doc-locally, so the margin does
    not scale with ``cfg.topk``; it must exceed k, or every full wire
    would look tied."""
    dev_topk = k + 8 if cfg.topk is None \
        else max(k + 1, min(cfg.topk, k + 8))
    return dataclasses.replace(cfg, topk=dev_topk)


def exact_terms_lines(input_dir: str, cfg: PipelineConfig, k: int, *,
                      doc_len: Optional[int] = None,
                      chunk_docs: int = 8192, strict: bool = True,
                      spill: str = "auto", device=None):
    """Exact-terms mode to the final output bytes: ingest, float64
    rescore, per-doc and global sort, reference formatting. The
    device-exact engine finishes in native code (``InternSession.emit``,
    boundary ties resolved against the live intern table); the hashed
    engine through :func:`exact_topk` and Python line assembly.

    Returns ``(lines, engine, sample_fn)``: the sorted output bytes
    (trailing newline included), the engine, and ``sample_fn(names)``
    building the per-doc ``[(word, score), ...]`` lists of a doc subset
    (recall) without the full-corpus dict."""
    length = doc_len or cfg.max_doc_len  # the ingest's truncation
    if fast_tokenizer.intern_available():
        from tfidf_tpu_torch.ingest import run_overlapped_exact
        with fast_tokenizer.InternSession(cfg.vocab_size) as sess:
            try:
                exact = run_overlapped_exact(input_dir, _device_cfg(cfg, k),
                                             chunk_docs=chunk_docs,
                                             doc_len=doc_len, strict=strict,
                                             session=sess, device=device)
            except (fast_tokenizer.ExactVocabOverflow, ValueError) as e:
                _log_fallback(f"device-exact path unavailable ({e})",
                              str(e))
                exact = None
            if exact is not None:
                lines, per_doc, offs, lens, scores, wblob = sess.emit(
                    input_dir, exact.names, exact.topk_ids,
                    exact.topk_counts, exact.df, exact.lengths,
                    exact.num_docs, k, cfg.truncate_tokens_at, length,
                    seed=cfg.hash_seed)
                starts = np.zeros(len(per_doc) + 1, dtype=np.int64)
                np.cumsum(per_doc, out=starts[1:])

                def sample_fn(names):
                    want = set(names)
                    return {name: [(wblob[offs[j]:offs[j] + lens[j]],
                                    float(scores[j]))
                                   for j in range(int(starts[d]),
                                                  int(starts[d + 1]))]
                            for d, name in enumerate(exact.names)
                            if name in want}

                return lines, "device-exact", sample_fn
    else:
        _log_fallback("native intern table not built", "no-intern")

    per_doc_dict, engine = _exact_terms_fallback(
        input_dir, cfg, k, doc_len=doc_len, chunk_docs=chunk_docs,
        strict=strict, spill=spill, device=device)
    lines_list = sorted(b"%s@%s\t%.16f" % (name.encode(), w, s)
                        for name, terms in per_doc_dict.items() if name
                        for w, s in terms)
    lines = b"".join(line + b"\n" for line in lines_list)
    return lines, engine, (lambda names: {n: per_doc_dict[n] for n in names
                                          if n in per_doc_dict})


def _exact_terms_fallback(input_dir: str, cfg: PipelineConfig, k: int, *,
                          doc_len: Optional[int], chunk_docs: int,
                          strict: bool, spill: str = "auto", device=None):
    """The hashed re-rank engine: the ids-only ingest
    (``run_overlapped(wire_vals=False)``; ``spill`` reaches its
    streaming regime), then :func:`exact_topk` with the ingest's
    truncation."""
    from tfidf_tpu_torch.ingest import run_overlapped

    r = run_overlapped(input_dir, cfg, chunk_docs=chunk_docs,
                       doc_len=doc_len, strict=strict, wire_vals=False,
                       spill=spill, device=device)
    return (exact_topk(input_dir, r.names, r.topk_ids, r.num_docs, cfg,
                       k=k, max_tokens=doc_len or cfg.max_doc_len,
                       df_occupied=r.df_occupied), "hashed-rerank")


def _doc_words(input_dir: str, name: str, cfg: PipelineConfig,
               max_tokens: Optional[int]) -> Tuple[List[bytes], int]:
    """Exact host tokenization of one document as the packer saw it:
    tokens past ``max_tokens`` are dropped (count and content)."""
    with open(os.path.join(input_dir, name), "rb") as f:
        data = f.read()
    words = None
    if cfg.truncate_tokens_at is None:
        words = fast_tokenizer.tokenize_spans(data)  # native when built
    if words is None:
        words = whitespace_tokenize(data, cfg.truncate_tokens_at)
    if max_tokens is not None:
        words = words[:max_tokens]
    return words, len(words)


def exact_topk(input_dir: str, names: Sequence[str], topk_ids: np.ndarray,
               num_docs: int, cfg: PipelineConfig, k: int,
               docs: Optional[Iterable[str]] = None,
               max_tokens: Optional[int] = None,
               df: Optional[np.ndarray] = None,
               df_occupied: Optional[int] = None) -> Dict[str, DocTerms]:
    """Exact-string top-k for ``docs`` (default every named row) from a
    hashed selection ``topk_ids`` [D, K'] (rows in ``names`` order; -1
    pads). ``num_docs`` drives the exact IDF; ``max_tokens`` is the
    device batch's truncation, when one was used; ``df`` or
    ``df_occupied`` arms the :func:`margin_check` warning. Returns
    name -> ``[(word, score), ...]``: exact float64 TF-IDF, score
    descending then word ascending, at most k, positive scores only.

    The whole corpus without a doc subset goes through the native
    re-rank when it is built (``native/rerank.cc``); the Python passes
    below are the same semantics: exact counts of each doc's candidate
    words (those whose bucket made its selection), their exact DF over
    the corpus, the reference's float64 score."""
    if (df is not None or df_occupied is not None) \
            and np.asarray(topk_ids).ndim == 2 and k > 0:
        m = max(np.asarray(topk_ids).shape[1] // k, 1)
        if df_occupied is not None:
            warn = margin_check(None, m, occupied=df_occupied,
                                vocab_size=cfg.vocab_size)
        else:
            warn = margin_check(df, m)
        if warn is not None:
            obs_log.log_event("warning", "margin_pressure",
                              msg=f"warning: {warn}")

    # Padding rows carry '' names: skip them everywhere.
    want = [n for n in (docs if docs is not None else names) if n]
    rows = {n: i for i, n in enumerate(names)}

    if docs is None and cfg.tokenizer is TokenizerKind.WHITESPACE \
            and fast_tokenizer.rerank_available():
        live = [n for n in names if n]
        native = fast_tokenizer.exact_rerank_paths(
            [os.path.join(input_dir, n) for n in live],
            np.asarray(topk_ids)[[rows[n] for n in live]], num_docs,
            cfg.vocab_size, cfg.hash_seed, cfg.truncate_tokens_at,
            max_tokens, k)
        if native is not None:
            return dict(zip(live, native))

    # Pass 1 (selected docs): exact counts of the candidate words.
    per_doc: Dict[str, Tuple[Dict[bytes, int], int]] = {}
    candidates: set = set()
    for name in want:
        words, size = _doc_words(input_dir, name, cfg, max_tokens)
        buckets = set(int(b) for b in topk_ids[rows[name]] if b >= 0)
        if not words or not buckets:
            per_doc[name] = ({}, size)
            continue
        uniq = sorted(set(words))
        ids = words_to_ids(uniq, cfg.vocab_size, cfg.hash_seed)
        keep = {w for w, b in zip(uniq, ids) if int(b) in buckets}
        counts: Dict[bytes, int] = {}
        for w in words:
            if w in keep:
                counts[w] = counts.get(w, 0) + 1
        per_doc[name] = (counts, size)
        candidates.update(keep)

    # Pass 2 (whole corpus): exact DF of the candidate set only.
    exact_df: Dict[bytes, int] = {w: 0 for w in candidates}
    if candidates:
        for name in names:
            if not name:
                continue
            words, _ = _doc_words(input_dir, name, cfg, max_tokens)
            for w in set(words) & candidates:
                exact_df[w] += 1

    # The reference's op order: float64, natural log.
    out: Dict[str, DocTerms] = {}
    for name in want:
        counts, size = per_doc[name]
        scored = []
        for w, c in counts.items():
            tf = 1.0 * c / size
            idf = np.log(1.0 * num_docs / exact_df[w])
            if tf * idf > 0.0:
                scored.append((w, float(tf * idf)))
        scored.sort(key=lambda t: (-t[1], t[0]))
        out[name] = scored[:k]
    return out
