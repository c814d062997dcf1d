"""The segmented index in the port (tfidf_tpu_torch/index/: Segment,
SegmentedIndex, IndexView, Compactor; ops/sparse.sorted_term_counts_host)
against the JAX package's, on the CPU.

Contracts, as the port states them:

* ``sorted_term_counts_host`` equals ``sorted_term_counts`` bit for bit
  (ids and head everywhere, counts at head slots), and the JAX package's
  mirror.
* Within the port, under any interleaving of add/update/delete/seal/
  compaction/save+restore, every ``IndexView.search`` — tfidf, bm25, a
  filter; tiled and untiled — equals a from-scratch
  ``SegmentedIndex.rebuild_retriever()`` bit for bit: score bytes, doc
  names and tie order.
* Against the JAX ``SegmentedIndex`` fed the same operations: the same
  row space, ids and tie order exact but for near-ties and scores within
  ``parity.compare_search``'s bounds (the two packages' float32 weights
  differ by a few ulp, which is also why six of the JAX package's own
  rebuild-parity tests fail under jax 0.9.0: never compare scores across
  the packages with ``array_equal``).
* Snapshots cross between the packages in both directions; restore
  rejects a plain retriever snapshot and a config mismatch.
* A ``swap`` fault during compaction leaves the index exactly as it was;
  the ``Compactor`` retries within its budget and dies past it.
"""

import contextlib
import os
import tempfile
import threading
import time

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from tfidf_tpu import checkpoint as jckpt
from tfidf_tpu.config import PipelineConfig as JConfig
from tfidf_tpu.config import VocabMode as JVocab
from tfidf_tpu.index import Segment as JSegment
from tfidf_tpu.index import SegmentedIndex as JIndex
from tfidf_tpu.io.corpus import Corpus as JCorpus
from tfidf_tpu.models import TfidfRetriever as JRetriever
from tfidf_tpu.ops.sparse import sorted_term_counts_host as j_host_counts

from tfidf_tpu_torch import checkpoint as tckpt
from tfidf_tpu_torch import faults as tfaults
from tfidf_tpu_torch.config import PipelineConfig as TConfig
from tfidf_tpu_torch.config import VocabMode as TVocab
from tfidf_tpu_torch.index import Compactor, IndexView, Segment
from tfidf_tpu_torch.index import SegmentedIndex as TIndex
from tfidf_tpu_torch.io.corpus import Corpus as TCorpus
from tfidf_tpu_torch.models import TfidfRetriever as TRetriever
from tfidf_tpu_torch.ops.sparse import (sorted_term_counts,
                                        sorted_term_counts_host)
from tfidf_tpu_torch.parity import compare_search

KW = dict(vocab_size=512, max_doc_len=16, doc_chunk=16)
JCFG = JConfig(vocab_mode=JVocab.HASHED, **KW)
TCFG = TConfig(vocab_mode=TVocab.HASHED, **KW)
DOCS = {
    "doc1": "apple banana apple cherry",
    "doc2": "banana banana date",
    "doc3": "cherry date elder fig",
    "doc4": "apple fig fig fig",
    "doc5": "grape grape grape grape",
}
QUERIES = ["apple cherry", "banana", "grape date", "fig", "elder",
           "apple fig", "date banana cherry", "nosuchword"]
WORDS = ["apple", "banana", "cherry", "date", "elder", "fig", "grape",
         "melon", "kiwi", "lime", "nut", "olive", "pear", "quince"]
# (scorer, filter) settings every search parity check runs
SETTINGS = [{}, {"scorer": "bm25"}, {"scorer": "bm25:k1=1.5,b=0.6"},
            {"filter": {"prefix": "doc"}}, {"filter": {"id_range": [2, 9]}},
            {"scorer": "bm25", "filter": {"ids": [0, 3, 5, 8]}}]


def _corpus(cls, docs):
    return cls(names=list(docs), docs=[t.encode() for t in docs.values()])


def build(docs=DOCS, delta_docs=4, compact_at=2):
    return TIndex.from_corpus(_corpus(TCorpus, docs), TCFG,
                              delta_docs=delta_docs, compact_at=compact_at,
                              device="cpu")


def build_jax(docs=DOCS, delta_docs=4, compact_at=2):
    return JIndex.from_corpus(_corpus(JCorpus, docs), JCFG,
                              delta_docs=delta_docs, compact_at=compact_at)


def names_of(names, ids):
    return [[names[i] if i >= 0 else None for i in row] for row in ids]


@contextlib.contextmanager
def tiling(value):
    old = os.environ.get("TFIDF_TPU_SCORE_TILING")
    os.environ["TFIDF_TPU_SCORE_TILING"] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("TFIDF_TPU_SCORE_TILING")
        else:
            os.environ["TFIDF_TPU_SCORE_TILING"] = old


def _oracle_filter(view: IndexView, oracle, flt):
    """The rebuild's filter for a view filter: positional filters pick
    view rows, so they become the rebuild positions of the same live
    docs; name prefixes need no mapping."""
    if flt is None or "prefix" in flt:
        return flt
    live = view._stacked()[2].numpy()
    if "ids" in flt:
        pos = [p for p in flt["ids"] if p < len(view.names)]
    else:
        pos = range(flt["id_range"][0], min(flt["id_range"][1],
                                            len(view.names)))
    where = {n: i for i, n in enumerate(oracle.names)}
    return {"ids": sorted(where[view.names[p]] for p in pos if live[p])}


def assert_rebuild_parity(idx, queries=QUERIES, k=3, settings_=SETTINGS):
    """Every setting, tiled and untiled: the view equals a from-scratch
    rebuild of the live corpus bit for bit (score bytes, names, order)."""
    view = idx.view()
    oracle = idx.rebuild_retriever() if idx.num_docs else None
    for kw in settings_:
        flt = kw.get("filter")
        okw = dict(kw)
        if oracle is not None and flt is not None:
            okw["filter"] = _oracle_filter(view, oracle, flt)
        for mode in ("on", "off"):
            with tiling(mode):
                vals, ids = view.search(queries, k, **kw)
                if oracle is None:
                    assert vals.shape == (len(queries), 0)
                    continue
                ovals, oids = oracle.search(queries, k, **okw)
            np.testing.assert_array_equal(vals.view(np.uint32),
                                          ovals.view(np.uint32))
            assert names_of(view.names, ids) == names_of(oracle.names, oids)


def assert_jax_parity(tidx, jidx, queries=QUERIES, k=3):
    """The two packages' views: the same row space and names, search ids
    exact but for near-ties, scores within compare_search's bounds."""
    tv, jv = tidx.view(), jidx.view()
    assert tv.names == jv.names and tv._num_docs == jv._num_docs
    ts, js = tidx.stats(), jidx.stats()
    for stats in (ts, js):
        stats.pop("version")  # a restore starts its own count
    assert ts == js
    for kw in SETTINGS:
        a = tv.search(queries, k, **kw)
        b = jv.search(queries, k, **kw)
        rep = compare_search(*a, *(np.asarray(x) for x in b),
                             val_ulps=4 if "scorer" in kw else 0)
        assert rep["ok"], (kw, rep)


# --- primitives ------------------------------------------------------

@pytest.mark.parametrize("seed,shape,vocab", [
    (0, (7, 12), 64), (1, (1, 1), 4), (2, (16, 33), 3), (3, (5, 64), 1 << 12),
    (4, (9, 8), 2), (5, (0, 8), 16)])
def test_host_sorted_counts_equal_device(seed, shape, vocab):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, size=shape).astype(np.int32)
    lens = rng.integers(-1, shape[1] + 2, size=shape[:1]).astype(np.int32)
    ids_d, counts_d, head_d = sorted_term_counts(torch.from_numpy(toks),
                                                 torch.from_numpy(lens))
    ids_h, counts_h, head_h = sorted_term_counts_host(toks, lens)
    np.testing.assert_array_equal(ids_d.numpy(), ids_h)
    np.testing.assert_array_equal(head_d.numpy(), head_h)
    # counts are garbage by contract off head slots: compare there only
    np.testing.assert_array_equal(counts_d.numpy()[head_h], counts_h[head_h])
    jids, jcounts, jhead = j_host_counts(toks, lens)
    np.testing.assert_array_equal(ids_h, jids)
    np.testing.assert_array_equal(counts_h, jcounts)
    np.testing.assert_array_equal(head_h, jhead)


def _rows(seed, n, length=8, vocab=64):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (n, length)).astype(np.int32)
    lens = rng.integers(0, length + 1, n).astype(np.int32)
    return (*sorted_term_counts_host(toks, lens), lens)


def test_add_rows():
    rng = np.random.default_rng(1)
    toks = rng.integers(0, 64, (7, 8)).astype(np.int32)
    lens = rng.integers(0, 9, 7).astype(np.int32)
    ids, counts, head = sorted_term_counts_host(toks, lens)
    names = [f"n{i}" for i in range(7)]
    seg = Segment(8, 8, 64)
    assert list(seg.add_rows(ids[:6], counts[:6], head[:6], lens[:6],
                             names[:6])) == list(range(6))
    assert seg.add_row(ids[6], counts[6], head[6], int(lens[6]),
                       names[6]) == 6
    want_df = np.zeros(64, np.int32)
    for t, n in zip(toks, lens):
        want_df[np.unique(t[:n])] += 1
    np.testing.assert_array_equal(seg.df, want_df)
    np.testing.assert_array_equal(seg.ids[:7], ids)
    np.testing.assert_array_equal(seg.counts[:7], counts)
    np.testing.assert_array_equal(seg.head[:7], head)
    np.testing.assert_array_equal(seg.lengths[:7], lens)
    assert seg.live.tolist() == [True] * 7 + [False]
    assert seg.names == names + [None]
    assert (seg.used, seg.content_rev) == (7, 7)
    with pytest.raises(RuntimeError, match="full"):
        seg.add_rows(ids[:2], counts[:2], head[:2], lens[:2], names[:2])
    seg.seal()
    with pytest.raises(RuntimeError, match="sealed"):
        seg.add_rows(ids[:1], counts[:1], head[:1], lens[:1], names[:1])


def test_segment_validation():
    with pytest.raises(ValueError):
        Segment(0, 16, 512)
    with pytest.raises(ValueError):
        Segment(4, 0, 512)
    with pytest.raises(ValueError):
        TIndex(TCFG, delta_docs=0, device="cpu")
    with pytest.raises(ValueError):
        TIndex(TCFG, compact_at=1, device="cpu")
    with pytest.raises(ValueError, match="HASHED"):
        TIndex(TConfig(), device="cpu")    # EXACT vocab
    seg = Segment(1, 4, 8)
    seg.add_row(*(a[0] for a in _rows(2, 1, 4, 8)[:3]), 2, "x")
    with pytest.raises(RuntimeError, match="full"):
        seg.add_row(*(a[0] for a in _rows(2, 1, 4, 8)[:3]), 2, "y")


@pytest.mark.parametrize("direction", ["port", "port_to_jax", "jax_to_port"])
def test_segment_arrays_round_trip(direction):
    ids, counts, head, lens = _rows(3, 5)
    src = (JSegment if direction == "jax_to_port" else Segment)(8, 8, 64,
                                                                seg_id=7)
    for i in range(5):
        src.add_row(ids[i], counts[i], head[i], int(lens[i]), f"d{i}")
    src.tombstone(1)
    src.tombstone(1)  # a second tombstone changes nothing
    src.seal()
    arrays = src.to_arrays("seg0_")
    meta = {"used": src.used, "sealed": True, "seg_id": src.seg_id}
    dst = (JSegment if direction == "port_to_jax" else Segment).from_arrays(
        "seg0_", arrays, meta, 64)
    for f in ("ids", "counts", "head", "lengths", "live", "df", "names",
              "used", "seg_id", "sealed"):
        np.testing.assert_array_equal(getattr(dst, f), getattr(src, f))
    assert dst.live_docs == 4 and dst.tombstones == 1


def test_device_triple_is_a_copy_cached_per_revision():
    ids, counts, head, lens = _rows(4, 3)
    seg = Segment(4, 8, 64)
    seg.add_rows(ids[:2], counts[:2], head[:2], lens[:2], ["a", "b"])
    cpu = torch.device("cpu")
    first = seg.device_triple(cpu)
    assert seg.device_triple(cpu)[0] is first[0]   # cached
    seg.tombstone(0)
    assert seg.device_triple(cpu)[0] is first[0]   # tombstones ride apart
    before = first[0].clone()
    seg.add_row(ids[2], counts[2], head[2], int(lens[2]), "c")
    assert torch.equal(first[0], before)           # no alias of the host
    again = seg.device_triple(cpu)
    assert again[0] is not first[0]
    np.testing.assert_array_equal(again[0].numpy(), seg.ids)


# --- bit parity with the rebuild, and with the JAX package ------------

def test_initial_build_parity():
    idx = build()
    assert_rebuild_parity(idx)
    assert_jax_parity(idx, build_jax())


def test_parity_vs_natural_retriever_build():
    idx = build()
    view = idx.view()
    r = TRetriever(TCFG, device="cpu").index(_corpus(TCorpus, DOCS))
    vals, ids = view.search(QUERIES, 3)
    ovals, oids = r.search(QUERIES, 3)
    np.testing.assert_array_equal(vals.view(np.uint32), ovals.view(np.uint32))
    assert names_of(view.names, ids) == names_of(r.names, oids)


def test_add_update_delete_parity():
    idx, jidx = build(), build_jax()
    for x in (idx, jidx):
        x.add_docs(["doc6", "doc7"], ["grape melon", "melon apple date"])
    assert_rebuild_parity(idx)
    for x in (idx, jidx):
        x.add_docs(["doc2"], ["banana melon melon"])     # update
    assert_rebuild_parity(idx)
    for x in (idx, jidx):
        x.delete_docs(["doc5", "doc1"])
    assert_rebuild_parity(idx)
    assert_jax_parity(idx, jidx)


def _synth(rng):
    n = int(rng.integers(1, 9))
    return " ".join(WORDS[int(rng.integers(0, len(WORDS)))] for _ in range(n))


def _apply(op, arg, pair, alive, next_id, tmp):
    """One operation on both packages' indexes; returns the pair (a
    save+restore crosses the packages' snapshots)."""
    rng = np.random.default_rng(arg)
    tidx, jidx = pair
    if op == 0 or len(alive) <= 2:                 # add
        name = f"doc{next_id[0]}"
        next_id[0] += 1
        text = _synth(rng)
        for x in pair:
            x.add_docs([name], [text])
        alive.add(name)
    elif op == 1:                                  # update in place
        name = sorted(alive)[int(rng.integers(0, len(alive)))]
        text = _synth(rng)
        for x in pair:
            x.add_docs([name], [text])
    elif op == 2:                                  # delete (or a miss)
        name = (sorted(alive)[int(rng.integers(0, len(alive)))]
                if arg % 5 else "ghost")
        for x in pair:
            x.delete_docs([name])
        alive.discard(name)
    elif op == 3:                                  # compact
        for x in pair:
            x.compact(force=bool(arg % 2))
    else:                                          # save + restore, crossed
        tdir, jdir = os.path.join(tmp, f"t{arg}"), os.path.join(tmp, f"j{arg}")
        tidx.save(tdir, epoch=arg % 100)
        jidx.save(jdir, epoch=arg % 100)
        tidx, tmeta = TIndex.restore(jdir, TCFG, device="cpu")
        jidx, jmeta = JIndex.restore(tdir, JCFG)
        assert tmeta["epoch"] == jmeta["epoch"] == arg % 100
    return tidx, jidx


@settings(max_examples=12, deadline=None)
@given(st.lists(st.tuples(st.integers(0, 4), st.integers(0, 10 ** 6)),
                min_size=3, max_size=14))
def test_property_random_interleavings(ops):
    """Random mutation streams with seals, compactions and crossed
    save/restores: within the port, parity with the rebuild after every
    visibility change; against the JAX package, at the end."""
    pair = (build(delta_docs=3, compact_at=2),
            build_jax(delta_docs=3, compact_at=2))
    alive, next_id = set(DOCS), [6]
    with tempfile.TemporaryDirectory() as tmp:
        for op, arg in ops:
            pair = _apply(op, arg, pair, alive, next_id, tmp)
            assert_rebuild_parity(pair[0], QUERIES[:4])
    assert pair[0].num_docs == pair[1].num_docs == len(alive)
    assert_jax_parity(*pair)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_seeded_interleavings(tmp_path, seed):
    rng = np.random.default_rng(seed)
    pair = (build(delta_docs=3, compact_at=2),
            build_jax(delta_docs=3, compact_at=2))
    alive, next_id = set(DOCS), [6]
    for step in range(20):
        op = 4 if step == 11 else int(rng.integers(0, 4))
        pair = _apply(op, int(rng.integers(0, 10 ** 6)), pair, alive,
                      next_id, str(tmp_path))
        assert_rebuild_parity(pair[0], QUERIES[:3], settings_=SETTINGS[:2])
    assert_rebuild_parity(pair[0])
    assert_jax_parity(*pair)


def test_all_deleted_and_width():
    idx = build(delta_docs=4)
    view = idx.view()
    assert view.search(QUERIES[:2], 10)[0].shape == (2, 5)  # min(k, D)
    idx.delete_docs(list(DOCS))
    vals, ids = idx.view().search(QUERIES[:2], 3)
    assert vals.shape == (2, 0) and ids.shape == (2, 0)
    assert idx.num_docs == 0
    with pytest.raises(RuntimeError, match="live doc"):
        idx.rebuild_retriever()


def test_tie_order_matches_rebuild():
    # identical docs score the same: the winners come out in insertion
    # order on both paths, across segment boundaries
    docs = {f"t{i}": "same same words" for i in range(7)}
    docs["x"] = "other content"
    idx = build(docs, delta_docs=3, compact_at=2)
    idx.add_docs(["t7", "t8"], ["same same words"] * 2)
    idx.delete_docs(["t2"])
    assert_rebuild_parity(idx, ["same words", "other"], k=6)
    idx.compact(force=True)
    assert_rebuild_parity(idx, ["same words", "other"], k=6)


def test_more_queries_than_the_legacy_block():
    idx = build(delta_docs=2)
    idx.add_docs(["a1", "a2", "a3"], ["kiwi apple", "lime", "melon fig"])
    queries = [" ".join(WORDS[(i + j) % len(WORDS)] for j in range(i % 4 + 1))
               for i in range(70)]
    assert_rebuild_parity(idx, queries, k=4, settings_=SETTINGS[:2])


# --- segment lifecycle ----------------------------------------------

def test_seal_on_full_delta():
    idx = build(delta_docs=2)
    assert idx.sealed_count == 1            # the bulk-load base
    out = idx.add_docs(["a1", "a2", "a3"], ["kiwi", "lime", "melon"])
    assert out["sealed"] == 1 and out["added"] == 3
    assert idx.sealed_count == 2
    assert idx.stats()["delta_used"] == 1
    assert idx.view().num_segments == 3
    assert_rebuild_parity(idx)


def test_compaction_drops_tombstones_preserves_order():
    idx = build(delta_docs=2, compact_at=2)
    idx.add_docs(["a1", "a2", "a3", "a4"],
                 ["kiwi", "lime", "melon", "kiwi lime"])
    idx.delete_docs(["doc2", "a1"])
    assert idx.needs_compaction
    assert idx.stats()["tombstones"] >= 2
    order = idx.live_rows()[2]
    summary = idx.compact()
    assert summary["dropped_tombstones"] >= 2
    assert summary["segments_in"] == 2 and summary["capacity"] == 8
    assert idx.sealed_count == 1
    assert idx.stats()["tombstones"] == 0
    assert idx.live_rows()[2] == order
    assert idx.compactions[-1] == summary
    assert_rebuild_parity(idx)


def test_compact_below_threshold_noop():
    idx = build(delta_docs=8, compact_at=4)
    v0 = idx.version
    assert idx.compact() is None            # 1 sealed < threshold
    assert idx.compact(force=True) is None  # force still needs >= 2
    assert idx.version == v0


def test_delete_missing_is_not_a_visibility_change():
    idx = build()
    v0 = idx.version
    view = idx.view()
    out = idx.delete_docs(["nope"])
    assert out == {"deleted": 0, "missing": 1, "version": v0}
    assert idx.view() is view                # cached per version
    idx.add_docs([], [])
    assert idx.version == v0
    with pytest.raises(ValueError, match="align"):
        idx.add_docs(["a"], [])
    idx.add_docs(["a"], [b"kiwi"])
    assert idx.version == v0 + 1 and idx.view() is not view


def test_views_are_immutable_snapshots():
    idx = build(delta_docs=2)
    old = idx.view()
    before = old.search(QUERIES, 3)
    bm25 = old.search(QUERIES, 3, scorer="bm25")
    idx.add_docs(["a1", "a2"], ["grape apple", "banana"])
    idx.delete_docs(["doc5"])
    idx.compact(force=True)
    for got, want in ((old.search(QUERIES, 3), before),
                      (old.search(QUERIES, 3, scorer="bm25"), bm25)):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    assert old.version < idx.version


def test_view_faces_and_arrays():
    idx = build(delta_docs=2)
    idx.add_docs(["a1"], ["kiwi"])
    view = idx.view()
    data, cols = view.scorer_face()
    r = idx.rebuild_retriever()
    rdata, rcols = r.scorer_face("tfidf")
    live = view._stacked()[2].numpy()[:data.shape[0]]
    np.testing.assert_array_equal(data[live].view(np.uint32),
                                  rdata.view(np.uint32))
    np.testing.assert_array_equal(cols[live], rcols)
    bdata, _ = view.scorer_face("bm25")
    rb, _ = r.scorer_face("bm25")
    np.testing.assert_array_equal(bdata[live].view(np.uint32),
                                  rb.view(np.uint32))
    view.search(QUERIES, 2, filter={"prefix": "a"})
    arrays = view.index_arrays()
    assert all(isinstance(a, torch.Tensor) for a in arrays)
    assert view.indexed and view.num_segments == 2


def test_from_dir(toy_corpus_dir):
    idx = TIndex.from_dir(toy_corpus_dir, TCFG, delta_docs=2, device="cpu")
    assert idx.num_docs == 6
    jidx = JIndex.from_dir(toy_corpus_dir, JCFG, delta_docs=2)
    assert_jax_parity(idx, jidx, ["the quick", "tpu mesh kernel"])
    assert_rebuild_parity(idx, ["the quick", "tpu mesh kernel"])


def test_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device available"):
        TIndex(TCFG)
    with pytest.raises(RuntimeError, match="no CUDA device available"):
        TIndex.from_corpus(_corpus(TCorpus, DOCS), TCFG)
    assert TIndex(TCFG, device="cpu").device.type == "cpu"


def test_search_while_mutating_in_another_thread():
    idx = build(delta_docs=2, compact_at=2)
    view = idx.view()
    want = view.search(QUERIES, 3)
    errors = []

    def mutate():
        try:
            for i in range(12):
                idx.add_docs([f"m{i}"], [WORDS[i % len(WORDS)]])
                idx.view()
                if i % 4 == 3:
                    idx.compact()
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    t = threading.Thread(target=mutate)
    t.start()
    while t.is_alive():
        got = view.search(QUERIES, 3)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    t.join()
    assert not errors
    assert_rebuild_parity(idx)


def test_concurrent_mutations_lose_nothing():
    # more threads than cores, a short switch interval: every add and
    # delete lands once, the DF stays exact (the rebuild parity)
    import sys
    idx = build(delta_docs=3, compact_at=2)
    errors = []

    def worker(w):
        try:
            for j in range(3):
                idx.add_docs([f"w{w}_{j}", f"w{w}_{j}b"],
                             [WORDS[(w + j) % len(WORDS)], "kiwi lime"])
                idx.delete_docs([f"w{w}_{j}b"])
                idx.view()
                idx.compact()
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(w,))
                   for w in range(2 * (os.cpu_count() or 4))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not errors
    assert idx.num_docs == len(DOCS) + 3 * len(threads)
    assert_rebuild_parity(idx, settings_=SETTINGS[:2])


# --- persistence -----------------------------------------------------

def test_save_restore_roundtrip(tmp_path):
    idx = build(delta_docs=3)
    idx.add_docs(["a1", "a2"], ["kiwi lime", "melon"])
    idx.delete_docs(["doc3"])
    d = str(tmp_path / "snap")
    assert idx.view().snapshot(d, epoch=5) == d
    idx2, meta = TIndex.restore(d, TCFG, device="cpu")
    assert meta["epoch"] == 5 and meta["num_docs"] == idx.num_docs
    assert idx2.stats() == {**idx.stats(), "version": idx2.version}
    v1, i1 = idx.view().search(QUERIES, 3)
    v2, i2 = idx2.view().search(QUERIES, 3)
    np.testing.assert_array_equal(v1.view(np.uint32), v2.view(np.uint32))
    assert names_of(idx.view().names, i1) == names_of(idx2.view().names, i2)
    assert "doc3" not in [n for row in names_of(idx2.view().names, i2)
                          for n in row]
    idx2.add_docs(["a3"], ["elder kiwi"])    # mutation continues
    assert_rebuild_parity(idx2)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_snapshots_cross_packages(tmp_path, direction):
    tidx, jidx = build(delta_docs=2), build_jax(delta_docs=2)
    for x in (tidx, jidx):
        x.add_docs(["a1", "a2", "a3"], ["kiwi lime", "melon", "doc grape"])
        x.delete_docs(["doc4"])
    d = str(tmp_path / "snap")
    if direction == "jax_to_port":
        jidx.save(d, epoch=3)
        restored, meta = TIndex.restore(d, TCFG, device="cpu")
        assert_jax_parity(restored, jidx)
        assert_rebuild_parity(restored)
    else:
        tidx.save(d, epoch=3)
        restored, meta = JIndex.restore(d, JCFG)
        assert_jax_parity(tidx, restored)
    assert meta["epoch"] == 3 and meta["segmented"]["length"] == 16


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_restore_rejects_plain_retriever_snapshot(tmp_path, pkg):
    d = str(tmp_path / "plain")
    if pkg == "port":
        TRetriever(TCFG, device="cpu").index(_corpus(TCorpus, DOCS)).snapshot(d)
    else:
        JRetriever(JCFG).index(_corpus(JCorpus, DOCS)).snapshot(d)
    with pytest.raises(tckpt.SnapshotMismatch, match="not a segmented"):
        TIndex.restore(d, TCFG, device="cpu")


def test_restore_rejects_config_mismatch(tmp_path):
    d = str(tmp_path / "snap")
    build().save(d)
    other = TConfig(vocab_mode=TVocab.HASHED, vocab_size=256,
                    max_doc_len=16, doc_chunk=16)
    with pytest.raises(tckpt.SnapshotMismatch, match="fingerprint"):
        TIndex.restore(d, other, device="cpu")
    with pytest.raises(jckpt.SnapshotMismatch):
        JIndex.restore(d, JConfig(vocab_mode=JVocab.HASHED, vocab_size=256,
                                  max_doc_len=16, doc_chunk=16))


# --- compactor chaos -------------------------------------------------

def _state(idx):
    return (idx.version, idx.stats(), idx.live_rows()[2],
            [(s.seg_id, s.used, s.live.tolist()) for s in idx._sealed])


def test_swap_fault_leaves_index_untouched():
    idx = build(delta_docs=2, compact_at=2)
    idx.add_docs(["a1", "a2", "a3"], ["kiwi", "lime", "melon"])
    assert idx.needs_compaction
    before_state = _state(idx)
    before = idx.view().search(QUERIES, 3)
    tfaults.arm(tfaults.FaultPlan.parse("swap:fatal:n=1"))
    try:
        with pytest.raises(tfaults.FatalFault):
            idx.compact()
    finally:
        tfaults.disarm()
    assert _state(idx) == before_state
    after = idx.view().search(QUERIES, 3)
    np.testing.assert_array_equal(before[0], after[0])
    np.testing.assert_array_equal(before[1], after[1])
    assert_rebuild_parity(idx)
    assert idx.compact() is not None       # the retry succeeds
    assert_rebuild_parity(idx)


def _run_compactor(idx, plan, budget, until):
    tfaults.arm(tfaults.FaultPlan.parse(plan))
    try:
        c = Compactor(idx.compact, period_s=0.01,
                      restart_budget=budget).start()
        try:
            t0 = time.monotonic()
            while not until(c) and time.monotonic() - t0 < 10.0:
                time.sleep(0.01)
        finally:
            c.stop()
    finally:
        tfaults.disarm()
    return c


def test_compactor_retries_within_budget():
    idx = build(delta_docs=2, compact_at=2)
    idx.add_docs(["a1", "a2", "a3"], ["kiwi", "lime", "melon"])
    c = _run_compactor(idx, "swap:fatal:n=2", 3,
                       lambda c: not idx.needs_compaction)
    assert not idx.needs_compaction        # recovered within budget
    assert c.restarts == 2 and not c.dead
    assert_rebuild_parity(idx)


def test_compactor_dies_past_budget():
    idx = build(delta_docs=2, compact_at=2)
    idx.add_docs(["a1", "a2", "a3"], ["kiwi", "lime", "melon"])
    c = _run_compactor(idx, "swap:fatal:n=-1", 1, lambda c: c.dead)
    assert c.dead and c.restarts == 2
    assert idx.needs_compaction            # nothing compacted, nothing
    assert_rebuild_parity(idx)             # corrupted


def test_compactor_arguments():
    with pytest.raises(ValueError):
        Compactor(lambda: None, period_s=0)
    with pytest.raises(ValueError):
        Compactor(lambda: None, restart_budget=-1)
    c = Compactor(lambda: None, period_s=0.01)
    assert c.start() is c.start()          # idempotent while running
    c.stop()
    assert c.restarts == 0 and not c.dead
