"""Where a fault is planted in the program underneath the harness's own
driver code: the ways a kind's program can be reached from the harness's
process. Each patch is a ``monkeypatch`` of the port's module."""

import torch


def df_fold(monkeypatch, fn):
    """``fn(orig, ids, head, vocab_size)`` in place of the ingest's DF
    fold (``ops.sparse.sparse_df``)."""
    from tfidf_tpu_torch import ingest
    from tfidf_tpu_torch.ops import sparse
    orig = sparse.sparse_df

    def sparse_df(ids, head, vocab_size):
        return fn(orig, ids, head, vocab_size)

    monkeypatch.setattr(ingest, "sparse_df", sparse_df)
    monkeypatch.setattr(sparse, "sparse_df", sparse_df)


def df_unchanged(monkeypatch):
    """The DF fold returns its accumulator unchanged."""
    df_fold(monkeypatch, lambda orig, ids, head, v: torch.zeros(
        v, dtype=torch.int32, device=ids.device))


def search_answers(monkeypatch, alter):
    """``alter(vals, ids)`` applied to each search batch's answers where
    the retriever produces them."""
    from tfidf_tpu_torch.models import retrieval
    orig = retrieval.TfidfRetriever.search_async

    def search_async(self, queries, k=10, **kw):
        pending = orig(self, queries, k, **kw)
        return retrieval.PendingSearch(
            lambda: alter(*[a.copy() for a in pending.materialize()]))

    monkeypatch.setattr(retrieval.TfidfRetriever, "search_async",
                        search_async)


def ingest_result(monkeypatch, alter):
    """``alter(topk_ids)`` applied to each overlapped ingest pass's
    per-document picks."""
    from tfidf_tpu_torch import ingest
    orig = ingest.run_overlapped

    def run_overlapped(*a, **kw):
        r = orig(*a, **kw)
        r.topk_ids = alter(r.topk_ids.copy())
        return r

    monkeypatch.setattr(ingest, "run_overlapped", run_overlapped)
