"""The check fails what it must: each fault a cell can have, planted in
the timed path underneath the harness's own driver code, and the control
(the lower precision in the program's place) come out not correct."""

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.control import served_control
from benchmark.reference.compare import verdict
from benchmark.tests import tiny

SPEC = harness.Layout().spec()
CELLS = [w["name"] for w in SPEC["workloads"]]
SERVED = [c for c in CELLS
          if harness.Layout().cell(c)["driver"] != "ingest_passes"]


def _served(cell):
    return cell in SERVED


def _patch_answers(monkeypatch, alter):
    from tfidf_tpu_torch.models import retrieval
    orig = retrieval.TfidfRetriever.search_async

    def search_async(self, queries, k=10, **kw):
        pending = orig(self, queries, k, **kw)
        return retrieval.PendingSearch(
            lambda: alter(*[a.copy() for a in pending.materialize()]))

    monkeypatch.setattr(retrieval.TfidfRetriever, "search_async",
                        search_async)


def _patch_df(monkeypatch, fn):
    from tfidf_tpu_torch import ingest
    from tfidf_tpu_torch.ops import sparse
    orig = sparse.sparse_df

    def sparse_df(ids, head, vocab_size):
        return fn(orig, ids, head, vocab_size)

    monkeypatch.setattr(ingest, "sparse_df", sparse_df)
    monkeypatch.setattr(sparse, "sparse_df", sparse_df)


def _patch_ingest_result(monkeypatch, alter):
    from tfidf_tpu_torch import ingest
    orig = ingest.run_overlapped

    def run_overlapped(*a, **kw):
        r = orig(*a, **kw)
        r.topk_ids = alter(r.topk_ids.copy())
        return r

    monkeypatch.setattr(ingest, "run_overlapped", run_overlapped)


def state_unchanged(monkeypatch, cell):
    """The DF fold returns its accumulator unchanged."""
    _patch_df(monkeypatch, lambda orig, ids, head, v: torch.zeros(
        v, dtype=torch.int32, device=ids.device))


def half_batch(monkeypatch, cell):
    """Half of each batch left out: of a search batch's answers, or of a
    chunk's rows in the DF fold."""
    if _served(cell):
        def alter(vals, ids):
            vals[len(vals) // 2:] = 0.0
            ids[len(ids) // 2:] = -1
            return vals, ids
        _patch_answers(monkeypatch, alter)
    else:
        _patch_df(monkeypatch, lambda orig, ids, head, v: orig(
            ids[:len(ids) // 2], head[:len(head) // 2], v))


def answer_altered(monkeypatch, cell):
    """One answer altered where it is produced: a picked id moved."""
    if _served(cell):
        def alter(vals, ids):
            ids[0, 0] = ids[0, 0] + 1
            return vals, ids
        _patch_answers(monkeypatch, alter)
    else:
        def bump(ids):
            ids[7, 0] = (ids[7, 0] + 1) % (1 << 16)
            return ids
        _patch_ingest_result(monkeypatch, bump)


@pytest.mark.parametrize("fault", [state_unchanged, half_batch,
                                   answer_altered])
@pytest.mark.parametrize("cell", CELLS)
def test_a_planted_fault_is_not_correct(monkeypatch, cell, fault):
    fault(monkeypatch, cell)
    r = tiny.run(cell, seed=31)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    layout = harness.Layout()
    if _served(cell):
        c = layout.cell(cell)
        ov = tiny.overrides(layout, cell)
        cfg = {**layout.config(c["config"]), **ov["config"]}
        c = {**c, "traffic": {**c["traffic"], **ov["traffic"]}}
        ctx = harness.Context(cell, c, cfg, 3, 1.0, False, "cpu", "",
                              "bfloat16")
        numbers = served_control(ctx, layout)["checks"]
        limits = {k: float(v) for k, v in c["limits"].items()}
        assert not verdict(numbers, limits), numbers
    else:
        r = tiny.run(cell, seed=3, precision="bfloat16")
        assert not r["correct"], r["checks"]
        numbers = {k: v["value"] for k, v in r["checks"].items()}
    assert np.isfinite(list(numbers.values())).all()
