"""``ingest.packer_busy_share`` on synthetic spans: the ``pack`` spans'
time over the passes' wall; None without the wall or a ``pack``."""

from types import SimpleNamespace

import pytest

from benchmark import harness

READ = harness.Layout().metric("ingest.packer_busy_share").read


def _ctx(spans, wall):
    facts = {} if wall is None else {"passes_wall_s": wall}
    return SimpleNamespace(observed=harness.Observed(spans=spans,
                                                     facts=facts))


def test_reads_the_packs_over_the_wall():
    spans = [("pack", "tfidf-packer_0", 0, 1_500_000_000),
             ("pack", "tfidf-packer_1", 2_000_000_000, 500_000_000),
             ("pack_wait", "main", 0, 1_000_000_000)]
    assert READ(_ctx(spans, 4.0)) == pytest.approx(50.0)


def test_none_without_the_wall_or_a_pack():
    assert READ(_ctx([("pack", "t", 0, 10)], None)) is None
    assert READ(_ctx([("pack_wait", "main", 0, 10)], 4.0)) is None
