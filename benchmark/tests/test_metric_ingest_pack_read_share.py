"""``ingest.pack_read_share`` on synthetic spans: the packer's
``pack_read`` time over its ``pack`` time; None without either."""

from types import SimpleNamespace

import pytest

from benchmark import harness

READ = harness.Layout().metric("ingest.pack_read_share").read


def _ctx(spans):
    return SimpleNamespace(observed=harness.Observed(spans=spans))


def test_reads_the_share_of_the_packs():
    spans = [("pack", "tfidf-packer_0", 0, 4_000_000),
             ("pack_read", "tfidf-packer_0", 0, 1_000_000),
             ("pack_tokenize", "tfidf-packer_0", 1_000_000, 3_000_000),
             ("pack", "tfidf-packer_0", 5_000_000, 4_000_000),
             ("pack_read", "tfidf-packer_0", 5_000_000, 2_000_000),
             ("pack_wait", "main", 0, 9_000_000)]
    assert READ(_ctx(spans)) == pytest.approx(100.0 * 3 / 8)


def test_none_without_reads_or_packs():
    assert READ(_ctx([])) is None
    assert READ(_ctx([("pack", "tfidf-packer_0", 0, 10)])) is None
    assert READ(_ctx([("pack_read", "tfidf-packer_0", 0, 10)])) is None
