"""What the served kinds share in their tests: the tiny served
configuration and the planted faults."""

from benchmark.tests.kinds import plant

SERVE = {"config": {"docs": 2000, "word_types": 8192,
                    "serve": {"max_batch": 8, "max_wait_ms": 2.0,
                              "queue_depth": 256, "cache_entries": 4096,
                              "pipeline_depth": 2,
                              "scorer": "bm25:b=0.68,k1=0.82"}}}


def state_unchanged(monkeypatch):
    """The DF fold of the index's build returns its accumulator
    unchanged."""
    plant.df_unchanged(monkeypatch)


def half_batch(monkeypatch):
    """Half of each search batch's answers left out."""
    def alter(vals, ids):
        vals[len(vals) // 2:] = 0.0
        ids[len(ids) // 2:] = -1
        return vals, ids
    plant.search_answers(monkeypatch, alter)


def answer_altered(monkeypatch):
    """One answer altered where it is produced: a picked id moved."""
    def alter(vals, ids):
        ids[0, 0] = ids[0, 0] + 1
        return vals, ids
    plant.search_answers(monkeypatch, alter)


FAULTS = {f.__name__: f for f in (state_unchanged, half_batch,
                                   answer_altered)}
