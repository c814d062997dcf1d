"""Kind ``ingest_passes``: its tiny sizes and its planted faults."""

from benchmark.tests.kinds import plant

TINY = {"config": {"docs": 1500, "word_types": 8192, "doc_len": 128,
                   "chunk_docs": 512,
                   "length": {"kind": "lognormal", "median": 60,
                              "sigma": 1.2, "min": 1, "max": 1000}}}


def state_unchanged(monkeypatch):
    """The DF fold returns its accumulator unchanged."""
    plant.df_unchanged(monkeypatch)


def half_batch(monkeypatch):
    """Half of each chunk's rows left out of the DF fold."""
    plant.df_fold(monkeypatch, lambda orig, ids, head, v: orig(
        ids[:len(ids) // 2], head[:len(head) // 2], v))


def answer_altered(monkeypatch):
    """One answer altered where it is produced: a picked id moved."""
    def bump(ids):
        ids[7, 0] = (ids[7, 0] + 1) % (1 << 16)
        return ids
    plant.ingest_result(monkeypatch, bump)


FAULTS = {f.__name__: f for f in (state_unchanged, half_batch,
                                   answer_altered)}
