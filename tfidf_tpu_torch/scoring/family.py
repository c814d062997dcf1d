"""Scorer specs and the BM25 weight math (port of
``tfidf_tpu/scoring/family.py``).

* **Spec parsing** (host): :class:`ScorerSpec`, :func:`parse_scorer`,
  :func:`scorer_key` — one canonical string form (``"tfidf"``,
  ``"bm25:b=0.75,k1=1.2"``), byte for byte the JAX package's, so cache
  keys and snapshot metadata mean the same in both packages.
* **BM25 weight math** (tensors): :func:`bm25_idf_from_df` and
  :func:`bm25_weights` are the one elementwise float32 sequence every
  BM25 face runs, in PyTorch's eager order (no fused multiply-adds).

With Lucene idf ``log1p((N - df + 0.5) / (df + 0.5))`` (> 0 for every
df >= 1, so the ``vals > 0`` result mask still holds) the per-(doc, term)
weight

    w(d, t) = idf(t) * c * (k1 + 1) / (c + k1 * (1 - b + b * dl/avgdl))

absorbs everything but the query's raw term count, so BM25(q, d) =
``sum_t count_q(t) * w(d, t)``: the sparse dot the tile-scores kernel
computes. ``k1``/``b`` are runtime float32 scalars (changing them
re-derives a face and nothing else), and ``avgdl`` is
``float32(exact-int total live length) / float32(num live docs)``.
The ``log1p`` is taken in float64 and rounded once to float32, as
``ops.scoring.idf_from_df`` takes its ``log``: float32 ``log``/``log1p``
differ in the last bit across frameworks and across CPU runs, the
float64 one rounds to the same float32 on every device. Against the JAX
package's float32 ``log1p`` the idf differs by at most 1 ulp.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Union

import numpy as np
import torch

INT32_MAX = int(np.iinfo(np.int32).max)

DEFAULT_K1 = 1.2
DEFAULT_B = 0.75

_KINDS = ("tfidf", "bm25")


@dataclasses.dataclass(frozen=True)
class ScorerSpec:
    """One member of the scorer family. ``k1``/``b`` are only
    meaningful for ``bm25``; they are normalized to the defaults for
    ``tfidf`` so spec equality == scoring equality."""

    kind: str = "tfidf"
    k1: float = DEFAULT_K1
    b: float = DEFAULT_B

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown scorer {self.kind!r} "
                             f"(choose one of {', '.join(_KINDS)})")
        if self.kind == "tfidf":
            object.__setattr__(self, "k1", DEFAULT_K1)
            object.__setattr__(self, "b", DEFAULT_B)
        if not self.k1 >= 0:
            raise ValueError(f"bm25 k1 must be >= 0 (got {self.k1})")
        if not 0 <= self.b <= 1:
            raise ValueError(f"bm25 b must be in [0, 1] (got {self.b})")

    @property
    def is_default(self) -> bool:
        return self.kind == "tfidf"

    def key(self) -> str:
        """The canonical string form — parseable by
        :func:`parse_scorer`, stable under float formatting, the
        batch-group / cache-key / snapshot-meta representation."""
        if self.kind == "tfidf":
            return "tfidf"
        return f"bm25:b={self.b:g},k1={self.k1:g}"


def parse_scorer(spec: Union[None, str, dict, ScorerSpec]) -> ScorerSpec:
    """Anything-to-spec: None (default tfidf), a spec (pass-through),
    a dict (``{"kind": "bm25", "k1": 1.5}`` — the JSONL form), or a
    string (``"bm25"``, ``"bm25:k1=1.5,b=0.6"`` — the CLI/key form)."""
    if spec is None:
        return ScorerSpec()
    if isinstance(spec, ScorerSpec):
        return spec
    if isinstance(spec, dict):
        unknown = set(spec) - {"kind", "k1", "b"}
        if unknown:
            raise ValueError(f"unknown scorer fields {sorted(unknown)}")
        return ScorerSpec(kind=str(spec.get("kind", "tfidf")),
                          k1=float(spec.get("k1", DEFAULT_K1)),
                          b=float(spec.get("b", DEFAULT_B)))
    if not isinstance(spec, str):
        raise ValueError(f"cannot parse scorer spec {spec!r}")
    text = spec.strip()
    kind, _, params = text.partition(":")
    kw = {"kind": kind.strip().lower()}
    if params.strip():
        for part in params.split(","):
            name, _, val = part.partition("=")
            name = name.strip().lower()
            if name not in ("k1", "b") or not val.strip():
                raise ValueError(
                    f"bad scorer param {part!r} in {spec!r} "
                    f"(expected k1=<float> / b=<float>)")
            kw[name] = float(val)
    return ScorerSpec(**kw)


def scorer_key(spec: Union[None, str, dict, ScorerSpec]) -> str:
    """Canonical key of any spec form (``parse_scorer(x).key()``)."""
    return parse_scorer(spec).key()


def resolve_scorer(explicit: Union[None, str, dict, ScorerSpec] = None
                   ) -> ScorerSpec:
    """Resolve the index-default scorer: explicit setting >
    ``TFIDF_TPU_SCORER`` (with ``TFIDF_TPU_BM25_K1`` /
    ``TFIDF_TPU_BM25_B`` riding along for a bare ``bm25``) > tfidf."""
    if explicit is not None:
        return parse_scorer(explicit)
    raw = os.environ.get("TFIDF_TPU_SCORER", "").strip()
    if not raw:
        return ScorerSpec()
    spec = parse_scorer(raw)
    if spec.kind == "bm25" and ":" not in raw:
        k1 = os.environ.get("TFIDF_TPU_BM25_K1", "").strip()
        b = os.environ.get("TFIDF_TPU_BM25_B", "").strip()
        spec = ScorerSpec(kind="bm25",
                          k1=float(k1) if k1 else DEFAULT_K1,
                          b=float(b) if b else DEFAULT_B)
    return spec


def spec_from_parts(kind: Optional[str], k1: Optional[float],
                    b: Optional[float]) -> ScorerSpec:
    """Compose a spec from the serve config's three optional knobs
    (``--scorer`` / ``--bm25-k1`` / ``--bm25-b``). A ``--scorer``
    carrying inline params (``"bm25:k1=1.5"``) wins outright — the
    standalone knobs only flesh out a bare kind."""
    if kind and ":" in kind:
        return parse_scorer(kind)
    return ScorerSpec(kind=(kind or "tfidf").strip().lower(),
                      k1=DEFAULT_K1 if k1 is None else float(k1),
                      b=DEFAULT_B if b is None else float(b))


# --- BM25 weight math -------------------------------------------------


def _f32(x, device) -> torch.Tensor:
    """A float32 0-d tensor on ``device`` from a Python, numpy or torch
    scalar (a float64 value rounds once)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.tensor(np.float32(x), dtype=torch.float32, device=device)


def bm25_idf_from_df(df: torch.Tensor, num_docs, dtype=torch.float32
                     ) -> torch.Tensor:
    """Lucene BM25 idf: ``log1p((N - df + 0.5) / (df + 0.5))``, 0 where
    df == 0 (empty hashed buckets). The quotient is float32, as in the
    JAX package; the log1p is float64, rounded once."""
    dff = df.to(dtype)
    n = torch.tensor(num_docs, dtype=dtype, device=df.device)
    half = torch.tensor(0.5, dtype=dtype, device=df.device)
    quotient = (n - dff + half) / (dff + half)
    idf = torch.log1p(quotient.to(torch.float64)).to(dtype)
    return torch.where(df > 0, idf, torch.zeros((), dtype=dtype,
                                                device=df.device))


def bm25_weights(ids, counts, head, lengths, idf, avgdl, k1, b):
    """Per-slot BM25 doc weights + dense-safe columns: ``ids/counts/head``
    [D, L], ``lengths`` [D], ``idf`` [V], scalars ``avgdl``/``k1``/``b``
    (float32 0-d tensors or numbers). Returns ``(data float32 [D, L],
    cols int32 [D, L])``, zeros / column 0 off-head."""
    dev = ids.device
    f32 = torch.float32
    c = counts.to(f32)
    dl = torch.clamp_min(lengths, 1).to(f32)[:, None]
    avgdl, k1, b = _f32(avgdl, dev), _f32(k1, dev), _f32(b, dev)
    one = torch.tensor(1.0, dtype=f32, device=dev)
    sat = (c * (k1 + one)) / (c + k1 * (one - b + b * (dl / avgdl)))
    safe = torch.where(head, ids, 0).to(torch.int32)
    idf_slot = idf.index_select(0, safe.reshape(-1)).reshape(safe.shape)
    data = torch.where(head, idf_slot * sat, torch.zeros((), dtype=f32,
                                                         device=dev))
    return data, safe


def bm25_face_trace(ids, head, num_docs, avgdl, k1, b, *, vocab_size: int):
    """BM25 face from a stored flat index's ``(ids, head)`` alone:
    padding slots carry the ``INT32_MAX`` sort sentinel, so lengths are
    the non-sentinel counts, counts come from the run-length trick
    (:func:`ops.sparse.sorted_term_counts_masked` over already-sorted
    rows) and df from :func:`ops.sparse.sparse_df`. BM25 is a derived
    view of the stored index, not a stored one."""
    from tfidf_tpu_torch.ops.sparse import sorted_term_counts_masked, sparse_df

    valid = ids != INT32_MAX
    _, counts, _ = sorted_term_counts_masked(ids, valid)
    lengths = valid.sum(dim=1, dtype=torch.int32)
    df = sparse_df(ids, head, vocab_size)
    idf = bm25_idf_from_df(df, int(num_docs))
    return bm25_weights(ids, counts, head, lengths, idf, avgdl, k1, b)


def doc_lengths_host(ids) -> np.ndarray:
    """Host int64 per-row token counts of a stored flat index (the
    non-sentinel slot count): the exact-integer numerator of avgdl. The
    count is taken where ``ids`` lies; only [D] integers cross."""
    if isinstance(ids, torch.Tensor):
        return (ids != INT32_MAX).sum(dim=1).to(torch.int64).cpu().numpy()
    arr = np.asarray(ids)
    return (arr != INT32_MAX).sum(axis=1).astype(np.int64)


def avgdl_f32(total_len: int, num_docs: int) -> np.float32:
    """THE avgdl: float32(exact-int total) / float32(N), one correctly
    rounded divide, so every path that feeds the same integers gets the
    same float32 bits."""
    n = max(1, int(num_docs))
    return np.float32(np.float32(int(total_len)) / np.float32(n))
