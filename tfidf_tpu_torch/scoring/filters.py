"""Query-time document filters (port of ``tfidf_tpu/scoring/filters.py``;
numpy only, so the copy is the JAX package's code unchanged).

A filter is a per-request predicate over documents — a tenant
allowlist, an id range, a name prefix — applied BEFORE top-k by folding
into the live mask: a filtered-out row scores the sub-zero ``_DEAD``
sentinel (``ops/topk.py``) and can never surface. Corpus statistics
(df, idf, avgdl, N) stay global: filters are visibility, not mutation.

Spec forms:

* ``{"ids": [3, 17, 42]}`` — explicit doc-row allowlist;
* ``{"id_range": [lo, hi]}`` — half-open row range;
* ``{"prefix": "tenantA/"}`` — doc-NAME prefix allowlist.

:func:`filter_key` is the canonical JSON string (``""`` = no filter),
byte for byte the JAX package's, and invertible via
:func:`parse_filter`.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Sequence, Tuple, Union

import numpy as np

_KINDS = ("ids", "id_range", "prefix")


@dataclasses.dataclass(frozen=True)
class FilterSpec:
    """One parsed document filter (see module docstring)."""

    kind: str
    ids: Tuple[int, ...] = ()
    lo: int = 0
    hi: int = 0
    prefix: str = ""

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown filter kind {self.kind!r} "
                             f"(choose one of {', '.join(_KINDS)})")
        if self.kind == "id_range" and self.hi < self.lo:
            raise ValueError(
                f"bad id_range [{self.lo}, {self.hi}): hi < lo")

    def key(self) -> str:
        """Canonical JSON (sorted keys, normalized values) — equal
        filters produce equal keys, and ``parse_filter(json.loads(
        key))`` round-trips."""
        if self.kind == "ids":
            body = {"ids": sorted(set(self.ids))}
        elif self.kind == "id_range":
            body = {"id_range": [self.lo, self.hi]}
        else:
            body = {"prefix": self.prefix}
        return json.dumps(body, sort_keys=True, separators=(",", ":"))


def parse_filter(spec: Union[None, str, dict, FilterSpec]
                 ) -> Optional[FilterSpec]:
    """Anything-to-spec: None/"" (no filter), a spec (pass-through), a
    dict (the JSONL form), or a canonical-JSON string (the group-key
    form)."""
    if spec is None or spec == "":
        return None
    if isinstance(spec, FilterSpec):
        return spec
    if isinstance(spec, str):
        try:
            spec = json.loads(spec)
        except ValueError as e:
            raise ValueError(f"bad filter string {spec!r}: {e}") from e
        if spec is None:
            return None
    if not isinstance(spec, dict):
        raise ValueError(f"cannot parse filter spec {spec!r}")
    unknown = set(spec) - set(_KINDS)
    if unknown:
        raise ValueError(f"unknown filter fields {sorted(unknown)} "
                         f"(choose one of {', '.join(_KINDS)})")
    if len(spec) != 1:
        raise ValueError(f"filter must name exactly one of "
                         f"{', '.join(_KINDS)} (got {sorted(spec)})")
    if "ids" in spec:
        ids = spec["ids"]
        if (not isinstance(ids, (list, tuple))
                or not all(isinstance(i, int) and not isinstance(i, bool)
                           for i in ids)):
            raise ValueError("filter 'ids' must be a list of ints")
        return FilterSpec(kind="ids", ids=tuple(int(i) for i in ids))
    if "id_range" in spec:
        rng = spec["id_range"]
        if (not isinstance(rng, (list, tuple)) or len(rng) != 2
                or not all(isinstance(i, int) and not isinstance(i, bool)
                           for i in rng)):
            raise ValueError(
                "filter 'id_range' must be [lo, hi] ints (half-open)")
        return FilterSpec(kind="id_range", lo=int(rng[0]),
                          hi=int(rng[1]))
    prefix = spec["prefix"]
    if not isinstance(prefix, str):
        raise ValueError("filter 'prefix' must be a string")
    return FilterSpec(kind="prefix", prefix=prefix)


def filter_key(spec: Union[None, str, dict, FilterSpec]) -> str:
    """Canonical key of any spec form; ``""`` = no filter."""
    fspec = parse_filter(spec)
    return "" if fspec is None else fspec.key()


def filter_mask(fspec: FilterSpec, num_docs: int,
                names: Optional[Sequence[Optional[str]]] = None
                ) -> np.ndarray:
    """``[num_docs]`` bool allow-mask of one filter over doc rows.
    ``names`` (positional, ``names[row]``) is only consulted by the
    prefix kind; rows with no name (segmented padding) never match."""
    mask = np.zeros((num_docs,), bool)
    if fspec.kind == "ids":
        rows = [i for i in fspec.ids if 0 <= i < num_docs]
        if rows:
            mask[np.asarray(rows, np.int64)] = True
    elif fspec.kind == "id_range":
        lo = max(0, fspec.lo)
        hi = min(num_docs, fspec.hi)
        if hi > lo:
            mask[lo:hi] = True
    else:
        if names is None:
            raise ValueError(
                "prefix filters need the doc-name table")
        pre = fspec.prefix
        for row in range(min(num_docs, len(names))):
            name = names[row]
            if name is not None and name.startswith(pre):
                mask[row] = True
    return mask
