"""State that crosses between the JAX package and this port.

The pipeline has no learned weights: what crosses is the run's config,
the packed batch and a built retrieval index, all as plain Python and
numpy values, so this module imports neither package's arrays. With
them, one batch packed by either package runs through both, and a JAX
retriever's index serves from the port:

    cfg_t = config_from_dict(dataclasses.asdict(jax_cfg))
    batch_t = batch_from_numpy(b.token_ids, b.lengths, b.num_docs,
                               b.names, b.vocab_size, b.id_to_word)
    r_t = index_arrays_from_numpy(
        np.asarray(r._ids), np.asarray(r._weights), np.asarray(r._head),
        np.asarray(r._idf), r.names, r._num_docs,
        dataclasses.asdict(r.config), device="cpu")

Snapshots are the other route: ``checkpoint.save_index`` writes the
same files in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np

from tfidf_tpu_torch.config import PipelineConfig, TokenizerKind, VocabMode
from tfidf_tpu_torch.io.corpus import PackedBatch

_FIELDS = {f.name for f in dataclasses.fields(PipelineConfig)}


def _enum_value(v):
    return getattr(v, "value", v)


def config_from_dict(d: dict) -> PipelineConfig:
    """A :class:`PipelineConfig` from a config dict — e.g.
    ``dataclasses.asdict`` of a ``tfidf_tpu`` config, or its JSON. Enum
    members of either package (or their string values) are accepted.
    Unknown keys raise."""
    unknown = set(d) - _FIELDS
    if unknown:
        raise ValueError(f"unknown PipelineConfig fields {sorted(unknown)}")
    kw = dict(d)
    if "vocab_mode" in kw:
        kw["vocab_mode"] = VocabMode(_enum_value(kw["vocab_mode"]))
    if "tokenizer" in kw:
        kw["tokenizer"] = TokenizerKind(_enum_value(kw["tokenizer"]))
    if "ngram_range" in kw:
        kw["ngram_range"] = tuple(kw["ngram_range"])
    if "mesh_shape" in kw:
        kw["mesh_shape"] = dict(kw["mesh_shape"])
    return PipelineConfig(**kw)


def batch_from_numpy(token_ids, lengths, num_docs: int, names: Sequence[str],
                     vocab_size: int,
                     id_to_word: Optional[Dict[int, bytes]] = None) -> PackedBatch:
    """A :class:`PackedBatch` from host arrays (e.g. a ``tfidf_tpu``
    batch's fields). uint16 wire ids widen to int32 here, in numpy,
    since torch's uint16 support is thin."""
    toks = np.asarray(token_ids)
    if toks.dtype != np.int32:
        toks = toks.astype(np.int32)
    return PackedBatch(token_ids=np.ascontiguousarray(toks),
                       lengths=np.asarray(lengths, dtype=np.int32),
                       num_docs=int(num_docs), names=list(names),
                       vocab_size=int(vocab_size),
                       id_to_word=dict(id_to_word or {}))


def index_arrays_from_numpy(ids, weights, head, idf, names: Sequence[str],
                            num_docs: int, config_dict: dict, *,
                            scorer=None, fields=None, device=None):
    """A port ``TfidfRetriever`` serving a built index given as host
    arrays (e.g. a JAX retriever's ``_ids``, ``_weights``, ``_head``,
    ``_idf``): ids int32 [D, L], weights float32 [D, L], head bool
    [D, L], idf float32 [V]. ``scorer`` is the index-default scorer and
    ``fields`` a fielded index's ``[(name, weight, start, stop)]`` slot
    spans. ``device`` as for ``TfidfRetriever``."""
    from tfidf_tpu_torch.models.retrieval import TfidfRetriever

    r = TfidfRetriever(config_from_dict(config_dict), scorer=scorer,
                       device=device)
    arrays = [np.asarray(ids, np.int32), np.asarray(weights, np.float32),
              np.asarray(head, bool), np.asarray(idf, np.float32)]
    if not (arrays[0].shape == arrays[1].shape == arrays[2].shape):
        raise ValueError(f"ids {arrays[0].shape}, weights {arrays[1].shape} "
                         f"and head {arrays[2].shape} disagree")
    if len(names) != int(num_docs) or int(num_docs) > arrays[0].shape[0]:
        raise ValueError(f"{len(names)} names, num_docs {num_docs}, "
                         f"{arrays[0].shape[0]} rows")
    spans = ([(str(f), float(w), int(s), int(e)) for f, w, s, e in fields]
             if fields else None)
    return r._install(*(r._to_device(a) for a in arrays), names, num_docs,
                      fields=spans)
