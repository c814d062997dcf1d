"""Mesh-sharded serving: one logical index doc-sharded over a device plan
(port of ``tfidf_tpu/parallel/serving.py``).

The serving tier holds one retriever, whose index is capped by one
card's memory. This module shards the *retriever* the way
``parallel.collectives`` shards the ingest: the row-sparse face of the
index is cut into contiguous row blocks over the plan's ``docs`` axis,
each on its shard's device; a query block goes to every shard's device
once; each shard runs the tiled score + top-k (``ops.sparse.
score_topk_tiled_trace``: the tile-scores kernel, B6, on every tile) over
ITS rows only; and the per-shard [Q, k] candidates, their ids shifted by
the shard's first row, gather in shard order and merge with one
top-k-of-top-k (``ops.topk.merge_topk``) — the reference's serial
``MPI_Recv`` gather loop (``TFIDF.c:256-270``) as a collective.

Every answer is bit-identical (scores, doc indices, tie order) to the
single-device ``search`` of the same index:

* a row's score is a sum over its own L slots, whichever block holds it;
* the selections are stable and the candidates reach the merge in shard
  order, which is ascending global row order among equal scores, so a
  tie keeps the lower global row, as on one device;
* dead rows (tombstones, padding, filtered-out docs) score the sub-zero
  sentinel before selection and the ``vals > 0`` result mask drops
  them, as the single-device paths do.

:class:`MeshShardedRetriever` duck-types the retriever search contract
(``search`` / ``names`` / ``config`` / ``indexed`` / ``_num_docs`` /
``snapshot``) the same way a segmented ``IndexView`` does, which lets
``TfidfServer`` hold one where it held a retriever and re-shard on every
install path through one transform (:func:`shard_index`).

The mesh is single-controller (``parallel.mesh``): one process loops over
its shards, and a repeated device (``devices=["cuda:0"] * 4``) gives
virtual shards of one card. Across processes the candidates gather over
gloo in rank order. Where the JAX package moves the index blocks through
the host (``numpy`` then ``device_put``), the port slices and copies them
on the device; the bytes are the same. The JAX package's
``mesh_search_cache_size`` counts jitted search programs; the port
compiles none, so it has no counterpart, and a search has no compile to
note to the compile watch.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from tfidf_tpu_torch.models.retrieval import _LEGACY_QUERY_BLOCK, query_matrix
from tfidf_tpu_torch.ops.sparse import (score_method, score_tile_rows,
                                        score_tiling, score_topk_tiled_trace)
from tfidf_tpu_torch.ops.topk import merge_topk, segment_score_topk
from tfidf_tpu_torch.parallel.mesh import MeshPlan, default_devices
from tfidf_tpu_torch.scoring.family import ScorerSpec, parse_scorer
from tfidf_tpu_torch.scoring.filters import filter_mask, parse_filter

__all__ = ["MeshShardedRetriever", "make_serving_plan", "shard_index",
           "sharded_search"]


def make_serving_plan(n_shards: int, devices: Optional[Sequence] = None,
                      device=None) -> MeshPlan:
    """A docs-only serving mesh over the first ``n_shards`` devices
    (``0`` = every device) — the ``--mesh-shards`` resolution.

    Without ``devices`` the devices are those of ``device`` (default
    cuda): every visible card, or on the CPU one shard per asked shard
    (``0``: one), as :meth:`MeshPlan.create` takes them. A list that
    repeats a device gives virtual shards. More shards than devices
    raises ``ValueError``."""
    devs = (list(devices) if devices is not None
            else default_devices(device, n_shards))
    if n_shards == 0:
        n_shards = len(devs)
    if n_shards < 1:
        raise ValueError("mesh_shards must be >= 1 (0 = all devices)")
    if n_shards > len(devs):
        raise ValueError(f"mesh_shards={n_shards} exceeds the {len(devs)} "
                         f"visible device(s)")
    return MeshPlan.create(docs=n_shards, devices=devs[:n_shards])


def shard_index(index, plan: MeshPlan,
                keep_source: bool = True) -> "MeshShardedRetriever":
    """Shard any retriever-contract index over ``plan`` (idempotent: an
    index already sharded on the same plan passes through; one sharded on
    another plan re-shards from its retained source). The one transform
    every serve install path applies under ``mesh_shards``."""
    if isinstance(index, MeshShardedRetriever):
        if index.plan is plan:
            return index
        source = index.parity_oracle()
        if source is None:
            raise ValueError("cannot re-shard onto a different plan: the "
                             "single-device source was dropped "
                             "(keep_source=False)")
        index = source
    return MeshShardedRetriever(index, plan, keep_source=keep_source)


def _pad_rows(t: torch.Tensor, rows: int) -> torch.Tensor:
    """``t`` with zero (False) rows appended up to ``rows``."""
    pad = rows - int(t.shape[0])
    if not pad:
        return t
    return torch.cat([t, t.new_zeros((pad,) + tuple(t.shape[1:]))])


def _on_device(device: torch.device):
    """Make ``device`` the thread's current CUDA device for a block (the
    segmented index's helper; importing it here would close an import
    cycle through the stream)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def sharded_search(plan: MeshPlan, data: List[torch.Tensor],
                   cols: List[torch.Tensor], live: List[torch.Tensor],
                   qmat: np.ndarray, k: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sharded search: this process's docs-shard blocks of a
    row-sparse face (``data``/``cols`` [Dl, L], ``live`` [Dl] each, every
    block Dl rows on ``plan.device(d)``) against the host query block
    ``qmat`` [V, Q] -> merged ([Q, k'], int32 global rows [Q, k']), on
    the first shard's device, in (score desc, row asc) order.

    Per shard, tiled (the default): ``score_topk_tiled_trace`` over the
    shard's rows with the live mask (B6 on every tile);
    ``TFIDF_TPU_SCORE_TILING=off``: one ``segment_score_topk`` over them.
    Ids shift by the shard's first global row; the candidates gather in
    shard order (across processes: rank order) and merge."""
    tiled = score_tiling()
    if tiled:
        score_method()  # validates TFIDF_TPU_SCORE, as on one device
    staged: Dict[torch.device, torch.Tensor] = {}
    host = torch.from_numpy(np.ascontiguousarray(qmat))
    vals, ids = [], []
    for d in range(plan.n_local_docs):
        dev = plan.device(d)
        rows = int(data[d].shape[0])
        with _on_device(dev):
            q = staged.get(dev)
            if q is None:
                q = staged[dev] = host.to(dev)
            kk = min(k, rows)
            if tiled:
                v, i = score_topk_tiled_trace(
                    data[d], cols[d], live[d], q, k=kk,
                    tile=score_tile_rows(rows), masked=True)
            else:
                v, i = segment_score_topk(data[d], cols[d], live[d], q, kk)
        vals.append(v)
        ids.append(i + (plan.first_docs_shard + d) * rows)
    vals_g = plan.all_gather(vals, dim=1, across_processes=True)
    ids_g = plan.all_gather(ids, dim=1, across_processes=True)
    return merge_topk(vals_g, ids_g, min(k, int(vals_g.shape[1])))


def _device_face(source, spec: ScorerSpec):
    """A source's ``(data, cols)`` face of one scorer, on its device, over
    the rows ``_source_blocks`` lays out: a segmented view's stacked face
    with its pow2 padding cut; a retriever's cached face."""
    parts = getattr(source, "_parts", None)
    if parts is not None:
        with _on_device(source.device):
            data, cols = source._face(spec)
        rows = sum(int(p.data.shape[0]) for p in parts)
        return data[:rows], cols[:rows]
    return source._scorer_face(spec)


def _source_blocks(source):
    """Source -> device (data, cols, live, idf) over its positional rows,
    values byte-identical to what the source's own search scores with.

    * segmented IndexView: its parts concatenated in segment (=
      insertion) order, the padded positional row space ``names``
      indexes, tombstones riding the live mask;
    * plan-sharded retriever: its shard blocks' default face in shard
      order (global row order);
    * plain retriever: its tfidf face, ``where(head, weights, 0)`` /
      ``where(head, ids, 0)``, the one its own search caches (so the
      blocks are slices of it, not a copy, where no padding is needed);
      live = the rows that hold documents (an ingested index pads its
      last chunk with dead rows).
    """
    parts = getattr(source, "_parts", None)
    if parts is not None:
        data, cols, live = (torch.cat([getattr(p, f) for p in parts])
                            for f in ("data", "cols", "live"))
        return data, cols, live.to(torch.bool), source._idf
    blocks = getattr(source, "_shard_faces", None)
    if blocks is not None and getattr(source, "plan", None) is not None:
        dev = source.device
        data, cols = (torch.cat([b[j].to(dev) for b in blocks()])
                      for j in (0, 1))
    else:
        data, cols = source._scorer_face(ScorerSpec())
    live = torch.arange(int(data.shape[0]),
                        device=data.device) < source._num_docs
    return data, cols, live, source._idf


class MeshShardedRetriever:
    """One doc-sharded serving index across a device plan.

    Built FROM an indexed single-device source — a plain
    :class:`~tfidf_tpu_torch.models.TfidfRetriever` (snapshot-restored
    ones included) or a segmented :class:`~tfidf_tpu_torch.index.
    IndexView` — whose row-sparse face is padded with dead rows to a
    shard multiple and cut into one block per docs shard, each on its
    shard's device. Rows keep their global order, so result indices (and
    :attr:`names` positions) are the source's.

    Args:
      source: the indexed retriever-contract object to shard.
      plan: docs-only :class:`MeshPlan` (seq=1, vocab=1).
      keep_source: retain ``source`` as the single-device parity oracle
        (:meth:`parity_oracle`, which the canary prober captures
        against), the :meth:`snapshot` delegate and the deriver of
        non-default scorer faces. Costs the source's device memory;
        pass False where one device cannot hold it.
    """

    def __init__(self, source, plan: MeshPlan,
                 keep_source: bool = True) -> None:
        if plan.n_vocab_shards != 1 or plan.n_seq_shards != 1:
            raise ValueError("serving shards the docs axis only; build the "
                             "MeshPlan with seq=1, vocab=1")
        if not getattr(source, "indexed", False):
            raise ValueError("shard_index needs an indexed retriever "
                             "(index()/index_dir() first)")
        self.plan = plan
        self.device = plan.devices[0]
        self.config = source.config
        self.names: List[str] = list(source.names)
        self._num_docs = int(source._num_docs)
        # A sharded view keeps its segmented owner: the server's
        # swap-vs-mutation detach check sees through the wrapper.
        self.owner = getattr(source, "owner", None)
        self._source = source if keep_source else None

        data, cols, live, idf = _source_blocks(source)
        self._rows = plan.pad_docs(int(data.shape[0]))
        self._data = self._place(data)
        self._cols = self._place(cols)
        self._live = self._place(live)
        self._live_np = _pad_rows(live, self._rows).cpu().numpy()
        self._idf = idf
        self._idf_np = idf.cpu().numpy()
        # Per-scorer sharded faces and per-filter sharded live masks,
        # derived lazily and placed once.
        self._scorer_cache: Dict[str, tuple] = {}
        self._filter_cache: Dict[str, list] = {}

    def _place(self, t: torch.Tensor) -> List[torch.Tensor]:
        """This process's docs-shard row blocks of a [rows, ...] tensor
        padded with zero (dead) rows to ``self._rows``, each on its
        shard's device (a slice, not a copy, when the device is the
        tensor's own)."""
        plan = self.plan
        full = _pad_rows(t, self._rows)
        per = self._rows // plan.n_docs_shards
        lo = plan.first_docs_shard * per
        return [full[lo + d * per:lo + (d + 1) * per].to(plan.device(d))
                for d in range(plan.n_local_docs)]

    # --- retriever contract -------------------------------------------
    @property
    def indexed(self) -> bool:
        return True

    @property
    def n_shards(self) -> int:
        return self.plan.n_docs_shards

    def parity_oracle(self):
        """The retained single-device source (None when dropped): the
        bit-parity reference the canary prober captures its oracle from,
        so the live parity gauge pins sharded against single-device."""
        return self._source

    def snapshot(self, path: str, epoch: int = 0,
                 extra_meta: Optional[dict] = None) -> str:
        """Persist through the retained source (sharding is a placement,
        not a format: a restore re-shards)."""
        if self._source is None:
            raise ValueError("snapshot needs the retained single-device "
                             "source (shard_index(..., keep_source=True))")
        return self._source.snapshot(path, epoch=epoch,
                                     extra_meta=extra_meta)

    def index_arrays(self) -> list:
        """Live device tensors, for the device monitor's census."""
        out = [self._idf, *self._data, *self._cols, *self._live]
        for d, c in self._scorer_cache.values():
            out += [*d, *c]
        for live in self._filter_cache.values():
            out += list(live)
        return out

    def shard_stats(self) -> dict:
        """Bytes each docs shard of this process holds (its data, cols
        and live blocks) and the max/mean imbalance: what the device
        monitor publishes as ``shard_bytes_d*`` and
        ``shard_imbalance_milli``."""
        per = [sum(b[d].nbytes for b in (self._data, self._cols, self._live))
               for d in range(self.plan.n_local_docs)]
        mean = sum(per) / max(1, len(per))
        imbalance = (max(per) / mean) if mean else 1.0
        return {"n_shards": self.n_shards, "shard_bytes": per,
                "imbalance": round(imbalance, 4), "total_bytes": sum(per)}

    def _scorer_blocks(self, spec: ScorerSpec) -> tuple:
        """The sharded ``(data, cols)`` face of one scorer, cached per
        key. The face derives ON THE SOURCE through its own code (the
        same the source's single-device search scores with), then pads
        and splits: placement never touches the bytes."""
        key = spec.key()
        blk = self._scorer_cache.get(key)
        if blk is None:
            if self._source is None:
                raise ValueError("non-default scorers need the retained "
                                 "single-device source (shard_index(..., "
                                 "keep_source=True))")
            data, cols = _device_face(self._source, spec)
            blk = (self._place(data), self._place(cols))
            self._scorer_cache[key] = blk
        return blk

    def _filter_live(self, fspec) -> List[torch.Tensor]:
        """The sharded live mask AND one filter's allow-mask (a host AND,
        then placement), cached per canonical key; no filter returns the
        default live blocks."""
        if fspec is None:
            return self._live
        key = fspec.key()
        live = self._filter_cache.get(key)
        if live is None:
            npos = min(self._rows, len(self.names)) or self._num_docs
            mask = np.zeros((self._rows,), bool)
            mask[:npos] = filter_mask(fspec, npos, names=self.names)
            live = self._place(torch.from_numpy(self._live_np & mask)
                               .to(self.device))
            self._filter_cache[key] = live
        return live

    # --- querying -------------------------------------------------------
    def search(self, queries: Sequence[Union[str, bytes]], k: int = 10,
               *, scorer=None, filter=None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Ranked retrieval: (scores, doc_indices), each [Q, k'] with
        k' = min(k, num_docs), bit-identical to the source's single-device
        ``search`` (same query bucketing; the untiled path's 64-query
        blocks). ``scorer``/``filter`` swap in the derived sharded face /
        the composed live mask; with no scorer named the tfidf face
        scores (as in the JAX package: the source's index-default scorer
        is not consulted)."""
        spec = ScorerSpec() if scorer is None else parse_scorer(scorer)
        fspec = parse_filter(filter)
        if not score_tiling() and len(queries) > _LEGACY_QUERY_BLOCK:
            parts = [self.search(queries[s:s + _LEGACY_QUERY_BLOCK], k,
                                 scorer=spec, filter=fspec)
                     for s in range(0, len(queries), _LEGACY_QUERY_BLOCK)]
            return (np.concatenate([p[0] for p in parts]),
                    np.concatenate([p[1] for p in parts]))
        nq = len(queries)
        width = min(k, self._num_docs)
        if width == 0 or nq == 0:
            return (np.zeros((nq, width), np.float32),
                    np.full((nq, width), -1, np.int64))
        if spec.is_default:
            data, cols = self._data, self._cols
        else:
            data, cols = self._scorer_blocks(spec)
        live = self._filter_live(fspec)
        bucket = 1 << max(0, nq - 1).bit_length()
        qmat = query_matrix(queries, self.config, self._idf_np, pad_to=bucket,
                            mode="counts" if spec.kind == "bm25" else "cosine")
        vals, idx = sharded_search(self.plan, data, cols, live, qmat, k)
        vals = vals.cpu().numpy()[:nq, :width]
        idx = idx.cpu().numpy()[:nq, :width]
        # Dead and padding rows score the sentinel, zero-score rows are
        # padding either way: the single-device result mask.
        ok = vals > 0
        return np.where(ok, vals, 0.0), np.where(ok, idx, -1)

