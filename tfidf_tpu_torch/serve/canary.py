"""Canary parity probes: catch a corrupted index while serving it (port
of ``tfidf_tpu/serve/canary.py``; the JAX package's code).

Pin a small set of golden queries; capture their ORACLE results by
direct retriever search at index-build/swap time; then periodically
replay them through the full online path (admission → batcher → device
search, cache bypassed) and bit-compare. The ``serve_canary_parity``
gauge is 1.0 while every probe matches; anything less is an alarm with
the failing query indices in the flight recorder. A probe that
straddles a hot swap or is shed under load is SKIPPED, not failed.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence

import numpy as np

from tfidf_tpu_torch.obs import log as obs_log
from tfidf_tpu_torch.serve.batcher import ServeError

__all__ = ["CanaryProber", "pinned_queries_from_dir"]


def pinned_queries_from_dir(input_dir: str, n: int = 8,
                            tokens: int = 4, strict: bool = True
                            ) -> List[str]:
    """Derive a pinned golden-query set from a corpus directory: the
    first ``tokens`` tokens of each of the first ``n`` documents (in
    the deterministic discovery order). Queries built from real doc
    prefixes are guaranteed to score nonzero against a healthy index,
    so a canary miss is signal, not vocabulary luck."""
    import os

    from tfidf_tpu_torch.io.corpus import discover_names
    from tfidf_tpu_torch.ops.tokenize import whitespace_tokenize
    queries: List[str] = []
    for name in discover_names(input_dir, strict=strict)[:n]:
        with open(os.path.join(input_dir, name), "rb") as f:
            data = f.read(4096)  # a prefix is plenty for `tokens` words
        toks = whitespace_tokenize(data)[:tokens]
        if toks:
            queries.append(b" ".join(toks).decode("utf-8", "replace"))
    return queries


class CanaryProber:
    """Replays pinned queries through the batched path and bit-compares
    against the swap-time oracle.

    Args:
      server: the :class:`~tfidf_tpu_torch.serve.server.TfidfServer` to
        probe. The prober registers a swap listener so every
        ``swap_index`` re-captures the oracle synchronously — the
        capture happens inside the swap, before any post-swap
        corruption can exist.
      queries: the pinned golden queries (non-empty).
      k: results per query (one compiled bucket; probes never re-jit
        once warmed).
      period_s: background probe cadence for :meth:`start`; probes can
        also be driven manually (:meth:`probe` — the CLI ``canary``
        op).
      metrics: optional :class:`~tfidf_tpu_torch.serve.metrics.ServeMetrics`
        (default: the server's) whose registry carries the
        ``serve_canary_parity`` gauge and probe/failure/skip counters.
    """

    def __init__(self, server, queries: Sequence[str], k: int = 10,
                 period_s: float = 1.0, metrics=None) -> None:
        queries = list(queries)
        if not queries:
            raise ValueError("canary needs at least one pinned query")
        if period_s <= 0:
            raise ValueError("period_s must be positive")
        self._server = server
        self._queries = queries
        self._k = k
        self.period_s = period_s
        m = metrics if metrics is not None else server.metrics
        reg = m.registry
        self._g_parity = reg.gauge(
            "serve_canary_parity_milli",
            "last canary probe parity vs swap-time oracle, in 1/1000 "
            "(1000 = every pinned query bit-identical)")
        self._c_probes = reg.counter(
            "serve_canary_probes_total", "canary probes compared")
        self._c_failures = reg.counter(
            "serve_canary_failures_total",
            "canary probes with any mismatched query")
        self._c_skipped = reg.counter(
            "serve_canary_skipped_total",
            "canary probes skipped (shed under load / swap race)")
        self._oracle: dict = {}           # epoch -> (vals, ids)
        self._lock = threading.Lock()
        self._parity: Optional[float] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        server.add_swap_listener(self._on_swap)
        self.capture()

    # --- oracle ---
    def _on_swap(self, epoch: int, retriever) -> None:
        self._capture(epoch, retriever)

    def capture(self) -> None:
        """(Re)capture the oracle for the server's CURRENT index."""
        epoch, retriever = self._server.current_index()
        self._capture(epoch, retriever)

    def _capture(self, epoch: int, retriever) -> None:
        # Direct search — the bit-parity reference the serve tests pin
        # served responses against; NOT through the batcher, so the
        # oracle is independent of the path under test. A mesh-sharded
        # index offers its retained SINGLE-DEVICE source as the oracle
        # (``parity_oracle``): probes then replay through the sharded
        # path and bit-compare against single-device search — the live
        # sharded-vs-single parity pin of ROADMAP item 1, not a
        # sharded-vs-itself tautology.
        oracle_fn = getattr(retriever, "parity_oracle", None)
        source = oracle_fn() if oracle_fn is not None else None
        src = source if source is not None else retriever
        # Per-scorer golden: the oracle captures under the
        # server's DEFAULT scorer — the one probes replay with — so the
        # parity pin holds under non-default scorers too. A scorer
        # change routes through ``_install_index`` (epoch bump + this
        # listener), so a stale-scorer oracle can never be compared:
        # the epoch check skips any probe that straddled the change.
        get_key = getattr(self._server, "default_scorer_key", None)
        skey = get_key() if get_key is not None else "tfidf"
        if skey != "tfidf":
            vals, ids = src.search(self._queries, self._k, scorer=skey)
        else:
            vals, ids = src.search(self._queries, self._k)
        with self._lock:
            self._oracle[epoch] = (np.asarray(vals), np.asarray(ids))
            # Keep the previous epoch for probes racing a swap; drop
            # anything older.
            for old in sorted(self._oracle)[:-2]:
                del self._oracle[old]

    # --- probing ---
    def probe(self, timeout: float = 30.0) -> Optional[float]:
        """One probe: submit the pinned queries through the full
        batched path (cache bypassed) and bit-compare with the oracle
        of the epoch the probe ran under. Returns the parity fraction
        in [0, 1], or None when the probe was skipped (shed under
        load, or a swap landed mid-flight). Updates the gauge and
        counters; mismatches log an ``error`` flight event carrying
        the failing query indices."""
        epoch = self._server.epoch
        try:
            fut = self._server.submit(self._queries, self._k,
                                      use_cache=False)
            vals, ids = fut.result(timeout=timeout)
        except ServeError:
            self._c_skipped.inc()
            return None
        if self._server.epoch != epoch:
            self._c_skipped.inc()       # swap raced the probe
            return None
        with self._lock:
            oracle = self._oracle.get(epoch)
        if oracle is None:              # capture raced; next probe wins
            self._c_skipped.inc()
            return None
        ovals, oids = oracle
        vals, ids = np.asarray(vals), np.asarray(ids)
        bad = [i for i in range(len(self._queries))
               if not (np.array_equal(vals[i], ovals[i])
                       and np.array_equal(ids[i], oids[i]))]
        parity = 1.0 - len(bad) / len(self._queries)
        with self._lock:
            # the `canary` op probes from a protocol thread while the
            # background prober runs its own cadence
            self._parity = parity
        self._c_probes.inc()
        self._g_parity.set(int(round(parity * 1000)))
        if bad:
            self._c_failures.inc()
            obs_log.log_event(
                "error", "canary_parity_failure",
                msg=f"canary: {len(bad)}/{len(self._queries)} pinned "
                    f"queries diverged from the epoch-{epoch} oracle "
                    f"(parity {parity:.3f}) — index corruption?",
                epoch=epoch, parity=round(parity, 4), queries=bad)
        return parity

    @property
    def parity(self) -> Optional[float]:
        """Parity of the last compared probe (None before the first)."""
        return self._parity

    # --- background prober ---
    def start(self) -> "CanaryProber":
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()

        def run():
            while not self._stop.wait(self.period_s):
                try:
                    self.probe()
                except Exception as e:  # noqa: BLE001 — prober must
                    # never kill serving; the failure IS the evidence.
                    obs_log.log_event("error", "canary_probe_error",
                                      msg=f"canary probe raised: {e}",
                                      error=repr(e))

        self._thread = threading.Thread(
            target=run, daemon=True, name="tfidf-serve-canary")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5)
            self._thread = None

    def close(self) -> None:
        self.stop()
        self._server.remove_swap_listener(self._on_swap)
