"""Online serving layer (port of ``tfidf_tpu/serve``): micro-batching,
caching, admission, supervision, canary probes.

* :mod:`~tfidf_tpu_torch.serve.batcher` — deadline-bounded dynamic
  micro-batching (submit queue -> futures -> coalesced device batches),
  pipelined at ``pipeline_depth >= 2``;
* :mod:`~tfidf_tpu_torch.serve.cache` — epoch-keyed LRU result cache;
* :mod:`~tfidf_tpu_torch.serve.server` — :class:`TfidfServer`: admission
  control, per-request deadlines, load shedding, hot index swap, live
  mutation of a segmented index, graceful drain;
* :mod:`~tfidf_tpu_torch.serve.metrics` — latency percentiles, batch
  occupancy, queue depth, shed/cache counters;
* :mod:`~tfidf_tpu_torch.serve.canary` — parity probes replaying pinned
  golden queries against the swap-time oracle;
* :mod:`~tfidf_tpu_torch.serve.front` — the replicated tier:
  :class:`ReplicatedFront` runs N full servers as worker processes
  behind one lightweight front (hash-affinity routing, two-phase epoch
  swaps, restart supervision, merged metrics and traces);
* :mod:`~tfidf_tpu_torch.serve.supervisor` — bounded retry, a circuit
  breaker, poison-query bisection + quarantine.

Every :class:`TfidfServer` carries a
:class:`~tfidf_tpu_torch.obs.health.HealthMonitor` (``healthz`` /
``readyz``), with ``degraded`` shrinking the admission bound. The entry
point is ``python -m tfidf_tpu_torch.cli serve`` (a JSONL loop over
stdin or TCP; ``--replicas N`` runs the replicated tier).
"""

from tfidf_tpu_torch.serve.batcher import (DeadlineExceeded, MicroBatcher,
                                           Overloaded, PoisonQuery,
                                           ServeError, ServerClosed)
from tfidf_tpu_torch.serve.cache import ResultCache, normalize_query
from tfidf_tpu_torch.serve.canary import (CanaryProber,
                                          pinned_queries_from_dir)
from tfidf_tpu_torch.serve.metrics import ServeMetrics
from tfidf_tpu_torch.serve.server import TfidfServer
from tfidf_tpu_torch.serve.supervisor import (CircuitBreaker, QuarantineList,
                                              RetryPolicy,
                                              SupervisedDispatch)
# front imports the submodules above; keep it LAST so the package
# namespace is fully populated before it loads.
from tfidf_tpu_torch.serve.front import (FrontError, ReplicatedFront,
                                         SwapAborted)

__all__ = [
    "TfidfServer",
    "ReplicatedFront",
    "FrontError",
    "SwapAborted",
    "MicroBatcher",
    "ResultCache",
    "ServeMetrics",
    "CanaryProber",
    "ServeError",
    "Overloaded",
    "DeadlineExceeded",
    "ServerClosed",
    "PoisonQuery",
    "RetryPolicy",
    "CircuitBreaker",
    "QuarantineList",
    "SupervisedDispatch",
    "normalize_query",
    "pinned_queries_from_dir",
]

