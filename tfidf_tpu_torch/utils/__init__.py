"""Phase timing, throughput, profiler regions and the latency histogram."""

from tfidf_tpu_torch.utils.timing import (LatencyHistogram, PhaseTimer,
                                          Throughput, trace_region)

__all__ = ["LatencyHistogram", "PhaseTimer", "Throughput", "trace_region"]
