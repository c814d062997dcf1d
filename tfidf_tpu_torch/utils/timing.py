"""Phase timing (port of ``tfidf_tpu/utils/timing.py``'s ``PhaseTimer``
and ``PhaseTimedMixin``).

On a CUDA device each phase is timed with a pair of CUDA events on the
current stream and ends with ``torch.cuda.synchronize()``, so a phase
measures completed device work, not the enqueue, and the next phase
starts on an idle device. Without a timer nothing is recorded and no
synchronisation is added.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator, Optional

import torch


class PhaseTimer:
    """Accumulates seconds per named phase::

        timer = PhaseTimer()
        TfidfPipeline(cfg, timer=timer).run(corpus)
        timer.as_dict()  # {"pack": ..., "transfer": ..., ...}
    """

    def __init__(self) -> None:
        self._acc: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)

    def add(self, name: str, seconds: float) -> None:
        """Fold a measured duration in."""
        self._acc[name] = self._acc.get(name, 0.0) + seconds

    def as_dict(self) -> Dict[str, float]:
        """Seconds per phase, in first-seen order."""
        return dict(self._acc)


@contextlib.contextmanager
def _cuda_phase(timer: PhaseTimer, name: str,
                device: torch.device) -> Iterator[None]:
    stream = torch.cuda.current_stream(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record(stream)
    try:
        yield
    finally:
        end.record(stream)
        torch.cuda.synchronize(device)
        timer.add(name, start.elapsed_time(end) / 1e3)


class PhaseTimedMixin:
    """Phase plumbing for pipeline classes with a ``timer`` and a
    ``device``: ``_phase(name)`` times a phase on the attached
    :class:`PhaseTimer` (a no-op without one)."""

    timer: Optional[PhaseTimer] = None
    device: torch.device = torch.device("cpu")

    def _phase(self, name: str):
        if self.timer is None:
            return contextlib.nullcontext()
        if self.device.type == "cuda":
            return _cuda_phase(self.timer, name, self.device)
        return self.timer.phase(name)
