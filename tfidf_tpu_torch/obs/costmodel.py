"""Analytic bytes/bandwidth model: the roofline, next to the trace (port
of ``tfidf_tpu/obs/costmodel.py``).

One copy of the card's peaks, the per-stage device-memory traffic of
the port's resident program and the achieved-GB/s arithmetic that turns
a byte-stamped span into a roofline fraction. Consumers:

* ``obs/tracer.py``: a span stamped with a ``bytes`` arg exports its
  ``gb_s`` through :func:`span_gbps`, so the Perfetto timeline shows
  each span's achieved bandwidth;
* ``chip_smoke.py``: every kernel's ``bound_ms`` (bytes over
  :func:`hbm_peak_gbs` of the card, operations over
  :data:`INT32_MAD_PER_S` or :data:`FP32_FMA_PER_S`);
* ``tools/doctor.py`` reads the same arithmetic from the JAX package's
  copy, so its GB/s column reads either package's trace alike.

Stdlib-only, like the tracer.
"""

from __future__ import annotations

from typing import Dict, Optional

__all__ = [
    "HBM_PEAK_GBS_DEFAULT", "INT32_MAD_PER_S", "FP32_FMA_PER_S",
    "hbm_peak_gbs", "stage_bytes", "achieved_gbps",
    "span_gbps",
]

# Device-memory peak bandwidth (GB/s) of the H100 SXM5 (80 GB HBM3), the
# NVIDIA data sheet's 3.35 TB/s.
HBM_PEAK_GBS_DEFAULT = 3350.0
# Keyed by substrings of the card's name as torch.cuda.get_device_name()
# gives it, compared lower-case; the first match wins.
_HBM_PEAK_TABLE = (
    ("h100 80gb hbm3", HBM_PEAK_GBS_DEFAULT),
    ("h100 sxm", HBM_PEAK_GBS_DEFAULT),
)

# int32 multiply-adds per second of the H100 SXM5: 64 INT32 lanes per SM
# (half the 128 FP32 lanes behind the data sheet's 67 TFLOP/s) x 132 SMs
# x 1.98 GHz boost.
INT32_MAD_PER_S = 132 * 64 * 1.98e9
# float32 fused multiply-adds per second outside the tensor cores: the
# data sheet's 67 TFLOP/s, two operations per FMA.
FP32_FMA_PER_S = 67e12 / 2


def hbm_peak_gbs(device_kind: Optional[str]) -> Optional[float]:
    """Device-memory peak (GB/s) of the card named ``device_kind``
    (``torch.cuda.get_device_name()``), or None for the CPU and for any
    card not in the table: no roofline without a known card, and callers
    print "n/a" rather than a made-up fraction."""
    if not device_kind:
        return None
    kind = device_kind.lower()
    for key, peak in _HBM_PEAK_TABLE:
        if key in kind:
            return peak
    return None


def stage_bytes(docs: int, length: int, topk: int = 16,
                itemsize: int = 4, vocab_size: int = 1 << 16
                ) -> Dict[str, int]:
    """Device-memory traffic per stage of the port's resident program for
    ``docs`` full rows of ``length`` tokens, in bytes: each stage's
    inputs read once and its outputs written once (the least traffic the
    stage can have; ``itemsize`` is the id, count and score width, int32
    and float32 = 4):

    * ``rebuild`` (kernel B4): the flat uint16 id stream and the lengths
      in, the [D, L] ids out;
    * ``row_sort``: the masked [D, L] ids in, the stable sort's values
      and its int64 indices out;
    * ``rle``: the sorted ids and lengths in, the head mask (bool) and
      the counts out;
    * ``df``: ``sparse_df``'s ``index_add_``: the ids and the head mask
      in, the [V] DF out;
    * ``score_topk`` (kernel B1): the triples, lengths and the [V] IDF
      in, the [D, K] scores and ids out;
    * ``pack_words`` (kernel B3): the [D, K] scores and ids in, the
      [D, K] uint32 words out.

    The JAX package's model of the same name counts its bitonic sorts
    and global DF sort instead; the port's program has neither.
    ``vocab_size`` (the [V] DF and IDF) is the port's addition.
    """
    n = docs * length
    k = min(topk, length)
    return {
        "rebuild": n * 2 + docs * 4 + n * itemsize,
        "row_sort": n * itemsize + n * itemsize + n * 8,
        "rle": n * itemsize + docs * 4 + n + n * itemsize,
        "df": n * itemsize + n + vocab_size * 4,
        "score_topk": (2 * n * itemsize + n + docs * 4
                       + vocab_size * itemsize + docs * k * 2 * itemsize),
        "pack_words": docs * k * 2 * itemsize + docs * k * 4,
    }


def achieved_gbps(nbytes: float, seconds: float) -> Optional[float]:
    """Realized bandwidth, or None when the interval is degenerate
    (zero/negative duration must not export an Infinity that breaks a
    JSON reader)."""
    if not seconds or seconds <= 0 or nbytes < 0:
        return None
    return nbytes / seconds / 1e9


def span_gbps(event: dict) -> Optional[float]:
    """Achieved GB/s of one Chrome trace-event dict: a complete span
    whose ``args.bytes`` says what it moved (``ts``/``dur`` are in
    microseconds). None when the span carries no byte stamp."""
    args = event.get("args") or {}
    b = args.get("bytes")
    dur_us = event.get("dur")
    if not isinstance(b, (int, float)) \
            or not isinstance(dur_us, (int, float)):
        return None
    return achieved_gbps(float(b), dur_us / 1e6)
