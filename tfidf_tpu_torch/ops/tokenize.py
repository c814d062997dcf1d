"""Host-side tokenization (copy of ``tfidf_tpu/ops/tokenize.py``).

The reference tokenizes with a ``fscanf("%s")`` loop (``TFIDF.c:142-147``):
tokens are maximal runs of non-whitespace bytes, where whitespace is the C
locale's ``isspace`` set (space, \\t, \\n, \\v, \\f, \\r). Python's
``bytes.split()`` with no argument splits on exactly that set, so
``whitespace_tokenize`` is semantics-identical to the reference's scanner
(including treating runs of whitespace as one separator and ignoring
leading/trailing whitespace).

Tokenization is host-side by design: it is IO-bound string work, the one
part of the pipeline that does not belong on the MXU. A native C++
implementation of the same contract lives in ``native/fast_tokenizer.cc``
for the high-throughput loader path; this module is the portable fallback
and the semantics oracle for it.

Char n-grams (BASELINE config 4) have two paths: :func:`char_ngrams`
here materializes n-gram byte-strings on host (the semantics reference,
and what ``pack_corpus`` uses for EXACT-vocab n-gram runs), while the
scalable path ships raw document bytes to device and computes n-gram
*ids* there (the JAX package's ``ops.hashing.device_ngram_ids``; its
port arrives with the device-chargram slice) — a length-L document
yields ~3L overlapping n-grams, so host materialization triples the
host->device traffic the device path avoids.
"""

from __future__ import annotations

from typing import List, Optional


def whitespace_tokenize(data: bytes, truncate_at: Optional[int] = None) -> List[bytes]:
    """Split a document into whitespace-delimited tokens.

    Matches the reference scanner ``fscanf("%s")`` (``TFIDF.c:142-147``).
    ``truncate_at`` optionally clips each token to that many bytes
    (see ``PipelineConfig.truncate_tokens_at``).
    """
    toks = data.split()
    if truncate_at is not None:
        toks = [t[:truncate_at] for t in toks]
    return toks


def char_ngrams(data: bytes, lo: int, hi: int) -> List[bytes]:
    """All character n-grams of sizes lo..hi, in document order.

    Host reference implementation for tests; the production path computes
    n-gram *ids* on device from the raw byte array
    (``tfidf_tpu.ops.hashing.device_ngram_ids``) without materializing strings.
    N-grams are taken over the raw byte stream including whitespace, which
    matches the common hashing-vectorizer convention rather than any
    reference behaviour (the reference has no n-gram mode).
    """
    if not (0 < lo <= hi):
        raise ValueError(f"bad ngram range ({lo}, {hi})")
    out: List[bytes] = []
    n_bytes = len(data)
    for i in range(n_bytes):
        for n in range(lo, hi + 1):
            if i + n <= n_bytes:
                out.append(data[i : i + n])
    return out
