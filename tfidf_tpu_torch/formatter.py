"""Host-side result formatting with reference byte-parity.

Copy of ``tfidf_tpu/formatter.py`` (the port imports nothing of the JAX
package); the two must stay identical.

The device computes *exact integers* (TF counts, doc lengths, DF); this
module performs the final double math on host in the same operation order
as the C reference (``TFIDF.c:202,243-245``) and emits the same
``document@word\\t%.16f`` lines in the same ``strcmp`` order
(``TFIDF.c:273``). Splitting the pipeline there is what lets the device side
run in float32/bfloat16 while the emitted file is still byte-identical to
the reference (SURVEY §7 "hard parts": bit-identical output).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np


def _record_line(name: str, word: bytes, count: int, doc_size: int,
                 df_v: int, num_docs: int) -> bytes:
    """ONE (document, word) output line — the byte-parity-critical math.

    Shared by the dense and sparse formatters so the reference semantics
    (op order and %.16f formatting) live in exactly one place:
    TF = 1.0*count/docSize (``TFIDF.c:202``), IDF = log(1.0*N/DF)
    (``TFIDF.c:243``), line = document@word\\t%.16f (``TFIDF.c:245``).
    """
    tf = 1.0 * count / doc_size
    idf = math.log(1.0 * num_docs / df_v)
    score = tf * idf
    return b"%s@%s\t%s" % (name.encode(), word, b"%.16f" % score)


def format_records(counts: np.ndarray, lengths: np.ndarray, df: np.ndarray,
                   num_docs: int, names: Sequence[str],
                   id_to_word: Dict[int, bytes]) -> List[bytes]:
    """Golden-format lines from integer pipeline outputs.

    Args:
      counts: int [D, V] per-doc term counts (padding docs all-zero).
      lengths: int [D] docSize per doc.
      df: int [V] global document frequencies.
      num_docs: real (unpadded) document count N.
      names: D document names; '' entries (mesh padding) are skipped.
      id_to_word: id -> token bytes for every id with nonzero counts.
    """
    counts = np.asarray(counts)
    lengths = np.asarray(lengths)
    df = np.asarray(df)
    lines: List[bytes] = []
    docs_idx, vocab_idx = np.nonzero(counts)
    for d, v in zip(docs_idx.tolist(), vocab_idx.tolist()):
        name = names[d]
        if not name:
            continue
        lines.append(_record_line(name, id_to_word[v], int(counts[d, v]),
                                  int(lengths[d]), int(df[v]), num_docs))
    lines.sort()
    return lines


def format_sparse_records(ids: np.ndarray, counts: np.ndarray,
                          head: np.ndarray, lengths: np.ndarray,
                          df: np.ndarray, num_docs: int,
                          names: Sequence[str],
                          id_to_word: Dict[int, bytes]) -> List[bytes]:
    """Golden-format lines from the row-sparse engine's outputs.

    Same math and ordering as :func:`format_records`, sourced from
    (ids, counts, head) [D, L] triples instead of a dense [D, V] matrix.
    """
    ids, counts = np.asarray(ids), np.asarray(counts)
    head, lengths, df = np.asarray(head), np.asarray(lengths), np.asarray(df)
    lines: List[bytes] = []
    docs_idx, slot_idx = np.nonzero(head)
    for d, i in zip(docs_idx.tolist(), slot_idx.tolist()):
        name = names[d]
        if not name:
            continue
        v = int(ids[d, i])
        lines.append(_record_line(name, id_to_word[v], int(counts[d, i]),
                                  int(lengths[d]), int(df[v]), num_docs))
    lines.sort()
    return lines


def to_output_bytes(lines: Sequence[bytes]) -> bytes:
    """Join lines into the ``output.txt`` byte stream (``TFIDF.c:278-281``)."""
    return b"".join(line + b"\n" for line in lines)


def write_output(path: str, lines: Sequence[bytes]) -> None:
    with open(path, "wb") as f:
        f.write(to_output_bytes(lines))
