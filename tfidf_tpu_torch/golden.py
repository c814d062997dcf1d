"""Pure-Python golden oracle: byte-identical output to the C reference.

Copy of ``tfidf_tpu/golden.py`` (the port imports nothing of the JAX
package); the two must stay identical.

This is the executable specification of the reference's semantics
(SURVEY §2-§3), used to validate the device pipelines and the native
bit-reference under ``native/``. It deliberately runs the same double
operations in the same order as the C code:

* ``TF = 1.0 * wordCount / docSize``            (``TFIDF.c:202``)
* ``IDF = log(1.0 * numDocs / numDocsWithWord)``(``TFIDF.c:243``) —
  natural log, no smoothing; a word in every doc scores exactly 0.
* ``score = TF * IDF``                          (``TFIDF.c:244``)
* line = ``"%s@%s\\t%.16f" % (document, word, score)`` — note the output
  key order is document@word while the debug prints are word@document
  (SURVEY §2.5 C9).
* final ordering: ``qsort`` with ``strcmp`` (``TFIDF.c:273``) — raw-byte
  lexicographic, so ``doc10@...`` sorts before ``doc2@...``.

Python's float is the same IEEE double and ``%.16f`` performs the same
correctly-rounded decimal conversion as glibc, so lines match byte for
byte. Valid only inside the reference's envelope (SURVEY §2.5): the
oracle does NOT reproduce the 32-record silent overflows or the >=16-char
token buffer overflow — those are bugs, not semantics.
"""

from __future__ import annotations

import math
from typing import Dict, List

from tfidf_tpu_torch.io.corpus import Corpus
from tfidf_tpu_torch.ops.tokenize import whitespace_tokenize


def golden_lines(corpus: Corpus) -> List[bytes]:
    """TF-IDF output lines for a corpus, bit-identical to the reference.

    One line per (document, word) pair in which the word occurs, sorted
    raw-byte lexicographically, no trailing newline per element.
    """
    token_docs = [whitespace_tokenize(doc) for doc in corpus.docs]
    num_docs = len(corpus)

    # DF: number of documents containing each word (dedup within doc —
    # the reference's currDoc mechanism, TFIDF.c:171-188).
    df: Dict[bytes, int] = {}
    for toks in token_docs:
        for w in set(toks):
            df[w] = df.get(w, 0) + 1

    lines: List[bytes] = []
    for name, toks in zip(corpus.names, token_docs):
        doc_size = len(toks)
        counts: Dict[bytes, int] = {}
        for w in toks:
            counts[w] = counts.get(w, 0) + 1
        for w, c in counts.items():
            tf = 1.0 * c / doc_size
            idf = math.log(1.0 * num_docs / df[w])
            score = tf * idf
            lines.append(b"%s@%s\t%s" % (
                name.encode(), w, (b"%.16f" % score)))
    lines.sort()  # bytes compare == strcmp ordering (TFIDF.c:47-50,273)
    return lines


def golden_output(corpus: Corpus) -> bytes:
    """The full ``output.txt`` byte stream (one line per record,
    ``\\n``-terminated, ``TFIDF.c:278-281``)."""
    return b"".join(line + b"\n" for line in golden_lines(corpus))


def inspect_tables(corpus: Corpus) -> bytes:
    """The reference's per-phase debug tables (``--inspect``).

    Mirrors the eyeball-diff prints of the reference — the "TF Job"
    table (``word@document\\twordCount/docSize``, ``TFIDF.c:199-205``)
    and the "IDF Job" table (``word@document\\tnumDocs/numDocsWithWord``,
    ``TFIDF.c:236-239``) — in the same formats, including the
    word@document key order that is REVERSED from the final output's
    document@word (SURVEY §2.5 C9). Record order is per-document in
    discovery order, first-seen word order within a document; the
    reference's own interleaving depends on its rank schedule and is
    not a contract. Intended for toy corpora, exactly like the
    original prints.
    """
    token_docs = [whitespace_tokenize(doc) for doc in corpus.docs]
    num_docs = len(corpus)
    df: Dict[bytes, int] = {}
    for toks in token_docs:
        for w in set(toks):
            df[w] = df.get(w, 0) + 1
    per_doc = []
    for name, toks in zip(corpus.names, token_docs):
        counts: Dict[bytes, int] = {}
        for w in toks:
            counts[w] = counts.get(w, 0) + 1
        per_doc.append((name.encode(), len(toks), counts))
    out: List[bytes] = [b"-------------TF Job-------------"]
    for name, size, counts in per_doc:
        for w, c in counts.items():
            out.append(b"%s@%s\t%d/%d" % (w, name, c, size))
    out.append(b"------------IDF Job-------------")
    for name, size, counts in per_doc:
        for w in counts:
            out.append(b"%s@%s\t%d/%d" % (w, name, num_docs, df[w]))
    return b"".join(l + b"\n" for l in out)
