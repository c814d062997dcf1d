"""The plain reference that decides ``correct``: NumPy only.

It imports nothing of the program (``tfidf_tpu_torch``) nor of the JAX
package, and takes nothing the program made: it tokenizes, hashes and
scores the benchmark's own generated text from scratch.

* :mod:`.hashing`: whitespace tokenization and the seeded FNV-1a-64 hash
  folded into the hashed vocabulary.
* :mod:`.tfidf`: DF, IDF, the BM25 and cosine faces, ranked search and
  per-document top-k, in float64 or, for the control, in bfloat16.
* :mod:`.compare`: the numbers ``correct`` is decided by.
"""
