"""IDF and TF-IDF scoring (port of ``tfidf_tpu/ops/scoring.py``).

Reference semantics (``TFIDF.c:227-246``): ``TF = wordCount / docSize``,
``IDF = log(numDocs / DF)`` (natural log, no smoothing — a word in every
document scores exactly 0), ``score = TF * IDF``. Device math runs in the
canonical score dtype; the byte-exact doubles of ``output.txt`` are made
on the host by the formatter from the exact integer counts.

The JAX package's float32 ``jnp.log`` and this port's IDF (see
:func:`idf_from_df`) disagree by one ulp on some inputs, so scores may
differ from the JAX package's by a few ulp; integer outputs are exact.
"""

from __future__ import annotations

import numpy as np
import torch

# JAX without x64 (every configuration the reference package runs)
# computes float64 requests in float32; the port does the same so that
# scores agree.
_CANONICAL = {
    "float32": torch.float32,
    "float64": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def canonical_score_dtype(dtype) -> torch.dtype:
    """The dtype device score math runs in: ``dtype`` with float64
    truncated to float32. Accepts a name, a numpy dtype or a torch
    dtype."""
    if isinstance(dtype, torch.dtype):
        name = str(dtype).removeprefix("torch.")
    elif isinstance(dtype, str):
        name = dtype
    else:
        name = np.dtype(dtype).name
    if name not in _CANONICAL:
        raise ValueError(f"unsupported score dtype {dtype!r} "
                         f"(choose one of {sorted(_CANONICAL)})")
    return _CANONICAL[name]


def idf_from_df(df: torch.Tensor, num_docs, dtype=torch.float32) -> torch.Tensor:
    """``idf[v] = log(num_docs / df[v])``, 0 where df == 0 (the hashed
    vocab has empty buckets).

    The quotient is taken in ``dtype`` as in the JAX package; the log is
    taken in float64 and rounded once to ``dtype``. A float32 ``log`` is
    not reproducible here: on the CPU, PyTorch's (MKL) log gave
    different last bits for the same inputs in two runs, and the CUDA
    and CPU versions differ too. The float64 log rounds to the same
    float32 on every device (but for double-rounding cases), so the
    card and the CPU agree and a run repeats bit for bit.
    """
    dtype = canonical_score_dtype(dtype)
    dff = df.to(dtype)
    n = torch.tensor(num_docs, dtype=dtype, device=df.device)
    quotient = n / torch.clamp_min(dff, 1)
    return torch.where(df > 0, torch.log(quotient.to(torch.float64)).to(dtype),
                       torch.zeros((), dtype=dtype, device=df.device))


def tf_matrix(counts: torch.Tensor, lengths: torch.Tensor,
              dtype=torch.float32) -> torch.Tensor:
    """``tf[d, v] = counts[d, v] / docSize[d]`` (``TFIDF.c:202``)."""
    dtype = canonical_score_dtype(dtype)
    lens = torch.clamp_min(lengths, 1).to(dtype)
    return counts.to(dtype) / lens[:, None]


def tfidf_dense(counts: torch.Tensor, lengths: torch.Tensor, df: torch.Tensor,
                num_docs, dtype=torch.float32) -> torch.Tensor:
    """Dense [D, V] TF-IDF scores = TF ⊙ broadcast(IDF)."""
    return tf_matrix(counts, lengths, dtype) * idf_from_df(df, num_docs, dtype)[None, :]
