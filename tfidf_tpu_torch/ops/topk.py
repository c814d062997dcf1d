"""Per-document top-k selection (port of ``tfidf_tpu/ops/topk.py``'s
``topk_per_doc``).

``lax.top_k`` breaks equal scores toward the LOWER index; ``torch.topk``
does not promise any order among ties. So the selection is a stable
descending sort: among equal scores the lower index stays first.
"""

from __future__ import annotations

from typing import Tuple

import torch


def topk_per_doc(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k (value, vocab-id) per document. [D, V] -> ([D, K], [D, K]),
    ids int32, ties toward the lower id."""
    vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :k].contiguous(), idx[:, :k].to(torch.int32)
