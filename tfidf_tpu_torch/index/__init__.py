"""LSM-style segmented index: live add/update/delete without rebuilding
the world (port of ``tfidf_tpu/index``).

Composition::

    SegmentedIndex ── delta Segment (absorbing adds/updates)
        │                 └─ seals when full  -> sealed Segment
        ├─ sealed Segments (immutable, compacted by Compactor)
        └─ view() -> IndexView  (immutable snapshot; answers the
                                 TfidfRetriever search contract)

Every mutation bumps the visibility version. Search scores the live
segments against the corrected global DF/IDF: bit-identical to a
from-scratch rebuild of the live corpus (``rebuild_retriever``).
"""

from tfidf_tpu_torch.index.compactor import Compactor
from tfidf_tpu_torch.index.segment import Segment
from tfidf_tpu_torch.index.segmented import IndexView, SegmentedIndex

__all__ = ["SegmentedIndex", "IndexView", "Segment", "Compactor"]
