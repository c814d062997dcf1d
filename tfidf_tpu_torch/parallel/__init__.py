"""Distributed execution: mesh plans, collectives, sharded pipelines (port
of ``tfidf_tpu/parallel``).

The reference distributes with MPI ranks and explicit messages; here a
:class:`MeshPlan` lays a (docs, seq, vocab) grid over devices (several
cards, or virtual shards on one), one process drives every shard, and
the reference's reduce + bcast pair (``TFIDF.c:215,220``) is one
:meth:`MeshPlan.psum`. ``parallel.serving`` shards a retriever's index
over a docs-only plan (``make_serving_plan``, ``shard_index``,
``MeshShardedRetriever``). ``parallel.multihost`` adds the
process-spanning forms: ``initialize`` (``torch.distributed`` over gloo)
and the mpi_lite sharded ingest (``run_sharded_ingest``). The JAX package's
``shard_map`` shim (``parallel/compat.py``) has no counterpart.
"""

from tfidf_tpu_torch.parallel.collectives import sharded_tf_df
from tfidf_tpu_torch.parallel.mesh import (DOCS_AXIS, SEQ_AXIS, VOCAB_AXIS,
                                           MeshPlan)
from tfidf_tpu_torch.parallel.serving import (MeshShardedRetriever,
                                              make_serving_plan, shard_index)
from tfidf_tpu_torch.parallel.sharded import ShardedPipeline

__all__ = [
    "MeshPlan",
    "DOCS_AXIS",
    "VOCAB_AXIS",
    "SEQ_AXIS",
    "ShardedPipeline",
    "sharded_tf_df",
    "MeshShardedRetriever",
    "make_serving_plan",
    "shard_index",
]
