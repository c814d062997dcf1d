"""Device-mesh construction, axis conventions and the mesh collectives
(port of ``tfidf_tpu/parallel/mesh.py``).

Axis semantics are the JAX package's:

* ``docs``  — data parallelism over documents: the reference's rank
  ownership of documents (``TFIDF.c:130``) becomes block-sharding the
  document axis of the packed batch;
* ``vocab`` — the hashed vocabulary axis, sharded when the DF table and
  the score matrix outgrow one device;
* ``seq``   — one document's token chunks spread over devices, the
  histograms summed (``parallel.longdoc``).

The mesh is single-controller, as ``shard_map`` is: one Python process
drives every shard of the plan. A "shard_map" body becomes an explicit
loop over the shards; each shard's block lives on its shard's device and
one shard's work is issued after another's. ``psum`` is a sum of the
shards' tensors in shard order (DF is an exact integer sum) and a tiled
``all_gather`` a ``torch.cat`` in shard order, which is global row order
(the tie order depends on it). Both live here: :meth:`MeshPlan.psum` and
:meth:`MeshPlan.all_gather`.

A plan may repeat a device: those are *virtual shards*, each its own
block on the same card (how a 4-shard mesh runs on one GPU). On the CPU
the plan holds ``[cpu] * n`` for any ``n``, the counterpart of the JAX
tests' forced host device count.

Across processes (``parallel.multihost.initialize``, ``torch.distributed``
over gloo) a plan spans ``world_size`` x its local docs shards: this
process holds global docs shards ``rank * local + i``. The collectives
first reduce the local shards, then make one ``all_reduce``/``all_gather``
of a host tensor, the only cross-process traffic ([V] DF, result rows).
Gloo on host tensors is deliberate: NCCL refuses two ranks on one GPU.

The JAX ``PartitionSpec``/``NamedSharding`` helpers (``batch_spec``,
``sharding``...) have no counterpart: placement is explicit here
(:meth:`MeshPlan.row_blocks`), and the JAX ``parallel/compat.py``
(its ``shard_map`` import shim) has nothing to shim.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

DOCS_AXIS = "docs"
VOCAB_AXIS = "vocab"
SEQ_AXIS = "seq"


def _world() -> Tuple[int, int]:
    """(rank, world size) of an initialized process group, else (0, 1)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def default_devices(device, n_wanted: int) -> List[torch.device]:
    """The devices a plan takes when none are listed: every visible card,
    each once, on CUDA; ``n_wanted`` CPU shards on the CPU."""
    from tfidf_tpu_torch.pipeline import resolve_device
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev] * max(n_wanted, 1)


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """A (docs, seq, vocab) grid of devices plus the mesh collectives.

    ``devices`` are this process's shards in row-major (docs, seq,
    vocab) order; ``shape`` is the global (docs, seq, vocab) size, whose
    docs axis spans ``world`` processes (``rank`` is this one). Build
    with :meth:`create`.
    """

    devices: Tuple[torch.device, ...]
    shape: Tuple[int, int, int]
    rank: int = 0
    world: int = 1

    @staticmethod
    def create(docs: int = 0, vocab: int = 1, seq: int = 1,
               devices: Optional[Sequence] = None, device=None) -> "MeshPlan":
        """Make a (docs, seq, vocab) mesh.

        ``devices`` lists this process's shards (a device may repeat:
        virtual shards). Without it the plan takes every visible card on
        CUDA (the default ``device``; raises without one) or, with
        ``device="cpu"``, as many CPU shards as the axes ask for.
        ``docs=0`` means "all remaining devices": docs is inferred as
        n_devices / (vocab * seq), and on the CPU as 1 per process. Axis
        sizes must multiply to the device count across every process.
        """
        rank, world = _world()
        if devices is None:
            want = docs * vocab * seq // world if docs else vocab * seq
            devs = default_devices(device, want)
        else:
            devs = [torch.device(d) for d in devices]
            if any(d.type == "cuda" for d in devs) \
                    and not torch.cuda.is_available():
                raise RuntimeError("no CUDA device available")
        n = len(devs) * world
        if docs == 0:
            if n % (vocab * seq) != 0:
                raise ValueError(
                    f"{n} devices not divisible by vocab*seq={vocab * seq}")
            docs = n // (vocab * seq)
        if docs * vocab * seq != n:
            raise ValueError(f"mesh {docs}x{seq}x{vocab} != {n} devices")
        if docs % world:
            raise ValueError(f"{docs} docs shards do not split over "
                             f"{world} processes")
        return MeshPlan(tuple(devs), (docs, seq, vocab), rank, world)

    # --- axis sizes ---
    @property
    def n_docs_shards(self) -> int:
        return self.shape[0]

    @property
    def n_seq_shards(self) -> int:
        return self.shape[1]

    @property
    def n_vocab_shards(self) -> int:
        return self.shape[2]

    @property
    def n_local_docs(self) -> int:
        """Docs shards this process holds."""
        return self.shape[0] // self.world

    @property
    def first_docs_shard(self) -> int:
        """Global index of this process's first docs shard."""
        return self.rank * self.n_local_docs

    @property
    def n_cards(self) -> int:
        """Distinct devices across every process: the budgets that are
        per card (resident corpus, triple cache) scale with this, and
        virtual shards share their card's."""
        return len(set(self.devices)) * self.world

    def device(self, d: int = 0, s: int = 0, v: int = 0) -> torch.device:
        """The device of local docs shard ``d``, seq shard ``s``, vocab
        shard ``v``."""
        return self.devices[(d * self.shape[1] + s) * self.shape[2] + v]

    def pad_docs(self, num_docs: int) -> int:
        """Round a document count up to a docs-shard multiple."""
        shards = self.n_docs_shards
        return int(math.ceil(max(num_docs, 1) / shards) * shards)

    def pad_vocab(self, vocab_size: int) -> int:
        shards = self.n_vocab_shards
        return int(math.ceil(max(vocab_size, 1) / shards) * shards)

    def pad_tokens(self, length: int) -> int:
        shards = self.n_seq_shards
        return int(math.ceil(max(length, 1) / shards) * shards)

    # --- placement ---
    def row_blocks(self, arr) -> List[np.ndarray]:
        """This process's docs-shard row blocks of a global host array
        whose leading axis is the (padded) document axis."""
        dl = arr.shape[0] // self.n_docs_shards
        lo = self.first_docs_shard * dl
        return [arr[lo + i * dl:lo + (i + 1) * dl]
                for i in range(self.n_local_docs)]

    # --- collectives ---
    def psum(self, parts: Sequence[torch.Tensor],
             across_processes: bool = True) -> torch.Tensor:
        """Sum of the shards' tensors in shard order, on the first part's
        device. With ``across_processes`` (a reduction over the docs
        axis) the local sum is then summed over every process: one
        gloo ``all_reduce`` of a host copy."""
        out = parts[0].clone()
        for p in parts[1:]:
            out += p.to(out.device)
        if across_processes and self.world > 1:
            import torch.distributed as dist
            host = out.cpu()
            dist.all_reduce(host)
            out = host.to(out.device)
        return out

    def all_gather(self, parts: Sequence[torch.Tensor], dim: int = 0,
                   across_processes: bool = False) -> torch.Tensor:
        """The tiled ``all_gather``: the shards' tensors concatenated
        along ``dim`` in shard order, on the first part's device. With
        ``across_processes`` (a gather over the docs axis) every
        process's local concatenation (all the same shape) is then
        gathered in rank order: one gloo ``all_gather`` of a host copy."""
        dev = parts[0].device
        out = torch.cat([p.to(dev) for p in parts], dim=dim)
        if across_processes and self.world > 1:
            import torch.distributed as dist
            host = out.cpu()
            wire = host.view(torch.int32) if host.dtype == torch.uint32 \
                else host
            got = [torch.empty_like(wire) for _ in range(self.world)]
            dist.all_gather(got, wire.contiguous())
            out = torch.cat(got, dim=dim).view(host.dtype).to(dev)
        return out
