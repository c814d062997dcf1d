"""Command line of the PyTorch/CUDA port: the ``run``, ``stream`` and
``query`` subcommands.

    python -m tfidf_tpu_torch.cli run --input DIR [--output output.txt]
        [--vocab-mode exact|hashed] [--vocab-size N] [--topk K]
        [--engine dense|sparse] [--result-wire packed|pair]
        [--score-dtype float32|bfloat16|float16] [--device cuda|cpu]
        [--doc-len L [--chunk-docs N] [--spill auto|host|reread]
         [--wire ragged|padded|bytes] [--finish scan|chunked]
         [--pack-threads T]]

Without ``--topk`` it writes the reference's ``output.txt`` (byte-
identical to the MPI reference on EXACT vocab); with ``--topk`` it
writes the top-k report in the JAX CLI's format. A hashed top-k run
with ``--doc-len`` goes through the overlapped chunked ingest
(``ingest.run_overlapped``; documents longer than L tokens are
truncated, terms print as ``id:N``), any other run through
``TfidfPipeline``.

    python -m tfidf_tpu_torch.cli stream --input DIR [--output output.txt]
        [--batch-docs N] [--doc-len L] [--vocab-size V] [--topk K]
        [--checkpoint CK [--resume]] [--no-strict] [--timing]
        [--trace out.json] [--device cuda|cpu]

streams the directory in minibatches of N documents (``StreamingTfidf``):
pass 1 folds DF, saving the state to ``--checkpoint`` after every
minibatch; pass 2 scores every minibatch against the final DF and writes
the top-k report. ``--resume`` restores the checkpoint and skips the
``docs_seen`` documents already folded, in discovery order, so a killed
and resumed run writes the same bytes as an uninterrupted one (and as
the JAX CLI's ``stream``).

    python -m tfidf_tpu_torch.cli query --input DIR --query TEXT
        [--query TEXT ...] [-k K] [--vocab-size N] [--doc-len L]
        [--no-strict] [--device cuda|cpu]

indexes the directory (``TfidfRetriever.index_dir``; ``--doc-len``
through the overlapped ingest's chunk step) and prints, per query,
``query: <text>`` then one ``  <name>\t<score>`` line per result, as the
JAX CLI's ``query`` does.

Each runs on CUDA unless ``--device cpu`` is given, and fails when no GPU
is present and no device was named.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tfidf-torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)
    run = sub.add_parser("run", help="run the TF-IDF pipeline")
    run.add_argument("--input", required=True, help="document directory")
    run.add_argument("--output", default="output.txt",
                     help="output file (reference format)")
    run.add_argument("--vocab-mode", choices=["exact", "hashed"],
                     default="exact")
    run.add_argument("--vocab-size", type=int, default=1 << 16,
                     help="hashed vocabulary size")
    run.add_argument("--topk", type=int, default=None,
                     help="emit only the top-k terms per document")
    run.add_argument("--engine", choices=["dense", "sparse"], default=None,
                     help="default: sparse for hashed vocab, dense for exact")
    run.add_argument("--result-wire", choices=["packed", "pair"],
                     default="packed",
                     help="top-k fetch: uint32 words (float16 scores) or "
                          "full-precision (id, score) pairs")
    run.add_argument("--score-dtype",
                     choices=["float32", "bfloat16", "float16"],
                     default="float32")
    run.add_argument("--device", default=None,
                     help="torch device (default: cuda; 'cpu' runs the "
                          "kernels' plain versions)")
    run.add_argument("--doc-len", type=int, default=None,
                     help="static tokens per document: opts hashed top-k "
                          "runs into the overlapped chunked ingest; longer "
                          "documents are truncated and terms print as id:N")
    run.add_argument("--chunk-docs", type=int, default=None,
                     help="documents per ingest chunk (--doc-len runs; "
                          "default 8192)")
    run.add_argument("--spill", choices=["auto", "host", "reread"],
                     default=None,
                     help="streaming regime (--doc-len runs only): keep "
                          "chunks in host RAM between passes, re-read them "
                          "from disk, or pick by byte budget (default auto)")
    run.add_argument("--wire", choices=["ragged", "padded", "bytes"],
                     default="ragged",
                     help="host->device chunk wire (--doc-len runs): "
                          "'ragged' ships one flat uint16 id stream per "
                          "chunk, rebuilt on the device; 'bytes' ships raw "
                          "document bytes, tokenized and hashed on the "
                          "device; 'padded' ships the [D, L] batch")
    run.add_argument("--finish", choices=["scan", "chunked"], default=None,
                     help="packed-wire phase-B finish (--doc-len runs): "
                          "'scan' (default) fills one result buffer for "
                          "all chunks, drained by one copy; 'chunked' "
                          "drains each chunk's words as it is scored")
    run.add_argument("--pack-threads", type=int, default=None,
                     help="host packer threads of the native loader "
                          "(default every core; env TFIDF_TPU_PACK_THREADS)")
    st = sub.add_parser(
        "stream",
        help="stream the corpus in minibatches with checkpoint/resume")
    st.add_argument("--input", required=True, help="document directory")
    st.add_argument("--output", default="output.txt",
                    help="top-k output file")
    st.add_argument("--batch-docs", type=int, default=256,
                    help="documents per minibatch")
    st.add_argument("--doc-len", type=int, default=256,
                    help="static tokens per document (longer docs are "
                         "truncated; one shape for the whole stream)")
    st.add_argument("--vocab-size", type=int, default=1 << 16)
    st.add_argument("--topk", type=int, default=8)
    st.add_argument("--mesh-docs", type=int, default=None,
                    help="shard each minibatch over this many devices "
                         "(not ported yet: ROADMAP A9)")
    st.add_argument("--checkpoint", default=None,
                    help="checkpoint directory; state is saved after "
                         "every minibatch")
    st.add_argument("--resume", action="store_true",
                    help="restore from --checkpoint and skip the "
                         "documents already folded into the DF state")
    st.add_argument("--no-strict", action="store_true")
    st.add_argument("--timing", action="store_true",
                    help="print per-phase wall-clock (pass1/pass2/emit) "
                         "and docs/sec to stderr")
    st.add_argument("--trace", default=None,
                    help="record spans and write them as Chrome trace "
                         "JSON to this path (or TFIDF_TPU_TRACE)")
    st.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    q = sub.add_parser(
        "query", help="index a corpus and run ranked cosine retrieval")
    q.add_argument("--input", required=True, help="document directory")
    q.add_argument("--query", action="append", required=True,
                   help="query text (repeatable)")
    q.add_argument("-k", type=int, default=5, help="results per query")
    q.add_argument("--vocab-size", type=int, default=1 << 16)
    q.add_argument("--mesh-docs", type=int, default=None,
                   help="shard the index over this many devices (not "
                        "ported yet: ROADMAP A9)")
    q.add_argument("--doc-len", type=int, default=None,
                   help="static tokens per document: index via the "
                        "overlapped ingest's chunk step (native loader; "
                        "longer docs truncated)")
    q.add_argument("--no-strict", action="store_true")
    q.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' runs the "
                        "kernels' plain versions)")
    return p


def _run_query(args) -> int:
    """Index + search: ``<name>\t<score>`` per result line."""
    from tfidf_tpu_torch.config import PipelineConfig, VocabMode
    from tfidf_tpu_torch.models import TfidfRetriever

    if args.mesh_docs is not None:
        raise NotImplementedError(
            "query --mesh-docs (the docs-sharded index) is not ported yet: "
            "ROADMAP A9")
    cfg = PipelineConfig(vocab_mode=VocabMode.HASHED,
                         vocab_size=args.vocab_size)
    r = TfidfRetriever(cfg, device=args.device).index_dir(
        args.input, strict=not args.no_strict, doc_len=args.doc_len)
    vals, idx = r.search(args.query, k=args.k)
    for qi, text in enumerate(args.query):
        print(f"query: {text}")
        for v, d in zip(vals[qi], idx[qi]):
            if d < 0:
                continue
            print(f"  {r.names[int(d)]}\t{float(v):.6f}")
    return 0


def _write_topk(path: str, result) -> None:
    """Top-k report: doc@word\\tscore lines in raw-line strcmp order,
    the same format as the JAX CLI's ``run --topk``."""
    lines: List[bytes] = []
    for d in range(result.num_docs):
        name = result.names[d].encode()
        for v, s in zip(result.topk_ids[d], result.topk_vals[d]):
            if s <= 0:
                continue  # padding / sub-k docs
            word = result.id_to_word.get(int(v), b"id:%d" % int(v))
            lines.append(b"%s@%s\t%.16f" % (name, word, float(s)))
    lines.sort()
    with open(path, "wb") as f:
        f.write(b"".join(line + b"\n" for line in lines))


def _run_stream(args) -> int:
    """Two-pass streaming job: fold DF per minibatch (checkpointing as it
    goes), then score every minibatch against the corpus-wide DF.

    Resume contract: documents stream in the deterministic discovery
    order, so ``docs_seen`` from a restored checkpoint is the exact
    restart position.
    """
    import contextlib
    import types

    import numpy as np

    from tfidf_tpu_torch import checkpoint as ckpt
    from tfidf_tpu_torch.config import PipelineConfig, VocabMode
    from tfidf_tpu_torch.ingest import make_chunk_packer
    from tfidf_tpu_torch.io.corpus import PackedBatch, discover_names
    from tfidf_tpu_torch.pipeline import _host
    from tfidf_tpu_torch.streaming import StreamingTfidf
    from tfidf_tpu_torch.utils.timing import PhaseTimer

    if args.mesh_docs is not None:
        raise NotImplementedError(
            "stream --mesh-docs (the docs-sharded stream) is not ported "
            "yet: ROADMAP A9")
    cfg = PipelineConfig(vocab_mode=VocabMode.HASHED,
                         vocab_size=args.vocab_size, topk=args.topk,
                         max_doc_len=args.doc_len, doc_chunk=args.doc_len)
    stream = StreamingTfidf(cfg, device=args.device)
    names = discover_names(args.input, strict=not args.no_strict)
    if not names:
        sys.stderr.write(f"error: no documents in {args.input}\n")
        return 1

    start = 0
    if args.resume and args.checkpoint and ckpt.exists(args.checkpoint):
        stream.load_state(ckpt.restore_state(args.checkpoint))
        start = stream.docs_seen
        print(f"resumed at doc {start} ({args.checkpoint})")

    # Minibatches come off the native parallel loader when it builds
    # (uint16 ids), else the Python pack path: the ingest's packer. Every
    # batch is padded to batch_docs x doc_len.
    packer = make_chunk_packer(args.input, cfg, args.batch_docs,
                               args.doc_len)

    def batches(from_doc: int):
        for lo in range(from_doc, len(names), args.batch_docs):
            batch_names = names[lo:lo + args.batch_docs]
            token_ids, lengths = packer(batch_names)
            # PackedBatch invariant: one name per row, '' for padding.
            padded = batch_names + [""] * (token_ids.shape[0]
                                           - len(batch_names))
            yield PackedBatch(
                token_ids=token_ids, lengths=lengths,
                num_docs=len(batch_names), names=padded,
                vocab_size=cfg.vocab_size, id_to_word=None)

    timer = PhaseTimer() if args.timing else None

    def phase(name):
        return timer.phase(name) if timer else contextlib.nullcontext()

    # Pass 1: fold DF, checkpoint after every minibatch.
    with phase("pass1_df"):
        for batch in batches(start):
            stream.update(batch)
            if args.checkpoint:
                ckpt.save_state(args.checkpoint, stream.state_dict())
    print(f"df folded over {stream.docs_seen} docs")

    # Pass 2: score all minibatches against the final DF snapshot.
    all_names: List[str] = []
    all_vals, all_ids = [], []
    with phase("pass2_score"):
        for batch in batches(0):
            vals, ids = stream.score(batch)
            if not isinstance(vals, np.ndarray):  # the pair wire
                vals, ids = _host(vals), _host(ids)
            all_names.extend(batch.names[:batch.num_docs])
            all_vals.append(vals[:batch.num_docs])
            all_ids.append(ids[:batch.num_docs])
    report = types.SimpleNamespace(
        num_docs=len(all_names), names=all_names,
        topk_vals=np.concatenate(all_vals), topk_ids=np.concatenate(all_ids),
        id_to_word={})
    with phase("emit"):
        _write_topk(args.output, report)  # same format as `run --topk`
    if timer is not None:
        acc = timer.as_dict()
        total = sum(acc.values()) or 1.0
        rows = [f"{n:>12}: {s * 1e3:9.1f} ms ({100 * s / total:4.1f}%)"
                for n, s in acc.items()]
        sys.stderr.write("\n".join(rows) + f"\n{'docs/sec':>12}: "
                         f"{len(all_names) / total:9.1f}\n")
    print(f"wrote {args.output} ({stream.docs_seen} docs)")
    return 0


def _overlapped(args, cfg) -> Optional[bool]:
    """The JAX CLI's gating of ``--doc-len`` runs: True to take the
    overlapped ingest, False for the batch pipeline, None after an error
    message (exit 2). Prints the same warnings as the JAX CLI."""
    from tfidf_tpu_torch.config import VocabMode
    from tfidf_tpu_torch.ingest import use_bytes_wire
    from tfidf_tpu_torch.ops.downlink import use_packed_result_wire

    if args.doc_len is not None and args.doc_len < 1:
        sys.stderr.write("error: --doc-len must be >= 1\n")
        return None
    if args.chunk_docs is not None and args.chunk_docs < 1:
        sys.stderr.write("error: --chunk-docs must be >= 1\n")
        return None
    if args.doc_len is None and (args.spill is not None
                                 or args.chunk_docs is not None):
        sys.stderr.write("error: --spill/--chunk-docs only apply to "
                         "--doc-len (overlapped ingest) runs\n")
        return None
    overlapped = (args.doc_len is not None
                  and cfg.vocab_mode is VocabMode.HASHED
                  and cfg.topk is not None and cfg.engine == "sparse")
    if args.finish == "scan" and overlapped \
            and not use_packed_result_wire(cfg):
        sys.stderr.write(
            "warning: --finish=scan needs the packed result wire; "
            "falling back to the chunked/fused finish (the pair "
            "and exact wires' fused finish program is already one "
            "dispatch)\n")
    if args.wire == "bytes" and (
            not overlapped
            or not use_bytes_wire(cfg, args.chunk_docs or 8192,
                                  args.doc_len or cfg.max_doc_len)):
        sys.stderr.write(
            "warning: --wire=bytes needs a single-device hashed "
            "whitespace --doc-len run with vocab <= 2^16; falling "
            "back to the ragged/padded id wire\n")
    if args.doc_len is not None and not overlapped:
        sys.stderr.write("error: --doc-len (overlapped ingest) needs "
                         "--vocab-mode hashed, --topk, the whitespace "
                         "tokenizer, the sparse engine, no --pallas, "
                         "and a docs-only --mesh (seq=1, vocab=1) if "
                         "any\n")
        return None
    return overlapped


def _run(args) -> int:
    import types

    from tfidf_tpu_torch.config import PipelineConfig, VocabMode
    from tfidf_tpu_torch.formatter import write_output
    from tfidf_tpu_torch.io.corpus import discover_corpus
    from tfidf_tpu_torch.pipeline import TfidfPipeline

    cfg = PipelineConfig(vocab_mode=VocabMode(args.vocab_mode),
                         vocab_size=args.vocab_size, topk=args.topk,
                         engine=args.engine, result_wire=args.result_wire,
                         score_dtype=args.score_dtype, wire=args.wire,
                         pack_threads=args.pack_threads,
                         finish=args.finish or "scan")
    overlapped = _overlapped(args, cfg)
    if overlapped is None:
        return 2
    if overlapped:
        from tfidf_tpu_torch.ingest import run_overlapped
        r = run_overlapped(args.input, cfg, doc_len=args.doc_len,
                           chunk_docs=args.chunk_docs or 8192,
                           spill=args.spill or "auto", device=args.device)
        result = types.SimpleNamespace(
            num_docs=r.num_docs, names=r.names, topk_vals=r.topk_vals,
            topk_ids=r.topk_ids, id_to_word={})
    else:
        pipe = TfidfPipeline(cfg, device=args.device)
        result = pipe.run(discover_corpus(args.input))
    if args.topk is None:
        write_output(args.output, result.output_lines())
    else:
        _write_topk(args.output, result)
    print(f"wrote {args.output} ({result.num_docs} docs)")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    args = _build_parser().parse_args(argv)
    if args.cmd == "query":
        return _run_query(args)
    if args.cmd == "run":
        return _run(args)
    # Arm the span tracer (--trace / TFIDF_TPU_TRACE; a no-op when neither
    # is set) and export what was recorded on any exit.
    from tfidf_tpu_torch import obs
    obs.configure(args.trace)
    try:
        return _run_stream(args)
    finally:
        path = obs.export()
        if path:
            sys.stderr.write(f"trace written to {path} (Chrome trace "
                             f"JSON: open in Perfetto)\n")


if __name__ == "__main__":
    sys.exit(main())
