"""Command line of the PyTorch/CUDA port: the ``run`` subcommand.

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
``TfidfPipeline``. It runs on CUDA unless ``--device cpu`` is given, and
fails when no GPU is present and no device was named.
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
    return p


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
    return _run(_build_parser().parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
