"""Command line of the PyTorch/CUDA port: the ``run`` subcommand.

    python -m tfidf_tpu_torch.cli run --input DIR [--output output.txt]
        [--vocab-mode exact|hashed] [--vocab-size N] [--topk K]
        [--engine dense|sparse] [--result-wire packed|pair]
        [--score-dtype float32|bfloat16|float16] [--device cuda|cpu]

Without ``--topk`` it writes the reference's ``output.txt`` (byte-
identical to the MPI reference on EXACT vocab); with ``--topk`` it
writes the top-k report in the JAX CLI's format. It runs on CUDA unless
``--device cpu`` is given, and fails when no GPU is present and no
device was named.
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


def _run(args) -> int:
    from tfidf_tpu_torch.config import PipelineConfig, VocabMode
    from tfidf_tpu_torch.formatter import write_output
    from tfidf_tpu_torch.io.corpus import discover_corpus
    from tfidf_tpu_torch.pipeline import TfidfPipeline

    cfg = PipelineConfig(vocab_mode=VocabMode(args.vocab_mode),
                         vocab_size=args.vocab_size, topk=args.topk,
                         engine=args.engine, result_wire=args.result_wire,
                         score_dtype=args.score_dtype)
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
