"""The port's command line accepts every option of the JAX package's
(``tfidf_tpu_torch/cli.py`` against ``tfidf_tpu/cli.py``), on the CPU.

* Each subcommand of the two ``_build_parser()``s has the same option
  strings, the same action kinds, choices and defaults, but for a
  written allow-list of divergences: ``--device`` on every subcommand
  and ``run --score-dtype`` exist only in the port, and ``run
  --backend`` also takes ``cuda`` (its default; ``tpu`` is the JAX
  CLI's name for the same accelerator path).
* The options whose meaning is XLA's run as documented no-ops or
  aliases: ``--compile-cache DIR`` (``run``, ``query``, ``serve``) and
  ``run --backend tpu`` leave the output bytes unchanged.
* ``run --pallas`` writes the JAX CLI's bytes on the toy corpus (hashed
  top-k, where it turns the default engine dense, and the golden exact
  vocab), and with ``--doc-len`` exits 2 with the JAX CLI's message.
* ``query --trace`` writes the JAX CLI's span names and the same
  results.
"""

import json

import pytest

from tfidf_tpu.cli import _build_parser as jax_parser
from tfidf_tpu.cli import main as jax_main

from tfidf_tpu_torch import obs
from tfidf_tpu_torch.cli import _build_parser as port_parser
from tfidf_tpu_torch.cli import main as port_main
from test_torch_hygiene import PORT_ONLY_VOCAB

SUBCOMMANDS = ["run", "stream", "query", "serve"]
# (subcommand, option) -> why it exists only in the port
PORT_ONLY = {(cmd, "--device"): "the torch device (cuda unless named)"
             for cmd in SUBCOMMANDS}
PORT_ONLY["run", "--score-dtype"] = "the score dtype of a run"
# (subcommand, option) -> the port's (choices, default) where they differ
DIVERGENT = {("run", "--backend"): (["cuda", "tpu", "mpi"], "cuda")}


def _subparsers(parser):
    action = next(a for a in parser._actions
                  if a.__class__.__name__ == "_SubParsersAction")
    return action.choices


@pytest.fixture(scope="module")
def parsers():
    return _subparsers(jax_parser()), _subparsers(port_parser())


def test_same_subcommands(parsers):
    jax, port = parsers
    assert sorted(jax) == sorted(port) == sorted(SUBCOMMANDS)


@pytest.mark.parametrize("cmd", SUBCOMMANDS)
def test_option_strings(parsers, cmd):
    jax, port = (p[cmd]._option_string_actions for p in parsers)
    assert not set(jax) - set(port), "JAX options the port rejects"
    extra = {(cmd, opt) for opt in set(port) - set(jax)}
    assert extra == {key for key in PORT_ONLY if key[0] == cmd}


@pytest.mark.parametrize("cmd", SUBCOMMANDS)
def test_kinds_choices_and_defaults(parsers, cmd):
    jax, port = (p[cmd]._option_string_actions for p in parsers)
    for opt in sorted(set(jax) & set(port)):
        j, p = jax[opt], port[opt]
        assert type(j) is type(p), opt
        assert j.nargs == p.nargs and j.required == p.required, opt
        if (cmd, opt) in DIVERGENT:
            choices, default = DIVERGENT[cmd, opt]
            assert set(j.choices) <= set(p.choices) == set(choices), opt
            assert p.default == default
            continue
        assert j.choices == p.choices, opt
        assert j.default == p.default, opt


def test_backend_choices(parsers):
    jax, port = (p["run"]._option_string_actions["--backend"].choices
                 for p in parsers)
    assert jax == ["tpu", "mpi"]
    assert port == ["cuda", "tpu", "mpi"]


RUN_CASES = {
    "hashed_topk": ["--vocab-mode", "hashed", "--topk", "3"],
    "golden": [],
    # the JAX run_bytes returns full-precision scores: the pair wire
    "chargram": ["--vocab-mode", "hashed", "--topk", "3", "--tokenizer",
                 "chargram", "--result-wire", "pair"],
}


@pytest.mark.parametrize("case", sorted(RUN_CASES))
def test_run_pallas_same_bytes_as_jax(toy_corpus_dir, tmp_path, case):
    args = ["run", "--input", toy_corpus_dir, "--pallas", *RUN_CASES[case]]
    ours, theirs = str(tmp_path / "o.txt"), str(tmp_path / "j.txt")
    assert port_main(args + ["--output", ours, "--device", "cpu"]) == 0
    assert jax_main(args + ["--output", theirs]) == 0
    got = open(ours, "rb").read()
    assert got and got == open(theirs, "rb").read()


def test_run_pallas_turns_the_default_engine_dense():
    from tfidf_tpu_torch.config import PipelineConfig, VocabMode
    assert PipelineConfig(vocab_mode=VocabMode.HASHED,
                          use_pallas=True).engine == "dense"
    assert PipelineConfig(vocab_mode=VocabMode.HASHED).engine == "sparse"


def test_run_pallas_with_doc_len_exits_2(toy_corpus_dir, tmp_path, capsys):
    args = ["run", "--input", toy_corpus_dir, "--output",
            str(tmp_path / "o.txt"), "--vocab-mode", "hashed", "--topk", "3",
            "--pallas", "--doc-len", "8"]
    assert port_main(args + ["--device", "cpu"]) == 2
    ours = capsys.readouterr().err
    assert "no --pallas" in ours
    assert jax_main(args) == 2
    assert capsys.readouterr().err == ours


@pytest.mark.parametrize("flags", [["--backend", "tpu"],
                                   ["--compile-cache", "CACHE"],
                                   ["--backend", "tpu", "--doc-len", "16"]])
def test_run_aliases_and_no_ops(toy_corpus_dir, tmp_path, flags):
    flags = [str(tmp_path / "cache") if f == "CACHE" else f for f in flags]
    base = ["run", "--input", toy_corpus_dir, "--vocab-mode", "hashed",
            "--topk", "3", "--device", "cpu"]
    if "--doc-len" in flags:
        base += flags[flags.index("--doc-len"):]
        flags = flags[:flags.index("--doc-len")]
    plain, other = str(tmp_path / "p.txt"), str(tmp_path / "o.txt")
    assert port_main(base + ["--output", plain]) == 0
    assert port_main(base + flags + ["--output", other]) == 0
    assert open(other, "rb").read() == open(plain, "rb").read()
    assert not (tmp_path / "cache").exists()  # nothing compiled, nothing kept


def _spans(path):
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    return sorted({e["name"] for e in events if e.get("ph") == "X"})


@pytest.mark.parametrize("extra", [[], ["--compile-cache", "CACHE"]])
def test_query_trace_as_in_jax(toy_corpus_dir, tmp_path, capsys, extra):
    extra = [str(tmp_path / "cache") if f == "CACHE" else f for f in extra]
    args = ["query", "--input", toy_corpus_dir, "--query", "tpu mesh",
            "--query", "kernel", "-k", "3", *extra]
    ours, theirs = str(tmp_path / "o.json"), str(tmp_path / "j.json")
    try:
        assert port_main(args + ["--trace", ours, "--device", "cpu"]) == 0
    finally:
        obs.set_tracer(None)
    out = capsys.readouterr()
    assert f"trace written to {ours}" in out.err
    assert jax_main(args + ["--trace", theirs]) == 0
    jout = capsys.readouterr().out
    assert out.out == jout
    # less the spans only the port records (the fill, the tile steps)
    port_only = {name for _, _, name in PORT_ONLY_VOCAB}
    assert [n for n in _spans(ours) if n not in port_only] \
        == _spans(theirs) == ["h2d", "score_tile"]


def test_serve_compile_cache_accepted(toy_corpus_dir, tmp_path, monkeypatch,
                                      capsys):
    import io
    lines = [json.dumps({"id": 1, "queries": ["tpu mesh"], "k": 3}),
             json.dumps({"op": "shutdown"})]
    monkeypatch.setattr("sys.stdin", io.StringIO("\n".join(lines) + "\n"))
    assert port_main(["serve", "--input", toy_corpus_dir, "--compile-cache",
                      str(tmp_path / "cache"), "--canary-period-ms", "0",
                      "--device", "cpu"]) == 0
    resp = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x]
    assert resp[0]["id"] == 1 and resp[0]["results"][0]
