"""Boundaries of the PyTorch/CUDA port.

* No module of ``tfidf_tpu_torch`` (nor ``chip_smoke.py``) imports JAX or
  the JAX package. The check is static (``ast``): a test process may
  already hold jax in ``sys.modules`` from interpreter start-up, so a
  runtime check would prove nothing.
* Entry points run on CUDA unless told otherwise: with no GPU and no
  device named they raise instead of running on the CPU.
* A kernel wrapper handed CUDA tensors launches its kernel or raises; it
  is never served by the plain CPU version.
* What the port does not cover yet raises NotImplementedError naming
  the ROADMAP item that brings it. A case whose item has landed keeps
  its id and now checks the ported feature against the JAX package.
* Every public name of every JAX module (top-level names, and the public
  methods of public classes, read with ``ast`` without importing the JAX
  package) exists in the port module of the same path, or stands in
  :data:`NAME_DIVERGENCES` with its reason and in ROADMAP.md's
  "Deliberate divergences".
* What a run tells the outside world matches too, module by module: the
  fault seams fired, the flight events logged, the span and instant
  names, the heartbeat names and the ``TFIDF_TPU_*`` variables read (all
  read with ``ast``, private code included), up to
  :data:`VOCAB_DIVERGENCES`; and every seam the port declares is fired.
"""

import ast
import importlib
import os
import re

import numpy as np
import pytest
import torch

import tfidf_tpu_torch as T
from tfidf_tpu_torch import cli
from tfidf_tpu_torch.config import TokenizerKind, VocabMode
from tfidf_tpu_torch.ops import kernels as K

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "tfidf_tpu")


def _port_files():
    root = os.path.join(REPO, "tfidf_tpu_torch")
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(REPO, "chip_smoke.py")


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in FORBIDDEN


def test_port_imports_neither_jax_nor_the_jax_package():
    files = list(_port_files())
    assert len(files) > 15
    # the retrieval slice's modules, including the jax-free copies of the
    # JAX package's checkpoint, query slab and scoring modules, are here
    rel = {os.path.relpath(p, REPO) for p in files}
    for path in ("tfidf_tpu_torch/models/__init__.py",
                 "tfidf_tpu_torch/models/retrieval.py",
                 "tfidf_tpu_torch/scoring/__init__.py",
                 "tfidf_tpu_torch/scoring/family.py",
                 "tfidf_tpu_torch/scoring/filters.py",
                 "tfidf_tpu_torch/checkpoint.py",
                 "tfidf_tpu_torch/ops/queryslab.py",
                 # the streaming and segmented-index slice
                 "tfidf_tpu_torch/streaming.py",
                 "tfidf_tpu_torch/models/vectorizer.py",
                 "tfidf_tpu_torch/index/segment.py",
                 "tfidf_tpu_torch/index/segmented.py",
                 "tfidf_tpu_torch/index/compactor.py",
                 "tfidf_tpu_torch/faults.py",
                 "tfidf_tpu_torch/obs/tracer.py",
                 "tfidf_tpu_torch/obs/log.py",
                 # the serving slice: the server, its host modules and
                 # the observability they report through
                 "tfidf_tpu_torch/serve/__init__.py",
                 "tfidf_tpu_torch/serve/server.py",
                 "tfidf_tpu_torch/serve/batcher.py",
                 "tfidf_tpu_torch/serve/cache.py",
                 "tfidf_tpu_torch/serve/canary.py",
                 "tfidf_tpu_torch/serve/metrics.py",
                 "tfidf_tpu_torch/serve/supervisor.py",
                 "tfidf_tpu_torch/obs/registry.py",
                 "tfidf_tpu_torch/obs/health.py",
                 "tfidf_tpu_torch/obs/slo.py",
                 "tfidf_tpu_torch/obs/reqtrace.py",
                 "tfidf_tpu_torch/obs/disttrace.py",
                 "tfidf_tpu_torch/obs/devmon.py",
                 # the exact-terms slice: jax-free copies of the JAX
                 # package's re-rank and recall modules
                 "tfidf_tpu_torch/rerank.py",
                 "tfidf_tpu_torch/recall.py",
                 # the parallel run paths, with the jax-free copy of the
                 # JAX package's multi-process runtime
                 "tfidf_tpu_torch/parallel/__init__.py",
                 "tfidf_tpu_torch/parallel/mesh.py",
                 "tfidf_tpu_torch/parallel/collectives.py",
                 "tfidf_tpu_torch/parallel/longdoc.py",
                 "tfidf_tpu_torch/parallel/sharded.py",
                 "tfidf_tpu_torch/parallel/multihost.py",
                 # the search side of the parallel paths
                 "tfidf_tpu_torch/parallel/serving.py",
                 # the replicated serving front
                 "tfidf_tpu_torch/serve/front.py"):
        assert path in rel
    offenders = []
    for path in files:
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            elif (isinstance(node, ast.Call)
                  and getattr(node.func, "attr", getattr(node.func, "id", ""))
                  in ("import_module", "__import__") and node.args
                  and isinstance(node.args[0], ast.Constant)):
                names = [str(node.args[0].value)]
            else:
                continue
            offenders += [f"{os.path.relpath(path, REPO)}:{node.lineno} {n}"
                          for n in names if _forbidden(n)]
    assert offenders == []


# (JAX module path, public name) -> why the port has no counterpart.
# "<module>" stands for the whole module.
_XLA_CACHE = "the XLA compile cache and its sizes: the port compiles no XLA"
_SORT_JOIN = "a TPU sort/join form: the port folds DF with the gather join"
_IN_KERNELS = ("a jitted device op: the port's is the kernel wrapper of "
               "ops/kernels.py (ragged_rebuild, pack_words)")
_SHARDING = ("a jax Mesh, PartitionSpec or NamedSharding: the port's placement "
             "is explicit (MeshPlan.row_blocks, collectives.place_batch)")
NAME_DIVERGENCES = {
    ("cli.py", "NATIVE_BIN"): "the native oracle is built into _build "
                              "(ops/_build.load_oracle), not native/",
    ("cli.py", "REPO_ROOT"): "the same: the CLI locates no native/ binary",
    ("config.py", "apply_compile_cache"): _XLA_CACHE,
    ("index/__init__.py", "index_compile_cache_size"): _XLA_CACHE,
    ("ops/sparse.py", "score_topk_tiled_cache_size"): _XLA_CACHE,
    ("parallel/serving.py", "mesh_search_cache_size"): _XLA_CACHE,
    ("ingest.py", "rebuild_padded"): _IN_KERNELS,
    ("ops/downlink.py", "pack_result_words"): _IN_KERNELS,
    ("ops/downlink.py", "pack_words"): _IN_KERNELS,
    ("ops/downlink.py", "PACKED_SLOT_BYTES"): "the wires' bytes are counted "
                                              "from their tensors",
    ("ops/sparse.py", "df_join_sorted"): _SORT_JOIN,
    ("ops/sparse.py", "df_slot_sorted"): _SORT_JOIN,
    ("ops/sparse.py", "join_method"): _SORT_JOIN,
    ("ops/sparse.py", "sparse_scores_joined"): _SORT_JOIN,
    ("ops/pallas_kernels.py", "<module>"): "the Pallas kernels: the port's "
                                           "are csrc/*.cu behind ops/kernels.py",
    ("parallel/compat.py", "<module>"): "a shard_map import shim: the port's "
                                        "mesh is single-controller",
    ("parallel/__init__.py", "shard_map"): "the same shim, re-exported",
    ("parallel/mesh.py", "MeshPlan.batch_spec"): _SHARDING,
    ("parallel/mesh.py", "MeshPlan.counts_spec"): _SHARDING,
    ("parallel/mesh.py", "MeshPlan.df_spec"): _SHARDING,
    ("parallel/mesh.py", "MeshPlan.lengths_spec"): _SHARDING,
    ("parallel/mesh.py", "MeshPlan.sharding"): _SHARDING,
    ("parallel/mesh.py", "MeshPlan.mesh"): _SHARDING,
    ("obs/costmodel.py", "bytes_model"): "the port's program never called "
                                         "it; the benchmark keeps its own "
                                         "frozen counts",
}


def _public_names(path: str):
    """A module's public names by ``ast``: ``__all__`` when it has one,
    else its top-level defs, classes and assignments (imports excluded);
    each public class with its public methods and class attributes."""
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    top, classes, all_ = [], {}, None
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            top.append(node.name)
        elif isinstance(node, ast.ClassDef):
            top.append(node.name)
            members = []
            for b in node.body:
                if isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    members.append(b.name)
                elif isinstance(b, ast.Assign):
                    members += [t.id for t in b.targets
                                if isinstance(t, ast.Name)]
                elif isinstance(b, ast.AnnAssign) \
                        and isinstance(b.target, ast.Name):
                    members.append(b.target.id)
            classes[node.name] = [m for m in members if not m.startswith("_")]
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                for n in ast.walk(t):
                    if isinstance(n, ast.Name):
                        top.append(n.id)
                        if n.id == "__all__":
                            all_ = [e.value for e in node.value.elts]
    names = all_ if all_ is not None else top
    return ([n for n in names if not n.startswith("_")],
            {c: m for c, m in classes.items() if not c.startswith("_")})


def _jax_modules():
    root = os.path.join(REPO, "tfidf_tpu")
    for dirpath, _, files in os.walk(root):
        for f in sorted(files):
            if f.endswith(".py"):
                path = os.path.join(dirpath, f)
                yield os.path.relpath(path, root).replace(os.sep, "/"), path


def _divergences_text() -> str:
    with open(os.path.join(REPO, "ROADMAP.md"), encoding="utf-8") as f:
        text = f.read()
    start = text.index("Deliberate divergences")
    return text[start:]


def test_every_public_name_has_a_counterpart():
    missing, allowed = [], set()
    for rel, path in _jax_modules():
        mod_name = "tfidf_tpu_torch." + rel[:-3].replace("/", ".")
        mod_name = mod_name.removesuffix(".__init__")
        if not os.path.exists(os.path.join(REPO, "tfidf_tpu_torch", rel)):
            key = (rel, "<module>")
            if key in NAME_DIVERGENCES:
                allowed.add(key)
            else:
                missing.append(key)
            continue
        port = importlib.import_module(mod_name)
        names, classes = _public_names(path)
        for name in names:
            checks = [(name, hasattr(port, name))]
            if hasattr(port, name) and name in classes:
                cls = getattr(port, name)
                fields = getattr(cls, "__dataclass_fields__", {})
                checks += [(f"{name}.{m}", hasattr(cls, m) or m in fields)
                           for m in classes[name]]
            for what, present in checks:
                key = (rel, what)
                if key in NAME_DIVERGENCES:
                    # an allowed gap must still be one
                    assert not present, f"{key} is ported: drop it"
                    allowed.add(key)
                elif not present:
                    missing.append(key)
    assert missing == []
    assert allowed == set(NAME_DIVERGENCES), "stale divergence entries"
    text = _divergences_text()
    for rel, name in NAME_DIVERGENCES:
        word = rel if name == "<module>" else name.split(".")[-1]
        assert f"`{word}`" in text, f"{word} not in ROADMAP's divergences"


# --- the vocabulary audit ---------------------------------------------
#
# The name audit above sees public names only; a private worker's seam,
# event or beat escapes it. This one reads call sites. A call's callee
# is matched by its last name, import aliases resolved (``beat as
# _health_beat``), and its name argument by its string literal, either
# branch of a conditional expression included.
_VOCAB_CALLS = {
    "fire": ("seams", 0),                 # faults.fire(seam)
    "log_event": ("events", 1),           # obs_log.log_event(level, event)
    "span": ("spans", 0), "device_span": ("spans", 0),
    "begin": ("spans", 0), "instant": ("spans", 0),
    "phase_or_null": ("spans", 1),        # phase_or_null(timer, name)
    "_phase": ("spans", 0),               # PhaseTimedMixin._phase(name)
    "_device_phase": ("spans", 1),        # the port's _device_phase(devs, n)
    "span_on_live_lanes": ("spans", 0),   # Tracer.span_on_live_lanes(n, t0)
    "steps": ("spans", 0),                # obs.steps((n, ...), stamps)
    "beat": ("beats", 0), "heartbeat": ("beats", 0),
}
VOCABULARIES = ("seams", "events", "spans", "beats", "envs")
_ENV_NAME = re.compile(r"TFIDF_TPU_[A-Z0-9_]+")

# (vocabulary, module path, name) -> why the port lacks it.
VOCAB_DIVERGENCES = {
    ("envs", "config.py", "TFIDF_TPU_COMPILE_CACHE"): _XLA_CACHE,
    ("envs", "ops/sparse.py", "TFIDF_TPU_DF_METHOD"): _SORT_JOIN,
    ("envs", "ops/sparse.py", "TFIDF_TPU_JOIN"): _SORT_JOIN,
    ("envs", "ops/pallas_kernels.py", "TFIDF_TPU_PALLAS_MAX_VOCAB"):
        "a warning inside the Pallas kernels' module, which has no port",
}


# (vocabulary, module path, name) -> why the port has it and the JAX
# package has not: the steps of the port's host loops that a device
# capture labels its idle time with.
_IDLE = "labels the device's idle time while this host step runs"
PORT_ONLY_VOCAB = {
    ("spans", "serve/batcher.py", "take"): "the batcher's wait for a due "
                                           "batch; " + _IDLE,
    ("spans", "serve/batcher.py", "form"): "screening and forming a batch; "
                                           + _IDLE,
    ("spans", "serve/batcher.py", "window_wait"): "the dispatch stage's wait "
                                                  "on a full window; " + _IDLE,
    ("spans", "serve/batcher.py", "issue"): "the synchronous issue of a "
                                            "batch's search, a device span",
    ("spans", "serve/batcher.py", "d2h_wait"): "the drain's wait for a "
                                               "batch's result",
    ("spans", "serve/batcher.py", "deliver"): "the drain's resolution of a "
                                              "batch's futures",
    ("spans", "models/retrieval.py", "fill_query"): "the host fill of the "
                                                    "query block; " + _IDLE,
    ("spans", "ops/sparse.py", "tile_scores"): "a tile's B6; " + _IDLE,
    ("spans", "ops/sparse.py", "tile_topk"): "a tile's mask and top-k; "
                                             + _IDLE,
    ("spans", "ops/sparse.py", "tile_merge"): "a tile's merge into the "
                                              "carry; " + _IDLE,
    ("spans", "obs/tracer.py", "gc_full"): "a full collection, on every "
                                           "lane: every thread stalls",
    ("spans", "io/fast_tokenizer.py", "pack_read"): "the native loader's "
                                                    "parallel file read",
    ("spans", "io/fast_tokenizer.py", "pack_tokenize"): "the native "
                                                        "loader's fill",
    ("spans", "ingest.py", "pass_setup"): "the pass's set-up on the main "
                                          "thread; " + _IDLE,
    ("spans", "ingest.py", "gather"): "the pass's tail on the main "
                                      "thread; " + _IDLE,
}


def _literals(node) -> list:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return [node.value]
    if isinstance(node, ast.IfExp):
        return _literals(node.body) + _literals(node.orelse)
    if isinstance(node, ast.Tuple):
        return [name for e in node.elts for name in _literals(e)]
    return []


def _vocabularies(source: str) -> dict:
    """vocabulary -> the names one module's source uses."""
    tree = ast.parse(source)
    alias = {a.asname: a.name for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom) for a in n.names if a.asname}
    out = {v: set() for v in VOCABULARIES}
    for n in ast.walk(tree):
        if isinstance(n, ast.Call):
            f = n.func
            name = f.attr if isinstance(f, ast.Attribute) else \
                f.id if isinstance(f, ast.Name) else ""
            vocab, pos = _VOCAB_CALLS.get(alias.get(name, name), (None, 0))
            if vocab is not None and len(n.args) > pos:
                out[vocab].update(_literals(n.args[pos]))
        elif isinstance(n, ast.Constant) and isinstance(n.value, str) \
                and _ENV_NAME.fullmatch(n.value):
            out["envs"].add(n.value)  # an environ key, getenv or table arg
    return out


def _package_vocab(package: str) -> dict:
    """vocabulary -> {(module path, name)} over a package tree."""
    root = os.path.join(REPO, package)
    out = {v: set() for v in VOCABULARIES}
    for dirpath, _, files in os.walk(root):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            rel = os.path.relpath(path, root).replace(os.sep, "/")
            with open(path, encoding="utf-8") as fh:
                for vocab, names in _vocabularies(fh.read()).items():
                    out[vocab].update((rel, n) for n in names)
    return out


@pytest.fixture(scope="module")
def vocab_pair():
    return _package_vocab("tfidf_tpu"), _package_vocab("tfidf_tpu_torch")


@pytest.mark.parametrize("vocab", VOCABULARIES)
def test_vocabulary_matches_the_jax_package(vocab_pair, vocab):
    jax_v, port_v = (v[vocab] for v in vocab_pair)
    allowed = {(rel, name) for (v, rel, name) in VOCAB_DIVERGENCES
               if v == vocab}
    own = {(rel, name) for (v, rel, name) in PORT_ONLY_VOCAB if v == vocab}
    assert not allowed & port_v, "an allowed gap is closed: drop it"
    assert allowed <= jax_v, "stale divergence entries"
    assert sorted(jax_v - port_v - allowed) == [], "missing in the port"
    assert sorted(own - port_v) == [], "stale port-only entries"
    assert sorted(own & jax_v) == [], "listed as the port's own, in JAX too"
    assert sorted(port_v - jax_v - own) == [], "the port's own: not in JAX"


def _literals_in(node) -> list:
    return [n.value for n in ast.walk(node)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)]


def test_every_declared_seam_fires(vocab_pair):
    path = os.path.join(REPO, "tfidf_tpu_torch", "faults.py")
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    declared = next(set(_literals_in(n.value)) for n in ast.walk(tree)
                    if isinstance(n, ast.Assign)
                    and any(getattr(t, "id", None) == "SEAMS"
                            for t in n.targets))
    fired = {name for rel, name in vocab_pair[1]["seams"]
             if rel != "faults.py"}
    assert len(declared) == 6
    assert sorted(declared - fired) == [], "declared but never fired"


@pytest.mark.parametrize("src,vocab,name", [
    ("faults.fire('pack_worker' if w else 'drain', chunk=i)", "seams",
     "drain"),
    ("from x.health import beat as _hb\n_hb('packer')", "beats", "packer"),
    ("obs_log.log_event('warning', 'worker_restart', worker=w)", "events",
     "worker_restart"),
    ("with _device_phase(devs, 'phase_b'):\n    pass", "spans", "phase_b"),
    ("self.span_on_live_lanes('gc_full', t0, collected=n)", "spans",
     "gc_full"),
    ("obs.steps(('tile_scores', 'tile_topk'), (t0, t1, t2))", "spans",
     "tile_topk"),
    ("os.environ.get('TFIDF_TPU_RESTART_BUDGET', '3')", "envs",
     "TFIDF_TPU_RESTART_BUDGET"),
])
def test_vocabulary_reader_sees_each_form(src, vocab, name):
    assert name in _vocabularies(src)[vocab]


def test_vocabulary_divergences_are_in_the_roadmap():
    text = _divergences_text()
    for _, _, name in (*VOCAB_DIVERGENCES, *PORT_ONLY_VOCAB):
        assert f"`{name}`" in text, f"{name} not in ROADMAP's divergences"


@pytest.mark.parametrize("module,bad", [
    ("tfidf_tpu_torch.ops", False), ("tfidf_tpu", True),
    ("tfidf_tpu.ops.sparse", True), ("jax.numpy", True), ("jaxlib", True),
    ("numpy", False)])
def test_forbidden_prefix_rule(module, bad):
    assert _forbidden(module) is bad


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_pipeline_without_gpu_raises(no_gpu):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.TfidfPipeline(T.PipelineConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.TfidfPipeline(T.PipelineConfig(), device="cuda")
    assert T.TfidfPipeline(T.PipelineConfig(), device="cpu").device.type == "cpu"


def test_cli_without_gpu_raises(no_gpu, toy_corpus_dir, tmp_path):
    out = tmp_path / "o.txt"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["run", "--input", toy_corpus_dir, "--output", str(out)])
    assert not out.exists()


class _CudaLooking(torch.Tensor):
    """A CPU tensor that reports a CUDA device: stands in for a CUDA
    tensor on a machine without one."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _cuda_looking(a):
    return torch.from_numpy(np.array(a)).as_subclass(_CudaLooking)


def test_wrappers_never_serve_cuda_tensors_from_the_plain_path(no_gpu,
                                                               monkeypatch):
    def plain_must_not_run(*a, **k):
        raise AssertionError("plain path ran for CUDA tensors")

    for name in ("fused_score_topk_plain", "tf_df_plain", "pack_words_plain",
                 "ragged_rebuild_plain", "tokenize_hash_plain",
                 "tile_scores_plain"):
        monkeypatch.setattr(K, name, plain_must_not_run)
    K.reset_launches()
    ids = _cuda_looking(np.zeros((2, 4), np.int32))
    head = _cuda_looking(np.ones((2, 4), bool))
    lens = _cuda_looking(np.full(2, 4, np.int32))
    vals = _cuda_looking(np.ones((2, 4), np.float32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        K.fused_score_topk(ids, ids, head, lens, vals[0], k=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        K.tf_df(ids, lens, vocab_size=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        K.pack_words(vals, ids)
    for dtype in (np.uint16, np.int32):
        for align in (1, 2, 8, 16):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                K.ragged_rebuild(_cuda_looking(np.zeros(16, dtype)), lens,
                                 length=4, align=align)
    for dtype in (np.uint8, np.int32):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            K.tokenize_hash(_cuda_looking(np.full(8, 32, dtype)), ids, lens,
                            vocab_size=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        K.tile_scores(vals, ids, _cuda_looking(np.ones((4, 3), np.float32)))
    assert all(n == 0 for n in K.LAUNCHES.values())


@pytest.mark.parametrize("case,err", [
    ("data_dtype", TypeError), ("cols_dtype", TypeError),
    ("qmat_dtype", TypeError), ("data_ndim", ValueError),
    ("cols_shape", ValueError), ("noncontiguous", ValueError),
    ("out_shape", ValueError), ("out_dtype", TypeError)])
def test_tile_scores_rejects_bad_cuda_inputs(monkeypatch, case, err):
    # checks made before any launch (a card is reported; nothing may
    # reach the kernel library, which would need nvcc)
    from tfidf_tpu_torch.ops import _build
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(_build, "load", lambda: pytest.fail("launched"))
    data = np.ones((4, 6), np.float32)
    cols = np.zeros((4, 6), np.int32)
    qmat = np.ones((8, 3), np.float32)
    out = None
    if case == "data_dtype":
        data = data.astype(np.float16)
    elif case == "cols_dtype":
        cols = cols.astype(np.int64)
    elif case == "qmat_dtype":
        qmat = qmat.astype(np.float64)
    elif case == "data_ndim":
        data, cols = data.reshape(-1), cols.reshape(-1)
    elif case == "cols_shape":
        cols = cols[:, :5]
    elif case == "out_shape":
        out = _cuda_looking(np.zeros((4, 2), np.float32))
    elif case == "out_dtype":
        out = _cuda_looking(np.zeros((4, 3), np.float64))
    args = [_cuda_looking(data), _cuda_looking(cols), _cuda_looking(qmat)]
    if case == "noncontiguous":
        args[0] = _cuda_looking(np.ones((6, 4), np.float32)).t()
    with pytest.raises(err):
        K.tile_scores(*args, out=out)


def test_wrappers_reject_mixed_and_other_devices():
    cpu = torch.zeros((2, 4), dtype=torch.int32)
    meta = torch.zeros((2, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="expected all on the CPU"):
        K.tf_df(meta, torch.zeros(2, dtype=torch.int32, device="meta"),
                vocab_size=4)
    with pytest.raises(ValueError, match="expected all on the CPU"):
        K.pack_words(cpu.float(), _cuda_looking(np.zeros((2, 4), np.int32)))


def test_build_happens_at_first_gpu_use_not_at_import():
    from tfidf_tpu_torch.ops import _build
    assert _build.load.cache_info().currsize == 0
    assert set(_build.SIGNATURES) == {"tfidf_fused_score_topk", "tfidf_tf_df",
                                      "tfidf_pack_words",
                                      "tfidf_ragged_rebuild",
                                      "tfidf_tokenize_hash",
                                      "tfidf_tile_scores"}
    assert {p.name for p in _build.sources()} == {
        "score_topk.cu", "tf_df.cu", "pack_words.cu", "ragged_rebuild.cu",
        "tokenize_hash.cu", "tile_scores.cu"}
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    assert _build.library_path().parent == _build.BUILD_DIR
    # the host loader library builds beside it, never into native/
    assert _build.host_library_path().parent == _build.BUILD_DIR
    assert all(p.exists() for p in _build.host_sources())


def test_retriever_without_gpu_raises(no_gpu, toy_corpus_dir, tmp_path):
    cfg = T.PipelineConfig(vocab_mode=VocabMode.HASHED)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.TfidfRetriever(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.TfidfRetriever(cfg, device="cuda")
    r = T.TfidfRetriever(cfg, device="cpu").index_dir(toy_corpus_dir)
    r.snapshot(str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.TfidfRetriever.restore(str(tmp_path))
    assert T.TfidfRetriever.restore(str(tmp_path), device="cpu")[0].indexed


def test_cli_query_without_gpu_raises(no_gpu, toy_corpus_dir, capsys):
    args = ["query", "--input", toy_corpus_dir, "--query", "a b"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(args)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(args + ["--doc-len", "16"])
    assert capsys.readouterr().out == ""
    assert cli.main(args + ["--device", "cpu"]) == 0


def test_run_overlapped_without_gpu_raises(no_gpu, toy_corpus_dir):
    from tfidf_tpu_torch.ingest import run_overlapped
    cfg = T.PipelineConfig(vocab_mode=VocabMode.HASHED, topk=3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_overlapped(toy_corpus_dir, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_overlapped(toy_corpus_dir, cfg, device="cuda")
    assert run_overlapped(toy_corpus_dir, cfg, device="cpu").num_docs > 0


def test_cli_doc_len_without_gpu_raises(no_gpu, toy_corpus_dir, tmp_path):
    out = tmp_path / "o.txt"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["run", "--input", toy_corpus_dir, "--output", str(out),
                  "--doc-len", "16", "--vocab-mode", "hashed", "--topk", "3",
                  "--wire", "bytes"])
    assert not out.exists()


def test_serve_without_gpu_raises(no_gpu, toy_corpus_dir, monkeypatch,
                                  capsys):
    import io
    monkeypatch.setattr("sys.stdin", io.StringIO('{"op": "shutdown"}\n'))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["serve", "--input", toy_corpus_dir])
    assert capsys.readouterr().out == ""
    monkeypatch.setattr("sys.stdin", io.StringIO('{"op": "shutdown"}\n'))
    assert cli.main(["serve", "--input", toy_corpus_dir, "--device", "cpu",
                     "--no-warm", "--canary-period-ms", "0"]) == 0


def test_streaming_and_index_without_gpu_raise(no_gpu, toy_corpus_dir,
                                               tmp_path, capsys):
    from tfidf_tpu_torch.index import SegmentedIndex
    from tfidf_tpu_torch.models import TfidfVectorizer
    from tfidf_tpu_torch.streaming import StreamingTfidf
    cfg = T.PipelineConfig(vocab_mode=VocabMode.HASHED, topk=3)
    for make in (StreamingTfidf, TfidfVectorizer, SegmentedIndex):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make(cfg)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make(cfg, device="cuda")
        assert make(cfg, device="cpu") is not None
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SegmentedIndex.from_dir(toy_corpus_dir, cfg)
    out = tmp_path / "o.txt"
    args = ["stream", "--input", toy_corpus_dir, "--output", str(out)]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(args)
    assert not out.exists() and capsys.readouterr().out == ""
    assert cli.main(args + ["--device", "cpu"]) == 0 and out.exists()


def test_exact_and_chargram_without_gpu_raise(no_gpu, toy_corpus_dir,
                                              tmp_path, capsys):
    from tfidf_tpu_torch import ingest, rerank
    cfg = T.PipelineConfig(vocab_mode=VocabMode.HASHED, topk=3)
    calls = [
        lambda **kw: ingest.run_overlapped_exact(toy_corpus_dir, cfg, **kw),
        lambda **kw: ingest.profile_resident(toy_corpus_dir, cfg,
                                             doc_len=16, **kw),
        lambda **kw: rerank.exact_terms_lines(toy_corpus_dir, cfg, 2,
                                              doc_len=16, **kw),
        lambda **kw: rerank.exact_terms(toy_corpus_dir, cfg, 2, doc_len=16,
                                        **kw),
        lambda **kw: ingest.run_overlapped(toy_corpus_dir, cfg,
                                           wire_vals=False, **kw)]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call(device="cuda")
        call(device="cpu")
    chargram = T.PipelineConfig(vocab_mode=VocabMode.HASHED, topk=3,
                                tokenizer=TokenizerKind.CHARGRAM)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.TfidfPipeline(chargram)
    for i, extra in enumerate((["--doc-len", "16", "--exact-terms"],
                               ["--exact-terms"], ["--tokenizer", "chargram"])):
        out = tmp_path / f"o{i}.txt"
        args = ["run", "--input", toy_corpus_dir, "--output", str(out),
                "--vocab-mode", "hashed", "--topk", "3", *extra]
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(args)
        assert not out.exists() and capsys.readouterr().out == ""
        assert cli.main(args + ["--device", "cpu"]) == 0 and out.exists()
        assert "wrote" in capsys.readouterr().out


class TestNotPortedYet:
    def test_mesh(self, toy_corpus_dir):
        # Ported now (ROADMAP A9a): a mesh_shape pipeline runs on two
        # virtual CPU shards and equals the JAX package's 2-device
        # ShardedPipeline (counts, DF, output bytes), whose scores it
        # holds within 4 float32 ulp (tests/test_torch_parallel.py has
        # every mesh and engine).
        import jax

        from tfidf_tpu.config import PipelineConfig as JConfig
        from tfidf_tpu.io.corpus import discover_corpus
        from tfidf_tpu.parallel import MeshPlan, ShardedPipeline
        got = T.TfidfPipeline(T.PipelineConfig(mesh_shape={"docs": 2}),
                              device="cpu").run(
            T.discover_corpus(toy_corpus_dir))
        want = ShardedPipeline(MeshPlan.create(docs=2,
                                               devices=jax.devices()[:2]),
                               JConfig()).run(discover_corpus(toy_corpus_dir))
        np.testing.assert_array_equal(got.counts, np.asarray(want.counts))
        np.testing.assert_array_equal(got.df, np.asarray(want.df))
        np.testing.assert_allclose(got.scores, np.asarray(want.scores),
                                   rtol=4 * 2 ** -23, atol=0)
        assert got.output_bytes() == want.output_bytes()

    def test_device_chargram(self, toy_corpus_dir):
        # Ported now: a CHARGRAM hashed top-k config runs the device
        # chargram, the same df, docSize and picks as the JAX package's
        # (both engines held in tests/test_torch_chargram.py).
        from tfidf_tpu.config import PipelineConfig as JConfig
        from tfidf_tpu.config import TokenizerKind as JTok
        from tfidf_tpu.config import VocabMode as JV
        from tfidf_tpu.io.corpus import discover_corpus
        from tfidf_tpu.pipeline import TfidfPipeline as JPipeline
        cfg = T.PipelineConfig(vocab_mode=VocabMode.HASHED, topk=3,
                               tokenizer=TokenizerKind.CHARGRAM,
                               result_wire="pair")
        got = T.TfidfPipeline(cfg, device="cpu").run(
            T.discover_corpus(toy_corpus_dir))
        want = JPipeline(JConfig(vocab_mode=JV.HASHED, topk=3,
                                 tokenizer=JTok.CHARGRAM)).run(
            discover_corpus(toy_corpus_dir))
        for field in ("df", "lengths", "topk_ids", "topk_vals"):
            np.testing.assert_array_equal(getattr(got, field),
                                          np.asarray(getattr(want, field)))

    def test_ragged_batch(self):
        # Ported now: the port's RaggedBatch runs (equal to its padded
        # batch, tests/test_torch_pipeline.py); anything else that only
        # looks like one is refused by type.
        class RaggedBatch:  # the JAX package's ragged wire, by shape
            flat = np.zeros(16, np.uint16)

        with pytest.raises(TypeError, match="RaggedBatch"):
            T.TfidfPipeline(T.PipelineConfig.golden(),
                            device="cpu").run_packed(RaggedBatch())

    def test_stream_mesh(self, toy_corpus_dir, tmp_path):
        # Ported now (ROADMAP A9b): a plan runs the docs-sharded stream
        # and fit (equal to one device's), and cli stream --mesh-docs
        # writes the JAX CLI's bytes.
        from tfidf_tpu.cli import main as jax_main
        from tfidf_tpu_torch.models import TfidfVectorizer
        from tfidf_tpu_torch.parallel import MeshPlan
        from tfidf_tpu_torch.streaming import StreamingTfidf
        cfg = T.PipelineConfig(vocab_mode=VocabMode.HASHED, topk=3)
        corpus = T.discover_corpus(toy_corpus_dir)
        plan = MeshPlan.create(docs=2, device="cpu")
        assert StreamingTfidf(cfg, plan=plan).plan is plan
        got = TfidfVectorizer(cfg, plan=plan).fit_transform(corpus)
        want = TfidfVectorizer(cfg, device="cpu").fit_transform(corpus)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        args = ["stream", "--input", toy_corpus_dir, "--batch-docs", "4",
                "--topk", "3", "--mesh-docs", "2"]
        ours, theirs = str(tmp_path / "o.txt"), str(tmp_path / "j.txt")
        assert cli.main(args + ["--output", ours, "--device", "cpu"]) == 0
        assert jax_main(args + ["--output", theirs]) == 0
        assert open(ours, "rb").read() == open(theirs, "rb").read()

    def test_search_mesh(self, toy_corpus_dir, capsys):
        # Ported now (ROADMAP A9b): TfidfRetriever(plan=) and cli query
        # --mesh-docs answer as the JAX package does.
        from tfidf_tpu.cli import main as jax_main
        from tfidf_tpu_torch.parallel import MeshPlan
        cfg = T.PipelineConfig(vocab_mode=VocabMode.HASHED)
        r = T.TfidfRetriever(cfg, plan=MeshPlan.create(docs=2, device="cpu"))
        r.index_dir(toy_corpus_dir)
        single = T.TfidfRetriever(cfg, device="cpu").index_dir(
            toy_corpus_dir)
        for a, b in zip(r.search(["tpu mesh", "kernel"], k=3),
                        single.search(["tpu mesh", "kernel"], k=3)):
            np.testing.assert_array_equal(a, b)
        args = ["query", "--input", toy_corpus_dir, "--query", "tpu mesh",
                "--query", "kernel psum", "-k", "3", "--mesh-docs", "2"]
        assert cli.main(args + ["--device", "cpu"]) == 0
        ours = capsys.readouterr().out
        assert jax_main(args) == 0
        assert ours == capsys.readouterr().out and "query: kernel" in ours

    @pytest.mark.parametrize("member", ["MetricsRegistry", "HealthMonitor",
                                        "DeviceMonitor", "SloTracker"])
    def test_serving_obs(self, member):
        # Ported now (ROADMAP A8): the lazy members are the port's own
        # classes, defined in the port's modules.
        from tfidf_tpu_torch import obs
        cls = getattr(obs, member)
        assert cls.__module__.startswith("tfidf_tpu_torch.obs.")

    @pytest.mark.parametrize("member", ["ReplicatedFront", "FrontError",
                                        "SwapAborted"])
    def test_serving_front(self, member):
        # Ported now (ROADMAP A8b): the port's own classes, with the JAX
        # package's names, bases and public surface.
        from tfidf_tpu import serve as jserve
        from tfidf_tpu_torch import serve
        cls, jcls = getattr(serve, member), getattr(jserve, member)
        assert cls.__module__ == "tfidf_tpu_torch.serve.front"
        assert ([b.__name__ for b in cls.__mro__]
                == [b.__name__ for b in jcls.__mro__])

        def public(c):
            return {n for n in vars(c) if not n.startswith("_")}
        assert public(cls) == public(jcls)

    @pytest.mark.parametrize("flags,item", [
        (["--replicas", "2", "--snapshot-dir", "snap"], "ROADMAP A8b"),
        (["--replica-timeout-s", "5"], "ROADMAP A8b"),
        pytest.param(["--mesh-shards", "2"], "ROADMAP A9b",
                     id="flags2-ROADMAP A9")])
    def test_serve_cli_options(self, toy_corpus_dir, flags, item,
                               monkeypatch, capsys):
        argv = ["serve", "--input", toy_corpus_dir, "--device", "cpu",
                *flags]
        import io
        import json
        lines = [json.dumps({"id": 1, "queries": ["tpu mesh", "kernel"],
                             "k": 3}), json.dumps({"op": "shutdown"})]
        if item == "ROADMAP A8b":
            # Ported now (ROADMAP A8b): --replicas runs the replicated
            # tier and --replica-timeout-s alone changes nothing, as in
            # the JAX CLI; the answers are the unreplicated server's and
            # the JAX CLI's (names exact, scores within 1e-6). The JAX
            # side runs without --replicas: its tier would spawn JAX
            # replicas.
            from tfidf_tpu.cli import main as jax_main
            monkeypatch.chdir(os.path.dirname(toy_corpus_dir))
            monkeypatch.setenv("TFIDF_TPU_LOG_ECHO", "off")
            runs = []
            for main, args in ((cli.main, argv[:5]), (cli.main, argv),
                               (jax_main, argv[:3] + (
                                   [] if "--replicas" in flags else flags))):
                monkeypatch.setattr("sys.stdin",
                                    io.StringIO("\n".join(lines) + "\n"))
                assert main(args) == 0
                out = capsys.readouterr()
                runs.append([json.loads(x)["results"]
                             for x in out.out.splitlines() if x])
                if main is cli.main and args is argv:
                    assert ("front serving 2 replica(s)" in out.err) == (
                        "--replicas" in flags)
            plain, ours, theirs = runs
            assert ours == plain and plain[0][0]
            for a, b in zip(plain[0], theirs[0]):
                assert [n for n, _ in a] == [n for n, _ in b]
                np.testing.assert_allclose([s for _, s in a],
                                           [s for _, s in b], atol=1e-6)
            return
        # Ported now (ROADMAP A9b): serve --mesh-shards serves the index
        # doc-sharded, with the unsharded server's answers.
        answers = []
        for extra in ([], flags):
            monkeypatch.setattr("sys.stdin",
                                io.StringIO("\n".join(lines) + "\n"))
            assert cli.main(argv[:5] + extra) == 0
            out = capsys.readouterr()
            answers.append([json.loads(x)["results"]
                            for x in out.out.splitlines() if x])
        assert "mesh=2" in out.err
        assert answers[0] == answers[1] and answers[0][0][0]

    @pytest.mark.parametrize("kw,item", [
        ({"replicas": 2, "snapshot_dir": "snap"}, "ROADMAP A8b"),
        pytest.param({"mesh_shards": 2}, "ROADMAP A9b",
                     id="kw1-ROADMAP A9")])
    def test_server_options(self, toy_corpus_dir, kw, item):
        from tfidf_tpu_torch.config import ServeConfig
        from tfidf_tpu_torch.parallel import MeshShardedRetriever
        from tfidf_tpu_torch.serve import TfidfServer
        r = T.TfidfRetriever(T.PipelineConfig(vocab_mode=VocabMode.HASHED),
                             device="cpu").index_dir(toy_corpus_dir)
        if item == "ROADMAP A8b":
            # Ported now (ROADMAP A8b): the server accepts replicas and
            # ignores it, as the JAX server does; the same answers.
            from tfidf_tpu.config import PipelineConfig as JConfig
            from tfidf_tpu.config import ServeConfig as JServeConfig
            from tfidf_tpu.config import VocabMode as JVocab
            from tfidf_tpu.models import TfidfRetriever as JRetriever
            from tfidf_tpu.serve import TfidfServer as JServer
            j = JRetriever(JConfig(vocab_mode=JVocab.HASHED)).index_dir(
                toy_corpus_dir)
            with TfidfServer(r, ServeConfig(**kw)) as srv, \
                    JServer(j, JServeConfig(**kw)) as jsrv:
                got = srv.search(["tpu mesh", "kernel"], k=3, timeout=30)
                for a, b in zip(got, r.search(["tpu mesh", "kernel"], k=3)):
                    np.testing.assert_array_equal(a, b)
                want = jsrv.search(["tpu mesh", "kernel"], k=3, timeout=30)
                np.testing.assert_array_equal(got[1], np.asarray(want[1]))
                np.testing.assert_allclose(got[0], np.asarray(want[0]),
                                           atol=1e-6)
            return
        # Ported now (ROADMAP A9b): the server shards the index
        with TfidfServer(r, ServeConfig(**kw)) as srv:
            _, installed = srv.current_index()
            assert isinstance(installed, MeshShardedRetriever)
            assert installed.n_shards == kw["mesh_shards"]
            for a, b in zip(srv.search(["tpu mesh"], k=3, timeout=30),
                            r.search(["tpu mesh"], k=3)):
                np.testing.assert_array_equal(a, b)

    # Every option is ported now: each runs and equals the JAX
    # package's ingest with the same option (the mesh plan: 2 shards on
    # both sides), ids and DF exact, scores within 1 ulp of the wire.
    @pytest.mark.parametrize("kw", [
        pytest.param({"plan": 2}, id="kw0-ROADMAP A9"),
        pytest.param({"shard": (0, 1)}, id="kw1-ROADMAP A9"),
        pytest.param({"df_merge": lambda df: df}, id="kw2-ROADMAP A9"),
        pytest.param({"total_docs": 4}, id="kw3-ROADMAP A9"),
        pytest.param({"wire_vals": False}, id="kw4-ROADMAP A5"),
    ])
    def test_run_overlapped_options(self, toy_corpus_dir, kw):
        import jax

        from tfidf_tpu.config import PipelineConfig as JConfig
        from tfidf_tpu.config import VocabMode as JV
        from tfidf_tpu.ingest import run_overlapped as jax_run
        from tfidf_tpu.parallel import MeshPlan as JMesh
        from tfidf_tpu_torch.ingest import run_overlapped
        from tfidf_tpu_torch.parallel import MeshPlan
        cfg = T.PipelineConfig(vocab_mode=VocabMode.HASHED, topk=3)
        port_kw, jax_kw = dict(kw), dict(kw)
        if "plan" in kw:
            port_kw["plan"] = MeshPlan.create(docs=2, device="cpu")
            jax_kw["plan"] = JMesh.create(docs=2, devices=jax.devices()[:2])
        got = run_overlapped(toy_corpus_dir, cfg, doc_len=16, device="cpu",
                             **port_kw)
        want = jax_run(toy_corpus_dir, JConfig(vocab_mode=JV.HASHED, topk=3),
                       doc_len=16, **jax_kw)
        np.testing.assert_array_equal(got.topk_ids, want.topk_ids)
        np.testing.assert_array_equal(got.df, np.asarray(want.df))
        np.testing.assert_array_equal(got.lengths, want.lengths)
        assert got.path == want.path
        if "wire_vals" in kw:
            assert got.topk_vals is None and want.topk_vals is None
        else:  # the packed wire: float16 scores
            np.testing.assert_allclose(got.topk_vals, want.topk_vals,
                                       rtol=2 ** -10, atol=0)
