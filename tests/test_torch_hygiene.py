"""Boundaries of the PyTorch/CUDA port.

* No module of ``tfidf_tpu_torch`` (nor ``chip_smoke.py``) imports JAX or
  the JAX package. The check is static (``ast``): a test process may
  already hold jax in ``sys.modules`` from interpreter start-up, so a
  runtime check would prove nothing.
* Entry points run on CUDA unless told otherwise: with no GPU and no
  device named they raise instead of running on the CPU.
* A kernel wrapper handed CUDA tensors launches its kernel or raises; it
  is never served by the plain CPU version.
* What the slice does not cover raises NotImplementedError naming the
  ROADMAP item that brings it.
"""

import ast
import os

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

    for name in ("fused_score_topk_plain", "tf_df_plain", "pack_words_plain"):
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
    assert all(n == 0 for n in K.LAUNCHES.values())


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
                                      "tfidf_pack_words"}
    assert {p.name for p in _build.sources()} == {
        "score_topk.cu", "tf_df.cu", "pack_words.cu"}
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    assert _build.library_path().parent == _build.BUILD_DIR


class TestNotPortedYet:
    def test_mesh(self, toy_corpus_dir):
        pipe = T.TfidfPipeline(T.PipelineConfig(mesh_shape={"docs": 2}),
                               device="cpu")
        with pytest.raises(NotImplementedError, match="ROADMAP A9"):
            pipe.run(T.discover_corpus(toy_corpus_dir))

    def test_device_chargram(self, toy_corpus_dir):
        cfg = T.PipelineConfig(vocab_mode=VocabMode.HASHED, topk=3,
                               tokenizer=TokenizerKind.CHARGRAM)
        with pytest.raises(NotImplementedError, match="ROADMAP A5"):
            T.TfidfPipeline(cfg, device="cpu").run(
                T.discover_corpus(toy_corpus_dir))

    def test_ragged_batch(self):
        class RaggedBatch:  # the JAX package's ragged wire, by shape
            flat = np.zeros(16, np.uint16)

        with pytest.raises(NotImplementedError, match="ROADMAP A5"):
            T.TfidfPipeline(T.PipelineConfig.golden(),
                            device="cpu").run_packed(RaggedBatch())
