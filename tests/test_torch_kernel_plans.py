"""What the CPU can check of the redesigned B6 and B1 kernels.

* B6's launch plan (``ops.kernels.tile_scores_plan``): every (row,
  column) cell of the output is owned by exactly one (block, warp, lane
  group) and one (pass, vector, lane, element), with the indexing of
  csrc/tile_scores.cu, and the plan stays within the kernel's limits.
* B1's selection order (``ops.kernels.topk_order_key``) sorts like
  ``torch.sort(descending=True, stable=True)`` on adversarial rows, and a
  selection built from it the way csrc/score_topk.cu builds it (heads
  only, composite of key and slot, picks past the head count or not above
  ``finfo.min`` decoded to (0, -1)) equals the JAX package's
  ``fused_score_topk_pallas`` in interpret mode: ids exactly, values bit
  for bit.

The kernels themselves run only on the card, where ``chip_smoke.py``
holds them against their plain versions bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfidf_tpu.ops.pallas_kernels import fused_score_topk_pallas
from tfidf_tpu.ops.sparse import sorted_term_counts as jax_sorted_term_counts
from tfidf_tpu_torch.ops import kernels as K
from tfidf_tpu_torch.ops.sparse import sparse_scores

# (v, nv) pairs csrc/tile_scores.cu instantiates.
_B6_INSTANCES = {(4, 1), (4, 2), (2, 1), (2, 2), (2, 4),
                 (1, 1), (1, 2), (1, 4), (1, 8)}


def _rows_covered(p, rows):
    """Row of every (block, warp, group): each row < rows exactly once."""
    b, w, g = np.meshgrid(np.arange(p["blocks"]), np.arange(p["warps"]),
                          np.arange(p["rows_per_warp"]), indexing="ij")
    r = ((b * p["warps"] + w) * p["rows_per_warp"] + g).ravel()
    return np.bincount(r[r < rows], minlength=rows)


def _cols_covered(p, q):
    """Column of every (pass, vector, lane of the group, element)."""
    ps, i, sub, e = np.meshgrid(np.arange(p["passes"]), np.arange(p["nv"]),
                                np.arange(p["g"]), np.arange(p["v"]),
                                indexing="ij")
    c = (((ps * p["nv"] + i) * p["g"] + sub) * p["v"] + e).ravel()
    return np.bincount(c[c < q], minlength=q)


class TestTileScoresPlan:

    @pytest.mark.parametrize("rows", [1, 7, 3001, 4096])
    @pytest.mark.parametrize("length", [6, 256])
    def test_every_cell_once_within_limits(self, rows, length):
        for q in range(1, 601):
            p = K.tile_scores_plan(rows, length, q)
            assert (_rows_covered(p, rows) == 1).all(), (q, p)
            assert (_cols_covered(p, q) == 1).all(), (q, p)
            assert (p["v"], p["nv"]) in _B6_INSTANCES, (q, p)
            assert q % p["v"] == 0 and p["g"] * p["rows_per_warp"] == 32
            # the last pass owns at least one column: no empty pass
            assert (p["passes"] - 1) * p["nv"] * p["g"] * p["v"] < q
            assert p["cap"] % (p["g"] * p["sv"]) == 0
            assert p["smem_bytes"] == p["warps"] * 32 // p["g"] * p["cap"] * 8
            assert p["smem_bytes"] <= 48 * 1024
            assert p["sv"] == (4 if length % 4 == 0 else 1)

    @pytest.mark.parametrize("q,v", [(64, 4), (256, 4), (100, 4), (6, 2),
                                     (33, 1), (257, 1), (512, 4)])
    def test_vector_width_follows_q(self, q, v):
        assert K.tile_scores_plan(4096, 256, q)["v"] == v

    def test_main_shapes(self):
        # Q 64: 16 lanes a row (a float4 each), two rows a warp; Q 256: a
        # warp a row, two float4 a lane; Q 512: two passes of one list
        p64 = K.tile_scores_plan(4096, 256, 64)
        assert (p64["g"], p64["v"], p64["nv"], p64["passes"]) == (16, 4, 1, 1)
        p256 = K.tile_scores_plan(4096, 256, 256)
        assert (p256["g"], p256["v"], p256["nv"], p256["passes"]) == (32, 4, 2, 1)
        p512 = K.tile_scores_plan(4096, 256, 512)
        assert (p512["passes"], p512["cap"]) == (2, 256)  # one window

    def test_misaligned_pointers_narrow_the_loads(self):
        p = K.tile_scores_plan(100, 256, 64, slot_align=4, col_align=8)
        assert p["sv"] == 1 and p["v"] == 2
        assert (_cols_covered(p, 64) == 1).all()

    def test_long_rows_take_windows(self):
        p = K.tile_scores_plan(4096, 16384, 64)
        assert p["cap"] < 16384 and p["smem_bytes"] <= 48 * 1024

    def test_rejects_empty(self):
        with pytest.raises(ValueError):
            K.tile_scores_plan(0, 256, 64)


def _sorted_order(x: torch.Tensor) -> np.ndarray:
    return torch.sort(x, descending=True, stable=True).indices.numpy()


def _key_order(x: torch.Tensor) -> np.ndarray:
    key = K.topk_order_key(x)
    slot = torch.arange(x.shape[-1], dtype=torch.int64)
    comp = key * (1 << 31) + ((1 << 31) - 1 - slot)  # fits int64
    return torch.argsort(comp, descending=True).numpy()


def _adversarial(name, rng):
    if name == "all_equal":
        return torch.full((64,), 0.375)
    if name == "plus_minus_zero":
        return torch.tensor([0.0, -0.0] * 10 + [1.0, -0.0, -1.0, 0.0])
    if name == "subnormals":
        tiny = np.float32(1e-45)
        return torch.tensor(np.array([tiny, -tiny, 0, tiny * 3, -tiny * 3,
                                      np.float32(1.1754942e-38), 0, -0.0,
                                      tiny], np.float32))
    if name == "specials":
        return torch.tensor([np.nan, 1.0, np.inf, -np.inf, np.nan,
                             np.finfo(np.float32).min,
                             np.finfo(np.float32).max, -1.0])
    if name == "bf16_rounded":
        x = torch.from_numpy(rng.normal(size=200).astype(np.float32))
        return x.to(torch.bfloat16).to(torch.float32).repeat(2)
    if name == "f16_rounded":
        x = torch.from_numpy(rng.normal(size=200).astype(np.float32))
        return x.to(torch.float16).to(torch.float32).repeat(2)
    if name == "bf16_tensor":
        return torch.from_numpy(rng.integers(-4, 5, 100).astype(np.float32)
                                / 4).to(torch.bfloat16)
    if name == "f16_tensor":
        return torch.from_numpy(rng.integers(-4, 5, 100).astype(np.float32)
                                / 8).to(torch.float16)
    raise KeyError(name)


@pytest.mark.parametrize("name", ["all_equal", "plus_minus_zero",
                                  "subnormals", "specials", "bf16_rounded",
                                  "f16_rounded", "bf16_tensor", "f16_tensor"])
def test_order_key_sorts_like_stable_sort(name):
    x = _adversarial(name, np.random.default_rng(3))
    np.testing.assert_array_equal(_key_order(x), _sorted_order(x))


def test_order_key_values():
    key = K.topk_order_key(torch.tensor([0.0, -0.0, 1.0, -1.0, np.nan]))
    assert key.dtype == torch.int64
    assert key.tolist() == [0x80000000, 0x80000000, 0xBF800000,
                            0x407FFFFF, 0xFFFFFFFF]


def _keyed_select(ids, counts, head, lengths, idf, k):
    """csrc/score_topk.cu's selection in torch: score the head slots,
    order them by (topk_order_key desc, slot asc), decode picks past the
    head count or not above finfo.min to (0, -1)."""
    scores = sparse_scores(ids, counts, head, lengths, idf)
    d, length = ids.shape
    k = min(k, length)
    slot = torch.arange(length, dtype=torch.int64)
    comp = K.topk_order_key(scores) * (1 << 31) + ((1 << 31) - 1 - slot)
    comp = torch.where(head, comp, -1)
    order = torch.argsort(comp, dim=1, descending=True)[:, :k]
    picked = torch.gather(scores, 1, order)
    ok = (torch.gather(head, 1, order)
          & (picked > torch.finfo(scores.dtype).min))
    vals = torch.where(ok, picked, torch.zeros((), dtype=scores.dtype))
    tids = torch.where(ok, torch.gather(ids, 1, order), -1).to(torch.int32)
    return vals, tids


def _tie_heavy(seed, d, length, k, dtype):
    """Sorted triples of a batch whose rows have: all head slots scoring
    the same; exactly k and fewer than k head slots; no head slot; and
    Zipf rows where many scores tie."""
    rng = np.random.default_rng(seed)
    vocab = 40
    toks = np.clip(rng.zipf(1.3, (d, length)), 1, vocab).astype(np.int32) - 1
    lens = rng.integers(0, length + 1, d).astype(np.int32)
    toks[0] = np.repeat(np.arange(length // 2), 2)[:length]  # equal counts
    lens[0] = length
    toks[1, :k] = np.arange(k)                               # exactly k
    lens[1] = k
    toks[2, :max(k - 1, 0)] = np.arange(max(k - 1, 0))       # k - 1
    lens[2] = max(k - 1, 0)
    lens[3] = 0                                              # none
    toks[4, :length] = np.arange(length) % vocab             # up to L
    lens[4] = length
    ids, cnt, head = (np.asarray(a) for a in jax_sorted_term_counts(
        jnp.asarray(toks), jnp.asarray(lens)))
    idf = np.ones(vocab, np.float32)                         # every idf equal
    idf[rng.random(vocab) < 0.3] = 0.5
    return ids, cnt, head, lens, idf.astype(dtype)


@pytest.mark.parametrize("seed,d,length,k", [(0, 16, 32, 4), (1, 12, 64, 16),
                                             (2, 9, 40, 1), (3, 8, 24, 24)])
@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_keyed_selection_matches_pallas(seed, d, length, k, dtype):
    ids, cnt, head, lens, idf = _tie_heavy(seed, d, length, k, dtype)
    jv, jt = fused_score_topk_pallas(jnp.asarray(ids), jnp.asarray(cnt),
                                     jnp.asarray(head), jnp.asarray(lens),
                                     jnp.asarray(idf), k=k, interpret=True)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    tv, tt = _keyed_select(t(ids), t(cnt), t(head), t(lens), t(idf), k)
    jv, jt = np.asarray(jv), np.asarray(jt)
    np.testing.assert_array_equal(tt.numpy(), jt)
    bits = np.uint16 if dtype == np.float16 else np.uint32
    np.testing.assert_array_equal(tv.numpy().view(bits), jv.view(bits))
    # and the wrapper's plain version picks the same
    pv, pt = K.fused_score_topk(t(ids), t(cnt), t(head), t(lens), t(idf), k=k)
    np.testing.assert_array_equal(pt.numpy(), jt)
    assert (tt.numpy()[3] == -1).all()  # the row with no head slot
