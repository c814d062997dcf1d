"""What the CPU can check of the redesigned B6, B1, B4 and B5 kernels.

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
* B4's launch plan (``ops.kernels.ragged_rebuild_plan``): every (row,
  slot) of the output is written exactly once, a vector group never
  straddles a granule, and the kernel's indexing over that plan (vector
  loads of 4 contiguous ids included) equals the plain version; the
  offset scan's tile-local offsets and tile totals give
  ``granule_offsets``.
* B5's fold constants (``ops.kernels.tokenize_fold``) against Python's
  ``%`` on 64-bit hashes, and a numpy model of csrc/tokenize_hash.cu's
  word-window byte walk (aligned windows, the shift to the token's first
  byte, refills, the byte path near the slab's end or on an unaligned
  slab, truncation) against ``tokenize_hash_pallas`` in interpret mode.

The kernels themselves run only on the card, where ``chip_smoke.py``
holds them against their plain versions bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from tfidf_tpu.ops import device_tokenize as jdt
from tfidf_tpu.ops.pallas_kernels import (fused_score_topk_pallas,
                                          tokenize_hash_pallas)
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


# --- B4: the rebuild's launch plan and indexing ---------------------------

def _b4_groups(p, d, length):
    """(row, first slot) of every group the plan processes: rows below D
    (a warp past the last row returns), groups whose first slot is below
    L (csrc/ragged_rebuild.cu's loop bound)."""
    b, w, ps, lane = np.meshgrid(np.arange(p["blocks"]), np.arange(p["warps"]),
                                 np.arange(p["passes"]), np.arange(32),
                                 indexing="ij")
    row = (b * p["warps"] + w).ravel()
    j0 = ((ps * 32 + lane) * p["group"]).ravel()
    keep = (row < d) & (j0 < length)
    return row[keep], j0[keep]


def _b4_kernel_model(flat, lens, length, align, p):
    """The kernel's indexing over the plan: offg by the scan, then per
    group ``src = (min(offg + j0 >> shift, ngran - 1) << shift) +
    (j0 & (G - 1))`` and ``group`` contiguous ids from it."""
    d = lens.shape[0]
    ngran = flat.size // align
    offg = np.concatenate([[0], np.cumsum(
        (np.maximum(lens.astype(np.int64), 0) + align - 1) >> p["shift"])])[:-1]
    out = np.full((d, length), -1, np.int64)
    row, j0 = _b4_groups(p, d, length)
    gran = np.minimum(offg[row] + (j0 >> p["shift"]), ngran - 1)
    src = (gran << p["shift"]) + (j0 & (align - 1))
    for e in range(p["group"]):
        out[row, j0 + e] = flat[src + e]
    return out


@pytest.mark.parametrize("d", [1, 7, 4096])
@pytest.mark.parametrize("length", [1, 6, 250, 256])
@pytest.mark.parametrize("align", [1, 2, 4, 8, 16, 32, 64])
def test_rebuild_plan_owns_every_slot_once(d, length, align):
    for itemsize in (2, 4):
        for flat_align, out_align in ((256, 256), (2, 256), (256, 4)):
            p = K.ragged_rebuild_plan(d, length, align, itemsize=itemsize,
                                      flat_align=flat_align,
                                      out_align=out_align)
            row, j0 = _b4_groups(p, d, length)
            slots = (row[:, None] * length + j0[:, None]
                     + np.arange(p["group"])[None, :]).ravel()
            assert (j0 + p["group"] <= length).all()  # no write past a row
            assert (np.bincount(slots, minlength=d * length) == 1).all()
            assert 1 << p["shift"] == align
            assert p["blocks"] * p["warps"] >= d > (p["blocks"] - 1) * p["warps"]
            vector = p["group"] == 4
            assert vector == (align % 4 == 0 and length % 4 == 0
                              and flat_align % (4 * itemsize) == 0
                              and out_align % 16 == 0)
            if vector:  # a group lies inside one granule
                assert ((j0 >> p["shift"])
                        == ((j0 + 3) >> p["shift"])).all()
                assert (j0 % 4 == 0).all()


@pytest.mark.parametrize("align", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("length", [6, 250, 256])
@pytest.mark.parametrize("dtype", [np.uint16, np.int32])
def test_rebuild_kernel_model_equals_plain(align, length, dtype):
    rng = np.random.default_rng(align * 1000 + length)
    d = 37
    lens = rng.integers(-3, length + 1, d).astype(np.int32)
    lens[0], lens[1], lens[-1] = 0, -1, length
    ngran = int(((np.maximum(lens, 0) + align - 1) // align).sum()) + 3
    flat = rng.integers(0, 60000, ngran * align).astype(dtype)
    p = K.ragged_rebuild_plan(d, length, align, itemsize=flat.itemsize)
    got = _b4_kernel_model(flat, lens, length, align, p)
    want = K.ragged_rebuild(torch.from_numpy(flat), torch.from_numpy(lens),
                            length=length, align=align)
    np.testing.assert_array_equal(got, want.numpy())


def _scan_model(lens, align):
    """csrc/ragged_rebuild.cu granule_scan_kernel: per tile of 1,024 rows
    (a block, a row a thread), the tile-local exclusive offsets, then one
    total per tile, in the plan's scratch layout."""
    d = lens.size
    c = (np.maximum(lens.astype(np.int64), 0) + align - 1) // align
    tiles = -(-d // 1024)
    padded = np.zeros(tiles * 1024, np.int64)
    padded[:d] = c
    per_tile = padded.reshape(tiles, 1024)
    local = (np.cumsum(per_tile, axis=1) - per_tile).ravel()[:d]
    return np.concatenate([local, per_tile.sum(axis=1)])


@pytest.mark.parametrize("d", [1, 511, 1024, 1025, 32768, 40000])
@pytest.mark.parametrize("align", [1, 16])
def test_offset_scan_model_gives_granule_offsets(d, align):
    # a row's offset is its tile-local offset plus the totals of the
    # tiles before it (the rebuild's warp sum)
    lens = np.random.default_rng(d).integers(-4, 300, d).astype(np.int32)
    p = K.ragged_rebuild_plan(d, 256, align, itemsize=2)
    scratch = _scan_model(lens, align)
    assert scratch.size == p["scratch"]
    totals = scratch[d:]
    before = np.concatenate([[0], np.cumsum(totals)])[np.arange(d) >> 10]
    want = K.granule_offsets(torch.from_numpy(lens), align).numpy()
    np.testing.assert_array_equal(scratch[:d] + before, want)


def test_rebuild_plan_rejects_bad_shapes():
    with pytest.raises(ValueError):
        K.ragged_rebuild_plan(0, 256, 16, itemsize=2)
    with pytest.raises(ValueError):
        K.ragged_rebuild_plan(4, 256, 12, itemsize=2)


# --- B5: the fold's constants and the word-window byte walk ---------------

_FOLD_VOCABS = [1, 2, 3, 255, 4093, 65521, 65535, 65536]
_M64 = (1 << 64) - 1


@pytest.mark.parametrize("vocab", _FOLD_VOCABS)
@settings(max_examples=300, deadline=None)
@given(h=st.integers(0, _M64))
def test_fold_constants_match_python_mod(vocab, h):
    assert K.tokenize_fold(h, vocab) == (h ^ (h >> 32)) % vocab


@pytest.mark.parametrize("vocab", _FOLD_VOCABS)
def test_fold_constants_at_the_edges(vocab):
    m32, magic = K.tokenize_fold_constants(vocab)
    assert m32 == (1 << 32) % vocab and 0 <= magic <= _M64
    for h in (0, 1, _M64, _M64 - 1, 1 << 32, (1 << 32) - 1, 1 << 63,
              0xFFFFFFFF00000000, vocab, vocab * (vocab + 1) - 1,
              ((1 << 32) - 1) * vocab):
        h &= _M64
        assert K.tokenize_fold(h, vocab) == (h ^ (h >> 32)) % vocab


def _walk_ids(slab, starts, lens, vocab, seed, trunc, vec):
    """csrc/tokenize_hash.cu's byte walk in numpy and Python ints: the
    first window of each live token (uint8: 16 bytes from the 8-aligned
    position at or below the start; int32: 4 elements from the 4-aligned
    one) when ``vec`` and it ends within the slab, shifted to the token's
    first element; its first 9 (int32: 1) elements hashed with no bound
    test when the window holds them and truncation allows, then the rest
    of the window, aligned refills, or one element at a time where a
    refill would run past the slab's end or ``vec`` is off; the fold of
    ``tokenize_fold``."""
    n = slab.size
    wide = slab.dtype == np.int32
    elems, align, bits = (4, 4, 32) if wide else (16, 8, 8)
    emask = (1 << bits) - 1
    state = jdt.FNV_OFFSET ^ (seed & _M64)

    def window(p):  # elements [p, p + elems) as one little-endian integer
        return int.from_bytes(slab[p:p + elems].tobytes(), "little")

    def hash_token(s):
        p = s & ~(align - 1)
        if vec and 0 <= p and p + elems <= n:
            win, avail = window(p) >> ((s - p) * bits), elems - (s - p)
        else:
            win, avail = 0, 0
        h, k, pos = state, 0, s
        sure = elems - align + 1  # a first window holds at least this many
        if avail >= sure and (trunc <= 0 or trunc >= sure):
            for i in range(sure):
                b = (win >> (i * bits)) & emask
                if b == 32 or 9 <= b <= 13:
                    return h
                h = ((h ^ b) * jdt.FNV_PRIME) & _M64
            win >>= sure * bits
            avail, k, pos = avail - sure, sure, pos + sure
        while True:
            lim = avail if trunc <= 0 else min(avail, trunc - k)
            for i in range(lim):
                b = (win >> (i * bits)) & emask
                if b == 32 or 9 <= b <= 13:
                    return h
                h = ((h ^ b) * jdt.FNV_PRIME) & _M64
            k += lim
            pos += lim
            if lim < avail or (trunc > 0 and k >= trunc) or pos >= n:
                return h
            if vec and pos % align == 0 and pos + elems <= n:
                win, avail = window(pos), elems
            else:
                win, avail = int(slab[pos]) & 0xFFFFFFFF, 1

    out = np.zeros(starts.shape, np.int32)
    for d in range(starts.shape[0]):
        for j in range(min(int(lens[d]), starts.shape[1])):
            out[d, j] = K.tokenize_fold(hash_token(int(starts[d, j])), vocab)
    return out


def _walk_slab(kind):
    """Docs in the bytes wire's layout, cut or shaped for one edge of the
    walk; returns (uint8 slab, starts, lengths)."""
    docs = [b"w1 w22 w333\tw4444", "héllo wörld 中文 éé naïve".encode(),
            b"", b"a b  c\n\rd", b"x" * 7 + b" " + b"y" * 9]
    if kind == "long_tokens":  # longer than two 16-byte windows
        docs += [b"q" * 33 + b" " + b"r" * 50, "é".encode() * 20]
    if kind == "utf8":
        docs += ["日本語テキスト emoji😀 Ωmega ß".encode()] * 3
    blens = np.array([len(d) for d in docs], np.int32)
    albl = np.asarray(jdt.aligned_byte_lengths(blens, 16))
    offs = np.concatenate([[0], np.cumsum(albl)[:-1]])
    slab = np.full(int(albl.sum()) + 16, 0x20, np.uint8)
    for doc, off in zip(docs, offs):
        slab[off:off + len(doc)] = np.frombuffer(doc, np.uint8)
    if kind == "len_not_multiple_of_8":
        slab = slab[:int(offs[-1]) + len(docs[-1]) + 3]
    if kind == "token_to_slab_end":  # the last token runs to the end
        slab = slab[:int(offs[-1]) + len(docs[-1])]
    starts, _, lens, _ = jdt.token_starts(slab, blens, length=8, align=16)
    return slab, np.asarray(starts), np.asarray(lens)


@pytest.mark.parametrize("kind,vocab,seed,trunc", [
    ("len_not_multiple_of_8", 1 << 16, 0, 0),
    ("token_to_slab_end", 65521, 7, 0),
    ("long_tokens", 1 << 16, 0xDEADBEEF12345678, 0),
    ("utf8", 3, 1, 0),
    ("long_tokens", 65535, 0, 1),
    ("utf8", 1 << 16, 5, 3),
    ("long_tokens", 4093, 0, 16),
    ("token_to_slab_end", 1 << 16, 0, 16)])
@pytest.mark.parametrize("vec", [True, False])
@pytest.mark.parametrize("wide", [False, True])
def test_window_walk_matches_pallas(kind, vocab, seed, trunc, vec, wide):
    slab, starts, lens = _walk_slab(kind)
    assert kind != "len_not_multiple_of_8" or slab.size % 8
    if kind == "token_to_slab_end":
        assert slab[-1] != 0x20 and lens.sum() > 0
    want = np.asarray(tokenize_hash_pallas(
        jnp.asarray(slab.astype(np.int32)), jnp.asarray(starts),
        jnp.asarray(lens), vocab_size=vocab, seed=seed, truncate_at=trunc,
        interpret=True))
    walk = slab.astype(np.int32) if wide else slab
    got = _walk_ids(walk, starts, lens, vocab, seed, trunc, vec)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("d,length", [(1, 1), (9, 6), (4096, 250),
                                      (32768, 256)])
@pytest.mark.parametrize("slab_align,vec", [(256, True), (16, True),
                                            (8, False), (1, False)])
def test_tokenize_hash_plan(d, length, slab_align, vec):
    p = K.tokenize_hash_plan(d, length, slab_align=slab_align)
    assert p["vec"] == vec and p["group"] == 1
    row, j0 = _b4_groups(p, d, length)
    assert (np.bincount(row * length + j0, minlength=d * length) == 1).all()
