"""The port's device tokenize (tfidf_tpu_torch/ops/device_tokenize.py)
against the JAX package's (tfidf_tpu/ops/device_tokenize.py) and Python
bigint FNV-1a64 on the same numpy inputs.

The two-limb FNV emulation equals bigint arithmetic; ``token_starts``
equals the JAX function on the whole [D, L] output (invalid slots
included); ``tokenize_hash_device`` equals the JAX function (XLA and
Pallas-interpret lowerings) and the host packer's ids. All integer,
all exact.
"""

import numpy as np
import pytest
import torch

from tfidf_tpu.ops import device_tokenize as jdt
from tfidf_tpu.ops.hashing import words_to_ids
from tfidf_tpu.ops.tokenize import whitespace_tokenize
from tfidf_tpu_torch.ops import device_tokenize as dt

P = 1099511628211


def build_slab(docs, align, bucket=1024):
    """The slab layout contract: doc bytes at aligned offsets, 0x20 fill."""
    blens = np.array([len(d) for d in docs], np.int32)
    albl = jdt.aligned_byte_lengths(blens, align)
    total = int(albl.sum())
    slab = np.full(max(total + (-total % bucket), bucket), 0x20, np.uint8)
    off = 0
    for doc, a in zip(docs, albl.tolist()):
        slab[off:off + len(doc)] = np.frombuffer(doc, np.uint8)
        off += int(a)
    return slab, blens


def host_ids(docs, length, vocab, seed, trunc):
    """The Python host packer's [D, L] ids and lengths (the oracle)."""
    ids = np.zeros((len(docs), length), np.int32)
    lens = np.zeros(len(docs), np.int32)
    for i, doc in enumerate(docs):
        toks = whitespace_tokenize(doc, trunc)[:length]
        lens[i] = len(toks)
        if toks:
            ids[i, :len(toks)] = words_to_ids(toks, vocab, seed)
    return ids, lens


def _limbs(h):
    return (torch.from_numpy((h >> np.uint64(32)).astype(np.int64)),
            torch.from_numpy((h & np.uint64(0xFFFFFFFF)).astype(np.int64)))


class TestFnvLimbs:
    def test_step_matches_bigint(self):
        rng = np.random.default_rng(0)
        h = rng.integers(0, 1 << 64, 256, dtype=np.uint64)
        b = rng.integers(0, 256, 256)
        hi, lo = dt.fnv1a_step(*_limbs(h), torch.from_numpy(b))
        for i in range(256):
            ref = ((int(h[i]) ^ int(b[i])) * P) % (1 << 64)
            assert (int(hi[i]) << 32) | int(lo[i]) == ref

    def test_step_matches_jax_limbs(self):
        import jax.numpy as jnp
        rng = np.random.default_rng(2)
        h = rng.integers(0, 1 << 64, 64, dtype=np.uint64)
        b = rng.integers(0, 256, 64)
        jhi, jlo = jdt.fnv1a_step(
            jnp.asarray((h >> np.uint64(32)).astype(np.uint32)),
            jnp.asarray((h & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
            jnp.asarray(b.astype(np.uint32)))
        thi, tlo = dt.fnv1a_step(*_limbs(h), torch.from_numpy(b))
        np.testing.assert_array_equal(thi.numpy(), np.asarray(jhi))
        np.testing.assert_array_equal(tlo.numpy(), np.asarray(jlo))

    @pytest.mark.parametrize("vocab", [1 << 16, 65535, 1 << 10, 999, 7, 1])
    def test_fold_mod_matches_bigint_and_jax(self, vocab):
        import jax.numpy as jnp
        rng = np.random.default_rng(1)
        h = rng.integers(0, 1 << 64, 64, dtype=np.uint64)
        ids = dt.fold_mod(*_limbs(h), vocab)
        assert ids.dtype == torch.int32
        ref = [(int(x) ^ (int(x) >> 32)) % vocab for x in h]
        np.testing.assert_array_equal(ids.numpy(), ref)
        jids = jdt.fold_mod(
            jnp.asarray((h >> np.uint64(32)).astype(np.uint32)),
            jnp.asarray((h & np.uint64(0xFFFFFFFF)).astype(np.uint32)), vocab)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))

    def test_fold_mod_rejects_wide_vocab(self):
        one = torch.zeros(1, dtype=torch.int64)
        with pytest.raises(ValueError, match="2\\^16"):
            dt.fold_mod(one, one, (1 << 16) + 1)

    @pytest.mark.parametrize("seed", [0, 7, 0xDEADBEEF12345678, -1])
    def test_seed_state(self, seed):
        hi, lo = dt.seed_state(seed)
        jhi, jlo = jdt.seed_state(seed)
        assert (hi, lo) == (int(jhi), int(jlo))
        assert (hi << 32) | lo == dt.FNV_OFFSET ^ (seed & (2 ** 64 - 1))

    def test_is_space_and_aligned_lengths(self):
        b = np.arange(256)
        np.testing.assert_array_equal(
            dt.is_space(torch.from_numpy(b.astype(np.uint8))).numpy(),
            np.asarray(jdt.is_space(b)))
        blens = np.array([0, 1, 15, 16, 17, -3], np.int32)
        for align in (1, 4, 16):
            want = jdt.aligned_byte_lengths(blens, align)
            np.testing.assert_array_equal(
                dt.aligned_byte_lengths(blens, align), want)
            np.testing.assert_array_equal(
                dt.aligned_byte_lengths(torch.from_numpy(blens), align).numpy(),
                want)


CASES = [
    ([b"hello world", b"", b"   \t\n ", "héllo wörld 中文 éé".encode(),
      b"a b c d e f g h i j k l m n o p"], None),
    ([b"a\tb\nc\x0bd\x0ce\rf g", b"\r\n\t", b"x"], None),
    ([b"supercalifragilisticexpialidocious tiny", b"w" * 5000 + b" end"], 16),
    ([b"supercalifragilisticexpialidocious tiny"], 3),
]


class TestTokenStarts:
    @pytest.mark.parametrize("align", [1, 4, 16])
    @pytest.mark.parametrize("case", range(len(CASES)))
    def test_matches_jax_whole_output(self, align, case):
        docs, _ = CASES[case]
        slab, blens = build_slab(docs, align)
        js, jv, jl, _ = jdt.token_starts(slab, blens, length=8, align=align)
        ts, tv, tl, tb = dt.token_starts(torch.from_numpy(slab),
                                         torch.from_numpy(blens), length=8,
                                         align=align)
        assert ts.dtype == torch.int32 and tl.dtype == torch.int32
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        assert tb.dtype == torch.uint8  # the slab as shipped, no int32 copy

    def test_random_binary(self):
        rng = np.random.default_rng(4)
        for case in range(6):
            docs = [bytes(rng.integers(1, 256, rng.integers(0, 200))
                          .astype(np.uint8))
                    for _ in range(int(rng.integers(1, 12)))]
            length = int(rng.integers(1, 20))
            slab, blens = build_slab(docs, 16)
            js, _, jl, _ = jdt.token_starts(slab, blens, length=length,
                                            align=16)
            ts, _, tl, _ = dt.token_starts(torch.from_numpy(slab),
                                           torch.from_numpy(blens),
                                           length=length, align=16)
            np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
            np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


class TestTokenizeHashDevice:
    @pytest.mark.parametrize("align", [1, 4, 16])
    def test_fixed_cases(self, align):
        for docs, trunc in CASES:
            slab, blens = build_slab(docs, align)
            ids, lens = dt.tokenize_hash_device(
                torch.from_numpy(slab), torch.from_numpy(blens), length=8,
                vocab_size=1000, seed=7, truncate_at=trunc, align=align)
            jids, jlens = jdt.tokenize_hash_device(
                slab, blens, length=8, vocab_size=1000, seed=7,
                truncate_at=trunc, align=align)
            eids, elens = host_ids(docs, 8, 1000, 7, trunc)
            np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
            np.testing.assert_array_equal(lens.numpy(), np.asarray(jlens))
            np.testing.assert_array_equal(ids.numpy(), eids)
            np.testing.assert_array_equal(lens.numpy(), elens)

    @pytest.mark.parametrize("method", ["xla", "pallas"])
    def test_random_binary_corpora(self, method):
        rng = np.random.default_rng(3)
        for case in range(8):
            docs = [bytes(rng.integers(1, 256, rng.integers(0, 300))
                          .astype(np.uint8))
                    for _ in range(int(rng.integers(1, 10)))]
            trunc = [None, 4, 16][case % 3]
            length = int(rng.integers(1, 24))
            slab, blens = build_slab(docs, 16)
            ids, lens = dt.tokenize_hash_device(
                torch.from_numpy(slab), torch.from_numpy(blens),
                length=length, vocab_size=1 << 10, seed=case,
                truncate_at=trunc, align=16)
            jids, jlens = jdt.tokenize_hash_device(
                slab, blens, length=length, vocab_size=1 << 10, seed=case,
                truncate_at=trunc, align=16, method=method,
                interpret=method == "pallas")
            np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
            np.testing.assert_array_equal(lens.numpy(), np.asarray(jlens))

    def test_token_straddles_bucket_boundary(self):
        doc = b"x" * 1019 + b" straddler " + b"y" * 50
        slab, blens = build_slab([doc], 16, bucket=1024)
        assert slab.size > 1024
        ids, lens = dt.tokenize_hash_device(
            torch.from_numpy(slab), torch.from_numpy(blens), length=4,
            vocab_size=1 << 10, align=16)
        eids, elens = host_ids([doc], 4, 1 << 10, 0, None)
        np.testing.assert_array_equal(ids.numpy(), eids)
        np.testing.assert_array_equal(lens.numpy(), elens)

    def test_max_per_doc_cap(self):
        doc = b" ".join(f"t{i}".encode() for i in range(40))
        slab, blens = build_slab([doc], 16)
        ids, lens = dt.tokenize_hash_device(
            torch.from_numpy(slab), torch.from_numpy(blens), length=10,
            vocab_size=1 << 10, align=16)
        assert int(lens[0]) == 10
        np.testing.assert_array_equal(ids.numpy(),
                                      host_ids([doc], 10, 1 << 10, 0, None)[0])

    def test_padding_docs_and_empty_slab_tail(self):
        # blens padded with zero-byte docs (the packers' pad_docs_to rows)
        docs = [b"alpha beta", b"gamma"]
        slab, blens = build_slab(docs, 16)
        blens = np.concatenate([blens, np.zeros(3, np.int32)])
        ids, lens = dt.tokenize_hash_device(
            torch.from_numpy(slab), torch.from_numpy(blens), length=4,
            vocab_size=64, align=16)
        jids, jlens = jdt.tokenize_hash_device(slab, blens, length=4,
                                               vocab_size=64, align=16)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
        np.testing.assert_array_equal(lens.numpy(), [2, 1, 0, 0, 0])
