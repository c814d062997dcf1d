"""The benchmark's one text generator: word types, documents, queries
and arrival schedules, all from a seed.

A configuration's ``corpus`` block (``configs/<config>.json``) and a
cell's ``traffic`` block (``workloads/<cell>.json``) are its only inputs;
nothing here knows a cell by name.

Steadiness across seeds: what sets the amount of work (the multiset of
document lengths, of query lengths and of arrival gaps) is drawn once
from a fixed stream and only its order follows the run's seed; the
words drawn into those slots follow the seed. So two seeds do the same
amount of work in another order.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

ALPHABET = 26
# Stream ids of the independent random streams one seed feeds.
_S_WORDS, _S_ORDER, _S_TOKENS, _S_QLEN, _S_QTOK, _S_ARRIVAL, _S_SAMPLE = \
    range(1, 8)
# The fixed stream that sizes the work (lengths, gaps): the same for
# every seed.
_FIXED = 0x5EED
_CREATE = os.O_WRONLY | os.O_CREAT | os.O_TRUNC


def rng(seed: int, stream: int) -> np.random.Generator:
    """An independent generator for ``stream`` of ``seed`` (any whole
    number; negative ones wrap to 64 bits)."""
    return np.random.default_rng(
        np.random.SeedSequence([int(seed) % (1 << 64), stream]))


@dataclass
class Words:
    """The word types, most frequent first: ``table`` holds every word
    followed by one space, ``offsets`` [W + 1] where each starts."""

    table: np.ndarray     # uint8
    offsets: np.ndarray   # int64 [W + 1]

    def __len__(self) -> int:
        return len(self.offsets) - 1

    def word(self, r: int) -> bytes:
        return self.table[self.offsets[r]:self.offsets[r + 1] - 1].tobytes()


def make_words(spec: dict) -> Words:
    """``spec["word_types"]`` distinct lowercase words of
    ``spec["word_bytes"] = [lo, hi]`` letters. Frequent ranks are short:
    rank r gets ``lo + floor(1.5 * log26(r + 1))`` letters plus a jitter
    of 0..2 past rank 676, clipped to ``hi``; within one length the words
    are distinct draws. The table is the same for every seed (it is the
    language, not the data)."""
    n = int(spec["word_types"])
    lo, hi = (int(x) for x in spec["word_bytes"])
    g = rng(_FIXED, _S_WORDS)
    ranks = np.arange(n, dtype=np.float64)
    lens = lo + np.floor(1.5 * np.log(ranks + 1) / np.log(ALPHABET))
    lens = lens.astype(np.int64)
    late = ranks >= ALPHABET ** 2
    lens[late] += g.integers(0, 3, int(late.sum()))
    lens = np.clip(lens, lo, hi)
    codes = np.zeros(n, np.int64)
    for length in np.unique(lens):
        idx = np.flatnonzero(lens == length)
        space = ALPHABET ** int(length)
        if len(idx) > space:
            raise ValueError(f"{len(idx)} words of {length} letters exceed "
                             f"the {space} there are")
        if space <= 1 << 24:
            vals = g.choice(space, len(idx), replace=False)
        else:
            vals = np.unique(g.integers(0, space, 2 * len(idx)))
            while len(vals) < len(idx):
                vals = np.unique(np.concatenate(
                    [vals, g.integers(0, space, len(idx))]))
            vals = g.permutation(vals)[:len(idx)]
        codes[idx] = vals
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(lens + 1, out=offsets[1:])
    table = np.full(int(offsets[-1]), ord(" "), np.uint8)
    for j in range(hi):
        live = np.flatnonzero(lens > j)
        table[offsets[live] + j] = (
            ord("a") + (codes[live] // ALPHABET ** j) % ALPHABET)
    return Words(table, offsets)


def zipf_ranks(g: np.random.Generator, n: int, s: float,
               types: int) -> np.ndarray:
    """``n`` word ranks (0 = most frequent) of Zipf(``s``) over
    ``types`` types: the inverse CDF of the power law x^-s on [0.5,
    types + 0.5), rounded, so P(rank r) is the law's mass around r."""
    u = g.random(n)
    if s == 1.0:   # the law x^-1: log-uniform
        x = 0.5 * ((types + 0.5) / 0.5) ** u
    else:
        a = 1.0 - s
        lo, hi = 0.5 ** a, (types + 0.5) ** a
        x = (lo + u * (hi - lo)) ** (1.0 / a)
    return np.clip(np.rint(x) - 1, 0, types - 1).astype(np.int32)


def fixed_lengths(spec: dict, count: int, salt: int,
                  part: int = 0) -> np.ndarray:
    """``count`` lengths of the distribution ``spec`` (``lognormal``:
    median, sigma; ``binomial``: n, p, plus ``min``), clipped to
    [min, max], drawn from the fixed stream ``salt`` (its ``part``-th
    draw): the same multiset for every seed."""
    g = rng(_FIXED, salt + (part << 16))
    kind = spec["kind"]
    if kind == "lognormal":
        x = np.rint(g.lognormal(np.log(spec["median"]), spec["sigma"],
                                count))
    elif kind == "binomial":
        x = spec["min"] + g.binomial(spec["n"], spec["p"], count)
    else:
        raise ValueError(f"unknown length distribution {kind!r}")
    return np.clip(x, spec["min"], spec["max"]).astype(np.int64)


@dataclass
class Corpus:
    """Documents as word ranks: doc d is ``ranks[starts[d]:starts[d + 1]]``."""

    words: Words
    ranks: np.ndarray     # int32, every token of every doc
    starts: np.ndarray    # int64 [D + 1]

    @property
    def num_docs(self) -> int:
        return len(self.starts) - 1

    def lengths(self) -> np.ndarray:
        return np.diff(self.starts)

    def text(self, d: int) -> bytes:
        return render(self.words, self.ranks[self.starts[d]:self.starts[d + 1]])


def make_corpus(spec: dict, seed: int, words: Optional[Words] = None
                ) -> Corpus:
    """``spec["docs"]`` documents: lengths from ``spec["length"]`` (a
    fixed multiset, permuted by the seed), tokens Zipf(``spec["zipf"]``)
    over the word types, drawn from the seed."""
    words = words or make_words(spec)
    n = int(spec["docs"])
    lens = fixed_lengths(spec["length"], n, 0x1D0C)
    lens = lens[rng(seed, _S_ORDER).permutation(n)]
    starts = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=starts[1:])
    ranks = zipf_ranks(rng(seed, _S_TOKENS), int(starts[-1]),
                       float(spec["zipf"]), len(words))
    return Corpus(words, ranks, starts)


def render(words: Words, ranks: np.ndarray) -> bytes:
    """The text of a token sequence: each word and one space."""
    return render_many(words, ranks, np.array([0, len(ranks)]))[0]


def render_many(words: Words, ranks: np.ndarray, starts: np.ndarray,
                as_str: bool = False) -> list:
    """The texts of the sequences ``ranks[starts[i]:starts[i + 1]]``,
    gathered from the table in one vectorized pass."""
    wl = np.diff(words.offsets)[ranks]
    out_off = np.zeros(len(ranks) + 1, np.int64)
    np.cumsum(wl, out=out_off[1:])
    total = int(out_off[-1])
    src = np.repeat(words.offsets[:-1][ranks] - out_off[:-1], wl)
    buf = words.table[src + np.arange(total, dtype=np.int64)].tobytes()
    bounds = out_off[starts]
    if as_str:
        return [buf[a:b].decode() for a, b in zip(bounds[:-1], bounds[1:])]
    return [buf[a:b] for a, b in zip(bounds[:-1], bounds[1:])]


def write_corpus(corpus: Corpus, root: str, block: int = 8192) -> int:
    """Write doc ``d`` to ``root/doc{d + 1}`` (the reference's strict
    discovery names); returns the bytes written."""
    os.makedirs(root, exist_ok=True)
    total = 0
    for lo in range(0, corpus.num_docs, block):
        hi = min(lo + block, corpus.num_docs)
        s = corpus.starts[lo:hi + 1]
        texts = render_many(corpus.words, corpus.ranks[s[0]:s[-1]], s - s[0])
        for d, t in enumerate(texts, start=lo + 1):
            fd = os.open(os.path.join(root, f"doc{d}"), _CREATE, 0o644)
            try:
                os.write(fd, t)
            finally:
                os.close(fd)
            total += len(t)
    return total


class QueryStream:
    """Distinct query texts, drawn in blocks of ``block`` as they are
    taken. ``traffic["query"]`` gives their length distribution
    (``"like_docs"`` takes the corpus's own). Each block's lengths are a
    fixed multiset permuted by the seed and its words follow the seed,
    so every seed does the same work in another order; a text drawn
    before (in any block) is drawn again. ``salt`` separates query sets
    of one seed (warm-up, window)."""

    def __init__(self, traffic: dict, corpus_spec: dict, words: Words,
                 seed: int, salt: int = 0, block: int = 2048):
        qspec = traffic["query"]
        self.lspec = corpus_spec["length"] if qspec == "like_docs" else qspec
        self.words, self.seed, self.salt = words, seed, salt
        self.block = int(block)
        self.zipf = float(corpus_spec["zipf"])
        self.g = rng(seed, _S_QTOK + 16 * salt)
        self.texts: List[str] = []
        self.seen: set = set()
        self._blocks = self._taken = 0

    def _draw(self) -> None:
        b = self._blocks
        self._blocks += 1
        lens = fixed_lengths(self.lspec, self.block, 0x0E11 + self.salt,
                             part=b)
        lens = lens[rng(self.seed, _S_QLEN + 16 * self.salt + (b << 8))
                    .permutation(self.block)]
        out: List[tuple] = []
        todo = np.arange(self.block)
        while len(todo):
            starts = np.zeros(len(todo) + 1, np.int64)
            np.cumsum(lens[todo], out=starts[1:])
            ranks = zipf_ranks(self.g, int(starts[-1]), self.zipf,
                               len(self.words))
            texts = render_many(self.words, ranks, starts, as_str=True)
            again = []
            for i, t in zip(todo.tolist(), texts):
                if t in self.seen:
                    again.append(i)
                else:
                    self.seen.add(t)
                    out.append((i, t))
            todo = np.array(again, np.int64)
        out.sort()
        self.texts.extend(t for _, t in out)

    def take(self, n: int) -> List[str]:
        """The next ``n`` texts (drawing blocks as needed)."""
        lo = self._taken
        while len(self.texts) < lo + n:
            self._draw()
        self._taken = lo + n
        return self.texts[lo:lo + n]

    def __getitem__(self, i: int) -> str:
        """Text ``i`` of the stream, drawing blocks until it exists."""
        while len(self.texts) <= i:
            self._draw()
        return self.texts[i]


def make_queries(traffic: dict, corpus_spec: dict, words: Words, seed: int,
                 count: int, salt: int = 0) -> List[str]:
    """The first ``count`` texts of :class:`QueryStream`."""
    return QueryStream(traffic, corpus_spec, words, seed, salt).take(count)


def arrivals(traffic: dict, seconds: float) -> np.ndarray:
    """Due times (seconds from the window's start, ascending, the last
    at ``seconds``) of an open loop at ``traffic["rate"]`` requests/s:
    Poisson arrivals from the fixed stream, scaled so the schedule fills
    ``seconds`` exactly. The same schedule for every seed: the seed
    changes which query is sent when, not when requests arrive."""
    n = max(1, int(round(float(traffic["rate"]) * seconds)))
    t = np.cumsum(rng(_FIXED, _S_ARRIVAL).exponential(1.0, n))
    return np.minimum(t * (seconds / t[-1]), seconds)


def sample_rows(seed: int, n: int, k: int, must: np.ndarray) -> np.ndarray:
    """``k`` distinct row numbers of ``n`` drawn from the seed, the rows
    in ``must`` (the longest, say) always among them; sorted."""
    must = np.unique(np.asarray(must, np.int64))[:k]
    rest = np.setdiff1d(np.arange(n), must)
    extra = rng(seed, _S_SAMPLE).permutation(rest)[:max(0, k - len(must))]
    return np.sort(np.concatenate([must, extra]))
