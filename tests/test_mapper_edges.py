"""Mapper edge cases: empty batches, unmappable reads, tiny queries."""

import numpy as np

from telr_jax.config import MAP_PB
from telr_jax.io.seqs import SeqDict, Sequence
from telr_jax.kernels.mapper import Aligner


def _ref(seed=0, n=5000):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, n).astype(np.int8)
    return SeqDict([Sequence("r", codes)]), codes


def test_empty_batch():
    ref, _ = _ref()
    al = Aligner(ref, MAP_PB)
    assert al.map_batch({}) == {}


def test_unrelated_read_no_hits():
    ref, _ = _ref(0)
    rng = np.random.default_rng(99)
    foreign = rng.integers(0, 4, 2000).astype(np.int8)
    al = Aligner(ref, MAP_PB)
    assert al.map_seq("x", foreign) == []


def test_too_short_query():
    ref, _ = _ref()
    al = Aligner(ref, MAP_PB)
    assert al.map_seq("tiny", np.zeros(5, dtype=np.int8)) == []


def test_all_n_query():
    ref, _ = _ref()
    al = Aligner(ref, MAP_PB)
    assert al.map_seq("nn", np.full(500, 4, dtype=np.int8)) == []


def test_mixed_batch_hit_and_miss():
    ref, codes = _ref()
    rng = np.random.default_rng(7)
    queries = {
        "hit": codes[1000:2000].copy(),
        "miss": rng.integers(0, 4, 1000).astype(np.int8),
        "short": np.zeros(4, dtype=np.int8),
    }
    al = Aligner(ref, MAP_PB)
    res = al.map_batch(queries)
    assert len(res["hit"]) >= 1
    assert res["miss"] == []
    assert res["short"] == []
