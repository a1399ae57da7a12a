"""Device consensus vote: bit parity vs the numpy reference implementation."""

import numpy as np
import pytest

from telr_jax.assembly.local import consensus_vote
from telr_jax.assembly.device_vote import vote_many
from telr_jax.config import MAP_PB
from telr_jax.io.seqs import SeqDict, Sequence, revcomp_codes
from telr_jax.kernels.mapper import Aligner


def _make_locus(rng, n_reads, bb_len, with_insert):
    backbone = rng.integers(0, 4, bb_len).astype(np.int8)
    alns = []
    target = SeqDict([Sequence("bb", backbone)])
    aligner = Aligner(target, MAP_PB)
    reads = {}
    for i in range(n_reads):
        lo = int(rng.integers(0, bb_len // 4))
        hi = int(rng.integers(3 * bb_len // 4, bb_len))
        r = backbone[lo:hi].copy()
        # substitutions
        idx = rng.integers(0, len(r), max(1, len(r) // 50))
        r[idx] = rng.integers(0, 4, idx.size)
        if with_insert and i % 2 == 0:
            mid = len(r) // 2
            ins = rng.integers(0, 4, 37).astype(np.int8)
            r = np.concatenate([r[:mid], ins, r[mid:]])
        if i % 3 == 2:
            r = revcomp_codes(r)
        reads[f"r{i}"] = r.astype(np.int8)
    res = aligner.map_batch(reads)
    for name, hits in res.items():
        prim = [h for h in hits if h.primary]
        if prim:
            best = max(prim, key=lambda h: h.score)
            alns.append((best, reads[name]))
    assert len(alns) >= 3
    return backbone, alns


@pytest.mark.parametrize("with_insert", [False, True])
def test_device_vote_parity(with_insert):
    rng = np.random.default_rng(11 + with_insert)
    items = [_make_locus(rng, n, ln, with_insert)
             for n, ln in ((6, 900), (9, 2500), (4, 1400))]
    got = vote_many(items)
    for (bb, alns), dev in zip(items, got):
        ref = consensus_vote(bb, alns)
        assert np.array_equal(dev, ref)


def test_device_vote_low_coverage_trim():
    """min_cov tip trimming parity on a sparse pileup."""
    rng = np.random.default_rng(3)
    bb, alns = _make_locus(rng, 3, 700, False)
    ref = consensus_vote(bb, alns)
    dev = vote_many([(bb, alns)])[0]
    assert np.array_equal(dev, ref)
