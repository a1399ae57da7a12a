"""Minimizer sketching, index and mapper tests."""

import numpy as np
import pytest

from telr_jax.config import MAP_PB
from telr_jax.io.seqs import SeqDict, Sequence, encode, revcomp_codes
from telr_jax.kernels.index import MinimizerIndex
from telr_jax.kernels.mapper import Aligner
from telr_jax.kernels.minimizer import minimizers, pack_kmers


def test_pack_kmers_basic():
    codes = encode("ACGTACGT")
    fwd, rc, valid = pack_kmers(codes, 4)
    assert len(fwd) == 5
    # ACGT packed = 0b00011011 = 27
    assert fwd[0] == 0b00011011
    assert valid.all()
    # revcomp of ACGT is ACGT (palindrome)
    assert rc[0] == fwd[0]


def test_pack_kmers_ambiguous():
    codes = encode("ACGNACGT")
    _, _, valid = pack_kmers(codes, 4)
    assert not valid[0] and not valid[3]
    assert valid[4]


def test_minimizers_strand_symmetry():
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, 500).astype(np.int8)
    p1, h1, s1 = minimizers(codes, 15, 10)
    rc = revcomp_codes(codes)
    p2, h2, s2 = minimizers(rc, 15, 10)
    # canonical hashes are strand-invariant: same multiset
    assert sorted(h1.tolist()) == sorted(h2.tolist())


def test_minimizer_density():
    rng = np.random.default_rng(1)
    codes = rng.integers(0, 4, 10_000).astype(np.int8)
    pos, h, s = minimizers(codes, 15, 10)
    # expected density ~ 2/(w+1)
    assert 0.1 < len(pos) / 10_000 < 0.35
    assert (np.diff(pos) > 0).all()


def test_index_lookup_roundtrip():
    rng = np.random.default_rng(2)
    codes = rng.integers(0, 4, 2000).astype(np.int8)
    seqs = SeqDict([Sequence("t", codes)])
    idx = MinimizerIndex.build(seqs, 15, 10)
    pos, h, s = minimizers(codes, 15, 10)
    qi, tp, ts = idx.lookup(h)
    # every minimizer of the indexed sequence is found at its own position
    found = {(int(a), int(b)) for a, b in zip(qi, tp)}
    for i, p in enumerate(pos):
        assert (i, int(p)) in found


@pytest.mark.parametrize("strand", ["+", "-"])
def test_mapper_exact_substring(strand):
    rng = np.random.default_rng(3)
    ref_codes = rng.integers(0, 4, 20_000).astype(np.int8)
    ref = SeqDict([Sequence("ref", ref_codes)])
    aligner = Aligner(ref, MAP_PB)
    q = ref_codes[5_000:7_000].copy()
    if strand == "-":
        q = revcomp_codes(q)
    alns = aligner.map_seq("q", q)
    assert alns, "no alignment found"
    best = alns[0]
    assert best.strand == strand
    assert abs(best.tstart - 5_000) < 30
    assert abs(best.tend - 7_000) < 30
    assert best.identity > 0.98
    assert best.mapq >= 50


def test_mapper_with_insertion():
    """A query with a 500bp novel insertion maps as ONE alignment with a
    big I run at the right position."""
    rng = np.random.default_rng(4)
    ref_codes = rng.integers(0, 4, 20_000).astype(np.int8)
    ref = SeqDict([Sequence("ref", ref_codes)])
    aligner = Aligner(ref, MAP_PB)
    ins = rng.integers(0, 4, 500).astype(np.int8)
    q = np.concatenate([ref_codes[4_000:6_000], ins, ref_codes[6_000:8_000]])
    alns = aligner.map_seq("q", q)
    assert alns
    best = alns[0]
    big_i = [(op, ln) for op, ln in best.cigar if op == "I" and ln > 400]
    assert big_i, best.cigar
    # locate the insertion point on the target
    tj = best.tstart
    for op, ln in best.cigar:
        if op == "I" and ln > 400:
            break
        if op in ("M", "D"):
            tj += ln
    assert abs(tj - 6_000) < 30


def test_mapper_split_on_large_deletion():
    """A query skipping 5kb of reference (deletion >> band) produces split
    alignments rather than one distorted record."""
    rng = np.random.default_rng(5)
    ref_codes = rng.integers(0, 4, 20_000).astype(np.int8)
    ref = SeqDict([Sequence("ref", ref_codes)])
    aligner = Aligner(ref, MAP_PB)
    q = np.concatenate([ref_codes[2_000:5_000], ref_codes[10_000:13_000]])
    alns = [a for a in aligner.map_seq("q", q) if a.primary]
    spans = sorted((a.tstart, a.tend) for a in alns)
    assert len(spans) >= 2
    assert abs(spans[0][0] - 2_000) < 50 and abs(spans[0][1] - 5_000) < 50
    assert abs(spans[1][0] - 10_000) < 50 and abs(spans[1][1] - 13_000) < 50


def test_map_batch_parallel_identity():
    """Forked multiprocess mapping must return exactly map_batch's
    alignments (per-read independence), in the same order."""
    import numpy as np
    from telr_jax.config import MAP_PB
    from telr_jax.io.seqs import SeqDict, Sequence
    from telr_jax.kernels.mapper import Aligner

    rng = np.random.default_rng(41)
    ref = rng.integers(0, 4, 30_000).astype(np.int8)
    al = Aligner(SeqDict([Sequence("chrT", ref)]), MAP_PB)
    batch = {}
    for i in range(12):
        s = int(rng.integers(0, 25_000))
        q = ref[s:s + 3000].copy()
        idx = rng.integers(0, len(q), 150)
        q[idx] = rng.integers(0, 4, 150)
        batch[f"r{i}"] = q
    r1 = al.map_batch(batch)
    r2 = al.map_batch_parallel(batch, 3)
    assert set(r1) == set(r2)
    for n in batch:
        assert len(r1[n]) == len(r2[n])
        for a, b in zip(r1[n], r2[n]):
            assert (a.tstart, a.tend, a.score, a.mapq, a.cigar) == \
                   (b.tstart, b.tend, b.score, b.mapq, b.cigar)
