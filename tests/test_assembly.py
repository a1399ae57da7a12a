"""Local assembly consensus tests."""

import numpy as np
import pytest

from telr_jax.config import MAP_PB, AssemblyConfig
from telr_jax.io.seqs import SeqDict, Sequence, revcomp_codes
from telr_jax.assembly.local import assemble_locus, consensus_vote
from telr_jax.kernels.mapper import Aligner


def _noisy_copy(rng, codes, sub=0.05, ins=0.03, dele=0.03):
    out = []
    for c in codes:
        r = rng.random()
        if r < dele:
            continue
        if r < dele + ins:
            out.append(rng.integers(0, 4))
        if rng.random() < sub:
            out.append(rng.integers(0, 4))
        else:
            out.append(c)
    return np.array(out, dtype=np.int8)


def test_consensus_improves_backbone():
    """With 8 noisy reads, the consensus must be much closer to the truth
    than any single read."""
    rng = np.random.default_rng(0)
    truth = rng.integers(0, 4, 4000).astype(np.int8)
    reads = SeqDict()
    for i in range(8):
        codes = _noisy_copy(rng, truth)
        if i % 3 == 2:
            codes = revcomp_codes(codes)
        reads.add(Sequence(f"r{i}", codes))
    cfg = AssemblyConfig(polish_iterations=2)
    ctg = assemble_locus("locus", [f"r{i}" for i in range(8)], reads,
                         MAP_PB, cfg)
    assert ctg is not None
    # identity of consensus vs truth
    ref = SeqDict([Sequence("truth", truth)])
    al = Aligner(ref, MAP_PB)
    hits = al.map_seq("ctg", ctg.codes)
    assert hits
    best = max(hits, key=lambda h: h.score)
    ident = best.identity
    assert ident > 0.97, ident
    assert abs(len(ctg) - 4000) < 200


def test_assemble_single_read():
    rng = np.random.default_rng(1)
    truth = rng.integers(0, 4, 2000).astype(np.int8)
    reads = SeqDict([Sequence("only", truth.copy())])
    cfg = AssemblyConfig(polish_iterations=1)
    ctg = assemble_locus("locus", ["only"], reads, MAP_PB, cfg)
    assert ctg is not None
    assert np.array_equal(ctg.codes, truth)


def test_assemble_missing_reads():
    reads = SeqDict()
    cfg = AssemblyConfig()
    assert assemble_locus("locus", ["ghost"], reads, MAP_PB, cfg) is None


def test_consensus_vote_deletion_majority():
    """A base deleted in most reads disappears from the consensus."""
    backbone = np.array([0, 1, 2, 3, 0, 1, 2, 3], dtype=np.int8)
    from telr_jax.kernels.mapper import Alignment

    def mk(cigar, qlen):
        return Alignment(qname="r", qlen=qlen, qstart=0, qend=qlen,
                         strand="+", tname="t", tlen=8, tstart=0, tend=8,
                         matches=0, blocklen=0, mapq=60, score=0,
                         cigar=cigar)

    # three reads skipping backbone position 4 (code 0)
    alns = []
    for _ in range(3):
        q = np.array([0, 1, 2, 3, 1, 2, 3], dtype=np.int8)
        alns.append((mk([("M", 4), ("D", 1), ("M", 3)], 7), q))
    cons = consensus_vote(backbone, alns, min_cov=1)
    assert list(cons) == [0, 1, 2, 3, 1, 2, 3]


def test_extra_voters_polish_flanks_but_cannot_delete_te():
    """Non-support 'extra voter' reads (the other haplotype) polish the
    flank columns they cover, but a read whose alignment walks a long
    deletion over the insertion is excluded from voting — otherwise at a
    het short-TE locus the reference haplotype would vote the TE away."""
    from telr_jax.assembly.local import _assemble_batch
    from telr_jax.utils.evallog import LociEval

    rng = np.random.default_rng(3)
    flank_l = rng.integers(0, 4, 1500).astype(np.int8)
    te = rng.integers(0, 4, 300).astype(np.int8)       # short, alignable-through
    flank_r = rng.integers(0, 4, 1500).astype(np.int8)
    allele = np.concatenate([flank_l, te, flank_r])
    ref_hap = np.concatenate([flank_l, flank_r])

    reads = SeqDict()
    support = []
    for k in range(4):
        reads.add(Sequence(f"alt{k}", _noisy_copy(rng, allele)))
        support.append(f"alt{k}")
    extras = []
    for k in range(12):
        reads.add(Sequence(f"ref{k}", _noisy_copy(rng, ref_hap)))
        extras.append(f"ref{k}")

    cfg = AssemblyConfig(polish_iterations=2)
    contigs, passed = _assemble_batch(
        [("locus", support, support, extras)], reads, MAP_PB, cfg,
        LociEval())
    assert "locus" in passed
    ctg = contigs["locus"].codes
    # the TE must survive (ref reads may not delete it)
    al = Aligner(SeqDict([Sequence("ctg", ctg)]), MAP_PB)
    hits = al.map_seq("te", te)
    assert hits, "TE vanished from the consensus"
    best = max(hits, key=lambda h: h.score)
    assert best.blocklen >= 250
    # and overall the contig matches the allele closely
    hits2 = Aligner(SeqDict([Sequence("allele", allele.astype(np.int8))]),
                    MAP_PB).map_seq("ctg", ctg)
    b2 = max(hits2, key=lambda h: h.score)
    # TE interior is only covered by the 4 support reads (~11% error), so
    # whole-contig identity is bounded by that; the guard assertion above
    # is the regression target
    assert b2.matches / b2.blocklen > 0.95
