"""SV detection, TE filter and merge unit tests."""

import numpy as np
import pytest

from telr_jax.config import MAP_PB, SVConfig
from telr_jax.core.alignstore import AlignmentStore
from telr_jax.io.seqs import SeqDict, Sequence, decode, revcomp_codes
from telr_jax.kernels.mapper import Aligner
from telr_jax.sv.detect import (InsSignature, cluster_signatures,
                                detect_insertions, extract_signatures)
from telr_jax.sv.filter import filter_te_candidates
from telr_jax.sv.merge import merge_nearby_records
from telr_jax.sv.detect import SVRecord
from telr_jax.utils.evallog import LociEval


def _mk_reads_with_insertion(rng, ref, ins, n_alt=6, n_ref=4, readlen=3000):
    """Simulated reads: n_alt spanning the insertion at ref position 5000,
    n_ref without it."""
    reads = SeqDict()
    ins_point = 5000
    k = 0
    for i in range(n_alt):
        s = ins_point - rng.integers(800, readlen - 800)
        seq = np.concatenate([ref[s:ins_point], ins,
                              ref[ins_point:s + readlen]])
        if i % 2 == 1:
            seq = revcomp_codes(seq)
        reads.add(Sequence(f"alt{k}", seq.astype(np.int8)))
        k += 1
    for i in range(n_ref):
        s = ins_point - rng.integers(800, readlen - 800)
        reads.add(Sequence(f"ref{k}", ref[s:s + readlen].copy()))
        k += 1
    return reads


@pytest.fixture(scope="module")
def sim():
    rng = np.random.default_rng(7)
    ref = rng.integers(0, 4, 12_000).astype(np.int8)
    ins = rng.integers(0, 4, 700).astype(np.int8)
    refd = SeqDict([Sequence("chrT", ref)])
    reads = _mk_reads_with_insertion(rng, ref, ins)
    aligner = Aligner(refd, MAP_PB)
    alns = []
    for s in reads:
        alns.extend(aligner.map_seq(s.name, s.codes))
    return ref, ins, refd, reads, AlignmentStore(alns)


def test_signatures_found(sim):
    ref, ins, refd, reads, store = sim
    sigs = extract_signatures(store, reads, SVConfig())
    alt_sigs = [s for s in sigs if s.length > 500]
    assert len(alt_sigs) >= 5
    for s in alt_sigs:
        assert abs(s.tpos - 5000) < 50
        assert abs(s.length - 700) < 60


def test_detect_and_genotype(sim):
    ref, ins, refd, reads, store = sim
    recs = detect_insertions(store, reads, SVConfig(min_support=3))
    assert len(recs) == 1
    r = recs[0]
    assert r.chrom == "chrT"
    assert abs(r.start - 5000) < 50
    assert abs(r.length - 700) < 60
    assert r.alt_count >= 5
    assert r.ref_count >= 3
    assert r.genotype == "0/1"
    # inserted sequence matches the simulated insertion
    got = r.seq
    assert abs(len(got) - 700) < 60


def test_te_filter_keeps_hit_drops_miss(sim):
    ref, ins, refd, reads, store = sim
    lib = SeqDict([Sequence("fam1", ins.copy())])
    rng = np.random.default_rng(1)
    hit = SVRecord(chrom="c", start=1, end=1, length=700, coverage=5,
                   af=0.5, sv_id="0", seq=decode(ins), reads=["r1"],
                   sv_filter="PASS", genotype="0/1", ref_count=5, alt_count=5)
    miss = SVRecord(chrom="c", start=9000, end=9000, length=700, coverage=5,
                    af=0.5, sv_id="1",
                    seq=decode(rng.integers(0, 4, 700).astype(np.int8)),
                    reads=["r2"], sv_filter="PASS", genotype="0/1",
                    ref_count=5, alt_count=5)
    ev = LociEval()
    kept = filter_te_candidates([hit, miss], lib, ev)
    assert [r.sv_id for r in kept] == ["0"]
    assert kept[0].ins_te_prop > 0.9
    assert kept[0].ins_te_family == "fam1"
    assert ev.entries == [("c_9000_9000", "VCF sequence not repeatmasked")]


def _rec(chrom, pos, length, sv_id, reads, af=0.5):
    return SVRecord(chrom=chrom, start=pos, end=pos, length=length,
                    coverage=len(reads), af=af, sv_id=sv_id, seq="A" * length,
                    reads=list(reads), sv_filter="PASS", genotype="0/1",
                    ref_count=2, alt_count=len(reads))


def test_merge_window():
    a = _rec("c", 100, 500, "0", ["r1", "r2"], af=0.4)
    b = _rec("c", 110, 400, "1", ["r2", "r3"], af=0.3)
    far = _rec("c", 500, 300, "2", ["r4"], af=0.2)
    out = merge_nearby_records([a, b, far], window=20)
    assert len(out) == 2
    m = out[0]
    assert m.start == 105
    assert m.length == 500  # "500" > "400" both numerically and as strings
    assert sorted(m.reads) == ["r1", "r2", "r3"]
    assert m.alt_count == 3
    assert abs(m.af - 0.7) < 1e-9
    assert out[1].sv_id == "2"


def test_merge_af_capped():
    a = _rec("c", 100, 500, "0", ["r1"], af=0.8)
    b = _rec("c", 105, 500, "1", ["r2"], af=0.7)
    out = merge_nearby_records([a, b], window=20)
    assert out[0].af == 1


def test_cluster_min_support():
    store = AlignmentStore([])
    sigs = [InsSignature("c", 100 + i, 200, f"r{i}", 0, "+", "A" * 200)
            for i in range(3)]
    recs = cluster_signatures(sigs, store, SVConfig(min_support=5))
    assert recs == []
    recs = cluster_signatures(sigs, store, SVConfig(min_support=3, min_af=0.0))
    assert len(recs) == 1


# ---------------------------------------------------------------------------
# One-sided junction (clip) signatures: a long TE insertion that no read
# fully spans.  Left-flank reads end at the insertion point with >=500bp of
# dangling (TE) query; right-flank reads start there.  Sniffles counts such
# clipped reads as INS support (the reference consumes its RNAMES,
# TELR_sv.py:150-166); without them long TEs at modest coverage are invisible.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def junction_sim():
    rng = np.random.default_rng(11)
    ref = rng.integers(0, 4, 12_000).astype(np.int8)
    te = rng.integers(0, 4, 6000).astype(np.int8)   # longer than any read
    refd = SeqDict([Sequence("chrT", ref)])
    ins_point = 5000
    reads = SeqDict()
    k = 0
    for i in range(4):   # left-flank reads: ref flank + TE prefix
        s = ins_point - rng.integers(1200, 2000)
        seq = np.concatenate([ref[s:ins_point], te[:1500]])
        if i % 2:
            seq = revcomp_codes(seq)
        reads.add(Sequence(f"jl{k}", seq.astype(np.int8))); k += 1
    for i in range(4):   # right-flank reads: TE suffix + ref flank
        e = ins_point + rng.integers(1200, 2000)
        seq = np.concatenate([te[-1500:], ref[ins_point:e]])
        if i % 2:
            seq = revcomp_codes(seq)
        reads.add(Sequence(f"jr{k}", seq.astype(np.int8))); k += 1
    for i in range(3):   # reference-haplotype spanning reads
        s = ins_point - 1500
        reads.add(Sequence(f"ref{k}", ref[s:s + 3000].copy())); k += 1
    aligner = Aligner(refd, MAP_PB)
    alns = []
    for s in reads:
        alns.extend(aligner.map_seq(s.name, s.codes))
    return refd, reads, AlignmentStore(alns)


def test_junction_signatures_extracted(junction_sim):
    refd, reads, store = junction_sim
    sigs = extract_signatures(store, reads, SVConfig())
    kinds = {s.kind for s in sigs}
    assert "jr" in kinds and "jl" in kinds
    for s in sigs:
        if s.kind in ("jr", "jl"):
            assert abs(s.tpos - 5000) < 50
            assert s.length >= 500


def test_junction_rescue_calls_unspanned_te(junction_sim):
    refd, reads, store = junction_sim
    recs = detect_insertions(store, reads, SVConfig(min_support=5))
    assert len(recs) == 1
    r = recs[0]
    assert abs(r.start - 5000) < 50
    assert r.alt_count >= 6          # all 8 clipped reads minus edge cases
    assert not r.spanning_reads      # nothing spans the 6kb TE
    # stitched prefix+suffix carries TE sequence for the te_filter stage
    assert len(r.seq) >= 2000


def test_junction_needs_both_flanks():
    """Dangling tails on one side only (chimera pile-up) must not call."""
    rng = np.random.default_rng(13)
    ref = rng.integers(0, 4, 12_000).astype(np.int8)
    te = rng.integers(0, 4, 6000).astype(np.int8)
    refd = SeqDict([Sequence("chrT", ref)])
    reads = SeqDict()
    for k in range(6):   # left-flank reads only
        s = 5000 - rng.integers(1200, 2000)
        seq = np.concatenate([ref[s:5000], te[:1500]])
        reads.add(Sequence(f"jl{k}", seq.astype(np.int8)))
    aligner = Aligner(refd, MAP_PB)
    alns = []
    for s in reads:
        alns.extend(aligner.map_seq(s.name, s.codes))
    recs = detect_insertions(AlignmentStore(alns), reads,
                             SVConfig(min_support=5))
    assert recs == []


def test_rescue_does_not_perturb_spanned_locus(sim):
    """A locus with enough two-sided signatures is called identically
    whether or not clipped junction reads exist nearby (rescue-only
    policy keeps round-1 goldens byte-stable)."""
    ref, ins, refd, reads, store = sim
    cfg = SVConfig(min_support=3)
    base = detect_insertions(store, reads, cfg)
    # add two clipped reads (left flank + insertion prefix of a long tail)
    rng = np.random.default_rng(17)
    tail = rng.integers(0, 4, 2000).astype(np.int8)
    reads2 = SeqDict([s for s in reads])
    aligner = Aligner(refd, MAP_PB)
    alns = list(store.all())
    for k in range(2):
        s = 5000 - rng.integers(1200, 2000)
        seq = np.concatenate([ref[s:5000], tail]).astype(np.int8)
        reads2.add(Sequence(f"clip{k}", seq))
        alns.extend(aligner.map_seq(f"clip{k}", seq))
    recs = detect_insertions(AlignmentStore(alns), reads2, cfg)
    assert len(recs) == len(base) == 1
    a, b = base[0], recs[0]
    assert (a.start, a.end, a.length, a.reads) == (b.start, b.end,
                                                   b.length, b.reads)


def test_junction_stitch_spanning_backbone():
    """A long insertion covered only by junction reads: the jr/jl pair
    overlapping inside the TE body is stitched into the true insertion
    sequence plus a synthetic flank-to-flank spanning backbone."""
    from telr_jax.sv.detect import _stitch_junctions

    rng = np.random.default_rng(23)
    L = rng.integers(0, 4, 1000).astype(np.int8)
    TE = rng.integers(0, 4, 3000).astype(np.int8)
    R = rng.integers(0, 4, 1000).astype(np.int8)
    r1 = np.concatenate([L[-800:], TE[:2500]])   # jr: flank + prefix
    r2 = np.concatenate([TE[500:], R[:800]])     # jl: suffix + flank
    reads = SeqDict([Sequence("r1", r1), Sequence("r2", r2)])
    jr = InsSignature(tname="chrT", tpos=5000, length=2500, read="r1",
                      qpos=800, strand="+", seq=decode(TE[:2500]),
                      kind="jr")
    jl = InsSignature(tname="chrT", tpos=5000, length=2500, read="r2",
                      qpos=2500, strand="+", seq=decode(TE[500:]),
                      kind="jl")
    st = _stitch_junctions(jr, jl, reads)
    assert st is not None
    ins_seq, backbone = st
    assert abs(len(ins_seq) - 3000) <= 20
    assert ins_seq == decode(TE)
    want_bb = decode(np.concatenate([L[-800:], TE, R[:800]]))
    assert backbone == want_bb

    # non-overlapping segments (insertion longer than combined coverage)
    jr2 = InsSignature(tname="chrT", tpos=5000, length=1000, read="r1",
                       qpos=800, strand="+", seq=decode(TE[:1000]),
                       kind="jr")
    jl2 = InsSignature(tname="chrT", tpos=5000, length=1000, read="r2",
                       qpos=1000, strand="+", seq=decode(TE[2000:]),
                       kind="jl")
    assert _stitch_junctions(jr2, jl2, SeqDict([
        Sequence("r1", np.concatenate([L[-800:], TE[:1000]])),
        Sequence("r2", np.concatenate([TE[2000:], R[:800]])),
    ])) is None


def test_junction_stitch_minus_strand_and_spanning_jr():
    """Stitch correctness when (a) the jr read is '-'-strand (sig.qpos is
    a raw-strand coordinate — junction must be length-derived) and (b)
    the jr read spans past the TE into the right flank (the overlap then
    legitimately ends at S's tail, not P's)."""
    from telr_jax.sv.detect import _stitch_junctions

    rng = np.random.default_rng(31)
    L = rng.integers(0, 4, 1000).astype(np.int8)
    TE = rng.integers(0, 4, 3000).astype(np.int8)
    R = rng.integers(0, 4, 1000).astype(np.int8)

    # (a) '-'-strand jr read
    r1_fwd = np.concatenate([L[-800:], TE[:2500]])
    r1 = revcomp_codes(r1_fwd)
    r2 = np.concatenate([TE[500:], R[:800]])
    reads = SeqDict([Sequence("r1", r1), Sequence("r2", r2)])
    jr = InsSignature(tname="chrT", tpos=5000, length=2500, read="r1",
                      qpos=123, strand="-", seq=decode(TE[:2500]),
                      kind="jr")
    jl = InsSignature(tname="chrT", tpos=5000, length=2500, read="r2",
                      qpos=2500, strand="+", seq=decode(TE[500:]),
                      kind="jl")
    st = _stitch_junctions(jr, jl, reads)
    assert st is not None
    ins_seq, backbone = st
    assert ins_seq == decode(TE)
    assert backbone == decode(np.concatenate([L[-800:], TE, R[:800]]))

    # (b) jr read spans the whole TE plus right flank
    r1b = np.concatenate([L[-800:], TE, R[:300]])
    reads_b = SeqDict([Sequence("r1", r1b), Sequence("r2", r2)])
    jrb = InsSignature(tname="chrT", tpos=5000, length=3300, read="r1",
                       qpos=800, strand="+", seq=decode(r1b[800:]),
                       kind="jr")
    st = _stitch_junctions(jrb, jl, reads_b)
    assert st is not None
    ins_seq, backbone = st
    # insertion = P[:qend] + S[tend:]; the overlap ends at S's tail, so
    # the stitched insertion is the TE (within alignment-tie slop)
    assert abs(len(ins_seq) - 3000) <= 20
    assert backbone == decode(np.concatenate([L[-800:], TE, R[:800]]))
