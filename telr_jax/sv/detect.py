"""Insertion-signature SV detection: the replacement for the Sniffles subset
TELR consumes.

TELR runs `sniffles -n -1 -m bam -v vcf` (reference TELR_sv.py:49-51) and then
keeps ONLY records with SVTYPE=INS and an explicit ALT sequence, reading
CHROM/POS/END/SVLEN/RE/AF/ID/ALT/RNAMES/FILTER/GT/DR/DV
(TELR_sv.py:159-169).  This module produces exactly those fields:

  1. scan every primary/supplementary alignment for intra-read insertion
     evidence: CIGAR I runs >= min_ins_len, plus split-pair signatures (two
     alignments of one read adjacent on the reference with an unaligned query
     middle),
  2. cluster signatures along the reference (single-linkage within
     max_cluster_dist, Sniffles' default neighbourhood),
  3. per cluster emit a SVRecord with position = median breakpoint, ALT seq
     from the read with the median-length insertion, RNAMES = supporting
     reads, genotype from the local alt/ref read counts.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from telr_jax.config import SVConfig
from telr_jax.core.alignstore import AlignmentStore
from telr_jax.io.seqs import SeqDict, decode, revcomp_codes


@dataclasses.dataclass
class InsSignature:
    tname: str
    tpos: int            # reference breakpoint (insertion point)
    length: int
    read: str
    qpos: int            # insertion start on the strand-oriented query
    strand: str
    seq: str             # inserted sequence (reference-forward orientation)
    kind: str = "ins"    # "ins" (two-sided, exact length) | "jr" | "jl"
                         # jr = right-junction: read enters the insertion at
                         # tpos (seq = insertion prefix); jl = left-junction:
                         # read exits the insertion at tpos (seq = suffix)


@dataclasses.dataclass
class SVRecord:
    """One TE-candidate insertion locus == one row of TELR's parsed VCF
    (column layout per reference TELR_sv.py:194-208)."""

    chrom: str
    start: int
    end: int
    length: int
    coverage: int        # RE — number of supporting reads
    af: float
    sv_id: str
    seq: str
    reads: List[str]     # RNAMES
    sv_filter: str
    genotype: str
    ref_count: int       # DR
    alt_count: int       # DV
    ins_te_prop: float = 0.0
    ins_te_family: str = ""
    ins_te_strand: str = "."
    # reads whose signature spans the whole insertion (two-sided, kind
    # "ins"); preferred as assembly backbones — junction-clipped reads
    # carry only one flank and would truncate the contig
    spanning_reads: List[str] = dataclasses.field(default_factory=list)
    # synthetic spanning sequence for junction-evidence loci: the best
    # jr read (left flank + insertion prefix) stitched to the best jl
    # read (insertion suffix + right flank) at their TE-body overlap.
    # Empty when two-sided evidence exists or the junction segments
    # don't overlap (insertion longer than combined read coverage).
    stitched_backbone: str = ""

    @property
    def locus_name(self) -> str:
        # "chr_start_end", the contig name used pipeline-wide
        # (reference TELR_assembly.py:47, TELR_te.py:51)
        return f"{self.chrom}_{self.start}_{self.end}"


def extract_signatures(store: AlignmentStore, reads: SeqDict,
                       cfg: SVConfig) -> List[InsSignature]:
    """Collect insertion signatures from CIGAR I runs and split alignments."""
    sigs: List[InsSignature] = []
    by_read: Dict[str, list] = {}
    for a in store.all():
        by_read.setdefault(a.qname, []).append(a)

    for qname, alns in by_read.items():
        codes = reads[qname].codes if qname in reads else None
        for a in alns:
            if not a.primary:
                continue
            qc = codes
            if qc is not None and a.strand == "-":
                qc = revcomp_codes(qc)
            # strand-oriented query start of the aligned region
            if a.strand == "-":
                q_cursor = a.qlen - a.qend
            else:
                q_cursor = a.qstart
            t_cursor = a.tstart
            raw_i: List[Tuple[int, int, int]] = []   # (tpos, qpos, len)
            for op, ln in a.cigar:
                if op == "M":
                    q_cursor += ln
                    t_cursor += ln
                elif op == "I":
                    if ln >= 20 and qc is not None:
                        raw_i.append((t_cursor, q_cursor, ln))
                    q_cursor += ln
                elif op == "D":
                    t_cursor += ln
            # merge I runs separated by tiny interludes: inside a long
            # insertion a chance k-mer match of TE sequence against the
            # reference scores better than one pure I run, so the optimal
            # DP path legitimately splits the run (I·a M·e I·b, e ~ k).
            # Runs within 100bp on BOTH axes are one insertion event —
            # the interlude query bases are genuine TE sequence
            # (Sniffles merges nearby signatures the same way).
            # Entries: [tp0, qp0, qend, t_last] (t_last = target pos of
            # the latest merged run, for the next gap check)
            merged: List[List[int]] = []
            for tp, qp, ln in raw_i:
                if merged:
                    m = merged[-1]
                    if tp - m[3] <= 100 and qp - m[2] <= 100:
                        m[2] = qp + ln
                        m[3] = tp
                        continue
                merged.append([tp, qp, qp + ln, tp])
            for tp0, qp0, qend, t_last in merged:
                # net length discounts interlude target bases; seq is the
                # full query span (interlude bases are TE sequence)
                net = (qend - qp0) - (t_last - tp0)
                if net >= cfg.min_ins_len:
                    sigs.append(InsSignature(
                        tname=a.tname, tpos=tp0, length=net,
                        read=qname, qpos=qp0, strand=a.strand,
                        seq=decode(qc[qp0:qend])))

        # split-pair signatures: same read, same target+strand, adjacent
        # on the reference, with an unaligned (or elsewhere-mapped) query
        # middle — the insertion.  ALL ordered pairs are considered, not
        # just consecutive ones: the TE body of a long insertion often
        # maps to a reference TE copy at another locus, so the flank pair
        # is non-adjacent in query order (x..TE-segment..y).
        prim = sorted([a for a in alns if a.primary],
                      key=lambda a: a.qstart)
        for xi in range(len(prim)):
            x = prim[xi]
            for y in prim[xi + 1:]:
                if x.tname != y.tname or x.strand != y.strand:
                    continue
                q_gap = y.qstart - x.qend
                if x.strand == "-":
                    # query coords are strand-independent; target
                    # adjacency order flips for '-' strand
                    t_gap = x.tstart - y.tend
                    t_bp = x.tstart
                else:
                    t_gap = y.tstart - x.tend
                    t_bp = x.tend
                if q_gap >= cfg.min_ins_len and abs(t_gap) <= 100 \
                        and codes is not None:
                    seg = codes[x.qend:y.qstart]
                    if x.strand == "-":
                        seg = revcomp_codes(seg)
                    sigs.append(InsSignature(
                        tname=x.tname, tpos=int(t_bp), length=int(q_gap),
                        read=qname, qpos=int(x.qend), strand=x.strand,
                        seq=decode(seg)))

        # one-sided junction signatures (Sniffles counts clipped reads as
        # INS support): an alignment boundary where the query continues
        # >= min_clip_len bases that are NOT aligned adjacently on this
        # target.  This is how a long TE insertion looks when the TE body
        # maps to an existing reference copy of the family elsewhere — no
        # read spans the whole insertion, so split pairs never form, but
        # left-flank reads all end at the insertion point and right-flank
        # reads all start there.  Reference-side view per segment:
        #   right boundary (tend):  query beyond = qlen-qend (+) / qstart (-)
        #   left boundary (tstart): query before = qstart (+) / qlen-qend (-)
        # A boundary is "explained locally" (consumed) when another segment
        # of the same read continues on this target within the cluster
        # neighbourhood — then the pair logic above owns it.
        if codes is None:
            continue
        consumed = set()  # (segment index, 'R'|'L')
        for xi, x in enumerate(prim):
            for yi, y in enumerate(prim):
                if xi == yi or x.tname != y.tname:
                    continue
                # x's right boundary meets y's left boundary on the ref
                if abs(y.tstart - x.tend) <= cfg.max_cluster_dist:
                    gap_ok = (y.qstart >= x.qend - 50 if x.strand == "+"
                              else x.qstart >= y.qend - 50)
                    if x.strand == y.strand and gap_ok:
                        consumed.add((xi, "R"))
                        consumed.add((yi, "L"))
        cap = 20000  # liftover drops gaps > 20000 (TELR_liftover.py:717-720)
        for xi, a in enumerate(prim):
            if a.mapq < cfg.min_clip_mapq:
                continue
            # right junction: insertion begins at a.tend
            cont = (a.qlen - a.qend) if a.strand == "+" else a.qstart
            if cont >= cfg.min_clip_len and (xi, "R") not in consumed:
                if a.strand == "+":
                    seg = codes[a.qend:min(a.qlen, a.qend + cap)]
                else:
                    seg = revcomp_codes(codes[max(0, a.qstart - cap):a.qstart])
                sigs.append(InsSignature(
                    tname=a.tname, tpos=int(a.tend), length=int(min(cont, cap)),
                    read=qname, qpos=int(a.qend), strand=a.strand,
                    seq=decode(seg), kind="jr"))
            # left junction: insertion ends at a.tstart
            cont = a.qstart if a.strand == "+" else (a.qlen - a.qend)
            if cont >= cfg.min_clip_len and (xi, "L") not in consumed:
                if a.strand == "+":
                    seg = codes[max(0, a.qstart - cap):a.qstart]
                else:
                    seg = revcomp_codes(codes[a.qend:min(a.qlen, a.qend + cap)])
                sigs.append(InsSignature(
                    tname=a.tname, tpos=int(a.tstart), length=int(min(cont, cap)),
                    read=qname, qpos=int(a.qstart), strand=a.strand,
                    seq=decode(seg), kind="jl"))
    return sigs


def _stitch_junctions(best_jr: InsSignature, best_jl: InsSignature,
                      reads: SeqDict) -> Optional[Tuple[str, str]]:
    """Overlap-stitch a junction pair into (insertion_seq, spanning_backbone).

    A jr read carries [left flank | insertion prefix P], a jl read
    [insertion suffix S | right flank]; when the insertion is shorter than
    the combined read coverage, P's tail and S's head overlap inside the
    TE body.  Aligning P against S locates that overlap, giving the TRUE
    insertion sequence (the naive P+S concat duplicates the middle — it
    mis-sizes the SV and mis-places the INS-seq->contig seeding) and a
    synthetic read that spans the whole insertion flank-to-flank, which
    local assembly can use as a backbone where no real read spans it.
    Returns None when the segments don't overlap confidently."""
    from telr_jax.config import MAP_PB
    from telr_jax.io.seqs import Sequence, encode
    from telr_jax.kernels.mapper import Aligner

    P = encode(best_jr.seq)
    S = encode(best_jl.seq)
    if len(P) < 200 or len(S) < 200:
        return None
    # read-vs-read overlap sees ~2x the read error rate; seed densely
    ovl_preset = dataclasses.replace(MAP_PB, k=11, w=5,
                                     min_chain_anchors=3)
    aligner = Aligner(SeqDict([Sequence("S", S)]), ovl_preset)
    hits = [a for a in aligner.map_seq("P", P) if a.strand == "+"]
    if not hits:
        return None
    a = max(hits, key=lambda h: h.matches)
    # a valid junction overlap starts at one segment's head (S's TE
    # suffix begins inside P, or — when the jl read reaches back across
    # the whole insertion — P's head inside S) and reaches one segment's
    # tail on the right (P may legitimately run past S's end when the jr
    # read spans the TE into the right flank)
    left_ok = a.tstart <= 150 or a.qstart <= 150
    right_ok = (len(P) - a.qend) <= 150 or (len(S) - a.tend) <= 150
    if a.matches < 200 or not (left_ok and right_ok):
        return None
    ins = np.concatenate([P[:a.qend], S[a.tend:]])
    r1 = reads[best_jr.read].codes if best_jr.read in reads else None
    r2 = reads[best_jl.read].codes if best_jl.read in reads else None
    if r1 is None or r2 is None:
        return decode(ins), ""
    if best_jr.strand == "-":
        r1 = revcomp_codes(r1)
    if best_jl.strand == "-":
        r2 = revcomp_codes(r2)
    # in the strand-ORIENTED frame, P always runs to the jr read's end
    # and S always starts at the jl read's head (extract_signatures cuts
    # them that way), so the junction positions are len-derived — the
    # stored sig.qpos is a raw-strand coordinate and lies on '-' reads.
    # The 20kb signature cap would break the length identity; reads that
    # long don't occur here, and the guard below drops them if they do.
    if len(P) >= 20000 or len(S) >= 20000:
        return decode(ins), ""
    j1 = len(r1) - len(P)
    backbone = np.concatenate([r1[:j1 + a.qend], r2[a.tend:]])
    return decode(ins), decode(backbone)


def cluster_signatures(sigs: List[InsSignature], store: AlignmentStore,
                       cfg: SVConfig, sample_name: str = "sample",
                       reads: Optional[SeqDict] = None
                       ) -> List[SVRecord]:
    """Single-linkage clustering of signatures along the reference, then
    per-cluster record emission with Sniffles-style genotyping."""
    # fully canonical order: position ties broken by (read, kind, qpos,
    # length) so clustering is deterministic regardless of the order
    # signatures were produced in (required for bit-identical output when
    # signatures are gathered from multiple processes, SURVEY §7 #4
    # determinism-across-shard-counts)
    sigs = sorted(sigs, key=lambda s: (s.tname, s.tpos, s.read, s.kind,
                                       s.qpos, s.length))
    clusters: List[List[InsSignature]] = []
    for s in sigs:
        if (clusters and clusters[-1][-1].tname == s.tname
                and s.tpos - clusters[-1][-1].tpos <= cfg.max_cluster_dist):
            clusters[-1].append(s)
        else:
            clusters.append([s])
    # sub-split at large internal position gaps: single-linkage chains
    # distinct events (e.g. a junction pile and an unrelated small-ins
    # pile ~1kb away) into one cluster, and the merged cluster then votes
    # with the wrong evidence class.  True clusters are tight (two-sided
    # sigs are CIGAR-exact, junction sigs scatter by ~TSD), so an
    # intra-cluster gap beyond cluster_split_gap separates real events.
    split: List[List[InsSignature]] = []
    for cl in clusters:
        cur = [cl[0]]
        for s in cl[1:]:
            if s.tpos - cur[-1].tpos > cfg.cluster_split_gap:
                split.append(cur)
                cur = [s]
            else:
                cur.append(s)
        split.append(cur)
    clusters = split

    records: List[SVRecord] = []
    k = 0
    for cl in clusters:
        # one signature per read: prefer two-sided (exact length) over
        # one-sided junction evidence, then the longest
        per_read: Dict[str, InsSignature] = {}
        for s in cl:
            cur = per_read.get(s.read)
            if (cur is None
                    or (cur.kind != "ins" and s.kind == "ins")
                    or (cur.kind == s.kind == "ins"
                        and s.length > cur.length)
                    or (cur.kind != "ins" and s.kind != "ins"
                        and s.length > cur.length)):
                per_read[s.read] = s
        support = list(per_read.values())
        if len(support) < cfg.min_support:
            continue
        two_sided = [s for s in support if s.kind == "ins"]
        # junction evidence is a RESCUE path: a locus already carrying
        # enough two-sided (read-spans-the-insertion) signatures is called
        # exactly as if the junction reads did not exist — their clipped
        # alignments add nothing but noise to the pileup consensus.  Only
        # when spanning reads are too few (long TEs at modest coverage:
        # no read traverses the whole insertion) do junction reads join
        # the support set.
        if len(two_sided) >= cfg.min_support:
            support = two_sided
        jr = [s for s in support if s.kind == "jr"]
        jl = [s for s in support if s.kind == "jl"]
        if len(two_sided) < cfg.min_support:
            # junction evidence is load-bearing: demand a well-formed
            # junction pair.  True insertions put both flank groups at the
            # same point (median gap <= ~TSD scale, balanced read counts);
            # repeat edges / chimera piles scatter by hundreds of bases
            # (measured: true loci delta 5-12bp, junk 56-534bp).
            if not two_sided:
                if (len(jr) < cfg.min_junction_each
                        or len(jl) < cfg.min_junction_each):
                    continue
            if jr and jl:
                d = abs(float(np.median([s.tpos for s in jr]))
                        - float(np.median([s.tpos for s in jl])))
                if d > cfg.junction_pos_tol:
                    continue
            elif not two_sided:
                continue
        stitched_bb = ""
        if two_sided:
            lens = np.array([s.length for s in two_sided])
            rep = min(two_sided,
                      key=lambda s: abs(s.length - float(np.median(lens))))
            rep_seq = rep.seq
        else:
            # stitch the longest insertion prefix (jr) + suffix (jl) at
            # their TE-body overlap when one exists (true insertion seq +
            # a synthetic spanning backbone for assembly); fall back to
            # the naive concat — the middle may then be missing or
            # duplicated, but downstream only needs TE homology
            # (te_filter) and a length scale
            best_jr = max(jr, key=lambda s: s.length)
            best_jl = max(jl, key=lambda s: s.length)
            st = (_stitch_junctions(best_jr, best_jl, reads)
                  if reads is not None else None)
            if st is not None:
                rep_seq, stitched_bb = st
            else:
                rep_seq = best_jr.seq + best_jl.seq
            lens = np.array([len(rep_seq)])
        if np.median(lens) < cfg.min_ins_len:
            continue
        # breakpoint from two-sided signatures when available: junction
        # tpos values straddle the TSD (left-flank reads align through the
        # TSD copy, right-flank reads start before it), so mixing them in
        # shifts the consensus by a few bases and costs TSD recovery
        pos_sigs = two_sided if two_sided else support
        pos = int(np.median([s.tpos for s in pos_sigs]))
        tname = support[0].tname
        # DR: reads spanning the breakpoint without ANY supporting
        # signature.  Exclusion must use the full signature-read set, not
        # the reduced assembly support: a junction read dropped from
        # `support` by the two-sided short-circuit still aligns through
        # the TSD copy (tend >= pos+10 whenever TSD >= 10) and would
        # otherwise be counted as a REFERENCE read — at hom loci that
        # drags AF below hom_af and miscalls 1/1 as 0/1 (Sniffles DR
        # means reads with no insertion evidence at all)
        sig_reads = {s.read for s in per_read.values()}
        spanning = set()
        for a in store.fetch(tname, pos - 10, pos + 10):
            if a.primary and a.tstart <= pos - 10 and a.tend >= pos + 10:
                spanning.add(a.qname)
        alt_reads = {s.read for s in support}
        dv = len(alt_reads)
        dr = len(spanning - sig_reads)
        af = dv / (dv + dr) if (dv + dr) else 0.0
        if af < cfg.min_af:
            continue
        if af > cfg.hom_af:
            gt = "1/1"
        elif af >= cfg.het_af:
            gt = "0/1"
        else:
            # 0/0 clusters are still emitted and sv_filter is always PASS:
            # the reference's only VCF-level drop is the bcftools query
            # `SVTYPE="INS" & ALT!="<INS>"` (TELR_sv.py:161-163) — it
            # keeps Sniffles 0/0 genotypes and applies no FILTER gate, so
            # downstream stages must see these records for parity
            gt = "0/0"
        records.append(SVRecord(
            chrom=tname, start=pos, end=pos, length=int(np.median(lens)),
            coverage=dv, af=round(af, 6), sv_id=str(k), seq=rep_seq,
            reads=sorted(alt_reads), sv_filter="PASS", genotype=gt,
            ref_count=dr, alt_count=dv,
            spanning_reads=sorted({s.read for s in two_sided}),
            stitched_backbone=stitched_bb))
        k += 1
    return records


def detect_insertions(store: AlignmentStore, reads: SeqDict, cfg: SVConfig,
                      sample_name: str = "sample") -> List[SVRecord]:
    """Full SV stage: signatures -> clusters -> records (replaces
    detect_sv + parse_vcf, reference TELR_sv.py:11-228)."""
    sigs = extract_signatures(store, reads, cfg)
    return cluster_signatures(sigs, store, cfg, sample_name, reads=reads)
