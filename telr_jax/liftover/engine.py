"""Annotation liftover: map contig TE annotations onto the reference genome
via flank alignment, and classify each as non-reference / reference /
unlifted.

Exact-semantics port of the reference's TELR_liftover.py (the algorithmic
heart of stage 3).  Every rule, threshold, tie-break and even argument-order
quirk is reproduced so calls match:

  * flank extraction: 5' = [start-flank_len+1, start) (note the +1 making it
    499bp, TELR_liftover.py:433-434), 3' = [end, end+flank_len)
    (TELR_liftover.py:446-447); out-of-bounds flanks are skipped,
  * 5' hits are filtered to the contig's source chromosome in TELR mode
    (TELR_liftover.py:461-467), 3' hits are not (":494 filter=None"),
  * pairing via bedtools closest -s -d -t all (TELR_liftover.py:502-518),
  * insertion coordinates via get_coord — the reference calls it with 5p/3p
    arguments swapped relative to its signature (TELR_liftover.py:555-557 vs
    269); the effective mapping is start=end_5p,end=start_3p on '+' and
    start=start_5p,end=end_3p on '-',
  * the gap decision tree (TELR_liftover.py:630-720) with TSD extraction,
  * nearby-reference-TE tests via closest -d -D ref -k 5 with
    family+strand equality and a 5 kb cap (TELR_liftover.py:288-340),
  * multi-report selection incl. choose_new_size preferring the larger gap
    (TELR_liftover.py:724-754, 940-944) and the two-nonref -> unlifted rule,
  * single-flank rescue with the ±5bp reference-TE adjacency test
    (TELR_liftover.py:807-927) including its key-name quirks
    ("mapp_quality_5p", 3p QC stored under 5p keys in the 3p rescue),
  * cross-locus overlap dedup keeping the lexicographically-longest TE
    (string max, TELR_liftover.py:1123-1134) and the summary JSON.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from telr_jax.config import ASM10, AlignPreset, LiftoverConfig
from telr_jax.io.seqs import SeqDict
from telr_jax.kernels.mapper import Aligner, Alignment
from telr_jax.ops.intervals import Intervals, closest, merge_intervals


# ---------------------------------------------------------------------------
# helpers (ports of the reference's small functions)
# ---------------------------------------------------------------------------

def _absmin(a: int, b: int) -> int:
    return a if abs(a) <= abs(b) else b


def _check_nums_similar(a: float, b: float) -> bool:
    # b == 0 guard: a zero-length TE annotation (possible via component
    # retry parsing when cs == ce) must not crash the decision tree.  The
    # reference (TELR_liftover.py:947-952) raises ZeroDivisionError here;
    # parity does not require crashing — a zero-length TE is never
    # "similar" to a nonzero gap.
    if b == 0:
        return a == 0
    return abs(a - b) / b <= 0.1


def _choose_new_size(size_ref: float, size_old: float, size_new: float) -> bool:
    return size_ref - size_old > size_ref - size_new


def _effective_coord(start_5p, end_5p, start_3p, end_3p, strand,
                     strand_aware=False):
    """The reference's get_coord as actually invoked (swapped args).

    The reference defines get_coord(start_3p, end_3p, start_5p, end_5p)
    but calls it with the 5p coords first (TELR_liftover.py:269 vs :555),
    so on '-'-strand contigs the computed gap is the NEGATION of the true
    junction gap: a TSD overlap of T reads as gap=+T (TSD never
    extracted) and an eroded-tip gap of G reads as an overlap of G (call
    silently dropped when G > flank_overlap_max).  strand_aware=True
    computes the junction-true gap on '-' contigs instead;
    strand_aware=False reproduces the reference byte-for-byte."""
    if strand == "+":
        start, end = end_5p, start_3p
    elif strand_aware:
        start, end = end_3p, start_5p
    else:
        start, end = start_5p, end_3p
    gap = end - start
    if start > end:
        start, end = end, start
    return start, end, gap


@dataclasses.dataclass
class FlankHit:
    tchrom: str
    tstart: int
    tend: int
    name: str
    mapq: int
    strand: str
    qc: Dict[str, object]

    @property
    def coord(self) -> str:
        return f"{self.tchrom}:{self.tstart}-{self.tend}"


def _hits_to_intervals(hits: List[FlankHit]) -> Intervals:
    rows = [(h.tchrom, h.tstart, h.tend, i, h.mapq, h.strand)
            for i, h in enumerate(hits)]
    return Intervals.from_rows(rows, ("hit", "score", "strand"))


def check_nearby_ref(chrom: str, start_q: int, end_q: int, family: str,
                     strand: str, ref_bed: Optional[Intervals],
                     threshold: int = 5000) -> Optional[int]:
    """Signed distance to the nearest same-family same-strand reference TE
    (reference TELR_liftover.py:288-340)."""
    if ref_bed is None or len(ref_bed) == 0:
        return None
    query = Intervals.from_rows([(chrom, start_q, end_q, family, ".", strand)],
                                ("family", "score", "strand"))
    res = closest(query, ref_bed, same_strand=False, signed=True, k=5)[0]
    distance: Optional[int] = None
    for _, b_idx, d in res:
        if b_idx < 0:
            continue
        if (ref_bed.cols["family"][b_idx] == family
                and ref_bed.cols["strand"][b_idx] == strand):
            distance = d if distance is None else _absmin(distance, d)
    if distance is not None and abs(distance) > threshold:
        distance = None
    return distance


def _ref_te_between(d5, d3, gap) -> bool:
    """The reference's in-between test (TELR_liftover.py:638-649)."""
    return (d5 is not None and d5 >= 0 and d5 <= gap
            and d3 is not None and d3 <= 0 and -d3 <= gap)


_UNLIFTED_TEMPLATE_KEYS = [
    "type", "family", "chrom", "start", "end", "strand", "gap",
    "TSD_length", "TSD_sequence",
    "5p_flank_align_coord", "5p_flank_mapping_quality",
    "5p_flank_num_residue_matches", "5p_flank_alignment_block_length",
    "5p_flank_sequence_identity",
    "3p_flank_align_coord", "3p_flank_mapping_quality",
    "3p_flank_num_residue_matches", "3p_flank_alignment_block_length",
    "3p_flank_sequence_identity",
    "distance_5p_flank_ref_te", "distance_3p_flank_ref_te", "comment",
]


# ---------------------------------------------------------------------------
# single-annotation liftover
# ---------------------------------------------------------------------------

def _extract_flanks(contig, start: int, end: int, flank_len: int):
    """5'/3' flank codes with the reference's bounds checks
    (extract_genome_seqs, TELR_liftover.py:191-212)."""
    contig_len = len(contig)
    s5, e5 = int(start) - flank_len + 1, int(start)
    fa_5p = contig.codes[s5:e5] if (s5 >= 0 and e5 <= contig_len) else None
    if fa_5p is not None and len(fa_5p) == 0:
        fa_5p = None
    s3, e3 = int(end), int(end) + flank_len
    fa_3p = contig.codes[s3:e3] if (s3 >= 0 and e3 <= contig_len) else None
    if fa_3p is not None and len(fa_3p) == 0:
        fa_3p = None
    return fa_5p, fa_3p


def lift_annotation(
    chrom: str, start: int, end: int, family: str, strand: str,
    contigs: SeqDict,
    reference: SeqDict,
    ref_aligner: Aligner,
    ref_bed: Optional[Intervals],
    cfg: LiftoverConfig,
    different_contig_name: bool = False,
    telr_mode: bool = True,
    prefetched: Optional[dict] = None,
) -> dict:
    lift_entries: dict = {}
    prefix = f"{chrom}_{start}_{end}".replace("|", "_")
    lift_entries["ID"] = prefix
    lift_entries["genome1_coord"] = f"{chrom}:{start}-{end}"
    te_length = int(end) - int(start)
    lift_entries["te_length"] = te_length

    contig = contigs[chrom]
    contig_len = len(contig)
    flank_len = cfg.flank_len
    gap_max = cfg.flank_gap_max
    overlap_max = cfg.flank_overlap_max

    fa_5p, fa_3p = _extract_flanks(contig, start, end, flank_len)

    if not different_contig_name:
        filter_chrom = "_".join(chrom.split("_")[:-2]) if telr_mode else chrom
    else:
        filter_chrom = None

    def map_flank(codes, qname, chrom_filter):
        hits: List[FlankHit] = []
        if codes is None:
            return hits
        if prefetched is not None and qname in prefetched:
            alns = prefetched[qname]
        else:
            alns = ref_aligner.map_seq(qname, codes)
        for a in alns:
            if chrom_filter is not None and a.tname != chrom_filter:
                continue
            hits.append(FlankHit(
                tchrom=a.tname, tstart=a.tstart, tend=a.tend, name=qname,
                mapq=a.mapq, strand=a.strand,
                qc={"query_length": a.qlen, "query_mapp_qual": a.mapq,
                    "num_residue_matches": a.matches,
                    "alignment_block_length": a.blocklen,
                    "sequence_identity": a.matches / a.blocklen
                    if a.blocklen else 0.0}))
        hits.sort(key=lambda h: (h.tchrom, h.tstart, h.tend))
        return hits

    hits_5p = map_flank(fa_5p, prefix + "_5p", filter_chrom)
    hits_3p = map_flank(fa_3p, prefix + "_3p", None)

    reports: List[dict] = []
    num_hits = 0
    reported = False

    if hits_5p and hits_3p:
        iv5 = _hits_to_intervals(hits_5p)
        iv3 = _hits_to_intervals(hits_3p)
        pairs = closest(iv5, iv3, same_strand=True, signed=False, k=1)
        for row in pairs:
            for a_idx, b_idx, _dist in row:
                if b_idx < 0:
                    continue
                h5 = hits_5p[int(iv5.cols["hit"][a_idx])]
                h3 = hits_3p[int(iv3.cols["hit"][b_idx])]
                if h5.tchrom != h3.tchrom:
                    continue
                lift_chrom = h5.tchrom
                flank_strand = h5.strand
                lift_start, lift_end, lift_gap = _effective_coord(
                    h5.tstart, h5.tend, h3.tstart, h3.tend, flank_strand,
                    strand_aware=cfg.strand_aware_gap)
                lift_strand = "+" if flank_strand == strand else "-"
                lift_entry = {
                    "type": None,
                    "family": family,
                    "chrom": lift_chrom,
                    "start": int(lift_start),
                    "end": int(lift_end),
                    "strand": lift_strand,
                    "gap": lift_gap,
                    "TSD_length": None,
                    "TSD_sequence": None,
                    "5p_flank_align_coord": h5.coord,
                    "5p_flank_mapping_quality": h5.mapq,
                    "5p_flank_num_residue_matches": h5.qc["num_residue_matches"],
                    "5p_flank_alignment_block_length":
                        h5.qc["alignment_block_length"],
                    "5p_flank_sequence_identity": h5.qc["sequence_identity"],
                    "3p_flank_align_coord": h3.coord,
                    "3p_flank_mapping_quality": h3.mapq,
                    "3p_flank_num_residue_matches": h3.qc["num_residue_matches"],
                    "3p_flank_alignment_block_length":
                        h3.qc["alignment_block_length"],
                    "3p_flank_sequence_identity": h3.qc["sequence_identity"],
                    "distance_5p_flank_ref_te": None,
                    "distance_3p_flank_ref_te": None,
                    "comment": None,
                }
                d5 = check_nearby_ref(lift_chrom, h5.tstart, h5.tend, family,
                                      lift_strand, ref_bed,
                                      cfg.nearby_ref_threshold)
                d3 = check_nearby_ref(lift_chrom, h3.tstart, h3.tend, family,
                                      lift_strand, ref_bed,
                                      cfg.nearby_ref_threshold)
                if d5 is not None:
                    lift_entry["distance_5p_flank_ref_te"] = d5
                if d3 is not None:
                    lift_entry["distance_3p_flank_ref_te"] = d3

                if lift_gap < -overlap_max:
                    pass  # overlap too large: drop (TELR_liftover.py:631-633)
                elif -overlap_max <= lift_gap <= gap_max:
                    if (_ref_te_between(d5, d3, lift_gap)
                            or _check_nums_similar(lift_gap, te_length)
                            or lift_gap >= te_length):
                        lift_entry["type"] = "reference"
                        lift_entry["comment"] = (
                            "overlap/gap size between 3p and 5p flanks within "
                            "threshold, include genome2 TE in between")
                    else:
                        lift_entry["type"] = "non-reference"
                        lift_entry["comment"] = (
                            "overlap/gap size between 3p and 5p flanks within "
                            "threshold")
                        if lift_gap == 0:
                            lift_entry["TSD_length"] = 0
                            lift_entry["TSD_sequence"] = None
                        if lift_gap < 0:
                            lift_entry["TSD_length"] = -lift_gap
                            lift_entry["TSD_sequence"] = reference.fetch_str(
                                lift_chrom, lift_start, lift_end)
                        num_hits += 1
                    reports.append(lift_entry)
                    reported = True
                else:
                    if gap_max < lift_gap <= 0.5 * te_length:
                        if _ref_te_between(d5, d3, lift_gap):
                            lift_entry["type"] = "reference"
                            lift_entry["comment"] = (
                                "flanks gap size less than half of TE "
                                "annotation, include genome2 TE in between")
                        else:
                            lift_entry["type"] = "non-reference"
                            lift_entry["comment"] = (
                                "flanks gap size exceeds threshold but less "
                                "than half of TE annotation, no genome2 TE in "
                                "between")
                            num_hits += 1
                        reports.append(lift_entry)
                        reported = True
                    elif 0.5 * te_length <= lift_gap <= cfg.max_ref_gap:
                        lift_entry["type"] = "reference"
                        if _ref_te_between(d5, d3, lift_gap):
                            lift_entry["comment"] = (
                                "flanks gap size greater than half of TE "
                                "annotation, include genome2 TE in between")
                        else:
                            lift_entry["comment"] = (
                                "flanks gap size greater than half of TE "
                                "annotation, no genome2 TE in between")
                        reports.append(lift_entry)
                        reported = True
                    # gap > max_ref_gap: drop (TELR_liftover.py:717-720)

    # multi-report selection (TELR_liftover.py:724-754)
    report_out: Optional[dict]
    if len(reports) > 1:
        best_ref: dict = {}
        best_nonref: dict = {}
        for rep in reports:
            if rep["type"] == "reference":
                if not best_ref:
                    best_ref = rep
                elif _choose_new_size(te_length, best_ref["gap"], rep["gap"]):
                    best_ref = rep
            if rep["type"] == "non-reference":
                if not best_nonref:
                    best_nonref = rep
                else:
                    reported = False
        report_out = None
        if reported:
            if best_ref and best_nonref:
                report_out = best_nonref
            elif best_ref:
                report_out = best_ref
            elif best_nonref:
                report_out = best_nonref
            else:
                reported = False
    elif len(reports) == 1:
        report_out = reports[0]
    else:
        report_out = None

    if not reported:
        lift_entry = {k: None for k in _UNLIFTED_TEMPLATE_KEYS}
        lift_entry["type"] = "unlifted"
        lift_entry["family"] = family
        lift_entry["comment"] = ("flank alignments not nearby each other / "
                                 "only one flank aligned")
        coords_5p = [h.coord for h in hits_5p]
        coords_3p = [h.coord for h in hits_3p]
        if len(coords_5p) == 1:
            lift_entry["5p_flank_align_coord"] = coords_5p[0]
        elif len(coords_5p) > 1:
            lift_entry["5p_flank_align_coord"] = coords_5p
        if len(coords_3p) == 1:
            lift_entry["3p_flank_align_coord"] = coords_3p[0]
        elif len(coords_3p) > 1:
            lift_entry["3p_flank_align_coord"] = coords_3p

        # single-flank rescue (TELR_liftover.py:807-927)
        if len(coords_5p) == 1 and len(coords_3p) == 0:
            h = hits_5p[0]
            lift_strand = "+" if h.strand == strand else "-"
            pos = h.tend if h.strand == "+" else h.tstart
            lift_entry["chrom"] = h.tchrom
            lift_entry["start"] = int(pos)
            lift_entry["end"] = int(pos)
            lift_entry["mapp_quality_5p"] = h.mapq
            lift_entry["strand"] = lift_strand
            lift_entry["5p_flank_num_residue_matches"] = \
                h.qc["num_residue_matches"]
            lift_entry["5p_flank_alignment_block_length"] = \
                h.qc["alignment_block_length"]
            lift_entry["5p_flank_sequence_identity"] = \
                h.qc["sequence_identity"]
            d5 = check_nearby_ref(h.tchrom, h.tstart, h.tend, family,
                                  lift_strand, ref_bed,
                                  cfg.nearby_ref_threshold)
            lift_entry["distance_5p_flank_ref_te"] = d5
            if d5 is not None and abs(d5) <= cfg.single_flank_ref_dist:
                lift_entry["type"] = "reference"
                lift_entry["comment"] = ("only one flank aligned, flank "
                                         "alignment adjacent to reference TE")
            else:
                lift_entry["type"] = "non-reference"
                lift_entry["comment"] = ("only one flank aligned, flank "
                                         "alignment not adjacent to "
                                         "reference TE")
                num_hits = 1
        elif len(coords_5p) == 0 and len(coords_3p) == 1:
            h = hits_3p[0]
            lift_strand = "+" if h.strand == strand else "-"
            pos = h.tstart if h.strand == "+" else h.tend
            lift_entry["chrom"] = h.tchrom
            lift_entry["start"] = int(pos)
            lift_entry["end"] = int(pos)
            lift_entry["mapp_quality_5p"] = h.mapq
            lift_entry["strand"] = lift_strand
            # reference stores 3p QC under 5p keys here
            # (TELR_liftover.py:896-904) — kept for output parity
            lift_entry["5p_flank_num_residue_matches"] = \
                h.qc["num_residue_matches"]
            lift_entry["5p_flank_alignment_block_length"] = \
                h.qc["alignment_block_length"]
            lift_entry["5p_flank_sequence_identity"] = \
                h.qc["sequence_identity"]
            d3 = check_nearby_ref(h.tchrom, h.tstart, h.tend, family,
                                  lift_strand, ref_bed,
                                  cfg.nearby_ref_threshold)
            lift_entry["distance_3p_flank_ref_te"] = d3
            if d3 is not None and abs(d3) <= cfg.single_flank_ref_dist:
                lift_entry["type"] = "reference"
                lift_entry["comment"] = ("only one flank aligned, flank "
                                         "alignment adjacent to reference TE")
            else:
                lift_entry["type"] = "non-reference"
                lift_entry["comment"] = ("only one flank aligned, flank "
                                         "alignment not adjacent to "
                                         "reference TE")
                num_hits = 1
        report_out = lift_entry

    lift_entries["report"] = report_out
    lift_entries["num_hits"] = num_hits
    return lift_entries


# ---------------------------------------------------------------------------
# full liftover over all annotations + cross-locus dedup + summary
# ---------------------------------------------------------------------------

def liftover(
    contigs: SeqDict,
    reference: SeqDict,
    bed1: Intervals,
    bed2: Optional[Intervals],
    cfg: LiftoverConfig,
    preset: AlignPreset = ASM10,
    different_contig_name: bool = False,
    telr_mode: bool = True,
    use_wavefront: bool = False,
) -> Tuple[List[dict], Intervals, dict]:
    """Returns (liftover report list, non-reference BED intervals, summary)."""
    ref_aligner = Aligner(reference, preset, use_wavefront=use_wavefront)
    # prefetch all flank->reference alignments in ONE batched dispatch
    # (replaces the reference's per-annotation Pool fan-out,
    # TELR_liftover.py:1049-1054)
    queries: dict = {}
    for i in range(len(bed1)):
        chrom = bed1.chrom[i]
        if chrom not in contigs:
            continue
        s, e = int(bed1.start[i]), int(bed1.end[i])
        prefix = f"{chrom}_{s}_{e}".replace("|", "_")
        fa_5p, fa_3p = _extract_flanks(contigs[chrom], s, e, cfg.flank_len)
        if fa_5p is not None:
            queries[prefix + "_5p"] = fa_5p
        if fa_3p is not None:
            queries[prefix + "_3p"] = fa_3p
    prefetched = ref_aligner.map_batch(queries) if queries else {}
    comp_col = bed1.cols.get("components")
    data: List[dict] = []
    for i in range(len(bed1)):
        entry = lift_annotation(
            bed1.chrom[i], int(bed1.start[i]), int(bed1.end[i]),
            bed1.cols["family"][i], bed1.cols["strand"][i],
            contigs, reference, ref_aligner, bed2, cfg,
            different_contig_name=different_contig_name,
            telr_mode=telr_mode, prefetched=prefetched)
        data.append(entry)
        rep = entry["report"]
        # component retry: the annotate stage's merge -d 10000 can weld a
        # novel insertion to a nearby reference TE copy on the same
        # contig (or the host family's alignment can span straight across
        # a nested insertion).  The welded interval then either
        # classifies "reference" (flank gap spans the reference copy) or
        # falls into single-flank rescue at a wrong position (annotation
        # runs to the contig edge).  Whenever the joint lift is NOT a
        # clean both-flank non-reference call, re-lift each per-family
        # component block: blocks genuinely present in the reference
        # re-classify as reference, a novel block lifts non-reference
        # with both flanks and supersedes the joint call.
        joint_clean = (rep is not None and rep["type"] == "non-reference"
                       and rep.get("gap") is not None)
        if comp_col is not None and comp_col[i] and not joint_clean:
            got_comp = False
            for comp in comp_col[i].split(";"):
                coords, rest = comp.split(":", 1)
                fam, _, cstrand = rest.rpartition(":")
                cs, ce = (int(x) for x in coords.split("-"))
                if cs == int(bed1.start[i]) and ce == int(bed1.end[i]):
                    continue  # identical to the joint interval
                sub = lift_annotation(
                    bed1.chrom[i], cs, ce, fam, cstrand, contigs,
                    reference, ref_aligner, bed2, cfg,
                    different_contig_name=different_contig_name,
                    telr_mode=telr_mode, prefetched=prefetched)
                srep = sub["report"]
                if (srep is not None and srep["type"] == "non-reference"
                        and sub["num_hits"] == 1
                        and srep.get("gap") is not None):
                    data.append(sub)
                    got_comp = True
            if (got_comp and rep is not None
                    and rep["type"] == "non-reference"):
                # a clean component call supersedes the joint's
                # single-flank rescue guess
                entry["report"] = None
                entry["num_hits"] = 0

    # cross-locus overlap dedup (TELR_liftover.py:1074-1141)
    rows = []
    for entry in data:
        if entry["num_hits"] == 1:
            rep = entry["report"]
            if rep is not None and rep["type"] == "non-reference":
                rows.append((rep["chrom"], rep["start"], rep["end"],
                             str(entry["te_length"]), entry["ID"]))
    iv = Intervals.from_rows(rows, ("te_length", "te_id"))
    merged = merge_intervals(iv, dist=0,
                             collapse={"te_length": "collapse",
                                       "te_id": "collapse"}, delim=",")
    remove_ids = set()
    for i in range(len(merged)):
        lens = merged.cols["te_length"][i].split(",")
        if len(lens) > 1:
            ids = merged.cols["te_id"][i].split(",")
            # reference compares length STRINGS (max on str,
            # TELR_liftover.py:1129) — reproduced for parity
            keep_idx = lens.index(max(lens))
            final_id = ids[keep_idx]
            for te_id in ids:
                if te_id != final_id:
                    remove_ids.add(te_id)
    data_new = [e for e in data if e["ID"] not in remove_ids]

    bed_rows = []
    for item in data_new:
        if item["num_hits"] == 1:
            info = item["report"]
            bed_rows.append((info["chrom"], info["start"], info["end"],
                             info["family"], ".", info["strand"]))
    nonref_bed = Intervals.from_rows(bed_rows, ("family", "score", "strand"))

    summary: dict = {
        "non-reference": {"total": 0, "comments": {}},
        "reference": {"total": 0, "comments": {}},
        "unlifted": {"total": 0, "comments": {}},
    }
    for item in data_new:
        info = item["report"]
        if info is None:
            continue
        t = info["type"]
        if t in summary:
            summary[t]["total"] += 1
            c = info.get("comment")
            if c is not None:
                summary[t]["comments"][c] = summary[t]["comments"].get(c, 0) + 1
    return data_new, nonref_bed, summary
