"""Window-merge of nearby TE-candidate loci.

Exact-semantics port of the reference's merge_vcf (TELR_sv.py:84-140):
bedtools merge -d 20 with per-column collapse, then for multi-member windows:
  - start/end = rounded mean of members,
  - length/seq/ID/filter/genotype/ref_count/ins_te_prop from the member with
    the max length — NOTE the reference compares length strings
    lexicographically (`max(len_list)` on str, TELR_sv.py:104); we reproduce
    that for call parity,
  - coverage = sum, AF = capped sum (af_sum, TELR_sv.py:351-355),
  - reads = de-duplicated union, alt_count = len(reads).
"""

from __future__ import annotations

from typing import List

from telr_jax.ops.intervals import Intervals, merge_intervals
from telr_jax.sv.detect import SVRecord


def merge_nearby_records(records: List[SVRecord], window: int = 20
                         ) -> List[SVRecord]:
    if not records:
        return []
    iv = Intervals(
        chrom=[r.chrom for r in records],
        start=[r.start for r in records],
        end=[r.end for r in records],
        cols={"idx": list(range(len(records)))},
    )
    merged = merge_intervals(iv, dist=window,
                             collapse={"idx": "collapse"}, delim=";")
    out: List[SVRecord] = []
    for mi in range(len(merged)):
        idxs = [int(x) for x in merged.cols["idx"][mi].split(";")]
        members = [records[i] for i in idxs]
        if len(members) == 1:
            out.append(members[0])
            continue
        # reference picks the member with lexicographically-max length string
        len_strs = [str(m.length) for m in members]
        pick = members[len_strs.index(max(len_strs))]
        start = round(sum(m.start for m in members) / len(members))
        end = round(sum(m.end for m in members) / len(members))
        reads = []
        seen = set()
        for m in members:
            for r in m.reads:
                if r not in seen:
                    seen.add(r)
                    reads.append(r)
        af = sum(m.af for m in members)
        if af > 1:
            af = 1
        out.append(SVRecord(
            chrom=members[0].chrom, start=start, end=end, length=pick.length,
            coverage=sum(m.coverage for m in members), af=af,
            sv_id=pick.sv_id, seq=pick.seq, reads=reads,
            sv_filter=pick.sv_filter, genotype=pick.genotype,
            ref_count=pick.ref_count, alt_count=len(reads),
            ins_te_prop=pick.ins_te_prop, ins_te_family=pick.ins_te_family,
            ins_te_strand=pick.ins_te_strand))
    return out
