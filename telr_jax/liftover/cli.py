"""Standalone annotation-liftover CLI.

The reference's liftover is dual-use — importable module AND standalone
program (TELR_liftover.py:15-152 with its own argparse and standalone
defaults gap/overlap=50).  This mirrors that surface: lift a BED of
annotations from genome 1 onto genome 2.

Usage:
  python -m telr_jax.liftover.cli --fasta1 g1.fa --fasta2 g2.fa \
      -1 annotations.bed [-2 genome2_te.bed] [-o outdir] ...
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from telr_jax.config import LiftoverConfig
from telr_jax.io.fasta import read_fasta
from telr_jax.liftover.engine import liftover
from telr_jax.ops.intervals import Intervals


def read_bed(path: str) -> Intervals:
    rows = []
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line or line.startswith("#"):
                continue
            e = line.split("\t")
            rows.append((e[0], int(e[1]), int(e[2]),
                         e[3] if len(e) > 3 else ".",
                         e[4] if len(e) > 4 else ".",
                         e[5] if len(e) > 5 else "+"))
    return Intervals.from_rows(rows, ("family", "score", "strand"))


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Lift TE annotations from one assembly to another "
                    "(standalone mode; no external tools required)")
    p.add_argument("--fasta1", required=True, help="genome 1")
    p.add_argument("--fasta2", required=True, help="genome 2")
    p.add_argument("-1", "--bed1", required=True,
                   help="annotations on genome 1 (BED6)")
    p.add_argument("-2", "--bed2", default=None,
                   help="TE annotations on genome 2 (BED6)")
    p.add_argument("-l", "--flank_len", type=int, default=500)
    # standalone defaults are 50/50 (TELR_liftover.py:137-141), vs 20/20
    # in TELR mode
    p.add_argument("-g", "--flank_gap_max", type=int, default=50)
    p.add_argument("-p", "--flank_overlap_max", type=int, default=50)
    p.add_argument("-o", "--out", default=".")
    p.add_argument("--different_contig_name", action="store_true")
    p.add_argument("--telr_mode", action="store_true")
    p.add_argument("-t", "--threads", type=int, default=1)
    args = p.parse_args(argv)

    for path in (args.fasta1, args.fasta2, args.bed1):
        if not os.path.isfile(path):
            print(f"Can not open input file: {path}", file=sys.stderr)
            sys.exit(1)

    contigs = read_fasta(args.fasta1, dedup=False)
    reference = read_fasta(args.fasta2, dedup=False)
    bed1 = read_bed(args.bed1)
    bed2 = read_bed(args.bed2) if args.bed2 else None
    cfg = LiftoverConfig(flank_len=args.flank_len,
                         flank_gap_max=args.flank_gap_max,
                         flank_overlap_max=args.flank_overlap_max)
    data, nonref_bed, summary = liftover(
        contigs, reference, bed1, bed2, cfg,
        different_contig_name=args.different_contig_name,
        telr_mode=args.telr_mode)

    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "liftover_report.json"), "w") as f:
        json.dump(data, f, indent=4, sort_keys=False)
    with open(os.path.join(args.out, "liftover_summary.json"), "w") as f:
        json.dump(summary, f, indent=4, sort_keys=False)
    with open(os.path.join(args.out, "liftover_nonref.bed"), "w") as f:
        for i in range(len(nonref_bed)):
            f.write("\t".join([
                str(nonref_bed.chrom[i]), str(int(nonref_bed.start[i])),
                str(int(nonref_bed.end[i])), str(nonref_bed.cols["family"][i]),
                ".", str(nonref_bed.cols["strand"][i])]) + "\n")
    print("Liftover finished!")


if __name__ == "__main__":
    main()
