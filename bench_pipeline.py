"""Pipeline-level benchmark harness: the BASELINE.json north-star metrics.

Generates a synthetic multi-locus dataset (or uses the bundled TELR test),
runs the full pipeline, and reports:
  - aligned read bases / s (stage 1 throughput)
  - loci assembled / s (stage 2 throughput)
  - end-to-end wall-clock and per-stage split
  - recall on the known planted insertions (synthetic mode)

Usage:
  python bench_pipeline.py               # bundled 38kb dataset
  python bench_pipeline.py --synthetic   # 120kb genome, 3 insertions
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np


def synthetic_dataset(outdir: str):
    from telr_jax.io.fasta import write_fasta
    from telr_jax.io.seqs import Sequence, revcomp_codes
    rng = np.random.default_rng(7)
    G = 120_000
    ref = rng.integers(0, 4, G).astype(np.int8)
    te1 = rng.integers(0, 4, 2_000).astype(np.int8)
    te2 = rng.integers(0, 4, 1_200).astype(np.int8)
    sites = [(30_000, te1), (70_000, revcomp_codes(te1)), (100_000, te2)]
    parts, prev = [], 0
    for pos, te in sites:
        parts.append(ref[prev:pos])
        parts.append(te)
        prev = pos
    parts.append(ref[prev:])
    hap = np.concatenate(parts)

    def noisy(codes, err=0.04):
        out = []
        for c in codes:
            r = rng.random()
            if r < err / 3:
                continue
            if r < 2 * err / 3:
                out.append(rng.integers(0, 4))
            if rng.random() < err / 3:
                out.append(rng.integers(0, 4))
            else:
                out.append(c)
        return np.array(out, dtype=np.int8)

    reads = []
    readlen = 12_000
    for rep in range(2):
        for start in range(0, len(hap) - readlen, 3_000):
            seq = noisy(hap[start:start + readlen])
            if (len(reads)) % 3 == 2:
                seq = revcomp_codes(seq)
            reads.append(Sequence(f"read{len(reads)}", seq))
    write_fasta([Sequence("chrS", ref)], os.path.join(outdir, "ref.fa"))
    write_fasta(reads, os.path.join(outdir, "reads.fa"))
    write_fasta([Sequence("alpha", te1), Sequence("beta", te2)],
                os.path.join(outdir, "lib.fa"))
    truth = [(30_000, "alpha"), (70_000, "alpha"), (100_000, "beta")]
    return (os.path.join(outdir, "reads.fa"), os.path.join(outdir, "ref.fa"),
            os.path.join(outdir, "lib.fa"), truth)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--synthetic", action="store_true")
    args = ap.parse_args()

    from telr_jax.config import SVConfig, TELRConfig
    from telr_jax.io.fasta import read_fasta
    from telr_jax.pipeline import run_pipeline

    tmp = tempfile.mkdtemp(prefix="telr_bench_")
    if args.synthetic:
        reads_p, ref_p, lib_p, truth = synthetic_dataset(tmp)
        cfg = TELRConfig(sv=SVConfig(min_support=3))
    else:
        base = "/root/reference/test"
        reads_p = os.path.join(base, "reads.fasta")
        ref_p = os.path.join(base, "ref_38kb.fasta")
        lib_p = os.path.join(base, "library.fasta")
        truth = [(33_029, "jockey")]
        cfg = TELRConfig()

    total_bases = sum(len(s) for s in read_fasta(reads_p))
    t0 = time.time()
    res = run_pipeline(reads_p, ref_p, lib_p, os.path.join(tmp, "out"),
                       config=cfg)
    wall = time.time() - t0

    n_loci = len(res.contigs)
    align_s = res.stage_seconds.get("alignment", 1e-9)
    asm_s = res.stage_seconds.get("assembly", 1e-9)
    hits = 0
    for pos, fam in truth:
        for call in res.final_report:
            if call["family"] == fam and abs(call["start"] - pos) < 200:
                hits += 1
                break
    report = {
        "wall_s": round(wall, 1),
        "aligned_bases_per_s": round(total_bases / align_s),
        "loci_assembled_per_s": round(n_loci / asm_s, 3),
        "recall": round(hits / len(truth), 3),
        "calls": len(res.final_report),
        "stages_s": {k: round(v, 1) for k, v in res.stage_seconds.items()},
    }
    print(json.dumps(report))


if __name__ == "__main__":
    main()
