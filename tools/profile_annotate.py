"""Profile the annotate stage standalone from a genome_eval workdir.

Loads the assembly checkpoint + te_filter records produced by a prior
tools/genome_eval.py run and re-executes ONLY annotate_contigs (+
optional reannotate_families) under cProfile, so per-locus index-build
cost vs DP dispatch cost is measurable without re-running the pipeline.

Usage:
  python tools/profile_annotate.py --workdir /tmp/ge23 [--wavefront]
      [--max-loci N] [--reannotate]
"""

from __future__ import annotations

import argparse
import cProfile
import io
import os
import pstats
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--wavefront", action="store_true")
    ap.add_argument("--max-loci", type=int, default=0)
    ap.add_argument("--reannotate", action="store_true")
    a = ap.parse_args()

    from telr_jax.utils.runtime import init_compile_cache
    init_compile_cache()

    from telr_jax.annotate.contig import annotate_contigs, reannotate_families
    from telr_jax.config import TELRConfig
    from telr_jax.io.fasta import read_fasta
    from telr_jax.io.seqs import SeqDict
    from telr_jax.utils.checkpoint import Checkpointer
    from telr_jax.utils.evallog import LociEval

    cfg = TELRConfig(use_wavefront=a.wavefront)
    t0 = time.time()
    library = read_fasta(os.path.join(a.workdir, "lib.fa"))
    ckpt = Checkpointer(os.path.join(a.workdir, "ckpt"))
    contigs, meta = ckpt.load_seqs("assembly")
    passed = set(meta["passed"])
    records = ckpt.load_records("te_filter")
    print(f"loaded {len(contigs)} contigs in {time.time()-t0:.1f}s")

    if a.max_loci:
        keep = sorted(passed)[: a.max_loci]
        passed = set(keep)
        records = [r for r in records if r.locus_name in passed]
        contigs = SeqDict([contigs[n] for n in keep if n in contigs])

    le = LociEval()
    pr = cProfile.Profile()
    t0 = time.time()
    pr.enable()
    contig_te, te_seqs = annotate_contigs(
        contigs, passed, library, records, cfg.read_preset, cfg.annotate,
        le, use_wavefront=cfg.use_wavefront)
    if a.reannotate:
        contig_te = reannotate_families(contig_te, te_seqs, library,
                                        use_wavefront=cfg.use_wavefront)
    pr.disable()
    dt = time.time() - t0
    print(f"annotate: {dt:.1f}s for {len(passed)} loci "
          f"({len(passed)/dt:.3f} loci/s), {len(contig_te)} annotations")
    s = io.StringIO()
    pstats.Stats(pr, stream=s).sort_stats("cumulative").print_stats(35)
    print(s.getvalue())


if __name__ == "__main__":
    main()
