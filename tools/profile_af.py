"""Profile the allele-frequency stage standalone from a genome_eval workdir.

Loads reads + alignment/te_filter/assembly checkpoints and re-executes
ONLY estimate_af under cProfile.

Usage:
  python tools/profile_af.py --workdir /tmp/ge23 [--wavefront] [--max-loci N]
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
    a = ap.parse_args()

    from telr_jax.utils.runtime import init_compile_cache
    init_compile_cache()

    from telr_jax.af.freq import estimate_af
    from telr_jax.annotate.contig import annotate_contigs
    from telr_jax.config import TELRConfig
    from telr_jax.io.fasta import read_fasta
    from telr_jax.io.seqs import SeqDict
    from telr_jax.utils.checkpoint import Checkpointer
    from telr_jax.utils.evallog import LociEval

    cfg = TELRConfig(use_wavefront=a.wavefront)
    t0 = time.time()
    reads = read_fasta(os.path.join(a.workdir, "reads.fa"))
    library = read_fasta(os.path.join(a.workdir, "lib.fa"))
    ckpt = Checkpointer(os.path.join(a.workdir, "ckpt"))
    store = ckpt.load_alignments("alignment")
    records = ckpt.load_records("te_filter")
    contigs, meta = ckpt.load_seqs("assembly")
    passed = set(meta["passed"])
    print(f"loaded in {time.time()-t0:.1f}s", flush=True)
    if a.max_loci:
        keep = set(sorted(passed)[: a.max_loci])
        passed &= keep
        records = [r for r in records if r.locus_name in keep]
        contigs = SeqDict([contigs[n] for n in keep if n in contigs])

    t0 = time.time()
    contig_te, te_seqs = annotate_contigs(
        contigs, passed, library, records, cfg.read_preset, cfg.annotate,
        LociEval(), use_wavefront=cfg.use_wavefront)
    print(f"annotate (prereq): {time.time()-t0:.1f}s", flush=True)

    pr = cProfile.Profile()
    t0 = time.time()
    pr.enable()
    te_freq = estimate_af(records, contigs, contig_te, reads, store,
                          cfg.read_preset, cfg.af, cfg.assembly,
                          use_wavefront=cfg.use_wavefront)
    pr.disable()
    dt = time.time() - t0
    print(f"estimate_af: {dt:.1f}s for {len(records)} loci "
          f"({len(records)/dt:.3f} loci/s), {len(te_freq)} entries")
    s = io.StringIO()
    pstats.Stats(pr, stream=s).sort_stats("cumulative").print_stats(30)
    print(s.getvalue())


if __name__ == "__main__":
    main()
