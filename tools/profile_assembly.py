"""Profile the assembly stage standalone from a genome_eval workdir.

Loads reads + alignment/te_filter checkpoints produced by a prior
tools/genome_eval.py run and re-executes ONLY assemble_all (the dominant
stage at genome scale) under cProfile, so its host/device split and hot
host functions are measurable without re-running the whole pipeline.

Usage:
  python tools/profile_assembly.py --workdir /tmp/ge23 [--wavefront]
      [--max-loci N] [--rounds R]
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
    ap.add_argument("--rounds", type=int, default=-1,
                    help="override polish_iterations (-1 = config default)")
    a = ap.parse_args()

    from telr_jax.utils.runtime import init_compile_cache
    init_compile_cache()

    from telr_jax.assembly.local import assemble_all
    from telr_jax.config import TELRConfig
    from telr_jax.io.fasta import read_fasta
    from telr_jax.utils.checkpoint import Checkpointer
    from telr_jax.utils.evallog import LociEval

    cfg = TELRConfig(use_wavefront=a.wavefront)
    asm_cfg = cfg.assembly
    if a.rounds >= 0:
        import dataclasses
        asm_cfg = dataclasses.replace(asm_cfg, polish_iterations=a.rounds)

    t0 = time.time()
    reads = read_fasta(os.path.join(a.workdir, "reads.fa"), dedup=False)
    print(f"reads loaded: {len(reads)} in {time.time()-t0:.1f}s", flush=True)

    ckpt = Checkpointer(os.path.join(a.workdir, "ckpt"))
    t0 = time.time()
    store = ckpt.load_alignments("alignment")
    records = ckpt.load_records("te_filter")
    print(f"ckpt loaded: {len(records)} records in {time.time()-t0:.1f}s",
          flush=True)
    if a.max_loci:
        records = records[: a.max_loci]

    from telr_jax.assembly.local import collect_extra_voters
    extra_voters = collect_extra_voters(records, store, asm_cfg.window)

    prof = cProfile.Profile()
    t0 = time.time()
    prof.enable()
    contigs, passed = assemble_all(
        records, reads, cfg.read_preset, asm_cfg, LociEval(),
        use_wavefront=a.wavefront, extra_voters=extra_voters)
    prof.disable()
    wall = time.time() - t0
    print(f"assemble_all: {wall:.1f}s for {len(records)} loci "
          f"({len(records)/wall:.3f} loci/s), {len(passed)} passed",
          flush=True)

    s = io.StringIO()
    st = pstats.Stats(prof, stream=s)
    st.sort_stats("cumulative").print_stats(35)
    st.sort_stats("tottime").print_stats(25)
    print(s.getvalue())


if __name__ == "__main__":
    main()
