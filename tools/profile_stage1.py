"""Profile stage-1 (read->genome alignment) host planning vs DP time.

Simulates a small genome + reads with the genome_eval generators, maps a
subset of the reads through Aligner.map_batch, and prints a cProfile
cumulative-time table plus a coarse planning/DP wall split.  The VERDICT r3
finding this chases: at 100 Mb the alignment stage runs 0.665 MB/s with the
host-side planning (seeding/chaining/piece dispatch in kernels/mapper.py)
dominating both CPU and GPU backends.

Usage: python tools/profile_stage1.py [--size 3000000] [--coverage 5]
           [--reads 400] [--wavefront]
"""

from __future__ import annotations

import argparse
import cProfile
import io
import os
import pstats
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tools.genome_eval import (make_te_library, make_genome,
                               plant_insertions, simulate_reads)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=3_000_000)
    ap.add_argument("--coverage", type=int, default=5)
    ap.add_argument("--reads", type=int, default=400)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--wavefront", action="store_true")
    ap.add_argument("--sort", default="cumulative")
    ap.add_argument("--lines", type=int, default=40)
    args = ap.parse_args()

    rng = np.random.default_rng(args.seed)
    t0 = time.time()
    lib = make_te_library(rng)
    genome = make_genome(args.size, lib, rng)
    truth = plant_insertions(genome, lib, 10, rng)
    reads = simulate_reads(genome, truth, args.coverage, rng)
    print(f"sim: {len(reads)} reads, {time.time()-t0:.1f}s", file=sys.stderr)

    import dataclasses

    from telr_jax.io.seqs import SeqDict, Sequence
    from telr_jax.config import default_config
    from telr_jax.kernels.mapper import Aligner

    ref = SeqDict([Sequence("chr2L", genome)])
    cfg = default_config("pacbio")
    stage1 = dataclasses.replace(cfg.read_preset, chain_prune_frac=0.5)
    t0 = time.time()
    aligner = Aligner(ref, stage1, use_wavefront=args.wavefront)
    t_index = time.time() - t0
    print(f"index build: {t_index:.1f}s", file=sys.stderr)

    subset = dict(reads[: args.reads])
    nbases = sum(len(c) for c in subset.values())

    pr = cProfile.Profile()
    t0 = time.time()
    pr.enable()
    res = aligner.map_batch(subset)
    pr.disable()
    wall = time.time() - t0
    nal = sum(len(v) for v in res.values())
    print(f"map_batch: {len(subset)} reads {nbases/1e6:.1f}Mb "
          f"{wall:.1f}s = {nbases/1e6/wall:.3f} MB/s, {nal} alignments",
          file=sys.stderr)
    s = io.StringIO()
    ps = pstats.Stats(pr, stream=s).sort_stats(args.sort)
    ps.print_stats(args.lines)
    print(s.getvalue())


if __name__ == "__main__":
    main()
