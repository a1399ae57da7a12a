"""Stage-1 (read -> genome) wall-clock bench with hoststats breakdown.

Simulates genome+reads once (cached as npz in --workdir), then times ONE
map_batch_parallel call over the full read set — exactly the pipeline's
stage-1 — and prints reads/s plus the per-phase attribution counters
(plan fan-out, piece planning, wavefront prep/launch/wait/decode).
The fast iteration loop for dispatch-path optimization; the full
genome_eval run costs 3x more wall for the same stage-1 signal.

Usage: python tools/stage1_bench.py [--size 3000000] [--coverage 30]
           [--threads 4] [--wavefront] [--workdir s1bench]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def load_or_sim(size, coverage, seed, workdir):
    os.makedirs(workdir, exist_ok=True)
    cache = os.path.join(workdir, f"s1_{size}_{coverage}_{seed}.npz")
    if os.path.exists(cache):
        z = np.load(cache, allow_pickle=True)
        return z["genome"], list(zip(z["names"], z["codes"]))
    from tools.genome_eval import (make_genome, make_te_library,
                                   plant_insertions, simulate_reads)
    rng = np.random.default_rng(seed)
    lib = make_te_library(rng)
    genome = make_genome(size, lib, rng)
    truth = plant_insertions(genome, lib, max(10, size // 300_000), rng)
    reads = simulate_reads(genome, truth, coverage, rng)
    np.savez(cache, genome=genome,
             names=np.array([n for n, _ in reads], dtype=object),
             codes=np.array([c for _, c in reads], dtype=object))
    return genome, reads


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=3_000_000)
    ap.add_argument("--coverage", type=int, default=30)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--wavefront", action="store_true")
    ap.add_argument("--workdir", default=os.path.join(
        tempfile.gettempdir(), "telr_s1bench"))
    ap.add_argument("--repeat", type=int, default=1,
                    help="time the call N times in one process; the "
                         "last pass is fully warm (no compiles)")
    a = ap.parse_args()

    from telr_jax.utils.procpool import ensure_forkserver
    ensure_forkserver()
    from telr_jax.utils.runtime import init_compile_cache
    init_compile_cache()
    import dataclasses

    from telr_jax.config import MAP_PB
    from telr_jax.io.seqs import SeqDict, Sequence
    from telr_jax.kernels.mapper import Aligner
    from telr_jax.utils import hoststats

    genome, reads = load_or_sim(a.size, a.coverage, a.seed, a.workdir)
    n_bases = sum(len(c) for _, c in reads)
    print(f"workload: {len(reads)} reads, {n_bases / 1e6:.0f}Mb",
          flush=True)
    targets = SeqDict([Sequence("chr", np.asarray(genome))])
    pre = dataclasses.replace(MAP_PB, chain_prune_frac=0.5)
    t0 = time.time()
    al = Aligner(targets, pre, use_wavefront=a.wavefront)
    print(f"index: {time.time() - t0:.1f}s", flush=True)
    for it in range(a.repeat):
        hoststats.reset()
        t0 = time.time()
        res = al.map_batch_parallel({n: np.asarray(c) for n, c in reads},
                                    a.threads)
        dt = time.time() - t0
        n_aln = sum(len(v) for v in res.values())
        print(json.dumps({
            "pass": it,
            "wall_s": round(dt, 1),
            "reads_per_s": round(len(reads) / dt, 1),
            "mb_per_s": round(n_bases / 1e6 / dt, 3),
            "alignments": n_aln,
            "breakdown": hoststats.snapshot(),
        }, indent=1), flush=True)


if __name__ == "__main__":
    main()
