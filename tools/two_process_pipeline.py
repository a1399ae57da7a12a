"""Multi-process PIPELINE scaling + bit-identity harness (VERDICT r2 #2).

Runs the full pipeline through telr_jax.dist.runner

  1) as ONE process (one CPU device, fixed thread budget), then
  2) as TWO processes (jax.distributed + gloo over localhost — the DCN
     stand-in), each loading ONLY its read shard, same thread budget each,

asserts the two output directories are byte-identical, and writes
SCALING_r03.json with pipeline reads/s and end-to-end efficiency
T1 / (2 * T2).

Dataset: the bundled 38kb test (--bundled, identity only) or a simulated
genome (default 6Mb/30x — big enough that each process works for minutes,
so efficiency is not noise; VERDICT r2 #6).

Usage:  python tools/two_process_pipeline.py [--size N] [--bundled]
        python tools/two_process_pipeline.py worker NPROCS PID ... # internal
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

PORT = int(os.environ.get("TELR_MP_PORT", "23667"))
HERE = os.path.abspath(__file__)
REPO = os.path.dirname(os.path.dirname(HERE))


def worker(nprocs: int, pid: int, reads_fa: str, ref_fa: str, lib_fa: str,
           out_dir: str, stats_path: str, threads: int) -> None:
    sys.path.insert(0, REPO)
    from telr_jax.utils.procpool import ensure_forkserver
    ensure_forkserver()   # before jax/gloo spin up threads
    import jax
    if nprocs > 1:
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
        jax.distributed.initialize(
            coordinator_address=f"localhost:{PORT}",
            num_processes=nprocs, process_id=pid)
    from telr_jax.config import SVConfig, TELRConfig
    from telr_jax.dist.runner import run_pipeline_multiprocess

    cfg = TELRConfig(sv=SVConfig(min_support=3), threads=threads)
    t0 = time.time()
    stage_s = run_pipeline_multiprocess(reads_fa, ref_fa, lib_fa, out_dir,
                                        cfg)
    wall = time.time() - t0
    if pid == 0:
        with open(stats_path, "w") as f:
            json.dump({"nprocs": nprocs, "wall_s": wall,
                       "stage_seconds": {k: round(v, 2)
                                         for k, v in stage_s.items()}}, f)


def _env(threads: int) -> dict:
    env = dict(os.environ)
    env.update({
        "JAX_PLATFORMS": "cpu",
        "XLA_FLAGS": "--xla_force_host_platform_device_count=1 "
                     "--xla_cpu_multi_thread_eigen=false "
                     "intra_op_parallelism_threads=1",
        "OMP_NUM_THREADS": "1",
        "TELR_DP_THREADS": str(threads),
        "PYTHONPATH": REPO,
    })
    return env


def _compare_dirs(d1: str, d2: str) -> list:
    """Byte-compare every output file; returns list of mismatches."""
    bad = []
    names = sorted(set(os.listdir(d1)) | set(os.listdir(d2)))
    for n in names:
        if n in ("TELR.log", "run_env.json"):
            continue
        p1, p2 = os.path.join(d1, n), os.path.join(d2, n)
        if not (os.path.isfile(p1) and os.path.isfile(p2)):
            bad.append(f"{n}: missing on one side")
            continue
        with open(p1, "rb") as f:
            b1 = f.read()
        with open(p2, "rb") as f:
            b2 = f.read()
        if b1 != b2:
            bad.append(f"{n}: differs ({len(b1)} vs {len(b2)} bytes)")
    return bad


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=6_000_000)
    ap.add_argument("--coverage", type=int, default=30)
    ap.add_argument("--threads", type=int, default=2)
    ap.add_argument("--bundled", action="store_true",
                    help="use the bundled 38kb dataset (identity only)")
    ap.add_argument("--procs", type=int, default=2,
                    help="process count of the multi-process run")
    ap.add_argument("--out", default=os.path.join(REPO, "SCALING_r04.json"))
    a = ap.parse_args()

    if a.bundled:
        ref = "/root/reference/test"
        reads_fa = f"{ref}/reads.fasta"
        ref_fa = f"{ref}/ref_38kb.fasta"
        lib_fa = f"{ref}/library.fasta"
        n_reads = 18
        workload = {"dataset": "bundled 38kb", "n_reads": n_reads}
    else:
        sys.path.insert(0, os.path.dirname(HERE))
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        from genome_eval import simulate_dataset
        workdir = "/tmp/telr_2proc_data"
        ref_fa, reads_fa, lib_fa, truth, n_reads, n_bases = \
            simulate_dataset(a.size, a.coverage, seed=0, workdir=workdir)
        workload = {"dataset": f"simulated {a.size / 1e6:.0f}Mb "
                               f"{a.coverage}x", "n_reads": n_reads,
                    "read_mb": round(n_bases / 1e6, 1),
                    "n_truth": len(truth)}

    env = _env(a.threads)
    out1, out2 = "/tmp/telr_mp_out1", "/tmp/telr_mp_out2"
    for d in (out1, out2):
        subprocess.run(["rm", "-rf", d], check=True)

    print("== 1 process ==", flush=True)
    subprocess.run(
        [sys.executable, HERE, "worker", "1", "0", reads_fa, ref_fa,
         lib_fa, out1, "/tmp/telr_mp_1p.json", str(a.threads)],
        env=env, check=True)
    P = a.procs
    print(f"== {P} processes (gloo DCN) ==", flush=True)
    procs = [subprocess.Popen(
        [sys.executable, HERE, "worker", str(P), str(p), reads_fa, ref_fa,
         lib_fa, out2, "/tmp/telr_mp_2p.json", str(a.threads)], env=env)
        for p in range(P)]
    for p in procs:
        if p.wait() != 0:
            raise SystemExit(f"{P}-process worker failed")

    mismatches = _compare_dirs(out1, out2)
    with open("/tmp/telr_mp_1p.json") as f:
        r1 = json.load(f)
    with open("/tmp/telr_mp_2p.json") as f:
        r2 = json.load(f)
    eff = r1["wall_s"] / (P * r2["wall_s"])
    align1 = r1["stage_seconds"].get("alignment", float("nan"))
    align2 = r2["stage_seconds"].get("alignment", float("nan"))
    out = {
        "workload": workload,
        "threads_per_process": a.threads,
        "one_process": r1,
        "two_process": r2,
        "procs": P,
        "pipeline_reads_per_s": {
            "1p": round(n_reads / r1["wall_s"], 2),
            f"{P}p": round(n_reads / r2["wall_s"], 2),
        },
        "alignment_reads_per_s": {
            "1p": round(n_reads / align1, 2) if align1 == align1 else None,
            f"{P}p": round(n_reads / align2, 2) if align2 == align2
            else None,
        },
        "scaling_efficiency": round(eff, 3),
        "bit_identical": not mismatches,
        "mismatches": mismatches,
        "backend": "cpu x1 device/process, gloo collectives (fake DCN); "
                   "each process parses only its crc32-shard of reads",
    }
    with open(a.out, "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out, indent=2))
    if mismatches:
        raise SystemExit(f"output mismatch between 1p and {P}p runs")


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "worker":
        worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
               sys.argv[5], sys.argv[6], sys.argv[7], sys.argv[8],
               int(sys.argv[9]))
    else:
        main()
