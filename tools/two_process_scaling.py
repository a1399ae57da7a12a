"""Two-process fake-DCN scaling harness (SURVEY §2c / BASELINE multi-host
target).

Runs the sharded stage-1 alignment step over a fixed global workload

  1) as ONE process owning one CPU device, then
  2) as TWO processes (jax.distributed + gloo collectives over localhost —
     the DCN stand-in), one CPU device each, mesh spanning both,

and reports scaling efficiency = T1 / (2 * T2).  Each process is pinned to
a single XLA host device with single-threaded intra-op execution so the
two runs compare core-for-core.

Usage:  python tools/two_process_scaling.py            # orchestrate + JSON
        python tools/two_process_scaling.py worker N P # internal
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

PORT = 23458
B, LQ, LT, WIDTH, ITERS, WARMUP = 64, 2048, 2304, 512, 4, 1


def worker(nprocs: int, pid: int, out_path: str) -> None:
    import jax
    if nprocs > 1:
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
        jax.distributed.initialize(
            coordinator_address=f"localhost:{PORT}",
            num_processes=nprocs, process_id=pid)
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from telr_jax.dist.pipeline import make_sharded_align_step
    from telr_jax.kernels import dp
    from telr_jax.config import MAP_PB

    devs = jax.devices()
    mesh = Mesh(np.array(devs), ("reads",))
    params = dp.DPParams(match=MAP_PB.match, mismatch=MAP_PB.mismatch,
                         gap_open=MAP_PB.gap_open,
                         gap_extend=MAP_PB.gap_extend).tuple()

    rng = np.random.default_rng(0)
    q = rng.integers(0, 4, size=(B, LQ)).astype(np.int8)
    t = rng.integers(0, 4, size=(LT,)).astype(np.int8)
    off = np.broadcast_to(dp.make_band_offsets(LQ, LT, WIDTH),
                          (B, LQ + 1)).copy()
    qlen = np.full((B,), LQ, np.int32)
    tlen = np.asarray(LT, np.int32)

    batch_sh = NamedSharding(mesh, P("reads"))
    repl_sh = NamedSharding(mesh, P())
    qg = jax.make_array_from_process_local_data(batch_sh, q[
        pid * (B // nprocs):(pid + 1) * (B // nprocs)], (B, LQ))
    offg = jax.make_array_from_process_local_data(batch_sh, off[
        pid * (B // nprocs):(pid + 1) * (B // nprocs)], (B, LQ + 1))
    qleng = jax.make_array_from_process_local_data(batch_sh, qlen[
        pid * (B // nprocs):(pid + 1) * (B // nprocs)], (B,))
    tg = jax.device_put(t, repl_sh)
    tleng = jax.device_put(tlen, repl_sh)

    step = make_sharded_align_step(mesh, width=WIDTH, mode=dp.GLOBAL,
                                   params_tuple=params)
    for _ in range(WARMUP):
        g, b = step(qg, tg, offg, qleng, tleng)
        jax.block_until_ready((g, b))
    t0 = time.time()
    for _ in range(ITERS):
        g, b = step(qg, tg, offg, qleng, tleng)
        jax.block_until_ready((g, b))
    wall = time.time() - t0
    if pid == 0:
        cells = ITERS * B * LQ * WIDTH
        with open(out_path, "w") as f:
            json.dump({"nprocs": nprocs, "wall_s": wall,
                       "cells": cells,
                       "mcells_per_s": cells / wall / 1e6}, f)
        print(f"nprocs={nprocs}: {wall:.2f}s "
              f"({cells / wall / 1e6:.1f} Mcell-slots/s)")


def _env() -> dict:
    env = dict(os.environ)
    env.update({
        "JAX_PLATFORMS": "cpu",
        "XLA_FLAGS": "--xla_force_host_platform_device_count=1 "
                     "--xla_cpu_multi_thread_eigen=false "
                     "intra_op_parallelism_threads=1",
        "OMP_NUM_THREADS": "1",
        "PYTHONPATH": os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))),
    })
    return env


def main() -> None:
    here = os.path.abspath(__file__)
    env = _env()
    print("== 1 process ==", flush=True)
    subprocess.run([sys.executable, here, "worker", "1", "0",
                    "/tmp/scale_1p.json"], env=env, check=True)
    print("== 2 processes (gloo DCN) ==", flush=True)
    procs = [subprocess.Popen([sys.executable, here, "worker", "2",
                               str(p), "/tmp/scale_2p.json"], env=env)
             for p in range(2)]
    for p in procs:
        if p.wait() != 0:
            raise SystemExit("2-process worker failed")
    with open("/tmp/scale_1p.json") as f:
        r1 = json.load(f)
    with open("/tmp/scale_2p.json") as f:
        r2 = json.load(f)
    eff = r1["wall_s"] / (2 * r2["wall_s"])
    out = {
        "workload": {"B": B, "LQ": LQ, "LT": LT, "width": WIDTH,
                     "iters": ITERS},
        "one_process": r1, "two_process": r2,
        "scaling_efficiency": round(eff, 3),
        "backend": "cpu x1 device/process, gloo collectives (fake DCN)",
    }
    path = os.path.join(os.path.dirname(os.path.dirname(here)),
                        "SCALING.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "worker":
        worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    else:
        main()
