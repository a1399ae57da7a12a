#!/usr/bin/env python3
"""Smoke test of telr_jax on one NVIDIA GPU.

Run from the repository root:

    python chip_smoke.py               # one GPU: phases 1-3 below
    python chip_smoke.py --four-cards  # four GPUs: the mesh path only

Phases (one process; any failure exits non-zero):

  1. environment: device kind and count, the card's name and power limit,
     the compile-cache directory, the native host engine and the CUDA
     wavefront library (loaded or built, and build seconds);
  2. kernels at real widths: pairs cut from the smoke dataset's reads and
     reference windows at W = 128, 512 and 2048 in GLOBAL, EXTEND and
     LOCAL.  The CUDA DP and walk must equal the XLA form bit for bit
     (scores, direction bytes, op codes), and the full-band pairs the
     native host engine's optimum; every CIGAR must span its interval and
     re-score to its score.  Times of both forms at the mapper's chunk
     shapes; the device pileup vote against its numpy reference;
  3. end to end: a 3 Mb / 30x PacBio-like dataset (tools/genome_eval.py,
     seed 3) through telr_jax.cli.main with the default --wavefront auto,
     scored against the simulator's truth.

--four-cards runs the same dataset with --mesh_devices 4 and with
--mesh_devices 1 in one process, requires identical VCF and BED outputs,
and prints each card's peak memory.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
Without a GPU the script exits non-zero and prints no such line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
DATASET = dict(size=3_000_000, coverage=30, n_ins=12, seed=3)


def _say(*parts) -> None:
    print(*parts, flush=True)


def _fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        _fail(msg)


# ----------------------------------------------------------------------
# phase 1

def phase_environment(n_cards: int) -> dict:
    import jax
    from telr_jax.utils.runtime import init_compile_cache
    devs = jax.devices()
    if devs[0].platform != "gpu":
        _fail(f"needs an NVIDIA GPU; JAX found platform "
              f"{devs[0].platform!r}")
    if len(devs) < n_cards:
        _fail(f"needs {n_cards} GPUs; JAX found {len(devs)}")
    cache = init_compile_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    _check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    _say("== phase 1: environment")
    _say(f"device: {devs[0].platform} {devs[0].device_kind} "
         f"x{len(devs)}")
    _say(f"nvidia-smi name, power.limit: "
         f"{smi.stdout.strip().splitlines()[0]}")
    _say(f"compile cache: {cache}")
    from telr_jax.io import native
    t0 = time.perf_counter()
    lib = native.load()
    _check(lib is not None and native.has_banded_dp()
           and native.has_wave_decode(),
           "native host engine (native/libtelr_native.so) did not load")
    _say(f"native host engine: loaded ({time.perf_counter() - t0:.2f} s "
         "incl. any build)")
    from telr_jax.kernels import cuda_wave
    t0 = time.perf_counter()
    cuda_wave.load()
    built = cuda_wave.build_seconds
    _say(f"CUDA wavefront library: loaded ({time.perf_counter() - t0:.2f} "
         f"s; " + (f"built in {built:.2f} s" if built is not None
                   else "prebuilt") + ")")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


# ----------------------------------------------------------------------
# phase 2

def _dataset(workdir: str):
    sys.path.insert(0, os.path.join(HERE, "tools"))
    from genome_eval import simulate_dataset
    return simulate_dataset(workdir=workdir, **DATASET)


def _region_pieces(ref_fa: str, reads_fa: str, n_reads: int):
    """The GLOBAL chain-region pieces (query, target window, anchor guide)
    the stage-1 mapper builds for the first reads of the dataset."""
    import dataclasses
    from telr_jax.config import MAP_PB
    from telr_jax.io.fasta import read_fasta
    from telr_jax.kernels.mapper import Aligner
    ref = read_fasta(ref_fa)
    reads = read_fasta(reads_fa)
    al = Aligner(ref, dataclasses.replace(MAP_PB, chain_prune_frac=0.5))
    pieces = []
    for s in list(reads)[:n_reads]:
        for chain, s_id, st, _primary in al._plan(s.codes):
            p, _geom = al._chain_pieces(s.codes, chain, s_id, st)
            q, t, _mode, _w, guide = p["region"]
            if len(q) and len(t):
                pieces.append((q, t, guide))
    return pieces


def _rescore_ok(q, t, r, mode, params) -> bool:
    """The CIGAR spans [qstart, qend) x [tstart, tend) (the whole pair for
    GLOBAL) and re-scores to the reported score."""
    import numpy as np
    from telr_jax.kernels import dp
    ops, lens = dp.cigar_to_arrays(r["cigar"])
    qi, tj = r["qstart"], r["tstart"]
    nm, ni, nd, _ = dp.cigar_arrays_stats((ops, lens))
    if nm + ni != r["qend"] - qi or nm + nd != r["tend"] - tj:
        return False
    if mode == dp.GLOBAL and (r["qend"], r["tend"], qi, tj) != \
            (len(q), len(t), 0, 0):
        return False
    score = 0
    for op, ln in zip(ops.tolist(), lens.tolist()):
        if op == 0:
            a, b = q[qi:qi + ln], t[tj:tj + ln]
            amb = (a == 4) | (b >= 4)
            score += int(np.where(amb, params.ambig, np.where(
                a == b, params.match, -params.mismatch)).sum())
            qi += ln
            tj += ln
        else:
            score -= params.gap_open + params.gap_extend * ln
            if op == 2:
                qi += ln
            else:
                tj += ln
    return score == r["score"]


def _time(fn, reps=3):
    import jax
    jax.block_until_ready(fn())            # compile + warm
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2]


def phase_kernels(ref_fa: str, reads_fa: str) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np
    from telr_jax.kernels import cuda_wave, dp
    from telr_jax.kernels import wave_align as wa
    _say("== phase 2: kernels at real widths")
    params = dp.DPParams()
    pt = params.tuple()
    pieces = _region_pieces(ref_fa, reads_fa, 160)
    _check(len(pieces) >= 64, f"only {len(pieces)} region pieces")
    _say(f"region pieces: {len(pieces)}, mean length "
         f"{np.mean([len(q) for q, _t, _g in pieces]):.0f}")
    dp_x = jax.jit(wa.xla_dp, static_argnames=("width", "mode",
                                                "params_tuple"))
    dp_c = jax.jit(cuda_wave.cuda_dp, static_argnames=("width", "mode",
                                                        "params_tuple"))

    @jax.jit
    def same_dirs(a, b, meta_len):
        steps = jnp.arange(a.shape[1])[None, :, None]
        return jnp.all((a == b) | (steps >= meta_len[:, None, None]))

    # parity at real widths: 24 pieces per width, every mode
    for width in (128, 512, 2048):
        sub = pieces[:24]
        pairs = [(q, t) for q, t, _g in sub]
        guides = [g for _q, _t, g in sub]
        b = wa.prepare_wavefront_batch(pairs, width, guides, light=True)
        lens = jnp.asarray(b.scal[:, 0] + b.scal[:, 1])
        for mode in (dp.GLOBAL, dp.EXTEND, dp.LOCAL):
            rx, dx = dp_x(b.meta, b.qw, b.tw, b.scal, width=width,
                          mode=mode, params_tuple=pt)
            rc, dc = dp_c(b.meta, b.qw, b.tw, b.scal, width=width,
                          mode=mode, params_tuple=pt)
            _check(np.array_equal(np.asarray(rx), np.asarray(rc)),
                   f"CUDA vs XLA scores differ (W={width}, mode={mode})")
            _check(bool(same_dirs(dx, dc, lens)),
                   f"CUDA vs XLA direction bytes differ (W={width}, "
                   f"mode={mode})")
            ref = [np.asarray(a) for a in wa.fused_step(
                b.meta, b.qw, b.tw, b.scal, width=width, mode=mode,
                params_tuple=pt, impl=wa.XLA_IMPL)]
            got = [np.asarray(a) for a in wa.fused_step(
                b.meta, b.qw, b.tw, b.scal, width=width, mode=mode,
                params_tuple=pt, impl=wa.GPU_IMPL)]
            _check(all(np.array_equal(x, y) for x, y in zip(ref, got)),
                   f"CUDA vs XLA walk differs (W={width}, mode={mode})")
            res = wa.wavefront_align(pairs, width, mode, params,
                                     guides=guides, cigar_arrays=True)
            bad = [i for i, ((q, t), r) in enumerate(zip(pairs, res))
                   if not r.get("failed")
                   and not _rescore_ok(q, t, r, mode, params)]
            _check(not bad, f"CIGARs that do not re-score: W={width} "
                            f"mode={mode} pairs {bad[:5]}")
            n_failed = sum(1 for r in res if r.get("failed"))
            _say(f"  W={width:5d} mode={mode}: scores, dirs, walk identical "
                 f"to the XLA form; {len(pairs) - n_failed} CIGARs "
                 f"re-score ({n_failed} band escapes)")
        # full-band windows: CUDA == native host engine == Gotoh optimum
        rng = np.random.default_rng(width)
        full = []
        for q, t, _g in pieces[24:40]:
            lt = min(len(t), width - 16)
            o = int(rng.integers(0, len(t) - lt + 1))
            tt = t[o:o + lt]
            full.append((tt[: max(8, lt - 24)].copy(), tt.copy()))
        for mode in (dp.GLOBAL, dp.EXTEND, dp.LOCAL):
            got = wa.wavefront_align(full, width, mode, params)
            want = dp.align_pairs(
                [(q, t, mode, params, dp._bucket(len(t) + 1), None)
                 for q, t in full], want_cigar=False)
            _check([r["score"] for r in got] == [r["score"] for r in want],
                   f"CUDA vs native engine scores differ (W={width}, "
                   f"mode={mode})")
        _say(f"  W={width:5d}: {len(full)} full-band windows, scores equal "
             "the native host engine's in every mode")

    # memory of the fused step at the largest stage-1 shape
    b = wa.prepare_wavefront_batch([(q, t) for q, t, _g in pieces[:8]], 2048,
                                   [g for _q, _t, g in pieces[:8]],
                                   light=True)
    comp = wa.fused_step.lower(b.meta, b.qw, b.tw, b.scal, width=2048,
                               mode=dp.GLOBAL, params_tuple=pt,
                               impl=wa.GPU_IMPL).compile()
    _say(f"fused step memory_analysis (W=2048, n=8, S={b.meta.shape[1]}): "
         f"{comp.memory_analysis()}")

    # times at the mapper's chunk shapes (dirs budget from device memory)
    _say(f"dirs budget per chunk: {wa._dirs_budget()} bytes")
    exts = []
    for q, t, _g in pieces:
        for o in range(0, min(len(q), len(t)) - 704, 512):
            exts.append((q[o:o + 512], t[o:o + 704]))
    by_bucket = {}
    for p in pieces:
        by_bucket.setdefault(wa._sbucket(len(p[0]) + len(p[1])), []).append(p)
    modal = max(by_bucket, key=lambda sp: len(by_bucket[sp]))
    _say("region pieces per step bucket: " + json.dumps(
        {sp: len(v) for sp, v in sorted(by_bucket.items())}))
    shapes = [(128, "ext", exts, 2048)]
    shapes += [(w, "region", by_bucket[modal], modal) for w in (128, 512, 2048)]
    if modal != 32768 and len(by_bucket.get(32768, [])) >= 8:
        shapes.append((128, "region", by_bucket[32768], 32768))
    for width, kind, src, sp in shapes:
        per = [len(sel) for sel, s in wa.plan_chunks(
            [sp - 1] * 8192, width)][0]
        n = per
        sel = [src[i % len(src)] for i in range(n)]
        pairs = [(p[0], p[1]) for p in sel]
        guides = [p[2] for p in sel] if kind == "region" else None
        b = wa.prepare_wavefront_batch(pairs, width, guides, s_pad=sp,
                                       light=True)
        args = [jax.device_put(a) for a in (b.meta, b.qw, b.tw, b.scal)]
        cells = sum(len(q) + len(t) for q, t in pairs) * width
        row = {}
        for name, impl in (("xla", wa.XLA_IMPL), ("cuda", wa.GPU_IMPL),
                           ("cuda_dp+xla_walk", ("cuda", "xla"))):
            f_dp = dp_c if impl[0] == "cuda" else dp_x
            t_dp = _time(lambda: f_dp(*args, width=width, mode=dp.GLOBAL,
                                      params_tuple=pt))
            t_all = _time(lambda: wa.fused_step(
                *args, width=width, mode=dp.GLOBAL, params_tuple=pt,
                impl=impl))
            row[name] = (t_dp, t_all)
        _say(f"  time W={width} {kind} n={n} S_pad={b.meta.shape[1]} "
             f"cells={cells}: " + "; ".join(
                 f"{k}: dp {v[0] * 1e3:.2f} ms, dp+walk {v[1] * 1e3:.2f} ms"
                 for k, v in row.items())
             + f"; cuda dp {cells / row['cuda'][0] / 1e9:.1f} Gcells/s")

    # the device pileup vote at assembly width against its numpy reference
    _vote_parity()


def _vote_parity() -> None:
    import numpy as np
    from telr_jax.assembly.device_vote import vote_many
    from telr_jax.assembly.local import consensus_vote
    from telr_jax.config import MAP_PB
    from telr_jax.io.seqs import SeqDict, Sequence, revcomp_codes
    from telr_jax.kernels.mapper import Aligner
    rng = np.random.default_rng(5)
    items = []
    for bb_len, n_reads in ((14000, 30), (9000, 24)):
        backbone = rng.integers(0, 4, bb_len).astype(np.int8)
        reads = {}
        for i in range(n_reads):
            lo = int(rng.integers(0, bb_len // 4))
            hi = int(rng.integers(3 * bb_len // 4, bb_len))
            r = backbone[lo:hi].copy()
            idx = rng.integers(0, len(r), len(r) // 12)
            r[idx] = rng.integers(0, 4, idx.size)
            if i % 2 == 0:
                mid = len(r) // 2
                r = np.concatenate([r[:mid], rng.integers(
                    0, 4, 40).astype(np.int8), r[mid:]])
            if i % 3 == 2:
                r = revcomp_codes(r)
            reads[f"r{i}"] = r.astype(np.int8)
        al = Aligner(SeqDict([Sequence("bb", backbone)]), MAP_PB)
        alns = []
        for name, hits in al.map_batch(reads).items():
            prim = [h for h in hits if h.primary]
            if prim:
                alns.append((max(prim, key=lambda h: h.score), reads[name]))
        items.append((backbone, alns))
    got = vote_many(items)
    for (bb, alns), dev in zip(items, got):
        _check(np.array_equal(dev, consensus_vote(bb, alns)),
               "device pileup vote differs from consensus_vote")
    _say(f"  device pileup vote: {len(items)} loci "
         f"({', '.join(str(len(bb)) for bb, _a in items)} bp backbones) "
         "identical to the numpy reference")


# ----------------------------------------------------------------------
# phase 3

class _CompileTimer:
    """Sums JAX's compile-duration events (tracing, lowering, backend
    compile) while installed."""

    def __init__(self):
        import jax
        self.seconds = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, **_kw):
        if "/jax/core/compile/" in event:
            self.seconds += duration


def _peak_bytes():
    import jax
    return [int((d.memory_stats() or {}).get("peak_bytes_in_use", 0))
            for d in jax.devices()]


def _run_cli(ref_fa, reads_fa, lib_fa, out, extra=()):
    from telr_jax import cli
    argv = ["-i", reads_fa, "-r", ref_fa, "-l", lib_fa, "-o", out,
            "-t", str(min(8, os.cpu_count() or 1)),
            "--min_support", str(max(3, DATASET["coverage"] // 8))]
    t0 = time.perf_counter()
    res = cli.main(argv + list(extra))
    return res, time.perf_counter() - t0


def phase_end_to_end(ref_fa, reads_fa, lib_fa, truth, n_bases, workdir,
                     compile_timer, setup_s) -> None:
    from genome_eval import score_calls
    _say("== phase 3: end to end through the CLI")
    c0 = compile_timer.seconds
    res, wall = _run_cli(ref_fa, reads_fa, lib_fa,
                         os.path.join(workdir, "out"))
    score = score_calls(res.final_report, truth)
    q = score.get("call_quality", {})
    _say("stage seconds: " + json.dumps(
        {k: round(v, 2) for k, v in res.stage_seconds.items()}))
    _say(f"wall: {wall:.2f} s for {n_bases / 1e6:.1f} Mb of reads "
         f"({n_bases / 1e6 / wall:.3f} read Mb/s)")
    _say(f"set-up: {setup_s:.2f} s before the run (builds, dataset); "
         f"compile inside the run: {compile_timer.seconds - c0:.2f} s")
    _say(f"F1 {score['f1']} (tp {score['tp']}, fp {score['fp']}, "
         f"fn {score['fn']}), tsd_exact {q.get('tsd_exact')}")
    _say("device counters per stage: " + json.dumps(
        {k: v for k, v in res.stage_counters.items() if v}))
    _say(f"peak_bytes_in_use: {_peak_bytes()}")
    _check(score["f1"] >= 0.9, f"F1 {score['f1']} < 0.9")
    _check((q.get("tsd_exact") or 0) >= 0.9,
           f"tsd_exact {q.get('tsd_exact')} < 0.9")
    for stage in ("alignment", "assembly"):
        cells = res.stage_counters.get(stage, {}).get("device_cells", 0)
        _check(cells > 0, f"{stage} sent no DP cells to the device")


def phase_four_cards(ref_fa, reads_fa, lib_fa, workdir) -> None:
    _say("== four cards: --mesh_devices 4 against --mesh_devices 1")
    outs = {}
    for n in (4, 1):
        out = os.path.join(workdir, f"mesh{n}")
        res, wall = _run_cli(ref_fa, reads_fa, lib_fa, out,
                             ["--mesh_devices", str(n)])
        outs[n] = out
        _say(f"mesh_devices={n}: wall {wall:.2f} s, "
             f"{len(res.final_report)} calls, stage seconds "
             + json.dumps({k: round(v, 2)
                           for k, v in res.stage_seconds.items()}))
        _say(f"  peak_bytes_in_use per card after this run: "
             f"{_peak_bytes()}")
    for name in ("reads.telr.vcf", "reads.telr.bed"):
        with open(os.path.join(outs[4], name), "rb") as f4, \
                open(os.path.join(outs[1], name), "rb") as f1:
            a, b = f4.read(), f1.read()
        _check(a == b, f"{name} differs between 4 cards and 1")
        _say(f"{name}: identical ({len(a)} bytes)")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-GPU mesh path")
    args = ap.parse_args()
    if not os.path.isdir(os.path.join(HERE, "telr_jax")):
        _fail("run chip_smoke.py from a checkout of the repository "
              "(telr_jax/ not found beside it)")
    sys.path.insert(0, HERE)
    t_setup = time.perf_counter()
    from telr_jax.utils.procpool import ensure_forkserver
    ensure_forkserver()      # before JAX starts its threads
    compile_timer = _CompileTimer()
    device = phase_environment(4 if args.four_cards else 1)
    with tempfile.TemporaryDirectory(prefix="telr_smoke_") as workdir:
        ref_fa, reads_fa, lib_fa, truth, _n, n_bases = _dataset(workdir)
        if args.four_cards:
            phase_four_cards(ref_fa, reads_fa, lib_fa, workdir)
        else:
            setup_s = time.perf_counter() - t_setup
            phase_kernels(ref_fa, reads_fa)
            phase_end_to_end(ref_fa, reads_fa, lib_fa, truth, n_bases,
                             workdir, compile_timer, setup_s)
    if args.four_cards:
        device["count"] = 4
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()
