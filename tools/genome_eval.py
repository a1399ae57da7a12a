"""Genome-scale evaluation: simulated D. melanogaster-like chromosome.

Builds a repeat-dense genome (planted reference TE copies at varying
divergence + tandem repeats), plants non-reference TE insertions (hom and
het, with TSDs), simulates noisy long reads at a target coverage, runs the
FULL pipeline, and scores calls against the planted truth:

  F1 over insertions (call within +-100bp of truth, family must match),
  reads/s (stage-1), loci/s (assembly..liftover), stage wall-clock table.

This is the BASELINE.md ">=0.95 F1 on D. melanogaster" stand-in that can
run hermetically (no external data in the container) — the repeat
structure, error profile (~10% indel-heavy PacBio CLR) and coverage match
the reference's target regime (reference README.md:22,38).

Usage: python tools/genome_eval.py [--size 5000000] [--coverage 30]
           [--n-ins 30] [--seed 0] [--out GENOME_EVAL.json] [--wavefront]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def make_te_library(rng, hard=False) -> dict:
    """TE consensus families, dmel-like lengths.

    hard=True (VERDICT r4 #6 "eval realism"): the library gains real
    TE-like discrimination structure —
      * 2-3 diverged subfamilies per family at ~85-95% identity
        (named `fam__k`; `fam__0` is the ancestor), the regime where
        RepeatMasker has to discriminate close relatives
        (reference TELR_te.py:267-370);
      * a shared, diverged ~400bp block between copia and roo
        (LTR-family-style inter-family homology);
    the matching hard genome (make_genome(hard=True)) adds 5'-truncated
    LINE copies and satellite arrays."""
    base = {
        "jockey": rng.integers(0, 4, 5000).astype(np.int8),
        "copia": rng.integers(0, 4, 5100).astype(np.int8),
        "roo": rng.integers(0, 4, 9000).astype(np.int8),
        "P-element": rng.integers(0, 4, 2900).astype(np.int8),
        "INE-1": rng.integers(0, 4, 600).astype(np.int8),
    }
    if not hard:
        return base
    shared = rng.integers(0, 4, 400).astype(np.int8)
    base["copia"][100:500] = shared
    base["roo"][200:600] = _point_sub(shared, 0.20, rng)
    lib = {}
    for fam, cons in base.items():
        k = 3 if len(cons) >= 3000 else 2
        for si in range(k):
            sub = cons if si == 0 else _diverge(cons, 0.05 * si, rng)
            lib[f"{fam}__{si}"] = sub
    return lib


def base_family(name: str) -> str:
    """`fam__k` subfamily -> base family (hard library); identity
    otherwise."""
    return str(name).split("__")[0]


def _point_sub(codes, rate, rng):
    """Substitution-only divergence (length-preserving)."""
    out = codes.copy()
    m = rng.random(len(out)) < rate
    idx = np.nonzero(m)[0]
    out[idx] = (out[idx] + 1 + rng.integers(0, 3, idx.size)) % 4
    return out


def _mutate(codes, rate, rng, p_sub, p_ins, ins_extra, del_extra):
    """Vectorized point-process mutator: per-position events split into
    substitution / insertion-after / deletion-run classes.  The former
    per-base Python loops made 140Mb-scale simulation take an hour."""
    n = len(codes)
    ev = rng.random(n) < rate
    r = rng.random(n)
    sub_m = ev & (r < p_sub)
    ins_m = ev & (r >= p_sub) & (r < p_sub + p_ins)
    del_m = ev & (r >= p_sub + p_ins)
    out = codes.copy()
    si = np.nonzero(sub_m)[0]
    out[si] = (codes[si] + 1 + rng.integers(0, 3, si.size)) % 4
    counts = np.ones(n, np.int64)
    di = np.nonzero(del_m)[0]
    counts[di] = 0
    if del_extra and di.size:
        dext = rng.integers(0, del_extra + 1, di.size)
        for k in range(1, del_extra + 1):
            dk = di[dext >= k] + k
            counts[dk[dk < n]] = 0
    ii = np.nonzero(ins_m)[0]
    # an insertion site swallowed by a preceding deletion run loses its
    # event (the loop form's cursor skipped it too)
    ii = ii[counts[ii] == 1]
    if ii.size:
        ilen = 1 + rng.integers(0, ins_extra + 1, ii.size)
        counts[ii] += ilen
    rep = np.repeat(out, counts)
    if ii.size:
        tot = int(ilen.sum())
        starts = np.cumsum(counts) - counts
        base = np.repeat(starts[ii] + 1, ilen)
        offs = np.arange(tot) - np.repeat(np.cumsum(ilen) - ilen, ilen)
        rep[base + offs] = rng.integers(0, 4, tot)
    return rep.astype(np.int8)


def _diverge(codes, rate, rng):
    return _mutate(codes, rate, rng, p_sub=0.8, p_ins=0.1,
                   ins_extra=2, del_extra=2)


def make_genome(size, library, rng, repeat_density=0.15, hard=False):
    """Random background + planted (diverged, often truncated) ref TE
    copies up to ~repeat_density of the sequence + tandem patches.

    hard=True: LINE-family (jockey) genomic copies are predominantly
    5'-TRUNCATED (the incomplete-reverse-transcription signature — only
    the 3' end survives), and a few hundred-copy satellite arrays are
    planted (the centromeric background RepeatMasker's -nolow would
    normally suppress)."""
    genome = rng.integers(0, 4, size).astype(np.int8)
    placed = 0
    target = int(size * repeat_density)
    fams = list(library)
    while placed < target:
        fam = fams[int(rng.integers(0, len(fams)))]
        te = library[fam]
        div = float(rng.uniform(0.02, 0.25))
        copy = _diverge(te, div, rng)
        if hard and base_family(fam) == "jockey":
            # LINE 5'-truncation: keep the 3' end, cut 20-90% of the 5'
            if rng.random() < 0.8:
                cut = int(rng.integers(len(copy) // 10,
                                       (len(copy) * 4) // 5))
                copy = copy[cut:]
        elif rng.random() < 0.5:  # truncated copy
            cut = int(rng.integers(len(copy) // 4, len(copy)))
            copy = copy[-cut:] if rng.random() < 0.5 else copy[:cut]
        if rng.random() < 0.5:  # minus strand
            copy = (3 - copy)[::-1].copy()
        pos = int(rng.integers(0, size - len(copy)))
        genome[pos:pos + len(copy)] = copy
        placed += len(copy)
    # tandem/low-complexity patches
    for _ in range(max(1, size // 200_000)):
        unit = rng.integers(0, 4, int(rng.integers(2, 12))).astype(np.int8)
        n = int(rng.integers(20, 200))
        patch = np.tile(unit, n)
        pos = int(rng.integers(0, size - len(patch)))
        genome[pos:pos + len(patch)] = patch
    if hard:
        # satellite arrays: a 359bp unit (dmel 1.688-family-like) tiled
        # 40-150x with per-copy substitution jitter
        unit = rng.integers(0, 4, 359).astype(np.int8)
        for _ in range(max(1, size // 3_000_000)):
            n = int(rng.integers(40, 150))
            arr = np.concatenate(
                [_point_sub(unit, 0.03, rng) for _ in range(n)])
            if len(arr) < size - 1000:
                pos = int(rng.integers(0, size - len(arr)))
                genome[pos:pos + len(arr)] = arr
    return genome


def plant_insertions(genome, library, n_ins, rng):
    """Returns the truth list (pos/family/strand/tsd/len/zygosity/te);
    haplotype sequences are built later in simulate_reads.  Insertions
    are near-intact TE copies (0-5% divergence) with 4-12bp TSDs;
    ~40% heterozygous."""
    size = len(genome)
    fams = list(library)
    sites = np.sort(rng.choice(
        np.arange(50_000, size - 50_000), n_ins, replace=False))
    # enforce spacing
    keep = [sites[0]]
    for s in sites[1:]:
        if s - keep[-1] > 20_000:
            keep.append(s)
    truth = []
    for pos in keep:
        fam = fams[int(rng.integers(0, len(fams)))]
        te = _diverge(library[fam], float(rng.uniform(0.0, 0.05)), rng)
        if rng.random() < 0.5:
            te = (3 - te)[::-1].copy()
            strand = "-"
        else:
            strand = "+"
        tsd = int(rng.integers(4, 13))
        zyg = "het" if rng.random() < 0.4 else "hom"
        truth.append({"pos": int(pos), "family": fam, "strand": strand,
                      "tsd": tsd, "len": int(len(te)), "zygosity": zyg,
                      "te": te})
    return truth


def simulate_reads(genome, truth, coverage, rng, read_len_mean=9000,
                   err=0.10, ont_profile=False):
    """Reads drawn from a diploid sample: haplotype A carries every
    insertion, haplotype B only the homozygous ones — so "hom" sites are
    on both haplotypes and "het" sites on one.  PacBio-CLR-like errors
    (~10%: 40% ins / 35% del / 25% sub).  ont_profile switches to an
    ONT-like mix (~12%, deletion-dominated: 25% ins / 55% del / 20% sub,
    with occasional longer deletion runs — the homopolymer failure mode)
    and a wider, longer read-length distribution (reference map-ont
    target, TELR_alignment.py:56-65)."""
    if ont_profile:
        err = 0.12
        p_sub, p_ins = 0.20, 0.25
        ins_extra, del_extra = 1, 3
        len_cap = 40000
    else:
        p_sub, p_ins = 0.25, 0.40
        ins_extra, del_extra = 1, 1
        len_cap = 20000
    def build_hap(subset):
        cuts, segs = 0, []
        for t in subset:
            segs.append(genome[cuts:t["pos"]])
            segs.append(np.concatenate(
                [t["te"],
                 genome[t["pos"] - t["tsd"]:t["pos"]]]))  # TE + TSD dup
            cuts = t["pos"]
        segs.append(genome[cuts:])
        return np.concatenate(segs)

    hap_a = build_hap(truth)
    hap_b = build_hap([t for t in truth if t["zygosity"] == "hom"])
    haplos = [hap_a, hap_b]
    sources = []  # (hap_idx, start, end) per read, for diagnostics

    total_bases = int(coverage) * len(genome)
    reads = []
    made = 0
    k = 0
    while made < total_bases:
        L = int(np.clip(rng.normal(read_len_mean, read_len_mean // 3),
                        2000, len_cap))
        # het sites exist only on hap A; sample haplotypes 50/50
        hap_idx = int(rng.integers(0, 2))
        hap = haplos[hap_idx]
        if L >= len(hap):
            L = len(hap) // 2
        start = int(rng.integers(0, len(hap) - L))
        sources.append((hap_idx, start, start + L))
        codes = _mutate(hap[start:start + L], err, rng,
                        p_sub=p_sub, p_ins=p_ins, ins_extra=ins_extra,
                        del_extra=del_extra)
        if rng.random() < 0.5:
            codes = (3 - codes)[::-1].copy()
        reads.append((f"read{k}", codes))
        made += len(codes)
        k += 1
    simulate_reads.last_sources = sources
    simulate_reads.last_hap_lens = [len(h) for h in haplos]
    return reads


def score_calls(final_report, truth, window=100):
    tp, used = 0, set()
    fp_calls = []
    quality = []   # per-TP call-quality records
    for call in final_report:
        hit = None
        for ti, t in enumerate(truth):
            if ti in used:
                continue
            # a call's [start, end] spans its breakpoint uncertainty (wide
            # flank gaps report the whole gap, TELR get_coord) — match the
            # truth against the interval, padded by the window
            call_fams = str(call["family"]).split("|")
            fam_ok = (t["family"] in call_fams
                      or base_family(t["family"]) in
                      {base_family(f) for f in call_fams})
            if (call["start"] - window <= t["pos"] <= call["end"] + window
                    and t.get("chrom", call["chrom"]) == call["chrom"]
                    and fam_ok):
                hit = ti
                break
        if hit is None:
            fp_calls.append((call["chrom"], call["start"], call["family"]))
        else:
            used.add(hit)
            tp += 1
            t = truth[hit]
            te_len = len(call.get("te_sequence") or "")
            gt = call.get("genotype")
            quality.append({
                "pos_err": int(min(abs(call["start"] - t["pos"]),
                                   abs(call["end"] - t["pos"]))),
                "len_err": abs(te_len - t["len"]) / t["len"],
                "tsd_found": call.get("tsd_length") is not None,
                "tsd_err": (abs(int(call["tsd_length"]) - t["tsd"])
                            if call.get("tsd_length") is not None else None),
                "zyg_ok": (gt == "1/1") == (t["zygosity"] == "hom"),
                "strand_ok": call.get("strand") == t["strand"],
                # subfamily-exact assignment (hard library: fam__k names;
                # trivially exact when the library has no subfamilies)
                "fam_exact": t["family"] in
                             str(call["family"]).split("|"),
            })
    fn = len(truth) - tp
    fp = len(fp_calls)
    fn_sites = [{k: t[k] for k in ("pos", "family", "zygosity", "tsd")
                 if k in t}
                for ti, t in enumerate(truth) if ti not in used]
    prec = tp / (tp + fp) if tp + fp else 0.0
    rec = tp / (tp + fn) if tp + fn else 0.0
    f1 = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
    qsum = {}
    if quality:
        tsd_errs = [q["tsd_err"] for q in quality if q["tsd_err"] is not None]
        qsum = {
            "median_pos_err": float(np.median([q["pos_err"]
                                               for q in quality])),
            "median_len_err": round(float(np.median(
                [q["len_err"] for q in quality])), 4),
            "tsd_recovered": round(sum(q["tsd_found"]
                                       for q in quality) / len(quality), 4),
            "tsd_exact": round(sum(1 for e in tsd_errs if e == 0)
                               / max(1, len(tsd_errs)), 4),
            "zygosity_acc": round(sum(q["zyg_ok"]
                                      for q in quality) / len(quality), 4),
            "strand_acc": round(sum(q["strand_ok"]
                                    for q in quality) / len(quality), 4),
            "family_exact": round(sum(q["fam_exact"]
                                      for q in quality) / len(quality), 4),
        }
    return {"tp": tp, "fp": fp, "fn": fn, "precision": round(prec, 4),
            "recall": round(rec, 4), "f1": round(f1, 4),
            "fp_calls": fp_calls[:20], "fn_sites": fn_sites[:20],
            "call_quality": qsum}


def simulate_dataset(size=5_000_000, coverage=30, n_ins=30, seed=0,
                     workdir=None, read_len=9000, chroms=1,
                     ont_profile=False, hard=False):
    """Simulate (reference, reads, library) fastas + truth; returns
    (ref_fa, reads_fa, lib_fa, truth, n_reads, n_bases).  Shared by the
    single-process eval below and the multi-process scaling harness
    (tools/two_process_pipeline.py)."""
    from telr_jax.io.fasta import write_fasta
    from telr_jax.io.seqs import SeqDict, Sequence

    rng = np.random.default_rng(seed)
    t0 = time.time()
    library = make_te_library(rng, hard=hard)
    # multi-chromosome genomes exercise per-chrom flank filtering,
    # cross-chrom homology and dedup at scale (real dmel runs are 5+)
    ref_seqs, truth, reads = [], [], []
    for ci in range(chroms):
        cname = f"chr{ci + 1}" if chroms > 1 else "chr2L"
        genome = make_genome(size // chroms, library, rng, hard=hard)
        ctruth = plant_insertions(genome, library,
                                  max(1, n_ins // chroms), rng)
        creads = simulate_reads(genome, ctruth, coverage, rng,
                                read_len_mean=read_len,
                                ont_profile=ont_profile)
        for t in ctruth:
            t["chrom"] = cname
        truth.extend(ctruth)
        ref_seqs.append(Sequence(cname, genome))
        reads.extend((f"c{ci}_{n}", c) for n, c in creads)
    sim_s = time.time() - t0
    n_bases = sum(len(c) for _, c in reads)
    print(f"simulated: genome {size / 1e6:.1f}Mb x{chroms} chroms, "
          f"{len(truth)} insertions, {len(reads)} reads "
          f"({n_bases / 1e6:.0f}Mb) in {sim_s:.0f}s", flush=True)

    import tempfile
    workdir = workdir or tempfile.mkdtemp(prefix="telr_eval")
    os.makedirs(workdir, exist_ok=True)
    ref_fa = os.path.join(workdir, "ref.fa")
    reads_fa = os.path.join(workdir, "reads.fa")
    lib_fa = os.path.join(workdir, "lib.fa")
    write_fasta(SeqDict(ref_seqs), ref_fa)
    write_fasta(SeqDict([Sequence(n, c) for n, c in reads]), reads_fa)
    write_fasta(SeqDict([Sequence(n, c) for n, c in library.items()]),
                lib_fa)
    return ref_fa, reads_fa, lib_fa, truth, len(reads), n_bases


def run_eval(size=5_000_000, coverage=30, n_ins=30, seed=0,
             use_wavefront=False, out_path="GENOME_EVAL.json",
             workdir=None, read_len=9000, threads=1, chroms=1,
             ont_profile=False, wavefront_stages=None, hard=False):
    from telr_jax.utils.procpool import ensure_forkserver
    ensure_forkserver()   # before jax spins up threads (see procpool.py)
    from telr_jax.utils.runtime import init_compile_cache
    init_compile_cache()
    from telr_jax.config import TELRConfig, SVConfig
    from telr_jax.pipeline import run_pipeline

    import tempfile
    workdir = workdir or tempfile.mkdtemp(prefix="telr_eval")
    ref_fa, reads_fa, lib_fa, truth, n_reads, n_bases = simulate_dataset(
        size, coverage, n_ins, seed, workdir, read_len, chroms,
        ont_profile=ont_profile, hard=hard)
    cfg = TELRConfig(sv=SVConfig(min_support=max(3, coverage // 8)),
                     use_wavefront=use_wavefront, threads=threads,
                     wavefront_stages=wavefront_stages,
                     presets="ont" if ont_profile else "pacbio")
    cfg.validate()   # a typo'd --wavefront-stages must fail loudly, not
    # silently route nothing to the device while the output JSON records
    # use_wavefront=true (ADVICE r4: benchmark provenance)
    t0 = time.time()
    res = run_pipeline(reads_fa, ref_fa, lib_fa,
                       os.path.join(workdir, "out"), cfg,
                       checkpoint_dir=os.path.join(workdir, "ckpt"))
    pipe_s = time.time() - t0

    score = score_calls(res.final_report, truth)
    restored = set(getattr(res, "restored_stages", []))
    # a checkpoint-restored stage's wall time is a JSON load, not compute —
    # report no throughput rather than a fantasy number
    align_s = (float("nan") if "alignment" in restored
               else res.stage_seconds.get("alignment", float("nan")))
    locus_stages = (0.0 if "assembly" in restored
                    else sum(res.stage_seconds.get(k, 0.0) for k in
                             ("assembly", "annotate_contig",
                              "allele_frequency", "liftover")))
    report = {
        "workload": {"genome_mb": size / 1e6, "coverage": coverage,
                     "n_reads": n_reads, "read_mb": n_bases / 1e6,
                     "n_truth": len(truth), "seed": seed,
                     "read_len_mean": read_len,
                     "ont_profile": ont_profile,
                     "hard_library": hard,
                     "use_wavefront": use_wavefront,
                     "wavefront_stages": (list(wavefront_stages)
                                          if wavefront_stages else None)},
        "score": score,
        "throughput": {
            "reads_per_s": round(n_reads / align_s, 2)
            if align_s == align_s else None,
            "read_mb_per_s": round(n_bases / 1e6 / align_s, 3)
            if align_s == align_s else None,
            "loci_per_s": round(len(res.records) / locus_stages, 3)
            if locus_stages else None,
        },
        "restored_stages": sorted(restored),
        "stage_seconds": {k: round(v, 2)
                          for k, v in res.stage_seconds.items()},
        "wall_s": round(pipe_s, 1),
        "n_calls": len(res.final_report),
    }
    with open(out_path, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report["score"]))
    print(json.dumps(report["throughput"]))
    return report


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=5_000_000)
    ap.add_argument("--coverage", type=int, default=30)
    ap.add_argument("--n-ins", type=int, default=30)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="GENOME_EVAL.json")
    ap.add_argument("--wavefront", action="store_true")
    ap.add_argument("--wavefront-stages", default=None,
                    help="comma list: route only these stages' DPs to "
                         "the device (implies --wavefront for them)")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--read-len", type=int, default=9000)
    ap.add_argument("--threads", type=int, default=1)
    ap.add_argument("--chroms", type=int, default=1)
    ap.add_argument("--ont", action="store_true",
                    help="ONT-like error profile + MAP_ONT preset")
    ap.add_argument("--hard-library", action="store_true",
                    help="harder TE library: diverged subfamilies, "
                         "inter-family homology, 5'-truncated LINE "
                         "copies, satellite arrays (VERDICT r4 #6)")
    a = ap.parse_args()
    stages = (tuple(x.strip() for x in a.wavefront_stages.split(","))
              if a.wavefront_stages else None)
    run_eval(a.size, a.coverage, a.n_ins, a.seed,
             a.wavefront or bool(stages), a.out,
             a.workdir, read_len=a.read_len, threads=a.threads,
             chroms=a.chroms, ont_profile=a.ont, wavefront_stages=stages,
             hard=a.hard_library)
