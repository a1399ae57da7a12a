"""Per-locus local assembly: backbone + batched-realignment pileup consensus.

Replaces wtdbg2 + wtpoa-cns and the minimap2/wtpoa polish loop (reference
TELR_assembly.py:104-366).  TELR assembles each candidate locus from its
supporting reads (wtdbg2 -x rs -g 30k, then wtpoa-cns, then `polish_iterations`
rounds of realign+consensus).  Here:

  1. backbone selection — the supporting read with the median length (robust
     representative; every SV read contains the insertion),
  2. all supporting reads are aligned to the backbone with the shared DP core,
  3. a pileup vote per backbone column (match/substitution votes, deletion
     votes, insertion sequences keyed by column) produces the consensus,
  4. step 2-3 repeat `polish_iterations` times against the new consensus
     (realign+re-vote == the reference's minimap2 | wtpoa-cns -d polish loop,
     TELR_assembly.py:185-260).

The per-locus result is named `<chr>_<start>_<end>` like the reference's
renamed ctg1 contigs (TELR_assembly.py:82-98).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from telr_jax.config import AlignPreset, AssemblyConfig
from telr_jax.io.seqs import SeqDict, Sequence, encode, revcomp_codes
from telr_jax.kernels.mapper import Aligner, Alignment
from telr_jax.sv.detect import SVRecord
from telr_jax.utils.evallog import LociEval


def _oriented(a: Alignment, codes: np.ndarray) -> Tuple[np.ndarray, int]:
    """Strand-oriented query codes and aligned-region start in that frame."""
    if a.strand == "-":
        return revcomp_codes(codes), a.qlen - a.qend
    return codes, a.qstart


def consensus_vote(backbone: np.ndarray,
                   alignments: List[Tuple[Alignment, np.ndarray]],
                   min_cov: int = 2) -> np.ndarray:
    """Pileup consensus over a backbone.

    alignments: (Alignment vs backbone, original read codes).
    Returns consensus codes.  Ends with coverage < min_cov are trimmed when
    more than two reads support the locus.
    """
    n = len(backbone)
    del_votes = np.zeros(n, dtype=np.int32)
    cov = np.zeros(n, dtype=np.int32)
    ins_seqs: Dict[int, List[np.ndarray]] = {}

    # gather every M-run's (column, base) pairs, then vote with ONE
    # bincount — scattered np.add.at per run was the stage's hottest
    # host op (ufunc.at has no fast path)
    mcols: List[np.ndarray] = []
    mbases: List[np.ndarray] = []
    for a, codes in alignments:
        qc, qi = _oriented(a, codes)
        tj = a.tstart
        for op, ln in a.cigar:
            if op == "M":
                mcols.append(np.arange(tj, tj + ln, dtype=np.int64))
                mbases.append(qc[qi:qi + ln])
                cov[tj:tj + ln] += 1
                qi += ln
                tj += ln
            elif op == "I":
                from telr_jax.assembly.device_vote import leftshift_ins
                js, sq = leftshift_ins(backbone, tj, qc[qi:qi + ln])
                ins_seqs.setdefault(js, []).append(sq)
                qi += ln
            elif op == "D":
                del_votes[tj:tj + ln] += 1
                cov[tj:tj + ln] += 1
                tj += ln
    if mcols:
        flat = (np.concatenate(mcols) * 5
                + np.concatenate(mbases).astype(np.int64))
        base_votes = np.bincount(flat, minlength=n * 5).reshape(n, 5)
        base_votes = base_votes.astype(np.int32)
    else:
        base_votes = np.zeros((n, 5), dtype=np.int32)

    # per-column base/deletion decisions, fully vectorized (the per-column
    # Python loop dominated the assembly stage at genome scale: loci x
    # polish rounds x ~14kb backbones)
    bb = backbone.astype(np.int64)
    col = np.arange(n)
    best = base_votes.argmax(axis=1)
    # tie goes to the backbone base; no votes at all keeps the backbone
    best = np.where(base_votes[col, best] == base_votes[col, bb], bb, best)
    best = np.where(base_votes.sum(axis=1) == 0, bb, best).astype(np.int8)
    keep = ~(del_votes * 2 > cov)

    # trimming + insertion-event splice shared with the device vote path
    from telr_jax.assembly.device_vote import finalize_consensus
    return finalize_consensus(backbone, best, keep, cov, ins_seqs,
                              len(alignments), min_cov)


def assemble_locus(locus_name: str, read_names: List[str], reads: SeqDict,
                   preset: AlignPreset, cfg: AssemblyConfig,
                   use_wavefront: bool = False) -> Optional[Sequence]:
    """Assemble one locus from its supporting reads (single-locus wrapper
    over the batched path)."""
    contigs, passed = _assemble_batch([(locus_name, read_names, [], [])],
                                      reads, preset, cfg, LociEval(),
                                      use_wavefront=use_wavefront)
    return contigs[locus_name] if locus_name in passed else None


def collect_extra_voters(records: List[SVRecord], store,
                         window: int) -> Dict[str, List[str]]:
    """Non-support reads overlapping each locus (the other haplotype +
    flank-only reads); they polish flank columns to full local depth.
    Shared by the pipeline and the standalone stage profiler."""
    out: Dict[str, List[str]] = {}
    for r in records:
        support = set(r.reads)
        near = {a.qname for a in store.fetch(
            r.chrom, r.start - window, r.end + window) if a.primary}
        out[r.locus_name] = sorted(near - support)
    return out


def assemble_all(records: List[SVRecord], reads: SeqDict,
                 preset: AlignPreset, cfg: AssemblyConfig,
                 loci_eval: LociEval,
                 use_wavefront: bool = False,
                 extra_voters: Optional[Dict[str, List[str]]] = None,
                 ) -> Tuple[SeqDict, Set[str]]:
    """Assemble every candidate locus (reference get_local_contigs,
    TELR_assembly.py:13-101).  Returns (contigs, assembly_passed_loci).

    extra_voters: per-locus reads that overlap the locus WITHOUT a
    supporting signature (the other haplotype, plus flank-only reads).
    They polish flank columns to full local depth — the reference polishes
    with support reads only (TELR_assembly.py:185-260), which at modest
    coverage leaves flanks noisy enough that the liftover's flank
    alignments fall short of the junction and the call is dropped."""
    extra_voters = extra_voters or {}
    return _assemble_batch(
        [(r.locus_name, r.reads, getattr(r, "spanning_reads", []) or [],
          extra_voters.get(r.locus_name, []),
          getattr(r, "stitched_backbone", "") or "")
         for r in records],
        reads, preset, cfg, loci_eval, use_wavefront=use_wavefront)


def _assemble_batch(items: List[Tuple[str, List[str], List[str], List[str]]],
                    reads: SeqDict,
                    preset: AlignPreset, cfg: AssemblyConfig,
                    loci_eval: LociEval,
                    use_wavefront: bool = False) -> Tuple[SeqDict, Set[str]]:
    """All loci advance through the realign+vote rounds in lockstep so each
    round pools every locus' realignment DPs into one grouped dispatch
    (`map_batch_grouped`) — the batched analogue of the reference's per-locus
    process fan-out (TELR_assembly.py:70-73), but as a few padded kernel
    launches instead of N processes."""
    from telr_jax.kernels.mapper import map_batch_grouped

    class _State:
        __slots__ = ("name", "avail", "extras", "consensus", "active",
                     "failed")

        def __init__(self, name, avail, extras, consensus):
            self.name = name
            self.avail = avail
            self.extras = extras
            self.consensus = consensus
            self.active = True
            self.failed = False

    states: List[_State] = []
    for item in items:
        locus_name, read_names, spanning, extras = item[:4]
        stitched = item[4] if len(item) > 4 else ""
        avail = [r for r in read_names if r in reads]
        if len(avail) < cfg.min_reads:
            loci_eval.add(locus_name, "local assembly failed")
            continue
        avail = avail[: cfg.max_reads]
        extras = [r for r in extras if r in reads and r not in avail]
        extras = extras[: cfg.max_extra_voters]
        # backbone pool: reads whose SV signature spans the insertion, when
        # known — a clipped junction read as backbone truncates the contig
        # inside the TE and costs a flank downstream
        pool = [r for r in spanning if r in avail]
        if pool:
            lens = sorted(pool, key=lambda r: len(reads[r]))
            backbone = reads[lens[len(lens) // 2]].codes
        elif stitched:
            # no real read spans the insertion, but SV detection stitched
            # a synthetic spanning sequence from a jr/jl junction-read
            # pair overlapping inside the TE body — polish rounds vote
            # its errors away like any read backbone
            backbone = encode(stitched)
        else:
            lens = sorted(avail, key=lambda r: len(reads[r]))
            backbone = reads[lens[len(lens) // 2]].codes
        if len(backbone) > cfg.max_locus_span:
            backbone = backbone[: cfg.max_locus_span]
        states.append(_State(locus_name, avail, extras, backbone))

    rounds = 1 + max(0, cfg.polish_iterations)
    for _ in range(rounds):
        live = [st for st in states if st.active]
        if not live:
            break
        groups = []
        for st in live:
            target = SeqDict([Sequence(st.name, st.consensus)])
            aligner = Aligner(target, preset, use_wavefront=use_wavefront)
            groups.append((aligner,
                           {rn: reads[rn].codes
                            for rn in st.avail + st.extras}))
        results = map_batch_grouped(groups)
        vote_items: List[Tuple[_State, list]] = []
        for st, result in zip(live, results):
            alns: List[Tuple[Alignment, np.ndarray]] = []
            for rn in st.avail:
                hits = [h for h in result.get(rn, []) if h.primary]
                if not hits:
                    continue
                best = max(hits, key=lambda h: h.score)
                alns.append((best, reads[rn].codes))
            # extra voters: non-support local reads polish the columns they
            # genuinely cover (flanks / TSD).  A read whose alignment walks
            # a long indel against the consensus is the OTHER haplotype
            # trying to delete the insertion (short TEs are alignable
            # straight through) — excluded from voting.
            for rn in st.extras:
                hits = [h for h in result.get(rn, []) if h.primary]
                if not hits:
                    continue
                best = max(hits, key=lambda h: h.score)
                if any(ln >= 30 and op in ("I", "D")
                       for op, ln in best.cigar):
                    continue
                alns.append((best, reads[rn].codes))
            if not alns:
                st.active = False
                st.failed = True
                continue
            vote_items.append((st, alns))
        # the vote itself runs on device, batched across every live locus
        # (device_vote.vote_many) — bit-identical to consensus_vote
        from telr_jax.assembly.device_vote import vote_many
        voted = vote_many([(st.consensus, alns) for st, alns in vote_items])
        for (st, _), new_consensus in zip(vote_items, voted):
            if new_consensus.size == 0:
                st.active = False
                st.failed = True
                continue
            if np.array_equal(new_consensus, st.consensus):
                st.active = False  # converged
                continue
            st.consensus = new_consensus

    # POA refinement: the pileup vote converges to a backbone-biased fixed
    # point on deletion-heavy noise (bases missing from the backbone only
    # return through gated insertion events; measured ~94% identity on
    # ONT) — two banded partial-order rounds (native telr_poa_consensus,
    # the wtpoa-cns role, reference TELR_assembly.py:225-247) finish the
    # contig: every read variant is a graph node and the majority-scored
    # heaviest path is the consensus, with no backbone bias.
    from telr_jax.io import native as _native
    if _native.has_poa():
        for _ in range(2):
            live = [st for st in states
                    if not st.failed and len(st.consensus)]
            if not live:
                break
            groups = []
            for st in live:
                target = SeqDict([Sequence(st.name, st.consensus)])
                aligner = Aligner(target, preset,
                                  use_wavefront=use_wavefront)
                groups.append((aligner,
                               {rn: reads[rn].codes
                                for rn in st.avail + st.extras}))
            results = map_batch_grouped(groups)
            poa_jobs = []   # (state, segs, c0s, c1s)
            for st, result in zip(live, results):
                segs, c0s, c1s = [], [], []
                for rn in st.avail + st.extras:
                    hits = [h for h in result.get(rn, []) if h.primary]
                    if not hits:
                        continue
                    best = max(hits, key=lambda h: h.score)
                    if rn in st.extras and any(
                            ln >= 30 and op in ("I", "D")
                            for op, ln in best.cigar):
                        continue
                    qc, _qi = _oriented(best, reads[rn].codes)
                    if best.strand == "-":
                        s0 = best.qlen - best.qend
                    else:
                        s0 = best.qstart
                    seg = qc[s0:s0 + (best.qend - best.qstart)]
                    if len(seg) == 0:
                        continue
                    segs.append(seg)
                    c0s.append(best.tstart)
                    c1s.append(best.tend)
                if segs:
                    poa_jobs.append((st, segs, c0s, c1s))

            def _refine(job):
                st, segs, c0s, c1s = job
                return st, _native.poa_consensus(
                    st.consensus, segs, c0s, c1s, width=192,
                    match=preset.match, mismatch=preset.mismatch,
                    gap_open=preset.gap_open,
                    gap_extend=preset.gap_extend,
                    min_cov=2 if len(segs) > 2 else 1)

            # the ctypes POA call releases the GIL — thread across loci
            import os as _os
            from concurrent.futures import ThreadPoolExecutor
            nthr = min(len(poa_jobs),
                       int(_os.environ.get("TELR_DP_THREADS", 0))
                       or (_os.cpu_count() or 1))
            any_change = False
            if poa_jobs:
                with ThreadPoolExecutor(max_workers=max(1, nthr)) as ex:
                    for st, refined in ex.map(_refine, poa_jobs):
                        if refined.size and not np.array_equal(
                                refined, st.consensus):
                            st.consensus = refined
                            any_change = True
            if not any_change:
                break

    contigs = SeqDict()
    passed: Set[str] = set()
    for st in states:
        if st.failed:
            loci_eval.add(st.name, "local assembly failed")
            continue
        contigs.add(Sequence(st.name, st.consensus,
                             description=f"len={len(st.consensus)}"))
        passed.add(st.name)
    return contigs, passed
