"""Allele-frequency estimation from strand-split realignment depth.

Exact-semantics port of the reference's get_af stage (TELR_te.py:495-884):

  * reads within ±1kb of each breakpoint are realigned to the locus contig
    AND its reverse complement (two separate pileups, TELR_te.py:620-652),
  * median depth is measured over four windows per orientation: TE 5'/3'
    (interval 50, offset 50 inside the TE; whole-TE fallback when the TE is
    short, TELR_te.py:841-867) and flank 5'/3' (interval 100, offset 200
    outside the TE; None when out of contig bounds, TELR_te.py:518-550),
  * taf_5p = te_5p_cov/flank_5p_cov on the forward contig; taf_3p uses the
    *5p* windows of the reverse-complement pileup (which face the TE's 3'
    end, TELR_te.py:810-817); ratios > 1.5 are discarded (TELR_te.py:570),
  * the two ratios combine iff they differ by <= 0.3, are capped at 1 and
    rounded to 3 digits (TELR_te.py:818-835).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from telr_jax.config import AFConfig, AlignPreset, AssemblyConfig
from telr_jax.core.alignstore import AlignmentStore
from telr_jax.io.seqs import SeqDict, Sequence
from telr_jax.kernels.mapper import Aligner
from telr_jax.ops.intervals import Intervals
from telr_jax.sv.detect import SVRecord


def _realign_stores_batched(
    targets: List[Sequence],
    read_name_lists: List[List[str]],
    reads: SeqDict,
    preset: AlignPreset,
    use_wavefront: bool = False,
) -> List[AlignmentStore]:
    """Realign each target's read window in ONE pooled dispatch across all
    (locus x strand) targets — the batched replacement for the reference's
    two sequential per-locus Pools (TELR_te.py:644-648)."""
    from telr_jax.kernels.mapper import map_batch_grouped
    groups = []
    for contig, read_names in zip(targets, read_name_lists):
        aligner = Aligner(SeqDict([contig]), preset,
                          use_wavefront=use_wavefront)
        groups.append((aligner, {rn: reads[rn].codes for rn in read_names
                                 if rn in reads}))
    results = map_batch_grouped(groups)
    return [AlignmentStore([h for hits in result.values() for h in hits
                            if h.primary])
            for result in results]


class _MeshDepthView:
    """Serves window medians from a precomputed per-base coverage array
    (AlignmentStore.median_coverage-compatible surface)."""

    def __init__(self, cov: np.ndarray):
        self._cov = cov

    def median_coverage(self, _cname: str, start: int, end: int) -> float:
        seg = self._cov[max(0, start):max(0, end)]
        return float(np.median(seg)) if seg.size else 0.0


def _get_te_cov(store: AlignmentStore, cname: str, start: int, end: int,
                cfg: AFConfig):
    te_5p = te_3p = None
    whole = False
    if cfg.te_interval:
        if start + cfg.te_offset + cfg.te_interval < end:
            te_5p = store.median_coverage(
                cname, start + cfg.te_offset,
                start + cfg.te_offset + cfg.te_interval)
            te_3p = store.median_coverage(
                cname, end - cfg.te_interval - cfg.te_offset,
                end - cfg.te_offset)
        else:
            whole = True
    else:
        whole = True
    if whole:
        te_5p = store.median_coverage(cname, start, end)
        te_3p = te_5p
    return te_5p, te_3p


def _get_flank_cov(store: AlignmentStore, cname: str, contig_len: int,
                   start: int, end: int, cfg: AFConfig):
    left = right = None
    if start - cfg.flank_interval - cfg.flank_offset >= 0:
        left = store.median_coverage(
            cname, start - cfg.flank_interval - cfg.flank_offset,
            start - cfg.flank_offset)
    if end + cfg.flank_interval + cfg.flank_offset <= contig_len:
        right = store.median_coverage(
            cname, end + cfg.flank_offset,
            end + cfg.flank_interval + cfg.flank_offset)
    return left, right


def _ratio(te_cov: Optional[float], flank_cov: Optional[float],
           cfg: AFConfig) -> Optional[float]:
    if te_cov and flank_cov:
        if flank_cov == 0:
            return None
        r = te_cov / flank_cov
        return None if r > cfg.max_ratio else r
    return None


def estimate_af(
    records: List[SVRecord],
    contigs: SeqDict,
    contig_te: Intervals,
    reads: SeqDict,
    genome_store: AlignmentStore,
    read_preset: AlignPreset,
    cfg: AFConfig,
    asm_cfg: AssemblyConfig,
    use_wavefront: bool = False,
    mesh=None,
    window_names: Optional[Dict[str, List[str]]] = None,
) -> Dict[str, dict]:
    """Returns te_freq: contig_name -> {te_5p_cov, ..., freq} exactly as the
    reference builds it (TELR_te.py:758-838).

    window_names: optional precomputed breakpoint-window read-name lists
    per locus (multi-process runner: resolved by the locus' REGION owner,
    whose store covers the window, so a load-balanced COMPUTE owner can
    run AF without positional store access)."""
    # contig TE coords: last annotation row per contig wins (reference
    # overwrites in file order, TELR_te.py:657-675)
    te_coords: Dict[str, tuple] = {}
    for i in range(len(contig_te)):
        cname = contig_te.chrom[i]
        if cname not in contigs:
            continue
        clen = len(contigs[cname])
        s, e = int(contig_te.start[i]), int(contig_te.end[i])
        te_coords[cname] = ((s, e), (clen - e, clen - s))

    te_freq: Dict[str, dict] = {}
    # collect every (locus x strand) realignment target, dispatch once
    jobs: List[tuple] = []   # (cname, rc, contig_len)
    targets: List[Sequence] = []
    read_lists: List[List[str]] = []
    for rec in records:
        cname = rec.locus_name
        te_freq[cname] = {
            "te_5p_cov": None, "te_3p_cov": None,
            "flank_5p_cov": None, "flank_3p_cov": None,
            "te_5p_cov_rc": None, "te_3p_cov_rc": None,
            "flank_5p_cov_rc": None, "flank_3p_cov_rc": None,
            "freq": None,
        }
        if cname not in contigs or cname not in te_coords:
            continue
        contig = contigs[cname]
        if window_names is not None:
            window_reads = window_names[cname]
        else:
            bp = round((rec.start + rec.end) / 2)
            window_reads = genome_store.fetch_read_names(
                rec.chrom, max(0, bp - asm_cfg.window), bp + asm_cfg.window)
        for rc in (False, True):
            jobs.append((cname, rc, len(contig)))
            targets.append(contig.revcomp() if rc else contig)
            read_lists.append(window_reads)

    stores = _realign_stores_batched(targets, read_lists, reads,
                                     read_preset,
                                     use_wavefront=use_wavefront)
    if mesh is not None:
        # depth reductions through the mesh: full-contig M-base coverage is
        # psum-reduced over the "reads" axis (CIGAR-true, bit-identical to
        # the host path), window medians sliced from the result
        from telr_jax.dist.exec import mesh_coverage
        stores = [_MeshDepthView(mesh_coverage(mesh, st, cname, clen))
                  for (cname, _rc, clen), st in zip(jobs, stores)]
    for (cname, rc, clen), store in zip(jobs, stores):
        (s, e) = te_coords[cname][1 if rc else 0]
        te_5p, te_3p = _get_te_cov(store, cname, s, e, cfg)
        fl_5p, fl_3p = _get_flank_cov(store, cname, clen, s, e, cfg)
        sfx = "_rc" if rc else ""
        te_freq[cname]["te_5p_cov" + sfx] = te_5p
        te_freq[cname]["te_3p_cov" + sfx] = te_3p
        te_freq[cname]["flank_5p_cov" + sfx] = fl_5p
        te_freq[cname]["flank_3p_cov" + sfx] = fl_3p

    for rec in records:
        cname = rec.locus_name
        if cname not in contigs or cname not in te_coords:
            continue
        taf_5p = _ratio(te_freq[cname]["te_5p_cov"],
                        te_freq[cname]["flank_5p_cov"], cfg)
        taf_3p = _ratio(te_freq[cname]["te_5p_cov_rc"],
                        te_freq[cname]["flank_5p_cov_rc"], cfg)
        if taf_5p and taf_3p:
            freq = ((taf_5p + taf_3p) / 2
                    if abs(taf_5p - taf_3p) <= cfg.max_taf_diff else None)
        elif taf_5p:
            freq = taf_5p
        elif taf_3p:
            freq = taf_3p
        else:
            freq = None
        if freq and freq > 1:
            freq = 1
        te_freq[cname]["freq"] = round(freq, 3) if freq else None
    return te_freq
