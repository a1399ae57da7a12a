"""Vectorised interval algebra — the in-memory replacement for every bedtools
call site in the reference pipeline:

  * bedtools sort        (TELR_sv.py:288, TELR_te.py:180,233, TELR_liftover.py:244)
  * bedtools merge -d N -o collapse/distinct
                         (TELR_sv.py:88-94,295; TELR_te.py:201,330; TELR_liftover.py:1115)
  * bedtools intersect -wao (TELR_te.py:148-158)
  * bedtools closest -s -d -t all (TELR_liftover.py:502-518)
  * bedtools closest -d -D ref -k 5 (TELR_liftover.py:304-319)
  * bedtools getfasta    (via telr_jax.io.SeqDict.fetch)

Semantics are matched to bedtools v2.30 behaviour:
  - intervals are 0-based half-open,
  - merge -d N joins intervals whose gap is <= N (bookended intervals merge at
    N=0),
  - closest -d distance is 0 for overlap and gap+1 otherwise ("abutting
    features have distance 1"),
  - closest -D ref reports negative distances when B is upstream (lower
    coordinate) of A,
  - ties at equal distance are all reported (-t all).

Data sizes here are O(loci) (hundreds to tens of thousands), so the host-side
numpy implementation is never the bottleneck; the hot per-base work lives in
the alignment kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class Intervals:
    """Struct-of-arrays interval table: chrom / start / end plus named extra
    columns (name, score, strand, ... as python lists)."""

    chrom: List[str]
    start: np.ndarray  # int64
    end: np.ndarray    # int64
    cols: Dict[str, list] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self.start = np.asarray(self.start, dtype=np.int64)
        self.end = np.asarray(self.end, dtype=np.int64)

    def __len__(self) -> int:
        return len(self.chrom)

    @classmethod
    def empty(cls, col_names: Sequence[str] = ()) -> "Intervals":
        return cls(chrom=[], start=np.zeros(0, np.int64),
                   end=np.zeros(0, np.int64),
                   cols={c: [] for c in col_names})

    @classmethod
    def from_rows(cls, rows: Sequence[tuple], col_names: Sequence[str] = ()) -> "Intervals":
        """rows: (chrom, start, end, *extras) with extras matching col_names."""
        chrom = [r[0] for r in rows]
        start = np.array([r[1] for r in rows], dtype=np.int64)
        end = np.array([r[2] for r in rows], dtype=np.int64)
        cols = {name: [r[3 + i] for r in rows] for i, name in enumerate(col_names)}
        return cls(chrom, start, end, cols)

    def row(self, i: int) -> tuple:
        return (self.chrom[i], int(self.start[i]), int(self.end[i]),
                *(self.cols[c][i] for c in self.cols))

    def take(self, idx: Sequence[int]) -> "Intervals":
        idx = np.asarray(idx, dtype=np.int64)
        return Intervals(
            chrom=[self.chrom[i] for i in idx],
            start=self.start[idx],
            end=self.end[idx],
            cols={c: [v[i] for i in idx] for c, v in self.cols.items()},
        )

    def sort(self) -> "Intervals":
        """bedtools sort: lexicographic by chrom, then start, then end."""
        if len(self) <= 1:
            return self.take(np.arange(len(self)))
        # np.unique's inverse codes are lexicographic chrom ranks
        _, inv = np.unique(np.array(self.chrom), return_inverse=True)
        order = np.lexsort((self.end, self.start, inv))
        return self.take(order)

    def by_chrom(self) -> Dict[str, np.ndarray]:
        """chrom -> row-index array (preserving current order)."""
        out: Dict[str, List[int]] = {}
        for i, c in enumerate(self.chrom):
            out.setdefault(c, []).append(i)
        return {c: np.array(v, dtype=np.int64) for c, v in out.items()}


# ---------------------------------------------------------------------------
# merge
# ---------------------------------------------------------------------------

def merge_intervals(
    iv: Intervals,
    dist: int = 0,
    collapse: Optional[Dict[str, str]] = None,
    delim: str = ",",
) -> Intervals:
    """bedtools merge -d dist [-c ... -o collapse|distinct -delim delim].

    `collapse` maps extra-column name -> op ("collapse" joins all values with
    delim; "distinct" joins unique values in first-appearance order).
    Input need not be sorted; output is sorted.  Returns string-valued extra
    columns (like bedtools' text output, which downstream reference code
    re-parses: TELR_sv.py:96-138, TELR_te.py:208-230).
    """
    collapse = collapse or {}
    iv = iv.sort()
    out_rows: List[tuple] = []
    col_names = list(collapse.keys())

    i = 0
    n = len(iv)
    while i < n:
        chrom = iv.chrom[i]
        start = int(iv.start[i])
        end = int(iv.end[i])
        members = [i]
        j = i + 1
        while j < n and iv.chrom[j] == chrom and int(iv.start[j]) <= end + dist:
            end = max(end, int(iv.end[j]))
            members.append(j)
            j += 1
        extras = []
        for cname in col_names:
            vals = [str(iv.cols[cname][m]) for m in members]
            if collapse[cname] == "distinct":
                seen, uniq = set(), []
                for v in vals:
                    if v not in seen:
                        seen.add(v)
                        uniq.append(v)
                extras.append(delim.join(uniq))
            else:  # collapse
                extras.append(delim.join(vals))
        out_rows.append((chrom, start, end, *extras))
        i = j

    return Intervals.from_rows(out_rows, col_names)


# ---------------------------------------------------------------------------
# intersect -wao
# ---------------------------------------------------------------------------

def intersect_wao(a: Intervals, b: Intervals) -> List[Tuple[int, int, int]]:
    """bedtools intersect -a A -b B -wao.

    Returns a list of (a_idx, b_idx, overlap_bp); rows of A with no overlap
    appear once as (a_idx, -1, 0).  Row order follows A's current order, with
    B matches in B's sorted order per A row (bedtools reports every pairwise
    overlap).
    """
    out: List[Tuple[int, int, int]] = []
    # per-chrom sorted arrays + running max(end): candidate window for an A
    # row is found by two binary searches instead of a linear scan over B
    b_bychrom: Dict[str, Tuple[np.ndarray, np.ndarray, np.ndarray,
                               np.ndarray]] = {}
    idx_by_chrom: Dict[str, List[int]] = {}
    for i, c in enumerate(b.chrom):
        idx_by_chrom.setdefault(c, []).append(i)
    for c, idxs in idx_by_chrom.items():
        idx = np.array(idxs, dtype=np.int64)
        bs, be = b.start[idx], b.end[idx]
        order = np.lexsort((be, bs))
        idx, bs, be = idx[order], bs[order], be[order]
        b_bychrom[c] = (idx, bs, be, np.maximum.accumulate(be))

    for ai in range(len(a)):
        chrom, astart, aend = a.chrom[ai], int(a.start[ai]), int(a.end[ai])
        entry = b_bychrom.get(chrom)
        hits: List[Tuple[int, int, int]] = []
        if entry is not None:
            idx, bs, be, cme = entry
            hi = int(np.searchsorted(bs, aend, side="left"))
            lo = int(np.searchsorted(cme[:hi], astart, side="right"))
            if hi > lo:
                ov = (np.minimum(aend, be[lo:hi])
                      - np.maximum(astart, bs[lo:hi]))
                for j in np.nonzero(ov > 0)[0]:
                    hits.append((ai, int(idx[lo + j]), int(ov[j])))
        if hits:
            out.extend(hits)
        else:
            out.append((ai, -1, 0))
    return out


# ---------------------------------------------------------------------------
# closest
# ---------------------------------------------------------------------------

def _distance_unsigned(astart: int, aend: int, bstart: int, bend: int) -> int:
    """bedtools closest -d distance: 0 if overlap, else gap+1."""
    if bstart < aend and bend > astart:
        return 0
    if bstart >= aend:
        return bstart - aend + 1
    return astart - bend + 1


def _distance_dref(astart: int, aend: int, bstart: int, bend: int) -> int:
    """bedtools closest -D ref signed distance: negative if B upstream of A."""
    d = _distance_unsigned(astart, aend, bstart, bend)
    if d == 0:
        return 0
    return -d if bend <= astart else d


def closest(
    a: Intervals,
    b: Intervals,
    same_strand: bool = False,
    signed: bool = False,
    k: int = 1,
    strand_col: str = "strand",
) -> List[List[Tuple[int, int, int]]]:
    """bedtools closest -a A -b B -d [-s] [-D ref] [-k K] [-t all].

    Returns, for each A row (in A's current order), a list of
    (a_idx, b_idx, distance) covering the K closest B features on the same
    chromosome (ties at each rank all included, as with -t all).  An A row
    with no candidate B yields [(a_idx, -1, None-marker)] with b_idx == -1 and
    distance == -1, mirroring bedtools' "." rows.
    """
    # Per (chrom[, strand]) group, B is indexed two ways: sorted by start
    # (with running max end) for the overlap window, and sorted by end for
    # upstream neighbours.  One A row then costs O(log n + k') — the k
    # nearest features are pulled from a window around the A interval that
    # doubles until it provably contains all k distance ranks, so results
    # are exact (incl. -t all tie semantics) without scanning the
    # chromosome.
    b_groups: Dict[tuple, tuple] = {}
    idx_by_group: Dict[tuple, List[int]] = {}
    b_strands = b.cols.get(strand_col) if same_strand else None
    for i, c in enumerate(b.chrom):
        key = (c, b_strands[i]) if same_strand and b_strands is not None \
            else (c,)
        idx_by_group.setdefault(key, []).append(i)
    for key, idxs in idx_by_group.items():
        idx = np.array(idxs, dtype=np.int64)
        bs, be = b.start[idx], b.end[idx]
        so = np.lexsort((be, bs))
        eo = np.lexsort((bs, be))
        b_groups[key] = (idx[so], bs[so], be[so],
                         np.maximum.accumulate(be[so]),
                         idx[eo], bs[eo], be[eo])

    a_strands = a.cols.get(strand_col) if same_strand else None
    results: List[List[Tuple[int, int, int]]] = []
    for ai in range(len(a)):
        chrom, astart, aend = a.chrom[ai], int(a.start[ai]), int(a.end[ai])
        key = (chrom, a_strands[ai]) if same_strand and a_strands is not None \
            else (chrom,)
        entry = b_groups.get(key)
        if entry is None:
            results.append([(ai, -1, -1)])
            continue
        idx_s, bs_s, be_s, cme, idx_e, bs_e, be_e = entry
        n = len(idx_s)
        hi = int(np.searchsorted(bs_s, aend, side="left"))
        lo = int(np.searchsorted(cme[:hi], astart, side="right"))
        up = int(np.searchsorted(be_e, astart, side="right"))
        w = 4 * k + 8
        while True:
            # candidates: overlap window + w nearest upstream (by end)
            # + w nearest downstream (by start)
            d_lo, u_lo = min(hi + w, n), max(up - w, 0)
            parts_i = [idx_s[lo:hi], idx_e[u_lo:up], idx_s[hi:d_lo]]
            parts_s = [bs_s[lo:hi], bs_e[u_lo:up], bs_s[hi:d_lo]]
            parts_e = [be_s[lo:hi], be_e[u_lo:up], be_s[hi:d_lo]]
            idx = np.concatenate(parts_i)
            if len(idx) == 0:
                results.append([(ai, -1, -1)])
                break
            bs = np.concatenate(parts_s)
            be = np.concatenate(parts_e)
            # the overlap window can contain rows that also appear in the
            # upstream slice (be <= astart inside [lo:hi)) — dedup by index
            idx, ui = np.unique(idx, return_index=True)
            bs, be = bs[ui], be[ui]
            ov = (bs < aend) & (be > astart)
            d = np.where(ov, 0, np.where(bs >= aend, bs - aend + 1,
                                         astart - be + 1))
            if signed:
                d = np.where(~ov & (be <= astart), -d, d)
            absd = np.abs(d)
            order = np.lexsort((idx, absd))   # bedtools tie order: (|d|, bi)
            sv = absd[order]
            rank_starts = np.nonzero(np.diff(sv))[0] + 1
            cut = int(rank_starts[k - 1]) if len(rank_starts) >= k else len(sv)
            # exact iff every unseen candidate is farther than the last
            # kept rank: the nearest excluded up/downstream rows bound it
            horizon = 1 << 62
            if u_lo > 0:
                horizon = min(horizon, astart - int(be_e[u_lo - 1]) + 1)
            if d_lo < n:
                horizon = min(horizon, int(bs_s[d_lo]) - aend + 1)
            kth_max = int(sv[cut - 1])
            done_ranks = len(rank_starts) >= k
            if (done_ranks and kth_max < horizon) or \
                    (u_lo == 0 and d_lo == n):
                results.append([(ai, int(idx[j]), int(d[j]))
                                for j in order[:cut]])
                break
            w *= 2
    return results
