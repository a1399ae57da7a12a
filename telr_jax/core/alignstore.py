"""In-memory alignment store: the replacement for sorted+indexed BAM files.

The reference round-trips every alignment through samtools sort/index/view/
depth (TELR_alignment.py:103-114, TELR_te.py:870-884, TELR_assembly.py:386-410).
Here alignments live as position-sorted python records with numpy coverage
reductions; BAM never exists inside the pipeline.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from telr_jax.kernels.mapper import Alignment


class AlignmentStore:
    """Position-sorted alignment container with windowed fetch and per-base
    depth (samtools depth -aa semantics: a position's depth counts reads whose
    M blocks cover it; deletion gaps do not count)."""

    def __init__(self, alignments: Iterable[Alignment]):
        self._by_target: Dict[str, List[Alignment]] = {}
        for a in alignments:
            self._by_target.setdefault(a.tname, []).append(a)
        for tname, lst in self._by_target.items():
            lst.sort(key=lambda a: (a.tstart, a.tend, a.qname))
        self._starts: Dict[str, np.ndarray] = {
            t: np.array([a.tstart for a in lst], dtype=np.int64)
            for t, lst in self._by_target.items()}
        # running max of tend makes fetch O(log n + k): rows before the
        # first index whose cummax(tend) exceeds `start` cannot overlap
        self._cummax_end: Dict[str, np.ndarray] = {
            t: np.maximum.accumulate(
                np.array([a.tend for a in lst], dtype=np.int64))
            for t, lst in self._by_target.items()}

    def targets(self) -> List[str]:
        return list(self._by_target.keys())

    def __len__(self) -> int:
        return sum(len(v) for v in self._by_target.values())

    def all(self) -> Iterable[Alignment]:
        for lst in self._by_target.values():
            yield from lst

    def fetch(self, tname: str, start: int, end: int) -> List[Alignment]:
        """Alignments overlapping [start, end) on target tname.

        Binary search over the position-sorted arrays (O(log n + k)), not a
        linear scan — at genome scale every SV-cluster count and AF window
        pays this path thousands of times."""
        lst = self._by_target.get(tname)
        if not lst:
            return []
        starts = self._starts[tname]
        hi = int(np.searchsorted(starts, end, side="left"))   # tstart < end
        cm = self._cummax_end[tname]
        lo = int(np.searchsorted(cm[:hi], start, side="right"))
        return [a for a in lst[lo:hi] if a.tend > start]

    def fetch_read_names(self, tname: str, start: int, end: int) -> List[str]:
        seen, out = set(), []
        for a in self.fetch(tname, start, end):
            if a.qname not in seen:
                seen.add(a.qname)
                out.append(a.qname)
        return out

    # ------------------------------------------------------------------
    def coverage(self, tname: str, start: int, end: int) -> np.ndarray:
        """Per-base depth over [start, end): counts aligned (M) bases."""
        n = end - start
        diff = np.zeros(n + 1, dtype=np.int64)
        for a in self.fetch(tname, start, end):
            tj = a.tstart
            for op, ln in a.cigar:
                if op == "M":
                    s = max(tj, start)
                    e = min(tj + ln, end)
                    if e > s:
                        diff[s - start] += 1
                        diff[e - start] -= 1
                    tj += ln
                elif op == "D":
                    tj += ln
        return np.cumsum(diff[:-1])

    def median_coverage(self, tname: str, start: int, end: int) -> float:
        """Median per-base depth over [start, end) (samtools depth -aa +
        statistics.median, reference TELR_te.py:870-884)."""
        cov = self.coverage(tname, start, end)
        if cov.size == 0:
            return 0.0
        return float(np.median(cov))
