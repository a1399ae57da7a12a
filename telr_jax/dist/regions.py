"""Genome region partition for sharded SV-evidence exchange.

SURVEY §2c prescribes halo exchange of boundary clusters, not full
replication, for the cross-shard breakpoint clustering.  This module
partitions the reference into P contiguous regions balanced by bases;
alignment records and insertion signatures are routed to the region(s)
their span (± halo) overlaps, each region's owner clusters its own slice
of the genome, and only the tiny per-cluster records are all-gathered.

The halo bounds how far a single-linkage cluster chain may reach across a
region boundary while staying bit-identical to the single-process
clustering; it also covers every positional store.fetch the owner performs
around its loci (genotype DR window, assembly/AF voter windows).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from telr_jax.io.seqs import SeqDict

# halo (bases) on each side of a region boundary.  Must exceed the largest
# positional reach of any per-locus computation: cluster chain span
# (max_cluster_dist-linked, realistically << 10kb), merge_window (20),
# assembly/AF read-fetch windows (1kb), max locus span.  100kb of margin
# makes boundary effects astronomically unlikely while costing only a few
# hundred duplicated alignment records per boundary.
DEFAULT_HALO = 100_000


class RegionMap:
    """P contiguous genome regions balanced by reference bases."""

    def __init__(self, reference: SeqDict, n_regions: int):
        self.names: List[str] = [s.name for s in reference]
        lens = np.array([len(reference[n]) for n in self.names],
                        dtype=np.int64)
        self.chrom_off: Dict[str, int] = {}
        off = 0
        for n, ln in zip(self.names, lens.tolist()):
            self.chrom_off[n] = off
            off += ln
        total = int(lens.sum())
        self.n = n_regions
        # global-offset boundaries of the regions: region r = [b[r], b[r+1])
        self.bounds = np.array(
            [round(total * k / n_regions) for k in range(n_regions + 1)],
            dtype=np.int64)

    def _gpos(self, chrom: str, pos: int) -> int:
        # clamp on the GLOBAL axis (a halo reach before a chrom's start
        # legitimately lands in the previous chrom's region)
        return max(0, self.chrom_off[chrom] + int(pos))

    def region_of(self, chrom: str, pos: int) -> int:
        g = self._gpos(chrom, pos)
        r = int(np.searchsorted(self.bounds, g, side="right")) - 1
        return min(max(r, 0), self.n - 1)

    def dests_for_span(self, chrom: str, start: int, end: int,
                       halo: int = DEFAULT_HALO) -> List[int]:
        """Regions whose [bound-halo, bound+halo)-extended range overlaps
        [start, end) on chrom."""
        lo = self.region_of(chrom, start - halo)
        hi = self.region_of(chrom, max(start, end - 1) + halo)
        return list(range(lo, hi + 1))
