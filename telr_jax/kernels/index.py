"""Minimizer hash index over a target SeqDict (the reference genome, a contig
set, or a TE library).

Replaces minimap2's .mmi / NGMLR's index.  Host-built (sorted-array layout,
no hash table): query by binary search.  The index is replicated per host in
the distributed design (SURVEY.md §2c); read batches are what gets sharded.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from telr_jax.io.seqs import SeqDict
from telr_jax.kernels.minimizer import minimizers


@dataclasses.dataclass
class MinimizerIndex:
    k: int
    w: int
    seq_names: List[str]
    seq_lens: np.ndarray        # (S,) int64
    seq_starts: np.ndarray      # (S,) int64 — global concat offset per seq
    hashes: np.ndarray          # (N,) uint64, sorted
    gpos: np.ndarray            # (N,) int64 global positions (concat coords)
    strand: np.ndarray          # (N,) int8
    max_occ: int = 512
    # prefix table over the top `pbits` hash bits: pref[b] = first index
    # whose hash >> (64-pbits) >= b (len 2^pbits + 1).  Built lazily; keeps
    # the native lookup's binary search inside one ~64-entry hot bucket.
    pbits: int = 0
    pref: Optional[np.ndarray] = None

    def _ensure_pref(self) -> None:
        if self.pref is not None:
            return
        n = len(self.hashes)
        # ~64 entries per bucket; pbits in [1, 26] bounds table memory
        pbits = max(1, min(26, int(np.ceil(np.log2(max(2, n / 64))))))
        bounds = np.arange(1, 2 ** pbits, dtype=np.uint64) << np.uint64(
            64 - pbits)
        pref = np.empty(2 ** pbits + 1, dtype=np.int64)
        pref[0] = 0
        pref[-1] = n
        pref[1:-1] = np.searchsorted(self.hashes, bounds, side="left")
        object.__setattr__(self, "pbits", pbits)
        object.__setattr__(self, "pref", pref)

    @classmethod
    def build(cls, seqs: SeqDict, k: int, w: int, max_occ: int = 512
              ) -> "MinimizerIndex":
        names, lens, starts = [], [], []
        hs, ps, ss = [], [], []
        offset = 0
        for s in seqs:
            names.append(s.name)
            lens.append(len(s))
            starts.append(offset)
            pos, h, st = minimizers(s.codes, k, w)
            hs.append(h)
            ps.append(pos + offset)
            ss.append(st)
            offset += len(s)
        hashes = np.concatenate(hs) if hs else np.zeros(0, np.uint64)
        gpos = np.concatenate(ps) if ps else np.zeros(0, np.int64)
        strand = np.concatenate(ss) if ss else np.zeros(0, np.int64)
        order = np.argsort(hashes, kind="stable")
        return cls(k=k, w=w, seq_names=names,
                   seq_lens=np.array(lens, dtype=np.int64),
                   seq_starts=np.array(starts, dtype=np.int64),
                   hashes=hashes[order], gpos=gpos[order],
                   strand=strand[order].astype(np.int8), max_occ=max_occ)

    def lookup(self, qhashes: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """For an array of query hashes, return (q_idx, t_gpos, t_strand) of
        all index hits, dropping hashes with more than max_occ occurrences
        (repeat filter, like minimap2 -f)."""
        from telr_jax.io import native
        if native.has_index_lookup() and len(self.hashes):
            self._ensure_pref()
            lo, cnt = native.index_lookup(self.hashes, self.pref,
                                          self.pbits, qhashes)
        else:
            lo = np.searchsorted(self.hashes, qhashes, side="left")
            cnt = np.searchsorted(self.hashes, qhashes, side="right") - lo
        keep = np.nonzero((cnt > 0) & (cnt <= self.max_occ))[0]
        if keep.size == 0:
            z = np.zeros(0, dtype=np.int64)
            return z, z.copy(), z.copy()
        c = cnt[keep]
        q_idx = np.repeat(keep, c)
        # flat index positions of every hit: per-run arange added to starts
        ends = np.cumsum(c)
        run_off = np.arange(ends[-1], dtype=np.int64) - np.repeat(
            ends - c, c)
        idx = np.repeat(lo[keep], c) + run_off
        return q_idx, self.gpos[idx], self.strand[idx].astype(np.int64)

    def seq_of_gpos(self, gpos: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Global concat position -> (seq_id, local position)."""
        sid = np.searchsorted(self.seq_starts, gpos, side="right") - 1
        return sid, gpos - self.seq_starts[sid]
