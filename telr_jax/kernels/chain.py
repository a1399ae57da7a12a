"""Anchor chaining (minimap2-style DP) for the seed-chain-extend aligner.

Given (query_pos, target_pos) seed anchors on one (target sequence, strand),
find high-scoring co-linear chains.  The scoring follows minimap2's chaining
objective (alpha = new bases covered, beta = capped concave gap cost), with
one deliberate deviation: query-side gaps (insertions in the read — the
signal TELR exists to detect) are allowed up to `max_gap` with a *capped*
penalty, so a read spanning a TE insertion yields ONE chain whose stitched
DP emits the full-length I run, instead of a split alignment.  Target-side
gaps larger than the DP band are disallowed (they become split alignments /
deletions, which the pipeline does not consume — reference TELR_sv.py:163
keeps only SVTYPE=INS).

Exception to the deviation: a link whose diagonal-offset jump |dq - dt|
exceeds `max_offset_jump` is SPLIT after extraction — the banded region DP
(band cap 2048) cannot contain such an L-shaped path, and an uncontainable
jump shreds the insertion into band-width fragments (observed on ONT:
600bp/2900bp TEs detected as ~120bp INS candidates that then fail the TE
homology filter).  The two flank sub-chains become a split-pair insertion
signature with the exact gap length instead (sv/detect.py:131-153).
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


@dataclasses.dataclass
class Chain:
    qpos: np.ndarray     # anchor query starts (ascending)
    tpos: np.ndarray     # anchor target starts (ascending)
    score: float
    k: int

    @property
    def n_anchors(self) -> int:
        return len(self.qpos)

    @property
    def q_span(self):
        return int(self.qpos[0]), int(self.qpos[-1]) + self.k

    @property
    def t_span(self):
        return int(self.tpos[0]), int(self.tpos[-1]) + self.k


def chain_anchors(
    qpos: np.ndarray,
    tpos: np.ndarray,
    k: int,
    max_gap: int = 5000,
    max_target_skew: int = 384,
    lookback: int = 64,
    gap_cap: float = 40.0,
    min_score: float = 40.0,
    min_anchors: int = 3,
    max_chains: int = 16,
    max_offset_jump: int = 1500,
) -> List[Chain]:
    """DP chaining over anchors of one (target, strand) group."""
    n = len(qpos)
    if n == 0:
        return []
    order = np.lexsort((qpos, tpos))
    q = qpos[order].astype(np.int64)
    t = tpos[order].astype(np.int64)

    nat = None
    try:
        from telr_jax.io import native
        nat = native.load()
        if nat is not None and not hasattr(nat, "telr_chain_dp"):
            nat = None
    except ImportError:
        nat = None
    if nat is not None:
        qa = np.ascontiguousarray(q)
        ta = np.ascontiguousarray(t)
        f = np.empty(n, dtype=np.float64)
        parent = np.empty(n, dtype=np.int64)
        nat.telr_chain_dp(qa.ctypes.data, ta.ctypes.data, n, k,
                          max_gap, max_target_skew, lookback,
                          float(gap_cap), f.ctypes.data,
                          parent.ctypes.data)
    else:
        f = np.full(n, float(k))
        parent = np.full(n, -1, dtype=np.int64)
        for i in range(1, n):
            j0 = max(0, i - lookback)
            dq = q[i] - q[j0:i]
            dt = t[i] - t[j0:i]
            ok = (dq >= 1) & (dt >= 0) & (dq <= max_gap) \
                & (dt <= max_gap) & ((dt - dq) <= max_target_skew)
            if not ok.any():
                continue
            alpha = np.minimum(np.minimum(dq, dt), k).astype(np.float64)
            dd = np.abs(dq - dt).astype(np.float64)
            beta = np.where(
                dd > 0,
                np.minimum(0.01 * k * dd + 0.5 * np.log2(dd + 1),
                           gap_cap), 0.0)
            cand = np.where(ok, f[j0:i] + alpha - beta, -np.inf)
            best = int(np.argmax(cand))
            if cand[best] > f[i]:
                f[i] = cand[best]
                parent[i] = j0 + best

    # extract chains greedily by score, skipping used anchors (native path
    # when available; identical semantics, ties broken by anchor index)
    chains: List[Chain] = []
    if nat is not None and hasattr(nat, "telr_chain_extract"):
        from telr_jax.io import native
        idx_flat, starts, lens, scores = native.chain_extract(
            f, parent, min_score, min_anchors, max_chains)
        for s, ln, sc in zip(starts, lens, scores):
            idx = idx_flat[s:s + ln]
            chains.append(Chain(qpos=q[idx], tpos=t[idx],
                                score=float(sc), k=k))
    else:
        used = np.zeros(n, dtype=bool)
        # stable descending order with index tiebreak (matches native)
        for i in np.argsort(-f, kind="stable"):
            if used[i] or f[i] < min_score:
                continue
            path = []
            cur = int(i)
            while cur != -1 and not used[cur]:
                path.append(cur)
                cur = int(parent[cur])
            if len(path) < min_anchors:
                for p in path:
                    used[p] = True
                continue
            path.reverse()
            idx = np.array(path, dtype=np.int64)
            used[idx] = True
            chains.append(Chain(qpos=q[idx], tpos=t[idx],
                                score=float(f[i]), k=k))
            if len(chains) >= max_chains:
                break
    chains = _split_at_offset_jumps(chains, k, gap_cap, min_anchors,
                                    max_offset_jump)
    chains.sort(key=lambda c: -c.score)
    return chains


JUMP_WINDOW = 6  # anchors: a spurious in-insertion anchor splits one big
                 # offset jump into adjacent smaller ones; measure the
                 # excursion over a short anchor window, not per link


def windowed_offset_jump(qpos: np.ndarray, tpos: np.ndarray) -> int:
    """Largest |diagonal-offset| excursion over any <=JUMP_WINDOW-anchor
    window — the bend the banded region DP must contain."""
    off = qpos.astype(np.int64) - tpos.astype(np.int64)
    n = len(off)
    if n < 2:
        return 0
    best = 0
    for d in range(1, min(JUMP_WINDOW, n - 1) + 1):
        best = max(best, int(np.abs(off[d:] - off[:-d]).max()))
    return best


def _split_at_offset_jumps(chains: List[Chain], k: int, gap_cap: float,
                           min_anchors: int,
                           max_offset_jump: int) -> List[Chain]:
    """Split chains at offset excursions the banded region DP cannot
    contain (see module docstring).  Every link under an offending
    <=JUMP_WINDOW-anchor window is cut, so stray in-insertion anchors end
    up in mini sub-chains that the min_anchors filter drops; sub-chain
    scores are recomputed with the chain DP's own alpha/beta terms."""
    out: List[Chain] = []
    for c in chains:
        if c.n_anchors < 2:
            out.append(c)
            continue
        off = c.qpos.astype(np.int64) - c.tpos.astype(np.int64)
        n = c.n_anchors
        cut = np.zeros(n - 1, dtype=bool)
        for d in range(1, min(JUMP_WINDOW, n - 1) + 1):
            bad = np.abs(off[d:] - off[:-d]) > max_offset_jump
            for i in np.nonzero(bad)[0]:
                cut[i:i + d] = True
        cuts = np.nonzero(cut)[0]
        if cuts.size == 0:
            out.append(c)
            continue
        bounds = [0, *(cuts + 1).tolist(), c.n_anchors]
        for a, b in zip(bounds[:-1], bounds[1:]):
            if b - a < min_anchors:
                continue
            sq, st_ = c.qpos[a:b], c.tpos[a:b]
            ddq = np.diff(sq).astype(np.float64)
            ddt = np.diff(st_).astype(np.float64)
            alpha = np.minimum(np.minimum(ddq, ddt), k)
            dd = np.abs(ddq - ddt)
            beta = np.where(
                dd > 0,
                np.minimum(0.01 * k * dd + 0.5 * np.log2(dd + 1), gap_cap),
                0.0)
            out.append(Chain(qpos=sq, tpos=st_,
                             score=float(k + np.sum(alpha - beta)), k=k))
    return out
