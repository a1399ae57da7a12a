"""Device-side pileup consensus vote (the wtpoa-cns replacement's hot half).

The consensus stage (reference wtpoa-cns, TELR_assembly.py:225-247 + polish
loop 185-260) is realign + column vote.  Realignment already runs through the
shared DP kernels; this module moves the *vote* onto the device too, as dense
XLA ops over padded per-locus alignment batches:

  1. host packs each alignment's CIGAR as (op, len) run arrays + the
     strand-oriented query codes (ragged -> bucketed padded shapes),
  2. one jitted kernel per bucket shape expands runs to per-column labels
     (base 0..4 / deletion / uncovered) with a vectorized searchsorted over
     run end offsets — no scatter, no host bincount — and reduces them to
     per-column base votes, deletion votes and coverage, then applies the
     backbone-tie / no-vote / deletion-majority rules,
  3. loci that share a bucket shape are stacked and vmapped so a polish
     round over hundreds of loci issues a handful of device calls, all
     dispatched asynchronously before any result is collected.

Insertion events (ragged, a handful per locus) stay host-side; they are read
straight off the run boundaries.

Parity: bit-identical to assembly.local.consensus_vote (the numpy reference
implementation) — pinned by tests/test_device_vote.py.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Sequence, Tuple

import numpy as np

OP_M, OP_I, OP_D, OP_PAD = 0, 1, 2, 3
_OP_CODE = {"M": OP_M, "I": OP_I, "D": OP_D}


def _bucket(n: int, step: int) -> int:
    """Power-of-two padded size with floor `step`.

    Each distinct padded shape is a separate jit key and compile;
    geometric bucketing bounds keys to ~4 per axis, and the vote kernel
    is cheap elementwise work, so <=2x padding costs far less than one
    recompile."""
    b = step
    while b < n:
        b *= 2
    return b


def leftshift_ins(backbone: np.ndarray, tj: int,
                  seq: np.ndarray) -> Tuple[int, np.ndarray]:
    """VCF-style left normalization of an insertion event: rotate the
    inserted sequence left while the preceding backbone base equals its
    last base.  The DP places an insertion anywhere inside a repeat
    context; normalizing makes every read's restoration of the same
    deleted base vote on the SAME column."""
    while seq.size and tj > 0 and backbone[tj - 1] == seq[-1]:
        seq = np.concatenate([seq[-1:], seq[:-1]])
        tj -= 1
    return tj, seq


@functools.lru_cache(maxsize=None)
def _vote_jit(a_pad: int, r_pad: int, q_pad: int, n_pad: int):
    """Bucket-shaped jitted vote kernel; cached per padded shape."""
    import jax
    import jax.numpy as jnp

    def one_locus(qcodes, opcode, oplen, qstart, tstart, backbone):
        # qcodes (A,Q) int8, opcode/oplen (A,R), qstart/tstart (A,),
        # backbone (N,) int8
        cols = jnp.arange(n_pad, dtype=jnp.int32)
        tcons = jnp.where((opcode == OP_M) | (opcode == OP_D), oplen, 0)
        qcons = jnp.where((opcode == OP_M) | (opcode == OP_I), oplen, 0)
        tend = tstart[:, None] + jnp.cumsum(tcons, axis=1)          # (A,R)
        tbeg = tend - tcons
        qbeg = qstart[:, None] + jnp.cumsum(qcons, axis=1) - qcons
        # covering run for column j = first r with tend[r] > j; zero-length
        # (I / pad) runs never win because their tbeg == tend
        run = jax.vmap(
            lambda e: jnp.searchsorted(e, cols, side="right"))(tend)
        run_c = jnp.minimum(run, r_pad - 1).astype(jnp.int32)
        op_j = jnp.take_along_axis(opcode, run_c, axis=1)
        tb_j = jnp.take_along_axis(tbeg, run_c, axis=1)
        qb_j = jnp.take_along_axis(qbeg, run_c, axis=1)
        covered = ((run < r_pad) & (tb_j <= cols[None, :])
                   & (op_j != OP_PAD) & (op_j != OP_I))
        qidx = jnp.clip(qb_j + (cols[None, :] - tb_j), 0, q_pad - 1)
        base = jnp.take_along_axis(
            qcodes, qidx, axis=1).astype(jnp.int32)
        # label: 0..4 base vote (4 = N base), 5 deletion, 6 uncovered
        lab = jnp.where(covered,
                        jnp.where(op_j == OP_D, 5, base), 6)
        cov = jnp.sum((lab <= 5).astype(jnp.int32), axis=0)       # (N,)
        delv = jnp.sum((lab == 5).astype(jnp.int32), axis=0)
        votes = jnp.sum(
            (lab[:, :, None] == jnp.arange(5)[None, None, :]
             ).astype(jnp.int32), axis=0)                          # (N,5)
        bb = jnp.clip(backbone.astype(jnp.int32), 0, 4)
        best = jnp.argmax(votes, axis=1).astype(jnp.int32)
        vbest = jnp.take_along_axis(votes, best[:, None], 1)[:, 0]
        vbb = jnp.take_along_axis(votes, bb[:, None], 1)[:, 0]
        best = jnp.where(vbest == vbb, bb, best)
        best = jnp.where(jnp.sum(votes, axis=1) == 0, bb, best)
        keep = ~(delv * 2 > cov)
        return best.astype(jnp.int8), keep, cov, delv

    return jax.jit(jax.vmap(one_locus))


class _PackedLocus:
    __slots__ = ("qcodes", "opcode", "oplen", "qstart", "tstart",
                 "backbone", "n", "ins_seqs", "n_reads")

    def __init__(self, backbone: np.ndarray, alignments) -> None:
        from telr_jax.assembly.local import _oriented
        n = len(backbone)
        a_n = len(alignments)
        r_max = max(len(a.cigar) for a, _ in alignments)
        q_max = max(a.qlen for a, _ in alignments)
        qcodes = np.zeros((a_n, q_max), dtype=np.int8)
        opcode = np.full((a_n, r_max), OP_PAD, dtype=np.int8)
        oplen = np.zeros((a_n, r_max), dtype=np.int32)
        qstart = np.zeros(a_n, dtype=np.int32)
        tstart = np.zeros(a_n, dtype=np.int32)
        ins: Dict[int, List[np.ndarray]] = {}
        for i, (a, codes) in enumerate(alignments):
            qc, qi = _oriented(a, codes)
            qcodes[i, : len(qc)] = qc
            qstart[i] = qi
            tstart[i] = a.tstart
            tj = a.tstart
            for r, (op, ln) in enumerate(a.cigar):
                opcode[i, r] = _OP_CODE[op]
                oplen[i, r] = ln
                if op == "I":
                    js, sq = leftshift_ins(backbone, tj, qc[qi:qi + ln])
                    ins.setdefault(js, []).append(sq)
                    qi += ln
                elif op == "M":
                    qi += ln
                    tj += ln
                else:
                    tj += ln
        self.qcodes = qcodes
        self.opcode = opcode
        self.oplen = oplen
        self.qstart = qstart
        self.tstart = tstart
        self.backbone = np.asarray(backbone, dtype=np.int8)
        self.n = n
        self.ins_seqs = ins
        self.n_reads = a_n

    def buckets(self) -> Tuple[int, int, int, int]:
        return (_bucket(self.n_reads, 8), _bucket(self.opcode.shape[1], 32),
                _bucket(self.qcodes.shape[1], 2048), _bucket(self.n, 2048))


_INS_CONSENSUS_MAX = 400   # events longer than this keep the representative
                           # read segment (they are whole-TE splices from a
                           # non-spanning backbone, individually alignable)


def _ins_event_consensus(seqs: List[np.ndarray]) -> np.ndarray:
    """Consensus of one insertion event's supporting sequences.

    The former rule spliced the median-length supporter VERBATIM — raw
    read bases, so every junction-adjacent event inherited that read's
    error rate (~12% on ONT), which is exactly where TSD bases live
    (reference wtpoa-cns computes a POA consensus here,
    TELR_assembly.py:225-247).  Column vote: align every supporter to the
    median-length representative (tiny global DPs), vote M-run bases and
    deletions per column, restore sub-majority-deleted columns by nested
    insertion majority."""
    if len(seqs) == 1:
        return seqs[0].astype(np.int8)
    from collections import Counter
    counts = Counter(s.tobytes() for s in seqs)
    top, cnt = counts.most_common(1)[0]
    if 2 * cnt > len(seqs):
        return np.frombuffer(top, dtype=np.int8).copy()
    lens = sorted(range(len(seqs)), key=lambda i: len(seqs[i]))
    rep = seqs[lens[len(lens) // 2]].astype(np.int8)
    if len(rep) > _INS_CONSENSUS_MAX or len(rep) == 0:
        return rep
    from telr_jax.kernels import dp
    params = dp.DPParams()
    n = len(rep)
    votes = np.zeros((n, 5), dtype=np.int32)
    delv = np.zeros(n, dtype=np.int32)
    cov = np.zeros(n, dtype=np.int32)
    nested: Dict[int, List[np.ndarray]] = {}
    items = [(s.astype(np.int8), rep, dp.GLOBAL, params, None, None)
             for s in seqs]
    for s, res in zip(seqs, dp.align_pairs(items, cigar_arrays=True)):
        qi = tj = 0
        ops, ls = dp.cigar_to_arrays(res["cigar"])
        for op, ln in zip(ops.tolist(), ls.tolist()):
            if op == 0:    # M
                votes[np.arange(tj, tj + ln),
                      s[qi:qi + ln].astype(np.int64)] += 1
                cov[tj:tj + ln] += 1
                qi += ln
                tj += ln
            elif op == 1:  # D
                delv[tj:tj + ln] += 1
                cov[tj:tj + ln] += 1
                tj += ln
            else:          # I
                js, sq = leftshift_ins(rep, tj, s[qi:qi + ln])
                nested.setdefault(js, []).append(sq)
                qi += ln
    col = np.arange(n)
    bb = rep.astype(np.int64)
    best = votes.argmax(axis=1)
    best = np.where(votes[col, best] == votes[col, bb], bb, best)
    best = np.where(votes.sum(axis=1) == 0, bb, best).astype(np.int8)
    keep = ~(delv * 2 > cov)
    parts: List[np.ndarray] = []
    prev = 0
    for j in sorted(nested):
        sqs = nested[j]
        if 2 * len(sqs) <= int(cov[j] if j < n else len(seqs)):
            continue
        jl = sorted(len(x) for x in sqs)
        med = jl[len(jl) // 2]
        sq = min(sqs, key=lambda x: abs(len(x) - med))
        parts.append(best[prev:j][keep[prev:j]])
        parts.append(sq.astype(np.int8))
        prev = j
    parts.append(best[prev:][keep[prev:]])
    return np.concatenate(parts).astype(np.int8)


def finalize_consensus(backbone: np.ndarray, best: np.ndarray,
                       keep: np.ndarray, cov: np.ndarray,
                       ins_seqs: Dict[int, List[np.ndarray]],
                       n_reads: int, min_cov: int = 2) -> np.ndarray:
    """Tip trimming + insertion-event splice (ragged host tail of the vote;
    shared with the numpy path — semantics of consensus_vote steps 3-4)."""
    covered = np.nonzero(cov >= (min_cov if n_reads > 2 else 1))[0]
    if covered.size == 0:
        return np.zeros(0, dtype=np.int8)
    lo, hi = int(covered[0]), int(covered[-1]) + 1
    best = best[lo:hi].astype(np.int8)
    keep = keep[lo:hi]
    events: List[Tuple[int, np.ndarray]] = []
    weak: List[int] = []
    for j in sorted(ins_seqs):
        if not (lo < j < hi):
            continue
        seqs = ins_seqs[j]
        if 2 * len(seqs) > int(cov[j]):
            events.append((j, _ins_event_consensus(seqs)))
        else:
            weak.append(j)
    # adjacent-column pooling of sub-majority insertions: a deleted
    # backbone base is restored by reads inserting it back, but alignment
    # ambiguity scatters those insertions over neighbouring columns, so no
    # single column reaches majority and the base stays lost (observed on
    # deletion-dominated ONT noise as ~7% contig shrinkage).  Columns that
    # individually failed the gate pool with neighbours within 2 columns.
    # Pooled events demand a 2/3 SUPERMAJORITY: genuine restorations carry
    # ~90% of coverage split over the window, while homopolymer insertion
    # noise piles (PacBio CLR) reach 30-45% — a bare pooled majority tips
    # those piles and bloats the contig instead.
    taken = {j for j, _ in events}
    cluster: List[int] = []
    for j in weak + [hi + 10]:
        if cluster and (j - cluster[-1] > 2 or j >= hi):
            if not any(c in taken or c - 1 in taken or c + 1 in taken
                       for c in cluster):
                seqs = [s for c in cluster for s in ins_seqs[c]]
                jm = cluster[len(cluster) // 2]
                if 3 * len(seqs) > 2 * int(cov[jm]):
                    events.append((cluster[0],
                                   _ins_event_consensus(seqs)))
            cluster = []
        if j < hi:
            cluster.append(j)
    events.sort(key=lambda e: e[0])
    parts: List[np.ndarray] = []
    prev = lo
    for j, seq in events + [(hi, None)]:
        m = keep[prev - lo:j - lo]
        parts.append(best[prev - lo:j - lo][m])
        if seq is not None:
            parts.append(seq)
        prev = j
    out = np.concatenate(parts) if parts else np.zeros(0, dtype=np.int8)
    return out.astype(np.int8)


def vote_many(items: Sequence[Tuple[np.ndarray, list]],
              min_cov: int = 2) -> List[np.ndarray]:
    """Batched device consensus over (backbone, alignments) loci.

    Loci sharing a padded bucket shape are stacked into one vmapped device
    call; every call is dispatched before any result is collected, so the
    device pipeline stays full.
    Returns one consensus codes array per locus (same contract as
    consensus_vote per locus).
    """
    import jax

    packed = [_PackedLocus(bb, alns) for bb, alns in items]
    groups: Dict[Tuple[int, int, int, int], List[int]] = {}
    for i, p in enumerate(packed):
        groups.setdefault(p.buckets(), []).append(i)

    pending = []
    for (a_b, r_b, q_b, n_b), idxs in groups.items():
        k = len(idxs)
        qcodes = np.zeros((k, a_b, q_b), dtype=np.int8)
        opcode = np.full((k, a_b, r_b), OP_PAD, dtype=np.int8)
        oplen = np.zeros((k, a_b, r_b), dtype=np.int32)
        qstart = np.zeros((k, a_b), dtype=np.int32)
        tstart = np.zeros((k, a_b), dtype=np.int32)
        backbone = np.zeros((k, n_b), dtype=np.int8)
        for s, i in enumerate(idxs):
            p = packed[i]
            a_n, r_n = p.opcode.shape
            qcodes[s, :a_n, : p.qcodes.shape[1]] = p.qcodes
            opcode[s, :a_n, :r_n] = p.opcode
            oplen[s, :a_n, :r_n] = p.oplen
            qstart[s, :a_n] = p.qstart
            tstart[s, :a_n] = p.tstart
            # padded alignment rows are all-OP_PAD -> label 6 everywhere
            backbone[s, : p.n] = p.backbone
        fn = _vote_jit(a_b, r_b, q_b, n_b)
        out = fn(qcodes, opcode, oplen, qstart, tstart, backbone)
        pending.append((idxs, out))

    results: List[np.ndarray] = [None] * len(packed)  # type: ignore
    for idxs, (best, keep, cov, delv) in pending:
        best = np.asarray(best)
        keep = np.asarray(keep)
        cov = np.asarray(cov)
        for s, i in enumerate(idxs):
            p = packed[i]
            results[i] = finalize_consensus(
                p.backbone, best[s, : p.n], keep[s, : p.n], cov[s, : p.n],
                p.ins_seqs, p.n_reads, min_cov)
    return results
