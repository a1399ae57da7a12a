"""Large-insertion alignment geometry: the band must contain the insertion's
diagonal-offset jump (mid-size insertions -> one full-length CIGAR I run) and
chains must split at jumps beyond the band cap (long insertions -> a
split-pair with the exact query gap).  Regression for the ONT eval failure
where 600bp/2900bp TEs were detected as ~120bp fragments and then dropped by
the TE homology filter."""

import numpy as np

from telr_jax.config import MAP_ONT
from telr_jax.io.seqs import SeqDict, Sequence
from telr_jax.kernels.mapper import Aligner


def _noisy(codes, rng, err=0.10):
    out = []
    for c in codes:
        r = rng.random()
        if r < err * 0.55:          # deletion-dominated ONT-like noise
            continue
        if r < err * 0.80:
            out.append(int(rng.integers(0, 4)))
        out.append(int(c))
        if rng.random() < err * 0.20:
            out.append(int(rng.integers(0, 4)))
    return np.array(out, dtype=np.int8)


def _read_codes(ins_len, seed=0):
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, 12000).astype(np.int8)
    te = rng.integers(0, 4, ins_len).astype(np.int8)
    bp = 6000
    return _noisy(np.concatenate([ref[2000:bp], te, ref[bp:10000]]), rng)


def _run(ins_len, seed=0):
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, 12000).astype(np.int8)
    read = _read_codes(ins_len, seed)
    aligner = Aligner(SeqDict([Sequence("ref", ref)]), MAP_ONT)
    return [a for a in aligner.map_seq("r0", read) if a.primary]


def test_mid_insertion_full_length_signature():
    """600bp insertion (INE-1 scale): one alignment whose merged insertion
    signature recovers >= 85% of the insert (chance in-TE k-mer matches may
    legitimately split the CIGAR I run; signature merging re-joins it)."""
    alns = _run(600)
    assert len(alns) == 1

    import dataclasses

    from telr_jax.config import SVConfig
    from telr_jax.io.seqs import SeqDict as SD
    from telr_jax.sv.detect import extract_signatures

    class _Store:
        def __init__(self, alns):
            self._alns = alns

        def all(self):
            return self._alns

    reads = SD([Sequence("r0", _read_codes(600))])
    sigs = extract_signatures(_Store(alns), reads, SVConfig())
    ins = [s for s in sigs if s.kind == "ins"]
    assert ins, sigs
    assert max(s.length for s in ins) >= 510, [
        (s.kind, s.length) for s in sigs]


def test_long_insertion_split_pair():
    """2900bp insertion (P-element scale): jump > max_offset_jump, so the
    chain splits -> two query-disjoint primaries with the exact query gap
    (the split-pair signature sv/detect.py consumes)."""
    alns = _run(2900)
    assert len(alns) == 2, [a.paf_row() for a in alns]
    alns = sorted(alns, key=lambda a: a.qstart)
    x, y = alns
    q_gap = y.qstart - x.qend
    t_gap = y.tstart - x.tend
    assert 2500 <= q_gap <= 3300, (q_gap, t_gap)
    assert abs(t_gap) <= 100, (q_gap, t_gap)
