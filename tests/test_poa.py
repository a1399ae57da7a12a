"""Banded partial-order consensus engine tests (native telr_poa_consensus,
the wtpoa-cns role — reference TELR_assembly.py:225-247)."""

import numpy as np
import pytest

from telr_jax.io import native
from telr_jax.kernels import dp

pytestmark = pytest.mark.skipif(not native.has_poa(),
                                reason="native POA not built")


def _identity(cons, truth):
    res = dp.align_pair(cons, truth, dp.GLOBAL, dp.DPParams(), width=2048)
    blk = dp.cigar_stats(res["cigar"])[3]
    m = dp.count_matches(cons, truth, res["cigar"])
    return m / blk if blk else 0.0


def _mutate(truth, rng, err, p_sub=0.25, p_ins=0.40, ins_extra=1,
            del_extra=1):
    out = []
    for b in truth:
        r = rng.random()
        if r < err * p_sub:
            out.append((b + 1 + rng.integers(0, 3)) % 4)
        elif r < err * (p_sub + p_ins):
            out.append(b)
            for _ in range(1 + int(rng.integers(0, ins_extra + 1))):
                out.append(rng.integers(0, 4))
        elif r < err:
            continue  # deletion
        else:
            out.append(b)
    return np.array(out, dtype=np.int8)


def test_clean_reads_identity():
    """Error-free reads reproduce the sequence exactly."""
    rng = np.random.default_rng(0)
    truth = rng.integers(0, 4, 800).astype(np.int8)
    reads = [truth.copy() for _ in range(5)]
    cons = native.poa_consensus(truth.copy(), reads, [0] * 5, [800] * 5)
    assert np.array_equal(cons, truth)


def test_majority_substitution():
    """A substitution carried by the backbone is out-voted by the reads."""
    rng = np.random.default_rng(1)
    truth = rng.integers(0, 4, 500).astype(np.int8)
    bb = truth.copy()
    bb[250] = (bb[250] + 1) % 4
    reads = [truth.copy() for _ in range(7)]
    cons = native.poa_consensus(bb, reads, [0] * 7, [500] * 7)
    assert np.array_equal(cons, truth)


def test_backbone_deletion_restored():
    """Bases missing from the BACKBONE come back — the case the pileup
    vote structurally cannot fix (its insertion events are gated)."""
    rng = np.random.default_rng(2)
    truth = rng.integers(0, 4, 600).astype(np.int8)
    bb = np.delete(truth, [100, 101, 102, 400])
    reads = [truth.copy() for _ in range(7)]
    cons = native.poa_consensus(bb.astype(np.int8), reads, [0] * 7,
                                [len(bb)] * 7)
    assert np.array_equal(cons, truth)


def test_minority_insertion_rejected():
    """An insertion supported by 1/7 reads does not enter the consensus
    (the majority-relative edge scoring; a raw edge-weight sum keeps
    multi-base detours)."""
    rng = np.random.default_rng(3)
    truth = rng.integers(0, 4, 500).astype(np.int8)
    noisy = np.concatenate([truth[:200],
                            rng.integers(0, 4, 6).astype(np.int8),
                            truth[200:]])
    reads = [truth.copy() for _ in range(6)] + [noisy]
    cons = native.poa_consensus(truth.copy(), reads, [0] * 7,
                                [500] * 7)
    assert np.array_equal(cons, truth)


@pytest.mark.parametrize("profile,err,kw", [
    ("pacbio", 0.10, dict(p_sub=0.25, p_ins=0.40, ins_extra=1,
                          del_extra=1)),
    ("ont", 0.12, dict(p_sub=0.20, p_ins=0.25, ins_extra=1, del_extra=3)),
])
def test_noisy_consensus_identity(profile, err, kw):
    """Two POA rounds reach wtpoa-class identity at 20x from a raw-read
    backbone (the pileup vote plateaus at ~0.94 on the ONT profile)."""
    rng = np.random.default_rng(4)
    truth = rng.integers(0, 4, 3000).astype(np.int8)
    reads = [_mutate(truth, rng, err, **kw) for _ in range(20)]
    cons = sorted(reads, key=len)[10]
    for _ in range(2):
        cons = native.poa_consensus(cons, reads, [0] * 20,
                                    [len(cons)] * 20, width=96)
    assert _identity(cons, truth) > 0.99


def test_segment_band_anchor():
    """Segments covering only part of the backbone anchor their band at
    their own span."""
    rng = np.random.default_rng(5)
    truth = rng.integers(0, 4, 2000).astype(np.int8)
    bb = truth.copy()
    bb[1500] = (bb[1500] + 2) % 4
    segs = [truth[0:1000].copy() for _ in range(4)] + \
           [truth[900:2000].copy() for _ in range(4)]
    c0s = [0] * 4 + [900] * 4
    c1s = [1000] * 4 + [2000] * 4
    cons = native.poa_consensus(bb, segs, c0s, c1s)
    assert np.array_equal(cons, truth)


def test_determinism():
    rng = np.random.default_rng(6)
    truth = rng.integers(0, 4, 1500).astype(np.int8)
    reads = [_mutate(truth, rng, 0.1) for _ in range(10)]
    a = native.poa_consensus(reads[0], reads, [0] * 10,
                             [len(reads[0])] * 10)
    b = native.poa_consensus(reads[0], reads, [0] * 10,
                             [len(reads[0])] * 10)
    assert np.array_equal(a, b)
