"""Reference repeatmask behavior, including the per-family copy cap.

The copy cap (repeatmask_reference max_copies) must never truncate silently
(VERDICT r3 weak #6): a high-copy family that exceeds it produces a logged
warning, and raising the cap recovers the dropped copies.
"""

import logging

import numpy as np
import pytest

from telr_jax.annotate.repeatmask import repeatmask_reference
from telr_jax.io.seqs import SeqDict, Sequence, revcomp_codes


def _make_high_copy_genome(n_copies, te_len=400, spacer=300, seed=7):
    """A genome that is `n_copies` exact copies of one TE separated by
    random spacers (alternating strands so strand handling is exercised)."""
    rng = np.random.default_rng(seed)
    te = rng.integers(0, 4, te_len, dtype=np.int8)
    parts = [rng.integers(0, 4, spacer, dtype=np.int8)]
    truth = []
    pos = spacer
    for i in range(n_copies):
        strand = "+" if i % 2 == 0 else "-"
        parts.append(te if strand == "+" else revcomp_codes(te))
        truth.append((pos, pos + te_len, strand))
        parts.append(rng.integers(0, 4, spacer, dtype=np.int8))
        pos += te_len + spacer
    genome = SeqDict([Sequence("chrH", np.concatenate(parts))])
    library = SeqDict([Sequence("HICOPY", te)])
    return genome, library, truth


def test_high_copy_family_all_found():
    genome, library, truth = _make_high_copy_genome(12)
    bed = repeatmask_reference(genome, library)
    rows = [bed.row(i) for i in range(len(bed))]
    assert len(rows) == len(truth)
    got = sorted((int(r[1]), int(r[2]), r[5]) for r in rows)
    for (gs, ge, gst), (ts, te_, tst) in zip(got, sorted(truth)):
        assert abs(gs - ts) <= 25 and abs(ge - te_) <= 25
        assert gst == tst


def test_copy_cap_logs_and_raising_recovers(caplog):
    genome, library, truth = _make_high_copy_genome(12)
    with caplog.at_level(logging.WARNING, logger="TELR"):
        capped = repeatmask_reference(genome, library, max_copies=5)
    assert len(capped) == 5
    assert any("cap" in rec.getMessage() for rec in caplog.records), \
        "cap hit must be logged"
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger="TELR"):
        full = repeatmask_reference(genome, library, max_copies=100)
    assert len(full) == len(truth)
    assert not caplog.records, "no warning when under the cap"


@pytest.mark.parametrize("P", [2, 3])
def test_job_sharded_repeatmask_bit_identical(P):
    """Chain-job sharding (the P-process distribution axis for this
    stage) reproduces the serial result exactly: every process plans the
    identical job list, aligns its ji % P share, and the merged
    postprocess sees the same ordered list (dist/runner.py ref_repeatmask)."""
    import dataclasses as _dc

    from telr_jax.config import LIB_TO_SEQ
    from telr_jax.kernels.mapper import Aligner, map_batch_grouped

    genome, library, truth = _make_high_copy_genome(9)
    # add a second, low-copy family so the job list spans families
    rng = np.random.default_rng(3)
    te2 = rng.integers(0, 4, 350, dtype=np.int8)
    g2 = np.concatenate([genome["chrH"].codes,
                         te2, rng.integers(0, 4, 200, dtype=np.int8)])
    genome = SeqDict([Sequence("chrH", g2)])
    library = SeqDict([library["HICOPY"], Sequence("LOWCOPY", te2)])

    want = repeatmask_reference(genome, library)

    preset = _dc.replace(LIB_TO_SEQ, max_secondary=4000)
    al = Aligner(genome, preset, max_occ=4096)
    queries = {s.name: s.codes for s in library}
    parts = [map_batch_grouped([(al, queries)], max_hits=4000,
                               job_shard=(p, P), raw=True)[0]
             for p in range(P)]
    # every shard's job list must be the same length and only own slots
    # may be filled
    assert len({len(pt) for pt in parts}) == 1
    for p, pt in enumerate(parts):
        for ji, (_q, aln) in enumerate(pt):
            if ji % P != p:
                assert aln is None

    got = repeatmask_reference(genome, library, shard=(0, P),
                               allgather=lambda mine: parts)
    assert len(got) == len(want)
    for i in range(len(want)):
        assert got.row(i) == want.row(i)
