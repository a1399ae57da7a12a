"""Checkpoint / resume round-trip tests."""

import numpy as np

from telr_jax.core.alignstore import AlignmentStore
from telr_jax.io.seqs import SeqDict, Sequence
from telr_jax.kernels.mapper import Alignment
from telr_jax.ops.intervals import Intervals
from telr_jax.sv.detect import SVRecord
from telr_jax.utils.checkpoint import Checkpointer


def _aln(name, tstart):
    return Alignment(qname=name, qlen=100, qstart=0, qend=100, strand="+",
                     tname="chr", tlen=1000, tstart=tstart, tend=tstart + 90,
                     matches=85, blocklen=95, mapq=60, score=150,
                     cigar=[("M", 40), ("I", 5), ("M", 30), ("D", 5),
                            ("M", 20)], primary=True)


def test_alignment_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path))
    store = AlignmentStore([_aln("r1", 10), _aln("r2", 500)])
    ck.save_alignments("alignment", store)
    assert ck.has("alignment")
    back = ck.load_alignments("alignment")
    a1 = list(store.all())
    a2 = list(back.all())
    assert len(a1) == len(a2)
    for x, y in zip(a1, a2):
        assert x == y
    # depth identical
    assert np.array_equal(store.coverage("chr", 0, 600),
                          back.coverage("chr", 0, 600))


def test_records_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path))
    recs = [SVRecord(chrom="c", start=5, end=5, length=300, coverage=4,
                     af=0.5, sv_id="0", seq="ACGT" * 75, reads=["a", "b"],
                     sv_filter="PASS", genotype="0/1", ref_count=4,
                     alt_count=4, ins_te_prop=0.9, ins_te_family="fam",
                     ins_te_strand="+")]
    ck.save_records("te_filter", recs)
    back = ck.load_records("te_filter")
    assert back == recs


def test_seqs_and_intervals_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path))
    seqs = SeqDict([Sequence.from_str("ctg1", "ACGTACGT", "len=8")])
    ck.save_seqs("assembly", seqs, {"passed": ["ctg1"]})
    back, extra = ck.load_seqs("assembly")
    assert back["ctg1"].seq == "ACGTACGT"
    assert extra == {"passed": ["ctg1"]}

    iv = Intervals.from_rows([("c", 1, 9, "fam", ".", "+")],
                             ("family", "score", "strand"))
    ck.save_intervals("annotation", iv)
    b2 = ck.load_intervals("annotation")
    assert b2.chrom == iv.chrom
    assert list(b2.start) == list(iv.start)
    assert b2.cols == iv.cols


def test_disabled_checkpointer_is_noop(tmp_path):
    ck = Checkpointer(None)
    ck.save_json("x", {"a": 1})
    assert not ck.has("x")
    assert ck.completed() == []


def test_manifest_ordering(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save_json("s1", 1)
    ck.save_json("s2", 2)
    assert ck.completed() == ["s1", "s2"]
    assert ck.load_json("s2") == 2


def test_concurrent_runs_same_dir_rejected(tmp_path):
    import pytest
    ck = Checkpointer(str(tmp_path))
    with pytest.raises(RuntimeError, match="locked by another"):
        Checkpointer(str(tmp_path))
    ck.close()
    ck2 = Checkpointer(str(tmp_path))  # released lock is reacquirable
    ck2.close()


def test_stale_run_cannot_publish_under_new_fingerprint(tmp_path):
    """A run whose inputs were superseded mid-flight (another run
    re-fingerprinted the shared manifest) must neither mark its stages
    nor see the other run's stages as resumable — observed failure mode:
    contigs assembled from a different genome grafted into the calls."""
    old = Checkpointer(str(tmp_path), lock=False)
    old.validate_fingerprint("fp-old")
    old.save_json("alignment", {"who": "old"})
    assert old.has("alignment")

    new = Checkpointer(str(tmp_path), lock=False)
    assert not new.validate_fingerprint("fp-new")  # invalidated
    assert not new.has("alignment")

    # the old run keeps computing and tries to publish a later stage
    old.save_json("te_filter", {"who": "old"})
    assert not old.has("te_filter")          # refused: fingerprint changed
    assert not new.has("te_filter")          # and the new run never sees it
    assert new.completed() == []
