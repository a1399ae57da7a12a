"""SAM boundary import/export round-trip tests."""

import numpy as np

from telr_jax.config import MAP_PB
from telr_jax.core.alignstore import AlignmentStore
from telr_jax.io.samio import parse_cigar, read_sam, write_sam
from telr_jax.io.seqs import SeqDict, Sequence, revcomp_codes
from telr_jax.kernels.mapper import Aligner


def test_parse_cigar_folding():
    assert parse_cigar("10M2I3M") == [("M", 10), ("I", 2), ("M", 3)]
    assert parse_cigar("5=1X4=") == [("M", 10)]
    assert parse_cigar("10M100N10M") == [("M", 10), ("D", 100), ("M", 10)]
    assert parse_cigar("5S10M3H") == [("M", 10)]


def test_sam_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    ref_codes = rng.integers(0, 4, 5000).astype(np.int8)
    ref = SeqDict([Sequence("chrR", ref_codes)])
    aligner = Aligner(ref, MAP_PB)
    reads = SeqDict()
    alns = []
    for i in range(4):
        s = 500 + i * 800
        codes = ref_codes[s:s + 700].copy()
        if i % 2:
            codes = revcomp_codes(codes)
        reads.add(Sequence(f"r{i}", codes))
        alns.extend(aligner.map_seq(f"r{i}", codes))
    store = AlignmentStore(alns)

    sam = tmp_path / "out.sam"
    write_sam(store, reads, str(sam), tlens={"chrR": 5000})
    back_store, back_reads = read_sam(str(sam))

    a1 = sorted(store.all(), key=lambda a: (a.qname, a.tstart, not a.primary))
    a2 = sorted(back_store.all(),
                key=lambda a: (a.qname, a.tstart, not a.primary))
    assert len(a1) == len(a2)
    for x, y in zip(a1, a2):
        assert (x.qname, x.strand, x.tname, x.tstart, x.tend, x.cigar,
                x.qstart, x.qend, x.qlen, x.primary) == \
               (y.qname, y.strand, y.tname, y.tstart, y.tend, y.cigar,
                y.qstart, y.qend, y.qlen, y.primary)
    # reads reconstructed in original orientation
    for s in reads:
        assert s.name in back_reads
        assert np.array_equal(back_reads[s.name].codes, s.codes)
    # coverage identical
    assert np.array_equal(store.coverage("chrR", 0, 5000),
                          back_store.coverage("chrR", 0, 5000))


def _toy_store(n=4, L=5000):
    rng = np.random.default_rng(1)
    ref_codes = rng.integers(0, 4, L).astype(np.int8)
    ref = SeqDict([Sequence("chrR", ref_codes)])
    aligner = Aligner(ref, MAP_PB)
    reads = SeqDict()
    alns = []
    for i in range(n):
        s = 500 + i * 800
        codes = ref_codes[s:s + 700].copy()
        if i % 2:
            codes = revcomp_codes(codes)
        reads.add(Sequence(f"r{i}", codes))
        alns.extend(aligner.map_seq(f"r{i}", codes))
    return AlignmentStore(alns), reads, ref


def test_bam_roundtrip(tmp_path):
    from telr_jax.io.samio import read_bam, write_bam
    store, reads, _ = _toy_store()
    bam = tmp_path / "out.bam"
    write_bam(store, reads, str(bam), tlens={"chrR": 5000})
    back_store, back_reads = read_bam(str(bam))
    a1 = sorted(store.all(), key=lambda a: (a.qname, a.tstart, not a.primary))
    a2 = sorted(back_store.all(),
                key=lambda a: (a.qname, a.tstart, not a.primary))
    assert len(a1) == len(a2)
    for x, y in zip(a1, a2):
        assert (x.qname, x.strand, x.tname, x.tstart, x.tend, x.cigar,
                x.qstart, x.qend, x.qlen, x.primary, x.mapq) == \
               (y.qname, y.strand, y.tname, y.tstart, y.tend, y.cigar,
                y.qstart, y.qend, y.qlen, y.primary, y.mapq)
    for s in reads:
        assert np.array_equal(back_reads[s.name].codes, s.codes)


def test_bam_readable_by_pysam_equivalent(tmp_path):
    """The BGZF container must be plain-gzip decompressible with intact
    magic + reference dictionary (external-tool compatibility surface)."""
    import gzip as _gzip
    import struct as _struct
    from telr_jax.io.samio import write_bam
    store, reads, _ = _toy_store(n=2)
    bam = tmp_path / "out.bam"
    write_bam(store, reads, str(bam), tlens={"chrR": 5000})
    data = _gzip.open(str(bam), "rb").read()
    assert data[:4] == b"BAM\x01"
    (l_text,) = _struct.unpack_from("<i", data, 4)
    text = data[8:8 + l_text].decode()
    assert "SN:chrR" in text and "LN:5000" in text


def test_prealigned_pipeline_input(tmp_path):
    """A .bam reads input skips the alignment stage and produces the same
    calls as the fasta path (reference TELR_input.py:299-305)."""
    from telr_jax.io.fasta import write_fasta
    from telr_jax.io.samio import write_bam
    from telr_jax.pipeline import run_pipeline
    import os
    ref_dir = "/root/reference/test"
    if not os.path.isdir(ref_dir):
        import pytest
        pytest.skip("bundled dataset unavailable")
    from telr_jax.io.fasta import read_fasta
    from telr_jax.config import default_config, MAP_PB as _PB
    reads = read_fasta(os.path.join(ref_dir, "reads.fasta"))
    reference = read_fasta(os.path.join(ref_dir, "ref_38kb.fasta"))
    aligner = Aligner(reference, _PB)
    result = aligner.map_batch({s.name: s.codes for s in reads})
    store = AlignmentStore([a for h in result.values() for a in h])
    bam = tmp_path / "reads.bam"
    write_bam(store, reads, str(bam), tlens=reference.sizes())
    out = tmp_path / "out"
    res = run_pipeline(str(bam), os.path.join(ref_dir, "ref_38kb.fasta"),
                       os.path.join(ref_dir, "library.fasta"), str(out),
                       default_config())
    assert len(res.final_report) == 1
    entry = res.final_report[0]
    assert entry["family"] == "jockey"
    assert entry["type"] == "non-reference"
    assert abs(entry["start"] - 33018) <= 30
