"""Sequence encoding and fasta round-trip tests."""

import numpy as np

from telr_jax.io.fasta import iter_fasta, read_fasta, write_fasta
from telr_jax.io.seqs import (SeqDict, Sequence, decode, encode, pad_batch,
                              revcomp_codes, revcomp_str)


def test_encode_decode_roundtrip():
    s = "ACGTNacgtnXYZ"
    codes = encode(s)
    assert list(codes) == [0, 1, 2, 3, 4, 0, 1, 2, 3, 4, 4, 4, 4]
    assert decode(codes) == "ACGTNACGTNNNN"


def test_revcomp():
    assert revcomp_str("ACGTN") == "NACGT"
    assert revcomp_str("AACCGGTT") == "AACCGGTT"[::-1].translate(
        str.maketrans("ACGT", "TGCA"))


def test_bundled_data_roundtrip(tmp_path):
    reads = read_fasta("/root/reference/test/reads.fasta")
    assert len(reads) == 18
    total = sum(len(s) for s in reads)
    assert 220_000 < total < 240_000
    lib = read_fasta("/root/reference/test/library.fasta")
    assert lib.names() == ["jockey"]
    assert len(lib["jockey"]) == 5020
    ref = read_fasta("/root/reference/test/ref_38kb.fasta")
    assert len(ref["chr2L"]) == 38001

    out = tmp_path / "rt.fa"
    write_fasta(reads, str(out))
    back = read_fasta(str(out))
    assert back.names() == reads.names()
    for s in reads:
        assert np.array_equal(back[s.name].codes, s.codes)


def test_seqdict_fetch_clipping():
    d = SeqDict([Sequence.from_str("x", "ACGTACGT")])
    assert d.fetch_str("x", 2, 5) == "GTA"
    assert d.fetch_str("x", -5, 3) == "ACG"
    assert d.fetch_str("x", 6, 100) == "GT"
    assert d.fetch_str("x", 5, 5) == ""


def test_dedup_keeps_first():
    d = SeqDict()
    d.add(Sequence.from_str("a", "AAAA"))
    d.add(Sequence.from_str("a", "CCCC"), dedup=True)
    assert d["a"].seq == "AAAA"


def test_pad_batch():
    arrs = [encode("ACGT"), encode("AA"), encode("ACGTACGTA")]
    mat, lens = pad_batch(arrs, pad_to=6)
    assert mat.shape == (3, 6)
    assert list(lens) == [4, 2, 6]
    assert mat[1, 2] == 4  # N padding


def test_fastq(tmp_path):
    fq = tmp_path / "r.fastq"
    fq.write_text("@r1 desc\nACGT\n+\nIIII\n@r2\nGGCC\n+\nIIII\n")
    d = read_fasta(str(fq))
    assert d.names() == ["r1", "r2"]
    assert d["r1"].seq == "ACGT"
