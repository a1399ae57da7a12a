"""Multi-locus end-to-end test on a synthetic genome.

Builds a 120kb genome with three TE insertions from a two-family library
(one homozygous, one heterozygous, one from the second family), simulates
noisy long reads, and checks the pipeline recovers all three with correct
families and plausible zygosity.
"""

import os

import numpy as np
import pytest

from telr_jax.config import default_config, SVConfig, TELRConfig, AssemblyConfig
from telr_jax.io.fasta import write_fasta
from telr_jax.io.seqs import Sequence, decode, revcomp_codes
from telr_jax.pipeline import run_pipeline

pytestmark = pytest.mark.e2e


def _noisy(rng, codes, err=0.04):
    out = []
    for c in codes:
        r = rng.random()
        if r < err / 3:
            continue
        if r < 2 * err / 3:
            out.append(rng.integers(0, 4))
        if rng.random() < err / 3:
            out.append(rng.integers(0, 4))
        else:
            out.append(c)
    return np.array(out, dtype=np.int8)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    rng = np.random.default_rng(99)
    d = tmp_path_factory.mktemp("sim")
    G = 120_000
    ref = rng.integers(0, 4, G).astype(np.int8)
    te1 = rng.integers(0, 4, 2_000).astype(np.int8)
    te2 = rng.integers(0, 4, 1_200).astype(np.int8)

    # sample genome: te1 at 30k (hom), te1 revcomp at 70k (het), te2 at 100k
    sites = [(30_000, te1, True), (70_000, revcomp_codes(te1), False),
             (100_000, te2, True)]

    def build_hap(with_het):
        parts, prev = [], 0
        for pos, te, always in sites:
            if always or with_het:
                parts.append(ref[prev:pos])
                parts.append(te)
                prev = pos
        parts.append(ref[prev:])
        return np.concatenate(parts)

    hap_ins = build_hap(True)     # all three insertions
    hap_ref = build_hap(False)    # het site absent

    reads = []
    k = 0
    readlen = 12_000
    for hap in (hap_ins, hap_ins, hap_ref):  # ~2:1 -> af het ~0.66
        n = len(hap)
        for start in range(0, n - readlen, 3_500):
            seq = _noisy(rng, hap[start:start + readlen])
            if k % 3 == 2:
                seq = revcomp_codes(seq)
            reads.append(Sequence(f"read{k}", seq))
            k += 1

    write_fasta([Sequence("chrS", ref)], str(d / "ref.fa"))
    write_fasta(reads, str(d / "reads.fa"))
    write_fasta([Sequence("alpha", te1), Sequence("beta", te2)],
                str(d / "lib.fa"))
    return d


def test_three_insertions_recovered(dataset):
    cfg = TELRConfig(sv=SVConfig(min_support=3),
                     assembly=AssemblyConfig(polish_iterations=1))
    res = run_pipeline(str(dataset / "reads.fa"), str(dataset / "ref.fa"),
                       str(dataset / "lib.fa"), str(dataset / "out"),
                       config=cfg)
    calls = {(r["family"], round(r["start"], -2)) for r in res.final_report}
    found_pos = sorted(r["start"] for r in res.final_report)
    # all three sites, right families
    fams = [r["family"] for r in sorted(res.final_report,
                                        key=lambda r: r["start"])]
    assert len(res.final_report) == 3, (res.final_report, res.summary)
    assert abs(found_pos[0] - 30_000) < 100
    assert abs(found_pos[1] - 70_000) < 100
    assert abs(found_pos[2] - 100_000) < 100
    assert fams == ["alpha", "alpha", "beta"]

    by_pos = {round(r["start"], -3): r for r in res.final_report}
    hom1 = by_pos[30_000]
    het = by_pos[70_000]
    # hom sites supported by ~all reads, het by ~2/3
    assert hom1["allele_frequency"] is None or hom1["allele_frequency"] > 0.7
    if het["allele_frequency"] is not None:
        assert 0.3 < het["allele_frequency"] < 0.95


def test_two_chromosomes(tmp_path):
    """Insertions of the SAME family on two chromosomes: per-chrom flank
    filtering, cross-chrom homology, and per-chrom dedup must all hold
    (real runs are multi-chromosome; the evals are single-chrom)."""
    rng = np.random.default_rng(123)
    G = 60_000
    refA = rng.integers(0, 4, G).astype(np.int8)
    refB = rng.integers(0, 4, G).astype(np.int8)
    te = rng.integers(0, 4, 1_500).astype(np.int8)

    def with_ins(ref, pos):
        return np.concatenate([ref[:pos], te, ref[pos:]])

    hapA = with_ins(refA, 25_000)
    hapB = with_ins(refB, 40_000)
    reads = []
    k = 0
    readlen = 10_000
    for hap in (hapA, hapB):
        for rep in range(2):
            for start in range(0, len(hap) - readlen, 3_000):
                seq = _noisy(rng, hap[start:start + readlen])
                if k % 3 == 2:
                    seq = revcomp_codes(seq)
                reads.append(Sequence(f"read{k}", seq))
                k += 1
    d = tmp_path
    write_fasta([Sequence("chrA", refA), Sequence("chrB", refB)],
                str(d / "ref.fa"))
    write_fasta(reads, str(d / "reads.fa"))
    write_fasta([Sequence("gamma", te)], str(d / "lib.fa"))

    cfg = TELRConfig(sv=SVConfig(min_support=3),
                     assembly=AssemblyConfig(polish_iterations=1))
    res = run_pipeline(str(d / "reads.fa"), str(d / "ref.fa"),
                       str(d / "lib.fa"), str(d / "out"), config=cfg)
    assert len(res.final_report) == 2, (res.final_report, res.summary)
    by_chrom = {r["chrom"]: r for r in res.final_report}
    assert set(by_chrom) == {"chrA", "chrB"}
    assert abs(by_chrom["chrA"]["start"] - 25_000) < 100
    assert abs(by_chrom["chrB"]["start"] - 40_000) < 100
    assert all(r["family"] == "gamma" for r in res.final_report)
