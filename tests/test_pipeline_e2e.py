"""End-to-end pipeline test on the bundled TELR dataset.

The oracle (docs/01_Installation.md:53-60 of the reference): the dataset
contains exactly one non-reference jockey insertion; success = the pipeline
detects it and writes all output files.
"""

import json
import os

import pytest

from telr_jax.pipeline import run_pipeline

pytestmark = pytest.mark.e2e

DATA = "/root/reference/test"


@pytest.fixture(scope="module")
def result(tmp_path_factory):
    out = tmp_path_factory.mktemp("telr_out")
    return run_pipeline(
        os.path.join(DATA, "reads.fasta"),
        os.path.join(DATA, "ref_38kb.fasta"),
        os.path.join(DATA, "library.fasta"),
        str(out)), str(out)


def test_single_jockey_insertion(result):
    res, _ = result
    assert len(res.final_report) == 1
    rec = res.final_report[0]
    assert rec["type"] == "non-reference"
    assert rec["family"] == "jockey"
    assert rec["chrom"] == "chr2L"
    # insertion point: ~chr2L:33029 in slice coords (1077029 genome-wide)
    assert 32950 < rec["start"] < 33100
    assert rec["support"] == "both_sides"


def test_heterozygous_genotype(result):
    res, _ = result
    rec = res.final_report[0]
    assert rec["genotype"] == "0/1"
    af = rec["allele_frequency"]
    assert af is not None and 0.3 <= af <= 0.9
    # support split: both allele classes present (DR counts only reads
    # with NO insertion evidence at all — junction-signature reads that
    # align through the TSD copy are excluded, sv/detect.py)
    assert int(rec["num_sv_reads"]) >= 5
    assert int(rec["num_ref_reads"]) >= 4


def test_te_sequence_is_jockey_sized(result):
    res, _ = result
    rec = res.final_report[0]
    # jockey consensus is 5020bp; the insertion is a near-full-length copy
    assert 4000 < len(rec["te_sequence"]) < 5600


def test_contig_assembled(result):
    res, _ = result
    assert len(res.contigs) >= 1
    ctg = next(iter(res.contigs))
    assert 8000 < len(ctg) < 30000


def test_output_files_written(result):
    res, out = result
    sample = res.sample_name
    for suffix in (".telr.json", ".telr.expanded.json", ".telr.vcf",
                   ".telr.bed", ".telr.te.fasta", ".telr.contig.fasta",
                   ".loci_eval.tsv"):
        path = os.path.join(out, sample + suffix)
        assert os.path.isfile(path), suffix
    # VCF structure
    with open(os.path.join(out, sample + ".telr.vcf")) as f:
        lines = f.read().splitlines()
    assert lines[0] == "##fileformat=VCFv4.1"
    data_rows = [l for l in lines if not l.startswith("#")]
    assert len(data_rows) == 1
    fields = data_rows[0].split("\t")
    assert fields[0] == "chr2L"
    assert fields[8] == "GT:DR:DV"
    # JSON roundtrip
    report = json.load(open(os.path.join(out, sample + ".telr.json")))
    assert report == res.final_report


def test_summary_counts(result):
    res, _ = result
    assert res.summary["non-reference"]["total"] == 1
    assert res.summary["unlifted"]["total"] == 0
