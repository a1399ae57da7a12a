"""Golden-output regression pinning on the bundled dataset.

Snapshots of telr_jax's own outputs (round 1) guard future rounds against
unintended behavioral drift: any diff here must be an intentional,
reviewed change.  (Byte parity vs the reference's own outputs requires
running the pinned TELR toolchain, which isn't available in this image —
see ROADMAP.md item 4.)
"""

import json
import os

import pytest

from telr_jax.pipeline import run_pipeline

pytestmark = pytest.mark.e2e

DATA = "/root/reference/test"
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")

# fields that legitimately vary across environments (paths, dates)
_VCF_SKIP_PREFIXES = ("##fileDate", "##reference")


@pytest.fixture(scope="module")
def outdir(tmp_path_factory):
    out = tmp_path_factory.mktemp("golden_run")
    run_pipeline(os.path.join(DATA, "reads.fasta"),
                 os.path.join(DATA, "ref_38kb.fasta"),
                 os.path.join(DATA, "library.fasta"), str(out))
    return str(out)


@pytest.mark.parametrize("name", [
    "reads.telr.bed",
    "reads.telr.te.fasta",
    "reads.telr.contig.fasta",
    "liftover_summary.json",
])
def test_byte_identical(outdir, name):
    with open(os.path.join(GOLDEN, name), "rb") as f:
        want = f.read()
    with open(os.path.join(outdir, name), "rb") as f:
        got = f.read()
    assert got == want, f"{name} drifted from the golden snapshot"


@pytest.mark.parametrize("name", [
    "reads.telr.json",
    "reads.telr.expanded.json",
])
def test_json_identical(outdir, name):
    want = json.load(open(os.path.join(GOLDEN, name)))
    got = json.load(open(os.path.join(outdir, name)))
    assert got == want, f"{name} drifted from the golden snapshot"


def _normalized_vcf_lines(path):
    with open(path) as f:
        return [ln for ln in f.read().splitlines()
                if not ln.startswith(_VCF_SKIP_PREFIXES)]


def test_vcf_identical(outdir):
    """Pin the VCF writer (matches reference TELR_output.py:313-427).

    ``##fileDate``/``##reference`` legitimately vary per run/environment and
    are excluded; every other line (full header + records) must match.
    """
    want = _normalized_vcf_lines(os.path.join(GOLDEN, "reads.telr.vcf"))
    got = _normalized_vcf_lines(os.path.join(outdir, "reads.telr.vcf"))
    assert got == want, "reads.telr.vcf drifted from the golden snapshot"
