"""Small-scale end-to-end F1 regression via the genome-eval harness.

A 150kb repeat-dense genome with planted TSD'd insertions and noisy
PacBio-CLR reads must be called perfectly (tools/genome_eval.py is the
BASELINE ">=0.95 F1" stand-in; the full-scale run goes through chip_smoke.py)."""

import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))


@pytest.mark.e2e
def test_small_genome_f1(tmp_path):
    from genome_eval import run_eval
    report = run_eval(size=150_000, coverage=15, n_ins=3, seed=0,
                      out_path=str(tmp_path / "ge.json"),
                      workdir=str(tmp_path / "work"))
    assert report["score"]["f1"] >= 0.99, report["score"]
    assert report["score"]["fp"] == 0
