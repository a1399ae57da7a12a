"""Pipeline checkpoint/resume integration test on the bundled dataset."""

import os

import pytest

from telr_jax.pipeline import run_pipeline

pytestmark = pytest.mark.e2e

DATA = "/root/reference/test"


def test_resume_reproduces_output(tmp_path):
    ck = str(tmp_path / "ckpt")
    out1 = str(tmp_path / "out1")
    out2 = str(tmp_path / "out2")
    res1 = run_pipeline(os.path.join(DATA, "reads.fasta"),
                        os.path.join(DATA, "ref_38kb.fasta"),
                        os.path.join(DATA, "library.fasta"),
                        out1, checkpoint_dir=ck)
    # second run resumes: alignment/te_filter/assembly restored
    res2 = run_pipeline(os.path.join(DATA, "reads.fasta"),
                        os.path.join(DATA, "ref_38kb.fasta"),
                        os.path.join(DATA, "library.fasta"),
                        out2, checkpoint_dir=ck)
    assert res2.final_report == res1.final_report
    # resumed alignment stage must be much faster than the cold one
    assert res2.stage_seconds["alignment"] < res1.stage_seconds["alignment"]
    assert res2.stage_seconds["assembly"] < res1.stage_seconds["assembly"]
    manifest = os.path.join(ck, "MANIFEST.json")
    assert os.path.isfile(manifest)


def test_changed_inputs_invalidate_checkpoints(tmp_path):
    """Rerunning into the same checkpoint dir with different inputs or
    semantic config must NOT resume stale stages (the stages are keyed
    by name only; the input fingerprint guards them)."""
    from telr_jax.config import SVConfig, TELRConfig

    ck = str(tmp_path / "ckpt")
    args = (os.path.join(DATA, "reads.fasta"),
            os.path.join(DATA, "ref_38kb.fasta"),
            os.path.join(DATA, "library.fasta"))
    res1 = run_pipeline(*args, str(tmp_path / "out1"), checkpoint_dir=ck)
    assert res1.restored_stages == []

    # same inputs/config -> resumes
    res2 = run_pipeline(*args, str(tmp_path / "out2"), checkpoint_dir=ck)
    assert "alignment" in res2.restored_stages

    # changed semantic config -> everything re-runs
    cfg = TELRConfig(sv=SVConfig(min_support=4))
    res3 = run_pipeline(*args, str(tmp_path / "out3"), config=cfg,
                        checkpoint_dir=ck)
    assert res3.restored_stages == []

    # changed input file -> everything re-runs
    import shutil
    reads2 = str(tmp_path / "reads2.fasta")
    shutil.copy(args[0], reads2)
    with open(reads2, "a") as f:
        f.write(">extra\nACGTACGTACGT\n")
    res4 = run_pipeline(reads2, args[1], args[2], str(tmp_path / "out4"),
                        config=cfg, checkpoint_dir=ck)
    assert res4.restored_stages == []
