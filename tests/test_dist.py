"""Distributed mesh tests on the virtual 8-device CPU mesh."""

import numpy as np
import pytest

import jax


@pytest.mark.usefixtures("eight_devices")
def test_make_mesh_axes():
    from telr_jax.dist.mesh import make_mesh, READS_AXIS, LOCI_AXIS
    mesh = make_mesh(8, loci_parallel=2)
    assert mesh.axis_names == (READS_AXIS, LOCI_AXIS)
    assert mesh.devices.shape == (4, 2)


@pytest.mark.usefixtures("eight_devices")
def test_sharded_align_step_matches_single_device():
    from telr_jax.dist.mesh import make_mesh
    from telr_jax.dist.pipeline import make_sharded_align_step
    from telr_jax.kernels import dp

    rng = np.random.default_rng(0)
    B, LQ, LT, W = 16, 128, 256, 128
    q = rng.integers(0, 4, size=(B, LQ)).astype(np.int8)
    t = rng.integers(0, 4, size=(LT,)).astype(np.int8)
    off = np.broadcast_to(dp.make_band_offsets(LQ, LT, W),
                          (B, LQ + 1)).copy()
    qlen = np.full((B,), LQ, np.int32)
    tlen = np.asarray(LT, np.int32)
    params = dp.DPParams().tuple()

    mesh = make_mesh(8, loci_parallel=1)
    step = make_sharded_align_step(mesh, width=W, mode=dp.GLOBAL,
                                   params_tuple=params)
    g_sh, b_sh = step(q, t, off, qlen, tlen)

    tb = np.broadcast_to(t, (B, LT))
    tl = np.full((B,), LT, np.int32)
    g_ref, b_ref = dp.banded_dp_scores(q, tb, off, qlen, tl, width=W,
                                       mode=dp.GLOBAL, params_tuple=params)
    assert np.array_equal(np.asarray(g_sh), np.asarray(g_ref))
    assert np.array_equal(np.asarray(b_sh), np.asarray(b_ref))


@pytest.mark.usefixtures("eight_devices")
def test_graft_dryrun():
    import __graft_entry__ as g
    g.dryrun_multichip(8)


def test_pipeline_through_mesh_matches_host(tmp_path):
    """The REAL pipeline with an 8-device mesh (sharded stage-1 DP, locus
    all-to-all, psum depth) must produce bit-identical outputs to the
    meshless run on the bundled dataset (VERDICT r1 item 1)."""
    import filecmp
    import os
    ref_dir = "/root/reference/test"
    if not os.path.isdir(ref_dir):
        pytest.skip("bundled dataset unavailable")
    from telr_jax.config import default_config
    from telr_jax.dist.mesh import make_mesh
    from telr_jax.pipeline import run_pipeline

    args = (os.path.join(ref_dir, "reads.fasta"),
            os.path.join(ref_dir, "ref_38kb.fasta"),
            os.path.join(ref_dir, "library.fasta"))
    out_host = tmp_path / "host"
    out_mesh = tmp_path / "mesh"
    res_host = run_pipeline(*args, str(out_host), default_config())
    mesh = make_mesh(8)
    res_mesh = run_pipeline(*args, str(out_mesh), default_config(),
                            mesh=mesh)
    assert "locus_redistribute" in res_mesh.stage_seconds
    assert res_mesh.te_freq == res_host.te_freq
    files = ["reads.telr.bed", "reads.telr.json", "reads.telr.expanded.json",
             "reads.telr.te.fasta", "reads.telr.contig.fasta"]
    for f in files:
        assert filecmp.cmp(out_host / f, out_mesh / f, shallow=False), f


@pytest.mark.usefixtures("eight_devices")
def test_depth_psum_matches_alignstore():
    """Mesh depth (CIGAR-true M spans + psum) must be bit-identical to
    AlignmentStore.coverage."""
    from telr_jax.config import MAP_PB
    from telr_jax.core.alignstore import AlignmentStore
    from telr_jax.dist.exec import mesh_coverage
    from telr_jax.dist.mesh import make_mesh
    from telr_jax.io.seqs import SeqDict, Sequence
    from telr_jax.kernels.mapper import Aligner

    rng = np.random.default_rng(3)
    L = 3000
    ref = rng.integers(0, 4, L).astype(np.int8)
    target = SeqDict([Sequence("c", ref)])
    aligner = Aligner(target, MAP_PB)
    alns = []
    for i in range(12):
        s = int(rng.integers(0, L - 600))
        codes = ref[s:s + 500].copy()
        # plant indels so CIGARs carry I/D blocks
        codes[100:103] = (codes[100:103] + 1) % 4
        codes = np.concatenate([codes[:250],
                                rng.integers(0, 4, 20).astype(np.int8),
                                codes[250:]])
        alns.extend(aligner.map_seq(f"r{i}", codes))
    store = AlignmentStore(alns)
    mesh = make_mesh(8, loci_parallel=1)
    got = mesh_coverage(mesh, store, "c", L)
    want = store.coverage("c", 0, L)
    assert np.array_equal(got, want)
