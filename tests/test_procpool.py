"""Forkserver worker-pool parity: map_batch_parallel must equal map_batch
on both the CPU fan-out path and the wavefront plan-fanout path.

The pool exists because plain fork() deadlocks under threaded runtimes
(the GPU runtime, gloo) — see utils/procpool.py.  These tests pin the
contract that the fan-out changes throughput only, never results."""

import numpy as np
import pytest

from telr_jax.config import MAP_PB
from telr_jax.io.seqs import SeqDict, Sequence, revcomp_codes
from telr_jax.kernels.mapper import Aligner


def _dataset(n_reads=24, ref_len=120_000, read_len=4000, err=0.05):
    rng = np.random.default_rng(7)
    ref = rng.integers(0, 4, ref_len).astype(np.int8)
    targets = SeqDict([Sequence("chr", ref)])
    reads = {}
    for i in range(n_reads):
        s = int(rng.integers(0, ref_len - read_len - 100))
        seg = ref[s:s + read_len].copy()
        m = rng.random(len(seg)) < err
        seg[m] = (seg[m] + 1 + rng.integers(0, 3, int(m.sum()))) % 4
        if i % 2:
            seg = revcomp_codes(seg)
        reads[f"r{i}"] = seg
    return targets, reads


def _sig(res):
    return {n: [(a.tname, a.tstart, a.tend, a.qstart, a.qend, a.strand,
                 a.primary, a.score) for a in v]
            for n, v in res.items()}


def test_cpu_pool_parity():
    targets, reads = _dataset()
    al = Aligner(targets, MAP_PB)
    assert _sig(al.map_batch_parallel(reads, 3)) == \
        _sig(al.map_batch(reads))


def test_plan_pool_parity_wavefront(monkeypatch):
    """Device path (the XLA form on the CPU): with the size gate off every
    DP runs on the wavefront, planned in the workers or in the parent."""
    from telr_jax.kernels import mapper
    from telr_jax.utils import hoststats
    monkeypatch.setattr(mapper, "_WAVE_MIN_CELLS", 0)
    targets, reads = _dataset(n_reads=16)
    al = Aligner(targets, MAP_PB, use_wavefront=True)
    hoststats.reset_counters()
    assert _sig(al.map_batch_parallel(reads, 3)) == \
        _sig(al.map_batch(reads))
    counts = hoststats.counters()
    assert counts["device_dispatches"] > 0 and counts["device_cells"] > 0
    assert "gate_host_dispatches" not in counts


def test_size_gate_counts_host_dispatches():
    """Below the size gate the wavefront request runs on the host engine,
    and the counters say so."""
    from telr_jax.io import native
    from telr_jax.utils import hoststats
    if not native.has_banded_dp():
        pytest.skip("native host engine unavailable")
    targets, reads = _dataset(n_reads=6)
    al = Aligner(targets, MAP_PB, use_wavefront=True)
    hoststats.reset_counters()
    assert _sig(al.map_batch(reads)) == \
        _sig(Aligner(targets, MAP_PB).map_batch(reads))
    counts = hoststats.counters()
    assert counts["gate_host_dispatches"] > 0
    assert counts["gate_host_cells"] > 0
    assert "device_dispatches" not in counts


def test_pool_worker_runs_jax_on_cpu_only():
    """Pool workers pin JAX to the CPU before anything imports it, so the
    parent stays the only process on the card."""
    targets, reads = _dataset(n_reads=2)
    al = Aligner(targets, MAP_PB)
    pool = al._worker_pool(2)
    try:
        got = pool.pool.apply(
            eval, ("(__import__('os').environ['JAX_PLATFORMS'], "
                   "__import__('os').environ['TELR_DP_THREADS'], "
                   "__import__('jax').devices()[0].platform)",))
    finally:
        pool.close()
        al._pool = None
    assert got == ("cpu", "1", "cpu")


def test_small_batch_stays_serial():
    targets, reads = _dataset(n_reads=6)
    al = Aligner(targets, MAP_PB)
    # below the fan-out threshold no pool is created
    assert _sig(al.map_batch_parallel(reads, 3)) == \
        _sig(al.map_batch(reads))
    assert getattr(al, "_pool", None) is None
