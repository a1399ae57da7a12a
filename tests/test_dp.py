"""DP kernel parity tests: banded JAX DP vs full-matrix numpy Gotoh oracle."""

import numpy as np
import pytest

from telr_jax.kernels import dp
from telr_jax.io.seqs import encode


def _rand_seq(rng, n):
    return rng.integers(0, 4, size=n).astype(np.int8)


def _mutate(rng, codes, sub=0.1, ins=0.05, dele=0.05):
    out = []
    for c in codes:
        r = rng.random()
        if r < dele:
            continue
        if r < dele + ins:
            out.append(rng.integers(0, 4))
        if rng.random() < sub:
            out.append(rng.integers(0, 4))
        else:
            out.append(c)
    return np.array(out, dtype=np.int8)


PAR = dp.DPParams(match=2, mismatch=4, gap_open=4, gap_extend=2)


@pytest.mark.parametrize("mode", [dp.GLOBAL, dp.EXTEND, dp.LOCAL])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_band_matches_oracle_related_seqs(mode, seed):
    """On related sequences (the band covers the optimal path) the banded DP
    must reproduce the full-matrix optimum exactly."""
    rng = np.random.default_rng(seed)
    t = _rand_seq(rng, rng.integers(40, 120))
    q = _mutate(rng, t)
    want, _ = dp.numpy_affine_dp(q, t, mode, PAR)
    got = dp.align_pair(q, t, mode, PAR, width=256)
    assert got["score"] == want, (mode, seed, got["score"], want)


@pytest.mark.parametrize("seed", range(6))
def test_global_cigar_consistency(seed):
    """CIGAR must be a valid path: consumes exactly lq query and lt target,
    and its rescored value equals the DP score."""
    rng = np.random.default_rng(100 + seed)
    t = _rand_seq(rng, rng.integers(30, 90))
    q = _mutate(rng, t, sub=0.15, ins=0.08, dele=0.08)
    res = dp.align_pair(q, t, dp.GLOBAL, PAR, width=256)
    nm, ni, nd, _ = dp.cigar_stats(res["cigar"])
    assert nm + ni == len(q)
    assert nm + nd == len(t)
    # rescore the path
    score, qi, tj = 0, 0, 0
    state = None
    for op, ln in res["cigar"]:
        if op == "M":
            for _ in range(ln):
                score += PAR.match if q[qi] == t[tj] else -PAR.mismatch
                qi += 1
                tj += 1
            state = "M"
        else:
            score -= PAR.gap_open + PAR.gap_extend * ln
            if op == "I":
                qi += ln
            else:
                tj += ln
            state = op
    assert score == res["score"], (score, res["score"], res["cigar"])


def test_big_insertion_in_band():
    """A large query-only insertion must appear as one I run when the band
    follows a guide path that pauses the target coordinate."""
    rng = np.random.default_rng(7)
    left = _rand_seq(rng, 300)
    right = _rand_seq(rng, 300)
    ins = _rand_seq(rng, 400)
    t = np.concatenate([left, right])
    q = np.concatenate([left, ins, right])
    qs = np.array([150, 300, 700, 850])
    ts = np.array([150, 300, 300, 450])
    off = dp.offsets_from_path(len(q), len(t), 512, qs, ts)
    res = dp.align_pair(q, t, dp.GLOBAL, PAR, width=512, off=off)
    big_I = [ln for op, ln in res["cigar"] if op == "I" and ln > 300]
    assert big_I, res["cigar"]
    nm, ni, nd, _ = dp.cigar_stats(res["cigar"])
    assert nm + ni == len(q) and nm + nd == len(t)


def test_local_alignment_coords():
    """LOCAL mode finds the embedded homologous segment."""
    rng = np.random.default_rng(11)
    core = _rand_seq(rng, 80)
    t = np.concatenate([_rand_seq(rng, 50), core, _rand_seq(rng, 60)])
    q = np.concatenate([_rand_seq(rng, 30), _mutate(rng, core, 0.05, 0.02, 0.02),
                        _rand_seq(rng, 20)])
    res = dp.align_pair(q, t, dp.LOCAL, PAR, width=256)
    assert res["score"] > 100
    assert 40 <= res["tstart"] <= 60
    assert 120 <= res["tend"] <= 140
    assert 25 <= res["qstart"] <= 35


def test_extend_mode():
    """EXTEND pins the start at (0,0) and stops at the best cell."""
    rng = np.random.default_rng(13)
    shared = _rand_seq(rng, 100)
    q = np.concatenate([shared, _rand_seq(rng, 50)])  # diverges after 100
    t = np.concatenate([shared, _rand_seq(rng, 50)])
    res = dp.align_pair(q, t, dp.EXTEND, PAR, width=256)
    assert res["score"] >= 2 * 95  # ~100 matches
    assert abs(res["qend"] - 100) < 20


def test_empty_and_degenerate():
    q = encode("ACGT")
    assert dp.align_pair(q, np.zeros(0, np.int8), dp.GLOBAL, PAR)["cigar"] == [("I", 4)]
    assert dp.align_pair(np.zeros(0, np.int8), q, dp.GLOBAL, PAR)["cigar"] == []


def test_wavefront_static_drift_parity_ragged():
    """Ragged batch (11 pairs padded to 16) of near-identical pairs whose
    schedules are mostly the canonical zigzag: the XLA form's scores must
    match the numpy recurrence in every mode."""
    import jax
    from telr_jax.kernels import dp as dpmod
    from telr_jax.kernels.wave_align import prepare_wavefront_batch, xla_dp
    from telr_jax.kernels.wavefront import build_schedule, numpy_wavefront

    rng = np.random.default_rng(77)
    W = 128
    pairs = []
    for k in range(11):
        lt = 300 + 60 * k
        t = rng.integers(0, 4, lt).astype(np.int8)
        q = t[: lt - (0 if k % 2 else 40)].copy()
        idx = rng.integers(0, len(q), len(q) // 30)
        q[idx] = rng.integers(0, 4, len(idx))
        pairs.append((q, t))
    batch = prepare_wavefront_batch(pairs, W, light=True)
    assert batch.meta.shape[0] == 16
    params = dpmod.DPParams()
    scheds = [build_schedule(q, t, W) for q, t in pairs]
    run = jax.jit(xla_dp, static_argnames=("width", "mode", "params_tuple"))
    for mode in (dpmod.GLOBAL, dpmod.EXTEND, dpmod.LOCAL):
        res, _dirs = run(batch.meta, batch.qw, batch.tw, batch.scal,
                         width=W, mode=mode, params_tuple=params.tuple())
        res = np.asarray(res)
        for i, (q, t) in enumerate(pairs):
            gs, bs = numpy_wavefront(q, t, scheds[i], W, mode, params)
            want, got = (gs, res[i, 0]) if mode == dpmod.GLOBAL \
                else (bs, res[i, 1])
            assert got == want, (mode, i, int(got), int(want))
