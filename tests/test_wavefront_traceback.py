"""Device wavefront path on the CPU: the XLA form of the recurrence, the
device walk and the native decode, checked against the numpy recurrence,
the Gotoh oracle and the host walker; plus the wrapper's chunking and
padding, the platform switch, and the CUDA call's operands."""

import numpy as np
import pytest

from telr_jax.kernels import dp
from telr_jax.kernels import wave_align as wa
from telr_jax.kernels.wave_align import wavefront_align
from telr_jax.kernels.wavefront import (build_schedule, numpy_wavefront,
                                        wavefront_traceback)

PAR = dp.DPParams()


def _pairs(n=4, seed=3, lo=40, hi=80):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        lt = int(rng.integers(lo, hi))
        t = rng.integers(0, 4, lt).astype(np.int8)
        q = t[rng.integers(0, 5):].copy()
        for _ in range(max(5, lt // 20)):
            k = rng.integers(0, len(q))
            q[k] = rng.integers(0, 4)
        out.append((q, t))
    return out


def _rescore(q, t, cigar, qi, tj):
    score = 0
    for op, ln in cigar:
        if op == "M":
            for _ in range(ln):
                score += PAR.match if q[qi] == t[tj] else -PAR.mismatch
                qi += 1
                tj += 1
        else:
            score -= PAR.gap_open + PAR.gap_extend * ln
            if op == "I":
                qi += ln
            else:
                tj += ln
    return score


def _run_xla(batch, width, mode):
    import jax
    fn = jax.jit(wa.xla_dp, static_argnames=("width", "mode",
                                              "params_tuple"))
    res, dirs = fn(batch.meta, batch.qw, batch.tw, batch.scal, width=width,
                   mode=mode, params_tuple=PAR.tuple())
    return np.asarray(res), np.asarray(dirs)


def _fused(b, width, mode, impl):
    packed, small = wa.fused_step(b.meta, b.qw, b.tw, b.scal, width=width,
                                  mode=mode, params_tuple=PAR.tuple(),
                                  impl=impl)
    return np.asarray(packed), np.asarray(small)


@pytest.mark.parametrize("mode", [dp.GLOBAL, dp.EXTEND, dp.LOCAL])
def test_traceback_paths_are_oracle_optimal(mode):
    pairs = _pairs()
    res = wavefront_align(pairs, 128, mode, PAR)
    for (q, t), r in zip(pairs, res):
        want, _ = dp.numpy_affine_dp(q, t, mode, PAR)
        got = _rescore(q, t, r["cigar"], r["qstart"], r["tstart"])
        assert got == want == r["score"]
        if mode == dp.GLOBAL:
            nm = sum(l for op, l in r["cigar"] if op == "M")
            ni = sum(l for op, l in r["cigar"] if op == "I")
            nd = sum(l for op, l in r["cigar"] if op == "D")
            assert nm + ni == len(q) and nm + nd == len(t)
        if mode == dp.EXTEND:
            assert r["qstart"] == 0 and r["tstart"] == 0


def test_traceback_big_insertion_guided():
    rng = np.random.default_rng(9)
    left = rng.integers(0, 4, 150).astype(np.int8)
    right = rng.integers(0, 4, 150).astype(np.int8)
    ins = rng.integers(0, 4, 120).astype(np.int8)
    t = np.concatenate([left, right])
    q = np.concatenate([left, ins, right])
    res = wavefront_align([(q, t)], 256, dp.GLOBAL, PAR)[0]
    big_i = [ln for op, ln in res["cigar"] if op == "I" and ln > 100]
    assert big_i, res["cigar"]
    got = _rescore(q, t, res["cigar"], 0, 0)
    assert got == res["score"]


@pytest.mark.parametrize("width", [128, 512])
@pytest.mark.parametrize("mode", [dp.GLOBAL, dp.EXTEND, dp.LOCAL])
def test_xla_form_matches_numpy_and_gotoh(mode, width):
    """The XLA form's scores equal the numpy recurrence bit for bit, and
    the full-matrix Gotoh optimum where the band covers the matrix."""
    pairs = _pairs(n=5, seed=width + mode, lo=60, hi=160)
    batch = wa.prepare_wavefront_batch(pairs, width)
    res, _dirs = _run_xla(batch, width, mode)
    for i, (q, t) in enumerate(pairs):
        sched = build_schedule(q, t, width)
        g, b = numpy_wavefront(q, t, sched, width, mode, PAR)
        assert res[i, 0] == g and res[i, 1] == b, (i, res[i], g, b)
        want, _ = dp.numpy_affine_dp(q, t, mode, PAR)
        assert (g if mode == dp.GLOBAL else b) == want


@pytest.mark.parametrize("mode", [dp.GLOBAL, dp.EXTEND, dp.LOCAL])
def test_device_walk_matches_host_walker(mode):
    """The XLA sweep walk + decode yields the host walker's CIGAR from the
    same direction bytes."""
    import jax
    pairs = _pairs(n=6, seed=21 + mode, lo=50, hi=140)
    W = 128
    batch = wa.prepare_wavefront_batch(pairs, W)
    res, dirs = _run_xla(batch, W, mode)
    packed, small = jax.jit(wa.xla_walk, static_argnames=("mode",))(
        dirs, batch.meta, batch.scal, res, mode=mode)
    small = np.asarray(small)
    decoded = wa._decode(np.asarray(packed), small, mode, len(pairs))
    for i, (q, t) in enumerate(pairs):
        sched = build_schedule(q, t, W)
        si, sj = int(small[5, i]), int(small[6, i])
        cigar, ei, ej = wavefront_traceback(dirs[i], sched, si, sj, mode)
        got = dp.arrays_to_cigar(decoded[i]["cigar"])
        assert got == cigar, (i, got, cigar)
        if mode == dp.LOCAL:
            assert (decoded[i]["qstart"], decoded[i]["tstart"]) == (ei, ej)


def test_chunking_ragged_and_empty(monkeypatch):
    """Pairs of mixed step buckets, a tiny budget (one pair per chunk) and
    degenerate pairs all come back in input order with the scores of one
    big batch."""
    pairs = _pairs(n=5, seed=5, lo=40, hi=300)
    pairs.insert(2, (np.zeros(0, np.int8), pairs[0][1]))
    pairs.append((pairs[1][0], np.zeros(0, np.int8)))
    one = wavefront_align(pairs, 128, dp.GLOBAL, PAR)
    monkeypatch.setattr(wa, "_dirs_budget", lambda: 1)
    lengths = [len(q) + len(t) for q, t in pairs]
    chunks = wa.plan_chunks(lengths, 128)
    assert all(len(sel) == 1 for sel, _ in chunks)
    assert sorted(i for sel, _ in chunks for i in sel) \
        == list(range(len(pairs)))
    many = wavefront_align(pairs, 128, dp.GLOBAL, PAR)
    assert [r["score"] for r in one] == [r["score"] for r in many]
    assert [r["cigar"] for r in one] == [r["cigar"] for r in many]
    for (q, t), r in zip(pairs, one):
        if len(q) and len(t):
            want, _ = dp.numpy_affine_dp(q, t, dp.GLOBAL, PAR)
        else:   # an empty side takes align_pair's closed form
            want = dp.align_pair(q, t, dp.GLOBAL, PAR)["score"]
        assert r["score"] == want


def test_plan_chunks_buckets_and_budget():
    lengths = [100, 900, 130, 5000, 120]
    budget = 2 * 1024 * 128
    chunks = wa.plan_chunks(lengths, 128, budget=budget)
    # buckets by padded step count, ascending; each chunk fits the budget
    assert [sp for _, sp in chunks] == sorted(sp for _, sp in chunks)
    for sel, sp in chunks:
        assert all(wa._sbucket(lengths[i]) == sp for i in sel)
        assert len(sel) == 1 or len(sel) * sp * 128 <= budget
    assert sorted(i for sel, _ in chunks for i in sel) == list(range(5))


def test_prepare_batch_padding():
    """Padding pairs score nothing and padding steps drift +1 over code 4;
    shapes are powers of two with S_pad >= 128."""
    pairs = _pairs(n=3, seed=2)
    b = wa.prepare_wavefront_batch(pairs, 128, n_pad=5, s_pad=200)
    assert b.meta.shape == (8, 256) and b.qw.shape == (8, 128)
    assert b.n == 3 and not b.scal[3:].any()
    assert (b.meta[3:] == np.int8(wa._PAD_CODE)).all()
    for i, (q, t) in enumerate(pairs):
        assert (b.meta[i, len(q) + len(t):] == np.int8(wa._PAD_CODE)).all()
    res, _ = _run_xla(b, 128, dp.EXTEND)
    assert (res[3:, 1] == 0).all()     # empty alignment only


@pytest.mark.parametrize("platform,want", [
    ("gpu", wa.GPU_IMPL), ("cpu", wa.XLA_IMPL), ("rocm", None)])
def test_platform_switch(monkeypatch, platform, want):
    """gpu -> CUDA kernels, cpu -> the XLA reference, anything else is an
    error; the CLI's auto routing follows the same switch."""
    import jax
    from telr_jax import cli

    class _Dev:
        pass
    dev = _Dev()
    dev.platform = platform
    monkeypatch.setattr(jax, "devices", lambda *a: [dev])
    if want is None:
        with pytest.raises(RuntimeError):
            wa.default_impl()
        with pytest.raises(RuntimeError):
            cli._resolve_wavefront("auto")
        return
    assert wa.default_impl() == want
    use, stages = cli._resolve_wavefront("auto")
    if platform == "gpu":
        assert use and stages == cli.AUTO_WAVEFRONT_STAGES
        assert cli._resolve_wavefront("on") == (True, None)
    else:
        assert (use, stages) == (False, None)
        with pytest.raises(SystemExit):
            cli._resolve_wavefront("on")
    assert cli._resolve_wavefront("off") == (False, None)


def test_cuda_call_spec_matches_xla_inputs():
    """The CUDA DP call takes exactly the XLA form's operands (same arrays,
    dtypes and shapes) and the scoring parameters as int32 attributes;
    bad shapes fail in Python."""
    from telr_jax.kernels import cuda_wave
    pairs = _pairs(n=3, seed=8)
    b = wa.prepare_wavefront_batch(pairs, 128, light=True)
    ops, results, attrs = cuda_wave.dp_call_spec(
        b.meta, b.qw, b.tw, b.scal, width=128, mode=dp.LOCAL,
        params_tuple=PAR.tuple())
    for got, want in zip(ops, (b.meta, b.qw, b.tw, b.scal)):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert [r.shape for r in results] == [(4, 256, 128), (4, 4)]
    assert [r.dtype for r in results] == [np.int8, np.int32]
    assert {k: int(v) for k, v in attrs.items()} == dict(
        mode=dp.LOCAL, ma=PAR.match, mi=PAR.mismatch, go=PAR.gap_open,
        ge=PAR.gap_extend, amb=PAR.ambig)
    assert all(v.dtype == np.int32 for v in attrs.values())
    with pytest.raises(ValueError):
        cuda_wave.dp_call_spec(b.meta, b.qw, b.tw, b.scal, width=96,
                               mode=0, params_tuple=PAR.tuple())
    with pytest.raises(ValueError):
        cuda_wave.dp_call_spec(b.meta, b.qw[:2], b.tw, b.scal, width=128,
                               mode=0, params_tuple=PAR.tuple())


@pytest.mark.gpu
@pytest.mark.parametrize("width", [128, 512, 2048])
@pytest.mark.parametrize("mode", [dp.GLOBAL, dp.EXTEND, dp.LOCAL])
def test_cuda_matches_xla_form(gpu, mode, width):
    """On the card: the CUDA DP and walk give the XLA form's scores,
    direction bytes (over each pair's real steps) and op codes."""
    import jax
    from telr_jax.kernels import cuda_wave
    pairs = _pairs(n=9, seed=width + mode, lo=200, hi=900)
    b = wa.prepare_wavefront_batch(pairs, width, light=True)
    res_x, dirs_x = _run_xla(b, width, mode)
    res_c, dirs_c = jax.jit(cuda_wave.cuda_dp, static_argnames=(
        "width", "mode", "params_tuple"))(
        b.meta, b.qw, b.tw, b.scal, width=width, mode=mode,
        params_tuple=PAR.tuple())
    res_c, dirs_c = np.asarray(res_c), np.asarray(dirs_c)
    assert np.array_equal(res_x, res_c)
    for i, (q, t) in enumerate(pairs):
        n = len(q) + len(t)
        assert np.array_equal(dirs_x[i, :n], dirs_c[i, :n]), i
    ref = _fused(b, width, mode, wa.XLA_IMPL)
    for impl in (("cuda", "xla"), wa.GPU_IMPL):
        packed, small = _fused(b, width, mode, impl)
        assert np.array_equal(packed, ref[0]) and np.array_equal(small, ref[1])
