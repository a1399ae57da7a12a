"""Native C++ module parity with the numpy reference implementations."""

import numpy as np
import pytest

from telr_jax.io import native

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native library not built")


def test_encode_parity():
    from telr_jax.io.seqs import encode as np_encode
    s = b"ACGTNacgtnXYZ-\n" * 50
    assert np.array_equal(native.encode(s), np_encode(s))


def test_fasta_scan_parity():
    from telr_jax.io.fasta import read_fasta
    recs = native.scan_fasta("/root/reference/test/reads.fasta")
    ref = read_fasta("/root/reference/test/reads.fasta")
    assert len(recs) == len(ref)
    for name, desc, codes in recs:
        assert np.array_equal(codes, ref[name].codes)


@pytest.mark.parametrize("n", [200, 5000, 50_000])
def test_minimizer_parity(n):
    from telr_jax.kernels.minimizer import (pack_kmers, _sliding_argmin,
                                            _splitmix64)
    # compare against the pure-numpy implementation (bypass the native
    # dispatch inside minimizers())
    import telr_jax.kernels.minimizer as mz
    rng = np.random.default_rng(n)
    codes = rng.integers(0, 4, n).astype(np.int8)
    codes[rng.integers(0, n, max(1, n // 100))] = 4

    fwd, rc, valid = pack_kmers(codes, 15)
    hf = _splitmix64(fwd)
    hr = _splitmix64(rc)
    strand = (hr < hf).astype(np.int64)
    hcan = np.minimum(hf, hr)
    invalid = (~valid) | (hf == hr)
    hcan = np.where(invalid, np.uint64(0xFFFFFFFFFFFFFFFF), hcan)
    sel = np.unique(_sliding_argmin(hcan, 10))
    sel = sel[~invalid[sel]]
    want = (sel, hcan[sel], strand[sel])

    got = native.minimizers(codes, 15, 10)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])
    assert np.array_equal(got[2], want[2])


def test_native_banded_dp_parity():
    """The C++ banded DP must be bit-exact with the XLA scan: scores,
    best-cell outputs and every direction byte within each pair's real
    rows (pad rows are never walked)."""
    import numpy as np
    from telr_jax.kernels import dp
    from telr_jax.io import native

    if not native.has_banded_dp():
        import pytest
        pytest.skip("native library not built")
    rng = np.random.default_rng(9)
    for trial in range(12):
        lq = int(rng.integers(1, 300))
        lt = int(rng.integers(1, 400))
        W = min(int(rng.choice([64, 128])), dp._bucket(lt + 1))
        q = rng.integers(0, 5, lq).astype(np.int8)
        t = rng.integers(0, 5, lt).astype(np.int8)
        off = dp.make_band_offsets(lq, lt, W)
        lqb, ltb = dp._bucket(lq), dp._bucket(lt)
        qp = np.full(lqb, 4, np.int8); qp[:lq] = q
        tp = np.full(ltb, 4, np.int8); tp[:lt] = t
        op = np.full(lqb + 1, off[-1], np.int32); op[:len(off)] = off
        for mode in (dp.GLOBAL, dp.EXTEND, dp.LOCAL):
            args = (qp[None], tp[None], op[None],
                    np.array([lq], np.int32), np.array([lt], np.int32))
            kw = dict(width=W, mode=mode,
                      params_tuple=dp.DPParams().tuple())
            ref = [np.asarray(x) for x in dp.banded_dp_batch(*args, **kw)]
            nat = native.banded_dp_batch(*args, **kw)
            for r, n in zip(ref[1:], nat[1:]):
                assert int(r[0]) == int(n[0]), (trial, mode)
            assert np.array_equal(ref[0][0][:lq], nat[0][0][:lq]), \
                (trial, mode)


def test_native_symbols_present():
    """Every fast-path symbol must exist in a freshly built library —
    the hasattr-based gates silently fall back to Python otherwise
    (this caught a mangled-linkage regression once)."""
    from telr_jax.io import native
    lib = native.load()
    if lib is None:
        import pytest
        pytest.skip("native library not built")
    for sym in ("telr_encode", "telr_scan_fasta", "telr_minimizers",
                "telr_wave_schedule", "telr_chain_dp",
                "telr_banded_dp_batch", "telr_traceback",
                "telr_count_matches"):
        assert hasattr(lib, sym), sym


def test_native_traceback_parity():
    """Native walk == Python walk on real DP outputs (cigar + end cell),
    including LOCAL stops and band-escape errors."""
    import numpy as np
    import pytest
    from telr_jax.kernels import dp
    from telr_jax.io import native

    if not native.has_traceback():
        pytest.skip("native library not built")
    import os
    os.environ["TELR_NATIVE_DP"] = "0"   # force Python reference walker
    try:
        rng = np.random.default_rng(17)
        for trial in range(10):
            lq = int(rng.integers(30, 250))
            lt = int(rng.integers(30, 300))
            q = rng.integers(0, 4, lq).astype(np.int8)
            t = rng.integers(0, 4, lt).astype(np.int8)
            for mode in (dp.GLOBAL, dp.EXTEND, dp.LOCAL):
                kind, payload = dp._prep_pair(q, t, mode, dp.DPParams())
                assert kind == "job"
                qp, tp_, op, lq_, lt_, W = payload
                dirs, g, b, bi, bp = dp.banded_dp_batch(
                    qp[None], tp_[None], op[None],
                    np.array([lq_], np.int32), np.array([lt_], np.int32),
                    width=W, mode=mode, params_tuple=dp.DPParams().tuple())
                d0 = np.asarray(dirs[0])
                if mode == dp.GLOBAL:
                    si, sj = lq_, lt_
                else:
                    si = int(bi[0])
                    sj = int(op[si]) + int(bp[0]) if si > 0 else int(bp[0])
                ref = dp.traceback(d0, op, si, sj, mode)
                got = native.traceback(d0, op, si, sj, mode)
                assert ref == got, (trial, mode)
    finally:
        os.environ.pop("TELR_NATIVE_DP", None)


def test_wave_decode_batch_matches_python_rle():
    """Native batched wavefront decode (unpack + strip no-ops + reverse +
    RLE + lead prepend) is byte-identical to the Python decode it
    replaces (wave_align._rle + lead logic)."""
    from telr_jax.io import native
    from telr_jax.kernels.wave_align import _rle, _unpack_ops
    if not native.has_wave_decode():
        import pytest
        pytest.skip("native wave decode unavailable")
    rng = np.random.default_rng(5)
    S, n = 256, 24
    # op codes 0..3 with a bias toward runs and no-ops; (n, S) rows
    ops = rng.choice([0, 0, 0, 1, 2, 3, 3, 3, 3], size=(n, S)).astype(np.uint8)
    # long constant stretches to exercise run merging
    ops[3, 40:90] = 0
    ops[7, 10:200] = 3
    packed = (ops[:, 0::4] | (ops[:, 1::4] << 2) | (ops[:, 2::4] << 4)
              | (ops[:, 3::4] << 6)).astype(np.uint8)
    assert np.array_equal(_unpack_ops(packed), ops)
    fi = rng.integers(0, 5, n).astype(np.int32)
    fj = rng.integers(0, 5, n).astype(np.int32)
    bad = (rng.random(n) < 0.2).astype(np.int32)

    for lead in (True, False):
        offsets, opsc, lensc = native.wave_decode_batch(
            packed, fi, fj, bad, lead)
        sym = {"M": 0, "D": 1, "I": 2}
        for k in range(n):
            got = list(zip(opsc[offsets[k]:offsets[k + 1]].tolist(),
                           lensc[offsets[k]:offsets[k + 1]].tolist()))
            if bad[k]:
                assert got == []
                continue
            cigar = _rle(ops[k])
            if lead:
                lead_l = []
                if fi[k] > 0:
                    lead_l.append(("I", int(fi[k])))
                if fj[k] > 0:
                    lead_l.append(("D", int(fj[k])))
                if lead_l:
                    if cigar and lead_l[-1][0] == cigar[0][0]:
                        cigar[0] = (cigar[0][0],
                                    cigar[0][1] + lead_l.pop()[1])
                    cigar = lead_l + cigar
            want = [(sym[o], ln) for o, ln in cigar]
            assert got == want, (k, lead)


def test_wave_prepare_batch_native_parity():
    """The native threaded prepare (light=True) emits bit-identical wire
    arrays (meta/qw/tw/scal) to the numpy per-pair packing loop."""
    from telr_jax.io import native
    from telr_jax.kernels.wave_align import prepare_wavefront_batch
    lib = native.load()
    if lib is None or not hasattr(lib, "telr_wave_prepare_batch"):
        import pytest
        pytest.skip("native wave prepare unavailable")
    rng = np.random.default_rng(11)
    pairs, guides = [], []
    for i in range(11):        # non-power of two: padding pairs
        lq = int(rng.integers(60, 900))
        lt = lq + int(rng.integers(-40, 220))
        lt = max(40, lt)
        t = rng.integers(0, 4, lt).astype(np.int8)
        q = t[:lq].copy() if lq <= lt else np.concatenate(
            [t, rng.integers(0, 4, lq - lt).astype(np.int8)])
        idx = rng.integers(0, lq, max(2, lq // 30))
        q[idx] = rng.integers(0, 4, len(idx))
        pairs.append((q, t))
        if i % 3 == 0:
            aq = np.arange(10, min(lq, lt) - 10, 97, dtype=np.int64)
            guides.append((aq, aq))
        else:
            guides.append(None)
    for width in (128, 512):
        full = prepare_wavefront_batch(pairs, width, guides,
                                       n_pad=16, s_pad=512)
        lite = prepare_wavefront_batch(pairs, width, guides,
                                       n_pad=16, s_pad=512, light=True)
        for name in ("meta", "qw", "tw", "scal"):
            assert np.array_equal(getattr(full, name),
                                  getattr(lite, name)), (name, width)
        assert full.n == lite.n == 11
        assert full.meta.shape == (16, 2048)
