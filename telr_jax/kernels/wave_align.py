"""Wavefront alignment on the device: batch preparation, the anti-diagonal
DP with direction bytes, the traceback walk, and `wavefront_align`, which
turns (query, target) pairs into scores and CIGARs.

The recurrence is the one in kernels/wavefront.py.  It exists in two
implementations that agree bit for bit:

  * "cuda": hand-written CUDA kernels (native/wave_cuda.cu, built for
    sm_90a and called through jax.ffi; see kernels/cuda_wave.py) — the
    implementation a GPU runs;
  * "xla": the same recurrence in jnp/lax over (n_pairs, W) int32 state
    — the reference the CPU tests run, and what XLA makes of the plain
    version on the card.

Wire format of one batch (n_pad pairs, S_pad steps, band width W):

  meta (n_pad, S_pad) int8   per step: drift bit | q_in << 1 | t_in << 4
  qw, tw (n_pad, W) int8     initial reversed-query and target windows
  scal (n_pad, 4) int32      lq, lt, i0, j0

The DP returns res (n_pad, 4) int32 = [gscore, best, best_s, best_p] and
dirs (n_pad, S_pad, W) int8, one direction byte per cell (2-bit H choice
| D-extend << 2 | I-extend << 3).  The walk returns the op codes packed
four to a byte, (n_pad, S_pad / 4) uint8, and the (7, n_pad) int32 stack
[gscore, best, fi, fj, bad, si, sj].  Padding pairs have lq = lt = 0 and
padding steps drift +1 over code 4, so neither can score.
"""

from __future__ import annotations

import functools
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from telr_jax.kernels.dp import GLOBAL, LOCAL, NEG_INF, DPParams
from telr_jax.kernels.wavefront import build_schedule
from telr_jax.utils.runtime import device_platform

_PAD_CODE = 1 | (4 << 1) | (4 << 4)   # drift +1, codes 4: never scores
_MAX_INFLIGHT = 4    # chunks issued before the oldest one is collected
_MAX_CHUNK = 4096    # pairs per chunk: bounds host prep per chunk
# the device walk packs four op codes per byte and reads dirs in blocks
# of 8 steps, so S_pad is a power of two >= this
_MIN_STEPS = 128

# (dp, walk) implementations a GPU runs; the XLA form is the reference
GPU_IMPL = ("cuda", "cuda")
XLA_IMPL = ("xla", "xla")


class WaveBatch(NamedTuple):
    meta: np.ndarray
    qw: np.ndarray
    tw: np.ndarray
    scal: np.ndarray
    n: int            # real pairs; rows [n, n_pad) are padding


def _pow2(x: int) -> int:
    b = 1
    while b < x:
        b *= 2
    return b


def _sbucket(s: int) -> int:
    return _pow2(max(s, _MIN_STEPS))


def default_impl() -> Tuple[str, str]:
    """The (dp, walk) pair wavefront_align runs on this platform: the
    CUDA kernels on a GPU, the XLA reference on the CPU."""
    return GPU_IMPL if device_platform() == "gpu" else XLA_IMPL


# ----------------------------------------------------------------------
# host-side batch preparation

def _target_m_arr(q, t, width, gq, gt):
    """The guide-following band-base target (build_schedule, kept in numpy
    for exact np.rint parity) + the even m0."""
    from telr_jax.kernels.wavefront import _cluster_corrections
    lq, lt = len(q), len(t)
    S = lq + lt
    if gq is None or len(gq) == 0:
        gqa = np.array([0, lq], dtype=np.float64)
        gta = np.array([0, lt], dtype=np.float64)
    else:
        gqa = np.concatenate([[0], np.asarray(gq, np.float64), [lq]])
        gta = np.concatenate([[0], np.asarray(gt, np.float64), [lt]])
        keep = np.concatenate([[True], np.diff(gqa) > 0])
        gqa, gta = gqa[keep], np.maximum.accumulate(gta[keep])
    o_guide = np.interp(np.arange(S + 1, dtype=np.float64),
                        gqa + gta, gta - gqa)
    tm = np.rint(o_guide).astype(np.int64) - width
    if width >= 64:
        tm = _cluster_corrections(tm, S, width)
    m0 = int(tm[0])
    if m0 % 2 != 0:
        m0 += 1
    return tm, m0


def prepare_wavefront_batch(
    pairs: Sequence[Tuple[np.ndarray, np.ndarray]],
    width: int,
    guides: Optional[Sequence] = None,
    n_pad: int = 0,
    s_pad: int = 0,
    light: bool = False,
) -> WaveBatch:
    """Build the wire arrays for a batch of pairs.

    n_pad / s_pad: lower bounds for the padded pair and step counts (each
    is rounded up to a power of two, which bounds the number of distinct
    shapes a run compiles).  light=True runs the parity walk and packing
    as one threaded native call (telr_wave_prepare_batch) when the host
    engine is built; the numpy loop below is its reference."""
    n = len(pairs)
    n_pad = _pow2(max(n, n_pad, 1))
    S_max = max((len(q) + len(t) for q, t in pairs), default=0)
    s_pad = _pow2(max(_sbucket(S_max), s_pad))
    meta = np.full((n_pad, s_pad), _PAD_CODE, dtype=np.int8)
    qw = np.full((n_pad, width), 4, dtype=np.int8)
    tw = np.full((n_pad, width), 4, dtype=np.int8)
    scal = np.zeros((n_pad, 4), dtype=np.int32)

    if light:
        from telr_jax.io import native as _native
        nat = _native.load()
        if nat is not None and hasattr(nat, "telr_wave_prepare_batch"):
            _prepare_native(nat, pairs, width, guides, s_pad,
                            meta, qw, tw, scal)
            return WaveBatch(meta, qw, tw, scal, n)

    p_idx = np.arange(width)
    for idx, (q, t) in enumerate(pairs):
        gq, gt = (guides[idx] if guides is not None and
                  guides[idx] is not None else (None, None))
        sched = build_schedule(q, t, width, gq, gt)
        drift_bits = (sched.drift > 0).astype(np.int32)
        q_in = sched.q_in.astype(np.int32) & 7
        t_in = sched.t_in.astype(np.int32) & 7
        meta[idx, :sched.n_steps] = drift_bits | (q_in << 1) | (t_in << 4)
        i0 = (0 - sched.m0) // 2
        j0 = (0 + sched.m0) // 2
        qidx = i0 - 1 - p_idx
        ok = (qidx >= 0) & (qidx < len(q))
        qw[idx, ok] = q[qidx[ok]]
        tidx = j0 - 1 + p_idx
        ok = (tidx >= 0) & (tidx < len(t))
        tw[idx, ok] = t[tidx[ok]]
        scal[idx] = (len(q), len(t), i0, j0)
    return WaveBatch(meta, qw, tw, scal, n)


def _prepare_native(nat, pairs, width, guides, s_pad, meta, qw, tw, scal):
    """numpy target-m per pair, then ONE threaded native call does the
    parity walk and all wire packing (native/telr_native.cpp)."""
    import ctypes
    n = len(pairs)
    if not n:
        return
    ptrs = np.empty((6, n), np.int64)   # q, lq, t, lt, target_m, m0
    keep = []          # keep contiguous copies + tm arrays alive
    for i, (q, t) in enumerate(pairs):
        gq, gt = (guides[i] if guides is not None and
                  guides[i] is not None else (None, None))
        tm, m0 = _target_m_arr(q, t, width, gq, gt)
        q = np.ascontiguousarray(q, dtype=np.int8)
        t = np.ascontiguousarray(t, dtype=np.int8)
        keep.append((q, t, tm))
        ptrs[:, i] = (q.ctypes.data, len(q), t.ctypes.data, len(t),
                      tm.ctypes.data, m0)
    ptrs = np.ascontiguousarray(ptrs)
    nat.telr_wave_prepare_batch(
        ptrs[0].ctypes.data, ptrs[1].ctypes.data, ptrs[2].ctypes.data,
        ptrs[3].ctypes.data, ptrs[4].ctypes.data, ptrs[5].ctypes.data,
        ctypes.c_int64(n), ctypes.c_int64(width), ctypes.c_int64(s_pad),
        meta.ctypes.data, qw.ctypes.data, tw.ctypes.data, scal.ctypes.data)


# ----------------------------------------------------------------------
# the XLA form of the DP and the walk

def _shl(x, fill):
    """x[p] <- x[p + 1]; the last lane takes `fill`."""
    return jnp.concatenate([x[:, 1:], fill], axis=1)


def _shr(x, fill):
    """x[p] <- x[p - 1]; lane 0 takes `fill`."""
    return jnp.concatenate([fill, x[:, :-1]], axis=1)


def xla_dp(meta, qw, tw, scal, *, width, mode, params_tuple):
    """The wavefront recurrence over (n, W) int32 state, one fori_loop
    iteration per anti-diagonal step.  Returns (res, dirs) as described in
    the module docstring."""
    ma, mi, go, ge, amb = params_tuple
    n, S = meta.shape
    W = width
    neg = jnp.int32(NEG_INF)
    lane = jnp.arange(W, dtype=jnp.int32)[None, :]
    negcol = jnp.full((n, 1), neg, jnp.int32)
    lq, lt = scal[:, 0:1], scal[:, 1:2]
    i0, j0 = scal[:, 2:3], scal[:, 3:4]
    codes = meta.astype(jnp.int32).T                    # (S, n)
    full_neg = jnp.full((n, W), neg, jnp.int32)
    h1 = jnp.where((i0 - lane == 0) & (j0 + lane == 0), 0, neg)
    state = (h1, full_neg, full_neg, full_neg,
             qw.astype(jnp.int32), tw.astype(jnp.int32), i0, j0,
             jnp.zeros((n, 1), jnp.int32),
             jnp.zeros((n, W), jnp.int32), jnp.zeros((n, W), jnp.int32),
             full_neg, jnp.zeros((n, S, W), jnp.int8))

    def body(k, st):
        (H1, H2, I1, D1, QW, TW, i0v, j0v, dprev, hb, sb, gb, dirs) = st
        mcol = jax.lax.dynamic_index_in_dim(codes, k, keepdims=False)
        mcol = mcol[:, None]
        dbit = (mcol & 1) == 1
        d = jnp.where(dbit, 1, -1)
        i0s = i0v + jnp.where(dbit, 0, 1)
        j0s = j0v + jnp.where(dbit, 1, 0)
        QW = jnp.where(dbit, QW, _shr(QW, (mcol >> 1) & 7))
        TW = jnp.where(dbit, _shl(TW, (mcol >> 4) & 7), TW)
        Hv = jnp.where(dbit, _shl(H1, negcol), H1)
        Iv = jnp.where(dbit, _shl(I1, negcol), I1)
        Hh = jnp.where(dbit, H1, _shr(H1, negcol))
        Dh = jnp.where(dbit, D1, _shr(D1, negcol))
        dd = d + dprev
        Hd = jnp.where(dd == 2, _shl(H2, negcol),
                       jnp.where(dd == -2, _shr(H2, negcol), H2))
        I = jnp.maximum(Hv - (go + ge), Iv - ge)
        D = jnp.maximum(Hh - (go + ge), Dh - ge)
        sc = jnp.where((QW == 4) | (TW >= 4), jnp.int32(amb),
                       jnp.where(QW == TW, jnp.int32(ma), jnp.int32(-mi)))
        Hdg = Hd + sc
        H = jnp.maximum(Hdg, jnp.maximum(I, D))
        if mode == LOCAL:
            H = jnp.maximum(H, 0)
        i_vec = i0s - lane
        j_vec = j0s + lane
        if mode == LOCAL:
            b_i = b_j = jnp.zeros((n, W), jnp.int32)
        else:
            b_i = -(go + ge * i_vec)
            b_j = -(go + ge * j_vec)
        H = jnp.where((i_vec == 0) & (j_vec == 0), 0,
                      jnp.where(i_vec == 0, b_j,
                                jnp.where(j_vec == 0, b_i, H)))
        valid = (i_vec >= 0) & (i_vec <= lq) & (j_vec >= 0) & (j_vec <= lt)
        H = jnp.where(valid, H, neg)
        I = jnp.where(valid, I, neg)
        D = jnp.where(valid, D, neg)
        inner = valid & (i_vec >= 1) & (j_vec >= 1)
        at_end = inner & (i_vec == lq) & (j_vec == lt)
        gb = jnp.where(at_end, jnp.maximum(gb, H), gb)
        if mode != GLOBAL:
            # per-lane best, earliest step wins (strict >); the cross-lane
            # reduction happens once after the loop
            take = jnp.where(inner, H, neg) > hb
            hb = jnp.where(take, H, hb)
            sb = jnp.where(take, k + 1, sb)
        choice = jnp.where(H == Hdg, 0, jnp.where(H == D, 1, 2))
        if mode == LOCAL:
            choice = jnp.where(H == 0, 3, choice)
        choice = jnp.where((i_vec <= 0) | (j_vec <= 0), 3, choice)
        dext = (D != Hh - (go + ge)) & (D > neg // 2)
        iext = (I != Hv - (go + ge)) & (I > neg // 2)
        byte = (choice | jnp.where(dext, 4, 0)
                | jnp.where(iext, 8, 0)).astype(jnp.int8)
        dirs = jax.lax.dynamic_update_slice(dirs, byte[:, None, :],
                                            (0, k, 0))
        return (H, H1, I, D, QW, TW, i0s, j0s, d, hb, sb, gb, dirs)

    st = jax.lax.fori_loop(0, S, body, state)
    hb, sb, gb, dirs = st[9], st[10], st[11], st[12]
    gbest = jnp.max(gb, axis=1)
    if mode == GLOBAL:
        zeros = jnp.zeros((n,), jnp.int32)
        res = jnp.stack([gbest, gbest, zeros, zeros], axis=1)
    else:
        best = jnp.max(hb, axis=1)
        arg = jnp.argmax(hb == best[:, None], axis=1).astype(jnp.int32)
        best_s = jnp.take_along_axis(sb, arg[:, None], axis=1)[:, 0]
        res = jnp.stack([gbest, best, best_s, arg], axis=1)
    return res, dirs


def _start_cells(meta, scal, res, mode):
    """(m_arr (n, S+1), si, sj): the band base per step and the walk's
    start cell (the end cell for GLOBAL, the best cell otherwise; best
    step 0 means the empty alignment won, so the walk starts at (0,0))."""
    drift = (meta.astype(jnp.int32) & 1) * 2 - 1
    m0 = scal[:, 3] - scal[:, 2]
    m_arr = jnp.concatenate(
        [m0[:, None], m0[:, None] + jnp.cumsum(drift, axis=1)], axis=1)
    if mode == GLOBAL:
        return m_arr, scal[:, 0], scal[:, 1]
    s_star, p_star = res[:, 2], res[:, 3]
    m_s = jnp.take_along_axis(m_arr, s_star[:, None], axis=1)[:, 0]
    o = m_s + 2 * p_star
    si = jnp.where(s_star == 0, 0, (s_star - o) // 2)
    sj = jnp.where(s_star == 0, 0, (s_star + o) // 2)
    return m_arr, si, sj


def xla_walk(dirs, meta, scal, res, *, mode):
    """Walk every pair's direction bytes on the device (anti-diagonal
    sweep).

    Every walk's cell coordinate s = i + j only decreases (M: -2, D/I:
    -1), so sweeping s from S down to 1 visits each pair's bytes in order;
    a pair acts only where its own s equals the sweep s.  Per active
    position each pair consumes exactly one byte: an H-state D/I choice
    performs the first gap step at once (what the host walker does in two
    visits to the same byte).  Op codes: 0=M, 1=D, 2=I, 3=no-op, emitted
    in sweep order; the host decode strips the no-ops and reverses."""
    n, S, W = dirs.shape
    H, D, I = jnp.int32(0), jnp.int32(1), jnp.int32(2)
    m_arr, si, sj = _start_cells(meta, scal, res, mode)
    lane = jax.lax.broadcasted_iota(jnp.int16, (n, W), 1)

    def step(state, s, slab, m_s):
        i, j, st, stopped, bad = state
        active = (i + j == s) & (i > 0) & (j > 0) & ~stopped
        off = j - i - m_s
        p_raw = off // 2
        # the host walker raises when a walk leaves the band; here the
        # pair is flagged and the caller drops its alignment
        bad = bad | (active & (((off & 1) != 0) | (p_raw < 0)
                               | (p_raw >= W)))
        p = jnp.clip(p_raw, 0, W - 1)
        byte = jnp.sum(jnp.where(lane == p[:, None].astype(jnp.int16),
                                 slab, jnp.int8(0)),
                       axis=1, dtype=jnp.int8).astype(jnp.int32)
        ch = byte & 3
        in_h = st == H
        stop_now = in_h & (ch == 3)
        if mode != LOCAL:
            # a STOP byte mid-walk outside LOCAL means corrupt dirs
            bad = bad | (active & stop_now)
        do_m = in_h & (ch == 0)
        do_d = ((in_h & (ch == 1)) | (st == D)) & ~stop_now & ~do_m
        do_i = (((in_h & (ch == 2)) | (st == I)) & ~stop_now & ~do_m
                & ~do_d)
        op = jnp.where(do_m, 0, jnp.where(do_d, 1, jnp.where(do_i, 2, 3)))
        op = jnp.where(active, op, 3).astype(jnp.uint8)
        ni = jnp.where(active & (do_m | do_i), i - 1, i)
        nj = jnp.where(active & (do_m | do_d), j - 1, j)
        nst = jnp.where(do_m, H,
                        jnp.where(do_d, jnp.where((byte & 4) != 0, D, H),
                                  jnp.where(do_i,
                                            jnp.where((byte & 8) != 0, I, H),
                                            st)))
        nst = jnp.where(active, nst, st)
        return (ni, nj, nst, stopped | (active & stop_now), bad), op

    def block_body(state, blk):
        # one slab load per 8 sweep positions (steps blk*8+1 .. blk*8+8)
        slab8 = jax.lax.dynamic_slice(dirs, (0, blk * 8, 0), (n, 8, W))
        m8 = jax.lax.dynamic_slice(m_arr, (0, blk * 8 + 1), (n, 8))
        ops8 = []
        for k in range(7, -1, -1):      # descending s within the block
            state, op = step(state, blk * 8 + k + 1, slab8[:, k], m8[:, k])
            ops8.append(op)
        return state, jnp.stack(ops8)   # (8, n), descending s

    init = (si.astype(jnp.int32), sj.astype(jnp.int32),
            jnp.zeros(n, jnp.int32), jnp.zeros(n, bool), jnp.zeros(n, bool))
    blocks = jnp.arange(S // 8 - 1, -1, -1, dtype=jnp.int32)
    (fi, fj, _, _, bad), ops = jax.lax.scan(block_body, init, blocks)
    ops = ops.reshape(S, n).T           # (n, S): column t is s = S - t
    packed = (ops[:, 0::4] | (ops[:, 1::4] << 2) | (ops[:, 2::4] << 4)
              | (ops[:, 3::4] << 6))
    small = jnp.stack([res[:, 0], res[:, 1], fi, fj, bad.astype(jnp.int32),
                       si.astype(jnp.int32), sj.astype(jnp.int32)])
    return packed, small


def _dp_fn(name):
    if name == "xla":
        return xla_dp
    from telr_jax.kernels import cuda_wave
    return cuda_wave.cuda_dp


def _walk_fn(name):
    if name == "xla":
        return xla_walk
    from telr_jax.kernels import cuda_wave
    return cuda_wave.cuda_walk


@functools.partial(jax.jit, static_argnames=("width", "mode", "params_tuple",
                                             "impl"))
def fused_step(meta, qw, tw, scal, *, width, mode, params_tuple, impl):
    """One device round: DP + walk.  Returns (packed ops, (7, n) stack)."""
    res, dirs = _dp_fn(impl[0])(meta, qw, tw, scal, width=width, mode=mode,
                                params_tuple=params_tuple)
    return _walk_fn(impl[1])(dirs, meta, scal, res, mode=mode)


@functools.lru_cache(maxsize=None)
def _dirs_budget() -> int:
    """Bytes of direction bytes one chunk may hold: a share of the device
    memory limit, so _MAX_INFLIGHT chunks together take at most half of
    it.  The CPU backend reports no limit; tests there use small chunks."""
    stats = jax.devices()[0].memory_stats()
    if stats and stats.get("bytes_limit"):
        return int(stats["bytes_limit"]) // (2 * _MAX_INFLIGHT)
    return 1 << 28


def plan_chunks(lengths: Sequence[int], width: int,
                budget: Optional[int] = None
                ) -> List[Tuple[List[int], int]]:
    """Group pair indices by step bucket and cut each bucket into chunks
    whose dirs tensor (pairs x S_pad x W bytes) fits the budget.  Returns
    [(indices, S_pad)]; chunk sizes are powers of two, so every full
    chunk of a bucket has the same shape."""
    budget = _dirs_budget() if budget is None else budget
    by_bucket: Dict[int, List[int]] = {}
    for i, s in enumerate(lengths):
        by_bucket.setdefault(_sbucket(s), []).append(i)
    chunks = []
    for sp in sorted(by_bucket):
        idxs = by_bucket[sp]
        per = 1
        while per * 2 <= min(budget // (sp * width), _MAX_CHUNK):
            per *= 2
        for lo in range(0, len(idxs), per):
            chunks.append((idxs[lo:lo + per], sp))
    return chunks


# ----------------------------------------------------------------------
# host decode of the packed op codes

def _unpack_ops(packed: np.ndarray) -> np.ndarray:
    """(n, S/4) packed codes -> (n, S) codes, column t holding s = S - t."""
    n, s4 = packed.shape
    ops = np.empty((n, s4 * 4), dtype=np.uint8)
    for k in range(4):
        ops[:, k::4] = (packed >> (2 * k)) & 3
    return ops


def _rle(ops_rev: np.ndarray) -> List[Tuple[str, int]]:
    """Reverse + run-length-encode a pair's op codes (3 = skip)."""
    ops_rev = ops_rev[ops_rev != 3][::-1]
    if ops_rev.size == 0:
        return []
    sym = np.array(["M", "D", "I"])
    change = np.nonzero(np.diff(ops_rev))[0] + 1
    bounds = np.concatenate([[0], change, [len(ops_rev)]])
    return list(zip(sym[ops_rev[bounds[:-1]]].tolist(),
                    np.diff(bounds).tolist()))


def _decode_python(packed, small, mode):
    """Per-pair array cigars, the reference for the native decode."""
    from telr_jax.kernels.dp import cigar_to_arrays
    ops = _unpack_ops(packed)
    out = []
    for k in range(small.shape[1]):
        cigar = _rle(ops[k])
        fi, fj = int(small[2, k]), int(small[3, k])
        if mode != LOCAL:
            lead: List[Tuple[str, int]] = []
            if fi > 0:
                lead.append(("I", fi))
            if fj > 0:
                lead.append(("D", fj))
            if lead:
                if cigar and lead[-1][0] == cigar[0][0]:
                    cigar[0] = (cigar[0][0], cigar[0][1] + lead.pop()[1])
                cigar = lead + cigar
        out.append(cigar_to_arrays(cigar))
    return out


def _decode(packed, small, mode, n) -> List[dict]:
    from telr_jax.io import native as _native
    packed, small = packed[:n], small[:, :n]
    if _native.has_wave_decode():
        offsets, opsc, lensc = _native.wave_decode_batch(
            packed, small[2], small[3], small[4], mode != LOCAL)
        cigars = [(opsc[offsets[k]:offsets[k + 1]],
                   lensc[offsets[k]:offsets[k + 1]]) for k in range(n)]
    else:
        cigars = _decode_python(packed, small, mode)
    out = []
    for k in range(n):
        if small[4, k]:
            out.append({"score": NEG_INF, "cigar": [], "qstart": 0,
                        "tstart": 0, "qend": 0, "tend": 0, "failed": True})
            continue
        if mode != LOCAL:
            ei = ej = 0
        else:
            ei, ej = int(small[2, k]), int(small[3, k])
        out.append({
            "score": int(small[0, k]) if mode == GLOBAL else int(small[1, k]),
            "cigar": cigars[k], "qstart": ei, "tstart": ej,
            "qend": int(small[5, k]), "tend": int(small[6, k])})
    return out


def wavefront_align(
    pairs: Sequence[Tuple[np.ndarray, np.ndarray]],
    width: int,
    mode: int,
    params: DPParams,
    guides: Optional[Sequence] = None,
    cigar_arrays: bool = False,
    impl: Optional[Tuple[str, str]] = None,
):
    """Full alignment through the device wavefront: scores + CIGARs.

    Returns a list of dicts like dp.align_pair: score, cigar, qstart,
    qend, tstart, tend (a walk that left the band comes back with
    "failed").  cigar_arrays=True returns "cigar" in the (ops uint8,
    lens int32) array form.  A pair with an empty side takes
    dp.align_pair's closed form.  impl: the (dp, walk) implementations,
    by default the platform's (default_impl)."""
    from telr_jax.utils import hoststats
    from telr_jax.kernels import dp
    impl = impl or default_impl()
    out: List[Optional[dict]] = [None] * len(pairs)
    live = []
    for i, (q, t) in enumerate(pairs):
        if len(q) and len(t):
            live.append(i)
            continue
        r = dp.align_pair(q, t, mode, params)
        if cigar_arrays:
            r["cigar"] = dp.cigar_to_arrays(r["cigar"])
        out[i] = r
    lengths = [len(q) + len(t) for q, t in pairs]
    chunks = [([live[k] for k in sel], sp) for sel, sp in
              plan_chunks([lengths[i] for i in live], width)]
    issued: list = []
    decode_s = 0.0

    def _collect_one():
        nonlocal decode_s
        sel, packed, small = issued.pop(0)
        with hoststats.timer("wave_device_wait"):
            packed = np.asarray(packed)
            small = np.asarray(small)
        t0 = time.perf_counter()
        for i, r in zip(sel, _decode(packed, small, mode, len(sel))):
            if not cigar_arrays and not r.get("failed"):
                r["cigar"] = dp.arrays_to_cigar(r["cigar"])
            out[i] = r
        decode_s += time.perf_counter() - t0

    for sel, sp in chunks:
        cp = [pairs[i] for i in sel]
        cg = [guides[i] for i in sel] if guides is not None else None
        with hoststats.timer("wave_prep"):
            batch = prepare_wavefront_batch(cp, width, cg, s_pad=sp,
                                            light=True)
        with hoststats.timer("wave_launch"):
            packed, small = fused_step(
                batch.meta, batch.qw, batch.tw, batch.scal, width=width,
                mode=mode, params_tuple=params.tuple(), impl=impl)
        hoststats.count("device_dispatches", 1)
        hoststats.count("device_cells",
                        sum(lengths[i] for i in sel) * width)
        issued.append((sel, packed, small))
        while len(issued) >= _MAX_INFLIGHT:
            _collect_one()
    while issued:
        _collect_one()
    hoststats.add("wave_decode", decode_s, len(chunks))
    return out
