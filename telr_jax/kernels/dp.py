"""Banded affine-gap dynamic-programming alignment core.

This single DP engine replaces the inner loops of every external aligner the
reference shells out to — NGMLR / minimap2 (reference TELR_alignment.py:31-82),
minimap2 contig/flank remaps (TELR_te.py:68-132, TELR_liftover.py:248-266),
wtpoa-cns polishing realignment (TELR_assembly.py:199-223) and rmblast inside
RepeatMasker (TELR_sv.py:254-273).

Design:
  * The DP matrix is banded: row i (query position) only holds a static-width
    window of W target columns starting at `off[i]`.  Band offsets follow the
    seed chain, so arbitrarily long indels are representable as long as each
    *piece* between anchors fits its band (the mapper stitches pieces).
  * Each row update is fully vectorised across the band:
    vertical/diagonal terms come from the previous row shifted by
    d = off[i]-off[i-1]; the horizontal (affine D) term is an exclusive
    max-plus prefix scan, which is exact for affine gaps (the classic
    "lazy-F" result: opening from a cell improved by D can never beat
    extending D).
  * Direction bits (2b H-choice, 1b D-extend, 1b I-extend) are emitted per
    cell; traceback is a cheap host-side walk.

Modes:
  GLOBAL — end-to-end (0,0)->(Lq,Lt) within the band (anchor stitching).
  EXTEND — start pinned at (0,0), best cell anywhere (read-end extension).
  LOCAL  — Smith-Waterman, scores clamped at 0 (TE-library homology search).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

NEG_INF = -(2 ** 30)

GLOBAL, EXTEND, LOCAL = 0, 1, 2

# direction byte layout
_CHOICE_DIAG, _CHOICE_D, _CHOICE_I, _CHOICE_STOP = 0, 1, 2, 3
_DEXT_BIT = 4
_IEXT_BIT = 8


@dataclasses.dataclass(frozen=True)
class DPParams:
    match: int = 2
    mismatch: int = 4     # positive; applied as negative
    gap_open: int = 4     # gap of length L costs gap_open + L*gap_extend
    gap_extend: int = 2
    ambig: int = -1       # score when either base is N

    def tuple(self) -> Tuple[int, int, int, int, int]:
        return (self.match, self.mismatch, self.gap_open, self.gap_extend,
                self.ambig)


def make_band_offsets(lq: int, lt: int, width: int) -> np.ndarray:
    """Band offsets for a plain (0,0)->(lq,lt) alignment: the band follows the
    main diagonal, clipped so row 0 contains column 0 and row lq contains
    column lt.  Returns int32 (lq+1,)."""
    if lq == 0:
        return np.zeros(1, dtype=np.int32)
    i = np.arange(lq + 1, dtype=np.float64)
    center = i * (lt / lq)
    off = np.rint(center).astype(np.int64) - width // 2
    off = np.clip(off, 0, max(0, lt - width + 1))
    off = np.maximum.accumulate(off)  # monotone non-decreasing
    # limit per-row shift to width (path continuity)
    for _ in range(2):
        d = np.diff(off)
        if (d <= width).all():
            break
        d = np.minimum(d, width)
        off = np.concatenate([[off[0]], off[0] + np.cumsum(d)])
        off = np.clip(off, 0, max(0, lt - width + 1))
    return off.astype(np.int32)


def offsets_from_path(lq: int, lt: int, width: int,
                      qs: np.ndarray, ts: np.ndarray) -> np.ndarray:
    """Band offsets following a monotone guide path given by matched points
    (qs[m], ts[m]) (e.g. chain anchors), linearly interpolated, endpoints
    pinned to (0,0) and (lq,lt)."""
    qs = np.concatenate([[0], np.asarray(qs, np.int64), [lq]])
    ts = np.concatenate([[0], np.asarray(ts, np.int64), [lt]])
    keep = np.concatenate([[True], (np.diff(qs) > 0)])
    qs, ts = qs[keep], np.maximum.accumulate(ts[keep])
    i = np.arange(lq + 1, dtype=np.float64)
    center = np.interp(i, qs.astype(np.float64), ts.astype(np.float64))
    off = np.rint(center).astype(np.int64) - width // 2
    off = np.clip(off, 0, max(0, lt - width + 1))
    off = np.maximum.accumulate(off)
    d = np.minimum(np.diff(off), width)
    off = np.concatenate([[off[0]], off[0] + np.cumsum(d)])
    off = np.clip(off, 0, max(0, lt - width + 1)).astype(np.int32)
    return off


# ---------------------------------------------------------------------------
# Reference implementation (full matrix, numpy) — test oracle only.
# ---------------------------------------------------------------------------

def numpy_affine_dp(q: np.ndarray, t: np.ndarray, mode: int,
                    params: DPParams) -> Tuple[int, Tuple[int, int]]:
    """Full-matrix Gotoh DP. Returns (best_score, (best_i, best_j))."""
    ma, mi, go, ge, amb = params.tuple()
    lq, lt = len(q), len(t)
    H = np.full((lq + 1, lt + 1), NEG_INF, dtype=np.int64)
    E = np.full((lq + 1, lt + 1), NEG_INF, dtype=np.int64)  # horizontal (D)
    F = np.full((lq + 1, lt + 1), NEG_INF, dtype=np.int64)  # vertical (I)
    H[0, 0] = 0
    for j in range(1, lt + 1):
        H[0, j] = 0 if mode == LOCAL else -(go + ge * j)
    for i in range(1, lq + 1):
        H[i, 0] = 0 if mode == LOCAL else -(go + ge * i)
    for i in range(1, lq + 1):
        for j in range(1, lt + 1):
            s = amb if (q[i - 1] == 4 or t[j - 1] == 4) else (
                ma if q[i - 1] == t[j - 1] else -mi)
            E[i, j] = max(H[i, j - 1] - go - ge, E[i, j - 1] - ge)
            F[i, j] = max(H[i - 1, j] - go - ge, F[i - 1, j] - ge)
            h = max(H[i - 1, j - 1] + s, E[i, j], F[i, j])
            if mode == LOCAL:
                h = max(h, 0)
            H[i, j] = h
    if mode == GLOBAL:
        return int(H[lq, lt]), (lq, lt)
    best = int(H.max())
    bi, bj = np.unravel_index(int(H.argmax()), H.shape)
    return best, (int(bi), int(bj))


# ---------------------------------------------------------------------------
# Banded JAX implementation
# ---------------------------------------------------------------------------

def _banded_dp_single(q, t, off, qlen, tlen, width, mode, params_tuple):
    """Banded DP over one (query,target) pair.

    q: (Lq,) int8 codes (padded with 4 beyond qlen)
    t: (Lt,) int8 codes (padded)
    off: (Lq+1,) int32 band offsets
    Returns: (dirs (Lq, W) uint8, final_global_score, best_score,
              best_row, best_p)
    """
    ma, mi, go, ge, amb = params_tuple
    lq = q.shape[0]
    lt = t.shape[0]
    p_idx = jnp.arange(width, dtype=jnp.int32)

    # init row 0: j = off[0] + p = p (off[0]==0 expected)
    j0 = off[0] + p_idx
    if mode == LOCAL:
        h0 = jnp.zeros((width,), jnp.int32)
    else:
        h0 = jnp.where(j0 == 0, 0, -(go + ge * j0)).astype(jnp.int32)
    h0 = jnp.where(j0 <= tlen, h0, NEG_INF)
    i0 = jnp.full((width,), NEG_INF, jnp.int32)

    # target codes per row: t_band[i, p] = t[off[i+1] + p - 1]; out-of-range→5
    tpad = jnp.concatenate([
        jnp.full((1,), 5, jnp.int8), t,
        jnp.full((width + 1,), 5, jnp.int8)])
    # mark beyond tlen as out-of-range (code 5)
    tmask_idx = jnp.arange(tpad.shape[0], dtype=jnp.int32) - 1
    tpad = jnp.where((tmask_idx >= 0) & (tmask_idx < tlen), tpad, 5)

    rows_off = off[1:]
    d_all = jnp.diff(off)
    row_valid = (jnp.arange(1, lq + 1, dtype=jnp.int32) <= qlen)

    def scan_body(carry, xs):
        h_prev, i_prev, best, bi, bp = carry
        qi, off_i, d_i, row_i, valid_row = xs
        t_band = jax.lax.dynamic_slice(tpad, (off_i,), (width,))

        pad = jnp.full((width + 1,), NEG_INF, jnp.int32)
        hbuf = jnp.concatenate([jnp.full((1,), NEG_INF, jnp.int32), h_prev, pad])
        ibuf = jnp.concatenate([jnp.full((1,), NEG_INF, jnp.int32), i_prev, pad])
        h_diag = jax.lax.dynamic_slice(hbuf, (d_i,), (width,))
        h_up = jax.lax.dynamic_slice(hbuf, (d_i + 1,), (width,))
        i_up = jax.lax.dynamic_slice(ibuf, (d_i + 1,), (width,))

        i_open = jnp.where(h_up > NEG_INF // 2, h_up - go - ge, NEG_INF)
        i_ext = jnp.where(i_up > NEG_INF // 2, i_up - ge, NEG_INF)
        i_cur = jnp.maximum(i_open, i_ext)
        i_ext_bit = (i_cur != i_open) & (i_cur > NEG_INF // 2)

        s = jnp.where((qi == 4) | (t_band >= 4), jnp.int32(amb),
                      jnp.where(t_band == qi, jnp.int32(ma),
                                jnp.int32(-mi)))
        diag = jnp.where(h_diag > NEG_INF // 2, h_diag + s, NEG_INF)

        h_nod = jnp.maximum(diag, i_cur)
        if mode == LOCAL:
            h_nod = jnp.maximum(h_nod, 0)

        # apply edge corrections BEFORE the horizontal scan so D opens from
        # true cell values: the j==0 cell is vertical-only, out-of-range
        # columns are -inf.
        j_col = off_i + p_idx
        in_t = (j_col >= 1) & (j_col <= tlen)
        at_zero = (j_col == 0)
        h_zero = jnp.maximum(i_cur, 0) if mode == LOCAL else i_cur
        h_nod = jnp.where(at_zero, h_zero, jnp.where(in_t, h_nod, NEG_INF))

        # g[p] = H_noD[p] + ge*p - (go + ge): a gap opened after cell p and
        # extended to cell p' costs go + ge*(p'-p), so
        # D[p'] = max_{p<p'} g[p] - ge*p'.
        g = jnp.where(h_nod > NEG_INF // 2,
                      h_nod + ge * p_idx - go - ge, NEG_INF)
        m = jax.lax.associative_scan(jnp.maximum, g)
        m_excl = jnp.concatenate([jnp.full((1,), NEG_INF, jnp.int32), m[:-1]])
        d_cur = jnp.where(m_excl > NEG_INF // 2, m_excl - ge * (p_idx - 1),
                          NEG_INF)
        d_cur = jnp.where(at_zero | ~in_t, NEG_INF, d_cur)
        open_cand = jnp.concatenate(
            [jnp.full((1,), NEG_INF, jnp.int32), h_nod[:-1] - go - ge])
        d_ext_bit = (d_cur != open_cand) & (d_cur > NEG_INF // 2)

        h_cur = jnp.maximum(h_nod, d_cur)

        choice = jnp.where(h_cur == diag, _CHOICE_DIAG,
                           jnp.where(h_cur == d_cur, _CHOICE_D, _CHOICE_I))
        choice = jnp.where(at_zero, _CHOICE_I, choice)
        if mode == LOCAL:
            choice = jnp.where(h_cur == 0, _CHOICE_STOP, choice)
        dirs = (choice.astype(jnp.uint8)
                | jnp.where(d_ext_bit, _DEXT_BIT, 0).astype(jnp.uint8)
                | jnp.where(i_ext_bit, _IEXT_BIT, 0).astype(jnp.uint8))

        # skip invalid rows (beyond qlen): pass carry through unchanged
        h_out = jnp.where(valid_row, h_cur, h_prev_passthrough(h_prev, d_i, width))
        i_out = jnp.where(valid_row, i_cur, NEG_INF)

        masked_h = jnp.where((in_t | at_zero) & valid_row, h_cur, NEG_INF)
        rbp = jnp.argmax(masked_h).astype(jnp.int32)
        rb = masked_h[rbp]
        take = rb > best
        best = jnp.where(take, rb, best)
        bi = jnp.where(take, row_i, bi)
        bp = jnp.where(take, rbp, bp)
        return (h_out, i_out, best, bi, bp), dirs

    def h_prev_passthrough(h_prev, d_i, width):
        # rows past qlen: carry last valid row forward unshifted
        return h_prev

    qi_seq = q.astype(jnp.int32)
    xs = (qi_seq, rows_off, d_all,
          jnp.arange(1, lq + 1, dtype=jnp.int32), row_valid)
    init_best = jnp.int32(0 if mode != GLOBAL else NEG_INF)
    carry0 = (h0, i0, init_best, jnp.int32(0), jnp.int32(0))
    (h_last, _, best, besti, bestp), dirs = jax.lax.scan(scan_body, carry0, xs)

    # global score: cell (qlen, tlen) lives in row qlen's band.
    # rows beyond qlen pass h through unshifted, and offsets beyond qlen are
    # expected constant, so h_last still holds row qlen's band.
    p_end = tlen - off[lq]
    p_end_c = jnp.clip(p_end, 0, width - 1)
    gscore = jnp.where((p_end >= 0) & (p_end < width), h_last[p_end_c],
                       NEG_INF)
    return dirs, gscore, best, besti, bestp


def _banded_dp_scores_single(q, t, off, qlen, tlen, width, mode,
                             params_tuple):
    """Score-only banded DP (no direction bits): the device-resident
    throughput path for filtering/scoring, where traceback is not needed.
    Same recurrence as _banded_dp_single."""
    ma, mi, go, ge, amb = params_tuple
    lq = q.shape[0]
    p_idx = jnp.arange(width, dtype=jnp.int32)

    j0 = off[0] + p_idx
    if mode == LOCAL:
        h0 = jnp.zeros((width,), jnp.int32)
    else:
        h0 = jnp.where(j0 == 0, 0, -(go + ge * j0)).astype(jnp.int32)
    h0 = jnp.where(j0 <= tlen, h0, NEG_INF)
    i0 = jnp.full((width,), NEG_INF, jnp.int32)

    tpad = jnp.concatenate([
        jnp.full((1,), 5, jnp.int8), t,
        jnp.full((width + 1,), 5, jnp.int8)])
    tmask_idx = jnp.arange(tpad.shape[0], dtype=jnp.int32) - 1
    tpad = jnp.where((tmask_idx >= 0) & (tmask_idx < tlen), tpad, 5)

    def scan_body(carry, xs):
        h_prev, i_prev, best = carry
        qi, off_i, d_i, row_i, valid_row = xs
        t_band = jax.lax.dynamic_slice(tpad, (off_i,), (width,))
        pad = jnp.full((width + 1,), NEG_INF, jnp.int32)
        hbuf = jnp.concatenate([jnp.full((1,), NEG_INF, jnp.int32), h_prev, pad])
        ibuf = jnp.concatenate([jnp.full((1,), NEG_INF, jnp.int32), i_prev, pad])
        h_diag = jax.lax.dynamic_slice(hbuf, (d_i,), (width,))
        h_up = jax.lax.dynamic_slice(hbuf, (d_i + 1,), (width,))
        i_up = jax.lax.dynamic_slice(ibuf, (d_i + 1,), (width,))

        i_open = jnp.where(h_up > NEG_INF // 2, h_up - go - ge, NEG_INF)
        i_ext = jnp.where(i_up > NEG_INF // 2, i_up - ge, NEG_INF)
        i_cur = jnp.maximum(i_open, i_ext)

        s = jnp.where((qi == 4) | (t_band >= 4), jnp.int32(amb),
                      jnp.where(t_band == qi, jnp.int32(ma), jnp.int32(-mi)))
        diag = jnp.where(h_diag > NEG_INF // 2, h_diag + s, NEG_INF)
        h_nod = jnp.maximum(diag, i_cur)
        if mode == LOCAL:
            h_nod = jnp.maximum(h_nod, 0)

        j_col = off_i + p_idx
        in_t = (j_col >= 1) & (j_col <= tlen)
        at_zero = (j_col == 0)
        h_zero = jnp.maximum(i_cur, 0) if mode == LOCAL else i_cur
        h_nod = jnp.where(at_zero, h_zero, jnp.where(in_t, h_nod, NEG_INF))

        g = jnp.where(h_nod > NEG_INF // 2,
                      h_nod + ge * p_idx - go - ge, NEG_INF)
        m = jax.lax.associative_scan(jnp.maximum, g)
        m_excl = jnp.concatenate([jnp.full((1,), NEG_INF, jnp.int32), m[:-1]])
        d_cur = jnp.where(m_excl > NEG_INF // 2, m_excl - ge * (p_idx - 1),
                          NEG_INF)
        d_cur = jnp.where(at_zero | ~in_t, NEG_INF, d_cur)
        h_cur = jnp.maximum(h_nod, d_cur)

        h_out = jnp.where(valid_row, h_cur, h_prev)
        i_out = jnp.where(valid_row, i_cur, NEG_INF)
        masked_h = jnp.where((in_t | at_zero) & valid_row, h_cur, NEG_INF)
        best = jnp.maximum(best, jnp.max(masked_h))
        return (h_out, i_out, best), None

    rows_off = off[1:]
    d_all = jnp.diff(off)
    row_valid = (jnp.arange(1, lq + 1, dtype=jnp.int32) <= qlen)
    xs = (q.astype(jnp.int32), rows_off, d_all,
          jnp.arange(1, lq + 1, dtype=jnp.int32), row_valid)
    init_best = jnp.int32(0 if mode != GLOBAL else NEG_INF)
    (h_last, _, best), _ = jax.lax.scan(
        scan_body, (h0, i0, init_best), xs)
    p_end = tlen - off[lq]
    p_end_c = jnp.clip(p_end, 0, width - 1)
    gscore = jnp.where((p_end >= 0) & (p_end < width), h_last[p_end_c],
                       NEG_INF)
    return gscore, best


@functools.partial(jax.jit, static_argnames=("width", "mode", "params_tuple"))
def banded_dp_scores(q, t, off, qlen, tlen, *, width, mode, params_tuple):
    """Batched score-only banded DP.  Returns (gscore (B,), best (B,))."""
    fn = functools.partial(_banded_dp_scores_single, width=width, mode=mode,
                           params_tuple=params_tuple)
    return jax.vmap(fn)(q, t, off, qlen, tlen)


@functools.partial(jax.jit, static_argnames=("width", "mode", "params_tuple"))
def banded_dp_batch(q, t, off, qlen, tlen, *, width, mode, params_tuple):
    """vmapped banded DP over a batch.

    q: (B, Lq) int8, t: (B, Lt) int8, off: (B, Lq+1) int32,
    qlen/tlen: (B,) int32.
    Returns dirs (B, Lq, W) uint8, gscore (B,), best (B,), besti (B,),
    bestp (B,).
    """
    fn = functools.partial(_banded_dp_single, width=width, mode=mode,
                           params_tuple=params_tuple)
    return jax.vmap(fn)(q, t, off, qlen, tlen)


# ---------------------------------------------------------------------------
# Host-side traceback
# ---------------------------------------------------------------------------

def traceback(dirs: np.ndarray, off: np.ndarray, start_i: int, start_j: int,
              mode: int, lt: int = 1 << 30
              ) -> Tuple[List[Tuple[str, int]], int, int]:
    """Walk direction bits from cell (start_i, start_j) back to the alignment
    start.  Returns (cigar ops as (op, len) in forward order, end_i, end_j)
    where (end_i, end_j) is the matrix cell where the alignment begins
    (always (0,0) for GLOBAL/EXTEND)."""
    if _native_walks():
        from telr_jax.io import native
        return native.traceback(dirs, off, int(start_i), int(start_j),
                                mode, lt)
    ops: List[Tuple[str, int]] = []
    i, j = int(start_i), int(start_j)

    def push(op: str):
        if ops and ops[-1][0] == op:
            ops[-1] = (op, ops[-1][1] + 1)
        else:
            ops.append((op, 1))

    state = "H"
    while i > 0 or j > 0:
        if i == 0:
            # leading horizontal run along row 0 (global init row)
            push("D")
            j -= 1
            continue
        p = j - int(off[i])
        if p < 0 or p >= dirs.shape[1]:
            raise RuntimeError(
                f"traceback left the band at i={i} j={j} p={p}")
        byte = int(dirs[i - 1, p])
        choice = byte & 3
        if state == "H":
            if mode == LOCAL and choice == _CHOICE_STOP:
                break
            if j == 0 or choice == _CHOICE_I:
                state = "I"
                continue
            if choice == _CHOICE_DIAG:
                push("M")
                i -= 1
                j -= 1
                continue
            if choice == _CHOICE_D:
                state = "D"
                continue
            # STOP in non-local mode shouldn't happen
            raise RuntimeError(f"bad traceback state at i={i} j={j}")
        elif state == "D":
            push("D")
            ext = byte & _DEXT_BIT
            j -= 1
            if not ext:
                state = "H"
        else:  # state == "I"
            push("I")
            ext = byte & _IEXT_BIT
            i -= 1
            if not ext:
                state = "H"
    ops.reverse()
    return ops, i, j


# ---------------------------------------------------------------------------
# Convenience single-pair API (used by the mapper for stitching pieces)
# ---------------------------------------------------------------------------

def _bucket(n: int, quanta=(64, 128, 256, 512, 1024, 2048, 4096, 8192,
                            16384, 32768, 65536)) -> int:
    for b in quanta:
        if n <= b:
            return b
    return ((n + 8191) // 8192) * 8192


def _prep_pair(q: np.ndarray, t: np.ndarray, mode: int, params: DPParams,
               width: Optional[int] = None,
               off: Optional[np.ndarray] = None):
    """Shared padding/bucketing front half of align_pair.

    Returns ("quick", result_dict) for degenerate pairs, else
    ("job", (q_pad, t_pad, off_pad, lq, lt, width))."""
    lq, lt = len(q), len(t)
    if lq == 0 or (lt == 0 and mode != GLOBAL):
        return "quick", {"score": 0, "cigar": [], "qend": 0, "tend": 0,
                         "qstart": 0, "tstart": 0}
    if lt == 0:
        return "quick", {
            "score": -(params.gap_open + params.gap_extend * lq),
            "cigar": [("I", lq)], "qend": lq, "tend": 0,
            "qstart": 0, "tstart": 0}
    if width is None:
        width = _bucket(max(abs(lt - lq) + 65, 128, min(max(lq, lt) + 2, 256)))
    width = min(width, _bucket(lt + 1))
    if off is None:
        off_arr = make_band_offsets(lq, lt, width)
    else:
        off_arr = np.asarray(off, dtype=np.int32)

    lq_b = _bucket(lq)
    q_pad = np.full(lq_b, 4, dtype=np.int8)
    q_pad[:lq] = q
    lt_b = _bucket(lt)
    t_pad = np.full(lt_b, 4, dtype=np.int8)
    t_pad[:lt] = t
    off_pad = np.full(lq_b + 1, off_arr[-1], dtype=np.int32)
    off_pad[: len(off_arr)] = off_arr
    return "job", (q_pad, t_pad, off_pad, lq, lt, width)


def _finish_pair(dirs, gscore, best, besti, bestp, off_pad, lq, lt, mode,
                 want_cigar: bool, cigar_arrays: bool = False):
    """Shared traceback back half of align_pair."""
    out = {"qstart": 0, "tstart": 0}
    if mode == GLOBAL:
        out["score"] = int(gscore)
        si, sj = lq, lt
    else:
        out["score"] = int(best)
        si = int(besti)
        sj = int(off_pad[si]) + int(bestp) if si > 0 else int(bestp)
    out["qend"], out["tend"] = si, sj
    if want_cigar:
        if cigar_arrays:
            arr, ei, ej, margin = traceback_arrays(
                np.asarray(dirs), off_pad, si, sj, mode, lt)
            out["cigar"] = arr
            out["band_margin"] = margin
        else:
            arr, ei, ej = traceback(np.asarray(dirs), off_pad, si, sj,
                                    mode, lt)
            out["cigar"] = arr
        out["qstart"], out["tstart"] = ei, ej
    return out


# ---------------------------------------------------------------------------
# Array-form cigars: (ops uint8 [M=0,D=1,I=2], lens int32) in forward order.
# The hot path (mapper piece assembly) stays in this form end-to-end; the
# list-of-(str, int) form remains the public ABI of Alignment.cigar.
# ---------------------------------------------------------------------------

_OP_STR = np.array(["M", "D", "I"])
_OP_CODE = {"M": 0, "D": 1, "I": 2}


def cigar_to_arrays(cigar) -> Tuple[np.ndarray, np.ndarray]:
    if isinstance(cigar, tuple):
        return cigar
    n = len(cigar)
    ops = np.fromiter((_OP_CODE[op] for op, _ in cigar), dtype=np.uint8,
                      count=n)
    lens = np.fromiter((ln for _, ln in cigar), dtype=np.int32, count=n)
    return ops, lens


def arrays_to_cigar(arr) -> List[Tuple[str, int]]:
    if isinstance(arr, list):
        return arr
    ops, lens = arr
    return list(zip(_OP_STR[ops].tolist(),
                    np.asarray(lens).astype(np.int64).tolist()))


def merge_cigar_arrays(a, b):
    """Concatenate two array-form cigars, joining an equal boundary op."""
    aops, alens = a
    bops, blens = b
    if len(aops) == 0:
        return b
    if len(bops) == 0:
        return a
    if aops[-1] == bops[0]:
        lens = np.concatenate([alens[:-1],
                               [alens[-1] + blens[0]], blens[1:]])
        ops = np.concatenate([aops, bops[1:]])
        return ops, lens.astype(np.int32)
    return (np.concatenate([aops, bops]),
            np.concatenate([alens, blens]))


def cigar_arrays_stats(arr) -> Tuple[int, int, int, int]:
    """(n_M, n_I, n_D, block_len) of an array-form cigar — vectorized
    sibling of cigar_stats."""
    ops, lens = arr
    if len(ops) == 0:
        return 0, 0, 0, 0
    sums = np.bincount(ops, weights=lens, minlength=3)
    nm, nd, ni = int(sums[0]), int(sums[1]), int(sums[2])
    return nm, ni, nd, nm + ni + nd


def traceback_arrays(dirs: np.ndarray, off: np.ndarray, start_i: int,
                     start_j: int, mode: int, lt: int = 1 << 30):
    """traceback returning the array cigar form (no per-run tuple list)
    plus the walk's minimum constraining-band-edge margin (W on the
    non-native fallback: no retry signal, band sizing is conservative
    there anyway)."""
    if _native_walks():
        from telr_jax.io import native
        return native.traceback_arrays(dirs, off, int(start_i),
                                       int(start_j), mode, lt)
    ops, ei, ej = traceback(dirs, off, start_i, start_j, mode)
    return cigar_to_arrays(ops), ei, ej, int(dirs.shape[1])


def align_pair(q: np.ndarray, t: np.ndarray, mode: int, params: DPParams,
               width: Optional[int] = None,
               off: Optional[np.ndarray] = None,
               want_cigar: bool = True):
    """Align one code-array pair.  Auto-buckets shapes to bound recompiles.

    Returns dict with score, cigar, and (for EXTEND/LOCAL) the end cell
    (query_end, target_end) plus for LOCAL the start cell.
    """
    kind, payload = _prep_pair(q, t, mode, params, width, off)
    if kind == "quick":
        return payload
    q_pad, t_pad, off_pad, lq, lt, width = payload
    run = _native_dp() or banded_dp_batch
    dirs, gscore, best, besti, bestp = run(
        q_pad[None], t_pad[None], off_pad[None],
        np.array([lq], np.int32), np.array([lt], np.int32),
        width=width, mode=mode, params_tuple=params.tuple())
    return _finish_pair(dirs[0], gscore[0], best[0], besti[0], bestp[0],
                        off_pad, lq, lt, mode, want_cigar)


# cap on dirs bytes (B * Lq * W) per launch; bounds device/host memory
_MAX_BATCH_CELLS = 1 << 26
_MAX_BATCH = 256


def _native_walks() -> bool:
    """True when the C++ traceback/count_matches walks are available (and
    not disabled via TELR_NATIVE_DP=0)."""
    import os
    if os.environ.get("TELR_NATIVE_DP", "1") == "0":
        return False
    from telr_jax.io import native
    return native.has_traceback()


def _native_dp():
    """The C++ banded-DP batch entry (native/telr_native.cpp), or None.

    Bit-exact with banded_dp_batch; preferred on the host-call paths
    because it pays neither XLA trace/compile per shape bucket nor a
    device round-trip per launch.  Disable with TELR_NATIVE_DP=0."""
    import os
    if os.environ.get("TELR_NATIVE_DP", "1") == "0":
        return None
    from telr_jax.io import native
    return native.banded_dp_batch if native.has_banded_dp() else None


def align_pairs(items, runner=None, want_cigar: bool = True,
                cigar_arrays: bool = False):
    """Batched align_pair: one padded banded_dp_batch launch per shape
    bucket instead of one launch per piece.

    items: list of (q, t, mode, params, width, off) — exactly align_pair's
    arguments.  Jobs are grouped by (mode, width, Lq-bucket, Lt-bucket,
    params) and each group runs as a single (chunked, power-of-two-B)
    batch; numerics are identical to per-piece align_pair because
    banded_dp_batch is an elementwise vmap.

    runner: optional override with banded_dp_batch's calling convention —
    the hook dist/exec.py uses to run the same batches through a
    mesh-sharded jit (stage-1 data parallelism over the "reads" axis).

    Returns one align_pair-style result dict per item."""
    results: List[Optional[dict]] = [None] * len(items)
    groups: dict = {}
    for i, (q, t, mode, params, width, off) in enumerate(items):
        kind, payload = _prep_pair(q, t, mode, params, width, off)
        if kind == "quick":
            if cigar_arrays and "cigar" in payload:
                payload = dict(payload,
                               cigar=cigar_to_arrays(payload["cigar"]))
            results[i] = payload
            continue
        q_pad, t_pad, off_pad, lq, lt, w = payload
        key = (mode, w, len(q_pad), len(t_pad), params.tuple())
        groups.setdefault(key, []).append((i, q_pad, t_pad, off_pad, lq, lt))

    native = _native_dp() if runner is None else None
    run = runner if runner is not None else (native or banded_dp_batch)
    for (mode, w, lq_b, lt_b, ptuple), jobs in groups.items():
        if native is not None:
            # native C++ path: no compile keys to manage — one exact-size
            # batch per group, bounded only by dirs memory
            chunk = min(_MAX_BATCH, max(1, _MAX_BATCH_CELLS // (lq_b * w)))
        elif runner is None and len(jobs) < 16:
            # small group on the single-device path: B=1 per piece reuses
            # ONE compiled graph per shape bucket (batching B would
            # multiply compile keys; XLA's scan compile dominates
            # wall-clock on small runs)
            chunk = 1
        else:
            # big group or mesh runner: large chunks amortize per-launch
            # dispatch + transfer overhead (the dominant cost at genome
            # scale: thousands of per-piece launches otherwise)
            chunk = min(_MAX_BATCH, max(1, _MAX_BATCH_CELLS // (lq_b * w)))
        for c0 in range(0, len(jobs), chunk):
            part = jobs[c0:c0 + chunk]
            if native is not None:
                B = len(part)
            else:
                # B bucketed to powers of 4 -> few distinct compile keys
                B = 1
                while B < len(part):
                    B *= 4
            qb = np.full((B, lq_b), 4, dtype=np.int8)
            tb = np.full((B, lt_b), 4, dtype=np.int8)
            ob = np.zeros((B, lq_b + 1), dtype=np.int32)
            ql = np.ones(B, dtype=np.int32)
            tl = np.ones(B, dtype=np.int32)
            for r, (_i, q_pad, t_pad, off_pad, lq, lt) in enumerate(part):
                qb[r] = q_pad
                tb[r] = t_pad
                ob[r] = off_pad
                ql[r] = lq
                tl[r] = lt
            dirs, gscore, best, besti, bestp = run(
                qb, tb, ob, ql, tl, width=w, mode=mode,
                params_tuple=ptuple)
            dirs = np.asarray(dirs)
            gscore = np.asarray(gscore)
            best = np.asarray(best)
            besti = np.asarray(besti)
            bestp = np.asarray(bestp)
            for r, (i, _q, _t, off_pad, lq, lt) in enumerate(part):
                results[i] = _finish_pair(
                    dirs[r], gscore[r], best[r], besti[r], bestp[r],
                    off_pad, lq, lt, mode, want_cigar, cigar_arrays)
    return results


def cigar_stats(cigar) -> Tuple[int, int, int, int]:
    """(n_M, n_I, n_D, block_len)."""
    if isinstance(cigar, tuple):
        return cigar_arrays_stats(cigar)
    nm = sum(l for op, l in cigar if op == "M")
    ni = sum(l for op, l in cigar if op == "I")
    nd = sum(l for op, l in cigar if op == "D")
    return nm, ni, nd, nm + ni + nd


def count_matches(q: np.ndarray, t: np.ndarray, cigar, qstart=0, tstart=0) -> int:
    """Number of exact residue matches along a cigar path (PAF col 10)."""
    if _native_walks():
        from telr_jax.io import native
        return native.count_matches(q, t, cigar, qstart, tstart)
    if isinstance(cigar, tuple):
        cigar = arrays_to_cigar(cigar)
    qi, tj = qstart, tstart
    matches = 0
    for op, ln in cigar:
        if op == "M":
            matches += int(np.sum(q[qi:qi + ln] == t[tj:tj + ln]))
            qi += ln
            tj += ln
        elif op == "I":
            qi += ln
        elif op == "D":
            tj += ln
    return matches
