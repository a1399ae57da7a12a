"""ctypes bindings for the native host runtime (native/telr_native.cpp).

Provides fast paths for sequence encoding, fasta scanning and minimizer
extraction.  Falls back to the pure-numpy implementations transparently when
the shared library has not been built (`make -C native`).
"""

from __future__ import annotations

import ctypes
import os
from typing import List, Optional, Tuple

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _find_lib() -> Optional[str]:
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    cand = os.path.join(here, "native", "libtelr_native.so")
    src = os.path.join(here, "native", "telr_native.cpp")
    stale = (os.path.isfile(cand) and os.path.isfile(src)
             and os.path.getmtime(cand) < os.path.getmtime(src))
    if (not os.path.isfile(cand) or stale) and os.path.isfile(src):
        _try_build(os.path.dirname(src))
    return cand if os.path.isfile(cand) else None


def _try_build(native_dir: str) -> None:
    """Build the engine in-place on first use (a fresh clone has no .so —
    without this the mapper silently rides the ~0.1 Gcells/s XLA scan).
    A lock file guards concurrent builds from forked workers."""
    import subprocess
    lock = os.path.join(native_dir, ".build_lock")
    try:
        fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    except OSError:
        # another process is building; wait for it briefly
        import time
        for _ in range(300):
            if not os.path.exists(lock):
                return
            time.sleep(0.1)
        return
    try:
        os.write(fd, str(os.getpid()).encode())
        os.close(fd)
        subprocess.run(["make", "-C", native_dir], check=True,
                       capture_output=True, timeout=300)
    except Exception as exc:  # noqa: BLE001 - any build failure -> fallback
        import logging
        logging.getLogger("telr").warning(
            "native engine build failed (%s); falling back to the slow "
            "XLA-scan DP (~6x slower per thread). Run `make -C %s` "
            "manually to diagnose.", exc, native_dir)
    finally:
        try:
            os.unlink(lock)
        except OSError:
            pass


def load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = _find_lib()
    if path is None:
        import logging
        logging.getLogger("telr").warning(
            "native host engine (libtelr_native.so) unavailable; "
            "CPU DP falls back to the slow XLA scan path")
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    i64 = ctypes.c_int64
    lib.telr_encode.argtypes = [ctypes.c_char_p, i64, ctypes.c_void_p]
    lib.telr_encode.restype = None
    lib.telr_scan_fasta.argtypes = [ctypes.c_char_p, i64] + \
        [ctypes.c_void_p] * 5 + [i64]
    lib.telr_scan_fasta.restype = i64
    lib.telr_minimizers.argtypes = [
        ctypes.c_void_p, i64, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.telr_minimizers.restype = i64
    lib.telr_wave_schedule.argtypes = [
        ctypes.c_void_p, i64, ctypes.c_void_p, i64, ctypes.c_void_p, i64,
        i64, ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p]
    lib.telr_wave_schedule.restype = ctypes.c_int32
    try:
        lib.telr_chain_dp.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, i64, ctypes.c_int32, i64,
            i64, ctypes.c_int32, ctypes.c_double, ctypes.c_void_p,
            ctypes.c_void_p]
        lib.telr_chain_dp.restype = None
    except AttributeError:
        # older .so without the chaining DP; callers fall back to numpy
        pass
    try:
        i32 = ctypes.c_int32
        lib.telr_poa_consensus.argtypes = (
            [ctypes.c_void_p, i64] + [ctypes.c_void_p] * 4 + [i64]
            + [i32] * 6 + [ctypes.c_void_p, i64])
        lib.telr_poa_consensus.restype = i64
    except AttributeError:
        pass
    try:
        lib.telr_chain_extract.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, i64, ctypes.c_double, i64,
            i64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p]
        lib.telr_chain_extract.restype = i64
    except AttributeError:
        pass
    try:
        lib.telr_index_lookup.argtypes = [
            ctypes.c_void_p, i64, ctypes.c_void_p, ctypes.c_int32,
            ctypes.c_void_p, i64, ctypes.c_void_p, ctypes.c_void_p]
        lib.telr_index_lookup.restype = None
    except AttributeError:
        pass
    try:
        i32 = ctypes.c_int32
        lib.telr_banded_dp_batch.argtypes = (
            [ctypes.c_void_p] * 5 + [i32] * 10 + [ctypes.c_void_p] * 2)
        lib.telr_banded_dp_batch.restype = None
        lib.telr_traceback.argtypes = [
            ctypes.c_void_p, i32, ctypes.c_void_p, i32, i32, i32, i32,
            ctypes.c_void_p, ctypes.c_void_p, i64, ctypes.c_void_p]
        lib.telr_traceback.restype = i64
        lib.telr_count_matches.argtypes = [
            ctypes.c_void_p, i64, ctypes.c_void_p, i64,
            ctypes.c_void_p, ctypes.c_void_p, i64, i64, i64]
        lib.telr_count_matches.restype = i64
    except AttributeError:
        pass
    try:
        i32 = ctypes.c_int32
        lib.telr_wave_decode_count.argtypes = (
            [ctypes.c_void_p, i64, i64] + [ctypes.c_void_p] * 3
            + [i32, ctypes.c_void_p])
        lib.telr_wave_decode_count.restype = None
        lib.telr_wave_decode_fill.argtypes = (
            [ctypes.c_void_p, i64, i64] + [ctypes.c_void_p] * 3
            + [i32] + [ctypes.c_void_p] * 3)
        lib.telr_wave_decode_fill.restype = None
    except AttributeError:
        pass
    try:
        lib.telr_wave_prepare_batch.argtypes = (
            [ctypes.c_void_p] * 6 + [i64] * 3 + [ctypes.c_void_p] * 4)
        lib.telr_wave_prepare_batch.restype = None
    except AttributeError:
        pass
    _LIB = lib
    return _LIB


def has_wave_decode() -> bool:
    lib = load()
    return lib is not None and hasattr(lib, "telr_wave_decode_count")


def wave_decode_batch(packed: np.ndarray, fi: np.ndarray, fj: np.ndarray,
                      bad: np.ndarray, lead: bool):
    """Batched decode of the device wavefront's packed op codes into
    per-pair array-form cigars (see native wave_walk_pair).

    packed: (n, s4) uint8 as pulled from the device (one row of op
    codes per pair); fi/fj/bad: (n,) int32 rows of the `small` stack.
    Returns (offsets (n+1,) int64, ops (total,) uint8, lens (total,)
    int32) — pair j's cigar is the [offsets[j]:offsets[j+1]] slice of
    ops/lens."""
    lib = load()
    n, s4 = packed.shape
    pt = np.ascontiguousarray(packed, dtype=np.uint8)
    fi = np.ascontiguousarray(fi, dtype=np.int32)
    fj = np.ascontiguousarray(fj, dtype=np.int32)
    bad = np.ascontiguousarray(bad, dtype=np.int32)
    nruns = np.empty(n, dtype=np.int32)
    lib.telr_wave_decode_count(pt.ctypes.data, s4, n, fi.ctypes.data,
                               fj.ctypes.data, bad.ctypes.data,
                               int(lead), nruns.ctypes.data)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(nruns, out=offsets[1:])
    total = int(offsets[-1])
    ops = np.empty(total, dtype=np.uint8)
    lens = np.empty(total, dtype=np.int32)
    lib.telr_wave_decode_fill(pt.ctypes.data, s4, n, fi.ctypes.data,
                              fj.ctypes.data, bad.ctypes.data, int(lead),
                              offsets.ctypes.data, ops.ctypes.data,
                              lens.ctypes.data)
    return offsets, ops, lens


def available() -> bool:
    return load() is not None


def encode(seq: bytes) -> np.ndarray:
    lib = load()
    if lib is None:
        from telr_jax.io.seqs import encode as np_encode
        return np_encode(seq)
    out = np.empty(len(seq), dtype=np.int8)
    lib.telr_encode(seq, len(seq), out.ctypes.data)
    return out


def scan_fasta(path: str) -> List[Tuple[str, str, np.ndarray]]:
    """Parse a fasta file natively. Returns [(name, description, codes)]."""
    lib = load()
    if lib is None:
        raise RuntimeError("native library not built")
    with open(path, "rb") as f:
        buf = f.read()
    n = len(buf)
    max_records = max(16, buf.count(b">") + 1)
    hs = np.empty(max_records, dtype=np.int64)
    he = np.empty(max_records, dtype=np.int64)
    ss = np.empty(max_records, dtype=np.int64)
    sl = np.empty(max_records, dtype=np.int64)
    codes = np.empty(n, dtype=np.int8)
    nrec = lib.telr_scan_fasta(buf, n, hs.ctypes.data, he.ctypes.data,
                               ss.ctypes.data, sl.ctypes.data,
                               codes.ctypes.data, max_records)
    if nrec < 0:
        raise RuntimeError("fasta scan overflow")
    out = []
    for i in range(nrec):
        header = buf[hs[i]:he[i]].decode("ascii", "replace").rstrip("\r")
        parts = header.split(None, 1)
        name = parts[0] if parts else ""
        desc = parts[1] if len(parts) > 1 else ""
        out.append((name, desc, codes[ss[i]:ss[i] + sl[i]].copy()))
    return out


def minimizers(codes: np.ndarray, k: int, w: int
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Native minimizer extraction; same semantics as
    telr_jax.kernels.minimizer.minimizers."""
    lib = load()
    if lib is None:
        from telr_jax.kernels.minimizer import minimizers as np_mini
        return np_mini(codes, k, w)
    n = len(codes)
    cap = max(16, n)
    pos = np.empty(cap, dtype=np.int64)
    hsh = np.empty(cap, dtype=np.uint64)
    strand = np.empty(cap, dtype=np.int8)
    codes = np.ascontiguousarray(codes, dtype=np.int8)
    cnt = lib.telr_minimizers(codes.ctypes.data, n, k, w,
                              pos.ctypes.data, hsh.ctypes.data,
                              strand.ctypes.data)
    return (pos[:cnt].copy(), hsh[:cnt].copy(),
            strand[:cnt].astype(np.int64))


def has_banded_dp() -> bool:
    lib = load()
    return lib is not None and hasattr(lib, "telr_banded_dp_batch")


def banded_dp_batch(q, t, off, qlen, tlen, *, width, mode, params_tuple):
    """Native drop-in for kernels.dp.banded_dp_batch (bit-exact recurrence;
    dirs rows beyond each pair's qlen are left zero — traceback never
    reads them).  Returns numpy (dirs, gscore, best, besti, bestp)."""
    lib = load()
    ma, mi, go, ge, amb = params_tuple
    q = np.ascontiguousarray(q, dtype=np.int8)
    t = np.ascontiguousarray(t, dtype=np.int8)
    off = np.ascontiguousarray(off, dtype=np.int32)
    qlen = np.ascontiguousarray(qlen, dtype=np.int32)
    tlen = np.ascontiguousarray(tlen, dtype=np.int32)
    B, lq_pad = q.shape
    lt_pad = t.shape[1]
    dirs = np.zeros((B, lq_pad, width), dtype=np.uint8)
    out = np.empty((B, 4), dtype=np.int32)
    lib.telr_banded_dp_batch(
        q.ctypes.data, t.ctypes.data, off.ctypes.data, qlen.ctypes.data,
        tlen.ctypes.data, B, lq_pad, lt_pad, width, mode,
        ma, mi, go, ge, amb, dirs.ctypes.data, out.ctypes.data)
    return dirs, out[:, 0], out[:, 1], out[:, 2], out[:, 3]


_OPS = np.array(["M", "D", "I"])


def _traceback_raw(dirs: np.ndarray, off: np.ndarray, si: int, sj: int,
                   mode: int, lt: int):
    lib = load()
    dirs = np.ascontiguousarray(dirs, dtype=np.uint8)
    off = np.ascontiguousarray(off, dtype=np.int32)
    cap = si + sj + 2
    ops = np.empty(cap, dtype=np.uint8)
    lens = np.empty(cap, dtype=np.int32)
    ij = np.empty(3, dtype=np.int32)
    n = lib.telr_traceback(dirs.ctypes.data, dirs.shape[1], off.ctypes.data,
                           si, sj, mode, lt, ops.ctypes.data,
                           lens.ctypes.data, cap, ij.ctypes.data)
    if n < 0:
        raise RuntimeError(f"traceback left the band from ({si},{sj})")
    return ops[:n], lens[:n], int(ij[0]), int(ij[1]), int(ij[2])


def traceback(dirs: np.ndarray, off: np.ndarray, si: int, sj: int,
              mode: int, lt: int = 1 << 30):
    """Native traceback walk; same contract as kernels.dp.traceback.
    Returns (cigar, end_i, end_j) or raises RuntimeError on band escape."""
    ops, lens, ei, ej, _m = _traceback_raw(dirs, off, si, sj, mode, lt)
    cigar = list(zip(_OPS[ops][::-1].tolist(), lens[::-1].tolist()))
    return cigar, ei, ej


def traceback_arrays(dirs: np.ndarray, off: np.ndarray, si: int, sj: int,
                     mode: int, lt: int = 1 << 30):
    """traceback returning the array cigar form (ops uint8, lens int32) in
    forward order plus the walk's minimum constraining-band-edge margin —
    skips the per-run tuple-list build."""
    ops, lens, ei, ej, margin = _traceback_raw(dirs, off, si, sj, mode, lt)
    return (ops[::-1].copy(), lens[::-1].copy()), ei, ej, margin


_OP_CODE = {"M": 0, "D": 1, "I": 2}


def count_matches(q: np.ndarray, t: np.ndarray, cigar, qstart=0,
                  tstart=0) -> int:
    lib = load()
    q = np.ascontiguousarray(q, dtype=np.int8)
    t = np.ascontiguousarray(t, dtype=np.int8)
    if isinstance(cigar, tuple):   # array form: (ops uint8, lens int32)
        ops = np.ascontiguousarray(cigar[0], dtype=np.uint8)
        lens = np.ascontiguousarray(cigar[1], dtype=np.int32)
        n = len(ops)
    else:
        n = len(cigar)
        ops = np.fromiter((_OP_CODE[op] for op, _ in cigar),
                          dtype=np.uint8, count=n)
        lens = np.fromiter((ln for _, ln in cigar), dtype=np.int32, count=n)
    return int(lib.telr_count_matches(
        q.ctypes.data, len(q), t.ctypes.data, len(t),
        ops.ctypes.data, lens.ctypes.data, n, qstart, tstart))


def has_traceback() -> bool:
    lib = load()
    return lib is not None and hasattr(lib, "telr_traceback")


def has_poa() -> bool:
    lib = load()
    return lib is not None and hasattr(lib, "telr_poa_consensus")


def poa_consensus(backbone: np.ndarray, segments, col0s, col1s=None, *,
                  width: int = 64, match: int = 2, mismatch: int = 4,
                  gap_open: int = 4, gap_extend: int = 2,
                  min_cov: int = 2) -> np.ndarray:
    """Banded partial-order consensus (the wtpoa-cns role).

    segments: oriented read segments (int8 code arrays); col0s/col1s[i] =
    the backbone span the segment covers (band anchors; the band center
    follows the linear map of the segment onto that span)."""
    lib = load()
    backbone = np.ascontiguousarray(backbone, dtype=np.int8)
    off = np.zeros(len(segments) + 1, dtype=np.int64)
    for i, s in enumerate(segments):
        off[i + 1] = off[i] + len(s)
    flat = np.empty(int(off[-1]), dtype=np.int8)
    for i, s in enumerate(segments):
        flat[off[i]:off[i + 1]] = s
    col0 = np.ascontiguousarray(np.asarray(col0s, dtype=np.int64))
    if col1s is None:
        col1s = [len(backbone)] * len(segments)
    col1 = np.ascontiguousarray(np.asarray(col1s, dtype=np.int64))
    cap = len(backbone) + int(off[-1]) + 16
    out = np.empty(cap, dtype=np.int8)
    n = lib.telr_poa_consensus(
        backbone.ctypes.data, len(backbone), flat.ctypes.data,
        off.ctypes.data, col0.ctypes.data, col1.ctypes.data,
        len(segments), width, match, mismatch, gap_open, gap_extend,
        min_cov, out.ctypes.data, cap)
    if n < 0:
        return np.zeros(0, dtype=np.int8)
    return out[:n].copy()


def has_chain_extract() -> bool:
    lib = load()
    return lib is not None and hasattr(lib, "telr_chain_extract")


def chain_extract(f: np.ndarray, parent: np.ndarray, min_score: float,
                  min_anchors: int, max_chains: int):
    """Greedy score-ordered chain extraction (native back half of
    chain_anchors).  Returns (idx_flat, starts, lens, scores) arrays."""
    lib = load()
    n = len(f)
    idx = np.empty(n, dtype=np.int64)
    starts = np.empty(max_chains, dtype=np.int64)
    lens = np.empty(max_chains, dtype=np.int64)
    scores = np.empty(max_chains, dtype=np.float64)
    nc = lib.telr_chain_extract(f.ctypes.data, parent.ctypes.data, n,
                                float(min_score), min_anchors, max_chains,
                                idx.ctypes.data, starts.ctypes.data,
                                lens.ctypes.data, scores.ctypes.data)
    return idx, starts[:nc], lens[:nc], scores[:nc]


def has_index_lookup() -> bool:
    lib = load()
    return lib is not None and hasattr(lib, "telr_index_lookup")


def index_lookup(hashes: np.ndarray, pref: np.ndarray, pbits: int,
                 qhashes: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Prefix-table-accelerated equal-range search of sorted index hashes.
    Returns (lo, cnt) per query hash — same values as two np.searchsorted
    calls, but one hot bucket per probe instead of log2(N) cold lines."""
    lib = load()
    qhashes = np.ascontiguousarray(qhashes, dtype=np.uint64)
    m = len(qhashes)
    lo = np.empty(m, dtype=np.int64)
    cnt = np.empty(m, dtype=np.int64)
    lib.telr_index_lookup(hashes.ctypes.data, len(hashes),
                          pref.ctypes.data, pbits,
                          qhashes.ctypes.data, m,
                          lo.ctypes.data, cnt.ctypes.data)
    return lo, cnt
