"""Minimizer sketching (minimap2-style) for the seed-chain-extend aligner.

Replaces the seeding stage of minimap2/NGMLR (reference TELR_alignment.py:31-82
shells out to them).  Canonical (strand-symmetric) minimizers: for every
window of w consecutive k-mers, keep the k-mer with the smallest invertible
64-bit hash over both strands.

All ops are vectorised numpy (host-side index build); the sliding-window
minimum uses a sparse-table (log2 w levels) rather than a materialised window
view so whole genomes fit in memory.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

_COMP = np.array([3, 2, 1, 0, 4], dtype=np.int8)


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """Invertible 64-bit finalizer (splitmix64)."""
    x = x.astype(np.uint64, copy=True)
    x = (x + np.uint64(0x9E3779B97F4A7C15)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    x ^= x >> np.uint64(30)
    x = (x * np.uint64(0xBF58476D1CE4E5B9)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    x ^= x >> np.uint64(27)
    x = (x * np.uint64(0x94D049BB133111EB)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    x ^= x >> np.uint64(31)
    return x


def pack_kmers(codes: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pack every k-mer into 2k bits, forward and reverse-complement.

    Returns (fwd_packed, rc_packed, valid) each of length n-k+1; valid is
    False where the k-mer contains an ambiguous base.
    """
    n = codes.shape[0]
    m = n - k + 1
    if m <= 0:
        z = np.zeros(0, dtype=np.uint64)
        return z, z.copy(), np.zeros(0, dtype=bool)
    c = codes.astype(np.uint64)
    comp = _COMP[codes.astype(np.int64)].astype(np.uint64)
    fwd = np.zeros(m, dtype=np.uint64)
    rc = np.zeros(m, dtype=np.uint64)
    for i in range(k):
        fwd = (fwd << np.uint64(2)) | (c[i : m + i] & np.uint64(3))
        rc |= (comp[i : m + i] & np.uint64(3)) << np.uint64(2 * i)
    bad = (codes == 4).astype(np.int64)
    cbad = np.concatenate([[0], np.cumsum(bad)])
    valid = (cbad[k:] - cbad[:-k]) == 0
    return fwd, rc, valid


def _sliding_argmin(vals: np.ndarray, w: int) -> np.ndarray:
    """Leftmost argmin over each window of w values; returns indices into vals
    of shape (len(vals)-w+1,).  Sparse-table: O(n log w) memory-light."""
    n = vals.shape[0]
    if n < w:
        return np.zeros(0, dtype=np.int64)
    idx = np.arange(n, dtype=np.int64)
    cur_v = vals.copy()
    cur_i = idx
    length = 1
    levels = []
    while length < w:
        levels.append((cur_v, cur_i, length))
        nxt = min(length * 2, w)
        shift = nxt - length
        v2 = cur_v[shift:]
        i2 = cur_i[shift:]
        m = len(v2)
        take_right = v2 < cur_v[:m]
        new_v = np.where(take_right, v2, cur_v[:m])
        new_i = np.where(take_right, i2, cur_i[:m])
        cur_v, cur_i, length = new_v, new_i, nxt
    return cur_i[: n - w + 1]


def minimizers(codes: np.ndarray, k: int, w: int
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Canonical minimizers of a sequence (native C++ fast path when the
    shared library is built; numpy otherwise — identical semantics, see
    tests/test_native.py).

    Returns (pos, hash, strand): start positions of selected k-mers, their
    canonical hashes, and strand (0 = forward k-mer was canonical).
    Ambiguous-base k-mers and strand-symmetric k-mers are skipped (their hash
    is set to +inf so they are never selected; windows that are entirely
    invalid produce no minimizer).
    """
    if codes.shape[0] >= k + w - 1:  # native path (identical output)
        try:
            from telr_jax.io import native
            if native.available():
                return native.minimizers(np.ascontiguousarray(codes), k, w)
        except ImportError:
            pass
    fwd, rc, valid = pack_kmers(codes, k)
    m = fwd.shape[0]
    if m == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, np.zeros(0, dtype=np.uint64), z.copy()
    hf = _splitmix64(fwd)
    hr = _splitmix64(rc)
    strand = (hr < hf).astype(np.int8)
    hcan = np.minimum(hf, hr)
    invalid = (~valid) | (hf == hr)
    hcan = np.where(invalid, np.uint64(0xFFFFFFFFFFFFFFFF), hcan)

    if m < w:
        sel = np.array([int(np.argmin(hcan))], dtype=np.int64)
    else:
        sel = _sliding_argmin(hcan, w)
        sel = np.unique(sel)
    keep = ~invalid[sel]
    sel = sel[keep]
    return sel, hcan[sel], strand[sel].astype(np.int64)
