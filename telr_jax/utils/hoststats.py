"""Lightweight wall-clock attribution counters for the host-side hot path.

The mapper/wavefront dispatch spends its time in places that are
invisible to stage-level timers: host planning, piece/schedule prep,
launch, device wait, and result decode (unpack + RLE).  These timers let
the pipeline log a per-stage breakdown.

Usage: with timer("wave_prep"): ...;  snapshot() -> dict, reset() zeroes.
count(name, k) adds to an integer counter (device dispatches, DP cells);
counters() / reset_counters() read and zero them.  Everything is
per-thread (threading.local), so a helper thread never mixes its numbers
into the dispatching thread's.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from contextlib import contextmanager

_TL = threading.local()


def _c():
    if not hasattr(_TL, "c"):
        _TL.c = defaultdict(float)
        _TL.n = defaultdict(int)
        _TL.k = defaultdict(int)
    return _TL.c, _TL.n


@contextmanager
def timer(name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        c, n = _c()
        c[name] += time.perf_counter() - t0
        n[name] += 1


def add(name: str, seconds: float, n: int = 1) -> None:
    c, cn = _c()
    c[name] += seconds
    cn[name] += n


def snapshot() -> dict:
    c, n = _c()
    return {k: {"s": round(v, 2), "n": n[k]} for k, v in sorted(c.items())}


def reset() -> None:
    c, n = _c()
    c.clear()
    n.clear()


def count(name: str, k: int) -> None:
    _c()
    _TL.k[name] += int(k)


def counters() -> dict:
    _c()
    return dict(sorted(_TL.k.items()))


def reset_counters() -> None:
    _c()
    _TL.k.clear()
