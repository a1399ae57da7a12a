"""Forkserver-backed worker pools for host-side fan-out.

The mapper's planning (seeding/chaining) is GIL-bound Python+numpy, so
process fan-out is the only way to scale it — the thread-count parity of
the reference's aligner passthrough (TELR_alignment.py:31-51).  Plain
fork() pools are unsound here: the parent typically runs many native
threads (XLA dispatch, the GPU runtime, gloo collectives), and a child
forked while one of them holds a lock deadlocks on first use of the
locked subsystem (observed: a gloo-initialized 2-process pipeline run
wedging inside the alignment fork pool).

Forkserver fixes the class of bug: one server process is forked EARLY
(ideally before jax ever initializes — call ensure_forkserver() from
pipeline entry points), and every pool worker is then forked from that
quiescent server, inheriting no runtime threads.  Workers receive state
explicitly (a pickled Aligner via the pool initializer, sent once per
worker) instead of by copy-on-write globals.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
from typing import Dict, List, Optional

_CTX = None


def ensure_forkserver():
    """Start the forkserver process now; idempotent.

    Call as early as possible — before jax/XLA initialize — so the
    server is forked from a thread-free process.  Late calls still work
    (the server itself only runs a socket accept loop), they just narrow
    the safety margin."""
    global _CTX
    if _CTX is None:
        _CTX = mp.get_context("forkserver")
        try:
            from multiprocessing import forkserver
            forkserver.ensure_running()
        except Exception:
            # fall back to a no-op worker round-trip, which forces the
            # context to spawn its server
            p = _CTX.Process(target=_noop)
            p.start()
            p.join()
    return _CTX


def _noop():
    pass


# ----------------------------------------------------------------------
# worker-side state: one unpickled Aligner per pool worker, installed by
# the initializer before any task runs
_ALIGNER = None


def _worker_init(blob: bytes) -> None:
    # keep workers strictly on the CPU runtime BEFORE anything imports
    # jax (unpickling the Aligner imports kernels.dp -> jax): one process
    # holds the card, and a second JAX process on it would fail for want
    # of memory; workers also must not fan out DP threads
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["TELR_DP_THREADS"] = "1"
    global _ALIGNER
    _ALIGNER = pickle.loads(blob)


def _worker_plan(sub: Dict[str, bytes]):
    import numpy as np
    return {n: _ALIGNER._plan(np.frombuffer(c, np.int8))
            for n, c in sub.items()}


def _worker_map(arg):
    import numpy as np
    sub, max_hits = arg
    res = _ALIGNER.map_batch(
        {n: np.frombuffer(c, np.int8) for n, c in sub.items()},
        max_hits=max_hits)
    return [res.get(n, []) for n in sub]


class AlignerPool:
    """Persistent forkserver pool with one Aligner replica per worker.

    The aligner (reference codes + minimizer index, all numpy) is pickled
    ONCE into each worker at pool creation; per-call traffic is then just
    read codes out and chain plans / alignments back.  Reused across
    map calls for the lifetime of the owning Aligner."""

    def __init__(self, aligner, processes: int):
        ctx = ensure_forkserver()
        self.processes = processes
        blob = pickle.dumps(aligner, protocol=pickle.HIGHEST_PROTOCOL)
        self.pool = ctx.Pool(processes, initializer=_worker_init,
                             initargs=(blob,))

    @staticmethod
    def _chunks(queries: Dict[str, "np.ndarray"], n: int):
        names = list(queries)
        step = -(-len(names) // n)
        return [{m: queries[m].tobytes() for m in names[lo:lo + step]}
                for lo in range(0, len(names), step)]

    def plan(self, queries, processes: Optional[int] = None
             ) -> Dict[str, list]:
        """Fan _plan over the workers; returns {qname: picked chains}."""
        parts = self.pool.map(
            _worker_plan, self._chunks(queries, processes
                                       or self.processes))
        out: Dict[str, list] = {}
        for part in parts:
            out.update(part)
        return out

    def map_batch(self, queries, max_hits=None) -> Dict[str, list]:
        """Fan full map_batch over the workers (CPU DP path)."""
        chunks = self._chunks(queries, self.processes)
        parts = self.pool.map(_worker_map,
                              [(c, max_hits) for c in chunks])
        out: Dict[str, list] = {}
        for chunk, part in zip(chunks, parts):
            for name, alns in zip(chunk, part):
                out[name] = alns
        return out

    def close(self) -> None:
        self.pool.terminate()
        self.pool.join()
