"""Reference-genome repeat annotation with the TE consensus library.

Replaces RepeatMasker on the whole reference (reference TELR_te.py:391-433 +
gff3tobed TELR_te.py:436-468): every genomic copy of each library consensus
becomes an interval (chrom, start, end, family, '.', strand), sorted — the
`ref_te_bed` the liftover stage uses to distinguish reference from
non-reference TEs (check_nearby_ref, TELR_liftover.py:288-340).

Implementation: the library consensi are mapped against the indexed genome
with the homology-search preset (many secondaries kept, local-identity
filtered) using the shared seed-chain-extend core — the rmblast role.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional

from telr_jax.config import LIB_TO_SEQ, AlignPreset
from telr_jax.io.seqs import SeqDict
from telr_jax.kernels.mapper import Aligner
from telr_jax.ops.intervals import Intervals

logger = logging.getLogger("TELR")


def repeatmask_reference(
    reference: SeqDict,
    library: SeqDict,
    preset: Optional[AlignPreset] = None,
    max_copies: int = 4000,
    use_wavefront: bool = False,
    shard=None,
    allgather=None,
) -> Intervals:
    """Annotate all library-homologous intervals on the reference; the whole
    library is searched in one batched dispatch.

    ``max_copies`` bounds the per-family copy count (high-copy families like
    INE-1 reach thousands of genomic copies); hitting the cap is logged so a
    truncated reference-TE annotation is never silent.

    shard=(pid, P) with an ``allgather`` callable distributes the CHAIN
    JOBS round-robin across P processes (family sharding cannot balance a
    library where one high-copy family dominates — SCALING_r04 measured
    the stage flat at 33-43 s from 1p to 4p): every process plans the
    identical job list, aligns its ji % P share, all-gathers the per-job
    alignments, and postprocesses the merged list — bit-identical to the
    single-process result because postprocess sees the same ordered list.
    """
    if preset is None:
        preset = dataclasses.replace(LIB_TO_SEQ, max_secondary=max_copies)
    aligner = Aligner(reference, preset, max_occ=4096,
                      use_wavefront=use_wavefront)
    queries = {s.name: s.codes for s in library}
    if shard is not None:
        from telr_jax.kernels.mapper import map_batch_grouped
        pid, P = shard
        mine = map_batch_grouped([(aligner, queries)],
                                 max_hits=max_copies,
                                 job_shard=(pid, P), raw=True)[0]
        parts = allgather(mine)
        merged: dict = {}
        for ji in range(len(mine)):
            qname, aln = parts[ji % P][ji]
            merged.setdefault(qname, []).append(aln)
        results = {q: aligner._postprocess(alns, max_copies)
                   for q, alns in merged.items()}
    else:
        results = aligner.map_batch(queries, max_hits=max_copies)
    rows = []
    for s in library:
        hits = results.get(s.name, [])
        if len(hits) >= max_copies:
            logger.warning(
                "repeatmask: family %s hit the %d-copy cap; additional "
                "genomic copies were dropped (raise max_copies to keep them)",
                s.name, max_copies)
        for a in hits:
            rows.append((a.tname, a.tstart, a.tend, s.name, ".", a.strand))
    return Intervals.from_rows(rows, ("family", "score", "strand")).sort()
