"""Sharded device-side pipeline steps.

Compute-dense inner steps of the pipeline, expressed over a
("reads", "loci") mesh:

  * `make_sharded_align_step` — stage-1 scoring: the read batch (padded
    (B, Lq) codes + band offsets) is sharded over the "reads" axis with the
    reference window replicated; each shard runs the banded DP scoring
    kernel over its reads.  The full mapper path runs the same partitioning
    through `dist.exec.sharded_dp_runner` (with traceback); this score-only
    step is the screening/compile surface.
  * `make_locus_score_step` — batched per-locus realignment scoring sharded
    over the "loci" axis (post all-to-all layout: each locus' read pile
    stays together).

Depth reductions live in `dist.exec.make_depth_psum_step` — CIGAR-true
M-span coverage psum-reduced over "reads" (samtools depth -aa semantics),
which is what `run_pipeline(mesh=...)` actually consumes for AF windows.

These functions are the multi-chip compile surface validated by
__graft_entry__.dryrun_multichip.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from telr_jax.dist.mesh import LOCI_AXIS, READS_AXIS
from telr_jax.kernels import dp


def make_sharded_align_step(mesh: Mesh, width: int, mode: int,
                            params_tuple):
    """Build a jitted sharded scoring step:
       (q (B,Lq) int8, t (Lt,) int8, off (B,Lq+1) i32, qlen (B,), tlen ())
       -> (scores (B,), best (B,))
    with q/off/qlen sharded over "reads" and t replicated."""

    def step(q, t, off, qlen, tlen):
        tb = jnp.broadcast_to(t, (q.shape[0],) + t.shape)
        tl = jnp.broadcast_to(tlen, (q.shape[0],))
        return dp.banded_dp_scores(
            q, tb, off, qlen, tl, width=width, mode=mode,
            params_tuple=params_tuple)

    batch_sh = NamedSharding(mesh, P(READS_AXIS))
    repl_sh = NamedSharding(mesh, P())
    return jax.jit(
        step,
        in_shardings=(batch_sh, repl_sh, batch_sh, batch_sh, repl_sh),
        out_shardings=(batch_sh, batch_sh),
    )


def make_locus_score_step(mesh: Mesh, width: int, params_tuple):
    """Batched per-locus realignment scoring sharded over the "loci" axis:
       (reads (L, R, Lq) int8, contigs (L, Lt) int8, off (L, R, Lq+1),
        qlen (L, R), tlen (L,)) -> (gscore (L, R), best (L, R))."""

    def step(reads, contigs, off, qlen, tlen):
        L, R, Lq = reads.shape

        def per_locus(rq, ct, roff, rql, ctl):
            tb = jnp.broadcast_to(ct, (R,) + ct.shape)
            tl = jnp.broadcast_to(ctl, (R,))
            return dp.banded_dp_scores(
                rq, tb, roff, rql, tl, width=width, mode=dp.EXTEND,
                params_tuple=params_tuple)

        return jax.vmap(per_locus)(reads, contigs, off, qlen, tlen)

    loci_sh = NamedSharding(mesh, P(LOCI_AXIS))
    return jax.jit(
        step,
        in_shardings=(loci_sh,) * 5,
        out_shardings=(loci_sh, loci_sh),
    )


# backwards-compatible alias (previous name)
make_locus_depth_step = make_locus_score_step
