"""Parameter sweep over the junction-stitch heuristics.

The junction-pair rescue path (sv/detect.py `_stitch_junctions`) carries
fixed constants — >=200bp segments, >=200 matched bases in the P-vs-S
overlap, +/-150bp end slack — that were tuned on one synthetic e2e
dataset.  These tests sweep read error rate and P/S overlap size to pin
the regimes where stitching must recover the TRUE insertion length, and
where it must degrade gracefully (fall back to the naive concat, never
drop the locus or crash).  Reference behavior being replaced: Sniffles'
clipped-read INS support consumed at TELR_sv.py:150-166 (the reference
never stitches; its assembly sees the raw per-locus reads instead).
"""

import numpy as np
import pytest

from telr_jax.config import MAP_ONT, MAP_PB, SVConfig
from telr_jax.core.alignstore import AlignmentStore
from telr_jax.io.seqs import SeqDict, Sequence
from telr_jax.kernels.mapper import Aligner
from telr_jax.sv.detect import detect_insertions


def _noisy(codes, rng, err):
    """Deletion-dominated long-read noise (matches test_insertion_band)."""
    if err == 0.0:
        return codes.copy()
    out = []
    for c in codes:
        r = rng.random()
        if r < err * 0.55:
            continue
        if r < err * 0.80:
            out.append(int(rng.integers(0, 4)))
        out.append(int(c))
        if rng.random() < err * 0.20:
            out.append(int(rng.integers(0, 4)))
    return np.array(out, dtype=np.int8)


def _detect(te_len, overlap, err, preset, seed=3, n_each=4):
    """Plant a TE no read spans; jr reads carry flank+TE[:Lp], jl reads
    TE[-Ls:]+flank with Lp+Ls = te_len+overlap; return detect records."""
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, 14_000).astype(np.int8)
    te = rng.integers(0, 4, te_len).astype(np.int8)
    ins_point = 6000
    lp = (te_len + overlap) // 2
    ls = te_len + overlap - lp
    reads = SeqDict()
    k = 0
    for _ in range(n_each):  # left-flank reads: ref flank + TE prefix
        s = ins_point - int(rng.integers(1500, 2500))
        seq = _noisy(np.concatenate([ref[s:ins_point], te[:lp]]), rng, err)
        reads.add(Sequence(f"jr{k}", seq)); k += 1
    for _ in range(n_each):  # right-flank reads: TE suffix + ref flank
        e = ins_point + int(rng.integers(1500, 2500))
        seq = _noisy(np.concatenate([te[te_len - ls:], ref[ins_point:e]]),
                     rng, err)
        reads.add(Sequence(f"jl{k}", seq)); k += 1
    for _ in range(2):       # reference-haplotype spanning reads
        s = ins_point - 2000
        reads.add(Sequence(f"ref{k}", _noisy(ref[s:s + 4000], rng, err)))
        k += 1
    aligner = Aligner(SeqDict([Sequence("chrS", ref)]), preset)
    alns = []
    for sq in reads:
        alns.extend(aligner.map_seq(sq.name, sq.codes))
    return detect_insertions(AlignmentStore(alns), reads,
                             SVConfig(min_support=5)), ins_point


# (error rate, preset, overlap, max relative length error).  Overlaps sit
# well above the 200-match stitch gate after error attrition: the P/S
# overlap sees independent noise on both copies, identity ~(1-err)^2.
SUPPORTED = [
    (0.00, MAP_PB, 400, 0.02),
    (0.00, MAP_PB, 1500, 0.02),
    (0.06, MAP_PB, 600, 0.10),
    (0.06, MAP_PB, 1500, 0.10),
    (0.12, MAP_ONT, 800, 0.18),
    (0.12, MAP_ONT, 1500, 0.18),
]


@pytest.mark.parametrize("err,preset,overlap,tol", SUPPORTED)
def test_stitch_recovers_insertion_length(err, preset, overlap, tol):
    te_len = 5000
    recs, ins_point = _detect(te_len, overlap, err, preset)
    assert len(recs) == 1, f"expected 1 locus, got {len(recs)}"
    r = recs[0]
    assert abs(r.start - ins_point) < 60
    assert not r.spanning_reads          # nothing spans the 5kb TE
    # stitched length must track the true insertion, not Lp+Ls
    rel = abs(r.length - te_len) / te_len
    assert rel <= tol, (f"stitched length {r.length} vs true {te_len} "
                        f"(rel err {rel:.3f} > {tol})")
    # the naive concat would be te_len+overlap; stitching must beat the
    # midpoint between truth and concat for real overlaps
    assert r.length < te_len + 0.6 * overlap


@pytest.mark.parametrize("err,preset,overlap", [
    (0.00, MAP_PB, 120),     # overlap below the 200-match stitch gate
    (0.12, MAP_ONT, 220),    # nominal 220bp -> ~130 expected matches
])
def test_sub_threshold_overlap_degrades_gracefully(err, preset, overlap):
    """Too-small overlaps must NOT stitch at a spurious anchor; the locus
    still emits via the naive concat (over-sized but TE-homologous)."""
    te_len = 5000
    recs, ins_point = _detect(te_len, overlap, err, preset)
    assert len(recs) == 1
    r = recs[0]
    assert abs(r.start - ins_point) < 60
    # concat fallback or a correct stitch are both acceptable; a *wrong*
    # stitch (chance anchor inside the TE) would undersize the insertion
    assert r.length >= te_len * 0.8
