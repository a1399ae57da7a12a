"""Typed configuration for the telr_jax pipeline.

Replaces TELR's argparse-default sprawl (reference TELR_input.py:10-256 and the
duplicated standalone liftover CLI defaults, TELR_liftover.py:136-151) with one
dataclass tree carrying pacbio/ont preset profiles.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class AlignPreset:
    """Parameters of the seed-chain-extend aligner for one preset profile.

    These play the role of minimap2's -x presets (map-pb/map-ont/asm10) and of
    NGMLR's -x pacbio/ont (reference TELR_alignment.py:15-26, 56-65,
    TELR_te.py:34-37, TELR_te.py:905).
    """

    name: str
    k: int                      # minimizer k-mer size
    w: int                      # minimizer window size
    min_chain_anchors: int      # min anchors to keep a chain
    min_chain_score: int
    max_anchor_gap: int         # max gap between chained anchors
    band_width: int             # DP band width (static, lane-aligned)
    match: int
    mismatch: int
    gap_open: int
    gap_extend: int             # single affine gap model; deviation from
                                # minimap2's dual-affine long-gap scoring is
                                # deliberate — long gaps are handled by chain
                                # splitting, not by a second gap component
    min_identity: float         # post-filter on alignment identity
    max_secondary: int          # secondary alignments kept
    chain_prune_frac: float = 0.0  # drop chains scoring below this
                                   # fraction of the best chain BEFORE the
                                   # DP (0 = keep all; homology presets
                                   # must keep all to find diverged copies)
    secondary_ratio: float = 0.0   # drop secondary alignments scoring
                                   # below this fraction of the best
                                   # primary (minimap2 -p; asm presets
                                   # use 0.8 so junk secondaries don't
                                   # block the liftover rescue path)


# Read->genome mapping, PacBio CLR error profile (~10-15% indel-heavy).
MAP_PB = AlignPreset(
    name="map-pb", k=15, w=10, min_chain_anchors=3, min_chain_score=40,
    max_anchor_gap=5000, band_width=512, match=2, mismatch=4, gap_open=4,
    gap_extend=2, min_identity=0.0,
    max_secondary=5,
)

# Read->genome mapping, ONT error profile.
MAP_ONT = AlignPreset(
    name="map-ont", k=15, w=10, min_chain_anchors=3, min_chain_score=40,
    max_anchor_gap=5000, band_width=512, match=2, mismatch=4, gap_open=4,
    gap_extend=2, min_identity=0.0,
    max_secondary=5,
)

# Assembly-to-reference mapping, ~10% divergence (flank liftover;
# reference TELR_te.py:905 hardcodes preset "asm10").
ASM10 = AlignPreset(
    name="asm10", k=19, w=10, min_chain_anchors=2, min_chain_score=40,
    max_anchor_gap=2000, band_width=512, match=1, mismatch=9, gap_open=16,
    gap_extend=2, min_identity=0.8,
    max_secondary=10, secondary_ratio=0.8,
)

# TE library -> sequence homology search (replaces RepeatMasker/rmblast,
# reference TELR_sv.py:254-273, TELR_te.py:267-290, TELR_te.py:391-433).
# Sensitive settings: small k, local alignment, tolerate ~20% divergence.
LIB_TO_SEQ = AlignPreset(
    name="lib2seq", k=11, w=5, min_chain_anchors=2, min_chain_score=20,
    max_anchor_gap=2000, band_width=512, match=2, mismatch=3, gap_open=5,
    gap_extend=2, min_identity=0.6,
    max_secondary=50,
)

PRESETS = {p.name: p for p in (MAP_PB, MAP_ONT, ASM10, LIB_TO_SEQ)}


@dataclasses.dataclass(frozen=True)
class SVConfig:
    """Insertion-signature detection thresholds (replaces the Sniffles subset
    TELR consumes: SVTYPE=INS records with explicit ALT sequence and RNAMES,
    reference TELR_sv.py:49-51, 159-228)."""

    min_ins_len: int = 30          # min insertion signature length
    max_cluster_dist: int = 1000   # cluster breakpoints within this distance
    cluster_split_gap: int = 200   # sub-split a cluster at position gaps
                                   # larger than this (distinct events that
                                   # single-linkage chained together)
    min_support: int = 5           # min supporting reads per cluster
    min_clip_len: int = 500        # min dangling query for a junction sig
    min_clip_mapq: int = 20        # flank segment mapq gate for junction sigs
    junction_pos_tol: int = 50     # max |median(jr)-median(jl)| in rescue
    min_junction_each: int = 2     # min reads per junction side in rescue
    merge_window: int = 20         # window merge of nearby loci (TELR_sv.py:84)
    min_af: float = 0.1            # drop clusters below this AF proxy
    hom_af: float = 0.8            # genotype thresholds (Sniffles-style)
    het_af: float = 0.3


@dataclasses.dataclass(frozen=True)
class AssemblyConfig:
    """Per-locus consensus assembly (replaces wtdbg2/wtpoa-cns + polish loop,
    reference TELR_assembly.py:104-366)."""

    polish_iterations: int = 1     # TELR -p default (TELR_input.py:200-201)
    max_locus_span: int = 30000    # wtdbg2 -g 30k cap (TELR_assembly.py:319)
    min_reads: int = 1
    max_reads: int = 64            # cap reads per locus batch slot
    max_extra_voters: int = 40     # cap non-support polish voters per locus
    window: int = 1000             # read-fetch window around breakpoint
    min_cov_frac: float = 0.2      # consensus column min coverage fraction


@dataclasses.dataclass(frozen=True)
class LiftoverConfig:
    """Flank liftover thresholds (reference TELR_liftover.py:136-151 standalone
    defaults; TELR mode passes gap=20, overlap=20 per TELR_input.py:250-254)."""

    flank_len: int = 500
    flank_gap_max: int = 20
    flank_overlap_max: int = 20
    nearby_ref_threshold: int = 5000   # TELR_liftover.py:289
    single_flank_ref_dist: int = 5     # TELR_liftover.py:856,917
    max_ref_gap: int = 20000           # TELR_liftover.py:697
    # junction-true gap on '-'-strand contigs (the reference's swapped
    # get_coord invocation negates it there — TELR_liftover.py:269 vs
    # :555 — silently dropping eroded-tip calls and never extracting
    # '-'-contig TSDs); False reproduces the reference byte-for-byte
    strand_aware_gap: bool = True


@dataclasses.dataclass(frozen=True)
class AFConfig:
    """Allele-frequency estimation windows (reference TELR_input.py:217-248
    defaults; consumed at TELR_te.py:518-575, 841-867)."""

    flank_interval: int = 100
    flank_offset: int = 200
    te_interval: int = 50
    te_offset: int = 50
    max_ratio: float = 1.5        # TELR_te.py:570
    max_taf_diff: float = 0.3     # TELR_te.py:819


@dataclasses.dataclass(frozen=True)
class AnnotateConfig:
    """Contig TE annotation thresholds (reference TELR_te.py:21-381)."""

    min_seq_overlap: int = 10      # VCF-seq vs TE-lib overlap >10bp (te.py:171)
    merge_dist: int = 10000        # bedtools merge -d 10000 (te.py:201)


@dataclasses.dataclass(frozen=True)
class TELRConfig:
    """Top-level pipeline configuration; mirrors the `telr` CLI surface
    (reference TELR_input.py:10-256)."""

    presets: str = "pacbio"        # "pacbio" | "ont"
    sv: SVConfig = dataclasses.field(default_factory=SVConfig)
    assembly: AssemblyConfig = dataclasses.field(default_factory=AssemblyConfig)
    liftover: LiftoverConfig = dataclasses.field(default_factory=LiftoverConfig)
    af: AFConfig = dataclasses.field(default_factory=AFConfig)
    annotate: AnnotateConfig = dataclasses.field(default_factory=AnnotateConfig)
    minimap2_family: bool = False  # False (reference default,
                                   # TELR_input.py:137-142): re-annotate TE
                                   # families RepeatMasker-style; True: keep
                                   # aligner-derived labels
    different_contig_name: bool = False
    keep_files: bool = False
    threads: int = 1               # stage-1 mapping worker processes (-t)
    use_wavefront: bool = False    # route mapper DPs through the device
                                   # wavefront (the GPU execution path)
    # Per-stage device routing.  None = every stage follows use_wavefront.
    # A tuple of stage names routes ONLY those stages' DPs to the device
    # and keeps the rest on the native host engine.  Names: alignment,
    # te_filter, assembly, annotate, af, repeatmask, liftover.
    wavefront_stages: Optional[Tuple[str, ...]] = None

    def wavefront_for(self, stage: str) -> bool:
        if self.wavefront_stages is None:
            return self.use_wavefront
        return stage in self.wavefront_stages

    @property
    def any_wavefront(self) -> bool:
        return self.use_wavefront or bool(self.wavefront_stages)

    @property
    def read_preset(self) -> AlignPreset:
        return MAP_ONT if self.presets == "ont" else MAP_PB

    _WAVEFRONT_STAGE_NAMES = ("alignment", "te_filter", "assembly",
                              "annotate", "af", "repeatmask", "liftover")

    def validate(self) -> None:
        if self.wavefront_stages is not None:
            bad = set(self.wavefront_stages) - set(self._WAVEFRONT_STAGE_NAMES)
            if bad:
                raise ValueError(
                    f"unknown wavefront_stages {sorted(bad)}; valid: "
                    f"{self._WAVEFRONT_STAGE_NAMES}")
        if self.presets not in ("pacbio", "ont"):
            raise ValueError(
                f"presets must be 'pacbio' or 'ont', got {self.presets!r}")
        if self.assembly.polish_iterations < 0:
            raise ValueError("polish_iterations must be >= 0")
        for name in ("flank_interval", "te_interval"):
            if getattr(self.af, name) <= 0:
                raise ValueError(f"af.{name} must be a positive integer")
        for name in ("flank_offset", "te_offset"):
            if getattr(self.af, name) < 0:
                raise ValueError(f"af.{name} must be >= 0")


def default_config(presets: str = "pacbio", **overrides) -> TELRConfig:
    cfg = TELRConfig(presets=presets, **overrides)
    cfg.validate()
    return cfg
