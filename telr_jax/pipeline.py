"""The telr_jax pipeline driver.

Mirrors the reference's four-stage flow (telr.py:22-189) with sharded arrays
and in-memory records as the ABI instead of intermediate files:

  stage 1a  read -> reference alignment           (TELR_alignment.alignment)
  stage 1b  insertion detection + TE filter + merge  (TELR_sv)
  stage 2   per-locus assembly + polish           (TELR_assembly)
  stage 3a  contig TE annotation                  (TELR_te.annotate_contig)
  stage 4   allele frequency                      (TELR_te.get_af)
  ref mask  reference repeatmask -> ref TE bed    (TELR_te.repeatmask)
  stage 3b  flank liftover + classification       (TELR_liftover.liftover)
  output    VCF/JSON/BED/fasta                    (TELR_output.generate_output)
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import Dict, List, Optional, Set

from telr_jax.af.freq import estimate_af
from telr_jax.annotate.contig import annotate_contigs, reannotate_families
from telr_jax.annotate.repeatmask import repeatmask_reference
from telr_jax.assembly.local import assemble_all, collect_extra_voters
from telr_jax.config import TELRConfig, default_config
from telr_jax.core.alignstore import AlignmentStore
from telr_jax.io.fasta import read_fasta, write_fasta
from telr_jax.io.seqs import SeqDict
from telr_jax.kernels.mapper import Aligner
from telr_jax.liftover.engine import liftover
from telr_jax.ops.intervals import Intervals
from telr_jax.report.output import generate_output
from telr_jax.sv.detect import SVRecord, detect_insertions
from telr_jax.sv.filter import filter_te_candidates
from telr_jax.sv.merge import merge_nearby_records
from telr_jax.utils.checkpoint import Checkpointer
from telr_jax.utils.evallog import LociEval

logger = logging.getLogger("telr_jax")


def _redistribute_loci(mesh, records: List[SVRecord], reads: SeqDict,
                       extra_voters: Dict[str, List[str]]
                       ) -> "SeqDict":
    """Route every (locus, read) PAYLOAD through the device all-to-all to
    its locus' owner shard and rebuild the assembly-stage read set from
    what the owner received (SURVEY §2c locus redistribution; replaces
    the reference's csplit per-locus read files TELR_assembly.py:418-456).

    Items are (locus_id, rank, kind, read_codes) — kind 0 = supporting
    read (rank indexes rec.reads), kind 1 = extra voter (rank indexes
    extra_voters[locus]).  Source shard = crc32(read name) mod S (the
    data-parallel read layout), owner = locus_id mod S.  Assembly then
    consumes ONLY the received codes: on a single host they must
    reproduce the local reads bit-for-bit — a routing or payload bug
    surfaces as a hard error, so the collective is load-bearing, not
    decorative."""
    import zlib

    import numpy as np

    from telr_jax.dist.mesh import READS_AXIS
    from telr_jax.dist.redistribute import owner_of, redistribute_payloads
    from telr_jax.io.seqs import Sequence

    n = int(mesh.shape[READS_AXIS])
    items_per_shard: List[List[tuple]] = [[] for _ in range(n)]
    name_of: Dict[tuple, str] = {}
    for li, rec in enumerate(records):
        for kind, names in ((0, rec.reads),
                            (1, extra_voters.get(rec.locus_name, []))):
            for rank, rn in enumerate(names):
                src = zlib.crc32(rn.encode()) % n
                items_per_shard[src].append(
                    (li, rank, kind, reads[rn].codes))
                name_of[(li, rank, kind)] = rn
    n_items = sum(len(x) for x in items_per_shard)
    if n_items == 0:
        return reads
    merged = redistribute_payloads(mesh, items_per_shard)
    got: Dict[tuple, np.ndarray] = {}
    for dst, lst in enumerate(merged):
        for li, rank, kind, codes in lst:
            if owner_of(li, n) != dst:
                raise RuntimeError(
                    f"locus {li} landed on shard {dst}, owner is "
                    f"{owner_of(li, n)}")
            got[(li, rank, kind)] = codes
    if set(got) != set(name_of):
        raise RuntimeError("locus redistribution dropped or duplicated "
                           "(locus, read) items")
    rebuilt = SeqDict()
    for key, codes in got.items():
        rn = name_of[key]
        if not np.array_equal(codes, reads[rn].codes):
            raise RuntimeError(
                f"locus redistribution corrupted read payload for {rn}")
        if rn not in rebuilt:
            rebuilt.add(Sequence(name=rn, codes=codes))
    logger.info("locus all-to-all: %d payload items (%d unique reads), "
                "%d loci over %d shards", n_items, len(rebuilt),
                len(records), n)
    return rebuilt


def _input_fingerprint(paths, config: TELRConfig) -> str:
    """Content hash of the input files + the semantic config fields.

    Execution knobs (threads, wavefront backend, keep_files) are
    excluded on purpose: they must not invalidate checkpoints, because
    both backends produce identical alignments and the knobs don't
    change results."""
    import hashlib
    h = hashlib.blake2b(digest_size=16)
    for p in paths:
        h.update(os.path.basename(p).encode())
        with open(p, "rb") as f:
            while True:
                chunk = f.read(1 << 22)
                if not chunk:
                    break
                h.update(chunk)
    sem = (config.presets, config.sv, config.assembly, config.annotate,
           config.af, config.liftover, config.minimap2_family,
           config.different_contig_name, config.read_preset)
    h.update(repr(sem).encode())
    return h.hexdigest()


@dataclasses.dataclass
class PipelineResult:
    sample_name: str
    records: List[SVRecord]
    contigs: SeqDict
    contig_te: Intervals
    te_freq: Dict[str, dict]
    liftover_report: List[dict]
    summary: dict
    final_report: List[dict]
    loci_eval: LociEval
    stage_seconds: Dict[str, float]
    # stages whose stage_seconds reflect a checkpoint restore, not compute —
    # throughput derived from them is meaningless
    restored_stages: List[str] = dataclasses.field(default_factory=list)
    # per stage: device dispatches and DP cells, and the dispatches and
    # cells the size gate kept on the host (utils/hoststats counters)
    stage_counters: Dict[str, dict] = dataclasses.field(default_factory=dict)


def run_pipeline(
    reads_path: str,
    reference_path: str,
    library_path: str,
    out_dir: str,
    config: Optional[TELRConfig] = None,
    sample_name: Optional[str] = None,
    checkpoint_dir: Optional[str] = None,
    profile_dir: Optional[str] = None,
    mesh=None,
) -> PipelineResult:
    """mesh: optional jax.sharding.Mesh with a "reads" axis.  When given,
    stage-1 DP batches execute as sharded SPMD over the mesh, candidate
    loci are redistributed with the device all-to-all before assembly,
    and AF depth reductions run as psum over the "reads" axis."""
    from telr_jax.utils.procpool import ensure_forkserver
    ensure_forkserver()   # before jax spins up threads (see procpool.py)
    config = config or default_config()
    if profile_dir:
        import jax
        # bounded trace: HLO protos + verbose host events off — a full
        # pipeline run compiles dozens of kernels and a default trace
        # overflows the 2GB XSpace protobuf cap (observed); level-1 host
        # tracing keeps the telr_stage TraceAnnotations, and the perfetto
        # json is what tools/profile_report.py parses
        opts = jax.profiler.ProfileOptions()
        opts.host_tracer_level = 1
        opts.python_tracer_level = 0
        opts.enable_hlo_proto = False
        jax.profiler.start_trace(profile_dir, create_perfetto_trace=True,
                                 profiler_options=opts)
    os.makedirs(out_dir, exist_ok=True)
    if sample_name is None:
        sample_name = os.path.splitext(os.path.basename(reads_path))[0]
    ckpt = Checkpointer(checkpoint_dir)
    if checkpoint_dir:
        # stage checkpoints are keyed by name only — fingerprint the
        # inputs + semantic config so a rerun with different reads or
        # thresholds can never silently resume stale results
        fp = _input_fingerprint(
            (reads_path, reference_path, library_path), config)
        if not ckpt.validate_fingerprint(fp):
            logger.warning("checkpoint inputs/config changed; existing "
                           "checkpoints invalidated")

    logging.basicConfig(
        level=logging.INFO,
        filename=os.path.join(out_dir, "TELR.log"),
        filemode="w",
        format="%(asctime)s: %(levelname)s: %(message)s",
        datefmt="%m/%d/%Y %H:%M:%S",
    )

    stage_seconds: Dict[str, float] = {}
    stage_counters: Dict[str, dict] = {}
    restored_stages: List[str] = []
    from telr_jax.utils import hoststats

    def timed(name):
        class _T:
            def __enter__(self):
                hoststats.reset_counters()
                self.t0 = time.time()
                logger.info("stage %s ...", name)
                if profile_dir:
                    import jax
                    # stage span marker in the profiler trace, so
                    # tools/profile_report.py can attribute device time
                    # per stage
                    self._ann = jax.profiler.TraceAnnotation(
                        f"telr_stage:{name}")
                    self._ann.__enter__()
                return self

            def __exit__(self, *a):
                if profile_dir:
                    self._ann.__exit__(None, None, None)
                stage_seconds[name] = time.time() - self.t0
                stage_counters[name] = hoststats.counters()
                logger.info("stage %s finished in %.2fs %s", name,
                            stage_seconds[name], stage_counters[name])
        return _T()

    # pre-aligned input (BAM/SAM) skips stage 1a, mirroring the reference's
    # BAM path (TELR_input.py:299-305, telr.py:58-61); reads are
    # reconstructed from the alignment records like `samtools fasta`
    prealigned = reads_path.endswith((".bam", ".sam", ".sam.gz"))
    with timed("parse_input"):
        if prealigned:
            from telr_jax.io.samio import read_alignment_file
            store, reads = read_alignment_file(reads_path)
            logger.info("pre-aligned input provided, skip alignment step")
        else:
            reads = read_fasta(reads_path)
            store = None
        reference = read_fasta(reference_path)
        library = read_fasta(library_path)
    loci_eval = LociEval()

    with timed("alignment"):
        if store is not None:
            pass  # pre-aligned input
        elif ckpt.has("alignment"):
            store = ckpt.load_alignments("alignment")
            logger.info("alignment stage restored from checkpoint")
            restored_stages.append("alignment")
        else:
            # stage-1 genome mapping prunes weak secondary chains before
            # the DP (minimap2-style) — the big mapping-throughput lever
            # on repeat-dense genomes; per-locus realignments keep every
            # chain (the AF depth windows count all local reads)
            stage1_preset = dataclasses.replace(config.read_preset,
                                                chain_prune_frac=0.5)
            aligner = Aligner(reference, stage1_preset,
                              use_wavefront=config.wavefront_for("alignment"),
                              mesh=mesh)
            result = aligner.map_batch_parallel(
                {s.name: s.codes for s in reads}, config.threads)
            alns = [a for hits in result.values() for a in hits]
            store = AlignmentStore(alns)
            ckpt.save_alignments("alignment", store)

    if ("alignment" in stage_seconds and stage_seconds["alignment"] > 0
            and "alignment" not in restored_stages and not prealigned):
        n_bases = sum(len(s) for s in reads)
        logger.info(
            "alignment throughput: %.2f reads/s, %.3f Mbases/s "
            "(%d reads, %d alignments)",
            len(reads) / stage_seconds["alignment"],
            n_bases / 1e6 / stage_seconds["alignment"],
            len(reads), len(store))
        logger.info("alignment breakdown: %s", hoststats.snapshot())
        hoststats.reset()

    with timed("sv_detection"):
        records = detect_insertions(store, reads, config.sv, sample_name)

    with timed("te_filter"):
        if ckpt.has("te_filter"):
            records = ckpt.load_records("te_filter")
            logger.info("te_filter stage restored from checkpoint")
            restored_stages.append("te_filter")
        else:
            records = filter_te_candidates(
                records, library, loci_eval,
                use_wavefront=config.wavefront_for("te_filter"))
            records = merge_nearby_records(records, config.sv.merge_window)
            ckpt.save_records("te_filter", records)

    # non-support reads overlapping each locus polish the flank
    # columns to full local depth (the other haplotype + flank-only
    # reads; assemble_all guards against deletion-of-the-TE votes)
    assembly_reads = reads
    extra_voters = None
    if mesh is not None and records and not ckpt.has("assembly"):
        with timed("locus_redistribute"):
            # device all-to-all: co-locate each locus' read PAYLOADS
            # (support + voter codes) on its owner shard before batched
            # assembly (SURVEY §2c); assembly consumes only the received
            # codes, with the payloads genuinely riding lax.all_to_all
            extra_voters = collect_extra_voters(
                records, store, config.assembly.window)
            assembly_reads = _redistribute_loci(mesh, records, reads,
                                                extra_voters)

    with timed("assembly"):
        if ckpt.has("assembly"):
            contigs, extra = ckpt.load_seqs("assembly")
            passed = set(extra.get("passed", []))
            logger.info("assembly stage restored from checkpoint")
            restored_stages.append("assembly")
        else:
            if extra_voters is None:
                extra_voters = collect_extra_voters(
                    records, store, config.assembly.window)
            contigs, passed = assemble_all(
                records, assembly_reads, config.read_preset,
                config.assembly, loci_eval,
                use_wavefront=config.wavefront_for("assembly"),
                extra_voters=extra_voters)
            ckpt.save_seqs("assembly", contigs,
                           {"passed": sorted(passed)})
    if (records and stage_seconds.get("assembly", 0) > 0
            and "assembly" not in restored_stages):
        logger.info("assembly throughput: %.3f loci/s (%d loci)",
                    len(records) / stage_seconds["assembly"], len(records))

    with timed("annotate_contig"):
        contig_te, te_seqs = annotate_contigs(
            contigs, passed, library, records, config.read_preset,
            config.annotate, loci_eval,
            use_wavefront=config.wavefront_for("annotate"))
        if not config.minimap2_family:
            contig_te = reannotate_families(
                contig_te, te_seqs, library,
                use_wavefront=config.wavefront_for("annotate"))

    with timed("allele_frequency"):
        te_freq = estimate_af(records, contigs, contig_te, reads, store,
                              config.read_preset, config.af, config.assembly,
                              use_wavefront=config.wavefront_for("af"),
                              mesh=mesh)

    with timed("ref_repeatmask"):
        # checkpointed: depends only on (reference, library), and the
        # whole-genome homology sweep is among the most expensive stages
        # at scale (the reference RepeatMasks the full genome every run,
        # TELR_te.py:391-433)
        if ckpt.has("ref_repeatmask"):
            ref_te_bed = ckpt.load_intervals("ref_repeatmask")
        else:
            ref_te_bed = repeatmask_reference(
                reference, library,
                use_wavefront=config.wavefront_for("repeatmask"))
            ckpt.save_intervals("ref_repeatmask", ref_te_bed)
        if len(ref_te_bed) == 0:
            ref_te_bed = None

    with timed("liftover"):
        lift_report, nonref_bed, summary = liftover(
            contigs, reference, contig_te, ref_te_bed, config.liftover,
            different_contig_name=config.different_contig_name,
            telr_mode=True,
            use_wavefront=config.wavefront_for("liftover"))
        # component-retry entries (liftover/engine.py) carry sub-interval
        # coords the annotate stage never extracted; slice their TE
        # sequences now so the output stage can look them up
        from telr_jax.io.seqs import Sequence as _Seq
        for item in lift_report:
            info = item.get("report")
            if not info or info.get("type") != "non-reference":
                continue
            ins_name = item["genome1_coord"]
            if ins_name in te_seqs:
                continue
            cname, _, coord = ins_name.rpartition(":")
            if cname in contigs:
                cs, ce = (int(x) for x in coord.split("-"))
                te_seqs.add(_Seq(name=ins_name,
                                 codes=contigs[cname].slice(cs, ce)))

    with timed("output"):
        final = generate_output(
            lift_report, te_freq, te_seqs, records, contig_te, contigs,
            reference, out_dir, sample_name, ref_path=reference_path)
        # run provenance (the reference exports its conda env,
        # telr.py:184-185 / TELR_utility.py:76-89)
        import dataclasses as _dc
        import sys as _sys
        try:
            import jax as _jax
            jv = _jax.__version__
        except Exception:
            jv = None
        import numpy as _np
        with open(os.path.join(out_dir, "run_env.json"), "w") as f:
            json.dump({
                "telr_jax": __import__("telr_jax").__version__,
                "python": _sys.version.split()[0],
                "jax": jv,
                "numpy": _np.__version__,
                "config": _dc.asdict(config),
            }, f, indent=2)
        loci_eval.write(os.path.join(out_dir,
                                     sample_name + ".loci_eval.tsv"))
        with open(os.path.join(out_dir, "liftover_summary.json"), "w") as f:
            json.dump(summary, f, indent=4, sort_keys=False)
        with open(os.path.join(out_dir, "liftover_report.json"), "w") as f:
            json.dump(lift_report, f, indent=4, sort_keys=False)

    if profile_dir:
        import jax
        jax.profiler.stop_trace()
        logger.info("profiler trace written to %s", profile_dir)

    if not final:
        print("No non-reference TE insertion found")
        logger.info("TELR found no non-reference TE insertions")

    ckpt.close()  # release the checkpoint-dir lock
    return PipelineResult(
        sample_name=sample_name, records=records, contigs=contigs,
        contig_te=contig_te, te_freq=te_freq, liftover_report=lift_report,
        summary=summary, final_report=final, loci_eval=loci_eval,
        stage_seconds=stage_seconds,
        restored_stages=restored_stages,
        stage_counters=stage_counters)
