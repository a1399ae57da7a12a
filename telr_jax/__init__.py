"""telr_jax — a JAX engine for non-reference transposable-element (TE)
insertion detection from long reads, with its device path on NVIDIA GPUs.

Re-implements the full capability surface of bergmanlab/TELR (reference:
/root/reference/src/telr/telr.py:22-189) as an in-memory, array-based JAX/XLA
program.  Where TELR shells out to NGMLR/minimap2/Sniffles/wtdbg2/RepeatMasker/
samtools/bedtools with files as the ABI, telr_jax runs:

  * one batched banded affine-gap alignment core (CUDA wavefront DP on the
    GPU, native C++ engine on the host) serving all
    aligner roles (read->genome, INS-seq->contig, TE-library->anything,
    flank->reference, polish realignment),
  * an insertion-signature SV caller over CIGAR evidence,
  * a batched backbone+pileup consensus assembler for per-locus contigs,
  * a vectorised interval-algebra module replacing bedtools,
  * exact-semantics ports of TELR's liftover decision tree, allele-frequency
    rules and VCF/JSON/BED writers.

Pipeline entry point: telr_jax.pipeline.run_pipeline / the `telr-jax` CLI.
"""

__version__ = "0.1.0"
