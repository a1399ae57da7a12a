from telr_jax.io.seqs import (
    encode, decode, revcomp_codes, revcomp_str, Sequence, SeqDict,
)
from telr_jax.io.fasta import read_fasta, write_fasta, faidx
