"""FASTA/FASTQ readers and writers (host-side IO boundary).

Replaces the reference's Biopython/seqtk/samtools-fasta usage at the input
boundary (reference TELR_input.py:259-361, TELR_assembly.py:423-431).
Internally everything is a SeqDict of int8 code arrays; files only appear at
the pipeline boundary.
"""

from __future__ import annotations

import gzip
import io
import os
from typing import Iterator, List, Optional, TextIO, Tuple

import numpy as np

from telr_jax.io.seqs import Sequence, SeqDict, encode, decode


def _open_text(path: str) -> TextIO:
    if path.endswith(".gz"):
        return io.TextIOWrapper(gzip.open(path, "rb"))
    return open(path, "r")


def iter_fasta(path: str) -> Iterator[Tuple[str, str, str]]:
    """Yield (name, description, sequence) from a fasta/fastq file."""
    with _open_text(path) as fh:
        first = fh.read(1)
        fh.seek(0)
        if first == "@":
            yield from _iter_fastq(fh)
        else:
            yield from _iter_fasta_handle(fh)


def _iter_fasta_handle(fh: TextIO) -> Iterator[Tuple[str, str, str]]:
    name, desc, chunks = None, "", []
    for line in fh:
        line = line.rstrip("\n")
        if line.startswith(">"):
            if name is not None:
                yield name, desc, "".join(chunks)
            header = line[1:].split(None, 1)
            name = header[0] if header else ""
            desc = header[1] if len(header) > 1 else ""
            chunks = []
        elif line:
            chunks.append(line)
    if name is not None:
        yield name, desc, "".join(chunks)


def _iter_fastq(fh: TextIO) -> Iterator[Tuple[str, str, str]]:
    while True:
        header = fh.readline()
        if not header:
            return
        seq = fh.readline().rstrip("\n")
        fh.readline()  # +
        fh.readline()  # qual
        fields = header[1:].rstrip("\n").split(None, 1)
        name = fields[0] if fields else ""
        desc = fields[1] if len(fields) > 1 else ""
        yield name, desc, seq


def read_fasta(path: str, dedup: bool = True, keep=None) -> SeqDict:
    """Load fasta/fastq into a SeqDict.

    dedup=True keeps the first record per ID, matching the reference's
    rm_fasta_redundancy (TELR_input.py:351-361).
    keep: optional name predicate — records failing it are skipped at
    parse time (multi-process shard loading: each process materializes
    only its own read shard).
    """
    d = SeqDict()
    for name, desc, seq in iter_fasta(path):
        if keep is not None and not keep(name):
            continue
        d.add(Sequence.from_str(name, seq, desc), dedup=dedup)
    return d


def write_fasta(seqs, path: str, width: int = 60) -> None:
    """Write sequences (iterable of Sequence) to fasta with line wrapping."""
    with open(path, "w") as out:
        for s in seqs:
            header = s.name if not s.description else f"{s.name} {s.description}"
            out.write(f">{header}\n")
            text = s.seq
            for i in range(0, len(text), width):
                out.write(text[i : i + width] + "\n")


def faidx(seqs: SeqDict, path: str) -> None:
    """Write a .fai-style index (name, length) for provenance/debugging."""
    with open(path, "w") as out:
        for s in seqs:
            out.write(f"{s.name}\t{len(s)}\n")
