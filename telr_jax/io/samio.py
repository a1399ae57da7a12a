"""SAM/BAM import + SAM export at the pipeline boundary.

The reference accepts pre-aligned reads (BAM) and skips stage 1a
(TELR_input.py:299-305) and emits BAM internally; telr_jax keeps alignments
in memory and imports either form at the boundary: `read_sam` parses SAM
text (plain or gzip), `read_bam` parses the binary BAM container directly
(BGZF is a concatenated-member gzip stream, which Python's zlib/gzip layer
decompresses natively — no htslib needed), and `read_alignment_file`
dispatches on extension.  Both build the same (AlignmentStore, reads
SeqDict) pair, so a pre-aligned run enters the pipeline exactly where a
fresh alignment would.
"""

from __future__ import annotations

import gzip
import io
import re
import struct
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from telr_jax.core.alignstore import AlignmentStore
from telr_jax.io.seqs import SeqDict, Sequence, encode, revcomp_codes
from telr_jax.kernels.mapper import Alignment

_CIG_RE = re.compile(r"(\d+)([MIDNSHP=X])")


def parse_cigar(s: str) -> List[Tuple[str, int]]:
    """SAM CIGAR -> internal ops.  =/X fold into M; N folds into D;
    H/P are dropped; S is returned separately by the caller via spans."""
    out: List[Tuple[str, int]] = []

    def push(op, ln):
        if out and out[-1][0] == op:
            out[-1] = (op, out[-1][1] + ln)
        else:
            out.append((op, ln))

    for ln, op in _CIG_RE.findall(s):
        ln = int(ln)
        if op in ("M", "=", "X"):
            push("M", ln)
        elif op == "I":
            push("I", ln)
        elif op in ("D", "N"):
            push("D", ln)
        # S/H/P: not part of the aligned block
    return out


def _clips(s: str) -> Tuple[int, int]:
    """(leading, trailing) soft/hard clip lengths."""
    ops = _CIG_RE.findall(s)
    lead = int(ops[0][0]) if ops and ops[0][1] in "SH" else 0
    tail = int(ops[-1][0]) if ops and ops[-1][1] in "SH" else 0
    return lead, tail


def _ingest(qname: str, flag: int, rname: str, pos1: int, mapq: int,
            cigar: str, seq: str, sq_len: Dict[str, int],
            alns: List[Alignment], reads: SeqDict) -> None:
    """Fold one SAM/BAM record into (alns, reads).  Reads are reconstructed
    from SEQ fields of primary alignments (reverse-complemented back to
    original orientation for flag 0x10), the same information `samtools
    fasta` extracts for the reference's BAM input path
    (TELR_input.py:329-348)."""
    if flag & 4 or rname == "*" or cigar == "*":
        return
    secondary = bool(flag & 0x100)
    reverse = bool(flag & 0x10)
    ops = parse_cigar(cigar)
    lead, tail = _clips(cigar)
    nm = sum(l for op, l in ops if op == "M")
    ni = sum(l for op, l in ops if op == "I")
    nd = sum(l for op, l in ops if op == "D")
    qlen = lead + nm + ni + tail
    tstart = pos1 - 1
    tend = tstart + nm + nd
    # strand-oriented aligned region -> original coords
    if reverse:
        qstart, qend = tail, tail + nm + ni
    else:
        qstart, qend = lead, lead + nm + ni
    alns.append(Alignment(
        qname=qname, qlen=qlen, qstart=qstart, qend=qend,
        strand="-" if reverse else "+", tname=rname,
        tlen=sq_len.get(rname, tend), tstart=tstart, tend=tend,
        matches=nm, blocklen=nm + ni + nd, mapq=mapq, score=nm,
        cigar=ops, primary=not secondary))
    if (not secondary and seq != "*" and qname not in reads
            and len(seq) == qlen):
        codes = encode(seq)
        if reverse:
            codes = revcomp_codes(codes)
        reads.add(Sequence(qname, codes), dedup=True)


def read_sam(path: str, tlens: Optional[Dict[str, int]] = None
             ) -> Tuple[AlignmentStore, SeqDict]:
    """Parse a SAM file (plain or .gz) into (AlignmentStore, reads)."""
    opener = gzip.open if path.endswith(".gz") else open
    alns: List[Alignment] = []
    reads = SeqDict()
    sq_len: Dict[str, int] = dict(tlens or {})
    with opener(path, "rt") as fh:
        for line in fh:
            if line.startswith("@"):
                if line.startswith("@SQ"):
                    fields = dict(f.split(":", 1) for f in
                                  line.rstrip("\n").split("\t")[1:]
                                  if ":" in f)
                    if "SN" in fields and "LN" in fields:
                        sq_len[fields["SN"]] = int(fields["LN"])
                continue
            e = line.rstrip("\n").split("\t")
            if len(e) < 11:
                continue
            _ingest(e[0], int(e[1]), e[2], int(e[3]), int(e[4]), e[5],
                    e[9], sq_len, alns, reads)
    return AlignmentStore(alns), reads


# BAM binary decode tables (SAM spec §4.2): 4-bit seq nibbles and cigar ops
_BAM_CIGAR_OPS = "MIDNSHP=X"
_NIB = "=ACMGRSVTWYHKDBN"
_SEQ_BYTE = ["%s%s" % (_NIB[b >> 4], _NIB[b & 0xF]) for b in range(256)]


def read_bam(path: str) -> Tuple[AlignmentStore, SeqDict]:
    """Parse a binary BAM file into (AlignmentStore, reads SeqDict).

    BGZF blocks are RFC1952-conformant gzip members, so the container is
    decompressed with the stdlib gzip reader; the BAM payload (magic,
    reference dictionary, alignment records) is decoded here per the SAM
    spec.  Replaces the reference's `samtools fasta` + BAM re-sort input
    path (TELR_input.py:299-305, telr.py:58-61)."""
    with gzip.open(path, "rb") as fh:
        data = fh.read()
    if data[:4] != b"BAM\x01":
        raise ValueError(f"{path}: not a BAM file (bad magic)")
    off = 4
    (l_text,) = struct.unpack_from("<i", data, off)
    off += 4 + l_text
    (n_ref,) = struct.unpack_from("<i", data, off)
    off += 4
    ref_names: List[str] = []
    sq_len: Dict[str, int] = {}
    for _ in range(n_ref):
        (l_name,) = struct.unpack_from("<i", data, off)
        off += 4
        name = data[off:off + l_name - 1].decode()
        off += l_name
        (l_ref,) = struct.unpack_from("<i", data, off)
        off += 4
        ref_names.append(name)
        sq_len[name] = l_ref
    alns: List[Alignment] = []
    reads = SeqDict()
    n = len(data)
    while off + 4 <= n:
        (block_size,) = struct.unpack_from("<i", data, off)
        off += 4
        end = off + block_size
        (ref_id, pos, l_read_name, mapq, _bin, n_cigar, flag,
         l_seq, _next_ref, _next_pos, _tlen) = struct.unpack_from(
            "<iiBBHHHiiii", data, off)
        p = off + 32
        qname = data[p:p + l_read_name - 1].decode()
        p += l_read_name
        cig = struct.unpack_from("<%dI" % n_cigar, data, p)
        p += 4 * n_cigar
        nbytes = (l_seq + 1) // 2
        if l_seq:
            raw = data[p:p + nbytes]
            seq = "".join([_SEQ_BYTE[b] for b in raw])[:l_seq]
        else:
            seq = "*"
        # qual + tags skipped
        off = end
        if ref_id < 0:
            continue
        cigar = "".join("%d%s" % (c >> 4, _BAM_CIGAR_OPS[c & 0xF])
                        for c in cig) or "*"
        _ingest(qname, flag, ref_names[ref_id], pos + 1, mapq, cigar,
                seq, sq_len, alns, reads)
    return AlignmentStore(alns), reads


def read_alignment_file(path: str) -> Tuple[AlignmentStore, SeqDict]:
    """Dispatch on extension: .bam -> read_bam, .sam/.sam.gz -> read_sam."""
    if path.endswith(".bam"):
        return read_bam(path)
    return read_sam(path)


_SEQ_NIBBLE = {"A": 1, "C": 2, "G": 4, "T": 8, "N": 15}
_BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")


def _bgzf_block(payload: bytes) -> bytes:
    """One BGZF block: a gzip member with the BC extra subfield carrying the
    total block size (SAM spec §4.1)."""
    import zlib
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    comp = co.compress(payload) + co.flush()
    bsize = len(comp) + 25  # 18B header + comp + 8B trailer, minus 1
    header = struct.pack("<BBBBIBBHBBHH", 31, 139, 8, 4, 0, 0, 0xFF, 6,
                         66, 67, 2, bsize)
    return header + comp + struct.pack(
        "<II", zlib.crc32(payload) & 0xFFFFFFFF, len(payload) & 0xFFFFFFFF)


def write_bam(store: AlignmentStore, reads: SeqDict, path: str,
              tlens: Optional[Dict[str, int]] = None) -> None:
    """Export an AlignmentStore as a standards-conformant BGZF BAM file
    (readable by samtools/pysam); coordinate-sorted like the reference's
    `samtools sort` output (TELR_alignment.py:103-110)."""
    from telr_jax.io.seqs import decode
    targets: Dict[str, int] = dict(tlens or {})
    for a in store.all():
        targets.setdefault(a.tname, a.tlen)
    names = list(targets.keys())
    rid = {nm: i for i, nm in enumerate(names)}
    text = "@HD\tVN:1.6\tSO:coordinate\n" + "".join(
        f"@SQ\tSN:{nm}\tLN:{targets[nm]}\n" for nm in names)
    body = io.BytesIO()
    body.write(b"BAM\x01")
    tb = text.encode()
    body.write(struct.pack("<i", len(tb)))
    body.write(tb)
    body.write(struct.pack("<i", len(names)))
    for nm in names:
        nb = nm.encode() + b"\x00"
        body.write(struct.pack("<i", len(nb)))
        body.write(nb)
        body.write(struct.pack("<i", targets[nm]))
    op_idx = {op: i for i, op in enumerate(_BAM_CIGAR_OPS)}
    # exactly ONE record per read may be neither secondary nor
    # supplementary (SAM spec): split reads carry several primary
    # segments internally, so every primary beyond the best-scoring one
    # is exported with the 0x800 supplementary flag
    rep: Dict[str, int] = {}
    for a in store.all():
        if a.primary and (a.qname not in rep or a.score > rep[a.qname]):
            rep[a.qname] = a.score
    rep_used: set = set()
    for tname in store.targets():
        for a in store.fetch(tname, 0, targets.get(tname, 1 << 60)):
            if not a.primary:
                flag = 0x100
            elif a.qname not in rep_used and a.score == rep[a.qname]:
                rep_used.add(a.qname)
                flag = 0
            else:
                flag = 0x800
            flag |= 0x10 if a.strand == "-" else 0
            if a.strand == "-":
                lead, tail = a.qlen - a.qend, a.qstart
            else:
                lead, tail = a.qstart, a.qlen - a.qend
            cig: List[Tuple[str, int]] = []
            if lead:
                cig.append(("S", lead))
            cig.extend(a.cigar)
            if tail:
                cig.append(("S", tail))
            if a.qname in reads:
                codes = reads[a.qname].codes
                if a.strand == "-":
                    codes = revcomp_codes(codes)
                seq = decode(codes)
            else:
                seq = ""
            qn = a.qname.encode() + b"\x00"
            rec = io.BytesIO()
            rec.write(struct.pack(
                "<iiBBHHHiiii", rid[a.tname], a.tstart, len(qn), a.mapq,
                0, len(cig), flag, len(seq), -1, -1, 0))
            rec.write(qn)
            for op, ln in cig:
                rec.write(struct.pack("<I", (ln << 4) | op_idx[op]))
            packed = bytearray((len(seq) + 1) // 2)
            for i, ch in enumerate(seq):
                nib = _SEQ_NIBBLE.get(ch, 15)
                packed[i // 2] |= nib << (4 if i % 2 == 0 else 0)
            rec.write(bytes(packed))
            rec.write(b"\xff" * len(seq))  # qual absent
            rb = rec.getvalue()
            body.write(struct.pack("<i", len(rb)))
            body.write(rb)
    raw = body.getvalue()
    with open(path, "wb") as out:
        for i in range(0, len(raw), 60000):
            out.write(_bgzf_block(raw[i:i + 60000]))
        out.write(_BGZF_EOF)


def write_sam(store: AlignmentStore, reads: SeqDict, path: str,
              tlens: Optional[Dict[str, int]] = None) -> None:
    """Export an AlignmentStore as SAM (header + records)."""
    targets: Dict[str, int] = dict(tlens or {})
    for a in store.all():
        targets.setdefault(a.tname, a.tlen)
    with open(path, "w") as out:
        out.write("@HD\tVN:1.6\tSO:coordinate\n")
        for name, ln in targets.items():
            out.write(f"@SQ\tSN:{name}\tLN:{ln}\n")
        for tname in store.targets():
            for a in store.fetch(tname, 0, targets.get(tname, 1 << 60)):
                flag = 0
                if a.strand == "-":
                    flag |= 0x10
                if not a.primary:
                    flag |= 0x100
                if a.strand == "-":
                    lead = a.qlen - a.qend
                    tail = a.qstart
                else:
                    lead = a.qstart
                    tail = a.qlen - a.qend
                cig = ""
                if lead:
                    cig += f"{lead}S"
                cig += "".join(f"{l}{op}" for op, l in a.cigar)
                if tail:
                    cig += f"{tail}S"
                if a.qname in reads:
                    codes = reads[a.qname].codes
                    if a.strand == "-":
                        codes = revcomp_codes(codes)
                    from telr_jax.io.seqs import decode
                    seq = decode(codes)
                else:
                    seq = "*"
                out.write("\t".join([
                    a.qname, str(flag), a.tname, str(a.tstart + 1),
                    str(a.mapq), cig, "*", "0", "0", seq, "*"]) + "\n")
