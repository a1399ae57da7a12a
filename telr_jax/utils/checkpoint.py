"""Per-stage checkpoint / resume.

The reference's only "checkpointing" is keeping intermediate files with -k
and skipping alignment when a BAM is supplied (telr.py:179-180,
TELR_input.py:300-305).  Here every stage boundary can be checkpointed and a
re-run resumes after the last completed stage — so a pod-scale run that dies
after the (expensive) alignment stage restarts from SV detection.

Format: <dir>/<stage>.json (+ .fa sidecars for sequence sets), plus a
MANIFEST recording completion order.  Everything is plain JSON/fasta so
checkpoints are inspectable and survive version skew better than pickles.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from telr_jax.core.alignstore import AlignmentStore
from telr_jax.io.fasta import read_fasta, write_fasta
from telr_jax.io.seqs import SeqDict, Sequence
from telr_jax.kernels.mapper import Alignment
from telr_jax.ops.intervals import Intervals
from telr_jax.sv.detect import SVRecord


def _cigar_str(cigar) -> str:
    return "".join(f"{ln}{op}" for op, ln in cigar)


def _cigar_parse(s: str):
    out, num = [], ""
    for ch in s:
        if ch.isdigit():
            num += ch
        else:
            out.append((ch, int(num)))
            num = ""
    return out


def _atomic_json(path: str, obj) -> None:
    """Write JSON via tmp-file + rename so a crash mid-write never leaves a
    truncated payload (the whole point of checkpointing is surviving
    mid-run death)."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


class Checkpointer:
    def __init__(self, directory: Optional[str], lock: bool = True):
        self.dir = directory
        self._fp: Optional[str] = None
        self._lockf = None
        if directory:
            os.makedirs(directory, exist_ok=True)
            if lock:
                # exclusive advisory lock for the life of this run: two
                # pipelines sharing a checkpoint dir overwrite each
                # other's stage files and cross-stamp the manifest
                # (observed: a stale concurrent run published its stages
                # under the fresh run's fingerprint, and the resume then
                # grafted contigs from a different genome into the calls)
                import fcntl
                self._lockf = open(os.path.join(directory, "MANIFEST.lock"),
                                   "w")
                try:
                    fcntl.flock(self._lockf, fcntl.LOCK_EX | fcntl.LOCK_NB)
                except OSError:
                    self._lockf.close()
                    self._lockf = None
                    raise RuntimeError(
                        f"checkpoint dir {directory} is locked by another "
                        "running pipeline; concurrent runs must use "
                        "separate checkpoint dirs") from None

    def close(self) -> None:
        if self._lockf is not None:
            try:
                import fcntl
                fcntl.flock(self._lockf, fcntl.LOCK_UN)
            except OSError:
                pass
            self._lockf.close()
            self._lockf = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    # -- manifest -----------------------------------------------------
    def _manifest_path(self) -> str:
        return os.path.join(self.dir, "MANIFEST.json")

    def _read_manifest(self) -> dict:
        if not self.dir or not os.path.isfile(self._manifest_path()):
            return {"fingerprint": None, "stages": []}
        try:
            with open(self._manifest_path()) as f:
                data = json.load(f)
        except (json.JSONDecodeError, OSError):
            # a manifest predating atomic writes may be truncated; treat as
            # "nothing completed" rather than crashing the resume
            return {"fingerprint": None, "stages": []}
        if isinstance(data, list):  # legacy format: bare stage list
            return {"fingerprint": None, "stages": data}
        return data

    def completed(self) -> List[str]:
        return self._read_manifest()["stages"]

    def validate_fingerprint(self, fp: str) -> bool:
        """Invalidate every checkpoint when the inputs/config changed.

        Stage checkpoints are keyed by name only; resuming them against
        different reads/reference/library or different semantic config
        would silently produce wrong calls.  Stores `fp` on first use;
        on mismatch the manifest is reset (stage files become orphans)
        and False is returned so the caller can log it."""
        if not self.dir:
            return True
        self._fp = fp
        m = self._read_manifest()
        if m["fingerprint"] == fp:
            return True
        fresh = m["fingerprint"] is None and not m["stages"]
        _atomic_json(self._manifest_path(),
                     {"fingerprint": fp, "stages": []})
        return fresh

    def mark(self, stage: str) -> None:
        if not self.dir:
            return
        m = self._read_manifest()
        # a run only publishes under its OWN fingerprint: if another run
        # re-fingerprinted the manifest since we started, our stage files
        # describe different inputs and must not be advertised as resumable
        if self._fp is not None and m["fingerprint"] != self._fp:
            return
        if stage not in m["stages"]:
            m["stages"].append(stage)
        _atomic_json(self._manifest_path(), m)

    def has(self, stage: str) -> bool:
        if self.dir is None:
            return False
        m = self._read_manifest()
        if self._fp is not None and m["fingerprint"] != self._fp:
            return False
        return stage in m["stages"]

    def _p(self, name: str) -> str:
        return os.path.join(self.dir, name)

    # -- typed payloads ----------------------------------------------
    # alignment stores are columnar npz, not JSON: a genome-scale store
    # (10^5 alignments x ~2.5k cigar runs each) costs minutes through
    # json.dump and ~4x the bytes
    _ALN_I32 = ("qlen", "qstart", "qend", "tlen", "tstart", "tend",
                "matches", "blocklen", "mapq", "score")

    def save_alignments(self, stage: str, store: AlignmentStore) -> None:
        if not self.dir:
            return
        alns = list(store.all())
        n = len(alns)
        cols = {k: np.fromiter((getattr(a, k) for a in alns),
                               dtype=np.int32, count=n)
                for k in self._ALN_I32}
        cols["strand"] = np.fromiter(
            (1 if a.strand == "-" else 0 for a in alns), np.uint8, count=n)
        cols["primary"] = np.fromiter(
            (1 if a.primary else 0 for a in alns), np.uint8, count=n)
        qnames = [a.qname for a in alns]
        tnames = sorted({a.tname for a in alns})
        tid = {nm: i for i, nm in enumerate(tnames)}
        cols["tname_id"] = np.fromiter((tid[a.tname] for a in alns),
                                       np.int32, count=n)
        op_code = {"M": 0, "D": 1, "I": 2}
        c_off = np.zeros(n + 1, dtype=np.int64)
        for i, a in enumerate(alns):
            c_off[i + 1] = c_off[i] + len(a.cigar)
        ops = np.empty(int(c_off[-1]), dtype=np.uint8)
        lens = np.empty(int(c_off[-1]), dtype=np.int32)
        for i, a in enumerate(alns):
            lo = int(c_off[i])
            for k, (op, ln) in enumerate(a.cigar):
                ops[lo + k] = op_code[op]
                lens[lo + k] = ln
        path = self._p(stage + ".npz")
        tmp = path + ".tmp.npz"
        # uncompressed: save speed beats bytes for a per-run artifact
        np.savez(tmp.removesuffix(".npz"),
                 n=np.int64(n),
                 qname=np.array("\x00".join(qnames)),
                 tnames=np.array("\x00".join(tnames)),
                 cigar_off=c_off, cigar_ops=ops, cigar_lens=lens, **cols)
        os.replace(tmp, path)
        self.mark(stage)

    def load_alignments(self, stage: str) -> AlignmentStore:
        jpath = self._p(stage + ".json")
        if os.path.isfile(jpath):  # legacy JSON checkpoints
            with open(jpath) as f:
                rows = json.load(f)
            alns = []
            for d in rows:
                d["cigar"] = _cigar_parse(d["cigar"])
                alns.append(Alignment(**d))
            return AlignmentStore(alns)
        z = np.load(self._p(stage + ".npz"))
        n = int(z["n"])
        if n == 0:
            return AlignmentStore([])
        qnames = str(z["qname"]).split("\x00")
        tnames = str(z["tnames"]).split("\x00")
        cols = {k: z[k] for k in self._ALN_I32}
        strand = z["strand"]
        primary = z["primary"]
        tname_id = z["tname_id"]
        c_off = z["cigar_off"]
        ops_s = np.array(["M", "D", "I"])[z["cigar_ops"]]
        lens_l = z["cigar_lens"].tolist()
        ops_l = ops_s.tolist()
        alns = []
        for i in range(n):
            lo, hi = int(c_off[i]), int(c_off[i + 1])
            alns.append(Alignment(
                qname=qnames[i], qlen=int(cols["qlen"][i]),
                qstart=int(cols["qstart"][i]), qend=int(cols["qend"][i]),
                strand="-" if strand[i] else "+",
                tname=tnames[int(tname_id[i])], tlen=int(cols["tlen"][i]),
                tstart=int(cols["tstart"][i]), tend=int(cols["tend"][i]),
                matches=int(cols["matches"][i]),
                blocklen=int(cols["blocklen"][i]),
                mapq=int(cols["mapq"][i]), score=int(cols["score"][i]),
                cigar=list(zip(ops_l[lo:hi], lens_l[lo:hi])),
                primary=bool(primary[i])))
        return AlignmentStore(alns)

    def save_records(self, stage: str, records: List[SVRecord]) -> None:
        if not self.dir:
            return
        _atomic_json(self._p(stage + ".json"),
                     [dataclasses.asdict(r) for r in records])
        self.mark(stage)

    def load_records(self, stage: str) -> List[SVRecord]:
        with open(self._p(stage + ".json")) as f:
            return [SVRecord(**d) for d in json.load(f)]

    def save_seqs(self, stage: str, seqs: SeqDict,
                  extra: Optional[dict] = None) -> None:
        if not self.dir:
            return
        tmp_fa = self._p(stage + ".fa.tmp")
        write_fasta(seqs, tmp_fa)
        os.replace(tmp_fa, self._p(stage + ".fa"))
        _atomic_json(self._p(stage + ".json"), extra or {})
        self.mark(stage)

    def load_seqs(self, stage: str) -> Tuple[SeqDict, dict]:
        seqs = read_fasta(self._p(stage + ".fa"), dedup=False)
        with open(self._p(stage + ".json")) as f:
            extra = json.load(f)
        return seqs, extra

    def save_intervals(self, stage: str, iv: Intervals) -> None:
        if not self.dir:
            return
        payload = {
            "chrom": iv.chrom,
            "start": [int(x) for x in iv.start],
            "end": [int(x) for x in iv.end],
            "cols": iv.cols,
        }
        _atomic_json(self._p(stage + ".json"), payload)
        self.mark(stage)

    def load_intervals(self, stage: str) -> Intervals:
        with open(self._p(stage + ".json")) as f:
            d = json.load(f)
        return Intervals(chrom=d["chrom"], start=np.array(d["start"]),
                         end=np.array(d["end"]), cols=d["cols"])

    def save_json(self, stage: str, obj) -> None:
        if not self.dir:
            return
        _atomic_json(self._p(stage + ".json"), obj)
        self.mark(stage)

    def load_json(self, stage: str):
        with open(self._p(stage + ".json")) as f:
            return json.load(f)
