"""Final report generation: <sample>.telr.{json, expanded.json, vcf, bed,
te.fasta, contig.fasta}.

Exact-format port of the reference's TELR_output.py:10-438, including:
  * the simple + expanded JSON record layouts and key order
    (TELR_output.py:79-129),
  * te_length in the expanded report being overwritten with
    len(te_sequence) (TELR_output.py:196-201),
  * minus-strand contig TEs emitted reverse-complemented
    (TELR_output.py:156-161),
  * the VCF sample column writing GT:DV:DR values under a GT:DR:DV FORMAT
    (TELR_output.py:321-322) — preserved for byte parity,
  * VCFv4.1 header with ##contig lines from the reference index
    (TELR_output.py:313-427).
"""

from __future__ import annotations

import json
import os
from datetime import date
from typing import Dict, List, Optional

from telr_jax.io.seqs import SeqDict, decode, revcomp_codes
from telr_jax.ops.intervals import Intervals
from telr_jax.sv.detect import SVRecord

_EXPANDED_TEMPLATE_KEYS = [
    "type", "ID", "chrom", "start", "end", "family", "strand", "support",
    "tsd_length", "tsd_sequence", "te_sequence", "genotype", "num_sv_reads",
    "num_ref_reads", "allele_frequency", "gap_between_flank", "te_length",
    "contig_id", "contig_length", "contig_te_start", "contig_te_end",
    "5p_flank_align_coord", "5p_flank_mapping_quality",
    "5p_flank_num_residue_matches", "5p_flank_alignment_block_length",
    "5p_flank_sequence_identity",
    "3p_flank_align_coord", "3p_flank_mapping_quality",
    "3p_flank_num_residue_matches", "3p_flank_alignment_block_length",
    "3p_flank_sequence_identity",
]

_SIMPLE_TEMPLATE_KEYS = [
    "type", "ID", "chrom", "start", "end", "family", "strand", "support",
    "tsd_length", "tsd_sequence", "te_sequence", "genotype", "num_sv_reads",
    "num_ref_reads", "allele_frequency",
]


def build_reports(
    liftover_report: List[dict],
    te_freq_dict: Dict[str, dict],
    te_seqs: SeqDict,
    records: List[SVRecord],
    contig_te: Intervals,
    contigs: SeqDict,
):
    """Build (final_report, final_report_expanded, contig_ids)."""
    contig_te_strand: Dict[str, str] = {}
    for i in range(len(contig_te)):
        st = contig_te.cols["strand"][i]
        contig_te_strand[contig_te.chrom[i]] = st if st in ("+", "-") else "."

    sniffles_info = {r.locus_name: {
        "gt": r.genotype, "alt_count": str(r.alt_count),
        "ref_count": str(r.ref_count)} for r in records}

    final_report: List[dict] = []
    final_expanded: List[dict] = []
    contig_ids = set()

    for item in liftover_report:
        info = item.get("report")
        if not info or info.get("type") != "non-reference":
            continue
        ins_name = item["genome1_coord"]
        rep = {k: None for k in _SIMPLE_TEMPLATE_KEYS}
        exp = {k: None for k in _EXPANDED_TEMPLATE_KEYS}

        rep["type"] = info["type"]
        rep["chrom"] = info["chrom"]
        rep["start"] = info["start"]
        rep["end"] = info["end"]
        rep["family"] = info["family"]
        rep["ID"] = "_".join([str(info["chrom"]), str(info["start"]),
                              str(info["end"]), str(info["family"])])
        rep["strand"] = info["strand"]
        rep["tsd_length"] = info["TSD_length"]
        if info.get("TSD_sequence"):
            rep["tsd_sequence"] = info["TSD_sequence"].upper()

        contig_id = ins_name.split(":")[0]
        contig_ids.add(contig_id)
        te_strand = contig_te_strand.get(contig_id, ".")
        te_codes = te_seqs[ins_name].codes
        if te_strand in ("+", "."):
            rep["te_sequence"] = decode(te_codes)
        else:
            rep["te_sequence"] = decode(revcomp_codes(te_codes))

        sn = sniffles_info.get(contig_id, {})
        rep["genotype"] = sn.get("gt")
        rep["num_sv_reads"] = sn.get("alt_count")
        rep["num_ref_reads"] = sn.get("ref_count")
        freq = te_freq_dict.get(contig_id, {})
        rep["allele_frequency"] = freq.get("freq")

        for key in ("te_5p_cov", "te_3p_cov", "flank_5p_cov", "flank_3p_cov",
                    "te_5p_cov_rc", "te_3p_cov_rc", "flank_5p_cov_rc",
                    "flank_3p_cov_rc"):
            exp[key] = freq.get(key)
        exp["contig_length"] = (len(contigs[contig_id])
                                if contig_id in contigs else None)
        exp["gap_between_flank"] = info["gap"]
        exp["te_length"] = item["te_length"]
        exp["contig_id"] = contig_id
        exp["te_length"] = len(rep["te_sequence"])
        coord = ins_name.split(":")[1]
        exp["contig_te_start"] = int(coord.split("-")[0])
        exp["contig_te_end"] = int(coord.split("-")[1])
        for key in ("5p_flank_align_coord", "5p_flank_mapping_quality",
                    "5p_flank_num_residue_matches",
                    "5p_flank_alignment_block_length",
                    "5p_flank_sequence_identity",
                    "3p_flank_align_coord", "3p_flank_mapping_quality",
                    "3p_flank_num_residue_matches",
                    "3p_flank_alignment_block_length",
                    "3p_flank_sequence_identity"):
            exp[key] = info.get(key)

        if (exp["5p_flank_align_coord"] is not None
                and exp["3p_flank_align_coord"] is not None):
            rep["support"] = "both_sides"
        else:
            rep["support"] = "single_side"

        final_report.append(rep)
        exp.update(rep)
        final_expanded.append(exp)
    return final_report, final_expanded, contig_ids


def generate_output(
    liftover_report: List[dict],
    te_freq_dict: Dict[str, dict],
    te_seqs: SeqDict,
    records: List[SVRecord],
    contig_te: Intervals,
    contigs: SeqDict,
    reference: SeqDict,
    out_dir: str,
    sample_name: str,
    ref_path: str = "",
) -> List[dict]:
    final_report, final_expanded, contig_ids = build_reports(
        liftover_report, te_freq_dict, te_seqs, records, contig_te, contigs)

    with open(os.path.join(out_dir, sample_name + ".telr.json"), "w") as f:
        json.dump(final_report, f, indent=4, sort_keys=False)
    with open(os.path.join(out_dir, sample_name + ".telr.expanded.json"),
              "w") as f:
        json.dump(final_expanded, f, indent=4, sort_keys=False)

    with open(os.path.join(out_dir, sample_name + ".telr.te.fasta"),
              "w") as f:
        for item in final_report:
            name = (f"{item['chrom']}_{item['start']}_{item['end']}"
                    f"#{item['family']}")
            f.write(">" + name + "\n" + item["te_sequence"] + "\n")

    with open(os.path.join(out_dir, sample_name + ".telr.contig.fasta"),
              "w") as f:
        for s in contigs:
            if s.name in contig_ids:
                header = s.name + (" " + s.description if s.description else "")
                f.write(">" + header + "\n")
                text = s.seq
                for i in range(0, len(text), 60):
                    f.write(text[i:i + 60] + "\n")

    write_vcf(final_report, reference, ref_path,
              os.path.join(out_dir, sample_name + ".telr.vcf"))
    write_bed(final_report,
              os.path.join(out_dir, sample_name + ".telr.bed"))
    return final_report


def write_bed(final_report: List[dict], path: str) -> None:
    with open(path, "w") as out:
        for item in final_report:
            out.write("\t".join([
                str(item["chrom"]), str(item["start"]), str(item["end"]),
                str(item["family"]), ".", str(item["strand"])]) + "\n")


def write_vcf(final_report: List[dict], reference: SeqDict, ref_path: str,
              out_path: str) -> None:
    with open(out_path, "w") as vcf:
        vcf.write("##fileformat=VCFv4.1\n")
        vcf.write("##fileDate={}\n".format(date.today()))
        vcf.write("##source=TELR\n")
        vcf.write("##reference=" + ref_path + "\n")
        for s in reference:
            vcf.write("##contig=<ID={},length={}>\n".format(s.name, len(s)))
        vcf.write('##INFO=<ID=END,Number=1,Type=Integer,Description="End position of the structure variant">\n')
        vcf.write('##INFO=<ID=SVTYPE,Number=1,Type=String,Description="Type of structure variant">\n')
        vcf.write('##INFO=<ID=STRANDS,Number=A,Type=String,Description="Strand orientation">\n')
        vcf.write('##INFO=<ID=AF,Number=A,Type=Float,Description="Allele Frequency">\n')
        vcf.write('##INFO=<ID=FAMILY,Number=1,Type=String,Description="TE family">\n')
        vcf.write('##INFO=<ID=RE,Number=1,Type=Integer,Description="read support">\n')
        vcf.write('##INFO=<ID=SUPPORT_TYPE,Number=1,Type=String,Description="single_side or both_sides">\n')
        vcf.write('##INFO=<ID=TSD_LEN,Number=1,Type=String,Description="Length of the TSD sequence if available">\n')
        vcf.write('##INFO=<ID=TSD_SEQ,Number=1,Type=String,Description="TSD sequence if available">\n')
        vcf.write('##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">\n')
        vcf.write('##FORMAT=<ID=DR,Number=1,Type=Integer,Description="# high-quality reference reads">\n')
        vcf.write('##FORMAT=<ID=DV,Number=1,Type=Integer,Description="# high-quality variant reads">\n')
        vcf.write("#" + "\t".join(["CHROM", "POS", "ID", "REF", "ALT", "QUAL",
                                   "FILTER", "INFO", "FORMAT", "SAMPLE"]) + "\n")
        for idx, item in enumerate(final_report):
            info = ("SVTYPE=INS" + ";END=" + str(item["end"])
                    + ";FAMILY=" + str(item["family"])
                    + ";STRANDS=" + str(item["strand"])
                    + ";SUPPORT_TYPE=" + str(item["support"])
                    + ";RE=" + str(item["num_sv_reads"])
                    + ";AF=" + str(item["allele_frequency"])
                    + ";TSD_LEN=" + str(item["tsd_length"])
                    + ";TSD_SEQ=" + str(item["tsd_sequence"]))
            # sample column: GT:DV:DR values under GT:DR:DV FORMAT, as the
            # reference writes it (TELR_output.py:321-322)
            gt = (str(item["genotype"]) + ":" + str(item["num_sv_reads"])
                  + ":" + str(item["num_ref_reads"]))

            def _na(v):
                return "NA" if v is None else str(v)

            row = [str(item["chrom"]), str(item["start"] + 1), str(idx), "N",
                   _na(item["te_sequence"]), ".", "PASS", info, "GT:DR:DV", gt]
            vcf.write("\t".join(row) + "\n")
