"""breakpoint file -> VCF 4.x paired BND records.

Reimplements breakpoint2vcf/breakpoint2vcf.py (python2 + PyVCF) in
python3 with a plain text writer.  Strand-combination -> breakend
orientation mapping follows the reference exactly (ref:
breakpoint2vcf.py:21-35):

  +/+ : ALT1 = t]right]      ALT2 = [left[t
  +/- : ALT1 = t[right[      ALT2 = t[left[   (ref2 revcomp'd)
  -/+ : ALT1 = ]right]t      ALT2 = ]left]t   (ref1 revcomp'd)

(-/- never occurs in seeksv output.)  A template VCF may supply extra
header lines (its ## lines are copied through).

Counterpart of seeksv_tpu/pipeline/vcf.py.
"""
from __future__ import annotations

from typing import Optional

_RC = {"A": "T", "T": "A", "C": "G", "G": "C",
       "a": "T", "t": "A", "c": "G", "g": "C"}

_HEADER_LINES = [
    '##INFO=<ID=SVTYPE,Number=1,Type=String,Description="Type of structural variant">',
    '##INFO=<ID=MATEID,Number=.,Type=String,Description="ID of mate breakends">',
    '##INFO=<ID=CLIP_READ_NO,Number=1,Type=Integer,Description="Number of clipped reads supporting the breakend">',
    '##INFO=<ID=STRAND,Number=1,Type=String,Description="Strand of the breakend">',
    '##INFO=<ID=ABNORMAL_READPAIR_NO,Number=1,Type=Integer,Description="Number of discordant read pairs supporting the junction">',
    '##INFO=<ID=DEPTH,Number=1,Type=Integer,Description="Depth at the breakend position">',
]


def breakpoint_to_vcf(breakpoint_file: str, template_vcf: Optional[str],
                      out_vcf: str) -> None:
    with open(breakpoint_file) as f:
        header = f.readline()
        if not header.startswith("@"):
            raise ValueError("breakpoint file header should start with '@'")
        cols = header[1:].strip().split("\t")
        rows = [dict(zip(cols, line.rstrip("\n").split("\t")))
                for line in f if line.strip()]

    out = open(out_vcf, "w")
    wrote_fileformat = False
    if template_vcf:
        with open(template_vcf) as t:
            for line in t:
                if line.startswith("##"):
                    out.write(line)
                    if line.startswith("##fileformat"):
                        wrote_fileformat = True
    if not wrote_fileformat:
        out.write("##fileformat=VCFv4.1\n")
    for h in _HEADER_LINES:
        out.write(h + "\n")
    out.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")

    for i, d in enumerate(rows, 1):
        lc, rc = d["left_chr"], d["right_chr"]
        lp, rp = int(d["left_pos"]), int(d["right_pos"])
        ls, rs = d["left_strand"], d["right_strand"]
        if ls == "+" and rs == "+":
            ref1 = d["left_seq"][-1]
            alt1 = f"{ref1}]{rc}:{rp}]"
            ref2 = d["right_seq"][0]
            alt2 = f"[{lc}:{lp}[{ref2}"
        elif ls == "+" and rs == "-":
            ref1 = d["left_seq"][-1]
            alt1 = f"{ref1}[{rc}:{rp}["
            ref2 = _RC.get(d["right_seq"][0], "N")
            alt2 = f"{ref2}[{lc}:{lp}["
        elif ls == "-" and rs == "+":
            ref1 = _RC.get(d["left_seq"][-1], "N")
            alt1 = f"]{rc}:{rp}]{ref1}"
            ref2 = d["right_seq"][0]
            alt2 = f"]{lc}:{lp}]{ref2}"
        else:
            continue  # -/- never emitted by the caller
        up_id, dn_id = f"bnd{i}_U", f"bnd{i}_D"
        info1 = (f"SVTYPE=BND;MATEID={dn_id};"
                 f"CLIP_READ_NO={d['left_clip_read_NO']};STRAND={ls};"
                 f"ABNORMAL_READPAIR_NO={d['abnormal_readpair_NO']};"
                 f"DEPTH={d['left_pos_depth']}")
        info2 = (f"SVTYPE=BND;MATEID={up_id};"
                 f"CLIP_READ_NO={d['right_clip_read_NO']};STRAND={rs};"
                 f"ABNORMAL_READPAIR_NO={d['abnormal_readpair_NO']};"
                 f"DEPTH={d['right_pos_depth']}")
        out.write(f"{lc}\t{lp}\t{up_id}\t{ref1}\t{alt1}\t.\tPASS\t{info1}\n")
        out.write(f"{rc}\t{rp}\t{dn_id}\t{ref2}\t{alt2}\t.\tPASS\t{info2}\n")
    out.close()
