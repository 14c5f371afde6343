"""Read-through split reads (`getsv -F`).

ref: process_bwasw.cpp:5-227 FindJunction — a bwasw/bwa-mem alignment of
*whole* reads where both halves of one read appear as two soft-clipped
records sharing a read id; their overlap yields a junction + microhomology
before clip evidence arrives.

Quirk replicated: when `-F` is used, the reference sets the global
g_min_mapQ to this pass's mapQ (ref: process_bwasw.cpp:32), which then also
filters the clip.bam read in InputSoftInfoStoreBreakpoint — the caller
(getsv) is responsible for that interaction if it wants it.

Counterpart of seeksv_tpu/pipeline/readthrough.py.
"""
from __future__ import annotations

from typing import Dict

from ..io.bam import FDUP, FUNMAP, OP_H, OP_M, OP_S, read_bam
from ..ops import cigar as cg
from ..ops.matchrate import revcomp
from .junctions import JunctionMap, OtherInfo, SeqInfo


class _Alignment:
    """ref: process_bwasw.h Alignment."""

    def __init__(self, chrom, pos, left_seq, left_qual, right_seq, right_qual,
                 cigar, clipped_side, strand):
        self.chr = chrom
        self.pos = pos
        self.left_seq = left_seq
        self.left_qual = left_qual
        self.right_seq = right_seq
        self.right_qual = right_qual
        self.cigar = cigar
        self.clipped_side = clipped_side
        self.strand = strand


def find_junction(path: str, min_mapq: int, jmap: JunctionMap) -> None:
    recs = read_bam(path)
    read_id2align: Dict[bytes, _Alignment] = {}
    first_op = recs.first_op()
    last_op = recs.last_op()
    first_len = recs.first_len()
    last_len = recs.last_len()
    map_len = recs.ref_span(count_x=False)

    for i in range(recs.n):
        if recs.mapq[i] < min_mapq:  # __g_skip_aln with g_min_mapQ=min_mapq
            continue
        if recs.flag[i] & FUNMAP:
            continue
        op1, op2 = int(first_op[i]), int(last_op[i])
        if (op1 == OP_H or op2 == OP_H
                or (op1 == OP_S and op2 == OP_S)
                or (op1 == OP_M and op2 == OP_M)
                or recs.flag[i] & FDUP):
            continue
        cigar_vec, _ = cg.from_bam_ops(recs.cigar(i))
        l_qseq = int(recs.l_qseq[i])
        if op1 == OP_S:
            clipped_side = "5"
            left_len = int(first_len[i])
            right_len = l_qseq - left_len
            pos = int(recs.pos[i]) + 1
        else:
            clipped_side = "3"
            right_len = int(last_len[i])
            left_len = l_qseq - right_len
            pos = int(recs.pos[i]) + int(map_len[i])
        strand = "-" if recs.flag[i] & 0x10 else "+"
        chrom = recs.ref_names[recs.tid[i]]
        seq = recs.seq_bytes(i)
        qual = recs.qual_str(i)
        if qual == b"*":
            lq = rq = b"*"
        else:
            lq, rq = qual[:left_len], qual[left_len:left_len + right_len]
        aln = _Alignment(chrom, pos, seq[:left_len], lq,
                         seq[left_len:left_len + right_len], rq,
                         cigar_vec, clipped_side, strand)
        read_id = bytes(recs.qnames[i])
        prev = read_id2align.get(read_id)
        if prev is None:
            read_id2align[read_id] = aln
            continue

        mh = -1
        same_strand_diff_side = (prev.strand == strand
                                 and prev.clipped_side != clipped_side)
        diff_strand_same_side = (prev.strand != strand
                                 and prev.clipped_side == clipped_side)
        if not (same_strand_diff_side or diff_strand_same_side):
            continue
        up_seq_info = SeqInfo()
        down_seq_info = SeqInfo()
        if same_strand_diff_side:
            if prev.clipped_side == "5":
                up_a, down_a = aln, prev
            else:
                up_a, down_a = prev, aln
            if len(up_a.left_seq) >= len(down_a.left_seq):
                mh = len(up_a.left_seq) - len(down_a.left_seq)
                junction = (up_a.chr, up_a.pos - mh, "+", down_a.chr, down_a.pos, "+")
                cv = list(up_a.cigar)
                cg.minus_right(cv, mh)
                up_seq_info = SeqInfo(down_a.left_seq, cv, 0, 0, 0, 2)
                down_seq_info = SeqInfo(down_a.right_seq, list(down_a.cigar), 0, 0, 1, 2)
            else:
                mh = 0
                junction = (up_a.chr, up_a.pos, "+", down_a.chr, down_a.pos, "+")
                up_seq_info = SeqInfo(down_a.left_seq, list(up_a.cigar), 0,
                                      len(down_a.left_seq) - len(up_a.left_seq), 0, 2)
                down_seq_info = SeqInfo(down_a.right_seq, list(down_a.cigar), 0, 0, 1, 2)
        else:
            if (prev.chr, prev.pos) < (chrom, pos):
                up_a, down_a = prev, aln
            else:
                up_a, down_a = aln, prev
            if clipped_side == "5":
                if len(up_a.right_seq) >= len(down_a.left_seq):
                    mh = len(up_a.right_seq) - len(down_a.left_seq)
                    junction = (up_a.chr, up_a.pos, "-", down_a.chr,
                                down_a.pos + mh, "+")
                    ul = revcomp(up_a.left_seq)
                    ur = revcomp(up_a.right_seq)
                    cv = list(down_a.cigar)
                    cg.add_left(cv, mh)
                    up_seq_info = SeqInfo(ur, list(up_a.cigar), 0, 0, 0, 2)
                    down_seq_info = SeqInfo(ul, cv, 0, 0, 1, 2)
                else:
                    mh = 0
                    junction = (up_a.chr, up_a.pos, "-", down_a.chr, down_a.pos, "+")
                    up_seq_info = SeqInfo(down_a.left_seq, list(up_a.cigar), 0,
                                          len(down_a.left_seq) - len(up_a.right_seq), 0, 2)
                    down_seq_info = SeqInfo(down_a.right_seq, list(down_a.cigar), 0, 0, 1, 2)
            else:
                if len(up_a.left_seq) >= len(down_a.right_seq):
                    mh = len(up_a.left_seq) - len(down_a.right_seq)
                    junction = (up_a.chr, up_a.pos - mh, "+", down_a.chr,
                                down_a.pos, "-")
                    dl = revcomp(down_a.left_seq)
                    dr = revcomp(down_a.right_seq)
                    cv = list(up_a.cigar)
                    cg.minus_right(cv, mh)
                    up_seq_info = SeqInfo(dr, cv, 0, 0, 0, 2)
                    down_seq_info = SeqInfo(dl, list(down_a.cigar), 0, 0, 1, 2)
                else:
                    mh = 0
                    junction = (up_a.chr, up_a.pos, "+", down_a.chr, down_a.pos, "-")
                    up_seq_info = SeqInfo(up_a.left_seq, list(up_a.cigar), 0, 0, 0, 2)
                    down_seq_info = SeqInfo(up_a.right_seq, list(down_a.cigar),
                                            len(down_a.right_seq) - len(up_a.left_seq),
                                            0, 1, 2)

        rng = jmap.equal_range(junction)
        if len(rng) == 0:
            jmap.insert(junction, OtherInfo(up_seq_info, down_seq_info, mh, 0))
        else:
            # ref: :200-217 — `find` returns the first equal entry only
            _, info = jmap.items[rng[0]]
            if (len(info.up.seq) != len(up_seq_info.seq)
                    or len(info.down.seq) != len(down_seq_info.seq)):
                info.down.support += 1
        del read_id2align[read_id]
