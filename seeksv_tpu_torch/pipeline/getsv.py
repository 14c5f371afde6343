"""getsv — junction calling from clip evidence + realignments.

Semantics-equivalent redesign of the reference's core caller
(ref: getsv.h:423-541 InputSoftInfoStoreBreakpoint, getsv.cpp:1705-1845
GetJunction, :1325-1482 MergeJunction, :990-1120 FindDiscordantReadPairs,
:752-835 GetBreak/MergeOverlap, bam2depth.cpp:17-142 main_depth,
:838-987 OutputBreakpoint, seeksv.cpp:157-364 CallGetsv):

  * the clip.gz / realigned clip.bam(sam) co-iteration keeps the reference's
    exact grouping and ordering quirks (see _CoIterator),
  * discordant-pair counting replaces BAM index seeks with vectorized numpy
    window reductions over the in-memory record arrays,
  * depth replaces the mplp pileup with per-chromosome coverage arrays built
    from M/=/X segments (the pileup counts exactly reads presenting a query
    base at a position: is_del/is_refskip excluded, baseQ threshold is 0 —
    bam2depth.cpp:94-95),
  * the filter cascade and reject-reason stream are preserved verbatim.

Replicated quirks (required for parity; each verified against the example):
  - only the FIRST clip line of an equal-clipped-seq group is paired with
    the alignments (the inner iterator is never reset, getsv.h:489-498),
  - the first alignment record of group k+1 is keyed under group k's seq in
    the dedup map (insert happens before last_clipped_seq is updated,
    getsv.h:501-502),
  - the post-loop drain skips __g_skip_aln but NOT hard-clipped records
    (getsv.h:512-515 has no IsHardClip),
  - GetJunction mutates the shared AlignInfo cigar on '-'-strand reverse
    branches (ReverseCigar on clipped_align_info.cigar_vec persists across
    pairings, getsv.cpp:1774/:1791),
  - unmapped clip realignments ('n') return before reaching the
    aligned2clipped rescue branch (getsv.cpp:1726) — the rescue fastq is
    therefore always empty; verified the v1.2.0 oracle binary behaves the
    same.  A functional rescue for virus-integration iteration is provided
    separately (rescue=True).

Counterpart of seeksv_tpu/pipeline/getsv.py.
"""
from __future__ import annotations

import gzip
import math
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..io.bam import (BamRecords, DEF_MASK, FDUP, FMUNMAP, FMREVERSE,
                      FPAIRED, FPROPER_PAIR, FREVERSE, FSECONDARY, FUNMAP,
                      OP_EQ, OP_H, OP_M, OP_S, OP_X, read_bam)
from ..ops import cigar as cg
from ..ops.matchrate import (largest_base_frequency, match_rate_begin,
                             match_rate_end, revcomp)
from ..utils import trace
from .junctions import JunctionMap, OtherInfo, SeqInfo

K_CROSS_LENGTH = 5  # ref: getsv.cpp:15


@dataclass
class AlignInfo:
    """ref: getsv.h:24-45."""
    chr: str = ""
    pos: int = -1
    len: int = -1
    strand: str = "*"
    cigar: List[Tuple[int, str]] = field(default_factory=list)
    seq: bytes = b""
    lcl: int = 0
    rcl: int = 0
    type: str = "n"  # 'u' uniq / 'r' repeat / 'n' none(unmapped)


@dataclass
class AlignReadsInfo:
    """One clip.gz consensus line (ref: clip_reads.h:86-95 AlignReadsInfo
    wrapping ReadsInfo; seq_left = aligned part, seq_right = clipped part
    as constructed at getsv.h:460)."""
    chr: str
    pos: int
    cigar: List[Tuple[int, str]]
    aligned: bytes
    clipped: bytes
    clipped_qual: bytes
    support: int


@dataclass
class ClipReads:
    """Unmapped/repeat clip kept for the rescue path (ref: getsv.h:109-120)."""
    aligned: SeqInfo
    side: str
    clipped_seq: bytes
    clipped_qual: bytes
    type: str


def is_hard_clip(recs: BamRecords, i: int) -> bool:
    c = recs.cigar(i)
    if len(c) == 0:
        return False
    return (int(c[0]) & 0xF) == OP_H or (int(c[-1]) & 0xF) == OP_H


def get_align_info(recs: BamRecords, i: int) -> AlignInfo:
    """ref: getsv.cpp:25-71."""
    if recs.flag[i] & FUNMAP:
        return AlignInfo("Exogenous", -1, -1, "*", [], recs.seq_bytes(i),
                         0, 0, "n")
    typ = "r" if (recs.flag[i] & FSECONDARY or recs.mapq[i] == 0) else "u"
    c = recs.cigar(i)
    lcl = rcl = 0
    if len(c):
        op1 = int(c[0]) & 0xF
        op2 = int(c[-1]) & 0xF
        if op1 in (OP_S, OP_H):
            lcl = int(c[0]) >> 4
        if op2 in (OP_S, OP_H):
            rcl = int(c[-1]) >> 4
    seq = bytes(recs.qnames[i])
    cigar_vec, l = cg.from_bam_ops(c)
    if recs.flag[i] & FREVERSE:
        strand = "-"
        seq = revcomp(seq)
    else:
        strand = "+"
    return AlignInfo(recs.ref_names[recs.tid[i]], int(recs.pos[i]) + 1, l,
                     strand, cigar_vec, seq, lcl, rcl, typ)


def junction_event(ari: AlignReadsInfo, orientation: str, cai: AlignInfo,
                   rescue: bool = False):
    """The pure part of GetJunction (ref: getsv.cpp:1705-1805): computes
    the oriented junction key + up/down SeqInfo payloads from one
    (consensus, realignment) pairing, with no map access.  Returns
    ("junction", junction, up, down), ("rescue", pos_key, ClipReads), or
    None.  This is the unit the SPMD path shards over groups — the event
    stream is order-preserving and state-free, so per-shard generation +
    ordered replay is exactly the sequential pass
    (parallel/spmd_pipeline.py)."""
    chrom, pos = ari.chr, ari.pos
    cigar_vec = list(ari.cigar)
    aligned_seq = ari.aligned
    clipped_seq = ari.clipped
    support = ari.support

    if cai.type == "u":
        uniq = 2
    elif cai.type == "r":
        uniq = 1
    else:
        # 'n': the reference returns here (getsv.cpp:1726), making its
        # aligned2clipped rescue branch unreachable and the rescue fastq
        # always empty (verified against the v1.2.0 oracle too).  With
        # rescue=True the framework keeps the unmapped clip so the
        # virus-integration iteration (README.md:55-57) actually works.
        if rescue:
            aligned_info = SeqInfo(aligned_seq, cigar_vec, 0, 0, support, 0)
            return ("rescue", (chrom, pos),
                    ClipReads(aligned_info, orientation, clipped_seq,
                              ari.clipped_qual, "n"))
        return None

    up = SeqInfo()
    down = SeqInfo()
    if cai.strand == "+":
        if orientation == "5":
            junction = (cai.chr, cai.pos + cai.len - 1, "+", chrom, pos, "+")
            up = SeqInfo(clipped_seq, list(cai.cigar), cai.lcl, cai.rcl, 0, uniq)
            down = SeqInfo(aligned_seq, cigar_vec, 0, 0, support, 0)
        else:
            junction = (chrom, pos, "+", cai.chr, cai.pos, "+")
            up = SeqInfo(aligned_seq, cigar_vec, 0, 0, support, 0)
            down = SeqInfo(clipped_seq, list(cai.cigar), cai.lcl, cai.rcl, 0, uniq)
    elif cai.strand == "-":
        if orientation == "5":
            if (cai.chr, cai.pos) <= (chrom, pos):
                junction = (cai.chr, cai.pos, "-", chrom, pos, "+")
                up = SeqInfo(clipped_seq, list(cai.cigar), cai.lcl, cai.rcl, 0, uniq)
                down = SeqInfo(aligned_seq, cigar_vec, 0, 0, support, 0)
            else:
                junction = (chrom, pos, "-", cai.chr, cai.pos, "+")
                aligned_seq = revcomp(aligned_seq)
                clipped_seq = revcomp(clipped_seq)
                cigar_vec = cigar_vec[::-1]
                cai.cigar.reverse()  # mutates shared state (ref :1774)
                up = SeqInfo(aligned_seq, cigar_vec, 0, 0, support, 0)
                down = SeqInfo(clipped_seq, list(cai.cigar), cai.rcl, cai.lcl, 0, uniq)
        else:
            if (chrom, pos) <= (cai.chr, cai.pos + cai.len - 1):
                junction = (chrom, pos, "+", cai.chr, cai.pos + cai.len - 1, "-")
                up = SeqInfo(aligned_seq, cigar_vec, 0, 0, support, 0)
                down = SeqInfo(clipped_seq, list(cai.cigar), cai.lcl, cai.rcl, 0, uniq)
            else:
                junction = (cai.chr, cai.pos + cai.len - 1, "+", chrom, pos, "-")
                aligned_seq = revcomp(aligned_seq)
                clipped_seq = revcomp(clipped_seq)
                cai.cigar.reverse()  # ref :1791
                cigar_vec = cigar_vec[::-1]
                up = SeqInfo(clipped_seq, list(cai.cigar), cai.rcl, cai.lcl, 0, uniq)
                down = SeqInfo(aligned_seq, cigar_vec, 0, 0, support, 0)
    else:
        return None
    return ("junction", junction, up, down)


def insert_junction_event(jmap: JunctionMap, junction, up: SeqInfo,
                          down: SeqInfo) -> None:
    """Duplicate-key accumulation of GetJunction (ref: getsv.cpp:1805-1835):
    probe the equal range, merge when the clip-length fingerprints line up,
    else append."""
    rng = jmap.equal_range(junction)
    if len(rng) == 0:
        jmap.insert(junction, OtherInfo(up, down, -1, 0))
        return
    status = True
    for i in rng:
        stored_j, info = jmap.items[i]
        if info.up.rcl == down.lcl and info.down.lcl == up.rcl:
            info.up.uniq = max(info.up.uniq, up.uniq)
            info.down.uniq = max(info.down.uniq, down.uniq)
            info.up.support += up.support
            info.down.support += down.support
            if info.mh == -1:
                info.mh = stored_j[1] - junction[1]  # equal keys => 0
            status = False
    if status:
        jmap.insert(junction, OtherInfo(up, down, -1, 0))


def get_junction(ari: AlignReadsInfo, orientation: str, cai: AlignInfo,
                 jmap: JunctionMap, aligned2clipped: list,
                 rescue: bool = False) -> None:
    """ref: getsv.cpp:1705-1845 — event generation + map accumulation."""
    ev = junction_event(ari, orientation, cai, rescue)
    if ev is None:
        return
    if ev[0] == "rescue":
        aligned2clipped.append((ev[1], ev[2]))
    else:
        insert_junction_event(jmap, ev[1], ev[2], ev[3])


def iter_soft_groups(clipfile: str, samfile: str, skip_min_mapq: int = 0,
                     initial_last: Optional[bytes] = None,
                     seam_overrides=None):
    """Co-iterate clip.gz with the realigned clip records
    (ref: getsv.h:423-541), preserving grouping/order quirks; yields one
    (AlignReadsInfo, orientation, [AlignInfo...]) tuple per clip group —
    the alignments in sorted-key order, exactly the pairing order the
    sequential pass uses.

    skip_min_mapq reproduces the reference's global-variable interaction:
    g_min_mapQ is 0 here unless `-F` ran first, in which case FindJunction
    left it at the read-through mapQ (ref: process_bwasw.cpp:32 +
    sam_view.h:5) and __g_skip_aln then filters the clip.bam records too.

    Multi-process segment support (parallel/multiproc.py): a segment cut
    out of the sequential stream must reproduce the co-iteration's
    odd-keying quirk — the FIRST alignment record of each group is keyed
    under the PREVIOUS group's seq (getsv.h:472-509), and a segment's
    predecessor lives on another process.  initial_last seeds the
    carried seq for the segment's first group; seam_overrides maps a
    clip DATA-LINE index (a section start whose sequential predecessor
    is elsewhere) to the predecessor seq to key that group's first
    record under."""
    sam = read_bam(samfile)
    j = 0
    nsam = sam.n
    last: Optional[bytes] = initial_last
    li = -1                      # clip data-line index (parsed lines)
    seam_overrides = seam_overrides or {}
    clip_group: List[Tuple[AlignReadsInfo, str]] = []
    align_map: Dict[Tuple[bytes, Tuple[str, int]], AlignInfo] = {}

    def group():
        if not clip_group:
            return None
        ari, orient = clip_group[0]  # only the first entry pairs (quirk)
        return (ari, orient, [align_map[k] for k in sorted(align_map)])

    opener = gzip.open if clipfile.endswith(".gz") else open
    with opener(clipfile, "rt") as fin:
        for line in fin:
            f = line.split()
            if len(f) < 9:
                continue
            li += 1
            ari = AlignReadsInfo(f[0], int(f[1]), cg.parse(f[3]),
                                 f[4].encode(), f[6].encode(), f[7].encode(),
                                 int(f[8]))
            orient = f[2]
            cseq = ari.clipped
            if last is None or last == cseq:
                clip_group.append((ari, orient))
                last = cseq
                continue
            key_seq = seam_overrides.get(li, last)
            while j < nsam:
                i = j
                j += 1
                if sam.mapq[i] < skip_min_mapq:
                    continue
                if is_hard_clip(sam, i):
                    continue
                cai = get_align_info(sam, i)
                qn = bytes(sam.qnames[i])
                if qn == last:
                    align_map.setdefault((last, (cai.chr, cai.pos)), cai)
                else:
                    g = group()
                    if g is not None:
                        yield g
                    clip_group = [(ari, orient)]
                    align_map = {(key_seq, (cai.chr, cai.pos)): cai}  # old-seq key (quirk)
                    last = cseq
                    break
            # sam exhausted without a new group: line dropped (ref behavior)
    while j < nsam:
        i = j
        j += 1
        if sam.mapq[i] < skip_min_mapq:
            continue
        # note: no hard-clip skip in the drain loop (ref: getsv.h:512-515)
        cai = get_align_info(sam, i)
        if bytes(sam.qnames[i]) == last:
            align_map.setdefault((last, (cai.chr, cai.pos)), cai)
        else:
            break
    g = group()
    if g is not None:
        yield g


def input_soft_info(clipfile: str, samfile: str, jmap: JunctionMap,
                    aligned2clipped: list, skip_min_mapq: int = 0,
                    rescue: bool = False) -> None:
    """Sequential accumulation over iter_soft_groups (ref: getsv.h:423-541)."""
    for ari, orient, cais in iter_soft_groups(clipfile, samfile,
                                              skip_min_mapq):
        for cai in cais:
            get_junction(ari, orient, cai, jmap, aligned2clipped, rescue)


def merge_junction(jmap: JunctionMap, search_length: int) -> None:
    """ref: getsv.cpp:1325-1482 — microhomology-shift dedup within
    search_length, 0.85 both-side gate, priority-based survivor choice."""
    i = 0
    while i < len(jmap):
        ji, oi = jmap.items[i]
        if oi.up.rcl > 0 or oi.up.lcl > 0:
            i += 1
            continue
        k = i + 1
        mark = False
        while (k < len(jmap)
               and ji[0] == jmap.items[k][0][0] and ji[3] == jmap.items[k][0][3]
               and ji[2] == jmap.items[k][0][2] and ji[5] == jmap.items[k][0][5]
               and jmap.items[k][0][1] - ji[1] <= search_length):
            jk, ok = jmap.items[k]
            if abs(jk[4] - ji[4]) <= search_length and ok.down.lcl == 0:
                up1 = down1 = up2 = down2 = b""
                skip = False
                if len(oi.up.cigar) == 1 and len(ok.up.cigar) == 1:
                    mh = jk[1] - ji[1]
                    if ((ji[2] == "+" and len(ok.up.seq) < mh + 5)
                            or (ji[2] == "-" and len(oi.up.seq) < mh + 5)):
                        skip = True
                    elif ji[2] == "+":
                        up1 = oi.up.seq
                        down1 = oi.down.seq
                        up2 = ok.up.seq[: len(ok.up.seq) - mh]
                        down2 = ok.up.seq[len(ok.up.seq) - mh:] + ok.down.seq
                    else:
                        up1 = oi.up.seq[: len(oi.up.seq) - mh]
                        down1 = oi.up.seq[len(oi.up.seq) - mh:] + oi.down.seq
                        up2 = ok.up.seq
                        down2 = ok.down.seq
                elif len(oi.down.cigar) == 1 and len(ok.down.cigar) == 1:
                    mh = abs(jk[4] - ji[4])
                    if ((ji[2] == "+" and len(oi.down.seq) < mh + 5)
                            or (ji[2] == "-" and len(ok.down.seq) < mh + 5)):
                        skip = True
                    elif ji[2] == "+":
                        down1 = oi.down.seq[mh:]
                        down2 = ok.down.seq
                        up1 = oi.up.seq + oi.down.seq[:mh]
                        up2 = ok.up.seq
                    else:
                        down1 = oi.down.seq
                        down2 = ok.down.seq[mh:]
                        up1 = oi.up.seq
                        up2 = ok.up.seq + ok.down.seq[:mh]
                if skip:
                    k += 1
                    continue
                r1 = match_rate_end(up1, up2)
                r2 = match_rate_begin(down1, down2)
                if r1 >= 0.85 and r2 >= 0.85:
                    oi.up.uniq = max(oi.up.uniq, ok.up.uniq)
                    oi.down.uniq = max(oi.down.uniq, ok.down.uniq)
                    if oi.mh == -1 and ok.mh == -1:
                        oi.up.support += ok.up.support
                        oi.down.support += ok.down.support
                        if ((oi.up.support != 0 and ok.down.support != 0)
                                or (oi.down.support != 0 and ok.up.support != 0)):
                            oi.mh = jk[1] - ji[1]
                        jmap.delete(k)
                    elif oi.mh != -1 and ok.mh == -1:
                        oi.up.support += ok.up.support
                        oi.down.support += ok.down.support
                        jmap.delete(k)
                    elif oi.mh == -1 and ok.mh != -1:
                        ok.up.support += oi.up.support
                        ok.down.support += oi.down.support
                        mark = True
                    else:
                        if (oi.up.support > ok.up.support
                                or oi.down.support == ok.down.support):
                            oi.up.support += ok.up.support
                            jmap.delete(k)
                        elif (oi.up.support == ok.up.support
                                or oi.down.support > ok.down.support):
                            oi.down.support += ok.down.support
                            jmap.delete(k)
                        elif (ok.up.support > oi.up.support
                                and oi.down.support == ok.down.support):
                            ok.up.support += oi.up.support
                            mark = True
                        elif (ok.down.support > oi.down.support
                                and ok.up.support == oi.up.support):
                            ok.down.support += oi.down.support
                            mark = True
                        else:
                            k += 1
                    if mark:
                        break
                else:
                    k += 1
            else:
                k += 1
        if mark:
            jmap.delete(i)
        else:
            i += 1


def calculate_insert_size(recs: BamRecords, min_mapq: int,
                          read_pair_used: int) -> Tuple[int, int]:
    """ref: cluster.cpp:15-83 — first N proper pairs, integer mean,
    truncated-int deviation."""
    first_op = recs.first_op()
    last_op = recs.last_op()
    has_cigar = recs.cig_off[1:] > recs.cig_off[:-1]
    hard = has_cigar & ((first_op == OP_H) | (last_op == OP_H))
    ok = ((recs.mapq >= min_mapq)
          & ((recs.flag & FPAIRED) != 0) & ((recs.flag & FPROPER_PAIR) != 0)
          & ((recs.flag & FDUP) == 0) & (recs.isize > 0) & ~hard)
    vals = recs.isize[ok][:read_pair_used].astype(np.int64)
    if len(vals) == 0:
        return 0, 0
    mean = int(vals.sum() // len(vals))
    dev = int(math.sqrt(float(((vals - mean).astype(np.float64) ** 2).sum())
                        / len(vals)))
    return mean, dev


class DiscordantCounter:
    """Vectorized replacement for the per-junction bam_iter_query scans
    (ref: getsv.cpp:990-1120 / :1123-1247).  All records of the original
    BAM are held as SoA arrays; each junction's window is a searchsorted
    slice + boolean reductions — the same structure used for the sharded
    device path (windowed gathers instead of index seeks).  ``count``
    adds the records a junction's window covers to the pass's counter
    ``getsv.window_records`` (utils/trace.count; somatic's calls too)."""

    def __init__(self, recs, min_mapq: int, mean_insert: int,
                 deviation: int, times: int, skip_hard_clip: bool = True):
        self.recs = recs
        self.name2tid = {n: i for i, n in enumerate(recs.ref_names)}
        self.ref_lens = recs.ref_lens
        self.min_insert = max(0, mean_insert - deviation * times)
        self.max_insert = mean_insert + deviation * times
        if hasattr(recs, "hard"):  # stream.LightBam: precomputed columns
            hard = recs.hard
            end = recs.end
        else:
            first_op = recs.first_op()
            last_op = recs.last_op()
            has_cigar = recs.cig_off[1:] > recs.cig_off[:-1]
            hard = has_cigar & ((first_op == OP_H) | (last_op == OP_H))
            end = recs.pos + recs.ref_span(count_x=True)  # bam_calend
        from ..io import native
        if native.available():
            # fused single native pass (numpy chain below is the oracle)
            self.base_ok = native.discordant_base_ok(
                recs.flag, recs.mapq, recs.isize,
                np.asarray(hard, np.uint8), min_mapq, self.min_insert,
                self.max_insert, skip_hard_clip)
        else:
            flag = recs.flag
            isize = recs.isize
            fwd = (flag & FREVERSE) == 0
            mfwd = (flag & FMREVERSE) == 0
            conc = ((fwd & ~mfwd & (self.min_insert <= isize)
                     & (isize <= self.max_insert))
                    | (~fwd & mfwd & (isize < 0)
                       & (self.min_insert <= -isize)
                       & (-isize <= self.max_insert)))
            base = ((recs.mapq >= min_mapq)
                    & ((flag & (FDUP | FUNMAP | FMUNMAP)) == 0) & ~conc)
            if skip_hard_clip:
                base &= ~hard
            self.base_ok = np.asarray(base)
        self.end = end
        # int64 copy of pos made ONCE: searchsorted with python-int keys
        # silently promotes+copies an int32 array per call — at 30M
        # records that turned each window probe into a 200MB memcpy
        self.pos64 = np.asarray(recs.pos, np.int64)
        # per-tid sorted views: a coordinate-sorted BAM holds each
        # contig's records in one run, and its unplaced reads (tid -1)
        # after all of them, so the tid column as a whole is not sorted
        # (a binary search over it can run into that tail and cut a
        # contig's last windows short): the runs are found directly
        self.tid_ranges: Dict[int, Tuple[int, int]] = {}
        # per-tid max reference span: a record at pos p can only overlap
        # beg if p > beg - max_span, which bounds the window slice from
        # below (equivalence: dropped records all fail `end > beg`)
        self.tid_max_span: Dict[int, int] = {}
        tids = np.asarray(recs.tid)
        span = self.end - recs.pos
        bounds = np.concatenate([[0], np.flatnonzero(tids[1:] != tids[:-1])
                                 + 1, [len(tids)]])
        for lo, hi in zip(bounds[:-1].tolist(), bounds[1:].tolist()):
            t = int(tids[lo]) if hi > lo else -1
            if 0 <= t < len(recs.ref_names):
                self.tid_ranges[t] = (lo, hi)
                self.tid_max_span[t] = int(span[lo:hi].max())

    def count(self, junction) -> int:
        up_chr, up_pos, up_strand, down_chr, down_pos, down_strand = junction
        tid = self.name2tid.get(up_chr, -1)
        if tid == -1:
            return 0
        chr_len = self.ref_lens[tid]
        if up_strand == "+":
            end = up_pos
            beg = end - self.max_insert
        elif up_strand == "-":
            beg = up_pos - 1 - K_CROSS_LENGTH
            end = up_pos - 1 + self.max_insert
        else:
            return 0
        if beg <= 0:
            beg = 1
        if end > chr_len:
            end = chr_len
        rng = self.tid_ranges.get(tid)
        if rng is None or end <= beg:
            return 0
        lo, hi = rng
        pos = self.pos64[lo:hi]
        # overlap predicate of bam_iter_query: pos < end && read_end > beg
        hi2 = lo + int(np.searchsorted(pos, end, "left"))
        lo2 = lo + int(np.searchsorted(pos, beg - self.tid_max_span[tid],
                                       "right"))
        sl = slice(min(lo2, hi2), hi2)
        r = self.recs
        covers = self.end[sl] > beg
        trace.count("getsv.window_records", int(np.count_nonzero(covers)))
        m = self.base_ok[sl] & covers
        if not m.any():
            return 0
        mtid = self.name2tid.get(down_chr, -1)
        if mtid == -1:
            return 0
        m &= r.mtid[sl] == mtid
        if not m.any():
            return 0
        pos0 = r.pos[sl]
        mpos0 = r.mpos[sl]
        lq = r.l_qseq[sl]
        flag = r.flag[sl]
        fwd = (flag & FREVERSE) == 0
        mfwd = (flag & FMREVERSE) == 0
        cnt = 0
        if up_strand == "+" and down_strand == "+":
            c = (m & (pos0 + lq <= up_pos + K_CROSS_LENGTH)
                 & (mpos0 + 1 >= down_pos - K_CROSS_LENGTH) & fwd & ~mfwd)
            ins = up_pos - pos0 + mpos0 + lq - down_pos + 1
            if (tid == mtid and up_pos > down_pos
                    and np.any(c & (up_pos - down_pos + 1 + 2 * lq <= self.max_insert))):
                period = up_pos - down_pos + 1
                tandem = c & (up_pos - down_pos + 1 + 2 * lq <= self.max_insert)
                plain = c & ~tandem
                # modular insert-size loop (ref: getsv.cpp:1081-1091)
                k0 = np.maximum(0, -(-(self.min_insert - ins) // period))
                mark = tandem & (ins + k0 * period <= self.max_insert)
                cnt += int(np.count_nonzero(mark))
                cnt += int(np.count_nonzero(
                    plain & (self.min_insert <= ins) & (ins <= self.max_insert)))
            else:
                cnt += int(np.count_nonzero(
                    c & (self.min_insert <= ins) & (ins <= self.max_insert)))
        elif up_strand == "-" and down_strand == "+":
            c = (m & ~fwd & ~mfwd & (mpos0 + 1 >= down_pos - K_CROSS_LENGTH))
            ins = pos0 + 1 - up_pos + 1 + mpos0 + lq - down_pos + 1
            cnt += int(np.count_nonzero(
                c & (self.min_insert <= ins) & (ins <= self.max_insert)))
        elif up_strand == "+" and down_strand == "-":
            c = (m & fwd & mfwd & (pos0 + lq <= up_pos + K_CROSS_LENGTH)
                 & (mpos0 + lq <= down_pos + K_CROSS_LENGTH))
            ins = up_pos - pos0 + down_pos - (mpos0 + lq) + 1
            cnt += int(np.count_nonzero(
                c & (self.min_insert <= ins) & (ins <= self.max_insert)))
        return cnt


def depth_segments(recs: BamRecords, min_mapq: int):
    """Extract the (start, end, tid) reference segments that the mplp
    pileup counts (ref: bam2depth.cpp:75-129): reads failing mapQ are
    marked unmapped (bam2depth.h:33), the pileup engine masks
    BAM_DEF_MASK, and positions count reads presenting a query base
    (M/=/X segments).  Returns (seg_start, seg_end, seg_tid) filtered to
    depth-contributing ops — the shared front half of compute_coverage
    and the SPMD coverage step (parallel/spmd_pipeline.py)."""
    keep = (recs.mapq >= min_mapq) & ((recs.flag & DEF_MASK) == 0)
    ops = (recs.cig & 0xF).astype(np.int32)
    lens = (recs.cig >> 4).astype(np.int64)
    ref_consume = ((ops == OP_M) | (ops == 2) | (ops == 3) | (ops == OP_EQ)
                   | (ops == OP_X))
    n_ops = np.diff(recs.cig_off)
    rec_of_op = np.repeat(np.arange(recs.n), n_ops)
    vals = np.where(ref_consume, lens, 0)
    csum_incl = np.cumsum(vals)
    csum_excl = csum_incl - vals
    rec_base = np.concatenate([[0], csum_incl])[recs.cig_off[:-1]]
    ref_off = csum_excl - rec_base[rec_of_op]
    seg_start = recs.pos[rec_of_op].astype(np.int64) + ref_off
    seg_end = seg_start + lens
    depth_op = ((ops == OP_M) | (ops == OP_EQ) | (ops == OP_X)) & keep[rec_of_op]
    op_tid = recs.tid[rec_of_op]
    return seg_start[depth_op], seg_end[depth_op], op_tid[depth_op]


def compute_coverage(recs: BamRecords, min_mapq: int) -> Dict[int, np.ndarray]:
    """Per-chromosome depth arrays replacing the mplp pileup (see
    depth_segments)."""
    seg_start, seg_end, seg_tid = depth_segments(recs, min_mapq)
    out: Dict[int, np.ndarray] = {}
    from ..io.native import coverage_depth
    for t in range(len(recs.ref_names)):
        L = recs.ref_lens[t]
        sel = seg_tid == t
        out[t] = coverage_depth(seg_start[sel], seg_end[sel],
                                np.ones(int(sel.sum()), np.int32), L)
    return out


class DepthQuery:
    def __init__(self, recs: BamRecords, min_mapq: int,
                 cov: Optional[Dict[int, np.ndarray]] = None):
        self.name2tid = {n: i for i, n in enumerate(recs.ref_names)}
        self.ref_lens = recs.ref_lens
        # flank ranges are <= 2*flank_length bp, so range sums are direct
        # slice reductions — no genome-sized prefix table (800 MB + a
        # full pass at 100 Mbp for a few thousand 400 bp queries)
        self.cov = cov if cov is not None else compute_coverage(recs, min_mapq)

    def point(self, chrom: str, pos1: int) -> int:
        t = self.name2tid.get(chrom)
        if t is None or pos1 < 1 or pos1 > self.ref_lens[t]:
            return 0
        return int(self.cov[t][pos1 - 1])

    def range_avg(self, chrom: str, begin1: int, end1: int) -> int:
        """Average depth over [begin1, end1] (1-based inclusive), with the
        reference's unsigned-underflow semantics for begin1 <= 0 (sum = 0,
        denominator = end - begin + 1; ref ChrRange uses unsigned ints,
        getsv.h:231-258, division at getsv.cpp:946)."""
        denom = end1 - begin1 + 1
        if denom <= 0:
            return 0
        t = self.name2tid.get(chrom)
        if t is None:
            return 0
        if begin1 < 0:
            return 0  # unsigned wrap: positions never accumulate
        lo = max(begin1, 1) - 1
        hi = min(end1, self.ref_lens[t])
        if hi <= lo:
            return 0
        s = int(self.cov[t][lo:hi].sum(dtype=np.int64))
        return s // denom


def fmt_g(x: float) -> str:
    """C++ default ostream double formatting (6 significant digits)."""
    return "%g" % x


def get_sv_type(j) -> str:
    """ref: clip_reads.cpp:572-581."""
    up_chr, up_pos, up_strand, down_chr, down_pos, down_strand = j
    if up_chr != down_chr:
        return "CTX"
    if up_strand != down_strand:
        return "INV"
    if up_pos < down_pos:
        return "DEL"
    if up_pos > down_pos:
        return "INS"
    return "Unknown"


SV_HEADER = ("@left_chr\tleft_pos\tleft_strand\tleft_clip_read_NO\tright_chr\t"
             "right_pos\tright_strand\tright_clip_read_NO\tmicrohomology_length\t"
             "abnormal_readpair_NO\tsvtype\tleft_pos_depth\tright_pos_depth\t"
             "average_depth_of_left_pos_5end\taverage_depth_of_left_pos_3end\t"
             "average_depth_of_right_pos_5end\taverage_depth_of_right_pos_3end\t"
             "left_pos_clip_percentage\tright_pos_clip_percentage\t"
             "left_seq_cigar\tright_seq_cigar\tleft_seq\tright_seq")


def _format_row(j, o: OtherInfo, updepth, downdepth, uu, ud, du, dd, r1, r2) -> str:
    """ref OutputOneBreakpoint, getsv.cpp:1855-1862."""
    return (f"{j[0]}\t{j[1]}\t{j[2]}\t{o.up.support}\t"
            f"{j[3]}\t{j[4]}\t{j[5]}\t{o.down.support}\t"
            f"{o.mh}\t{o.abnormal}\t{get_sv_type(j)}\t"
            f"{updepth}\t{downdepth}\t{uu}\t{ud}\t{du}\t{dd}\t"
            f"{fmt_g(r1)}\t{fmt_g(r2)}\t"
            f"{cg.to_str(o.up.cigar, o.up.lcl, o.up.rcl)}\t"
            f"{cg.to_str(o.down.cigar, o.down.lcl, o.down.rcl)}\t"
            f"{o.up.seq.decode()}\t{o.down.seq.decode()}")


def _format_filtered(reason, j, o, updepth, downdepth, r1, r2) -> str:
    """ref OutputFilteredBreakpoint, getsv.cpp:1846-1853 (note: only the
    point depths + rates, no flank depths)."""
    return (f"{reason}\t{j[0]}\t{j[1]}\t{j[2]}\t{o.up.support}\t"
            f"{j[3]}\t{j[4]}\t{j[5]}\t{o.down.support}\t"
            f"{o.mh}\t{o.abnormal}\t{get_sv_type(j)}\t"
            f"{updepth}\t{downdepth}\t{fmt_g(r1)}\t{fmt_g(r2)}\t"
            f"{cg.to_str(o.up.cigar, o.up.lcl, o.up.rcl)}\t"
            f"{cg.to_str(o.down.cigar, o.down.lcl, o.down.rcl)}\t"
            f"{o.up.seq.decode()}\t{o.down.seq.decode()}")


def output_breakpoints(jmap: JunctionMap, depth: Optional[DepthQuery],
                       flank_length: int, sum_min_both: int,
                       min_abnormal: int, frequency: float, min_distance: int,
                       max_microhomology: int, min_seq_len: int,
                       max_seq_indel_no: int, out, filtered_out,
                       rescue_mode: bool = True,
                       min_one_side_clip: int = 5,
                       max_repeat_depth: int = 500) -> None:
    """Filter cascade (ref OutputBreakpoint, getsv.cpp:838-987) + the
    flank-range depth computation of GetBreak (getsv.cpp:752-789)."""
    for j, o in jmap.items:
        if depth is not None:
            updepth = depth.point(j[0], j[1]) + o.down.support
            downdepth = depth.point(j[3], j[4]) + o.up.support
        else:
            # -D: pos2depth is empty, the lookup fails, and the support is
            # NOT added (ref: getsv.cpp:852-856 error branch)
            updepth = downdepth = 0
        jr = o.up.support + o.down.support
        r1 = jr / updepth if updepth else 0.0
        r2 = jr / downdepth if downdepth else 0.0

        if not (o.up.uniq + o.down.uniq >= 2 or o.abnormal > 0):
            filtered_out.write(_format_filtered(
                "mappingQ_too_low", j, o, updepth, downdepth, r1, r2) + "\n")
            continue
        # v1.2.0 oracle rescue-mode gate (its usage text; option removed in
        # v1.2.2/3): a junction with clip support on only ONE side is kept
        # only when rescue mode is on AND that side has >= -a [5] reads
        # (verified by probing the binary with -a/-r on single-sided and
        # both-sided junctions; both-sided rows are never affected).
        # v1.2.3 semantics = min_one_side_clip 0 with rescue_mode on.
        if o.up.support == 0 or o.down.support == 0:
            one_side = max(o.up.support, o.down.support)
            if not rescue_mode or one_side < min_one_side_clip:
                filtered_out.write(_format_filtered(
                    "one_side_clip_read_NO_not_pass", j, o, updepth,
                    downdepth, r1, r2) + "\n")
                continue
        # v1.2.0 oracle -R gate (removed in v1.2.2): breakends whose
        # output depth reaches the repetitive-coverage threshold [500] are
        # dropped (either side; verified by probing the binary with -R
        # values bracketing the example depths)
        if updepth >= max_repeat_depth or downdepth >= max_repeat_depth:
            filtered_out.write(_format_filtered(
                "depth_repetitive", j, o, updepth, downdepth, r1, r2) + "\n")
            continue
        if j[0] == j[3] and abs(j[1] - j[4]) < min_distance:
            filtered_out.write(_format_filtered(
                "distance_too_near", j, o, updepth, downdepth, r1, r2) + "\n")
            continue
        if o.mh > max_microhomology:
            filtered_out.write(_format_filtered(
                "microhomology_len_too_long", j, o, updepth, downdepth, r1, r2) + "\n")
            continue
        if o.abnormal < min_abnormal:
            filtered_out.write(_format_filtered(
                "abnormal_read_pair_no_not_pass", j, o, updepth, downdepth, r1, r2) + "\n")
            continue
        if ((o.up.support > 0 and o.down.support > 0 and r1 < frequency and r2 < frequency)
                or (o.up.support == 0 and r2 < frequency)
                or (o.down.support == 0 and r1 < frequency)):
            filtered_out.write(_format_filtered(
                "frequency_too_low", j, o, updepth, downdepth, r1, r2) + "\n")
            continue
        if o.up.support + o.down.support < sum_min_both:
            filtered_out.write(_format_filtered(
                "total_clipped_reads_NO_not_pass", j, o, updepth, downdepth, r1, r2) + "\n")
            continue
        if o.abnormal == 0:
            if (len(o.up.seq) < o.up.lcl + o.up.rcl + min_seq_len
                    or len(o.down.seq) < o.down.lcl + o.down.rcl + min_seq_len):
                filtered_out.write(_format_filtered(
                    "seq_length_too_short", j, o, updepth, downdepth, r1, r2) + "\n")
                continue
            if (len(o.up.cigar) > 2 * max_seq_indel_no + 1
                    or len(o.down.cigar) > 2 * max_seq_indel_no + 1):
                filtered_out.write(_format_filtered(
                    "seq_with_too_many_indels", j, o, updepth, downdepth, r1, r2) + "\n")
                continue
            if (largest_base_frequency(o.up.seq) >= 0.8
                    or largest_base_frequency(o.down.seq) >= 0.8):
                filtered_out.write(_format_filtered(
                    "repeat_bases", j, o, updepth, downdepth, r1, r2) + "\n")
                continue

        uu = ud = du = dd = 0
        if depth is not None:
            # flank window length (ref GetBreak :762-769)
            if j[0] == j[3] and j[2] == j[5]:
                l = min(abs(j[4] - 1 - j[1]), flank_length)
            else:
                l = flank_length
            uu = depth.range_avg(j[0], j[1] - l + 1, j[1])
            ud = depth.range_avg(j[0], j[1] + 1, j[1] + l)
            du = depth.range_avg(j[3], j[4] - l, j[4] - 1)
            dd = depth.range_avg(j[3], j[4], j[4] + l - 1)
        out.write(_format_row(j, o, updepth, downdepth, uu, ud, du, dd, r1, r2) + "\n")


def read_breakpoint(path: str, jmap: JunctionMap) -> None:
    """Resume from a prior sv.txt (ref ReadBreakpoint, getsv.cpp:1292-1323)."""
    with open(path) as f:
        for line in f:
            if line.startswith("@"):
                continue
            fl = line.split()
            if len(fl) < 23:
                continue
            j = (fl[0], int(fl[1]), fl[2], fl[4], int(fl[5]), fl[6])
            up = SeqInfo(fl[21].encode(), cg.parse(fl[19]), 0, 0, int(fl[3]), 0)
            down = SeqInfo(fl[22].encode(), cg.parse(fl[20]), 0, 0, int(fl[7]), 0)
            jmap.insert(j, OtherInfo(up, down, int(fl[8]), int(fl[9])))


def getsv(clip_sam: str, original_bam: str, clipfile: str, sv_out: str,
          rescue_fq_out: str, *, threshold: float = 0.9, flank: int = 50,
          min_mapq: int = 20, read_pair_used: int = 5_000_000,
          sum_min_both_clip: int = 3, min_distance: int = 50,
          min_abnormal: int = 0, frequency: float = 0.1,
          max_microhomology: int = 50, min_seq_len: int = 30,
          max_seq_indel_no: int = 1, flank_length: int = 200,
          output_depth: bool = True, times: int = 4,
          temp_breakpoint: Optional[str] = None,
          connect_bam: Optional[str] = None, connect_min_mapq: int = 1,
          filtered_out=None, recs: Optional[BamRecords] = None,
          rescue: bool = False, rescue_mode: bool = True,
          min_one_side_clip: int = 5, max_repeat_depth: int = 500,
          stats=None, log=lambda *a: None) -> None:
    """Full getsv pass (ref CallGetsv, seeksv.cpp:157-364).

    stats: a pipeline.stream.StreamStats accumulated over the original
    BAM — the bounded-memory path: insert-size/coverage/discordant inputs
    come from the single streaming pass instead of re-decoding the BAM."""
    if filtered_out is None:
        filtered_out = sys.stdout
    jmap = JunctionMap()
    aligned2clipped: list = []

    if temp_breakpoint:
        read_breakpoint(temp_breakpoint, jmap)
    skip_min_mapq = 0
    if connect_bam:
        from .readthrough import find_junction
        find_junction(connect_bam, connect_min_mapq, jmap)
        log("'FindJunction' finished")
        # NOTE: the v1.2.3 source leaks g_min_mapQ from FindJunction into
        # the clip.bam co-iteration (process_bwasw.cpp:32 + sam_view.h:5),
        # which silently desynchronizes clip groups whose records are all
        # mapq 0.  The v1.2.0 oracle binary does not; we follow the oracle
        # (skip_min_mapq stays 0).

    with trace.span("seeksv.getsv.soft_info"):
        input_soft_info(clipfile, clip_sam, jmap, aligned2clipped,
                        skip_min_mapq, rescue)
    log("'InputSoftInfoStoreBreakpoint' finished")
    with trace.span("seeksv.getsv.merge"):
        merge_junction(jmap, flank)

    if stats is not None:
        recs = stats.light()
        with trace.span("seeksv.getsv.coverage"):
            cov = stats.coverage() if output_depth else None
    else:
        cov = None
        if recs is None:
            recs = read_bam(original_bam)

    if read_pair_used >= 100_000:
        with trace.span("seeksv.getsv.insert_size"):
            if stats is not None:
                mean, dev = stats.insert_size()
            else:
                mean, dev = calculate_insert_size(recs, min_mapq,
                                                  read_pair_used)
        log(f"Mean insert size: {mean}; deviation: {dev}")
        with trace.span("seeksv.getsv.discordant"):
            counter = DiscordantCounter(recs, min_mapq, mean, dev, times)
            with trace.span("seeksv.getsv.windows"):
                for j, o in jmap.items:
                    o.abnormal = counter.count(j)
        log("'FindDiscordantReadPairs' finished")
    else:
        min_abnormal = 0  # ref: seeksv.cpp:284-286

    depth = None
    if output_depth:
        with trace.span("seeksv.getsv.depth"):
            depth = DepthQuery(recs, min_mapq, cov=cov)
        log("'main_depth' finished")
    else:
        frequency = 0.0  # ref: seeksv.cpp:298-301

    with trace.span("seeksv.getsv.output"):
        with open(sv_out, "w") as fout:
            fout.write(SV_HEADER + "\n")
            output_breakpoints(
                jmap, depth, flank_length, sum_min_both_clip, min_abnormal,
                frequency, min_distance, max_microhomology, min_seq_len,
                max_seq_indel_no, fout, filtered_out, rescue_mode,
                min_one_side_clip, max_repeat_depth)

        # rescue fastq (empty under reference semantics; ref
        # getsv.cpp:1252-1288)
        with open(rescue_fq_out, "w") as fq:
            for pos_key, cr in aligned2clipped:
                if cr.type == "n":
                    fq.write(f"@{cr.clipped_seq.decode()}\n"
                             f"{cr.clipped_seq.decode()}"
                             f"\n+\n{cr.clipped_qual.decode()}\n")
