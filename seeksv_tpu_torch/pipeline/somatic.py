"""somatic — tumor/normal subtraction.

ref: somatic.{h,cpp} — loads the normal sample's clip.gz into 3'/5' maps,
then for each tumor sv.txt row searches normal clip consensus that
reproduces the junction (3 strand cases × microhomology handling) and
counts normal discordant pairs; appends 3 control columns.  The final
somatic set is rows where all three are 0 (awk filter in
example/seeksv.somatic.sh:6), exposed here as `somatic_filter`.

Default min_map_rate is 0.85 to match the v1.2.0 oracle binary (the
changelog records the default moving 0.85 -> 0.95 -> 0.9 across 1.2.2/1.2.3).

Counterpart of seeksv_tpu/pipeline/somatic.py.
"""
from __future__ import annotations

import bisect
import gzip
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..io.bam import BamRecords, read_bam
from ..ops.matchrate import (match_rate_begin, match_rate_end, revcomp,
                             seed_containment)
from ..utils import trace
from .getsv import DiscordantCounter, calculate_insert_size, fmt_g


@dataclass
class NormalClip:
    """ref ReadsInfo as stored by ReadsClipReads (somatic.h:40-70):
    3' clips: seq_left = aligned, seq_right = clipped;
    5' clips: seq_left = clipped, seq_right = aligned."""
    seq_left: bytes
    seq_right: bytes
    support: int


class ClipMap:
    """Sorted multimap (chr,pos) -> [NormalClip...] preserving insertion
    order within keys, with equal_range and lower_bound iteration."""

    def __init__(self):
        self.by_key: Dict[Tuple[str, int], List[NormalClip]] = {}
        self._sorted_keys: Optional[List[Tuple[str, int]]] = None

    def insert(self, key, entry):
        self.by_key.setdefault(key, []).append(entry)
        self._sorted_keys = None

    @property
    def sorted_keys(self):
        if self._sorted_keys is None:
            self._sorted_keys = sorted(self.by_key)
        return self._sorted_keys

    def equal_range(self, key) -> List[NormalClip]:
        return self.by_key.get(key, [])

    def iter_from(self, key):
        """lower_bound(key) iteration over (key, entry) pairs."""
        ks = self.sorted_keys
        i = bisect.bisect_left(ks, key)
        while i < len(ks):
            for e in self.by_key[ks[i]]:
                yield ks[i], e
            i += 1


def read_clip_reads(path: str, min_len_of_clipped_seq: int
                    ) -> Tuple[ClipMap, ClipMap]:
    """ref ReadsClipReads (somatic.h:40-70)."""
    clip3 = ClipMap()
    clip5 = ClipMap()
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        for line in f:
            fl = line.split()
            if len(fl) < 9:
                continue
            chrom, pos, orient = fl[0], int(fl[1]), fl[2]
            aligned, clipped = fl[4].encode(), fl[6].encode()
            support = int(fl[8])
            if len(clipped) < min_len_of_clipped_seq:
                continue
            if orient == "3":
                clip3.insert((chrom, pos), NormalClip(aligned, clipped, support))
            elif orient == "5":
                clip5.insert((chrom, pos), NormalClip(clipped, aligned, support))
    return clip3, clip5


def somatic(normal_bam: str, normal_clip_gz: str, tumor_sv: str,
            out_path: Optional[str], *, min_map_rate: float = 0.85,
            min_mapq: int = 20,
            offset: int = 30, min_len_of_clipped_seq: int = 10,
            read_pair_used: int = 5_000_000, times: int = 4,
            recs: Optional[BamRecords] = None, stats=None,
            mean_dev: Optional[Tuple[int, int]] = None,
            collect_triples: Optional[list] = None,
            use_triples=None) -> None:
    """ref CallSomatic (seeksv.cpp:366-410) +
    ReadTumorFileAndOutputSomaticInfo (somatic.cpp:14-427).

    stats: a pipeline.stream.StreamStats over the normal BAM (the
    bounded-memory path; avoids re-decoding the normal BAM here).

    Distribution hooks (parallel/multiproc.multiprocess_somatic): the
    control flow per tumor row depends only on the row's own fields,
    and every normal-side lookup (clip-map probes bounded to one
    chromosome position window; discordant window inside the
    up-chromosome) finds nonzero support only on the process owning
    that normal range — so per-process triples computed on LOCAL maps
    and records sum to the sequential values.
      collect_triples: compute (nleft, nright, nab) per row into this
        list and write nothing (out_path may be None);
      use_triples: skip all lookups and write rows with these combined
        values (maps/records unused);
      mean_dev: externally computed global insert stats (the
        multi-process first-N estimator)."""
    if use_triples is not None:
        clip3 = clip5 = counter = None
        mean = dev = 0
    else:
        with trace.span("seeksv.somatic.read_clips"):
            clip3, clip5 = read_clip_reads(normal_clip_gz,
                                           min_len_of_clipped_seq)
        if mean_dev is not None:
            mean, dev = mean_dev
            if recs is None and stats is not None:
                recs = stats.light()
        elif stats is not None:
            recs = stats.light()
            mean = dev = 0
            if read_pair_used >= 100_000:
                mean, dev = stats.insert_size()
        else:
            if recs is None:
                recs = read_bam(normal_bam)
            mean = dev = 0
            if read_pair_used >= 100_000:
                mean, dev = calculate_insert_size(recs, min_mapq,
                                                  read_pair_used)
        with trace.span("seeksv.somatic.discordant"):
            counter = DiscordantCounter(recs, min_mapq, mean, dev, times)

    fout = open(out_path, "w") if out_path is not None else None
    try:
        with trace.span("seeksv.somatic.lookup"):
            _somatic_rows(tumor_sv, fout, clip3, clip5, counter, mean,
                          min_map_rate, offset, collect_triples, use_triples)
    finally:
        if fout is not None:
            fout.close()


def _somatic_rows(tumor_sv: str, fout, clip3, clip5, counter, mean: int,
                  min_map_rate: float, offset: int, collect_triples,
                  use_triples) -> None:
    """somatic()'s pass over the tumour rows: each row's normal-side
    lookups, written to fout (or collected)."""
    _row_ids: list = []
    with open(tumor_sv) as fin:
        for line in fin:
            if line.startswith("@"):
                if fout is not None:
                    fout.write(line.rstrip("\n")
                               + "\tleft_clip_read_NO_of_control"
                               "\tright_clip_read_NO_of_control"
                               "\tabnormal_read_pair_no_of_control\n")
                continue
            fl = line.split()
            if len(fl) < 23:
                continue
            (up_chr, up_pos, up_strand, up_reads, down_chr, down_pos,
             down_strand, down_reads, mh, abnormal, sv_type) = (
                fl[0], int(fl[1]), fl[2], int(fl[3]), fl[4], int(fl[5]),
                fl[6], int(fl[7]), int(fl[8]), int(fl[9]), fl[10])
            depths = [int(x) for x in fl[11:17]]
            up_rate, down_rate = float(fl[17]), float(fl[18])
            up_cigar, down_cigar = fl[19], fl[20]
            up_seq, down_seq = fl[21].encode(), fl[22].encode()
            junction = (up_chr, up_pos, up_strand, down_chr, down_pos, down_strand)

            nleft = nright = 0
            nab = 0
            emit = True

            if use_triples is not None:
                # combined values from the per-process passes; emit is a
                # pure function of the row's own fields (every
                # emit=False branch below is either '-/-' or
                # 'mh == -1 with both sides supported')
                emit = not ((up_strand == "-" and down_strand == "-")
                            or (mh == -1 and up_reads != 0
                                and down_reads != 0))
                nleft, nright, nab = (int(v) for v in
                                      use_triples[len(_row_ids)])
                _row_ids.append(None)
            elif up_strand == "+" and down_strand == "+":
                if mh != -1:
                    for e in clip5.equal_range((down_chr, down_pos)):
                        if (match_rate_begin(down_seq, e.seq_right) >= min_map_rate
                                and match_rate_end(up_seq, e.seq_left) >= min_map_rate):
                            nright = e.support
                            break
                    if len(down_seq) >= mh:
                        up_seq1 = up_seq + down_seq[:mh]
                        down_seq1 = down_seq[mh:]
                        for e in clip3.equal_range((up_chr, up_pos + mh)):
                            if (match_rate_begin(down_seq1, e.seq_right) >= min_map_rate
                                    and match_rate_end(up_seq1, e.seq_left) >= min_map_rate):
                                nleft = e.support
                                break
                    # note: called unconditionally here (ref: somatic.cpp:111)
                    nab = counter.count(junction)
                else:
                    if up_reads == 0:
                        for e in clip5.equal_range((down_chr, down_pos)):
                            if (match_rate_begin(down_seq, e.seq_right) >= min_map_rate
                                    and match_rate_end(up_seq, e.seq_left) >= min_map_rate):
                                nright = e.support
                                break
                        for (kc, kp), e in clip3.iter_from((up_chr, up_pos)):
                            if kc != up_chr or kp > up_pos + offset:
                                break
                            if seed_containment(e.seq_left, e.seq_right,
                                                up_seq, down_seq, min_map_rate) != -1:
                                nleft = e.support
                                break
                        if mean != 0:
                            nab = counter.count(junction)
                    elif down_reads == 0:
                        for e in clip3.equal_range((up_chr, up_pos)):
                            if (match_rate_begin(down_seq, e.seq_right) >= min_map_rate
                                    and match_rate_end(up_seq, e.seq_left) >= min_map_rate):
                                nleft = e.support
                                break
                        for (kc, kp), e in clip5.iter_from((down_chr, down_pos - offset)):
                            if kc != down_chr or kp > down_pos:
                                break
                            if seed_containment(up_seq, down_seq,
                                                e.seq_left, e.seq_right, min_map_rate) != -1:
                                nright = e.support
                                break
                        if mean != 0:
                            nab = counter.count(junction)
                    else:
                        emit = False  # ref: cerr only (somatic.cpp:176-179)
            elif up_strand == "+" and down_strand == "-":
                if mh != -1:
                    up_seq1 = up_seq + down_seq[:mh]
                    down_seq1 = down_seq[mh:]
                    for e in clip3.equal_range((up_chr, up_pos + mh)):
                        if (match_rate_begin(down_seq1, e.seq_right) >= min_map_rate
                                and match_rate_end(up_seq1, e.seq_left) >= min_map_rate):
                            nleft = e.support
                            break
                    up_rc, down_rc = revcomp(up_seq), revcomp(down_seq)
                    for e in clip3.equal_range((down_chr, down_pos)):
                        if (match_rate_begin(up_rc, e.seq_right) >= min_map_rate
                                and match_rate_end(down_rc, e.seq_left) >= min_map_rate):
                            nright = e.support
                            break
                    if mean != 0:
                        nab = counter.count(junction)
                else:
                    if up_reads == 0:
                        up_rc, down_rc = revcomp(up_seq), revcomp(down_seq)
                        for e in clip3.equal_range((down_chr, down_pos)):
                            if (match_rate_begin(up_rc, e.seq_right) >= min_map_rate
                                    and match_rate_end(down_rc, e.seq_left) >= min_map_rate):
                                nright = e.support
                                break
                        for (kc, kp), e in clip3.iter_from((up_chr, up_pos)):
                            if kc != up_chr or kp > up_pos + offset:
                                break
                            if seed_containment(e.seq_left, e.seq_right,
                                                up_seq, down_seq, min_map_rate) != -1:
                                nleft = e.support
                                break
                        if mean != 0:
                            nab = counter.count(junction)
                    elif down_reads == 0:
                        for e in clip3.equal_range((up_chr, up_pos)):
                            if (match_rate_begin(down_seq, e.seq_right) >= min_map_rate
                                    and match_rate_end(up_seq, e.seq_left) >= min_map_rate):
                                nleft = e.support
                                break
                        up_rc, down_rc = revcomp(up_seq), revcomp(down_seq)
                        for (kc, kp), e in clip3.iter_from((down_chr, down_pos)):
                            if kc != down_chr or kp > down_pos + offset:
                                break
                            if seed_containment(e.seq_left, e.seq_right,
                                                down_rc, up_rc, min_map_rate) != -1:
                                nright = e.support
                                break
                        if mean != 0:
                            nab = counter.count(junction)
                    else:
                        emit = False
            elif up_strand == "-" and down_strand == "+":
                if mh != -1:
                    up_rc, down_rc = revcomp(up_seq), revcomp(down_seq)
                    for e in clip5.equal_range((up_chr, up_pos)):
                        if (match_rate_begin(up_rc, e.seq_right) >= min_map_rate
                                and match_rate_end(down_rc, e.seq_left) >= min_map_rate):
                            nleft = e.support
                            break
                    # ref: somatic.cpp:324-326 — substr throws if mh > len(up_seq)
                    up_seq1 = up_seq[: len(up_seq) - mh]
                    down_seq1 = up_seq[len(up_seq) - mh:] + down_seq
                    for e in clip5.equal_range((down_chr, down_pos - mh)):
                        if (match_rate_begin(down_seq1, e.seq_right) >= min_map_rate
                                and match_rate_end(up_seq1, e.seq_left) >= min_map_rate):
                            nright = e.support
                            break
                    if mean != 0:
                        nab = counter.count(junction)
                else:
                    if up_reads == 0:
                        for e in clip5.equal_range((down_chr, down_pos)):
                            if (match_rate_begin(down_seq, e.seq_right) >= min_map_rate
                                    and match_rate_end(up_seq, e.seq_left) >= min_map_rate):
                                nright = e.support
                                break
                        up_rc, down_rc = revcomp(up_seq), revcomp(down_seq)
                        for (kc, kp), e in clip5.iter_from((up_chr, up_pos - offset)):
                            if kc != up_chr or kp > up_pos:
                                break
                            if seed_containment(up_rc, down_rc,
                                                e.seq_left, e.seq_right, min_map_rate) != -1:
                                nleft = e.support
                                break
                        if mean != 0:
                            nab = counter.count(junction)
                    elif down_reads == 0:
                        up_rc, down_rc = revcomp(up_seq), revcomp(down_seq)
                        for e in clip5.equal_range((up_chr, up_pos)):
                            if (match_rate_begin(up_rc, e.seq_right) >= min_map_rate
                                    and match_rate_end(down_rc, e.seq_left) >= min_map_rate):
                                nleft = e.support
                                break
                        for (kc, kp), e in clip5.iter_from((down_chr, down_pos - offset)):
                            if kc != down_chr or kp > down_pos:
                                break
                            if seed_containment(up_seq, down_seq,
                                                e.seq_left, e.seq_right, min_map_rate) != -1:
                                nright = e.support
                                break
                        if mean != 0:
                            nab = counter.count(junction)
                    else:
                        emit = False
            else:
                emit = False  # '-/-' never emitted by getsv (ref: cerr only)

            if collect_triples is not None:
                collect_triples.append((nleft, nright, nab))
                continue
            if emit:
                fout.write(
                    f"{up_chr}\t{up_pos}\t{up_strand}\t{up_reads}\t{down_chr}\t"
                    f"{down_pos}\t{down_strand}\t{down_reads}\t{mh}\t{abnormal}\t"
                    f"{sv_type}\t" + "\t".join(str(d) for d in depths)
                    + f"\t{fmt_g(up_rate)}\t{fmt_g(down_rate)}\t{up_cigar}\t"
                    f"{down_cigar}\t{up_seq.decode()}\t{down_seq.decode()}\t"
                    f"{nleft}\t{nright}\t{nab}\n")


def somatic_filter(temp_sv_path: str, out_path: str) -> None:
    """The awk post-filter (ref example/seeksv.somatic.sh:6): keep rows
    where all three control columns are 0."""
    with trace.span("seeksv.somatic.filter"), open(temp_sv_path) as fin, \
            open(out_path, "w") as fout:
        for line in fin:
            if line.startswith("@"):
                fout.write(line)
                continue
            fl = line.split()
            if len(fl) >= 26 and fl[23] == "0" and fl[24] == "0" and fl[25] == "0":
                fout.write(line)
