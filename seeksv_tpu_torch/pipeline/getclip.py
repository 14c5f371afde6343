"""getclip — soft-clip evidence extraction.

Semantics-equivalent redesign of the reference's streaming pass
(ref: clip_reads.h:363-484 InputBamOutputReads, clip_reads.cpp:112-192
GetSClipReads, :260-283 InsertSeq, :57-108 ChangeSeqAndQual):

  * the BAM is decoded whole into SoA arrays (io.bam), clip candidates are
    classified with vectorized numpy over the record arrays,
  * only the (rare) clipped / unmapped records are touched per-record,
  * the per-breakpoint greedy consensus merge keeps the reference's exact
    insertion-order + first-match semantics so outputs are byte-identical.

Replicated quirks (required for parity):
  - the record that triggers a chromosome flush (first mapped record of a
    new tid) is itself dropped (ref: clip_reads.h:423-438 else-branch does
    not process `b`),
  - `__g_skip_aln` is a no-op here because g_min_mapQ is still 0 during
    getclip (ref: sam/sam_view.h:5, never set by CallGetclip),
  - the parity oracle is the shipped v1.2.0 binary, whose consensus merge
    is longest-wins replacement at threshold 0.85 / min mapQ 20 — NOT the
    v1.2.3 source's quality-vote at 0.9 / mapQ 1 (established by probing
    example/bin/seeksv with crafted SAM inputs; see Consensus.replace_merge
    and the getclip() docstring).  The v1.2.3 vote semantics remain
    available via BreakpointMap(vote=True).

Counterpart of seeksv_tpu/pipeline/getclip.py.
"""
from __future__ import annotations

import gzip
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from ..io.bam import (BamRecords, FDUP, FMUNMAP, FREAD1, FUNMAP, OP_H, OP_S,
                      read_bam)
from ..ops import cigar as cg
from ..ops.matchrate import match_rate_begin, match_rate_end
from ..utils import trace

LEFT_CLIPPED = True
RIGHT_CLIPPED = False


@dataclass
class Consensus:
    """One merged soft-clip consensus at a breakpoint (ref ReadsInfo,
    clip_reads.h:44-84)."""
    seq_left: np.ndarray   # uint8
    qual_left: np.ndarray
    seq_right: np.ndarray
    qual_right: np.ndarray
    cigar: List[Tuple[int, str]]
    support: int = 1
    used: int = 0

    def replace_merge(self, s_l, q_l, s_r, q_r, cigar, left_clipped: bool):
        """Consensus update as performed by the shipped seeksv v1.2.0 binary
        (the parity oracle for the committed example outputs): each side is
        replaced wholesale by a strictly longer incoming sequence+quality,
        with no per-base voting; the CIGAR follows the *aligned* side.

        Determined empirically by probing example/bin/seeksv with crafted
        SAM inputs (ties keep the existing side; votes never alter bases).
        The v1.2.3 source's quality-vote variant is kept below as
        vote_merge() and selectable via BreakpointMap(vote=True).
        """
        if len(s_l) > len(self.seq_left):
            self.seq_left, self.qual_left = s_l, q_l
            if not left_clipped:  # RIGHT_CLIPPED: aligned part grew
                self.cigar = list(cigar)
        if len(s_r) > len(self.seq_right):
            self.seq_right, self.qual_right = s_r, q_r
            if left_clipped:  # LEFT_CLIPPED: aligned part grew
                self.cigar = list(cigar)

    def vote_merge(self, s_l, q_l, s_r, q_r, cigar, left_clipped: bool):
        """ChangeSeqAndQual of the v1.2.3 source (ref: clip_reads.cpp:57-108):
        per-base quality-weighted vote + extension."""
        len1, len2 = len(self.seq_left), len(s_l)
        n = min(len1, len2)
        if n:
            a_q = self.qual_left[len1 - n:]
            b_q = q_l[len2 - n:]
            m = a_q < b_q
            a_q[m] = b_q[m]
            self.seq_left[len1 - n:][m] = s_l[len2 - n:][m]
        if len1 <= len2:
            self.seq_left = np.concatenate([s_l[: len2 - n], self.seq_left])
            self.qual_left = np.concatenate([q_l[: len2 - n], self.qual_left])
            if not left_clipped:  # RIGHT_CLIPPED: aligned part grew
                self.cigar = list(cigar)
        len1, len2 = len(self.seq_right), len(s_r)
        n = min(len1, len2)
        if n:
            a_q = self.qual_right[:n]
            b_q = q_r[:n]
            m = a_q < b_q
            a_q[m] = b_q[m]
            self.seq_right[:n][m] = s_r[:n][m]
        if len1 < len2:
            self.seq_right = np.concatenate([self.seq_right, s_r[n:]])
            self.qual_right = np.concatenate([self.qual_right, q_r[n:]])
            if left_clipped:  # LEFT_CLIPPED: aligned part grew
                self.cigar = list(cigar)


class BreakpointMap:
    """Ordered multimap (pos -> [Consensus...]) for one chromosome with the
    reference's greedy first-match insert (ref InsertSeq,
    clip_reads.cpp:260-283)."""

    def __init__(self, vote: bool = False):
        self.by_pos: Dict[int, List[Consensus]] = {}
        self.vote = vote

    def insert(self, pos, s_l, q_l, s_r, q_r, cigar, limit, left_clipped):
        entries = self.by_pos.get(pos)
        if entries is not None:
            for e in entries:
                r1 = match_rate_end(s_l, e.seq_left)
                r2 = match_rate_begin(s_r, e.seq_right)
                if r1 >= limit and r2 >= limit:
                    if self.vote:
                        e.vote_merge(s_l, q_l, s_r, q_r, cigar, left_clipped)
                    else:
                        e.replace_merge(s_l, q_l, s_r, q_r, cigar, left_clipped)
                    e.support += 1
                    return
        else:
            entries = self.by_pos.setdefault(pos, [])
        entries.append(Consensus(s_l, q_l, s_r, q_r, list(cigar)))

    def sorted_items(self):
        for pos in sorted(self.by_pos):
            for e in self.by_pos[pos]:
                yield pos, e


def _qual_arr(recs: BamRecords, i: int, a: int, b: int) -> np.ndarray:
    """Quality slice [a,b) as phred+33 bytes; '*' when missing
    (ref GetSeq, clip_reads.cpp:296-301)."""
    q = recs.qual_raw(i)
    if len(q) and q[0] == 0xFF:
        return np.frombuffer(b"*", np.uint8).copy()
    return (q[a:b] + np.uint8(33)).astype(np.uint8)


def _write_chrom(chrom: str, bmap: BreakpointMap, orient: str, soft_out, fq_out):
    """DisplaySClipReadsAndClipFq (ref: clip_reads.h:300-345).
    Streams are binary; lines are built as bytes."""
    for pos, e in bmap.sorted_items():
        if orient == "5":
            aligned, aligned_q = e.seq_right, e.qual_right
            clipped, clipped_q = e.seq_left, e.qual_left
        else:
            aligned, aligned_q = e.seq_left, e.qual_left
            clipped, clipped_q = e.seq_right, e.qual_right
        soft_out.write(
            (f"{chrom}\t{pos}\t{orient}\t{cg.to_str(e.cigar)}\t"
             f"{aligned.tobytes().decode()}\t{aligned_q.tobytes().decode()}\t"
             f"{clipped.tobytes().decode()}\t{clipped_q.tobytes().decode()}\t"
             f"{e.support}\n").encode())
        if e.used == 1:
            continue
        cs = clipped.tobytes().decode()
        fq_out.write(
            f"@{cs}\n{cs}\n+\n{clipped_q.tobytes().decode()}\n".encode())


class _OwnFilter:
    """Insert-filtering proxy over a BreakpointMap: drops events whose
    breakpoint position is outside the owned [lo, hi) interval (the
    python-fallback counterpart of _filter_rows_owned)."""

    def __init__(self, inner, lo: int, hi: int):
        self.inner = inner
        self.lo = lo
        self.hi = hi

    def insert(self, pos, *a, **k):
        if self.lo <= pos < self.hi:
            self.inner.insert(pos, *a, **k)


class GetclipStream:
    """Incremental getclip over BamRecords slabs (io.bam.read_bam_chunks):
    per-breakpoint maps, mate pairing, and the last-seen tid carry across
    slab boundaries, so process(slab) in file order is exactly the
    whole-file pass — this is the bounded-memory contract of the
    reference's streaming loop (ref: clip_reads.h:363-446), with the
    chromosome flush happening at real tid changes only (slab boundaries
    inside a chromosome do NOT flush)."""

    SPAN = "seeksv.scan.getclip"

    def __init__(self, prefix: str, threshold: float = 0.85,
                 min_mapq: int = 20, save_low_quality: bool = False,
                 own_range=None):
        """own_range: optional (tid, pos_lo, pos_hi_exclusive) triples —
        when set, only clip events whose BREAKPOINT position falls in an
        owned range are inserted (the sub-chromosome multi-process
        sharding: records near a cut are ingested by both neighbors via
        halos, and this filter assigns each breakpoint group to exactly
        one owner; unmapped-pair extraction is similarly restricted to
        owned record positions)."""
        self.threshold = threshold
        self.min_mapq = min_mapq
        self.save_low_quality = save_low_quality
        self.own_range = own_range
        self.soft_out = gzip.open(f"{prefix}.clip.gz", "wb", compresslevel=1)
        self.fq_out = gzip.open(f"{prefix}.clip.fq.gz", "wb", compresslevel=1)
        self.un1 = gzip.open(f"{prefix}.unmapped_1.fq.gz", "wb",
                             compresslevel=1)
        self.un2 = gzip.open(f"{prefix}.unmapped_2.fq.gz", "wb",
                             compresslevel=1)
        from ..io import native
        native_ok = native.available()
        self._nmap = native.NativeClipMap(threshold) if native_ok else None
        self._pairer = native.UnmappedPairer() if native_ok else None
        self.left_map = BreakpointMap()
        self.right_map = BreakpointMap()
        self.id2seq_qual: Dict[bytes, Tuple[Tuple[bytes, bytes], str]] = {}
        self.last_tid = 0
        self.ref_names: List[str] = []

    def _flush(self, tid: int) -> None:
        chrom = (self.ref_names[tid] if 0 <= tid < len(self.ref_names)
                 else str(tid))
        if self._nmap is not None:
            soft, fq = self._nmap.flush(chrom)
            if soft:
                self.soft_out.write(soft)
            if fq:
                self.fq_out.write(fq)
            return
        _write_chrom(chrom, self.left_map, "5", self.soft_out, self.fq_out)
        _write_chrom(chrom, self.right_map, "3", self.soft_out, self.fq_out)
        self.left_map.by_pos.clear()
        self.right_map.by_pos.clear()

    def _candidate_rows(self, recs, cand, first_op, last_op, first_len,
                        last_len, map_len):
        """Vectorized form of the per-record _get_sclip_read case logic
        (ref GetSClipReads clip_reads.cpp:112-192) -> candidate row
        arrays for the native consensus map, in stream order (per record:
        left insert before right insert)."""
        n = len(cand)
        sf = first_op[cand] == OP_S
        sl = last_op[cand] == OP_S
        both = sf & sl
        ll = first_len[cand].astype(np.int64)
        rl = last_len[cand].astype(np.int64)
        lq = recs.l_qseq[cand].astype(np.int64)
        xcskip = (recs.xc[cand] != 0) & (not self.save_low_quality)
        fwd = (recs.flag[cand] & 0x10) == 0
        emit_l = (sf & ~sl & ~xcskip) | (both & (~xcskip | fwd))
        emit_r = (sl & ~sf & ~xcskip) | (both & (~xcskip | ~fwd))
        ll_eff = np.where(both, ll, 0)
        rl_eff = np.where(both, rl, 0)
        pos_l = recs.pos[cand].astype(np.int64) + 1
        pos_r = recs.pos[cand].astype(np.int64) + map_len[cand]
        # interleave (L, R) per record, then compact by the emit masks
        rec2 = np.repeat(np.asarray(cand, np.int64), 2)
        is_l = np.tile(np.array([True, False]), n)
        emit = np.empty(2 * n, bool)
        emit[0::2] = emit_l
        emit[1::2] = emit_r

        def inter(a_l, a_r):
            out = np.empty(2 * n, np.int64)
            out[0::2] = a_l
            out[1::2] = a_r
            return out

        rows = {
            "rec": rec2[emit],
            "side": np.where(is_l, 0, 1).astype(np.int32)[emit],
            "pos": inter(pos_l, pos_r)[emit],
            "a": inter(np.zeros(n, np.int64), ll_eff)[emit],
            "ms": inter(ll, lq - rl)[emit],
            "me": inter(lq - rl_eff, lq)[emit],
            "leftclip": is_l.astype(np.uint8)[emit],
        }
        return rows

    def process(self, recs: BamRecords) -> None:
        self.ref_names = recs.ref_names
        # ---- vectorized classification over the slab ----
        flag = recs.flag
        unmapped_any = (flag & (FUNMAP | FMUNMAP)) != 0
        mapped = ~unmapped_any
        first_op = recs.first_op()
        last_op = recs.last_op()
        has_hard = (first_op == OP_H) | (last_op == OP_H)
        clip_candidate = (mapped & ~has_hard
                          & ((first_op == OP_S) | (last_op == OP_S))
                          & (recs.mapq >= self.min_mapq)
                          & ((flag & FDUP) == 0))
        first_len = recs.first_len()
        last_len = recs.last_len()
        map_len = _map_len_no_x(recs)

        # Python only touches the sparse interesting subsets; the streaming
        # loop's semantics are reproduced from the vectorized tid-run view:
        #   - unmapped records pair mates in BAM order,
        #   - mapped records form contiguous tid runs (coordinate-sorted
        #     BAM); each run boundary triggers a flush and DROPS the first
        #     mapped record of the new run (the reference's else-branch
        #     quirk, clip_reads.h:423-438) — except a leading tid-0 run
        #     (last_tid starts at 0).
        with trace.span("seeksv.scan.unmapped"):
            self._pair_unmapped(recs, np.nonzero(unmapped_any)[0])

        mapped_idx = np.nonzero(mapped)[0]
        if len(mapped_idx):
            mtids = recs.tid[mapped_idx]
            run_starts = np.concatenate(
                [[0], np.nonzero(mtids[1:] != mtids[:-1])[0] + 1,
                 [len(mtids)]])
            for r in range(len(run_starts) - 1):
                s, e = int(run_starts[r]), int(run_starts[r + 1])
                tid = int(mtids[s])
                if tid != self.last_tid:
                    self._flush(self.last_tid)
                    self.last_tid = tid
                    s += 1  # quirk: flush-triggering record is dropped
                run = mapped_idx[s:e]
                cand = run[clip_candidate[run]]
                if self._nmap is not None:
                    if len(cand):
                        rows = self._candidate_rows(
                            recs, cand, first_op, last_op, first_len,
                            last_len, map_len)
                        if self.own_range is not None:
                            rows = self._filter_rows_owned(rows, tid)
                        self._nmap.insert_slab(recs, rows)
                    continue
                lmap, rmap = self.left_map, self.right_map
                if self.own_range is not None:
                    lo, hi = self._tid_interval(tid)
                    lmap = _OwnFilter(lmap, lo, hi)
                    rmap = _OwnFilter(rmap, lo, hi)
                for i in cand:
                    _get_sclip_read(recs, int(i), lmap, rmap,
                                    self.threshold,
                                    self.save_low_quality, first_op, last_op,
                                    first_len, last_len, map_len)

    def _tid_interval(self, tid: int):
        """Owned 1-based breakpoint-position interval for one tid
        ([-inf, -1] when the tid has no owned range)."""
        for t, lo, hi in self.own_range:
            if t == tid:
                return lo, hi
        return 0, -1

    def _pair_unmapped(self, recs, idx: np.ndarray) -> None:
        """Pair the slab's unmapped / mate-unmapped records ``idx`` (those
        at owned positions under own_range) into unmapped_{1,2}.fq.gz:
        the native pairer and one write a file a slab, else
        _store_unmapped record by record.  Counts ``getclip.
        unmapped_records`` (records paired) and ``getclip.unmapped_pairs``
        (pairs written)."""
        if self.own_range is not None and len(idx):
            idx = idx[self._owned(recs.tid[idx], recs.pos[idx])]
        if self._pairer is not None:
            un1, un2, pairs = self._pairer.pair(recs, idx)
            if pairs:
                self.un1.write(un1)
                self.un2.write(un2)
        else:
            pairs = 0
            for i in idx:
                pairs += _store_unmapped(recs, int(i), self.id2seq_qual,
                                         self.un1, self.un2)
        trace.count("getclip.unmapped_records", len(idx))
        trace.count("getclip.unmapped_pairs", pairs)

    def _owned(self, tid: np.ndarray, pos: np.ndarray) -> np.ndarray:
        """Whether each (tid, pos) lies in its tid's owned interval (the
        first own_range triple of the tid, as _tid_interval)."""
        lo = np.zeros(len(tid), np.int64)
        hi = np.full(len(tid), -1, np.int64)
        for t, a, b in reversed(self.own_range):
            m = tid == t
            lo[m] = a
            hi[m] = b
        return (lo <= pos) & (pos < hi)

    def _filter_rows_owned(self, rows, tid):
        lo, hi = self._tid_interval(tid)
        keep = (rows["pos"] >= lo) & (rows["pos"] < hi)
        return {k: v[keep] for k, v in rows.items()}

    def close(self) -> None:
        with trace.span("seeksv.scan.flush"):
            self._flush(self.last_tid)
            self.soft_out.close()
            self.fq_out.close()
            self.un1.close()
            self.un2.close()
            if self._pairer is not None:
                self._pairer.close()


def getclip(bam_path: str, prefix: str, threshold: float = 0.85,
            min_mapq: int = 20, save_low_quality: bool = False,
            recs: BamRecords | None = None) -> None:
    """Run the getclip pass, producing prefix.clip.gz / prefix.clip.fq.gz /
    prefix.unmapped_{1,2}.fq.gz (ref CallGetclip, seeksv.cpp:128-155).

    Defaults differ from the v1.2.3 usage text because the parity oracle is
    the shipped v1.2.0 binary that produced the committed example outputs
    (both determined empirically by probing example/bin/seeksv with crafted
    SAM inputs):
      - min_mapq = 20 (v1.2.3 text says 1),
      - threshold = 0.85 (v1.2.3 says 0.9); both sides must reach it
        (merge at exactly 17/20 = 0.85, reject at 11/13 = 0.846)."""
    if recs is None:
        recs = read_bam(bam_path)
    stream = GetclipStream(prefix, threshold, min_mapq, save_low_quality)
    stream.process(recs)
    stream.close()


def _map_len_no_x(recs: BamRecords) -> np.ndarray:
    return recs.ref_span(count_x=False)


def _store_unmapped(recs, i, id2seq_qual, un1, un2) -> bool:
    """StoreUnmapSeqAndQual (ref: clip_reads.h:172-219): pair mates of
    fully/half-unmapped reads into unmapped_{1,2}.fq.gz.  Returns whether
    record i completed a pair."""
    qname = recs.qnames[i]
    seq = recs.seq_bytes(i).decode()
    qual = recs.qual_str(i).decode()
    ent = id2seq_qual.get(qname)
    name = qname.decode()
    if ent is not None:
        (oseq, oqual), end = ent
        if recs.flag[i] & FREAD1:
            if end == "2":
                un1.write(f"@{name}/1\n{seq}\n+\n{qual}\n".encode())
                un2.write(f"@{name}/2\n{oseq}\n+\n{oqual}\n".encode())
                del id2seq_qual[qname]
                return True
        else:
            if end == "1":
                un1.write(f"@{name}/1\n{oseq}\n+\n{oqual}\n".encode())
                un2.write(f"@{name}/2\n{seq}\n+\n{qual}\n".encode())
                del id2seq_qual[qname]
                return True
    else:
        end = "1" if recs.flag[i] & FREAD1 else "2"
        id2seq_qual[qname] = ((seq, qual), end)
    return False


def _get_sclip_read(recs, i, left_map, right_map, limit, save_low_quality,
                    first_op, last_op, first_len, last_len, map_len,
                    only=None):
    """GetSClipReads (ref: clip_reads.cpp:112-192).

    only='L'/'R' restricts to one clip side (used by the coordinate-sharded
    path where the two sides of a both-ends-clipped read belong to
    different key shards)."""
    sf = first_op[i] == OP_S
    sl = last_op[i] == OP_S
    l_qseq = int(recs.l_qseq[i])
    seq = recs.seq[recs.seq_off[i]:recs.seq_off[i + 1]]
    cigar_vec, _ = cg.from_bam_ops(recs.cigar(i))

    def parts(a, mid_start, mid_len):
        s_l = seq[a:mid_start].copy()
        s_r = seq[mid_start:mid_start + mid_len].copy()
        q_l = _qual_arr(recs, i, a, mid_start)
        q_r = _qual_arr(recs, i, mid_start, mid_start + mid_len)
        return s_l, q_l, s_r, q_r

    if sf != sl:  # exactly one soft-clipped end
        if recs.xc[i] != 0 and not save_low_quality:
            return
        if sf:
            if only == "R":
                return
            ll = int(first_len[i])
            s_l, q_l, s_r, q_r = parts(0, ll, l_qseq - ll)
            pos = int(recs.pos[i]) + 1
            left_map.insert(pos, s_l, q_l, s_r, q_r, cigar_vec, limit, LEFT_CLIPPED)
        else:
            if only == "L":
                return
            rl = int(last_len[i])
            ll = l_qseq - rl
            s_l, q_l, s_r, q_r = parts(0, ll, rl)
            pos = int(recs.pos[i]) + int(map_len[i])
            right_map.insert(pos, s_l, q_l, s_r, q_r, cigar_vec, limit, RIGHT_CLIPPED)
    elif sf and sl:  # both ends soft-clipped
        ll = int(first_len[i])
        rcl = int(last_len[i])
        mid = l_qseq - ll - rcl
        if recs.xc[i] != 0 and not save_low_quality:
            if not (recs.flag[i] & 0x10):  # forward: left clip is useful
                if only == "R":
                    return
                s_l, q_l, s_r, q_r = parts(0, ll, mid)
                pos = int(recs.pos[i]) + 1
                left_map.insert(pos, s_l, q_l, s_r, q_r, cigar_vec, limit, LEFT_CLIPPED)
            else:  # reverse: right clip is useful
                if only == "L":
                    return
                s_l, q_l, s_r, q_r = parts(ll, ll + mid, rcl)
                pos = int(recs.pos[i]) + int(map_len[i])
                right_map.insert(pos, s_l, q_l, s_r, q_r, cigar_vec, limit, RIGHT_CLIPPED)
        else:
            if only != "R":
                s_l, q_l, s_r, q_r = parts(0, ll, mid)
                pos = int(recs.pos[i]) + 1
                left_map.insert(pos, s_l, q_l, s_r, q_r, cigar_vec, limit, LEFT_CLIPPED)
            if only != "L":
                s_l, q_l, s_r, q_r = parts(ll, ll + mid, rcl)
                pos = int(recs.pos[i]) + int(map_len[i])
                right_map.insert(pos, s_l, q_l, s_r, q_r, cigar_vec, limit, RIGHT_CLIPPED)
