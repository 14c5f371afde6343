"""Synthetic dataset generation: donor genomes with implanted SVs and
paired-end reads with analytically derived alignments.

Serves the roles the reference covers with its committed example assets
and simu_data truth files (SURVEY.md §4): end-to-end accuracy testing
against known junctions, scale benchmarking, and virus-integration-mode
fixtures (a donor containing segments from an extra contig absent from
the alignment reference).

Reads are emitted as a coordinate-sorted BAM with bwa-like conventions:
full-length matches inside contiguous segments, soft-clips at junction
crossings (aligned side = longer side; unmapped when the longer side is
below the score threshold), FR proper-pair flags, sampling-based insert
sizes.

Counterpart of seeksv_tpu/utils/simulate.py.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..io.bam_writer import BamWriter
from ..ops.matchrate import REVCOMP_TABLE

BASES = np.frombuffer(b"ACGT", np.uint8)


def random_genome(rng, length: int) -> np.ndarray:
    return BASES[rng.integers(0, 4, length)]


def mutate(rng, seq: np.ndarray, rate: float) -> np.ndarray:
    """Substitute a `rate` fraction of positions with a different base —
    models strain-level divergence between a donor's integrated sequence
    and the reference contig it aligns to (the virus-integration class
    the reference targets, ref: README.md:60-96).  Unlike sequencing
    error, these substitutions are shared by every read covering the
    site, so consensus voting preserves them and the realignment step
    sees genuinely divergent fragments."""
    out = seq.copy()
    n = int(len(seq) * rate)
    if n == 0:
        return out
    sites = rng.choice(len(seq), n, replace=False)
    # shift each base by 1..3 in ACGT space => always a different base
    code = ENCODE_SIM[out[sites]]
    out[sites] = BASES[(code + rng.integers(1, 4, n)) % 4]
    return out


ENCODE_SIM = np.zeros(256, np.uint8)
for _i, _c in enumerate(b"ACGT"):
    ENCODE_SIM[_c] = _i


@dataclass
class Segment:
    """One piece of the donor: a reference slice or novel sequence."""
    chrom: Optional[str]      # None => novel insertion (unalignable)
    start: int = 0            # 0-based ref start (for + strand: left edge)
    end: int = 0
    strand: int = 1           # +1 / -1
    novel: Optional[np.ndarray] = None

    def length(self) -> int:
        return len(self.novel) if self.chrom is None else self.end - self.start


@dataclass
class Donor:
    segments: List[Segment]
    seq: np.ndarray
    seg_bounds: np.ndarray    # donor-space offsets [n_seg+1]
    truth: List[Tuple]        # junction truth tuples


def build_donor(ref: Dict[str, np.ndarray], deletions=(), inversions=(),
                insertions=(), translocation_to: Optional[str] = None,
                chrom: Optional[str] = None) -> Donor:
    """Compose a donor chromosome from one reference chromosome with
    implanted deletions / inversions / novel insertions.  Event tuples:
    deletions:  (start0, end0)   half-open ref interval removed
    inversions: (start0, end0)   interval reverse-complemented
    insertions: (pos0, seq)      novel sequence inserted before pos0
    """
    chrom = chrom or next(iter(ref))
    L = len(ref[chrom])
    events = ([("del", s, e, None) for s, e in deletions]
              + [("inv", s, e, None) for s, e in inversions]
              + [("ins", p, p, s) for p, s in insertions])
    events.sort(key=lambda t: t[1])
    segs: List[Segment] = []
    truth: List[Tuple] = []
    cur = 0
    for typ, s, e, payload in events:
        if s > cur:
            segs.append(Segment(chrom, cur, s, 1))
        if typ == "del":
            truth.append(("DEL", chrom, s, chrom, e + 1))  # 1-based breakends
        elif typ == "inv":
            segs.append(Segment(chrom, s, e, -1))
            truth.append(("INV", chrom, s, chrom, e))
        elif typ == "ins":
            segs.append(Segment(None, novel=np.asarray(payload, np.uint8)))
            truth.append(("INS", chrom, s, chrom, s + 1))
        cur = e
    if cur < L:
        segs.append(Segment(chrom, cur, L, 1))
    parts = []
    bounds = [0]
    for sg in segs:
        if sg.chrom is None:
            parts.append(sg.novel)
        elif sg.strand == 1:
            parts.append(ref[sg.chrom][sg.start:sg.end])
        else:
            parts.append(REVCOMP_TABLE[ref[sg.chrom][sg.start:sg.end][::-1]])
        bounds.append(bounds[-1] + sg.length())
    return Donor(segs, np.concatenate(parts), np.asarray(bounds, np.int64),
                 truth)


@dataclass
class _Aln:
    mapped: bool
    tid: int = -1
    pos: int = 0
    rev: bool = False
    cigar: List[Tuple[int, str]] = field(default_factory=list)


def _map_read(donor: Donor, name2tid: Dict[str, int], s: int, e: int,
              rev: bool, read_len: int, min_anchor: int = 30) -> _Aln:
    """Analytic alignment of donor interval [s, e) as bwa would report it."""
    bounds = donor.seg_bounds
    i0 = int(np.searchsorted(bounds, s, "right")) - 1
    i1 = int(np.searchsorted(bounds, e - 1, "right")) - 1
    # choose the segment with the largest overlap as the aligned anchor
    best_seg, best_len = -1, 0
    for i in range(i0, i1 + 1):
        sg = donor.segments[i]
        if sg.chrom is None:
            continue
        ov = min(e, int(bounds[i + 1])) - max(s, int(bounds[i]))
        if ov > best_len:
            best_seg, best_len = i, ov
    if best_seg < 0 or best_len < min_anchor:
        return _Aln(False)
    sg = donor.segments[best_seg]
    left_clip = max(0, int(bounds[best_seg]) - s)
    right_clip = max(0, e - int(bounds[best_seg + 1]))
    anchor = read_len - left_clip - right_clip
    off = max(s, int(bounds[best_seg])) - int(bounds[best_seg])
    if sg.strand == 1:
        pos = sg.start + off
        seg_rev = rev
        lcl, rcl = left_clip, right_clip
    else:
        pos = sg.end - off - anchor
        seg_rev = not rev
        lcl, rcl = right_clip, left_clip
    # the emitted record's clip sides are in REFERENCE orientation of the
    # stored sequence; when the record is reverse-strand, the stored seq
    # is the revcomp of the donor-forward read, and clip sides swap with
    # seg orientation only (handled above via lcl/rcl)
    cig: List[Tuple[int, str]] = []
    if lcl:
        cig.append((lcl, "S"))
    cig.append((anchor, "M"))
    if rcl:
        cig.append((rcl, "S"))
    return _Aln(True, name2tid[sg.chrom], pos, seg_rev, cig)


def simulate_reads(donor: Donor, ref_names: List[str], ref_lens: List[int],
                   out_bam: str, *, coverage: float = 30.0,
                   read_len: int = 100, insert_mean: int = 500,
                   insert_sd: int = 25, error_rate: float = 0.002,
                   seed: int = 0, level: int = 1) -> int:
    """Paired-end simulation -> coordinate-sorted BAM.  Returns #records.

    Throughput design (the data-loader role at production scale): pairs
    whose reads both lie inside a single forward reference segment — the
    overwhelming majority — take a fully vectorized path (gathered
    sequence matrices, fixed-shape record-byte assembly, chunked BGZF);
    only junction-crossing / inverted / novel-segment pairs go through the
    per-pair analytic aligner (_map_read), which makes 500Mbp x 30x
    datasets practical."""
    rng = np.random.default_rng(seed)
    name2tid = {n: i for i, n in enumerate(ref_names)}
    G = len(donor.seq)
    n_pairs = int(coverage * G / (2 * read_len))
    frag = np.maximum(rng.normal(insert_mean, insert_sd, n_pairs)
                      .astype(np.int64), 2 * read_len + 10)
    starts = rng.integers(0, np.maximum(G - frag, 1))
    max_isize = insert_mean + 4 * insert_sd
    qual = "I" * read_len

    # ---- vectorized pair classification ----
    r1_s = starts
    r2_s = starts + frag - read_len
    valid = r2_s + read_len <= G
    bounds = donor.seg_bounds
    seg_fwd_ref = np.asarray(
        [sg.chrom is not None and sg.strand == 1 for sg in donor.segments])
    seg_tid = np.asarray([name2tid.get(sg.chrom, -1) if sg.chrom else -1
                          for sg in donor.segments], np.int32)
    seg_ref_start = np.asarray(
        [sg.start for sg in donor.segments], np.int64)

    def classify(s):
        i0 = np.searchsorted(bounds, s, "right") - 1
        simple = seg_fwd_ref[i0] & (s + read_len <= bounds[i0 + 1])
        pos = seg_ref_start[i0] + (s - bounds[i0])
        return simple, pos, seg_tid[i0]

    simple1, pos1, tid1 = classify(r1_s)
    simple2, pos2, tid2 = classify(r2_s)
    bulk = valid & simple1 & simple2
    complex_idx = np.nonzero(valid & ~bulk)[0]
    bulk_idx = np.nonzero(bulk)[0]

    # ---- complex pairs: per-pair analytic path ----
    records = _complex_pair_records(donor, name2tid, starts, frag,
                                    complex_idx, read_len, max_isize,
                                    rng, error_rate, G)

    # ---- bulk pair fields (vectorized; mirrors the loop for the case
    # a1 fwd / a2 rev, both full-length M) ----
    p1 = pos1[bulk_idx]
    p2 = pos2[bulk_idx]
    t1 = tid1[bulk_idx]
    t2 = tid2[bulk_idx]
    same = t1 == t2
    span = (np.maximum(p1, p2) - np.minimum(p1, p2) + read_len)
    proper = same & (p1 <= p2) & (span <= max_isize)
    isize1 = np.where(same, np.where(p1 <= p2, span, -span), 0)
    flag1 = np.where(proper, 0x1 | 0x40 | 0x20 | 0x2,
                     0x1 | 0x40 | 0x20).astype(np.uint16)
    flag2 = np.where(proper, 0x1 | 0x80 | 0x10 | 0x2,
                     0x1 | 0x80 | 0x10).astype(np.uint16)

    # global coordinate-sorted write order over complex + bulk records
    n_bulk = len(bulk_idx)
    comp_tid = np.asarray([r[0] for r in records], np.int64) \
        if records else np.zeros(0, np.int64)
    comp_pos = np.asarray([r[1] for r in records], np.int64) \
        if records else np.zeros(0, np.int64)
    all_tid = np.concatenate([comp_tid, t1.astype(np.int64),
                              t2.astype(np.int64)])
    all_pos = np.concatenate([comp_pos, p1, p2])
    all_tid = np.where(all_tid < 0, 1 << 30, all_tid)
    order = np.lexsort((np.arange(len(all_tid)), all_pos, all_tid))

    w = BamWriter(out_bam, ref_names, ref_lens, level=level)
    qb = qual.encode()
    n_comp = len(records)
    _write_sorted(w, order, n_comp, records, qb, donor, rng, error_rate,
                  read_len, bulk_idx, r1_s, r2_s, p1, p2, t1, t2,
                  flag1, flag2, isize1)
    w.close()
    return n_comp + 2 * n_bulk


def _complex_pair_records(donor, name2tid, starts, frag, complex_idx,
                          read_len, max_isize, rng, error_rate, G):
    """The original per-pair path, for pairs touching junctions /
    inversions / novel segments.  Returns encoded-field tuples."""
    records = []
    for k in complex_idx:
        s = int(starts[k])
        f = int(frag[k])
        r1_s, r1_e = s, s + read_len
        r2_s, r2_e = s + f - read_len, s + f
        if r2_e > G:
            continue
        seq1 = donor.seq[r1_s:r1_e].copy()
        seq2f = donor.seq[r2_s:r2_e]
        seq2 = REVCOMP_TABLE[seq2f[::-1]].copy()   # read2 sequenced reverse
        for sq in (seq1, seq2):
            errs = np.nonzero(rng.random(read_len) < error_rate)[0]
            if len(errs):
                sq[errs] = BASES[rng.integers(0, 4, len(errs))]
        a1 = _map_read(donor, name2tid, r1_s, r1_e, False, read_len)
        a2 = _map_read(donor, name2tid, r2_s, r2_e, True, read_len)
        qname = b"sim_%010d" % int(k)
        flag1 = 0x1 | 0x40
        flag2 = 0x1 | 0x80
        # stored sequence follows alignment strand convention
        st1 = seq1 if not (a1.mapped and a1.rev) else REVCOMP_TABLE[seq1[::-1]]
        st2 = seq2 if not (a2.mapped and a2.rev) else REVCOMP_TABLE[seq2[::-1]]
        # mate/pair fields
        isize1 = isize2 = 0
        proper = False
        if a1.mapped and a2.mapped and a1.tid == a2.tid:
            p1, p2 = a1.pos, a2.pos
            end2 = a2.pos + sum(l for l, o in a2.cigar if o == "M")
            end1 = a1.pos + sum(l for l, o in a1.cigar if o == "M")
            lo = min(p1, p2)
            hi = max(end1, end2)
            span = hi - lo
            if (not a1.rev) and a2.rev and p1 <= p2 and span <= max_isize:
                proper = True
            isize1 = span if p1 <= p2 else -span
            isize2 = -isize1
        if proper:
            flag1 |= 0x2
            flag2 |= 0x2
        if a1.mapped and a1.rev:
            flag1 |= 0x10
        if a2.mapped and a2.rev:
            flag2 |= 0x10
        if not a1.mapped:
            flag1 |= 0x4
            flag2 |= 0x8
        if not a2.mapped:
            flag2 |= 0x4
            flag1 |= 0x8
        if a2.mapped and a2.rev:
            flag1 |= 0x20
        if a1.mapped and a1.rev:
            flag2 |= 0x20
        t1 = a1.tid if a1.mapped else (a2.tid if a2.mapped else -1)
        p1 = a1.pos if a1.mapped else (a2.pos if a2.mapped else -1)
        t2 = a2.tid if a2.mapped else (a1.tid if a1.mapped else -1)
        p2 = a2.pos if a2.mapped else (a1.pos if a1.mapped else -1)
        records.append((t1, p1, qname, flag1, 60 if a1.mapped else 0,
                        a1.cigar if a1.mapped else [], st1.tobytes(),
                        t2, p2, isize1))
        records.append((t2, p2, qname, flag2, 60 if a2.mapped else 0,
                        a2.cigar if a2.mapped else [], st2.tobytes(),
                        t1, p1, isize2))
    return records


_NT16_CODE = np.full(256, 15, np.uint8)
for _c, _v in ((b"=", 0), (b"A", 1), (b"C", 2), (b"M", 3), (b"G", 4),
               (b"R", 5), (b"S", 6), (b"V", 7), (b"T", 8), (b"W", 9),
               (b"Y", 10), (b"H", 11), (b"K", 12), (b"D", 13), (b"B", 14),
               (b"N", 15)):
    _NT16_CODE[_c[0]] = _v


def _i32_bytes(a: np.ndarray) -> np.ndarray:
    """[n] ints -> [n, 4] little-endian bytes."""
    return np.ascontiguousarray(a, "<i4").view(np.uint8).reshape(-1, 4)


def _write_sorted(w, order, n_comp, records, qb, donor, rng, error_rate,
                  read_len, bulk_idx, r1_s, r2_s, p1, p2, t1, t2,
                  flag1, flag2, isize1) -> None:
    """Write records in global (tid, pos) order: runs of bulk records are
    assembled as byte matrices; complex records go through encode_record."""
    n_bulk = len(bulk_idx)
    QN = 15
    packed_len = (read_len + 1) // 2
    rec_size = 4 + 32 + QN + 4 + packed_len + read_len
    CHUNK = 1 << 20

    def bulk_bytes(run):
        """Assemble the [n, rec_size] record-byte matrix for bulk entries
        (indices into the combined table, all >= n_comp), in one shot."""
        j = run - n_comp            # 0..2*n_bulk-1: r1 block then r2 block
        is_r2 = j >= n_bulk
        pi = np.where(is_r2, j - n_bulk, j)
        k = bulk_idx[pi]
        pos = np.where(is_r2, p2[pi], p1[pi])
        tid = np.where(is_r2, t2[pi], t1[pi])
        mpos = np.where(is_r2, p1[pi], p2[pi])
        mtid = np.where(is_r2, t1[pi], t2[pi])
        flag = np.where(is_r2, flag2[pi], flag1[pi])
        isz = np.where(is_r2, -isize1[pi], isize1[pi])
        s = np.where(is_r2, r2_s[k], r1_s[k])

        n = len(run)
        # gathered sequences + errors (stored forward for both mates:
        # read2's sequencing errors are uniform, so applying uniform
        # errors to the forward-stored bases is the same distribution);
        # error sites drawn as flat indices (duplicate draws are
        # vanishingly rare and harmless)
        seq = donor.seq[s[:, None] + np.arange(read_len)]
        total = n * read_len
        ne = rng.binomial(total, error_rate) if error_rate > 0 else 0
        if ne:
            flat = rng.integers(0, total, ne)
            seq.reshape(-1)[flat] = BASES[rng.integers(0, 4, ne)]
        from ..io import native
        if native.pack_sim_available():
            return native.pack_sim_records(read_len, tid, pos, mtid, mpos,
                                           flag, isz, k, seq)
        out = np.empty((n, rec_size), np.uint8)
        out[:, 0:4] = np.frombuffer(
            np.int32(rec_size - 4).tobytes(), np.uint8)
        out[:, 4:8] = _i32_bytes(tid)
        out[:, 8:12] = _i32_bytes(pos)
        out[:, 12] = QN
        out[:, 13] = 60
        out[:, 14:16] = 0
        out[:, 16] = 1
        out[:, 17] = 0
        out[:, 18:20] = np.ascontiguousarray(
            flag, "<u2").view(np.uint8).reshape(-1, 2)
        out[:, 20:24] = np.frombuffer(np.int32(read_len).tobytes(), np.uint8)
        out[:, 24:28] = _i32_bytes(mtid)
        out[:, 28:32] = _i32_bytes(mpos)
        out[:, 32:36] = _i32_bytes(isz)
        qn = np.zeros((n, QN), np.uint8)
        qn[:, 0:4] = np.frombuffer(b"sim_", np.uint8)
        digits = k.astype(np.int64).copy()
        for d in range(10):
            qn[:, 13 - d] = 0x30 + (digits % 10)
            digits //= 10
        out[:, 36:36 + QN] = qn
        c0 = 36 + QN
        out[:, c0:c0 + 4] = np.frombuffer(
            np.uint32(read_len << 4).tobytes(), np.uint8)
        codes = _NT16_CODE[seq]
        sp = c0 + 4
        out[:, sp:sp + packed_len] = (codes[:, 0::2] << 4)
        if read_len > 1:
            out[:, sp:sp + (read_len // 2)] |= codes[:, 1::2]
        out[:, sp + packed_len:] = 40  # qual 'I' - 33
        return out.reshape(-1)

    # two-level walk: bulk record bytes are assembled in big chunks (few
    # large numpy calls), then the global order interleaves slices of
    # those chunks with individually encoded complex records
    from ..io.bam_writer import encode_record
    is_bulk_o = order >= n_comp
    bulk_seq = order[is_bulk_o]          # bulk entries in global order
    bulk_rank = np.cumsum(is_bulk_o) - 1  # rank of each order slot
    chunk_id = -1
    chunk = None
    i = 0
    N = len(order)
    while i < N:
        if not is_bulk_o[i]:
            (tid, pos, qname, flag, mapq, cig, seq, mtid, mpos,
             isize) = records[order[i]]
            w.w.write(encode_record(tid, pos, qname, flag, mapq, cig, seq,
                                    qb, mtid, mpos, isize))
            i += 1
            continue
        j = i
        while j < N and is_bulk_o[j]:
            j += 1
        r0, r1r = int(bulk_rank[i]), int(bulk_rank[j - 1]) + 1
        while r0 < r1r:
            cid = r0 // CHUNK
            if cid != chunk_id:
                chunk_id = cid
                lo, hi = cid * CHUNK, min((cid + 1) * CHUNK, len(bulk_seq))
                chunk = bulk_bytes(bulk_seq[lo:hi])
            base = chunk_id * CHUNK
            a, b = r0 - base, min(r1r - base, CHUNK)
            w.w.write(chunk[a * rec_size:b * rec_size].tobytes())
            r0 = base + b
        i = j


def write_fasta(path: str, seqs: Dict[str, np.ndarray]) -> None:
    with open(path, "w") as f:
        for name, arr in seqs.items():
            f.write(f">{name}\n")
            s = arr.tobytes().decode()
            for i in range(0, len(s), 60):
                f.write(s[i:i + 60] + "\n")
