"""BAM/SAM decoding into structure-of-arrays batches.

Replaces the reference's bundled samtools-0.1.x C API (ref: sam/bam.h,
sam/sam.h): instead of streaming one `bam1_t` at a time, the whole file is
decoded into flat numpy arrays (one entry per record, ragged payloads stored
as concatenated blobs + offset arrays).  This is the layout every vectorized
stage of the framework consumes (counterpart of seeksv_tpu/io/bam.py).

A native C++ decoder (csrc/seeksv_native.cpp) is used when available; this
module also contains a pure-python fallback with identical output.
"""
from __future__ import annotations

import gzip
import struct
import zlib
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

# BAM flag bits (ref: sam/bam.h:56-77)
FPAIRED = 0x1
FPROPER_PAIR = 0x2
FUNMAP = 0x4
FMUNMAP = 0x8
FREVERSE = 0x10
FMREVERSE = 0x20
FREAD1 = 0x40
FREAD2 = 0x80
FSECONDARY = 0x100
FQCFAIL = 0x200
FDUP = 0x400
FSUPPLEMENTARY = 0x800

# default mask used by the samtools pileup engine (ref: sam/bam.h:124)
DEF_MASK = FUNMAP | FSECONDARY | FQCFAIL | FDUP

# CIGAR op codes (ref: sam/bam.h:99-110) and their display characters
CIGAR_CHARS = b"MIDNSHP=X"
OP_M, OP_I, OP_D, OP_N, OP_S, OP_H, OP_P, OP_EQ, OP_X = range(9)

# 4-bit nucleotide code -> ASCII (ref: sam/bam.h bam_nt16_rev_table)
SEQ_NT16 = b"=ACMGRSVTWYHKDBN"
_NT16_ARR = np.frombuffer(SEQ_NT16, dtype=np.uint8)
# byte -> two decoded ASCII chars
_NIB2 = np.zeros((256, 2), dtype=np.uint8)
for _b in range(256):
    _NIB2[_b, 0] = _NT16_ARR[_b >> 4]
    _NIB2[_b, 1] = _NT16_ARR[_b & 0xF]

_CHAR2OP = {c: i for i, c in enumerate(CIGAR_CHARS)}

# A slab's CIGAR summary: the streamed decoder's columns (io/native.py
# _TorchSoA) -> the BamRecords memo key of the helper each stands for
CIGAR_SUMMARY = {"first_op": "first_op", "last_op": "last_op",
                 "first_len": "first_len", "last_len": "last_len",
                 "span_nox": ("ref_span", False),
                 "span_x": ("ref_span", True)}


@dataclass
class BamRecords:
    """Structure-of-arrays view of a decoded BAM/SAM file."""

    ref_names: List[str]
    ref_lens: List[int]
    n: int
    flag: np.ndarray      # uint16 -> int32 [n]
    tid: np.ndarray       # int32 [n]
    pos: np.ndarray       # int32 [n] (0-based)
    mapq: np.ndarray      # int32 [n]
    mtid: np.ndarray      # int32 [n]
    mpos: np.ndarray      # int32 [n] (0-based)
    isize: np.ndarray     # int32 [n]
    l_qseq: np.ndarray    # int32 [n]
    qnames: List[bytes]
    cig: np.ndarray       # uint32 concat (len<<4|op), bam encoding
    cig_off: np.ndarray   # int64 [n+1]
    seq: np.ndarray       # uint8 ASCII concat
    qual: np.ndarray      # uint8 raw phred concat (0xff = missing)
    seq_off: np.ndarray   # int64 [n+1]
    xc: np.ndarray        # int32 [n]; XC aux tag value, 0 when absent
    owner: object = None  # keep-alive for zero-copy native buffers

    # ---- per-record accessors (host-side passes) ----
    def cigar(self, i: int) -> np.ndarray:
        return self.cig[self.cig_off[i]:self.cig_off[i + 1]]

    def cigar_pairs(self, i: int) -> List[Tuple[int, int]]:
        c = self.cigar(i)
        return [(int(x) >> 4, int(x) & 0xF) for x in c]

    def seq_bytes(self, i: int) -> bytes:
        return self.seq[self.seq_off[i]:self.seq_off[i + 1]].tobytes()

    def qual_raw(self, i: int) -> np.ndarray:
        return self.qual[self.seq_off[i]:self.seq_off[i + 1]]

    def qual_str(self, i: int) -> bytes:
        """Phred+33 string; '*' when quality is missing (0xff sentinel).

        ref: clip_reads.cpp:296-301 (GetSeq) / :383-384 (GetSeqAndQual).
        """
        q = self.qual_raw(i)
        if len(q) and q[0] == 0xFF:
            return b"*"
        return (q + 33).astype(np.uint8).tobytes()

    def ref_name(self, tid: int) -> str:
        return self.ref_names[tid]

    # vectorized helpers (memoized: multiple streaming consumers ask for
    # the same columns per slab; the streamed decoder fills the memo with
    # its CIGAR summary) -------------------------------------------------
    _memo: dict = None

    def _cached(self, key, fn):
        if self._memo is None:
            object.__setattr__(self, "_memo", {})
        v = self._memo.get(key)
        if v is None:
            v = self._memo[key] = fn()
        return v

    def summarised(self) -> bool:
        """Whether the memo holds every CIGAR summary helper's column
        (the streamed decoder writes them), so none walks the CIGARs."""
        return self._memo is not None and all(
            k in self._memo for k in CIGAR_SUMMARY.values())

    def first_op(self) -> np.ndarray:
        """CIGAR op code of the first op per record (-1 when no cigar)."""
        def compute():
            out = np.full(self.n, -1, dtype=np.int32)
            has = self.cig_off[1:] > self.cig_off[:-1]
            idx = self.cig_off[:-1][has]
            out[has] = (self.cig[idx] & 0xF).astype(np.int32)
            return out
        return self._cached("first_op", compute)

    def last_op(self) -> np.ndarray:
        def compute():
            out = np.full(self.n, -1, dtype=np.int32)
            has = self.cig_off[1:] > self.cig_off[:-1]
            idx = self.cig_off[1:][has] - 1
            out[has] = (self.cig[idx] & 0xF).astype(np.int32)
            return out
        return self._cached("last_op", compute)

    def first_len(self) -> np.ndarray:
        def compute():
            out = np.zeros(self.n, dtype=np.int32)
            has = self.cig_off[1:] > self.cig_off[:-1]
            out[has] = (self.cig[self.cig_off[:-1][has]] >> 4).astype(
                np.int32)
            return out
        return self._cached("first_len", compute)

    def last_len(self) -> np.ndarray:
        def compute():
            out = np.zeros(self.n, dtype=np.int32)
            has = self.cig_off[1:] > self.cig_off[:-1]
            out[has] = (self.cig[self.cig_off[1:][has] - 1] >> 4).astype(
                np.int32)
            return out
        return self._cached("last_len", compute)

    def ref_span(self, count_x: bool = True) -> np.ndarray:
        """Reference-consumed length per record.

        count_x=True  -> M/D/N/=/X (bam_calend semantics, used for window
                         overlap & coverage extents)
        count_x=False -> M/D/N/=   (GenerateCigar's `l`, ref:
                         clip_reads.cpp:322 — X is *not* counted there)
        """
        def compute():
            ops = (self.cig & 0xF).astype(np.int32)
            lens = (self.cig >> 4).astype(np.int64)
            consume = ((ops == OP_M) | (ops == OP_D) | (ops == OP_N)
                       | (ops == OP_EQ))
            if count_x:
                consume |= ops == OP_X
            vals = np.where(consume, lens, 0)
            csum = np.concatenate([[0], np.cumsum(vals)])
            return (csum[self.cig_off[1:]]
                    - csum[self.cig_off[:-1]]).astype(np.int32)
        return self._cached(("ref_span", count_x), compute)


class LazyQnames:
    """List-like view over a concatenated qname blob + offsets; avoids
    materializing hundreds of thousands of bytes objects when qnames are
    only touched for the sparse unmapped/clip subsets.  The blob may be
    bytes or a uint8 array view into the native decoder's buffer (the
    owning BamRecords keeps it alive); per-access slices copy out."""

    __slots__ = ("blob", "off")

    def __init__(self, blob, off: np.ndarray):
        self.blob = blob
        self.off = off

    def __len__(self):
        return len(self.off) - 1

    def __getitem__(self, i):
        b = self.blob[self.off[i]:self.off[i + 1]]
        return b if isinstance(b, bytes) else b.tobytes()

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __eq__(self, other):
        if len(self) != len(other):
            return False
        return all(a == b for a, b in zip(self, other))


def _parse_header_text(text: str) -> Tuple[List[str], List[int]]:
    names, lens = [], []
    for line in text.split("\n"):
        if line.startswith("@SQ"):
            name, ln = None, 0
            for fld in line.split("\t")[1:]:
                if fld.startswith("SN:"):
                    name = fld[3:]
                elif fld.startswith("LN:"):
                    ln = int(fld[3:])
            if name is not None:
                names.append(name)
                lens.append(ln)
    return names, lens


def _aux_xc(buf: memoryview) -> int:
    """Scan a BAM aux blob for the XC integer tag (bwa's low-quality-clip
    marker, ref: clip_reads.cpp:126-129).  Returns 0 when absent, matching
    bam_aux2i(NULL) (ref: sam/bam_aux.c semantics)."""
    i, n = 0, len(buf)
    xc = 0
    while i + 3 <= n:
        tag = bytes(buf[i:i + 2])
        typ = buf[i + 2]
        i += 3
        if typ in (0x41, 0x63, 0x43):      # A, c, C
            val = buf[i] if typ != 0x63 else struct.unpack_from("<b", buf, i)[0]
            size = 1
        elif typ in (0x73, 0x53):          # s, S
            val = struct.unpack_from("<h" if typ == 0x73 else "<H", buf, i)[0]
            size = 2
        elif typ in (0x69, 0x49, 0x66):    # i, I, f
            val = struct.unpack_from("<i" if typ == 0x69 else ("<I" if typ == 0x49 else "<f"), buf, i)[0]
            size = 4
        elif typ in (0x5A, 0x48):          # Z, H
            j = i
            while j < n and buf[j] != 0:
                j += 1
            val, size = 0, j - i + 1
        elif typ == 0x42:                  # B array
            sub = buf[i]
            cnt = struct.unpack_from("<i", buf, i + 1)[0]
            esz = {0x63: 1, 0x43: 1, 0x73: 2, 0x53: 2, 0x69: 4, 0x49: 4, 0x66: 4}[sub]
            val, size = 0, 5 + cnt * esz
        else:
            break
        if tag == b"XC" and typ in (0x63, 0x43, 0x73, 0x53, 0x69, 0x49):
            xc = int(val)
        i += size
    return xc


def decode_bgzf(path: str) -> bytes:
    """Decompress a BGZF (or plain gzip) file fully into memory.

    BGZF is a series of concatenated gzip members, which python's gzip/zlib
    handle natively; no virtual-offset machinery is needed because every
    pass in this framework is whole-file vectorized, with random access
    replaced by in-memory gathers (SURVEY.md §2 call-out)."""
    with open(path, "rb") as f:
        raw = f.read()
    out = []
    d = zlib.decompressobj(wbits=31)
    data = raw
    while data:
        out.append(d.decompress(data))
        data = d.unused_data
        if not data:
            break
        d = zlib.decompressobj(wbits=31)
    return b"".join(out)


def read_bam_python(path: str) -> BamRecords:
    """Pure-python BAM decoder (fallback path; same contract as native)."""
    blob = decode_bgzf(path)
    if blob[:4] != b"BAM\x01":
        raise ValueError(f"{path}: not a BAM file")
    off = 4
    (l_text,) = struct.unpack_from("<i", blob, off)
    off += 4
    text = blob[off:off + l_text].split(b"\x00")[0].decode()
    off += l_text
    (n_ref,) = struct.unpack_from("<i", blob, off)
    off += 4
    ref_names, ref_lens = [], []
    for _ in range(n_ref):
        (l_name,) = struct.unpack_from("<i", blob, off)
        off += 4
        ref_names.append(blob[off:off + l_name - 1].decode())
        off += l_name
        (l_ref,) = struct.unpack_from("<i", blob, off)
        off += 4
        ref_lens.append(l_ref)

    hdr = struct.Struct("<iiiBBHHHiiii")
    flags, tids, poss, mapqs, mtids, mposs, isizes, lqs = ([] for _ in range(8))
    qnames: List[bytes] = []
    cig_parts: List[np.ndarray] = []
    cig_counts: List[int] = []
    seq_parts: List[np.ndarray] = []
    qual_parts: List[np.ndarray] = []
    xcs: List[int] = []
    mv = memoryview(blob)
    n_total = len(blob)
    while off + 4 <= n_total:
        (block_size,) = struct.unpack_from("<i", blob, off)
        off += 4
        end = off + block_size
        (tid, pos, l_read_name, mapq, _bin, n_cigar, flag, l_seq, mtid, mpos,
         tlen) = struct.unpack_from("<iiBBHHHiiii", blob, off)
        p = off + 32
        qnames.append(bytes(mv[p:p + l_read_name - 1]))
        p += l_read_name
        cig = np.frombuffer(blob, dtype="<u4", count=n_cigar, offset=p)
        p += 4 * n_cigar
        npk = (l_seq + 1) // 2
        packed = np.frombuffer(blob, dtype=np.uint8, count=npk, offset=p)
        seq_ascii = _NIB2[packed].reshape(-1)[:l_seq]
        p += npk
        qual = np.frombuffer(blob, dtype=np.uint8, count=l_seq, offset=p)
        p += l_seq
        xcs.append(_aux_xc(mv[p:end]) if end > p else 0)
        flags.append(flag)
        tids.append(tid)
        poss.append(pos)
        mapqs.append(mapq)
        mtids.append(mtid)
        mposs.append(mpos)
        isizes.append(tlen)
        lqs.append(l_seq)
        cig_parts.append(cig)
        cig_counts.append(n_cigar)
        seq_parts.append(seq_ascii)
        qual_parts.append(qual)
        off = end

    n = len(flags)
    cig_off = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(cig_counts, out=cig_off[1:])
    seq_off = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lqs, out=seq_off[1:])
    return BamRecords(
        ref_names=ref_names, ref_lens=ref_lens, n=n,
        flag=np.asarray(flags, np.int32), tid=np.asarray(tids, np.int32),
        pos=np.asarray(poss, np.int32), mapq=np.asarray(mapqs, np.int32),
        mtid=np.asarray(mtids, np.int32), mpos=np.asarray(mposs, np.int32),
        isize=np.asarray(isizes, np.int32), l_qseq=np.asarray(lqs, np.int32),
        qnames=qnames,
        cig=np.concatenate(cig_parts) if cig_parts else np.zeros(0, np.uint32),
        cig_off=cig_off,
        seq=np.concatenate(seq_parts) if seq_parts else np.zeros(0, np.uint8),
        qual=np.concatenate(qual_parts) if qual_parts else np.zeros(0, np.uint8),
        seq_off=seq_off,
        xc=np.asarray(xcs, np.int32),
    )


class _PyRecordParser:
    """Incremental BAM record parser shared by the whole-file and chunked
    python decoders: accumulates SoA columns, emits BamRecords batches."""

    def __init__(self, ref_names, ref_lens):
        self.ref_names = ref_names
        self.ref_lens = ref_lens
        self.reset()

    def reset(self):
        self.flags = []
        self.tids = []
        self.poss = []
        self.mapqs = []
        self.mtids = []
        self.mposs = []
        self.isizes = []
        self.lqs = []
        self.qnames: List[bytes] = []
        self.cig_parts: List[np.ndarray] = []
        self.cig_counts: List[int] = []
        self.seq_parts: List[np.ndarray] = []
        self.qual_parts: List[np.ndarray] = []
        self.xcs: List[int] = []

    def __len__(self):
        return len(self.flags)

    def parse(self, blob: bytes, off: int, max_records: int) -> int:
        """Parses complete records from blob[off:] until max_records total
        are buffered or bytes run out; returns the new offset."""
        mv = memoryview(blob)
        n_total = len(blob)
        while len(self.flags) < max_records and off + 4 <= n_total:
            (block_size,) = struct.unpack_from("<i", blob, off)
            end = off + 4 + block_size
            if end > n_total:
                break
            off += 4
            (tid, pos, l_read_name, mapq, _bin, n_cigar, flag, l_seq, mtid,
             mpos, tlen) = struct.unpack_from("<iiBBHHHiiii", blob, off)
            p = off + 32
            self.qnames.append(bytes(mv[p:p + l_read_name - 1]))
            p += l_read_name
            cig = np.frombuffer(blob, dtype="<u4", count=n_cigar, offset=p)
            p += 4 * n_cigar
            npk = (l_seq + 1) // 2
            packed = np.frombuffer(blob, dtype=np.uint8, count=npk, offset=p)
            seq_ascii = _NIB2[packed].reshape(-1)[:l_seq]
            p += npk
            qual = np.frombuffer(blob, dtype=np.uint8, count=l_seq, offset=p)
            p += l_seq
            self.xcs.append(_aux_xc(mv[p:end]) if end > p else 0)
            self.flags.append(flag)
            self.tids.append(tid)
            self.poss.append(pos)
            self.mapqs.append(mapq)
            self.mtids.append(mtid)
            self.mposs.append(mpos)
            self.isizes.append(tlen)
            self.lqs.append(l_seq)
            self.cig_parts.append(cig.copy())
            self.cig_counts.append(n_cigar)
            self.seq_parts.append(seq_ascii)
            self.qual_parts.append(qual.copy())
            off = end
        return off

    def emit(self) -> BamRecords:
        n = len(self.flags)
        cig_off = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(self.cig_counts, out=cig_off[1:])
        seq_off = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(self.lqs, out=seq_off[1:])
        recs = BamRecords(
            ref_names=self.ref_names, ref_lens=self.ref_lens, n=n,
            flag=np.asarray(self.flags, np.int32),
            tid=np.asarray(self.tids, np.int32),
            pos=np.asarray(self.poss, np.int32),
            mapq=np.asarray(self.mapqs, np.int32),
            mtid=np.asarray(self.mtids, np.int32),
            mpos=np.asarray(self.mposs, np.int32),
            isize=np.asarray(self.isizes, np.int32),
            l_qseq=np.asarray(self.lqs, np.int32),
            qnames=self.qnames,
            cig=(np.concatenate(self.cig_parts) if self.cig_parts
                 else np.zeros(0, np.uint32)),
            cig_off=cig_off,
            seq=(np.concatenate(self.seq_parts) if self.seq_parts
                 else np.zeros(0, np.uint8)),
            qual=(np.concatenate(self.qual_parts) if self.qual_parts
                  else np.zeros(0, np.uint8)),
            seq_off=seq_off,
            xc=np.asarray(self.xcs, np.int32),
        )
        self.reset()
        return recs


def iter_bam_chunks_python(path: str, chunk_records: int):
    """Pure-python fallback of io.native.iter_bam_chunks_native: streams
    BGZF members through zlib, parses complete records incrementally, and
    yields BamRecords slabs of up to chunk_records records."""
    READ_WINDOW = 4 << 20
    with open(path, "rb") as f:
        d = zlib.decompressobj(wbits=31)
        buf = bytearray()
        pos = 0
        file_eof = False

        def pump() -> bool:
            nonlocal d, file_eof
            raw = f.read(READ_WINDOW)
            if not raw:
                file_eof = True
                return False
            data = raw
            while data:
                buf.extend(d.decompress(data))
                data = d.unused_data
                if not data and d.eof:
                    d = zlib.decompressobj(wbits=31)
                    break
                if data:
                    d = zlib.decompressobj(wbits=31)
            return True

        def have(need: int) -> bool:
            while len(buf) - pos < need and not file_eof:
                pump()
            return len(buf) - pos >= need

        if not have(12) or bytes(buf[pos:pos + 4]) != b"BAM\x01":
            raise ValueError(f"{path}: not a BAM file")
        (l_text,) = struct.unpack_from("<i", buf, pos + 4)
        if not have(12 + l_text):
            raise ValueError(f"{path}: truncated BAM header")
        pos += 8 + l_text
        (n_ref,) = struct.unpack_from("<i", buf, pos)
        pos += 4
        ref_names, ref_lens = [], []
        for _ in range(n_ref):
            if not have(8):
                raise ValueError(f"{path}: truncated BAM header")
            (l_name,) = struct.unpack_from("<i", buf, pos)
            if not have(8 + l_name):
                raise ValueError(f"{path}: truncated BAM header")
            pos += 4
            ref_names.append(bytes(buf[pos:pos + l_name - 1]).decode())
            pos += l_name
            (l_ref,) = struct.unpack_from("<i", buf, pos)
            pos += 4
            ref_lens.append(l_ref)
        del buf[:pos]
        pos = 0

        parser = _PyRecordParser(ref_names, ref_lens)
        while True:
            pos = parser.parse(bytes(buf), pos, chunk_records)
            if len(parser) >= chunk_records:
                del buf[:pos]
                pos = 0
                yield parser.emit()
                continue
            if file_eof or not pump():
                break
        if pos < len(buf):
            raise ValueError(f"{path}: truncated BAM record at EOF")
        if len(parser):
            yield parser.emit()


def read_bam_chunks(path: str, chunk_records: int = 2_000_000,
                    lazy_seq: bool = False):
    """Chunked, bounded-memory BAM decode (native stream reader when
    built, python fallback otherwise): yields BamRecords slabs of up to
    chunk_records records in file order.  This is the framework's
    streaming-ingestion contract — the explicit form of the reference's
    per-chromosome flush memory bound (ref: clip_reads.h:423-446).

    lazy_seq=True (native only; python fallback decodes everything) skips
    base/qual decode for records with no soft clip and both mates mapped —
    safe when consumers only read bases of clipped/unmapped records, which
    is the getclip+stats streaming contract."""
    if path.endswith(".bam"):
        try:
            from . import native
            if native.stream_available():
                yield from native.iter_bam_chunks_native(
                    path, chunk_records, lazy_seq=lazy_seq)
                return
        except ImportError:
            pass
        yield from iter_bam_chunks_python(path, chunk_records)
        return
    # SAM text: no BGZF framing; decode whole then slice (fallback only)
    recs = read_sam_text(path)
    for lo in range(0, max(recs.n, 1), chunk_records):
        hi = min(lo + chunk_records, recs.n)
        if hi > lo:
            yield slice_records(recs, lo, hi)


def slice_records(recs: BamRecords, lo: int, hi: int) -> BamRecords:
    """Contiguous record-range view [lo, hi) of a BamRecords (payload
    blobs sliced to the range; offsets rebased)."""
    co0, co1 = int(recs.cig_off[lo]), int(recs.cig_off[hi])
    so0, so1 = int(recs.seq_off[lo]), int(recs.seq_off[hi])
    return BamRecords(
        ref_names=recs.ref_names, ref_lens=recs.ref_lens, n=hi - lo,
        flag=recs.flag[lo:hi], tid=recs.tid[lo:hi], pos=recs.pos[lo:hi],
        mapq=recs.mapq[lo:hi], mtid=recs.mtid[lo:hi], mpos=recs.mpos[lo:hi],
        isize=recs.isize[lo:hi], l_qseq=recs.l_qseq[lo:hi],
        qnames=[recs.qnames[i] for i in range(lo, hi)],
        cig=recs.cig[co0:co1], cig_off=recs.cig_off[lo:hi + 1] - co0,
        seq=recs.seq[so0:so1], qual=recs.qual[so0:so1],
        seq_off=recs.seq_off[lo:hi + 1] - so0,
        xc=recs.xc[lo:hi], owner=recs.owner,
    )


def concat_records(parts: List[BamRecords]) -> BamRecords:
    """Concatenate record slabs (inverse of read_bam_chunks; offsets
    rebased).  All parts must share the same reference dictionary."""
    if len(parts) == 1:
        return parts[0]
    base = parts[0]

    def cat(attr):
        return np.concatenate([getattr(p, attr) for p in parts])

    def cat_off(attr):
        outs = [np.asarray(getattr(parts[0], attr))]
        for p in parts[1:]:
            outs.append(np.asarray(getattr(p, attr))[1:] + outs[-1][-1])
        return np.concatenate(outs)

    qnames = [bytes(q) for p in parts for q in p.qnames]
    return BamRecords(
        ref_names=base.ref_names, ref_lens=base.ref_lens,
        n=sum(p.n for p in parts),
        flag=cat("flag"), tid=cat("tid"), pos=cat("pos"), mapq=cat("mapq"),
        mtid=cat("mtid"), mpos=cat("mpos"), isize=cat("isize"),
        l_qseq=cat("l_qseq"), qnames=qnames,
        cig=cat("cig"), cig_off=cat_off("cig_off"),
        seq=cat("seq"), qual=cat("qual"), seq_off=cat_off("seq_off"),
        xc=cat("xc"),
    )


def cigar_str_to_ops(cigar: str) -> np.ndarray:
    """'10M2S' -> bam-encoded uint32 ops ('*' -> empty)."""
    if cigar == "*":
        return np.zeros(0, dtype=np.uint32)
    ops = []
    num = 0
    for ch in cigar.encode():
        if 0x30 <= ch <= 0x39:
            num = num * 10 + (ch - 0x30)
        else:
            ops.append((num << 4) | _CHAR2OP[ch])
            num = 0
    return np.asarray(ops, dtype=np.uint32)


def read_sam_text(path: str) -> BamRecords:
    """Parse a SAM text file (used for realigned clip sequences; the
    reference accepts SAM there too, ref: getsv.h:439-443)."""
    if path.endswith(".gz"):
        fh = gzip.open(path, "rt")
    else:
        fh = open(path, "rt")
    ref_names: List[str] = []
    ref_lens: List[int] = []
    name2tid = {}
    flags, tids, poss, mapqs, mtids, mposs, isizes, lqs = ([] for _ in range(8))
    qnames: List[bytes] = []
    cig_parts: List[np.ndarray] = []
    seq_parts: List[np.ndarray] = []
    qual_parts: List[np.ndarray] = []
    xcs: List[int] = []
    with fh:
        for line in fh:
            if line.startswith("@"):
                if line.startswith("@SQ"):
                    nm, ln = None, 0
                    for fld in line.rstrip("\n").split("\t")[1:]:
                        if fld.startswith("SN:"):
                            nm = fld[3:]
                        elif fld.startswith("LN:"):
                            ln = int(fld[3:])
                    if nm is not None:
                        name2tid[nm] = len(ref_names)
                        ref_names.append(nm)
                        ref_lens.append(ln)
                continue
            f = line.rstrip("\n").split("\t")
            qnames.append(f[0].encode())
            flag = int(f[1])
            flags.append(flag)
            tids.append(name2tid.get(f[2], -1))
            poss.append(int(f[3]) - 1)
            mapqs.append(int(f[4]))
            cig_parts.append(cigar_str_to_ops(f[5]))
            mtids.append(tids[-1] if f[6] == "=" else name2tid.get(f[6], -1))
            mposs.append(int(f[7]) - 1)
            isizes.append(int(f[8]))
            seq = f[9]
            if seq == "*":
                seq_arr = np.zeros(0, np.uint8)
                l_seq = 0
            else:
                seq_arr = np.frombuffer(seq.upper().encode(), np.uint8).copy()
                l_seq = len(seq)
            lqs.append(l_seq)
            seq_parts.append(seq_arr)
            if f[10] == "*":
                qual_parts.append(np.full(l_seq, 0xFF, np.uint8))
            else:
                qual_parts.append(
                    np.frombuffer(f[10].encode(), np.uint8) - np.uint8(33))
            xc = 0
            for tag in f[11:]:
                if tag.startswith("XC:i:"):
                    xc = int(tag[5:])
            xcs.append(xc)
    n = len(flags)
    cig_off = np.zeros(n + 1, dtype=np.int64)
    np.cumsum([len(c) for c in cig_parts], out=cig_off[1:])
    seq_off = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lqs, out=seq_off[1:])
    return BamRecords(
        ref_names=ref_names, ref_lens=ref_lens, n=n,
        flag=np.asarray(flags, np.int32), tid=np.asarray(tids, np.int32),
        pos=np.asarray(poss, np.int32), mapq=np.asarray(mapqs, np.int32),
        mtid=np.asarray(mtids, np.int32), mpos=np.asarray(mposs, np.int32),
        isize=np.asarray(isizes, np.int32), l_qseq=np.asarray(lqs, np.int32),
        qnames=qnames,
        cig=np.concatenate(cig_parts) if cig_parts else np.zeros(0, np.uint32),
        cig_off=cig_off,
        seq=np.concatenate(seq_parts) if seq_parts else np.zeros(0, np.uint8),
        qual=np.concatenate(qual_parts) if qual_parts else np.zeros(0, np.uint8),
        seq_off=seq_off,
        xc=np.asarray(xcs, np.int32),
    )


def read_bam(path: str) -> BamRecords:
    """Decode a BAM or SAM file into SoA form (native decoder when built)."""
    if path.endswith(".bam"):
        try:
            from . import native
            if native.available():
                return native.read_bam_native(path)
        except ImportError:
            pass
        return read_bam_python(path)
    return read_sam_text(path)
