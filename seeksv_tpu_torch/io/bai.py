"""BAI (BAM index) reading and region queries.

Completes the L0 samtools-replacement surface (ref: sam/bam_index.c
bam_index_load / bam_iter_query): the binning index + linear index give
the BGZF virtual-offset window for a genomic region, and only the needed
BGZF blocks are inflated.  The calling pipeline itself never uses index
seeks (windowed in-memory gathers replace them, SURVEY.md §2), but the
reader makes the framework a complete BAM toolkit (`seeksv-tpu view`).

Counterpart of seeksv_tpu/io/bai.py.
"""
from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

BAM_MAX_BIN = 37450  # ((1<<18)-1)/7 + 1


@dataclass
class BaiIndex:
    bins: List[Dict[int, List[Tuple[int, int]]]]   # per-ref: bin -> chunks
    linear: List[np.ndarray]                       # per-ref: 16kb intervals

    @classmethod
    def load(cls, path: str) -> "BaiIndex":
        with open(path, "rb") as f:
            data = f.read()
        if data[:4] != b"BAI\x01":
            raise ValueError(f"{path}: not a BAI file")
        off = 4
        (n_ref,) = struct.unpack_from("<i", data, off)
        off += 4
        bins = []
        linear = []
        for _ in range(n_ref):
            (n_bin,) = struct.unpack_from("<i", data, off)
            off += 4
            bmap: Dict[int, List[Tuple[int, int]]] = {}
            for _ in range(n_bin):
                bin_id, n_chunk = struct.unpack_from("<Ii", data, off)
                off += 8
                chunks = []
                for _ in range(n_chunk):
                    beg, end = struct.unpack_from("<QQ", data, off)
                    off += 16
                    chunks.append((beg, end))
                bmap[bin_id] = chunks
            (n_intv,) = struct.unpack_from("<i", data, off)
            off += 4
            ioffs = np.frombuffer(data, "<u8", n_intv, off).copy()
            off += 8 * n_intv
            bins.append(bmap)
            linear.append(ioffs)
        return cls(bins, linear)


def reg2bins(beg: int, end: int) -> List[int]:
    """Bins overlapping [beg, end), 0-based (ref: sam/bam.h reg2bins)."""
    end -= 1
    out = [0]
    for shift, base in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        out.extend(range(base + (beg >> shift), base + (end >> shift) + 1))
    return out


def region_chunks(idx: BaiIndex, tid: int, beg: int, end: int
                  ) -> List[Tuple[int, int]]:
    """Merged virtual-offset chunks overlapping [beg, end), filtered by the
    linear index (bam_iter_query's chunk selection)."""
    if tid < 0 or tid >= len(idx.bins):
        return []
    bmap = idx.bins[tid]
    lin = idx.linear[tid]
    min_off = 0
    w = beg >> 14
    if len(lin):
        min_off = int(lin[min(w, len(lin) - 1)])
    chunks = []
    for b in reg2bins(beg, end):
        for c in bmap.get(b, ()):
            if c[1] > min_off:
                chunks.append(c)
    chunks.sort()
    merged: List[Tuple[int, int]] = []
    for c in chunks:
        if merged and c[0] <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], c[1]))
        else:
            merged.append(c)
    return merged


class BgzfRandomReader:
    """Random access into a BGZF file by virtual offset
    (coffset << 16 | uoffset)."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            self.raw = f.read()
        self._cache: Dict[int, bytes] = {}

    def _block(self, coffset: int) -> Tuple[bytes, int]:
        """Inflate the block at compressed offset; returns (data, next_coffset)."""
        cached = self._cache.get(coffset)
        raw = self.raw
        xlen = struct.unpack_from("<H", raw, coffset + 10)[0]
        p = coffset + 12
        bsize = 0
        xend = p + xlen
        while p + 4 <= xend:
            si1, si2, slen = raw[p], raw[p + 1], struct.unpack_from("<H", raw, p + 2)[0]
            if si1 == 66 and si2 == 67 and slen == 2:
                bsize = struct.unpack_from("<H", raw, p + 4)[0] + 1
            p += 4 + slen
        data_off = xend
        comp = raw[data_off: coffset + bsize - 8]
        if cached is None:
            cached = zlib.decompress(comp, -15)
            self._cache[coffset] = cached
        return cached, coffset + bsize

    def read_range(self, vbeg: int, vend: int) -> bytes:
        """All decompressed bytes from virtual offset vbeg to vend."""
        out = []
        coff, uoff = vbeg >> 16, vbeg & 0xFFFF
        cend, uend = vend >> 16, vend & 0xFFFF
        while True:
            data, nxt = self._block(coff)
            if coff == cend:
                out.append(data[uoff:uend])
                break
            out.append(data[uoff:])
            uoff = 0
            coff = nxt
            if coff >= len(self.raw) - 28:
                break
        return b"".join(out)


def reg2bin(beg: int, end: int) -> int:
    """Smallest bin containing [beg, end), 0-based (ref: sam/bam.h reg2bin)."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def _reg2bin_vec(beg: np.ndarray, end: np.ndarray) -> np.ndarray:
    """Vectorized reg2bin over [beg, end) arrays."""
    e = end - 1
    out = np.zeros(len(beg), np.int64)
    done = np.zeros(len(beg), bool)
    for shift, base in ((14, (1 << 15) - 1), (17, (1 << 12) - 1),
                        (20, (1 << 9) - 1), (23, (1 << 6) - 1),
                        (26, (1 << 3) - 1)):
        hit = ~done & ((beg >> shift) == (e >> shift))
        out[hit] = base // 7 + (beg[hit] >> shift)
        done |= hit
    return out


def _scan_blocks(raw: bytes):
    """BGZF block table: (compressed offsets, decompressed offsets)."""
    import struct as _s
    coffs, outs = [], []
    off = 0
    out_off = 0
    while off + 18 <= len(raw):
        xlen = _s.unpack_from("<H", raw, off + 10)[0]
        p = off + 12
        bsize = 0
        xend = p + xlen
        while p + 4 <= xend:
            si1, si2, slen = raw[p], raw[p + 1], _s.unpack_from("<H", raw, p + 2)[0]
            if si1 == 66 and si2 == 67 and slen == 2:
                bsize = _s.unpack_from("<H", raw, p + 4)[0] + 1
            p += 4 + slen
        isize = _s.unpack_from("<I", raw, off + bsize - 4)[0]
        coffs.append(off)
        outs.append(out_off)
        out_off += isize
        off += bsize
    return np.asarray(coffs, np.int64), np.asarray(outs, np.int64)


def _build_index_vectorized(bam_path: str, out_path: str) -> Optional[str]:
    """Vectorized BAI build over the native decoder's record-offset table
    (byte-identical output to the per-record path, asserted by
    tests/test_bai.py); returns None when the native offsets are
    unavailable (python decode fallback)."""
    import struct as _s

    from . import native

    if not native.available():
        return None
    # lazy decode: the index needs tid/pos/cigars + record offsets only
    # — full seq/qual decode of a 300M-record BAM is ~70 GB it never
    # reads (a 1 Gbp x 30x build OOM'd exactly there)
    recs = native.read_bam_native(bam_path, lazy=True)
    offs = native.rec_offsets(recs)
    if offs is None:
        return None
    rec_off, _body = offs
    with open(bam_path, "rb") as f:
        raw = f.read()
    block_coffs, block_outs = _scan_blocks(raw)

    def voff(g):
        i = np.searchsorted(block_outs, g, "right") - 1
        return (block_coffs[i] << 16) | (g - block_outs[i])

    n_ref = len(recs.ref_names)
    sel = np.nonzero(recs.tid >= 0)[0]
    tid = recs.tid[sel].astype(np.int64)
    pos = recs.pos[sel].astype(np.int64)
    span = recs.ref_span(count_x=True)[sel].astype(np.int64)
    end = pos + np.maximum(span, 1)
    vb = voff(rec_off[:-1][sel])
    ve = voff(rec_off[1:][sel])
    binv = _reg2bin_vec(pos, end)

    bins: List[Dict[int, List[Tuple[int, int]]]] = [dict() for _ in range(n_ref)]
    linear: List[Dict[int, int]] = [dict() for _ in range(n_ref)]

    # chunk lists per (tid, bin), merging file-adjacent records (stable
    # group order = record order, reproducing the sequential pass)
    order = np.lexsort((np.arange(len(sel)), binv, tid))
    t_s, b_s, vb_s, ve_s = tid[order], binv[order], vb[order], ve[order]
    if len(order):
        new_group = np.ones(len(order), bool)
        new_group[1:] = (t_s[1:] != t_s[:-1]) | (b_s[1:] != b_s[:-1])
        new_chunk = new_group.copy()
        new_chunk[1:] |= vb_s[1:] != ve_s[:-1]
        starts = np.nonzero(new_chunk)[0]
        ends = np.append(starts[1:], len(order))
        for s, e in zip(starts, ends):
            bins[int(t_s[s])].setdefault(int(b_s[s]), []).append(
                (int(vb_s[s]), int(ve_s[e - 1])))

    # linear 16kb windows: min vb per window covered
    w_end = (end - 1) >> 14
    for t in range(n_ref):
        m = tid == t
        if not m.any():
            continue
        size = int(w_end[m].max()) + 1
        arr = np.full(size, (1 << 63) - 1, np.int64)
        w = pos[m] >> 14
        we = w_end[m]
        vbm = vb[m]
        k = 0
        while True:
            act = w + k <= we
            if not act.any():
                break
            np.minimum.at(arr, (w + k)[act], vbm[act])
            k += 1
        lt = linear[t]
        for wi in np.nonzero(arr != (1 << 63) - 1)[0]:
            lt[int(wi)] = int(arr[wi])

    _write_bai(out_path, n_ref, bins, linear)
    return out_path


def _write_bai(out_path, n_ref, bins, linear) -> None:
    import struct as _s
    with open(out_path, "wb") as f:
        f.write(b"BAI\x01" + _s.pack("<i", n_ref))
        for t in range(n_ref):
            f.write(_s.pack("<i", len(bins[t])))
            for b, chunks in sorted(bins[t].items()):
                f.write(_s.pack("<Ii", b, len(chunks)))
                for beg, end in chunks:
                    f.write(_s.pack("<QQ", beg, end))
            n_intv = max(linear[t]) + 1 if linear[t] else 0
            f.write(_s.pack("<i", n_intv))
            run = 0
            for w in range(n_intv):
                if w in linear[t]:
                    run = linear[t][w]
                f.write(_s.pack("<Q", run))


def build_index(bam_path: str, out_path: Optional[str] = None) -> str:
    """Build a .bai for a BAM (the `samtools index` role).  Walks the BGZF
    blocks to map global uncompressed offsets -> virtual offsets, then one
    record pass fills bins + 16kb linear windows.  Uses the vectorized
    native-offset path when available; the per-record fallback below is
    the semantic reference."""
    import struct as _s

    out_path = out_path or bam_path + ".bai"
    if bam_path.endswith(".bam"):
        r = _build_index_vectorized(bam_path, out_path)
        if r is not None:
            return r
    with open(bam_path, "rb") as f:
        raw = f.read()
    # block table: (header_coffset, out_off, out_len)
    blocks = []
    off = 0
    out_off = 0
    while off + 18 <= len(raw):
        xlen = _s.unpack_from("<H", raw, off + 10)[0]
        p = off + 12
        bsize = 0
        xend = p + xlen
        while p + 4 <= xend:
            si1, si2, slen = raw[p], raw[p + 1], _s.unpack_from("<H", raw, p + 2)[0]
            if si1 == 66 and si2 == 67 and slen == 2:
                bsize = _s.unpack_from("<H", raw, p + 4)[0] + 1
            p += 4 + slen
        isize = _s.unpack_from("<I", raw, off + bsize - 4)[0]
        blocks.append((off, out_off, isize))
        out_off += isize
        off += bsize
    block_coffs = np.asarray([b[0] for b in blocks], np.int64)
    block_outs = np.asarray([b[1] for b in blocks], np.int64)

    def voffset(g: int) -> int:
        i = int(np.searchsorted(block_outs, g, "right")) - 1
        return (int(block_coffs[i]) << 16) | (g - int(block_outs[i]))

    from .bam import decode_bgzf
    blob = decode_bgzf(bam_path)
    (l_text,) = _s.unpack_from("<i", blob, 4)
    p = 8 + l_text
    (n_ref,) = _s.unpack_from("<i", blob, p)
    p += 4
    for _ in range(n_ref):
        (ln,) = _s.unpack_from("<i", blob, p)
        p += 8 + ln
    bins: List[Dict[int, List[Tuple[int, int]]]] = [dict() for _ in range(n_ref)]
    linear: List[Dict[int, int]] = [dict() for _ in range(n_ref)]
    while p + 4 <= len(blob):
        (bs,) = _s.unpack_from("<i", blob, p)
        rec_end_g = p + 4 + bs
        if rec_end_g > len(blob):
            break
        tid, pos = _s.unpack_from("<ii", blob, p + 4)
        (nc,) = _s.unpack_from("<H", blob, p + 16)
        lrn = blob[p + 12]
        if tid >= 0:
            cig = np.frombuffer(blob, "<u4", nc, p + 36 + lrn)
            ops = cig & 0xF
            span = int(((cig >> 4) * (((ops == 0) | (ops == 2) | (ops == 3)
                                       | (ops == 7) | (ops == 8)))).sum())
            end = pos + max(span, 1)
            vb, ve = voffset(p), voffset(rec_end_g)
            b = reg2bin(pos, end)
            ch = bins[tid].setdefault(b, [])
            if ch and ch[-1][1] == vb:
                ch[-1] = (ch[-1][0], ve)
            else:
                ch.append((vb, ve))
            for w in range(pos >> 14, ((end - 1) >> 14) + 1):
                if w not in linear[tid] or vb < linear[tid][w]:
                    linear[tid][w] = vb
        p = rec_end_g
    with open(out_path, "wb") as f:
        f.write(b"BAI\x01" + _s.pack("<i", n_ref))
        for t in range(n_ref):
            f.write(_s.pack("<i", len(bins[t])))
            for b, chunks in sorted(bins[t].items()):
                f.write(_s.pack("<Ii", b, len(chunks)))
                for beg, end in chunks:
                    f.write(_s.pack("<QQ", beg, end))
            n_intv = max(linear[t]) + 1 if linear[t] else 0
            f.write(_s.pack("<i", n_intv))
            run = 0
            for w in range(n_intv):
                if w in linear[t]:
                    run = linear[t][w]
                f.write(_s.pack("<Q", run))
    return out_path


def view_region(bam_path: str, chrom: str, beg1: int, end1: int,
                bai_path: Optional[str] = None):
    """Yield record dicts overlapping chrom:[beg1, end1] (1-based closed),
    via the BAI index — the `samtools view region` / bam_iter_query role."""
    from .bam import CIGAR_CHARS, SEQ_NT16

    idx = BaiIndex.load(bai_path or bam_path + ".bai")
    rdr = BgzfRandomReader(bam_path)
    # header for tids
    hdr = rdr._block(0)[0]
    (l_text,) = struct.unpack_from("<i", hdr, 4)
    # parse refs from a full decode of the header area only
    off = 8 + l_text
    while off + 4 > len(hdr):  # header spans blocks (rare for small headers)
        nxt_data, _ = rdr._block(rdr._block(0)[1])
        hdr = hdr + nxt_data
    (n_ref,) = struct.unpack_from("<i", hdr, off)
    off += 4
    names = []
    for _ in range(n_ref):
        (ln,) = struct.unpack_from("<i", hdr, off)
        off += 4
        names.append(hdr[off:off + ln - 1].decode())
        off += ln + 4
    if chrom not in names:
        return
    tid = names.index(chrom)
    beg0, end0 = beg1 - 1, end1
    nt = np.frombuffer(SEQ_NT16, np.uint8)
    for vbeg, vend in region_chunks(idx, tid, beg0, end0):
        blob = rdr.read_range(vbeg, vend)
        p = 0
        while p + 4 <= len(blob):
            (bs,) = struct.unpack_from("<i", blob, p)
            if p + 4 + bs > len(blob):
                break
            (rtid, pos, lrn, mapq, _bin, nc, flag, lseq, mtid, mpos,
             tl) = struct.unpack_from("<iiBBHHHiiii", blob, p + 4)
            q = p + 36
            if rtid == tid and pos < end0:
                qname = blob[q:q + lrn - 1]
                cig = np.frombuffer(blob, "<u4", nc, q + lrn)
                span = int(sum((int(c) >> 4) for c in cig
                               if (int(c) & 0xF) in (0, 2, 3, 7, 8)))
                if pos + max(span, 1) > beg0:
                    sp = q + lrn + 4 * nc
                    packed = np.frombuffer(blob, np.uint8, (lseq + 1) // 2, sp)
                    seq = bytes(nt[(packed[i // 2] >> (4 if i % 2 == 0 else 0))
                                   & 0xF] for i in range(lseq))
                    cigar = "".join(f"{int(c) >> 4}{chr(CIGAR_CHARS[int(c) & 0xF])}"
                                    for c in cig) or "*"
                    yield {"qname": qname.decode(), "flag": flag, "tid": rtid,
                           "pos": pos, "mapq": mapq, "cigar": cigar,
                           "seq": seq.decode()}
            p += 4 + bs
