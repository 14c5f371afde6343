"""BGZF/BAM writing (used by the simulator and format converters).

The reference never writes BAM (it reads via libbam and writes text); the
framework includes a writer so synthetic datasets and converted outputs are
self-contained.

Counterpart of seeksv_tpu/io/bam_writer.py.
"""
from __future__ import annotations

import struct
import zlib
from typing import List, Optional, Sequence, Tuple

import numpy as np

_NT16_CODE = np.full(256, 15, np.uint8)
for _i, _c in enumerate(b"=ACMGRSVTWYHKDBN"):
    _NT16_CODE[_c] = _i
    if 97 <= _c + 32 <= 122:
        pass
for _c, _i in ((b"a", 1), (b"c", 2), (b"g", 4), (b"t", 8), (b"n", 15)):
    _NT16_CODE[_c[0]] = _i

_CHAR2OP = {c: i for i, c in enumerate(b"MIDNSHP=X")}

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")


def _bgzf_block(data: bytes, level: int = 6) -> bytes:
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    comp = co.compress(data) + co.flush()
    bsize = len(comp) + 25 + 1
    header = (b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
              + struct.pack("<H", 6) + b"BC" + struct.pack("<HH", 2, bsize - 1))
    footer = struct.pack("<II", zlib.crc32(data) & 0xFFFFFFFF, len(data))
    return header + comp + footer


class BgzfWriter:
    def __init__(self, path: str, level: int = 6):
        self.f = open(path, "wb")
        self.buf = bytearray()
        self.level = level
        from . import native
        self._native = native if native.available() else None

    def write(self, data: bytes):
        # large writes are sliced from a moving offset (no quadratic
        # front-deletion on the buffer)
        buf = self.buf
        buf += data
        if len(buf) < 60000:
            return
        n_full = (len(buf) // 60000) * 60000
        mv = memoryview(buf)
        if self._native is not None:
            self.f.write(self._native.bgzf_compress(mv[:n_full], self.level))
        else:
            off = 0
            while off < n_full:
                self.f.write(_bgzf_block(bytes(mv[off:off + 60000]),
                                         self.level))
                off += 60000
        del mv
        del buf[:n_full]

    def close(self):
        if self.buf:
            self.f.write(_bgzf_block(bytes(self.buf), self.level))
        self.f.write(BGZF_EOF)
        self.f.close()


def encode_record(tid: int, pos: int, qname: bytes, flag: int, mapq: int,
                  cigar: Sequence[Tuple[int, str]], seq: bytes,
                  qual: Optional[bytes], mtid: int, mpos: int,
                  isize: int, tags: bytes = b"") -> bytes:
    n_cigar = len(cigar)
    l_seq = len(seq)
    l_read_name = len(qname) + 1
    # bin: unused by our readers; write 0
    core = struct.pack("<iiBBHHHiiii", tid, pos, l_read_name, mapq, 0,
                       n_cigar, flag, l_seq, mtid, mpos, isize)
    cig = b"".join(struct.pack("<I", (ln << 4) | _CHAR2OP[op.encode()[0]])
                   for ln, op in cigar)
    codes = _NT16_CODE[np.frombuffer(seq, np.uint8)]
    packed = np.zeros((l_seq + 1) // 2, np.uint8)
    packed |= codes[0::2] << 4
    if l_seq > 1:
        packed[: l_seq // 2] |= codes[1::2]
    if qual is None:
        q = np.full(l_seq, 0xFF, np.uint8)
    else:
        q = np.frombuffer(qual, np.uint8) - np.uint8(33)
    body = (core + qname + b"\x00" + cig + packed.tobytes() + q.tobytes()
            + tags)
    return struct.pack("<i", len(body)) + body


class BamWriter:
    def __init__(self, path: str, ref_names: List[str], ref_lens: List[int],
                 level: int = 6):
        self.w = BgzfWriter(path, level=level)
        text = "".join(f"@SQ\tSN:{n}\tLN:{l}\n"
                       for n, l in zip(ref_names, ref_lens)).encode()
        hdr = b"BAM\x01" + struct.pack("<i", len(text)) + text
        hdr += struct.pack("<i", len(ref_names))
        for n, l in zip(ref_names, ref_lens):
            nb = n.encode() + b"\x00"
            hdr += struct.pack("<i", len(nb)) + nb + struct.pack("<i", l)
        self.w.write(hdr)

    def write_record(self, *args, **kwargs):
        self.w.write(encode_record(*args, **kwargs))

    def close(self):
        self.w.close()
