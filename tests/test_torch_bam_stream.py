"""The port's streamed BAM decoder (seeksv_tpu_torch/csrc/bam_stream.cpp,
io/native.iter_bam_chunks_native) against the reference's streamed reader
in the same shared library (csrc/seeksv_native.cpp: seeksv_bam_next, and
seeksv_bam_next2 with lazy seq): the same slab boundaries, every column
byte for byte where the reference writes it, the same error messages;
and a slab's buffer set is never written while a view of it lives."""
import ctypes
import dataclasses
import gzip
import itertools
import os
import struct
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from seeksv_tpu_torch.io import native
from seeksv_tpu_torch.io.bam import (CIGAR_SUMMARY, cigar_str_to_ops,
                                     iter_bam_chunks_python)
from seeksv_tpu_torch.io.bam_writer import BgzfWriter
from seeksv_tpu_torch.utils import trace

# several test workers share few cores: one intra-op thread each
torch.set_num_threads(1)

WINDOW = 16 << 20       # the decoders' compressed bytes a read
COLS = ("flag", "tid", "pos", "mapq", "mtid", "mpos", "isize", "l_qseq",
        "xc", "cig", "cig_off", "seq_off")


def _reference_chunks(path, chunk, lazy):
    """The reference's streamed reader, as the port called it before it
    had its own."""
    lib = native._load()
    err = ctypes.create_string_buffer(256)
    s = lib.seeksv_bam_open(path.encode(), 0, err)
    if not s:
        raise IOError(f"{path}: {err.value.decode()}")
    try:
        while True:
            h = (lib.seeksv_bam_next2(s, chunk, 1) if lazy
                 else lib.seeksv_bam_next(s, chunk))
            recs = native._soa_to_records(h, path, lib.seeksv_bam_free)
            if recs.n == 0:
                break
            yield recs
    finally:
        lib.seeksv_bam_close(s)


def _header(n_ref=3):
    text = b"@HD\tVN:1.6\tSO:coordinate\n" + b"".join(
        b"@SQ\tSN:c%d\tLN:%d\n" % (i, 1000 + i) for i in range(n_ref))
    out = b"BAM\x01" + struct.pack("<i", len(text)) + text
    out += struct.pack("<i", n_ref)
    for i in range(n_ref):
        name = b"c%d\x00" % i
        out += struct.pack("<i", len(name)) + name + struct.pack("<i", 1000 + i)
    return out


_FLAGS = (0, 16, 0x1 | 0x2 | 0x20, 0x4, 0x1 | 0x8, 0x1 | 0x4 | 0x8, 0x400,
          0x1 | 0x40 | 0x10)
_TAGS = (b"", b"XCi" + struct.pack("<i", -7), b"XCC\x05",
         b"ZZZhello\x00XCs" + struct.pack("<h", 300),
         b"NMi" + struct.pack("<i", 3),
         b"BBBc" + struct.pack("<i", 3) + b"\x01\x02\x03XCc\xfe",
         b"XAA!")


def _record(rng, pool, l_seq=None):
    """One BAM record with random fields, cigar ends (soft and hard clips)
    and aux tags (XC of every integer type among others); its seq and qual
    bytes come from the random pool."""
    if l_seq is None:
        l_seq = int(rng.integers(0, 300))
    qname = bytes(rng.integers(65, 91, int(rng.integers(1, 40)),
                               dtype=np.uint8))
    ops = [int(rng.choice((0, 1, 2, 4, 5)))
           for _ in range(int(rng.integers(0, 5)))]
    cig = b"".join(struct.pack("<I", (int(rng.integers(1, 200)) << 4) | op)
                   for op in ops)
    flag = int(rng.choice(_FLAGS))
    n_seq = (l_seq + 1) // 2 + l_seq
    at = int(rng.integers(0, len(pool) - n_seq))
    body = struct.pack("<iiBBHHHiiii", int(rng.integers(-1, 3)),
                       int(rng.integers(-1, 1 << 30)), len(qname) + 1,
                       int(rng.integers(0, 256)), 0, len(ops), flag, l_seq,
                       int(rng.integers(-1, 3)),
                       int(rng.integers(-1, 1 << 30)),
                       int(rng.integers(-1000, 1000)))
    body += qname + b"\x00" + cig + pool[at:at + n_seq]
    body += _TAGS[int(rng.integers(0, len(_TAGS)))]
    return struct.pack("<i", len(body)) + body


def _write_bam(path, rng, n, huge_at=None, level=1):
    """n random records (and, at index huge_at, one whose 24 M bases
    straddle more than one compressed window), BGZF at `level`."""
    pool = rng.integers(0, 256, 1 << 20, dtype=np.uint8).tobytes()
    w = BgzfWriter(str(path), level=level)
    w.write(_header())
    for i in range(n):
        if i == huge_at:
            big = rng.integers(0, 256, 36 << 20, dtype=np.uint8).tobytes()
            rec = bytearray(_record(rng, pool, l_seq=0))
            # the same record with 24 M bases, a soft clip first
            head = struct.unpack_from("<iiBBHHHiiii", rec, 4)
            name = bytes(rec[36:36 + head[2]])
            body = struct.pack("<iiBBHHHiiii", *head[:5], 1, 0, 24 << 20,
                               *head[8:])
            body += name + struct.pack("<I", (5 << 4) | 4) + big
            w.write(struct.pack("<i", len(body)) + body)
        w.write(_record(rng, pool))
    w.close()
    return str(path)


# one record of each CIGAR shape: none (unmapped), H at either end and at
# both, S at both ends, =, X (at an end too), N, D, I and P
_SHAPES = ("*", "5H95M", "95M5H", "3H94M3H", "10S80M10S", "50=1X49=",
           "2X98M", "98M2X", "40M1000N60M", "50M2D50M", "40M5I55M",
           "40M2P5I55M", "7S3X20=4D1I30M2N35=5S", "100M", "1M")


def _shapes_bam(path, rng, n):
    """n records cycling through _SHAPES, with random lengths scaled into
    each op, flags and tags."""
    pool = rng.integers(0, 256, 1 << 16, dtype=np.uint8).tobytes()
    w = BgzfWriter(str(path), level=1)
    w.write(_header())
    for i in range(n):
        ops = cigar_str_to_ops(_SHAPES[i % len(_SHAPES)])
        scale = int(rng.integers(1, 4))
        ops = ((ops >> 4) * scale << 4) | (ops & 0xF)
        cig = ops.astype("<u4").tobytes()
        flag = 0x4 if not len(ops) else int(rng.choice(_FLAGS[:3]))
        l_seq = int(rng.integers(0, 120))
        n_seq = (l_seq + 1) // 2 + l_seq
        name = b"r%d" % i
        body = struct.pack("<iiBBHHHiiii", 0, i, len(name) + 1, 60, 0,
                           len(ops), flag, l_seq, 0, i + 300, 400)
        body += name + b"\x00" + cig + pool[:n_seq]
        body += _TAGS[i % len(_TAGS)]
        w.write(struct.pack("<i", len(body)) + body)
    w.close()
    return str(path)


@pytest.fixture(scope="module")
def bams(tmp_path_factory):
    from torch_inputs import single_chrom_dataset
    root = tmp_path_factory.mktemp("bam_stream")
    rng = np.random.default_rng(20261018)
    out = {"small": _write_bam(root / "small.bam", rng, 1_500),
           "big": _write_bam(root / "big.bam", rng, 60_000, huge_at=31_000),
           "shapes": _shapes_bam(root / "shapes.bam", rng, 2_000)}
    out["sim"], _fa = single_chrom_dataset(root, False)
    assert os.path.getsize(out["big"]) > 3 * WINDOW
    return out


def _need_seq(recs):
    """The rows lazy mode fills: unmapped or mate unmapped, or a soft clip
    at either cigar end (fill_records)."""
    need = (recs.flag & 0xC) != 0
    has = recs.cig_off[1:] > recs.cig_off[:-1]
    idx = np.nonzero(has)[0]
    first = recs.cig[recs.cig_off[idx]] & 0xF
    last = recs.cig[recs.cig_off[idx + 1] - 1] & 0xF
    need[idx] |= (first == 4) | (last == 4)
    return need


def _written(blob, off, rows):
    """The bytes of the rows that were written, in order."""
    lens = np.diff(off)
    return np.asarray(blob)[np.repeat(rows, lens)]


def _assert_same(a, b, lazy):
    assert a.n == b.n
    assert (a.ref_names, a.ref_lens) == (b.ref_names, b.ref_lens)
    for k in COLS:
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k), k)
    np.testing.assert_array_equal(a.qnames.off, b.qnames.off)
    every = np.ones(a.n, bool)
    rows_q = (a.flag & 0xC) != 0 if lazy else every
    rows_s = _need_seq(a) if lazy else every
    assert _written(a.qnames.blob, a.qnames.off, rows_q).tobytes() == \
        _written(b.qnames.blob, b.qnames.off, rows_q).tobytes()
    for k in ("seq", "qual"):
        assert _written(getattr(a, k), a.seq_off, rows_s).tobytes() == \
            _written(getattr(b, k), b.seq_off, rows_s).tobytes(), k


@pytest.mark.parametrize("lazy", [False, True])
@pytest.mark.parametrize("bam, chunk, n_threads", [
    ("small", 1, 0), ("small", 7, 0),
    ("small", 10 ** 9, 0),          # fewer records than one slab
    ("sim", 7_001, 0), ("sim", 10 ** 9, 3),
    ("big", 7_001, 0), ("big", 7_001, 1), ("big", 10 ** 9, 2)])
def test_slabs_match_the_reference(bams, bam, chunk, n_threads, lazy):
    """Every slab of the port's decoder equals the reference's: the same
    boundaries, every column where the reference writes it, with slabs
    of one record, of 7, of more than the file; on random records that
    straddle BGZF blocks and compressed windows (one record spans more
    than a window), and on a simulated BAM."""
    path = bams[bam]
    want = _reference_chunks(path, chunk, lazy)
    got = native.iter_bam_chunks_native(path, chunk, n_threads=n_threads,
                                        lazy_seq=lazy)
    n = 0
    for a, b in itertools.zip_longest(got, want):
        assert a is not None and b is not None, n
        _assert_same(a, b, lazy)
        n += 1
    assert n >= 1


def _plain_summary(recs):
    """The numpy forms of the CIGAR summary, on records without a memo."""
    plain = dataclasses.replace(recs, _memo=None)
    assert not plain.summarised()
    return {col: plain.ref_span(key[1]) if isinstance(key, tuple)
            else getattr(plain, key)() for col, key in CIGAR_SUMMARY.items()}


@pytest.mark.parametrize("lazy", [False, True])
@pytest.mark.parametrize("bam, chunk, n_threads", [
    ("shapes", 1, 1), ("shapes", 7, 0), ("shapes", 10 ** 9, 3),
    ("small", 7, 1), ("small", 10 ** 9, 0), ("sim", 7_001, 3),
    ("big", 7_001, 0)])
def test_cigar_summary_matches_the_numpy_forms(bams, bam, chunk, n_threads,
                                               lazy):
    """Every slab of the port's decoder carries its records' CIGAR
    summary, and each helper returns the decoder's column: first_op,
    last_op, first_len, last_len, ref_span without and with X equal to
    the numpy forms on the reference's slabs, which carry none; on every
    CIGAR shape (none, H, S, =, X, N, D, I, P), on random records, on
    slabs that cut the stream at every record, at one and several
    threads."""
    path = bams[bam]
    got = native.iter_bam_chunks_native(path, chunk, n_threads=n_threads,
                                        lazy_seq=lazy)
    want = _reference_chunks(path, chunk, lazy)
    n = 0
    for a, b in itertools.zip_longest(got, want):
        assert a is not None and b is not None, n
        assert a.summarised() and not b.summarised()
        plain = _plain_summary(b)
        assert a.first_op() is a._memo["first_op"]
        assert a.ref_span(count_x=True) is a._memo[("ref_span", True)]
        for col, key in CIGAR_SUMMARY.items():
            got_col = a._memo[key]
            assert got_col.dtype == np.int32 and got_col.base is not None
            np.testing.assert_array_equal(got_col, plain[col], col)
        n += a.n
    assert n >= 1_500


def test_other_decoders_carry_no_cigar_summary(bams):
    """The whole-file decoder and the Python one give no summary: their
    helpers compute the numpy forms, equal to the streamed slab's."""
    path = bams["shapes"]
    (streamed,) = native.iter_bam_chunks_native(path, 10 ** 9)
    (python,) = iter_bam_chunks_python(path, 10 ** 9)
    whole = native.read_bam_native(path)
    for recs in (python, whole):
        assert not recs.summarised()
        for col, v in _plain_summary(recs).items():
            np.testing.assert_array_equal(
                v, streamed._memo[CIGAR_SUMMARY[col]], col)
    assert np.any(streamed.first_op() == -1)
    assert np.any(streamed.ref_span(False) != streamed.ref_span(True))


def _truncated_block(src, dst):
    data = open(src, "rb").read()
    open(dst, "wb").write(data[:len(data) * 3 // 5])


def _truncated_record(src, dst):
    """Cut at a BGZF block boundary inside the records: the framing is
    sound and the last record is incomplete."""
    data = open(src, "rb").read()
    off, cut = 0, len(data) * 3 // 5
    while True:
        bsize = struct.unpack_from("<H", data, off + 16)[0] + 1
        if off + bsize > cut:
            break
        off += bsize
    open(dst, "wb").write(data[:off])


def _garbage_after_window(src, dst):
    """A block boundary past the first window followed by bytes that are
    not a BGZF header."""
    data = open(src, "rb").read()
    off = 0
    while off < WINDOW + 100_000:
        off += struct.unpack_from("<H", data, off + 16)[0] + 1
    open(dst, "wb").write(data[:off] + b"\x00" * 64 + data[off:])


def _corrupt_record(src, dst):
    """A record whose block_size is below the 32 bytes of its core."""
    w = BgzfWriter(dst, level=1)
    w.write(_header())
    rng = np.random.default_rng(5)
    pool = rng.integers(0, 256, 1 << 16, dtype=np.uint8).tobytes()
    for _ in range(50):
        w.write(_record(rng, pool))
    w.write(struct.pack("<i", 20) + b"\x00" * 20)
    w.close()


@pytest.mark.parametrize("case", [
    "truncated_block", "truncated_record", "garbage_after_window",
    "corrupt_record", "plain_gzip", "short_file", "empty_file", "missing"])
def test_bad_input_gives_the_reference_messages(bams, tmp_path, case):
    """A truncated BAM, a non-BGZF file and a corrupt record: the same
    slabs before the error, then the same message."""
    dst = str(tmp_path / f"{case}.bam")
    if case == "truncated_block":
        _truncated_block(bams["big"], dst)
    elif case == "truncated_record":
        _truncated_record(bams["big"], dst)
    elif case == "garbage_after_window":
        _garbage_after_window(bams["big"], dst)
    elif case == "corrupt_record":
        _corrupt_record(bams["small"], dst)
    elif case == "plain_gzip":
        open(dst, "wb").write(gzip.compress(open(bams["small"], "rb")
                                            .read()[:5000]))
    elif case == "short_file":
        open(dst, "wb").write(b"\x1f\x8b\x08\x04" + b"\x00" * 8)
    elif case == "empty_file":
        open(dst, "wb").close()

    def run(chunks):
        slabs = []
        with pytest.raises(IOError) as ei:
            for recs in chunks:
                slabs.append(recs)
        return slabs, str(ei.value)

    got, got_msg = run(native.iter_bam_chunks_native(dst, 7_001,
                                                     lazy_seq=True))
    want, want_msg = run(_reference_chunks(dst, 7_001, True))
    assert got_msg == want_msg
    assert len(got) == len(want)
    for a, b in zip(got, want):
        _assert_same(a, b, True)


def test_held_slabs_are_never_overwritten(bams):
    """Slab k held (and a bare column of slab k + 1) while slabs k + 1 to
    k + 4 are drawn: their bytes stay as they arrived.  Every slab's set
    is a recycled one or a fresh one: scan.slabs_recycled plus the fresh
    sets (distinct handles) is scan.slabs."""
    fields = ("flag", "pos", "cig", "seq", "qual", "seq_off")
    handles, n_slabs = set(), 0
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.driver_pass():
            chunks = native.iter_bam_chunks_native(bams["sim"], 3_000,
                                                   lazy_seq=False)
            held, snap, bare, bare_snap, since = None, None, None, None, 0
            for recs in chunks:
                n_slabs += 1
                handles.add(ctypes.addressof(recs.owner.handle.contents))
                if held is None and n_slabs == 3:
                    held = recs
                    snap = {k: np.array(getattr(recs, k)) for k in fields}
                elif held is not None and bare is None:
                    bare, bare_snap = recs.seq, np.array(recs.seq)
                elif held is not None:
                    since += 1
                    if since == 3:
                        for k in fields:
                            np.testing.assert_array_equal(
                                getattr(held, k), snap[k], k)
                        np.testing.assert_array_equal(bare, bare_snap)
                        held = bare = None
                del recs
    assert n_slabs >= 8 and since >= 3
    counts = trace.last().counts
    assert counts["scan.slabs"] == n_slabs
    assert counts["scan.slabs_recycled"] + len(handles) == n_slabs
    # two slabs held, the one the consumer has, the one being decoded
    assert len(handles) <= 4
    assert 0 <= counts["scan.windows_ready"] <= counts["scan.windows"]
    assert counts["scan.windows"] >= 1


def test_a_view_outlives_the_stream(bams):
    """A column kept after its slab and its stream are gone still reads
    its bytes: the set is freed only with its last view."""
    chunks = native.iter_bam_chunks_native(bams["small"], 500)
    first = next(chunks)
    seq, want = first.seq, np.array(first.seq)
    del first
    for _ in chunks:
        pass
    np.testing.assert_array_equal(seq, want)
    assert seq.base is not None


class _Fail:
    """A scan_bam consumer that raises at slab `fail_at`."""

    def __init__(self, fail_at=None):
        self.n, self.fail_at = 0, fail_at

    def process(self, recs):
        self.n += 1
        if self.n == self.fail_at:
            raise ValueError("consumer failed")


@pytest.mark.parametrize("fail_at", [None, 3])
def test_scan_bam_keeps_two_slabs(bams, fail_at):
    """scan_bam's decode thread starts a slab only once the consumers
    dropped the one before the last, so the decoder fills every slab
    after the first two into a set handed back; a consumer that raises
    stops the scan, and the thread ends."""
    from seeksv_tpu_torch.pipeline.stream import scan_bam
    cons = _Fail(fail_at)
    result = {}

    def run():
        with profile(activities=[ProfilerActivity.CPU]), \
                trace.driver_pass():
            try:
                scan_bam(bams["sim"], 3_000, [cons])
            except ValueError as e:
                result["error"] = str(e)
    before = threading.active_count()
    th = threading.Thread(target=run)
    th.start()
    th.join(timeout=120)
    assert not th.is_alive()
    assert threading.active_count() == before
    if fail_at is None:
        assert "error" not in result
        counts = trace.last().counts
        assert counts["scan.slabs"] == cons.n >= 8
        assert counts["scan.slabs"] - counts["scan.slabs_recycled"] == 2
    else:
        assert result["error"] == "consumer failed" and cons.n == fail_at
