"""ctypes bindings for the native host runtime (csrc/seeksv_native.cpp,
and the port's streamed BAM decoder seeksv_tpu_torch/csrc/bam_stream.cpp).

Counterpart of seeksv_tpu/io/native.py.  The library is built at first use
by ``_build.build_native`` into ``build/seeksv_tpu_torch/native/<hash>/``
and loaded from there; where it cannot be built (no compiler, no source)
the pure-python decoder in io/bam.py and the numpy kernels are used
instead (identical contract, asserted by tests/test_torch_host_parity.py).
On a CUDA device the port's entry points raise rather than run without it.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

from .bam import CIGAR_SUMMARY

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


class _BamSoA(ctypes.Structure):
    _fields_ = [
        ("n", ctypes.c_int64),
        ("flag", ctypes.POINTER(ctypes.c_int32)),
        ("tid", ctypes.POINTER(ctypes.c_int32)),
        ("pos", ctypes.POINTER(ctypes.c_int32)),
        ("mapq", ctypes.POINTER(ctypes.c_int32)),
        ("mtid", ctypes.POINTER(ctypes.c_int32)),
        ("mpos", ctypes.POINTER(ctypes.c_int32)),
        ("isize", ctypes.POINTER(ctypes.c_int32)),
        ("l_qseq", ctypes.POINTER(ctypes.c_int32)),
        ("xc", ctypes.POINTER(ctypes.c_int32)),
        ("cig_off", ctypes.POINTER(ctypes.c_int64)),
        ("cig", ctypes.POINTER(ctypes.c_uint32)),
        ("n_cig_total", ctypes.c_int64),
        ("seq_off", ctypes.POINTER(ctypes.c_int64)),
        ("seq", ctypes.POINTER(ctypes.c_uint8)),
        ("qual", ctypes.POINTER(ctypes.c_uint8)),
        ("n_seq_total", ctypes.c_int64),
        ("qname_off", ctypes.POINTER(ctypes.c_int64)),
        ("qnames", ctypes.POINTER(ctypes.c_uint8)),
        ("n_qname_total", ctypes.c_int64),
        ("n_refs", ctypes.c_int32),
        ("ref_lens", ctypes.POINTER(ctypes.c_int32)),
        ("ref_names", ctypes.POINTER(ctypes.c_uint8)),
        ("ref_names_len", ctypes.c_int64),
        ("rec_off", ctypes.POINTER(ctypes.c_int64)),
        ("body_off", ctypes.c_int64),
        ("error", ctypes.c_char * 256),
    ]


class _TorchSoA(_BamSoA):
    """A slab of the port's streamed decoder (csrc/bam_stream.cpp SoA):
    _BamSoA's layout, then each record's CIGAR summary, int32 columns in
    the C struct's order (io/bam.CIGAR_SUMMARY maps each to the memo key
    of the BamRecords helper it stands for)."""
    _fields_ = [
        ("first_op", ctypes.POINTER(ctypes.c_int32)),
        ("last_op", ctypes.POINTER(ctypes.c_int32)),
        ("first_len", ctypes.POINTER(ctypes.c_int32)),
        ("last_len", ctypes.POINTER(ctypes.c_int32)),
        ("span_nox", ctypes.POINTER(ctypes.c_int32)),
        ("span_x", ctypes.POINTER(ctypes.c_int32)),
    ]


# why the library is absent, when it is (the build's error)
LOAD_ERROR: Optional[str] = None


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED, LOAD_ERROR
    if _TRIED:
        return _LIB
    _TRIED = True
    from .._build import build_native
    try:
        cands = (build_native(),)
    except (RuntimeError, OSError, subprocess.SubprocessError) as exc:
        LOAD_ERROR = str(exc)
        cands = ()
    for cand in cands:
        if os.path.exists(cand):
            try:
                lib = ctypes.CDLL(cand)
                lib.seeksv_bam_decode.restype = ctypes.POINTER(_BamSoA)
                lib.seeksv_bam_decode.argtypes = [ctypes.c_char_p,
                                                  ctypes.c_int]
                if hasattr(lib, "seeksv_bam_decode_flags"):
                    lib.seeksv_bam_decode_flags.restype = \
                        ctypes.POINTER(_BamSoA)
                    lib.seeksv_bam_decode_flags.argtypes = [
                        ctypes.c_char_p, ctypes.c_int, ctypes.c_int32]
                lib.seeksv_bam_free.argtypes = [ctypes.POINTER(_BamSoA)]
                lib.seeksv_coverage_diff.argtypes = [
                    ctypes.POINTER(ctypes.c_int64),
                    ctypes.POINTER(ctypes.c_int64),
                    ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
                    ctypes.POINTER(ctypes.c_int32), ctypes.c_int64]
                if hasattr(lib, "seeksv_coverage_depth"):
                    lib.seeksv_coverage_depth.argtypes = \
                        lib.seeksv_coverage_diff.argtypes
                if hasattr(lib, "seeksv_prefix_sum_i32"):
                    p32 = ctypes.POINTER(ctypes.c_int32)
                    p64 = ctypes.POINTER(ctypes.c_int64)
                    lib.seeksv_prefix_sum_i32.argtypes = [
                        p32, ctypes.c_int64, p32]
                    lib.seeksv_prefix_excl_i64.argtypes = [
                        p32, ctypes.c_int64, p64]
                if hasattr(lib, "seeksv_discordant_base_ok"):
                    p32 = ctypes.POINTER(ctypes.c_int32)
                    pu8 = ctypes.POINTER(ctypes.c_uint8)
                    lib.seeksv_discordant_base_ok.argtypes = [
                        p32, p32, p32, pu8, ctypes.c_int64, ctypes.c_int32,
                        ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, pu8]
                if hasattr(lib, "seeksv_depth_diff_soa"):
                    p32 = ctypes.POINTER(ctypes.c_int32)
                    p64 = ctypes.POINTER(ctypes.c_int64)
                    lib.seeksv_depth_diff_soa.argtypes = [
                        p32, p32, p32, p32,
                        ctypes.POINTER(ctypes.c_uint32), p64,
                        ctypes.c_int64, ctypes.c_int32, p64,
                        ctypes.c_int32, p32, p32]
                if hasattr(lib, "seeksv_depth_segments_flat"):
                    p32 = ctypes.POINTER(ctypes.c_int32)
                    p64 = ctypes.POINTER(ctypes.c_int64)
                    lib.seeksv_depth_segments_flat.restype = ctypes.c_int64
                    lib.seeksv_depth_segments_flat.argtypes = [
                        p32, p32, p32, p32,
                        ctypes.POINTER(ctypes.c_uint32), p64,
                        ctypes.c_int64, ctypes.c_int32, p64, p32,
                        ctypes.c_int32, p64, p64]
                if hasattr(lib, "seeksv_nm_from_runs"):
                    p32 = ctypes.POINTER(ctypes.c_int32)
                    p64 = ctypes.POINTER(ctypes.c_int64)
                    lib.seeksv_nm_from_runs.argtypes = [
                        p32, p64, p32, p64, ctypes.c_int64, p32,
                        ctypes.POINTER(ctypes.c_uint8), p64, p32]
                if hasattr(lib, "seeksv_bgzf_compress"):
                    pu8 = ctypes.POINTER(ctypes.c_uint8)
                    lib.seeksv_bgzf_bound.restype = ctypes.c_int64
                    lib.seeksv_bgzf_bound.argtypes = [ctypes.c_int64]
                    lib.seeksv_bgzf_compress.restype = ctypes.c_int64
                    lib.seeksv_bgzf_compress.argtypes = [
                        pu8, ctypes.c_int64, ctypes.c_int, pu8,
                        ctypes.c_int64, ctypes.c_int]
                if hasattr(lib, "seeksv_pack_sim_records"):
                    pu8 = ctypes.POINTER(ctypes.c_uint8)
                    p32 = ctypes.POINTER(ctypes.c_int32)
                    lib.seeksv_pack_sim_records.argtypes = [
                        ctypes.c_int64, ctypes.c_int32, p32, p32, p32, p32,
                        ctypes.POINTER(ctypes.c_uint16), p32,
                        ctypes.POINTER(ctypes.c_int64), pu8, pu8,
                        ctypes.c_int]
                if hasattr(lib, "seeksv_torch_bam_open"):
                    lib.seeksv_torch_bam_open.restype = ctypes.c_void_p
                    lib.seeksv_torch_bam_open.argtypes = [
                        ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p]
                    lib.seeksv_torch_bam_next.restype = \
                        ctypes.POINTER(_TorchSoA)
                    lib.seeksv_torch_bam_next.argtypes = [
                        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32]
                    lib.seeksv_torch_bam_release.argtypes = [
                        ctypes.POINTER(_TorchSoA)]
                    lib.seeksv_torch_bam_counts.argtypes = [
                        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
                    lib.seeksv_torch_bam_close.argtypes = [ctypes.c_void_p]
                if hasattr(lib, "seeksv_bam_open"):
                    lib.seeksv_bam_open.restype = ctypes.c_void_p
                    lib.seeksv_bam_open.argtypes = [
                        ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p]
                    lib.seeksv_bam_next.restype = ctypes.POINTER(_BamSoA)
                    lib.seeksv_bam_next.argtypes = [ctypes.c_void_p,
                                                    ctypes.c_int64]
                    lib.seeksv_bam_close.argtypes = [ctypes.c_void_p]
                if hasattr(lib, "seeksv_bam_next2"):
                    lib.seeksv_bam_next2.restype = ctypes.POINTER(_BamSoA)
                    lib.seeksv_bam_next2.argtypes = [
                        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32]
                if hasattr(lib, "seeksv_sw_extend_batch"):
                    p32 = ctypes.POINTER(ctypes.c_int32)
                    lib.seeksv_sw_extend_batch.argtypes = [
                        p32, p32, p32, p32, p32,
                        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                        ctypes.c_int32, p32, ctypes.c_int32]
                    lib.seeksv_sw_global.restype = ctypes.c_int64
                    lib.seeksv_sw_global.argtypes = [
                        p32, ctypes.c_int64, p32, ctypes.c_int64,
                        p32, p32, ctypes.POINTER(ctypes.c_uint8)]
                if hasattr(lib, "seeksv_clipmap_new"):
                    p32 = ctypes.POINTER(ctypes.c_int32)
                    p64 = ctypes.POINTER(ctypes.c_int64)
                    pu8 = ctypes.POINTER(ctypes.c_uint8)
                    lib.seeksv_clipmap_new.restype = ctypes.c_void_p
                    lib.seeksv_clipmap_new.argtypes = [ctypes.c_double]
                    lib.seeksv_clipmap_free.argtypes = [ctypes.c_void_p]
                    lib.seeksv_clipmap_insert_slab.argtypes = [
                        ctypes.c_void_p, pu8, pu8, p64,
                        ctypes.POINTER(ctypes.c_uint32), p64,
                        ctypes.c_int64, p64, p32, p64, p32, p32, p32, pu8]
                    lib.seeksv_clipmap_flush.argtypes = [
                        ctypes.c_void_p, ctypes.c_char_p,
                        ctypes.POINTER(pu8), p64, ctypes.POINTER(pu8), p64]
                    lib.seeksv_blob_free.argtypes = [pu8]
                if hasattr(lib, "seeksv_seed_batch"):
                    p32 = ctypes.POINTER(ctypes.c_int32)
                    p64 = ctypes.POINTER(ctypes.c_int64)
                    lib.seeksv_seed_batch.argtypes = [
                        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32,
                        ctypes.POINTER(ctypes.c_uint32),
                        ctypes.c_int64, p64, ctypes.c_int32,
                        ctypes.POINTER(ctypes.c_uint8), p64,
                        ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
                        ctypes.c_int32, p64, p32, p32, p32, p32,
                        ctypes.c_int32]
                if hasattr(lib, "seeksv_index_build"):
                    p64 = ctypes.POINTER(ctypes.c_int64)
                    lib.seeksv_index_build.restype = ctypes.c_int64
                    lib.seeksv_index_build.argtypes = [
                        ctypes.POINTER(ctypes.c_uint8), p64,
                        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                        ctypes.POINTER(ctypes.c_uint16),
                        ctypes.POINTER(ctypes.c_uint32), p64,
                        ctypes.c_int32]
                if hasattr(lib, "seeksv_sw_global_batch"):
                    p32 = ctypes.POINTER(ctypes.c_int32)
                    p64 = ctypes.POINTER(ctypes.c_int64)
                    lib.seeksv_sw_global_batch.argtypes = [
                        p32, p64, p32, p64, ctypes.c_int64, p32, p32, p64,
                        p32, ctypes.POINTER(ctypes.c_uint8),
                        ctypes.c_int64, ctypes.c_int32]
                _LIB = lib
                break
            except OSError:
                pass
    return _LIB


def available() -> bool:
    return _load() is not None


def library_path() -> Optional[str]:
    """Where the loaded library lies (under build/), or None."""
    lib = _load()
    return lib._name if lib is not None else None


class _Owner:
    """Keeps a native BamSoA alive while zero-copy views reference it, and
    hands it back (``free``: ``seeksv_bam_free``, or the streamed
    decoder's ``seeksv_torch_bam_release``) once the last is gone."""

    def __init__(self, handle, free):
        self.handle = handle
        self.free = free

    def __del__(self):
        try:
            self.free(self.handle)
        except Exception:
            pass


class _Buffer:
    """A native buffer as numpy reads it: the array made from it keeps it,
    and through it the owner, as its base."""

    def __init__(self, ptr, n: int, dtype, owner):
        self.__array_interface__ = {
            "data": (ctypes.cast(ptr, ctypes.c_void_p).value, False),
            "shape": (n,), "typestr": np.dtype(dtype).str, "version": 3}
        self.owner = owner


def _view(ptr, n, dtype, owner):
    if n == 0:
        return np.zeros(0, dtype)
    return np.asarray(_Buffer(ptr, int(n), dtype, owner))


def _soa_to_records(h, path: str, free):
    """Wrap a native BamSoA* handle as a BamRecords of zero-copy views;
    every view keeps the handle's _Owner, which hands it to ``free`` when
    the last view is gone.  A _TorchSoA's CIGAR summary goes into the
    records' memo, so that their CIGAR helpers return it.  Raises on a set
    error field."""
    from .bam import BamRecords, LazyQnames

    s = h.contents
    if s.n == 0 and s.error and s.error != b"":
        err = s.error.decode()
        free(h)
        raise IOError(f"{path}: {err}")
    owner = _Owner(h, free)
    n = int(s.n)

    def view(ptr, count, dtype):
        return _view(ptr, count, dtype, owner)

    qname_off = view(s.qname_off, n + 1, np.int64)
    # zero-copy qname blob view (LazyQnames copies per access)
    qblob = view(s.qnames, s.n_qname_total, np.uint8)
    names_blob = view(s.ref_names, s.ref_names_len, np.uint8).tobytes()
    ref_names = [x.decode() for x in names_blob.split(b"\x00") if x]
    ref_lens = view(s.ref_lens, s.n_refs, np.int32).tolist()
    memo = None
    if isinstance(s, _TorchSoA):
        memo = {key: view(getattr(s, col), n, np.int32)
                for col, key in CIGAR_SUMMARY.items()}
    return BamRecords(
        ref_names=ref_names, ref_lens=[int(x) for x in ref_lens], n=n,
        flag=view(s.flag, n, np.int32), tid=view(s.tid, n, np.int32),
        pos=view(s.pos, n, np.int32), mapq=view(s.mapq, n, np.int32),
        mtid=view(s.mtid, n, np.int32), mpos=view(s.mpos, n, np.int32),
        isize=view(s.isize, n, np.int32),
        l_qseq=view(s.l_qseq, n, np.int32),
        qnames=LazyQnames(qblob, qname_off),
        cig=view(s.cig, s.n_cig_total, np.uint32),
        cig_off=view(s.cig_off, n + 1, np.int64),
        seq=view(s.seq, s.n_seq_total, np.uint8),
        qual=view(s.qual, s.n_seq_total, np.uint8),
        seq_off=view(s.seq_off, n + 1, np.int64),
        xc=view(s.xc, n, np.int32),
        owner=owner, _memo=memo,
    )


def read_bam_native(path: str, n_threads: int = 0, lazy: bool = False):
    """lazy=True skips seq/qual (and qname for fully-mapped-pair
    records) decode — the whole-file form of the streaming reader's
    lazy mode, for consumers that only need the numeric columns +
    cigars (a 300M-record BAM is ~70 GB of bases otherwise)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library not built")
    if lazy and hasattr(lib, "seeksv_bam_decode_flags"):
        h = lib.seeksv_bam_decode_flags(path.encode(), n_threads, 1)
    else:
        h = lib.seeksv_bam_decode(path.encode(), n_threads)
    return _soa_to_records(h, path, lib.seeksv_bam_free)


def stream_available() -> bool:
    lib = _load()
    return lib is not None and hasattr(lib, "seeksv_torch_bam_open")


def iter_bam_chunks_native(path: str, chunk_records: int,
                           n_threads: int = 0, lazy_seq: bool = False):
    """Bounded-memory chunked decode: yields BamRecords slabs of up to
    chunk_records records, in file order (the streaming memory contract
    the reference gets from per-chromosome flushes, clip_reads.h:423-446).

    The port's streamed decoder (csrc/bam_stream.cpp): its n_threads
    workers (0: one a core) inflate the compressed windows ahead of the
    record walk, and a slab's columns are views of a buffer set that goes
    back to the stream's pool when the last view of the slab is gone.
    Peak footprint: the windows in flight + one set a slab held.  Slabs,
    columns and errors are those of the reference's seeksv_bam_next2
    (tests/test_torch_bam_stream.py); each slab also carries its records'
    CIGAR summary, which its CIGAR helpers return (BamRecords.summarised).
    When the stream closes its counts go to utils/trace.count:
    ``scan.slabs``, ``scan.slabs_recycled`` (slabs written into a set an
    earlier slab handed back), ``scan.slabs_summarised`` (slabs that
    carried the summary), ``scan.windows`` and ``scan.windows_ready``
    (windows inflated before the walk reached them).

    lazy_seq=True skips the seq/qual decode for records that are fully
    mapped with no soft-clipped end — valid only when the consumer reads
    bases exclusively from clipped/unmapped records (GetclipStream +
    StreamStats do; the skipped rows are uninitialised)."""
    from ..utils import trace
    lib = _load()
    if lib is None or not hasattr(lib, "seeksv_torch_bam_open"):
        raise RuntimeError("native stream reader not built")
    err = ctypes.create_string_buffer(256)
    s = lib.seeksv_torch_bam_open(path.encode(), n_threads, err)
    if not s:
        raise IOError(f"{path}: {err.value.decode()}")
    summarised = 0
    try:
        while True:
            h = lib.seeksv_torch_bam_next(s, chunk_records, int(lazy_seq))
            recs = _soa_to_records(h, path, lib.seeksv_torch_bam_release)
            if recs.n == 0:
                break
            summarised += recs.summarised()
            yield recs
    finally:
        c = (ctypes.c_int64 * 4)()
        lib.seeksv_torch_bam_counts(s, c)
        lib.seeksv_torch_bam_close(s)
        for name, v in zip(("scan.slabs", "scan.slabs_recycled",
                            "scan.windows", "scan.windows_ready"), c):
            trace.count(name, v)
        trace.count("scan.slabs_summarised", summarised)


def pack_sim_available() -> bool:
    lib = _load()
    return lib is not None and hasattr(lib, "seeksv_pack_sim_records")


def pack_sim_records(read_len: int, tid, pos, mtid, mpos, flag, isize, qk,
                     seq, n_threads: int = 0) -> np.ndarray:
    """Pack fixed-shape simulator records (full-length-M reads, fixed
    'sim_%010d' qnames) into BAM record bytes; mirrors the numpy assembly
    in utils/simulate._write_sorted (asserted by tests/test_simulation.py)."""
    lib = _load()
    n = len(pos)
    QN = 15
    rec = 4 + 32 + QN + 4 + (read_len + 1) // 2 + read_len
    out = np.empty(n * rec, np.uint8)
    p32 = ctypes.POINTER(ctypes.c_int32)
    pu8 = ctypes.POINTER(ctypes.c_uint8)
    # keep-alive: materialize contiguous copies before taking pointers
    tid_c = np.ascontiguousarray(tid, np.int32)
    pos_c = np.ascontiguousarray(pos, np.int32)
    mtid_c = np.ascontiguousarray(mtid, np.int32)
    mpos_c = np.ascontiguousarray(mpos, np.int32)
    flag_c = np.ascontiguousarray(flag, np.uint16)
    isize_c = np.ascontiguousarray(isize, np.int32)
    qk_c = np.ascontiguousarray(qk, np.int64)
    seq_c = np.ascontiguousarray(seq, np.uint8)
    lib.seeksv_pack_sim_records(
        n, read_len, tid_c.ctypes.data_as(p32), pos_c.ctypes.data_as(p32),
        mtid_c.ctypes.data_as(p32), mpos_c.ctypes.data_as(p32),
        flag_c.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        isize_c.ctypes.data_as(p32),
        qk_c.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        seq_c.ctypes.data_as(pu8), out.ctypes.data_as(pu8), n_threads)
    return out


def bgzf_available() -> bool:
    lib = _load()
    return lib is not None and hasattr(lib, "seeksv_bgzf_compress")


def bgzf_compress(data, level: int = 1, n_threads: int = 0) -> bytes:
    """BGZF-frame and deflate `data` (threaded native path; the python
    writer falls back to zlib when the library is absent)."""
    lib = _load()
    src = np.frombuffer(data, np.uint8)
    n = len(src)
    cap = int(lib.seeksv_bgzf_bound(n))
    out = np.empty(cap, np.uint8)
    pu8 = ctypes.POINTER(ctypes.c_uint8)
    written = lib.seeksv_bgzf_compress(
        src.ctypes.data_as(pu8), n, level, out.ctypes.data_as(pu8), cap,
        n_threads)
    if written < 0:
        raise RuntimeError("bgzf compression overflow")
    return out[:written].tobytes()


def rec_offsets(recs) -> Optional[np.ndarray]:
    """Decompressed-stream record offsets ([n+1] int64) + header size for
    a natively decoded whole-file BamRecords; None when unavailable."""
    owner = getattr(recs, "owner", None)
    if owner is None or not hasattr(owner, "handle"):
        return None
    s = owner.handle.contents
    if not s.rec_off:
        return None
    return (_view(s.rec_off, int(s.n) + 1, np.int64, owner),
            int(s.body_off))


def sw_available() -> bool:
    lib = _load()
    return lib is not None and hasattr(lib, "seeksv_sw_extend_batch")


def sw_extend_batch_native(q: np.ndarray, qlen: np.ndarray, t: np.ndarray,
                           tlen: np.ndarray, h0: np.ndarray,
                           zdrop: int = 100, n_threads: int = 0):
    """Native batched anchored extension; exact extend_batch_np semantics
    (asserted by tests/test_native.py::test_sw_extend_native_vs_numpy)."""
    lib = _load()
    q = np.ascontiguousarray(q, np.int32)
    t = np.ascontiguousarray(t, np.int32)
    qlen = np.ascontiguousarray(qlen, np.int32)
    tlen = np.ascontiguousarray(tlen, np.int32)
    h0 = np.ascontiguousarray(h0, np.int32)
    B, LQ = q.shape
    LT = t.shape[1]
    out = np.empty((B, 5), np.int32)
    p32 = ctypes.POINTER(ctypes.c_int32)
    lib.seeksv_sw_extend_batch(
        q.ctypes.data_as(p32), qlen.ctypes.data_as(p32),
        t.ctypes.data_as(p32), tlen.ctypes.data_as(p32),
        h0.ctypes.data_as(p32), B, LQ, LT, zdrop,
        out.ctypes.data_as(p32), n_threads)
    return {"max_score": out[:, 0].astype(np.int64),
            "qle": out[:, 1].astype(np.int64),
            "tle": out[:, 2].astype(np.int64),
            "gscore": out[:, 3].astype(np.int64),
            "gtle": out[:, 4].astype(np.int64)}


def sw_global_native(query: np.ndarray, target: np.ndarray):
    """Native global affine alignment -> (score, [(len, op), ...]); exact
    sw.global_align semantics incl. traceback preference order."""
    lib = _load()
    q = np.ascontiguousarray(query, np.int32)
    t = np.ascontiguousarray(target, np.int32)
    m, n = len(q), len(t)
    cap = m + n + 1
    cig_len = np.empty(cap, np.int32)
    cig_op = np.empty(cap, np.uint8)
    score = ctypes.c_int32(0)
    p32 = ctypes.POINTER(ctypes.c_int32)
    nc = lib.seeksv_sw_global(
        q.ctypes.data_as(p32), m, t.ctypes.data_as(p32), n,
        ctypes.byref(score), cig_len.ctypes.data_as(p32),
        cig_op.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return int(score.value), [(int(cig_len[i]), chr(cig_op[i]))
                              for i in range(nc)]


class NativeClipMap:
    """Handle to the native getclip consensus multimap (the v1.2.0
    longest-wins merge; byte-equal outputs vs pipeline.getclip's
    BreakpointMap, asserted by the golden/stream parity tests)."""

    def __init__(self, limit: float):
        self._lib = _load()
        self._h = self._lib.seeksv_clipmap_new(ctypes.c_double(limit))

    def insert_slab(self, recs, rows) -> None:
        """rows: dict of candidate arrays (rec, side, pos, a, ms, me,
        leftclip) in stream order."""
        n = len(rows["rec"])
        if n == 0:
            return
        p32 = ctypes.POINTER(ctypes.c_int32)
        p64 = ctypes.POINTER(ctypes.c_int64)
        pu8 = ctypes.POINTER(ctypes.c_uint8)
        seq = np.ascontiguousarray(recs.seq, np.uint8)
        qual = np.ascontiguousarray(recs.qual, np.uint8)
        seq_off = np.ascontiguousarray(recs.seq_off, np.int64)
        cig = np.ascontiguousarray(recs.cig, np.uint32)
        cig_off = np.ascontiguousarray(recs.cig_off, np.int64)
        rec = np.ascontiguousarray(rows["rec"], np.int64)
        side = np.ascontiguousarray(rows["side"], np.int32)
        pos = np.ascontiguousarray(rows["pos"], np.int64)
        a = np.ascontiguousarray(rows["a"], np.int32)
        ms = np.ascontiguousarray(rows["ms"], np.int32)
        me = np.ascontiguousarray(rows["me"], np.int32)
        lc = np.ascontiguousarray(rows["leftclip"], np.uint8)
        self._lib.seeksv_clipmap_insert_slab(
            self._h, seq.ctypes.data_as(pu8), qual.ctypes.data_as(pu8),
            seq_off.ctypes.data_as(p64),
            cig.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            cig_off.ctypes.data_as(p64), n, rec.ctypes.data_as(p64),
            side.ctypes.data_as(p32), pos.ctypes.data_as(p64),
            a.ctypes.data_as(p32), ms.ctypes.data_as(p32),
            me.ctypes.data_as(p32), lc.ctypes.data_as(pu8))

    def flush(self, chrom: str):
        """Returns (clip_gz_text, clip_fq_text) bytes for the live
        chromosome and clears the maps."""
        pu8 = ctypes.POINTER(ctypes.c_uint8)
        soft_p = pu8()
        fq_p = pu8()
        soft_n = ctypes.c_int64(0)
        fq_n = ctypes.c_int64(0)
        self._lib.seeksv_clipmap_flush(
            self._h, chrom.encode(), ctypes.byref(soft_p),
            ctypes.byref(soft_n), ctypes.byref(fq_p), ctypes.byref(fq_n))
        soft = ctypes.string_at(soft_p, soft_n.value) if soft_n.value else b""
        fq = ctypes.string_at(fq_p, fq_n.value) if fq_n.value else b""
        self._lib.seeksv_blob_free(soft_p)
        self._lib.seeksv_blob_free(fq_p)
        return soft, fq

    def __del__(self):
        try:
            self._lib.seeksv_clipmap_free(self._h)
        except Exception:
            pass


def clipmap_available() -> bool:
    lib = _load()
    return lib is not None and hasattr(lib, "seeksv_clipmap_new")


def seed_batch_available() -> bool:
    lib = _load()
    return lib is not None and hasattr(lib, "seeksv_seed_batch")


def seed_batch_native(idx, reads, max_occ: int, top: int,
                      n_threads: int = 0):
    """Native batched seeding over a KmerIndex; exact
    align.seed_batch.batch_candidates semantics (asserted by
    tests/test_native.py).  reads: list of uint8 code arrays."""
    lib = _load()
    n = len(reads)
    read_off = np.zeros(n + 1, np.int64)
    for i, r in enumerate(reads):
        read_off[i + 1] = read_off[i] + len(r)
    flat = np.empty(int(read_off[-1]), np.uint8)
    for i, r in enumerate(reads):
        flat[read_off[i]:read_off[i + 1]] = r
    # v2 packed table: low-bit keys (uint16/uint32) + uint32 positions;
    # ascontiguousarray preserves the mmap'd arrays zero-copy when the
    # dtype already matches
    keys = np.ascontiguousarray(idx.keys)
    if keys.dtype == np.uint16:
        key_bytes = 2
    elif keys.dtype == np.uint32:
        key_bytes = 4
    else:
        raise TypeError(f"v2 index expects uint16/uint32 low keys, "
                        f"got {keys.dtype}")
    positions = np.ascontiguousarray(idx.positions, np.uint32)
    ptab = np.ascontiguousarray(idx.prefix_tab, np.int64)
    shift = idx._prefix_shift(idx.k)
    diag = np.zeros((n, top), np.int64)
    qstart = np.zeros((n, top), np.int32)
    alen = np.zeros((n, top), np.int32)
    votes = np.zeros((n, top), np.int32)
    ncand = np.zeros(n, np.int32)
    p32 = ctypes.POINTER(ctypes.c_int32)
    p64 = ctypes.POINTER(ctypes.c_int64)
    if n:
        lib.seeksv_seed_batch(
            keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), key_bytes,
            positions.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            len(keys),
            ptab.ctypes.data_as(p64), shift,
            flat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            read_off.ctypes.data_as(p64), n, idx.k, max_occ, top,
            diag.ctypes.data_as(p64), qstart.ctypes.data_as(p32),
            alen.ctypes.data_as(p32), votes.ctypes.data_as(p32),
            ncand.ctypes.data_as(p32), n_threads)
    out = {}
    for i in range(n):
        out[i] = [(int(diag[i, c]), int(qstart[i, c]), int(alen[i, c]),
                   int(votes[i, c])) for c in range(int(ncand[i]))]
    return out


def index_build_available() -> bool:
    lib = _load()
    return lib is not None and hasattr(lib, "seeksv_index_build")


def index_build_native(ref_codes: np.ndarray, starts: np.ndarray, k: int,
                       bits: int, n_threads: int = 0):
    """Radix-bucketed v2 index build (csrc seeksv_index_build): returns
    (keys_low uint16, positions uint32, prefix_tab int64) with the same
    layout/order as the numpy build (equivalence asserted by
    tests/test_align.py).  Requires residual bits <= 16 (production
    prefix widths); callers fall back to numpy otherwise."""
    lib = _load()
    ref_codes = np.ascontiguousarray(ref_codes, np.uint8)
    starts = np.ascontiguousarray(starts, np.int64)
    cap = int(np.maximum(np.diff(starts) - k + 1, 0).sum())
    keys = np.empty(max(cap, 1), np.uint16)
    positions = np.empty(max(cap, 1), np.uint32)
    nb = 1 << bits
    ptab = np.empty(nb + 1, np.int64)
    p64 = ctypes.POINTER(ctypes.c_int64)
    n = lib.seeksv_index_build(
        ref_codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        starts.ctypes.data_as(p64), len(starts) - 1, k, bits,
        keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        positions.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        ptab.ctypes.data_as(p64), n_threads)
    if n == cap:
        return keys, positions, ptab
    return keys[:n].copy(), positions[:n].copy(), ptab


def sw_global_batch_available() -> bool:
    lib = _load()
    return lib is not None and hasattr(lib, "seeksv_sw_global_batch")


def sw_global_batch_native(queries, targets, n_threads: int = 0):
    """Batched threaded global alignment + NM: queries/targets are lists
    of code arrays; returns [(score, cigar, nm)] per pair, exactly
    matching per-pair sw.global_align + engine._nm (degenerate m==0/n==0
    rows follow the wrapper conventions)."""
    from ..align.sw import GAP_EXT, GAP_OPEN
    B = len(queries)
    q_off = np.zeros(B + 1, np.int64)
    t_off = np.zeros(B + 1, np.int64)
    for i in range(B):
        q_off[i + 1] = q_off[i] + len(queries[i])
        t_off[i + 1] = t_off[i] + len(targets[i])
    q = np.empty(int(q_off[-1]), np.int32)
    t = np.empty(int(t_off[-1]), np.int32)
    for i in range(B):
        q[q_off[i]:q_off[i + 1]] = queries[i]
        t[t_off[i]:t_off[i + 1]] = targets[i]
    cap = (int(((q_off[1:] - q_off[:-1])
                + (t_off[1:] - t_off[:-1])).max(initial=0)) + 1 if B else 1)
    score = np.zeros(B, np.int32)
    nm = np.zeros(B, np.int32)
    ncig = np.zeros(B, np.int64)
    cig_len = np.empty((B, cap), np.int32)
    cig_op = np.empty((B, cap), np.uint8)
    lib = _load()
    p32 = ctypes.POINTER(ctypes.c_int32)
    p64 = ctypes.POINTER(ctypes.c_int64)
    pu8 = ctypes.POINTER(ctypes.c_uint8)
    if B:
        lib.seeksv_sw_global_batch(
            q.ctypes.data_as(p32), q_off.ctypes.data_as(p64),
            t.ctypes.data_as(p32), t_off.ctypes.data_as(p64), B,
            score.ctypes.data_as(p32), nm.ctypes.data_as(p32),
            ncig.ctypes.data_as(p64), cig_len.ctypes.data_as(p32),
            cig_op.ctypes.data_as(pu8), cap, n_threads)
    out = []
    for i in range(B):
        m = int(q_off[i + 1] - q_off[i])
        n = int(t_off[i + 1] - t_off[i])
        if m == 0 and n == 0:
            out.append((0, [], 0))
        elif m == 0:
            out.append((-GAP_OPEN - n * GAP_EXT, [(n, "D")], n))
        elif n == 0:
            out.append((-GAP_OPEN - m * GAP_EXT, [(m, "I")], m))
        else:
            k = int(ncig[i])
            out.append((int(score[i]),
                        [(int(cig_len[i, c]), chr(cig_op[i, c]))
                         for c in range(k)], int(nm[i])))
    return out


def coverage_depth(starts: np.ndarray, ends: np.ndarray,
                   weights: np.ndarray, L: int) -> np.ndarray:
    """depth[i] = sum of weights of segments covering position i, i<L —
    the fused native equivalent of np.cumsum(coverage_diff(...))[:L]."""
    lib = _load()
    if lib is None or not hasattr(lib, "seeksv_coverage_depth"):
        diff = coverage_diff(starts, ends, weights, L + 1)
        return np.cumsum(diff)[:L].astype(np.int32)
    depth = np.zeros(L + 1, np.int32)
    s = np.ascontiguousarray(starts, np.int64)
    e = np.ascontiguousarray(ends, np.int64)
    w = np.ascontiguousarray(weights, np.int32)
    lib.seeksv_coverage_depth(
        s.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        e.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        w.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(s), depth.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), L)
    return depth[:L]


def cumsum_i32(a: np.ndarray) -> np.ndarray:
    """Inclusive int32 prefix sum (native when built; np.cumsum fallback)."""
    lib = _load()
    if lib is None or not hasattr(lib, "seeksv_prefix_sum_i32"):
        return np.cumsum(a, dtype=np.int32)
    a = np.ascontiguousarray(a, np.int32)
    out = np.empty(len(a), np.int32)
    p32 = ctypes.POINTER(ctypes.c_int32)
    lib.seeksv_prefix_sum_i32(a.ctypes.data_as(p32), len(a),
                              out.ctypes.data_as(p32))
    return out


def prefix_excl_i64(a: np.ndarray) -> np.ndarray:
    """Exclusive int64 prefix sum of an int32 array: out[0]=0,
    out[i+1]=sum(a[:i+1]); len(out) == len(a)+1 (the range-sum table)."""
    lib = _load()
    if lib is None or not hasattr(lib, "seeksv_prefix_excl_i64"):
        return np.concatenate([[0], np.cumsum(a, dtype=np.int64)])
    a = np.ascontiguousarray(a, np.int32)
    out = np.empty(len(a) + 1, np.int64)
    lib.seeksv_prefix_excl_i64(
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(a),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return out


def discordant_base_ok_available() -> bool:
    lib = _load()
    return lib is not None and hasattr(lib, "seeksv_discordant_base_ok")


def discordant_base_ok(flag, mapq, isize, hard, min_mapq: int,
                       min_ins: int, max_ins: int,
                       skip_hard: bool) -> np.ndarray:
    """Fused base-eligibility mask for DiscordantCounter (one native
    pass; numpy mask chain is the oracle, tests/test_native.py)."""
    lib = _load()
    n = len(flag)
    flag = np.ascontiguousarray(flag, np.int32)
    mapq = np.ascontiguousarray(mapq, np.int32)
    isize = np.ascontiguousarray(isize, np.int32)
    hard = np.ascontiguousarray(hard, np.uint8)
    out = np.empty(n, np.uint8)
    p32 = ctypes.POINTER(ctypes.c_int32)
    pu8 = ctypes.POINTER(ctypes.c_uint8)
    lib.seeksv_discordant_base_ok(
        flag.ctypes.data_as(p32), mapq.ctypes.data_as(p32),
        isize.ctypes.data_as(p32), hard.ctypes.data_as(pu8), n,
        min_mapq, min_ins, max_ins, int(skip_hard),
        out.ctypes.data_as(pu8))
    return out.view(bool)


def depth_segments_flat_available() -> bool:
    lib = _load()
    return lib is not None and hasattr(lib, "seeksv_depth_segments_flat")


def depth_segments_flat(recs, min_mapq: int, offsets: np.ndarray):
    """(flat_start, flat_end) per M/=/X segment of every gate-passing
    record, clipped to the owning chromosome — one native pass replacing
    the repeat+cumsum numpy expansion of depth_segments + flat mapping
    (parallel/spmd_pipeline.py _flat_segments)."""
    lib = _load()
    p32 = ctypes.POINTER(ctypes.c_int32)
    p64 = ctypes.POINTER(ctypes.c_int64)
    flag = np.ascontiguousarray(recs.flag, np.int32)
    tid = np.ascontiguousarray(recs.tid, np.int32)
    pos = np.ascontiguousarray(recs.pos, np.int32)
    mapq = np.ascontiguousarray(recs.mapq, np.int32)
    cig = np.ascontiguousarray(recs.cig, np.uint32)
    cig_off = np.ascontiguousarray(recs.cig_off, np.int64)
    offs = np.ascontiguousarray(offsets[:len(recs.ref_lens)], np.int64)
    rl = np.ascontiguousarray(recs.ref_lens, np.int32)
    cap = max(len(cig), 1)
    out_s = np.empty(cap, np.int64)
    out_e = np.empty(cap, np.int64)
    k = lib.seeksv_depth_segments_flat(
        flag.ctypes.data_as(p32), tid.ctypes.data_as(p32),
        pos.ctypes.data_as(p32), mapq.ctypes.data_as(p32),
        cig.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        cig_off.ctypes.data_as(p64), recs.n, min_mapq,
        offs.ctypes.data_as(p64), rl.ctypes.data_as(p32),
        len(recs.ref_lens), out_s.ctypes.data_as(p64),
        out_e.ctypes.data_as(p64))
    return out_s[:k], out_e[:k]


def nm_from_runs_available() -> bool:
    lib = _load()
    return lib is not None and hasattr(lib, "seeksv_nm_from_runs")


def nm_from_runs(qs, ts, runs):
    """NM per job from cigar runs (mismatches on M + indel bases; the
    engine contract).  qs/ts: lists of code arrays; runs: list of
    [(len, 'M'|'I'|'D'), ...]."""
    lib = _load()
    B = len(qs)
    q = np.concatenate([np.asarray(x, np.int32) for x in qs]) \
        if B else np.zeros(0, np.int32)
    t = np.concatenate([np.asarray(x, np.int32) for x in ts]) \
        if B else np.zeros(0, np.int32)
    q_off = np.zeros(B + 1, np.int64)
    t_off = np.zeros(B + 1, np.int64)
    np.cumsum([len(x) for x in qs], out=q_off[1:])
    np.cumsum([len(x) for x in ts], out=t_off[1:])
    opmap = {"M": 0, "I": 1, "D": 2}
    rlen = np.asarray([ln for rr in runs for ln, _ in rr], np.int32)
    rop = np.asarray([opmap[o] for rr in runs for _, o in rr], np.uint8)
    r_off = np.zeros(B + 1, np.int64)
    np.cumsum([len(rr) for rr in runs], out=r_off[1:])
    nm = np.zeros(B, np.int32)
    p32 = ctypes.POINTER(ctypes.c_int32)
    p64 = ctypes.POINTER(ctypes.c_int64)
    lib.seeksv_nm_from_runs(
        q.ctypes.data_as(p32), q_off.ctypes.data_as(p64),
        t.ctypes.data_as(p32), t_off.ctypes.data_as(p64), B,
        rlen.ctypes.data_as(p32),
        rop.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        r_off.ctypes.data_as(p64), nm.ctypes.data_as(p32))
    return nm


def depth_diff_soa_available() -> bool:
    lib = _load()
    return lib is not None and hasattr(lib, "seeksv_depth_diff_soa")


def depth_diff_soa(recs, min_mapq: int, tid_base: np.ndarray,
                   diff: np.ndarray) -> None:
    """Accumulate the pileup-depth difference contributions of every
    record in `recs` into the flat per-genome diff buffer (layout:
    chromosome t owns diff[tid_base[t] : tid_base[t] + ref_lens[t] + 1]).
    Single native pass over the SoA columns — the streaming-stats
    replacement for depth_segments + coverage_diff
    (ref: bam2depth.cpp:75-129)."""
    lib = _load()
    p32 = ctypes.POINTER(ctypes.c_int32)
    p64 = ctypes.POINTER(ctypes.c_int64)
    flag = np.ascontiguousarray(recs.flag, np.int32)
    tid = np.ascontiguousarray(recs.tid, np.int32)
    pos = np.ascontiguousarray(recs.pos, np.int32)
    mapq = np.ascontiguousarray(recs.mapq, np.int32)
    cig = np.ascontiguousarray(recs.cig, np.uint32)
    cig_off = np.ascontiguousarray(recs.cig_off, np.int64)
    tb = np.ascontiguousarray(tid_base, np.int64)
    rl = np.ascontiguousarray(recs.ref_lens, np.int32)
    assert diff.dtype == np.int32 and diff.flags.c_contiguous
    lib.seeksv_depth_diff_soa(
        flag.ctypes.data_as(p32), tid.ctypes.data_as(p32),
        pos.ctypes.data_as(p32), mapq.ctypes.data_as(p32),
        cig.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        cig_off.ctypes.data_as(p64), recs.n, min_mapq,
        tb.ctypes.data_as(p64), len(recs.ref_lens),
        rl.ctypes.data_as(p32), diff.ctypes.data_as(p32))


def coverage_diff(starts: np.ndarray, ends: np.ndarray,
                  weights: np.ndarray, length: int) -> np.ndarray:
    """Native scatter-add into a difference array (fallback: np.add.at)."""
    lib = _load()
    diff = np.zeros(length + 1, np.int32)
    if lib is None:
        np.add.at(diff, np.clip(starts, 0, length), weights)
        np.add.at(diff, np.clip(ends, 0, length), -weights)
        return diff
    s = np.ascontiguousarray(starts, np.int64)
    e = np.ascontiguousarray(ends, np.int64)
    w = np.ascontiguousarray(weights, np.int32)
    lib.seeksv_coverage_diff(
        s.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        e.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        w.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(s), diff.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        length)
    return diff
