"""Streaming, bounded-memory pipeline execution (``run --stream``) on a torch
device.  Counterpart of ``seeksv_tpu/pipeline/stream.py``.

The reference bounds getclip memory with per-chromosome flushes
(ref: clip_reads.h:423-446) but getsv still random-accesses the whole
original BAM through the BAI index (getsv.cpp:1027 bam_iter_query,
bam2depth.cpp:75 pileup).  This module is the framework's explicit memory
contract for whole-genome scale: the BAM is decoded ONCE in bounded slabs
(io.bam.read_bam_chunks) and every consumer of the original records is fed
from that single pass —

  * getclip         -> pipeline.getclip.GetclipStream (slab-incremental),
  * insert-size     -> first-N proper-pair accumulation (cluster.cpp:15-83),
  * depth           -> one flat coverage diff (bam2depth.cpp:75),
  * discordant pairs-> compact per-record columns (LightBam) retained in
                       RAM: ~26 bytes/record instead of the full record
                       (~2 bytes/base seq+qual + cigars + qnames), a >10x
                       reduction that makes 30x whole-genome runs fit.

Peak RSS = decode slab (chunk_records full records) + coverage arrays
(4 bytes/ref bp) + LightBam columns (~26 bytes/record) + getclip's live
per-chromosome breakpoint maps.  Parity: stream-vs-whole byte equality is
asserted by tests/test_torch_stream.py and tests/test_torch_host_parity.py.

``run_pipeline_streaming`` realigns the clip fastq in chunks of 200,000
reads on a ``BatchAligner`` and runs getsv [+ somatic] on the streamed
statistics.
"""
from __future__ import annotations

import io
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..align.engine import Aligner, BatchAligner
from ..align.index import KmerIndex
from ..io.bam import (BamRecords, FDUP, FPAIRED, FPROPER_PAIR, OP_H,
                      read_bam_chunks)
from ..utils import trace
from .driver import export_profile, native_stage, profiled, realign_clips
from .getclip import GetclipStream
from .getsv import depth_segments, getsv
from .somatic import somatic, somatic_filter


@dataclass
class LightBam:
    """Compact column view of a whole BAM: exactly the fields
    DiscordantCounter needs (ref FindDiscordantReadPairs inputs,
    getsv.cpp:990-1120), with `end` (bam_calend) and `hard` (leading or
    trailing hard clip) precomputed from the cigars during streaming so
    the cigars themselves need not be retained."""
    ref_names: List[str]
    ref_lens: List[int]
    n: int
    pos: np.ndarray     # int32
    mpos: np.ndarray    # int32
    mtid: np.ndarray    # int32
    l_qseq: np.ndarray  # int32
    flag: np.ndarray    # uint16
    mapq: np.ndarray    # uint8
    isize: np.ndarray   # int32
    tid: np.ndarray     # int32
    end: np.ndarray     # int32: pos + ref_span (bam_calend)
    hard: np.ndarray    # bool


def _end_hard(recs: BamRecords) -> Tuple[np.ndarray, np.ndarray]:
    """(end, hard) per record: end = pos + ref span (M/D/N/=/X,
    bam_calend), hard = the first or last CIGAR op is H.  The streamed
    decoder's slabs carry both in their CIGAR summary; other slabs
    compute the numpy forms."""
    hard = (recs.first_op() == OP_H) | (recs.last_op() == OP_H)
    return recs.pos + recs.ref_span(count_x=True), hard


class _GrowCols:
    """Preallocated growable SoA columns (doubling): appending slab
    columns writes into one resident buffer, so finalizing is a zero-copy
    slice instead of a concatenate of every slab's columns."""

    _DTYPES = dict(flag=np.uint16, mapq=np.uint8, hard=bool)

    def __init__(self, names):
        self.names = names
        self.cap = 0
        self.n = 0
        self.buf: Dict[str, np.ndarray] = {}

    def _reserve(self, extra: int) -> None:
        need = self.n + extra
        if need <= self.cap:
            return
        new_cap = max(need, self.cap * 2, 4_000_000)
        for k in self.names:
            dt = self._DTYPES.get(k, np.int32)
            nb = np.empty(new_cap, dt)
            if self.n:
                nb[:self.n] = self.buf[k][:self.n]
            self.buf[k] = nb
        self.cap = new_cap

    def hint(self, n_records: int) -> None:
        """Pre-size the buffers (untouched pages cost nothing; doubling
        regrowth at the GB scale costs seconds of page faults on this
        host).  Call before the first append."""
        if self.n == 0 and n_records > self.cap:
            self._reserve(n_records)

    def append(self, **cols) -> None:
        m = len(next(iter(cols.values())))
        self._reserve(m)
        for k, v in cols.items():
            self.buf[k][self.n:self.n + m] = v
        self.n += m

    def view(self, k: str) -> np.ndarray:
        return self.buf[k][:self.n] if self.buf else \
            np.zeros(0, self._DTYPES.get(k, np.int32))


class StreamStats:
    """Single-pass accumulator over BamRecords slabs for everything getsv
    and somatic need from the original BAM (see module docstring).
    process() every slab in file order, then read insert_size(),
    coverage() and light().

    Coverage lives in one flat int32 diff buffer over the genome:
    chromosome t owns ``[tid_base[t], tid_base[t] + L_t + 1)``.  With the
    native host library one fused pass over the slab's columns adds into
    it (``native.depth_diff_soa``); without it the numpy form
    (``depth_segments``, each segment clipped to its chromosome, offset by
    ``tid_base``) adds the same counts."""

    SPAN = "seeksv.scan.stats"

    def __init__(self, min_mapq: int, read_pair_used: int):
        self.min_mapq = min_mapq
        self.read_pair_used = read_pair_used
        self._isize_parts: List[np.ndarray] = []
        self._isize_count = 0
        self._diff: Optional[np.ndarray] = None
        self._tid_base: Optional[np.ndarray] = None
        self._cols = _GrowCols(("pos", "mpos", "mtid", "l_qseq", "flag",
                                "mapq", "isize", "tid", "end", "hard"))
        self.ref_names: List[str] = []
        self.ref_lens: List[int] = []
        self.n = 0

    def reserve_hint(self, n_records: int) -> None:
        self._cols.hint(n_records)

    def process(self, recs: BamRecords) -> None:
        from ..io import native
        self.ref_names = recs.ref_names
        self.ref_lens = list(recs.ref_lens)
        self.n += recs.n

        end, hard = _end_hard(recs)

        # insert-size model: first N qualifying records in file order
        # (ref: cluster.cpp:25-56)
        if self._isize_count < self.read_pair_used:
            ok = ((recs.mapq >= self.min_mapq)
                  & ((recs.flag & FPAIRED) != 0)
                  & ((recs.flag & FPROPER_PAIR) != 0)
                  & ((recs.flag & FDUP) == 0) & (recs.isize > 0) & ~hard)
            vals = recs.isize[ok]
            self._isize_parts.append(np.asarray(vals, np.int32))
            self._isize_count += len(vals)

        # coverage diffs (ref: bam2depth.cpp:75-129)
        if self._diff is None:
            lens = np.asarray(recs.ref_lens, np.int64)
            self._tid_base = np.concatenate([[0], np.cumsum(lens + 1)])[:-1]
            self._diff = np.zeros(int((lens + 1).sum()), np.int32)
        if native.available():
            native.depth_diff_soa(recs, self.min_mapq, self._tid_base,
                                  self._diff)
        else:
            seg_start, seg_end, seg_tid = depth_segments(recs, self.min_mapq)
            tid_len = np.asarray(recs.ref_lens, np.int64)[seg_tid]
            base = self._tid_base[seg_tid]
            np.add.at(self._diff, base + np.clip(seg_start, 0, tid_len), 1)
            np.add.at(self._diff, base + np.clip(seg_end, 0, tid_len), -1)

        # compact discordant-counting columns, copied into the resident
        # growable buffers (the slab's arrays are zero-copy views into the
        # native decoder's buffers, which it reuses once the slab is
        # dropped).
        self._cols.append(
            pos=recs.pos, mpos=recs.mpos, mtid=recs.mtid,
            l_qseq=recs.l_qseq, flag=recs.flag, mapq=recs.mapq,
            isize=recs.isize, tid=recs.tid, end=end, hard=hard)

    def insert_size(self) -> Tuple[int, int]:
        """Exact calculate_insert_size semantics over the accumulated
        first-N values (integer mean, truncated-int deviation;
        ref: cluster.cpp:15-83)."""
        import math
        if self._isize_parts:
            vals = np.concatenate(self._isize_parts)[:self.read_pair_used]
        else:
            vals = np.zeros(0, np.int32)
        if len(vals) == 0:
            return 0, 0
        vals = vals.astype(np.int64)
        mean = int(vals.sum() // len(vals))
        dev = int(math.sqrt(
            float(((vals - mean).astype(np.float64) ** 2).sum()) / len(vals)))
        return mean, dev

    def coverage(self) -> Dict[int, np.ndarray]:
        """Per-tid depth arrays (= pipeline.getsv.compute_coverage on the
        whole file)."""
        from ..io.native import cumsum_i32
        out: Dict[int, np.ndarray] = {}
        for t in range(len(self.ref_names)):
            L = int(self.ref_lens[t])
            b = int(self._tid_base[t])
            out[t] = cumsum_i32(self._diff[b:b + L + 1])[:L]
        return out

    def light(self) -> LightBam:
        v = self._cols.view
        return LightBam(self.ref_names, self.ref_lens, self.n,
                        v("pos"), v("mpos"), v("mtid"), v("l_qseq"),
                        v("flag"), v("mapq"), v("isize"), v("tid"),
                        v("end"), v("hard"))


def scan_bam(bam_path: str, chunk_records: int, consumers: list) -> None:
    """One decode pass (``read_bam_chunks``) feeding every consumer
    (objects with .process(recs)) in file order; slabs are dropped after
    each round, bounding memory to two slabs + consumer state.

    A background thread decodes slab k+1 while the consumers process slab
    k: the native decoder (ctypes -> C++ threads) releases the GIL, so
    decode wall-clock overlaps the Python/numpy consumer work.  The thread
    starts slab k+2 only once the consumers have dropped slab k: two slabs
    at a time.  The decode is lazy (``lazy_seq=True``): it skips the bases
    of unclipped fully-mapped records, which GetclipStream and StreamStats
    never read.  Without the native host library the python decoder
    decodes every record, with the same slabs and bytes.

    Spans (utils/trace.py): ``seeksv.scan.decode`` a slab on the thread
    that decodes, ``seeksv.scan.wait`` the consumers' wait for a slab,
    a consumer's ``SPAN`` (else ``seeksv.scan.<class name>``) a slab,
    ``seeksv.scan.release`` the drop of a slab; the counter
    ``scan.bam_bytes`` the compressed bytes it decodes."""
    import os
    # record-count estimate from the compressed size (~23 B/record at
    # 100 bp reads): lets accumulators pre-size instead of doubling
    try:
        size = os.path.getsize(bam_path)
    except OSError:
        size = 0
    trace.count("scan.bam_bytes", size)
    est = size // 16
    if est:
        for cns in consumers:
            h = getattr(cns, "reserve_hint", None)
            if h is not None:
                h(est)
    names = [getattr(c, "SPAN", f"seeksv.scan.{type(c).__name__.lower()}")
             for c in consumers]
    import queue
    import threading
    q: "queue.Queue" = queue.Queue(maxsize=1)
    _SENTINEL = object()
    stop = threading.Event()
    slots = threading.Semaphore(2)  # the consumers' slab and the next

    token = trace.handoff()

    def producer():
        with trace.adopt(token):
            try:
                chunks = read_bam_chunks(bam_path, chunk_records,
                                         lazy_seq=True)
                while True:
                    slots.acquire()
                    if stop.is_set():  # consumer raised: abandon the decode
                        return
                    with trace.span("seeksv.scan.decode"):
                        recs = next(chunks, None)
                    if recs is None:
                        break
                    if stop.is_set():
                        return
                    q.put(recs)
                    del recs
                q.put(_SENTINEL)
            except BaseException as e:  # surfaced in the consumer loop
                q.put(e)

    th = threading.Thread(target=producer, daemon=True)
    th.start()
    try:
        while True:
            with trace.span("seeksv.scan.wait"):
                item = q.get()
            if item is _SENTINEL:
                break
            if isinstance(item, BaseException):
                raise item
            for cns, name in zip(consumers, names):
                with trace.span(name):
                    cns.process(item)
            with trace.span("seeksv.scan.release"):
                del item  # drop the slab before blocking on the next one
            slots.release()
    finally:
        # stop + unblock a producer stuck on put() or on its slot if the
        # consumer raised
        stop.set()
        slots.release()
        while th.is_alive():
            try:
                q.get_nowait()
            except queue.Empty:
                pass
            th.join(timeout=0.05)


def run_pipeline_streaming(ref_fa: str, bam: str, prefix: str, *,
                           device="cuda", chunk_records: int = 2_000_000,
                           normal_bam: Optional[str] = None,
                           min_mapq: int = 20,
                           read_pair_used: int = 5_000_000,
                           device_seed: bool = False,
                           device_align: bool = False,
                           index: Optional[KmerIndex] = None,
                           filtered_out=None,
                           profile_dir: Optional[str] = None,
                           log=lambda *a: None) -> dict:
    """Write the outputs of ``run_pipeline`` with bounded-memory ingestion.
    Arguments as in ``pipeline.driver.run_pipeline`` (no force_host or
    rescue, as in the reference's streaming driver; filtered_out, a text
    stream, takes getsv's filtered candidates), plus chunk_records
    (records per decode slab), min_mapq and read_pair_used (the getsv
    statistics' settings, the reference's defaults).  profile_dir: trace
    the whole call with ``torch.profiler`` into
    ``{profile_dir}/{basename(prefix)}.trace.json``, the program's spans
    and counters with it (utils/trace.py).  Returns {"stages_s",
    "aligner"} as ``run_pipeline`` does."""
    device = torch.device(device)
    stages = {}
    t0 = time.perf_counter()
    with profiled(profile_dir, device) as prof, \
            trace.driver_pass(stages, "total"):
        native_stage(device, stages)
        with trace.span("seeksv.stage.scan_bam", stages, "scan_bam"):
            gstream = GetclipStream(prefix)
            stats = StreamStats(min_mapq, read_pair_used)
            scan_bam(bam, chunk_records, [gstream, stats])
            gstream.close()
        log(f"[{time.perf_counter() - t0:.2f}s] streaming getclip+stats "
            f"done ({stats.n:,} records)")
        with trace.span("seeksv.stage.index", stages, "index"):
            if index is None:
                index = Aligner.from_fasta(ref_fa).idx
            aligner = BatchAligner(index, device=device)
        with trace.span("seeksv.stage.realign", stages, "realign"):
            realign_clips(ref_fa, f"{prefix}.clip.fq.gz",
                          f"{prefix}.clip.sam", aligner=aligner,
                          device_seed=device_seed, device_align=device_align,
                          chunk_reads=200_000)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        log(f"[{time.perf_counter() - t0:.2f}s] realignment done")
        with trace.span("seeksv.stage.getsv", stages, "getsv"):
            getsv(f"{prefix}.clip.sam", bam, f"{prefix}.clip.gz",
                  f"{prefix}.sv", f"{prefix}.unmapped.clip.fq", stats=stats,
                  filtered_out=filtered_out or io.StringIO(), log=log)
        log(f"[{time.perf_counter() - t0:.2f}s] getsv done -> {prefix}.sv")
        if normal_bam:
            with trace.span("seeksv.stage.somatic", stages, "somatic"):
                nprefix = f"{prefix}.normal"
                with trace.span("seeksv.somatic.scan"):
                    ngstream = GetclipStream(nprefix)
                    nstats = StreamStats(min_mapq, read_pair_used)
                    scan_bam(normal_bam, chunk_records, [ngstream, nstats])
                    ngstream.close()
                somatic(normal_bam, f"{nprefix}.clip.gz", f"{prefix}.sv",
                        f"{prefix}.somatic.temp.sv", stats=nstats)
                somatic_filter(f"{prefix}.somatic.temp.sv",
                               f"{prefix}.somatic.sv")
            log(f"[{time.perf_counter() - t0:.2f}s] somatic done -> "
                f"{prefix}.somatic.sv")
    export_profile(prof, profile_dir, prefix, stages, log)
    return {"stages_s": stages, "aligner": aligner}
