"""Streaming x SPMD: slab ingestion with the numeric stages on the mesh.

Counterpart of ``seeksv_tpu/parallel/stream_spmd.py``.  The BAM is
decoded once in slabs (``scan_bam``); per slab, on every rank:

  * ``SpmdGetclipStream`` (with ``mesh_consensus=True``) — the
    slab-incremental getclip, its consensus merge at each chromosome
    flush on the mesh (``spmd_pipeline.mesh_consensus``, K5); otherwise
    the host ``GetclipStream``.
  * ``SpmdStreamStats`` — coverage as a genome-sharded int32 diff on the
    devices: rank r owns genome slice r and scatter-adds only the slab's
    segment endpoints that fall in it (no collective per slab); the
    slices are gathered and prefix-summed on the device at the end.  The
    first-N insert-size histogram: the take mask on the host (running
    cross-slab offset), each rank's block histogrammed on its device and
    summed over the mesh.  The compact record columns stay on the host.

Then realignment on the mesh (K1w), the junction tables, the discordant
counts (K6) and the output as in ``spmd_pipeline``.  Flat genome
coordinates stay int64 (the reference's stream_spmd.py:371-373 casts
them to int32).  Only rank 0 writes the user's output files.
"""
from __future__ import annotations

import io
import time
import gzip
from typing import Dict, List, Optional

import numpy as np
import torch

from ..align.engine import Aligner, BatchAligner
from ..align.index import KmerIndex
from ..io.bam import (BamRecords, FDUP, FMUNMAP, FPAIRED, FPROPER_PAIR,
                      FUNMAP, OP_H, OP_S)
from ..ops import coverage as cov_ops
from ..pipeline.driver import native_stage, realign_clips
from ..pipeline.getclip import (GetclipStream, _get_sclip_read,
                                _map_len_no_x, _store_unmapped)
from ..pipeline.getsv import (DepthQuery, DiscordantCounter, SV_HEADER,
                              output_breakpoints)
from ..pipeline.stream import LightBam, _GrowCols, _end_hard, scan_bam
from .mesh import agree, all_gather, all_reduce_sum, mesh_device, shard_index
from .spmd_pipeline import (HIST_SIZE, _flat_segments, _insert_columns,
                            _insert_stats_from_hist, is_writer,
                            merge_junction_sharded, mesh_consensus,
                            rank_prefix, spmd_build_junctions,
                            spmd_discordant_counts_sharded, write_rescue_fastq,
                            write_segment)


class _SideSink:
    """Ordered per-position event lists for one clip side of the live
    chromosome (insertion order preserved — the consensus merge is
    order-sensitive, ref InsertSeq clip_reads.cpp:260)."""

    def __init__(self):
        self.by_pos: Dict[int, list] = {}

    def insert(self, pos, s_l, q_l, s_r, q_r, cigar, limit, left_clipped):
        self.by_pos.setdefault(int(pos), []).append(
            (int(pos), s_l, q_l, s_r, q_r, list(cigar)))


class SpmdGetclipStream:
    """Slab-incremental getclip (the flush/drop quirks of
    pipeline.getclip.GetclipStream) with each chromosome flush's
    consensus merge on the torch mesh (K5).  process(slab) in file order
    == the whole-file spmd_getclip pass.  Every rank must process the
    same slabs."""

    def __init__(self, mesh, prefix: str, threshold: float = 0.85,
                 min_mapq: int = 20, save_low_quality: bool = False,
                 log=lambda *a: None):
        self.mesh = mesh
        self.log = log
        self.threshold = threshold
        self.min_mapq = min_mapq
        self.save_low_quality = save_low_quality
        self.soft_out = gzip.open(f"{prefix}.clip.gz", "wt", compresslevel=1)
        self.fq_out = gzip.open(f"{prefix}.clip.fq.gz", "wt", compresslevel=1)
        # binary: _store_unmapped writes bytes
        self.un1 = gzip.open(f"{prefix}.unmapped_1.fq.gz", "wb",
                             compresslevel=1)
        self.un2 = gzip.open(f"{prefix}.unmapped_2.fq.gz", "wb",
                             compresslevel=1)
        self.left = _SideSink()
        self.right = _SideSink()
        self.id2seq_qual: Dict[bytes, tuple] = {}
        self.last_tid = 0
        self.ref_names: List[str] = []

    def _flush(self, tid: int) -> None:
        chrom = (self.ref_names[tid] if 0 <= tid < len(self.ref_names)
                 else str(tid))
        group_keys = []
        group_events = []
        for side, sink in ((0, self.left), (1, self.right)):
            for pos, evs in sink.by_pos.items():
                group_keys.append((0, side, pos))
                group_events.append(evs)
        consensus = mesh_consensus(self.mesh, group_keys, group_events,
                                   self.threshold, self.log)
        write_segment(self.soft_out, self.fq_out, chrom, consensus,
                      list(consensus))
        self.left.by_pos.clear()
        self.right.by_pos.clear()

    def process(self, recs: BamRecords) -> None:
        self.ref_names = recs.ref_names
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

        for i in np.nonzero(unmapped_any)[0]:
            _store_unmapped(recs, int(i), self.id2seq_qual, self.un1,
                            self.un2)

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
                for i in run[clip_candidate[run]]:
                    _get_sclip_read(recs, int(i), self.left, self.right,
                                    self.threshold, self.save_low_quality,
                                    first_op, last_op, first_len, last_len,
                                    map_len)

    def close(self) -> None:
        self._flush(self.last_tid)
        self.soft_out.close()
        self.fq_out.close()
        self.un1.close()
        self.un2.close()


class SpmdStreamStats:
    """Streaming statistics with the coverage diff and the insert-size
    histogram on the torch mesh (see module docstring): the coverage
    accumulates as a genome-sharded diff, each slab's segment endpoints
    becoming +-1 points that the owner rank scatter-adds into its slice
    (no collective per slab, no replicated genome copies).  Every rank
    must process the same slabs."""

    def __init__(self, mesh, min_mapq: int, read_pair_used: int):
        self.mesh = mesh
        self.min_mapq = min_mapq
        self.read_pair_used = read_pair_used
        self.ref_names: List[str] = []
        self.ref_lens: List[int] = []
        self.n = 0
        self._acc = None          # this rank's genome slice, int32 diff
        self._offsets = None
        self._g_pad = 0
        self._g_local = 0         # genome slice per rank
        self._hist = np.zeros(HIST_SIZE, np.int64)
        self._base = 0            # qualifying records seen so far (first-N)
        self._cols = _GrowCols(("pos", "mpos", "mtid", "l_qseq", "flag",
                                "mapq", "isize", "tid", "end", "hard"))
        self._pend_pts: list = []
        self._pend_val: list = []
        self._pend_n = 0

    def reserve_hint(self, n_records: int) -> None:
        self._cols.hint(n_records)

    def process(self, recs: BamRecords) -> None:
        self.ref_names = recs.ref_names
        self.ref_lens = list(recs.ref_lens)
        self.n += recs.n
        mesh = self.mesh
        ndev = mesh.size()
        if self._offsets is None:
            lens = np.asarray(recs.ref_lens, np.int64)
            self._offsets = np.concatenate([[0], np.cumsum(lens)])
            self._g_pad = int(self._offsets[-1])
            self._g_local = -(-self._g_pad // ndev)
            self._acc = torch.zeros(self._g_local, dtype=torch.int32,
                                    device=mesh_device(mesh))
        # segment endpoints -> +-1 points, buffered across slabs
        self._scatter_points(recs)

        # insert-size histogram with the running cross-slab first-N offset
        if agree(mesh, [self._base < self.read_pair_used])[0]:
            ok, isz, _over = _insert_columns(recs, self.min_mapq)
            room = self.read_pair_used - self._base
            idx = np.nonzero(ok)[0]
            take = ok
            if len(idx) > room:
                take = np.zeros_like(ok)
                take[idx[:room]] = True
            per = -(-max(recs.n, 1) // ndev)
            a = min(shard_index(mesh) * per, recs.n)
            b = min(a + per, recs.n)
            dev = mesh_device(mesh)
            hist = cov_ops.insert_histogram(
                torch.from_numpy(isz[a:b]).to(dev),
                torch.from_numpy(take[a:b]).to(dev), HIST_SIZE)
            all_reduce_sum(mesh, hist)
            self._hist += hist.cpu().numpy().astype(np.int64)
            self._base += int(ok.sum())

        # compact host columns (the discordant-window working set)
        end, hard = _end_hard(recs)
        self._cols.append(
            pos=recs.pos, mpos=recs.mpos, mtid=recs.mtid,
            l_qseq=recs.l_qseq, flag=recs.flag, mapq=recs.mapq,
            isize=recs.isize, tid=recs.tid, end=end, hard=hard)

    def _scatter_points(self, recs: BamRecords) -> None:
        st, en = _flat_segments(recs, self.min_mapq, self._offsets,
                                self._g_pad)
        pts = np.concatenate([st, en])
        val = np.empty(2 * len(st), np.int32)
        val[:len(st)] = 1
        val[len(st):] = -1
        inb = pts < self._g_pad
        self._pend_pts.append(pts[inb])
        self._pend_val.append(val[inb])
        self._pend_n += int(inb.sum())
        if self._pend_n >= 16_000_000:
            self._flush_points()

    def _flush_points(self) -> None:
        """Scatter-add the buffered points of this rank's genome slice
        into its diff (local: no collective)."""
        if self._pend_n == 0:
            return
        pts = np.concatenate(self._pend_pts)
        val = np.concatenate(self._pend_val)
        self._pend_pts, self._pend_val, self._pend_n = [], [], 0
        lo = shard_index(self.mesh) * self._g_local
        sel = (pts >= lo) & (pts < lo + self._g_local)
        dev = self._acc.device
        self._acc.index_add_(0, torch.from_numpy(pts[sel] - lo).to(dev),
                             torch.from_numpy(val[sel]).to(dev))

    def coverage(self):
        """Gather the genome slices, prefix-sum on the device -> per-tid
        int32 depth arrays."""
        if self._offsets is None:
            return {t: np.zeros(int(L), np.int32)
                    for t, L in enumerate(self.ref_lens)}
        self._flush_points()
        diff = all_gather(self.mesh, self._acc)[:self._g_pad]
        cum = cov_ops.prefix_sum_i32(diff).cpu().numpy()
        return {t: cum[int(self._offsets[t]):int(self._offsets[t + 1])]
                for t in range(len(self.ref_names))}

    def insert_size(self):
        """Exact cluster.cpp:15-83 stats from the mesh-summed histogram,
        with host-side spill for isize >= HIST_SIZE (the LightBam columns hold
        every record's exact isize)."""
        isize = self._cols.view("isize")
        flag = self._cols.view("flag").astype(np.int32)
        mapq = self._cols.view("mapq").astype(np.int32)
        hard = self._cols.view("hard")
        ok = ((mapq >= self.min_mapq) & ((flag & FPAIRED) != 0)
              & ((flag & FPROPER_PAIR) != 0) & ((flag & FDUP) == 0)
              & (isize > 0) & ~hard)
        over = isize >= HIST_SIZE
        extra = ()
        hist = self._hist.copy()
        if (ok & over).any():
            rank = np.cumsum(ok) - 1
            taken_over = ok & over & (rank < self.read_pair_used)
            extra = isize[taken_over].astype(np.int64)
            hist[HIST_SIZE - 1] -= len(extra)
        return _insert_stats_from_hist(hist, extra)

    def light(self) -> LightBam:
        v = self._cols.view
        return LightBam(self.ref_names, self.ref_lens, self.n,
                        v("pos"), v("mpos"), v("mtid"), v("l_qseq"),
                        v("flag"), v("mapq"), v("isize"), v("tid"),
                        v("end"), v("hard"))


def spmd_run_pipeline_streaming(mesh, ref_fa: str, bam: str, prefix: str, *,
                                chunk_records: int = 2_000_000,
                                min_mapq: int = 20,
                                read_pair_used: int = 5_000_000,
                                force_device_extend: bool = False,
                                mesh_consensus: bool = False,
                                filtered_out=None,
                                index: Optional[KmerIndex] = None,
                                log=lambda *a: None) -> dict:
    """The whole pipeline with slab ingestion and the numeric stages on
    the mesh (stream_spmd.py:448-531); rank 0 writes the outputs of
    ``spmd_run_pipeline``.  mesh_consensus=True runs the getclip
    consensus on the mesh (K5), False on the host's native kernels.
    Every rank of the mesh calls it with the same arguments.  Returns
    {"stages_s", "aligner", "sv"}."""
    dev = mesh_device(mesh)
    stages: dict = {}
    t0 = time.perf_counter()
    native_stage(dev, stages)
    with rank_prefix(mesh, prefix) as work:
        t = time.perf_counter()
        gs = (SpmdGetclipStream(mesh, work, log=log) if mesh_consensus
              else GetclipStream(work))
        stats = SpmdStreamStats(mesh, min_mapq, read_pair_used)
        scan_bam(bam, chunk_records, [gs, stats])
        gs.close()
        stages["scan_bam"] = time.perf_counter() - t
        log(f"[{time.perf_counter() - t0:.2f}s] spmd streaming getclip+stats "
            f"done ({stats.n:,} records)")
        t = time.perf_counter()
        if index is None:
            index = Aligner.from_fasta(ref_fa).idx
        aligner = BatchAligner(index, device=dev)
        aligner.shard_mesh = mesh
        stages["index"] = time.perf_counter() - t
        t = time.perf_counter()
        realign_clips(ref_fa, f"{work}.clip.fq.gz", f"{work}.clip.sam",
                      aligner=aligner, force_device=force_device_extend,
                      chunk_reads=200_000)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        stages["realign"] = time.perf_counter() - t
        log(f"[{time.perf_counter() - t0:.2f}s] spmd realign done")
        t = time.perf_counter()
        jmap, rescue_events = spmd_build_junctions(
            mesh, f"{work}.clip.gz", f"{work}.clip.sam", 0, False)
        stages["junctions"] = time.perf_counter() - t
    t = time.perf_counter()
    merge_junction_sharded(jmap, 50)
    stages["merge"] = time.perf_counter() - t
    mean, dev_ = stats.insert_size()
    log(f"Mean insert size: {mean}; deviation: {dev_}")
    recs = stats.light()
    t = time.perf_counter()
    counter = DiscordantCounter(recs, min_mapq, mean, dev_, 4)
    counts = spmd_discordant_counts_sharded(mesh, counter,
                                            [j for j, _ in jmap.items], log)
    for (_j, o), c in zip(jmap.items, counts):
        o.abnormal = int(c)
    stages["discordant"] = time.perf_counter() - t
    t = time.perf_counter()
    cov = stats.coverage()
    if is_writer(mesh):
        depth = DepthQuery(recs, min_mapq, cov=cov)
        with open(f"{prefix}.sv", "w") as fout:
            fout.write(SV_HEADER + "\n")
            output_breakpoints(jmap, depth, 200, 3, 0, 0.1, 50, 50, 30, 1,
                               fout, filtered_out or io.StringIO(), True, 5,
                               500)
        write_rescue_fastq(f"{prefix}.unmapped.clip.fq", rescue_events)
    stages["output"] = time.perf_counter() - t
    stages["total"] = time.perf_counter() - t0
    log(f"[{stages['total']:.2f}s] spmd streaming getsv done -> {prefix}.sv")
    return {"stages_s": stages, "aligner": aligner, "sv": f"{prefix}.sv"}
