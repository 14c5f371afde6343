"""Streaming x SPMD: slab ingestion with the numeric stages on the mesh.

Counterpart of ``seeksv_tpu/parallel/stream_spmd.py``.  The BAM is
decoded once in slabs (``scan_bam``); per slab, on every rank:

  * ``SpmdGetclipStream`` (with ``mesh_consensus=True``) — the reference's
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
from typing import Optional

import numpy as np
import torch

from seeksv_tpu.align.engine import Aligner
from seeksv_tpu.align.index import KmerIndex
from seeksv_tpu.io.bam import BamRecords, OP_H
from seeksv_tpu.pipeline.driver import realign_clips
from seeksv_tpu.pipeline.getclip import GetclipStream
from seeksv_tpu.pipeline.getsv import (DepthQuery, DiscordantCounter,
                                       SV_HEADER, output_breakpoints)
from seeksv_tpu.pipeline.stream import scan_bam

from ..ops import coverage as cov_ops
from ._shared import stream_spmd as _ref
from .mesh import agree, all_gather, all_reduce_sum, mesh_device, shard_index
from .spmd_pipeline import (HIST_SIZE, _insert_columns, is_writer,
                            merge_junction_sharded, mesh_consensus,
                            rank_prefix, spmd_build_junctions,
                            spmd_discordant_counts_sharded, write_rescue_fastq,
                            write_segment)


class SpmdGetclipStream(_ref.SpmdGetclipStream):
    """The reference's slab-incremental getclip (stream_spmd.py:55-167)
    with each chromosome flush's consensus merge on the torch mesh.
    Every rank must process the same slabs."""

    def __init__(self, mesh, prefix: str, threshold: float = 0.85,
                 min_mapq: int = 20, save_low_quality: bool = False,
                 log=lambda *a: None):
        super().__init__(mesh, prefix, threshold, min_mapq,
                         save_low_quality)
        self.log = log

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


class SpmdStreamStats(_ref.SpmdStreamStats):
    """The reference's streaming statistics (stream_spmd.py:177-445) with
    the coverage diff and the insert-size histogram on the torch mesh;
    ``insert_size``, ``light`` and the host routing of the coverage
    points (``_scatter_points``) are the reference's.  Every rank must
    process the same slabs."""

    def process(self, recs: BamRecords) -> None:
        from seeksv_tpu.io import native
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
        if native.stream_end_hard_available():
            end, hard = native.stream_end_hard(recs)
        else:
            first_op = recs.first_op()
            last_op = recs.last_op()
            has_cigar = recs.cig_off[1:] > recs.cig_off[:-1]
            hard = has_cigar & ((first_op == OP_H) | (last_op == OP_H))
            end = recs.pos + recs.ref_span(count_x=True)
        self._cols.append(
            pos=recs.pos, mpos=recs.mpos, mtid=recs.mtid,
            l_qseq=recs.l_qseq, flag=recs.flag, mapq=recs.mapq,
            isize=recs.isize, tid=recs.tid, end=end, hard=hard)

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
    from ..align.engine import TorchBatchAligner
    from ..pipeline.driver import native_stage
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
        aligner = TorchBatchAligner(index, device=dev)
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
