"""Streaming ``run`` (``run --stream``) on a torch device.

Counterpart of ``seeksv_tpu/pipeline/stream.py:run_pipeline_streaming``:
each BAM is decoded once in ``chunk_records`` slabs that feed getclip and
the getsv statistics together (``scan_bam``, ``GetclipStream`` and
``StreamStats`` are the reference's, imported), then the clip fastq is
realigned in chunks of 200,000 reads by a ``TorchBatchAligner``, and
getsv [+ somatic] run on the streamed statistics.
"""
from __future__ import annotations

import io
import time
from typing import Optional

import torch

from seeksv_tpu.align.engine import Aligner
from seeksv_tpu.align.index import KmerIndex
from seeksv_tpu.pipeline.driver import realign_clips
from seeksv_tpu.pipeline.getclip import GetclipStream
from seeksv_tpu.pipeline.getsv import getsv
from seeksv_tpu.pipeline.somatic import somatic, somatic_filter
from seeksv_tpu.pipeline.stream import StreamStats, scan_bam

from ..align.engine import TorchBatchAligner
from .driver import native_stage


def run_pipeline_streaming(ref_fa: str, bam: str, prefix: str, *,
                           device="cuda", chunk_records: int = 2_000_000,
                           normal_bam: Optional[str] = None,
                           min_mapq: int = 20,
                           read_pair_used: int = 5_000_000,
                           device_seed: bool = False,
                           device_align: bool = False,
                           index: Optional[KmerIndex] = None,
                           log=lambda *a: None) -> dict:
    """Write the outputs of ``run_pipeline`` with bounded-memory ingestion.
    Arguments as in ``pipeline.driver.run_pipeline`` (no force_host, as
    in the reference's streaming driver), plus chunk_records
    (records per decode slab), min_mapq and read_pair_used (the getsv
    statistics' settings, the reference's defaults).  Returns
    {"stages_s", "aligner"} as ``run_pipeline`` does."""
    device = torch.device(device)
    stages = {}
    t0 = time.perf_counter()
    native_stage(device, stages)
    t = time.perf_counter()
    gstream = GetclipStream(prefix)
    stats = StreamStats(min_mapq, read_pair_used)
    scan_bam(bam, chunk_records, [gstream, stats])
    gstream.close()
    stages["scan_bam"] = time.perf_counter() - t
    log(f"[{time.perf_counter() - t0:.2f}s] streaming getclip+stats done "
        f"({stats.n:,} records)")
    t = time.perf_counter()
    if index is None:
        index = Aligner.from_fasta(ref_fa).idx
    aligner = TorchBatchAligner(index, device=device)
    stages["index"] = time.perf_counter() - t
    t = time.perf_counter()
    realign_clips(ref_fa, f"{prefix}.clip.fq.gz", f"{prefix}.clip.sam",
                  aligner=aligner, device_seed=device_seed,
                  device_align=device_align, chunk_reads=200_000)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    stages["realign"] = time.perf_counter() - t
    log(f"[{time.perf_counter() - t0:.2f}s] realignment done")
    t = time.perf_counter()
    getsv(f"{prefix}.clip.sam", bam, f"{prefix}.clip.gz", f"{prefix}.sv",
          f"{prefix}.unmapped.clip.fq", stats=stats,
          filtered_out=io.StringIO(), log=log)
    stages["getsv"] = time.perf_counter() - t
    log(f"[{time.perf_counter() - t0:.2f}s] getsv done -> {prefix}.sv")
    if normal_bam:
        t = time.perf_counter()
        nprefix = f"{prefix}.normal"
        ngstream = GetclipStream(nprefix)
        nstats = StreamStats(min_mapq, read_pair_used)
        scan_bam(normal_bam, chunk_records, [ngstream, nstats])
        ngstream.close()
        somatic(normal_bam, f"{nprefix}.clip.gz", f"{prefix}.sv",
                f"{prefix}.somatic.temp.sv", stats=nstats)
        somatic_filter(f"{prefix}.somatic.temp.sv", f"{prefix}.somatic.sv")
        stages["somatic"] = time.perf_counter() - t
        log(f"[{time.perf_counter() - t0:.2f}s] somatic done -> "
            f"{prefix}.somatic.sv")
    stages["total"] = time.perf_counter() - t0
    return {"stages_s": stages, "aligner": aligner}
