"""One-shot ``run`` pipeline on a torch device: the reference's 3-step
shell workflow (example/seeksv.sh + seeksv.somatic.sh) as a single
in-framework call — no external aligner, no awk.

Counterpart of ``seeksv_tpu/pipeline/driver.py``: read_bam -> getclip ->
realign_clips -> getsv [-> somatic], with ``realign_clips`` driving a
``BatchAligner`` on an explicit device, and ``profile_dir`` tracing the
call with ``torch.profiler``.  The stages are ``utils/trace.py`` spans.
"""
from __future__ import annotations

import contextlib
import gzip
import io
import os
import time
from typing import Optional

import numpy as np
import torch

from ..align.engine import _RC, Aligner, BatchAligner, _cigar_str
from ..align.index import KmerIndex
from ..io import native
from ..io.bam import read_bam
from ..utils import trace
from .getclip import getclip
from .getsv import getsv
from .somatic import somatic, somatic_filter


def _read_fastq(path):
    seqs, quals = [], []
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        while True:
            h = f.readline()
            if not h:
                break
            seqs.append(f.readline().strip().encode())
            f.readline()
            quals.append(f.readline().strip())
    return seqs, quals


def _iter_fastq_chunks(path, chunk_reads: int):
    """Yield (seqs, quals) chunks — the bounded-memory form of
    _read_fastq for the streaming pipelines: the realign phase's
    live set is one chunk, not the whole clip fastq."""
    opener = gzip.open if path.endswith(".gz") else open
    seqs, quals = [], []
    with opener(path, "rt") as f:
        while True:
            h = f.readline()
            if not h:
                break
            seqs.append(f.readline().strip().encode())
            f.readline()
            quals.append(f.readline().strip())
            if len(seqs) >= chunk_reads:
                yield seqs, quals
                seqs, quals = [], []
    if seqs:
        yield seqs, quals


def write_sam_header(aligner, out) -> None:
    out.write("@HD\tVN:1.5\tSO:unsorted\n")
    for name, ln in zip(aligner.idx.chrom_names,
                        np.diff(aligner.idx.chrom_starts)):
        out.write(f"@SQ\tSN:{name}\tLN:{int(ln)}\n")


def write_sam(aligner, seqs, quals, alns, path) -> None:
    with open(path, "w") as out:
        write_sam_header(aligner, out)
        write_sam_records(aligner, seqs, quals, alns, out)


def write_sam_records(aligner, seqs, quals, alns, out) -> None:
    for seq, qual, a in zip(seqs, quals, alns):
        qn = seq.decode()
        if not a.mapped:
            out.write(f"{qn}\t4\t*\t0\t0\t*\t*\t0\t0\t{qn}\t{qual}\n")
            continue
        oseq, oq = qn, qual
        if a.strand:
            oseq = bytes(_RC[np.frombuffer(seq, np.uint8)][::-1]).decode()
            oq = qual[::-1]
        out.write(f"{qn}\t{16 if a.strand else 0}\t"
                  f"{aligner.idx.chrom_names[a.tid]}\t{a.pos + 1}\t"
                  f"{a.mapq}\t{_cigar_str(a.cigar)}\t*\t0\t0\t{oseq}\t{oq}\n")
        for s in (a.supp or []):
            # chimeric split part (bwa supplementary, flag 0x800):
            # hard-clipped, SEQ/QUAL restricted to the aligned span
            sseq, sq = oseq, oq
            if s.strand != a.strand:
                sseq = bytes(
                    _RC[np.frombuffer(sseq.encode(),
                                      np.uint8)][::-1]).decode()
                sq = sq[::-1]
            out.write(f"{qn}\t{2048 | (16 if s.strand else 0)}\t"
                      f"{aligner.idx.chrom_names[s.tid]}\t{s.pos + 1}\t"
                      f"{s.mapq}\t{_cigar_str(s.cigar)}\t*\t0\t0\t"
                      f"{sseq[s.qb:s.qe]}\t{sq[s.qb:s.qe]}\n")


def realign_clips(ref_fa: str, clip_fq: str, out_sam: str,
                  aligner: Optional[BatchAligner] = None,
                  device_seed: bool = False,
                  device_align: bool = False,
                  force_device: bool = False,
                  force_host: bool = False,
                  chunk_reads: Optional[int] = None) -> BatchAligner:
    """chunk_reads: when set, the clip fastq streams through in chunks
    of that many reads (bounded-memory realign for the streaming
    pipelines)."""
    # full stage accounting: aligner.timings must sum to the realign
    # stage wall
    load = {}
    with trace.span("seeksv.engine.index_load", load, "s"):
        if aligner is None:
            aligner = BatchAligner.from_fasta(ref_fa)
    aligner.timings["index_load_s"] = \
        aligner.timings.get("index_load_s", 0.0) + load["s"]
    if device_seed:
        aligner.device_seed = True
    if device_align:
        aligner.device_align = True
    if chunk_reads:
        with open(out_sam, "w") as out:
            write_sam_header(aligner, out)
            for seqs, quals in _iter_fastq_chunks(clip_fq, chunk_reads):
                alns = aligner.batch_align(seqs, force_device=force_device,
                                           force_host=force_host)
                with trace.span("seeksv.engine.write_sam", aligner.timings,
                                "write_sam_s"):
                    write_sam_records(aligner, seqs, quals, alns, out)
        return aligner
    with trace.span("seeksv.engine.read_fq", aligner.timings, "read_fq_s"):
        seqs, quals = _read_fastq(clip_fq)
    alns = aligner.batch_align(seqs, force_device=force_device,
                               force_host=force_host)
    with trace.span("seeksv.engine.write_sam", aligner.timings,
                    "write_sam_s"):
        write_sam(aligner, seqs, quals, alns, out_sam)
    return aligner


def native_stage(device: torch.device, stages: dict) -> None:
    """Build and load the native host library once, timed as its own
    stage (a first build takes seconds that are no part of read_bam); on
    a CUDA device the library must load."""
    with trace.span("seeksv.stage.native", stages, "native"):
        if not native.available() and device.type == "cuda":
            raise RuntimeError(
                "the native host library did not build or load; the CUDA "
                f"path needs it: {native.LOAD_ERROR}")


def profiled(profile_dir: Optional[str], device: torch.device):
    """A torch.profiler context over CPU and, on a CUDA device, CUDA
    activity; a null context without profile_dir."""
    if not profile_dir:
        return contextlib.nullcontext()
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def export_profile(prof, profile_dir: Optional[str], prefix: str,
                   stages: dict, log) -> None:
    """Write a finished ``profiled`` trace to
    ``{profile_dir}/{basename(prefix)}.trace.json`` (nothing without
    one), timed as the ``profile_export`` stage."""
    if prof is None:
        return
    with trace.span("seeksv.stage.profile_export", stages,
                    "profile_export"):
        os.makedirs(profile_dir, exist_ok=True)
        path = os.path.join(profile_dir,
                            f"{os.path.basename(prefix)}.trace.json")
        prof.export_chrome_trace(path)
    log(f"profile trace -> {path}")


def run_pipeline(ref_fa: str, bam: str, prefix: str, *, device="cuda",
                 normal_bam: Optional[str] = None, force_host: bool = False,
                 rescue: bool = False, filtered_out=None,
                 profile_dir: Optional[str] = None,
                 device_seed: bool = False, device_align: bool = False,
                 index: Optional[KmerIndex] = None,
                 log=lambda *a: None) -> dict:
    """Write ``{prefix}.clip.gz``, ``.clip.fq.gz``, ``.clip.sam``, ``.sv``
    (and ``.somatic.sv`` with ``normal_bam``), as the reference does.

    device: where the extension and finalize kernels run (``cuda`` or
    ``cpu`` for their plain versions).  force_host: keep both on the
    native host kernels.  rescue: getsv writes the unmapped clipped
    sequences to ``{prefix}.unmapped.clip.fq`` (``getsv --rescue``).
    filtered_out: a text stream that takes getsv's filtered candidates.
    profile_dir: trace the whole call with ``torch.profiler`` (CPU and,
    on a CUDA device, CUDA activity), the program's spans and counters
    with it (utils/trace.py), and write the Chrome trace to
    ``{profile_dir}/{basename(prefix)}.trace.json``; where the
    reference's ``try/except`` runs on without a trace when the profiler
    fails to start, this raises.  device_seed / device_align: the device
    front-ends of ``run --device-seed`` / ``--device-align`` (seeding on
    the device; or seeding, window gather and both extension rounds).
    index: a prebuilt k-mer index of ``ref_fa``
    (else built, or loaded from the port's own ~/.cache/seeksv_tpu_torch
    cache).  Returns {"stages_s": wall seconds per stage (each the span
    ``seeksv.stage.<key>``; ``total`` the call's ``seeksv.pass``),
    "aligner": the BatchAligner (its .timings split the realign stage)}.

    On a CUDA device the native host library must load (the finalize
    batching runs beside the card through it): else this raises."""
    device = torch.device(device)
    stages = {}
    t0 = time.perf_counter()
    with profiled(profile_dir, device) as prof, \
            trace.driver_pass(stages, "total"):
        native_stage(device, stages)
        with trace.span("seeksv.stage.read_bam", stages, "read_bam"):
            recs = read_bam(bam)
        log(f"[{stages['read_bam']:.2f}s] decoded {recs.n} records")
        with trace.span("seeksv.stage.getclip", stages, "getclip"):
            getclip(bam, prefix, recs=recs)
        with trace.span("seeksv.stage.index", stages, "index"):
            if index is None:
                index = Aligner.from_fasta(ref_fa).idx
            aligner = BatchAligner(index, device=device)
        with trace.span("seeksv.stage.realign", stages, "realign"):
            realign_clips(ref_fa, f"{prefix}.clip.fq.gz",
                          f"{prefix}.clip.sam", aligner=aligner,
                          device_seed=device_seed, device_align=device_align,
                          force_host=force_host)
            if aligner.device.type == "cuda":
                torch.cuda.synchronize(aligner.device)
        log(f"[{time.perf_counter() - t0:.2f}s] realignment done")
        with trace.span("seeksv.stage.getsv", stages, "getsv"):
            getsv(f"{prefix}.clip.sam", bam, f"{prefix}.clip.gz",
                  f"{prefix}.sv", f"{prefix}.unmapped.clip.fq", recs=recs,
                  rescue=rescue, filtered_out=filtered_out or io.StringIO(),
                  log=log)
        log(f"[{time.perf_counter() - t0:.2f}s] getsv done -> {prefix}.sv")
        if normal_bam:
            with trace.span("seeksv.stage.somatic", stages, "somatic"):
                with trace.span("seeksv.somatic.scan"):
                    nrecs = read_bam(normal_bam)
                    nprefix = f"{prefix}.normal"
                    getclip(normal_bam, nprefix, recs=nrecs)
                somatic(normal_bam, f"{nprefix}.clip.gz", f"{prefix}.sv",
                        f"{prefix}.somatic.temp.sv", recs=nrecs)
                somatic_filter(f"{prefix}.somatic.temp.sv",
                               f"{prefix}.somatic.sv")
            log(f"[{time.perf_counter() - t0:.2f}s] somatic done -> "
                f"{prefix}.somatic.sv")
    export_profile(prof, profile_dir, prefix, stages, log)
    return {"stages_s": stages, "aligner": aligner}
