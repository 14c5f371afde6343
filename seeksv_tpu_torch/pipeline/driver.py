"""One-shot ``run`` pipeline on a torch device: the reference's 3-step
shell workflow (example/seeksv.sh + seeksv.somatic.sh) as a single
in-framework call — no external aligner, no awk.

Counterpart of ``seeksv_tpu/pipeline/driver.py``: read_bam -> getclip ->
realign_clips -> getsv [-> somatic], with ``realign_clips`` driving a
``BatchAligner`` on an explicit device.  There is no profiler hook and no
calibration.
"""
from __future__ import annotations

import gzip
import io
import time
from typing import Optional

import numpy as np
import torch

from ..align.engine import _RC, Aligner, BatchAligner, _cigar_str
from ..align.index import KmerIndex
from ..io import native
from ..io.bam import read_bam
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
    t0 = time.perf_counter()
    if aligner is None:
        aligner = BatchAligner.from_fasta(ref_fa)
    # full stage accounting: aligner.timings must sum to the realign
    # stage wall
    aligner.timings["index_load_s"] = \
        aligner.timings.get("index_load_s", 0.0) + time.perf_counter() - t0
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
                t0 = time.perf_counter()
                write_sam_records(aligner, seqs, quals, alns, out)
                aligner.timings["write_sam_s"] = \
                    aligner.timings.get("write_sam_s", 0.0) \
                    + time.perf_counter() - t0
        return aligner
    t0 = time.perf_counter()
    seqs, quals = _read_fastq(clip_fq)
    aligner.timings["read_fq_s"] = \
        aligner.timings.get("read_fq_s", 0.0) + time.perf_counter() - t0
    alns = aligner.batch_align(seqs, force_device=force_device,
                               force_host=force_host)
    t0 = time.perf_counter()
    write_sam(aligner, seqs, quals, alns, out_sam)
    aligner.timings["write_sam_s"] = \
        aligner.timings.get("write_sam_s", 0.0) + time.perf_counter() - t0
    return aligner


def native_stage(device: torch.device, stages: dict) -> None:
    """Build and load the native host library once, timed as its own
    stage (a first build takes seconds that are no part of read_bam); on
    a CUDA device the library must load."""
    t = time.perf_counter()
    if not native.available() and device.type == "cuda":
        raise RuntimeError(
            "the native host library did not build or load; the CUDA "
            f"path needs it: {native.LOAD_ERROR}")
    stages["native"] = time.perf_counter() - t


def run_pipeline(ref_fa: str, bam: str, prefix: str, *, device="cuda",
                 normal_bam: Optional[str] = None, force_host: bool = False,
                 device_seed: bool = False, device_align: bool = False,
                 index: Optional[KmerIndex] = None,
                 log=lambda *a: None) -> dict:
    """Write ``{prefix}.clip.gz``, ``.clip.fq.gz``, ``.clip.sam``, ``.sv``
    (and ``.somatic.sv`` with ``normal_bam``), as the reference does.

    device: where the extension and finalize kernels run (``cuda`` or
    ``cpu`` for their plain versions).  force_host: keep both on the
    native host kernels.  device_seed / device_align: the device
    front-ends of ``run --device-seed`` / ``--device-align`` (seeding on
    the device; or seeding, window gather and both extension rounds).
    index: a prebuilt k-mer index of ``ref_fa``
    (else built, or loaded from the port's own ~/.cache/seeksv_tpu_torch
    cache).  Returns {"stages_s": wall seconds per stage, "aligner": the
    BatchAligner (its .timings split the realign stage)}.

    On a CUDA device the native host library must load (the finalize
    batching runs beside the card through it): else this raises."""
    device = torch.device(device)
    stages = {}
    t0 = time.perf_counter()
    native_stage(device, stages)
    t = time.perf_counter()
    recs = read_bam(bam)
    stages["read_bam"] = time.perf_counter() - t
    log(f"[{stages['read_bam']:.2f}s] decoded {recs.n} records")
    t = time.perf_counter()
    getclip(bam, prefix, recs=recs)
    stages["getclip"] = time.perf_counter() - t
    t = time.perf_counter()
    if index is None:
        index = Aligner.from_fasta(ref_fa).idx
    aligner = BatchAligner(index, device=device)
    stages["index"] = time.perf_counter() - t
    t = time.perf_counter()
    realign_clips(ref_fa, f"{prefix}.clip.fq.gz", f"{prefix}.clip.sam",
                  aligner=aligner, device_seed=device_seed,
                  device_align=device_align, force_host=force_host)
    if aligner.device.type == "cuda":
        torch.cuda.synchronize(aligner.device)
    stages["realign"] = time.perf_counter() - t
    log(f"[{time.perf_counter() - t0:.2f}s] realignment done")
    t = time.perf_counter()
    getsv(f"{prefix}.clip.sam", bam, f"{prefix}.clip.gz", f"{prefix}.sv",
          f"{prefix}.unmapped.clip.fq", recs=recs,
          filtered_out=io.StringIO(), log=log)
    stages["getsv"] = time.perf_counter() - t
    log(f"[{time.perf_counter() - t0:.2f}s] getsv done -> {prefix}.sv")
    if normal_bam:
        t = time.perf_counter()
        nrecs = read_bam(normal_bam)
        nprefix = f"{prefix}.normal"
        getclip(normal_bam, nprefix, recs=nrecs)
        somatic(normal_bam, f"{nprefix}.clip.gz", f"{prefix}.sv",
                f"{prefix}.somatic.temp.sv", recs=nrecs)
        somatic_filter(f"{prefix}.somatic.temp.sv", f"{prefix}.somatic.sv")
        stages["somatic"] = time.perf_counter() - t
        log(f"[{time.perf_counter() - t0:.2f}s] somatic done -> "
            f"{prefix}.somatic.sv")
    stages["total"] = time.perf_counter() - t0
    return {"stages_s": stages, "aligner": aligner}
