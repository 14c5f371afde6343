"""One-shot ``run`` pipeline on a torch device.

Counterpart of ``seeksv_tpu/pipeline/driver.py:run_pipeline``: read_bam
-> getclip -> realign_clips -> getsv [-> somatic], with the shared
numpy/C++ stages and the shared ``realign_clips`` driving a
``TorchBatchAligner``.  There is no profiler hook and no calibration.
"""
from __future__ import annotations

import io
import time
from typing import Optional

import torch

from seeksv_tpu.align.engine import Aligner
from seeksv_tpu.align.index import KmerIndex
from seeksv_tpu.io.bam import read_bam
from seeksv_tpu.pipeline.driver import realign_clips
from seeksv_tpu.pipeline.getclip import getclip
from seeksv_tpu.pipeline.getsv import getsv
from seeksv_tpu.pipeline.somatic import somatic, somatic_filter

from .._build import ensure_native
from ..align.engine import TorchBatchAligner


def native_stage(device: torch.device, stages: dict) -> None:
    """Build the shared C++ host kernels once, timed as their own stage
    (a first build takes seconds that are no part of read_bam); on a CUDA
    device the library must load."""
    t = time.perf_counter()
    if not ensure_native() and device.type == "cuda":
        raise RuntimeError(
            "the native host library (csrc/libseeksv_native.so) did not "
            "build or load; the CUDA path needs it")
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
    (else built, or loaded from the ~/.cache/seeksv_tpu cache, as the
    reference does).  Returns {"stages_s": wall seconds per stage, "aligner": the
    TorchBatchAligner (its .timings split the realign stage)}.

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
    aligner = TorchBatchAligner(index, device=device)
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
