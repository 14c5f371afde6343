#!/usr/bin/env python3
"""Smoke run of the PyTorch port (seeksv_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--workdir build/chip_smoke] [--parent DIR]
                          [--scale-mb 10] [--scale-only]

Phases (each prints its lines; any failure exits non-zero):

1. provenance: torch and CUDA versions, nvcc, triton, the card's name and
   power limit, the rates the bounds are taken against (3.35 TB/s; int32
   at 132 SMs x 64 lanes x nvidia-smi's clocks.max.sm), the build of the
   native host library (and the directory under build/ it was loaded
   from) and of the port's CUDA kernels from seeksv_tpu_torch/csrc (one
   nvcc per source, all started together);
2. each kernel against its plain PyTorch version on the card, exactly
   (integer outputs, tolerance 0), with each kernel's time beside its
   plain version's and its bound: the larger of the bytes the call's data
   need over the memory rate and its int32 operations over the int32
   rate, data-dependent work counted as these inputs need it (an
   extension job's rows until tlen or z-drop, from the plain version).  No
   PyTorch call computes K4's lookup (torch.searchsorted over the full
   keys, timed in phase 3); none computes any other kernel's function,
   so library_ms is null for each of those, with the reason beside it:
   - K1 on the resident genome at B = 18,143 jobs, LQ 1024 / LT 1536, in
     both directions (windows off the genome and tlen = 0 rows included).
     18,143 is the flagship's job count in the TPU record
     (BENCH_SCALE.jsonl:27); this simulator gives the flagship 17,999,
     and phase 3 prints the slice's own count beside it;
   - K1w on uploaded windows at one ``--device-align`` chunk's shape:
     B = 8,192 (1,024 strand reads x 8 slots), LQ 1024, LT 1152, half the
     rows empty slots (qlen = tlen = 0);
   - both entries on batches that mix every query-length bin of the
     kernel's dispatch (every bin edge - 1, edge, edge + 1), qlen = 0,
     tlen = 0 slots, random queries that z-drop early, windows running
     off both ends of the genome and a qlen past the bucket LQ, at LQ 1024
     and at LQ 2048 (queries past the widest bin);
   - the banded direction pass at K = 128 and 256 on LQ 1024 (one launch
     per k_real bin), and the walk on its output; the pass again at every
     edge of its k_real bins and one column past it, the narrowest and the
     widest band, n - m of either sign, m = 257 and m = LQ, at LQ 512,
     1024 and 2048, and on sub-batches of one job;
   - the consensus scan on groups of 0, 1, 2, 8, 9 and G reads and groups
     that overflow max_slots, and on groups of 2,000 reads, whose lengths
     and slot state are past a warp's shared memory;
   - the walk (K3) beside its bound and its sector floor (one 32-byte
     sector per row a walk visits, over the memory rate), and on walks
     built to leave its windows (tests/torch_inputs.py:adversarial_walks);
   With ``--parent DIR`` (another checkout) that checkout's traceback.cu,
   seed_lookup.cu and discordant_count.cu are built apart (one nvcc
   each, started together) and timed in turns with this one's on the
   same inputs (parent, this, this, parent); where the two sources
   differ, this one's must be the faster (K6: _count's work past the
   record uploads, the junctions' uploads and the wrapper included);
3. the slice: the repo's virus-integration flagship dataset (40 Mb host
   + 12 Mb virus panel, 25x, 1 kb reads, insert mean 3000, 6,000
   integrations at 4 % divergence, error rate 0.002, seed 1) through
   ``seeksv_tpu_torch``'s ``run`` on the card six times: the default
   path, ``device_seed``, ``device_align``, and the streaming driver with
   ``device_align`` at 400,000 records per slab; the launch counters are
   reset just before each run and read just after, and each run must
   launch exactly its own set of kernels (an extension call counts one
   launch per query-length bin of its bucket: 4 at LQ 1024; a direction
   call one per k_real bin: 2 at K 128, 3 at K 256; a consensus call 1)
   and no wrapper may take its plain version.  Between the first two, K1
   is held against its plain version and timed beside its bound on the
   default run's own left-round jobs, K2 likewise on every direction call
   the run made (with the jobs' k_real histogram and the share that
   reaches rung 64), K3 likewise on every walk the run made (calls, live
   walks, steps, time beside the bound and the sector floor), and K4
   (the k-mer lookup) is held against its plain version on the first
   1,024 strand reads of the run's clip fastq (uint16 keys), timed beside
   torch.searchsorted over the table's full keys (a yardstick the port
   never calls).  Then plan_bins, plan_band_bins and the K3 and K4
   wrappers run at the run's shapes under
   torch.cuda.set_sync_debug_mode("error") (none may wait for the card).
   After the ``device_seed`` run, one of its chunks is seeded again:
   its seed call's host time, and a torch.profiler table of the ten
   device ops of its seed_core that take the most time.  Then the SPMD
   pipeline on a one-rank NCCL mesh (``parallel.mesh.make_mesh``):
   ``spmd_run_pipeline`` and ``spmd_run_pipeline_streaming`` (consensus on
   the mesh, 400,000 records per slab), each through K1w, K2, K3, K5
   (consensus scan) and K6 (discordant count) and no resident K1; K5 and
   K6 are then held against their plain versions, exactly, on the inputs
   of the SPMD run's first consensus call (plus 64 groups of random reads
   that overflow max_slots = 8; K5 timed as its launch alone, as the call
   the pipeline makes and with the sides' gathers, each beside a bound
   counted from the bytes it needs) and its discordant call (K6 also on
   its edge cases, tests/torch_inputs.py:discordant_edge_cases; timed as
   its launch alone, warm and cold, the wrapper's call, cold (its ``ms``)
   and warm, and _count's work past the record uploads and from host
   columns, beside a bound from the distinct records the windows read at
   the rate of device memory and one counting each record once a window,
   with torch.profiler tables; with ``--parent``, the parent's kernel
   and _count's work as the parent made it, in turns).  Before the SPMD runs, ``aln -2``
   (align_paired_fastq_to_sam) on the flagship's reference with the
   default run's unmapped_{1,2}.fq.gz and the BAM's first 2,000 proper
   pairs, through K1 both ways, K2 and K3, both ends' dispatch choosing
   the device under the committed crossover, its SAM byte-identical to
   force_host's; then ``run --rescue --profile DIR`` through the port's
   cli.main (the dispatch calibration must not be stale on the card),
   its outputs byte-identical to a force_host run with rescue and its
   torch.profiler trace naming the port's kernels.  On the same
   one-rank mesh, the distributed half (``parallel.multiproc``,
   ``parallel.sharded``; two ranks cannot share one card under NCCL, so
   the range cuts, the boundary exchange and the clip halo do not fire
   here): ``multiprocess_run_pipeline`` (through K1 both ways, K2 and K3,
   as the default run), ``multiprocess_somatic_range`` and
   ``multiprocess_somatic`` with the flagship BAM as its own normal
   against the default run's ``.sv`` (no kernel: the coverage step is
   torch ops on the card), whose temp and final files must be
   byte-identical to the port's sequential getclip + somatic +
   somatic_filter on the same inputs, and ``sharded_evidence_step`` on
   ``make_example_batch`` at 52 Mb, 1,000,000 reads and 8,192 jobs of LQ
   1024 / LT 1152 (through K1w), whose extension results must equal K1w's
   plain version on the same jobs and whose coverage, insert statistics
   and candidate table must equal a numpy recomputation; K1w is timed on
   those jobs beside its bound.  Then the same run with the native host
   kernels (``force_host``): every device run's ``.clip.sam``, ``.sv``
   and decompressed ``.clip.gz`` (the multi-process run's own rank-0
   clip files) must be byte-identical to it, no chunk may overflow to
   host seeding, and at least 90 % of the virus junctions of the truth
   must be called;
4. scale: the port's scale programs through their ``main(argv)`` on the
   card, on short reads (100 bp, 30x, 20 events a Mbp) with the genome
   cut to ``--scale-mb`` (10 Mbp by default, of the JAX record's 100),
   one trial each, datasets and index cached under the workdir:
   ``scripts/bench_scale.py --stream --ab`` (the arms' sv rows and
   clip streams identical, DEL recall >= 0.95, the device arm's dispatch
   on the card in K1's first query-length bin; K1 then held against its
   plain version and timed beside its bound on that arm's first call),
   ``scripts/bench_somatic_scale.py`` (somatic parity exact, recall >=
   0.95, no germline deletion leaked), ``entry()``'s step against its
   plain version, exactly, and ``scripts/bench_stream_spmd.py`` on one
   NCCL rank (sv rows equal to the sequential stream's); each run must
   launch exactly its own kernels.  ``--scale-only`` runs phase 2's K1
   check and this phase alone (the full-size measurements).

The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``.  Without a CUDA device the script
fails before printing any result.  Imports no jax.
"""
from __future__ import annotations

import argparse
import ctypes
import gzip
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def _say(*a):
    print(*a, flush=True)


def _cuda_ms(fn, reps):
    """Mean milliseconds per call over `reps` calls, by CUDA events."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _max_abs_err(pairs):
    """Largest |a - b| over pairs of integer tensors of equal shape."""
    import torch
    err = 0
    for a, b in pairs:
        if a.shape != b.shape:
            raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
        if a.numel():
            err = max(err, int((a.to(torch.int64) - b.to(torch.int64))
                               .abs().max()))
    return err


# The card's peaks a bound is taken against: device memory at 3.35 TB/s
# (H100 SXM data sheet) and the int32 rate of the CUDA cores, 132 SMs x 64
# lanes x the SM clock that nvidia-smi reports as the card's maximum.
MEM_BYTES_PER_S = 3.35e12
INT32_LANES = 132 * 64
RATES = {"int32_ops_per_s": None}

# int32 operations the recurrences need at the least, an operation being
# one instruction of the card: a fused add + max (__viaddmax_s32) counts as
# one, at the plain int32 rate, constants are folded, and what a row needs
# once is counted per row, not per cell.
# Extension (ops/extend.py:extend_batch_plain), a cell: substitution score
# 2 (compare, select), E 2 (max(H - open, E) fused, then - ext), max(diag +
# score, E) 1 fused, the prefix max's step 1 fused (its input g + j folded
# in), F 1, H 1, the row's best 1;
EXTEND_OPS_PER_CELL = 9
# a cell of a row that raises the job's best: the first-occurrence argmax
# (compare, select), which no other row needs;
EXTEND_OPS_PER_CELL_IMPROVED = 2
# a row: the target code and its two flags 3, best / qle / tle 3, H at
# qlen against gscore / gtle 3, the z-drop test 2, column 0's value 1.
EXTEND_OPS_PER_ROW = 12
# Banded direction pass (ops/global_device.py:banded_direction_plain), a
# cell of the band: substitution 2, diagonal 1 (kept apart: a flag
# compares against it), F 2, max(diag, F) 1, the prefix max's step 1
# fused, E 1, H 1, the direction byte's five flags 7 (five compares, the
# two run flags' - ext) and their packing into a byte 4.
BANDED_OPS_PER_CELL = 20
NO_LIBRARY = {
    "extend": "no single PyTorch call computes an affine-gap extension "
              "with z-drop",
    "banded_dir": "no single PyTorch call computes a banded affine DP "
                  "with direction bytes",
    "traceback": "no single PyTorch call walks a direction matrix",
    "consensus_scan": "no single PyTorch call runs a first-match slot "
                      "scan",
    "discordant_count": "no single PyTorch call counts predicates over "
                        "ragged windows",
}


def _bound(ops, nbytes):
    """(bound_ms, bound_by): the larger of `ops` int32 operations at the
    card's int32 rate and `nbytes` bytes at its memory rate."""
    t_ops = ops / RATES["int32_ops_per_s"]
    t_bytes = nbytes / MEM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


# The kernels of another checkout (--parent), timed beside this one's on
# the same inputs in the same run: traceback.cu and seed_lookup.cu, built
# apart and called through their own C entry points.  "differs" says
# which of the two sources is not this checkout's.
PARENT = {"lib": None, "differs": {}}
PARENT_SOURCES = ("traceback.cu", "seed_lookup.cu", "discordant_count.cu")


def build_parent(parent):
    """Build <parent>/seeksv_tpu_torch/csrc/{traceback,seed_lookup,
    discordant_count}.cu (one nvcc each, started together) into a library
    of its own and keep its handle in PARENT."""
    from seeksv_tpu_torch import _build
    out = os.path.join(HERE, "build", "chip_smoke_parent")
    os.makedirs(out, exist_ok=True)
    t0 = time.perf_counter()
    jobs = []
    for name in PARENT_SOURCES:
        src = os.path.join(parent, "seeksv_tpu_torch", "csrc", name)
        with open(src, "rb") as a, open(os.path.join(_build.CSRC, name),
                                        "rb") as b:
            PARENT["differs"][name] = a.read() != b.read()
        obj = os.path.join(out, name + ".o")
        jobs.append((obj, subprocess.Popen(
            [_build._nvcc(), *_build.ARCH, "-std=c++17", "-O3", "-Xcompiler",
             "-fPIC", "-c", "-o", obj, src])))
    for obj, proc in jobs:
        if proc.wait():
            raise AssertionError(f"parent build of {obj} failed")
    path = os.path.join(out, "libparent_kernels.so")
    subprocess.run([_build._nvcc(), *_build.ARCH, "-shared", "-o", path,
                    *(obj for obj, _p in jobs)], check=True)
    lib = ctypes.CDLL(path)
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    # dirs, m, n, dlo, B, LQ, K, runs_len, runs_op, n_runs, stream
    lib.seeksv_traceback.argtypes = [P, P, P, P, I, I, I, P, P, P, P]
    # mat, lens, N, LP, k, keys, n_keys, key_bits, prefix_tab, tab_size,
    # shift, max_occ, lo, cnt, stream
    lib.seeksv_seed_lookup.argtypes = [P, P, I, I, I, P, LL, I, P, LL, I, I,
                                       P, P, P]
    # the column K6: pos, end, lq, mpos, mtid, fwd, mfwd, base_ok, R, lo, hi,
    # beg, up_pos, down_pos, down_tid, same_tid, case_code, min_ins,
    # max_ins, J, window_cap, out, stream
    lib.seeksv_discordant_count.argtypes = [P] * 8 + [LL] + [P] * 10 + [
        I, LL, P, P]
    PARENT["lib"] = lib
    _say(f"parent kernels: {os.path.relpath(parent, HERE)} built in "
         f"{time.perf_counter() - t0:.1f} s; differs from this checkout: "
         f"{json.dumps(PARENT['differs'])}")


def _parent_call(name, *args):
    import torch
    rc = getattr(PARENT["lib"], name)(
        *args, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise AssertionError(f"parent {name}: CUDA error {rc}")


def _in_turns(name, run_parent, run_this, reps=3):
    """Parent, this, this, parent, each the mean of `reps` calls by CUDA
    events; returns (this one's two times, the parent's two)."""
    turns = [_cuda_ms(f, reps) for f in (run_parent, run_this, run_this,
                                         run_parent)]
    _say(f"{name} in turns: parent {turns[0]:.4f} ms, this {turns[1]:.4f}, "
         f"this {turns[2]:.4f}, parent {turns[3]:.4f}")
    return turns[1:3], [turns[0], turns[3]]


def _beats_parent(name, source, this, parent):
    """Where the parent's `source` differs from this checkout's, both of
    this kernel's times in turns must lie below both of the parent's."""
    if PARENT["differs"][source] and max(this) >= min(parent):
        raise AssertionError(f"{name}: this kernel ({this[0]:.4f} / "
                             f"{this[1]:.4f} ms) is not below the parent's "
                             f"({parent[0]:.4f} / {parent[1]:.4f})")


def provenance(card):
    import torch

    from seeksv_tpu_torch import _build
    _say(f"torch {torch.__version__} cuda {torch.version.cuda} "
         f"python {sys.version.split()[0]}")
    nvcc = _build._nvcc()
    ver = subprocess.run([nvcc, "--version"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    _say(f"nvcc {nvcc}: {ver[-1] if ver else '?'}")
    try:
        import triton
        _say(f"triton {triton.__version__} imports")
    except ImportError as exc:
        _say(f"triton does not import ({exc})")
    _say(card)
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits", "-i", "0"], capture_output=True,
        text=True, check=True).stdout.strip())
    RATES["int32_ops_per_s"] = INT32_LANES * mhz * 1e6
    _say(f"bounds against: {MEM_BYTES_PER_S / 1e12} TB/s device memory; "
         f"int32 132 SMs x 64 lanes x clocks.max.sm {mhz:.0f} MHz = "
         f"{RATES['int32_ops_per_s'] / 1e12:.3f} Tops/s")
    from seeksv_tpu_torch.io import native
    t0 = time.perf_counter()
    if not native.available():
        raise AssertionError("the native host library did not build: "
                             f"{native.LOAD_ERROR}")
    lib_dir = os.path.relpath(os.path.dirname(native.library_path()), HERE)
    _say(f"native host library ready in {time.perf_counter() - t0:.1f} s "
         f"(libdeflate {_build.native_info['libdeflate']}), loaded from "
         f"{lib_dir}")
    if not lib_dir.startswith(os.path.join("build", "seeksv_tpu_torch",
                                           "native")):
        raise AssertionError(f"native library loaded from {lib_dir}")
    t0 = time.perf_counter()
    _build.lib()
    _say(f"kernel build: {time.perf_counter() - t0:.3f} s "
         f"(nvcc {_build.build_info['seconds']:.3f} s) -> "
         f"{os.path.relpath(_build.build_info['path'], HERE)}")
    for line in _build.build_info["log"].splitlines():
        # the kernel's name and template arguments out of its mangled symbol
        entry = re.search(r"Compiling entry function '\w*?\d+([a-z_]+_kernel)"
                          r"(I\w+?E(?=Ev))?", line)
        if entry:
            _say(f"  ptxas: {entry.group(1)} {entry.group(2) or ''}")
        elif "registers" in line or "spill" in line:
            _say(f"  ptxas:   {line.strip()}")


def _extend_bound(qlen, plain, q_bytes_per_code, t_bytes_per_code):
    """Bound of one extension call on these jobs, from the plain version's
    with_rows output: sum of qlen x rows cells (rows: what each job ran
    before tlen or z-drop ended it) at EXTEND_OPS_PER_CELL, the cells of
    the rows that raised a job's best at EXTEND_OPS_PER_CELL_IMPROVED more,
    and EXTEND_OPS_PER_ROW a row, against the bytes the jobs need (their
    query and target codes once, 4 ints in, 5 ints out).  Returns (cells,
    a text of the count, the bound)."""
    q = qlen.to("cpu").numpy().astype(np.int64)
    r = plain["rows"].to("cpu").numpy().astype(np.int64)
    ri = plain["rows_improved"].to("cpu").numpy().astype(np.int64)
    cells, improved, rows = int((q * r).sum()), int((q * ri).sum()), int(r.sum())
    nbytes = int(q.sum() * q_bytes_per_code + r.sum() * t_bytes_per_code
                 + len(q) * 9 * 4)
    ops = (cells * EXTEND_OPS_PER_CELL
           + improved * EXTEND_OPS_PER_CELL_IMPROVED
           + rows * EXTEND_OPS_PER_ROW)
    text = (f"{cells} cells x {EXTEND_OPS_PER_CELL} + {improved} cells of "
            f"improving rows x {EXTEND_OPS_PER_CELL_IMPROVED} + {rows} rows "
            f"x {EXTEND_OPS_PER_ROW} = {ops} ops")
    return cells, text, _bound(ops, nbytes)


def _extend_row(replaces, err, ms, plain_ms, bound, shape, LQ):
    from seeksv_tpu_torch.ops.extend import bin_launches
    return {"route": "cuda", "source": "seeksv_tpu_torch/csrc/extend.cu",
            "replaces": replaces, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": None, "library_why": NO_LIBRARY["extend"],
            "ms_of": f"one call ({bin_launches(LQ)} launches, one per "
                     f"query-length bin, and the binning), {shape}"}


def _resident_jobs(rng, genome, B, LQ, reverse, qlen):
    """B resident jobs with the given qlen: genome windows in scan order
    with a small indel and 2 % substitutions, every tenth query random
    (z-drops), the first 16 windows running off the genome's end in scan
    direction, the next 32 with tlen = 0.  Returns q, qlen, start, tlen,
    h0 (numpy)."""
    G = len(genome)
    k = np.arange(LQ)[None, :]
    tlen = (qlen + 100).astype(np.int32)
    start = rng.integers(2 * LQ, G - 2 * LQ, B).astype(np.int32)
    edge = np.arange(16)
    start[:16] = edge if reverse else G - 1 - edge   # runs off the genome
    tlen[16:48] = 0                                  # anchor at a start
    h0 = rng.integers(19, 80, B).astype(np.int32)
    cut = rng.integers(0, LQ, B)[:, None]
    shift = rng.integers(-5, 6, B)[:, None]
    off = k + np.where(k >= cut, shift, 0)
    idx = start[:, None] - off if reverse else start[:, None] + off
    q = genome[np.clip(idx, 0, G - 1)]
    sub = rng.random((B, LQ)) < 0.02
    q[sub] = rng.integers(0, 4, int(sub.sum()))
    q[::10] = rng.integers(0, 4, (len(q[::10]), LQ))
    q[k >= qlen[:, None]] = 4
    return q, qlen, start, tlen, h0


def check_extend(dev, rng, rows, B=18_143, G=52_000_000):
    """K1 at the flagship's dispatch shapes against its plain version."""
    import torch

    from seeksv_tpu_torch.ops import extend as ext
    genome = rng.integers(0, 4, G, dtype=np.uint8)
    genome[rng.integers(0, G, G // 10_000)] = 4
    refp = torch.from_numpy(
        (genome[0::2] | (genome[1::2] << 4)).astype(np.uint8)).to(dev)
    LQ, LT = 1024, 1536
    for reverse in (True, False):
        name = "extend_left" if reverse else "extend_right"
        q, qlen, start, tlen, h0 = _resident_jobs(
            rng, genome, B, LQ, reverse,
            rng.integers(0, LQ + 1, B).astype(np.int32))
        args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in
                (ext.pack_nibbles(q), qlen, start, tlen, h0)]
        got = ext.extend_batch_resident(*args, refp, G, LQ, LT, reverse)
        want = ext.extend_batch_resident_plain(*args, refp, G, LQ, LT,
                                               reverse, with_rows=True)
        torch.cuda.synchronize()
        err = _max_abs_err([(got[x], want[x]) for x in ext.KEYS])
        ms = _cuda_ms(lambda: ext.extend_batch_resident(
            *args, refp, G, LQ, LT, reverse), 3)
        plain_ms = _cuda_ms(lambda: ext.extend_batch_resident_plain(
            *args, refp, G, LQ, LT, reverse), 1)
        cells, count, bound = _extend_bound(args[1], want, 0.5, 0.5)
        _say(f"{name}: B={B} LQ={LQ} LT={LT} max_abs_err={err} "
             f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
             f"{bound[0]:.4g} ms by {bound[1]} ({count}; "
             f"{cells / ms / 1e6:.1f} Gcell/s)")
        if err:
            raise AssertionError(f"{name} disagrees with its plain version")
        rows[name] = _extend_row(
            "seeksv_tpu/ops/pallas_sw.py:35", err, ms, plain_ms, bound,
            f"B={B} LQ={LQ} LT={LT}, {cells} cells", LQ)
    return genome, refp


def check_extend_windows(dev, rng, rows, B=8192, G=1_000_000):
    """K1w at one device_align chunk's shape against its plain version."""
    import torch

    from seeksv_tpu_torch.ops import extend as ext
    LQ, LT = 1024, 1152
    genome = rng.integers(0, 4, G, dtype=np.uint8)
    k = np.arange(LT)[None, :]
    qlen = rng.integers(0, LQ + 1, B).astype(np.int32)
    tlen = np.minimum(qlen + 100, LT).astype(np.int32)
    h0 = rng.integers(19, 80, B).astype(np.int32)
    empty = rng.random(B) < 0.5                       # invalid slots
    qlen[empty] = 0
    tlen[empty] = 0
    h0[empty] = 0
    start = rng.integers(0, G - LT, B)
    t = genome[start[:, None] + k]
    q = t[:, :LQ].copy()
    sub = rng.random(q.shape) < 0.02
    q[sub] = rng.integers(0, 4, int(sub.sum()))
    q[::10] = rng.integers(0, 4, (len(q[::10]), LQ))  # z-drops
    q[k[:, :LQ] >= qlen[:, None]] = 4
    t[k >= tlen[:, None]] = 4
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in (q, qlen, t, tlen, h0)]
    got = ext.extend_batch(*args)
    want = ext.extend_batch_plain(*args, with_rows=True)
    torch.cuda.synchronize()
    err = _max_abs_err([(got[x], want[x]) for x in ext.KEYS])
    ms = _cuda_ms(lambda: ext.extend_batch(*args), 3)
    plain_ms = _cuda_ms(lambda: ext.extend_batch_plain(*args), 1)
    cells, count, bound = _extend_bound(args[1], want, 1, 1)
    _say(f"extend_windows: B={B} ({int(empty.sum())} empty) LQ={LQ} "
         f"LT={LT} max_abs_err={err} kernel {ms:.3f} ms, plain "
         f"{plain_ms:.3f} ms, bound {bound[0]:.4g} ms by {bound[1]} "
         f"({count})")
    if err:
        raise AssertionError("extend_windows disagrees with its plain "
                             "version")
    rows["extend_windows"] = _extend_row(
        "seeksv_tpu/ops/pallas_sw.py:161", err, ms, plain_ms, bound,
        f"B={B} ({int(empty.sum())} empty) LQ={LQ} LT={LT}, {cells} cells",
        LQ)


def check_extend_mixed(dev, rng, genome, refp,
                       sizes=((1024, 2048), (2048, 256))):
    """Both entries against the plain version on batches that mix every
    query-length bin: qlen at every bin edge (edge - 1, edge, edge + 1)
    and at random, qlen = 0 (z-drops at its first row), tlen = 0 slots,
    random queries (z-drop before their row qlen), windows running off
    both ends of the genome, and jobs whose qlen lies past the bucket LQ
    (LQ cells and no cell qlen); at LQ 1024 and at LQ 2048 (queries past
    the widest bin)."""
    import torch

    from seeksv_tpu_torch.ops import extend as ext
    G = len(genome)
    for LQ, B in sizes:
        LT = LQ + 512
        edges = [e + d for e in ext.BIN_EDGES if e <= LQ for d in (-1, 0, 1)]
        edges = [e for e in edges if 0 <= e <= LQ] + [0, 1, LQ]
        for reverse in (True, False):
            qlen = rng.integers(1, LQ + 1, B).astype(np.int32)
            qlen[48:48 + len(edges)] = edges
            qlen[48:] = qlen[48:][rng.permutation(B - 48)]
            q, qlen, start, tlen, h0 = _resident_jobs(rng, genome, B, LQ,
                                                      reverse, qlen)
            past = np.flatnonzero((qlen == LQ) & (tlen > 0))[:2]
            qlen[past] = [LQ + 1, LQ + 900][:len(past)]
            args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                    for a in (ext.pack_nibbles(q), qlen, start, tlen, h0)]
            got = ext.extend_batch_resident(*args, refp, G, LQ, LT, reverse)
            want = ext.extend_batch_resident_plain(*args, refp, G, LQ, LT,
                                                   reverse, with_rows=True)
            # the same jobs through the window entry
            tq = torch.from_numpy(q).to(dev)
            tt = ext.gather_ref_windows(refp, G, args[2], args[3], LT,
                                        reverse).to(torch.uint8)
            gotw = ext.extend_batch(tq, args[1], tt, args[3], args[4])
            torch.cuda.synchronize()
            err = _max_abs_err([(g[x], want[x]) for x in ext.KEYS
                                for g in (got, gotw)])
            zdrop = want["rows"] < args[3]
            first = int(((want["rows"] <= 1) & zdrop).sum())
            early = int(((want["rows"] < args[1]) & zdrop).sum())
            bins = np.bincount(np.searchsorted(ext.BIN_EDGES,
                                               np.minimum(qlen, LQ)),
                               minlength=len(ext.BIN_EDGES) + 1)
            _say(f"extend mixed {'left' if reverse else 'right'}: B={B} "
                 f"LQ={LQ} LT={LT} jobs per bin {bins.tolist()}, "
                 f"{int((qlen == 0).sum())} with qlen 0, {len(past)} with "
                 f"qlen past LQ, "
                 f"{int((tlen == 0).sum())} with tlen 0, {int(zdrop.sum())} "
                 f"z-dropped ({first} at the first row, {early} before row "
                 f"qlen), 16 off the genome: resident and windows "
                 f"max_abs_err={err}")
            if err or not first or not early or not len(past) \
                    or (bins[:len(ext.BIN_EDGES)] == 0).any():
                raise AssertionError("extend on mixed bins disagrees with "
                                     "its plain version, or a case is "
                                     "missing")


def check_seed_lookup(dev, index, clip_fq, rows, n_strand=1024):
    """K4 against its plain version on the first n_strand strand reads of
    the slice's clip fastq, against the flagship's table; timed beside
    its bound, its sector floor, torch.searchsorted over the table's full
    keys (library_ms) and, with --parent, the parent's kernel in turns.
    Returns the lookup's arguments."""
    import torch

    from seeksv_tpu_torch.align.index import ENCODE
    from seeksv_tpu_torch.ops import seed_device as sd
    reads = []
    with gzip.open(clip_fq, "rt") as f:
        while len(reads) < n_strand:
            if not f.readline():
                break
            fwd = ENCODE[np.frombuffer(f.readline().strip().encode(),
                                       np.uint8)]
            f.readline()
            f.readline()
            reads += [fwd, np.where(fwd[::-1] < 4, 3 - fwd[::-1],
                                    4).astype(np.uint8)]
    seeder = sd.TorchDeviceSeeder.from_index(index, dev)
    mat, lens = seeder.upload(sd.pad_reads(reads, index.k))
    args = (mat, lens, seeder.keys, seeder.prefix_tab, seeder.shift,
            index.k, seeder.search_iters)
    lo, cnt = sd.seed_lookup(*args)
    want_lo, want_cnt = sd.seed_lookup_plain(*args)
    torch.cuda.synchronize()
    err = _max_abs_err([(lo, want_lo), (cnt, want_cnt)])
    run_this = lambda: sd.seed_lookup(*args)
    ms = _cuda_ms(run_this, 3)
    plain_ms = _cuda_ms(lambda: sd.seed_lookup_plain(*args), 1)
    N, LP = mat.shape
    k, shift = index.k, seeder.shift
    nk = LP - k + 1
    keys, tab = seeder.keys, seeder.prefix_tab
    shape = (f"N={N} LP={LP} ({lo.numel()} k-mers), {index.keys.dtype} "
             f"keys")
    # the yardstick: torch.searchsorted (both sides) over the full keys,
    # bucket << shift | residual, built once outside the timed window
    bucket = torch.repeat_interleave(
        torch.arange(tab.numel() - 1, device=dev), torch.diff(tab))
    full = (bucket << shift) | sd._widen(keys)
    del bucket
    hashes, ok = sd._hashes(mat, lens, k, nk)
    library = lambda: (torch.searchsorted(full, hashes, side="left"),
                       torch.searchsorted(full, hashes, side="right"))
    lib_lo, lib_hi = library()
    lib_cnt = lib_hi - lib_lo
    hit = ok & (cnt > 0)
    agree = bool((lib_lo[ok] == lo[ok]).all()) and bool(
        (lib_cnt[hit] == cnt[hit]).all()) and not bool(
        (ok & ~hit & (lib_cnt > 0) & (lib_cnt <= sd.MAX_OCC)).any())
    library_ms = _cuda_ms(library, 3)
    del full, lib_lo, lib_hi, lib_cnt
    parent_ms = None
    if PARENT["lib"]:
        plo, pcnt = torch.empty_like(lo), torch.empty_like(cnt)
        run_parent = lambda: _parent_call(
            "seeksv_seed_lookup", mat.data_ptr(), lens.data_ptr(), N, LP, k,
            keys.data_ptr(), keys.numel(),
            16 if keys.dtype == torch.int16 else 32, tab.data_ptr(),
            tab.numel(), shift, sd.MAX_OCC, plo.data_ptr(), pcnt.data_ptr())
        run_parent()
        torch.cuda.synchronize()
        err = max(err, _max_abs_err([(plo, want_lo), (pcnt, want_cnt)]))
        this, parent_ms = _in_turns("seed_lookup", run_parent, run_this)
        _beats_parent("seed_lookup", "seed_lookup.cu", this, parent_ms)
    # bytes these reads need: the read matrix and lengths once, per k-mer
    # two prefix-table entries and 2 x search_iters key probes, lo and cnt
    # out; operations: the k-mer's rolling hash (3) and its probes (4 each)
    n_kmers = lo.numel()
    probes = 2 * seeder.search_iters
    bound = _bound(n_kmers * (3 + 4 * probes),
                   _nbytes(mat, lens) + n_kmers * (
                       2 * 8 + probes * keys.element_size() + 2 * 8))
    # the sector floor: a random 32-byte sector for the prefix pair and
    # one for the bucket a k-mer, lo and cnt out, the reads once
    floor_ms = (_nbytes(mat, lens) + n_kmers * (2 * 32 + 16)) \
        / MEM_BYTES_PER_S * 1e3
    widths = torch.diff(tab)
    _say(f"seed_lookup: {len(reads)} strand reads, {shape}, "
         f"{int((cnt > 0).sum())} k-mers with hits, search_iters="
         f"{seeder.search_iters}, buckets of the table: mean "
         f"{float(widths.float().mean()):.2f} keys, "
         f"{int((widths > 16).sum())} past 16, widest {int(widths.max())}; "
         f"max_abs_err={err} kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
         f"bound {bound[0]:.4g} ms by {bound[1]}, sector floor "
         f"{floor_ms:.4g} ms, torch.searchsorted left + right over the "
         f"{keys.numel()} full keys {library_ms:.4f} ms (agrees: {agree})"
         + (f", parent {min(parent_ms):.4f} ms" if parent_ms else ""))
    if err or not int((cnt > 0).sum()) or not agree:
        raise AssertionError("seed_lookup disagrees with its plain version "
                             "or torch.searchsorted, or finds nothing")
    rows["seed_lookup"] = {
        "route": "cuda", "source": "seeksv_tpu_torch/csrc/seed_lookup.cu",
        "replaces": "seeksv_tpu/ops/seed_device.py:64",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound[0], "bound_by": bound[1],
        "library_ms": library_ms,
        "library_call": "torch.searchsorted(full_keys, hashes, side='left') "
                        "+ side='right'",
        "sector_floor_ms": floor_ms, "parent_ms": parent_ms,
        "ms_of": f"one launch, {shape}"}
    return args


def _finalize_pairs(rng, B, LQ, lim):
    """Long-fragment (q, t) pairs: a genome-like window against a copy
    with a small indel and 3 % substitutions, |n - m| <= lim."""
    m = rng.integers(257, LQ + 1, B).astype(np.int32)
    n = np.clip(m + rng.integers(-lim, lim + 1, B), 257, LQ).astype(np.int32)
    src = rng.integers(0, 4, (B, LQ + 16), dtype=np.uint8)
    k = np.arange(LQ)[None, :]
    q = src[:, :LQ].copy()
    cut = rng.integers(0, LQ, B)[:, None]
    off = k + np.where(k >= cut, rng.integers(0, 9, B)[:, None], 0)
    t = np.take_along_axis(src, off, axis=1)
    for a in (q, t):
        sub = rng.random(a.shape) < 0.03
        a[sub] = rng.integers(0, 4, int(sub.sum()))
    q[k >= m[:, None]] = 4
    t[k >= n[:, None]] = 4
    return q, t, m, n


def _direction_err(gd, dev, q, t, m, n, w, K):
    """max_abs_err of K2 against its plain version on these jobs (score
    and every whole row 1..m of the direction block), and the jobs per
    k_real bin, widest first."""
    import torch
    LQ = q.shape[1]
    tq, tt, tm, tn = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                      for a in (q, t, m, n))
    td = torch.from_numpy((np.minimum(0, n - m) - w).astype(np.int32)).to(dev)
    n0 = gd.LAUNCHES["banded_dir"]
    score, dirs = gd.banded_direction(tq, tm, tt, td, tn, K)
    if gd.LAUNCHES["banded_dir"] != n0 + gd.band_launches(K):
        raise AssertionError("a direction call must count one launch per "
                             "k_real bin")
    ws, wdirs = gd.banded_direction_plain(
        tq, tm, gd.build_t2(tt, tn, td, K, LQ), td, tn, K, LQ)
    torch.cuda.synchronize()
    rows_m = torch.arange(1, LQ + 1, device=dev)[None, :] <= tm[:, None]
    err = _max_abs_err([(score, ws), (dirs[rows_m], wdirs[rows_m])])
    _order, seg = gd.plan_band_bins(tm, td, tn, K)
    return err, torch.diff(seg).tolist()


def check_finalize_edges(dev, rng):
    """K2 against its plain version at the edges of its k_real bins
    (tests/torch_inputs.py:band_edge_lengths: a band of every edge's width
    and of one column more, the narrowest and the widest band, n - m of
    either sign up to what the rung's band holds, m = 257, m = LQ and in
    between) at LQ 512, 1024 and 2048; and a sub-batch of one job (what
    rung 64 gets when one job of a chunk needs it) in the narrowest and
    the widest bin."""
    from torch_inputs import band_edge_lengths, finalize_pairs

    from seeksv_tpu_torch.ops import global_device as gd
    for w, K in gd.TorchDeviceGlobalAligner.RUNGS:
        for LQ in (512, 1024, 2048):
            LT = LQ + 128
            m, n = band_edge_lengths(w, K, LQ, LT)
            q, t = finalize_pairs(rng, m, n, LQ, LT)
            err, bins = _direction_err(gd, dev, q, t, m, n, w, K)
            one = 0
            for mm, nn in ((LQ - 5, LQ - 5), (300, 300 + K - 2 * w - 1)):
                m1, n1 = (np.asarray([x], np.int32) for x in (mm, nn))
                q1, t1 = finalize_pairs(rng, m1, n1, LQ, LT)
                one = max(one, _direction_err(gd, dev, q1, t1, m1, n1, w,
                                              K)[0])
            k_real = sorted(set((np.abs(n - m) + 2 * w + 1).tolist()))
            _say(f"banded_dir edges K={K} LQ={LQ}: {len(m)} jobs with "
                 f"k_real in {k_real}, m in {sorted(set(m.tolist()))}, "
                 f"n - m from {int((n - m).min())} to {int((n - m).max())}"
                 f", jobs per bin (widest first) {bins}: max_abs_err={err}; "
                 f"one-job sub-batches max_abs_err={one}")
            if err or one or not all(bins):
                raise AssertionError(f"banded_dir K={K} LQ={LQ} disagrees "
                                     "at a bin edge, or a bin is empty")


def _banded_bound(m, n, w, K):
    """(cells, bound) of one direction call on these jobs: the band's
    cells, m rows of min(K, |n - m| + 2w + 1) columns, at
    BANDED_OPS_PER_CELL; bytes: q and t once, 3 ints in, the m x K
    direction bytes and the score out."""
    m64, n64 = m.astype(np.int64), n.astype(np.int64)
    width = np.minimum(K, np.abs(n64 - m64) + 2 * w + 1)
    cells = int((m64 * width).sum())
    return cells, _bound(cells * BANDED_OPS_PER_CELL,
                         int((m64 + n64).sum()) + len(m) * 4 * 4
                         + int(m64.sum()) * K)


def _walk_bound(got, m, n, B):
    """(steps, bound, sector floor ms) of one walk call: the steps the
    walks took (a finished walk's steps are its runs' lengths, an
    overflowed one's at most m + n), the direction bytes they read (one a
    step) and the runs written, at 12 operations a step; the floor is one
    32-byte sector per row a walk visits (m rows) over the memory rate."""
    import torch
    from seeksv_tpu_torch.ops import global_device as gd
    steps = int(torch.where(got[2] <= gd.RUNS_CAP, got[0].sum(dim=1),
                            (m + n)).sum())
    bound = _bound(steps * 12, steps + B * 3 * 4 + _nbytes(*got))
    floor_ms = int(m.to(torch.int64).sum()) * 32 / MEM_BYTES_PER_S * 1e3
    return steps, bound, floor_ms


def _walk_parent(dirs, m, n, dlo):
    """The parent's walk on these inputs, into outputs of its own:
    (the launcher, its outputs)."""
    import torch
    B, LQ, K = dirs.shape
    out = [torch.empty((B, 64), dtype=torch.int32, device=dirs.device),
           torch.empty((B, 64), dtype=torch.int32, device=dirs.device),
           torch.empty(B, dtype=torch.int32, device=dirs.device)]
    run = lambda: _parent_call("seeksv_traceback", dirs.data_ptr(),
                               m.data_ptr(), n.data_ptr(), dlo.data_ptr(), B,
                               LQ, K, *(x.data_ptr() for x in out))
    return run, out


def check_finalize(dev, rng, rows, B=4096):
    """K2 at K = 128 / 256 on LQ 1024 and K3 on K2's output, against
    their plain versions; one chunk of 4,096 jobs (the finalize's
    chunk at 1 GiB of direction bytes and LQ 1024).  With --parent, K3
    in turns with the parent's walk."""
    import torch

    from seeksv_tpu_torch.ops import global_device as gd
    LQ = 1024
    q, t, m, n = _finalize_pairs(rng, B, LQ, 40)
    tq, tt, tm, tn = (torch.from_numpy(a).to(dev) for a in (q, t, m, n))
    # per kernel: max error and one {K, ms, plain_ms} entry per rung
    agg = {"banded_dir": [0, []], "traceback": [0, []]}
    for w, K in gd.TorchDeviceGlobalAligner.RUNGS:
        td = torch.from_numpy((np.minimum(0, n - m) - w).astype(
            np.int32)).to(dev)
        n0 = gd.LAUNCHES["banded_dir"]
        score, dirs = gd.banded_direction(tq, tm, tt, td, tn, K)
        if gd.LAUNCHES["banded_dir"] != n0 + gd.band_launches(K):
            raise AssertionError("a direction call must count one launch "
                                 "per k_real bin")
        ws, wdirs = gd.banded_direction_plain(
            tq, tm, gd.build_t2(tt, tn, td, K, LQ), td, tn, K, LQ)
        torch.cuda.synchronize()
        rows_m = torch.arange(1, LQ + 1, device=dev)[None, :] <= tm[:, None]
        err = _max_abs_err([(score, ws), (dirs[rows_m], wdirs[rows_m])])
        del wdirs
        ms = _cuda_ms(lambda: gd.banded_direction(tq, tm, tt, td, tn, K), 3)
        plain_ms = _cuda_ms(lambda: gd.banded_direction_plain(
            tq, tm, gd.build_t2(tt, tn, td, K, LQ), td, tn, K, LQ), 1)
        cells, bound = _banded_bound(m, n, w, K)
        _order, seg = gd.plan_band_bins(tm, td, tn, K)
        bins = torch.diff(seg).tolist()
        _say(f"banded_dir K={K}: B={B} LQ={LQ} max_abs_err={err} "
             f"kernel {ms:.3f} ms ({gd.band_launches(K)} launches, jobs per "
             f"k_real bin, widest first, {bins}), plain {plain_ms:.3f} ms, "
             f"bound {bound[0]:.4g} ms by {bound[1]} ({cells} cells x "
             f"{BANDED_OPS_PER_CELL} ops, {int(m.sum()) * K} direction "
             f"bytes)")
        if err:
            raise AssertionError(f"banded_dir K={K} disagrees")
        a = agg["banded_dir"]
        a[0] = max(a[0], err)
        a[1].append({"K": K, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound[0], "bound_by": bound[1],
                     "jobs_per_bin": bins})
        got = gd.traceback_rle(dirs, tm, tn, td)
        want = gd.traceback_rle_plain(dirs, tm, tn, td)
        torch.cuda.synchronize()
        err = _max_abs_err(list(zip(got, want)))
        run_this = lambda: gd.traceback_rle(dirs, tm, tn, td)
        ms = _cuda_ms(run_this, 3)
        plain_ms = _cuda_ms(lambda: gd.traceback_rle_plain(dirs, tm, tn, td),
                            1)
        parent_ms = None
        if PARENT["lib"]:
            run_parent, pout = _walk_parent(dirs, tm, tn, td)
            run_parent()
            torch.cuda.synchronize()
            err = max(err, _max_abs_err(list(zip(pout, want))))
            this, parent_ms = _in_turns(f"traceback K={K}", run_parent,
                                        run_this)
            _beats_parent(f"traceback K={K}", "traceback.cu", this,
                          parent_ms)
        done = int((got[2] <= gd.RUNS_CAP).sum())
        steps, bound, floor_ms = _walk_bound(got, tm, tn, B)
        _say(f"traceback K={K}: B={B} max_abs_err={err} kernel {ms:.4f} ms, "
             f"plain {plain_ms:.3f} ms, bound {bound[0]:.4g} ms by "
             f"{bound[1]} ({steps} steps x 12 ops; {done} walks within "
             f"RUNS_CAP), sector floor {floor_ms:.4g} ms "
             f"({int(m.sum())} rows x 32 B)"
             + (f", parent {min(parent_ms):.4f} ms" if parent_ms else ""))
        if err or not done:
            raise AssertionError(f"traceback K={K} disagrees or is vacuous")
        a = agg["traceback"]
        a[0] = max(a[0], err)
        a[1].append({"K": K, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound[0], "bound_by": bound[1],
                     "sector_floor_ms": floor_ms, "parent_ms": parent_ms})
        del dirs
    for name, src, rep in (
            ("banded_dir", "banded_dir.cu",
             "seeksv_tpu/ops/global_device.py:334"),
            ("traceback", "traceback.cu",
             "seeksv_tpu/ops/global_device.py:493")):
        err, rungs = agg[name]
        rows[name] = {"route": "cuda",
                      "source": f"seeksv_tpu_torch/csrc/{src}",
                      "replaces": rep,
                      "max_abs_err": err,
                      "ms": sum(r["ms"] for r in rungs),
                      "plain_ms": sum(r["plain_ms"] for r in rungs),
                      "bound_ms": sum(r["bound_ms"] for r in rungs),
                      "bound_by": rungs[0]["bound_by"],
                      "library_ms": None, "library_why": NO_LIBRARY[name],
                      "ms_of": (f"sum of one call per rung "
                                f"(K={'+'.join(str(r['K']) for r in rungs)}"
                                f"; K2: one launch per k_real bin and the "
                                f"binning), B={B} LQ={LQ}"),
                      "rungs": rungs}


def check_walks(dev):
    """K3 against its plain version on the walks built to leave its
    windows (tests/torch_inputs.py:adversarial_walks), at both band
    widths; with --parent the parent's walk on them too."""
    import torch
    from torch_inputs import WALK_CASES, adversarial_walks

    from seeksv_tpu_torch.ops import global_device as gd
    for K in (128, 256):
        err, n_walks, runs = 0, 0, set()
        for case in WALK_CASES:
            args = [torch.from_numpy(a).to(dev)
                    for a in adversarial_walks(case, K)]
            got = gd.traceback_rle(*args)
            want = gd.traceback_rle_plain(*args)
            pairs = list(zip(got, want))
            if PARENT["lib"]:
                run_parent, pout = _walk_parent(*args)
                run_parent()
                pairs += list(zip(pout, want))
            torch.cuda.synchronize()
            err = max(err, _max_abs_err(pairs))
            n_walks += int(args[0].shape[0])
            runs |= set(want[2].tolist())
        _say(f"traceback on the adversarial walks K={K}: {n_walks} walks of "
             f"{len(WALK_CASES)} cases, run counts {sorted(runs)}: "
             f"max_abs_err={err}")
        if err or not {gd.RUNS_CAP, gd.RUNS_CAP + 1} <= runs:
            raise AssertionError("traceback disagrees on the adversarial "
                                 "walks, or a case is missing")


def _keep_first_call(module, name, kept):
    """Wrap module.<name> so that its first call's arguments land in
    kept[name]; returns the undo."""
    fn = getattr(module, name)

    def wrapper(*args, **kwargs):
        kept.setdefault(name, (args, kwargs))
        return fn(*args, **kwargs)
    setattr(module, name, wrapper)
    return lambda: setattr(module, name, fn)


def _keep_calls(module, name, calls):
    """Wrap module.<name> so that every call's positional arguments are
    appended to calls; returns the undo."""
    fn = getattr(module, name)

    def wrapper(*args):
        calls.append(args)
        return fn(*args)
    setattr(module, name, wrapper)
    return lambda: setattr(module, name, fn)


def _bins_in_job_order(plan_bins):
    """plan_bins with the jobs of a bin in job order, not longest first."""
    import torch

    def plan(qlen, tlen, LQ):
        order, seg = plan_bins(qlen, tlen, LQ)
        B = order.numel()
        slot = torch.arange(B, device=order.device)
        which = torch.bucketize(slot, seg[1:].to(torch.int64), right=True)
        return order[torch.argsort(which * B + order.to(torch.int64))], seg
    return plan


def check_extend_path(kept, rows, run="the default run",
                      key="on_the_runs_jobs"):
    """K1 on a run's own first call (by default the flagship run's left
    round: the jobs the flagship really dispatches, not phase 2's uniform
    lengths) against the plain version, timed beside its bound, and timed
    once more with the dispatch's order inside a bin switched off; the
    numbers go to rows["extend_left"][key]."""
    import torch

    from seeksv_tpu_torch.ops import extend as ext
    args, _kw = kept
    got = ext.extend_batch_resident(*args)
    want = ext.extend_batch_resident_plain(*args, with_rows=True)
    torch.cuda.synchronize()
    err = _max_abs_err([(got[x], want[x]) for x in ext.KEYS])
    ms = _cuda_ms(lambda: ext.extend_batch_resident(*args), 3)
    plain_ms = _cuda_ms(lambda: ext.extend_batch_resident_plain(*args), 1)
    plan_bins = ext.plan_bins
    ext.plan_bins = _bins_in_job_order(plan_bins)
    try:
        unsorted = ext.extend_batch_resident(*args)
        err = max(err, _max_abs_err([(unsorted[x], want[x])
                                     for x in ext.KEYS]))
        job_order_ms = _cuda_ms(lambda: ext.extend_batch_resident(*args), 3)
    finally:
        ext.plan_bins = plan_bins
    ms_again = _cuda_ms(lambda: ext.extend_batch_resident(*args), 3)
    cells, count, bound = _extend_bound(args[1], want, 0.5, 0.5)
    qlen = args[1].cpu().numpy()
    B, LQ, LT = len(qlen), args[7], args[8]
    _say(f"extend_left on {run}'s jobs: B={B} LQ={LQ} LT={LT} "
         f"qlen mean {qlen.mean():.1f} max {qlen.max()}, rows mean "
         f"{float(want['rows'].float().mean()):.1f}: max_abs_err={err} "
         f"kernel {ms:.3f} ms (again {ms_again:.3f}; with a bin's jobs in "
         f"job order instead of longest first {job_order_ms:.3f}, two more "
         f"torch ops in its binning), plain {plain_ms:.3f} ms, bound "
         f"{bound[0]:.4g} ms by {bound[1]} ({count})")
    if err:
        raise AssertionError("extend_left disagrees with its plain version "
                             f"on {run}'s own jobs")
    rows["extend_left"][key] = {
        "B": B, "LQ": LQ, "LT": LT, "cells": cells, "max_abs_err": err,
        "ms": ms, "ms_again": ms_again, "ms_bins_in_job_order": job_order_ms,
        "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1]}


def check_finalize_path(calls, launches, rows):
    """K2 on the default run's own finalize jobs: every direction call the
    run made (a chunk at rung 16, then its jobs that rung 16 did not
    accept at rung 64), each against the plain version, with the jobs'
    k_real histogram and the rung's time beside its bound."""
    import torch

    from seeksv_tpu_torch.ops import global_device as gd
    want = sum(gd.band_launches(c[5]) for c in calls)
    if launches["banded_dir"] != want:
        raise AssertionError(f"the default run made {len(calls)} direction "
                             f"calls, {want} launches by their k_real bins, "
                             f"and counted {launches['banded_dir']}")
    rungs = {}
    for w, K in gd.TorchDeviceGlobalAligner.RUNGS:
        mine = [c for c in calls if c[5] == K]
        r = rungs[K] = {"calls": len(mine), "jobs": 0, "max_abs_err": 0,
                        "ms": 0.0, "bound_ms": 0.0, "cells": 0,
                        "jobs_per_bin": [0] * gd.band_launches(K)}
        k_all = []
        for q, qlen, t, dlo, n, _K in mine:
            B, LQ = q.shape
            score, dirs = gd.banded_direction(q, qlen, t, dlo, n, K)
            ws, wdirs = gd.banded_direction_plain(
                q, qlen, gd.build_t2(t, n, dlo, K, LQ), dlo, n, K, LQ)
            torch.cuda.synchronize()
            rows_m = (torch.arange(1, LQ + 1, device=q.device)[None, :]
                      <= qlen[:, None])
            r["max_abs_err"] = max(r["max_abs_err"], _max_abs_err(
                [(score, ws), (dirs[rows_m], wdirs[rows_m])]))
            del wdirs, rows_m
            r["ms"] += _cuda_ms(
                lambda: gd.banded_direction(q, qlen, t, dlo, n, K), 3)
            cells, bound = _banded_bound(qlen.cpu().numpy(), n.cpu().numpy(),
                                         w, K)
            r["jobs"] += B
            r["cells"] += cells
            r["bound_ms"] += bound[0]
            r["bound_by"] = bound[1]
            _order, seg = gd.plan_band_bins(qlen, dlo, n, K)
            r["jobs_per_bin"] = [a + b for a, b in zip(
                r["jobs_per_bin"], torch.diff(seg).tolist())]
            k_all.append(gd.band_columns(qlen, dlo, n, K).cpu().numpy())
        if k_all:
            # the jobs by k_real: {columns: jobs}, the 12 commonest widths
            widths, jobs = np.unique(np.concatenate(k_all),
                                     return_counts=True)
            top = np.sort(np.argsort(-jobs)[:12])
            r["k_real"] = {str(int(widths[x])): int(jobs[x]) for x in top}
            r["k_real_widths"] = len(widths)
    share = rungs[256]["jobs"] / max(1, rungs[128]["jobs"])
    for K, r in rungs.items():
        _say(f"banded_dir on the default run's finalize jobs, K={K}: "
             f"{r['calls']} calls, {r['jobs']} jobs, jobs by k_real "
             f"{json.dumps(r.get('k_real'))} ({r.get('k_real_widths', 0)} "
             f"widths in all), jobs per k_real bin (edges "
             f"{list(reversed(gd.BAND_EDGES[K]))}) {r['jobs_per_bin']}, "
             f"{r['cells']} cells: max_abs_err={r['max_abs_err']} kernel "
             f"{r['ms']:.3f} ms over the calls, bound {r['bound_ms']:.4g} "
             f"ms")
        if r["max_abs_err"]:
            raise AssertionError("banded_dir disagrees with its plain "
                                 "version on the run's own jobs")
    _say(f"banded_dir on the default run: {share:.4f} of the finalize jobs "
         f"reach rung 64")
    if not rungs[128]["jobs"]:
        raise AssertionError("the default run finalized nothing on the card")
    rows["banded_dir"]["on_the_runs_jobs"] = {
        "share_reaching_rung_64": share,
        "rungs": [{"K": K, **r} for K, r in rungs.items()]}


def check_traceback_path(calls, launches, rows):
    """K3 on the default run's own walks: every walk call the run made
    (the accepted jobs of a chunk's pass at rung 16, then at rung 64;
    declined jobs come with m = n = 0), each against the plain version;
    per rung the calls, the live walks and their steps, the time beside
    the bound and the sector floor, and with --parent the parent's walk
    in turns."""
    import torch

    from seeksv_tpu_torch.ops import global_device as gd
    if launches["traceback"] != len(calls):
        raise AssertionError(f"the default run made {len(calls)} walk calls "
                             f"and counted {launches['traceback']} launches")
    out = []
    for _w, K in gd.TorchDeviceGlobalAligner.RUNGS:
        mine = [c for c in calls if c[0].shape[2] == K]
        r = {"K": K, "calls": len(mine), "walks": 0, "live_walks": 0,
             "steps": 0, "max_abs_err": 0, "ms": 0.0, "plain_ms": 0.0,
             "bound_ms": 0.0, "sector_floor_ms": 0.0,
             "parent_ms": [0.0, 0.0] if PARENT["lib"] else None,
             "ms_in_turns": [0.0, 0.0] if PARENT["lib"] else None}
        for dirs, m, n, dlo in mine:
            got = gd.traceback_rle(dirs, m, n, dlo)
            want = gd.traceback_rle_plain(dirs, m, n, dlo)
            pairs = list(zip(got, want))
            run_this = lambda: gd.traceback_rle(dirs, m, n, dlo)
            if PARENT["lib"]:
                run_parent, pout = _walk_parent(dirs, m, n, dlo)
                run_parent()
                pairs += list(zip(pout, want))
            torch.cuda.synchronize()
            r["max_abs_err"] = max(r["max_abs_err"], _max_abs_err(pairs))
            r["ms"] += _cuda_ms(run_this, 3)
            r["plain_ms"] += _cuda_ms(
                lambda: gd.traceback_rle_plain(dirs, m, n, dlo), 1)
            if PARENT["lib"]:
                this, parent = _in_turns(
                    f"traceback on the run's walks K={K}", run_parent,
                    run_this)
                r["parent_ms"] = [a + b for a, b in zip(r["parent_ms"],
                                                        parent)]
                r["ms_in_turns"] = [a + b for a, b in zip(r["ms_in_turns"],
                                                          this)]
            B = dirs.shape[0]
            steps, bound, floor_ms = _walk_bound(got, m, n, B)
            r["walks"] += B
            r["live_walks"] += int(((m > 0) | (n > 0)).sum())
            r["steps"] += steps
            r["bound_ms"] += bound[0]
            r["bound_by"] = bound[1]
            r["sector_floor_ms"] += floor_ms
        _say(f"traceback on the default run's walks, K={K}: {r['calls']} "
             f"calls, {r['walks']} jobs, {r['live_walks']} live walks, "
             f"{r['steps']} steps: max_abs_err={r['max_abs_err']} kernel "
             f"{r['ms']:.4f} ms over the calls, plain {r['plain_ms']:.3f} "
             f"ms, bound {r['bound_ms']:.4g} ms, sector floor "
             f"{r['sector_floor_ms']:.4g} ms"
             + (f", parent {min(r['parent_ms']):.4f} ms" if PARENT["lib"]
                else ""))
        if r["max_abs_err"]:
            raise AssertionError("traceback disagrees with its plain version "
                                 "on the run's own walks")
        if PARENT["lib"] and mine:
            _beats_parent(f"traceback on the run's walks K={K}",
                          "traceback.cu", r["ms_in_turns"], r["parent_ms"])
        out.append(r)
    if not sum(r["live_walks"] for r in out):
        raise AssertionError("the default run walked nothing on the card")
    rows["traceback"]["on_the_runs_walks"] = out


def check_no_host_waits(ext_args, dir_call, walk_call, lookup_args):
    """plan_bins, plan_band_bins and the K3 and K4 wrappers on the default
    run's own inputs (its first extension call, its last direction and
    walk calls) and on the lookup's, under
    torch.cuda.set_sync_debug_mode("error"): an op that waits for the card
    raises."""
    import torch

    from seeksv_tpu_torch.ops import extend as ext
    from seeksv_tpu_torch.ops import global_device as gd
    from seeksv_tpu_torch.ops import seed_device as sd
    _q, dqlen, _t, dlo, n, K = dir_call
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ext.plan_bins(ext_args[1], ext_args[3], ext_args[7])
        gd.plan_band_bins(dqlen, dlo, n, K)
        gd.traceback_rle(*walk_call)
        sd.seed_lookup(*lookup_args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    _say(f"no host waits: plan_bins (B={ext_args[1].numel()}, "
         f"LQ={ext_args[7]}), plan_band_bins (B={dqlen.numel()}, K={K}), "
         f"traceback_rle (B={walk_call[0].shape[0]}), seed_lookup "
         f"(N={lookup_args[0].shape[0]}) under set_sync_debug_mode('error')")


def _device_us(e):
    """A profiler average's own device time, in microseconds."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(e, name, None)
        if v:
            return v
    return 0


def profile_seed_chunk(kept, top=10):
    """One chunk of the device_seed run (the first seed call it made)
    seeded again: the seed call's host time (padding, upload, seed_core,
    the overflow read, download), seed_core's time by CUDA events, and a
    torch.profiler table of the ten torch ops of its seed_core with the
    most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from seeksv_tpu_torch.ops import seed_device as sd
    (seeder, reads, cap), _kw = kept
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seeder.seed(reads, cap)
    torch.cuda.synchronize()
    seed_s = time.perf_counter() - t0
    mat, lens = seeder.upload(sd.pad_reads(reads, seeder.k))
    core_ms = _cuda_ms(lambda: seeder.core(mat, lens, cap), 3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        seeder.core(mat, lens, cap)
        torch.cuda.synchronize()
    avgs = prof.key_averages()
    kernels = [e for e in avgs if str(e.device_type).endswith("CUDA")]
    kernel_ms = sum(_device_us(e) for e in kernels) / 1e3
    ops = sorted((e for e in avgs if not str(e.device_type).endswith("CUDA")
                  and _device_us(e) > 0), key=_device_us, reverse=True)
    _say(f"seed chunk of the device_seed run: {len(reads)} strand reads, "
         f"hit_cap {cap}: seed call {seed_s * 1e3:.3f} ms on the host clock, "
         f"seed_core {core_ms:.3f} ms by CUDA events, its kernels "
         f"{kernel_ms:.3f} ms of device time ({len(kernels)} kernels by "
         f"name) by torch.profiler")
    if not kernels:
        _say("  torch.profiler shows no device time: seed_core timed by CUDA "
             "events alone")
        return
    for e in ops[:top]:
        _say(f"  {_device_us(e) / 1e3:8.3f} ms device, {e.count:4d} calls, "
             f"{_device_us(e) / 1e3 / max(kernel_ms, 1e-9):6.1%}  {e.key}")


def _consensus_cases(dev, G, LL, LR):
    """Groups of 1, 2, 8, 9 and G reads (and none) of noisy copies of two
    templates, then eight groups of random reads that overflow
    max_slots = 8 (tests/torch_inputs.py:sized_groups), on the card."""
    import torch
    from torch_inputs import sized_groups
    sizes = [0, 1, 2, 8, 9, G] * 4 + [G] * 8
    return [torch.from_numpy(a).to(dev)
            for a in sized_groups(5, sizes, G, LL, LR, S_random=8)]


def check_consensus_paths(dev):
    """K5 against its plain version, exactly, on groups of every size
    class (none, 1, 2, 8, 9 and G reads, eight of them overflowing), and
    on groups of 2,000 reads, whose lengths and slot state are past the
    shared memory a warp has and stay in device memory."""
    import torch

    from seeksv_tpu_torch.ops import consensus_scan as cs
    from torch_inputs import sized_groups
    G, L, S = 45, 999, 8
    arrays = _consensus_cases(dev, G, L, L)
    big = [torch.from_numpy(a).to(dev)
           for a in sized_groups(1, [2000, 3, 2000, 1], 2000, 40, 36)]
    for name, inputs, n_over in (("sides up to 999 bytes", arrays, 8),
                                 ("sides up to 40 bytes", big, None)):
        got = cs.consensus_scan_groups(*inputs, 17, 20, max_slots=S)
        want = cs.consensus_scan_plain(*inputs, 17, 20, max_slots=S)
        torch.cuda.synchronize()
        err = _max_abs_err([(got[k], want[k]) for k in want])
        over = int(want["overflow"].sum())
        _say(f"consensus_scan paths: {len(inputs[4])} groups of "
             f"{sorted(set(inputs[4].tolist()))} reads, {name}, "
             f"{over} overflow: max_abs_err={err}")
        if err or n_over not in (None, over):
            raise AssertionError("consensus_scan disagrees with its plain "
                                 "version on one of its paths")


def check_consensus_scan(kept, rows):
    """K5 against its plain version on the SPMD run's first consensus
    call, with 64 groups of random reads appended (at least 16 each, so
    max_slots = 8 overflows); timed as its launch alone and as the whole
    call, each beside a bound counted from the bytes it needs."""
    import torch

    from seeksv_tpu_torch.ops import consensus_scan as cs
    (seq_l, len_l, seq_r, len_r, n_reads, num, den), kw = kept
    NG, G, LL = seq_l.shape
    LR = seq_r.shape[2]
    dev = seq_l.device
    G2 = max(G, 16)
    gen = torch.Generator(device=dev).manual_seed(1)

    def grow(x, extra):
        pad = [0, 0] * (x.dim() - 2) + [0, G2 - G]
        return torch.cat([torch.nn.functional.pad(x, pad), extra])
    rnd = lambda L: torch.randint(65, 69, (64, G2, L), generator=gen,
                                  device=dev, dtype=torch.uint8)
    full = lambda L: torch.full((64, G2), L, dtype=torch.int32, device=dev)
    args = (grow(seq_l, rnd(LL)), grow(len_l, full(LL)),
            grow(seq_r, rnd(LR)), grow(len_r, full(LR)),
            torch.cat([n_reads, torch.full((64,), G2, dtype=torch.int32,
                                           device=dev)]), num, den)
    got = cs.consensus_scan_groups(*args, max_slots=8)
    want = cs.consensus_scan_plain(*args, max_slots=8)
    torch.cuda.synchronize()
    err = _max_abs_err([(got[k], want[k]) for k in want])
    n_over = int(want["overflow"].sum())
    # the run's own groups by their number of reads
    sizes = np.bincount(n_reads.cpu().numpy(), minlength=G + 1)
    order = cs.plan_groups(args[1], args[3], args[4])
    _say(f"consensus_scan: the run's {NG} groups by reads "
         f"{json.dumps({str(i): int(c) for i, c in enumerate(sizes) if c})}"
         f"; a group's live bytes are "
         f"{int(cs.live_bytes(args[1], args[3], args[4]).max())} at the most")
    # timed three ways: the launch alone (the order made before), the call
    # as the pipeline makes it (mesh_consensus: with_sides=False, the
    # ordering's torch ops in it), and the call with the gathers of the
    # sides' rows (what the pipeline asked for before)
    launch = lambda: cs.consensus_scan_groups(
        *args, max_slots=8, with_sides=False, order=order)
    launch_ms = _cuda_ms(launch, 3)
    ms = _cuda_ms(lambda: cs.consensus_scan_groups(
        *args, max_slots=8, with_sides=False), 3)
    sides_ms = _cuda_ms(lambda: cs.consensus_scan_groups(*args, max_slots=8),
                        3)
    plain_ms = _cuda_ms(lambda: cs.consensus_scan_plain(*args, max_slots=8),
                        1)
    # the bound, from what the kernel needs: the live bytes of the live
    # reads' sides, their two lengths, n_reads and the kernel's outputs,
    # each once; operations: each read's two sides compared (a compare and
    # a count per base) against at most the slots its group ends with.
    # With the sides, the gathered rows and lengths it writes are added.
    live = torch.arange(G2, device=dev)[None, :] < args[4][:, None]
    bases = ((args[1] + args[3]) * live).sum(dim=1).to(torch.int64)
    kernel_keys = ("support", "n_slots", "slot_of_read", "overflow", "src_l",
                   "src_r")
    live_bytes = (int(bases.sum()) + int(live.sum()) * 8 + _nbytes(args[4])
                  + _nbytes(*(got[k] for k in kernel_keys)))
    gathered = _nbytes(*(v for k, v in got.items() if k not in kernel_keys))
    ops = int((bases * got["n_slots"].clamp(max=8)).sum()) * 2
    bound = _bound(ops, live_bytes)
    sides_bound = _bound(ops, live_bytes + gathered)
    shape = (f"the SPMD run's first call NG={NG} G={G} LL={LL} LR={LR} "
             f"(max_slots {kw.get('max_slots')}, with_sides "
             f"{kw.get('with_sides', True)}) + 64 random groups, G {G2}, "
             f"max_slots 8")
    _say(f"consensus_scan: {shape}: {n_over} groups overflow, "
         f"max_abs_err={err} launch alone {launch_ms:.3f} ms, the call as "
         f"the pipeline makes it (the ordering's torch ops too, no sides) "
         f"{ms:.3f} (bound {bound[0]:.4g} ms by {bound[1]}: {live_bytes} "
         f"live bytes, {int(live.sum())} reads), with the gathers of the "
         f"sides' rows {sides_ms:.3f} (bound {sides_bound[0]:.4g} ms: "
         f"{gathered} gathered bytes more), plain {plain_ms:.3f} ms")
    if err or n_over < 64:
        raise AssertionError("consensus_scan disagrees with its plain "
                             "version or the overflow groups did not")
    if kw.get("with_sides", True):
        raise AssertionError("mesh_consensus asked K5 for the sides' rows")
    rows["consensus_scan"] = {
        "route": "cuda", "source": "seeksv_tpu_torch/csrc/consensus_scan.cu",
        "replaces": "seeksv_tpu/ops/consensus_scan.py:31",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound[0], "bound_by": bound[1], "library_ms": None,
        "library_why": NO_LIBRARY["consensus_scan"],
        "ms_of": f"one call as mesh_consensus makes it (one launch and the "
                 f"ordering, no sides' rows), {shape}",
        "launch_ms": launch_ms, "with_sides_ms": sides_ms,
        "with_sides_bound_ms": sides_bound[0]}


def _profile_table(name, fn, top=6):
    """A torch.profiler table (CPU and CUDA activity) of ten calls of fn
    (the second of two sessions: a first one can miss the device rows)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _session in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
    _say(f"{name}: torch.profiler, ten calls:")
    for line in prof.key_averages().table(
            sort_by="self_cuda_time_total", row_limit=top).splitlines():
        _say(f"  {line}")


def _cold_ms(fn, reps):
    """Mean milliseconds of fn by CUDA events around each call alone, 256 MB
    read before each (outside the timed span, and still running when the
    call is queued), so that none of its inputs sits in the card's 50 MB
    L2 and no dirty line waits there to be written back."""
    import torch
    flush = torch.zeros(256 << 20, dtype=torch.uint8, device="cuda")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    total = 0.0
    for _ in range(reps):
        flush.max()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def check_discordant_count(kept, rows):
    """K6 against its plain version on the SPMD run's discordant call
    (padding rows are empty windows) and on the edge cases of
    tests/torch_inputs.py:discordant_edge_cases, exactly; timed as its
    launch alone (warm, and cold: L2 flushed before each), the wrapper's
    call (its `ms` the cold call, held against the bound by device
    memory), _count's work past the record uploads
    (parallel/spmd_pipeline.py:_count_uploaded: the junctions packed on the
    host and uploaded, the count) and _count's whole work from host
    columns, beside two bounds (each record once per window that holds
    it, and each distinct record once); torch.profiler tables; with
    --parent, the parent's kernel on the same windows in turns with this
    one: its launch, and _count's work as the parent made it (ten
    junction uploads, 18 checks, the launch; the whole of it with the
    eight record uploads), where _count's work past the record uploads
    must be the faster."""
    import torch

    from seeksv_tpu_torch import _build
    from seeksv_tpu_torch.ops import discordant as dc
    from seeksv_tpu_torch.ops.extend import _check
    from seeksv_tpu_torch.parallel import spmd_pipeline as sp
    from torch_inputs import (discordant_args, discordant_edge_cases,
                              discordant_packed)
    args, kw = kept
    recs, jun = args[:8], args[8]
    cap = kw["window_cap"]
    dev = jun.device
    R, J = recs[0].shape[0], jun.shape[1]
    juns = dc.unpack_junctions(jun)
    got = dc.discordant_count_batch(*recs, jun, window_cap=cap)
    want = dc.discordant_count_plain(*recs, *juns, window_cap=cap)
    torch.cuda.synchronize()
    err = _max_abs_err([(got, want)])
    edges = []
    for name, r, j, wc in discordant_edge_cases():
        ra, ja = ([torch.from_numpy(x).to(dev) for x in a]
                  for a in discordant_args(r, j))
        e_got = dc.discordant_count_batch(*discordant_packed(r, j, dev),
                                          window_cap=wc)
        e_want = dc.discordant_count_plain(*ra, *ja, window_cap=wc)
        torch.cuda.synchronize()
        edges.append((name, _max_abs_err([(e_got, e_want)]),
                      int(e_want.sum())))
    _say(f"discordant_count edge cases (name, max_abs_err, pairs): "
         f"{json.dumps(edges)}")
    lib = _build.lib()
    out = torch.empty(J, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rec_ptrs = [x.data_ptr() for x in recs]
    launch = lambda: lib.seeksv_discordant_count(
        *rec_ptrs, R, jun.data_ptr(), J, cap, out.data_ptr(), stream)
    call = lambda: dc.discordant_count_batch(*recs, jun, window_cap=cap)
    # _count's inputs: the run's columns on the host, and uploaded
    rec_np = {k: x.cpu().numpy() for (k, _), x in zip(dc.REC_COLS, recs)}
    jun_np = {k: x.cpu().numpy() for (k, _), x in zip(dc.JUN_COLS, juns)}
    min_ins, max_ins = int(jun_np.pop("min_ins")[0]), \
        int(jun_np.pop("max_ins")[0])
    uploaded = lambda: sp._count_uploaded(list(recs), jun_np, min_ins,
                                          max_ins, cap)
    whole = lambda: sp._count(dev, rec_np, jun_np, min_ins, max_ins, cap)
    for fn in (uploaded, whole):
        o = fn()
        torch.cuda.synchronize()
        if not torch.equal(o, want):
            raise AssertionError("_count disagrees with the plain version")
    launch_ms = _cuda_ms(launch, 20)
    launch_cold_ms = _cold_ms(launch, 10)
    warm_ms = _cuda_ms(call, 20)
    ms = _cold_ms(call, 10)
    uploaded_ms = _cuda_ms(uploaded, 50)
    whole_ms = _cuda_ms(whole, 5)
    plain_ms = _cuda_ms(lambda: dc.discordant_count_plain(
        *recs, *juns, window_cap=cap), 1)
    parent = {}
    if PARENT["lib"]:
        # the parent's kernel on the same columns, and _count's work as the
        # parent made it: each junction column uploaded (and, for the
        # whole, each record column), 18 columns checked, 23 arguments
        pout = torch.empty(J, dtype=torch.int32, device=dev)
        ptrs = rec_ptrs + [R] + [x.data_ptr() for x in juns] + \
            [J, cap, pout.data_ptr()]
        p_launch = lambda: _parent_call("seeksv_discordant_count", *ptrs)
        put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        def p_count(rec_cols):
            cols = {**jun_np, "min_ins": np.full(J, min_ins, np.int64),
                    "max_ins": np.full(J, max_ins, np.int64)}
            jc = [put(cols[k]) for k, _ in dc.JUN_COLS]
            for (nm, dt), x in zip(dc.REC_COLS, rec_cols):
                _check(nm, x, dt, (R,), dev)
            for (nm, dt), x in zip(dc.JUN_COLS, jc):
                _check(nm, x, dt, (J,), dev)
            o = torch.empty(J, dtype=torch.int32, device=dev)
            _parent_call("seeksv_discordant_count",
                         *(x.data_ptr() for x in rec_cols), R,
                         *(x.data_ptr() for x in jc), J, cap, o.data_ptr())
            return o
        p_uploaded = lambda: p_count(recs)
        p_whole = lambda: p_count([put(rec_np[k]) for k, _ in dc.REC_COLS])
        p_launch()
        for o in (pout, p_uploaded(), p_whole()):
            torch.cuda.synchronize()
            if not torch.equal(o, want):
                raise AssertionError("the parent's discordant_count "
                                     "disagrees")
        this_l, par_l = _in_turns("discordant_count launch alone", p_launch,
                                  launch, reps=20)
        cold = [_cold_ms(f, 10) for f in (p_launch, launch, launch,
                                          p_launch)]
        _say(f"discordant_count launch alone, cold, in turns: parent "
             f"{cold[0]:.4f} ms, this {cold[1]:.4f}, this {cold[2]:.4f}, "
             f"parent {cold[3]:.4f}")
        this_u, par_u = _in_turns("discordant_count _count past the record "
                                  "uploads", p_uploaded, uploaded, reps=50)
        this_w, par_w = _in_turns("discordant_count _count from host "
                                  "columns", p_whole, whole, reps=5)
        _beats_parent("discordant_count _count past the record uploads",
                      "discordant_count.cu", this_u, par_u)
        parent = {"parent_launch_ms": par_l, "launch_ms_in_turns": this_l,
                  "parent_launch_cold_ms": [cold[0], cold[3]],
                  "launch_cold_ms_in_turns": cold[1:3],
                  "parent_count_uploaded_ms": par_u,
                  "count_uploaded_ms_in_turns": this_u,
                  "parent_count_whole_ms": par_w,
                  "count_whole_ms_in_turns": this_w}
    _profile_table("discordant_count call", call)
    _profile_table("_count past the record uploads", uploaded)
    # the bounds: 30 operations a record a window visits; bytes at the
    # rate of device memory (what a cold call reads), the junctions and
    # the counts, and either each record's eight columns once per window
    # that holds it, or what this run's data needs: each distinct record's
    # head (base_ok, end, mtid) once, and its other five columns once
    # where its head passes in some window
    junh = jun.cpu().numpy()
    _first, _last, live = dc.window_ranges(junh, R, cap)
    in_windows = int(np.where(live, np.minimum(junh[1] - junh[0], cap),
                              0).sum())
    distinct = dc.distinct_records(junh, R, cap)
    g = jun[0][:, None] + torch.arange(cap, device=dev)[None, :]
    gi = g.clamp(0, max(R - 1, 0))
    head = ((g < jun[1][:, None]) & (((jun[7] >> 32) & 3) != 3)[:, None]
            & recs[7][gi] & (recs[1][gi] > jun[2][:, None])
            & (recs[4][gi] == juns[5][:, None]))
    tails = int(torch.unique(gi[head]).numel())
    size = [x.element_size() for x in recs]
    head_bytes = size[7] + size[1] + size[4]
    other = _nbytes(jun) + _nbytes(got)
    bound_visits = _bound(in_windows * 30, in_windows * sum(size) + other)
    bound = _bound(in_windows * 30, distinct * head_bytes
                   + tails * (sum(size) - head_bytes) + other)
    empty = int((jun[1] <= jun[0]).sum())
    shape = (f"the SPMD run's call J={J} ({empty} empty windows) over "
             f"R={R} records, window_cap={cap}")
    _say(f"discordant_count: {shape}: {int(want.sum())} pairs, "
         f"max_abs_err={err}; launch alone {launch_ms:.4f} ms warm, "
         f"{launch_cold_ms:.4f} cold; the call {warm_ms:.4f} warm, "
         f"{ms:.4f} cold; _count past the record uploads (the junctions "
         f"packed on the host and uploaded, the count) {uploaded_ms:.4f} "
         f"ms, _count from host columns {whole_ms:.4f} ms; plain "
         f"{plain_ms:.3f} ms; bound {bound[0]:.4g} ms by {bound[1]} "
         f"({distinct} distinct records in the windows, {head_bytes} "
         f"bytes each, {tails} of them passing a head test, "
         f"{sum(size) - head_bytes} bytes more each, at the rate of "
         f"device memory), bound counting each record's {sum(size)} bytes "
         f"once a window {bound_visits[0]:.4g} ms by {bound_visits[1]} "
         f"({in_windows} records in windows)")
    if err or not int(want.sum()) or any(e for _n, e, _c in edges):
        raise AssertionError("discordant_count disagrees with its plain "
                             "version or counts nothing")
    rows["discordant_count"] = {
        "route": "cuda", "source": "seeksv_tpu_torch/csrc/discordant_count.cu",
        "replaces": "seeksv_tpu/ops/jax_kernels.py:165",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound[0], "bound_by": bound[1], "library_ms": None,
        "library_why": NO_LIBRARY["discordant_count"],
        "ms_of": f"one cold call of the wrapper (256 MB read before "
                 f"each, so the records come from device memory, as the "
                 f"bound assumes), {shape}",
        "warm_ms": warm_ms, "launch_ms": launch_ms,
        "launch_cold_ms": launch_cold_ms,
        "count_uploaded_ms": uploaded_ms, "count_whole_ms": whole_ms,
        "bound_visits_ms": bound_visits[0],
        "distinct_records": distinct, "head_passing_records": tails,
        "records_in_windows": in_windows, "edge_cases": edges, **parent}


# the kernels each run of the slice must launch (and no others)
SPMD = ("extend_windows", "banded_dir", "traceback", "consensus_scan",
        "discordant_count")
EXPECTED = {
    "device": ("extend_left", "extend_right", "banded_dir", "traceback"),
    "device_seed": ("seed_lookup", "extend_left", "extend_right",
                    "banded_dir", "traceback"),
    "device_align": ("seed_lookup", "extend_windows", "banded_dir",
                     "traceback"),
    "stream_device_align": ("seed_lookup", "extend_windows", "banded_dir",
                            "traceback"),
    "spmd": SPMD,
    "stream_spmd": SPMD,
    "multiproc": ("extend_left", "extend_right", "banded_dir", "traceback"),
    "multiproc_somatic_range": (),
    "multiproc_somatic": (),
    "evidence": ("extend_windows",),
    "aln_paired": ("extend_left", "extend_right", "banded_dir", "traceback"),
    "cli_rescue_profile": ("extend_left", "extend_right", "banded_dir",
                           "traceback"),
    # the scale phase on 100 bp reads: no finalize job is long enough for
    # the card (m, n > 256), and the SPMD stream merges its consensus on
    # the host, as the JAX script does
    "scale_ab": ("extend_left", "extend_right"),
    "scale_somatic": ("extend_left", "extend_right"),
    "scale_entry": ("extend_right",),
    "scale_stream_spmd": ("extend_left", "extend_right", "extend_windows",
                          "discordant_count"),
}
# the runs that write the pipeline's outputs, each compared with
# force_host's; the multi-process run's clip files are its rank 0's
PIPELINE_RUNS = ("device", "device_seed", "device_align",
                 "stream_device_align", "spmd", "stream_spmd", "multiproc")
CLIP_PREFIX = {"multiproc": "multiproc.p0"}


def _counters():
    """(the launch counters of every kernel, the counters of plain-version
    calls, the hit_cap counters)."""
    from seeksv_tpu_torch.ops import consensus_scan as cs
    from seeksv_tpu_torch.ops import discordant as dc
    from seeksv_tpu_torch.ops import extend as ext
    from seeksv_tpu_torch.ops import global_device as gd
    from seeksv_tpu_torch.ops import seed_device as sd
    mods = (ext, gd, sd, cs, dc)
    return (tuple(x.LAUNCHES for x in mods),
            tuple(x.PLAIN_CALLS for x in mods), sd.OVERFLOW)


def _drive(name, fn):
    """Run fn with every counter at 0 just before; return its result and
    the launches it made; fail unless they are exactly EXPECTED[name], or
    if any wrapper took its plain version during the run."""
    launch_counts, plain_counts, overflow_count = _counters()
    for c in (*launch_counts, *plain_counts, overflow_count):
        for key in c:
            c[key] = 0
    res = fn()
    launches = {k: v for c in launch_counts for k, v in c.items()}
    plain = {k: v for c in plain_counts for k, v in c.items()}
    overflow = dict(overflow_count)
    _say(f"slice {name}: launches {json.dumps(launches)} plain-version "
         f"calls {sum(plain.values())} hit_cap {json.dumps(overflow)}")
    want = EXPECTED[name]
    wrong = {k: v for k, v in launches.items() if (v > 0) != (k in want)}
    if wrong:
        raise AssertionError(f"slice {name}: expected launches of exactly "
                             f"{want}, got {launches}")
    if any(plain.values()):
        raise AssertionError(f"slice {name}: a wrapper took its plain "
                             f"version on the card: {plain}")
    if overflow["to_host"]:
        raise AssertionError(f"slice {name}: {overflow['to_host']} chunk(s) "
                             "overflowed to host seeding")
    return res, launches


def run_spmd(dev, ref, bam, out, index, rows, drive):
    """The SPMD pipeline and its streaming form on a one-rank NCCL mesh;
    K5 and K6 held against their plain versions on the inputs of the
    SPMD run's first consensus and discordant calls."""
    import torch.distributed as dist

    from seeksv_tpu_torch.parallel import spmd_pipeline as sp
    from seeksv_tpu_torch.parallel.mesh import make_mesh
    from seeksv_tpu_torch.parallel.stream_spmd import \
        spmd_run_pipeline_streaming
    mesh = make_mesh(dev)
    _say(f"spmd: mesh {mesh}")
    kept = {}
    try:
        undo = [_keep_first_call(sp, name, kept) for name in
                ("consensus_scan_groups", "discordant_count_batch")]
        try:
            drive("spmd", lambda: sp.spmd_run_pipeline(
                mesh, ref, bam, os.path.join(out, "spmd"), index=index,
                log=lambda m: _say(f"  spmd: {m}")))
        finally:
            for u in undo:
                u()
        drive("stream_spmd", lambda: spmd_run_pipeline_streaming(
            mesh, ref, bam, os.path.join(out, "stream_spmd"),
            mesh_consensus=True, chunk_records=400_000, index=index,
            log=lambda m: _say(f"  stream_spmd: {m}")))
        check_consensus_scan(kept["consensus_scan_groups"], rows)
        check_discordant_count(kept["discordant_count_batch"], rows)
        run_multiproc(mesh, ref, bam, out, index, drive)
        run_evidence(mesh, rows, drive)
    finally:
        dist.destroy_process_group()


def _timed(fn, **kw):
    """fn(stages=..., **kw) as a run of the slice: {"stages_s", "out"}."""
    stages = {}
    return {"stages_s": stages, "out": fn(stages=stages, **kw)}


def run_multiproc(mesh, ref, bam, out, index, drive):
    """The multi-process pipeline and both somatic forms on the one-rank
    mesh.  The somatic runs take the flagship BAM as its own normal
    against the default run's .sv; their temp and final files must equal
    the port's sequential getclip + somatic + somatic_filter on the same
    inputs."""
    from seeksv_tpu_torch.parallel import multiproc as mp
    from seeksv_tpu_torch.pipeline.getclip import getclip
    from seeksv_tpu_torch.pipeline.somatic import somatic, somatic_filter
    drive("multiproc", lambda: _timed(
        mp.multiprocess_run_pipeline, mesh=mesh, ref_fa=ref, bam=bam,
        prefix=os.path.join(out, "multiproc"), index=index,
        log=lambda m: _say(f"  multiproc: {m}")))
    tumor_sv = os.path.join(out, "device.sv")
    for name, fn, tag in (
            ("multiproc_somatic_range", mp.multiprocess_somatic_range, "mpr"),
            ("multiproc_somatic", mp.multiprocess_somatic, "mps")):
        drive(name, lambda: _timed(
            fn, mesh=mesh, normal_bam=bam, tumor_sv=tumor_sv,
            out_temp=os.path.join(out, f"{tag}.temp.sv"),
            out_final=os.path.join(out, f"{tag}.somatic.sv"),
            prefix=os.path.join(out, tag),
            log=lambda m: _say(f"  {name}: {m}")))
    t0 = time.perf_counter()
    getclip(bam, os.path.join(out, "seqn"))
    somatic(bam, os.path.join(out, "seqn.clip.gz"), tumor_sv,
            os.path.join(out, "seq.temp.sv"))
    somatic_filter(os.path.join(out, "seq.temp.sv"),
                   os.path.join(out, "seq.somatic.sv"))
    seq_s = time.perf_counter() - t0
    want = {}
    for suffix in ("temp.sv", "somatic.sv"):
        with open(os.path.join(out, f"seq.{suffix}"), "rb") as f:
            want[suffix] = f.read()
    for tag in ("mpr", "mps"):
        for suffix in ("temp.sv", "somatic.sv"):
            with open(os.path.join(out, f"{tag}.{suffix}"), "rb") as f:
                if f.read() != want[suffix]:
                    raise AssertionError(f"{tag}.{suffix} differs from the "
                                         "sequential somatic pass")
    rows = [ln.split("\t") for ln in want["temp.sv"].decode().splitlines()
            if not ln.startswith("@")]
    counted = sum(1 for r in rows if r[23:26] != ["0", "0", "0"])
    final = sum(1 for ln in want["somatic.sv"].decode().splitlines()
                if not ln.startswith("@"))
    _say(f"multiproc somatic: temp and final files of both forms "
         f"byte-identical to the sequential pass ({seq_s:.1f} s): "
         f"{len(rows)} tumor rows, {counted} with nonzero control counts, "
         f"{final} left after the filter")
    if not counted:
        raise AssertionError("the somatic check is vacuous: no tumor row "
                             "found support in its own normal")


def run_evidence(mesh, rows, drive, genome_len=52_000_000,
                 n_reads=1_000_000, n_jobs=8192, lq=1024, lt=1152):
    """sharded_evidence_step on make_example_batch at the flagship's
    genome and K1w's front-end shape on the one-rank mesh: its extension
    results against K1w's plain version on the same jobs, its coverage,
    insert statistics and candidate table against a numpy recomputation;
    K1w timed on those jobs beside its bound."""
    import torch

    from seeksv_tpu_torch.ops import extend as ext
    from seeksv_tpu_torch.parallel import sharded
    t0 = time.perf_counter()
    batch = sharded.make_example_batch(mesh, genome_len, n_reads, n_jobs,
                                       lq, lt)
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    step = sharded.sharded_evidence_step(mesh, genome_len)

    def run():
        t = time.perf_counter()
        res = step(batch)
        torch.cuda.synchronize()
        return {"stages_s": {"batch": batch_s,
                             "step": time.perf_counter() - t}, "out": res}
    res = drive("evidence", run)["out"]
    q, t = batch["q"].to(torch.uint8), batch["t"].to(torch.uint8)
    jobs = (q, batch["qlen"], t, batch["tlen"], batch["h0"])
    want = ext.extend_batch_plain(*jobs, with_rows=True)
    torch.cuda.synchronize()
    err = _max_abs_err([(res["sw"][k], want[k]) for k in ext.KEYS])
    ms = _cuda_ms(lambda: ext.extend_batch(*jobs), 3)
    plain_ms = _cuda_ms(lambda: ext.extend_batch_plain(*jobs), 1)
    cells, count, bound = _extend_bound(batch["qlen"], want, 1, 1)
    # the numpy recomputation of the rest (sharded.py:36-77)
    b = {k: v.cpu().numpy() for k, v in batch.items()}
    diff = np.bincount(np.clip(b["seg_start"], 0, genome_len),
                       b["seg_weight"], minlength=genome_len + 1) \
        - np.bincount(np.clip(b["seg_end"], 0, genome_len),
                      b["seg_weight"], minlength=genome_len + 1)
    cov = np.cumsum(diff.astype(np.int64))[:genome_len]
    hist = np.bincount(np.clip(b["isize"], 0, 2047), b["isize_ok"],
                       minlength=2048).astype(np.int64)
    n = max(int(hist.sum()), 1)
    mean = int((hist * np.arange(2048)).sum() // n)
    var = float((hist * (np.arange(2048) - mean) ** 2).sum()) / n
    order = np.argsort(b["cand_key"], kind="stable")
    sk = b["cand_key"][order]
    first = np.concatenate([[True], sk[1:] != sk[:-1]])
    seg = np.bincount(np.cumsum(first) - 1, b["cand_support"][order],
                      minlength=len(sk)).astype(np.int64)
    got = {k: res[k].cpu().numpy() for k in res if k != "sw"}
    bad = [k for k, ok in (
        ("coverage", np.array_equal(got["coverage"], cov)),
        ("insert_mean", int(got["insert_mean"][0]) == mean),
        ("insert_dev", int(got["insert_dev"][0]) == int(np.sqrt(var))),
        ("cand_sorted_keys", np.array_equal(got["cand_sorted_keys"], sk)),
        ("cand_first", np.array_equal(got["cand_first"], first)),
        ("cand_support_sum", np.array_equal(got["cand_support_sum"], seg)))
        if not ok]
    _say(f"evidence: genome {genome_len}, {n_reads} reads, {n_jobs} jobs "
         f"LQ={lq} LT={lt}: insert mean {mean} dev "
         f"{int(got['insert_dev'][0])} (numpy {np.sqrt(var):.4f}), "
         f"{int(first.sum())} candidate keys, coverage max {cov.max()}; "
         f"K1w max_abs_err={err} kernel {ms:.3f} ms, plain {plain_ms:.3f} "
         f"ms, bound {bound[0]:.4g} ms by {bound[1]} ({count}); "
         f"differs from numpy: {bad}")
    if err or bad:
        raise AssertionError(f"the evidence step disagrees: sw "
                             f"max_abs_err={err}, {bad}")
    rows["extend_windows"]["on_the_evidence_jobs"] = {
        "B": n_jobs, "LQ": lq, "LT": lt, "cells": cells, "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
        "bound_by": bound[1]}


def _revcomp(seq: bytes) -> bytes:
    return seq.translate(bytes.maketrans(b"ACGTN", b"TGCAN"))[::-1]


def write_pairs(bam, unmapped_prefix, out_prefix, n_pairs=2000):
    """FASTQ pairs for ``aln -2``: the default run's unmapped_{1,2}.fq.gz
    (the virus-mode reads the reference leaves to bwa), then the first
    n_pairs proper pairs of the BAM in file order, each end in its read's
    own orientation.  Returns (r1 path, r2 path, pairs from the unmapped
    files, proper pairs)."""
    from seeksv_tpu_torch.io.bam import read_bam
    recs = read_bam(bam)
    flag = np.asarray(recs.flag)
    ends = {}
    pairs = []
    for i in np.nonzero(((flag & 0x2) != 0) & ((flag & 0x900) == 0))[0]:
        i = int(i)
        name = recs.qnames[i]
        seq = recs.seq_bytes(i)
        qual = recs.qual_str(i)
        if flag[i] & 0x10:
            seq, qual = _revcomp(seq), qual[::-1]
        ends.setdefault(name, {})[1 if flag[i] & 0x40 else 2] = (seq, qual)
        if len(ends[name]) == 2:
            pairs.append((name, ends.pop(name)))
            if len(pairs) == n_pairs:
                break
    paths, n_unmapped = [], 0
    for end in (1, 2):
        path = f"{out_prefix}_{end}.fq.gz"
        with gzip.open(f"{unmapped_prefix}.unmapped_{end}.fq.gz", "rb") as f:
            head = f.read()
        n_unmapped = head.count(b"\n") // 4
        with gzip.open(path, "wb") as f:
            f.write(head)
            for name, e in pairs:
                seq, qual = e[end]
                f.write(b"@%s/%d\n%s\n+\n%s\n" % (name, end, seq, qual))
        paths.append(path)
    return paths[0], paths[1], n_unmapped, len(pairs)


def run_aln_paired(dev, ref, bam, out, index, drive):
    """``aln -2`` on the card (align_paired_fastq_to_sam through
    BatchAligner.batch_align: K1 both ways, K2, K3) on the flagship's
    reference with pairs from the flagship BAM; both ends' dispatch must
    choose the device under the committed crossover, and the SAM must be
    byte-identical to force_host's."""
    from seeksv_tpu_torch.align.engine import align_paired_fastq_to_sam
    fq1, fq2, n_un, n_proper = write_pairs(
        bam, os.path.join(out, "device"), os.path.join(out, "pairs"))
    sam = os.path.join(out, "aln.sam")
    res = drive("aln_paired", lambda: align_paired_fastq_to_sam(
        ref, fq1, fq2, sam, device=dev, index=index))
    for d in res["dispatch"]:
        if not d or not d["chose_device"] or not d["crossover_applied"]:
            raise AssertionError(f"aln -2: an end did not choose the device "
                                 f"under the crossover: {d}")
    t0 = time.perf_counter()
    host = align_paired_fastq_to_sam(ref, fq1, fq2,
                                     os.path.join(out, "aln_host.sam"),
                                     device=dev, force_host=True,
                                     index=index)
    host_s = time.perf_counter() - t0
    with open(sam, "rb") as a, open(os.path.join(out, "aln_host.sam"),
                                    "rb") as b:
        got, want = a.read(), b.read()
    if got != want:
        raise AssertionError("aln -2's SAM differs from force_host's")
    lines = [ln.split(b"\t") for ln in got.splitlines()
             if not ln.startswith(b"@")]
    proper = sum(1 for f in lines if int(f[1]) & 0x2)
    mapped = sum(1 for f in lines if not int(f[1]) & 0x4)
    st = {k: round(v, 3) for k, v in res["stages_s"].items()}
    al = {k: round(v, 3) for k, v in res["aligner"].timings.items()}
    _say(f"aln -2: {n_un} unmapped pairs + {n_proper} proper pairs of the "
         f"flagship BAM: {len(lines)} records, {mapped} mapped, {proper} "
         f"proper; stages_s {json.dumps(st)} aligner_s {json.dumps(al)}; "
         f"dispatch {json.dumps(res['dispatch'])}; force_host "
         f"{host_s:.3f} s (align {host['stages_s']['align']:.3f}); SAM "
         f"byte-identical ({len(got)} bytes)")


def run_cli_rescue_profile(dev, ref, bam, out, index, drive):
    """``run --rescue --profile DIR`` through the port's cli.main on the
    card (the dispatch calibration's fingerprint check included): its
    outputs byte-identical to a force_host run with rescue=True, and its
    trace naming the port's kernels."""
    from seeksv_tpu_torch import cli
    from seeksv_tpu_torch.align.engine import BatchAligner
    from seeksv_tpu_torch.pipeline.driver import run_pipeline
    stale = BatchAligner.calibration_stale()
    cal = BatchAligner._load_calibration(BatchAligner._calibration_path())
    _say(f"calibration: stale {stale!r}; crossover "
         f"{BatchAligner._calibrated_min_device_cells()} cells, measured on "
         f"{cal and cal.get('card')}; finalize crossover "
         f"{BatchAligner._min_device_finalize_cells()} cells")
    if stale is not None:
        raise AssertionError(f"the committed dispatch calibration is stale "
                             f"on this card: {stale}")
    prof = os.path.join(out, "profile")
    prefix = os.path.join(out, "cli")
    drive("cli_rescue_profile", lambda: {"stages_s": {}, "out": cli.main(
        ["run", "--rescue", "--profile", prof, "--device", str(dev), "-o",
         prefix, ref, bam])})
    run_pipeline(ref, bam, os.path.join(out, "host_rescue"), device=dev,
                 force_host=True, rescue=True, index=index)
    for suffix in ("clip.sam", "sv", "unmapped.clip.fq", "clip.gz"):
        opener = gzip.open if suffix.endswith(".gz") else open
        with opener(f"{prefix}.{suffix}", "rb") as a, \
                opener(os.path.join(out, f"host_rescue.{suffix}"), "rb") as b:
            if a.read() != b.read():
                raise AssertionError(f"run --rescue --profile: {suffix} "
                                     "differs from force_host's")
    trace = os.path.join(prof, "cli.trace.json")
    with open(trace) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    kernels = {k: sum(1 for n in names if k in n) for k in
               ("extend_kernel", "banded_dir_kernel", "traceback_kernel")}
    _say(f"run --rescue --profile: outputs byte-identical to force_host with "
         f"rescue; trace {os.path.getsize(trace)} bytes, kernel names "
         f"{json.dumps(kernels)}")
    if not all(kernels.values()):
        raise AssertionError(f"the trace lacks a kernel of the port: "
                             f"{kernels}")


def run_slice(dev, workdir, card, rows):
    from seeksv_tpu_torch.align.engine import TorchBatchAligner
    from seeksv_tpu_torch.pipeline.driver import run_pipeline
    from seeksv_tpu_torch.pipeline.stream import run_pipeline_streaming
    from seeksv_tpu_torch.utils.dataset import build_dataset, truth_recall
    t0 = time.perf_counter()
    paths = build_dataset(os.path.join(workdir, "flagship"), 40_000_000,
                          25, 1000, 1, 30, False, virus_kb=12_000,
                          virus_events=6_000, virus_div=0.04, log=_say)
    _say(f"slice: dataset ready in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    # the index cache (which the CLI run loads) under the workdir
    os.environ["HOME"] = os.path.join(workdir, "home")
    index = TorchBatchAligner.from_fasta(paths["ref_fa"], device=dev).idx
    _say(f"slice: k-mer index built in {time.perf_counter() - t0:.1f} s")
    out = os.path.join(workdir, "out")
    os.makedirs(out, exist_ok=True)
    ref, bam = paths["ref_fa"], paths["bam"]
    runs = {}
    launches = {}

    def drive(name, fn):
        runs[name], launches[name] = _drive(name, fn)
        return runs[name]

    from seeksv_tpu_torch.ops import extend as ext
    from seeksv_tpu_torch.ops import global_device as gd
    from seeksv_tpu_torch.ops import seed_device as sd
    kept, dir_calls, walk_calls = {}, [], []
    undo = [_keep_first_call(ext, "extend_batch_resident", kept),
            _keep_calls(gd, "banded_direction", dir_calls),
            _keep_calls(gd, "traceback_rle", walk_calls)]
    try:
        drive("device", lambda: run_pipeline(
            ref, bam, os.path.join(out, "device"), device=dev, index=index))
    finally:
        for u in undo:
            u()
    check_extend_path(kept["extend_batch_resident"], rows)
    check_finalize_path(dir_calls, launches["device"], rows)
    check_traceback_path(walk_calls, launches["device"], rows)
    n_jobs = runs["device"]["aligner"].last_dispatch["n_jobs"]
    _say(f"slice: the default run dispatched {n_jobs} extension jobs per "
         f"direction (phase 2's K1 shape is the TPU record's 18,143)")
    lookup_args = check_seed_lookup(
        dev, index, os.path.join(out, "device.clip.fq.gz"), rows)
    check_no_host_waits(kept["extend_batch_resident"][0], dir_calls[-1],
                        walk_calls[-1], lookup_args)
    del dir_calls, walk_calls, lookup_args
    seed_kept = {}
    undo = _keep_first_call(sd.TorchDeviceSeeder, "seed", seed_kept)
    try:
        drive("device_seed", lambda: run_pipeline(
            ref, bam, os.path.join(out, "device_seed"), device=dev,
            index=index, device_seed=True))
    finally:
        undo()
    profile_seed_chunk(seed_kept.pop("seed"))
    drive("device_align", lambda: run_pipeline(
        ref, bam, os.path.join(out, "device_align"), device=dev,
        index=index, device_align=True))
    drive("stream_device_align", lambda: run_pipeline_streaming(
        ref, bam, os.path.join(out, "stream_device_align"), device=dev,
        index=index, device_align=True, chunk_records=400_000))
    run_aln_paired(dev, ref, bam, out, index, drive)
    run_cli_rescue_profile(dev, ref, bam, out, index, drive)
    run_spmd(dev, ref, bam, out, index, rows, drive)
    runs["force_host"] = run_pipeline(ref, bam, os.path.join(out, "host"),
                                      device=dev, force_host=True,
                                      index=index)
    for name, res in runs.items():
        if not res["stages_s"]:
            continue
        st = {k: round(v, 3) for k, v in res["stages_s"].items()}
        line = f"slice {name} on {card}: stages_s {json.dumps(st)}"
        if "aligner" in res:
            al = {k: round(v, 3) for k, v in res["aligner"].timings.items()}
            line += f" aligner_s {json.dumps(al)}"
        _say(line)
    _say(f"slice: dispatch {json.dumps(runs['device']['aligner'].last_dispatch)}")
    host = {}
    for suffix in ("clip.sam", "sv"):
        with open(os.path.join(out, f"host.{suffix}"), "rb") as f:
            host[suffix] = f.read()
    with gzip.open(os.path.join(out, "host.clip.gz")) as f:
        host["clip.gz"] = f.read()
    for name in PIPELINE_RUNS:
        for suffix in ("clip.sam", "sv", "clip.gz"):
            stem = name if suffix == "sv" else CLIP_PREFIX.get(name, name)
            path = os.path.join(out, f"{stem}.{suffix}")
            opener = gzip.open if suffix.endswith(".gz") else open
            with opener(path, "rb") as f:
                if f.read() != host[suffix]:
                    raise AssertionError(f"{name}.{suffix} differs from "
                                         "the force_host run")
        _say(f"slice: {name} .clip.sam/.sv/.clip.gz byte-identical to "
             f"force_host ({len(host['clip.sam'])} / {len(host['sv'])} / "
             f"{len(host['clip.gz'])} bytes)")
    del_recall, recall = truth_recall(paths["truth"],
                                      os.path.join(out, "device.sv"))
    _say(f"slice: truth recall DEL {del_recall}, virus junctions {recall}")
    if recall < 0.9:
        raise AssertionError(f"virus junction recall {recall} < 0.9")
    shutil.rmtree(workdir, ignore_errors=True)
    return launches


def _jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def run_scale(dev, workdir, rows, genome_mb):
    """Phase 4: the port's scale programs through their main(argv) on the
    card, on short reads (100 bp, 30x, 20 events a Mbp) with the genome
    cut to genome_mb: bench_scale's streamed A/B (K1 held against its
    plain version on the device arm's first call), bench_somatic_scale,
    entry()'s step and bench_stream_spmd on one NCCL rank.  Returns the
    launches of each run."""
    import torch

    from seeksv_tpu_torch.entry import entry
    from seeksv_tpu_torch.ops import extend as ext
    from seeksv_tpu_torch.scripts import (bench_scale, bench_somatic_scale,
                                          bench_stream_spmd)
    t_phase = time.perf_counter()
    # the datasets' and the index's caches under the workdir
    os.environ["HOME"] = os.path.join(workdir, "home")
    out = os.path.join(workdir, "scale")
    os.makedirs(out, exist_ok=True)
    events = round(20 * genome_mb)
    common = ["--genome-mb", f"{genome_mb:g}", "--coverage", "30",
              "--read-len", "100", "--events", str(events), "--trials", "1"]
    _say(f"scale: cut to {genome_mb:g} Mbp of the JAX record's 100 Mbp row "
         f"(BENCH_SCALE.jsonl:29), {events} events (20 a Mbp, as its 2,000 "
         f"at 100 Mbp), 1 trial of its 3; coverage 30 and 100 bp reads as "
         f"there")
    launches = {}

    def drive(name, fn):
        res, launches[name] = _drive(name, fn)
        if res:
            raise AssertionError(f"scale {name}: exit code {res}")

    kept = {}
    undo = _keep_first_call(ext, "extend_batch_resident", kept)
    ab_path = os.path.join(out, "ab.jsonl")
    try:
        drive("scale_ab", lambda: bench_scale.main(
            common + ["--stream", "--ab", "--out", ab_path]))
    finally:
        undo()
    ab = _jsonl(ab_path)
    for row in ab:
        _say(f"scale bench_scale: {json.dumps(row)}")
    dev_row = ab[0]
    d = dev_row["dispatch"]
    if not (dev_row["arm"] == "device" and dev_row["ab"]["arms_sv_identical"]
            and all(r["clip_parity"] == "exact" for r in ab)
            and dev_row["truth_del_recall"] >= 0.95 and d["chose_device"]
            and d["crossover_applied"] and d["LQ"] <= ext.BIN_EDGES[0]):
        raise AssertionError("scale bench_scale: the arms differ, recall "
                             "< 0.95 or the device arm did not extend on "
                             f"the card in the first query-length bin: {d}")
    _say(f"scale bench_scale: arms identical, DEL recall "
         f"{dev_row['truth_del_recall']}, the device arm's dispatch chose "
         f"the card at LQ {d['LQ']} (kernel bin <= {ext.BIN_EDGES[0]}), "
         f"{d['n_jobs']} jobs; realign s: device "
         f"{dev_row['ours_stages_s']['realign']}, forced_host "
         f"{ab[1]['ours_stages_s']['realign']}")
    check_extend_path(kept["extend_batch_resident"], rows,
                      run=f"the {genome_mb:g} Mbp short-read run",
                      key="on_the_short_read_jobs")
    del kept
    som_path = os.path.join(out, "somatic.jsonl")
    drive("scale_somatic", lambda: bench_somatic_scale.main(
        common + ["--seed", "2", "--out", som_path]))
    (som,) = _jsonl(som_path)
    _say(f"scale bench_somatic_scale: {json.dumps(som)}")
    if not (som["somatic_parity"] == "exact" and som["germline_leaked"] == 0
            and som["somatic_truth_recall_ours"] >= 0.95):
        raise AssertionError("scale bench_somatic_scale: parity, recall or "
                             "a germline leak")
    fn, args = entry(dev)
    res, launches["scale_entry"] = _drive("scale_entry", lambda: fn(*args))
    want = ext.extend_batch_resident_plain(*args, 1 << 16, 64, 128, False)
    torch.cuda.synchronize()
    err = _max_abs_err([(res[k], want[k]) for k in ext.KEYS])
    _say(f"scale entry(): B={len(args[1])} LQ 64 LT 128 on the card against "
         f"the plain version: max_abs_err={err}")
    if err:
        raise AssertionError("entry()'s step disagrees with its plain "
                             "version")
    spmd_path = os.path.join(out, "stream_spmd.jsonl")
    drive("scale_stream_spmd", lambda: bench_stream_spmd.main(
        common + ["--ranks", "1", "--out", spmd_path]))
    (spmd,) = _jsonl(spmd_path)
    _say(f"scale bench_stream_spmd: {json.dumps(spmd)}")
    if spmd["sv_parity_vs_sequential_stream"] != "exact":
        raise AssertionError("scale bench_stream_spmd: sv rows differ from "
                             "the sequential stream")
    _say(f"scale: phase {time.perf_counter() - t_phase:.1f} s")
    shutil.rmtree(workdir, ignore_errors=True)
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workdir", default=os.path.join(HERE, "build",
                                                      "chip_smoke"),
                    help="scratch for the dataset and outputs (removed "
                         "after a passing run)")
    ap.add_argument("--parent", default=None, metavar="DIR",
                    help="another checkout of the repo: its traceback.cu "
                         "and seed_lookup.cu are built apart and timed in "
                         "turns with this one's on the same inputs; where "
                         "a source differs, this one's must be the faster")
    ap.add_argument("--scale-mb", type=float, default=10,
                    help="the scale phase's genome, Mbp (its datasets are "
                         "built at this size)")
    ap.add_argument("--scale-only", action="store_true",
                    help="after phase 2's K1 check, only the scale phase")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch sees no CUDA device")
    sys.path[:0] = [HERE, os.path.join(HERE, "tests")]
    import seeksv_tpu_torch  # noqa: F401  (absent: not run from the repo)
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"], capture_output=True, text=True,
        check=True).stdout.strip()
    t_all = time.perf_counter()
    provenance(card)
    if args.parent:
        build_parent(os.path.abspath(args.parent))
    rng = np.random.default_rng(1)
    rows = {}
    genome, refp = check_extend(dev, rng, rows)
    by_run = {}
    if not args.scale_only:
        check_extend_windows(dev, rng, rows)
        check_extend_mixed(dev, rng, genome, refp)
    del genome, refp
    if not args.scale_only:
        check_finalize(dev, rng, rows)
        check_walks(dev)
        check_finalize_edges(dev, rng)
        check_consensus_paths(dev)
        by_run = run_slice(dev, args.workdir, card, rows)
    by_run.update(run_scale(dev, args.workdir, rows, args.scale_mb))
    kernels = []
    for name, row in rows.items():
        per_run = {run: c[name] for run, c in by_run.items()}
        kernels.append({"name": name, "launches": sum(per_run.values()),
                        "launches_by_run": per_run, **row})
    _say(f"total {time.perf_counter() - t_all:.1f} s on {card}")
    _say(card)
    _say(json.dumps({"kernels": kernels}))
    _say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
