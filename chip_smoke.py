#!/usr/bin/env python3
"""Smoke run of the PyTorch port (seeksv_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--workdir build/chip_smoke]

Phases (each prints its lines; any failure exits non-zero):

1. provenance: torch and CUDA versions, nvcc, triton, the card's name and
   power limit, and the build of the port's CUDA kernels from
   seeksv_tpu_torch/csrc (one nvcc per source, all started together);
2. each kernel against its plain PyTorch version on the card, exactly
   (integer outputs, tolerance 0), with each kernel's time beside its
   plain version's:
   - K1 on the resident genome at B = 18,143 jobs, LQ 1024 / LT 1536, in
     both directions (windows off the genome and tlen = 0 rows included).
     18,143 is the flagship's job count in the TPU record
     (BENCH_SCALE.jsonl:27); this simulator gives the flagship 17,999,
     and phase 3 prints the slice's own count beside it;
   - K1w on uploaded windows at one ``--device-align`` chunk's shape:
     B = 8,192 (1,024 strand reads x 8 slots), LQ 1024, LT 1152, half the
     rows empty slots (qlen = tlen = 0);
   - the banded direction pass at K = 128 and 256 on LQ 1024, and the
     walk on its output;
3. the slice: the repo's virus-integration flagship dataset (40 Mb host
   + 12 Mb virus panel, 25x, 1 kb reads, insert mean 3000, 6,000
   integrations at 4 % divergence, error rate 0.002, seed 1) through
   ``seeksv_tpu_torch``'s ``run`` on the card six times: the default
   path, ``device_seed``, ``device_align``, and the streaming driver with
   ``device_align`` at 400,000 records per slab; the launch counters are
   reset just before each run and read just after, and each run must
   launch exactly its own set of kernels.  Between the first two, K4 (the
   k-mer lookup) is held against its plain version on the first 1,024
   strand reads of the run's clip fastq (uint16 keys).  Then the SPMD
   pipeline on a one-rank NCCL mesh (``parallel.mesh.make_mesh``):
   ``spmd_run_pipeline`` and ``spmd_run_pipeline_streaming`` (consensus on
   the mesh, 400,000 records per slab), each through K1w, K2, K3, K5
   (consensus scan) and K6 (discordant count) and no resident K1; K5 and
   K6 are then held against their plain versions, exactly, on the inputs
   of the SPMD run's first consensus call (plus 64 groups of random reads
   that overflow max_slots = 8) and its discordant call.  Then the same
   run with the native host kernels (``force_host``): every device run's
   ``.clip.sam``, ``.sv`` and decompressed ``.clip.gz`` must be
   byte-identical to it, no chunk may overflow to host seeding, and at
   least 90 % of the virus junctions of the truth must be called.

The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``.  Without a CUDA device the script
fails before printing any result.  Imports no jax.
"""
from __future__ import annotations

import argparse
import gzip
import json
import os
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
    t0 = time.perf_counter()
    if not _build.ensure_native():
        raise AssertionError("the native host library did not build")
    _say(f"native host library ready in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    _build.lib()
    _say(f"kernel build: {time.perf_counter() - t0:.3f} s "
         f"(nvcc {_build.build_info['seconds']:.3f} s) -> "
         f"{os.path.relpath(_build.build_info['path'], HERE)}")
    for line in _build.build_info["log"].splitlines():
        if "registers" in line or "spill" in line:
            _say(f"  ptxas: {line.strip()}")


def check_extend(dev, rng, rows, B=18_143, G=52_000_000):
    """K1 at the flagship's dispatch shapes against its plain version."""
    import torch

    from seeksv_tpu_torch.ops import extend as ext
    genome = rng.integers(0, 4, G, dtype=np.uint8)
    genome[rng.integers(0, G, G // 10_000)] = 4
    refp = torch.from_numpy(
        (genome[0::2] | (genome[1::2] << 4)).astype(np.uint8)).to(dev)
    LQ, LT = 1024, 1536
    k = np.arange(LQ)[None, :]
    for reverse in (True, False):
        name = "extend_left" if reverse else "extend_right"
        qlen = rng.integers(0, LQ + 1, B).astype(np.int32)
        tlen = (qlen + 100).astype(np.int32)
        start = rng.integers(2 * LQ, G - 2 * LQ, B).astype(np.int32)
        edge = np.arange(16)
        start[:16] = edge if reverse else G - 1 - edge   # runs off the genome
        tlen[16:48] = 0                                  # anchor at a start
        h0 = rng.integers(19, 80, B).astype(np.int32)
        # genome windows in scan order with a small indel and 2 % subs;
        # every tenth query random (z-drops)
        cut = rng.integers(0, LQ, B)[:, None]
        shift = rng.integers(-5, 6, B)[:, None]
        off = k + np.where(k >= cut, shift, 0)
        idx = start[:, None] - off if reverse else start[:, None] + off
        q = genome[np.clip(idx, 0, G - 1)]
        sub = rng.random((B, LQ)) < 0.02
        q[sub] = rng.integers(0, 4, int(sub.sum()))
        q[::10] = rng.integers(0, 4, (len(q[::10]), LQ))
        q[k >= qlen[:, None]] = 4
        args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in
                (ext.pack_nibbles(q), qlen, start, tlen, h0)]
        got = ext.extend_batch_resident(*args, refp, G, LQ, LT, reverse)
        want = ext.extend_batch_resident_plain(*args, refp, G, LQ, LT,
                                               reverse)
        torch.cuda.synchronize()
        err = _max_abs_err([(got[x], want[x]) for x in ext.KEYS])
        ms = _cuda_ms(lambda: ext.extend_batch_resident(
            *args, refp, G, LQ, LT, reverse), 3)
        plain_ms = _cuda_ms(lambda: ext.extend_batch_resident_plain(
            *args, refp, G, LQ, LT, reverse), 1)
        cells = int((qlen.astype(np.int64) * tlen).sum())
        _say(f"{name}: B={B} LQ={LQ} LT={LT} max_abs_err={err} "
             f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms "
             f"({cells / ms / 1e6:.1f} Gcell/s upper bound)")
        if err:
            raise AssertionError(f"{name} disagrees with its plain version")
        rows[name] = {"route": "cuda",
                      "source": "seeksv_tpu_torch/csrc/extend.cu",
                      "replaces": "seeksv_tpu/ops/pallas_sw.py:35",
                      "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                      "ms_of": f"one launch, B={B} LQ={LQ} LT={LT}"}


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
    want = ext.extend_batch_plain(*args)
    torch.cuda.synchronize()
    err = _max_abs_err([(got[x], want[x]) for x in ext.KEYS])
    ms = _cuda_ms(lambda: ext.extend_batch(*args), 3)
    plain_ms = _cuda_ms(lambda: ext.extend_batch_plain(*args), 1)
    _say(f"extend_windows: B={B} ({int(empty.sum())} empty) LQ={LQ} "
         f"LT={LT} max_abs_err={err} kernel {ms:.3f} ms, plain "
         f"{plain_ms:.3f} ms")
    if err:
        raise AssertionError("extend_windows disagrees with its plain "
                             "version")
    rows["extend_windows"] = {
        "route": "cuda", "source": "seeksv_tpu_torch/csrc/extend.cu",
        "replaces": "seeksv_tpu/ops/pallas_sw.py:161",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "ms_of": f"one launch, B={B} LQ={LQ} LT={LT}"}


def check_seed_lookup(dev, index, clip_fq, rows, n_strand=1024):
    """K4 against its plain version on the first n_strand strand reads of
    the slice's clip fastq, against the flagship's table."""
    import torch

    from seeksv_tpu.align.index import ENCODE
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
    ms = _cuda_ms(lambda: sd.seed_lookup(*args), 3)
    plain_ms = _cuda_ms(lambda: sd.seed_lookup_plain(*args), 1)
    shape = (f"N={mat.shape[0]} LP={mat.shape[1]} "
             f"({lo.numel()} k-mers), {index.keys.dtype} keys")
    _say(f"seed_lookup: {len(reads)} strand reads, {shape}, "
         f"{int((cnt > 0).sum())} k-mers with hits, search_iters="
         f"{seeder.search_iters}, max_abs_err={err} kernel {ms:.3f} ms, "
         f"plain {plain_ms:.3f} ms")
    if err or not int((cnt > 0).sum()):
        raise AssertionError("seed_lookup disagrees with its plain version "
                             "or finds nothing")
    rows["seed_lookup"] = {
        "route": "cuda", "source": "seeksv_tpu_torch/csrc/seed_lookup.cu",
        "replaces": "seeksv_tpu/ops/seed_device.py:64",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "ms_of": f"one launch, {shape}"}


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


def check_finalize(dev, rng, rows, B=4096):
    """K2 at K = 128 / 256 on LQ 1024 and K3 on K2's output, against
    their plain versions; one chunk of 4,096 jobs (the finalize's
    chunk at 1 GiB of direction bytes and LQ 1024)."""
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
        score, dirs = gd.banded_direction(tq, tm, tt, td, tn, K)
        ws, wdirs = gd.banded_direction_plain(
            tq, tm, gd.build_t2(tt, tn, td, K, LQ), td, tn, K, LQ)
        torch.cuda.synchronize()
        rows_m = torch.arange(1, LQ + 1, device=dev)[None, :] <= tm[:, None]
        err = _max_abs_err([(score, ws), (dirs[rows_m], wdirs[rows_m])])
        del wdirs
        ms = _cuda_ms(lambda: gd.banded_direction(tq, tm, tt, td, tn, K), 3)
        plain_ms = _cuda_ms(lambda: gd.banded_direction_plain(
            tq, tm, gd.build_t2(tt, tn, td, K, LQ), td, tn, K, LQ), 1)
        _say(f"banded_dir K={K}: B={B} LQ={LQ} max_abs_err={err} "
             f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
        if err:
            raise AssertionError(f"banded_dir K={K} disagrees")
        a = agg["banded_dir"]
        a[0] = max(a[0], err)
        a[1].append({"K": K, "ms": ms, "plain_ms": plain_ms})
        got = gd.traceback_rle(dirs, tm, tn, td)
        want = gd.traceback_rle_plain(dirs, tm, tn, td)
        torch.cuda.synchronize()
        err = _max_abs_err(list(zip(got, want)))
        ms = _cuda_ms(lambda: gd.traceback_rle(dirs, tm, tn, td), 3)
        plain_ms = _cuda_ms(lambda: gd.traceback_rle_plain(dirs, tm, tn, td),
                            1)
        done = int((got[2] <= gd.RUNS_CAP).sum())
        _say(f"traceback K={K}: B={B} max_abs_err={err} kernel {ms:.3f} ms, "
             f"plain {plain_ms:.3f} ms ({done} walks within RUNS_CAP)")
        if err or not done:
            raise AssertionError(f"traceback K={K} disagrees or is vacuous")
        a = agg["traceback"]
        a[0] = max(a[0], err)
        a[1].append({"K": K, "ms": ms, "plain_ms": plain_ms})
        del dirs
    for name, src, rep in (
            ("banded_dir", "banded_dir.cu", "global_device.py:334"),
            ("traceback", "traceback.cu", "global_device.py:493")):
        err, rungs = agg[name]
        rows[name] = {"route": "cuda",
                      "source": f"seeksv_tpu_torch/csrc/{src}",
                      "replaces": f"seeksv_tpu/ops/{rep}",
                      "max_abs_err": err,
                      "ms": sum(r["ms"] for r in rungs),
                      "plain_ms": sum(r["plain_ms"] for r in rungs),
                      "ms_of": (f"sum of one launch per rung "
                                f"(K={'+'.join(str(r['K']) for r in rungs)})"
                                f", B={B} LQ={LQ}"),
                      "rungs": rungs}


def _keep_first_call(module, name, kept):
    """Wrap module.<name> so that its first call's arguments land in
    kept[name]; returns the undo."""
    fn = getattr(module, name)

    def wrapper(*args, **kwargs):
        kept.setdefault(name, (args, kwargs))
        return fn(*args, **kwargs)
    setattr(module, name, wrapper)
    return lambda: setattr(module, name, fn)


def check_consensus_scan(kept, rows):
    """K5 against its plain version on the SPMD run's first consensus
    call, with 64 groups of random reads appended (at least 16 each, so
    max_slots = 8 overflows)."""
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
    ms = _cuda_ms(lambda: cs.consensus_scan_groups(*args, max_slots=8), 3)
    plain_ms = _cuda_ms(lambda: cs.consensus_scan_plain(*args, max_slots=8),
                        1)
    n_over = int(want["overflow"].sum())
    shape = (f"the SPMD run's first call NG={NG} G={G} LL={LL} LR={LR} "
             f"(max_slots {kw.get('max_slots')}) + 64 random groups, "
             f"G {G2}, max_slots 8")
    _say(f"consensus_scan: {shape}: {n_over} groups overflow, "
         f"max_abs_err={err} kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    if err or n_over < 64:
        raise AssertionError("consensus_scan disagrees with its plain "
                             "version or the overflow groups did not")
    rows["consensus_scan"] = {
        "route": "cuda", "source": "seeksv_tpu_torch/csrc/consensus_scan.cu",
        "replaces": "seeksv_tpu/ops/consensus_scan.py:31",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "ms_of": f"one launch, {shape}"}


def check_discordant_count(kept, rows):
    """K6 against its plain version on the SPMD run's first discordant
    call (padding rows are empty windows)."""
    import torch

    from seeksv_tpu_torch.ops import discordant as dc
    args, kw = kept
    J = args[8].shape[0]
    empty = int((args[9] <= args[8]).sum())
    got = dc.discordant_count_batch(*args, **kw)
    want = dc.discordant_count_plain(*args, **kw)
    torch.cuda.synchronize()
    err = _max_abs_err([(got, want)])
    ms = _cuda_ms(lambda: dc.discordant_count_batch(*args, **kw), 3)
    plain_ms = _cuda_ms(lambda: dc.discordant_count_plain(*args, **kw), 1)
    shape = (f"the SPMD run's call J={J} ({empty} empty windows) over "
             f"R={args[0].shape[0]} records, window_cap={kw['window_cap']}")
    _say(f"discordant_count: {shape}: {int(want.sum())} pairs, "
         f"max_abs_err={err} kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    if err or not int(want.sum()):
        raise AssertionError("discordant_count disagrees with its plain "
                             "version or counts nothing")
    rows["discordant_count"] = {
        "route": "cuda", "source": "seeksv_tpu_torch/csrc/discordant_count.cu",
        "replaces": "seeksv_tpu/ops/jax_kernels.py:165",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "ms_of": f"one launch, {shape}"}


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
}


def _counters():
    """(the launch counters of every kernel, the hit_cap counters)."""
    from seeksv_tpu_torch.ops import consensus_scan as cs
    from seeksv_tpu_torch.ops import discordant as dc
    from seeksv_tpu_torch.ops import extend as ext
    from seeksv_tpu_torch.ops import global_device as gd
    from seeksv_tpu_torch.ops import seed_device as sd
    return (ext.LAUNCHES, gd.LAUNCHES, sd.LAUNCHES, cs.LAUNCHES,
            dc.LAUNCHES), sd.OVERFLOW


def _drive(name, fn):
    """Run fn with every counter at 0 just before; return its result and
    the launches it made; fail unless they are exactly EXPECTED[name]."""
    launch_counts, overflow_count = _counters()
    for c in (*launch_counts, overflow_count):
        for key in c:
            c[key] = 0
    res = fn()
    launches = {k: v for c in launch_counts for k, v in c.items()}
    overflow = dict(overflow_count)
    _say(f"slice {name}: launches {json.dumps(launches)} hit_cap "
         f"{json.dumps(overflow)}")
    want = EXPECTED[name]
    wrong = {k: v for k, v in launches.items() if (v > 0) != (k in want)}
    if wrong:
        raise AssertionError(f"slice {name}: expected launches of exactly "
                             f"{want}, got {launches}")
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
    finally:
        dist.destroy_process_group()


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
    index = TorchBatchAligner.from_fasta(paths["ref_fa"], cache=False,
                                         device=dev).idx
    _say(f"slice: k-mer index built in {time.perf_counter() - t0:.1f} s")
    out = os.path.join(workdir, "out")
    os.makedirs(out, exist_ok=True)
    ref, bam = paths["ref_fa"], paths["bam"]
    runs = {}
    launches = {}

    def drive(name, fn):
        runs[name], launches[name] = _drive(name, fn)

    drive("device", lambda: run_pipeline(
        ref, bam, os.path.join(out, "device"), device=dev, index=index))
    n_jobs = runs["device"]["aligner"].last_dispatch["n_jobs"]
    _say(f"slice: the default run dispatched {n_jobs} extension jobs per "
         f"direction (phase 2's K1 shape is the TPU record's 18,143)")
    check_seed_lookup(dev, index, os.path.join(out, "device.clip.fq.gz"),
                      rows)
    drive("device_seed", lambda: run_pipeline(
        ref, bam, os.path.join(out, "device_seed"), device=dev, index=index,
        device_seed=True))
    drive("device_align", lambda: run_pipeline(
        ref, bam, os.path.join(out, "device_align"), device=dev,
        index=index, device_align=True))
    drive("stream_device_align", lambda: run_pipeline_streaming(
        ref, bam, os.path.join(out, "stream_device_align"), device=dev,
        index=index, device_align=True, chunk_records=400_000))
    run_spmd(dev, ref, bam, out, index, rows, drive)
    runs["force_host"] = run_pipeline(ref, bam, os.path.join(out, "host"),
                                      device=dev, force_host=True,
                                      index=index)
    for name, res in runs.items():
        st = {k: round(v, 3) for k, v in res["stages_s"].items()}
        al = {k: round(v, 3) for k, v in res["aligner"].timings.items()}
        _say(f"slice {name} on {card}: stages_s {json.dumps(st)} "
             f"aligner_s {json.dumps(al)}")
    _say(f"slice: dispatch {json.dumps(runs['device']['aligner'].last_dispatch)}")
    host = {}
    for suffix in ("clip.sam", "sv"):
        with open(os.path.join(out, f"host.{suffix}"), "rb") as f:
            host[suffix] = f.read()
    with gzip.open(os.path.join(out, "host.clip.gz")) as f:
        host["clip.gz"] = f.read()
    for name in EXPECTED:
        for suffix in ("clip.sam", "sv", "clip.gz"):
            path = os.path.join(out, f"{name}.{suffix}")
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workdir", default=os.path.join(HERE, "build",
                                                      "chip_smoke"),
                    help="scratch for the dataset and outputs (removed "
                         "after a passing run)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch sees no CUDA device")
    sys.path.insert(0, HERE)
    import seeksv_tpu_torch  # noqa: F401  (absent: not run from the repo)
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"], capture_output=True, text=True,
        check=True).stdout.strip()
    t_all = time.perf_counter()
    provenance(card)
    rng = np.random.default_rng(1)
    rows = {}
    check_extend(dev, rng, rows)
    check_extend_windows(dev, rng, rows)
    check_finalize(dev, rng, rows)
    by_run = run_slice(dev, args.workdir, card, rows)
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
