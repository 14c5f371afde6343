"""Measure the device finalize's crossover and share on the flagship, on
the card, and whether the ladder's rung 16 pays on such data.

The reference set its finalize crossover (150 M banded cells) and share
(0.55 of the eligible jobs; 0.45 and 0.65 measured beside it) from runs
of its flagship on the TPU (seeksv_tpu/align/engine.py:827-871).  This
program measures the same on the card: it builds the flagship dataset
(``utils.dataset.build_dataset``, the configuration ``chip_smoke.py``
runs: 40 Mb host + 12 Mb virus panel, 25x, 1 kb reads, seed 1), runs the
default pipeline once on the card and keeps the arguments of its
finalize call, then times that finalize again:

  1. share: the device taking 0.45, 0.55, 0.65 and 1.0 of the eligible
     jobs (the rest on the native host ladder beside it; this program
     cuts the engine's plan to the share, as the reference's engine
     did, since the port's engine sends every eligible job), two turns
     each in the order 0.45 .. 1.0, 1.0 .. 0.45; wall seconds and the
     device thread's seconds;
  2. crossover: the finalize of the first N reads (N from 16 to all),
     on the host alone (force_host) against the device at the chosen
     share with no crossover, best of three; the crossover in the
     estimated banded cells of the eligible jobs (phase A's two rungs,
     min(m, n) x 384 a job) is log-interpolated where the device first
     wins;
  3. rung 16: in the share-1.0 run, each rung's direction pass (K2) and
     walk (K3) calls by CUDA events, the jobs at each rung, the walks
     rung 16 runs (its sound jobs and the equal-score rule's) and rung
     64's.  Recorded only: nothing of the ladder changes.

    python -m seeksv_tpu_torch.scripts.calibrate_finalize \\
        [--workdir build/calibrate_finalize] [--out PATH]

Writes a JSON record (default: finalize_calibration.json in the
workdir); the engine's MIN_DEVICE_FINALIZE_CELLS is set from it by hand
(and the engine sends every eligible job only while the best share is
1.0).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import torch

from ..align.engine import BatchAligner
from ..ops import global_device as gd
from ..pipeline.driver import run_pipeline
from ..utils.dataset import build_dataset
from ._card import card

SHARES = (0.45, 0.55, 0.65, 1.0)
SHARE = {"share": 1.0}   # the device's share while measuring
ENV_CROSS = "SEEKSV_TPU_TORCH_FINALIZE_CROSSOVER_CELLS"


def _say(*a):
    print(*a, file=sys.stderr, flush=True)


class _Rungs:
    """K2 and K3 calls by CUDA events, per band width K, while active."""

    def __init__(self):
        self.active = False
        self.stats = {}
        self._dir, self._tb = gd.banded_direction, gd.traceback_rle

    def __enter__(self):
        def timed(fn, kind):
            def run(*a, **kw):
                if not self.active:
                    return fn(*a, **kw)
                s = torch.cuda.Event(enable_timing=True)
                e = torch.cuda.Event(enable_timing=True)
                s.record()
                out = fn(*a, **kw)
                e.record()
                torch.cuda.synchronize()
                if kind == "dir":
                    K, jobs = a[5] if len(a) > 5 else kw["K"], a[0].shape[0]
                else:
                    K = a[0].shape[2]
                    jobs = int((a[1] > 0).sum())   # walks: m > 0
                st = self.stats.setdefault(f"K{K}", {
                    "dir_calls": 0, "dir_jobs": 0, "dir_ms": 0.0,
                    "walk_calls": 0, "walks": 0, "walk_ms": 0.0})
                if kind == "dir":
                    st["dir_calls"] += 1
                    st["dir_jobs"] += jobs
                    st["dir_ms"] += s.elapsed_time(e)
                else:
                    st["walk_calls"] += 1
                    st["walks"] += jobs
                    st["walk_ms"] += s.elapsed_time(e)
                return out
            return run
        gd.banded_direction = timed(self._dir, "dir")
        gd.traceback_rle = timed(self._tb, "walk")
        return self

    def __exit__(self, *exc):
        gd.banded_direction, gd.traceback_rle = self._dir, self._tb


def _cut_to_share(plan):
    """BatchAligner._device_finalize_plan with its rows cut to SHARE's
    share of them (at least one), as the reference's engine cut them."""
    def cut(self, qs, ts, force_device):
        dga, rows = plan(self, qs, ts, force_device)
        if rows:
            rows = rows[:max(1, int(len(rows) * SHARE["share"]))]
        return dga, rows
    return cut


def _finalize(aligner, args, force_host=False):
    """One finalize of the kept call: (wall s, device thread s)."""
    d0 = aligner.timings["device_finalize_s"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    aligner._finalize_many(*args, force_host=force_host)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0,
            aligner.timings["device_finalize_s"] - d0)


def _subset(args, n):
    per_read_codes, seqs, results_by_read = args
    return (per_read_codes[:n], seqs[:n],
            {i: results_by_read[i] for i in range(min(n, len(seqs)))})


def _est_cells(aligner, args):
    """The finalize plan's estimated banded cells of the eligible jobs."""
    seen = []
    plan = BatchAligner._device_finalize_plan

    def spy(self, qs, ts, force_device):
        dga = self._dga or gd.TorchDeviceGlobalAligner(self.device)
        seen.append(sum(min(len(q), len(t)) * 384 for q, t in zip(qs, ts)
                        if dga.eligible(len(q), len(t))))
        return None, []
    BatchAligner._device_finalize_plan = spy
    try:
        aligner._finalize_many(*args, force_host=False)
    finally:
        BatchAligner._device_finalize_plan = plan
    return int(seen[0]) if seen else 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workdir", default=os.path.join("build",
                                                      "calibrate_finalize"))
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    info = card()
    dev = torch.device("cuda", torch.cuda.current_device())
    t0 = time.perf_counter()
    paths = build_dataset(os.path.join(a.workdir, "flagship"), 40_000_000,
                          25, 1000, 1, 30, False, virus_kb=12_000,
                          virus_events=6_000, virus_div=0.04, log=_say)
    _say(f"dataset {time.perf_counter() - t0:.1f} s")
    kept = []
    orig = BatchAligner._finalize_many

    def keep(self, *args, **kw):
        if not kept:
            kept.append(args)
        return orig(self, *args, **kw)
    os.environ[ENV_CROSS] = "0"
    BatchAligner._finalize_many = keep
    try:
        res = run_pipeline(paths["ref_fa"], paths["bam"],
                           os.path.join(a.workdir, "run"), device=dev)
    finally:
        BatchAligner._finalize_many = orig
    aligner, args = res["aligner"], kept[0]
    n_reads = len(args[1])
    est_all = _est_cells(aligner, args)
    stages = {k: round(v, 3) for k, v in res["stages_s"].items()}
    _say(f"run {json.dumps(stages)}; finalize of {n_reads} reads, "
         f"{est_all} estimated cells")

    # 1. the share, in turns
    BatchAligner._device_finalize_plan = _cut_to_share(
        BatchAligner._device_finalize_plan)
    share_rows = {s: [] for s in SHARES}
    rungs = _Rungs()
    with rungs:
        for order in (SHARES, tuple(reversed(SHARES))):
            for s in order:
                SHARE["share"] = s
                rungs.active = s == 1.0 and not share_rows[s]
                share_rows[s].append(_finalize(aligner, args))
                rungs.active = False
    host_s = min(_finalize(aligner, args, force_host=True)[0]
                 for _ in range(2))
    shares = [{"share": s, "wall_s": [round(w, 4) for w, _d in r],
               "device_thread_s": [round(d, 4) for _w, d in r],
               "mean_wall_s": round(sum(w for w, _d in r) / len(r), 4)}
              for s, r in share_rows.items()]
    best = min(shares, key=lambda r: r["mean_wall_s"])
    for r in shares:
        _say(json.dumps(r))
    _say(f"host alone {host_s:.4f} s; best share {best['share']}")

    # 2. the crossover at the chosen share
    SHARE["share"] = best["share"]
    rows, crossover = [], None
    sizes = [n for n in (16, 64, 256, 1024, 4096, 16384) if n < n_reads]
    for n in sizes + [n_reads]:
        sub = _subset(args, n)
        est = _est_cells(aligner, sub)
        th = min(_finalize(aligner, sub, force_host=True)[0]
                 for _ in range(3))
        td = min(_finalize(aligner, sub)[0] for _ in range(3))
        rows.append({"reads": n, "est_cells": est, "host_s": round(th, 5),
                     "device_s": round(td, 5)})
        _say(json.dumps(rows[-1]))
        if td < th and crossover is None and est > 0:
            prev = next((r for r in reversed(rows[:-1]) if r["est_cells"]),
                        None)
            if prev is None:
                crossover = est
            else:
                r0 = prev["device_s"] / prev["host_s"]
                r1 = td / th
                f = (math.log(r0) / (math.log(r0) - math.log(r1))
                     if r0 != r1 else 0.5)
                crossover = int(prev["est_cells"]
                                * (est / prev["est_cells"]) ** f)
    if crossover is None:
        crossover = rows[-1]["est_cells"] * 4
    out = {"card": info["nvidia_smi"], "device": info["device"],
           "torch": info["torch"], "cuda": info["cuda"],
           "host_threads": info["host_threads"],
           "dataset": "flagship: 40 Mb host + 12 Mb virus, 25x, 1 kb reads, "
                      "seed 1 (chip_smoke.py)",
           "finalize_reads": n_reads, "est_cells": est_all,
           "host_alone_s": round(host_s, 4), "shares": shares,
           "best_share": best["share"], "crossover_rows": rows,
           "finalize_crossover_cells": crossover,
           "rungs_at_share_1": rungs.stats}
    path = a.out or os.path.join(a.workdir, "finalize_calibration.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(json.dumps({"best_share": best["share"],
                      "finalize_crossover_cells": crossover,
                      "rungs": rungs.stats, "out": path}))


if __name__ == "__main__":
    main()
