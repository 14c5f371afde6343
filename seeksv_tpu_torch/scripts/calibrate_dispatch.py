"""Measure the host-vs-card crossover of the batched extension and write
it as the port's dispatch calibration.

Counterpart of scripts/calibrate_dispatch.py, on the card: for each
batch size (64 .. 65,536 jobs at LQ 128 / LT 256, the engine's dominant
bucket for short clip fragments) it times the native C++ kernel on this
host against the engine's single-card path (nibble-packed queries
uploaded, targets gathered from the genome resident on the card by K1,
results downloaded: ``BatchAligner._device_round``), best of three each,
on identical random jobs whose queries match their genome window up to a
random break (so the host kernel z-drops as real clip fragments do).
The crossover in actual DP cells is log-interpolated where the card
first wins (``crossover_cells``): 0 when the card wins at the smallest
size measured, since nothing measured shows the host faster there.  The
fingerprint (the card's name, platform ``cuda``, the
host's threads, the measured upload rate) lets
``BatchAligner.calibration_stale`` spot another card.

    python -m seeksv_tpu_torch.scripts.calibrate_dispatch [--out PATH]

Default output: seeksv_tpu_torch/align/dispatch_calibration.json.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import numpy as np
import torch

from ..align.engine import BatchAligner
from ..io import native
from ..ops.extend import extend_batch_resident, pack_nibbles
from ._card import card

LQ, LT = 128, 256
BATCHES = [64, 256, 1024, 4096, 16384, 65536]
# synthetic genome kept on the card for the resident target gather
GENOME_MB = 64
OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "align", "dispatch_calibration.json")


def make_batch(rng, B, genome):
    """B jobs: qlen uniform in LQ/4 .. LQ, tlen qlen + 100 (at most LT),
    targets genome windows, queries matching them (95 %) up to a random
    break, then random."""
    G = len(genome)
    ql = rng.integers(LQ // 4, LQ + 1, B).astype(np.int32)
    tl = np.minimum(ql + 100, LT).astype(np.int32)
    start = rng.integers(0, G - LT - 1, B).astype(np.int32)
    t = np.full((B, LT), 4, np.int8)
    q = np.full((B, LQ), 4, np.int8)
    brk = (ql * rng.uniform(0.3, 1.0, B)).astype(np.int32)
    for b in range(B):
        w = genome[start[b]:start[b] + tl[b]]
        t[b, :tl[b]] = w
        n = int(brk[b])
        qc = rng.integers(0, 4, ql[b]).astype(np.int8)
        m = rng.random(n) < 0.95
        qc[:n][m] = w[:n][m]
        q[b, :ql[b]] = qc
    h0 = np.full(B, 19, np.int32)
    return q, ql, t, tl, h0, start


def batch_cells(batch):
    _q, ql, _t, tl, _h0, _start = batch
    return int((ql.astype(np.int64) * tl).sum())


def time_host(batch, trials=3):
    q, ql, t, tl, h0, _start = batch
    best = None
    for _ in range(trials):
        t0 = time.perf_counter()
        native.sw_extend_batch_native(q, ql, t, tl, h0)
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return best


def time_device(batch, refp, n_codes, dev, trials=3):
    """From host numpy inputs to host numpy results, as the engine's
    resident round makes it (upload, K1, download)."""
    q, ql, t, tl, h0, start = batch
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def kern():
        res = extend_batch_resident(
            put(pack_nibbles(q.view(np.uint8))), put(ql), put(start),
            put(tl), put(h0), refp, n_codes, LQ, LT, False)
        return {k: v.cpu().numpy() for k, v in res.items()}
    kern()   # warm-up: the kernels' build and first launch
    best = None
    for _ in range(trials):
        t0 = time.perf_counter()
        kern()
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return best


def crossover_cells(rows) -> int:
    """The crossover in actual DP cells from rows of ascending size
    ({"cells", "host_s", "device_s"}): 0 when the card wins at the
    smallest size, log-interpolated between the last size the host won
    and the first the card won, four times the largest size when the card
    never wins."""
    for i, row in enumerate(rows):
        if row["device_s"] >= row["host_s"]:
            continue
        if i == 0:
            return 0
        prev = rows[i - 1]
        r0 = prev["device_s"] / prev["host_s"]
        r1 = row["device_s"] / row["host_s"]
        f = math.log(r0) / (math.log(r0) - math.log(r1)) if r0 != r1 else 0.5
        return int(prev["cells"] * (row["cells"] / prev["cells"]) ** f)
    return rows[-1]["cells"] * 4


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    info = card()
    if not native.available():
        raise SystemExit(f"the native host library did not load: "
                         f"{native.LOAD_ERROR}")
    dev = torch.device("cuda", torch.cuda.current_device())
    probe_mb_s = round(BatchAligner._upload_probe_mb_s(), 2)
    print(json.dumps({"upload_probe_mb_s": probe_mb_s}), file=sys.stderr)
    rng = np.random.default_rng(0)
    genome = rng.integers(0, 4, GENOME_MB << 20).astype(np.uint8)
    gp = genome if len(genome) % 2 == 0 else np.concatenate(
        [genome, np.full(1, 4, np.uint8)])
    refp = torch.from_numpy((gp[0::2] | (gp[1::2] << 4)).astype(
        np.uint8)).to(dev)
    torch.cuda.synchronize(dev)
    rows = []
    for B in BATCHES:
        batch = make_batch(rng, B, genome)
        cells = batch_cells(batch)
        th = time_host(batch)
        td = time_device(batch, refp, len(genome), dev)
        row = {"batch": B, "cells": cells, "host_s": round(th, 6),
               "device_s": round(td, 6),
               "host_gcells_s": round(cells / th / 1e9, 3),
               "device_gcells_s": round(cells / td / 1e9, 3)}
        rows.append(row)
        print(json.dumps(row), file=sys.stderr)
    crossover = crossover_cells(rows)
    out = {
        "kernel": "extend_batch_resident (K1)",
        "shape": {"LQ": LQ, "LT": LT},
        "platform": "cuda", "device": info["device"],
        "card": info["nvidia_smi"], "torch": info["torch"],
        "cuda": info["cuda"], "host_threads": info["host_threads"],
        "rows": rows,
        "crossover_cells": crossover,
        "fingerprint": {"device": info["device"], "platform": "cuda",
                        "host_threads": info["host_threads"],
                        "upload_probe_mb_s": probe_mb_s},
        "note": ("card path = nibble-packed query upload + K1 on the "
                 "resident genome + result download; host path = the "
                 "native kernel on host windows; best of 3 each, from host "
                 "numpy inputs to host results"),
    }
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(json.dumps({"crossover_cells": crossover,
                      "device": info["device"], "out": args.out}))


if __name__ == "__main__":
    main()
