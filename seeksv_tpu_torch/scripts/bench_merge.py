"""Micro-benchmark: the partitioned MergeJunction replays more than one
partition at a time.

Counterpart of scripts/bench_merge.py.  Builds a synthetic junction
table of many independent partitions, then runs the sequential
``pipeline/getsv.merge_junction`` and
``parallel/spmd_pipeline.merge_junction_sharded`` at one worker and at
``--workers``, with each partition's replay instrumented to record its
(thread, start, end) window.  Prints one JSON line: the wall clocks, the
partition count and the most partitions whose replay windows overlap in
time.  Both sharded results must equal the sequential one item for item,
else the run raises.  Host code only: no device is used.

    python -m seeksv_tpu_torch.scripts.bench_merge [--junctions 40000]
        [--per-cluster 8] [--workers 4]
"""
from __future__ import annotations

import argparse
import copy
import json
import threading
import time

import numpy as np

from ..parallel import spmd_pipeline as sp
from ..pipeline.getsv import merge_junction
from ..pipeline.junctions import JunctionMap, OtherInfo, SeqInfo


def build_jmap(rng, n_clusters, per_cluster):
    """n_clusters clusters of per_cluster junctions sharing a sequence
    with shifted breakends; clusters 500 bp apart (past the merge's
    search length, so each is a partition of its own)."""
    jmap = JunctionMap()
    base = 1000
    for c in range(n_clusters):
        up0 = base + c * 500
        dn0 = up0 + 3000
        seq = rng.integers(65, 69, 120).astype(np.uint8).tobytes()
        for _r in range(per_cluster):
            mh = int(rng.integers(0, 30))
            u = seq[mh:60 + mh]
            d = seq[60 + mh:110 + mh]
            up = SeqInfo(u, [(len(u), "M")], 0, 0,
                         int(rng.integers(1, 6)), int(rng.integers(0, 3)))
            down = SeqInfo(d, [(len(d), "M")], 0, 0,
                           int(rng.integers(1, 6)), int(rng.integers(0, 3)))
            jmap.insert(("chr1", up0 + mh, "+", "chr1", dn0 + mh, "+"),
                        OtherInfo(up, down, -1, 0))
    return jmap


def max_overlap(windows) -> int:
    """The most (thread, start, end) windows open at one time."""
    events = sorted([(s, 1) for _t, s, _e in windows]
                    + [(e, -1) for _t, _s, e in windows])
    cur = peak = 0
    for _x, d in events:
        cur += d
        peak = max(peak, cur)
    return peak


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--junctions", type=int, default=40000)
    ap.add_argument("--per-cluster", type=int, default=8)
    ap.add_argument("--workers", type=int, default=4)
    args = ap.parse_args(argv)

    rng = np.random.default_rng(0)
    n_clusters = max(1, args.junctions // args.per_cluster)
    jmap = build_jmap(rng, n_clusters, args.per_cluster)

    seq_ref = copy.deepcopy(jmap)
    t0 = time.perf_counter()
    merge_junction(seq_ref, 50)
    t_seq = time.perf_counter() - t0

    j1 = copy.deepcopy(jmap)
    t0 = time.perf_counter()
    sp.merge_junction_sharded(j1, 50, max_workers=1)
    t_w1 = time.perf_counter() - t0

    # the replay instrumented to observe its concurrency
    windows = []
    lock = threading.Lock()
    orig = sp._merge_partition_gated

    def instrumented(items, lo, hi, search_length, gates):
        s = time.perf_counter()
        out = orig(items, lo, hi, search_length, gates)
        e = time.perf_counter()
        with lock:
            windows.append((threading.get_ident(), s, e))
        return out

    sp._merge_partition_gated = instrumented
    try:
        jn = copy.deepcopy(jmap)
        t0 = time.perf_counter()
        nparts = sp.merge_junction_sharded(jn, 50, max_workers=args.workers)
        t_wn = time.perf_counter() - t0
    finally:
        sp._merge_partition_gated = orig

    for got in (j1, jn):
        if len(got.items) != len(seq_ref.items) or any(
                ja != jb or oa != ob for (ja, oa), (jb, ob)
                in zip(seq_ref.items, got.items)):
            raise AssertionError("the sharded merge differs from the "
                                 "sequential merge_junction")

    print(json.dumps({
        "metric": "merge_junction_partition_concurrency",
        "n_junctions": args.junctions, "n_partitions": nparts,
        "sequential_s": round(t_seq, 3),
        "sharded_1worker_s": round(t_w1, 3),
        f"sharded_{args.workers}worker_s": round(t_wn, 3),
        "max_concurrent_partitions": max_overlap(windows),
        "replay_threads_used": len({t for t, _s, _e in windows}),
        "exact": True,
    }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
