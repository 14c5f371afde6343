"""Peak memory of the windowed getsv-phase junction build: with
``window_groups`` 4096 the live set of decoded clip groups in
``parallel/spmd_pipeline.spmd_build_junctions`` is one window, so the
phase's peak memory follows the window, not the clip table.

Counterpart of scripts/bench_junction_window.py.  getclip and the
realignment (on ``--device``) of a clip-dense dataset (``bench_scale``'s,
100 bp reads) write the clip table; then the junction build runs on a
one-rank mesh (``--device``'s: gloo on the CPU, NCCL on the card) in a
fresh subprocess per configuration, windowed (4096 groups) and unbounded,
each reporting its junction count, its seconds and its ``VmHWM`` (not
``ru_maxrss``, which a child inherits from its parent).  The two
junction counts must be equal, else the run raises.  Prints one JSON
row and appends it to ``--out``.

    python -m seeksv_tpu_torch.scripts.bench_junction_window
        [--genome-mb 20] [--coverage 30] [--events 4000] [--seed 1]
        [--device cuda] [--out PATH]
"""
from __future__ import annotations

import argparse
import gzip
import json
import os
import subprocess
import sys
import tempfile
import time

from ..align.engine import BatchAligner
from ..pipeline.driver import realign_clips
from ..pipeline.getclip import getclip
from ..utils.dataset import build_dataset
from ._card import provenance, require
from .bench_scale import cache_root, dataset_key

WINDOW = 4096
UNBOUNDED = 1 << 30


def child_env(**extra) -> dict:
    """This process's environment with the repo root on PYTHONPATH, for a
    child that imports the port."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, **extra)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p)
    return env


def vm_hwm_mb() -> float:
    """This process's peak resident set (VmHWM), MB: per address space,
    reset at exec."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmHWM:"):
                return int(line.split()[1]) / 1024
    return 0.0


def child(argv) -> None:
    """One configuration: ``CLIP_GZ CLIP_SAM WINDOW DEVICE``; prints
    ``window, junctions, seconds, VmHWM MB`` tab-separated."""
    import torch.distributed as dist

    from ..parallel.mesh import make_mesh
    from ..parallel.spmd_pipeline import spmd_build_junctions
    clip_gz, clip_sam, window, device = argv
    mesh = make_mesh(device)
    try:
        print(f"rss after imports: {vm_hwm_mb():.1f}", file=sys.stderr)
        t0 = time.perf_counter()
        jmap, _rescue = spmd_build_junctions(mesh, clip_gz, clip_sam, 0,
                                             False,
                                             window_groups=int(window))
        dt = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    print(f"{window}\t{len(jmap.items)}\t{dt:.3f}\t{vm_hwm_mb():.1f}")


def _run_child(clip_gz, clip_sam, window, device):
    r = subprocess.run(
        [sys.executable, "-c",
         "import sys; from seeksv_tpu_torch.scripts.bench_junction_window "
         "import child; child(sys.argv[1:])",
         clip_gz, clip_sam, str(window), device],
        capture_output=True, text=True, env=child_env(), timeout=3600)
    print(r.stderr[-2000:], file=sys.stderr)
    if r.returncode:
        raise RuntimeError(f"junction build (window {window}) exited "
                           f"{r.returncode}")
    w, nj, dt, rss = r.stdout.strip().split("\n")[-1].split("\t")
    return dict(n_junctions=int(nj), phase_s=float(dt),
                peak_rss_mb=float(rss))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--genome-mb", type=float, default=20)
    ap.add_argument("--coverage", type=int, default=30)
    ap.add_argument("--events", type=int, default=4000)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the realignment and of the "
                         "one-rank mesh (cuda, or cpu)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = require(args.device)
    G = int(args.genome_mb * 1e6)
    root = cache_root(dataset_key(G, args.coverage, 100, args.seed,
                                  args.events))
    paths = build_dataset(root, G, args.coverage, 100, args.seed,
                          args.events, False)
    with tempfile.TemporaryDirectory() as d:
        prefix = os.path.join(d, "x")
        getclip(paths["bam"], prefix)
        realign_clips(paths["ref_fa"], f"{prefix}.clip.fq.gz",
                      f"{prefix}.clip.sam",
                      aligner=BatchAligner.from_fasta(paths["ref_fa"],
                                                      device=dev))
        with gzip.open(f"{prefix}.clip.gz") as f:
            n_lines = sum(1 for _ in f)
        rows = {w: _run_child(f"{prefix}.clip.gz", f"{prefix}.clip.sam", w,
                              str(dev)) for w in (WINDOW, UNBOUNDED)}
    windowed, unbounded = rows[WINDOW], rows[UNBOUNDED]
    if windowed["n_junctions"] != unbounded["n_junctions"]:
        raise AssertionError(f"the windowed junction build differs: {rows}")
    row = {
        "metric": "junction_window_rss",
        "genome_mb": args.genome_mb, "coverage": args.coverage,
        "events": args.events, "clip_lines": n_lines,
        "window_groups": WINDOW,
        "windowed_peak_rss_mb": windowed["peak_rss_mb"],
        "unbounded_peak_rss_mb": unbounded["peak_rss_mb"],
        "rss_saved_mb": round(unbounded["peak_rss_mb"]
                              - windowed["peak_rss_mb"], 1),
        "windowed_phase_s": windowed["phase_s"],
        "unbounded_phase_s": unbounded["phase_s"],
        "n_junctions": windowed["n_junctions"],
        **provenance(dev),
        "note": "getsv-phase junction build, one-rank mesh subprocesses; "
                "the windowed live set is one 4096-group window "
                "(spmd_build_junctions), the unbounded arm holds the "
                "whole clip table",
    }
    line = json.dumps(row)
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
