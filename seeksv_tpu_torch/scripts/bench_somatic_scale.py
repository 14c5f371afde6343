"""Tumour / normal somatic runs of the port at scale, with the somatic
output held to the port's host somatic path byte for byte.

Counterpart of scripts/bench_somatic_scale.py without its
reference-binary flow (``seeksv getclip / getsv / somatic`` + ``bwa
mem``), which needs the reference's binaries.  One genome; the tumour
donor carries germline and somatic deletions, the normal donor the
germline ones only (``utils/dataset.build_somatic_dataset``, cached under
``~/.cache/seeksv_tpu_torch/<key>``), so the somatic subtraction must
keep the somatic calls and drop the germline ones.

    ours: run_pipeline_streaming(ref, tumor, prefix, normal_bam=normal,
          device=--device): one streamed decode per BAM, realignment on
          the card, somatic + the reference's awk filter

Best of ``--trials``.  The cross-check feeds the run's own tumour ``.sv``
through ``pipeline/somatic.somatic`` on the whole normal BAM and
``somatic_filter`` (the host path tests/test_torch_host_parity.py holds
to the reference's bytes) and compares with the run's ``.somatic.sv``:
``somatic_parity`` is ``exact`` or the exit code is 1.  Somatic recall
and the germline deletions that leak into ``.somatic.sv`` are counted
against ``truth.json`` (±50 bp on both breakends).  Prints one JSON row.

    python -m seeksv_tpu_torch.scripts.bench_somatic_scale
        [--genome-mb 100] [--coverage 30] [--read-len 100] [--seed 2]
        [--events 2000] [--trials 3] [--device cuda] [--out PATH]
"""
from __future__ import annotations

import argparse
import json
import os
import resource
import sys
import tempfile
import time

import numpy as np
import torch

from ..align.engine import BatchAligner
from ..pipeline.somatic import somatic, somatic_filter
from ..pipeline.stream import run_pipeline_streaming
from ..utils.dataset import build_somatic_dataset
from ._card import provenance, require, warm
from .bench_scale import cache_root


def _calls(path):
    out = []
    with open(path) as f:
        for line in f:
            if not line.startswith("@"):
                fl = line.split("\t")
                out.append((int(fl[1]), int(fl[5])))
    return out


def _found(calls, up, down):
    return any(abs(cu - up) <= 50 and abs(cv - down) <= 50
               for cu, cv in calls)


def run_trials(paths, prefix, trials, dev, chunk_records=2_000_000):
    """Best of ``trials`` streaming tumour / normal runs into ``prefix``:
    (best total seconds, every trial's total, the best run's stages,
    its aligner's timings and last dispatch)."""
    totals, best = [], None
    for _ in range(max(1, trials)):
        res = run_pipeline_streaming(paths["ref_fa"], paths["tumor"], prefix,
                                     normal_bam=paths["normal"], device=dev,
                                     chunk_records=chunk_records)
        st = res["stages_s"]
        totals.append(round(st["total"], 3))
        if best is None or st["total"] < best[0]["total"]:
            al = res["aligner"]
            best = (st, dict(al.timings), getattr(al, "last_dispatch", None))
    return min(totals), totals, best


def check(paths, prefix):
    """The cross-check and the truth counts of a run written at
    ``prefix``: somatic_parity, the rows, recall, germline_leaked."""
    t = time.perf_counter()
    somatic(paths["normal"], f"{prefix}.normal.clip.gz", f"{prefix}.sv",
            f"{prefix}.host_somatic.temp.sv")
    somatic_filter(f"{prefix}.host_somatic.temp.sv",
                   f"{prefix}.host_somatic.sv")
    cross_s = time.perf_counter() - t
    with open(f"{prefix}.somatic.sv", "rb") as a, \
            open(f"{prefix}.host_somatic.sv", "rb") as b:
        parity = "exact" if a.read() == b.read() else "MISMATCH"
    with open(paths["truth"]) as f:
        truth = json.load(f)
    calls = _calls(f"{prefix}.somatic.sv")
    hit = sum(1 for up, down in truth["somatic"] if _found(calls, up, down))
    # a germline deletion (s, e) has the breakends (s, e + 1), as
    # utils/simulate.build_donor writes them
    leaked = sum(1 for s, e in truth["germline"] if _found(calls, s, e + 1))
    return {"somatic_parity": parity, "cross_check_s": round(cross_s, 3),
            "somatic_calls_ours": len(calls),
            "tumor_sv_rows": len(_calls(f"{prefix}.sv")),
            "events_germline": len(truth["germline"]),
            "events_somatic": len(truth["somatic"]),
            "somatic_truth_recall_ours": round(
                hit / max(len(truth["somatic"]), 1), 4),
            "germline_leaked": leaked}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--genome-mb", type=float, default=100)
    ap.add_argument("--coverage", type=int, default=30)
    ap.add_argument("--read-len", type=int, default=100)
    ap.add_argument("--seed", type=int, default=2)
    ap.add_argument("--events", type=int, default=2000)
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the kernels (cuda, or cpu for "
                         "their plain versions)")
    ap.add_argument("--out", default=None,
                    help="append the JSON row to this file")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = require(args.device)
    G = int(args.genome_mb * 1e6)
    key = (f"somatic-G{G}-c{args.coverage}-l{args.read_len}-s{args.seed}"
           f"-e{args.events}")
    root = cache_root(key)
    log = lambda *a: print(*a, file=sys.stderr, flush=True)  # noqa: E731
    t0 = time.perf_counter()
    paths = build_somatic_dataset(root, G, args.coverage, args.read_len,
                                  args.seed, args.events, log=log)
    setup = {"dataset": round(time.perf_counter() - t0, 3)}
    warm(dev, setup)
    # the k-mer index cached before the timed trials (the JAX script's
    # counterpart is its bwa index)
    t0 = time.perf_counter()
    BatchAligner.from_fasta(paths["ref_fa"], device=dev)
    setup["index"] = round(time.perf_counter() - t0, 3)
    log(f"# dataset {setup['dataset']}s, index {setup['index']}s "
        f"(cached under {root})")
    peak_cuda = None
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    with tempfile.TemporaryDirectory() as d:
        prefix = os.path.join(d, "ours")
        best_s, totals, (stages, timings, dispatch) = run_trials(
            paths, prefix, args.trials, dev)
        if dev.type == "cuda":
            peak_cuda = round(torch.cuda.max_memory_allocated(dev) / 2 ** 20,
                              1)
        res = check(paths, prefix)
    row = {
        "metric": "somatic_scale_run",
        "genome_mb": args.genome_mb, "coverage": args.coverage,
        "read_len": args.read_len, "seed": args.seed,
        "ours_total_s": round(best_s, 3),
        "trials": max(1, args.trials),
        "ours_totals_s": totals,
        "ours_stddev_s": round(float(np.std(totals)), 3),
        "ours_stages_s": {k: round(v, 3) for k, v in stages.items()},
        "aligner_stages_s": {k: round(v, 3) for k, v in timings.items()},
        "dispatch": dispatch,
        **res,
        "peak_rss_mb": round(resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss / 1024, 1),
        "peak_cuda_mb": peak_cuda,
        **provenance(dev),
        "setup_s": setup,
    }
    line = json.dumps(row)
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0 if res["somatic_parity"] == "exact" else 1


if __name__ == "__main__":
    sys.exit(main())
