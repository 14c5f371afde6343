"""getsv's pair evidence of one pass of a cell, checked on the card
against the plain reference (``sbench/plain_pair_evidence.py``):

    python3 benchmark/check_pair_evidence.py --workload <cell> --seed <n> \
        [--out checks.jsonl]

Takes the cell's dataset for the seed as ``run.py`` does (kept from a
run of the same seed, else built), runs one pass of the program
(``pipeline.stream.run_pipeline_streaming`` with the cell's slabs, on
the card) with getsv's filtered rows and its log kept and a profiler
on, so that the program's counters record.  Then the plain reference
decodes the BAM into columns and recomputes, with masks on the card:
the insert size, the discordant-pair count of every row of the
``.sv`` and of the filtered rows (but the rows within one contig that
may take the reference's tandem-repeat loop), and the records every
row's window covers (their sum against the
program's counter ``getsv.window_records``, where the program has it).
Every mismatch is printed.  Beside them: the judge's numbers of the
pass and the virus junctions' recall alone.

Prints one JSON line; exits 1 on a mismatch, 3 without a CUDA card.
"""
from __future__ import annotations

import argparse
import io
import json
import os
import re
import shutil
import sys
import tempfile
import time
from collections import Counter

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _pass(cell: dict, data: dict, prefix: str) -> dict:
    """One pass of the program with its filtered rows, log and
    counters."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from seeksv_tpu_torch.pipeline import stream
    from seeksv_tpu_torch.utils import trace
    logged, filtered = [], io.StringIO()
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU]):
        stream.run_pipeline_streaming(
            data["ref_fa"], data["bams"][0], prefix, device="cuda",
            chunk_records=cell["traffic"]["chunk_records"],
            filtered_out=filtered, log=logged.append)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    rec = trace.last()
    ins = [re.match(r"Mean insert size: (-?\d+); deviation: (-?\d+)", s)
           for s in logged if s.startswith("Mean insert size")]
    return {"seconds": seconds,
            "insert": [int(ins[0].group(1)), int(ins[0].group(2))]
            if ins else None,
            "counts": dict(rec.counts) if rec is not None else {},
            "filtered": filtered.getvalue().splitlines()}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--out")
    a = ap.parse_args()
    sys.path.insert(0, HERE)
    sys.path.insert(1, REPO)
    import torch

    from sbench import harness, judge, loader
    from sbench import plain_pair_evidence as plain
    if not torch.cuda.is_available():
        log("no CUDA card")
        return 3
    cell = loader.Spec(REPO).cell(a.workload)
    if cell["traffic"]["driver"] != "stream" or cell["traffic"]["sample"] \
            != "single":
        log("the check runs a single-sample streamed cell")
        return 2
    data = harness.ensure_data(HERE, cell, a.seed, log)
    work = os.path.join(tempfile.gettempdir(), "seeksv_check", a.workload)
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    prefix = os.path.join(work, "s")
    home = os.environ.get("HOME")
    os.environ["HOME"] = data["home"]
    try:
        run = _pass(cell, data, prefix)
    finally:
        if home is None:
            os.environ.pop("HOME", None)
        else:
            os.environ["HOME"] = home
    log(f"# pass {run['seconds']:.3f} s, insert size {run['insert']}")

    t = time.perf_counter()
    cols = plain.to_device(plain.bam_columns(data["bams"][0]), "cuda")
    decode_s = time.perf_counter() - t
    mean, dev = plain.insert_size(cols)
    with open(f"{prefix}.sv") as f:
        sv = plain.sv_junctions(f)
    filt = plain.sv_junctions(run["filtered"], filtered=True)
    reasons = [ln.split("\t", 1)[0] for ln in run["filtered"] if ln.strip()]
    rows = sv + filt
    t = time.perf_counter()
    cov, cnt = plain.pair_evidence(cols, rows, mean, dev)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t

    bad = []
    if run["insert"] != [mean, dev]:
        bad.append({"what": "insert_size", "program": run["insert"],
                    "plain": [mean, dev]})
    cross = [i for i, r in enumerate(rows) if r[0] != r[3]]
    counted = [i for i in range(len(rows)) if int(cnt[i]) >= 0]
    for i in counted:
        if rows[i][6] != int(cnt[i]):
            bad.append({"what": "abnormal", "row": list(rows[i][:6]),
                        "in": "sv" if i < len(sv) else "filtered",
                        "program": rows[i][6], "plain": int(cnt[i])})
    counter = run["counts"].get("getsv.window_records")
    if counter is not None and counter != int(cov.sum()):
        bad.append({"what": "window_records", "program": counter,
                    "plain": int(cov.sum())})
    for b in bad:
        log("MISMATCH " + json.dumps(b))

    with open(data["truth"]) as f:
        truth = json.load(f)
    sv_lines = judge.sv_rows(f"{prefix}.sv")
    clips = judge.clip_rows(f"{prefix}.clip.gz")
    got = judge.judge_outputs(prefix, data["truth"], False, clips)
    vint = [x for x in truth if x["type"] == "VINT"]
    tid = cols["tid"]
    names = cols["ref_names"]
    line = {
        "workload": a.workload, "seed": a.seed,
        "card": torch.cuda.get_device_name(0),
        "mismatches": len(bad), "insert_size": [mean, dev],
        "rows": {"sv": len(sv), "filtered": len(filt),
                 "counted": len(counted), "cross_contig": len(cross),
                 "cross_contig_sv": sum(1 for i in cross if i < len(sv)),
                 "abnormal_nonzero": sum(1 for i in counted
                                         if int(cnt[i]) > 0),
                 "cross_contig_abnormal_nonzero": sum(
                     1 for i in cross if int(cnt[i]) > 0)},
        "window_records": {"program": counter, "plain": int(cov.sum())},
        "records": {n: int((tid == k).sum()) for k, n in enumerate(names)}
        | {"unplaced": int((tid < 0).sum())},
        "judge": got, "vint_recall": judge.sv_recall(vint, sv_lines),
        "filtered_reasons": dict(Counter(reasons)),
        "seconds": {"pass": run["seconds"], "plain_decode": decode_s,
                    "plain_masks": plain_s}}
    print(json.dumps(line), flush=True)
    if a.out:
        with open(a.out, "a") as f:
            f.write(json.dumps(line) + "\n")
    shutil.rmtree(work, ignore_errors=True)
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
