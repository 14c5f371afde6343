"""Readings that limits are set from: the program's and the control's,
on many seeds of one cell, in one process on the card.

    python3 benchmark/proof.py --workload <cell> --seeds 11 12 13 ... \
        [--out readings.jsonl]

Per seed: the cell's dataset and the program's index of its fasta (the
next seed's dataset is built by a subprocess while this one runs), the
set-up and one whole pass of the timed path, then ``harness.check``
twice: the program's numbers that decide ``correct``, and the same
numbers with the control in the program's place (the plain aligner in
saturating arithmetic one integer type narrower than the
configuration's scores need), which has to come out not correct.  One
JSON line a seed.  The benchmark's runs never run this.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out")
    a = ap.parse_args()
    sys.path.insert(0, HERE)
    sys.path.insert(1, REPO)
    from sbench import harness, loader
    from sbench.datagen import data_key
    import torch
    if not torch.cuda.is_available():
        log("no CUDA card")
        return 3
    cell = loader.Spec(REPO).cell(a.workload)
    root = os.path.join(HERE, ".cache", "proof", a.workload)

    def start(seed):
        out = os.path.join(root, str(seed))
        key = data_key(cell["config"], cell["traffic"], seed)
        return out, time.perf_counter(), subprocess.Popen(
            [sys.executable, os.path.join(HERE, "sbench", "datagen.py"),
             "--key", json.dumps(key), "--out", out],
            stdout=subprocess.PIPE, text=True,
            env=dict(os.environ, OMP_NUM_THREADS="1"))

    nxt = start(a.seeds[0])
    for i, seed in enumerate(a.seeds):
        out, t0, proc = nxt
        build = json.loads(proc.communicate()[0].strip().splitlines()[-1])
        if proc.returncode:
            raise RuntimeError(f"the build of seed {seed} failed")
        waited = time.perf_counter() - t0
        data = harness.dataset(out, cell, build["n_records"])
        index_s = harness.prepare_reference(data)
        nxt = start(a.seeds[i + 1]) if i + 1 < len(a.seeds) else None
        work = os.path.join(tempfile.gettempdir(), "seeksv_proof", a.workload)
        ctx = harness.measure(cell, data, 0.0, False, "cuda", work, log)
        t = time.perf_counter()
        prog = harness.check(cell, data, ctx["prefix"], seed, "cuda",
                             log=log)
        ctrl = harness.check(cell, data, ctx["prefix"], seed, "cuda",
                             control=True, log=log)
        row = {"workload": a.workload, "seed": seed,
               "records": sum(build["n_records"]),
               "build_s": build["seconds"], "build_wait_s": waited,
               "index_s": index_s, "setup_s": ctx["setup_s"],
               "pass_s": ctx["passes"][0]["seconds"],
               "stages_s": ctx["passes"][0]["stages_s"],
               "check_s": time.perf_counter() - t,
               "checks": {k: c["value"] for k, c in prog.items()},
               "correct": all(c["ok"] for c in prog.values()),
               "control": {k: c["value"] for k, c in ctrl.items()},
               "control_correct": all(c["ok"] for c in ctrl.values()),
               "card": torch.cuda.get_device_name(0)}
        print(json.dumps(row), flush=True)
        if a.out:
            os.makedirs(os.path.dirname(os.path.abspath(a.out)),
                        exist_ok=True)
            with open(a.out, "a") as f:
                f.write(json.dumps(row) + "\n")
        shutil.rmtree(out, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
