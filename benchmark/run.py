"""The benchmark of seeksv_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Builds the cell's dataset from the seed and the program's k-mer index
of its fasta (subprocesses; both kept in ``benchmark/.cache/data/<cell>``
for the next run of the same seed), sets the program up (CUDA context,
native library, kernels, one warm pass), runs whole passes for
``--seconds``, checks the last pass's outputs against
the plain reference (``sbench/judge.py``), and prints one JSON line:
``correct``, ``attempted`` (passes), ``failed``, ``metrics`` (the end-to-
end ones, or with ``--trace 1`` the per-layer ones), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each number compared
beside its limit.  Exits non-zero, with no line, without enough CUDA
cards, without the program, or when a module of JAX or of the JAX
package is loaded.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args()
    sys.path.insert(0, HERE)
    from sbench import harness, loader, report
    spec = loader.Spec(REPO)
    cell = spec.cell(a.workload)
    if not os.path.isdir(os.path.join(REPO, "seeksv_tpu_torch")):
        log("the program (seeksv_tpu_torch) is not in this checkout")
        return 2
    import torch
    chips = cell["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"the cell needs {chips} CUDA card(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    sys.path.insert(1, REPO)
    # fixed cache directories inside the checkout, for any JIT cache a
    # kernel library of the program may keep (the port's own nvcc build
    # goes to the checkout's build/)
    cache = os.path.join(HERE, ".cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    data = harness.ensure_data(HERE, cell, a.seed, log)
    workdir = os.path.join(tempfile.gettempdir(), "seeksv_bench",
                           a.workload)
    ctx = harness.measure(cell, data, a.seconds, bool(a.trace), "cuda",
                          workdir, log)
    checks = harness.check(cell, data, ctx["prefix"], a.seed, "cuda",
                           log=log)
    line = report.result(spec, cell, ctx, checks, bool(a.trace), log)
    bad = harness.forbidden_modules()
    if bad:
        log(f"modules of JAX or the JAX package are loaded: {bad}")
        return 4
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
