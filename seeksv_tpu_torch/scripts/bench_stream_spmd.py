"""Streaming x SPMD at scale: ``parallel/stream_spmd.
spmd_run_pipeline_streaming`` against the sequential streaming pipeline,
with the sv rows required equal and the peak resident set recorded.

Counterpart of scripts/bench_stream_spmd.py.  The JAX script puts a
virtual 8-device mesh in one process; the port's mesh is
``torch.distributed``, one process a rank:

- ``--device cpu --ranks 1,2,4``: for each size, that many gloo ranks,
  each a subprocess joined through a ``FileStore`` (as
  tests/torch_spmd_worker.py runs them); the row's peak resident set is
  the largest ``VmHWM`` of any rank;
- ``--device cuda``: one NCCL rank on the card, in this process (NCCL
  refuses two ranks on one device); its peak resident set is this
  process's ``ru_maxrss``, the sequential run's included.

The sequential baseline (``pipeline/stream.run_pipeline_streaming``)
runs in this process on ``--device``.  Both sides best of ``--trials``.
The dataset is ``bench_scale``'s (the same cache).  One JSON row per
mesh size, appended to ``--out``; the exit code is 1 unless every size's
sv rows equal the sequential stream's.

    python -m seeksv_tpu_torch.scripts.bench_stream_spmd [--genome-mb 100]
        [--coverage 30] [--events 3000] [--ranks 1] [--device cuda]
        [--chunk-records 2000000] [--trials 2] [--out PATH]
"""
from __future__ import annotations

import argparse
import json
import os
import resource
import subprocess
import sys
import tempfile
import time

import torch

from ..pipeline.stream import run_pipeline_streaming
from ..utils.dataset import build_dataset, sv_rows
from ._card import provenance, require, warm
from .bench_junction_window import child_env, vm_hwm_mb
from .bench_scale import cache_root, dataset_key


def rank_main(argv) -> None:
    """One gloo rank: ``RANK WORLD STORE REF_FA BAM PREFIX CHUNK``; runs
    the streaming SPMD pipeline and prints its stages and VmHWM as one
    JSON line."""
    import torch.distributed as dist

    from ..parallel.mesh import make_mesh
    from ..parallel.stream_spmd import spmd_run_pipeline_streaming
    rank, world, store, ref_fa, bam, prefix, chunk = argv
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, int(world)),
                            rank=int(rank), world_size=int(world))
    try:
        mesh = make_mesh("cpu", int(world))
        t0 = time.perf_counter()
        res = spmd_run_pipeline_streaming(mesh, ref_fa, bam, prefix,
                                          chunk_records=int(chunk))
        total = time.perf_counter() - t0
        shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
    finally:
        dist.destroy_process_group()
    print(json.dumps({"total_s": total, "stages_s": res["stages_s"],
                      "mesh": shape, "vm_hwm_mb": vm_hwm_mb()}))


def _gloo_run(world, ref_fa, bam, prefix, chunk, work):
    """world gloo ranks as subprocesses: (wall seconds of rank 0's
    pipeline, rank 0's stages, the mesh shape, every rank's VmHWM)."""
    store = os.path.join(work, f"store{world}.{time.monotonic_ns()}")
    env = child_env(OMP_NUM_THREADS="1")
    code = ("import sys; from seeksv_tpu_torch.scripts.bench_stream_spmd "
            "import rank_main; rank_main(sys.argv[1:])")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(r), str(world), store, ref_fa, bam,
         prefix, str(chunk)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env) for r in range(world)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=3600)
            if p.returncode:
                raise RuntimeError(f"a gloo rank exited {p.returncode}: "
                                   f"{err[-2000:]}")
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return (outs[0]["total_s"], outs[0]["stages_s"], outs[0]["mesh"],
            [o["vm_hwm_mb"] for o in outs])


def _card_run(dev, ref_fa, bam, prefix, chunk):
    """One NCCL rank in this process: (seconds, stages, mesh shape)."""
    import torch.distributed as dist

    from ..parallel.mesh import make_mesh
    from ..parallel.stream_spmd import spmd_run_pipeline_streaming
    owned = not dist.is_initialized()
    mesh = make_mesh(dev)
    try:
        t0 = time.perf_counter()
        res = spmd_run_pipeline_streaming(mesh, ref_fa, bam, prefix,
                                          chunk_records=chunk)
        total = time.perf_counter() - t0
    finally:
        if owned:
            dist.destroy_process_group()
    return total, res["stages_s"], dict(zip(mesh.mesh_dim_names, mesh.shape))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--genome-mb", type=float, default=100)
    ap.add_argument("--coverage", type=int, default=30)
    ap.add_argument("--read-len", type=int, default=100)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--events", type=int, default=3000)
    ap.add_argument("--ranks", default="1",
                    help="comma list of mesh sizes (gloo ranks on the CPU; "
                         "1 on the card)")
    ap.add_argument("--chunk-records", type=int, default=2_000_000)
    ap.add_argument("--trials", type=int, default=2,
                    help="best of N per configuration (both sides)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (one NCCL rank) or cpu (gloo ranks)")
    ap.add_argument("--out", default=None)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = require(args.device)
    sizes = [int(x) for x in args.ranks.split(",")]
    if dev.type == "cuda" and sizes != [1]:
        raise SystemExit("--device cuda runs one rank: NCCL refuses two "
                         "ranks on one device (use --device cpu for gloo "
                         "ranks)")
    G = int(args.genome_mb * 1e6)
    root = cache_root(dataset_key(G, args.coverage, args.read_len,
                                  args.seed, args.events))
    paths = build_dataset(root, G, args.coverage, args.read_len, args.seed,
                          args.events, False,
                          log=lambda *a: print(*a, file=sys.stderr))
    fa, bam = paths["ref_fa"], paths["bam"]
    warm(dev, {})
    dev_info = provenance(dev)
    all_exact = True
    with tempfile.TemporaryDirectory() as d:
        seq_totals = []
        seq_prefix = os.path.join(d, "seq")
        for _ in range(max(1, args.trials)):
            t0 = time.perf_counter()
            run_pipeline_streaming(fa, bam, seq_prefix, device=dev,
                                   chunk_records=args.chunk_records)
            seq_totals.append(round(time.perf_counter() - t0, 3))
        t_seq = min(seq_totals)
        want = sv_rows(seq_prefix + ".sv")
        for n in sizes:
            spmd_totals, best, rss = [], None, []
            prefix = os.path.join(d, f"spmd{n}")
            for _ in range(max(1, args.trials)):
                if dev.type == "cuda":
                    total, stages, mesh = _card_run(
                        dev, fa, bam, prefix, args.chunk_records)
                    rss = [resource.getrusage(
                        resource.RUSAGE_SELF).ru_maxrss / 1024]
                else:
                    total, stages, mesh, hwm = _gloo_run(
                        n, fa, bam, prefix, args.chunk_records, d)
                    rss = [max(a, b) for a, b in zip(rss or hwm, hwm)]
                spmd_totals.append(round(total, 3))
                if best is None or total < best[0]:
                    best = (total, stages)
            parity = ("exact" if sv_rows(prefix + ".sv") == want
                      else "MISMATCH")
            all_exact &= parity == "exact"
            row = {
                "metric": "stream_spmd_scale_run",
                "genome_mb": args.genome_mb, "coverage": args.coverage,
                "ranks": n, "mesh": mesh,
                "backend": "nccl" if dev.type == "cuda" else "gloo",
                "chunk_records": args.chunk_records,
                "sv_parity_vs_sequential_stream": parity,
                "sv_rows": len(want),
                "sequential_stream_s": t_seq,
                "spmd_stream_s": min(spmd_totals),
                "speedup_vs_sequential": round(t_seq / min(spmd_totals), 3),
                "trials": max(1, args.trials),
                "seq_totals_s": seq_totals,
                "spmd_totals_s": spmd_totals,
                "spmd_stages_s": {k: round(v, 3)
                                  for k, v in best[1].items()},
                "peak_rss_mb": round(max(rss), 1),
                "peak_rss_by_rank_mb": [round(x, 1) for x in rss],
                **dev_info,
                "note": ("one NCCL rank in the process that also ran the "
                         "sequential stream (peak_rss_mb is its ru_maxrss)"
                         if dev.type == "cuda" else
                         "gloo ranks on the CPU, one subprocess each "
                         "(peak_rss_mb is the largest rank's VmHWM)"),
            }
            line = json.dumps(row)
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
    return 0 if all_exact else 1


if __name__ == "__main__":
    sys.exit(main())
