"""One rank of a multi-process gloo run of the port's distributed half, for
tests/test_torch_multiproc.py and tests/test_torch_sharded.py:

    python tests/torch_multiproc_worker.py RANK WORLD STORE TASKS_JSON

Joins a gloo process group of WORLD ranks through the FileStore at STORE
and runs each task of the JSON list in order.  A task is a dict with
"task", "out" (a directory) and the task's own keys:

  pipeline       ref_fa, bam: multiprocess_run_pipeline -> out/mp.*
  somatic_range  normal, tumor_sv: multiprocess_somatic_range ->
                 out/mpr.temp.sv, out/mpr.somatic.sv
  somatic        normal, tumor_sv: multiprocess_somatic -> out/mps.temp.sv,
                 out/mps.somatic.sv
  coverage       bam, n_pairs, spill (five records with isize >= 65536),
                 split ("half": each rank the WORLD-th part of the records
                 in file order; "first": rank 0 all of them, the others
                 none): multiprocess_coverage_insert -> out/<tag>.npz
  allgather      process_allgather of rank-stamped bool, int64 and uint8
                 arrays and of a zero-length one -> out/allgather.npz
  evidence       genome_len, dp, n_reads, n_jobs, lq, lt, seed:
                 sharded_evidence_step on make_example_batch on a
                 (dp, WORLD / dp) mesh ->
                 out/evidence_<dp>_<genome_len>_r<RANK>.npz

Each rank prints its log lines.  Imports no jax.
"""
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def _records(bam, rank, world, split, spill):
    """This rank's contiguous part of the BAM's records in file order
    (with spill, after planting the five spills on the whole file)."""
    from seeksv_tpu_torch.io.bam import read_bam, slice_records
    from seeksv_tpu_torch.parallel.multiproc import _empty_records
    from torch_spmd_worker import plant_spill
    recs = read_bam(bam)
    if spill:
        recs = plant_spill(recs)
    if split == "first":
        return recs if rank == 0 else _empty_records(recs.ref_names,
                                                     recs.ref_lens)
    return slice_records(recs, rank * recs.n // world,
                         (rank + 1) * recs.n // world)


def main(argv):
    import numpy as np
    import torch
    import torch.distributed as dist

    rank, world, store, tasks = argv[:4]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    from seeksv_tpu_torch.parallel import multiproc as mp
    from seeksv_tpu_torch.parallel import sharded
    from seeksv_tpu_torch.parallel.mesh import make_mesh, process_allgather
    from seeksv_tpu_torch.parallel.spmd_pipeline import \
        multiprocess_coverage_insert
    mesh = make_mesh("cpu", world)
    log = lambda *a: print(*a, flush=True)
    for t in json.loads(tasks):
        out = t["out"]
        name = t["task"]
        if name == "pipeline":
            stages = {}
            sv = mp.multiprocess_run_pipeline(
                mesh, t["ref_fa"], t["bam"], os.path.join(out, "mp"),
                log=log, stages=stages)
            assert (sv is not None) == (rank == 0), sv
            log(f"[p{rank}] stages {json.dumps(sorted(stages))}")
        elif name in ("somatic_range", "somatic"):
            fn, tag = ((mp.multiprocess_somatic_range, "mpr")
                       if name == "somatic_range"
                       else (mp.multiprocess_somatic, "mps"))
            res = fn(mesh, t["normal"], t["tumor_sv"],
                     os.path.join(out, f"{tag}.temp.sv"),
                     os.path.join(out, f"{tag}.somatic.sv"),
                     os.path.join(out, tag), log=log)
            assert (res is not None) == (rank == 0), res
        elif name == "coverage":
            recs = _records(t["bam"], rank, world, t["split"], t["spill"])
            cov, mean, dev = multiprocess_coverage_insert(
                mesh, recs, 20, t["n_pairs"])
            if rank == 0:
                np.savez(os.path.join(out, f"{t['tag']}.npz"), mean=mean,
                         dev=dev, **{f"cov{k}": c for k, c in cov.items()})
        elif name == "allgather":
            got = {
                "b": process_allgather(
                    mesh, np.arange(5) % (rank + 2) == 0),
                "i64": process_allgather(mesh, np.asarray(
                    [[rank, -rank], [1 << 40, -(1 << 62) + rank]],
                    np.int64)),
                "u8": process_allgather(mesh, np.full(3, 250 + rank,
                                                      np.uint8)),
                "empty": process_allgather(mesh, np.zeros((0, 4),
                                                          np.int64))}
            if rank == 0:
                np.savez(os.path.join(out, "allgather.npz"), **got)
        elif name == "evidence":
            m = make_mesh("cpu", world, dp=t["dp"])
            batch = sharded.make_example_batch(
                m, t["genome_len"], t["n_reads"], t["n_jobs"], t["lq"],
                t["lt"], t["seed"])
            res = sharded.sharded_evidence_step(m, t["genome_len"])(batch)
            flat = {k: v for k, v in res.items() if k != "sw"}
            flat.update({f"sw_{k}": v for k, v in res["sw"].items()})
            flat.update({f"in_{k}": v for k, v in batch.items()})
            np.savez(os.path.join(
                out, f"evidence_{t['dp']}_{t['genome_len']}_r{rank}.npz"),
                **{k: v.numpy() for k, v in flat.items()})
        else:
            raise SystemExit(f"unknown task {name}")
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
