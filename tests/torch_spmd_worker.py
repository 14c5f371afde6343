"""One rank of a multi-process gloo run of the port's SPMD pipeline, for
tests/test_torch_spmd.py and tests/test_torch_stream_spmd.py:

    python tests/torch_spmd_worker.py RANK WORLD STORE OUT REF_FA BAM TASK...

Joins a gloo process group of WORLD ranks through the FileStore at
STORE, builds the mesh and runs each TASK in order, writing under OUT
(rank 0 writes the pipeline outputs; the coverage tasks write their
results as .npz).  Tasks:

  pipeline            spmd_run_pipeline -> OUT/spmd.*
  stream_mc           spmd_run_pipeline_streaming, consensus on the mesh,
                      1,000-record slabs -> OUT/stream_mc.*
  stream_host         the same with the host consensus -> OUT/stream_host.*
  coverage:N[:spill]  spmd_coverage_insert with read_pair_used N (and
                      isize >= 65536 planted on five records) on the
                      squarest mesh -> OUT/coverage_N[_spill].npz
  coverage_gp:N       the same on a (1, WORLD) mesh (genome blocks over
                      gp) -> OUT/coverage_gp_N.npz
  dryrun              dryrun_multichip(WORLD)

Imports no jax.
"""
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def plant_spill(recs):
    """Five qualifying records get insert sizes past the histogram, as
    tests/test_spmd_pipeline.py:119-140 plants them."""
    import copy

    import numpy as np

    from seeksv_tpu_torch.io.bam import FDUP, FPAIRED, FPROPER_PAIR
    recs = copy.copy(recs)
    isz = np.array(recs.isize, copy=True)
    ok = ((recs.mapq >= 20) & ((recs.flag & FPAIRED) != 0)
          & ((recs.flag & FPROPER_PAIR) != 0)
          & ((recs.flag & FDUP) == 0) & (isz > 0))
    idx = np.nonzero(ok)[0][:5]
    isz[idx] = [70_000, 100_000, 66_000, 1 << 20, 65_536]
    recs.isize = isz
    return recs


def main(argv):
    import numpy as np
    import torch
    import torch.distributed as dist

    rank, world, store, out, ref_fa, bam = argv[:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    from seeksv_tpu_torch.io.bam import read_bam
    from seeksv_tpu_torch.parallel import spmd_pipeline as sp
    from seeksv_tpu_torch.parallel import stream_spmd as ss
    from seeksv_tpu_torch.parallel.dryrun import dryrun_multichip
    from seeksv_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh("cpu", world)
    for task in argv[6:]:
        name, *opt = task.split(":")
        if name == "pipeline":
            sp.spmd_run_pipeline(mesh, ref_fa, bam, os.path.join(out, "spmd"))
        elif name in ("stream_mc", "stream_host"):
            ss.spmd_run_pipeline_streaming(
                mesh, ref_fa, bam, os.path.join(out, name),
                chunk_records=1000, mesh_consensus=name == "stream_mc")
        elif name in ("coverage", "coverage_gp"):
            recs = read_bam(bam)
            tag = f"{name}_{opt[0]}"
            if opt[1:] == ["spill"]:
                recs = plant_spill(recs)
                tag += "_spill"
            m = make_mesh("cpu", world, dp=1) if name == "coverage_gp" \
                else mesh
            cov, mean, dev = sp.spmd_coverage_insert(m, recs, 20,
                                                     int(opt[0]))
            if rank == 0:
                np.savez(os.path.join(out, f"{tag}.npz"), mean=mean,
                         dev=dev, **{f"cov{t}": c for t, c in cov.items()})
        elif name == "dryrun":
            dryrun_multichip(world, "cpu")
        else:
            raise SystemExit(f"unknown task {task}")
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
