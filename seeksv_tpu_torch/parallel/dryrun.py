"""The multichip dry run on a torch.distributed mesh.

Counterpart of ``__graft_entry__.py:dryrun_multichip``: the whole
pipeline SPMD on a mesh of every rank there is, on the small simulated
dataset the JAX entry falls back to without the reference's example
(a 40 kb ``chr17`` with two deletions, 25x, seed 0), checked byte for
byte against the port's single-process host run.

One rank: ``python -c "from seeksv_tpu_torch.parallel.dryrun import
dryrun_multichip; dryrun_multichip(1)"``.  n ranks: start n processes,
each calling ``torch.distributed.init_process_group`` (its rank, the
world size n, a shared store), then ``dryrun_multichip(n)`` in each.
"""
from __future__ import annotations

import gzip
import os
import tempfile

import numpy as np

from .mesh import make_mesh, mesh_device
from .spmd_pipeline import is_writer, spmd_run_pipeline


def simulated_dataset(root: str) -> dict:
    """__graft_entry__.py:118-132: a 40 kb genome with deletions at
    8,000-9,000 and 25,000-25,600, reads at 25x from seed 0."""
    from ..utils.simulate import (build_donor, random_genome,
                                  simulate_reads, write_fasta)
    rng = np.random.default_rng(0)
    G = 40_000
    ref = {"chr17": random_genome(rng, G)}
    donor = build_donor(ref, deletions=[(8_000, 9_000), (25_000, 25_600)])
    paths = {"bam": os.path.join(root, "sim.bam"),
             "ref_fa": os.path.join(root, "ref.fa")}
    simulate_reads(donor, ["chr17"], [G], paths["bam"], coverage=25, seed=0)
    write_fasta(paths["ref_fa"], ref)
    return paths


def dryrun_multichip(n_devices: int, device: str = "cuda") -> None:
    """spmd_run_pipeline on an n-rank mesh on ``device`` (the card unless
    the caller asks for ``"cpu"``; without a card ``"cuda"`` raises), then,
    on rank 0, the port's ``run_pipeline`` with force_host: the ``.sv``
    and the decompressed ``.clip.gz`` must be equal, and the ``.sv`` must
    hold a call.  Raises AssertionError on a difference."""
    from ..pipeline.driver import run_pipeline
    mesh = make_mesh(device, n_devices)
    with tempfile.TemporaryDirectory() as d:
        p = simulated_dataset(d)
        spmd_run_pipeline(mesh, p["ref_fa"], p["bam"],
                          os.path.join(d, "spmd"), force_device_extend=True)
        if not is_writer(mesh):
            return
        run_pipeline(p["ref_fa"], p["bam"], os.path.join(d, "host"),
                     device=mesh_device(mesh), force_host=True)
        with open(os.path.join(d, "spmd.sv"), "rb") as f:
            got = f.read()
        with open(os.path.join(d, "host.sv"), "rb") as f:
            want = f.read()
        if got != want:
            raise AssertionError("SPMD sv rows diverge from the host run")
        if len(got.splitlines()) < 2:
            raise AssertionError("no sv rows produced")
        with gzip.open(os.path.join(d, "spmd.clip.gz")) as f:
            got = f.read()
        with gzip.open(os.path.join(d, "host.clip.gz")) as f:
            want = f.read()
        if got != want:
            raise AssertionError("SPMD clip.gz diverges from the host run")
