"""The evidence-extraction step over a (dp, gp) mesh, one rank a shard.

Counterpart of ``seeksv_tpu/parallel/sharded.py`` (``_evidence_step``
under ``shard_map``), on a ``parallel.mesh`` DeviceMesh:

  * reads are data-parallel over dp (replicated over gp), extension jobs
    over the flattened dp x gp axis (rank r holds shard r);
  * each rank's coverage (segment diffs scatter-added into genome_len + 1
    cells, prefix-summed) is summed over dp, and each gp rank keeps its
    block of genome_len // n_gp positions (a remainder is dropped, as
    the reference drops it);
  * the 2,048-bin insert-size histogram is summed over dp, and its integer
    mean and float32 deviation taken as the reference takes them with
    jax_enable_x64 off (the mean's product sum in int64);
  * the rank's extension jobs go through K1w (``ops.extend.
    extend_batch``: the CUDA kernel on the card, its plain version on the
    CPU), the counterpart of ``sw_extend_batch``;
  * the candidate keys and supports are gathered over dp, sorted (stably:
    equal keys keep their gather order) and each run's support summed
    into the run's slot.

The step takes this rank's shards and returns this rank's outputs: its gp
block of the coverage, its shard of the extension results, and the
replicated insert statistics and candidate table.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..ops import coverage as cov_ops
from ..ops.extend import extend_batch
from .mesh import all_gather, all_reduce_sum, mesh_device, shard_index

HIST_BINS = 2048
# the inputs sharded over dp (the rest over dp x gp)
DP_KEYS = ("seg_start", "seg_end", "seg_weight", "isize", "isize_ok",
           "cand_key", "cand_support")
JOB_KEYS = ("q", "qlen", "t", "tlen", "h0")


def _evidence_step(mesh, batch: Dict[str, torch.Tensor], genome_len: int):
    """One rank's body (sharded.py:32-86)."""
    g = mesh.get_coordinate()[1]
    n_gp = mesh.shape[1]
    # coverage: scatter-add, prefix sum, sum over dp, this rank's gp block
    cov = cov_ops.coverage_from_segments(
        batch["seg_start"], batch["seg_end"], batch["seg_weight"],
        genome_len)
    all_reduce_sum(mesh, cov, "dp")
    block = genome_len // n_gp
    cov_local = cov[g * block:(g + 1) * block]

    # insert-size histogram: reads are dp shards, replicated over gp
    isize = batch["isize"].to(torch.int64).clamp(0, HIST_BINS - 1)
    hist = cov_ops.insert_histogram(isize, batch["isize_ok"], HIST_BINS)
    all_reduce_sum(mesh, hist, "dp")
    n = hist.sum().clamp(min=1)
    vals = torch.arange(HIST_BINS, dtype=torch.int64, device=hist.device)
    mean = (hist.to(torch.int64) * vals).sum() // n
    var = (hist.to(torch.float32)
           * (vals - mean).to(torch.float32) ** 2).sum() / n
    dev = torch.sqrt(var).to(torch.int32)

    # extension of this rank's jobs (K1w)
    sw = extend_batch(batch["q"].to(torch.uint8), batch["qlen"],
                      batch["t"].to(torch.uint8), batch["tlen"],
                      batch["h0"])

    # candidate table: gather over dp, stable sort, support summed per run
    keys = all_gather(mesh, batch["cand_key"], "dp")
    sup = all_gather(mesh, batch["cand_support"], "dp")
    order = torch.argsort(keys, stable=True)
    sk = keys[order]
    sv = sup[order]
    first = torch.ones_like(sk, dtype=torch.bool)
    first[1:] = sk[1:] != sk[:-1]
    seg_id = torch.cumsum(first, 0) - 1
    seg_sum = torch.zeros_like(sv).index_add_(0, seg_id, sv)
    return {
        "coverage": cov_local,
        "insert_mean": mean.to(torch.int32).reshape(1),
        "insert_dev": dev.reshape(1),
        "sw": sw,
        "cand_sorted_keys": sk,
        "cand_first": first,
        "cand_support_sum": seg_sum,
    }


def sharded_evidence_step(mesh, genome_len: int):
    """The step on `mesh` (every rank calls it): a callable over a dict
    of this rank's input shards (``make_example_batch``'s keys, on this
    rank's device) that returns this rank's outputs (module
    docstring)."""
    def step(batch: Dict[str, torch.Tensor]):
        return _evidence_step(mesh, batch, genome_len)
    return step


def example_batch_numpy(dp: int, gp: int, genome_len: int, n_reads: int,
                        n_jobs: int, lq: int, lt: int,
                        seed: int) -> Dict[str, np.ndarray]:
    """The whole batch of make_example_batch as numpy arrays, drawn from
    np.random.default_rng(seed) in the reference's order (sharded.py:
    118-137): n_reads rounded down to a multiple of dp (at least dp),
    n_jobs to a multiple of dp x gp."""
    rng = np.random.default_rng(seed)
    n_reads = max(n_reads, dp) // dp * dp
    n_jobs = max(n_jobs, dp * gp) // (dp * gp) * (dp * gp)
    starts = rng.integers(0, max(genome_len - 100, 1), n_reads).astype(
        np.int32)
    return {
        "seg_start": starts,
        "seg_end": (starts + rng.integers(50, 100, n_reads)).astype(np.int32),
        "seg_weight": np.ones(n_reads, np.int32),
        "isize": rng.integers(400, 600, n_reads).astype(np.int32),
        "isize_ok": np.ones(n_reads, bool),
        "q": rng.integers(0, 4, (n_jobs, lq)).astype(np.int32),
        "qlen": np.full(n_jobs, lq, np.int32),
        "t": rng.integers(0, 4, (n_jobs, lt)).astype(np.int32),
        "tlen": np.full(n_jobs, lt, np.int32),
        "h0": np.full(n_jobs, 19, np.int32),
        "cand_key": rng.integers(0, 1 << 20, n_reads).astype(np.int64),
        "cand_support": np.ones(n_reads, np.int32),
    }


def shard_batch(mesh, batch: Dict[str, np.ndarray]
                ) -> Dict[str, torch.Tensor]:
    """This rank's shards of a whole numpy batch, on its device: the dp
    block of each read input, the dp x gp block of each job input."""
    dp, gp = mesh.shape
    d = mesh.get_coordinate()[0]
    r = shard_index(mesh)
    dev = mesh_device(mesh)
    out = {}
    for k, v in batch.items():
        n, idx = (dp, d) if k in DP_KEYS else (dp * gp, r)
        per = len(v) // n
        out[k] = torch.from_numpy(
            np.ascontiguousarray(v[idx * per:(idx + 1) * per])).to(dev)
    return out


def make_example_batch(mesh, genome_len: int, n_reads: int = 64,
                       n_jobs: int = 32, lq: int = 32, lt: int = 64,
                       seed: int = 0) -> Dict[str, torch.Tensor]:
    """Synthetic inputs (sharded.py:114-146): this rank's shards of
    example_batch_numpy's batch, on its device."""
    dp, gp = mesh.shape
    return shard_batch(mesh, example_batch_numpy(
        dp, gp, genome_len, n_reads, n_jobs, lq, lt, seed))
