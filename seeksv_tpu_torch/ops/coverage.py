"""Coverage and insert-size histograms as torch ops.

Counterpart of ``seeksv_tpu/ops/jax_kernels.py:coverage_from_segments``
and of the local steps of the SPMD coverage/insert-size bodies
(``seeksv_tpu/parallel/spmd_pipeline.py:_coverage_insert_body``,
``stream_spmd.py:SpmdStreamStats``).  On the TPU these are XLA
scatter-adds and cumsums, not Pallas kernels; here they are
``index_add_`` and ``cumsum`` on whatever device the tensors are on.
The collectives around them live in ``parallel/``.

Depth diffs are int32 like the reference's; ``torch.cumsum`` of int32
returns int64, so prefix sums are cast back.  Flat genome coordinates
are int64 throughout (no int32 wrap past 2^31 bp).
"""
from __future__ import annotations

import torch


def segment_diff(starts: torch.Tensor, ends: torch.Tensor, length: int,
                 weights=None) -> torch.Tensor:
    """[length + 1] int32 difference array of segments [start, end):
    +weight at start, -weight at end, both clamped into [0, length] (the
    last cell collects what falls past the end)."""
    dev = starts.device
    diff = torch.zeros(length + 1, dtype=torch.int32, device=dev)
    if weights is None:
        weights = torch.ones(starts.shape[0], dtype=torch.int32, device=dev)
    weights = weights.to(torch.int32)
    diff.index_add_(0, starts.to(torch.int64).clamp(0, length), weights)
    diff.index_add_(0, ends.to(torch.int64).clamp(0, length), -weights)
    return diff


def prefix_sum_i32(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of an int32 vector, as int32."""
    return torch.cumsum(x, 0).to(torch.int32)


def coverage_from_segments(starts: torch.Tensor, ends: torch.Tensor,
                           weights: torch.Tensor, length: int) -> torch.Tensor:
    """[length] int32 depth of weighted segments (jax_kernels.py:154)."""
    return prefix_sum_i32(segment_diff(starts, ends, length,
                                       weights))[:length]


def first_n_take(ok: torch.Tensor, offset: int,
                 read_pair_used: int) -> torch.Tensor:
    """The first-N mask: qualifying records (ok) whose rank among all
    qualifying records, counting `offset` before this block, is below
    read_pair_used (cluster.cpp:25-56)."""
    rank = offset + torch.cumsum(ok.to(torch.int64), 0) - 1
    return ok & (rank < read_pair_used)


def insert_histogram(isize: torch.Tensor, take: torch.Tensor,
                     size: int) -> torch.Tensor:
    """[size] int32 histogram of isize (already clamped into [0, size))
    over the records where take is set."""
    hist = torch.zeros(size, dtype=torch.int32, device=isize.device)
    hist.index_add_(0, isize.to(torch.int64), take.to(torch.int32))
    return hist
