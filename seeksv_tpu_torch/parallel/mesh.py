"""The device mesh on torch.distributed.

Counterpart of ``seeksv_tpu/parallel/mesh.py``.  JAX runs the SPMD
pipeline from one controller over a ``Mesh`` of devices; PyTorch runs one
process per rank (NCCL on the card, gloo on the CPU).  Every rank reads
the same input and runs the same host code; the device work of its shard
runs on its own device, and the shards meet in collectives over the
mesh's ``("dp", "gp")`` groups:

  dp — data parallelism over reads and clip groups;
  gp — genome-coordinate parallelism (the coverage's genome blocks).

Rank r is shard r in row-major (dp, gp) order, the order
``P(("dp", "gp"))`` gives in JAX.

Every rank must enter every collective in the same order with the same
shapes: sizes that pad a collective's operand are agreed with ``agree``
(an all-reduce MAX) before the padding, and every branch around a
collective is decided on such an agreed value.  A rank that skips a
collective hangs the others.
"""
from __future__ import annotations

import math
import warnings
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

AXES = ("dp", "gp")


def mesh_shape(n: int, dp: Optional[int] = None):
    """(dp, gp) of an n-rank mesh: the squarest split with dp >= gp, as
    seeksv_tpu/parallel/mesh.py:25-31 chooses it, or the given dp."""
    if dp is None:
        dp = 1
        for d in range(math.isqrt(n), 0, -1):
            if n % d == 0:
                dp = max(d, n // d)
                break
    if dp < 1 or n % dp:
        raise ValueError(f"dp={dp} does not divide {n} ranks")
    return dp, n // dp


def make_mesh(device="cuda", n: Optional[int] = None,
              dp: Optional[int] = None) -> DeviceMesh:
    """A ("dp", "gp") DeviceMesh over every rank of the default process
    group, on `device`'s type (``cuda``: NCCL; ``cpu``: gloo).

    Without a process group this starts a one-rank group on an in-process
    HashStore (no port, no network).  A mesh of more ranks needs one
    process per rank, each having called
    ``torch.distributed.init_process_group``.  n, when given, must be
    the number of ranks.  On ``cuda`` each rank's current device becomes
    ``device.index``, or rank % device_count."""
    device = torch.device(device)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    if device.type == "cuda":
        rank = dist.get_rank() if dist.is_initialized() else 0
        torch.cuda.set_device(device.index if device.index is not None
                              else rank % torch.cuda.device_count())
    if not dist.is_initialized():
        if n not in (None, 1):
            raise RuntimeError(
                f"a mesh of {n} ranks needs {n} processes, each in "
                "torch.distributed.init_process_group")
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            store=dist.HashStore(), rank=0, world_size=1)
    world = dist.get_world_size()
    if n is not None and n != world:
        raise ValueError(f"asked for {n} ranks, the process group has "
                         f"{world}")
    return init_device_mesh(device.type, mesh_shape(world, dp),
                            mesh_dim_names=AXES)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def shard_index(mesh: DeviceMesh) -> int:
    """This rank's shard: its row-major position in the (dp, gp) grid."""
    d, g = mesh.get_coordinate()
    return d * mesh.shape[1] + g


def agree(mesh: DeviceMesh, values: Sequence[int]) -> List[int]:
    """The largest of each value over every rank of the mesh."""
    t = torch.tensor([int(v) for v in values], dtype=torch.int64,
                     device=mesh_device(mesh))
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return [int(v) for v in t.cpu()]


def all_gather(mesh: DeviceMesh, x: torch.Tensor,
               axis: Optional[str] = None) -> torch.Tensor:
    """x of every rank of the mesh (axis None) or of this rank's `axis`
    group, concatenated along dim 0 in rank order.  Every rank passes
    the same shape."""
    group = None if axis is None else mesh.get_group(axis)
    n = dist.get_world_size(group)
    out = torch.empty((n * x.shape[0], *x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    with warnings.catch_warnings():
        # torch >= 2.12 prefers all_gather_single, which 2.11 lacks
        warnings.filterwarnings("ignore", category=FutureWarning,
                                message=".*all_gather_into_tensor")
        dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out


def all_reduce_sum(mesh: DeviceMesh, x: torch.Tensor,
                   axis: Optional[str] = None) -> torch.Tensor:
    """x summed in place over the mesh (axis None) or this rank's `axis`
    group."""
    dist.all_reduce(x, group=None if axis is None else mesh.get_group(axis))
    return x


def process_allgather(mesh: DeviceMesh, a: np.ndarray) -> np.ndarray:
    """[world, *a.shape]: every rank's `a`, in rank order (the port's
    ``multihost_utils.process_allgather`` as seeksv_tpu/parallel/
    multiproc.py uses it).  Every rank passes the same shape and dtype:
    callers pad to an agreed cap.  The bytes go round as one uint8 tensor
    on this rank's device (CUDA under NCCL, CPU under gloo), so any dtype,
    bool included, comes back as it went; a zero-size array enters no
    collective (every rank has the same shape, so every rank skips)."""
    a = np.ascontiguousarray(a)
    world = dist.get_world_size()
    if a.size == 0:
        return np.zeros((world, *a.shape), a.dtype)
    raw = torch.tensor(a.reshape(-1).view(np.uint8), device=mesh_device(mesh))
    out = all_gather(mesh, raw).cpu().numpy()
    return out.view(a.dtype).reshape(world, *a.shape)


def process_allgather_ragged(mesh: DeviceMesh, a: np.ndarray
                             ) -> List[np.ndarray]:
    """Every rank's 1-D `a`, of any length, in rank order: the lengths
    gathered, then each `a` padded to the longest and gathered."""
    lens = process_allgather(mesh, np.asarray([len(a)], np.int64))
    lens = lens.reshape(-1)
    padded = np.zeros(int(lens.max()), a.dtype)
    padded[:len(a)] = a
    allv = process_allgather(mesh, padded)
    return [allv[p, :lens[p]] for p in range(len(lens))]
