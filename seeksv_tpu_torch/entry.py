"""Entry points of the port.

Counterpart of ``__graft_entry__.py``:

- ``entry(device="cuda")`` -> ``(fn, args)``: one step of the flagship
  kernel, the batched anchored extension on the resident genome (the
  aligner's inner loop, ``ops/extend.py:extend_batch_resident``; K1 on a
  CUDA device, its plain version on the CPU), on the inputs of the JAX
  entry's TPU branch: 128 jobs, LQ 64, LT 128, nibble-packed queries,
  target windows gathered from a 65,536-code genome, drawn from
  ``np.random.default_rng(0)`` in the same order.  The JAX entry's CPU
  branch calls an unpacked XLA scan; the port keeps the one resident
  form on both devices.
- ``dryrun_multichip(n, device="cuda")``: the whole pipeline SPMD on a
  mesh of n ranks (``parallel/dryrun.py``).
"""
from __future__ import annotations

import numpy as np
import torch

from .ops.extend import extend_batch_resident, pack_nibbles
from .parallel.dryrun import dryrun_multichip

__all__ = ["entry", "dryrun_multichip"]


def entry(device="cuda"):
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("entry(): no CUDA device; entry('cpu') runs the "
                           "kernel's plain version")
    rng = np.random.default_rng(0)
    B, LQ, LT = 128, 64, 128
    qlen = rng.integers(20, LQ + 1, B).astype(np.int32)
    tlen = rng.integers(40, LT + 1, B).astype(np.int32)
    h0 = np.full(B, 19, np.int32)
    G = 1 << 16
    genome = rng.integers(0, 4, G).astype(np.uint8)
    refp = (genome[0::2] | (genome[1::2] << 4)).astype(np.uint8)
    q4 = pack_nibbles(rng.integers(0, 4, (B, LQ)).astype(np.uint8))
    tstart = rng.integers(0, G - LT - 1, B).astype(np.int32)

    def fn(q4, qlen, tstart, tlen, h0, refp):
        return extend_batch_resident(q4, qlen, tstart, tlen, h0, refp, G,
                                     LQ, LT, False)

    return fn, tuple(torch.from_numpy(a).to(dev)
                     for a in (q4, qlen, tstart, tlen, h0, refp))
