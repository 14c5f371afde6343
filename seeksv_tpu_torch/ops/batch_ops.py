"""Batched comparators and reverse complement on padded rows, as torch ops.

Counterparts of ``seeksv_tpu/ops/jax_kernels.py``:

- ``match_rate_pairs_begin`` (jax_kernels.py:124): the batched
  CompareStringBeginFirst;
- ``match_rate_pairs_end`` (:137): the batched CompareStringEndFirst;
- ``revcomp_batch`` (:226): reverse complement of right-padded code rows.

On the TPU these are XLA programs; here a few torch ops each, on whatever
device the rows are on.  No ported path calls them, so they have no CUDA
kernel.  The match rates return the match count and the compared length:
the division stays with the caller, which keeps the reference's NaN for
an empty comparison.
"""
from __future__ import annotations

import torch


def match_rate_pairs_begin(a: torch.Tensor, alen: torch.Tensor,
                           b: torch.Tensor, blen: torch.Tensor):
    """a, b [N, L] byte rows, alen, blen [N]: (the count of equal bytes
    over the first min(alen, blen) positions as int32 [N], that minimum)."""
    idx = torch.arange(a.shape[1], device=a.device)[None, :]
    n = torch.minimum(alen, blen)
    m = (a == b) & (idx < n[:, None])
    return m.sum(dim=1, dtype=torch.int32), n


def match_rate_pairs_end(a: torch.Tensor, alen: torch.Tensor,
                         b: torch.Tensor, blen: torch.Tensor):
    """The same right-anchored: a[alen - 1 - i] against b[blen - 1 - i]
    for i below min(alen, blen)."""
    L = a.shape[1]
    idx = torch.arange(L, device=a.device)[None, :]
    n = torch.minimum(alen, blen)
    ia = (alen.to(torch.int64)[:, None] - 1 - idx).clamp(0, L - 1)
    ib = (blen.to(torch.int64)[:, None] - 1 - idx).clamp(0, L - 1)
    m = (a.gather(1, ia) == b.gather(1, ib)) & (idx < n[:, None])
    return m.sum(dim=1, dtype=torch.int32), n


def revcomp_batch(seq: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """seq [N, L] codes (0-3 bases, 4 = N) right-padded to L, lens [N]:
    each row's first lens codes reverse-complemented (3 - code below 4,
    N kept), the padding left in place."""
    L = seq.shape[1]
    idx = torch.arange(L, device=seq.device)[None, :]
    src = (lens.to(torch.int64)[:, None] - 1 - idx).clamp(0, L - 1)
    rev = seq.gather(1, src)
    comp = torch.where(rev < 4, 3 - rev, rev)
    return torch.where(idx < lens[:, None], comp, seq)
