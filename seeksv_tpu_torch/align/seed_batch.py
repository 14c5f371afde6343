"""Batched seeding: candidate diagonals for many reads at once.

Exact vectorization of Aligner._candidates (verified element-for-element by
tests/test_align.py::test_batch_seeding_equivalence): all reads' k-mers are
hashed and looked up in one searchsorted, hits expand to a flat
(job, offset, position) table, and diagonal grouping / longest-consecutive-
run anchors / vote ranking are segment reductions over one lexsort.  The
same structure maps onto the device path (sorted segment ops + gathers
against the device-resident index, ops/seed_device.py).  Counterpart of
seeksv_tpu/align/seed_batch.py.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from .index import KmerIndex

MAX_OCC = 500
TOP_CANDIDATES = 8


def batch_candidates(idx: KmerIndex, reads: List[np.ndarray]
                     ) -> Dict[int, List[Tuple[int, int, int, int]]]:
    """reads: list of encoded code arrays (one per job, already
    strand-expanded by the caller).  Returns {job_i: [(diag, q_start,
    anchor_len, votes), ...]} in the per-read ranking order.

    Dispatches to the threaded native kernel (csrc seeksv_seed_batch)
    when built; the numpy path below is the oracle (equivalence asserted
    by tests/test_native.py)."""
    if len(reads) == 0:
        return {}
    from ..io import native
    if native.seed_batch_available() and idx.prefix_tab is not None:
        return native.seed_batch_native(idx, reads, MAX_OCC, TOP_CANDIDATES)
    return _batch_candidates_np(idx, reads)


def _batch_candidates_np(idx: KmerIndex, reads: List[np.ndarray]
                         ) -> Dict[int, List[Tuple[int, int, int, int]]]:
    """Pure-numpy batched seeding (the oracle for the native kernel)."""
    k = idx.k
    n = len(reads)
    if n == 0:
        return {}
    # ---- batch rolling hashes ----
    lens = np.asarray([len(r) for r in reads], np.int64)
    L = int(lens.max(initial=0))
    if L < k:
        return {i: [] for i in range(n)}
    mat = np.full((n, L), 4, np.uint8)
    for i, r in enumerate(reads):
        mat[i, :len(r)] = r
    nk = L - k + 1
    h = np.zeros((n, nk), np.uint64)
    ok = np.ones((n, nk), bool)
    valid = mat < 4
    for j in range(k):
        h = (h << np.uint64(2)) | mat[:, j:nk + j].astype(np.uint64)
        ok &= valid[:, j:nk + j]
    ok &= (np.arange(nk)[None, :] + k) <= lens[:, None]
    job_of, off_of = np.nonzero(ok)
    hashes = h[job_of, off_of]
    lo, hi = idx.lookup(hashes)
    cnt = hi - lo
    keep = (cnt > 0) & (cnt <= MAX_OCC)
    job_of, off_of, lo, cnt = job_of[keep], off_of[keep], lo[keep], cnt[keep]
    if len(job_of) == 0:
        return {i: [] for i in range(n)}
    # ---- ragged hit expansion ----
    total = int(cnt.sum())
    hit_src = np.repeat(np.arange(len(cnt)), cnt)
    base = np.concatenate([[0], np.cumsum(cnt)])[:-1]
    intra = np.arange(total) - base[hit_src]
    pos = idx.positions[lo[hit_src] + intra]
    hjob = job_of[hit_src]
    hoff = off_of[hit_src].astype(np.int64)
    diag = pos - hoff
    # ---- group by (job, diag); runs of consecutive offsets ----
    order = np.lexsort((hoff, diag, hjob))
    hjob, diag, hoff = hjob[order], diag[order], hoff[order]
    new_key = np.concatenate(
        [[True], (hjob[1:] != hjob[:-1]) | (diag[1:] != diag[:-1])])
    jump = np.concatenate([[True], hoff[1:] != hoff[:-1] + 1])
    new_run = new_key | jump
    run_id = np.cumsum(new_run) - 1
    n_runs = int(run_id[-1]) + 1
    run_start_idx = np.nonzero(new_run)[0]
    run_len = np.diff(np.concatenate([run_start_idx, [len(hoff)]]))
    run_q_start = hoff[run_start_idx]
    key_id = np.cumsum(new_key) - 1
    run_key = key_id[run_start_idx]
    # longest run per key, earliest on ties (host loop uses strict >)
    run_order = np.lexsort((np.arange(n_runs), -run_len, run_key))
    rk_sorted = run_key[run_order]
    first_of_key = np.concatenate([[True], rk_sorted[1:] != rk_sorted[:-1]])
    best_runs = run_order[first_of_key]        # one run per key, key-sorted
    # per-key metadata
    key_start_idx = np.nonzero(new_key)[0]
    key_votes = np.diff(np.concatenate([key_start_idx, [len(hoff)]]))
    key_job = hjob[key_start_idx]
    key_diag = diag[key_start_idx]
    anchor_start = run_q_start[best_runs]
    anchor_len = run_len[best_runs] + k - 1
    # ---- rank per job: (-votes, diag), top 8 ----
    out: Dict[int, List[Tuple[int, int, int, int]]] = {i: [] for i in range(n)}
    rank = np.lexsort((key_diag, -key_votes, key_job))
    for ki in rank:
        lst = out[int(key_job[ki])]
        if len(lst) < TOP_CANDIDATES:
            lst.append((int(key_diag[ki]), int(anchor_start[ki]),
                        int(anchor_len[ki]), int(key_votes[ki])))
    return out
