"""The card's peaks and the least time a kernel's work needs on it.

Frozen copy of the bound arithmetic of ``chip_smoke.py`` (``_bound``,
``_extend_bound``, ``_banded_bound``, ``_walk_bound`` and their
constants) at commit 08505b7, and of the plain extension of
``seeksv_tpu_torch/ops/extend.py`` (``extend_batch_plain`` with its
``rows`` count, ``unpack_nibbles``, ``gather_ref_windows``) that counts
the rows each job ran.  Changes from the original: the int32 rate is
the table's (the H100 SXM's maximum SM clock) instead of one read from
nvidia-smi, a walk's steps sum only its written runs, and the plain
extension keeps only what the row count needs.
"""
from __future__ import annotations

import numpy as np
import torch

# NVIDIA H100 SXM (data sheet): HBM3 at 3.35 TB/s; the int32 rate of the
# CUDA cores, 132 SMs x 64 lanes x 1,980 MHz.
PEAKS = {"NVIDIA H100 80GB HBM3": {"mem_bytes_per_s": 3.35e12,
                                   "int32_ops_per_s": 132 * 64 * 1.98e9}}
# int32 operations the recurrences need at the least (chip_smoke.py):
# extension 9 a cell, 2 more on a row that raises the job's best, 12 a
# row; banded direction 20 a band cell; a traceback step 12.
EXTEND_OPS_PER_CELL = 9
EXTEND_OPS_PER_CELL_IMPROVED = 2
EXTEND_OPS_PER_ROW = 12
BANDED_OPS_PER_CELL = 20
WALK_OPS_PER_STEP = 12
RUNS_CAP = 64
# the finalize's rungs, (half band w, band width K)
RUNGS = {128: 16, 256: 64}

MATCH, MISMATCH, GAP_OPEN, GAP_EXT = 1, 4, 6, 1
AMBIG = -1
NEG_INF = -0x10000000
ZDROP = 100


def peaks(kind: str) -> dict:
    """The table's peaks of a card by its name; a card it lacks raises
    (a share of an unknown peak is no number)."""
    if kind not in PEAKS:
        raise KeyError(f"no peaks for {kind!r} in the benchmark's table")
    return PEAKS[kind]


def bound_s(ops: int, nbytes: int, kind: str) -> float:
    """Seconds: the larger of ops at the int32 rate and nbytes at the
    memory rate."""
    p = peaks(kind)
    return max(ops / p["int32_ops_per_s"], nbytes / p["mem_bytes_per_s"])


def unpack_nibbles(p: torch.Tensor, L: int) -> torch.Tensor:
    lo = (p & 0xF).to(torch.int32)
    hi = (p >> 4).to(torch.int32)
    return torch.stack([lo, hi], dim=2).reshape(p.shape[0], -1)[:, :L]


def gather_ref_windows(refp, n_codes, start, tlen, LT, reverse):
    iota = torch.arange(LT, dtype=torch.int64, device=start.device)[None, :]
    st = start.to(torch.int64)[:, None]
    idx = st - iota if reverse else st + iota
    valid = (iota < tlen.to(torch.int64)[:, None]) & (idx >= 0) \
        & (idx < n_codes)
    idx_c = idx.clamp(0, max(n_codes - 1, 0))
    byte = refp[idx_c >> 1].to(torch.int32)
    nib = torch.where((idx_c & 1) == 1, byte >> 4, byte & 0xF)
    return torch.where(valid, nib, 4)


def extend_rows(q4, qlen, tstart, tlen, h0, refp, n_codes, LQ, LT,
                reverse) -> tuple:
    """(rows, rows_improved) [B]: the target rows each extension job ran
    before tlen or z-drop ended it, and those that raised its best."""
    q = unpack_nibbles(q4, LQ)
    t = gather_ref_windows(refp, n_codes, tstart, tlen, LT, reverse)
    dev = q.device
    B = q.shape[0]
    i32 = torch.int32
    qlen, tlen, h0 = qlen.to(i32), tlen.to(i32), h0.to(i32)
    neg = torch.tensor(NEG_INF, dtype=i32, device=dev)
    jidx = torch.arange(1, LQ + 1, dtype=i32, device=dev)[None, :]
    valid_q = jidx <= qlen[:, None]
    row0 = h0[:, None] - GAP_OPEN - jidx * GAP_EXT
    h = torch.where((row0 >= 0) & valid_q, row0, neg)
    h_first = h0.clone()
    e = torch.full((B, LQ), NEG_INF, dtype=i32, device=dev)
    best = h0.clone()
    dead = torch.zeros(B, dtype=torch.bool, device=dev)
    neg_col = torch.full((B, 1), NEG_INF, dtype=i32, device=dev)
    q_amb = q > 3
    rows = torch.zeros(B, dtype=i32, device=dev)
    rows_improved = torch.zeros(B, dtype=i32, device=dev)
    n_rows = min(LT, int(tlen.max())) if B else 0
    for i in range(n_rows):
        active = (i < tlen) & ~dead
        if not bool(active.any()):
            break
        rows += active
        tcol = t[:, i:i + 1]
        sub = torch.where(q_amb | (tcol > 3), AMBIG,
                          torch.where(q == tcol, MATCH, -MISMATCH)).to(i32)
        diag = torch.cat([h_first[:, None], h[:, :-1]], dim=1) + sub
        ecand = torch.maximum(h - GAP_OPEN, e) - GAP_EXT
        g = torch.maximum(diag, ecand)
        h0_col = h0 - GAP_OPEN - (i + 1) * GAP_EXT
        pref = torch.cat([neg_col, torch.cummax(g + jidx * GAP_EXT,
                                                dim=1).values[:, :-1]], dim=1)
        f = pref - GAP_OPEN - jidx * GAP_EXT
        h_row = torch.where(valid_q, torch.maximum(g, f), neg)
        row_best = h_row.max(dim=1).values
        improved = active & (row_best > best)
        rows_improved += improved
        best = torch.where(improved, row_best, best)
        dead = dead | (active & (row_best < best - ZDROP))
        h_first = torch.where(active, h0_col, h_first)
        h = torch.where(active[:, None], h_row, h)
        e = torch.where(active[:, None], torch.where(valid_q, ecand, neg), e)
    return rows, rows_improved


def extend_bound_s(args: tuple, kind: str) -> float:
    """The bound of one resident extension call (its positional
    arguments, as ops/extend.py:extend_batch_resident takes them): qlen x
    rows cells at EXTEND_OPS_PER_CELL, the improving rows' cells at
    EXTEND_OPS_PER_CELL_IMPROVED more, EXTEND_OPS_PER_ROW a row, against
    the query and target codes once (half a byte each), 4 ints in and 5
    out a job."""
    rows, imp = extend_rows(*args)
    q = args[1].to("cpu").numpy().astype(np.int64)
    r = rows.to("cpu").numpy().astype(np.int64)
    ri = imp.to("cpu").numpy().astype(np.int64)
    ops = (int((q * r).sum()) * EXTEND_OPS_PER_CELL
           + int((q * ri).sum()) * EXTEND_OPS_PER_CELL_IMPROVED
           + int(r.sum()) * EXTEND_OPS_PER_ROW)
    nbytes = int(q.sum() * 0.5 + r.sum() * 0.5 + len(q) * 9 * 4)
    return bound_s(ops, nbytes, kind)


def banded_bound_s(m: np.ndarray, n: np.ndarray, K: int, kind: str) -> float:
    """The bound of one banded direction call: m rows of min(K, |n - m|
    + 2w + 1) columns at BANDED_OPS_PER_CELL; q and t once, 3 ints in,
    the m x K direction bytes and the score out."""
    w = RUNGS[K]
    m64, n64 = m.astype(np.int64), n.astype(np.int64)
    width = np.minimum(K, np.abs(n64 - m64) + 2 * w + 1)
    cells = int((m64 * width).sum())
    return bound_s(cells * BANDED_OPS_PER_CELL,
                   int((m64 + n64).sum()) + len(m) * 4 * 4
                   + int(m64.sum()) * K, kind)


def walk_bound_s(runs_len: np.ndarray, n_runs: np.ndarray, m: np.ndarray,
                 n: np.ndarray, kind: str) -> float:
    """The bound of one traceback call: the steps the walks took (a
    finished walk's steps are its written runs' lengths, an overflowed
    one's at most m + n) at WALK_OPS_PER_STEP, against a direction byte
    a step, 3 ints in and the runs out."""
    B = len(m)
    cols = np.arange(runs_len.shape[1])[None, :]
    written = np.where(cols < n_runs[:, None], runs_len, 0).sum(1)
    steps = int(np.where(n_runs <= RUNS_CAP, written,
                         m.astype(np.int64) + n).sum())
    out_bytes = runs_len.size * 4 * 2 + n_runs.size * 4
    return bound_s(steps * WALK_OPS_PER_STEP,
                   steps + B * 3 * 4 + out_bytes, kind)
