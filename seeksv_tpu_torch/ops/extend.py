"""Batched anchored affine-gap extension (the aligner's inner loop).

Counterpart of ``seeksv_tpu/ops/pallas_sw.py`` (the Pallas kernel, its
resident-genome entry and its window entry) and
``seeksv_tpu/ops/jax_kernels.py:sw_extend_batch``.

- ``extend_batch_plain``: the plain PyTorch version on [B, LQ] / [B, LT]
  code tensors, any device.  It is the exact-prefix-max formulation of
  the JAX kernels: one target row per step, the row-gap term as an
  exclusive ``cummax`` over the query axis.
- ``extend_batch_resident_plain``: the same on nibble-packed queries, with
  target windows gathered from the nibble-packed genome (reversed for
  left extensions; positions off the genome or at/after tlen read 4).
- ``extend_batch_resident``: the wrapper.  On a CUDA tensor it launches
  the CUDA kernel (csrc/extend.cu, target gather fused into the kernel's
  loads) and counts the launch; on a CPU tensor it runs the plain version.
- ``extend_batch``: the wrapper on uint8 [B, LQ] / [B, LT] windows already
  on the device (the device front-end's), counterpart of
  ``pallas_extend_batch``; the same kernel reads them as they lie.
- ``plan_bins``: the kernel's dispatch, in torch ops on the jobs' device:
  one warp runs one job with the cells a lane holds sized to the job's
  own qlen, so the jobs are binned by qlen (``BIN_EDGES``), the bins
  ordered widest first and the jobs of a bin by falling qlen x tlen; a
  call is one launch per bin that a query of the bucket LQ can fall into
  (``bin_launches``), each job's results written at its own index.

Scores: match +1, mismatch -4, ambiguous (code > 3) -1, gap open 6,
extend 1, z-drop 100.  Outputs per job: max_score, qle/tle (first
occurrence of the best), gscore/gtle (best score reaching the query end).
"""
from __future__ import annotations

import numpy as np
import torch

MATCH = 1
MISMATCH = 4
GAP_OPEN = 6
GAP_EXT = 1
AMBIG = -1
NEG_INF = -0x10000000
ZDROP = 100
BIG = 0x7FFFFFFF
KEYS = ("max_score", "qle", "tle", "gscore", "gtle")
# query-length bins of the CUDA kernel: a job whose qlen is at most
# BIN_EDGES[i] (and above the edge before) runs in bin i, one warp with
# BIN_EDGES[i] / 32 cells a lane; longer queries run in the last bin's
# width in several passes a row.  csrc/extend.cu holds the same edges
# (kEdges) and every launch checks that the two agree.
BIN_EDGES = (128, 256, 512, 1024)

# CUDA kernel launches of the resident entry by direction (left =
# reversed windows) and of the window entry: a call adds one per bin it
# launches (bin_launches(LQ)); plain-version calls made for CPU tensors
# are counted apart
LAUNCHES = {"extend_left": 0, "extend_right": 0, "extend_windows": 0}
PLAIN_CALLS = {"extend_left": 0, "extend_right": 0, "extend_windows": 0}


def pack_nibbles(a: np.ndarray) -> np.ndarray:
    """[B, L] uint8 codes (0..4) -> [B, ceil(L/2)] uint8, host side; the
    low nibble holds the even position."""
    B, L = a.shape
    if L % 2:
        a = np.concatenate([a, np.full((B, 1), 4, np.uint8)], axis=1)
    return (a[:, 0::2] | (a[:, 1::2] << 4)).astype(np.uint8)


def unpack_nibbles(p: torch.Tensor, L: int) -> torch.Tensor:
    """[B, ceil(L/2)] uint8 -> [B, L] int32."""
    lo = (p & 0xF).to(torch.int32)
    hi = (p >> 4).to(torch.int32)
    return torch.stack([lo, hi], dim=2).reshape(p.shape[0], -1)[:, :L]


def gather_ref_windows(refp: torch.Tensor, n_codes: int, start: torch.Tensor,
                       tlen: torch.Tensor, LT: int,
                       reverse: bool) -> torch.Tensor:
    """[B, LT] int32 target windows from the packed genome: element k is
    genome position start -/+ k; code 4 off the genome or at k >= tlen."""
    iota = torch.arange(LT, dtype=torch.int64, device=start.device)[None, :]
    st = start.to(torch.int64)[:, None]
    idx = st - iota if reverse else st + iota
    valid = (iota < tlen.to(torch.int64)[:, None]) & (idx >= 0) \
        & (idx < n_codes)
    idx_c = idx.clamp(0, max(n_codes - 1, 0))
    byte = refp[idx_c >> 1].to(torch.int32)
    nib = torch.where((idx_c & 1) == 1, byte >> 4, byte & 0xF)
    return torch.where(valid, nib, 4)


def extend_batch_plain(q: torch.Tensor, qlen: torch.Tensor, t: torch.Tensor,
                       tlen: torch.Tensor, h0: torch.Tensor,
                       with_rows: bool = False) -> dict:
    """Plain PyTorch extension: q [B, LQ], t [B, LT] codes, qlen/tlen/h0
    [B].  Returns a dict of int32 [B] tensors (KEYS); with_rows adds
    "rows", the target rows each job ran before tlen or z-drop ended it,
    and "rows_improved", those of them that raised the job's best (the
    rows whose first-occurrence argmax is needed): what a roofline bound
    of this data counts.

    Rows stop once no job is active: activity (i < tlen, not z-dropped)
    never returns, so the frozen state is the final one."""
    dev = q.device
    B, LQ = q.shape
    LT = t.shape[1]
    i32 = torch.int32
    q = q.to(i32)
    t = t.to(i32)
    qlen = qlen.to(i32)
    tlen = tlen.to(i32)
    h0 = h0.to(i32)
    neg = torch.tensor(NEG_INF, dtype=i32, device=dev)
    jidx = torch.arange(1, LQ + 1, dtype=i32, device=dev)[None, :]
    valid_q = jidx <= qlen[:, None]
    row0 = h0[:, None] - GAP_OPEN - jidx * GAP_EXT
    h = torch.where((row0 >= 0) & valid_q, row0, neg)
    h_first = h0.clone()
    e = torch.full((B, LQ), NEG_INF, dtype=i32, device=dev)
    best = h0.clone()
    qle = torch.zeros(B, dtype=i32, device=dev)
    tle = torch.zeros(B, dtype=i32, device=dev)
    gscore = torch.full((B,), NEG_INF, dtype=i32, device=dev)
    gtle = torch.zeros(B, dtype=i32, device=dev)
    dead = torch.zeros(B, dtype=torch.bool, device=dev)
    at_qlen = jidx == qlen[:, None]
    qlen_zero = qlen == 0
    neg_col = torch.full((B, 1), NEG_INF, dtype=i32, device=dev)
    s_amb = torch.tensor(AMBIG, dtype=i32, device=dev)
    s_match = torch.tensor(MATCH, dtype=i32, device=dev)
    s_mis = torch.tensor(-MISMATCH, dtype=i32, device=dev)
    big = torch.tensor(BIG, dtype=i32, device=dev)
    q_amb = q > 3
    rows = torch.zeros(B, dtype=i32, device=dev)
    rows_improved = torch.zeros(B, dtype=i32, device=dev)
    n_rows = min(LT, int(tlen.max())) if B else 0
    for i in range(n_rows):
        active = (i < tlen) & ~dead
        if not bool(active.any()):
            break
        if with_rows:
            rows += active
        tcol = t[:, i:i + 1]
        sub = torch.where(q_amb | (tcol > 3), s_amb,
                          torch.where(q == tcol, s_match, s_mis))
        diag = torch.cat([h_first[:, None], h[:, :-1]], dim=1) + sub
        ecand = torch.maximum(h - GAP_OPEN, e) - GAP_EXT
        g = torch.maximum(diag, ecand)
        h0_col = h0 - GAP_OPEN - (i + 1) * GAP_EXT
        pref = torch.cat([neg_col, torch.cummax(g + jidx * GAP_EXT,
                                                dim=1).values[:, :-1]], dim=1)
        f = pref - GAP_OPEN - jidx * GAP_EXT
        h_row = torch.where(valid_q, torch.maximum(g, f), neg)
        row_best = h_row.max(dim=1).values
        row_arg = torch.where(h_row == row_best[:, None], jidx,
                              big).min(dim=1).values
        improved = active & (row_best > best)
        if with_rows:
            rows_improved += improved
        best = torch.where(improved, row_best, best)
        qle = torch.where(improved, row_arg, qle)
        tle = torch.where(improved, torch.full_like(tle, i + 1), tle)
        h_at_qlen = torch.where(
            qlen_zero, h0_col,
            torch.where(at_qlen, h_row, neg).max(dim=1).values)
        gimp = active & (h_at_qlen > gscore)
        gscore = torch.where(gimp, h_at_qlen, gscore)
        gtle = torch.where(gimp, torch.full_like(gtle, i + 1), gtle)
        dead = dead | (active & (row_best < best - ZDROP))
        h_first = torch.where(active, h0_col, h_first)
        h = torch.where(active[:, None], h_row, h)
        e = torch.where(active[:, None], torch.where(valid_q, ecand, neg), e)
    out = {"max_score": best, "qle": qle, "tle": tle, "gscore": gscore,
           "gtle": gtle}
    if with_rows:
        out["rows"] = rows
        out["rows_improved"] = rows_improved
    return out


def extend_batch_resident_plain(q4, qlen, tstart, tlen, h0, refp, n_codes,
                                LQ, LT, reverse,
                                with_rows: bool = False) -> dict:
    """Plain version of the resident entry: unpack the queries, gather the
    target windows from the packed genome, extend."""
    q = unpack_nibbles(q4, LQ)
    t = gather_ref_windows(refp, n_codes, tstart, tlen, LT, reverse)
    return extend_batch_plain(q, qlen, t, tlen, h0, with_rows)


def bin_launches(LQ: int) -> int:
    """Kernel launches of one call at the query bucket LQ: one per bin
    that a query of at most LQ can fall into."""
    return 1 + sum(LQ > e for e in BIN_EDGES)


def bin_of(x: torch.Tensor, edges) -> torch.Tensor:
    """[B] int64: the bin of each x among the Python int edges, bin i for
    edges[i-1] < x <= edges[i] (len(edges) past the last edge).  Compares
    against Python ints: no tensor of edges, no wait for the device."""
    b = (x > edges[0]).to(torch.int64)
    for e in edges[1:]:
        b += x > e
    return b


def bin_offsets(bin_id: torch.Tensor, n_bins: int) -> torch.Tensor:
    """[n_bins + 1] int32: seg[x] = the jobs in the x widest bins (those
    with bin_id >= n_bins - x), counted by a comparison and a sum (a
    bincount would wait for the device to size its output)."""
    floor = torch.arange(n_bins, -1, -1, dtype=bin_id.dtype,
                         device=bin_id.device)
    return (bin_id[None, :] >= floor[:, None]).sum(dim=1, dtype=torch.int32)


def plan_bins(qlen: torch.Tensor, tlen: torch.Tensor, LQ: int):
    """The kernel's dispatch of B jobs of the query bucket LQ: (order, seg).

    order [B] int32: the jobs, bins widest first (queries past
    BIN_EDGES[-1], then the bins of BIN_EDGES from the last to the first),
    inside a bin by falling qlen x tlen (the longest job starts first).
    seg [len(BIN_EDGES) + 2] int32: the bins' offsets into order, in that
    order.  A job with no query cell or no target row does no work and
    goes to the narrowest bin; a qlen past LQ has LQ cells and is binned
    as LQ, so every job lies in a bin that the call launches.  A few torch
    ops on the device of qlen, none of which waits for the device."""
    q = qlen.to(torch.int64).clamp(max=LQ)
    t = tlen.to(torch.int64).clamp(min=0)
    bin_id = torch.where((q <= 0) | (t <= 0), 0, bin_of(q, BIN_EDGES))
    key = bin_id * (1 << 44) + (q.clamp(min=0) * t).clamp(max=(1 << 44) - 1)
    order = torch.argsort(key, descending=True).to(torch.int32)
    return order, bin_offsets(bin_id, len(BIN_EDGES) + 1)


def _check(name, x, dtype, shape, device):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                         f"expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def extend_batch_resident(q4: torch.Tensor, qlen: torch.Tensor,
                          tstart: torch.Tensor, tlen: torch.Tensor,
                          h0: torch.Tensor, refp: torch.Tensor, n_codes: int,
                          LQ: int, LT: int, reverse: bool) -> dict:
    """Extension of B jobs against the resident packed genome.

    q4 [B, ceil(LQ/2)] uint8 nibble-packed queries; qlen, tstart, tlen,
    h0 [B] int32; refp [ceil(G/2)] uint8 the packed genome of n_codes
    codes.  tstart is the genome index of the window's first element in
    scan order (left extensions walk backwards: reverse=True).

    A CUDA tensor launches csrc/extend.cu (no fallback); a CPU tensor
    runs extend_batch_resident_plain."""
    dev = q4.device
    B = q4.shape[0]
    _check("q4", q4, torch.uint8, (B, (LQ + 1) // 2), dev)
    for name, x in (("qlen", qlen), ("tstart", tstart), ("tlen", tlen),
                    ("h0", h0)):
        _check(name, x, torch.int32, (B,), dev)
    _check("refp", refp, torch.uint8, ((n_codes + 1) // 2,), dev)
    key = "extend_left" if reverse else "extend_right"
    if dev.type == "cpu":
        PLAIN_CALLS[key] += 1
        return extend_batch_resident_plain(q4, qlen, tstart, tlen, h0, refp,
                                           n_codes, LQ, LT, reverse)
    if q4.data_ptr() % 4:
        q4 = q4.clone()     # the kernel reads the packed query by words
    return _launch("seeksv_extend_resident", key, dev, qlen, tlen, LQ,
                   q4.data_ptr(), qlen.data_ptr(), tstart.data_ptr(),
                   tlen.data_ptr(), h0.data_ptr(), refp.data_ptr(), n_codes,
                   B, LQ, LT, int(reverse))


def extend_batch(q: torch.Tensor, qlen: torch.Tensor, t: torch.Tensor,
                 tlen: torch.Tensor, h0: torch.Tensor) -> dict:
    """Extension of B jobs on windows already on the device: q [B, LQ] and
    t [B, LT] uint8 codes (0..4), qlen, tlen, h0 [B] int32.  Returns the
    KEYS as int32 [B] tensors, as pallas_extend_batch does.

    A CUDA tensor launches csrc/extend.cu's window entry (no fallback); a
    CPU tensor runs extend_batch_plain."""
    dev = q.device
    if q.dim() != 2 or t.dim() != 2:
        raise ValueError("q and t must be [B, L] code matrices")
    B, LQ = q.shape
    LT = t.shape[1]
    _check("q", q, torch.uint8, (B, LQ), dev)
    _check("t", t, torch.uint8, (B, LT), dev)
    for name, x in (("qlen", qlen), ("tlen", tlen), ("h0", h0)):
        _check(name, x, torch.int32, (B,), dev)
    if dev.type == "cpu":
        PLAIN_CALLS["extend_windows"] += 1
        return extend_batch_plain(q, qlen, t, tlen, h0)
    return _launch("seeksv_extend_windows", "extend_windows", dev, qlen,
                   tlen, LQ, q.data_ptr(), qlen.data_ptr(), t.data_ptr(),
                   tlen.data_ptr(), h0.data_ptr(), B, LQ, LT)


def _launch(entry: str, key: str, dev, qlen, tlen, LQ: int, *args) -> dict:
    """Launch an entry of csrc/extend.cu on `dev` (CUDA, or raise) with
    its leading arguments, then the dispatch (plan_bins), the output and
    the stream; count its kernel launches (one per bin of the bucket
    LQ)."""
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if LQ % 32 or not 32 <= LQ <= 16384:
        raise ValueError(f"query bucket LQ={LQ} has no launch shape "
                         "(needs a multiple of 32, at most 16384)")
    from .. import _build
    lib = _build.lib()
    edges = tuple(lib.seeksv_extend_bin_edge(i)
                  for i in range(lib.seeksv_extend_bins() - 1))
    if edges != BIN_EDGES:
        raise RuntimeError(f"csrc/extend.cu bins queries at {edges}, "
                           f"BIN_EDGES says {BIN_EDGES}")
    B = qlen.shape[0]
    out = torch.empty((len(KEYS), B), dtype=torch.int32, device=dev)
    if B:
        order, seg = plan_bins(qlen, tlen, LQ)
        rc = getattr(lib, entry)(*args, order.data_ptr(), seg.data_ptr(),
                                 out.data_ptr(),
                                 torch.cuda.current_stream(dev).cuda_stream)
        _build.check(rc, entry)
        LAUNCHES[key] += bin_launches(LQ)
    return dict(zip(KEYS, out.unbind(0)))
