"""Windowed discordant-read-pair counting on a torch device.

Counterpart of ``seeksv_tpu/ops/jax_kernels.py:discordant_count_batch``
(K6), the device form of FindDiscordantReadPairs (getsv.cpp:990-1120;
host form ``seeksv_tpu/pipeline/getsv.py:DiscordantCounter.count``): for
each junction, the records of its window ``[lo, min(hi, lo +
window_cap))`` over the coordinate-sorted record columns that pass the
junction's orientation and insert-size tests (case 0 = +/+ with the
tandem-duplication closed form, 1 = -/+, 2 = +/-).

- ``discordant_count_plain``: the reference's [J, window_cap] gather and
  reductions in torch ops over the columns, any device.
- ``pack_junctions``: the junction columns as the kernel reads them, in
  numpy on the host where the junctions are built: one tensor ``jun``
  [8, J] int64, a row per field (lo, hi, beg, up_pos, down_pos, min_ins,
  max_ins, down_tid | code << 32 | same_tid << 34, code 3 for a case
  code outside 0..2), so that each field is one contiguous copy.
  ``unpack_junctions`` gives columns back that count the same.
- ``discordant_count_batch(*record columns, jun, window_cap)``: the
  wrapper.  On CUDA tensors it launches csrc/discordant_count.cu (a warp
  a junction over the record columns) and counts the launch; on CPU
  tensors it runs the plain version on ``unpack_junctions``' columns.
- ``distinct_records``: the records the windows read, each once (the
  bytes the call needs at the least).

Positions are int64, as in the host counter (the TPU ran int32).
Columns: records pos, end, mpos int64; lq, mtid int32; fwd, mfwd,
base_ok bool.  Junctions lo, hi, beg, up_pos, down_pos, min_ins,
max_ins int64; down_tid, case_code int32; same_tid bool.  Returns [J]
int32.
"""
from __future__ import annotations

import numpy as np
import torch

from .extend import _check

# K6 launches; plain-version calls made for CPU tensors are counted apart
LAUNCHES = {"discordant_count": 0}
PLAIN_CALLS = {"discordant_count": 0}

K_CROSS = 5   # kCrossLength, getsv.cpp:15

REC_COLS = (("pos", torch.int64), ("end", torch.int64), ("lq", torch.int32),
            ("mpos", torch.int64), ("mtid", torch.int32),
            ("fwd", torch.bool), ("mfwd", torch.bool),
            ("base_ok", torch.bool))
JUN_COLS = (("lo", torch.int64), ("hi", torch.int64), ("beg", torch.int64),
            ("up_pos", torch.int64), ("down_pos", torch.int64),
            ("down_tid", torch.int32), ("same_tid", torch.bool),
            ("case_code", torch.int32), ("min_ins", torch.int64),
            ("max_ins", torch.int64))
CODE_NONE = 3   # a case code outside 0..2, in a junction row
_LOW32 = 0xFFFFFFFF


def pack_junctions(lo, hi, beg, up_pos, down_pos, down_tid, same_tid,
                   case_code, min_ins, max_ins) -> np.ndarray:
    """jun [8, J] int64 on the host from the junctions' numpy columns
    (min_ins and max_ins may be scalars): the junctions are built there,
    so the card gets them as one upload."""
    i64 = np.int64
    code = case_code.astype(i64)
    code[(code < 0) | (code > 2)] = CODE_NONE
    out = np.empty((8, len(code)), i64)
    for k, x in enumerate((lo, hi, beg, up_pos, down_pos, min_ins,
                           max_ins)):
        out[k] = x
    out[7] = ((down_tid.astype(i64) & _LOW32) | (code << 32)
              | (same_tid.astype(i64) << 34))
    return out


def unpack_junctions(jun: torch.Tensor):
    """Junction columns in discordant_count_plain's order that count what
    the rows count (a case code of 3 comes back as -1)."""
    jm = jun[7]
    code = ((jm >> 32) & 3).to(torch.int32)
    down_tid = (((jm & _LOW32) ^ 0x80000000) - 0x80000000).to(torch.int32)
    return (*(jun[k] for k in range(5)), down_tid, ((jm >> 34) & 1) != 0,
            torch.where(code == CODE_NONE, -1, code), jun[5], jun[6])


def discordant_count_plain(pos, end, lq, mpos, mtid, fwd, mfwd, base_ok,
                           lo, hi, beg, up_pos, down_pos, down_tid, same_tid,
                           case_code, min_ins, max_ins,
                           window_cap: int) -> torch.Tensor:
    """jax_kernels.py:165-222 in torch ops (arguments as the module
    docstring says)."""
    J = lo.shape[0]
    R = pos.shape[0]
    dev = lo.device
    if J == 0 or R == 0 or window_cap <= 0:
        return torch.zeros(J, dtype=torch.int32, device=dev)
    i64 = torch.int64
    widx = torch.arange(window_cap, dtype=i64, device=dev)[None, :]
    gidx = torch.clamp(lo[:, None] + widx, 0, R - 1)
    valid = lo[:, None] + widx < hi[:, None]

    def g(a):
        return a[gidx]

    p, e, mp = g(pos), g(end), g(mpos)
    ln = g(lq).to(i64)
    up = up_pos[:, None]
    dn = down_pos[:, None]
    m = (valid & g(base_ok) & (e > beg[:, None])
         & (g(mtid) == down_tid[:, None]))
    fw, mf = g(fwd), g(mfwd)
    mini = min_ins[:, None]
    maxi = max_ins[:, None]
    K = K_CROSS
    # case 0: +/+ (fwd read, rev mate) with the tandem-dup closed form
    c0 = m & (p + ln <= up + K) & (mp + 1 >= dn - K) & fw & ~mf
    ins0 = up - p + mp + ln - dn + 1
    period = up - dn + 1
    tandem_ok = same_tid[:, None] & (up > dn) & (period + 2 * ln <= maxi)
    # ceil((mini - ins0) / period) as JAX writes it: -(-(a) // b), // floor
    k0 = torch.clamp(-torch.div(-(mini - ins0), torch.clamp(period, min=1),
                                rounding_mode="floor"), min=0)
    hit0 = c0 & torch.where(tandem_ok, ins0 + k0 * period <= maxi,
                            (mini <= ins0) & (ins0 <= maxi))
    # case 1: -/+ (both reverse)
    ins1 = p + 1 - up + 1 + mp + ln - dn + 1
    hit1 = (m & ~fw & ~mf & (mp + 1 >= dn - K) & (mini <= ins1)
            & (ins1 <= maxi))
    # case 2: +/- (both forward)
    ins2 = up - p + dn - (mp + ln) + 1
    hit2 = (m & fw & mf & (p + ln <= up + K) & (mp + ln <= dn + K)
            & (mini <= ins2) & (ins2 <= maxi))
    code = case_code[:, None]
    hits = ((code == 0) & hit0) | ((code == 1) & hit1) | ((code == 2) & hit2)
    return hits.sum(1).to(torch.int32)


def window_ranges(jun: np.ndarray, R: int, window_cap: int):
    """The clamped record-index range [first, last] of each junction's
    window ([J] int64 each) and whether it reads any record, as the
    kernel computes them (numpy)."""
    lo, hi = jun[0], jun[1]
    code = (jun[7] >> 32) & 3
    n = np.minimum(hi - lo, window_cap)
    live = (n > 0) & (code != CODE_NONE) & (R > 0)
    first = np.clip(lo, 0, max(R - 1, 0))
    last = np.clip(lo + np.maximum(n, 1) - 1, 0, max(R - 1, 0))
    return first, last, live


def distinct_records(jun: np.ndarray, R: int, window_cap: int) -> int:
    """How many distinct records the junctions' windows read (the union
    of their clamped ranges)."""
    first, last, live = window_ranges(jun, R, window_cap)
    order = np.argsort(first[live], kind="stable")
    f, la = first[live][order], last[live][order]
    prev = np.maximum.accumulate(np.concatenate([[-1], la]))[:-1]
    return int(np.maximum(la - np.maximum(f, prev + 1) + 1, 0).sum())


def discordant_count_batch(pos, end, lq, mpos, mtid, fwd, mfwd, base_ok,
                           jun: torch.Tensor,
                           window_cap: int) -> torch.Tensor:
    """Discordant-pair counts of J junction windows from the record
    columns and the junction rows (pack_junctions).

    CUDA tensors launch csrc/discordant_count.cu (no fallback); CPU
    tensors run discordant_count_plain on unpack_junctions' columns."""
    recs = (pos, end, lq, mpos, mtid, fwd, mfwd, base_ok)
    dev = jun.device
    R, J = pos.shape[0], jun.shape[-1]
    for (name, dtype), x in zip(REC_COLS, recs):
        _check(name, x, dtype, (R,), dev)
    _check("jun", jun, torch.int64, (8, J), dev)
    if window_cap < 0:
        raise ValueError(f"window_cap={window_cap} < 0")
    if dev.type == "cpu":
        PLAIN_CALLS["discordant_count"] += 1
        return discordant_count_plain(*recs, *unpack_junctions(jun),
                                      window_cap=window_cap)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    from .. import _build
    lib = _build.lib()
    out = torch.empty(J, dtype=torch.int32, device=dev)
    if J:
        rc = lib.seeksv_discordant_count(
            *(x.data_ptr() for x in recs), R, jun.data_ptr(), J, window_cap,
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        _build.check(rc, "seeksv_discordant_count")
        LAUNCHES["discordant_count"] += 1
    return out
