"""Windowed discordant-read-pair counting on a torch device.

Counterpart of ``seeksv_tpu/ops/jax_kernels.py:discordant_count_batch``
(K6), the device form of FindDiscordantReadPairs (getsv.cpp:990-1120;
host form ``seeksv_tpu/pipeline/getsv.py:DiscordantCounter.count``): for
each junction, the records of its window ``[lo, min(hi, lo +
window_cap))`` over the coordinate-sorted record columns that pass the
junction's orientation and insert-size tests (case 0 = +/+ with the
tandem-duplication closed form, 1 = -/+, 2 = +/-).

- ``discordant_count_plain``: the reference's [J, window_cap] gather and
  reductions in torch ops, any device.
- ``discordant_count_batch``: the wrapper.  On a CUDA tensor it launches
  csrc/discordant_count.cu (one warp per junction) and counts the launch;
  on a CPU tensor it runs the plain version.

Positions are int64, as in the host counter (the TPU ran int32).
Record columns [R]: pos, end, mpos int64; lq, mtid int32; fwd, mfwd,
base_ok bool.  Junction columns [J]: lo, hi, beg, up_pos, down_pos,
min_ins, max_ins int64; down_tid, case_code int32; same_tid bool.
Returns [J] int32.
"""
from __future__ import annotations

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


def discordant_count_batch(pos, end, lq, mpos, mtid, fwd, mfwd, base_ok,
                           lo, hi, beg, up_pos, down_pos, down_tid, same_tid,
                           case_code, min_ins, max_ins,
                           window_cap: int) -> torch.Tensor:
    """Discordant-pair counts of J junction windows.

    A CUDA tensor launches csrc/discordant_count.cu (no fallback); a CPU
    tensor runs discordant_count_plain."""
    dev = lo.device
    recs = (pos, end, lq, mpos, mtid, fwd, mfwd, base_ok)
    juns = (lo, hi, beg, up_pos, down_pos, down_tid, same_tid, case_code,
            min_ins, max_ins)
    R, J = pos.shape[0], lo.shape[0]
    for (name, dtype), x in zip(REC_COLS, recs):
        _check(name, x, dtype, (R,), dev)
    for (name, dtype), x in zip(JUN_COLS, juns):
        _check(name, x, dtype, (J,), dev)
    if window_cap < 0:
        raise ValueError(f"window_cap={window_cap} < 0")
    if dev.type == "cpu":
        PLAIN_CALLS["discordant_count"] += 1
        return discordant_count_plain(*recs, *juns, window_cap=window_cap)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    from .. import _build
    lib = _build.lib()
    out = torch.empty(J, dtype=torch.int32, device=dev)
    if J:
        rc = lib.seeksv_discordant_count(
            *(x.data_ptr() for x in recs), R,
            *(x.data_ptr() for x in juns), J, window_cap, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        _build.check(rc, "seeksv_discordant_count")
        LAUNCHES["discordant_count"] += 1
    return out
