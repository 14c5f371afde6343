"""getclip's per-breakpoint greedy consensus merge on a torch device.

Counterpart of ``seeksv_tpu/ops/consensus_scan.py:consensus_scan_groups``
(K5): the reads of a breakpoint-key group, in order, probe the group's
live slots; the first slot whose two sides both match at >= num/den
(end-anchored left, begin-anchored right, over the common length) takes
the read (support + 1, each side replaced when the read's is strictly
longer); otherwise the read opens a new slot, or the group overflows
once ``max_slots`` are open.

- ``consensus_scan_plain``: the reference's scan in torch ops, a loop
  over the G reads on [NG, S, L] slot tensors, any device.
- ``consensus_scan_groups``: the wrapper.  On a CUDA tensor it launches
  csrc/consensus_scan.cu and counts the launch; on a CPU tensor it runs
  the plain version.
- ``plan_groups``: the order in which the kernel's warps take the groups,
  in torch ops on the groups' device.

What bounds the kernel on the card is the live bytes of the sides (not
the padding of the [NG, G, L] tensors) and the dependent chain of a
group's reads.  What the design does about it: the slot state is the
source read of each side, not its bytes, and lives in shared memory with
the group's lengths; a warp runs a group, four groups a block, in one
persistent launch (thousands of groups give the card its parallelism, and
a group's live slots are few) that walks the groups by falling live bytes
(``plan_groups``), so the largest start at once; the sides are compared
in the input rows where they lie, four bytes a lane a step, with many
warps a multiprocessor to hide the distance; a group of one read takes no
compare; a group too long for its lengths and state to fit the warp's
shared memory keeps them in device memory, in the same loop.

Unlike the reference, neither takes the qualities: the reference carries
them beside the sequences but returns none of them, and a side's
quality follows its source read (``src_l``/``src_r``).

Both return the reference's keys: ``support``, ``src_l``, ``src_r``,
``sl_len``, ``sr_len`` [NG, S] int32 (src -1: an unopened slot);
``sl_seq`` [NG, S, LL] / ``sr_seq`` [NG, S, LR] uint8 (the sides' rows,
zeros for an unopened slot); ``n_slots`` [NG] int32; ``slot_of_read``
[NG, G] int32 (-1: merged nowhere); ``overflow`` [NG] bool.
"""
from __future__ import annotations

import torch

from .extend import _check

# K5's kernel launches (one a call); plain-version calls made for CPU
# tensors apart
LAUNCHES = {"consensus_scan": 0}
PLAIN_CALLS = {"consensus_scan": 0}

BIG = 0x7FFFFFFF


def live_bytes(len_l, len_r, n_reads) -> torch.Tensor:
    """[NG] int64: the bytes of a group's live sides (len_l + len_r of its
    first n_reads reads); 0 for a group of at most one read, which takes
    no compare."""
    G = len_l.shape[1]
    n = n_reads.to(torch.int64).clamp(0, G)
    live = torch.arange(G, device=len_l.device)[None, :] < n[:, None]
    total = ((len_l.to(torch.int64) + len_r.to(torch.int64)) * live).sum(dim=1)
    return torch.where(n > 1, total, torch.zeros_like(n))


def plan_groups(len_l, len_r, n_reads) -> torch.Tensor:
    """The order in which the kernel's warps take the NG groups: [NG]
    int32, by falling live_bytes (the largest group starts first; equal
    groups in index order).  Torch ops on the device of n_reads; no
    synchronisation with the host."""
    need = live_bytes(len_l, len_r, n_reads)
    return torch.argsort(need, descending=True, stable=True).to(torch.int32)


def _side_rows(seq, lens, src):
    """[NG, S, L] rows seq[k, src[k, s]] and their lengths, zeros where
    src is -1."""
    NG, S = src.shape
    has = src >= 0
    idx = src.clamp(min=0).to(torch.int64)
    rows = torch.gather(seq, 1, idx[:, :, None].expand(NG, S, seq.shape[2]))
    ln = torch.gather(lens, 1, idx)
    return (rows.masked_fill_(~has[:, :, None], 0),
            ln.masked_fill_(~has, 0))


def _with_sides(out, seq_l, len_l, seq_r, len_r):
    out["sl_seq"], out["sl_len"] = _side_rows(seq_l, len_l, out["src_l"])
    out["sr_seq"], out["sr_len"] = _side_rows(seq_r, len_r, out["src_r"])
    return out


def consensus_scan_plain(seq_l, len_l, seq_r, len_r, n_reads,
                         threshold_num: int, threshold_den: int,
                         max_slots: int = 16) -> dict:
    """The reference's scan (consensus_scan.py:63-128) with a batch
    dimension over the groups: seq_l [NG, G, LL] right-aligned, seq_r
    [NG, G, LR] left-aligned uint8, len_l/len_r [NG, G], n_reads [NG]."""
    dev = seq_l.device
    NG, G, LL = seq_l.shape
    LR = seq_r.shape[2]
    S = max_slots
    i32 = torch.int32
    len_l = len_l.to(i32)
    len_r = len_r.to(i32)
    n_reads = n_reads.to(i32)
    num, den = int(threshold_num), int(threshold_den)
    s_sl = torch.zeros((NG, S, LL), dtype=torch.uint8, device=dev)
    s_sr = torch.zeros((NG, S, LR), dtype=torch.uint8, device=dev)
    s_ll = torch.zeros((NG, S), dtype=i32, device=dev)
    s_lr = torch.zeros((NG, S), dtype=i32, device=dev)
    sup = torch.zeros((NG, S), dtype=i32, device=dev)
    src_l = torch.full((NG, S), -1, dtype=i32, device=dev)
    src_r = torch.full((NG, S), -1, dtype=i32, device=dev)
    n_slots = torch.zeros(NG, dtype=i32, device=dev)
    slot_of = torch.full((NG, G), -1, dtype=i32, device=dev)
    overflow = torch.zeros(NG, dtype=torch.bool, device=dev)
    lidx = torch.arange(LL, device=dev)
    ridx = torch.arange(LR, device=dev)
    sidx = torch.arange(S, dtype=i32, device=dev)
    rows = torch.arange(NG, device=dev)
    for g in range(G):
        rl_seq, rl_len = seq_l[:, g], len_l[:, g]
        rr_seq, rr_len = seq_r[:, g], len_r[:, g]
        active = g < n_reads
        nmin_l = torch.minimum(s_ll, rl_len[:, None])
        in_l = lidx[None, None, :] >= (LL - nmin_l)[:, :, None]
        m_l = ((s_sl == rl_seq[:, None, :]) & in_l).sum(2)
        ok_l = (m_l * den >= nmin_l.to(torch.int64) * num) & (nmin_l > 0)
        nmin_r = torch.minimum(s_lr, rr_len[:, None])
        in_r = ridx[None, None, :] < nmin_r[:, :, None]
        m_r = ((s_sr == rr_seq[:, None, :]) & in_r).sum(2)
        ok_r = (m_r * den >= nmin_r.to(torch.int64) * num) & (nmin_r > 0)
        match = (sidx[None, :] < n_slots[:, None]) & ok_l & ok_r
        first = torch.where(match, sidx[None, :], BIG).min(1).values
        has = first < BIG
        target = torch.where(has, first,
                             torch.clamp(n_slots, max=S - 1)).to(torch.int64)
        overflow = overflow | (active & ~has & (n_slots >= S))
        write = active & (has | (n_slots < S))
        take_l = write & (~has | (rl_len > s_ll[rows, target]))
        take_r = write & (~has | (rr_len > s_lr[rows, target]))
        gi = torch.full_like(n_slots, g)
        for take, seq, ln, s_seq, s_len, src in (
                (take_l, rl_seq, rl_len, s_sl, s_ll, src_l),
                (take_r, rr_seq, rr_len, s_sr, s_lr, src_r)):
            s_seq[rows, target] = torch.where(take[:, None], seq,
                                              s_seq[rows, target])
            s_len[rows, target] = torch.where(take, ln, s_len[rows, target])
            src[rows, target] = torch.where(take, gi, src[rows, target])
        sup[rows, target] += write.to(i32)
        n_slots = torch.where(active & ~has & (n_slots < S), n_slots + 1,
                              n_slots)
        slot_of[:, g] = torch.where(write, target.to(i32), -1)
    return {"sl_seq": s_sl, "sl_len": s_ll, "sr_seq": s_sr, "sr_len": s_lr,
            "support": sup, "n_slots": n_slots, "slot_of_read": slot_of,
            "overflow": overflow, "src_l": src_l, "src_r": src_r}


def consensus_scan_groups(seq_l, len_l, seq_r, len_r, n_reads,
                          threshold_num: int, threshold_den: int,
                          max_slots: int = 16, with_sides: bool = True,
                          order=None) -> dict:
    """The consensus merge of NG groups (arguments as
    consensus_scan_plain, lengths and n_reads int32).

    A CUDA tensor launches csrc/consensus_scan.cu (no fallback); a CPU
    tensor runs consensus_scan_plain.  with_sides=False leaves out the
    sides' rows and lengths (sl_seq, sl_len, sr_seq, sr_len), which are
    gathers after the kernel; order: plan_groups of these inputs, made
    before (a timing's way to leave the planning out)."""
    dev = seq_l.device
    if seq_l.dim() != 3 or seq_r.dim() != 3:
        raise ValueError("seq_l and seq_r must be [NG, G, L] byte tensors")
    NG, G, LL = seq_l.shape
    LR = seq_r.shape[2]
    _check("seq_l", seq_l, torch.uint8, (NG, G, LL), dev)
    _check("seq_r", seq_r, torch.uint8, (NG, G, LR), dev)
    _check("len_l", len_l, torch.int32, (NG, G), dev)
    _check("len_r", len_r, torch.int32, (NG, G), dev)
    _check("n_reads", n_reads, torch.int32, (NG,), dev)
    if max_slots < 1 or LL < 1 or LR < 1:
        raise ValueError(f"max_slots={max_slots}, LL={LL}, LR={LR}: each "
                         "must be at least 1")
    if dev.type == "cpu":
        PLAIN_CALLS["consensus_scan"] += 1
        return consensus_scan_plain(seq_l, len_l, seq_r, len_r, n_reads,
                                    threshold_num, threshold_den, max_slots)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    from .. import _build
    lib = _build.lib()
    S = max_slots
    out = {k: torch.empty((NG, S), dtype=torch.int32, device=dev)
           for k in ("support", "src_l", "src_r")}
    out["n_slots"] = torch.empty(NG, dtype=torch.int32, device=dev)
    out["slot_of_read"] = torch.empty((NG, G), dtype=torch.int32, device=dev)
    out["overflow"] = torch.empty(NG, dtype=torch.bool, device=dev)
    if NG:
        if order is None:
            order = plan_groups(len_l, len_r, n_reads)
        rc = lib.seeksv_consensus_scan(
            seq_l.data_ptr(), len_l.data_ptr(), LL, seq_r.data_ptr(),
            len_r.data_ptr(), LR, n_reads.data_ptr(), NG, G, S,
            int(threshold_num), int(threshold_den), order.data_ptr(),
            out["support"].data_ptr(), out["n_slots"].data_ptr(),
            out["slot_of_read"].data_ptr(), out["overflow"].data_ptr(),
            out["src_l"].data_ptr(), out["src_r"].data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        _build.check(rc, "seeksv_consensus_scan")
        LAUNCHES["consensus_scan"] += 1
    if not with_sides:
        return out
    return _with_sides(out, seq_l, len_l, seq_r, len_r)
