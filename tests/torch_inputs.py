"""Inputs of the consensus-scan and discordant-count tests, and the
extension kernel's dispatch with the plain version in the kernel's place,
shared by the CPU tests (against the JAX package) and the card tests
(against the plain versions).  No jax: the card's host has none."""
import numpy as np
import torch

from seeksv_tpu_torch.ops import discordant as dc
from seeksv_tpu_torch.ops import extend as ext

CONSENSUS_KEYS = ("sl_seq", "sl_len", "sr_seq", "sr_len", "support",
                  "n_slots", "slot_of_read", "overflow", "src_l", "src_r")


def extend_batch_binned_plain(q, qlen, t, tlen, h0):
    """ops.extend.extend_batch through the CUDA kernel's dispatch with the
    plain version in the kernel's place: each bin's jobs, in plan_bins'
    order and at the bin's own query width, through extend_batch_plain,
    their results written at the jobs' own indices."""
    B, LQ = q.shape
    order, seg = ext.plan_bins(qlen, tlen, LQ)
    seg = seg.tolist()
    widths = (LQ,) + tuple(reversed(ext.BIN_EDGES))
    out = torch.empty((len(ext.KEYS), B), dtype=torch.int32, device=q.device)
    for which, width in enumerate(widths):
        idx = order[seg[which]:seg[which + 1]].to(torch.int64)
        if idx.numel() == 0:
            continue
        res = ext.extend_batch_plain(q[idx, :min(width, LQ)], qlen[idx],
                                     t[idx], tlen[idx], h0[idx])
        out[:, idx] = torch.stack([res[k] for k in ext.KEYS])
    return dict(zip(ext.KEYS, out.unbind(0)))


def random_groups(seed, NG=24, G=12, LL=40, LR=36):
    """Consensus groups whose reads are noisy copies of three templates
    (so slots match, mismatch and overflow), with empty sides and empty
    groups: seq_l, len_l, seq_r, len_r, n_reads."""
    rng = np.random.default_rng(seed)
    seq_l = np.zeros((NG, G, LL), np.uint8)
    seq_r = np.zeros((NG, G, LR), np.uint8)
    len_l = np.zeros((NG, G), np.int32)
    len_r = np.zeros((NG, G), np.int32)
    n_reads = rng.integers(0, G + 1, NG).astype(np.int32)
    n_reads[0] = 0
    n_reads[1] = G
    for k in range(NG):
        tl = rng.integers(65, 69, (3, LL)).astype(np.uint8)
        tr = rng.integers(65, 69, (3, LR)).astype(np.uint8)
        for ri in range(n_reads[k]):
            t = int(rng.integers(0, 3))
            nl = int(rng.integers(0, LL + 1)) if rng.random() < 0.9 else 0
            nr = int(rng.integers(0, LR + 1)) if rng.random() < 0.9 else 0
            sl = tl[t, LL - nl:].copy()
            sr = tr[t, :nr].copy()
            for s in (sl, sr):
                mut = rng.random(len(s)) < rng.choice([0.02, 0.1, 0.3])
                s[mut] = rng.integers(65, 69, int(mut.sum()))
            seq_l[k, ri, LL - nl:] = sl
            seq_r[k, ri, :nr] = sr
            len_l[k, ri], len_r[k, ri] = nl, nr
    return seq_l, len_l, seq_r, len_r, n_reads


def discordant_windows(seed, R=4000, J=400):
    """Coordinate-sorted record columns and junction windows reaching all
    three cases, tandem junctions (same chromosome, up > down), windows
    wider than 64 records and eight empty padding rows: (records,
    junctions) as dicts of ops.discordant's columns."""
    rng = np.random.default_rng(seed)
    pos = np.sort(rng.integers(0, 40_000, R)).astype(np.int64)
    lq = rng.integers(50, 151, R).astype(np.int32)
    rec = {"pos": pos, "end": pos + lq + rng.integers(-5, 6, R),
           "lq": lq, "mpos": pos + rng.integers(-4000, 4000, R),
           "mtid": rng.integers(0, 2, R).astype(np.int32),
           "fwd": rng.random(R) < 0.5, "mfwd": rng.random(R) < 0.5,
           "base_ok": rng.random(R) < 0.85}
    lo = rng.integers(0, R, J)
    hi = lo + rng.integers(-20, 400, J)        # lo >= hi: empty windows
    up = pos[np.clip(hi - 1, 0, R - 1)] + rng.integers(0, 300, J)
    tandem = rng.random(J) < 0.4
    dn = np.where(tandem, up - rng.integers(1, 400, J),
                  up + rng.integers(-3000, 3000, J))
    jun = {"lo": lo.astype(np.int64),
           "hi": np.clip(hi, 0, R).astype(np.int64),
           "beg": up - rng.integers(2000, 4000, J),
           "up_pos": up.astype(np.int64), "down_pos": dn.astype(np.int64),
           "down_tid": rng.integers(0, 2, J).astype(np.int32),
           "same_tid": tandem | (rng.random(J) < 0.3),
           "case_code": rng.integers(0, 3, J).astype(np.int32),
           "min_ins": rng.integers(100, 2000, J).astype(np.int64),
           "max_ins": rng.integers(2000, 6000, J).astype(np.int64)}
    jun["lo"][:8] = jun["hi"][:8] = 0                # padding rows
    return rec, jun


def discordant_args(rec, jun):
    """The columns in discordant_count_batch's argument order."""
    return ([rec[k] for k, _ in dc.REC_COLS], [jun[k] for k, _ in dc.JUN_COLS])
