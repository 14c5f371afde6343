"""Device-resident alignment front-end: seed -> candidate windows -> both
extension rounds, all on one torch device.

Counterpart of ``seeksv_tpu/ops/align_device.py``: the seed tables stay
on the device, the left/right query and target windows are gathered
there from the uploaded read matrix and the genome kept on the device,
the window entry of the extension kernel (``ops.extend.extend_batch``,
K1w) runs both rounds on them, and the bwa clip/extend decisions run
between and after the rounds as elementwise torch ops.  A chunk costs one
upload (the padded read matrix), one sync on the overflow flag, and one
download (the per-candidate score and coordinate scalars).  Every slot,
valid or not, goes to the kernel: an invalid slot has zero lengths and
leaves its block at once.

``device_align_auto_enabled`` reads the port's own
``align/device_align_calibration.json`` (written on the card by
``python -m seeksv_tpu_torch.scripts.calibrate_device_align``).
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..align.sw import MATCH, PEN_CLIP
from .extend import extend_batch
from .seed_device import TOP_CANDIDATES, TorchDeviceSeeder, \
    hit_cap_ladder, pad_reads


def device_align_auto_enabled() -> bool:
    """True only when the committed calibration
    (align/device_align_calibration.json of this package) measured a
    break-even of the device front-end against the host front-end
    (seeksv_tpu/ops/align_device.py:41)."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "align",
        "device_align_calibration.json")
    try:
        with open(path) as f:
            be = json.load(f).get("break_even")
        return isinstance(be, dict)
    except (OSError, ValueError):
        return False


def seed_and_gather(seeder: TorchDeviceSeeder, ref: torch.Tensor,
                    chrom_starts: torch.Tensor, mat: torch.Tensor,
                    lens: torch.Tensor, hit_cap: int, LT: int):
    """seeksv_tpu/ops/align_device.py:_seed_and_gather: seed every read and
    gather the left/right windows of every (job, slot) candidate.

    ref [G] uint8 codes, chrom_starts [n_chrom + 1] int64, mat [NP, LP]
    uint8, lens [NP] int64, all on the seeder's device.  Returns the four
    [J, LP|LT] uint8 windows (J = NP * 8; invalid slots have zero lengths),
    their int32 lengths, int32 h0, the int64 per-candidate ref_anchor, q0,
    q_end0, ref_end0, jlen, tid, the int32 per-job candidate counts and
    the overflow flag: 17 values, in the reference's order."""
    dev = mat.device
    i64 = torch.int64
    diag, qs, alen, _votes, n_cand, overflow = seeder.core(mat, lens,
                                                           hit_cap)
    C = TOP_CANDIDATES
    NP, LP = mat.shape
    J = NP * C
    ref_span = seeder.ref_span
    zero = torch.zeros((), dtype=i64, device=dev)
    job = torch.arange(J, dtype=i64, device=dev) // C
    slot = torch.arange(J, dtype=i64, device=dev) % C
    valid = slot < n_cand[job]
    d = diag.reshape(-1)
    q0 = torch.where(valid, qs.reshape(-1), zero)
    al = torch.where(valid, alen.reshape(-1), zero)
    jlen = torch.where(valid, lens[job], zero)
    ref_anchor = d + q0
    ra = ref_anchor.clamp(0, max(ref_span - 1, 0))
    tid = torch.searchsorted(chrom_starts, ra, right=True) - 1
    tid = tid.clamp(0, chrom_starts.shape[0] - 2)
    c_lo = chrom_starts[tid]
    c_hi = chrom_starts[tid + 1]
    h0 = (al * MATCH).to(torch.int32)
    jr = torch.arange(LP, dtype=i64, device=dev)[None, :]
    tr = torch.arange(LT, dtype=i64, device=dev)[None, :]
    four = torch.tensor(4, dtype=torch.uint8, device=dev)
    mat_flat = mat.reshape(-1)
    row_base = (job * LP)[:, None]

    # out-of-range positions are clamped as JAX's gathers clamp them; the
    # lengths mask them to code 4 afterwards
    def gather_q(idx, qlen):
        g = mat_flat[row_base + idx.clamp(0, LP - 1)]
        return torch.where(jr < qlen[:, None], g, four)

    def gather_t(idx, tlen):
        g = ref[idx.clamp(0, max(ref_span - 1, 0))]
        return torch.where(tr < tlen[:, None], g, four)

    # left: reversed read prefix vs reversed upstream reference
    lqlen = q0
    t_lo = torch.maximum(c_lo, ref_anchor - (q0 + 100))
    ltlen = torch.where(valid, (ref_anchor - t_lo).clamp(min=0), zero)
    lq = gather_q(q0[:, None] - 1 - jr, lqlen)
    lt = gather_t(ref_anchor[:, None] - 1 - tr, ltlen)
    # right: read suffix past the anchor vs downstream reference
    q_end0 = q0 + al
    rqlen = (jlen - q_end0).clamp(min=0)
    ref_end0 = ref_anchor + al
    t_hi = torch.minimum(c_hi, ref_end0 + rqlen + 100)
    rtlen = torch.where(valid, (t_hi - ref_end0).clamp(min=0), zero)
    rq = gather_q(q_end0[:, None] + jr, rqlen)
    rt = gather_t(ref_end0[:, None] + tr, rtlen)
    i32 = torch.int32
    return (lq, lqlen.to(i32), lt, ltlen.to(i32), rq, rqlen.to(i32), rt,
            rtlen.to(i32), h0, ref_anchor, q0, q_end0, ref_end0, jlen, tid,
            n_cand, overflow)


def left_decision(max_score, gscore, qle, tle, gtle, q0, ref_anchor):
    """bwa-mem clip/extend decision after the left round
    (align_device.py:_left_decision)."""
    ms = max_score.to(torch.int64)
    gs = gscore.to(torch.int64)
    use_g = (gs > 0) & (gs > ms - PEN_CLIP)
    qb = torch.where(use_g, torch.zeros_like(q0), q0 - qle.to(torch.int64))
    rb = ref_anchor - torch.where(use_g, gtle, tle).to(torch.int64)
    return qb, rb


def right_decision(max_score, gscore, qle, tle, gtle, q_end0, ref_end0,
                   jlen):
    """The same after the right round (align_device.py:_right_decision)."""
    ms = max_score.to(torch.int64)
    gs = gscore.to(torch.int64)
    use_g = (gs > 0) & (gs > ms - PEN_CLIP)
    qe = torch.where(use_g, jlen, q_end0 + qle.to(torch.int64))
    rend = ref_end0 + torch.where(use_g, gtle, tle).to(torch.int64)
    return ms, qe, rend


class TorchDeviceAligner:
    """The genome and the k-mer table on one torch device, and the whole
    seed-and-extend front-end over strand-expanded read batches
    (counterpart of seeksv_tpu/ops/align_device.py:DeviceAligner)."""

    # strand reads per device batch (the reference's: keeps the expected
    # hit count near hit_cap and the shape set small)
    CHUNK = 1024

    def __init__(self, idx, device, seeder: TorchDeviceSeeder = None):
        self.idx = idx
        self.device = torch.device(device)
        self.seeder = seeder or TorchDeviceSeeder.from_index(idx, device)
        # copies: the index's arrays may be read-only maps of its cache
        self.ref = torch.from_numpy(np.array(idx.ref, np.uint8)).to(
            self.device)
        self.chrom_starts = torch.from_numpy(
            np.array(idx.chrom_starts, np.int64)).to(self.device)

    def align_jobs(self, reads, hit_cap: int = 1 << 18,
                   max_hit_cap: int = 1 << 22):
        """reads: strand-expanded encoded uint8 code arrays.  Returns
        {job: [(final, tid, qb, qe, rb, rend), ...]} with candidates in the
        host path's (-votes, diag) order, or None when a chunk's hits
        exceed max_hit_cap even after the ladder (x4 per retry)."""
        n = len(reads)
        if n > self.CHUNK:
            out = {}
            for c0 in range(0, n, self.CHUNK):
                sub = self.align_jobs(reads[c0:c0 + self.CHUNK], hit_cap,
                                      max_hit_cap)
                if sub is None:
                    return None
                for k2, v in sub.items():
                    out[k2 + c0] = v
            return out
        return hit_cap_ladder(lambda cap: self._align_chunk(reads, cap),
                              hit_cap, max_hit_cap)

    def _align_chunk(self, reads, hit_cap: int):
        n = len(reads)
        if n == 0:
            return {}
        padded = pad_reads(reads, self.idx.k)
        if padded is None:
            return {i: [] for i in range(n)}
        mat, lens = self.seeder.upload(padded)
        LP = mat.shape[1]
        (lq, lql, lt, ltl, rq, rql, rt, rtl, h0, ref_anchor, q0, q_end0,
         ref_end0, jlen, tid, nc, ovf) = seed_and_gather(
            self.seeder, self.ref, self.chrom_starts, mat, lens, hit_cap,
            LP + 128)
        if bool(ovf):      # the chunk's one sync before its download
            return None
        left = extend_batch(lq, lql, lt, ltl, h0)
        qb, rb = left_decision(left["max_score"], left["gscore"],
                               left["qle"], left["tle"], left["gtle"], q0,
                               ref_anchor)
        right = extend_batch(rq, rql, rt, rtl, left["max_score"])
        final, qe, rend = right_decision(
            right["max_score"], right["gscore"], right["qle"],
            right["tle"], right["gtle"], q_end0, ref_end0, jlen)
        # the single device->host download of the chunk
        flat = torch.cat([torch.stack((final, tid, qb, qe, rb, rend))
                          .reshape(-1), nc.to(torch.int64)]).cpu().numpy()
        J = final.shape[0]
        cols = flat[:6 * J].reshape(6, J).T.tolist()
        nc = flat[6 * J:]
        C = TOP_CANDIDATES
        return {i: [tuple(cols[i * C + s]) for s in range(int(nc[i]))]
                for i in range(n)}
