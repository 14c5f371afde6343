"""Banded global alignment on the device for the finalize stage.

Counterpart of ``seeksv_tpu/ops/global_device.py``.  The winning
candidates' global tracebacks (long fragments, m and n > 256) run as
two cheap rungs of the host ladder on the device:

  rung 16  one banded DP pass (w = 16, K = 128 band columns) for every
           job: terminal score + one direction byte per cell; the host
           applies the ladder's sound band-sufficiency bound.
  rung 64  the same at w = 64 (K = 256) for jobs rung 16 did not accept.
           Acceptance order mirrors the host ladder: sound16, sound64,
           then the equal-adjacent-score rule emitting rung 16's walk.
  walk     the traceback from (m, n) to (0, 0) over the direction bytes,
           run-length encoded on the device (RUNS_CAP runs per job; more
           goes back to the host).  NM is computed on the host from the
           runs (io.native.nm_from_runs).

Direction bytes reproduce the C++ traceback's value comparisons (DM 1,
DE 2, DF 4, ERUN 8, FRUN 16), so score, CIGAR and NM equal the host
ladder's.  Band: j - i in [dlo, dhi], dlo = min(0, n-m) - w, band
column c = j - i - dlo.

Each kernel has its plain PyTorch version here; the wrappers
``banded_direction`` and ``traceback_rle`` run the CUDA kernels
(csrc/banded_dir.cu, csrc/traceback.cu) on CUDA tensors and the plain
versions on CPU tensors.  Unlike the reference's scan, the walk has no
step budget, so a walk always completes.
"""
from __future__ import annotations

import numpy as np
import torch

from .extend import _check

MATCH = 1
MISMATCH = 4
GAP_OPEN = 6
GAP_EXT = 1
AMBIG = -1
NEG_INF = -0x40000000   # deep negatives are compared for equality
RUNS_CAP = 64

_DM = 1      # h == diag(H[i-1,j-1] + sub)
_DE = 2      # h == E[i,j]
_DF = 4      # h == F[i,j]
_ERUN = 8    # E[i,j] == E[i,j-1] - ext  (and j-1 >= 1, in band)
_FRUN = 16   # F[i,j] == F[i-1,j] - ext  (and i > 1, in band)

LAUNCHES = {"banded_dir": 0, "traceback": 0}
PLAIN_CALLS = {"banded_dir": 0, "traceback": 0}

_OPCHR = np.array(["M", "I", "D"])


def build_t2(t: torch.Tensor, tlen: torch.Tensor, dlo: torch.Tensor,
             K: int, LQ: int) -> torch.Tensor:
    """[B, LQ+K] int32 dlo-shifted target panel: t2[b, y] = t[b, y+dlo[b]],
    code 4 out of range; band row i reads t2[:, i-1 : i-1+K]."""
    LT = t.shape[1]
    y = torch.arange(LQ + K, dtype=torch.int64, device=t.device)[None, :]
    idx = y + dlo.to(torch.int64)[:, None]
    valid = (idx >= 0) & (idx < tlen.to(torch.int64)[:, None]) & (idx < LT)
    vals = torch.gather(t.to(torch.int32), 1, idx.clamp(0, LT - 1))
    return torch.where(valid, vals, 4)


def banded_direction_plain(q, qlen, t2, dlo, n, K: int, LQ: int):
    """Plain banded DP over rows 1..LQ.  q [B, LQ] codes, t2 from
    build_t2, qlen/dlo/n [B].  Returns (score [B] int32, direction bytes
    [B, LQ, K] uint8 with row i-1 holding DP row i)."""
    dev = q.device
    B = q.shape[0]
    i32 = torch.int32
    q = q.to(i32)
    qlen = qlen.to(i32)
    t2 = t2.to(i32)
    dlo = dlo.to(i32)
    n = n.to(i32)
    neg = torch.tensor(NEG_INF, dtype=i32, device=dev)
    negcol = torch.full((B, 1), NEG_INF, dtype=i32, device=dev)
    c = torch.arange(K, dtype=i32, device=dev)[None, :]
    w = torch.clamp(n - qlen, max=0) - dlo
    in_band = c < ((n - qlen).abs() + 2 * w + 1)[:, None]
    c_end = (n - qlen) - dlo
    end_ok = (c_end >= 0) & (c_end < K)
    c_end_idx = c_end.clamp(0, K - 1).to(torch.int64)[:, None]
    j0 = dlo[:, None] + c
    h = torch.where(j0 == 0, torch.zeros_like(j0),
                    torch.where((j0 >= 1) & (j0 <= n[:, None]) & in_band,
                                -GAP_OPEN - j0 * GAP_EXT, neg))
    f = torch.full((B, K), NEG_INF, dtype=i32, device=dev)
    score = torch.where((qlen == 0) & (n == 0), torch.zeros_like(qlen), neg)
    dirs = torch.zeros((B, LQ, K), dtype=torch.uint8, device=dev)
    s_amb = torch.tensor(AMBIG, dtype=i32, device=dev)
    s_match = torch.tensor(MATCH, dtype=i32, device=dev)
    s_mis = torch.tensor(-MISMATCH, dtype=i32, device=dev)
    for i in range(1, LQ + 1):
        j = i + dlo[:, None] + c
        computed = (j >= 1) & (j <= n[:, None]) & in_band
        bnd = (j == 0) & in_band
        qi = q[:, i - 1:i]
        trow = t2[:, i - 1:i - 1 + K]
        sub = torch.where((qi > 3) | (trow > 3), s_amb,
                          torch.where(qi == trow, s_match, s_mis))
        diag = h + sub
        hup = torch.cat([h[:, 1:], negcol], dim=1)
        fup = torch.cat([f[:, 1:], negcol], dim=1)
        fv = torch.maximum(hup - GAP_OPEN, fup) - GAP_EXT
        g = torch.maximum(diag, fv)
        bval = torch.tensor(-GAP_OPEN - i * GAP_EXT, dtype=i32, device=dev)
        edge = torch.where(bnd, bval, neg)
        u = torch.where(computed, g + j * GAP_EXT, edge)
        m2 = torch.cat([negcol, torch.cummax(u, dim=1).values[:, :-1]],
                       dim=1)
        e = m2 - GAP_OPEN - j * GAP_EXT
        hn = torch.where(computed, torch.maximum(g, e), edge)
        fm = torch.where(computed, fv, edge)
        em = torch.where(computed, e, neg)
        eprev = torch.cat([negcol, em[:, :-1]], dim=1)
        d = ((computed & (hn == diag)).to(i32) * _DM
             + (computed & (hn == em)).to(i32) * _DE
             + ((computed & (hn == fm)) | bnd).to(i32) * _DF
             + (computed & (j - 1 >= 1)
                & (em == eprev - GAP_EXT)).to(i32) * _ERUN
             + ((computed | bnd) & (i > 1)
                & (fm == fup - GAP_EXT)).to(i32) * _FRUN)
        dirs[:, i - 1] = d.to(torch.uint8)
        sc_here = torch.where(end_ok, torch.gather(hn, 1, c_end_idx)[:, 0],
                              neg)
        score = torch.where(qlen == i, sc_here, score)
        h, f = hn, fm
    return score, dirs


def unpack_reference_dirs(dirs_packed: np.ndarray, B: int, LQ: int,
                          K: int) -> np.ndarray:
    """The reference Pallas kernel's packed words [(LQ/4)*K, Bp] int32
    (row i, column c at word ((i-1)//4)*K + c, byte (i-1) % 4) ->
    [B, LQ, K] uint8 in this module's layout."""
    words = np.asarray(dirs_packed).astype(np.uint32)[:, :B]
    words = words.reshape(LQ // 4, K, B)
    byts = np.stack([(words >> (8 * r)) & 0xFF for r in range(4)], axis=1)
    return byts.reshape(LQ, K, B).transpose(2, 0, 1).astype(np.uint8)


def traceback_rle_plain(dirs: torch.Tensor, qlen: torch.Tensor,
                        n: torch.Tensor, dlo: torch.Tensor):
    """Plain walk over dirs [B, LQ, K] from (qlen, n) to (0, 0) for every
    job at once, runs encoded as they are emitted.  Returns (runs_len,
    runs_op [B, RUNS_CAP] int32 with op 0 M / 1 I / 2 D and zeros past
    the last run, n_runs [B] int32, RUNS_CAP + 1 on overflow with the
    runs zeroed).  No step budget: every step lowers i + j."""
    dev = dirs.device
    B, LQ, K = dirs.shape
    i32 = torch.int32
    i = qlen.to(torch.int64).clone()
    j = n.to(torch.int64).clone()
    dlo = dlo.to(torch.int64)
    bidx = torch.arange(B, device=dev)
    mode = torch.zeros(B, dtype=i32, device=dev)
    rl = torch.zeros((B, RUNS_CAP), dtype=i32, device=dev)
    ro = torch.zeros((B, RUNS_CAP), dtype=i32, device=dev)
    nr = torch.zeros(B, dtype=torch.int64, device=dev)
    cur_op = torch.full((B,), -1, dtype=i32, device=dev)
    cur_len = torch.zeros(B, dtype=i32, device=dev)
    over = torch.zeros(B, dtype=torch.bool, device=dev)
    zero = torch.zeros((), dtype=i32, device=dev)

    def push(rows):
        full = rows & (nr == RUNS_CAP)
        over.logical_or_(full)
        ok = rows & ~full
        r = ok.nonzero()[:, 0]
        rl[r, nr[r]] = cur_len[r]
        ro[r, nr[r]] = cur_op[r]
        nr.add_(ok.to(torch.int64))

    while True:
        live = ((i > 0) | (j > 0)) & ~over
        if not bool(live.any()):
            break
        c = j - i - dlo
        ok = (i >= 1) & (c >= 0) & (c < K)
        d = dirs[bidx, (i - 1).clamp(0, LQ - 1), c.clamp(0, K - 1)].to(i32)
        d = torch.where(ok, d, zero)
        ipos = i > 0
        jpos = j > 0
        op_h = torch.where(
            ipos & jpos & ((d & _DM) != 0), 0,
            torch.where(jpos & ((d & _DE) != 0), 2,
                        torch.where(ipos & ((d & _DF) != 0), 1,
                                    torch.where(ipos & jpos, 0,
                                                torch.where(jpos, 2, 1)))))
        op = torch.where(mode == 1, 2,
                         torch.where(mode == 2, 1, op_h)).to(i32)
        from_h = mode == 0
        nmode = torch.where(
            (op == 2) & ((d & _ERUN) != 0) & ((mode == 1) | from_h), 1,
            torch.where((op == 1) & ((d & _FRUN) != 0)
                        & ((mode == 2) | from_h), 2, 0)).to(i32)
        mode = torch.where(live, nmode, mode)
        i = torch.where(live & (op != 2), i - 1, i)
        j = torch.where(live & (op != 1), j - 1, j)
        new = live & (op != cur_op)
        push(new & (cur_op >= 0))
        cur_len = torch.where(new, torch.ones_like(cur_len),
                              torch.where(live, cur_len + 1, cur_len))
        cur_op = torch.where(new, op, cur_op)
    push((cur_op >= 0) & ~over)
    over = over | (i != 0) | (j != 0)
    k = torch.arange(RUNS_CAP, device=dev)[None, :]
    keep = (k < nr[:, None]) & ~over[:, None]
    src = (nr[:, None] - 1 - k).clamp(min=0)
    runs_len = torch.where(keep, torch.gather(rl, 1, src), zero)
    runs_op = torch.where(keep, torch.gather(ro, 1, src), zero)
    n_runs = torch.where(over, RUNS_CAP + 1, nr).to(i32)
    return runs_len, runs_op, n_runs


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def banded_direction(q: torch.Tensor, qlen: torch.Tensor, t: torch.Tensor,
                     dlo: torch.Tensor, n: torch.Tensor, K: int):
    """Banded DP pass: q [B, LQ] / t [B, LT] uint8 codes, qlen, dlo, n
    [B] int32 (n is the target length).  Returns (score [B] int32,
    dirs [B, LQ, K] uint8).  Direction rows past a job's qlen are
    unspecified on the card (the kernel stops at row qlen).

    CUDA tensors launch csrc/banded_dir.cu; CPU tensors run build_t2 +
    banded_direction_plain."""
    dev = q.device
    B, LQ = q.shape
    LT = t.shape[1]
    if K not in (128, 256):
        raise ValueError(f"band width K={K} not in (128, 256)")
    _check("q", q, torch.uint8, (B, LQ), dev)
    _check("t", t, torch.uint8, (B, LT), dev)
    for name, x in (("qlen", qlen), ("dlo", dlo), ("n", n)):
        _check(name, x, torch.int32, (B,), dev)
    if dev.type == "cpu":
        PLAIN_CALLS["banded_dir"] += 1
        return banded_direction_plain(q, qlen, build_t2(t, n, dlo, K, LQ),
                                      dlo, n, K, LQ)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    from .. import _build
    lib = _build.lib()
    score = torch.empty(B, dtype=torch.int32, device=dev)
    dirs = torch.empty((B, LQ, K), dtype=torch.uint8, device=dev)
    if B == 0:
        return score, dirs
    rc = lib.seeksv_banded_dir(q.data_ptr(), t.data_ptr(), dlo.data_ptr(),
                               qlen.data_ptr(), n.data_ptr(), B, LQ, LT, K,
                               score.data_ptr(), dirs.data_ptr(),
                               _stream(dev))
    _build.check(rc, "seeksv_banded_dir")
    LAUNCHES["banded_dir"] += 1
    return score, dirs


def traceback_rle(dirs: torch.Tensor, qlen: torch.Tensor, n: torch.Tensor,
                  dlo: torch.Tensor):
    """Walk + run-length encoding over dirs [B, LQ, K] uint8 from
    (qlen, n) per job (0, 0 walks nothing).  Returns (runs_len, runs_op
    [B, RUNS_CAP] int32, n_runs [B] int32; RUNS_CAP + 1 = overflow).

    CUDA tensors launch csrc/traceback.cu; CPU tensors run
    traceback_rle_plain."""
    dev = dirs.device
    B, LQ, K = dirs.shape
    if K not in (128, 256):
        raise ValueError(f"band width K={K} not in (128, 256)")
    _check("dirs", dirs, torch.uint8, (B, LQ, K), dev)
    for name, x in (("qlen", qlen), ("n", n), ("dlo", dlo)):
        _check(name, x, torch.int32, (B,), dev)
    if dev.type == "cpu":
        PLAIN_CALLS["traceback"] += 1
        return traceback_rle_plain(dirs, qlen, n, dlo)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    from .. import _build
    lib = _build.lib()
    runs_len = torch.empty((B, RUNS_CAP), dtype=torch.int32, device=dev)
    runs_op = torch.empty((B, RUNS_CAP), dtype=torch.int32, device=dev)
    n_runs = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return runs_len, runs_op, n_runs
    rc = lib.seeksv_traceback(dirs.data_ptr(), qlen.data_ptr(), n.data_ptr(),
                              dlo.data_ptr(), B, LQ, K, runs_len.data_ptr(),
                              runs_op.data_ptr(), n_runs.data_ptr(),
                              _stream(dev))
    _build.check(rc, "seeksv_traceback")
    LAUNCHES["traceback"] += 1
    return runs_len, runs_op, n_runs


class TorchDeviceGlobalAligner:
    """Batched device finalize over the two cheap rungs; the host decides
    acceptance from the rung scores with the ladder's rules, and every
    job the device declines stays with the native host ladder."""

    # (w, K) rungs; |n - m| must fit K - 2w - 1 for every rung
    RUNGS = ((16, 128), (64, 256))
    LQ_BUCKETS = (512, 1024, 1536, 2048)

    def __init__(self, device="cuda", max_dir_bytes: int = 1 << 30):
        self.device = torch.device(device)
        # per-chunk cap on the direction bytes of the widest rung
        self.max_dir_bytes = max_dir_bytes

    @staticmethod
    def _bucket(v, menu):
        for b in menu:
            if v <= b:
                return b
        return None

    def eligible(self, m: int, n: int) -> bool:
        """Long fragments only (m, n > 256), a diagonal offset every
        rung's band holds, and lengths inside the bucket menu."""
        if not (m > 256 and n > 256):
            return False
        if abs(n - m) > min(K - 2 * w - 1 for w, K in self.RUNGS):
            return False
        return (self._bucket(m, self.LQ_BUCKETS) is not None
                and self._bucket(n, self.LQ_BUCKETS) is not None)

    @staticmethod
    def _sound_ceiling(mn, ad, w):
        return (MATCH * (mn - (w + 1)) - 2 * GAP_OPEN
                - (ad + 2 * (w + 1)) * GAP_EXT)

    def align_batch(self, qs, ts):
        """qs/ts: lists of code arrays.  Returns {job index: (score,
        [(len, op), ...], nm)} for the jobs completed on the device;
        missing indices are the host's (ladder past rung 64, more than
        RUNS_CAP runs, or ineligible shapes)."""
        idxs = [i for i, (q, t) in enumerate(zip(qs, ts))
                if self.eligible(len(q), len(t))]
        if not idxs:
            return {}
        ms = np.asarray([len(qs[i]) for i in idxs], np.int32)
        ns = np.asarray([len(ts[i]) for i in idxs], np.int32)
        LQ = self._bucket(int(ms.max()), self.LQ_BUCKETS)
        LT = self._bucket(int(ns.max()), self.LQ_BUCKETS)
        B = len(idxs)
        q = np.full((B, LQ), 4, np.uint8)
        t = np.full((B, LT), 4, np.uint8)
        for r, i in enumerate(idxs):
            q[r, :ms[r]] = qs[i]
            t[r, :ns[r]] = ts[i]
        out = {}
        chunk = max(128, self.max_dir_bytes // (LQ * self.RUNGS[-1][1]))
        for c0 in range(0, B, chunk):
            c1 = min(B, c0 + chunk)
            self._chunk(q[c0:c1], t[c0:c1], ms[c0:c1], ns[c0:c1],
                        idxs[c0:c1], out)
        return out

    def _chunk(self, q, t, ms, ns, idxs, out):
        dev = self.device

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        qd, td, md, nd = put(q), put(t), put(ms), put(ns)
        mn = np.minimum(ms, ns)
        ad = np.abs(ns - ms)
        B = len(idxs)

        def run_dir(w, K):
            dl = put((np.minimum(0, ns - ms) - w).astype(np.int32))
            score, dirs = banded_direction(qd, md, td, dl, nd, K)
            return score.cpu().numpy(), dirs, dl

        accepted = []      # (out index, row, score, cigar) pending NM

        def run_tb(dirs, dl, accept, score_arr):
            mm = put(np.where(accept, ms, 0).astype(np.int32))
            nn = put(np.where(accept, ns, 0).astype(np.int32))
            rl, ro, nr = (x.cpu().numpy()
                          for x in traceback_rle(dirs, mm, nn, dl))
            for rr in np.nonzero(accept)[0]:
                k = int(nr[rr])
                if k == 0 or k > RUNS_CAP:
                    continue              # overflow -> host
                cigar = [(int(rl[rr, x]), _OPCHR[int(ro[rr, x])])
                         for x in range(k)]
                accepted.append((idxs[rr], rr, int(score_arr[rr]), cigar))

        # the host ladder's check order: sound16, sound64, then the
        # equal-adjacent rule -> rung 16's walk
        (w16, K16), (w64, K64) = self.RUNGS
        sc16, dirs16, dl16 = run_dir(w16, K16)
        sound16 = sc16 >= self._sound_ceiling(mn, ad, w16)
        need64 = ~sound16
        sound64 = np.zeros(B, bool)
        equal = np.zeros(B, bool)
        if need64.any():
            sc64, dirs64, dl64 = run_dir(w64, K64)
            sound64 = need64 & (sc64 >= self._sound_ceiling(mn, ad, w64))
            equal = need64 & ~sound64 & (sc16 == sc64)
        acc16 = sound16 | equal
        if acc16.any():
            run_tb(dirs16, dl16, acc16, sc16)
        if sound64.any():
            run_tb(dirs64, dl64, sound64, sc64)
        if not accepted:
            return
        from ..io import native
        a_q = [q[rr, :ms[rr]] for _oi, rr, _sc, _cg in accepted]
        a_t = [t[rr, :ns[rr]] for _oi, rr, _sc, _cg in accepted]
        a_runs = [cg for _oi, _rr, _sc, cg in accepted]
        if not native.nm_from_runs_available():
            raise RuntimeError("NM of the device walks needs the native host "
                               f"library: {native.LOAD_ERROR}")
        nms = native.nm_from_runs(a_q, a_t, a_runs)
        for (oi, _rr, sc, cg), nmv in zip(accepted, nms):
            out[oi] = (sc, cg, int(nmv))
