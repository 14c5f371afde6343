"""Affine-gap DP primitives for seed-and-extend alignment.

Structured like the production seed-extend aligners the reference pipeline
outsources to bwa (README.md:22-34): an *extension* kernel that only needs
scores (hot path, batched — see ops/extend.py for the device form) and a small
banded *global* aligner with traceback used once per chosen alignment to
emit the CIGAR.  Default scoring matches bwa-mem 0.7.x defaults:
match 1, mismatch 4, gapopen 6, gapextend 1, 5'/3' clip penalty 5,
ambiguous-base score -1.  Counterpart of seeksv_tpu/align/sw.py.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

MATCH = 1
MISMATCH = 4
GAP_OPEN = 6
GAP_EXT = 1
PEN_CLIP = 5
AMBIG = -1
NEG_INF = -0x40000000


def _score(a: int, b: int) -> int:
    if a > 3 or b > 3:
        return AMBIG
    return MATCH if a == b else -MISMATCH


@dataclass
class ExtendResult:
    max_score: int   # best local score (anchored at origin)
    qle: int         # query extent of the local best
    tle: int         # target extent of the local best
    gscore: int      # best score consuming the full query
    gtle: int        # target extent of that to-query-end best


def extend_score(query: np.ndarray, target: np.ndarray, h0: int,
                 w: int = 100, zdrop: int = 100) -> ExtendResult:
    """ksw_extend-style one-sided extension from an anchored seed with
    initial score h0.  Only scores/extents, no traceback."""
    qlen, tlen = len(query), len(target)
    if qlen == 0:
        return ExtendResult(h0, 0, 0, h0, 0)
    # H over query axis; iterate target rows
    h = np.full(qlen + 1, NEG_INF, np.int64)
    e = np.full(qlen + 1, NEG_INF, np.int64)
    h[0] = h0
    for j in range(1, qlen + 1):
        v = h0 - GAP_OPEN - j * GAP_EXT
        if v < 0:
            break
        h[j] = v
    best = h0
    qle = tle = 0
    gscore = NEG_INF
    gtle = 0
    qarr = query.astype(np.int64)
    q_ambig = qarr > 3
    jext = np.arange(1, qlen + 1, dtype=np.int64) * GAP_EXT
    for i in range(1, tlen + 1):
        t = int(target[i - 1])
        if t > 3:
            sub = np.full(qlen, AMBIG, np.int64)
        else:
            sub = np.where(q_ambig, AMBIG,
                           np.where(qarr == t, MATCH, -MISMATCH))
        diag = h[:-1] + sub
        h0_col = h0 - GAP_OPEN - i * GAP_EXT
        ecand = np.maximum(h - GAP_OPEN, e) - GAP_EXT  # target-gap (col-wise)
        g = np.maximum(diag, ecand[1:])
        # exact row-gap recurrence via prefix max (gap reopening from an
        # F-sourced cell is never optimal with GAP_OPEN > 0):
        #   f_j = max_{1<=k<j} (g_k - GAP_OPEN - (j-k) * GAP_EXT)
        u = g + jext
        pref = np.empty(qlen, np.int64)
        pref[0] = NEG_INF
        np.maximum.accumulate(u[:-1], out=pref[1:])
        f = pref - GAP_OPEN - jext
        new_h = np.empty(qlen + 1, np.int64)
        new_h[0] = h0_col
        np.maximum(g, f, out=new_h[1:])
        new_e = np.empty(qlen + 1, np.int64)
        new_e[0] = NEG_INF
        new_e[1:] = ecand[1:]
        h, e = new_h, new_e
        amax = int(h[1:].argmax())
        row_best = int(h[1 + amax])
        if row_best > best:
            best = row_best
            qle = amax + 1
            tle = i
        if h[qlen] > gscore:
            gscore = int(h[qlen])
            gtle = i
        if row_best < best - zdrop:
            break
    return ExtendResult(int(best), qle, tle, int(gscore), gtle)


def extend_batch_np(q: np.ndarray, qlen: np.ndarray, t: np.ndarray,
                    tlen: np.ndarray, h0: np.ndarray, zdrop: int = 100):
    """Vectorized-over-jobs extension scoring (numpy mirror of the
    device kernels in ops/extend.py; same results as per-job extend_score).  Used as
    the host path of BatchAligner — one [B, LQ] matrix op per target
    column instead of per-job python loops."""
    B, LQ = q.shape
    LT = t.shape[1]
    qlen = qlen.astype(np.int64)
    tlen = tlen.astype(np.int64)
    h0 = h0.astype(np.int64)
    jidx = np.arange(1, LQ + 1, dtype=np.int64)[None, :]
    valid_q = jidx <= qlen[:, None]
    row0 = h0[:, None] - GAP_OPEN - jidx * GAP_EXT
    h = np.where((row0 >= 0) & valid_q, row0, NEG_INF)
    h_first = h0.copy()
    e = np.full((B, LQ), NEG_INF, np.int64)
    best = h0.copy()
    qle = np.zeros(B, np.int64)
    tle = np.zeros(B, np.int64)
    gscore = np.full(B, NEG_INF, np.int64)
    gtle = np.zeros(B, np.int64)
    dead = np.zeros(B, bool)
    at_qlen = jidx == qlen[:, None]
    qlen_zero = qlen == 0
    q_ambig = q > 3
    bidx = np.arange(B)
    for i in range(min(LT, int(tlen.max(initial=0)))):
        active = (i < tlen) & ~dead
        if not active.any():
            break
        tcol = t[:, i][:, None]
        sub = np.where(q_ambig | (tcol > 3), AMBIG,
                       np.where(q == tcol, MATCH, -MISMATCH))
        diag = np.concatenate([h_first[:, None], h[:, :-1]], axis=1) + sub
        ecand = np.maximum(h - GAP_OPEN, e) - GAP_EXT
        g = np.maximum(diag, ecand)
        h0_col = h0 - GAP_OPEN - (i + 1) * GAP_EXT
        u = g + jidx * GAP_EXT
        pref = np.concatenate(
            [np.full((B, 1), NEG_INF, np.int64),
             np.maximum.accumulate(u, axis=1)[:, :-1]], axis=1)
        f = pref - GAP_OPEN - jidx * GAP_EXT
        h_row = np.where(valid_q, np.maximum(g, f), NEG_INF)
        amax = h_row.argmax(axis=1)
        row_best = h_row[bidx, amax]
        improved = active & (row_best > best)
        best = np.where(improved, row_best, best)
        qle = np.where(improved, amax + 1, qle)
        tle = np.where(improved, i + 1, tle)
        h_at_qlen = np.where(
            qlen_zero, h0_col,
            np.where(at_qlen, h_row, NEG_INF).max(axis=1))
        gimp = active & (h_at_qlen > gscore)
        gscore = np.where(gimp, h_at_qlen, gscore)
        gtle = np.where(gimp, i + 1, gtle)
        dead |= active & (row_best < best - zdrop)
        h_first = np.where(active, h0_col, h_first)
        h = np.where(active[:, None], h_row, h)
        e = np.where(active[:, None], np.where(valid_q, ecand, NEG_INF), e)
    return {"max_score": best, "qle": qle, "tle": tle,
            "gscore": gscore, "gtle": gtle}


def global_align(query: np.ndarray, target: np.ndarray,
                 w: int = 100) -> Tuple[int, List[Tuple[int, str]]]:
    """Banded affine global alignment with traceback -> (score, cigar).
    Used only on the chosen extents (ksw_global role in bwa).  Dispatches
    to the native kernel (csrc) when built; global_align_np is the oracle
    (equivalence asserted by tests/test_native.py)."""
    m, n = len(query), len(target)
    if m == 0 and n == 0:
        return 0, []
    if m == 0:
        return -GAP_OPEN - n * GAP_EXT, [(n, "D")]
    if n == 0:
        return -GAP_OPEN - m * GAP_EXT, [(m, "I")]
    from ..io import native
    if native.available():
        return native.sw_global_native(query, target)
    return global_align_np(query, target, w)


def _global_banded_np(query: np.ndarray, target: np.ndarray,
                      w: int) -> Tuple[int, List[Tuple[int, str]]]:
    """One banded rung (path constraint j-i in [dlo, dhi]); exact mirror
    of csrc sw_global_banded — banded addressing col = j-i-dlo keeps the
    diagonal move in the same column."""
    m, n = len(query), len(target)
    dlo = min(0, n - m) - w
    dhi = max(0, n - m) + w
    K = dhi - dlo + 1
    H = np.full((m + 1, K), NEG_INF, np.int64)
    E = np.full((m + 1, K), NEG_INF, np.int64)
    F = np.full((m + 1, K), NEG_INF, np.int64)
    H[0, -dlo] = 0
    jtop = min(n, dhi)
    if jtop >= 1:
        j0 = np.arange(1, jtop + 1, dtype=np.int64)
        H[0, j0 - dlo] = E[0, j0 - dlo] = -GAP_OPEN - j0 * GAP_EXT
    tarr = target.astype(np.int64)
    t_ambig = tarr > 3
    for i in range(1, m + 1):
        jlo = max(1, i + dlo)
        jhi = min(n, i + dhi)
        m2 = NEG_INF
        if i + dlo <= 0:   # boundary column j=0 inside the band
            b = -GAP_OPEN - i * GAP_EXT
            H[i, -i - dlo] = b
            F[i, -i - dlo] = b
            m2 = b
        if jlo > jhi:
            continue
        js = np.arange(jlo, jhi + 1, dtype=np.int64)
        cols = js - i - dlo
        qi = int(query[i - 1])
        if qi > 3:
            sub = np.full(len(js), AMBIG, np.int64)
        else:
            tj = tarr[js - 1]
            sub = np.where(t_ambig[js - 1], AMBIG,
                           np.where(tj == qi, MATCH, -MISMATCH))
        hp = np.full(len(js), NEG_INF, np.int64)
        fp = np.full(len(js), NEG_INF, np.int64)
        up_ok = cols + 1 <= K - 1     # (i-1, j) in band
        hp[up_ok] = H[i - 1, cols[up_ok] + 1]
        fp[up_ok] = F[i - 1, cols[up_ok] + 1]
        Frow = np.maximum(hp - GAP_OPEN, fp) - GAP_EXT
        dg = H[i - 1, cols] + sub     # (i-1, j-1): same column
        g = np.maximum(dg, Frow)
        u = g + js * GAP_EXT
        pref = np.maximum.accumulate(
            np.concatenate(([np.int64(m2)], u[:-1])))
        Erow = pref - GAP_OPEN - js * GAP_EXT
        E[i, cols] = Erow
        F[i, cols] = Frow
        H[i, cols] = np.maximum(g, Erow)

    def hv(i, j, M):
        d = j - i
        if j < 0 or j > n or d < dlo or d > dhi:
            return NEG_INF
        return int(M[i, j - i - dlo])

    score = hv(m, n, H)
    cig: List[Tuple[int, str]] = []
    i, j = m, n

    def push(op):
        if cig and cig[-1][1] == op:
            cig[-1] = (cig[-1][0] + 1, op)
        else:
            cig.append((1, op))

    while i > 0 or j > 0:
        h = hv(i, j, H)
        if i > 0 and j > 0 and h == hv(i - 1, j - 1, H) + _score(
                int(query[i - 1]), int(target[j - 1])):
            push("M")
            i -= 1
            j -= 1
        elif j > 0 and h == hv(i, j, E):
            push("D")
            while j > 1 and hv(i, j, E) == hv(i, j - 1, E) - GAP_EXT:
                push("D")
                j -= 1
            j -= 1
        elif i > 0 and h == hv(i, j, F):
            push("I")
            while i > 1 and hv(i, j, F) == hv(i - 1, j, F) - GAP_EXT:
                push("I")
                i -= 1
            i -= 1
        elif i > 0 and j > 0:
            push("M")
            i -= 1
            j -= 1
        elif j > 0:
            push("D")
            j -= 1
        else:
            push("I")
            i -= 1
    cig.reverse()
    return score, cig


def global_align_np(query: np.ndarray, target: np.ndarray,
                    w: int = 100) -> Tuple[int, List[Tuple[int, str]]]:
    """Pure-numpy reference implementation of global_align.

    Long pairs (min(m, n) > 256 — only the long-fragment regime) run the
    banded LADDER spec (rungs 16/64/256), identical to csrc
    seeksv_sw_global; equivalence asserted by tests/test_native.py.
    A rung is accepted when either (a) SOUND band-sufficiency holds —
    any path leaving band w has >= 2 gap runs totalling >= |n-m|+2(w+1)
    gap columns and at most min(m,n)-(w+1) diagonal columns, so a
    banded score >= MATCH*(min(m,n)-(w+1)) - 2*GAP_OPEN -
    (|n-m|+2(w+1))*GAP_EXT is the global optimum score — or (b) the
    HEURISTIC: two adjacent rungs report equal scores (smaller rung's
    traceback emitted; equal constrained optima do not prove band
    sufficiency, so (b) can emit a suboptimal score/CIGAR — documented
    fallback for the high-divergence regime).  Else full
    DP."""
    m, n = len(query), len(target)
    if m == 0 and n == 0:
        return 0, []
    if m == 0:
        return -GAP_OPEN - n * GAP_EXT, [(n, "D")]
    if n == 0:
        return -GAP_OPEN - m * GAP_EXT, [(m, "I")]
    if m > 256 and n > 256:
        mn, ad = min(m, n), abs(m - n)
        prev = None
        for rung in (16, 64, 256):
            cur = _global_banded_np(query, target, rung)
            ceiling = (MATCH * (mn - (rung + 1)) - 2 * GAP_OPEN
                       - (ad + 2 * (rung + 1)) * GAP_EXT)
            if cur[0] >= ceiling:          # sound acceptance (a)
                return cur
            if prev is not None and cur[0] == prev[0]:
                return prev                # heuristic acceptance (b)
            prev = cur
    H = np.full((m + 1, n + 1), NEG_INF, np.int64)
    E = np.full((m + 1, n + 1), NEG_INF, np.int64)  # gap in query (D: target consumed)
    F = np.full((m + 1, n + 1), NEG_INF, np.int64)  # gap in target (I: query consumed)
    H[0, 0] = 0
    H[0, 1:] = -GAP_OPEN - np.arange(1, n + 1, dtype=np.int64) * GAP_EXT
    E[0, 1:] = H[0, 1:]
    H[1:, 0] = -GAP_OPEN - np.arange(1, m + 1, dtype=np.int64) * GAP_EXT
    F[1:, 0] = H[1:, 0]
    tarr = target.astype(np.int64)
    t_ambig = tarr > 3
    jext = np.arange(1, n + 1, dtype=np.int64) * GAP_EXT
    for i in range(1, m + 1):
        qi = int(query[i - 1])
        if qi > 3:
            sub = np.full(n, AMBIG, np.int64)
        else:
            sub = np.where(t_ambig, AMBIG,
                           np.where(tarr == qi, MATCH, -MISMATCH))
        F[i, 1:] = np.maximum(H[i - 1, 1:] - GAP_OPEN, F[i - 1, 1:]) - GAP_EXT
        diag = H[i - 1, :-1] + sub
        g = np.maximum(diag, F[i, 1:])
        # exact row-gap recurrence via prefix max (same argument as in
        # extend_score; the j=0 border cell participates as g'_0)
        u = np.concatenate(([H[i, 0]], g[:-1] + jext[:-1]))
        E[i, 1:] = np.maximum.accumulate(u) - GAP_OPEN - jext
        H[i, 1:] = np.maximum(g, E[i, 1:])
    # traceback
    cig: List[Tuple[int, str]] = []
    i, j = m, n

    def push(op):
        if cig and cig[-1][1] == op:
            cig[-1] = (cig[-1][0] + 1, op)
        else:
            cig.append((1, op))

    while i > 0 or j > 0:
        if i > 0 and j > 0 and H[i, j] == H[i - 1, j - 1] + _score(int(query[i - 1]), int(target[j - 1])):
            push("M")
            i -= 1
            j -= 1
        elif j > 0 and H[i, j] == E[i, j]:
            # walk the E (target-gap) run
            push("D")
            while j > 1 and E[i, j] == E[i, j - 1] - GAP_EXT:
                push("D")
                j -= 1
            j -= 1
        elif i > 0 and H[i, j] == F[i, j]:
            push("I")
            while i > 1 and F[i, j] == F[i - 1, j] - GAP_EXT:
                push("I")
                i -= 1
            i -= 1
        elif i > 0 and j > 0:
            push("M")
            i -= 1
            j -= 1
        elif j > 0:
            push("D")
            j -= 1
        else:
            push("I")
            i -= 1
    cig.reverse()
    return int(H[m, n]), cig
