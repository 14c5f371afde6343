"""The plain reference that decides ``correct``.

It reads the dataset the benchmark built (fasta, truth) and the outputs
the timed passes wrote, and imports nothing of the program.  Two layers
are judged:

- the realignment (``.clip.sam``, the card's K1 extension and K2/K3
  finalize).  Its input is worked out again from ``.clip.gz``: every
  row's clipped sequence is one query, named by itself.  Each query
  has to have one primary record (``clip_sam_unmatched`` counts the
  queries without one and the records without a query).  A sample of
  the queries drawn from the seed, with the longest in it, is realigned
  by a plain affine-gap Smith-Waterman in PyTorch (match 1, mismatch 4,
  gap 6 + 1 a base, the scoring the configuration states) over
  candidate loci that a plain exact k-mer search finds, plus the locus
  the record names.  The score of the record's own CIGAR at its
  position is worked out from the fasta.  ``aln_score_lost_pct`` is the
  share of the best scores that the records miss, over the queries
  whose best reaches SCORE_T: 0 for optimal alignments; a query with no
  record, or unmapped where it has an alignment, loses all of it, and a
  record scores at least 0.
- the pipeline's outputs, against the simulation's truth: DEL and virus
  junction recall of ``.sv`` (a call matches when both breakends lie
  within 50 bp), the share of simulated breakends that have a
  ``.clip.gz`` row within 50 bp and the share of rows that lie within
  50 bp of a simulated breakend, and for a pair the somatic deletions
  found in ``.somatic.sv`` and the germline ones leaked into it.

The control runs the same aligner in saturating arithmetic one integer
type narrower than the configuration's scores need, and takes the exact
score at the cell each query's narrow best puts first.
"""
from __future__ import annotations

import gzip
import json
from collections import Counter

import numpy as np
import torch

MATCH, MISMATCH, GAP_OPEN, GAP_EXT = 1, 4, 6, 1
SCORE_T = 30
K = 16
MAX_OCC = 16
CANDIDATES = 2
SAMPLE = 256
LONGEST = 32
WINDOW_PAD = 48
NEAR = 50

_CODE = np.full(256, 4, np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _CODE[_c] = _i
    _CODE[_c + 32] = _i
_RC = np.array([3, 2, 1, 0, 4], np.uint8)


class Genome:
    """The fasta as base codes (A C G T = 0-3, others 4), contigs laid
    end to end."""

    def __init__(self, path: str):
        names, parts = [], []
        with open(path, "rb") as f:
            cur = []
            for line in f:
                if line.startswith(b">"):
                    if names:
                        parts.append(b"".join(cur))
                    names.append(line[1:].split()[0].decode())
                    cur = []
                else:
                    cur.append(line.strip())
            if names:
                parts.append(b"".join(cur))
        self.names = names
        self.lens = np.array([len(p) for p in parts], np.int64)
        self.starts = np.concatenate([[0], np.cumsum(self.lens)])
        self.codes = _CODE[np.frombuffer(b"".join(parts), np.uint8)]
        self.tid = {n: i for i, n in enumerate(names)}


def kmer_table(g: Genome, dev) -> tuple:
    """(sorted keys, their positions) of every k-mer that lies inside
    one contig and holds no ambiguous base."""
    c = torch.from_numpy(g.codes).to(dev)
    n = c.numel() - K + 1
    if n <= 0:
        z = torch.zeros(0, dtype=torch.int64, device=dev)
        return z, z
    key = torch.zeros(n, dtype=torch.int64, device=dev)
    bad = torch.zeros(n, dtype=torch.bool, device=dev)
    for i in range(K):
        ci = c[i:i + n].to(torch.int64)
        key = key * 4 + ci.clamp(max=3)
        bad |= ci > 3
    pos = torch.arange(n, device=dev)
    ends = torch.from_numpy(g.starts[1:]).to(dev)
    bad |= torch.bucketize(pos, ends, right=True) != torch.bucketize(
        pos + K - 1, ends, right=True)
    key, pos = key[~bad], pos[~bad]
    key, order = torch.sort(key)
    return key, pos[order]


def read_sam(path: str) -> list:
    """Primary records of a SAM file as dicts (qname, flag, rname, pos
    0-based, cigar, seq)."""
    out = []
    with open(path) as f:
        for line in f:
            if line.startswith("@"):
                continue
            fl = line.rstrip("\n").split("\t")
            flag = int(fl[1])
            if flag & 0x900:
                continue
            out.append({"qname": fl[0], "flag": flag, "rname": fl[2],
                        "pos": int(fl[3]) - 1, "cigar": fl[5],
                        "seq": fl[9]})
    return out


def _cigar_ops(cigar: str) -> list:
    ops, n = [], 0
    for ch in cigar:
        if ch.isdigit():
            n = n * 10 + ord(ch) - 48
        else:
            ops.append((n, ch))
            n = 0
    return ops


def path_score(g: Genome, rec: dict):
    """(score, genome offset of the aligned span's start, span) of a
    record's own alignment, or (0, None, 0) where it is unmapped or
    says something impossible (a query other than its name, a span off
    its contig, an unknown operation)."""
    if rec["flag"] & 4 or rec["cigar"] == "*" or rec["rname"] not in g.tid:
        return 0, None, 0
    q = _CODE[np.frombuffer(rec["qname"].encode(), np.uint8)]
    s = _CODE[np.frombuffer(rec["seq"].encode(), np.uint8)]
    want = _RC[q[::-1]] if rec["flag"] & 16 else q
    if len(s) != len(want) or not np.array_equal(s, want):
        return 0, None, 0
    ops = _cigar_ops(rec["cigar"])
    if sum(n for n, o in ops if o in "MIS=X") != len(s):
        return 0, None, 0
    tid = g.tid[rec["rname"]]
    span = sum(n for n, o in ops if o in "MD=X")
    if rec["pos"] < 0 or rec["pos"] + span > g.lens[tid]:
        return 0, None, 0
    base = int(g.starts[tid]) + rec["pos"]
    qi = ti = score = 0
    for n, o in ops:
        if o in "M=X":
            a, b = s[qi:qi + n], g.codes[base + ti:base + ti + n]
            same = (a == b) & (a < 4)
            score += int(same.sum()) * MATCH - int((~same).sum()) * MISMATCH
            qi += n
            ti += n
        elif o == "I":
            score -= GAP_OPEN + n * GAP_EXT
            qi += n
        elif o == "D":
            score -= GAP_OPEN + n * GAP_EXT
            ti += n
        elif o == "S":
            qi += n
        else:
            return 0, None, 0
    return score, base, span


def sample(queries: list, seed: int) -> list:
    """The indices of the queries judged: the LONGEST longest and SAMPLE
    more drawn from the seed."""
    n = len(queries)
    order = sorted(range(n), key=lambda i: -len(queries[i]))
    keep = set(order[:LONGEST])
    rest = [i for i in range(n) if i not in keep]
    rng = np.random.default_rng(seed)
    pick = rng.choice(len(rest), min(SAMPLE, len(rest)), replace=False)
    keep.update(rest[int(i)] for i in pick)
    return sorted(keep)


def _candidates(g: Genome, table, queries: list, dev) -> list:
    """Per oriented query (2 a query: forward, reverse complement), the
    genome offsets of the CANDIDATES diagonals with the most exact k-mer
    hits (at most MAX_OCC hits a k-mer)."""
    keys, pos = table
    out = [[] for _ in range(2 * len(queries))]
    if keys.numel() == 0:
        return out
    jobs, offs, kms = [], [], []
    for qi, q in enumerate(queries):
        for strand, o in enumerate((q, _RC[q[::-1]])):
            n = len(o) - K + 1
            if n <= 0:
                continue
            w = np.lib.stride_tricks.sliding_window_view(
                o.astype(np.int64), K)
            bad = (w > 3).any(axis=1)
            km = (np.minimum(w, 3) * (4 ** np.arange(K - 1, -1, -1))).sum(1)
            ok = np.nonzero(~bad)[0]
            jobs.append(np.full(len(ok), 2 * qi + strand, np.int64))
            offs.append(ok)
            kms.append(km[ok])
    if not jobs:
        return out
    job = torch.from_numpy(np.concatenate(jobs)).to(dev)
    off = torch.from_numpy(np.concatenate(offs)).to(dev)
    km = torch.from_numpy(np.concatenate(kms)).to(dev)
    lo = torch.searchsorted(keys, km)
    hi = torch.searchsorted(keys, km, right=True)
    occ = hi - lo
    use = (occ > 0) & (occ <= MAX_OCC)
    lo, occ, job, off = lo[use], occ[use], job[use], off[use]
    if lo.numel() == 0:
        return out
    rep = torch.repeat_interleave(torch.arange(lo.numel(), device=dev), occ)
    first = torch.cumsum(occ, 0) - occ
    hit = lo[rep] + (torch.arange(rep.numel(), device=dev) - first[rep])
    diag = pos[hit] - off[rep]
    bucket = torch.div(diag, 32, rounding_mode="floor")
    j = job[rep]
    pair = torch.stack([j, bucket], 1)
    uniq, inv, cnt = torch.unique(pair, dim=0, return_inverse=True,
                                  return_counts=True)
    dmin = torch.full((uniq.shape[0],), 1 << 62, dtype=torch.int64,
                      device=dev).scatter_reduce(0, inv, diag, "amin")
    u, c, d = uniq.cpu().numpy(), cnt.cpu().numpy(), dmin.cpu().numpy()
    order = np.lexsort((-c, u[:, 0]))
    for r in order:
        lst = out[u[r, 0]]
        if len(lst) < CANDIDATES:
            lst.append(int(d[r]))
    return out


def _sw(qs: list, ts: list, dev, cap=None):
    """Local affine-gap alignment of each query against its target.
    Returns the exact best score of each job; with cap, also the exact
    score at the first cell where the same recurrences in arithmetic
    saturating at [-cap - 1, cap] reach their best."""
    B = len(qs)
    if B == 0:
        z = torch.zeros(0, dtype=torch.int32)
        return (z, z) if cap else z
    LQ = max(len(q) for q in qs)
    W = max(max(len(t) for t in ts), 1)
    qm = np.full((B, LQ), 5, np.uint8)
    tm = np.full((B, W), 6, np.uint8)
    for b, (q, t) in enumerate(zip(qs, ts)):
        qm[b, :len(q)] = q
        tm[b, :len(t)] = t
    q = torch.from_numpy(qm).to(dev)
    t = torch.from_numpy(tm).to(dev)
    i32 = torch.int32
    t_ok = t < 4
    jx = torch.arange(1, W + 1, dtype=i32, device=dev)[None, :] * GAP_EXT
    neg = -(1 << 28)

    def fresh():
        return (torch.zeros((B, W + 1), dtype=i32, device=dev),
                torch.full((B, W), neg, dtype=i32, device=dev))

    def row(h, e, qi, lo=None, hi=None):
        sub = torch.where((t == qi[:, None]) & t_ok & (qi[:, None] < 4),
                          MATCH, -MISMATCH).to(i32)
        diag = h[:, :-1] + sub
        e = torch.maximum(h[:, 1:] - (GAP_OPEN + GAP_EXT), e - GAP_EXT)
        if lo is not None:
            diag, e = diag.clamp(lo, hi), e.clamp(lo, hi)
        hp = torch.maximum(torch.maximum(diag, e), torch.zeros_like(diag))
        pref = torch.cummax(hp + jx, dim=1).values
        f = torch.cat([torch.full((B, 1), neg, dtype=i32, device=dev),
                       pref[:, :-1]], 1) - GAP_OPEN - jx
        if lo is not None:
            f = f.clamp(lo, hi)
        hn = torch.maximum(hp, f)
        return torch.cat([torch.zeros((B, 1), dtype=i32, device=dev), hn],
                         1), e, hn

    h, e = fresh()
    best = torch.zeros(B, dtype=i32, device=dev)
    if cap:
        hs, es = fresh()
        sbest = torch.full((B,), -1, dtype=i32, device=dev)
        pick = torch.zeros(B, dtype=i32, device=dev)
    for i in range(LQ):
        qi = q[:, i].to(i32)
        h, e, hn = row(h, e, qi)
        best = torch.maximum(best, hn.max(1).values)
        if cap:
            hs, es, hsn = row(hs, es, qi, -cap - 1, cap)
            rmax, arg = hsn.max(1)
            up = rmax > sbest
            sbest = torch.where(up, rmax, sbest)
            pick = torch.where(up, hn.gather(1, arg[:, None])[:, 0], pick)
    if cap:
        return best.cpu(), sbest.cpu(), pick.cpu()
    return best.cpu()


def clip_rows(path: str) -> list:
    """The rows of a ``.clip.gz`` as lists of fields: chrom, breakpoint,
    orientation, CIGAR, aligned sequence and quality, clipped sequence
    and quality, support."""
    with gzip.open(path, "rt") as f:
        return [ln.rstrip("\n").split("\t") for ln in f]


def judge_alignments(g: Genome, table, rows: list, sam_path: str,
                     seed: int, dev, cap=None) -> dict:
    """aln_score_lost_pct of the program's ``.clip.sam`` over a sample of
    the queries that ``rows`` (the ``.clip.gz``) give realign, and
    clip_sam_unmatched; with cap, also the narrow-arithmetic control's
    score lost on the same queries."""
    names = [r[6] for r in rows]
    prim = {}
    for r in read_sam(sam_path):
        prim.setdefault(r["qname"], []).append(r)
    want = Counter(names)
    unmatched = sum(abs(want[q] - len(prim.get(q, ())))
                    for q in set(want) | set(prim))
    used = Counter()
    recs = []
    picked = [names[i] for i in sample(names, seed)]
    for name in picked:
        have = prim.get(name, ())
        recs.append(have[used[name]] if used[name] < len(have) else None)
        used[name] += 1
    queries = [_CODE[np.frombuffer(n.encode(), np.uint8)] for n in picked]
    cands = _candidates(g, table, queries, dev)
    qs, ts, owner = [], [], []
    prog = []
    for qi, (r, q) in enumerate(zip(recs, queries)):
        score, base, span = path_score(g, r) if r else (0, None, 0)
        prog.append(score)
        wins = []
        for strand in (0, 1):
            o = q if strand == 0 else _RC[q[::-1]]
            for d in cands[2 * qi + strand]:
                wins.append((o, d, len(o)))
        if base is not None:
            o = q if not r["flag"] & 16 else _RC[q[::-1]]
            wins.append((o, base, span))
        for o, d, span in wins:
            tid = int(np.searchsorted(g.starts, max(d, 0) + span // 2,
                                      "right")) - 1
            tid = min(max(tid, 0), len(g.lens) - 1)
            lo = max(int(g.starts[tid]), d - WINDOW_PAD)
            hi = min(int(g.starts[tid + 1]), d + span + WINDOW_PAD)
            if hi <= lo:
                continue
            qs.append(o)
            ts.append(g.codes[lo:hi])
            owner.append(qi)
    res = _sw(qs, ts, dev, cap)
    best_job = res[0] if cap else res
    n = len(recs)
    best = np.zeros(n, np.int64)
    ctrl = np.zeros(n, np.int64)
    sbest = np.full(n, -1, np.int64)
    for j, qi in enumerate(owner):
        best[qi] = max(best[qi], int(best_job[j]))
        if cap and int(res[1][j]) > sbest[qi]:
            sbest[qi] = int(res[1][j])
            ctrl[qi] = int(res[2][j])
    due = best >= SCORE_T
    prog = np.maximum(np.asarray(prog, np.int64), 0)
    total = int(best[due].sum())

    def lost(got):
        return 100.0 * float(np.maximum(best - got, 0)[due].sum()) / total \
            if total else 0.0
    gap = np.where(due, best - prog, 0)
    worst = [{"qlen": len(picked[i]), "best": int(best[i]),
              "got": int(prog[i]),
              "flag": recs[i]["flag"] if recs[i] else None,
              "cigar": recs[i]["cigar"] if recs[i] else None}
             for i in np.argsort(-gap, kind="stable")[:3] if gap[i] > 0]
    missing = np.array([r is None for r in recs], bool)
    out = {"aln_score_lost_pct": lost(prog), "judged": int(due.sum()),
           "sampled": n, "queries": len(names),
           "clip_sam_unmatched": int(unmatched),
           "unmapped_due": int((due & (prog <= 0) & ~missing).sum()),
           "missing_due": int((due & missing).sum()), "worst": worst}
    if cap:
        out["control_lost_pct"] = lost(ctrl)
    return out


def _ends(truth: list) -> dict:
    """Every simulated breakend, by contig."""
    ends = {}
    for t in truth:
        pts = [(t["up_chrom"], t["up"]), (t["down_chrom"], t["down"])]
        if t["type"] == "VINT":
            pts += [(t["down_chrom"], t["right_up"]),
                    (t["up_chrom"], t["right_down"])]
        for c, p in pts:
            ends.setdefault(c, []).append(p)
    return {c: np.sort(np.asarray(v, np.int64)) for c, v in ends.items()}


def _near(sorted_pts: np.ndarray, p: int) -> bool:
    if sorted_pts is None or not len(sorted_pts):
        return False
    i = int(np.searchsorted(sorted_pts, p))
    return any(abs(int(sorted_pts[j]) - p) <= NEAR
               for j in (i - 1, i) if 0 <= j < len(sorted_pts))


def sv_rows(path: str) -> list:
    with open(path) as f:
        return [ln for ln in f if not ln.startswith("@")]


def sv_recall(truth: list, rows: list) -> float:
    """Share of the simulated DEL and virus junctions (two an
    integration) that a call matches: both breakends within NEAR bp on
    the same contigs (the reference caller's merge window).  As
    seeksv_tpu_torch/utils/dataset.py:sv_recall at commit 08505b7, with
    the two kinds pooled."""
    calls = {}
    for line in rows:
        fl = line.split("\t")
        calls.setdefault((fl[0], fl[4]), []).append((int(fl[1]), int(fl[5])))
    arr = {k: np.asarray(v, np.int64) for k, v in calls.items()}

    def hit(uc, up, dc, down):
        a = arr.get((uc, dc))
        return a is not None and bool(
            ((np.abs(a[:, 0] - up) <= NEAR)
             & (np.abs(a[:, 1] - down) <= NEAR)).any())
    n = h = 0
    for t in truth:
        if t["type"] == "DEL":
            n += 1
            h += hit(t["up_chrom"], t["up"], t["down_chrom"], t["down"])
        elif t["type"] == "VINT":
            n += 2
            h += hit(t["up_chrom"], t["up"], t["down_chrom"], t["down"])
            h += hit(t["down_chrom"], t["right_up"], t["up_chrom"],
                     t["right_down"])
    return h / n if n else 1.0


def clip_at_events(truth: list, rows: list) -> float:
    """Share of ``.clip.gz`` rows whose breakpoint lies within NEAR bp of
    a simulated breakend (1.0 for a file with no rows)."""
    ends = _ends(truth)
    h = sum(_near(ends.get(r[0]), int(r[1])) for r in rows)
    return h / len(rows) if rows else 1.0


def clip_breakend_recall(truth: list, rows: list) -> float:
    """Share of the simulated breakends that have a ``.clip.gz`` row
    within NEAR bp on their contig (1.0 where nothing was simulated)."""
    at = {}
    for r in rows:
        at.setdefault(r[0], []).append(int(r[1]))
    at = {c: np.sort(np.asarray(v, np.int64)) for c, v in at.items()}
    n = h = 0
    for c, pts in _ends(truth).items():
        for p in pts:
            n += 1
            h += _near(at.get(c), int(p))
    return h / n if n else 1.0


def somatic_scores(truth: dict, path: str) -> tuple:
    """(share of the somatic deletions called, germline deletions
    called) in a ``.somatic.sv``."""
    rows = [ln.split("\t") for ln in sv_rows(path)]
    calls = np.asarray([(int(r[1]), int(r[5])) for r in rows],
                       np.int64).reshape(-1, 2)

    def called(up, down):
        return bool(((np.abs(calls[:, 0] - up) <= NEAR)
                     & (np.abs(calls[:, 1] - down) <= NEAR)).any())
    som = truth["somatic"]
    found = sum(called(u, d) for u, d in som)
    leaked = sum(called(s, e + 1) for s, e in truth["germline"])
    return (found / len(som) if som else 1.0), leaked


def judge_outputs(prefix: str, truth_path: str, pair: bool,
                  rows: list) -> dict:
    """The pipeline's outputs against the truth; rows: the
    ``.clip.gz``'s."""
    with open(truth_path) as f:
        truth = json.load(f)
    if pair:
        somatic_truth = truth
        truth = [{"type": "DEL", "up_chrom": "chr17", "up": s,
                  "down_chrom": "chr17", "down": e + 1}
                 for s, e in truth["germline"]] + [
            {"type": "DEL", "up_chrom": "chr17", "up": u,
             "down_chrom": "chr17", "down": d}
            for u, d in truth["somatic"]]
    out = {"sv_recall": sv_recall(truth, sv_rows(f"{prefix}.sv")),
           "clip_breakend_recall": clip_breakend_recall(truth, rows),
           "clip_at_events": clip_at_events(truth, rows)}
    if pair:
        rec, leaked = somatic_scores(somatic_truth, f"{prefix}.somatic.sv")
        out["somatic_recall"] = rec
        out["germline_leaked"] = leaked
    return out
