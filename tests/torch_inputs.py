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


def finalize_pairs(rng, ms, ns, LQ, LT):
    """Finalize jobs of the given lengths: q [B, LQ] a random sequence, t
    [B, LT] a copy with a short indel and 3 % substitutions, code 4 past
    m and n (and one ambiguous code inside each)."""
    B = len(ms)
    L = max(LQ, LT)
    src = rng.integers(0, 4, (B, L + 16), dtype=np.uint8)
    k = np.arange(L)[None, :]
    q = src[:, :LQ].copy()
    cut = rng.integers(0, L, B)[:, None]
    off = k + np.where(k >= cut, rng.integers(0, 9, B)[:, None], 0)
    t = np.take_along_axis(src, off, axis=1)[:, :LT].copy()
    for a in (q, t):
        sub = rng.random(a.shape) < 0.03
        a[sub] = rng.integers(0, 4, int(sub.sum()))
        a[:, 7] = 4
    q[k[:, :LQ] >= np.asarray(ms)[:, None]] = 4
    t[k[:, :LT] >= np.asarray(ns)[:, None]] = 4
    return q, t


def band_edge_lengths(w, K, LQ, LT):
    """(ms, ns) int32 whose bands have k_real = |n - m| + 2w + 1 at every
    edge of the direction kernel's bins and one past it (and the
    narrowest band, the widest, and the widest that the aligner's
    eligible() admits), with n - m of either sign, at m = 257, at m = LQ
    and in between."""
    from seeksv_tpu_torch.ops.global_device import (
        BAND_EDGES, TorchDeviceGlobalAligner)
    # the widest |n - m| that eligible() admits, at this rung
    lim = min(kk - 2 * ww - 1 for ww, kk in TorchDeviceGlobalAligner.RUNGS)
    widths = {2 * w + 1, lim + 2 * w + 1, K}
    for e in BAND_EDGES[K]:
        widths |= {e, e + 1}
    ms, ns = [], []
    for k_real in sorted(x for x in widths if 2 * w + 1 <= x <= K):
        d = k_real - 2 * w - 1
        for m in (257, (257 + LQ) // 2, LQ):
            for n in (m + d, m - d):
                if 257 <= n <= LT:
                    ms.append(m)
                    ns.append(n)
    return np.asarray(ms, np.int32), np.asarray(ns, np.int32)


def banded_direction_binned_plain(q, qlen, t, dlo, n, K):
    """ops.global_device.banded_direction through the CUDA kernel's
    dispatch with the plain version in the kernel's place: each bin's
    jobs, in plan_band_bins' order, through banded_direction_plain, their
    results written at the jobs' own indices."""
    from seeksv_tpu_torch.ops import global_device as gd
    B, LQ = q.shape
    order, seg = gd.plan_band_bins(qlen, dlo, n, K)
    seg = seg.tolist()
    score = torch.empty(B, dtype=torch.int32, device=q.device)
    dirs = torch.empty((B, LQ, K), dtype=torch.uint8, device=q.device)
    for which in range(gd.band_launches(K)):
        idx = order[seg[which]:seg[which + 1]].to(torch.int64)
        if idx.numel() == 0:
            continue
        s, d = gd.banded_direction_plain(
            q[idx], qlen[idx], gd.build_t2(t[idx], n[idx], dlo[idx], K, LQ),
            dlo[idx], n[idx], K, LQ)
        score[idx] = s
        dirs[idx] = d
    return score, dirs


def sized_groups(seed, sizes, G, LL, LR, S_random=0):
    """Consensus groups of the given numbers of reads (noisy copies of two
    templates, full-length sides), the last S_random of them of random
    reads that match nothing (they overflow max_slots < their size)."""
    rng = np.random.default_rng(seed)
    NG = len(sizes)
    seq_l = np.zeros((NG, G, LL), np.uint8)
    seq_r = np.zeros((NG, G, LR), np.uint8)
    len_l = np.zeros((NG, G), np.int32)
    len_r = np.zeros((NG, G), np.int32)
    for k, n in enumerate(sizes):
        tl = rng.integers(65, 69, (2, LL)).astype(np.uint8)
        tr = rng.integers(65, 69, (2, LR)).astype(np.uint8)
        for ri in range(n):
            nl = int(rng.integers(LL // 2, LL + 1))
            nr = int(rng.integers(LR // 2, LR + 1))
            if k >= NG - S_random:
                sl = rng.integers(65, 69, nl).astype(np.uint8)
                sr = rng.integers(65, 69, nr).astype(np.uint8)
            else:
                which = int(rng.integers(0, 2))
                sl = tl[which, LL - nl:].copy()
                sr = tr[which, :nr].copy()
                for s in (sl, sr):
                    mut = rng.random(len(s)) < 0.05
                    s[mut] = rng.integers(65, 69, int(mut.sum()))
            seq_l[k, ri, LL - nl:] = sl
            seq_r[k, ri, :nr] = sr
            len_l[k, ri], len_r[k, ri] = nl, nr
    return seq_l, len_l, seq_r, len_r, np.asarray(sizes, np.int32)


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


# ---- the walk (K3): direction blocks with a planted path

_DM, _DE, _DF, _ERUN, _FRUN = 1, 2, 4, 8, 16


def planted_walk(rng, runs, K, LQ, tail=None):
    """One job's direction block [LQ, K] uint8 in which the walk from (m, n)
    follows `runs` (walk order: [(op, length)], op "M", "I" or "D", no two
    neighbours alike), then, with tail ("D", J) or ("I", J), runs along row
    0 or column 0 to (0, 0).  Every byte off the path is random, with ERUN
    only where j - 1 >= 1 and FRUN only where i > 1 (as the direction pass
    writes them).  Returns (dirs, m, n, dlo)."""
    di = sum(ln for op, ln in runs if op != "D")
    dj = sum(ln for op, ln in runs if op != "I")
    m = di + (tail[1] if tail and tail[0] == "I" else 0)
    n = dj + (tail[1] if tail and tail[0] == "D" else 0)
    # the path's cells and their bytes, in walk order
    i, j, cells = m, n, []
    for op, ln in runs:
        for s in range(ln):
            last = s == ln - 1
            if op == "M":
                b = _DM | int(rng.integers(0, 32)) & (_DE | _DF)
            elif s == 0:     # H mode picks D by DE, I by DF; no DM
                b = _DE if op == "D" else _DF
                b |= 0 if last else (_ERUN if op == "D" else _FRUN)
            else:            # inside the run: its flag says "go on"
                b = int(rng.integers(0, 8))
                b |= 0 if last else (_ERUN if op == "D" else _FRUN)
            cells.append((i, j, b))
            i -= op != "D"
            j -= op != "I"
    assert (i, j) == ((0, tail[1]) if tail and tail[0] == "D" else
                      (tail[1], 0) if tail else (0, 0))
    diag = [cj - ci for ci, cj, _b in cells] or [0]
    room = K - 1 - (max(diag) - min(diag))
    assert room >= 0, "the path does not fit the band"
    dlo = min(diag) - int(rng.integers(0, room + 1))
    d = rng.integers(0, 32, (LQ, K)).astype(np.uint8)
    ii = np.arange(1, LQ + 1)[:, None]
    jj = ii + dlo + np.arange(K)[None, :]
    d[jj - 1 < 1] &= ~np.uint8(_ERUN)
    d[np.broadcast_to(ii <= 1, d.shape)] &= ~np.uint8(_FRUN)
    for ci, cj, b in cells:
        assert ci >= 1 and 0 <= cj - ci - dlo < K
        if b & _ERUN:
            assert cj - 1 >= 1
        if b & _FRUN:
            assert ci > 1
        d[ci - 1, cj - ci - dlo] = b
    return d, m, n, dlo


def _alternating(rng, n_runs, ops="MDMI", lo=1, hi=9):
    """n_runs runs cycling through ops, the last one the first of ops."""
    return [(ops[(n_runs - 1 - r) % len(ops)], int(rng.integers(lo, hi)))
            for r in range(n_runs)]


def adversarial_walks(case, K, seed=0):
    """Walk inputs (dirs [B, LQ, K] uint8, m, n, dlo [B] int32) built to
    leave any window of a warp's walk (128 rows of one 32-byte sector):
      long_gaps  D and I runs of 33 to 97 steps between M runs of up to
                 300 rows (across sectors and window rows);
      row0 / col0  walks that end along row 0 (D) or column 0 (I);
      runs_cap   walks of exactly RUNS_CAP runs, and of RUNS_CAP + 1;
      idle       jobs with m = n = 0 between live ones.
    Each case also holds a long M-only walk and a walk of one step."""
    rng = np.random.default_rng(seed + K)
    LQ = 640
    jobs = []
    if case == "long_gaps":
        jobs += [[("M", 150), ("D", 70), ("M", 40), ("I", 70), ("M", 200)],
                 [("M", 33), ("I", 40), ("M", 31), ("D", 65), ("M", 129)],
                 [("D", 97), ("M", 300), ("I", 33), ("M", 5)],
                 [("I", 64), ("M", 128), ("D", 64), ("M", 64), ("I", 1)]]
    elif case in ("row0", "col0"):
        op = "D" if case == "row0" else "I"
        for runs, J in (([("M", 200), ("I" if op == "D" else "D", 3),
                          ("M", 30)], 40),
                        ([("M", 127)], 70),
                        ([("M", 5), (op, 9), ("M", 1)], 1)):
            jobs.append((runs, (op, J)))
    elif case == "runs_cap":
        for n_runs in (64, 65, 63, 66):
            jobs.append(_alternating(rng, n_runs))
    elif case == "idle":
        jobs += [_alternating(rng, 20, lo=1, hi=30), None,
                 [("M", 300), ("D", 2), ("M", 100)], None, None,
                 _alternating(rng, 9, ops="MIMD", lo=20, hi=60), None]
    else:
        raise ValueError(case)
    jobs += [[("M", 600)], [("M", 1)]]
    ds, ms, ns, dlos = [], [], [], []
    for job in jobs:
        if job is None:
            ds.append(rng.integers(0, 32, (LQ, K)).astype(np.uint8))
            ms.append(0)
            ns.append(0)
            dlos.append(-16)
            continue
        runs, tail = job if isinstance(job, tuple) else (job, None)
        d, m, n, dlo = planted_walk(rng, runs, K, LQ, tail)
        ds.append(d)
        ms.append(m)
        ns.append(n)
        dlos.append(dlo)
    return (np.stack(ds), np.asarray(ms, np.int32), np.asarray(ns, np.int32),
            np.asarray(dlos, np.int32))


WALK_CASES = ("long_gaps", "row0", "col0", "runs_cap", "idle")


# ---- the k-mer lookup (K4): tables with buckets of chosen widths

def bucket_table(key_bits, seed=0):
    """A sorted k-mer table with 2^8 prefix buckets of widths around one
    and two 16-byte loads of keys (W = 8 uint16 or 4 uint32 residuals)
    and past them: buckets of 0, 1, W - 1, W, W + 1, 2W - 1,
    2W, 2W + 1, 40 and 100 keys at every start offset in a 16-byte chunk,
    repeated residuals (k-mers that occur more than once), and a last
    bucket of 70 keys.  k = 12 gives uint16 residuals, k = 20 uint32.

    Returns (k, keys, prefix_tab, positions, ref_span, reads): keys the
    unsigned residuals, prefix_tab [2^8 + 1] int64, positions uint32, and
    reads (code arrays) whose k-mers are table keys, residuals beside
    them, random k-mers and k-mers holding a code 4."""
    rng = np.random.default_rng(seed + key_bits)
    k, bits = {16: (12, 8), 32: (20, 8)}[key_bits]
    shift = 2 * k - bits
    W = 16 // (key_bits // 8)
    widths = [0, 1, W - 1, W, W + 1, 2 * W - 1, 2 * W, 2 * W + 1, 40, 100,
              2, 3]
    sizes = [widths[(p * 7) % len(widths)] for p in range(1 << bits)]
    sizes[-1] = 70
    full = []
    for p, size in enumerate(sizes):
        pool = rng.integers(0, 1 << shift, max(1, size // 2 + 1))
        res = np.sort(rng.choice(pool, size))        # repeats
        full.append((np.uint64(p) << np.uint64(shift)) | res.astype(np.uint64))
    full = np.concatenate(full)
    tab = np.zeros((1 << bits) + 1, np.int64)
    tab[1:] = np.cumsum(sizes)
    keys = (full & np.uint64((1 << shift) - 1)).astype(
        np.uint16 if key_bits == 16 else np.uint32)
    ref_span = 1_000_000
    positions = rng.integers(0, ref_span, len(full)).astype(np.uint32)

    def codes(h):
        return np.asarray([(int(h) >> (2 * (k - 1 - x))) & 3
                           for x in range(k)], np.uint8)
    reads = []
    for idx in rng.choice(len(full), 300):
        h = int(full[idx])
        h2 = h + int(rng.integers(-2, 3))             # beside a key
        r = np.concatenate([codes(h), codes(max(h2, 0) % (1 << 2 * k)),
                            rng.integers(0, 4, int(rng.integers(0, 12)))])
        if rng.random() < 0.15:
            r[rng.integers(0, len(r))] = 4
        reads.append(r.astype(np.uint8))
    for p in (0, (1 << bits) - 1):                    # first and last bucket
        lo = int(tab[p])
        reads.append(np.concatenate([codes(full[lo]), codes(full[lo])]))
    reads.append(np.full(30, 4, np.uint8))
    reads.append(np.full(k - 1, 1, np.uint8))         # shorter than k
    return k, keys, tab, positions, ref_span, reads


# ---- the multi-process pipeline: datasets and gloo ranks

def single_chrom_dataset(root, with_equal_boundary: bool):
    """tests/test_multihost.py:78-112 with the port's simulator: a 240 kb
    single-chromosome genome with two deletions; with_equal_boundary adds
    two deletions with identical junction contexts either side of the
    2-rank flat cut (G/2 = 120 kb), which the sequential co-iteration
    merges into one group and the range sharding must exchange across the
    seam.  Returns (bam, ref_fa)."""
    from seeksv_tpu_torch.io.bai import build_index
    from seeksv_tpu_torch.utils.simulate import (build_donor, random_genome,
                                                 simulate_reads, write_fasta)
    rng = np.random.default_rng(3)
    G = 240_000
    g = random_genome(rng, G)
    dels = [(30_000, 30_400), (200_000, 200_500)]
    cov, seed = 30, 5
    if with_equal_boundary:
        startA, endA = 117_000, 117_400
        startB, endB = 123_000, 123_400
        g[endB:endB + 300] = g[endA:endA + 300]
        g[startB - 300:startB] = g[startA - 300:startA]
        dels += [(startA, endA), (startB, endB)]
        cov, seed = 120, 0
    ref = {"chr1": g}
    donor = build_donor(ref, deletions=sorted(dels))
    bam = str(root / "sim.bam")
    fa = str(root / "ref.fa")
    simulate_reads(donor, ["chr1"], [G], bam, coverage=cov, seed=seed,
                   error_rate=0.0)
    build_index(bam)
    write_fasta(fa, ref)
    return bam, fa


def tumor_normal_dataset(root, contigs: int = 1, unread_contig: int = 0):
    """tests/test_multihost.py:115-143 with the port's simulator: a 240 kb
    genome with two germline deletions (one with its breakends 10-400 bp
    below the 2-rank flat cut, G/2 = 120 kb) and two somatic-only ones;
    cancer and normal BAMs at 30x.  contigs=2 writes the same genome as
    two contigs of 120 kb (chr1, chr2; the donor runs from chr1's end
    straight into chr2's start, in both samples), so the last somatic
    deletion lies on chr2.  unread_contig: the length of one more contig,
    chrU, that the header and the FASTA hold and no read covers.  Returns
    (cancer_bam, normal_bam, ref_fa)."""
    from seeksv_tpu_torch.io.bai import build_index
    from seeksv_tpu_torch.utils.simulate import (Donor, build_donor,
                                                 random_genome,
                                                 simulate_reads, write_fasta)
    rng = np.random.default_rng(11)
    G = 240_000
    g = random_genome(rng, G)
    germline = [(40_000, 40_400), (119_600, 119_990)]
    somatic_only = [(80_000, 80_500), (170_000, 170_350)]
    cut = G // contigs
    read = {f"chr{c + 1}": g[c * cut:(c + 1) * cut] for c in range(contigs)}
    ref = dict(read)
    if unread_contig:
        ref["chrU"] = random_genome(rng, unread_contig)
    fa = str(root / "ref.fa")
    write_fasta(fa, ref)

    def donor(dels):
        parts = [build_donor(ref, chrom=name, deletions=[
            (s - c * cut, e - c * cut) for s, e in sorted(dels)
            if c * cut <= s < (c + 1) * cut])
            for c, name in enumerate(read)]
        seq = np.concatenate([p.seq for p in parts])
        lens = np.concatenate([np.diff(p.seg_bounds) for p in parts])
        return Donor([s for p in parts for s in p.segments], seq,
                     np.concatenate([[0], np.cumsum(lens)]),
                     [t for p in parts for t in p.truth])
    out = []
    for name, dels, seed in (("cancer", germline + somatic_only, 7),
                             ("normal", germline, 8)):
        bam = str(root / f"{name}.bam")
        simulate_reads(donor(dels), list(ref),
                       [len(x) for x in ref.values()], bam, coverage=30,
                       seed=seed, error_rate=0.0)
        build_index(bam)
        out.append(bam)
    return out[0], out[1], fa


def run_gloo_ranks(worker, tmp, world, args, timeout=240):
    """Run `worker` RANK WORLD STORE *args as `world` gloo ranks joined
    through a FileStore under tmp; kill them all if any is not done in
    `timeout` s (a hung collective fails the test, not the suite).
    Returns each rank's output."""
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="1", HOME=str(tmp),
               PYTHONPATH=os.pathsep.join(
                   [repo] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p]))
    store = str(tmp / f"store{world}")
    if os.path.exists(store):
        os.remove(store)
    procs = [subprocess.Popen(
        [sys.executable, worker, str(r), str(world), store, *args],
        cwd=str(tmp), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-4000:]}"
    return logs


# ---- the evidence step

def evidence_batch_numpy(genome_len, n_reads, n_jobs, lq, lt, seed):
    """The unsharded batch of make_example_batch (seeksv_tpu/parallel/
    sharded.py:118-137) for n_reads and n_jobs that every mesh of the test
    divides: the same draws from np.random.default_rng(seed) in the same
    order."""
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, max(genome_len - 100, 1), n_reads).astype(
        np.int32)
    return {
        "seg_start": starts,
        "seg_end": (starts + rng.integers(50, 100, n_reads)).astype(np.int32),
        "seg_weight": np.ones(n_reads, np.int32),
        "isize": rng.integers(400, 600, n_reads).astype(np.int32),
        "isize_ok": np.ones(n_reads, bool),
        "q": rng.integers(0, 4, (n_jobs, lq)).astype(np.int32),
        "qlen": np.full(n_jobs, lq, np.int32),
        "t": rng.integers(0, 4, (n_jobs, lt)).astype(np.int32),
        "tlen": np.full(n_jobs, lt, np.int32),
        "h0": np.full(n_jobs, 19, np.int32),
        "cand_key": rng.integers(0, 1 << 20, n_reads).astype(np.int64),
        "cand_support": np.ones(n_reads, np.int32),
    }
