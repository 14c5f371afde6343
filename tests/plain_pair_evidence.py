"""A plain reference of getsv's pair evidence, in numpy and plain torch.

It imports no jax, nothing of seeksv_tpu and nothing of seeksv_tpu_torch,
so it runs where only torch is installed.  From a coordinate-sorted BAM
(decoded here into plain columns by ``bam_columns``) and the rows of a
``.sv`` file (or of getsv's filtered output) it computes what the
reference's ``FindDiscordantReadPairs`` (getsv.cpp:990-1120) and
``CalculateInsertSize`` (cluster.cpp:15-136) give, as SURVEY.md and the
port's docstrings record them:

- ``insert_size``: the integer mean and the truncated deviation of the
  insert size over the first ``read_pair_used`` (-n) records that are
  paired, proper, not duplicates, of mapping quality >= ``min_mapq``,
  with a positive insert size and no hard clip at either end;
- ``pair_evidence``: for each junction row, the records its window
  covers, and its discordant-pair count (the ``abnormal`` column) for
  every row but those the reference may count with its tandem-repeat
  loop (getsv.cpp:1081-1091): both breakends on one contig, both strands
  ``+`` and the up breakend after the down one.

The window is the reference's ``bam_iter_query(tid, beg, end)`` on the
up breakend's contig: for an up strand ``+`` it is ``[up - max_insert,
up)``, for ``-`` ``[up - 1 - 5, up - 1 + max_insert)``, ``beg`` raised to
1 and ``end`` cut at the contig's length, empty where ``end <= beg`` or
the strand is neither.  A record lies in it when it is on that contig,
``pos < end`` and its end (``pos`` + the reference span of its CIGAR's
M, D, N, = and X) ``> beg``.  Every record is tested against every window
by masks, in blocks of rows and of records: no sorted-order bound and no
per-contig span.

Departures from the reference, each deliberate:

- rows that may take the tandem-repeat loop get no count (-1): every
  row whose breakends lie on two contigs has one;
- a record without a CIGAR ends at its own position (the port's rule;
  samtools' ``bam_calend`` gives the same);
- the up strand ``-`` with the down strand ``-`` counts nothing, as the
  reference's three cases leave it.
"""
from __future__ import annotations

import math
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

FPAIRED, FPROPER, FUNMAP, FMUNMAP = 0x1, 0x2, 0x4, 0x8
FREVERSE, FMREVERSE, FDUP = 0x10, 0x20, 0x400
K_CROSS = 5                     # getsv.cpp:15 K_CROSS_LENGTH
_REF_OPS = (0, 2, 3, 7, 8)      # M, D, N, =, X
_OP_H = 5
COLUMNS = ("tid", "pos", "mtid", "mpos", "l_qseq", "flag", "mapq", "isize",
           "end", "hard")


def _inflate(path: str) -> np.ndarray:
    """The BGZF file's decompressed bytes: its blocks found by their
    headers, inflated in threads (zlib releases the lock) into one
    buffer at the offsets their footers' sizes give."""
    with open(path, "rb") as f:
        raw = f.read()
    blocks, p, n = [], 0, len(raw)
    while p < n:
        if raw[p:p + 4] != b"\x1f\x8b\x08\x04":
            raise ValueError(f"{path}: no BGZF block at byte {p}")
        xlen = struct.unpack_from("<H", raw, p + 10)[0]
        bsize = None
        q = p + 12
        while q < p + 12 + xlen:
            si1, si2, slen = struct.unpack_from("<BBH", raw, q)
            if si1 == 66 and si2 == 67:
                bsize = struct.unpack_from("<H", raw, q + 4)[0] + 1
            q += 4 + slen
        if bsize is None:
            raise ValueError(f"{path}: a block without its size at {p}")
        isize = struct.unpack_from("<I", raw, p + bsize - 4)[0]
        blocks.append((p + 12 + xlen, p + bsize - 8, isize))
        p += bsize
    starts = np.concatenate([[0], np.cumsum([b[2] for b in blocks])])
    out = np.empty(int(starts[-1]), np.uint8)

    def one(i):
        a, b, size = blocks[i]
        data = zlib.decompress(raw[a:b], -15)
        if len(data) != size:
            raise ValueError(f"{path}: block {i} inflates to {len(data)} "
                             f"bytes, its footer says {size}")
        out[starts[i]:starts[i] + size] = np.frombuffer(data, np.uint8)
    with ThreadPoolExecutor(8) as ex:
        list(ex.map(one, range(len(blocks))))
    return out


def _gather(buf: np.ndarray, off: np.ndarray, dtype: str) -> np.ndarray:
    """The little-endian values of ``dtype`` at byte offsets ``off``."""
    w = np.dtype(dtype).itemsize
    return buf[off[:, None] + np.arange(w)].copy().view(dtype)[:, 0]


def bam_columns(path: str) -> dict:
    """A BAM as plain columns over every record in file order (int64
    tensors; ``hard`` bool): ``COLUMNS``, with ``ref_names`` and
    ``ref_lens`` of its header."""
    buf = _inflate(path)
    mv = memoryview(buf)
    if bytes(mv[:4]) != b"BAM\x01":
        raise ValueError(f"{path}: not a BAM")
    l_text = struct.unpack_from("<i", mv, 4)[0]
    p = 8 + l_text
    n_ref = struct.unpack_from("<i", mv, p)[0]
    p += 4
    names, lens = [], []
    for _ in range(n_ref):
        ln = struct.unpack_from("<i", mv, p)[0]
        names.append(bytes(mv[p + 4:p + 4 + ln - 1]).decode())
        lens.append(struct.unpack_from("<i", mv, p + 4 + ln)[0])
        p += 8 + ln
    # each record starts with its own size: one walk finds them all
    offs = []
    unpack = struct.Struct("<i").unpack_from
    n = len(buf)
    while p < n:
        offs.append(p)
        p += 4 + unpack(mv, p)[0]
    off = np.asarray(offs, np.int64)
    del offs
    i32 = {k: _gather(buf, off + o, "<i4").astype(np.int64)
           for k, o in (("tid", 4), ("pos", 8), ("l_qseq", 20),
                        ("mtid", 24), ("mpos", 28), ("isize", 32))}
    lrn = buf[off + 12].astype(np.int64)
    mapq = buf[off + 13].astype(np.int64)
    ncig = _gather(buf, off + 16, "<u2").astype(np.int64)
    flag = _gather(buf, off + 18, "<u2").astype(np.int64)
    first = np.concatenate([[0], np.cumsum(ncig)])
    rec = np.repeat(np.arange(len(off)), ncig)
    j = np.arange(int(first[-1])) - first[:-1][rec]
    cig = _gather(buf, off[rec] + 36 + lrn[rec] + 4 * j, "<u4").astype(
        np.int64)
    op, ln = cig & 0xF, cig >> 4
    span = np.bincount(rec, weights=np.where(np.isin(op, _REF_OPS), ln, 0),
                       minlength=len(off)).astype(np.int64)
    has = ncig > 0
    opx = np.concatenate([op, [-1]])    # -1: where a record has no CIGAR
    fop = np.where(has, opx[first[:-1]], -1)
    lop = np.where(has, opx[first[1:] - 1], -1)
    cols = {k: torch.from_numpy(v) for k, v in i32.items()}
    cols.update(mapq=torch.from_numpy(mapq), flag=torch.from_numpy(flag),
                end=torch.from_numpy(i32["pos"] + span),
                hard=torch.from_numpy(has & ((fop == _OP_H)
                                             | (lop == _OP_H))))
    cols["ref_names"], cols["ref_lens"] = names, lens
    return cols


def to_device(cols: dict, device) -> dict:
    return {k: (v.to(device) if torch.is_tensor(v) else v)
            for k, v in cols.items()}


def insert_size(cols: dict, min_mapq: int = 20,
                read_pair_used: int = 5_000_000) -> tuple:
    """(mean, deviation) as integers: the mean floored, the deviation
    the square root of the mean squared difference, truncated; (0, 0)
    where no record qualifies."""
    f = cols["flag"]
    ok = ((cols["mapq"] >= min_mapq) & ((f & FPAIRED) != 0)
          & ((f & FPROPER) != 0) & ((f & FDUP) == 0)
          & (cols["isize"] > 0) & ~cols["hard"])
    vals = cols["isize"][ok][:read_pair_used].to(torch.int64)
    n = vals.numel()
    if n == 0:
        return 0, 0
    mean = int(vals.sum()) // n
    ss = int(((vals - mean) ** 2).sum())
    return mean, int(math.sqrt(ss / n))


def sv_junctions(lines, filtered: bool = False) -> list:
    """(up_chr, up_pos, up_strand, down_chr, down_pos, down_strand,
    abnormal) of each row of a ``.sv`` file, or of getsv's filtered
    output (its first field the reason)."""
    out = []
    for line in lines:
        if not line.strip() or line.startswith("@"):
            continue
        fl = line.rstrip("\n").split("\t")
        if filtered:
            fl = fl[1:]
        out.append((fl[0], int(fl[1]), fl[2], fl[4], int(fl[5]), fl[6],
                    int(fl[9])))
    return out


def pair_evidence(cols: dict, junctions: list, mean: int, dev: int,
                  min_mapq: int = 20, times: int = 4,
                  rows_per_block: int = 64,
                  records_per_block: int = 1 << 22) -> tuple:
    """(covered, count) for each junction: the records its window covers,
    and its discordant-pair count (-1 for a row within one contig whose
    strands are both ``+`` and whose up breakend lies after the down
    one).  Plain masks over every record, on the columns' device."""
    dev_ = cols["pos"].device
    name2tid = {n: i for i, n in enumerate(cols["ref_names"])}
    lens = cols["ref_lens"]
    min_ins = max(0, mean - dev * times)
    max_ins = mean + dev * times
    f = cols["flag"]
    fwd = (f & FREVERSE) == 0
    mfwd = (f & FMREVERSE) == 0
    isz = cols["isize"]
    conc = ((fwd & ~mfwd & (min_ins <= isz) & (isz <= max_ins))
            | (~fwd & mfwd & (isz < 0) & (min_ins <= -isz)
               & (-isz <= max_ins)))
    base = ((cols["mapq"] >= min_mapq)
            & ((f & (FDUP | FUNMAP | FMUNMAP)) == 0) & ~conc & ~cols["hard"])
    # one row of parameters a junction: tid, beg, end, mate tid, up, down,
    # case (1: ++, 2: -+, 3: +-, 0: none), counted
    params = []
    for uc, up, us, dc, down, ds, _ab in junctions:
        tid = name2tid.get(uc)
        beg = end = 0
        if tid is not None and us in ("+", "-"):
            if us == "+":
                end, beg = up, up - max_ins
            else:
                beg, end = up - 1 - K_CROSS, up - 1 + max_ins
            beg = max(beg, 1)
            end = min(end, lens[tid])
        if tid is None or end <= beg:
            tid, beg, end = -2, 0, 0     # an empty window: no record's tid
        case = {("+", "+"): 1, ("-", "+"): 2, ("+", "-"): 3}.get((us, ds), 0)
        tandem = uc == dc and (us, ds) == ("+", "+") and up > down
        params.append((tid, beg, end, name2tid.get(dc, -3), up, down, case,
                       int(not tandem)))
    R = len(params)
    covered = torch.zeros(R, dtype=torch.int64)
    count = torch.zeros(R, dtype=torch.int64)
    if R == 0:
        return covered, count
    P = torch.tensor(params, dtype=torch.int64, device=dev_)
    N = cols["pos"].numel()
    for r0 in range(0, R, rows_per_block):
        p = P[r0:r0 + rows_per_block]
        tid, beg, end, mtid, up, down, case, counted = (
            p[:, k:k + 1] for k in range(8))
        cov_n = torch.zeros(p.shape[0], dtype=torch.int64, device=dev_)
        cnt_n = torch.zeros(p.shape[0], dtype=torch.int64, device=dev_)
        for a in range(0, N, records_per_block):
            s = slice(a, a + records_per_block)
            pos, rend = cols["pos"][s][None, :], cols["end"][s][None, :]
            cov = (cols["tid"][s][None, :] == tid) & (pos < end) \
                & (rend > beg)
            cov_n += cov.sum(1)
            m = cov & base[s][None, :] & (cols["mtid"][s][None, :] == mtid) \
                & (counted == 1)
            ri, ci = torch.nonzero(m, as_tuple=True)
            if ri.numel() == 0:
                continue
            ci = ci + a
            pos0, mpos0 = cols["pos"][ci], cols["mpos"][ci]
            lq = cols["l_qseq"][ci]
            fw, mfw = fwd[ci], mfwd[ci]
            u, d, c = up[ri, 0], down[ri, 0], case[ri, 0]
            pp = ((c == 1) & fw & ~mfw & (pos0 + lq <= u + K_CROSS)
                  & (mpos0 + 1 >= d - K_CROSS))
            mp = (c == 2) & ~fw & ~mfw & (mpos0 + 1 >= d - K_CROSS)
            pm = ((c == 3) & fw & mfw & (pos0 + lq <= u + K_CROSS)
                  & (mpos0 + lq <= d + K_CROSS))
            ins = torch.where(
                c == 1, u - pos0 + mpos0 + lq - d + 1,
                torch.where(c == 2, pos0 + 1 - u + 1 + mpos0 + lq - d + 1,
                            u - pos0 + d - (mpos0 + lq) + 1))
            hit = (pp | mp | pm) & (min_ins <= ins) & (ins <= max_ins)
            cnt_n.index_add_(0, ri, hit.to(torch.int64))
        covered[r0:r0 + p.shape[0]] = cov_n.cpu()
        count[r0:r0 + p.shape[0]] = cnt_n.cpu()
    counted = torch.tensor([q[7] for q in params], dtype=torch.bool)
    count[~counted] = -1
    return covered, count
