"""getclip's native unmapped-mate pairer (csrc/getclip_unmapped.cpp,
``io.native.UnmappedPairer``) inside ``GetclipStream`` writes the same
``unmapped_{1,2}.fq.gz`` text as the ``_store_unmapped`` loop that runs
without the native library, for slabs cut at every size and qnames given
as a blob (the streamed decoder's ``LazyQnames``) or as a list (the
Python decoder's); both count the records they pair and the pairs they
write (``getclip.unmapped_records`` / ``getclip.unmapped_pairs``)."""
import gzip

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from seeksv_tpu_torch.io import native
from seeksv_tpu_torch.io.bam import (FMUNMAP, FPAIRED, FREAD1, FREAD2,
                                     FUNMAP, BamRecords, LazyQnames)
from seeksv_tpu_torch.pipeline.getclip import GetclipStream
from seeksv_tpu_torch.utils import trace

OUTPUTS = ("clip.gz", "clip.fq.gz", "unmapped_1.fq.gz", "unmapped_2.fq.gz")
BIG = 1 << 62
# owned ranges of the own_range case: the first triple of a tid rules, so
# tid 0's second triple is never read; nothing of tid -1 is owned
OWN_RANGE = [(0, 200, 600), (0, 0, BIG), (1, 100, BIG)]


class _Recs:
    """Records as (qname, flag, tid, pos, seq, raw qual) in file order."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.rows = []
        self.n_names = 0

    def name(self):
        self.n_names += 1
        return b"r%06d" % self.n_names

    def read(self, n=None, no_qual=False):
        n = int(self.rng.integers(1, 40)) if n is None else n
        seq = bytes(self.rng.choice(list(b"ACGTN"), n).astype(np.uint8))
        qual = (np.full(n, 0xFF, np.uint8) if no_qual
                else self.rng.integers(0, 42, n).astype(np.uint8))
        return seq, qual

    def add(self, qname, flag, tid=-1, pos=-1, n=None, no_qual=False):
        self.rows.append((qname, flag | FPAIRED, tid, pos,
                          *self.read(n, no_qual)))

    def pair(self, ends=(FREAD1, FREAD2)):
        """Two unplaced, unmapped mates of one name."""
        name = self.name()
        return [(name, FUNMAP | FMUNMAP | e) for e in ends]

    def shuffled(self, items):
        return [items[i] for i in self.rng.permutation(len(items))]


def _split(r):
    # mates far apart: many slabs lie between them
    for name, flag in r.shuffled([m for _ in range(30) for m in r.pair()]):
        r.add(name, flag)


def _half_mapped(r):
    # a mapped read with an unmapped mate, placed at its position, between
    # fully mapped pairs
    pos = 100
    for k in range(20):
        name = r.name()
        e1, e2 = (FREAD1, FREAD2) if k % 2 else (FREAD2, FREAD1)
        r.add(name, FMUNMAP | e1, 0, pos, n=30)
        r.add(r.name(), e1, 0, pos + 1, n=30)
        r.add(name, FUNMAP | e2, 0, pos)
        pos += 37


def _duplicates(r):
    # the same name and end again before and after the mate comes
    for _ in range(15):
        name = r.name()
        e = [FREAD1, FREAD2][int(r.rng.integers(2))]
        o = FREAD1 + FREAD2 - e
        for flag in (e, e, o, e, o, o):
            r.add(name, FUNMAP | FMUNMAP | flag)


def _no_end_flag(r):
    # neither READ1 nor READ2 is end 2
    for ends in ((FREAD1, 0), (0, FREAD1), (0, 0), (FREAD2, 0), (0, FREAD2),
                 (FREAD1 | FREAD2, 0)) * 3:
        for name, flag in r.pair(ends):
            r.add(name, flag)


def _no_qual(r):
    for k in range(20):
        for j, (name, flag) in enumerate(r.pair()):
            r.add(name, flag, no_qual=(k + j) % 3 != 0)


def _empty_read(r):
    for k in range(20):
        for j, (name, flag) in enumerate(r.pair()):
            r.add(name, flag, n=0 if (k + j) % 2 else None,
                  no_qual=k % 5 == 0)


def _unpaired(r):
    # single mates, some placed beside mapped reads, left open at close
    for k in range(40):
        name = r.name()
        if k % 4:
            r.add(name, FUNMAP | FMUNMAP | FREAD1 << (k % 2))
        else:
            r.add(name, FMUNMAP | FREAD2, 0, 50 + k, n=30)
    for name, flag in r.pair():
        r.add(name, flag)


def _own_range(r):
    # mates placed on tid 0 and 1 on both sides of the owned edges, and
    # unplaced ones (never owned)
    for k in range(60):
        name = r.name()
        tid = k % 3 - 1
        pos = -1 if tid < 0 else int(r.rng.integers(0, 900))
        for flag in (FMUNMAP | FREAD1, FUNMAP | FREAD2):
            if tid < 0:
                flag |= FUNMAP | FMUNMAP
            r.add(name, flag, tid, pos, n=30 if not flag & FUNMAP else None)


def _mixed(r):
    # every kind at once, in a random order over many slabs
    names = [r.name() for _ in range(150)]
    items = []
    for name in names:
        for _ in range(int(r.rng.integers(1, 4))):
            e = [FREAD1, FREAD2, 0][int(r.rng.integers(3))]
            items.append((name, e))
    for name, e in r.shuffled(items):
        half = r.rng.random() < 0.2
        flag = (FMUNMAP | e) if half else (FUNMAP | FMUNMAP | e)
        r.add(name, flag, 0 if half else -1, 10 if half else -1,
              n=int(r.rng.integers(0, 3)) * 25 if half else None,
              no_qual=r.rng.random() < 0.2)


CASES = {"split": _split, "half_mapped": _half_mapped,
         "duplicates": _duplicates, "no_end_flag": _no_end_flag,
         "no_qual": _no_qual, "empty_read": _empty_read,
         "unpaired": _unpaired, "own_range": _own_range, "mixed": _mixed}


def _records(case):
    r = _Recs(sorted(CASES).index(case))
    CASES[case](r)
    return r.rows


def _slab(rows, qnames):
    """One slab of rows as the decoders give it: a mapped read has an
    all-M CIGAR, an unmapped one none."""
    n = len(rows)
    col = {k: np.array([row[j] for row in rows], np.int32)
           for j, k in ((1, "flag"), (2, "tid"), (3, "pos"))}
    seq_len = np.array([len(row[4]) for row in rows], np.int64)
    seq_off = np.concatenate([[0], np.cumsum(seq_len)]).astype(np.int64)
    mapped = (col["flag"] & FUNMAP) == 0
    cig = np.array([len(row[4]) << 4 for row, m in zip(rows, mapped) if m],
                   np.uint32)
    cig_off = np.concatenate([[0], np.cumsum(mapped)]).astype(np.int64)
    names = [row[0] for row in rows]
    if qnames == "lazy":
        off = np.concatenate([[0], np.cumsum([len(q) for q in names])])
        names = LazyQnames(np.frombuffer(b"".join(names), np.uint8),
                           off.astype(np.int64))
    z = np.zeros(n, np.int32)
    return BamRecords(
        ref_names=["chr1", "chr2"], ref_lens=[1000, 1000], n=n,
        flag=col["flag"], tid=col["tid"], pos=col["pos"],
        mapq=np.full(n, 60, np.int32), mtid=col["tid"], mpos=col["pos"],
        isize=z, l_qseq=seq_len.astype(np.int32), qnames=names, cig=cig,
        cig_off=cig_off,
        seq=np.frombuffer(b"".join(row[4] for row in rows), np.uint8),
        qual=np.concatenate([row[5] for row in rows]).astype(np.uint8),
        seq_off=seq_off, xc=z)


def _run(rows, slab, qnames, own_range, prefix):
    """GetclipStream over the rows in slabs of ``slab`` records, under a
    profiler so that the pass records its counters; returns them."""
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.driver_pass():
            gs = GetclipStream(str(prefix), own_range=own_range)
            for lo in range(0, len(rows), slab):
                gs.process(_slab(rows[lo:lo + slab], qnames))
            gs.close()
    return trace.last().counts


def _owned(row, own_range):
    for t, lo, hi in own_range or ():
        if t == row[2]:
            return lo <= row[3] < hi
    return own_range is None


def _read(prefix, ext):
    with gzip.open(f"{prefix}.{ext}") as f:
        return f.read()


@pytest.mark.parametrize("qnames", ["lazy", "list"])
@pytest.mark.parametrize("slab", [1, 7, 64, 1_000_000])
@pytest.mark.parametrize("case", sorted(CASES))
def test_native_pairs_are_the_store_unmapped_loops(case, slab, qnames,
                                                   tmp_path, monkeypatch):
    assert native.available(), native.LOAD_ERROR
    rows = _records(case)
    own_range = OWN_RANGE if case == "own_range" else None
    got = _run(rows, slab, qnames, own_range, tmp_path / "native")
    with monkeypatch.context() as m:
        m.setattr(native, "available", lambda: False)
        want = _run(rows, slab, qnames, own_range, tmp_path / "loop")
    for ext in OUTPUTS:
        assert _read(tmp_path / "native", ext) == \
            _read(tmp_path / "loop", ext), ext
    un1 = _read(tmp_path / "native", "unmapped_1.fq.gz").splitlines()
    un2 = _read(tmp_path / "native", "unmapped_2.fq.gz").splitlines()
    pairs = len(un1) // 4
    assert len(un1) == len(un2) == 4 * pairs and pairs > 0
    stored = sum(1 for row in rows if row[1] & (FUNMAP | FMUNMAP)
                 and _owned(row, own_range))
    for counts in (got, want):
        assert counts["getclip.unmapped_records"] == stored
        assert counts["getclip.unmapped_pairs"] == pairs
