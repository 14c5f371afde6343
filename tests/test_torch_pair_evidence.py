"""getsv's pair evidence on a virus-panel dataset against the plain
reference (tests/plain_pair_evidence.py, which imports nothing of the
port or of JAX): the insert size, every cross-contig row's discordant
count in the ``.sv`` and in getsv's filtered output, and the counter
``getsv.window_records`` against the plain window count, through
``run_pipeline_streaming`` on the CPU.  The dataset is the virus cell's
shape cut small (1 Mb host, a 60 kb panel, 40 integrations whose panel
offsets overlap, 100 bp reads at 20x); its reads of panel sequence are
unmapped, so the cross-contig counts there are 0, and synthetic columns
with mates across the two contigs give the counter's three cases
nonzero counts."""
import io
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import plain_pair_evidence as plain
from seeksv_tpu_torch.io.bam import (FDUP, FMREVERSE, FMUNMAP, FREVERSE,
                                     FUNMAP, read_bam)
from seeksv_tpu_torch.pipeline.driver import run_pipeline
from seeksv_tpu_torch.pipeline.getsv import DiscordantCounter
from seeksv_tpu_torch.pipeline.stream import LightBam, run_pipeline_streaming
from seeksv_tpu_torch.utils import trace
from seeksv_tpu_torch.utils.dataset import build_dataset

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
CHUNK_RECORDS = 50_000
COUNTER = "getsv.window_records"


@pytest.fixture(scope="module")
def panel(tmp_path_factory):
    """The streamed pass under a profiler (so the counter records), its
    ``.sv`` and filtered rows, the insert size it logged, and the plain
    columns of its BAM."""
    root = tmp_path_factory.mktemp("panel")
    paths = build_dataset(str(root / "ds"), 1_000_000, 20, 100, 3, 20, False,
                          virus_kb=60, virus_events=40)
    logged, filtered = [], io.StringIO()
    with profile(activities=[ProfilerActivity.CPU]):
        run_pipeline_streaming(paths["ref_fa"], paths["bam"],
                               str(root / "s"), device="cpu",
                               chunk_records=CHUNK_RECORDS,
                               filtered_out=filtered, log=logged.append)
    counts = dict(trace.last().counts)
    (ins,) = [re.match(r"Mean insert size: (\d+); deviation: (\d+)", s)
              for s in logged if s.startswith("Mean insert size")]
    with open(root / "s.sv") as f:
        sv = plain.sv_junctions(f)
    rows = sv + plain.sv_junctions(filtered.getvalue().splitlines(), True)
    return {"root": root, "paths": paths, "sv": sv, "rows": rows,
            "insert": (int(ins.group(1)), int(ins.group(2))),
            "counts": counts, "cols": plain.bam_columns(paths["bam"])}


def test_plain_columns_are_the_bam_records(panel):
    """The plain decoder reads what the port's whole-BAM reader reads."""
    cols = panel["cols"]
    r = read_bam(panel["paths"]["bam"])
    assert cols["ref_names"] == ["chr17", "virus"]
    assert list(cols["ref_lens"]) == [1_000_000, 60_000]
    hard = (r.cig_off[1:] > r.cig_off[:-1]) & (
        (r.first_op() == 5) | (r.last_op() == 5))
    want = {"tid": r.tid, "pos": r.pos, "mtid": r.mtid, "mpos": r.mpos,
            "l_qseq": r.l_qseq, "flag": r.flag, "mapq": r.mapq,
            "isize": r.isize, "end": r.pos + r.ref_span(count_x=True),
            "hard": hard}
    for k in plain.COLUMNS:
        assert np.array_equal(cols[k].numpy(), np.asarray(want[k])), k


def test_insert_size_equals_plain(panel):
    assert panel["insert"] == plain.insert_size(panel["cols"])
    assert 450 <= panel["insert"][0] <= 550


def test_discordant_counts_equal_plain(panel):
    """Every row, called or filtered, carries the plain count: the rows
    across the host and the panel (both orders of the contigs) and the
    host's own rows, whose deletions have discordant pairs."""
    mean, dev = panel["insert"]
    rows = panel["rows"]
    _cov, cnt = plain.pair_evidence(panel["cols"], rows, mean, dev)
    cross = [i for i, j in enumerate(rows) if j[0] != j[3]]
    assert {(rows[i][0], rows[i][3]) for i in cross} == {
        ("chr17", "virus"), ("virus", "chr17")}
    assert len(cross) >= 40
    counted = [i for i in range(len(rows)) if int(cnt[i]) >= 0]
    assert set(cross) <= set(counted)
    assert [int(cnt[i]) for i in counted] == [rows[i][6] for i in counted]
    assert any(rows[i][6] > 0 for i in counted if i not in cross)


def test_window_counter_equals_plain(panel):
    """The counter sums, over every junction getsv counted (the rows of
    the .sv and of the filtered output), the records its window covers,
    as the plain masks count them."""
    mean, dev = panel["insert"]
    cov, _cnt = plain.pair_evidence(panel["cols"], panel["rows"], mean, dev,
                                    rows_per_block=7,
                                    records_per_block=30_000)
    assert panel["counts"][COUNTER] == int(cov.sum()) > 0


def test_stream_and_whole_bam_write_the_same_sv(panel):
    root, paths = panel["root"], panel["paths"]
    run_pipeline(paths["ref_fa"], paths["bam"], str(root / "w"),
                 device="cpu")
    with open(root / "w.sv", "rb") as a, open(root / "s.sv", "rb") as b:
        assert a.read() == b.read()


# bwa mem's defaults, which the engine keeps (align/engine.py
# MIN_SEED_LEN, SCORE_T; align/sw.py's scores): a seed is an exact match
# of 19 bases, an alignment that scores under 30 is left unmapped
SEED_LEN, MIN_SCORE = 19, 30
MATCH, MISMATCH, GAP_OPEN, GAP_EXT = 1, 4, 6, 1
_CODE = np.full(256, 255, np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _CODE[_c] = _i


def _seed_codes(seq: bytes) -> np.ndarray:
    """The 2-bit codes of every SEED_LEN-mer of ``seq``."""
    a = _CODE[np.frombuffer(seq, np.uint8)].astype(np.uint64)
    n = len(a) - SEED_LEN + 1
    if n <= 0:
        return np.zeros(0, np.uint64)
    out = np.zeros(n, np.uint64)
    for j in range(SEED_LEN):
        out = (out << np.uint64(2)) | a[j:j + n]
    return out


def _local_score(q: bytes, t: bytes) -> int:
    """The best local alignment score of q in t under the engine's
    scores (affine gaps)."""
    qa = np.frombuffer(q, np.uint8)
    ta = np.frombuffer(t, np.uint8)
    neg = -10 ** 9
    h = np.zeros(len(t) + 1, np.int64)
    e = np.full(len(t) + 1, neg, np.int64)
    best = 0
    for c in qa:
        diag = h[:-1] + np.where(ta == c, MATCH, -MISMATCH)
        e = np.maximum(h - GAP_OPEN - GAP_EXT, e - GAP_EXT)
        row = np.zeros(len(t) + 1, np.int64)
        row[1:] = np.maximum(0, np.maximum(diag, e[1:]))
        f = neg
        for j in range(1, len(t) + 1):
            f = max(row[j - 1] - GAP_OPEN - GAP_EXT, f - GAP_EXT)
            row[j] = max(row[j], f)
        h = row
        best = max(best, int(h.max()))
    return best


def test_unmapped_clips_are_past_bwa_mem_defaults(panel):
    """Every clip that realign leaves unmapped is one that bwa mem's
    defaults (the reference's realigner) cannot place either: shorter
    than the minimum score, no exact 19-mer shared with the reference
    on either strand, or a best local score under 30 on every diagonal
    its seeds give.  At the panel's 4 % divergence these are the virus
    junctions whose every host clip stays unplaced."""
    genome, starts = [], []
    with open(panel["paths"]["ref_fa"], "rb") as f:
        for line in f:
            if line.startswith(b">"):
                starts.append(sum(len(x) for x in genome))
            else:
                genome.append(line.strip().upper())
    genome = b"".join(genome)
    codes = _seed_codes(genome)
    bad = np.zeros(len(codes), bool)         # seeds across two contigs
    for s in starts[1:]:
        bad[max(0, s - SEED_LEN + 1):s] = True
    order = np.argsort(codes, kind="stable")
    keys = codes[order]
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    unmapped = []
    with open(panel["root"] / "s.clip.sam") as f:
        for line in f:
            fl = line.split("\t")
            if not line.startswith("@") and int(fl[1]) & 4 \
                    and not int(fl[1]) & 0x900:
                unmapped.append(fl[9].encode())
    assert unmapped
    placeable = []
    for q in unmapped:
        if len(q) < MIN_SCORE:
            continue
        for x in (q, q.translate(comp)[::-1]):
            c = _seed_codes(x)
            lo = np.searchsorted(keys, c, "left")
            hi = np.searchsorted(keys, c, "right")
            diag = {int(order[k]) - i for i in range(len(c))
                    for k in range(lo[i], hi[i]) if not bad[order[k]]}
            for d in diag:
                t = genome[max(0, d - 20):d + len(x) + 20]
                if _local_score(x, t) >= MIN_SCORE:
                    placeable.append(x)
    assert placeable == []


def _mates_across(seed, unplaced=0, n_jun=24, per=240):
    """Records around junctions between two contigs, their mates on the
    other contig (some on the same one, some unmapped), every flag and
    orientation drawn; sorted by contig and position, then ``unplaced``
    reads without a contig (tid -1), as a sorted BAM ends.  Returns the
    port's LightBam, the plain columns and the junctions (each
    junction's three strand cases, both orders of the contigs, and a
    few within one contig)."""
    rng = np.random.default_rng(seed)
    lens = [300_000, 80_000]
    jun, parts = [], []
    for k in range(n_jun):
        t = k % 2
        up = int(rng.integers(2_000, lens[t] - 2_000))
        down = int(rng.integers(2_000, lens[1 - t] - 2_000))
        for us, ds in (("+", "+"), ("-", "+"), ("+", "-"), ("-", "-")):
            jun.append(((t, up, us, 1 - t, down, ds)))
        jun.append((t, up, "+", t, up + 3_000, "+"))
        pos = up + rng.integers(-900, 900, per)
        mt = np.where(rng.random(per) < 0.85, 1 - t,
                      np.where(rng.random(per) < 0.5, t, -1))
        parts.append(np.stack([
            np.full(per, t), pos, mt, down + rng.integers(-900, 900, per),
            rng.integers(40, 101, per),
            rng.integers(0, 4, per) * FREVERSE
            | (rng.random(per) < 0.05) * FDUP
            | (rng.random(per) < 0.03) * FMUNMAP,
            rng.integers(0, 61, per),
            np.where(mt == t, rng.integers(-900, 900, per), 0),
            rng.random(per) < 0.05], 1))
    a = np.concatenate(parts)
    a = a[np.lexsort((a[:, 1], a[:, 0]))]
    tail = np.zeros((unplaced, a.shape[1]), a.dtype)
    tail[:, [0, 1, 2, 3]] = -1
    tail[:, 4] = 100
    tail[:, 5] = FUNMAP | FMUNMAP
    a = np.concatenate([a, tail])
    flag = a[:, 5]          # 0-3 x FREVERSE: both strands' bits
    end = np.where(a[:, 0] >= 0,
                   a[:, 1] + a[:, 4] + rng.integers(-3, 4, len(a)), -1)
    lb = LightBam(["chr17", "virus"], lens, len(a),
                  a[:, 1].astype(np.int32), a[:, 3].astype(np.int32),
                  a[:, 2].astype(np.int32), a[:, 4].astype(np.int32),
                  flag.astype(np.uint16), a[:, 6].astype(np.uint8),
                  a[:, 7].astype(np.int32), a[:, 0].astype(np.int32),
                  end.astype(np.int32), a[:, 8].astype(bool))
    cols = {k: torch.from_numpy(np.asarray(getattr(lb, k)).astype(
        bool if k == "hard" else np.int64)) for k in plain.COLUMNS}
    cols["ref_names"], cols["ref_lens"] = lb.ref_names, lens
    names = lb.ref_names
    rows = [(names[u], up, us, names[d], down, ds, 0)
            for u, up, us, d, down, ds in jun]
    return lb, cols, rows


@pytest.mark.parametrize("seed, unplaced", [(0, 0), (1, 0), (2, 0),
                                            (3, 20_000)])
def test_mates_on_the_other_contig_count_as_plain(seed, unplaced):
    """The counter's three strand cases with mates across the contigs,
    against the plain masks; the window counter too.  With more unplaced
    reads than placed ones after the last contig, every window still
    finds its contig's records."""
    lb, cols, rows = _mates_across(seed, unplaced)
    mean, dev = 500, 25
    cov, want = plain.pair_evidence(cols, rows, mean, dev, rows_per_block=16,
                                    records_per_block=2_000)
    counter = DiscordantCounter(lb, 20, mean, dev, 4)
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.driver_pass():
            got = [counter.count(r[:6]) for r in rows]
    cross = [i for i, r in enumerate(rows) if r[0] != r[3]]
    assert all(int(want[i]) >= 0 for i in range(len(rows)))
    assert got == [int(w) for w in want]
    assert trace.last().counts[COUNTER] == int(cov.sum())
    by_case = {}
    for i in cross:
        by_case[rows[i][2] + rows[i][5]] = by_case.get(
            rows[i][2] + rows[i][5], 0) + got[i]
    assert by_case["--"] == 0
    assert min(by_case["++"], by_case["-+"], by_case["+-"]) > 0


def test_plain_counts_by_hand():
    """One +/+ junction chr17:1000 -> virus:500 at insert 500 +- 25 x 4
    (inserts 400-600): of six records in its window one is counted; the
    others fail on the mate's strand, the mate's contig, the mapping
    quality, a duplicate flag and a hard clip."""
    rec = {  # pos, end, mtid, mpos, flag, mapq, hard
        "ok": (950, 1000, 1, 899, FMREVERSE, 60, False),
        "mate_fwd": (950, 1000, 1, 899, 0, 60, False),
        "mate_here": (950, 1000, 0, 899, FMREVERSE, 60, False),
        "low_mapq": (950, 1000, 1, 899, FMREVERSE, 10, False),
        "dup": (950, 1000, 1, 899, FMREVERSE | FDUP, 60, False),
        "hard": (950, 1000, 1, 899, FMREVERSE, 60, True)}
    v = np.array(list(rec.values()), dtype=object)
    n = len(v)
    cols = {"tid": torch.zeros(n, dtype=torch.int64),
            "pos": torch.tensor(v[:, 0].astype(np.int64)),
            "end": torch.tensor(v[:, 1].astype(np.int64)),
            "mtid": torch.tensor(v[:, 2].astype(np.int64)),
            "mpos": torch.tensor(v[:, 3].astype(np.int64)),
            "flag": torch.tensor(v[:, 4].astype(np.int64)),
            "mapq": torch.tensor(v[:, 5].astype(np.int64)),
            "hard": torch.tensor(v[:, 6].astype(bool)),
            "l_qseq": torch.full((n,), 50, dtype=torch.int64),
            "isize": torch.zeros(n, dtype=torch.int64),
            "ref_names": ["chr17", "virus"], "ref_lens": [5_000, 2_000]}
    rows = [("chr17", 1000, "+", "virus", 500, "+", 0),
            ("chr17", 1000, "+", "virus", 99, "+", 0),    # insert 901
            ("chr17", 2000, "+", "virus", 500, "+", 0),   # window misses
            ("chr17", 1000, "-", "virus", 500, "-", 0)]
    cov, cnt = plain.pair_evidence(cols, rows, 500, 25)
    assert cnt.tolist() == [1, 0, 0, 0]
    assert cov.tolist() == [6, 6, 0, 6]


def test_plain_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import plain_pair_evidence; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'seeksv_tpu', 'seeksv_tpu_torch'}))")
    r = subprocess.run([sys.executable, "-c", code, HERE],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"
