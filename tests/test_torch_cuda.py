"""The port's CUDA kernels against their plain PyTorch versions, on the
card (exact: every output is an integer).  Every test here skips when
torch sees no CUDA device.  This file imports no jax, so it also runs
where jax is not installed:

    SEEKSV_TPU_TESTS_ON_DEVICE=1 python -m pytest tests/test_torch_cuda.py

(tests/conftest.py imports jax unless that variable is set)."""
import numpy as np
import pytest
import torch

from seeksv_tpu_torch.ops import extend as ext
from seeksv_tpu_torch.ops import global_device as tgd
from seeksv_tpu_torch.ops import seed_device as tsd


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _packed_genome(rng, G):
    genome = rng.integers(0, 4, G).astype(np.uint8)
    genome[rng.random(G) < 0.001] = 4
    gp = genome if G % 2 == 0 else np.concatenate(
        [genome, np.full(1, 4, np.uint8)])
    return genome, (gp[0::2] | (gp[1::2] << 4)).astype(np.uint8)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("LQ", [32, 512, 1024, 1536])
def test_extend_matches_plain(cuda, reverse, LQ):
    """Queries copied from the genome with 3 % substitutions (long
    extensions), random ones (z-drops), windows off both genome ends and
    tlen = 0 rows."""
    rng = np.random.default_rng(LQ + reverse)
    G = 200_001
    genome, refp = _packed_genome(rng, G)
    B, LT = 300, LQ + 128
    qlen = rng.integers(0, LQ + 1, B).astype(np.int32)
    tlen = np.minimum(qlen + 100, LT).astype(np.int32)
    tlen[:8] = 0
    start = rng.integers(0, G, B).astype(np.int32)
    start[8:12] = [0, 1, G - 1, G - 2]
    h0 = rng.integers(19, 60, B).astype(np.int32)
    q = rng.integers(0, 4, (B, LQ)).astype(np.uint8)
    for b in range(0, B, 2):
        s = int(start[b])
        w = genome[max(s - LQ + 1, 0):s + 1][::-1] if reverse \
            else genome[s:s + LQ]
        q[b, :len(w)] = w
    q[rng.random((B, LQ)) < 0.03] = rng.integers(0, 4)
    q[np.arange(LQ)[None, :] >= qlen[:, None]] = 4
    args = [torch.from_numpy(a).to(cuda) for a in
            (ext.pack_nibbles(q), qlen, start, tlen, h0, refp)]
    n0 = ext.LAUNCHES["extend_left" if reverse else "extend_right"]
    got = ext.extend_batch_resident(*args, G, LQ, LT, reverse)
    want = ext.extend_batch_resident_plain(*args, G, LQ, LT, reverse)
    torch.cuda.synchronize()
    # one kernel launch per bin of the bucket
    assert ext.bin_launches(LQ) == {32: 1, 512: 3, 1024: 4, 1536: 5}[LQ]
    assert ext.LAUNCHES["extend_left" if reverse else "extend_right"] \
        == n0 + ext.bin_launches(LQ)
    for k in ext.KEYS:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("LQ", [1024, 2048])
@pytest.mark.parametrize("reverse", [False, True])
def test_extend_mixed_bins_match_plain(cuda, reverse, LQ):
    """One batch that mixes every query-length bin of the kernel's
    dispatch (each edge - 1, edge, edge + 1, qlen 0 and 1, queries past
    the widest bin at LQ 2048), two jobs whose qlen lies past the bucket
    LQ (LQ cells, no cell qlen), tlen = 0 slots and windows off both
    genome ends, through both entries: results at the jobs' own indices."""
    from torch_inputs import extend_batch_binned_plain
    rng = np.random.default_rng(LQ + reverse)
    G = 300_001
    genome, refp = _packed_genome(rng, G)
    edges = sorted(x for x in {e + d for e in ext.BIN_EDGES
                               for d in (-1, 0, 1)} | {0, 1, LQ} if x <= LQ)
    B, LT = 400, LQ + 128
    qlen = rng.integers(1, LQ + 1, B).astype(np.int32)
    qlen[20:20 + len(edges)] = edges
    qlen[13:15] = LQ
    tlen = np.minimum(qlen + 100, LT).astype(np.int32)
    tlen[:8] = 0
    start = rng.integers(LQ, G - LQ, B).astype(np.int32)
    start[8:12] = [0, 1, G - 1, G - 2]
    h0 = rng.integers(19, 60, B).astype(np.int32)
    q = rng.integers(0, 4, (B, LQ)).astype(np.uint8)
    for b in range(0, B, 4):
        q[b] = rng.integers(0, 4, LQ)
    for b in range(B):
        if b % 4:
            s = int(start[b])
            w = genome[max(s - LQ + 1, 0):s + 1][::-1] if reverse \
                else genome[s:s + LQ]
            q[b, :len(w)] = w
    q[rng.random((B, LQ)) < 0.03] = rng.integers(0, 4)
    q[np.arange(LQ)[None, :] >= qlen[:, None]] = 4
    qlen[13:15] = [LQ + 1, LQ + 900]
    args = [torch.from_numpy(a).to(cuda) for a in
            (ext.pack_nibbles(q), qlen, start, tlen, h0, refp)]
    got = ext.extend_batch_resident(*args, G, LQ, LT, reverse)
    want = ext.extend_batch_resident_plain(*args, G, LQ, LT, reverse)
    tq = torch.from_numpy(q).to(cuda)
    tt = ext.gather_ref_windows(args[5], G, args[2], args[3], LT,
                                reverse).to(torch.uint8)
    gotw = ext.extend_batch(tq, args[1], tt, args[3], args[4])
    binned = extend_batch_binned_plain(tq, args[1], tt, args[3], args[4])
    torch.cuda.synchronize()
    for k in ext.KEYS:
        assert torch.equal(got[k], want[k]), k
        assert torch.equal(gotw[k], want[k]), f"windows {k}"
        assert torch.equal(binned[k], want[k]), f"binned plain {k}"
    assert int(want["max_score"][13]) > 60
    assert int(want["gscore"][13]) == ext.NEG_INF
    order, seg = ext.plan_bins(args[1], args[3], LQ)
    assert sorted(order.tolist()) == list(range(B))
    assert (torch.diff(seg) > 0).sum() >= len(ext.BIN_EDGES)


def _pairs(rng, B, LQ, w, K):
    q = np.full((B, LQ), 4, np.uint8)
    t = np.full((B, LQ), 4, np.uint8)
    lim = K - 2 * w - 1
    ms = rng.integers(257, LQ + 1, B).astype(np.int32)
    ns = np.clip(ms + rng.integers(-lim, lim + 1, B), 257, LQ).astype(np.int32)
    for b in range(B):
        qc = rng.integers(0, 4, ms[b]).astype(np.uint8)
        tc = np.resize(qc, ns[b] + 40).copy()
        mut = rng.random(len(tc)) < 0.04
        tc[mut] = rng.integers(0, 4, int(mut.sum()))
        for _ in range(int(rng.integers(0, 4))):    # short indels
            cut = int(rng.integers(1, len(tc) - 20))
            tc = np.concatenate([tc[:cut], tc[cut + int(rng.integers(1, 9)):]])
        q[b, :ms[b]] = qc
        t[b, :ns[b]] = tc[:ns[b]]
    dlo = (np.minimum(0, ns - ms) - w).astype(np.int32)
    return q, t, ms, ns, dlo


@pytest.mark.parametrize("w,K", [(16, 128), (64, 256)])
def test_banded_direction_and_walk_match_plain(cuda, w, K):
    rng = np.random.default_rng(K)
    B, LQ = 96, 1024
    q, t, ms, ns, dlo = _pairs(rng, B, LQ, w, K)
    tq, tm, tt, td, tn = (torch.from_numpy(a).to(cuda)
                          for a in (q, ms, t, dlo, ns))
    score, dirs = tgd.banded_direction(tq, tm, tt, td, tn, K)
    ws, wdirs = tgd.banded_direction_plain(
        tq, tm, tgd.build_t2(tt, tn, td, K, LQ), td, tn, K, LQ)
    torch.cuda.synchronize()
    assert torch.equal(score, ws)
    rows = torch.arange(1, LQ + 1, device=cuda)[None, :] <= tm[:, None]
    assert torch.equal(dirs[rows], wdirs[rows])
    got = tgd.traceback_rle(dirs, tm, tn, td)
    want = tgd.traceback_rle_plain(wdirs, tm, tn, td)
    torch.cuda.synchronize()
    for g, x in zip(got, want):
        assert torch.equal(g, x)
    assert (got[2] <= tgd.RUNS_CAP).any()


def test_walk_matches_plain_on_random_dirs(cuda):
    """Random direction bytes (keeping ERUN only where j - 1 >= 1 and
    FRUN only where i > 1): many turns, some walks over RUNS_CAP."""
    rng = np.random.default_rng(9)
    B, LQ, K = 200, 256, 128
    ms = rng.integers(0, LQ + 1, B).astype(np.int32)
    ns = np.clip(ms + rng.integers(-40, 41, B), 0, None).astype(np.int32)
    ms[:2] = 0
    ns[0] = 0
    dlo = (np.minimum(0, ns - ms) - 16).astype(np.int32)
    d = rng.integers(0, 32, (B, LQ, K)).astype(np.uint8)
    i = np.arange(1, LQ + 1)[None, :, None]
    j = i + dlo[:, None, None] + np.arange(K)[None, None, :]
    d[np.broadcast_to(j - 1 < 1, d.shape)] &= ~np.uint8(8)
    d[np.broadcast_to(i <= 1, d.shape)] &= ~np.uint8(16)
    args = [torch.from_numpy(a).to(cuda) for a in (d, ms, ns, dlo)]
    got = tgd.traceback_rle(*args)
    want = tgd.traceback_rle_plain(*args)
    torch.cuda.synchronize()
    for g, x in zip(got, want):
        assert torch.equal(g, x)
    assert (got[2] > tgd.RUNS_CAP).any()


@pytest.mark.parametrize("LQ", [64, 128, 1024, 2048])
def test_extend_windows_matches_plain(cuda, LQ):
    """The window entry (K1w) at the device front-end's shapes (LQ a
    multiple of 64, LT = LQ + 128): genome windows with 2 % substitutions,
    every tenth query random, a third of the rows empty slots."""
    rng = np.random.default_rng(LQ)
    G = 100_000
    genome = rng.integers(0, 4, G).astype(np.uint8)
    B, LT = 300, LQ + 128
    k = np.arange(LT)[None, :]
    qlen = rng.integers(0, LQ + 1, B).astype(np.int32)
    tlen = np.minimum(qlen + 100, LT).astype(np.int32)
    h0 = rng.integers(19, 60, B).astype(np.int32)
    empty = np.arange(B) % 3 == 0
    qlen[empty] = 0
    tlen[empty] = 0
    h0[empty] = 0
    start = rng.integers(0, G - LT, B)
    t = genome[start[:, None] + k]
    q = t[:, :LQ].copy()
    sub = rng.random(q.shape) < 0.02
    q[sub] = rng.integers(0, 4, int(sub.sum()))
    q[::10] = rng.integers(0, 4, (len(q[::10]), LQ))
    q[k[:, :LQ] >= qlen[:, None]] = 4
    t[k >= tlen[:, None]] = 4
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
            for a in (q, qlen, t, tlen, h0)]
    n0 = ext.LAUNCHES["extend_windows"]
    got = ext.extend_batch(*args)
    want = ext.extend_batch_plain(*args)
    torch.cuda.synchronize()
    assert ext.LAUNCHES["extend_windows"] == n0 + ext.bin_launches(LQ)
    for key in ext.KEYS:
        assert torch.equal(got[key], want[key]), key
    assert int((got["max_score"] > 50).sum()) > B // 4


@pytest.mark.parametrize("G", [30_000, 2_200_000])
def test_seed_lookup_matches_plain(cuda, G):
    """K4 against its plain version on uint32 (30 kb) and uint16 (2.2 Mb)
    keys, and the device seeder on it against the host seeder."""
    from seeksv_tpu.align.index import KmerIndex
    from seeksv_tpu.align.seed_batch import batch_candidates
    rng = np.random.default_rng(G)
    genome = rng.integers(0, 4, G).astype(np.uint8)
    genome[G // 2:G // 2 + 4000] = np.tile(genome[:400], 10)   # repeats
    idx = KmerIndex.build({"c": np.frombuffer(b"ACGT", np.uint8)[genome]},
                          k=19)
    assert idx.keys.dtype == (np.uint32 if G < 100_000 else np.uint16)
    reads = []
    for i in range(700):
        ln = int(rng.integers(30, 1000))
        st = int(rng.integers(0, G - ln))
        r = genome[st:st + ln].copy()
        r[rng.random(ln) < 0.02] = rng.integers(0, 5)
        reads.append(r if i % 2 else np.where(r < 4, 3 - r, 4)[::-1].copy())
    seeder = tsd.TorchDeviceSeeder.from_index(idx, cuda)
    mat, lens = seeder.upload(tsd.pad_reads(reads, idx.k))
    args = (mat, lens, seeder.keys, seeder.prefix_tab, seeder.shift, idx.k,
            seeder.search_iters)
    n0 = tsd.LAUNCHES["seed_lookup"]
    lo, cnt = tsd.seed_lookup(*args)
    want_lo, want_cnt = tsd.seed_lookup_plain(*args)
    torch.cuda.synchronize()
    assert tsd.LAUNCHES["seed_lookup"] == n0 + 1
    assert torch.equal(lo, want_lo) and torch.equal(cnt, want_cnt)
    assert int((cnt > 0).sum()) > 1000
    assert seeder.seed(reads, hit_cap=1 << 22) == batch_candidates(idx,
                                                                   reads)


def _small_dataset(tmp_path):
    from seeksv_tpu_torch.utils.dataset import build_dataset
    return build_dataset(str(tmp_path / "ds"), 300_000, 10, 1000, 1, 2,
                         False, virus_kb=60, virus_events=20)


def _reset(*counts):
    for d in counts:
        for k in d:
            d[k] = 0


def test_slice_on_cuda_matches_force_host(cuda, tmp_path):
    """A small virus-integration run on the card: byte-identical to the
    native host path, through the resident extension and the finalize
    kernels."""
    from seeksv_tpu_torch.pipeline.driver import run_pipeline
    p = _small_dataset(tmp_path)
    _reset(ext.LAUNCHES, tgd.LAUNCHES, tsd.LAUNCHES)
    run_pipeline(p["ref_fa"], p["bam"], str(tmp_path / "dev"),
                 device="cuda")
    counts = {**ext.LAUNCHES, **tgd.LAUNCHES, **tsd.LAUNCHES}
    run_pipeline(p["ref_fa"], p["bam"], str(tmp_path / "host"),
                 device="cuda", force_host=True)
    used = ("extend_left", "extend_right", "banded_dir", "traceback")
    assert min(counts[k] for k in used) > 0, counts
    assert counts["extend_windows"] == counts["seed_lookup"] == 0, counts
    for suffix in ("clip.sam", "sv"):
        assert (tmp_path / f"dev.{suffix}").read_bytes() == \
            (tmp_path / f"host.{suffix}").read_bytes(), suffix


@pytest.mark.parametrize("S", [2, 8, 64])
def test_consensus_scan_matches_plain(cuda, S):
    """K5 against its plain version: groups of noisy copies of three
    templates with empty sides; S = 2 and 8 overflow, 64 does not."""
    from seeksv_tpu_torch.ops import consensus_scan as cs
    from torch_inputs import CONSENSUS_KEYS as KEYS
    from torch_inputs import random_groups
    arrays = [torch.from_numpy(a).to(cuda)
              for a in random_groups(S, NG=500, G=40, LL=300, LR=280)]
    n0 = cs.LAUNCHES["consensus_scan"]
    got = cs.consensus_scan_groups(*arrays, 17, 20, max_slots=S)
    want = cs.consensus_scan_plain(*arrays, 17, 20, max_slots=S)
    torch.cuda.synchronize()
    assert cs.LAUNCHES["consensus_scan"] == n0 + 1
    for k in KEYS:
        assert torch.equal(got[k], want[k]), k
    assert bool(want["overflow"].any()) == (S < 64)
    assert int(want["support"].max()) > 1


@pytest.mark.parametrize("window_cap", [64, 512])
def test_discordant_count_matches_plain(cuda, window_cap):
    """K6 against its plain version: every case, tandem junctions, capped
    and empty windows."""
    from seeksv_tpu_torch.ops import discordant as dc
    from torch_inputs import discordant_args, discordant_windows
    rec, jun = discordant_windows(window_cap, R=20_000, J=3_000)
    ra, ja = ([torch.from_numpy(x).to(cuda) for x in a]
              for a in discordant_args(rec, jun))
    n0 = dc.LAUNCHES["discordant_count"]
    got = dc.discordant_count_batch(*ra, *ja, window_cap=window_cap)
    want = dc.discordant_count_plain(*ra, *ja, window_cap=window_cap)
    torch.cuda.synchronize()
    assert dc.LAUNCHES["discordant_count"] == n0 + 1
    assert torch.equal(got, want)
    assert int(got.sum()) > 0
    assert int(got[:8].abs().sum()) == 0          # empty windows


def test_spmd_on_one_rank_nccl_matches_force_host(cuda, tmp_path):
    """spmd_run_pipeline on a one-rank NCCL mesh: byte-identical to the
    native host path, through K1w, K2/K3, K5 and K6 (no resident
    extension)."""
    import gzip

    import torch.distributed as dist

    from seeksv_tpu_torch.ops import consensus_scan as cs
    from seeksv_tpu_torch.ops import discordant as dc
    from seeksv_tpu_torch.parallel.mesh import make_mesh
    from seeksv_tpu_torch.parallel.spmd_pipeline import spmd_run_pipeline
    from seeksv_tpu_torch.pipeline.driver import run_pipeline
    p = _small_dataset(tmp_path)
    created = not dist.is_initialized()
    mesh = make_mesh("cuda")
    try:
        _reset(ext.LAUNCHES, tgd.LAUNCHES, tsd.LAUNCHES, cs.LAUNCHES,
               dc.LAUNCHES)
        spmd_run_pipeline(mesh, p["ref_fa"], p["bam"], str(tmp_path / "dev"))
        counts = {**ext.LAUNCHES, **tgd.LAUNCHES, **tsd.LAUNCHES,
                  **cs.LAUNCHES, **dc.LAUNCHES}
    finally:
        if created:
            dist.destroy_process_group()
    run_pipeline(p["ref_fa"], p["bam"], str(tmp_path / "host"),
                 device="cuda", force_host=True)
    used = ("extend_windows", "banded_dir", "traceback", "consensus_scan",
            "discordant_count")
    assert min(counts[k] for k in used) > 0, counts
    assert all(v == 0 for k, v in counts.items() if k not in used), counts
    for suffix in ("clip.sam", "sv"):
        assert (tmp_path / f"dev.{suffix}").read_bytes() == \
            (tmp_path / f"host.{suffix}").read_bytes(), suffix
    with gzip.open(tmp_path / "dev.clip.gz") as a, \
            gzip.open(tmp_path / "host.clip.gz") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("flag", ["device_align", "device_seed"])
def test_front_end_on_cuda_matches_force_host(cuda, tmp_path, flag):
    """The same run with a device front-end: device_align through K4, K1w
    and the finalize kernels (no resident extension), device_seed through
    K4 and the resident extension; no chunk overflows to the host."""
    from seeksv_tpu_torch.pipeline.driver import run_pipeline
    p = _small_dataset(tmp_path)
    _reset(ext.LAUNCHES, tgd.LAUNCHES, tsd.LAUNCHES, tsd.OVERFLOW)
    run_pipeline(p["ref_fa"], p["bam"], str(tmp_path / "dev"),
                 device="cuda", **{flag: True})
    counts = {**ext.LAUNCHES, **tgd.LAUNCHES, **tsd.LAUNCHES}
    run_pipeline(p["ref_fa"], p["bam"], str(tmp_path / "host"),
                 device="cuda", force_host=True)
    used = {"device_align": ("seed_lookup", "extend_windows", "banded_dir",
                             "traceback"),
            "device_seed": ("seed_lookup", "extend_left", "extend_right",
                            "banded_dir", "traceback")}[flag]
    assert min(counts[k] for k in used) > 0, counts
    assert all(v == 0 for k, v in counts.items() if k not in used), counts
    assert tsd.OVERFLOW["to_host"] == 0
    for suffix in ("clip.sam", "sv"):
        assert (tmp_path / f"dev.{suffix}").read_bytes() == \
            (tmp_path / f"host.{suffix}").read_bytes(), suffix
