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
    n0 = tgd.LAUNCHES["banded_dir"]
    score, dirs = tgd.banded_direction(tq, tm, tt, td, tn, K)
    ws, wdirs = tgd.banded_direction_plain(
        tq, tm, tgd.build_t2(tt, tn, td, K, LQ), td, tn, K, LQ)
    torch.cuda.synchronize()
    # one kernel launch per k_real bin of the band width
    assert tgd.band_launches(K) == {128: 2, 256: 3}[K]
    assert tgd.LAUNCHES["banded_dir"] == n0 + tgd.band_launches(K)
    assert torch.equal(score, ws)
    rows = torch.arange(1, LQ + 1, device=cuda)[None, :] <= tm[:, None]
    assert torch.equal(dirs[rows], wdirs[rows])
    got = tgd.traceback_rle(dirs, tm, tn, td)
    want = tgd.traceback_rle_plain(wdirs, tm, tn, td)
    torch.cuda.synchronize()
    for g, x in zip(got, want):
        assert torch.equal(g, x)
    assert (got[2] <= tgd.RUNS_CAP).any()


def _assert_direction_matches_plain(cuda, q, t, ms, ns, w, K):
    LQ = q.shape[1]
    dlo = (np.minimum(0, ns - ms) - w).astype(np.int32)
    tq, tm, tt, td, tn = (torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
                          for a in (q, ms, t, dlo, ns))
    score, dirs = tgd.banded_direction(tq, tm, tt, td, tn, K)
    ws, wdirs = tgd.banded_direction_plain(
        tq, tm, tgd.build_t2(tt, tn, td, K, LQ), td, tn, K, LQ)
    torch.cuda.synchronize()
    assert torch.equal(score, ws)
    rows = torch.arange(1, LQ + 1, device=cuda)[None, :] <= tm[:, None]
    assert torch.equal(dirs[rows], wdirs[rows])
    return tm, td, tn


@pytest.mark.parametrize("LQ", [512, 1024, 2048])
@pytest.mark.parametrize("w,K", [(16, 128), (64, 256)])
def test_banded_direction_bin_edges_match_plain(cuda, w, K, LQ):
    """K2 at every edge of its k_real bins and one past it (33, 64, 65,
    128 columns at rung 16; 129, 160, 161, 192, 193, 256 at rung 64), with
    n - m of either sign, at m = 257 and m = LQ, every whole row 1..m of
    the direction block: exact."""
    from torch_inputs import band_edge_lengths, finalize_pairs
    rng = np.random.default_rng(K + LQ)
    LT = LQ + 128
    ms, ns = band_edge_lengths(w, K, LQ, LT)
    q, t = finalize_pairs(rng, ms, ns, LQ, LT)
    tm, td, tn = _assert_direction_matches_plain(cuda, q, t, ms, ns, w, K)
    _order, seg = tgd.plan_band_bins(tm, td, tn, K)
    assert (torch.diff(seg) > 0).all()          # every bin holds jobs
    assert int(tm.max()) == LQ and int(tm.min()) == 257


@pytest.mark.parametrize("w,K", [(16, 128), (64, 256)])
def test_banded_direction_of_one_job_matches_plain(cuda, w, K):
    """A sub-batch of one job (what rung 64 gets when one job of a chunk
    needs it), in the narrowest and in the widest bin."""
    from torch_inputs import finalize_pairs
    rng = np.random.default_rng(w)
    LQ = 1024
    for m, n in ((700, 700), (600, 600 + K - 2 * w - 1)):
        ms, ns = np.asarray([m], np.int32), np.asarray([n], np.int32)
        q, t = finalize_pairs(rng, ms, ns, LQ, LQ)
        _assert_direction_matches_plain(cuda, q, t, ms, ns, w, K)


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


@pytest.mark.parametrize("K", [128, 256])
@pytest.mark.parametrize("case", ["long_gaps", "row0", "col0", "runs_cap",
                                  "idle"])
def test_walk_matches_plain_on_adversarial_blocks(cuda, case, K):
    """K3 on direction blocks built to leave its windows (128 rows of one
    32-byte sector): D and I runs past 32 and 64 steps, walks that end
    along row 0 or column 0, exactly RUNS_CAP runs and RUNS_CAP + 1,
    m = n = 0 jobs between live ones (tests/torch_inputs.py)."""
    from torch_inputs import adversarial_walks
    args = [torch.from_numpy(a).to(cuda) for a in adversarial_walks(case, K)]
    n0 = tgd.LAUNCHES["traceback"]
    got = tgd.traceback_rle(*args)
    want = tgd.traceback_rle_plain(*args)
    torch.cuda.synchronize()
    assert tgd.LAUNCHES["traceback"] == n0 + 1
    for g, x in zip(got, want):
        assert torch.equal(g, x)
    if case == "runs_cap":
        assert set(want[2].tolist()) >= {tgd.RUNS_CAP, tgd.RUNS_CAP + 1}


@pytest.mark.parametrize("key_bits", [16, 32])
def test_seed_lookup_matches_plain_on_bucket_edges(cuda, key_bits):
    """K4 on tables whose buckets hold 0, 1, W - 1, W, W + 1, 2W +- 1, 40,
    100 and 70 keys (W: the keys of one 16-byte load), repeated keys, the
    last bucket, k-mers holding code 4; the keys also at an offset of one
    key (not 16-byte aligned)."""
    from torch_inputs import bucket_table
    k, keys, tab, _pos, _span, reads = bucket_table(key_bits)
    mat, lens, _NP, _LP = tsd.pad_reads(reads, k)
    kt = tsd.key_tensor(keys, cuda)
    odd = torch.cat([kt[:1], kt])[1:]               # not 16-byte aligned
    assert odd.data_ptr() % 16
    for keys_t in (kt, odd):
        args = (torch.from_numpy(mat).to(cuda), torch.from_numpy(lens).to(cuda),
                keys_t, torch.from_numpy(tab).to(cuda), 2 * k - 8, k,
                tsd.search_iterations(tab))
        lo, cnt = tsd.seed_lookup(*args)
        want_lo, want_cnt = tsd.seed_lookup_plain(*args)
        torch.cuda.synchronize()
        assert torch.equal(lo, want_lo) and torch.equal(cnt, want_cnt)
    assert int((cnt > 1).sum()) > 50


def test_dispatch_and_walk_and_lookup_wait_for_no_host(cuda):
    """plan_bins, plan_band_bins and the K3 and K4 wrappers under
    torch.cuda.set_sync_debug_mode("error"): none of them waits for the
    card."""
    from torch_inputs import adversarial_walks, bucket_table
    rng = np.random.default_rng(2)
    B, LQ = 500, 1024
    qlen = torch.from_numpy(rng.integers(0, LQ + 300, B).astype(np.int32))
    tlen = torch.from_numpy(rng.integers(0, LQ + 100, B).astype(np.int32))
    qlen, tlen = qlen.to(cuda), tlen.to(cuda)
    ms = rng.integers(257, LQ + 1, B).astype(np.int32)
    ns = np.clip(ms + rng.integers(-40, 41, B), 257, LQ).astype(np.int32)
    walk = [torch.from_numpy(a).to(cuda)
            for a in adversarial_walks("long_gaps", 256)]
    k, keys, tab, _pos, _span, reads = bucket_table(16)
    mat, lens, _NP, _LP = tsd.pad_reads(reads, k)
    look = (torch.from_numpy(mat).to(cuda), torch.from_numpy(lens).to(cuda),
            tsd.key_tensor(keys, cuda), torch.from_numpy(tab).to(cuda),
            2 * k - 8, k, tsd.search_iterations(tab))
    bands = {}
    for w, K in tgd.TorchDeviceGlobalAligner.RUNGS:
        dlo = (np.minimum(0, ns - ms) - w).astype(np.int32)
        bands[K] = [torch.from_numpy(a).to(cuda) for a in (ms, dlo, ns)]
    tgd.traceback_rle(*walk)                # build the library first
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ext.plan_bins(qlen, tlen, LQ)
        for K, (tm, td, tn) in bands.items():
            tgd.plan_band_bins(tm, td, tn, K)
        tgd.traceback_rle(*walk)
        tsd.seed_lookup(*look)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


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


@pytest.mark.parametrize("S", [4, 40])
def test_consensus_scan_group_sizes_match_plain(cuda, S):
    """K5 on groups of 0, 1, 2, 8, 9 and G reads with sides of up to 999
    bytes, the last eight of random reads (they overflow S = 4)."""
    from seeksv_tpu_torch.ops import consensus_scan as cs
    from torch_inputs import CONSENSUS_KEYS as KEYS
    from torch_inputs import sized_groups
    G = 40
    sizes = [0, 1, 2, 8, 9, G] * 6 + [G // 2] * 8
    arrays = [torch.from_numpy(a).to(cuda)
              for a in sized_groups(S, sizes, G, 999, 999, S_random=8)]
    got = cs.consensus_scan_groups(*arrays, 17, 20, max_slots=S)
    want = cs.consensus_scan_plain(*arrays, 17, 20, max_slots=S)
    torch.cuda.synchronize()
    for k in KEYS:
        assert torch.equal(got[k], want[k]), k
    assert int(want["overflow"].sum()) == (8 if S == 4 else 0)
    assert int(want["support"].max()) > 4
    # the kernel's outputs alone, in an order made before
    order = cs.plan_groups(arrays[1], arrays[3], arrays[4])
    bare = cs.consensus_scan_groups(*arrays, 17, 20, max_slots=S,
                                    with_sides=False, order=order)
    assert "sl_seq" not in bare
    for k in bare:
        assert torch.equal(bare[k], want[k]), k


def test_consensus_scan_group_past_the_shared_memory_matches_plain(cuda):
    """Groups of 2,000 reads: their lengths and slot state take more than
    the 12 KB of shared memory a warp has, so the kernel keeps them in
    device memory; the groups of 3 and 1 reads beside them keep theirs on
    chip."""
    from seeksv_tpu_torch.ops import consensus_scan as cs
    from torch_inputs import CONSENSUS_KEYS as KEYS
    from torch_inputs import sized_groups
    G, S = 2000, 8
    assert (2 * G + 3 * S) * 4 > 12 * 1024
    arrays = [torch.from_numpy(a).to(cuda)
              for a in sized_groups(1, [G, 3, G, 1], G, 40, 36)]
    got = cs.consensus_scan_groups(*arrays, 17, 20, max_slots=S)
    want = cs.consensus_scan_plain(*arrays, 17, 20, max_slots=S)
    torch.cuda.synchronize()
    for k in KEYS:
        assert torch.equal(got[k], want[k]), k
    assert int(want["support"].max()) > 100


@pytest.mark.parametrize("window_cap", [64, 512])
def test_discordant_count_matches_plain(cuda, window_cap):
    """K6 against its plain version: every case, tandem junctions, capped
    and empty windows."""
    from seeksv_tpu_torch.ops import discordant as dc
    from torch_inputs import (discordant_args, discordant_packed,
                              discordant_windows)
    rec, jun = discordant_windows(window_cap, R=20_000, J=3_000)
    ra, ja = ([torch.from_numpy(x).to(cuda) for x in a]
              for a in discordant_args(rec, jun))
    packed = discordant_packed(rec, jun, cuda)
    n0 = dc.LAUNCHES["discordant_count"]
    got = dc.discordant_count_batch(*packed, window_cap=window_cap)
    want = dc.discordant_count_plain(*ra, *ja, window_cap=window_cap)
    torch.cuda.synchronize()
    assert dc.LAUNCHES["discordant_count"] == n0 + 1
    assert torch.equal(got, want)
    assert int(got.sum()) > 0
    assert int(got[:8].abs().sum()) == 0          # empty windows


def test_discordant_count_edge_cases(cuda):
    """K6 against its plain version on every edge case of
    torch_inputs.discordant_edge_cases, and on sorted windows of the SPMD
    form (lo ascending)."""
    from seeksv_tpu_torch.ops import discordant as dc
    from torch_inputs import (discordant_args, discordant_edge_cases,
                              discordant_packed, discordant_windows)
    rec, jun = discordant_windows(7, R=50_000, J=4_000)
    order = np.argsort(jun["lo"], kind="stable")
    cases = discordant_edge_cases() + [
        ("sorted", rec, {k: v[order] for k, v in jun.items()}, 256)]
    for name, rec, jun, window_cap in cases:
        ra, ja = ([torch.from_numpy(x).to(cuda) for x in a]
                  for a in discordant_args(rec, jun))
        n0 = dc.LAUNCHES["discordant_count"]
        got = dc.discordant_count_batch(*discordant_packed(rec, jun, cuda),
                                        window_cap=window_cap)
        want = dc.discordant_count_plain(*ra, *ja, window_cap=window_cap)
        torch.cuda.synchronize()
        assert dc.LAUNCHES["discordant_count"] == n0 + (len(ja[0]) > 0)
        assert torch.equal(got, want), name


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


def test_committed_calibration_is_fresh_on_the_card(cuda):
    """The committed dispatch calibration's fingerprint matches this card
    (its name, its upload rate within 4x)."""
    from seeksv_tpu_torch.align.engine import BatchAligner
    BatchAligner._load_calibration.cache_clear()
    assert BatchAligner.calibration_stale() is None


def test_aln_paired_on_cuda_matches_force_host(cuda, tmp_path):
    """aln -2 on the card: both ends through K1 both ways, the finalize
    through K2 and K3 (600-base ends), both ends' dispatch choosing the
    device under the committed crossovers; the SAM byte-identical to
    force_host's."""
    from seeksv_tpu_torch.align.engine import align_paired_fastq_to_sam
    from torch_inputs import paired_fastqs
    fa, (fq1, fq2) = paired_fastqs(tmp_path, 3, 200_000, 600, 150, 1500, 60,
                                   odd=4, sub_rate=0.01)
    _reset(ext.LAUNCHES, tgd.LAUNCHES, tsd.LAUNCHES)
    res = align_paired_fastq_to_sam(fa, fq1, fq2, str(tmp_path / "d.sam"),
                                    device="cuda")
    counts = {**ext.LAUNCHES, **tgd.LAUNCHES, **tsd.LAUNCHES}
    align_paired_fastq_to_sam(fa, fq1, fq2, str(tmp_path / "h.sam"),
                              device="cuda", force_host=True)
    used = ("extend_left", "extend_right", "banded_dir", "traceback")
    assert min(counts[k] for k in used) > 0, counts
    assert all(v == 0 for k, v in counts.items() if k not in used), counts
    assert all(d["chose_device"] and d["crossover_applied"]
               for d in res["dispatch"]), res["dispatch"]
    assert (tmp_path / "d.sam").read_bytes() == \
        (tmp_path / "h.sam").read_bytes()


def test_cli_run_rescue_profile_on_cuda(cuda, tmp_path):
    """`run --rescue --profile DIR` through the port's CLI on the card:
    force_host's bytes with rescue, and a trace that names the kernels."""
    import gzip
    import json

    from seeksv_tpu_torch import cli
    from seeksv_tpu_torch.pipeline.driver import run_pipeline
    p = _small_dataset(tmp_path)
    assert cli.main(["run", "--rescue", "--profile", str(tmp_path / "prof"),
                     "-o", str(tmp_path / "dev"), p["ref_fa"],
                     p["bam"]]) == 0
    run_pipeline(p["ref_fa"], p["bam"], str(tmp_path / "host"),
                 device="cuda", force_host=True, rescue=True)
    for suffix in ("clip.sam", "sv", "unmapped.clip.fq"):
        assert (tmp_path / f"dev.{suffix}").read_bytes() == \
            (tmp_path / f"host.{suffix}").read_bytes(), suffix
    with gzip.open(tmp_path / "dev.clip.gz") as a, \
            gzip.open(tmp_path / "host.clip.gz") as b:
        assert a.read() == b.read()
    with open(tmp_path / "prof" / "dev.trace.json") as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    for kernel in ("extend_kernel", "banded_dir_kernel", "traceback_kernel"):
        assert any(kernel in n for n in names), kernel


def test_entry_on_cuda_matches_plain(cuda):
    """entry()'s fn(*args) on the card: K1 in one launch (LQ 64, the
    first query-length bin), equal to its plain version."""
    from seeksv_tpu_torch.entry import entry
    fn, args = entry()
    assert all(a.device.type == "cuda" for a in args)
    n0 = ext.LAUNCHES["extend_right"]
    got = fn(*args)
    want = ext.extend_batch_resident_plain(*args, 1 << 16, 64, 128, False)
    torch.cuda.synchronize()
    assert ext.LAUNCHES["extend_right"] == n0 + ext.bin_launches(64) == n0 + 1
    for k in ext.KEYS:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("stream", [True, False], ids=["stream", "whole"])
def test_bench_scale_run_ours_on_cuda_matches_force_host(cuda, tmp_path,
                                                         monkeypatch, stream):
    """bench_scale.run_ours on a short-read dataset (200 kb, 20x, 100 bp)
    on the card: the device arm extends on K1 in the first query-length
    bin, and its .sv, .clip.sam and clip streams equal the forced-host
    arm's."""
    from seeksv_tpu_torch.scripts import bench_scale
    from seeksv_tpu_torch.utils.dataset import build_dataset
    monkeypatch.setenv("HOME", str(tmp_path))
    root = str(tmp_path / "ds")
    build_dataset(root, 200_000, 20, 100, 1, 10, False)
    (tmp_path / "dev").mkdir()
    (tmp_path / "host").mkdir()
    _reset(ext.LAUNCHES, tgd.LAUNCHES)
    _n, st = bench_scale.run_ours(root, str(tmp_path / "dev"), stream=stream,
                                  chunk_records=7_000)
    counts = {**ext.LAUNCHES, **tgd.LAUNCHES}
    bench_scale.run_ours(root, str(tmp_path / "host"), stream=stream,
                         chunk_records=7_000, force_host=True)
    assert counts["extend_left"] > 0 and counts["extend_right"] > 0, counts
    assert st["dispatch"]["chose_device"] and st["dispatch"]["LQ"] <= 128
    assert st["aligner"]["device_extend_s"] > 0
    for suffix in ("clip.sam", "sv"):
        assert (tmp_path / "dev" / f"ours.{suffix}").read_bytes() == \
            (tmp_path / "host" / f"ours.{suffix}").read_bytes(), suffix
    for suffix in ("clip.gz", "clip.fq.gz"):
        assert bench_scale.gz_sha(str(tmp_path / "dev" / f"ours.{suffix}")) \
            == bench_scale.gz_sha(str(tmp_path / "host" / f"ours.{suffix}"))
