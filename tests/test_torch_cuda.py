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
    assert ext.LAUNCHES["extend_left" if reverse else "extend_right"] == n0 + 1
    for k in ext.KEYS:
        assert torch.equal(got[k], want[k]), k


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


def test_slice_on_cuda_matches_force_host(cuda, tmp_path):
    """A small virus-integration run on the card: byte-identical to the
    native host path, through all three kernels."""
    from seeksv_tpu_torch.pipeline.driver import run_pipeline
    from seeksv_tpu_torch.utils.dataset import build_dataset
    p = build_dataset(str(tmp_path / "ds"), 300_000, 10, 1000, 1, 2, False,
                      virus_kb=60, virus_events=20)
    for d in (ext.LAUNCHES, tgd.LAUNCHES):
        for k in d:
            d[k] = 0
    run_pipeline(p["ref_fa"], p["bam"], str(tmp_path / "dev"),
                 device="cuda")
    counts = {**ext.LAUNCHES, **tgd.LAUNCHES}
    run_pipeline(p["ref_fa"], p["bam"], str(tmp_path / "host"),
                 device="cuda", force_host=True)
    assert min(counts.values()) > 0, counts
    for suffix in ("clip.sam", "sv"):
        assert (tmp_path / f"dev.{suffix}").read_bytes() == \
            (tmp_path / f"host.{suffix}").read_bytes(), suffix
