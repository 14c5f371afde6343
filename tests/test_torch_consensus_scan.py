"""The port's consensus merge (K5's plain version and the wrapper on the
CPU) against the JAX package's consensus_scan_groups, exact on every
returned key: random groups (several seeds, max_slots 2 / 8 / 16 with
overflow, thresholds 85/100 and 9/10, empty sides) and the real clip
groups of a simulated BAM."""
import numpy as np
import pytest
import torch

from seeksv_tpu.ops.consensus_scan import consensus_scan_groups as jax_scan
from seeksv_tpu_torch.ops import consensus_scan as cs
from seeksv_tpu_torch.parallel.spmd_pipeline import (clip_insert_streams,
                                                     consensus_inputs)
from torch_inputs import CONSENSUS_KEYS as KEYS
from torch_inputs import random_groups

# several test workers share few cores: one intra-op thread each
torch.set_num_threads(1)


def _jax(seq_l, len_l, seq_r, len_r, n_reads, num, den, S):
    # the reference carries qualities beside the sequences and returns
    # none of them: the sequences stand in
    out = jax_scan(seq_l, len_l, seq_l, seq_r, len_r, seq_r, n_reads, num,
                   den, max_slots=S)
    return {k: np.asarray(v) for k, v in out.items()}


def _assert_equal(got, want):
    assert set(got) == set(want) == set(KEYS)
    for k in KEYS:
        g = got[k].numpy()
        assert g.shape == want[k].shape, k
        assert np.array_equal(g, want[k]), k


@pytest.mark.parametrize("num,den", [(85, 100), (9, 10)])
@pytest.mark.parametrize("S", [2, 8, 16])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_matches_jax_on_random_groups(seed, S, num, den):
    arrays = random_groups(seed)
    want = _jax(*arrays, num, den, S)
    got = cs.consensus_scan_plain(*map(torch.from_numpy, arrays), num, den,
                                  max_slots=S)
    _assert_equal(got, want)
    if S == 2:
        assert want["overflow"].any()


def test_wrapper_on_cpu_runs_plain_and_rebuilds_sides():
    """The wrapper takes the plain version for CPU tensors (counted); the
    side rows rebuilt from src_l/src_r (the CUDA path's way) equal the
    carried ones."""
    arrays = [torch.from_numpy(a) for a in random_groups(5)]
    n0 = cs.PLAIN_CALLS["consensus_scan"]
    got = cs.consensus_scan_groups(*arrays, 85, 100, max_slots=4)
    assert cs.PLAIN_CALLS["consensus_scan"] == n0 + 1
    assert cs.LAUNCHES["consensus_scan"] == 0
    want = cs.consensus_scan_plain(*arrays, 85, 100, max_slots=4)
    rebuilt = cs._with_sides(
        {k: want[k] for k in ("src_l", "src_r")}, arrays[0], arrays[1],
        arrays[2], arrays[3])
    for k in KEYS:
        assert torch.equal(got[k], want[k]), k
    for k in ("sl_seq", "sl_len", "sr_seq", "sr_len"):
        assert torch.equal(rebuilt[k], want[k]), k
    with pytest.raises(TypeError):
        cs.consensus_scan_groups(arrays[0], arrays[1].long(), *arrays[2:],
                                 85, 100)


@pytest.fixture(scope="module")
def clip_groups(tmp_path_factory):
    """The breakpoint-key groups of the small simulated virus dataset, as
    spmd_getclip builds them."""
    from seeksv_tpu.io.bam import read_bam
    from seeksv_tpu_torch.utils.dataset import build_dataset
    root = tmp_path_factory.mktemp("cs")
    p = build_dataset(str(root / "ds"), 300_000, 10, 1000, 1, 2, False,
                      virus_kb=60, virus_events=20)
    segments = clip_insert_streams(read_bam(p["bam"]), 0.85, 20, False)
    groups = {}
    for si, (_tid, lev, rev) in enumerate(segments):
        for side, events in ((0, lev), (1, rev)):
            for ev in events:
                groups.setdefault((si, side, ev[0]), []).append(ev)
    return list(groups.values())


@pytest.mark.parametrize("S", [2, 8])
def test_plain_matches_jax_on_real_clip_groups(clip_groups, S):
    G = max(len(v) for v in clip_groups)
    LL = max(len(ev[1]) for v in clip_groups for ev in v)
    LR = max(len(ev[3]) for v in clip_groups for ev in v)
    arrays = consensus_inputs(clip_groups, G, LL, LR)
    assert len(clip_groups) > 20 and G > 8
    want = _jax(*arrays, 17, 20, S)
    got = cs.consensus_scan_plain(*map(torch.from_numpy, arrays), 17, 20,
                                  max_slots=S)
    _assert_equal(got, want)
    assert (want["support"] > 1).any()


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_plan_groups_matches_numpy(seed):
    """The order in which the kernel takes the groups against a numpy
    restatement: every group exactly once, by falling live bytes, equal
    groups in index order; a group of at most one read counts no bytes
    and comes after every group that compares."""
    seq_l, len_l, seq_r, len_r, n_reads = random_groups(seed, NG=60)
    NG = len(n_reads)
    tensors = tuple(map(torch.from_numpy, (len_l, len_r, n_reads)))
    order = cs.plan_groups(*tensors)
    assert order.dtype == torch.int32
    order = order.numpy()
    need = np.zeros(NG, np.int64)
    for k in range(NG):
        n = int(n_reads[k])
        if n > 1:
            need[k] = int(len_l[k, :n].sum()) + int(len_r[k, :n].sum())
    np.testing.assert_array_equal(cs.live_bytes(*tensors).numpy(), need)
    want = sorted(range(NG), key=lambda k: (-need[k], k))
    assert order.tolist() == want
    multi = int((n_reads > 1).sum())
    assert 0 < multi < NG
    assert (n_reads[order[:multi]] > 1).all()


def test_live_bytes_ignores_rows_past_n_reads():
    """Lengths left in the rows past a group's n_reads (padding of an
    earlier, larger group) count nothing."""
    len_l = torch.tensor([[5, 7, 9, 11], [5, 7, 9, 11]], dtype=torch.int32)
    len_r = torch.tensor([[1, 2, 3, 4], [1, 2, 3, 4]], dtype=torch.int32)
    n_reads = torch.tensor([2, 9], dtype=torch.int32)
    assert cs.live_bytes(len_l, len_r, n_reads).tolist() == [15, 42]
    assert cs.plan_groups(len_l, len_r, n_reads).tolist() == [1, 0]
