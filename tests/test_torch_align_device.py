"""The port's device front-end (seeksv_tpu_torch.ops.align_device and the
engine's device_seed / device_align branches) against the JAX package's
on the same inputs, exactly (every output is an integer, tolerance 0),
on the CPU: the kernels' plain versions on the port's side, the XLA scan
on the JAX side (as tests/test_align_device.py runs it there)."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seeksv_tpu.align.engine import ENCODE, BatchAligner
from seeksv_tpu.align.index import KmerIndex
from seeksv_tpu.align.seed_batch import batch_candidates
from seeksv_tpu.ops import align_device as jad
from seeksv_tpu_torch.align.engine import TorchBatchAligner
from seeksv_tpu_torch.ops import align_device as tad
from seeksv_tpu_torch.ops import extend as ext
from seeksv_tpu_torch.ops import seed_device as tsd

# several test workers share few cores: one intra-op thread each keeps
# the plain versions' many small ops from oversubscribing them
torch.set_num_threads(1)

BASES = np.frombuffer(b"ACGT", np.uint8)


def _fields(alns):
    """Every field of every Alignment, supplementary parts included (the
    two packages each have their own Alignment class)."""
    return [dataclasses.asdict(a) for a in alns]


@pytest.fixture(scope="module")
def genome():
    """tests/test_align_device.py:38-71: a random genome around a repeat
    block (here over two chromosomes, so that windows meet a chromosome
    edge), and 153 reads of 20-150 bp with substitutions, N bases, indels,
    an all-N read, a random read and a read inside the repeat."""
    rng = np.random.default_rng(23)
    unit = rng.integers(0, 4, 300).astype(np.uint8)
    g = np.concatenate(
        [rng.integers(0, 4, 5000).astype(np.uint8)] + [unit] * 10 +
        [rng.integers(0, 4, 5000).astype(np.uint8)])
    idx = KmerIndex.build({"c1": BASES[g[:9000]], "c2": BASES[g[9000:]]},
                          k=19)
    seqs = []
    for _ in range(150):
        ln = int(rng.integers(20, 151))
        st = int(rng.integers(0, len(g) - ln))
        r = g[st:st + ln].copy()
        mut = rng.random(ln) < 0.04
        r[mut] = rng.integers(0, 4, int(mut.sum()))
        r[rng.random(ln) < 0.01] = 4
        if rng.random() < 0.3:
            cut = int(rng.integers(5, ln - 5))
            if rng.random() < 0.5:
                r = np.delete(r, slice(cut, min(cut + 3, ln - 1)))
            else:
                r = np.insert(r, cut, rng.integers(0, 4, 2).astype(np.uint8))
        seqs.append(bytes(np.where(r < 4, BASES[np.minimum(r, 3)],
                                   ord("N")).astype(np.uint8)))
    seqs.append(b"N" * 40)
    seqs.append(bytes(BASES[rng.integers(0, 4, 50)]))
    seqs.append(bytes(BASES[unit[:60]]))
    return idx, seqs


def _strands(seqs):
    reads = []
    for s in seqs:
        fwd = ENCODE[np.frombuffer(s, np.uint8)]
        reads.extend([fwd, np.where(fwd[::-1] < 4, 3 - fwd[::-1],
                                    4).astype(np.uint8)])
    return reads


def test_seed_and_gather_matches_jax(genome):
    """All 17 outputs, windows included, against JAX _seed_and_gather."""
    idx, seqs = genome
    mat, lens, NP, LP = tsd.pad_reads(_strands(seqs), idx.k)
    al = tad.TorchDeviceAligner(idx, "cpu")
    got = tad.seed_and_gather(al.seeder, al.ref, al.chrom_starts,
                              torch.from_numpy(mat), torch.from_numpy(lens),
                              1 << 16, LP + 128)
    jal = jad.DeviceAligner(idx)
    s = jal.seeder
    with jax.enable_x64(True):
        want = jad._seed_and_gather(
            s.keys, s.prefix_tab, jnp.int64(s.shift), s.positions, jal.ref,
            jal.chrom_starts, jnp.asarray(mat), jnp.asarray(lens),
            jnp.int64(s.ref_span), k=idx.k, hit_cap=1 << 16, n_jobs=NP,
            nk=LP - idx.k + 1, LT=LP + 128)
        want = [np.asarray(x) for x in want]
    assert len(got) == len(want) == 17
    for i, (g, w) in enumerate(zip(got, want)):
        assert tuple(g.shape) == w.shape, i
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f"output {i}")
    for i in (0, 2, 4, 6):
        assert got[i].dtype == torch.uint8
    assert int((got[1] > 0).sum()) > 100 and int((got[7] > 0).sum()) > 100


def test_decisions_match_jax():
    rng = np.random.default_rng(7)
    J = 500
    i32 = [rng.integers(-60, 200, J).astype(np.int32) for _ in range(5)]
    i32[1][::7] = ext.NEG_INF
    i64 = [rng.integers(0, 10_000, J).astype(np.int64) for _ in range(3)]
    with jax.enable_x64(True):
        want_l = jad._left_decision(*(jnp.asarray(a) for a in
                                      (*i32, *i64[:2])))
        want_r = jad._right_decision(*(jnp.asarray(a) for a in (*i32, *i64)))
        want = [np.asarray(x) for x in (*want_l, *want_r)]
    t = [torch.from_numpy(a) for a in (*i32, *i64)]
    got = (*tad.left_decision(*t[:7]), *tad.right_decision(*t))
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f"output {i}")


def test_align_jobs_matches_jax(genome, monkeypatch):
    """TorchDeviceAligner.align_jobs against DeviceAligner.align_jobs with
    CHUNK = 64 on both sides (several chunks, a short last one)."""
    idx, seqs = genome
    monkeypatch.setattr(jad.DeviceAligner, "CHUNK", 64)
    monkeypatch.setattr(tad.TorchDeviceAligner, "CHUNK", 64)
    reads = _strands(seqs[:100])
    before = ext.PLAIN_CALLS["extend_windows"]
    got = tad.TorchDeviceAligner(idx, "cpu").align_jobs(reads)
    assert ext.PLAIN_CALLS["extend_windows"] == before + 2 * 4
    want = jad.DeviceAligner(idx).align_jobs(reads)
    assert got == want
    assert sum(len(v) for v in got.values()) > 100


@pytest.mark.parametrize("flag", ["device_align", "device_seed"])
def test_batch_aligner_flag_matches_jax_and_host(genome, flag):
    """TorchBatchAligner with the flag against BatchAligner with it and
    against the host path, at the Alignment level."""
    idx, seqs = genome
    calls = dict(ext.PLAIN_CALLS)
    lookups = tsd.PLAIN_CALLS["seed_lookup"]
    overflow = dict(tsd.OVERFLOW)
    tal = TorchBatchAligner(idx, device="cpu", **{flag: True})
    got = tal.batch_align(seqs)
    assert tsd.PLAIN_CALLS["seed_lookup"] > lookups
    assert tsd.OVERFLOW == overflow
    if flag == "device_align":
        assert ext.PLAIN_CALLS["extend_windows"] > calls["extend_windows"]
        assert ext.PLAIN_CALLS["extend_left"] == calls["extend_left"]
        assert tal.timings["device_extend_s"] > 0
    else:
        assert ext.PLAIN_CALLS["extend_windows"] == calls["extend_windows"]
        assert ext.PLAIN_CALLS["extend_left"] > calls["extend_left"]
        assert tal.timings["seed_s"] > 0
    assert _fields(got) == _fields(
        BatchAligner(idx, **{flag: True}).batch_align(seqs))
    assert _fields(got) == _fields(BatchAligner(idx).batch_align(seqs))
    assert sum(a.mapped for a in got) > 100


def test_device_align_overflow_falls_back(monkeypatch):
    """tests/test_align_device.py:74-98: every chunk overflows a ladder
    capped at 256 hits, so the batch is seeded on the host and extended
    on the resident path, and counted."""
    rng = np.random.default_rng(5)
    unit = rng.integers(0, 4, 100).astype(np.uint8)
    g = np.concatenate([unit] * 80)
    idx = KmerIndex.build({"c1": BASES[g]}, k=19)
    orig = tad.TorchDeviceAligner.align_jobs
    calls = {}

    def patched(self, reads, hit_cap=256, max_hit_cap=256):
        out = orig(self, reads, hit_cap=hit_cap, max_hit_cap=max_hit_cap)
        calls["overflowed"] = out is None
        return out
    monkeypatch.setattr(tad.TorchDeviceAligner, "align_jobs", patched)
    seqs = [bytes(BASES[g[:90]]) for _ in range(64)]
    before = dict(tsd.OVERFLOW)
    left = ext.PLAIN_CALLS["extend_left"]
    got = TorchBatchAligner(idx, device="cpu",
                            device_align=True).batch_align(seqs)
    assert calls["overflowed"]
    assert tsd.OVERFLOW["to_host"] == before["to_host"] + 1
    assert tsd.OVERFLOW["hit_cap_retries"] == before["hit_cap_retries"]
    assert ext.PLAIN_CALLS["extend_left"] > left
    assert _fields(got) == _fields(BatchAligner(idx).batch_align(seqs))


def test_device_seed_ladder_and_overflow():
    """The device seeder's chunks retry at 4x the cap, and a chunk beyond
    the largest cap is seeded on the host; both give batch_candidates."""
    rng = np.random.default_rng(5)
    unit = rng.integers(0, 4, 100).astype(np.uint8)
    g = np.concatenate([unit] * 80)
    idx = KmerIndex.build({"c1": BASES[g]}, k=19)
    reads = [g[i:i + 90].copy() for i in range(0, 640, 10)]
    tal = TorchBatchAligner(idx, device="cpu", device_seed=True)
    want = batch_candidates(idx, reads)
    before = dict(tsd.OVERFLOW)
    # 64 reads x 72 k-mers x 80 hits = 368,640: 256 -> 1,048,576 in 6 steps
    assert tal._device_candidates(reads, 256, 1 << 20) == want
    assert tsd.OVERFLOW["hit_cap_retries"] == before["hit_cap_retries"] + 6
    assert tsd.OVERFLOW["to_host"] == before["to_host"]
    assert tal._device_candidates(reads, 256, 256) == want
    assert tsd.OVERFLOW["to_host"] == before["to_host"] + 1
