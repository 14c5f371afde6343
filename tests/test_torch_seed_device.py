"""The port's device seeding (seeksv_tpu_torch.ops.seed_device) against
the JAX package's seeding kernel and the host seeders, exactly (every
output is an integer, tolerance 0), on the CPU: K4's plain version, the
whole seed_core and TorchDeviceSeeder.  Two genomes: the repeat genome of
tests/test_seed_device.py (uint32 low-bit keys) and a 2.2 Mb one (uint16
keys, the flagship's layout)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seeksv_tpu.align.index import KmerIndex
from seeksv_tpu.align.seed_batch import batch_candidates
from seeksv_tpu.ops import seed_device as jsd
from seeksv_tpu_torch.ops import seed_device as tsd

# several test workers share few cores: one intra-op thread each keeps
# the plain versions' many small ops from oversubscribing them
torch.set_num_threads(1)

BASES = np.frombuffer(b"ACGT", np.uint8)


def _repeat_genome():
    """tests/test_seed_device.py:45-69: a 400 bp unit repeated 30 times
    between random flanks, and 122 reads with substitutions, N bases, an
    all-N read and a read inside the repeat."""
    rng = np.random.default_rng(11)
    unit = rng.integers(0, 4, 400).astype(np.uint8)
    genome = np.concatenate([
        rng.integers(0, 4, 3000).astype(np.uint8)] +
        [unit] * 30 + [rng.integers(0, 4, 3000).astype(np.uint8)])
    idx = KmerIndex.build({"c1": BASES[genome]}, k=19)
    reads = []
    for _ in range(120):
        ln = int(rng.integers(15, 120))
        st = int(rng.integers(0, len(genome) - ln))
        r = genome[st:st + ln].copy()
        mut = rng.random(ln) < 0.05
        r[mut] = rng.integers(0, 4, int(mut.sum()))
        r[rng.random(ln) < 0.02] = 4
        reads.append(r)
    reads.append(np.full(60, 4, np.uint8))
    reads.append(unit[:50].copy())
    return idx, reads


def _large_genome():
    """2.2 Mb over two chromosomes (>= 2^21 k-mers: uint16 keys), reads of
    60-150 bp from both strands with 2 % substitutions, some across the
    chromosome boundary, some random."""
    rng = np.random.default_rng(21)
    chroms = {"a": rng.integers(0, 4, 1_500_000).astype(np.uint8),
              "b": rng.integers(0, 4, 700_000).astype(np.uint8)}
    idx = KmerIndex.build({n: BASES[g] for n, g in chroms.items()}, k=19)
    g = np.concatenate(list(chroms.values()))
    reads = []
    for i in range(150):
        ln = int(rng.integers(60, 151))
        st = int(rng.integers(0, len(g) - ln))
        if i % 15 == 0:
            st = 1_500_000 - ln // 2              # across the boundary
        r = g[st:st + ln].copy()
        mut = rng.random(ln) < 0.02
        r[mut] = rng.integers(0, 4, int(mut.sum()))
        if i % 2:
            r = np.where(r < 4, 3 - r, 4)[::-1].astype(np.uint8)
        if i % 10 == 3:
            r = rng.integers(0, 4, ln).astype(np.uint8)
        reads.append(r)
    return idx, reads


@pytest.fixture(scope="module", params=["repeat", "large"])
def case(request):
    idx, reads = (_repeat_genome if request.param == "repeat"
                  else _large_genome)()
    return request.param, idx, reads


def test_key_layouts(case):
    name, idx, _ = case
    assert idx.keys.dtype == (np.uint32 if name == "repeat" else np.uint16)


def test_lookup_plain_matches_host_index(case):
    """K4's plain version against KmerIndex.hash_read + lookup, read by
    read: the same ranges for every valid k-mer, cnt 0 elsewhere."""
    _, idx, reads = case
    mat, lens, NP, LP = tsd.pad_reads(reads, idx.k)
    keys = tsd.key_tensor(idx.keys, "cpu")
    before = tsd.PLAIN_CALLS["seed_lookup"]
    lo, cnt = tsd.seed_lookup(
        torch.from_numpy(mat), torch.from_numpy(lens), keys,
        torch.from_numpy(np.asarray(idx.prefix_tab, np.int64)),
        idx._prefix_shift(idx.k), idx.k,
        tsd.search_iterations(idx.prefix_tab))
    assert tsd.PLAIN_CALLS["seed_lookup"] == before + 1
    nk = LP - idx.k + 1
    lo = lo.numpy().reshape(NP, nk)
    cnt = cnt.numpy().reshape(NP, nk)
    n_hits = 0
    for i, r in enumerate(reads):
        offs, hashes = idx.hash_read(r)
        want_cnt = np.zeros(nk, np.int64)
        if len(offs):
            h_lo, h_hi = idx.lookup(hashes)
            c = h_hi - h_lo
            c = np.where((c > 0) & (c <= tsd.MAX_OCC), c, 0)
            want_cnt[offs] = c
            hit = c > 0
            np.testing.assert_array_equal(lo[i, offs[hit]], h_lo[hit])
            n_hits += int(hit.sum())
        np.testing.assert_array_equal(cnt[i], want_cnt, err_msg=f"read {i}")
    assert n_hits > 100
    assert not cnt[len(reads):].any()


@pytest.mark.parametrize("hit_cap", [256, 1 << 12, 1 << 16])
def test_seed_core_matches_jax(case, hit_cap):
    """All six outputs of seed_core against JAX _seed_kernel on the same
    padded batch (256: an overflowing cap; its outputs are defined all
    the same and must agree too)."""
    _, idx, reads = case
    mat, lens, NP, LP = tsd.pad_reads(reads, idx.k)
    nk = LP - idx.k + 1
    seeder = tsd.TorchDeviceSeeder.from_index(idx, "cpu")
    got = seeder.core(torch.from_numpy(mat), torch.from_numpy(lens),
                      hit_cap)
    jseed = jsd.DeviceSeeder(idx)
    with jax.enable_x64(True):
        want = jsd._seed_kernel(
            jseed.keys, jseed.prefix_tab, jnp.int64(jseed.shift),
            jseed.positions, jnp.asarray(mat), jnp.asarray(lens),
            jnp.int64(jseed.ref_span), k=idx.k, hit_cap=hit_cap, n_jobs=NP,
            nk=nk)
        want = [np.asarray(x) for x in want]
    names = ("diag", "q_start", "anchor_len", "votes", "n_cand", "overflow")
    for name, g, w in zip(names, got, want):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    if hit_cap in (256, 1 << 16):
        assert bool(got[5]) == (hit_cap == 256)
    assert int(got[4].sum()) > 0


def test_seeder_matches_jax_and_host(case):
    _, idx, reads = case
    got = tsd.TorchDeviceSeeder.from_index(idx, "cpu").seed(reads,
                                                           hit_cap=1 << 16)
    assert got is not None
    assert got == batch_candidates(idx, reads)
    assert got == jsd.DeviceSeeder(idx).seed(reads, hit_cap=1 << 16)


def test_seeder_overflow_returns_none():
    """tests/test_seed_device.py:72-79: 64 reads inside an 80-fold repeat
    overflow hit_cap 256."""
    rng = np.random.default_rng(3)
    unit = rng.integers(0, 4, 100).astype(np.uint8)
    genome = np.concatenate([unit] * 80)
    idx = KmerIndex.build({"c1": BASES[genome]}, k=19)
    reads = [genome[:90].copy() for _ in range(64)]
    seeder = tsd.TorchDeviceSeeder.from_index(idx, "cpu")
    assert seeder.seed(reads, hit_cap=256) is None
    assert jsd.DeviceSeeder(idx).seed(reads, hit_cap=256) is None
    # 64 reads x 72 k-mers x 80 hits
    assert seeder.seed(reads, hit_cap=1 << 19) == batch_candidates(idx,
                                                                   reads)


def test_pad_reads_matches_reference():
    rng = np.random.default_rng(4)
    reads = [rng.integers(0, 5, int(n)).astype(np.uint8)
             for n in rng.integers(0, 300, 70)]
    for k in (19, 400):
        got, want = tsd.pad_reads(reads, k), jsd.pad_reads(reads, k)
        if want is None:
            assert got is None
            continue
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert tsd.pad_reads([], 19) is None
    with pytest.raises(ValueError):
        tsd.pad_reads([np.zeros(2100, np.uint8)], 19)


def test_lookup_rejects_bad_inputs():
    mat = torch.full((2, 32), 4, dtype=torch.uint8)
    lens = torch.zeros(2, dtype=torch.int64)
    tab = torch.zeros(5, dtype=torch.int64)
    keys = torch.zeros(3, dtype=torch.int16)
    with pytest.raises(TypeError):
        tsd.seed_lookup(mat, lens, keys.long(), tab, 0, 19, 1)
    with pytest.raises(TypeError):
        tsd.seed_lookup(mat.int(), lens, keys, tab, 0, 19, 1)
    with pytest.raises(ValueError):
        tsd.seed_lookup(mat, lens[:1], keys, tab, 0, 19, 1)
    with pytest.raises(ValueError):
        tsd.seed_lookup(mat, lens, keys, tab, 0, 40, 1)
    with pytest.raises(TypeError):
        tsd.key_tensor(np.zeros(3, np.uint64), "cpu")


def _bucket_index(key_bits):
    """tests/torch_inputs.py:bucket_table as the JAX package's KmerIndex
    (the host index of the reference), with its reads."""
    from torch_inputs import bucket_table
    k, keys, tab, pos, ref_span, reads = bucket_table(key_bits)
    idx = KmerIndex(k, np.zeros(ref_span, np.uint8), ["c"],
                    np.asarray([0, ref_span], np.int64), keys, pos, tab)
    return idx, reads


@pytest.mark.parametrize("key_bits", [16, 32])
def test_lookup_plain_matches_host_index_on_bucket_edges(key_bits):
    """K4's plain version against KmerIndex.hash_read + lookup on a table
    whose buckets hold 0, 1, W - 1, W, W + 1, 2W +- 1, 40, 100 and 70 keys
    (W: the keys of one 16-byte load), with repeated keys, 16- and 32-bit
    residuals, the first and the last bucket, and k-mers holding code 4."""
    idx, reads = _bucket_index(key_bits)
    assert idx.keys.dtype == (np.uint16 if key_bits == 16 else np.uint32)
    W = 16 // idx.keys.dtype.itemsize
    widths = set(np.diff(idx.prefix_tab).tolist())
    assert {0, 1, W - 1, W, W + 1, 100} <= widths and max(widths) > 64
    mat, lens, NP, LP = tsd.pad_reads(reads, idx.k)
    lo, cnt = tsd.seed_lookup(
        torch.from_numpy(mat), torch.from_numpy(lens),
        tsd.key_tensor(idx.keys, "cpu"), torch.from_numpy(idx.prefix_tab),
        idx._prefix_shift(idx.k), idx.k,
        tsd.search_iterations(idx.prefix_tab))
    nk = LP - idx.k + 1
    lo = lo.numpy().reshape(NP, nk)
    cnt = cnt.numpy().reshape(NP, nk)
    hit_widths = set()
    for i, r in enumerate(reads):
        offs, hashes = idx.hash_read(r)
        want_cnt = np.zeros(nk, np.int64)
        if len(offs):
            h_lo, h_hi = idx.lookup(hashes)
            c = h_hi - h_lo
            want_cnt[offs] = np.where((c > 0) & (c <= tsd.MAX_OCC), c, 0)
            np.testing.assert_array_equal(lo[i, offs], h_lo, err_msg=str(i))
            p = (hashes >> np.uint64(idx._prefix_shift(idx.k))).astype(int)
            hit_widths |= set(np.diff(idx.prefix_tab)[p[c > 0]].tolist())
        np.testing.assert_array_equal(cnt[i], want_cnt, err_msg=f"read {i}")
    assert (cnt > 1).sum() > 50                      # repeated keys
    assert {1, W - 1, W, W + 1, 100, 70} <= hit_widths
    assert any((r == 4).any() and len(r) > 2 * idx.k for r in reads)


def test_seed_core_matches_jax_on_bucket_edges():
    """seed_core against the JAX _seed_kernel on the bucket-edge table
    (uint16 residuals)."""
    idx, reads = _bucket_index(16)
    mat, lens, NP, LP = tsd.pad_reads(reads, idx.k)
    got = tsd.TorchDeviceSeeder.from_index(idx, "cpu").core(
        torch.from_numpy(mat), torch.from_numpy(lens), 1 << 14)
    jseed = jsd.DeviceSeeder(idx)
    with jax.enable_x64(True):
        want = jsd._seed_kernel(
            jseed.keys, jseed.prefix_tab, jnp.int64(jseed.shift),
            jseed.positions, jnp.asarray(mat), jnp.asarray(lens),
            jnp.int64(jseed.ref_span), k=idx.k, hit_cap=1 << 14, n_jobs=NP,
            nk=LP - idx.k + 1)
        want = [np.asarray(x) for x in want]
    names = ("diag", "q_start", "anchor_len", "votes", "n_cand", "overflow")
    for name, g, w in zip(names, got, want):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert not bool(got[5]) and int(got[4].sum()) > 100
