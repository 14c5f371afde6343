"""The port's sharded evidence step (parallel/sharded.py), sharded getclip
(parallel/sharded_getclip.py) and batch ops (ops/batch_ops.py) against the
JAX package: the evidence step on one rank in this process and on two gloo
ranks (meshes (2, 1) and (1, 2)) equals the JAX sharded_evidence_step on
make_mesh(1), (2) and (4) exactly, output by output, on the same numpy
batch; getclip_sharded equals getclip and the JAX getclip_sharded for 1, 2
and 4 shards; the match-rate comparators and the reverse complement equal
their jax_kernels counterparts."""
import gzip
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from seeksv_tpu.ops import jax_kernels as jk
from seeksv_tpu.parallel.mesh import make_mesh as jax_make_mesh
from seeksv_tpu.parallel.sharded import \
    make_example_batch as jax_make_example_batch
from seeksv_tpu.parallel.sharded import \
    sharded_evidence_step as jax_sharded_evidence_step
from seeksv_tpu.parallel.sharded_getclip import \
    getclip_sharded as jax_getclip_sharded
from seeksv_tpu_torch.ops import batch_ops
from seeksv_tpu_torch.ops import extend as ext
from seeksv_tpu_torch.parallel import sharded
from seeksv_tpu_torch.parallel.mesh import make_mesh
from seeksv_tpu_torch.parallel.sharded_getclip import getclip_sharded
from seeksv_tpu_torch.pipeline.getclip import getclip
from seeksv_tpu_torch.utils.dataset import build_dataset
from torch_inputs import evidence_batch_numpy, run_gloo_ranks

torch.set_num_threads(1)

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_multiproc_worker.py")
# the batch of tests/test_parallel.py:test_shard_count_invariance; 64
# reads and 32 jobs divide every mesh below
N_READS, N_JOBS, LQ, LT, SEED = 64, 32, 32, 64, 42
SW_KEYS = ("max_score", "qle", "tle", "gscore", "gtle")
OUT_KEYS = ("coverage", "insert_mean", "insert_dev", "cand_sorted_keys",
            "cand_first", "cand_support_sum") + tuple(f"sw_{k}"
                                                      for k in SW_KEYS)


def _flat(res):
    out = {k: np.asarray(v) for k, v in res.items() if k != "sw"}
    out.update({f"sw_{k}": np.asarray(v) for k, v in res["sw"].items()})
    return out


def _jax_step(n, genome_len):
    """The JAX step on make_mesh(n), its batch and outputs as numpy."""
    mesh = jax_make_mesh(n)
    batch = jax_make_example_batch(mesh, genome_len, N_READS, N_JOBS, LQ,
                                   LT, SEED)
    out = _flat(jax_sharded_evidence_step(mesh, genome_len)(batch))
    return {k: np.asarray(v) for k, v in batch.items()}, out


def _same(got, want):
    for k in OUT_KEYS:
        assert got[k].shape == want[k].shape, k
        assert np.array_equal(got[k].astype(np.int64),
                              want[k].astype(np.int64)), k


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The step on two gloo ranks, meshes (2, 1) and (1, 2), at a genome
    length that gp = 2 divides and at one that it does not; each rank's
    outputs and input shards, by (dp, genome_len)."""
    root = tmp_path_factory.mktemp("evidence")
    cases = [(dp, g) for dp in (2, 1) for g in (2048, 2049)]
    run_gloo_ranks(WORKER, root, 2, [json.dumps(
        [{"task": "evidence", "out": str(root), "genome_len": g, "dp": dp,
          "n_reads": N_READS, "n_jobs": N_JOBS, "lq": LQ, "lt": LT,
          "seed": SEED} for dp, g in cases])])
    return {(dp, g): [dict(np.load(root / f"evidence_{dp}_{g}_r{r}.npz"))
                      for r in range(2)] for dp, g in cases}


def _assemble(ranks, dp):
    """The global outputs of a 2-rank (dp, 2 / dp) mesh: the gp blocks of
    the coverage in gp order, the extension shards in rank order, the
    replicated outputs (equal on both ranks) once."""
    out = {}
    for k in OUT_KEYS:
        parts = [r[k] for r in ranks]
        if k.startswith("sw_"):
            out[k] = np.concatenate(parts)
        elif k == "coverage" and dp == 1:
            out[k] = np.concatenate(parts)
        else:
            assert np.array_equal(parts[0], parts[1]), k
            out[k] = parts[0]
    return out


@pytest.mark.parametrize("genome_len", [2048, 2049])
def test_one_rank_matches_jax_one_device(genome_len):
    want_batch, want = _jax_step(1, genome_len)
    batch = evidence_batch_numpy(genome_len, N_READS, N_JOBS, LQ, LT, SEED)
    for k, v in want_batch.items():
        assert np.array_equal(batch[k], v), k
    created = not dist.is_initialized()
    mesh = make_mesh("cpu")
    try:
        got_batch = sharded.make_example_batch(mesh, genome_len, N_READS,
                                               N_JOBS, LQ, LT, SEED)
        n0 = ext.PLAIN_CALLS["extend_windows"]
        got = _flat(sharded.sharded_evidence_step(mesh, genome_len)(
            got_batch))
    finally:
        if created:
            dist.destroy_process_group()
    assert ext.PLAIN_CALLS["extend_windows"] == n0 + 1
    for k, v in batch.items():
        assert np.array_equal(got_batch[k].numpy(), v), k
    _same(got, want)
    assert got["coverage"].max() > 0


def test_one_rank_candidate_runs_match_jax():
    """Keys that repeat (the batch's keys mod 16) with supports of 1 to 5:
    the stable sort, the run flags and the run sums equal the JAX step's
    on make_mesh(1)."""
    genome_len = 2048
    batch = evidence_batch_numpy(genome_len, N_READS, N_JOBS, LQ, LT, SEED)
    rng = np.random.default_rng(1)
    batch["cand_key"] %= 16
    batch["cand_support"] = rng.integers(1, 6, N_READS).astype(np.int32)
    jmesh = jax_make_mesh(1)
    want = _flat(jax_sharded_evidence_step(jmesh, genome_len)(
        {k: jnp.asarray(v) for k, v in batch.items()}))
    created = not dist.is_initialized()
    mesh = make_mesh("cpu")
    try:
        got = _flat(sharded.sharded_evidence_step(mesh, genome_len)(
            sharded.shard_batch(mesh, batch)))
    finally:
        if created:
            dist.destroy_process_group()
    _same(got, want)
    n_runs = int(got["cand_first"].sum())
    assert n_runs == 16
    assert got["cand_support_sum"][:n_runs].sum() == \
        batch["cand_support"].sum()


@pytest.mark.parametrize("dp,n_jax", [(2, 2), (1, 4)])
@pytest.mark.parametrize("genome_len", [2048, 2049])
def test_two_ranks_match_jax(two_ranks, dp, n_jax, genome_len):
    """Mesh (2, 1) against make_mesh(2) = (2, 1), mesh (1, 2) against
    make_mesh(4) = (2, 2): the same gp, so the same coverage blocks (at
    2049 the last position is dropped on both); the input shards are the
    numpy batch's."""
    ranks = two_ranks[(dp, genome_len)]
    batch = evidence_batch_numpy(genome_len, N_READS, N_JOBS, LQ, LT, SEED)
    gp = 2 // dp
    for r, shard in enumerate(ranks):
        d, g = divmod(r, gp)
        for k, v in batch.items():
            n, idx = (dp, d) if k in sharded.DP_KEYS else (2, r)
            per = len(v) // n
            assert np.array_equal(shard[f"in_{k}"],
                                  v[idx * per:(idx + 1) * per]), (r, k)
    _jb, want = _jax_step(n_jax, genome_len)
    got = _assemble(ranks, dp)
    _same(got, want)
    assert len(got["coverage"]) == genome_len // gp * gp


def test_shard_count_invariance(two_ranks):
    """tests/test_parallel.py:test_shard_count_invariance on the port: the
    same batch on one rank and on two ranks of either shape gives the
    same coverage, insert model, candidate map and sorted extension
    scores."""
    created = not dist.is_initialized()
    mesh = make_mesh("cpu")
    try:
        one = _flat(sharded.sharded_evidence_step(mesh, 2048)(
            sharded.make_example_batch(mesh, 2048, seed=SEED)))
    finally:
        if created:
            dist.destroy_process_group()

    def cand_map(o):
        f = o["cand_first"].astype(bool)
        return dict(zip(o["cand_sorted_keys"][f].tolist(),
                        o["cand_support_sum"][:int(f.sum())].tolist()))
    for dp in (2, 1):
        two = _assemble(two_ranks[(dp, 2048)], dp)
        assert (one["coverage"] == two["coverage"]).all()
        assert int(one["insert_mean"][0]) == int(two["insert_mean"][0])
        assert int(one["insert_dev"][0]) == int(two["insert_dev"][0])
        assert cand_map(one) == cand_map(two)
        for k in SW_KEYS:
            assert (np.sort(one[f"sw_{k}"]) == np.sort(two[f"sw_{k}"])).all()


@pytest.fixture(scope="module")
def clip_bam(tmp_path_factory):
    root = tmp_path_factory.mktemp("sharded_getclip")
    p = build_dataset(str(root / "ds"), 300_000, 10, 1000, 1, 2, False,
                      virus_kb=60, virus_events=20)
    getclip(p["bam"], str(root / "one"))
    return root, p["bam"]


def _gz(path):
    with gzip.open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_getclip_sharded_matches_getclip_and_jax(clip_bam, n_shards):
    root, bam = clip_bam
    getclip_sharded(bam, str(root / f"port{n_shards}"), n_shards=n_shards)
    jax_getclip_sharded(bam, str(root / f"jax{n_shards}"), n_shards=n_shards)
    for suffix in ("clip.gz", "clip.fq.gz"):
        want = _gz(root / f"one.{suffix}")
        assert want.count(b"\n") > 10, suffix
        assert _gz(root / f"port{n_shards}.{suffix}") == want, suffix
        assert _gz(root / f"jax{n_shards}.{suffix}") == want, suffix


def _pairs(seed, N=96, L=80):
    """Byte rows of lengths 0..L (zero lengths included), random bytes
    past each row's length; every sixth pair a copy with a few bytes
    changed, every twelfth an exact copy, so match counts run from 0 to
    the full length."""
    rng = np.random.default_rng(seed)
    a = rng.integers(65, 85, (N, L)).astype(np.uint8)
    b = rng.integers(65, 85, (N, L)).astype(np.uint8)
    b[::6] = a[::6]
    b[::6, ::7] = 78
    b[::12] = a[::12]
    alen = rng.integers(0, L + 1, N).astype(np.int32)
    blen = rng.integers(0, L + 1, N).astype(np.int32)
    alen[:3] = 0
    blen[3:5] = 0
    blen[::6] = alen[::6]
    return a, alen, b, blen


@pytest.mark.parametrize("name", ["match_rate_pairs_begin",
                                  "match_rate_pairs_end"])
def test_match_rate_pairs_match_jax(name):
    a, alen, b, blen = _pairs(7)
    m, n = getattr(batch_ops, name)(*(torch.from_numpy(x)
                                      for x in (a, alen, b, blen)))
    jm, jn = getattr(jk, name)(*(jnp.asarray(x) for x in (a, alen, b, blen)))
    assert m.dtype == torch.int32
    assert np.array_equal(m.numpy(), np.asarray(jm))
    assert np.array_equal(n.numpy(), np.asarray(jn))
    assert (n.numpy() == 0).sum() >= 5
    assert (m.numpy() == n.numpy())[n.numpy() > 0].any()


def test_revcomp_batch_matches_jax():
    """Codes 0-4 (N kept), lengths 0..L, padding of other values left in
    place."""
    rng = np.random.default_rng(3)
    N, L = 40, 30
    seq = rng.integers(0, 5, (N, L)).astype(np.int32)
    lens = rng.integers(0, L + 1, N).astype(np.int32)
    lens[:2] = (0, L)
    pad = np.arange(L)[None, :] >= lens[:, None]
    seq[pad] = rng.integers(5, 9, int(pad.sum()))
    got = batch_ops.revcomp_batch(torch.from_numpy(seq),
                                  torch.from_numpy(lens)).numpy()
    want = np.asarray(jk.revcomp_batch(jnp.asarray(seq), jnp.asarray(lens)))
    assert np.array_equal(got, want)
    assert np.array_equal(got[pad], seq[pad])
    for i in range(N):
        fwd = seq[i, :lens[i]]
        assert (got[i, :lens[i]] == np.where(fwd[::-1] < 4, 3 - fwd[::-1],
                                              4)).all()
