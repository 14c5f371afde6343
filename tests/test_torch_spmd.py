"""The port's SPMD pipeline on torch.distributed gloo meshes against the
JAX package: the mesh shape, spmd_run_pipeline on one rank in this
process and on two ranks in two processes (byte-identical to JAX's
spmd_run_pipeline on make_mesh(2) and to seeksv_tpu's run_pipeline),
spmd_coverage_insert with a first-N cap that cuts mid-shard and the
isize >= 65536 spill, the engine's mesh branch, and the slice's modules
in a process where jax cannot be imported."""
import gzip
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from seeksv_tpu.io.bam import read_bam
from seeksv_tpu.parallel.mesh import make_mesh as jax_make_mesh
from seeksv_tpu.parallel.spmd_pipeline import \
    spmd_coverage_insert as jax_coverage_insert
from seeksv_tpu.parallel.spmd_pipeline import \
    spmd_run_pipeline as jax_spmd_run_pipeline
from seeksv_tpu.pipeline.driver import run_pipeline as jax_run_pipeline
from seeksv_tpu.pipeline.getsv import calculate_insert_size, compute_coverage
from seeksv_tpu_torch.ops import consensus_scan as cs
from seeksv_tpu_torch.ops import discordant as dc
from seeksv_tpu_torch.ops import extend as ext
from seeksv_tpu_torch.parallel.mesh import make_mesh, mesh_shape
from seeksv_tpu_torch.parallel.spmd_pipeline import (spmd_coverage_insert,
                                                     spmd_run_pipeline)
from seeksv_tpu_torch.utils.dataset import build_dataset
from torch_spmd_worker import plant_spill

# several test workers share few cores: one intra-op thread each
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_spmd_worker.py")


def same_outputs(a, b):
    for s in ("clip.sam", "sv"):
        with open(f"{a}.{s}", "rb") as fa, open(f"{b}.{s}", "rb") as fb:
            assert fa.read() == fb.read(), s
    for s in ("clip.gz", "clip.fq.gz"):
        with gzip.open(f"{a}.{s}") as fa, gzip.open(f"{b}.{s}") as fb:
            assert fa.read() == fb.read(), s


def run_ranks(tmp, world, ref_fa, bam, tasks, timeout=240):
    """Run tests/torch_spmd_worker.py as `world` gloo ranks joined through
    a FileStore under tmp; kill them all if any is not done in
    `timeout` s (a hung collective fails the test, not the suite)."""
    env = dict(os.environ, OMP_NUM_THREADS="1", HOME=str(tmp),
               PYTHONPATH=os.pathsep.join(
                   [REPO] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p]))
    store = str(tmp / "store")
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), str(world), store, str(tmp),
         ref_fa, bam, *tasks], cwd=str(tmp), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-4000:]}"


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """The small simulated virus dataset; the JAX package's
    spmd_run_pipeline on make_mesh(2) and its run_pipeline on it."""
    root = tmp_path_factory.mktemp("spmd")
    p = build_dataset(str(root / "ds"), 300_000, 10, 1000, 1, 2, False,
                      virus_kb=60, virus_events=20)
    jax_spmd_run_pipeline(jax_make_mesh(2), p["ref_fa"], p["bam"],
                          str(root / "jax_spmd"))
    jax_run_pipeline(p["ref_fa"], p["bam"], str(root / "jax_run"))
    same_outputs(root / "jax_spmd", root / "jax_run")
    return root, p


@pytest.fixture(scope="module")
def mesh1():
    created = not dist.is_initialized()
    mesh = make_mesh("cpu")
    yield mesh
    if created:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def two_ranks(dataset):
    root, p = dataset
    out = root / "two"
    out.mkdir()
    run_ranks(out, 2, p["ref_fa"], p["bam"],
              ["pipeline", "coverage:137", "coverage:5000000:spill",
               "coverage_gp:5000000"])
    return out


@pytest.mark.parametrize("n", range(1, 9))
def test_mesh_shape_matches_jax(n):
    assert mesh_shape(n) == jax_make_mesh(n).devices.shape


def test_spmd_run_pipeline_one_rank(dataset, mesh1):
    root, p = dataset
    before = (dict(ext.PLAIN_CALLS), cs.PLAIN_CALLS["consensus_scan"],
              dc.PLAIN_CALLS["discordant_count"])
    res = spmd_run_pipeline(mesh1, p["ref_fa"], p["bam"],
                            str(root / "port1"))
    same_outputs(root / "port1", root / "jax_spmd")
    same_outputs(root / "port1", root / "jax_run")
    assert ext.PLAIN_CALLS["extend_windows"] > before[0]["extend_windows"]
    assert ext.PLAIN_CALLS["extend_left"] == before[0]["extend_left"]
    assert cs.PLAIN_CALLS["consensus_scan"] > before[1]
    assert dc.PLAIN_CALLS["discordant_count"] > before[2]
    assert set(res["stages_s"]) >= {"read_bam", "getclip", "realign",
                                    "getsv", "total"}


def test_spmd_run_pipeline_two_ranks(dataset, two_ranks):
    root, _p = dataset
    same_outputs(two_ranks / "spmd", root / "jax_spmd")
    same_outputs(two_ranks / "spmd", root / "jax_run")
    assert not list(two_ranks.glob(".rank*")), "a private directory stayed"


def _coverage_want(bam, n_pairs, spill):
    recs = read_bam(bam)
    if spill:
        recs = plant_spill(recs)
    return recs, compute_coverage(recs, 20), calculate_insert_size(
        recs, 20, n_pairs)


@pytest.mark.parametrize("tag,n_pairs,spill", [
    ("coverage_137", 137, False),
    ("coverage_5000000_spill", 5_000_000, True),
    ("coverage_gp_5000000", 5_000_000, False)])
def test_coverage_insert_two_ranks(dataset, two_ranks, tag, n_pairs, spill):
    """Two ranks (dp 2, or gp 2 for coverage_gp) against JAX's step on
    make_mesh(2) and the host: the first-N cap of 137 pairs ends inside
    the first dp shard, and five records spill past the histogram."""
    _root, p = dataset
    recs, cov, ins = _coverage_want(p["bam"], n_pairs, spill)
    jcov, jmean, jdev = jax_coverage_insert(jax_make_mesh(2), recs, 20,
                                            n_pairs)
    got = np.load(two_ranks / f"{tag}.npz")
    assert (int(got["mean"]), int(got["dev"])) == (jmean, jdev) == ins
    for t in cov:
        assert np.array_equal(got[f"cov{t}"], cov[t]), t
        assert np.array_equal(got[f"cov{t}"], jcov[t]), t


@pytest.mark.parametrize("n_pairs,spill", [(137, False), (5_000_000, True)])
def test_coverage_insert_one_rank(dataset, mesh1, n_pairs, spill):
    _root, p = dataset
    recs, cov, ins = _coverage_want(p["bam"], n_pairs, spill)
    got, mean, dev = spmd_coverage_insert(mesh1, recs, 20, n_pairs)
    assert (mean, dev) == ins
    for t in cov:
        assert got[t].dtype == np.int32
        assert np.array_equal(got[t], cov[t]), t


def test_engine_mesh_branch_matches_no_mesh(dataset, mesh1):
    """TorchBatchAligner with a shard mesh (windows cut on the host, K1w's
    plain version per rank, results all-gathered) aligns as without one
    (the resident path)."""
    from seeksv_tpu.pipeline.driver import _read_fastq, write_sam
    from seeksv_tpu_torch.align.engine import TorchBatchAligner
    root, p = dataset
    seqs, quals = _read_fastq(str(root / "jax_run.clip.fq.gz"))
    # 40 clips cut to 150 bases: short windows keep the plain
    # extension's row loop short
    seqs, quals = [s[:150] for s in seqs[:40]], [q[:150] for q in quals[:40]]
    plain = TorchBatchAligner.from_fasta(p["ref_fa"], device="cpu")
    meshed = TorchBatchAligner(plain.idx, device="cpu")
    meshed.shard_mesh = mesh1
    n0 = dict(ext.PLAIN_CALLS)
    write_sam(plain, seqs, quals, plain.batch_align(seqs),
              str(root / "nomesh.sam"))
    n1 = dict(ext.PLAIN_CALLS)
    write_sam(meshed, seqs, quals, meshed.batch_align(seqs),
              str(root / "mesh.sam"))
    assert (root / "nomesh.sam").read_bytes() == \
        (root / "mesh.sam").read_bytes()
    assert n1["extend_left"] > n0["extend_left"]
    assert ext.PLAIN_CALLS["extend_windows"] == n1["extend_windows"] + 2
    assert ext.PLAIN_CALLS["extend_left"] == n1["extend_left"]


def _consensus_groups(rng, n_groups=30):
    """Breakpoint-key groups of 1 to 14 reads, as getclip's events (pos,
    left side, its qualities, right side, its qualities, CIGAR): noisy
    copies of two templates with sides of varying length, every fifth
    group of random reads (more than 8 slots: the overflow retry)."""
    keys, events = [], []
    for g in range(n_groups):
        tl = rng.integers(0, 4, 60).astype(np.uint8)
        tr = rng.integers(0, 4, 50).astype(np.uint8)
        evs = []
        for r in range(int(rng.integers(1, 15))):
            a, b = (tl, tr) if r % 3 else (tl[::-1].copy(), tr[::-1].copy())
            if g % 5 == 4:
                a, b = rng.integers(0, 4, 60), rng.integers(0, 4, 50)
            s_l = bytes(np.frombuffer(b"ACGT", np.uint8)[
                a[-int(rng.integers(1, 61)):]])
            s_r = bytes(np.frombuffer(b"ACGT", np.uint8)[
                b[:int(rng.integers(1, 51))]])
            evs.append((1000 + g, np.frombuffer(s_l, np.uint8),
                        np.full(len(s_l), 30, np.uint8),
                        np.frombuffer(s_r, np.uint8),
                        np.full(len(s_r), 31, np.uint8), f"{len(s_r)}M"))
        keys.append((0, g % 2, 1000 + g))
        events.append(evs)
    return keys, events


def test_mesh_consensus_asks_for_no_sides(mesh1, monkeypatch):
    """mesh_consensus reads n_slots, overflow, support and the source
    indices only, so it calls K5 with with_sides=False (a spy on the
    call); its one-rank result equals the JAX package's mesh_consensus on
    make_mesh(1), overflow retry included."""
    from seeksv_tpu.parallel.spmd_pipeline import \
        mesh_consensus as jax_mesh_consensus
    from seeksv_tpu_torch.parallel import spmd_pipeline as sp
    keys, events = _consensus_groups(np.random.default_rng(5))
    calls = []
    real = sp.consensus_scan_groups

    def spy(*args, **kwargs):
        calls.append(kwargs)
        return real(*args, **kwargs)
    monkeypatch.setattr(sp, "consensus_scan_groups", spy)
    got = sp.mesh_consensus(mesh1, keys, events, 0.85)
    assert len(calls) == 2                  # max_slots 8, then the retry
    assert all(kw.get("with_sides") is False for kw in calls)
    want = jax_mesh_consensus(jax_make_mesh(1), keys, events, 0.85)

    def plain(consensus):
        return {k: [tuple(x.tobytes() if isinstance(x, np.ndarray) else x
                          for x in e) for e in v]
                for k, v in consensus.items()}
    assert plain(got) == plain(want)
    assert max(len(v) for v in got.values()) > 8
    assert max(e[5] for v in got.values() for e in v) > 3


_NO_JAX = """
import sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
import seeksv_tpu_torch.parallel.mesh
import seeksv_tpu_torch.parallel.spmd_pipeline
import seeksv_tpu_torch.parallel.stream_spmd
import seeksv_tpu_torch.ops.consensus_scan
import seeksv_tpu_torch.ops.discordant
import seeksv_tpu_torch.ops.coverage
from seeksv_tpu_torch.parallel.dryrun import dryrun_multichip
dryrun_multichip(1, "cpu")
assert not [m for m in sys.modules
            if m.split(".")[0] in ("jax", "jaxlib") and sys.modules[m]]
print("NO_JAX_OK")
"""


def test_dryrun_multichip_asks_for_the_card_by_default(monkeypatch):
    """Without a device argument the dry run asks for ``cuda``; on a host
    without a card that raises instead of carrying on on the CPU."""
    import torch.distributed as dist

    from seeksv_tpu_torch.parallel import dryrun
    asked = []

    class Stop(Exception):
        pass

    def fake_mesh(device, n):
        asked.append((device, n))
        raise Stop
    with monkeypatch.context() as mp:
        mp.setattr(dryrun, "make_mesh", fake_mesh)
        with pytest.raises(Stop):
            dryrun.dryrun_multichip(1)
        with pytest.raises(Stop):
            dryrun.dryrun_multichip(1, "cpu")
    assert asked == [("cuda", 1), ("cpu", 1)]
    if not torch.cuda.is_available():
        was = dist.is_initialized()
        with pytest.raises(Exception):
            dryrun.dryrun_multichip(1)
        assert dist.is_initialized() == was


def test_slice_modules_and_dryrun_with_jax_blocked(tmp_path):
    """The slice's modules import, and the one-rank dry run passes, in a
    process where every jax import fails."""
    env = dict(os.environ, HOME=str(tmp_path), OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [REPO] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p]))
    out = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "NO_JAX_OK" in out.stdout
