"""The port's multi-process pipeline (parallel/multiproc.py) on gloo ranks
against the JAX package: multiprocess_run_pipeline on 2 and 4 ranks of a
single-chromosome genome (flat cuts mid-chromosome) byte-equal to the
port's and the JAX package's sequential run_pipeline, the equal-boundary
group exchange byte-equal to the JAX multi-process run itself, the
one-rank form's per-rank files equal to the sequential ones,
multiprocess_coverage_insert against the JAX spmd_coverage_insert (spill,
a first-N cut in rank 1's half, a rank with no records),
process_allgather, and the multi-process pipeline with jax and the JAX
package refused."""
import gzip
import io
import json
import os
import socket
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
from seeksv_tpu.pipeline.driver import run_pipeline as jax_run_pipeline
from seeksv_tpu_torch.parallel.mesh import make_mesh
from seeksv_tpu_torch.parallel.multiproc import multiprocess_run_pipeline
from seeksv_tpu_torch.parallel.spmd_pipeline import _insert_columns
from seeksv_tpu_torch.pipeline.driver import run_pipeline
from torch_inputs import run_gloo_ranks, single_chrom_dataset
from torch_spmd_worker import plant_spill

# several test workers share few cores: one intra-op thread each
torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "torch_multiproc_worker.py")
JAX_WORKER = os.path.join(HERE, "multihost_worker.py")


def _read(path):
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rb") as f:
        return f.read()


def _ranks(tmp, world, tasks, timeout=240):
    return run_gloo_ranks(WORKER, tmp, world, [json.dumps(tasks)], timeout)


def _sequential(root, bam, fa):
    """The port's run_pipeline on the CPU and the JAX package's on the
    same files; their .sv agree."""
    run_pipeline(fa, bam, str(root / "seq"), device="cpu")
    jax_run_pipeline(fa, bam, str(root / "jax"), filtered_out=io.StringIO())
    assert _read(root / "seq.sv") == _read(root / "jax.sv")
    return _read(root / "seq.sv")


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    root = tmp_path_factory.mktemp("mp_single")
    bam, fa = single_chrom_dataset(root, with_equal_boundary=False)
    want = _sequential(root, bam, fa)
    assert want.count(b"\n") > 2, want
    return root, bam, fa, want


@pytest.mark.parametrize("world", [2, 4])
def test_pipeline_matches_both_sequential_runs(single, world):
    """N gloo ranks, flat cuts mid-chromosome: the rank-0 .sv equals the
    port's and the JAX package's sequential .sv, and the rescue fastq
    the sequential one's."""
    root, bam, fa, want = single
    out = root / f"w{world}"
    out.mkdir()
    logs = _ranks(out, world, [{"task": "pipeline", "out": str(out),
                                "ref_fa": fa, "bam": bam}])
    assert _read(out / "mp.sv") == want
    assert _read(out / "mp.unmapped.clip.fq") == \
        _read(root / "seq.unmapped.clip.fq")
    assert f"flat range [0, {240_000 // world})" in logs[0]
    assert all('"realign"' in x for x in logs)


def test_one_rank_writes_the_sequential_files(single, tmp_path):
    """One rank in this process (gloo on a HashStore): the .sv and the
    rank's own clip.gz, clip.fq.gz and clip.sam equal the sequential
    run's (what chip_smoke.py compares on the card's one-rank mesh)."""
    root, bam, fa, want = single
    created = not dist.is_initialized()
    mesh = make_mesh("cpu")
    try:
        stages = {}
        sv = multiprocess_run_pipeline(mesh, fa, bam, str(tmp_path / "mp"),
                                       stages=stages)
    finally:
        if created:
            dist.destroy_process_group()
    assert sv == str(tmp_path / "mp.sv")
    assert _read(sv) == want
    for suffix in ("clip.gz", "clip.fq.gz", "clip.sam"):
        assert _read(tmp_path / f"mp.p0.{suffix}") == \
            _read(root / f"seq.{suffix}"), suffix
    assert set(stages) >= {"ingest", "getclip", "exchange", "realign",
                           "junctions", "coverage", "discordant", "output",
                           "total"}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_multiprocess(workdir, bam, fa, nproc=2, timeout=300):
    """tests/multihost_worker.py in mode pipeline on nproc jax.distributed
    processes (as tests/test_multihost.py:_run_workers runs it): writes
    workdir/mp.sv and asserts it equals the JAX sequential run."""
    port = _free_port()
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, JAX_WORKER, str(pid), str(nproc), str(port), bam,
         "pipeline", fa, str(workdir)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, env=env, text=True)
        for pid in range(nproc)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"jax worker {pid}:\n{out[-3000:]}"
    assert "MULTIHOST_PIPELINE_OK" in outs[0], outs[0][-3000:]
    return outs


def test_equal_boundary_exchange_matches_jax_multiprocess(tmp_path):
    """Two deletions with identical junction contexts either side of the
    2-rank cut: the boundary-group exchange fires, and the port's .sv
    equals the port's sequential .sv and, byte for byte, the JAX
    multi-process run's on the same files."""
    bam, fa = single_chrom_dataset(tmp_path, with_equal_boundary=True)
    run_pipeline(fa, bam, str(tmp_path / "seq"), device="cpu")
    out = tmp_path / "port"
    out.mkdir()
    logs = _ranks(out, 2, [{"task": "pipeline", "out": str(out),
                            "ref_fa": fa, "bam": bam}])
    assert any("boundary-group exchange" in x for x in logs), logs[0][-2000:]
    jax_dir = tmp_path / "jax"
    jax_dir.mkdir()
    jax_logs = _jax_multiprocess(jax_dir, bam, fa)
    assert any("boundary-group exchange" in x for x in jax_logs)
    assert _read(out / "mp.sv") == _read(jax_dir / "mp.sv")
    assert _read(out / "mp.sv") == _read(tmp_path / "seq.sv")


@pytest.fixture(scope="module")
def coverage_runs(single):
    """multiprocess_coverage_insert on 2 ranks: records halved in file
    order (no cap, the spill, a first-N cap that ends in rank 1's half)
    and all on rank 0 with none on rank 1 (with the spill)."""
    root, bam, _fa, _want = single
    out = root / "cov"
    out.mkdir()
    recs = read_bam(bam)
    ok = _insert_columns(recs, 20)[0]
    in_first_half = int(ok[:recs.n // 2].sum())
    cut = in_first_half + 137
    assert cut < int(ok.sum())
    cases = {"half": ("half", 5_000_000, False),
             "half_spill": ("half", 5_000_000, True),
             "half_cut": ("half", cut, False),
             "empty_rank": ("first", 5_000_000, True)}
    _ranks(out, 2, [{"task": "coverage", "out": str(out), "bam": bam,
                     "tag": tag, "split": split, "n_pairs": n,
                     "spill": spill}
                    for tag, (split, n, spill) in cases.items()])
    return out, recs, cases


@pytest.mark.parametrize("tag", ["half", "half_spill", "half_cut",
                                 "empty_rank"])
def test_coverage_insert_matches_jax(coverage_runs, tag):
    out, recs, cases = coverage_runs
    _split, n_pairs, spill = cases[tag]
    whole = plant_spill(recs) if spill else recs
    jcov, jmean, jdev = jax_coverage_insert(jax_make_mesh(2), whole, 20,
                                            n_pairs)
    got = np.load(out / f"{tag}.npz")
    assert (int(got["mean"]), int(got["dev"])) == (jmean, jdev)
    for t in jcov:
        assert got[f"cov{t}"].dtype == np.int32
        assert np.array_equal(got[f"cov{t}"], jcov[t]), t


def test_process_allgather_round_trips(tmp_path):
    _ranks(tmp_path, 2, [{"task": "allgather", "out": str(tmp_path)}])
    got = np.load(tmp_path / "allgather.npz")
    assert got["b"].dtype == bool and got["b"].shape == (2, 5)
    assert got["b"].tolist() == [[r % (k + 2) == 0 for r in range(5)]
                                 for k in range(2)]
    assert got["i64"].dtype == np.int64
    assert got["i64"].tolist() == [
        [[k, -k], [1 << 40, -(1 << 62) + k]] for k in range(2)]
    assert got["u8"].dtype == np.uint8
    assert got["u8"].tolist() == [[250] * 3, [251] * 3]
    assert got["empty"].shape == (2, 0, 4)
    assert got["empty"].dtype == np.int64


_NO_JAX = """
import os, runpy, sys
REFUSED = ("seeksv_tpu", "jax", "jaxlib")
class _Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in REFUSED:
            raise ImportError("refused: " + name)
sys.meta_path.insert(0, _Refuse())
sys.argv[0] = WORKER
runpy.run_path(WORKER, run_name="__main__")
assert not [m for m in sys.modules if m.split(".")[0] in REFUSED]
print("NO_JAX_OK", flush=True)
"""


def test_two_rank_pipeline_with_the_jax_package_refused(single, tmp_path):
    """multiprocess_run_pipeline on 2 gloo ranks, each in a process whose
    import system refuses jax and seeksv_tpu, writes the sequential .sv."""
    _root, bam, fa, want = single
    shim = tmp_path / "no_jax.py"
    shim.write_text(f"WORKER = {WORKER!r}\n" + _NO_JAX)
    logs = run_gloo_ranks(str(shim), tmp_path, 2, [json.dumps(
        [{"task": "pipeline", "out": str(tmp_path), "ref_fa": fa,
          "bam": bam}])])
    assert all("NO_JAX_OK" in x for x in logs), logs[0][-2000:]
    assert _read(tmp_path / "mp.sv") == want
