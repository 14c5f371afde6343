"""The port's device front-ends and its streaming ``run`` end to end on a
short-read simulated dataset (1 Mb host + 200 kb virus panel, 100 bp
reads at 20x, 215 clip reads): ``run_pipeline(device_align=True)``,
``(device_seed=True)`` and ``run_pipeline_streaming`` must write what the
JAX package's ``run`` writes under the same flags, byte for byte, through
the kernels' plain versions on the CPU; ``run --stream --device-align``
must run in a process where jax cannot be imported."""
import gzip
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from seeksv_tpu.pipeline.driver import run_pipeline as jax_run_pipeline
from seeksv_tpu.pipeline.stream import \
    run_pipeline_streaming as jax_run_pipeline_streaming
from seeksv_tpu_torch.io import native
from seeksv_tpu_torch.io.bam import iter_bam_chunks_python
from seeksv_tpu_torch.ops import extend as ext
from seeksv_tpu_torch.ops import seed_device as tsd
from seeksv_tpu_torch.pipeline.driver import run_pipeline
from seeksv_tpu_torch.pipeline.getclip import GetclipStream
from seeksv_tpu_torch.pipeline.stream import (StreamStats,
                                              run_pipeline_streaming)
from seeksv_tpu_torch.utils.dataset import build_dataset

# several test workers share few cores: one intra-op thread each keeps
# the plain versions' many small ops from oversubscribing them
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHUNK_RECORDS = 50_000          # several decode slabs of the BAM


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("short")
    paths = build_dataset(str(root / "ds"), 1_000_000, 20, 100, 1, 20,
                          False, virus_kb=200, virus_events=80,
                          virus_div=0.04)
    return root, paths


def _same_outputs(a, b):
    for ext_ in ("clip.sam", "sv"):
        with open(f"{a}.{ext_}", "rb") as fa, open(f"{b}.{ext_}", "rb") as fb:
            assert fa.read() == fb.read(), ext_
    for ext_ in ("clip.gz", "clip.fq.gz"):
        with gzip.open(f"{a}.{ext_}") as fa, gzip.open(f"{b}.{ext_}") as fb:
            assert fa.read() == fb.read(), ext_


@pytest.mark.parametrize("flag", ["device_align", "device_seed"])
def test_run_flag_matches_jax_run(dataset, flag):
    root, paths = dataset
    jax_run_pipeline(paths["ref_fa"], paths["bam"], str(root / f"jax_{flag}"),
                     **{flag: True})
    calls = dict(ext.PLAIN_CALLS)
    lookups = tsd.PLAIN_CALLS["seed_lookup"]
    overflow = dict(tsd.OVERFLOW)
    res = run_pipeline(paths["ref_fa"], paths["bam"], str(root / flag),
                       device="cpu", **{flag: True})
    _same_outputs(root / flag, root / f"jax_{flag}")
    with open(root / f"{flag}.clip.sam") as f:
        assert sum(1 for line in f if not line.startswith("@")) > 200
    assert tsd.PLAIN_CALLS["seed_lookup"] > lookups
    assert tsd.OVERFLOW == overflow
    windows = ext.PLAIN_CALLS["extend_windows"] > calls["extend_windows"]
    resident = ext.PLAIN_CALLS["extend_left"] > calls["extend_left"]
    assert (windows, resident) == ((True, False) if flag == "device_align"
                                   else (False, True))
    timings = res["aligner"].timings
    assert timings["device_extend_s" if flag == "device_align"
                   else "seed_s"] > 0


def test_streaming_matches_jax_streaming(dataset):
    root, paths = dataset
    jax_run_pipeline_streaming(paths["ref_fa"], paths["bam"],
                               str(root / "jax_stream"),
                               chunk_records=CHUNK_RECORDS, device_seed=True)
    res = run_pipeline_streaming(paths["ref_fa"], paths["bam"],
                                 str(root / "stream"), device="cpu",
                                 chunk_records=CHUNK_RECORDS,
                                 device_seed=True)
    _same_outputs(root / "stream", root / "jax_stream")
    assert set(res["stages_s"]) >= {"native", "scan_bam", "index", "realign",
                                    "getsv", "total"}
    assert res["aligner"].device_seed


def _consume(slabs, prefix):
    """getclip and the scan's statistics over the slabs, as scan_bam
    feeds them; whether every slab carried the CIGAR summary."""
    g = GetclipStream(str(prefix))
    stats = StreamStats(20, 5_000_000)
    summarised = []
    for recs in slabs:
        summarised.append(recs.summarised())
        g.process(recs)
        stats.process(recs)
    g.close()
    return stats, summarised


def test_consumers_read_the_summary_as_the_numpy_forms(dataset):
    """GetclipStream and StreamStats fed the native stream's slabs (the
    CIGAR summary in their memo) and the Python decoder's (the forms
    computed from the CIGARs) write the same getclip outputs, keep the
    same discordant-counting columns, coverage and insert size."""
    root, paths = dataset
    got, got_sum = _consume(native.iter_bam_chunks_native(
        paths["bam"], CHUNK_RECORDS, lazy_seq=True), root / "summary")
    want, want_sum = _consume(iter_bam_chunks_python(
        paths["bam"], CHUNK_RECORDS), root / "computed")
    assert len(got_sum) == len(want_sum) > 1
    assert all(got_sum) and not any(want_sum)
    for ext_ in ("clip.gz", "clip.fq.gz", "unmapped_1.fq.gz",
                 "unmapped_2.fq.gz"):
        with gzip.open(root / f"summary.{ext_}") as fa, \
                gzip.open(root / f"computed.{ext_}") as fb:
            a = fa.read()
            assert a and a == fb.read(), ext_
    la, lb = got.light(), want.light()
    assert la.n == lb.n > 0
    for k in ("pos", "mpos", "mtid", "l_qseq", "flag", "mapq", "isize",
              "tid", "end", "hard"):
        np.testing.assert_array_equal(getattr(la, k), getattr(lb, k), k)
    ca, cb = got.coverage(), want.coverage()
    assert ca.keys() == cb.keys()
    for t in ca:
        np.testing.assert_array_equal(ca[t], cb[t], t)
    assert got.insert_size() == want.insert_size() != (0, 0)


_NO_JAX = """
import runpy, sys
class _NoJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ImportError("jax is blocked: " + name)
for m in [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")]:
    del sys.modules[m]
sys.meta_path.insert(0, _NoJax())
sys.argv = ["seeksv_tpu_torch"] + sys.argv[1:]
try:
    runpy.run_module("seeksv_tpu_torch", run_name="__main__")
except SystemExit as e:
    if e.code:
        raise
assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")]
from seeksv_tpu_torch.ops import extend, seed_device
assert extend.PLAIN_CALLS["extend_windows"] > 0, extend.PLAIN_CALLS
assert extend.PLAIN_CALLS["extend_left"] == 0, extend.PLAIN_CALLS
assert seed_device.PLAIN_CALLS["seed_lookup"] > 0, seed_device.PLAIN_CALLS
assert seed_device.OVERFLOW["to_host"] == 0, seed_device.OVERFLOW
print("NO_JAX_OK")
"""


def test_stream_device_align_runs_with_jax_blocked(dataset, tmp_path):
    """`python -m seeksv_tpu_torch run --device cpu --stream --device-align`
    with every jax import refused writes the JAX package's device_align
    outputs."""
    root, paths = dataset
    prefix = root / "jax_device_align"
    if not os.path.exists(f"{prefix}.sv"):
        jax_run_pipeline(paths["ref_fa"], paths["bam"], str(prefix),
                         device_align=True)
    env = dict(os.environ, HOME=str(tmp_path), OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [REPO] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p]))
    out = subprocess.run(
        [sys.executable, "-c", _NO_JAX, "run", "--device", "cpu", "--stream",
         "--chunk-records", str(CHUNK_RECORDS), "--device-align", "-o",
         str(tmp_path / "nojax"), paths["ref_fa"], paths["bam"]],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "NO_JAX_OK" in out.stdout
    _same_outputs(tmp_path / "nojax", prefix)
