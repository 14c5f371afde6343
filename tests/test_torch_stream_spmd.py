"""The port's streaming SPMD pipeline on gloo meshes against the JAX
package: spmd_run_pipeline_streaming with the consensus on the mesh and
on the host, in 1,000-record slabs, on one rank in this process and on
two ranks in two processes, byte-identical to JAX's on make_mesh(2) and
to seeksv_tpu's run_pipeline; SpmdStreamStats against the host
StreamStats across slab boundaries."""
import numpy as np
import pytest
import torch
import torch.distributed as dist

from seeksv_tpu.parallel.mesh import make_mesh as jax_make_mesh
from seeksv_tpu.parallel.stream_spmd import \
    spmd_run_pipeline_streaming as jax_streaming
from seeksv_tpu.pipeline.driver import run_pipeline as jax_run_pipeline
from seeksv_tpu.pipeline.stream import StreamStats, scan_bam
from seeksv_tpu_torch.ops import consensus_scan as cs
from seeksv_tpu_torch.ops import discordant as dc
from seeksv_tpu_torch.parallel.mesh import make_mesh
from seeksv_tpu_torch.parallel.stream_spmd import (
    SpmdStreamStats, spmd_run_pipeline_streaming)
from seeksv_tpu_torch.utils.dataset import build_dataset
from test_torch_spmd import run_ranks, same_outputs

# several test workers share few cores: one intra-op thread each
torch.set_num_threads(1)

CHUNK = 1000   # records per slab: the dataset's 3,236 records in 4 slabs


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("stream_spmd")
    p = build_dataset(str(root / "ds"), 300_000, 10, 1000, 1, 2, False,
                      virus_kb=60, virus_events=20)
    for mc in (True, False):
        jax_streaming(jax_make_mesh(2), p["ref_fa"], p["bam"],
                      str(root / f"jax_{mc}"), chunk_records=CHUNK,
                      mesh_consensus=mc)
    jax_run_pipeline(p["ref_fa"], p["bam"], str(root / "jax_run"))
    return root, p


@pytest.fixture(scope="module")
def mesh1():
    created = not dist.is_initialized()
    mesh = make_mesh("cpu")
    yield mesh
    if created:
        dist.destroy_process_group()


@pytest.mark.parametrize("mc", [True, False])
def test_streaming_one_rank(dataset, mesh1, mc):
    root, p = dataset
    n_cs = cs.PLAIN_CALLS["consensus_scan"]
    n_dc = dc.PLAIN_CALLS["discordant_count"]
    res = spmd_run_pipeline_streaming(
        mesh1, p["ref_fa"], p["bam"], str(root / f"port_{mc}"),
        chunk_records=CHUNK, mesh_consensus=mc)
    same_outputs(root / f"port_{mc}", root / f"jax_{mc}")
    same_outputs(root / f"port_{mc}", root / "jax_run")
    assert (cs.PLAIN_CALLS["consensus_scan"] > n_cs) == mc
    assert dc.PLAIN_CALLS["discordant_count"] > n_dc
    assert res["stages_s"]["scan_bam"] > 0


@pytest.fixture(scope="module")
def two_ranks(dataset):
    root, p = dataset
    out = root / "two"
    out.mkdir()
    run_ranks(out, 2, p["ref_fa"], p["bam"], ["stream_mc", "stream_host"])
    return out


@pytest.mark.parametrize("mc", [True, False])
def test_streaming_two_ranks(dataset, two_ranks, mc):
    root, _p = dataset
    got = two_ranks / ("stream_mc" if mc else "stream_host")
    same_outputs(got, root / f"jax_{mc}")
    same_outputs(got, root / "jax_run")


@pytest.mark.parametrize("read_pair_used,chunk", [(5_000_000, 1000),
                                                  (137, 500)])
def test_stream_stats_match_host(dataset, mesh1, read_pair_used, chunk):
    """Coverage, insert size and the record columns equal the host
    StreamStats; with 137 pairs the first-N cap ends inside a slab."""
    _root, p = dataset
    host = StreamStats(20, read_pair_used)
    dev = SpmdStreamStats(mesh1, 20, read_pair_used)
    scan_bam(p["bam"], chunk, [host, dev])
    assert host.insert_size() == dev.insert_size()
    hc, dcov = host.coverage(), dev.coverage()
    assert set(hc) == set(dcov)
    for t in hc:
        assert np.array_equal(hc[t], dcov[t]), t
    hl, dl = host.light(), dev.light()
    for col in ("pos", "mpos", "mtid", "l_qseq", "flag", "mapq", "isize",
                "tid", "end", "hard"):
        assert np.array_equal(getattr(hl, col), getattr(dl, col)), col
