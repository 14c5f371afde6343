"""The port's multi-process tumor/normal subtraction (parallel/multiproc.py)
on gloo ranks against the sequential passes of both packages:
multiprocess_somatic_range on 2 and 4 ranks of a single-chromosome pair
(flat cuts mid-chromosome, the clip-line halo firing) and
multiprocess_somatic on 2 ranks of the same genome written as two contigs:
temp and final .somatic.sv byte-equal to the port's getclip + somatic +
somatic_filter and to the JAX package's."""
import json
import os

import pytest
import torch

from seeksv_tpu.pipeline.getclip import getclip as jax_getclip
from seeksv_tpu.pipeline.somatic import somatic as jax_somatic
from seeksv_tpu.pipeline.somatic import somatic_filter as jax_somatic_filter
from seeksv_tpu_torch.pipeline.driver import run_pipeline
from seeksv_tpu_torch.pipeline.getclip import getclip
from seeksv_tpu_torch.pipeline.somatic import somatic, somatic_filter
from torch_inputs import run_gloo_ranks, tumor_normal_dataset

torch.set_num_threads(1)

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_multiproc_worker.py")


def _pair(root, contigs):
    """The tumor .sv from the port's sequential run, then the sequential
    somatic pass of each package on the normal BAM: root/seq.* (port),
    root/jax.* (JAX package), their outputs equal."""
    cancer, normal, fa = tumor_normal_dataset(root, contigs)
    run_pipeline(fa, cancer, str(root / "cancer"), device="cpu")
    tumor_sv = str(root / "cancer.sv")
    for tag, (gc, som, filt) in (
            ("seq", (getclip, somatic, somatic_filter)),
            ("jax", (jax_getclip, jax_somatic, jax_somatic_filter))):
        gc(normal, str(root / f"{tag}n"))
        som(normal, str(root / f"{tag}n.clip.gz"), tumor_sv,
            str(root / f"{tag}.temp.sv"))
        filt(str(root / f"{tag}.temp.sv"), str(root / f"{tag}.somatic.sv"))
    for suffix in ("temp.sv", "somatic.sv"):
        assert (root / f"seq.{suffix}").read_bytes() == \
            (root / f"jax.{suffix}").read_bytes(), suffix
    return normal, tumor_sv


@pytest.fixture(scope="module")
def one_contig(tmp_path_factory):
    root = tmp_path_factory.mktemp("somatic1")
    return (root, *_pair(root, 1))


@pytest.fixture(scope="module")
def two_contigs(tmp_path_factory):
    root = tmp_path_factory.mktemp("somatic2")
    return (root, *_pair(root, 2))


def _rows(path):
    return [ln for ln in path.read_text().splitlines()
            if not ln.startswith("@")]


@pytest.mark.parametrize("world", [2, 4])
def test_range_sharded_somatic_matches_sequential(one_contig, world):
    """Range cuts mid-chromosome: temp and final files equal both
    sequential passes; the clip-line halo fires; the germline deletion
    near the cut (119,600) is subtracted and the somatic one at 80,000
    survives."""
    root, normal, tumor_sv = one_contig
    out = root / f"w{world}"
    out.mkdir()
    logs = run_gloo_ranks(WORKER, out, world, [json.dumps(
        [{"task": "somatic_range", "out": str(out), "normal": normal,
          "tumor_sv": tumor_sv}])])
    assert any("somatic clip halo" in x for x in logs), logs[0][-2000:]
    for suffix in ("temp.sv", "somatic.sv"):
        assert (out / f"mpr.{suffix}").read_bytes() == \
            (root / f"seq.{suffix}").read_bytes(), suffix
    poss = [int(r.split("\t")[1]) for r in _rows(out / "mpr.somatic.sv")]
    assert any(abs(p - 80_000) < 60 for p in poss), poss
    assert not any(abs(p - 119_600) < 60 for p in poss), poss
    # every tumor row's counts are in the temp file, the germline ones
    # nonzero
    assert len(_rows(out / "mpr.temp.sv")) > len(poss)


def test_chromosome_sharded_somatic_matches_sequential(two_contigs):
    """Two contigs, one a rank: temp and final files equal both
    sequential passes; the somatic deletion on chr2 survives."""
    root, normal, tumor_sv = two_contigs
    out = root / "w2"
    out.mkdir()
    run_gloo_ranks(WORKER, out, 2, [json.dumps(
        [{"task": "somatic", "out": str(out), "normal": normal,
          "tumor_sv": tumor_sv}])])
    for suffix in ("temp.sv", "somatic.sv"):
        assert (out / f"mps.{suffix}").read_bytes() == \
            (root / f"seq.{suffix}").read_bytes(), suffix
    rows = [r.split("\t") for r in _rows(out / "mps.somatic.sv")]
    assert any(r[0] == "chr2" and abs(int(r[1]) - 50_000) < 60
               for r in rows), rows


@pytest.fixture(scope="module")
def unread_contig(tmp_path_factory):
    root = tmp_path_factory.mktemp("somatic_unread")
    return (root, *_pair_unread(root))


def _pair_unread(root):
    cancer, normal, fa = tumor_normal_dataset(root, 1, unread_contig=50_000)
    run_pipeline(fa, cancer, str(root / "cancer"), device="cpu")
    getclip(normal, str(root / "seqn"))
    somatic(normal, str(root / "seqn.clip.gz"), str(root / "cancer.sv"),
            str(root / "seq.temp.sv"))
    somatic_filter(str(root / "seq.temp.sv"), str(root / "seq.somatic.sv"))
    return normal, str(root / "cancer.sv")


def test_chromosome_sharded_somatic_with_a_rank_that_owns_no_record(
        unread_contig, monkeypatch, tmp_path):
    """A header contig that no read covers, as the last of two ranks'
    chromosome range: the JAX package's multiprocess_somatic raises on its
    last process before the first collective (seeksv_tpu/parallel/
    multiproc.py:761-763), so its other process is left waiting; the
    port's last rank reads the header and contributes empty shards, and
    the outputs equal the sequential pass."""
    import jax

    from seeksv_tpu.parallel import multiproc as jax_mp
    root, normal, tumor_sv = unread_contig
    monkeypatch.setattr(jax, "process_index", lambda: 1)
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    with pytest.raises(RuntimeError, match="last process must at least"):
        jax_mp.multiprocess_somatic(
            None, normal, tumor_sv, str(tmp_path / "j.temp.sv"),
            str(tmp_path / "j.somatic.sv"), str(tmp_path / "j"))
    monkeypatch.undo()
    run_gloo_ranks(WORKER, tmp_path, 2, [json.dumps(
        [{"task": "somatic", "out": str(tmp_path), "normal": normal,
          "tumor_sv": tumor_sv}])])
    for suffix in ("temp.sv", "somatic.sv"):
        assert (tmp_path / f"mps.{suffix}").read_bytes() == \
            (root / f"seq.{suffix}").read_bytes(), suffix
    assert _rows(tmp_path / "mps.somatic.sv")
