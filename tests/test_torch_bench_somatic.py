"""The port's tumour / normal scale program
(``seeksv_tpu_torch/scripts/bench_somatic_scale.py``) and its dataset
(``utils/dataset.build_somatic_dataset``) against the JAX script
(``scripts/bench_somatic_scale.py``, loaded by path) and the JAX
streaming somatic pipeline, on a 200 kb pair at 20x with 100 bp reads
and 10 deletions (5 germline, 5 somatic), seed 2."""
import gzip
import importlib.util
import json
import os

import pytest
import torch

from seeksv_tpu.pipeline.stream import \
    run_pipeline_streaming as jax_run_pipeline_streaming
from seeksv_tpu_torch.scripts import bench_somatic_scale as bss
from seeksv_tpu_torch.scripts.bench_scale import cache_root
from seeksv_tpu_torch.utils.dataset import build_somatic_dataset

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
G, COV, LEN, SEED, EVENTS = 200_000, 20, 100, 2, 10
KEY = f"somatic-G{G}-c{COV}-l{LEN}-s{SEED}-e{EVENTS}"


@pytest.fixture(scope="module")
def home(tmp_path_factory):
    """A HOME whose cache holds the pair under the key main() uses."""
    home = tmp_path_factory.mktemp("home")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HOME", str(home))
        paths = build_somatic_dataset(cache_root(KEY), G, COV, LEN, SEED,
                                      EVENTS)
        yield home, paths


def test_dataset_matches_jax_build(home, tmp_path, monkeypatch):
    """The same BAM payloads, BAI, fasta and truth.json as the JAX
    build_dataset; its last step (copying the reference's binaries and
    running bwa index) is stubbed here, in the test only."""
    _h, paths = home
    spec = importlib.util.spec_from_file_location(
        "jax_bench_somatic_scale",
        os.path.join(REPO, "scripts", "bench_somatic_scale.py"))
    jax_bss = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_bss)

    def fake_copy(src, dst):
        open(dst, "wb").close()

    ran = []
    monkeypatch.setattr(jax_bss, "BIN_DIR", str(tmp_path / "bin"))
    monkeypatch.setattr(jax_bss.shutil, "copy", fake_copy)
    monkeypatch.setattr(jax_bss.subprocess, "run",
                        lambda cmd, **kw: ran.append(cmd))
    root = tmp_path / "jax"
    jax_bss.build_dataset(str(root), G, COV, LEN, SEED, EVENTS)
    assert [os.path.basename(c[0]) for c in ran] == ["bwa"]
    for name in ("tumor", "normal"):
        with gzip.open(paths[name]) as a, \
                gzip.open(root / f"{name}.bam") as b:
            assert a.read() == b.read(), name
        with open(paths[name] + ".bai", "rb") as a, \
                open(root / f"{name}.bam.bai", "rb") as b:
            assert a.read() == b.read(), name
    for name, path in (("truth.json", paths["truth"]),
                       ("ref.fa", paths["ref_fa"])):
        with open(path, "rb") as a, open(root / name, "rb") as b:
            assert a.read() == b.read(), name
    with open(paths["truth"]) as f:
        truth = json.load(f)
    assert len(truth["somatic"]) == len(truth["germline"]) == EVENTS // 2


def test_streaming_somatic_matches_jax(home, tmp_path, monkeypatch):
    """The port's run (run_trials) writes the JAX streaming somatic
    pipeline's .sv, .somatic.temp.sv and .somatic.sv byte for byte; the
    host cross-check is exact, every somatic deletion is called and no
    germline deletion leaks."""
    h, paths = home
    monkeypatch.setenv("HOME", str(h))
    prefix = str(tmp_path / "port")
    best_s, totals, (stages, timings, dispatch) = bss.run_trials(
        paths, prefix, 1, torch.device("cpu"), chunk_records=9_000)
    assert best_s == totals[0] and "somatic" in stages
    assert dispatch["chose_device"] and timings["device_extend_s"] > 0
    jprefix = str(tmp_path / "jax")
    jax_run_pipeline_streaming(paths["ref_fa"], paths["tumor"], jprefix,
                               chunk_records=9_000,
                               normal_bam=paths["normal"])
    for suffix in ("sv", "somatic.temp.sv", "somatic.sv"):
        with open(f"{prefix}.{suffix}", "rb") as a, \
                open(f"{jprefix}.{suffix}", "rb") as b:
            assert a.read() == b.read(), suffix
    res = bss.check(paths, prefix)
    assert res["somatic_parity"] == "exact"
    assert res["germline_leaked"] == 0
    assert res["somatic_truth_recall_ours"] == 1.0
    assert res["somatic_calls_ours"] >= EVENTS // 2
    assert res["tumor_sv_rows"] >= EVENTS


def test_main_on_the_cpu(home, tmp_path, monkeypatch):
    h, _paths = home
    monkeypatch.setenv("HOME", str(h))
    out = tmp_path / "row.jsonl"
    rc = bss.main(["--genome-mb", "0.2", "--coverage", str(COV),
                   "--events", str(EVENTS), "--trials", "2", "--device",
                   "cpu", "--out", str(out)])
    assert rc == 0
    (row,) = [json.loads(line) for line in out.read_text().splitlines()]
    assert row["somatic_parity"] == "exact" and row["germline_leaked"] == 0
    assert row["somatic_truth_recall_ours"] == 1.0
    assert row["trials"] == 2 and len(row["ours_totals_s"]) == 2
    assert row["device"] == "cpu" and row["peak_cuda_mb"] is None
    assert row["events_somatic"] == row["events_germline"] == EVENTS // 2


def test_asks_for_the_card_by_default(home, monkeypatch):
    h, _paths = home
    monkeypatch.setenv("HOME", str(h))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        bss.main(["--genome-mb", "0.2", "--coverage", str(COV), "--events",
                  str(EVENTS), "--trials", "1"])
