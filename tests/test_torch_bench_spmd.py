"""The port's streaming x SPMD scale program
(``seeksv_tpu_torch/scripts/bench_stream_spmd.py``) on the CPU: one and
two gloo ranks, each a subprocess, on bench_scale's small short-read
dataset (200 kb, 20x, 100 bp reads, 10 DEL/INV, seed 1); every mesh
size's sv rows must equal the sequential stream's."""
import json

import pytest
import torch

from seeksv_tpu_torch.scripts import bench_scale, bench_stream_spmd
from seeksv_tpu_torch.utils.dataset import build_dataset

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def home(tmp_path_factory):
    home = tmp_path_factory.mktemp("home")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HOME", str(home))
        build_dataset(bench_scale.cache_root(bench_scale.dataset_key(
            200_000, 20, 100, 1, 10)), 200_000, 20, 100, 1, 10, False)
        yield home


def test_gloo_ranks_match_the_sequential_stream(home, tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(home))
    out = tmp_path / "rows.jsonl"
    rc = bench_stream_spmd.main(
        ["--genome-mb", "0.2", "--coverage", "20", "--events", "10",
         "--ranks", "1,2", "--trials", "1", "--chunk-records", "7000",
         "--device", "cpu", "--out", str(out)])
    assert rc == 0
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["ranks"] for r in rows] == [1, 2]
    assert [r["mesh"] for r in rows] == [{"dp": 1, "gp": 1},
                                         {"dp": 2, "gp": 1}]
    for r in rows:
        assert r["sv_parity_vs_sequential_stream"] == "exact"
        assert r["sv_rows"] > 5 and r["backend"] == "gloo"
        assert len(r["peak_rss_by_rank_mb"]) == r["ranks"]
        assert r["peak_rss_mb"] == max(r["peak_rss_by_rank_mb"]) > 0
        assert {"scan_bam", "realign", "discordant"} <= set(
            r["spmd_stages_s"])


def test_the_card_takes_one_rank(home, monkeypatch):
    """--device cuda (the default) raises without a card, and with more
    than one rank (NCCL refuses two ranks on one device)."""
    monkeypatch.setenv("HOME", str(home))
    args = ["--genome-mb", "0.2", "--coverage", "20", "--events", "10"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        bench_stream_spmd.main(args)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(SystemExit, match="NCCL refuses"):
        bench_stream_spmd.main(args + ["--ranks", "1,2"])
