"""The port's host-side scale programs on the CPU at a tiny size:
``scripts/bench_merge.py`` (the partitioned MergeJunction against the
sequential one, against the JAX script's table) and
``scripts/bench_junction_window.py`` (the windowed and the unbounded
junction build in one-rank subprocesses, equal junction counts)."""
import dataclasses
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from seeksv_tpu_torch.scripts import (bench_junction_window, bench_merge,
                                      bench_scale)
from seeksv_tpu_torch.utils.dataset import build_dataset

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_bench_merge_is_exact(capsys):
    assert bench_merge.main(["--junctions", "800", "--workers", "2"]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["exact"] is True and row["n_partitions"] == 100
    assert row["replay_threads_used"] >= 1
    assert 1 <= row["max_concurrent_partitions"] <= 2


def test_merge_table_matches_jax():
    """build_jmap draws the JAX script's table: the same junctions and
    fields from the same seed (the two packages' classes compared by
    fields)."""
    spec = importlib.util.spec_from_file_location(
        "jax_bench_merge", os.path.join(REPO, "scripts", "bench_merge.py"))
    jax_bm = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_bm)
    got = bench_merge.build_jmap(np.random.default_rng(0), 20, 8)
    want = jax_bm.build_jmap(np.random.default_rng(0), 20, 8)
    assert len(got.items) == len(want.items) == 160
    for (ja, oa), (jb, ob) in zip(got.items, want.items):
        assert ja == jb
        assert dataclasses.asdict(oa) == dataclasses.asdict(ob)


@pytest.mark.parametrize("windows", [[(0, 1.0, 2.0)],
                                     [(0, 0.0, 1.0), (1, 0.5, 2.0),
                                      (2, 1.5, 3.0), (3, 0.2, 0.6)]])
def test_max_overlap(windows):
    assert bench_merge.max_overlap(windows) == (1 if len(windows) == 1
                                                else 3)


def test_bench_junction_window_tiny(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("HOME", str(tmp_path))
    build_dataset(bench_scale.cache_root(bench_scale.dataset_key(
        200_000, 20, 100, 1, 10)), 200_000, 20, 100, 1, 10, False)
    out = tmp_path / "row.jsonl"
    rc = bench_junction_window.main(
        ["--genome-mb", "0.2", "--coverage", "20", "--events", "10",
         "--device", "cpu", "--out", str(out)])
    assert rc == 0
    (row,) = [json.loads(line) for line in out.read_text().splitlines()]
    assert row["n_junctions"] > 5 and row["clip_lines"] > 0
    assert row["windowed_peak_rss_mb"] > 0
    assert row["unbounded_peak_rss_mb"] > 0
    assert row["device"] == "cpu"
