"""The harness finds configurations, traffic, limits and metric readers
by name: a cell and a metric are added with files and entries alone."""
import json
import os
import shutil

from bench_helpers import BENCH, REPO


def test_bench_loader_finds_a_dummy_cell_and_metric(tmp_path):
    from sbench import loader
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        doc = json.load(f)
    cfg = dict(json.load(open(root / "benchmark/configs/short100_30x.json")),
               name="dummy_cfg", genome_bp=2_000_000)
    (root / "benchmark/configs/dummy_cfg.json").write_text(json.dumps(cfg))
    (root / "benchmark/traffic/dummy_mix.json").write_text(json.dumps(
        {"driver": "stream", "sample": "single", "chunk_records": 1000}))
    (root / "benchmark/metrics/dummy_metric.py").write_text(
        "def read(ctx):\n    return 2.0 * len(ctx['passes'])\n")
    doc["configs"].append({"name": "dummy_cfg", "source": "https://x.org",
                           "file": "benchmark/configs/dummy_cfg.json",
                           "reduced": [], "why": "a test"})
    doc["workloads"].append({"name": "dummy_cfg.dummy_mix",
                             "config": "dummy_cfg", "traffic": "dummy_mix",
                             "chips": 1, "why": "a test"})
    doc["per_layer"].append({"name": "dummy_metric", "unit": "s",
                             "better": "lower", "source": "program_span",
                             "layer": "dummy", "moves": "records_per_s",
                             "workloads": ["dummy_cfg.dummy_mix"]})
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    spec = loader.Spec(str(root))
    cell = spec.cell("dummy_cfg.dummy_mix")
    assert cell["config"]["genome_bp"] == 2_000_000
    assert cell["traffic"]["chunk_records"] == 1000
    names = [m["name"] for m in cell["per_layer"]]
    assert "dummy_metric" in names and "somatic_s" not in names
    assert "k1_roofline_pct" not in names
    assert spec.reader("dummy_metric")({"passes": [1, 2]}) == 4.0
    # the cells already there are untouched
    assert "dummy_metric" not in [
        m["name"] for m in spec.cell("short100_30x.stream")["per_layer"]]
