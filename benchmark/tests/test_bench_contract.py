"""BENCHMARK.json and the run's line keep to the benchmark's contract;
the measuring path refuses to run without a card or without the
program; nothing it or the reference imports is JAX or the JAX
package."""
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from bench_helpers import BENCH, REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _doc():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_bench_json_keeps_to_the_contract():
    doc = _doc()
    assert set(doc) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert doc["paths"] == ["benchmark"]
    assert doc["command"] == ["python3", "benchmark/run.py"]
    assert isinstance(doc["run_seconds"], int) and \
        1 <= doc["run_seconds"] <= 51
    cfgs = {c["name"]: c for c in doc["configs"]}
    for c in doc["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("benchmark/")
        assert os.path.exists(os.path.join(REPO, c["file"]))
        assert all(NAME.match(k) for k in c["reduced"])
        with open(os.path.join(REPO, c["file"])) as f:
            assert sorted(json.load(f)["reduced"]) == sorted(c["reduced"])
    used = set()
    for w in doc["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in cfgs and w["chips"] == 1 and _line(w["why"])
        assert os.path.exists(os.path.join(BENCH, "traffic",
                                           f"{w['traffic']}.json"))
        assert os.path.exists(os.path.join(BENCH, "limits",
                                           f"{w['name']}.json"))
        used.add(w["config"])
    assert used == set(cfgs)
    cells = {w["name"] for w in doc["workloads"]}
    e2e = {m["name"] for m in doc["end_to_end"]}
    assert "setup_s" in e2e
    names = [m["name"] for g in ("end_to_end", "per_layer") for m in doc[g]]
    assert len(names) == len(set(names))
    for g in ("end_to_end", "per_layer"):
        for m in doc[g]:
            keys = {"name", "unit", "better", "source"} | (
                {"bound"} if g == "end_to_end" else {"layer", "moves"})
            assert set(m) - {"workloads"} == keys
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher")
            assert set(m.get("workloads", cells)) <= cells
            assert os.path.exists(os.path.join(BENCH, "metrics",
                                               f"{m['name']}.py"))
            if g == "end_to_end":
                assert m["source"] in ("host_clock", "device_trace")
                assert 0.01 <= m["bound"] <= 0.25
            else:
                assert m["moves"] in e2e and _line(m["layer"])
    for c in cells:
        mine = [m for m in doc["per_layer"] if c in m.get("workloads", [c])]
        assert mine
        assert len([m for m in doc["end_to_end"]
                    if c in m.get("workloads", [c])]) >= 2
    assert len(json.dumps(doc)) < 64 * 1024


def _trace_file(path):
    ev = [{"ph": "X", "cat": "user_annotation", "name": "bench.window",
           "ts": 0, "dur": 1_000_000},
          {"ph": "X", "cat": "user_annotation", "name": "bench.pass",
           "ts": 0, "dur": 1_000_000},
          {"ph": "X", "cat": "user_annotation", "name": "bench.getclip",
           "ts": 0, "dur": 600_000},
          {"ph": "X", "cat": "kernel", "name": "extend_kernel<2>",
           "ts": 700_000, "dur": 100_000},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD",
           "ts": 750_000, "dur": 100_000}]
    with open(path, "w") as f:
        json.dump({"traceEvents": ev}, f)


@pytest.mark.parametrize("traced", [False, True])
def test_bench_result_line_keys(tmp_path, monkeypatch, traced):
    from sbench import loader, report
    spec = loader.Spec(REPO)
    cell = spec.cell("short100_30x.stream")
    tp = str(tmp_path / "trace.json")
    _trace_file(tp)
    ctx = {"passes": [{"stages_s": {"read_bam": 1.0, "getclip": 2.0,
                                    "index": 0.5, "realign": 1.5,
                                    "getsv": 3.0}, "records": 100,
                       "seconds": 8.0}],
           "window_s": 8.0, "setup_s": 20.0, "peak_rss_mb": 5000.0,
           "memory_peak_bytes": 123, "trace_path": tp if traced else None,
           "calls": {"extend": [], "banded": [], "walk": []}}
    monkeypatch.setattr(report, "device_info", lambda ctx, tr: dict(
        {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
         "memory_peak_bytes": 123},
        **({"busy_s": tr.busy_s(), "window_s": tr.window_s()} if tr
           else {})))
    checks = {"aln_score_lost_pct": {"value": 0.1, "limit": 1.0, "ok": True}}
    line = report.result(spec, cell, ctx, checks, traced, lambda *a: None)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line) == keys + (["breakdown"] if traced else []) + ["checks"]
    assert line["correct"] is True
    got = set(line["metrics"])
    if traced:
        assert got == {"getclip_s", "realign_s", "getsv_s",
                       "device_idle_pct"}
        assert line["device"]["busy_s"] == pytest.approx(0.15)
        assert line["metrics"]["device_idle_pct"]["value"] == \
            pytest.approx(85.0)
        assert line["breakdown"]["idle_gaps"][0][0] == "bench.getclip"
        assert line["metrics"]["getclip_s"]["value"] == 3.0
    else:
        assert got == {"records_per_s", "peak_rss_mb", "setup_s"}
        assert line["metrics"]["records_per_s"]["value"] == 12.5
    json.dumps(line)


def _run(args, cwd, env=None):
    return subprocess.run([sys.executable, "benchmark/run.py", *args],
                          cwd=cwd, capture_output=True, text=True,
                          env=env, timeout=300)


def test_bench_run_refuses_without_a_card(monkeypatch):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = _run(["--workload", "short100_30x.stream", "--seed", "5",
              "--seconds", "1", "--trace", "0"], REPO, env)
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_bench_run_refuses_without_the_program(tmp_path):
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    r = _run(["--workload", "short100_30x.stream", "--seed", "5",
              "--seconds", "1", "--trace", "0"], str(tmp_path))
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_bench_forbidden_names_compare_whole(monkeypatch):
    from sbench import harness
    monkeypatch.setitem(sys.modules, "seeksv_tpu_torch_fake", object())
    monkeypatch.setitem(sys.modules, "jaxfake.sub", object())
    assert "seeksv_tpu" not in harness.forbidden_modules()
    assert "jax" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "seeksv_tpu.fake", object())
    assert "seeksv_tpu" in harness.forbidden_modules()


def test_bench_imports_no_jax(tmp_path):
    """What run.py, the reference and a traced pass import, in a fresh
    interpreter: no jax, jaxlib, flax or seeksv_tpu."""
    code = f"""
import sys, os, glob
sys.path[:0] = [{BENCH!r}, {REPO!r}]
sys.path.insert(0, {os.path.join(BENCH, 'tests')!r})
import torch
torch.set_num_threads(1)
from sbench import harness, judge, report, loader, bounds, trace, datagen
from bench_helpers import tiny_cell
spec = loader.Spec({REPO!r})
for m in glob.glob({os.path.join(BENCH, 'metrics', '*.py')!r}):
    spec.reader(os.path.basename(m)[:-3])
cell = tiny_cell("short100_30x.stream")
data = harness.ensure_data({str(tmp_path)!r}, cell, 3, lambda *a: None)
ctx = harness.measure(cell, data, 0.0, True, "cpu", {str(tmp_path / 'w')!r},
                      lambda *a: None)
harness.check(cell, data, ctx["prefix"], 3, "cpu", control=True)
print(harness.forbidden_modules())
"""
    env = dict(os.environ, HOME=str(tmp_path / "home"), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().splitlines()[-1] == "[]"
