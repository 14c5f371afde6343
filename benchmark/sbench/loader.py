"""Finds a cell's configuration, traffic, limits and metric readers by
the names ``BENCHMARK.json`` gives them, so that a cell or a metric is
added by adding files and entries:

- ``benchmark/configs/<config>.json``: the configuration (the file that
  ``BENCHMARK.json`` names for it);
- ``benchmark/traffic/<traffic>.json``: the traffic mix;
- ``benchmark/limits/<workload>.json``: the limits of the numbers that
  decide ``correct`` that were set from readings (the configuration
  states the others under ``guarantees``);
- ``benchmark/metrics/<metric>.py``: a reader with ``read(ctx)``, which
  returns the metric's value or None where it finds nothing to read.
"""
from __future__ import annotations

import importlib.util
import json
import os


class Spec:
    def __init__(self, repo: str):
        self.repo = repo
        self.bench = os.path.join(repo, "benchmark")
        with open(os.path.join(repo, "BENCHMARK.json")) as f:
            self.doc = json.load(f)

    def cell(self, workload: str) -> dict:
        """The workload's entry with its configuration, traffic, limits
        and the names of the metrics it reports."""
        cells = {w["name"]: w for w in self.doc["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        w = cells[workload]
        cfg = {c["name"]: c for c in self.doc["configs"]}[w["config"]]
        with open(os.path.join(self.repo, cfg["file"])) as f:
            config = json.load(f)
        with open(os.path.join(self.bench, "traffic",
                               f"{w['traffic']}.json")) as f:
            traffic = json.load(f)
        lim_path = os.path.join(self.bench, "limits", f"{workload}.json")
        limits = {}
        if os.path.exists(lim_path):
            with open(lim_path) as f:
                limits = json.load(f)
        return {"workload": w, "config": config, "traffic": traffic,
                "limits": limits,
                "end_to_end": self.metrics("end_to_end", workload),
                "per_layer": self.metrics("per_layer", workload)}

    def metrics(self, group: str, workload: str) -> list:
        """The entries of a metric group that this workload reports."""
        return [m for m in self.doc[group]
                if workload in m.get("workloads", [workload])]

    def reader(self, name: str):
        """The read(ctx) function of metrics/<name>.py."""
        path = os.path.join(self.bench, "metrics", f"{name}.py")
        spec = importlib.util.spec_from_file_location(
            f"sbench_metric_{name.replace('.', '_').replace('-', '_')}",
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
