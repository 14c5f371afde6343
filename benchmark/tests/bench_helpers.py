"""Helpers of the benchmark's tests."""
import copy
import os

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)


def tiny_cell(workload: str, traffic: str = None) -> dict:
    """A cell of BENCHMARK.json cut to a size the CPU runs in seconds:
    the configuration's widths (read length, insert, scoring) kept, the
    genome, coverage and events cut; with traffic, that mix of
    benchmark/traffic/ in the cell's own."""
    import json

    from sbench import loader
    cell = copy.deepcopy(loader.Spec(REPO).cell(workload))
    if traffic:
        with open(os.path.join(BENCH, "traffic", f"{traffic}.json")) as f:
            cell["traffic"] = json.load(f)
    cell["config"].update(genome_bp=1_000_000, coverage=20, n_events=20)
    if "chunk_records" in cell["traffic"]:
        cell["traffic"]["chunk_records"] = 20_000
    return cell


def quiet(*a):
    pass
