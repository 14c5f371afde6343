"""A run writes only inside its checkout and the HOME, XDG_CACHE_HOME and
TMPDIR it is given: nothing in /dev/shm and nothing at a fixed path under
/tmp.  The dataset is kept for one seed a cell."""
import json
import os
import subprocess
import sys

from bench_helpers import BENCH, REPO


def _entries(d):
    try:
        return set(os.listdir(d))
    except OSError:
        return set()


def test_bench_run_writes_only_in_its_places(tmp_path):
    home, xdg, tmp = (tmp_path / n for n in ("home", "xdg", "tmp"))
    for d in (home, xdg, tmp):
        d.mkdir()
    bench = tmp_path / "checkout" / "benchmark"
    bench.mkdir(parents=True)
    code = f"""
import sys, json, os
sys.path[:0] = [{BENCH!r}, {REPO!r}, {os.path.join(BENCH, 'tests')!r}]
import torch
torch.set_num_threads(1)
import tempfile
from sbench import harness
from bench_helpers import tiny_cell
cell = tiny_cell("short100_30x.stream")
work = os.path.join(tempfile.gettempdir(), "seeksv_bench", "x")
for seed in (5, 5, 6):
    data = harness.ensure_data({str(bench)!r}, cell, seed, lambda *a: None)
    print(json.dumps(data["build_s"] > 0))
ctx = harness.measure(cell, data, 0.0, True, "cpu", work, lambda *a: None)
harness.check(cell, data, ctx["prefix"], 6, "cpu")
"""
    before = {d: _entries(d) for d in ("/tmp", "/dev/shm")}
    env = dict(os.environ, HOME=str(home), XDG_CACHE_HOME=str(xdg),
               TMPDIR=str(tmp), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    # a second run of the same seed keeps the dataset; a new seed builds
    assert [json.loads(x) for x in r.stdout.split()] == [True, False, True]
    assert os.listdir(bench / ".cache" / "data") == ["short100_30x.stream"]
    for d, had in before.items():
        new = _entries(d) - had
        new = {n for n in new if not str(tmp_path).startswith(
            os.path.join(d, n))}
        assert not new, f"the run wrote {sorted(new)} into {d}"
    top = set(os.listdir(tmp_path))
    assert top == {"home", "xdg", "tmp", "checkout"}
    assert os.listdir(tmp / "seeksv_bench") == ["x"]
