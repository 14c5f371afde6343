"""On the card: one short run of each cell, as the driver runs it, gives
a correct result line.

    python -m pytest benchmark/tests/test_bench_card.py -q -m card
"""
import json
import os
import subprocess
import sys

import pytest

from bench_helpers import REPO


@pytest.mark.card
@pytest.mark.parametrize("workload", ["short100_30x.stream",
                                      "short100_30x.somatic"])
def test_bench_card_run(cuda, workload, tmp_path):
    env = dict(os.environ, HOME=str(tmp_path), TMPDIR=str(tmp_path))
    r = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", workload,
         "--seed", "2147483659", "--seconds", "1", "--trace", "1"],
        cwd=REPO, capture_output=True, text=True, env=env, timeout=1200)
    assert r.returncode == 0, r.stderr[-3000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
