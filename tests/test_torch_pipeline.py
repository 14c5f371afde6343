"""The port's ``run`` slice end to end on a small simulated virus-
integration dataset: its outputs must equal the JAX package's run byte
for byte, through the kernels' plain versions on the CPU, and the slice
must run in a process where jax cannot be imported."""
import gzip
import json
import os
import subprocess
import sys

import pytest
import torch

from seeksv_tpu.pipeline.driver import run_pipeline as jax_run_pipeline
from seeksv_tpu_torch.ops import extend as ext
from seeksv_tpu_torch.ops import global_device as tgd
from seeksv_tpu_torch.pipeline.driver import run_pipeline
from seeksv_tpu_torch.utils.dataset import build_dataset, truth_recall

# several test workers share few cores: one intra-op thread each keeps
# the plain versions' many small ops from oversubscribing them
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """300 kb host + 60 kb virus panel, 1 kb reads at 10x, 2 DEL/INV and
    20 integrations at 4 % divergence; the JAX package's run on it."""
    root = tmp_path_factory.mktemp("slice")
    paths = build_dataset(str(root / "ds"), 300_000, 10, 1000, 1, 2, False,
                          virus_kb=60, virus_events=20, virus_div=0.04)
    jax_run_pipeline(paths["ref_fa"], paths["bam"], str(root / "jax"))
    return root, paths


def _same_outputs(a, b):
    for ext_ in ("clip.sam", "sv"):
        with open(f"{a}.{ext_}", "rb") as fa, open(f"{b}.{ext_}", "rb") as fb:
            assert fa.read() == fb.read(), ext_
    for ext_ in ("clip.gz", "clip.fq.gz"):
        with gzip.open(f"{a}.{ext_}") as fa, gzip.open(f"{b}.{ext_}") as fb:
            assert fa.read() == fb.read(), ext_


def test_slice_matches_jax_run_pipeline(dataset):
    root, paths = dataset
    before = {**{f"x{k}": v for k, v in ext.PLAIN_CALLS.items()},
              **{f"g{k}": v for k, v in tgd.PLAIN_CALLS.items()}}
    res = run_pipeline(paths["ref_fa"], paths["bam"], str(root / "port"),
                       device="cpu")
    _same_outputs(root / "port", root / "jax")
    with open(root / "port.sv") as f:
        assert sum(1 for _ in f) > 10, "no junctions called"
    assert ext.PLAIN_CALLS["extend_left"] > before["xextend_left"]
    assert ext.PLAIN_CALLS["extend_right"] > before["xextend_right"]
    assert tgd.PLAIN_CALLS["banded_dir"] > before["gbanded_dir"]
    assert tgd.PLAIN_CALLS["traceback"] > before["gtraceback"]
    al = res["aligner"]
    assert al.last_dispatch["chose_device"] and al.last_dispatch["LQ"] >= 1024
    assert al.timings["device_finalize_s"] > 0
    assert set(res["stages_s"]) >= {"read_bam", "getclip", "realign",
                                    "getsv", "total"}


def test_truth_recall_matches_bench_scale(dataset):
    """The port's recall check equals scripts/bench_scale.py's."""
    import importlib.util
    root, paths = dataset
    spec = importlib.util.spec_from_file_location(
        "bench_scale", os.path.join(REPO, "scripts", "bench_scale.py"))
    bench_scale = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench_scale)
    sv = str(root / "jax.sv")
    with open(paths["truth"]) as f:
        want = bench_scale.sv_recall(json.load(f), bench_scale.sv_rows(sv))
    got = truth_recall(paths["truth"], sv)
    assert got == want
    assert got[1] is not None and got[1] > 0.5


def test_force_host_slice_matches(dataset):
    root, paths = dataset
    run_pipeline(paths["ref_fa"], paths["bam"], str(root / "host"),
                 device="cpu", force_host=True)
    _same_outputs(root / "host", root / "jax")


_NO_JAX = """
import runpy, sys
class _NoJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ImportError("jax is blocked: " + name)
for m in [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")]:
    del sys.modules[m]
sys.meta_path.insert(0, _NoJax())
sys.argv = ["seeksv_tpu_torch"] + sys.argv[1:]
try:
    runpy.run_module("seeksv_tpu_torch", run_name="__main__")
except SystemExit as e:
    if e.code:
        raise
assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")]
from seeksv_tpu_torch.ops import extend, global_device
# the default run extends on the resident path, not on uploaded windows
assert extend.PLAIN_CALLS["extend_left"] > 0, extend.PLAIN_CALLS
assert extend.PLAIN_CALLS["extend_right"] > 0, extend.PLAIN_CALLS
assert extend.PLAIN_CALLS["extend_windows"] == 0, extend.PLAIN_CALLS
assert min(global_device.PLAIN_CALLS.values()) > 0, global_device.PLAIN_CALLS
print("NO_JAX_OK")
"""


def test_slice_runs_with_jax_blocked(dataset, tmp_path):
    """`python -m seeksv_tpu_torch run --device cpu` with every jax import
    refused: the port and the shared modules it reaches import no jax."""
    root, paths = dataset
    env = dict(os.environ, HOME=str(tmp_path), OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [REPO] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p]))
    out = subprocess.run(
        [sys.executable, "-c", _NO_JAX, "run", "--device", "cpu", "-o",
         str(tmp_path / "nojax"), paths["ref_fa"], paths["bam"]],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "NO_JAX_OK" in out.stdout
    _same_outputs(tmp_path / "nojax", root / "jax")


def test_cuda_run_without_native_library_raises(monkeypatch, tmp_path):
    """run_pipeline on a CUDA device refuses to start when the native
    host library did not build, before it reads any input."""
    from seeksv_tpu_torch.io import native
    monkeypatch.setattr(native, "available", lambda: False)
    with pytest.raises(RuntimeError, match="native host library"):
        run_pipeline(str(tmp_path / "absent.fa"), str(tmp_path / "absent.bam"),
                     str(tmp_path / "out"), device="cuda")
