"""The port's scale benchmark (``seeksv_tpu_torch/scripts/bench_scale.py``)
against the JAX script (``scripts/bench_scale.py``, loaded by path) on a
small short-read dataset: 200 kb, 20x, 100 bp reads, 10 DEL/INV, seed 1,
the kernels' plain versions on the CPU."""
import gzip
import importlib.util
import json
import os

import pytest
import torch

from seeksv_tpu_torch.ops import extend as ext
from seeksv_tpu_torch.scripts import bench_scale
from seeksv_tpu_torch.utils.dataset import build_dataset

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--genome-mb", "0.2", "--coverage", "20", "--read-len", "100",
        "--events", "10"]


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def home(tmp_path_factory):
    """A HOME whose cache holds the dataset under the key main() uses."""
    home = tmp_path_factory.mktemp("home")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HOME", str(home))
        root = bench_scale.cache_root(bench_scale.dataset_key(
            200_000, 20, 100, 1, 10))
        build_dataset(root, 200_000, 20, 100, 1, 10, False)
        yield home, root


@pytest.fixture(scope="module")
def jax_bench():
    return _jax_script("bench_scale")


@pytest.mark.parametrize("stream", [True, False], ids=["stream", "whole"])
def test_run_ours_matches_jax(home, jax_bench, tmp_path, monkeypatch,
                              stream):
    """run_ours' .sv, .clip.sam and decompressed .clip.gz / .clip.fq.gz
    equal the JAX run_ours' on the same dataset, streamed and whole."""
    h, root = home
    monkeypatch.setenv("HOME", str(h))
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    n_jax, st_jax = jax_bench.run_ours(root, str(tmp_path / "jax"),
                                       stream=stream, chunk_records=7_000)
    before = dict(ext.PLAIN_CALLS)
    n, st = bench_scale.run_ours(root, str(tmp_path / "port"), "cpu",
                                 stream=stream, chunk_records=7_000)
    assert n == n_jax > 30_000
    assert ext.PLAIN_CALLS["extend_left"] > before["extend_left"]
    assert st["dispatch"]["chose_device"] and st["dispatch"]["LQ"] <= 128
    assert set(st) >= set(st_jax)
    for suffix in ("sv", "clip.sam"):
        with open(tmp_path / "port" / f"ours.{suffix}", "rb") as a, \
                open(tmp_path / "jax" / f"ours.{suffix}", "rb") as b:
            assert a.read() == b.read(), suffix
    for suffix in ("clip.gz", "clip.fq.gz"):
        with gzip.open(tmp_path / "port" / f"ours.{suffix}") as a, \
                gzip.open(tmp_path / "jax" / f"ours.{suffix}") as b:
            assert a.read() == b.read(), suffix
    sv = str(tmp_path / "port" / "ours.sv")
    rows = bench_scale.sv_rows(sv)
    assert rows == jax_bench.sv_rows(sv) and len(rows) > 5
    for suffix in ("clip.gz", "clip.fq.gz"):
        path = str(tmp_path / "port" / f"ours.{suffix}")
        assert bench_scale.gz_sha(path) == jax_bench.gz_sha(path)
    with open(os.path.join(root, "truth.json")) as f:
        truth = json.load(f)
    got = bench_scale.sv_recall(truth, rows)
    assert got == jax_bench.sv_recall(truth, rows)
    assert got[0] >= 0.95 and got[1] is None


def _row(up_pos, col9):
    fields = ["chr1", str(up_pos), "+", "10", "chr1", str(up_pos + 500), "-",
              "8", "3", str(col9), "0.5"]
    return "\t".join(fields) + "\n"


BIG = 1 << 29
DEFECT_CASES = {
    "equal": ([_row(100, 4)], [_row(100, 4)]),
    "signature": ([_row(BIG + 5, 4), _row(10, 2)],
                  [_row(BIG + 5, 0), _row(10, 2)]),
    "below_512mb": ([_row(BIG - 5, 4)], [_row(BIG - 5, 0)]),
    "ref_nonzero": ([_row(BIG + 5, 4)], [_row(BIG + 5, 3)]),
    "other_column": ([_row(BIG + 5, 4)],
                     [_row(BIG + 5, 4).replace("\t8\t", "\t9\t")]),
    "row_count": ([_row(BIG + 5, 4)], [_row(BIG + 5, 0), _row(10, 2)]),
    "field_count": ([_row(BIG + 5, 4)], [_row(BIG + 5, 0)[:-1] + "\tx\n"]),
}


@pytest.mark.parametrize("case", sorted(DEFECT_CASES))
def test_bai_512mb_defect_matches_jax(jax_bench, case):
    ours, ref = DEFECT_CASES[case]
    got = bench_scale.bai_512mb_defect(ours, ref)
    assert got == jax_bench.bai_512mb_defect(ours, ref)
    assert got == (case == "signature")


def test_run_ab_on_the_cpu(home, tmp_path, monkeypatch, capsys):
    """--ab --trials 1 --device cpu: two rows, one per arm, identical sv
    rows and clip streams, the device arm through the plain versions and
    the forced_host arm on the native host kernels."""
    h, _root = home
    monkeypatch.setenv("HOME", str(h))
    out = tmp_path / "ab.jsonl"
    rc = bench_scale.main(ARGS + ["--stream", "--chunk-records", "7000",
                                  "--ab", "--trials", "1", "--device", "cpu",
                                  "--out", str(out)])
    assert rc == 0
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["arm"] for r in rows] == ["device", "forced_host"]
    for r in rows:
        assert r["ab"]["arms_sv_identical"] is True
        assert r["parity"] == "exact" and r["clip_parity"] == "exact"
        assert r["truth_del_recall"] >= 0.95
        assert r["device"] == "cpu" and r["card"] is None
        assert r["peak_cuda_mb"] is None and r["trials"] == 1
        assert "getclip_stream" in r["ours_stages_s"]
    dev, host = rows
    assert dev["dispatch"]["chose_device"] and not dev["force_host_extend"]
    assert host["dispatch"]["forced"] == "host"
    assert host["aligner_stages_s"]["device_extend_s"] == 0.0
    assert dev["ab"]["session"] == host["ab"]["session"]
    printed = [json.loads(line) for line in
               capsys.readouterr().out.splitlines() if line.startswith("{")]
    assert printed == rows


def test_asks_for_the_card_by_default(home, monkeypatch):
    """--device defaults to cuda and raises where torch sees no card."""
    h, _root = home
    monkeypatch.setenv("HOME", str(h))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        bench_scale.main(ARGS + ["--trials", "1"])


class _FirstTrial(Exception):
    pass


def test_kernels_are_built_before_the_first_trial(home, monkeypatch):
    """On the card, main starts the CUDA context and builds and loads the
    port's kernels before any timed trial.  (The first 100 Mbp run on an
    H100 built them inside trial 1's device arm: realign 5.339 s, 4.98 of
    them in device_extend_s, against 0.427 s once built.)  Faked card:
    the calls are recorded and the first trial stops the run."""
    from seeksv_tpu_torch.scripts import _card
    h, _root = home
    monkeypatch.setenv("HOME", str(h))
    calls = []

    def first_trial(*a):
        calls.append("trial")
        raise _FirstTrial

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch, "zeros",
                        lambda *a, **k: calls.append("context"))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(_card._build, "lib", lambda: calls.append("build"))
    monkeypatch.setattr(bench_scale.BatchAligner, "calibration_stale",
                        classmethod(lambda cls: None))
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", first_trial)
    for extra in ([], ["--ab"]):
        calls.clear()
        with pytest.raises(_FirstTrial):
            bench_scale.main(ARGS + ["--trials", "1"] + extra)
        assert calls == ["context", "build", "trial"], extra
