"""The port's dispatch calibration: the six cases of
tests/test_calibration.py with a faked CUDA device and a patched
subprocess.run (stale on another card, a fresh fingerprint loads its
crossover, a missing fingerprint is stale, ensure_calibration reruns the
port's own module, a timeout keeps the committed values, no CUDA is never
stale), and the gate: a batch under the crossover on a CUDA device runs
on the host kernel, one above it on the device round; the CPU route
applies no crossover; the finalize crossover and share."""
import json
import os
import subprocess

import numpy as np
import pytest
import torch

from seeksv_tpu.utils.simulate import random_genome, write_fasta
from seeksv_tpu_torch.align import engine
from seeksv_tpu_torch.align.engine import BatchAligner

torch.set_num_threads(1)

CARD = "NVIDIA H100 80GB HBM3"


@pytest.fixture
def fake_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: CARD)
    yield
    BatchAligner._load_calibration.cache_clear()


def _write(p, fingerprint, crossover=123):
    p.write_text(json.dumps({"crossover_cells": crossover,
                             "fingerprint": fingerprint}))
    BatchAligner._load_calibration.cache_clear()


def _fp(device=CARD, mb_s=None):
    return {"device": device, "platform": "cuda",
            "upload_probe_mb_s": mb_s}


def test_stale_on_device_mismatch(tmp_path, monkeypatch, fake_cuda):
    p = tmp_path / "cal.json"
    monkeypatch.setenv("SEEKSV_TPU_TORCH_DISPATCH_CALIB", str(p))
    _write(p, _fp("NVIDIA B200"))
    reason = BatchAligner.calibration_stale()
    assert reason is not None and "B200" in reason


def test_fresh_fingerprint_not_stale_and_crossover_loaded(
        tmp_path, monkeypatch, fake_cuda):
    p = tmp_path / "cal.json"
    monkeypatch.setenv("SEEKSV_TPU_TORCH_DISPATCH_CALIB", str(p))
    _write(p, _fp())
    assert BatchAligner.calibration_stale() is None
    assert BatchAligner._calibrated_min_device_cells() == 123


def test_upload_rate_shift_is_stale(tmp_path, monkeypatch, fake_cuda):
    p = tmp_path / "cal.json"
    monkeypatch.setenv("SEEKSV_TPU_TORCH_DISPATCH_CALIB", str(p))
    _write(p, _fp(mb_s=10_000.0))
    monkeypatch.setattr(BatchAligner, "_upload_probe_mb_s",
                        staticmethod(lambda size_mb=4: 1_000.0))
    assert "upload bandwidth" in BatchAligner.calibration_stale()
    monkeypatch.setattr(BatchAligner, "_upload_probe_mb_s",
                        staticmethod(lambda size_mb=4: 9_000.0))
    assert BatchAligner.calibration_stale() is None


def test_missing_fingerprint_is_stale(tmp_path, monkeypatch, fake_cuda):
    p = tmp_path / "cal.json"
    monkeypatch.setenv("SEEKSV_TPU_TORCH_DISPATCH_CALIB", str(p))
    p.write_text(json.dumps({"crossover_cells": 123}))
    BatchAligner._load_calibration.cache_clear()
    assert "fingerprint" in BatchAligner.calibration_stale()


def test_ensure_calibration_reruns_the_ports_module(tmp_path, monkeypatch,
                                                   fake_cuda):
    p = tmp_path / "cal.json"
    monkeypatch.setenv("SEEKSV_TPU_TORCH_DISPATCH_CALIB", str(p))
    _write(p, _fp("NVIDIA B200"))
    calls = []

    def fake_run(cmd, timeout, env):
        calls.append((cmd, env))
        _write(p, _fp(), crossover=456)   # the rerun matches this card

        class _Proc:
            returncode = 0
        return _Proc()

    monkeypatch.setattr(subprocess, "run", fake_run)
    logs = []
    assert BatchAligner.ensure_calibration(auto=True, log=logs.append)
    cmd, env = calls[0]
    assert cmd[1:4] == ["-m", "seeksv_tpu_torch.scripts.calibrate_dispatch",
                        "--out"]
    assert cmd[-1] == str(p)
    assert not any("seeksv_tpu/" in c or "scripts/calibrate" in c
                   for c in cmd)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(engine.__file__))))
    assert env["PYTHONPATH"].split(os.pathsep)[0] == root
    assert BatchAligner._calibrated_min_device_cells() == 456
    # fingerprint now matches: no rerun
    assert not BatchAligner.ensure_calibration(auto=True, log=logs.append)
    assert len(calls) == 1


def test_ensure_calibration_timeout_keeps_committed_values(
        tmp_path, monkeypatch, fake_cuda):
    p = tmp_path / "cal.json"
    monkeypatch.setenv("SEEKSV_TPU_TORCH_DISPATCH_CALIB", str(p))
    monkeypatch.setenv("SEEKSV_TPU_TORCH_CALIBRATE_TIMEOUT_S", "7")
    _write(p, _fp("NVIDIA B200"))

    def fake_run(cmd, timeout, env):
        assert timeout == 7.0
        raise subprocess.TimeoutExpired(cmd, timeout)

    monkeypatch.setattr(subprocess, "run", fake_run)
    logs = []
    assert not BatchAligner.ensure_calibration(auto=True, log=logs.append)
    assert any("timed out" in str(m) for m in logs)
    assert BatchAligner._calibrated_min_device_cells() == 123


def test_no_cuda_never_stale(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = tmp_path / "cal.json"
    monkeypatch.setenv("SEEKSV_TPU_TORCH_DISPATCH_CALIB", str(p))
    _write(p, _fp("NVIDIA B200"))
    assert BatchAligner.calibration_stale() is None
    BatchAligner._load_calibration.cache_clear()


def test_committed_calibration_is_the_ports_own():
    """The committed files exist, name a CUDA card with its power limit,
    and lie inside the port (never seeksv_tpu/align/)."""
    for name in ("dispatch_calibration.json",
                 "device_align_calibration.json"):
        path = os.path.join(os.path.dirname(engine.__file__), name)
        with open(path) as f:
            cal = json.load(f)
        assert cal["platform"] == "cuda", name
        assert "W" in cal["card"], name
    BatchAligner._load_calibration.cache_clear()
    assert BatchAligner._calibration_path() == os.path.join(
        os.path.dirname(os.path.abspath(engine.__file__)),
        "dispatch_calibration.json")
    cal = BatchAligner._load_calibration(BatchAligner._calibration_path())
    assert cal["fingerprint"]["platform"] == "cuda"
    assert cal["crossover_cells"] == \
        BatchAligner._calibrated_min_device_cells()


def _row(cells, host_s, device_s):
    return {"cells": cells, "host_s": host_s, "device_s": device_s}


@pytest.mark.parametrize("rows,want", [
    # the card wins at the smallest size: nothing shows the host faster
    ([_row(1000, 2.0, 1.0), _row(4000, 4.0, 1.0)], 0),
    # the host wins, then the card: log-interpolated between the two
    ([_row(1000, 1.0, 2.0), _row(4000, 2.0, 1.0)], 2000),
    # a tie counts for the host: the crossover lies at the tie
    ([_row(1000, 1.0, 1.0), _row(4000, 2.0, 1.0)], 1000),
    # the card never wins: four times the largest size
    ([_row(1000, 1.0, 2.0), _row(4000, 2.0, 3.0)], 16000),
])
def test_calibrate_dispatch_crossover_rule(rows, want):
    from seeksv_tpu_torch.scripts.calibrate_dispatch import crossover_cells
    assert crossover_cells(rows) == want


def test_committed_crossover_follows_its_rows():
    """The committed dispatch calibration's crossover is what the
    program's rule gives for its own rows."""
    from seeksv_tpu_torch.scripts.calibrate_dispatch import crossover_cells
    with open(os.path.join(os.path.dirname(engine.__file__),
                           "dispatch_calibration.json")) as f:
        cal = json.load(f)
    assert cal["crossover_cells"] == crossover_cells(cal["rows"])


@pytest.fixture(scope="module")
def small_aligner_inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("gate")
    rng = np.random.default_rng(2)
    g = random_genome(rng, 30_000)
    fa = str(root / "ref.fa")
    write_fasta(fa, {"chrG": g})
    seqs = []
    for _ in range(40):
        s = int(rng.integers(0, 29_000))
        seqs.append(g[s:s + 120].tobytes())
    return BatchAligner.from_fasta(fa, device="cpu").idx, seqs


def _rounds(monkeypatch):
    """Record which extension round the aligner picks; the device round
    runs the host kernel in its place (no card here)."""
    picked = []
    host = BatchAligner._host_round.__func__

    def device_round(self, LQ, LT):
        picked.append("device")
        return host(BatchAligner, self.idx, LT)

    def host_round(cls, idx, LT):
        picked.append("host")
        return host(cls, idx, LT)
    monkeypatch.setattr(BatchAligner, "_device_round", device_round)
    monkeypatch.setattr(BatchAligner, "_host_round",
                        classmethod(host_round))
    return picked


def test_gate_sends_a_sub_crossover_batch_to_the_host(
        tmp_path, monkeypatch, fake_cuda, small_aligner_inputs):
    idx, seqs = small_aligner_inputs
    p = tmp_path / "cal.json"
    monkeypatch.setenv("SEEKSV_TPU_TORCH_DISPATCH_CALIB", str(p))
    picked = _rounds(monkeypatch)
    want = BatchAligner(idx, device="cpu").batch_align(seqs)
    picked.clear()
    _write(p, _fp(), crossover=10 ** 12)
    al = BatchAligner(idx, device="cuda")
    got = al.batch_align(seqs)
    d = al.last_dispatch
    assert picked == ["host"]
    assert d["crossover_applied"] and not d["chose_device"]
    assert d["est_actual_cells"] < d["crossover_cells"] == 10 ** 12
    assert d["forced"] is None
    # force_device passes the crossover
    picked.clear()
    al.batch_align(seqs, force_device=True)
    assert picked == ["device"] and al.last_dispatch["chose_device"]
    # a crossover at the batch's cells: the device round
    picked.clear()
    _write(p, _fp(), crossover=d["est_actual_cells"])
    al.batch_align(seqs)
    assert picked == ["device"] and al.last_dispatch["chose_device"]
    assert [a.__dict__ for a in got] == [a.__dict__ for a in want]


def test_cpu_route_applies_no_crossover(tmp_path, monkeypatch,
                                        small_aligner_inputs):
    idx, seqs = small_aligner_inputs
    p = tmp_path / "cal.json"
    monkeypatch.setenv("SEEKSV_TPU_TORCH_DISPATCH_CALIB", str(p))
    _write(p, _fp(), crossover=10 ** 12)
    al = BatchAligner(idx, device="cpu")
    al.batch_align(seqs)
    assert al.last_dispatch["chose_device"]
    assert not al.last_dispatch["crossover_applied"]
    BatchAligner._load_calibration.cache_clear()


def test_finalize_plan_crossover_and_share(monkeypatch, fake_cuda):
    """On a CUDA device the plan takes every eligible job (the H100's
    measured share is 1.0) when their estimated cells reach the
    crossover, none below it, all with force_device; on the CPU every
    eligible job; no share variable is read."""
    qs = [np.zeros(300 + (x % 3), np.uint8) for x in range(10)] + \
        [np.zeros(100, np.uint8)] * 3
    ts = [np.zeros(310, np.uint8)] * 13
    est = sum(min(len(q), 310) * 384 for q in qs[:10])
    al = BatchAligner.__new__(BatchAligner)
    al._dga = None
    al.device = torch.device("cuda")
    monkeypatch.setenv("SEEKSV_TPU_TORCH_FINALIZE_CROSSOVER_CELLS",
                       str(est + 1))
    monkeypatch.setenv("SEEKSV_TPU_TORCH_FINALIZE_DEVICE_SHARE", "0.55")
    assert al._device_finalize_plan(qs, ts, False) == (None, [])
    dga, rows = al._device_finalize_plan(qs, ts, True)
    assert rows == list(range(10))
    monkeypatch.setenv("SEEKSV_TPU_TORCH_FINALIZE_CROSSOVER_CELLS", str(est))
    _dga, rows = al._device_finalize_plan(qs, ts, False)
    assert rows == list(range(10))
    al.device = torch.device("cpu")
    assert al._device_finalize_plan(qs, ts, False)[1] == list(range(10))
    monkeypatch.delenv("SEEKSV_TPU_TORCH_FINALIZE_CROSSOVER_CELLS")
    assert al._min_device_finalize_cells() == \
        engine.MIN_DEVICE_FINALIZE_CELLS
    assert not hasattr(engine, "FINALIZE_DEVICE_SHARE")
