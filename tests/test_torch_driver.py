"""The port's run_pipeline with rescue, filtered_out and profile_dir, and
run_pipeline_streaming with filtered_out, against the JAX package's
drivers on a small simulated dataset (200 kb host + 40 kb virus panel,
100 bp reads at 20x, seed 1), byte for byte; `run --rescue --profile`
through the port's CLI against the JAX package's `run --rescue`."""
import gzip
import io
import json
import os

import pytest
import torch

import seeksv_tpu.cli as r_cli
import seeksv_tpu.pipeline.driver as r_driver
import seeksv_tpu.pipeline.stream as r_stream
import seeksv_tpu_torch.cli as p_cli
import seeksv_tpu_torch.pipeline.driver as p_driver
import seeksv_tpu_torch.pipeline.stream as p_stream
from seeksv_tpu_torch.utils.dataset import build_dataset

# several test workers share few cores: one intra-op thread each
torch.set_num_threads(1)

OUTPUTS = (("clip.sam", False), ("sv", False), ("unmapped.clip.fq", False),
           ("clip.gz", True))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("driver")
    paths = build_dataset(str(root / "ds"), 200_000, 20, 100, 1, 6, False,
                          virus_kb=40, virus_events=12, virus_div=0.04)
    return root, paths


def _same(a_prefix, b_prefix):
    for suffix, gz in OUTPUTS:
        with (gzip.open if gz else open)(f"{a_prefix}.{suffix}", "rb") as a, \
                (gzip.open if gz else open)(f"{b_prefix}.{suffix}",
                                            "rb") as b:
            assert a.read() == b.read(), suffix


def test_run_pipeline_rescue_and_filtered_out(data, tmp_path):
    root, paths = data
    r_f, p_f = io.StringIO(), io.StringIO()
    r_driver.run_pipeline(paths["ref_fa"], paths["bam"], str(tmp_path / "r"),
                          rescue=True, filtered_out=r_f)
    res = p_driver.run_pipeline(paths["ref_fa"], paths["bam"],
                                str(tmp_path / "p"), device="cpu",
                                rescue=True, filtered_out=p_f)
    _same(tmp_path / "p", tmp_path / "r")
    assert p_f.getvalue() == r_f.getvalue() != ""
    rescued = (tmp_path / "p.unmapped.clip.fq").read_bytes()
    assert rescued.count(b"\n") >= 4       # rescue wrote sequences
    assert "profile_export" not in res["stages_s"]
    # without rescue the rescue fastq stays empty, as the reference's
    p_driver.run_pipeline(paths["ref_fa"], paths["bam"],
                          str(tmp_path / "q"), device="cpu")
    assert (tmp_path / "q.unmapped.clip.fq").read_bytes() == b""


def test_run_pipeline_profile_dir_writes_a_trace(data, tmp_path):
    """profile_dir traces read_bam through getsv (torch.profiler, CPU
    activity on the CPU device) into {dir}/{prefix name}.trace.json; the
    outputs are those of the run without it."""
    root, paths = data
    prof = tmp_path / "prof"
    res = p_driver.run_pipeline(paths["ref_fa"], paths["bam"],
                                str(tmp_path / "p"), device="cpu",
                                profile_dir=str(prof))
    p_driver.run_pipeline(paths["ref_fa"], paths["bam"], str(tmp_path / "q"),
                          device="cpu")
    _same(tmp_path / "p", tmp_path / "q")
    with open(prof / "p.trace.json") as f:
        trace = json.load(f)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any(n.startswith("aten::") for n in names)
    assert res["stages_s"]["profile_export"] >= 0


def test_run_pipeline_profiler_failure_raises(data, tmp_path, monkeypatch):
    """Where the reference runs on without a trace, the port raises when
    the profiler cannot start."""
    import torch.profiler as tp
    root, paths = data

    class _Broken:
        def __init__(self, *a, **kw):
            pass

        def __enter__(self):
            raise RuntimeError("profiler refused to start")

        def __exit__(self, *exc):
            return False
    monkeypatch.setattr(tp, "profile", _Broken)
    with pytest.raises(RuntimeError, match="refused"):
        p_driver.run_pipeline(paths["ref_fa"], paths["bam"],
                              str(tmp_path / "p"), device="cpu",
                              profile_dir=str(tmp_path / "prof"))


def test_streaming_filtered_out(data, tmp_path):
    root, paths = data
    r_f, p_f = io.StringIO(), io.StringIO()
    r_stream.run_pipeline_streaming(paths["ref_fa"], paths["bam"],
                                    str(tmp_path / "r"), chunk_records=50_000,
                                    filtered_out=r_f)
    p_stream.run_pipeline_streaming(paths["ref_fa"], paths["bam"],
                                    str(tmp_path / "p"), device="cpu",
                                    chunk_records=50_000, filtered_out=p_f)
    for suffix in ("clip.sam", "sv"):
        assert (tmp_path / f"p.{suffix}").read_bytes() == \
            (tmp_path / f"r.{suffix}").read_bytes(), suffix
    assert p_f.getvalue() == r_f.getvalue() != ""


def test_cli_run_rescue_profile(data, tmp_path, capfd):
    """`run --rescue --profile DIR --device cpu --no-auto-calibrate`
    through the port's CLI: the reference CLI's `run --rescue` bytes, and
    a trace in DIR."""
    root, paths = data
    assert r_cli.main(["run", "--rescue", "--no-auto-calibrate", "-o",
                       str(tmp_path / "r"), paths["ref_fa"],
                       paths["bam"]]) == 0
    assert p_cli.main(["run", "--rescue", "--device", "cpu", "--profile",
                       str(tmp_path / "prof"), "-o", str(tmp_path / "p"),
                       paths["ref_fa"], paths["bam"]]) == 0
    _same(tmp_path / "p", tmp_path / "r")
    assert os.path.getsize(tmp_path / "prof" / "p.trace.json") > 0
    err = capfd.readouterr().err
    assert "stages_s" in err and "dispatch calibration" not in err


def test_cli_run_device_align_auto(data, tmp_path, capfd, monkeypatch):
    """--device-align-auto reads the port's own device-align calibration:
    with the committed file's answer the run takes (or leaves) the device
    front-end, and writes the bytes of the matching run."""
    from seeksv_tpu_torch.ops import align_device
    root, paths = data
    for want in (False, True):
        monkeypatch.setattr(align_device, "device_align_auto_enabled",
                            lambda w=want: w)
        out = tmp_path / f"p{int(want)}"
        assert p_cli.main(["run", "--device-align-auto", "--device", "cpu",
                           "-o", str(out), paths["ref_fa"],
                           paths["bam"]]) == 0
        assert f"--device-align-auto -> {want}" in capfd.readouterr().err
    assert (tmp_path / "p0.sv").read_bytes() == \
        (tmp_path / "p1.sv").read_bytes()
