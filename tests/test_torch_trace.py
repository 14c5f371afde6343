"""The port's spans and counters (seeksv_tpu_torch/utils/trace.py): with
no profiler running the drivers record nothing and fill ``stages_s`` as
before; under ``torch.profiler`` the main thread's spans are user
annotations of the trace, nested under one ``seeksv.pass``, and the
worker threads' spans and the pass's counters reach the trace's metadata
with two clock anchors, named after the pass, that map them onto the
trace's clock; the outputs are the same bytes with the profiler on and
off."""
import contextlib
import gc
import gzip
import json
import os
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import seeksv_tpu_torch.cli as p_cli
from seeksv_tpu_torch.pipeline.stream import run_pipeline_streaming
from seeksv_tpu_torch.utils import trace
from seeksv_tpu_torch.utils.dataset import build_dataset

# several test workers share few cores: one intra-op thread each
torch.set_num_threads(1)

CHUNK = 20_000      # three decode slabs of the small dataset
STAGES = ["native", "scan_bam", "index", "realign", "getsv", "total"]
# the streamed decoder's counters (io/native.iter_bam_chunks_native)
SCAN_COUNTS = ("scan.slabs", "scan.slabs_recycled", "scan.slabs_summarised",
               "scan.windows", "scan.windows_ready")
# getclip's unmapped mates (pipeline/getclip.py)
UNMAPPED_COUNTS = ("getclip.unmapped_records", "getclip.unmapped_pairs")
# a whole pass adds getsv's discordant windows (pipeline/getsv.py)
PASS_COUNTS = ("scan.bam_bytes", *SCAN_COUNTS, *UNMAPPED_COUNTS,
               "getsv.window_records")
BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmark")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("trace")
    paths = build_dataset(str(root / "ds"), 200_000, 20, 100, 1, 6, False,
                          virus_kb=40, virus_events=12, virus_div=0.04)
    return root, paths


def _stream(paths, prefix, **kw):
    return run_pipeline_streaming(paths["ref_fa"], paths["bam"], str(prefix),
                                  device="cpu", chunk_records=CHUNK, **kw)


def _export(prof, path):
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        return json.load(f)


def _annotations(doc, prefix="seeksv."):
    return [e for e in doc["traceEvents"]
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"
            and e["name"].startswith(prefix)]


def _records(doc):
    return [doc[k] for k in sorted(doc, key=lambda k: (len(k), k))
            if k.startswith(trace.META_PREFIX)]


def _to_trace_us(doc, rec):
    """perf_counter ns -> the trace's microseconds, through the record's
    two anchors seeksv.clock.<pass>.0 and .1 (the last event of each
    name: an anchor opened again is its last one)."""
    c0, c1 = (max(e["ts"] for e in _annotations(
        doc, f"{trace.CLOCK}.{rec['pass']}.{i}")) for i in (0, 1))
    a0, a1 = rec["anchor_ns"]
    return lambda ns: c0 + (ns - a0) * (c1 - c0) / (a1 - a0)


@contextlib.contextmanager
def _no_gc():
    """No garbage collection inside the block: a collection between a
    span's two clocks (the annotation's and perf_counter's) would part
    them by its own milliseconds."""
    gc.collect()
    gc.disable()
    try:
        yield
    finally:
        gc.enable()


def test_no_profiler_records_nothing(data, tmp_path, monkeypatch):
    """No profiler: no record_function opened, no metadata written, no
    recording kept; stages_s has run_pipeline_streaming's keys, in order."""
    root, paths = data

    def refuse(*a, **kw):
        raise AssertionError("opened while no profiler runs")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd, "_add_metadata_json", refuse)
    before = trace.last()
    res = _stream(paths, tmp_path / "p")
    assert trace.last() is before
    assert getattr(trace._tls, "rec", None) is None
    assert list(res["stages_s"]) == STAGES
    assert all(isinstance(v, float) and v >= 0
               for v in res["stages_s"].values())
    assert res["stages_s"]["total"] >= sum(
        v for k, v in res["stages_s"].items() if k != "total")
    assert set(res["aligner"].timings) >= {
        "seed_s", "device_extend_s", "host_extend_s", "between_rounds_s",
        "finalize_s", "device_finalize_s", "index_load_s", "write_sam_s"}


def test_spans_nest_under_one_pass(tmp_path):
    """Parents and the pass id; a worker thread's span reaches the
    metadata (not the annotations), the main thread's the annotations."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.driver_pass():
            with trace.span("seeksv.test.outer"):
                token = trace.handoff()

                def work():
                    with trace.adopt(token), trace.span("seeksv.test.worker"):
                        trace.count("test.worker", 2)
                th = threading.Thread(target=work)
                th.start()
                th.join(timeout=30)
                assert not th.is_alive()
                with trace.span("seeksv.test.inner"):
                    trace.count("test.inner")
    rec = trace.last()
    by = {s[2]: s for s in rec.spans}
    assert by["seeksv.pass"][0] == rec.pass_id and by["seeksv.pass"][1] == 0
    assert by["seeksv.test.outer"][1] == rec.pass_id
    assert by["seeksv.test.inner"][1] == by["seeksv.test.outer"][0]
    assert by["seeksv.test.worker"][1] == by["seeksv.test.outer"][0]
    assert by["seeksv.test.worker"][3] != by["seeksv.test.outer"][3]
    assert rec.counts == {"test.worker": 2, "test.inner": 1}
    doc = _export(prof, tmp_path / "t.json")
    names = {e["name"] for e in _annotations(doc)}
    clock = f"{trace.CLOCK}.{rec.pass_id}"
    assert names == {"seeksv.pass", "seeksv.test.outer", "seeksv.test.inner",
                     f"{clock}.0", f"{clock}.1"}
    (meta,) = _records(doc)
    assert doc[f"{trace.META_PREFIX}{rec.pass_id}"] is meta
    assert meta["pass"] == rec.pass_id and len(meta["anchor_ns"]) == 2
    # the anchors lie inside the pass's root annotation
    (root,) = _annotations(doc, "seeksv.pass")
    for e in _annotations(doc, clock):
        assert root["ts"] <= e["ts"] <= root["ts"] + root["dur"]
    (w,) = meta["spans"]
    assert (w["name"], w["parent"], w["parent_name"]) == (
        "seeksv.test.worker", by["seeksv.test.outer"][0], "seeksv.test.outer")
    assert meta["counts"] == {"test.worker": 2, "test.inner": 1}
    assert set(meta) == {"pass", "thread", "anchor_ns", "spans", "counts"}


def test_threads_lose_no_span_or_count():
    """More recording threads than cores, switching often: every span
    and every count of every thread is kept, under the span that was
    open where the threads were handed the recording."""
    import os
    import sys
    n_threads, n_each = 4 * (os.cpu_count() or 2), 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            with trace.driver_pass(), trace.span("seeksv.test.outer") as o:
                token = trace.handoff()

                def work():
                    with trace.adopt(token):
                        for _ in range(n_each):
                            with trace.span("seeksv.test.worker"):
                                trace.count("test.n")
                ths = [threading.Thread(target=work)
                       for _ in range(n_threads)]
                for th in ths:
                    th.start()
                for th in ths:
                    th.join(timeout=60)
                assert not any(th.is_alive() for th in ths)
    finally:
        sys.setswitchinterval(old)
    rec = trace.last()
    workers = [s for s in rec.spans if s[2] == "seeksv.test.worker"]
    assert len(workers) == n_threads * n_each
    assert {s[1] for s in workers} == {o.sid}
    assert len({s[0] for s in rec.spans}) == len(rec.spans)
    assert rec.counts == {"test.n": n_threads * n_each}


def test_worker_span_maps_onto_the_trace_clock(tmp_path):
    """A worker span mapped through the anchors lands within 1 ms of
    where the main-thread span timed around it puts it."""
    go, done = threading.Event(), threading.Event()
    with _no_gc(), profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.driver_pass():
            time.sleep(0.05)
            token = trace.handoff()

            def work():
                with trace.adopt(token):
                    go.wait(timeout=30)
                    with trace.span("seeksv.test.worker"):
                        time.sleep(0.05)
                done.set()
            th = threading.Thread(target=work)
            th.start()
            with trace.span("seeksv.test.main"):
                go.set()
                assert done.wait(timeout=30)
            th.join(timeout=30)
            assert not th.is_alive()
            time.sleep(0.05)
    rec = trace.last()
    by = {s[2]: s for s in rec.spans}
    m, w = by["seeksv.test.main"], by["seeksv.test.worker"]
    assert m[4] <= w[4] and w[5] <= m[5]
    doc = _export(prof, tmp_path / "t.json")
    (ev,) = [e for e in _annotations(doc) if e["name"] == "seeksv.test.main"]
    (meta,) = _records(doc)
    to_us = _to_trace_us(doc, meta)
    (ws,) = meta["spans"]
    for ns, main_ns in ((ws["t0_ns"], m[4]), (ws["t1_ns"], m[4])):
        want = ev["ts"] + (ns - main_ns) / 1e3
        assert abs(to_us(ns) - want) < 1000
    assert ev["ts"] - 1000 <= to_us(ws["t0_ns"])
    assert to_us(ws["t1_ns"]) <= ev["ts"] + ev["dur"] + 1000


def test_stages_are_their_spans(data, tmp_path):
    """stages_s[k] is the seconds of its seeksv.stage.k span (exactly,
    in the recording; within 1 ms in the trace), total the pass's; the
    timings split realign by the seeksv.engine.* spans."""
    root, paths = data
    with _no_gc(), profile(activities=[ProfilerActivity.CPU]) as prof:
        res = _stream(paths, tmp_path / "p")
    stages = res["stages_s"]
    assert list(stages) == STAGES
    rec = trace.last()
    dur = {}
    for _i, _p, name, _th, t0, t1 in rec.spans:
        dur.setdefault(name, []).append((t1 - t0) * 1e-9)
    for k in STAGES[:-1]:
        assert dur[f"seeksv.stage.{k}"] == [stages[k]]
    assert dur["seeksv.pass"] == [stages["total"]]
    tm = res["aligner"].timings
    assert sum(dur["seeksv.engine.extend"]) == pytest.approx(
        tm["device_extend_s"], abs=1e-9)
    assert len(dur["seeksv.engine.extend"]) == 2
    assert sum(dur["seeksv.engine.between_rounds"]) == pytest.approx(
        tm["between_rounds_s"], abs=1e-9)
    doc = _export(prof, tmp_path / "t.json")
    ann = {e["name"]: e for e in _annotations(doc)}
    for k in STAGES[:-1]:
        assert abs(ann[f"seeksv.stage.{k}"]["dur"] * 1e-6 - stages[k]) < 1e-3
    # the main thread's scan spans cover the scan stage but for the set-up
    scan = ann["seeksv.stage.scan_bam"]
    inner = [e for e in _annotations(doc, "seeksv.scan.")
             if scan["ts"] <= e["ts"] <= scan["ts"] + scan["dur"]]
    assert {e["name"] for e in inner} == {
        "seeksv.scan.wait", "seeksv.scan.getclip", "seeksv.scan.unmapped",
        "seeksv.scan.stats", "seeksv.scan.release", "seeksv.scan.flush"}
    (meta,) = _records(doc)
    decode = [s for s in meta["spans"] if s["name"] == "seeksv.scan.decode"]
    # three slabs, and the read that finds the end
    assert len(decode) == 4
    assert {s["parent_name"] for s in decode} == {"seeksv.stage.scan_bam"}
    assert set(meta["counts"]) == set(PASS_COUNTS)
    assert meta["counts"]["scan.bam_bytes"] == os.path.getsize(paths["bam"])
    assert meta["counts"]["scan.slabs"] == 3
    to_us = _to_trace_us(doc, meta)
    for s in decode:
        assert scan["ts"] <= to_us(s["t0_ns"]) <= to_us(s["t1_ns"]) \
            <= scan["ts"] + scan["dur"]


def test_counters_of_two_passes_do_not_mix(data, tmp_path):
    """Two passes under one profiler: two records, each with its own
    pass's counts, equal for equal work."""
    root, paths = data
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _stream(paths, tmp_path / "a")
        _stream(paths, tmp_path / "b")
    doc = _export(prof, tmp_path / "t.json")
    a, b = _records(doc)
    assert a["pass"] < b["pass"]
    # the decoder's recycled sets and ready windows depend on the threads'
    # timing; the rest is the work's
    fixed = ("scan.bam_bytes", "scan.slabs", "scan.windows")
    assert [{k: r["counts"][k] for k in fixed} for r in (a, b)] == [
        {"scan.bam_bytes": os.path.getsize(paths["bam"]), "scan.slabs": 3,
         "scan.windows": a["counts"]["scan.windows"]}] * 2
    assert set(a["counts"]) == set(b["counts"]) == set(PASS_COUNTS)
    assert a["counts"]["getsv.window_records"] == \
        b["counts"]["getsv.window_records"] > 0
    # each record's spans lie between its own anchors
    for r in (a, b):
        to_us = _to_trace_us(doc, r)
        lo, hi = to_us(r["anchor_ns"][0]), to_us(r["anchor_ns"][1])
        assert all(lo <= to_us(s["t0_ns"]) <= to_us(s["t1_ns"]) <= hi
                   for s in r["spans"])


def test_outputs_identical_with_the_profiler(tmp_path):
    """run_pipeline_streaming with a normal writes the same .clip.gz,
    .clip.sam, .sv and .somatic.sv with the profiler on and off; the
    normal's decode spans lie under its scan, the counter adds both
    BAMs."""
    from torch_inputs import tumor_normal_dataset
    cancer, normal, fa = tumor_normal_dataset(tmp_path)
    kw = dict(device="cpu", chunk_records=CHUNK, normal_bam=normal)
    run_pipeline_streaming(fa, cancer, str(tmp_path / "off"), **kw)
    with profile(activities=[ProfilerActivity.CPU]):
        res = run_pipeline_streaming(fa, cancer, str(tmp_path / "on"), **kw)
    for ext, gz in (("clip.gz", True), ("clip.sam", False), ("sv", False),
                    ("somatic.sv", False)):
        op = gzip.open if gz else open
        with op(tmp_path / f"on.{ext}", "rb") as a, \
                op(tmp_path / f"off.{ext}", "rb") as b:
            assert a.read() == b.read(), ext
    rec = trace.last()
    names = rec.names()
    decode = [s for s in rec.spans if s[2] == "seeksv.scan.decode"]
    assert {names[s[1]] for s in decode} == {"seeksv.stage.scan_bam",
                                             "seeksv.somatic.scan"}
    got = {s[2] for s in rec.spans}
    assert got >= {"seeksv.stage.somatic", "seeksv.somatic.read_clips",
                   "seeksv.somatic.lookup", "seeksv.somatic.filter"}
    assert rec.counts["scan.bam_bytes"] == os.path.getsize(cancer) \
        + os.path.getsize(normal)
    assert set(rec.counts) == set(PASS_COUNTS)
    assert list(res["stages_s"]) == STAGES[:-1] + ["somatic", "total"]


def test_cli_run_stream_profile(data, tmp_path, capfd):
    """`run --stream --profile DIR` writes DIR/<prefix>.trace.json with
    the program's spans and counters, and the bytes of the run without
    it."""
    root, paths = data
    base = ["run", "--stream", "--chunk-records", str(CHUNK), "--device",
            "cpu", "--no-auto-calibrate"]
    assert p_cli.main(base + ["-o", str(tmp_path / "q"), paths["ref_fa"],
                              paths["bam"]]) == 0
    assert p_cli.main(base + ["--profile", str(tmp_path / "prof"), "-o",
                              str(tmp_path / "p"), paths["ref_fa"],
                              paths["bam"]]) == 0
    for ext in ("clip.sam", "sv"):
        assert (tmp_path / f"p.{ext}").read_bytes() == \
            (tmp_path / f"q.{ext}").read_bytes()
    with open(tmp_path / "prof" / "p.trace.json") as f:
        doc = json.load(f)
    names = {e["name"] for e in _annotations(doc)}
    assert {"seeksv.pass", "seeksv.stage.scan_bam", "seeksv.scan.wait",
            "seeksv.engine.extend", "seeksv.getsv.output"} <= names
    (meta,) = _records(doc)
    assert meta["counts"]["scan.bam_bytes"] == os.path.getsize(paths["bam"])
    assert any(s["name"] == "seeksv.scan.decode" for s in meta["spans"])
    err = capfd.readouterr().err
    stages = json.loads(err.strip().splitlines()[-1])["stages_s"]
    assert "profile_export" in stages and "scan_bam" in stages


def _reader(name):
    """read(ctx) of the benchmark's metrics/<name>.py."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"reader_{name}", os.path.join(BENCH, "metrics", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_scan_counters_and_their_readers(data, tmp_path, monkeypatch):
    """Under a profiler, scan_bam records the streamed decoder's four
    counters and getclip's two, and the benchmark's two readers of the
    decoder's return shares between 0 and 100 (``scan_unmapped_s`` a part
    of ``scan_getclip_s``); with no profiler nothing is recorded, and a
    trace without the counters gives the readers nothing to read."""
    from seeksv_tpu_torch.pipeline.getclip import GetclipStream
    from seeksv_tpu_torch.pipeline.stream import StreamStats, scan_bam
    monkeypatch.syspath_prepend(BENCH)
    root, paths = data

    def one_scan(prefix):
        g = GetclipStream(str(prefix))
        scan_bam(paths["bam"], CHUNK, [g, StreamStats(20, 5_000_000)])
        g.close()

    before = trace.last()
    one_scan(tmp_path / "off")
    assert trace.last() is before
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("bench.pass"):
            with trace.driver_pass():
                with trace.span("seeksv.stage.scan_bam"):
                    one_scan(tmp_path / "on")
    counts = trace.last().counts
    assert set(counts) == {"scan.bam_bytes", *SCAN_COUNTS, *UNMAPPED_COUNTS}
    assert counts["scan.slabs"] == 3
    assert counts["getclip.unmapped_records"] >= \
        2 * counts["getclip.unmapped_pairs"]
    assert 0 <= counts["scan.slabs_recycled"] <= counts["scan.slabs"]
    assert 1 <= counts["scan.windows"]
    assert 0 <= counts["scan.windows_ready"] <= counts["scan.windows"]
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    ctx = {"trace_path": str(tmp_path / "t.json")}
    for name, part, whole in (
            ("scan_slab_reuse_pct", "scan.slabs_recycled", "scan.slabs"),
            ("scan_inflate_ready_pct", "scan.windows_ready",
             "scan.windows")):
        v = _reader(name)(ctx)
        assert 0 <= v <= 100
        assert v == pytest.approx(100 * counts[part] / counts[whole])
    assert 0 <= _reader("scan_unmapped_s")(ctx) <= \
        _reader("scan_getclip_s")(ctx)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("bench.pass"):
            with torch.profiler.record_function("seeksv.stage.scan_bam"):
                one_scan(tmp_path / "bare")
    prof.export_chrome_trace(str(tmp_path / "bare.json"))
    ctx = {"trace_path": str(tmp_path / "bare.json")}
    assert _reader("scan_slab_reuse_pct")(ctx) is None
    assert _reader("scan_inflate_ready_pct")(ctx) is None
    assert _reader("scan_unmapped_s")(ctx) is None


def test_cigar_summary_counter_and_its_reader(data, tmp_path, monkeypatch):
    """A native scan counts every slab as carrying the CIGAR summary
    (``scan.slabs_summarised`` equals ``scan.slabs``) and the benchmark's
    reader gives 100; the Python decoder's scan records neither counter,
    and a scan whose slabs' summary was not counted (a decoder without
    it) reads nothing, not 0."""
    from seeksv_tpu_torch.io import native
    from seeksv_tpu_torch.pipeline.getclip import GetclipStream
    from seeksv_tpu_torch.pipeline.stream import StreamStats, scan_bam
    monkeypatch.syspath_prepend(BENCH)
    root, paths = data
    read = _reader("scan_cigar_summary_pct")

    def traced_scan(name):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with torch.profiler.record_function("bench.pass"):
                with trace.driver_pass():
                    with trace.span("seeksv.stage.scan_bam"):
                        g = GetclipStream(str(tmp_path / name))
                        scan_bam(paths["bam"], CHUNK,
                                 [g, StreamStats(20, 5_000_000)])
                        g.close()
        prof.export_chrome_trace(str(tmp_path / f"{name}.json"))
        return trace.last().counts, read(
            {"trace_path": str(tmp_path / f"{name}.json")})

    counts, pct = traced_scan("native")
    assert counts["scan.slabs_summarised"] == counts["scan.slabs"] == 3
    assert pct == 100.0
    with monkeypatch.context() as m:
        m.setattr(native, "available", lambda: False)
        counts, pct = traced_scan("python")
    assert "scan.slabs_summarised" not in counts
    assert "scan.slabs" not in counts and pct is None
    count = trace.count
    with monkeypatch.context() as m:
        m.setattr(trace, "count", lambda name, n=1: None if name ==
                  "scan.slabs_summarised" else count(name, n))
        counts, pct = traced_scan("unsummarised")
    assert "scan.slabs_summarised" not in counts
    assert counts["scan.slabs"] == 3 and pct is None


def test_window_records_counter_and_its_reader(data, tmp_path,
                                               monkeypatch):
    """A streamed pass under a profiler inside ``bench.pass`` records
    ``getsv.window_records``, and the benchmark's reader gives it over
    the pass's ``seeksv.getsv.windows`` seconds (inside its
    ``seeksv.getsv.discordant``); the same pass with
    no profiler records nothing."""
    monkeypatch.syspath_prepend(BENCH)
    root, paths = data
    before = trace.last()
    _stream(paths, tmp_path / "off")
    assert trace.last() is before
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("bench.pass"):
            _stream(paths, tmp_path / "on")
    n = trace.last().counts["getsv.window_records"]
    doc = _export(prof, tmp_path / "t.json")
    sec = sum(e["dur"] * 1e-6
              for e in _annotations(doc, "seeksv.getsv.windows"))
    outer = sum(e["dur"] * 1e-6
                for e in _annotations(doc, "seeksv.getsv.discordant"))
    assert n > 0 and 0 < sec < outer
    v = _reader("getsv_window_records_per_s")(
        {"trace_path": str(tmp_path / "t.json")})
    assert v == pytest.approx(n / sec, rel=1e-6)
