"""sbench/program_spans.py and the six readers of the program's own
spans and counter, on a synthetic Chrome trace: two passes, each with
its main-thread ``seeksv.*`` annotations, its two anchors
``seeksv.clock.<id>.0`` / ``.1`` and a metadata record holding the
decode thread's spans in perf_counter nanoseconds on a clock that runs
1e-4 fast."""
import json

import pytest

from bench_helpers import REPO

MS = 1000                    # microseconds
PASS0 = (0, 1_100 * MS)      # the two bench.pass spans' starts (us)
PASS_ID = (3, 21)            # their records' pass ids
ANCHOR_NS = (5_000_000_000_000, 7_000_000_000_000)
FAST = 1.0001                # perf_counter ns per trace ns
BAM_BYTES = (40_000_000, 80_000_000)
READERS = ("scan_decode_s", "scan_wait_s", "scan_getclip_s", "scan_stats_s",
           "somatic_self_s", "scan_decode_mb_per_s")


def _x(name, t0, t1, cat="user_annotation"):
    return {"ph": "X", "cat": cat, "name": name, "ts": t0, "dur": t1 - t0,
            "pid": 1, "tid": 1}


def _pass(k):
    """Pass k: the tumour's scan, realign's K1, the somatic stage with
    the normal's scan.  Pass 0's first anchor was opened twice (the
    second is the anchor); pass 1 has a second getclip span."""
    b, pid = PASS0[k], PASS_ID[k]
    clock = f"seeksv.clock.{pid}"
    ev = [_x("bench.pass", b, b + 1_000 * MS),
          _x("seeksv.pass", b + 5, b + 980 * MS),
          _x(f"{clock}.0", b + 10, b + 11),
          _x("seeksv.stage.scan_bam", b + 100, b + 500 * MS + 100),
          _x("seeksv.scan.wait", b + 100, b + 100 * MS + 100),
          _x("seeksv.scan.getclip", b + 100 * MS + 100, b + 300 * MS + 100),
          _x("seeksv.scan.stats", b + 300 * MS + 100, b + 400 * MS + 100),
          _x("seeksv.scan.release", b + 400 * MS + 100, b + 400 * MS + 200),
          _x("seeksv.scan.flush", b + 450 * MS, b + 500 * MS),
          _x("seeksv.stage.realign", b + 520 * MS, b + 580 * MS),
          _x("seeksv.engine.extend", b + 530 * MS, b + 540 * MS),
          _x("seeksv.stage.somatic", b + 600 * MS, b + 900 * MS),
          _x("seeksv.somatic.scan", b + 600 * MS, b + 800 * MS),
          _x("seeksv.scan.wait", b + 600 * MS, b + 650 * MS),
          _x(f"{clock}.1", b + 970 * MS, b + 970 * MS + 1)]
    if k == 0:
        ev.append(_x(f"{clock}.0", b + 7, b + 8))
    else:
        ev.append(_x("seeksv.scan.getclip", b + 400 * MS + 200,
                     b + 450 * MS))
    return ev


def _ns(k, us):
    """The perf_counter ns at trace time us of pass k."""
    return ANCHOR_NS[k] + round((us - (PASS0[k] + 10)) * 1000 * FAST)


def _record(k):
    b = PASS0[k]
    spans = [{"name": "seeksv.scan.decode", "thread": 2,
              "t0_ns": _ns(k, b + t0), "t1_ns": _ns(k, b + t1),
              "id": 100 + i, "parent": 4 if k else 1, "parent_name": parent}
             for i, (t0, t1, parent) in enumerate(
                 ((200, 150 * MS + 200, "seeksv.stage.scan_bam"),
                  (150 * MS + 300, 300 * MS + 300, "seeksv.stage.scan_bam"),
                  (610 * MS, 710 * MS, "seeksv.somatic.scan")))]
    return {"pass": PASS_ID[k], "thread": 1,
            "anchor_ns": [_ns(k, b + 10), _ns(k, b + 970 * MS)],
            "spans": spans, "counts": {"scan.bam_bytes": BAM_BYTES[k]}}


def _write(path, program=True, records=(1, 0)):
    ev = [_x("bench.window", 0, 2_200 * MS)]
    for k in range(len(PASS0)):
        ps = _pass(k)
        ev += ps if program else ps[:1]
    ev.append(_x("extend_kernel<4>", 50 * MS, 60 * MS, cat="kernel"))
    doc = {"traceEvents": ev}
    if program:
        for k in records:
            doc[f"seeksv.pass.{PASS_ID[k]}"] = _record(k)
    with open(path, "w") as f:
        json.dump(doc, f)


@pytest.fixture
def ctx(tmp_path):
    p = str(tmp_path / "trace.json")
    _write(p)
    return {"trace_path": p, "passes": [], "calls": None}


def _read(name, ctx):
    from sbench import loader
    return loader.Spec(REPO).reader(name)(ctx)


@pytest.mark.parametrize("name, want", [
    ("scan_decode_s", 0.3),
    ("scan_wait_s", 0.1),
    ("scan_getclip_s", (0.25 + 0.2998) / 2),
    ("scan_stats_s", 0.1),
    ("somatic_self_s", 0.1),
    ("scan_decode_mb_per_s", (40 + 80) / 0.4 / 2)])
def test_readers_values(ctx, name, want):
    assert _read(name, ctx) == pytest.approx(want, rel=1e-9, abs=1e-9)


def test_pass_assignment_and_clock_mapping(ctx):
    from sbench import program_spans
    ps = program_spans.load(ctx)
    assert [r[1]["scan.bam_bytes"] for r in ps.records] == list(BAM_BYTES)
    per = ps.per_pass()
    assert len(per) == 2
    for k, p in enumerate(per):
        b = PASS0[k] * 1e-6
        assert [s[3] for s in p["worker"]] == [
            "seeksv.stage.scan_bam", "seeksv.stage.scan_bam",
            "seeksv.somatic.scan"]
        # mapped through the anchors, not by the raw ns: within 1 ns
        assert p["worker"][0][1] == pytest.approx(b + 200e-6, abs=1e-9)
        assert p["worker"][0][2] - p["worker"][0][1] == pytest.approx(
            0.15, abs=1e-9)
        assert len(p["main"]) == 12 + k
        assert not any(s[0].startswith("seeksv.clock") for s in p["main"])
        assert all(b <= s[1] <= b + 1.0 for s in p["main"])
    assert ps.pass_of(1.05) is None
    assert ps.pass_of(1.1) == 1
    to_s = program_spans.clock_map(10, 2010, 1.0, 1.001)
    assert to_s(1010) == pytest.approx(1.0005)


def test_a_missing_record_moves_no_other_pass(tmp_path):
    """Pass 0's record lost: pass 1's spans still map through its own
    anchors, by name, and the readers read pass 1 alone."""
    p = str(tmp_path / "trace.json")
    _write(p, records=(1,))
    c = {"trace_path": p, "passes": []}
    from sbench import program_spans
    per = program_spans.load(c).per_pass()
    assert per[0]["worker"] == []
    assert per[1]["worker"][0][1] == pytest.approx(1.1 + 200e-6, abs=1e-9)
    assert _read("scan_decode_s", c) == pytest.approx(0.3, abs=1e-9)
    assert _read("scan_decode_mb_per_s", c) == pytest.approx(80 / 0.4)


def test_readers_none_without_program_spans(tmp_path):
    p = str(tmp_path / "trace.json")
    _write(p, program=False)
    for name in READERS:
        assert _read(name, {"trace_path": p, "passes": []}) is None
        assert _read(name, {"trace_path": None, "passes": []}) is None
