"""The virus-panel cell's additions to the benchmark: the generator's
panel dataset (its ``virus`` contig, VINT truth with overlapping panel
offsets, record count), the reader ``getsv_window_records_per_s`` on a
synthetic trace, and the frozen copy of the plain reference."""
import json
import os

import pytest

from bench_helpers import BENCH, REPO

MS = 1000                        # microseconds
WINDOW_RECORDS = (3_000_000, 3_300_000)


def _config():
    with open(os.path.join(BENCH, "configs", "oncovirus_panel_30x.json")) as f:
        return json.load(f)


def test_panel_config_key():
    """The sizes the configuration gives the generator."""
    from sbench.datagen import data_key
    key = data_key(_config(), {"sample": "single"}, 2 ** 31 + 7)
    assert key["sizes"] == {
        "genome_bp": 100_000_000, "coverage": 30, "read_len": 100,
        "insert_mean": 500, "insert_sd": 25, "error_rate": 0.002,
        "n_events": 500, "virus_bp": 430_000, "virus_events": 1_000,
        "virus_div": 0.04}
    assert key["seed"] == 2 ** 31 + 7


def test_panel_dataset(tmp_path):
    """A small panel build: a 60 kb ``virus`` contig beside ``chr17``,
    40 integrations with overlapping panel offsets, and the record count
    the build reports is the BAM's."""
    from sbench import judge
    from sbench import plain_pair_evidence as plain
    from sbench.datagen import build, data_key
    cfg = dict(_config(), genome_bp=1_000_000, coverage=10, n_events=10,
               virus_bp=60_000, virus_events=40)
    key = data_key(cfg, {"sample": "single"}, 2 ** 31 + 7)
    p = build(key, str(tmp_path))
    g = judge.Genome(p["ref_fa"])
    assert g.names == ["chr17", "virus"]
    assert list(g.lens) == [1_000_000, 60_000]
    with open(p["truth"]) as f:
        truth = json.load(f)
    vint = [t for t in truth if t["type"] == "VINT"]
    assert len(vint) == 40
    assert {(t["up_chrom"], t["down_chrom"]) for t in vint} == {
        ("chr17", "virus")}
    spans = sorted((t["down"], t["right_up"]) for t in vint)
    assert all(1 <= a < b <= 60_000 and 500 <= b - a + 1 < 2_000
               for a, b in spans)
    assert any(b0 >= a1 for (_a0, b0), (a1, _b1) in zip(spans, spans[1:]))
    assert len(truth) == 40 + 10
    cols = plain.bam_columns(p["bams"][0])
    assert p["n_records"] == [cols["pos"].numel()]


def _x(name, t0, t1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": t0,
            "dur": t1 - t0, "pid": 1, "tid": 1}


def _trace(path, counter=True, program=True):
    """Two passes of 1 s; pass k's window loop is two spans of
    (k + 1) x 100 ms, each inside a discordant step 50 ms longer (the
    counter's construction, which the reader leaves out), its counter
    WINDOW_RECORDS[k]."""
    ev = [_x("bench.window", 0, 2_200 * MS)]
    doc = {}
    for k, b in enumerate((0, 1_100 * MS)):
        pid = 7 + k
        ev.append(_x("bench.pass", b, b + 1_000 * MS))
        if not program:
            continue
        d = (k + 1) * 100 * MS
        ev += [_x(f"seeksv.clock.{pid}.0", b + 10, b + 11),
               _x("seeksv.stage.getsv", b + 200 * MS, b + 900 * MS),
               _x("seeksv.getsv.discordant", b + 250 * MS, b + 300 * MS + d),
               _x("seeksv.getsv.windows", b + 300 * MS, b + 300 * MS + d),
               _x("seeksv.getsv.depth", b + 600 * MS, b + 650 * MS),
               _x("seeksv.getsv.discordant", b + 650 * MS, b + 700 * MS + d),
               _x("seeksv.getsv.windows", b + 700 * MS, b + 700 * MS + d),
               _x(f"seeksv.clock.{pid}.1", b + 950 * MS, b + 950 * MS + 1)]
        counts = {"scan.bam_bytes": 10}
        if counter:
            counts["getsv.window_records"] = WINDOW_RECORDS[k]
        doc[f"seeksv.pass.{pid}"] = {
            "pass": pid, "thread": 1, "spans": [], "counts": counts,
            "anchor_ns": [10 ** 12 + k, 10 ** 12 + k + 950 * 10 ** 6]}
    doc["traceEvents"] = ev
    with open(path, "w") as f:
        json.dump(doc, f)


def _read(ctx):
    from sbench import loader
    return loader.Spec(REPO).reader("getsv_window_records_per_s")(ctx)


def test_window_records_reader(tmp_path):
    p = str(tmp_path / "t.json")
    _trace(p)
    want = (WINDOW_RECORDS[0] / 0.2 + WINDOW_RECORDS[1] / 0.4) / 2
    assert _read({"trace_path": p, "passes": []}) == pytest.approx(
        want, rel=1e-9)


@pytest.mark.parametrize("counter, program", [(False, True), (False, False)])
def test_window_records_reader_none_without_the_counter(tmp_path, counter,
                                                        program):
    """The parent's program has no such counter: nothing, and no
    error."""
    p = str(tmp_path / "t.json")
    _trace(p, counter, program)
    assert _read({"trace_path": p, "passes": []}) is None
    assert _read({"trace_path": None, "passes": []}) is None


def test_frozen_plain_reference_is_the_tests_copy():
    """The benchmark's copy of tests/plain_pair_evidence.py differs from
    it only in the note that heads its docstring."""
    with open(os.path.join(REPO, "tests", "plain_pair_evidence.py")) as f:
        orig = f.read()
    with open(os.path.join(BENCH, "sbench", "plain_pair_evidence.py")) as f:
        copy = f.read()
    head, sep, rest = copy.partition("\n\n")
    assert head.startswith('"""Frozen copy of tests/plain_pair_evidence.py')
    assert '"""' + rest == orig
