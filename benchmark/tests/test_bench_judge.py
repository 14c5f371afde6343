"""The check that decides ``correct``: the plain aligner is exact, a
sound run of a small cell passes, the control fails, and each fault the
cells can have, planted under the timed path, makes ``correct`` false.
(The control at the cells' own size runs on the card through
benchmark/proof.py.)"""
import gzip

import numpy as np
import pytest

from bench_helpers import quiet, tiny_cell


def _brute(q, t):
    n, m = len(q), len(t)
    H = np.zeros((n + 1, m + 1), int)
    E = np.full((n + 1, m + 1), -10 ** 9)
    F = np.full((n + 1, m + 1), -10 ** 9)
    best = 0
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            E[i][j] = max(H[i - 1][j] - 7, E[i - 1][j] - 1)
            F[i][j] = max(H[i][j - 1] - 7, F[i][j - 1] - 1)
            s = 1 if q[i - 1] == t[j - 1] else -4
            H[i][j] = max(0, H[i - 1][j - 1] + s, E[i][j], F[i][j])
            best = max(best, H[i][j])
    return best


def test_bench_plain_aligner_is_exact():
    from sbench import judge
    rng = np.random.default_rng(0)
    qs, ts = [], []
    for _ in range(40):
        t = rng.integers(0, 4, rng.integers(5, 50)).astype(np.uint8)
        q = t[rng.integers(0, 3):].copy()
        cut = len(q) // 2
        q = np.concatenate([q[:cut], rng.integers(0, 4, rng.integers(0, 4))
                            .astype(np.uint8), q[cut + rng.integers(0, 4):]])
        flip = rng.random(len(q)) < 0.1
        q[flip] = rng.integers(0, 4, flip.sum())
        qs.append(q)
        ts.append(t)
    want = [_brute(q, t) for q, t in zip(qs, ts)]
    assert judge._sw(qs, ts, "cpu").tolist() == want
    best, narrow, pick = judge._sw(qs, ts, "cpu", cap=7)
    assert best.tolist() == want
    assert (narrow <= 7).all() and (pick <= best).all()


def test_bench_path_score():
    from sbench import judge

    class G:
        pass
    g = G()
    g.tid, g.lens, g.starts = {"c": 0}, np.array([20]), np.array([0, 20])
    g.codes = np.frombuffer(b"ACGTACGTAACCGGTTACGT", np.uint8)
    g.codes = judge._CODE[g.codes]
    rec = {"qname": "GTACGTTAAC", "flag": 0, "rname": "c", "pos": 2,
           "cigar": "6M1D2M2S", "seq": "GTACGTTAAC"}
    # GTACGT matches 6, a deletion of A (-7), AA/CC... :
    # ref after the deletion at 9: "AC" against "TA": 2 mismatches
    score, base, span = judge.path_score(g, rec)
    assert (score, base, span) == (6 - 7 - 8, 2, 9)
    assert judge.path_score(g, dict(rec, seq="GTACGTTAAA"))[1] is None
    assert judge.path_score(g, dict(rec, cigar="6M1D2M1S"))[1] is None


def _run(tmp_path, workload, fault=None, control=False, traffic=None):
    from sbench import harness
    cell = tiny_cell(workload, traffic)
    data = harness.ensure_data(str(tmp_path), cell, 2 ** 31 + 11, quiet)
    ctx = harness.measure(cell, data, 0.0, False, "cpu",
                          str(tmp_path / "w"), quiet)
    if fault:
        fault(ctx["prefix"])
    return harness.check(cell, data, ctx["prefix"], 2 ** 31 + 11, "cpu",
                         control=control)


@pytest.mark.parametrize("workload,traffic", [
    ("short100_30x.stream", None), ("short100_30x.somatic", None),
    ("short100_30x.stream", "run")])
def test_bench_sound_run_is_correct(tmp_path, workload, traffic):
    checks = _run(tmp_path, workload, traffic=traffic)
    assert all(c["ok"] for c in checks.values()), checks
    assert checks["clip_sam_unmatched"]["value"] == 0
    assert checks["clip_breakend_recall"]["value"] == 1.0
    assert "somatic_recall" in checks or "somatic" not in workload


@pytest.mark.parametrize("workload", ["short100_30x.stream",
                                      "short100_30x.somatic"])
def test_bench_control_fails(tmp_path, workload):
    """The plain aligner in saturating arithmetic one integer type
    narrower than the configuration's scores need (int4 for short
    reads' int8), put in the program's place, loses more of the best
    scores than the limit allows, so the check comes out not correct;
    the program's own run passes on the same outputs."""
    from sbench import harness
    cell = tiny_cell(workload)
    data = harness.ensure_data(str(tmp_path), cell, 2 ** 31 + 11, quiet)
    ctx = harness.measure(cell, data, 0.0, False, "cpu",
                          str(tmp_path / "w"), quiet)
    prog = harness.check(cell, data, ctx["prefix"], 2 ** 31 + 11, "cpu")
    ctrl = harness.check(cell, data, ctx["prefix"], 2 ** 31 + 11, "cpu",
                         control=True)
    assert all(c["ok"] for c in prog.values()), prog
    assert not ctrl["aln_score_lost_pct"]["ok"], ctrl
    assert ctrl["aln_score_lost_pct"]["limit"] == \
        prog["aln_score_lost_pct"]["limit"]


def _half_unaligned(monkeypatch):
    from seeksv_tpu_torch.align import engine
    real = engine.BatchAligner.batch_align

    def half(self, seqs, **kw):
        out = real(self, seqs, **kw)
        return [engine.Alignment(False) if i % 2 else a
                for i, a in enumerate(out)]
    monkeypatch.setattr(engine.BatchAligner, "batch_align", half)


def _moved(monkeypatch):
    from seeksv_tpu_torch.align import engine
    real = engine.BatchAligner.batch_align

    def moved(self, seqs, **kw):
        out = real(self, seqs, **kw)
        for a in out:
            if a.mapped:
                a.pos += 3
        return out
    monkeypatch.setattr(engine.BatchAligner, "batch_align", moved)


def _calls_moved(monkeypatch):
    from seeksv_tpu_torch.pipeline import driver, stream
    for mod in (driver, stream):
        real = mod.getsv

        def getsv(clip_sam, bam, clip_gz, sv, *a, _real=real, **kw):
            r = _real(clip_sam, bam, clip_gz, sv, *a, **kw)
            with open(sv) as f:
                rows = f.read().splitlines(True)
            with open(sv, "w") as f:
                for ln in rows:
                    fl = ln.split("\t")
                    if not ln.startswith("@"):
                        fl[1] = str(int(fl[1]) + 200)
                    f.write("\t".join(fl))
            return r
        monkeypatch.setattr(mod, "getsv", getsv)


def _unchanged(monkeypatch):
    """A pass that leaves its state as it was: it writes nothing."""
    from seeksv_tpu_torch.pipeline import driver, stream
    calls = {"n": 0}
    for mod, name in ((driver, "run_pipeline"),
                      (stream, "run_pipeline_streaming")):
        real = getattr(mod, name)

        def run(*a, _real=real, **kw):
            calls["n"] += 1
            if calls["n"] == 1:
                return _real(*a, **kw)
            return {"stages_s": {}, "aligner": None}
        monkeypatch.setattr(mod, name, run)


def _every_second(lines: list, width: int) -> list:
    return [ln for i in range(0, len(lines), 2 * width)
            for ln in lines[i:i + width]]


def _half_clips_left_out(monkeypatch):
    """getclip loses half of its work: every second row of ``.clip.gz``
    and its query in ``.clip.fq.gz`` are gone before realign reads
    them."""
    from seeksv_tpu_torch.pipeline import driver, stream
    for mod in (driver, stream):
        real = mod.realign_clips

        def realign(ref_fa, clip_fq, out_sam, *a, _real=real, **kw):
            prefix = out_sam[:-len(".clip.sam")]
            for path, width in ((f"{prefix}.clip.gz", 1), (clip_fq, 4)):
                with gzip.open(path, "rt") as f:
                    lines = f.readlines()
                with gzip.open(path, "wt") as f:
                    f.writelines(_every_second(lines, width))
            return _real(ref_fa, clip_fq, out_sam, *a, **kw)
        monkeypatch.setattr(mod, "realign_clips", realign)


def _half_records_left_out(monkeypatch):
    """realign writes the records of every second query only."""
    from seeksv_tpu_torch.pipeline import driver, stream
    for mod in (driver, stream):
        real = mod.realign_clips

        def realign(ref_fa, clip_fq, out_sam, *a, _real=real, **kw):
            r = _real(ref_fa, clip_fq, out_sam, *a, **kw)
            with open(out_sam) as f:
                lines = f.readlines()
            keep, k = [], -1
            for ln in lines:
                if not ln.startswith("@"):
                    if not int(ln.split("\t")[1]) & 0x900:
                        k += 1
                    if k % 2:
                        continue
                keep.append(ln)
            with open(out_sam, "w") as f:
                f.writelines(keep)
            return r
        monkeypatch.setattr(mod, "realign_clips", realign)


@pytest.mark.parametrize("workload", ["short100_30x.stream",
                                      "short100_30x.somatic"])
@pytest.mark.parametrize("fault", [_half_unaligned, _moved, _calls_moved,
                                   _unchanged, _half_clips_left_out,
                                   _half_records_left_out])
def test_bench_fault_makes_correct_false(tmp_path, monkeypatch, workload,
                                         fault):
    fault(monkeypatch)
    checks = _run(tmp_path, workload)
    assert not all(c["ok"] for c in checks.values()), checks
