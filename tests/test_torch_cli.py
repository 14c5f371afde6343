"""The port's remaining subcommands (view, cluster, simulate, compare, aln)
and svcompare against the JAX package's on the same arguments: equal
stdout, stderr and files (exact: text and integers).

Inputs: a small simulated tumor dataset (200 kb host + 40 kb virus panel,
100 bp reads at 20x, seed 1) and the JAX package's run on it; compare's
control and target files come from tests/golden/cancer.somatic.temp.sv,
that run's .sv and the simulator's truth."""
import json
import os
import shutil

import numpy as np
import pytest
import torch

import seeksv_tpu.cli as r_cli
import seeksv_tpu.pipeline.driver as r_driver
import seeksv_tpu.pipeline.svcompare as r_cmp
import seeksv_tpu_torch.cli as p_cli
import seeksv_tpu_torch.pipeline.svcompare as p_cmp
from seeksv_tpu_torch.utils.dataset import build_dataset

# several test workers share few cores: one intra-op thread each
torch.set_num_threads(1)

GOLDEN_SV = os.path.join(os.path.dirname(__file__), "golden",
                         "cancer.somatic.temp.sv")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The dataset, its .bai, and the JAX package's run (jax.sv)."""
    root = tmp_path_factory.mktemp("cli")
    paths = build_dataset(str(root / "ds"), 200_000, 20, 100, 1, 6, False,
                          virus_kb=40, virus_events=12, virus_div=0.04)
    r_driver.run_pipeline(paths["ref_fa"], paths["bam"], str(root / "jax"))
    return root, paths


def _run_both(argv_of, tmp_path, capfd):
    """Run each CLI with argv_of(out_dir); (stdout, stderr, out_dir) each."""
    got = {}
    for tag, cli in (("r", r_cli), ("p", p_cli)):
        out = tmp_path / tag
        out.mkdir()
        capfd.readouterr()
        assert cli.main(argv_of(str(out))) == 0
        o, e = capfd.readouterr()
        got[tag] = (o, e.replace(str(out), "OUT"), out)
    return got


def test_view_prints_the_reference_records(world, tmp_path, capfd):
    _root, paths = world
    got = _run_both(lambda out: ["view", paths["bam"], "chr17:5000-9000"],
                    tmp_path, capfd)
    assert got["p"][:2] == got["r"][:2]
    assert got["p"][0].count("\n") > 50


def test_view_of_a_region_without_records(world, tmp_path, capfd):
    _root, paths = world
    got = _run_both(lambda out: ["view", paths["bam"], "virus:39990-39999"],
                    tmp_path, capfd)
    assert got["p"][:2] == got["r"][:2]


@pytest.mark.parametrize("flags", [[], ["-n", "500", "-q", "30"]])
def test_cluster_prints_the_reference_insert_model(world, tmp_path, capfd,
                                                    flags):
    _root, paths = world
    got = _run_both(lambda out: ["cluster", *flags, paths["bam"]], tmp_path,
                    capfd)
    assert got["p"][:2] == got["r"][:2]
    assert "Mean insert size" in got["p"][1]


def test_simulate_writes_the_reference_files(tmp_path, capfd):
    got = _run_both(lambda out: ["simulate", "-G", "60000", "-c", "4",
                                 "--dels", "3", "--invs", "2", "--seed", "5",
                                 "-o", f"{out}/sim"], tmp_path, capfd)
    assert got["p"][:2] == got["r"][:2]
    for name in ("sim.ref.fa", "sim.truth.txt", "sim.bam"):
        a = (got["p"][2] / name).read_bytes()
        b = (got["r"][2] / name).read_bytes()
        assert a == b and len(a) > 0, name


def _crest(rows):
    """The .sv rows as CREST lines (up, strand, count, down, strand,
    count, type), one of each inverted pair written down-first so that
    read_result's swap runs."""
    out = []
    for i, f in enumerate(rows):
        if i % 2 and f[2] != f[6]:
            out.append("\t".join([f[4], f[5], f[2], f[7], f[0], f[1], f[6],
                                  f[3], f[10]]))
        else:
            out.append("\t".join([*f[:8], f[10]]))
    return "\n".join(out) + "\n"


@pytest.fixture(scope="module")
def compare_inputs(world, tmp_path_factory):
    """Control and target files of every mode: the golden .sv, the JAX
    run's .sv and a copy of it with breakends moved by 0-80 bp, rows
    duplicated and dropped; the same in CREST form; the simulator's DEL
    and INV truth as svcompare's sv_info and cnv files; an N-region
    file."""
    root, paths = world
    d = tmp_path_factory.mktemp("cmp")
    rows = [ln.rstrip("\n").split("\t") for ln in open(root / "jax.sv")
            if not ln.startswith("@")]
    assert len(rows) > 10
    rng = np.random.default_rng(3)
    moved = []
    for f in rows:
        if rng.random() < 0.15:
            continue
        g = list(f)
        g[1] = str(int(g[1]) + int(rng.integers(-80, 81)))
        g[5] = str(int(g[5]) + int(rng.integers(-40, 41)))
        moved.append(g)
        if rng.random() < 0.1:
            moved.append(list(f))
    head = open(root / "jax.sv").readline()
    (d / "target.sv").write_text(head + "".join("\t".join(g) + "\n"
                                                for g in moved))
    (d / "control.crest").write_text(_crest(rows))
    (d / "target.crest").write_text(_crest(moved))
    truth = json.load(open(paths["truth"]))
    inv = [t for t in truth if t["type"] == "INV"]
    dels = [t for t in truth if t["type"] == "DEL"]
    assert inv and dels
    (d / "truth.sv_info").write_text("".join(
        f"inv\t{t['up']}\t{t['down'] - t['up'] + 1}\ta\tp\n" for t in inv))
    (d / "truth.cnv").write_text("".join(
        f"ldel\t{t['up'] + 1}\t{t['down'] - 1}\ta\tp\n" for t in dels)
        + "lins\t150000\t150400\ta\tp\tx:120000\n")
    (d / "n.bed").write_text(f"chr17\t{inv[0]['up'] - 5}\t{inv[0]['up'] + 5}"
                             "\n")
    return root, d


def _cases(root, d):
    sv, golden = str(root / "jax.sv"), GOLDEN_SV
    return {
        "seeksv golden": ["seeksv", golden, golden],
        "seeksv moved": ["seeksv", "-l", "60", sv, str(d / "target.sv")],
        "seeksv crest target": ["seeksv", "-t", sv, str(d / "target.crest")],
        "crest": ["crest", str(d / "control.crest"), str(d / "target.sv")],
        "simu": ["simu", "-c", "chr17", "--cnv", str(d / "truth.cnv"),
                 str(d / "truth.sv_info"), sv],
        "simu n-region": ["simu", "-n", str(d / "n.bed"), "-l", "30",
                          "--cnv", str(d / "truth.cnv"),
                          str(d / "truth.sv_info"), str(d / "target.sv")],
    }


@pytest.mark.parametrize("case", ["seeksv golden", "seeksv moved",
                                  "seeksv crest target", "crest", "simu",
                                  "simu n-region"])
def test_compare_writes_the_reference_bytes(compare_inputs, tmp_path,
                                             capfd, case):
    root, d = compare_inputs
    mode, *rest = _cases(root, d)[case]
    got = _run_both(lambda out: ["compare", mode, *rest, f"{out}/cmp.txt"],
                    tmp_path, capfd)
    a = (got["p"][2] / "cmp.txt").read_bytes()
    assert a == (got["r"][2] / "cmp.txt").read_bytes()
    assert got["p"][:2] == got["r"][:2]
    tags = {ln.split(b"\t")[0] for ln in a.splitlines()}
    assert b"target_share" in tags or case == "simu n-region"
    if case in ("seeksv moved", "simu"):
        assert {b"control_only", b"target_only"} <= tags


def test_svcompare_functions_equal_the_reference(compare_inputs, tmp_path):
    """svcompare.compare called directly (keyword arguments as the CLI
    passes them) in each mode."""
    root, d = compare_inputs
    for case, (mode, *rest) in _cases(root, d).items():
        kw = {"fuzz": 50, "n_region_file": None, "target_is_crest": False,
              "chrom": "chr17", "cnv_file": None}
        pos = []
        it = iter(rest)
        for x in it:
            if x == "-l":
                kw["fuzz"] = int(next(it))
            elif x == "-n":
                kw["n_region_file"] = next(it)
            elif x == "-t":
                kw["target_is_crest"] = True
            elif x == "-c":
                kw["chrom"] = next(it)
            elif x == "--cnv":
                kw["cnv_file"] = next(it)
            else:
                pos.append(x)
        out = {}
        for tag, mod in (("r", r_cmp), ("p", p_cmp)):
            path = tmp_path / f"{tag}.{case.replace(' ', '_')}.txt"
            mod.compare(mode, *pos, str(path), **kw)
            out[tag] = path.read_bytes()
        assert out["p"] == out["r"], case


def test_aln_single_end_through_the_cli(world, tmp_path, capfd):
    """`aln` on the JAX run's clip fastq: the host aligner's SAM."""
    root, paths = world
    got = _run_both(lambda out: ["aln", paths["ref_fa"],
                                 str(root / "jax.clip.fq.gz"),
                                 f"{out}/a.sam"], tmp_path, capfd)
    a = (got["p"][2] / "a.sam").read_bytes()
    assert a == (got["r"][2] / "a.sam").read_bytes()
    assert a.count(b"\n") > 20


def test_aln_paired_through_the_cli(world, tmp_path, capfd):
    """`aln -2 --device cpu` on the JAX run's unmapped_{1,2}.fq.gz (the
    virus-mode realignment the reference leaves to bwa): the reference's
    SAM, byte for byte."""
    root, paths = world
    fq1, fq2 = (str(root / f"jax.unmapped_{i}.fq.gz") for i in (1, 2))
    outs = {}
    for tag, cli, extra in (("r", r_cli, []),
                            ("p", p_cli, ["--device", "cpu"])):
        out = tmp_path / tag
        out.mkdir()
        assert cli.main(["aln", "-2", fq2, *extra, paths["ref_fa"], fq1,
                         str(out / "pe.sam")]) == 0
        outs[tag] = (out / "pe.sam").read_bytes()
    assert outs["p"] == outs["r"]
    assert outs["p"].count(b"\n") > 10
    shutil.rmtree(tmp_path / "r")
