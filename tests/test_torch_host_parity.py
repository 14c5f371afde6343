"""Every host module the port keeps its own copy of, against the JAX
package's module of the same name, on the same inputs: equal bytes and
equal arrays (tolerance: exact, everything here is integers or text).

Inputs come from the simulator at a small size (200 kb host + 40 kb virus
panel, 100 bp reads at 20x, seed 1) or from numpy with a seed.  Gzip
outputs are compared decompressed (the two packages may link different
deflate libraries)."""
import copy
import dataclasses
import gzip
import os

import numpy as np
import pytest
import torch

import seeksv_tpu.align.index as r_index
import seeksv_tpu.align.seed_batch as r_seed
import seeksv_tpu.align.sw as r_sw
import seeksv_tpu.cli as r_cli
import seeksv_tpu.io.bai as r_bai
import seeksv_tpu.io.bam as r_bam
import seeksv_tpu.io.fasta as r_fasta
import seeksv_tpu.parallel.spmd_pipeline as r_spmd
import seeksv_tpu.pipeline.driver as r_driver
import seeksv_tpu.pipeline.getclip as r_getclip
import seeksv_tpu.pipeline.getsv as r_getsv
import seeksv_tpu.pipeline.junctions as r_junctions
import seeksv_tpu.pipeline.somatic as r_somatic
import seeksv_tpu.pipeline.stream as r_stream
import seeksv_tpu.utils.simulate as r_sim
import seeksv_tpu_torch.align.index as p_index
import seeksv_tpu_torch.align.seed_batch as p_seed
import seeksv_tpu_torch.align.sw as p_sw
import seeksv_tpu_torch.cli as p_cli
import seeksv_tpu_torch.io.bai as p_bai
import seeksv_tpu_torch.io.bam as p_bam
import seeksv_tpu_torch.io.fasta as p_fasta
import seeksv_tpu_torch.io.native as p_native
import seeksv_tpu_torch.parallel.spmd_pipeline as p_spmd
import seeksv_tpu_torch.pipeline.getclip as p_getclip
import seeksv_tpu_torch.pipeline.getsv as p_getsv
import seeksv_tpu_torch.pipeline.junctions as p_junctions
import seeksv_tpu_torch.pipeline.somatic as p_somatic
import seeksv_tpu_torch.pipeline.stream as p_stream
import seeksv_tpu_torch.utils.simulate as p_sim
from seeksv_tpu_torch.utils.dataset import build_dataset

torch.set_num_threads(1)

RECORD_COLUMNS = ("flag", "tid", "pos", "mapq", "mtid", "mpos", "isize",
                  "l_qseq", "cig", "cig_off", "seq", "qual", "seq_off", "xc")


def _read(path, gz=False):
    with (gzip.open if gz else open)(path, "rb") as f:
        return f.read()


def _same_file(a, b, gz=False):
    got, want = _read(a, gz), _read(b, gz)
    assert got == want, f"{a} != {b}"
    return len(got)


def _same_records(a, b):
    assert a.n == b.n and a.n > 0
    assert list(a.ref_names) == list(b.ref_names)
    assert [int(x) for x in a.ref_lens] == [int(x) for x in b.ref_lens]
    for col in RECORD_COLUMNS:
        np.testing.assert_array_equal(getattr(a, col), getattr(b, col),
                                      err_msg=col)
    idx = list(range(0, a.n, max(1, a.n // 200)))
    assert [a.qnames[i] for i in idx] == [b.qnames[i] for i in idx]


def _simulate(sim, root, seed):
    """A 60 kb genome with one deletion and one inversion, 100 bp reads at
    15x, through package `sim`'s simulator."""
    rng = np.random.default_rng(seed)
    ref = {"chr17": sim.random_genome(rng, 60_000)}
    donor = sim.build_donor(ref, deletions=[(10_000, 11_000)],
                            inversions=[(30_000, 31_500)])
    os.makedirs(root, exist_ok=True)
    bam = os.path.join(root, "sim.bam")
    n = sim.simulate_reads(donor, ["chr17"], [60_000], bam, coverage=15,
                           read_len=100, seed=seed)
    sim.write_fasta(os.path.join(root, "ref.fa"), ref)
    return bam, n


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The tumor dataset, a normal sample of the same genome without
    events, and the JAX package's whole run on the tumor (its .clip.sam is
    the realignment both getsv's read)."""
    root = tmp_path_factory.mktemp("parity")
    paths = build_dataset(str(root / "ds"), 200_000, 20, 100, 1, 6, False,
                          virus_kb=40, virus_events=12, virus_div=0.04)
    ref = r_fasta.read_fasta(paths["ref_fa"])
    donor = r_sim.build_donor({k: np.frombuffer(v, np.uint8)
                               if isinstance(v, bytes) else v
                               for k, v in ref.items()})
    names = list(ref)
    normal = str(root / "normal.bam")
    r_sim.simulate_reads(donor, names, [len(ref[n]) for n in names], normal,
                         coverage=10, read_len=100, seed=7)
    r_driver.run_pipeline(paths["ref_fa"], paths["bam"], str(root / "jax"),
                          normal_bam=normal)
    return root, paths, normal


def test_simulate_same_seed_same_bam(tmp_path):
    r_path, r_n = _simulate(r_sim, str(tmp_path / "r"), 3)
    p_path, p_n = _simulate(p_sim, str(tmp_path / "p"), 3)
    assert r_n == p_n > 1000
    assert _same_file(p_path, r_path, gz=True) > 100_000
    _same_file(tmp_path / "p" / "ref.fa", tmp_path / "r" / "ref.fa")


def test_read_bam_and_build_index(world, tmp_path):
    _root, paths, _normal = world
    _same_records(p_bam.read_bam(paths["bam"]), r_bam.read_bam(paths["bam"]))
    r_out = r_bai.build_index(paths["bam"], str(tmp_path / "r.bai"))
    p_out = p_bai.build_index(paths["bam"], str(tmp_path / "p.bai"))
    assert _same_file(p_out, r_out) > 100


def test_native_against_python_decoders(world):
    """The port's own native library against the port's python decoder,
    whole-file and in slabs."""
    _root, paths, _normal = world
    assert p_native.available(), p_native.LOAD_ERROR
    assert os.sep + os.path.join("build", "seeksv_tpu_torch", "native") \
        + os.sep in p_native.library_path()
    want = p_bam.read_bam_python(paths["bam"])
    _same_records(p_native.read_bam_native(paths["bam"]), want)
    slabs = list(p_bam.read_bam_chunks(paths["bam"], 7_001))
    assert len(slabs) > 2 and sum(s.n for s in slabs) == want.n
    np.testing.assert_array_equal(np.concatenate([s.pos for s in slabs]),
                                  want.pos)
    np.testing.assert_array_equal(np.concatenate([s.seq for s in slabs]),
                                  want.seq)


def test_kmer_index_and_batch_candidates(world):
    _root, paths, _normal = world
    r_idx = r_index.KmerIndex.build(r_fasta.read_fasta(paths["ref_fa"]), k=19)
    p_idx = p_index.KmerIndex.build(p_fasta.read_fasta(paths["ref_fa"]), k=19)
    for name in ("ref", "chrom_starts", "keys", "positions", "prefix_tab"):
        a, b = getattr(p_idx, name), getattr(r_idx, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert p_idx.chrom_names == r_idx.chrom_names
    np.testing.assert_array_equal(p_index.ENCODE, r_index.ENCODE)
    rng = np.random.default_rng(4)
    G = len(r_idx.ref)
    reads = []
    for _ in range(200):
        s = int(rng.integers(0, G - 100))
        codes = np.array(r_idx.ref[s:s + 100], np.uint8)
        flip = rng.random(100) < 0.03
        codes[flip] = rng.integers(0, 4, int(flip.sum()))
        reads.append(codes)
    got = p_seed.batch_candidates(p_idx, reads)
    want = r_seed.batch_candidates(r_idx, reads)
    assert got == want
    assert sum(len(v) for v in got.values()) >= 200


def test_extend_batch_np():
    rng = np.random.default_rng(5)
    B, LQ, LT = 64, 96, 128
    t = rng.integers(0, 4, (B, LT)).astype(np.int8)
    q = t[:, :LQ].copy()
    flip = rng.random(q.shape) < 0.05
    q[flip] = rng.integers(0, 4, int(flip.sum()))
    q[::7] = rng.integers(0, 4, (len(q[::7]), LQ))      # z-drops
    qlen = rng.integers(0, LQ + 1, B).astype(np.int32)
    tlen = np.minimum(qlen + 30, LT).astype(np.int32)
    tlen[:4] = 0
    h0 = rng.integers(19, 60, B).astype(np.int32)
    got = p_sw.extend_batch_np(q, qlen, t, tlen, h0)
    want = r_sw.extend_batch_np(q, qlen, t, tlen, h0)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for fn in ("extend_score", "global_align"):
        a = getattr(p_sw, fn)(q[1, :qlen[1]].view(np.uint8),
                              t[1, :tlen[1]].view(np.uint8),
                              *((int(h0[1]),) if fn == "extend_score" else ()))
        b = getattr(r_sw, fn)(q[1, :qlen[1]].view(np.uint8),
                              t[1, :tlen[1]].view(np.uint8),
                              *((int(h0[1]),) if fn == "extend_score" else ()))
        assert (dataclasses.astuple(a) if dataclasses.is_dataclass(a)
                else a) == (dataclasses.astuple(b)
                            if dataclasses.is_dataclass(b) else b), fn


def test_getclip(world, tmp_path):
    root, paths, _normal = world
    p_getclip.getclip(paths["bam"], str(tmp_path / "p"))
    assert _same_file(tmp_path / "p.clip.gz", root / "jax.clip.gz",
                      gz=True) > 1000
    for suffix in ("clip.fq.gz", "unmapped_1.fq.gz", "unmapped_2.fq.gz"):
        _same_file(tmp_path / f"p.{suffix}", root / f"jax.{suffix}", gz=True)


def test_getsv(world, tmp_path):
    root, paths, _normal = world
    args = (str(root / "jax.clip.sam"), paths["bam"],
            str(root / "jax.clip.gz"))
    with open(tmp_path / "r.filtered", "w") as rf, \
            open(tmp_path / "p.filtered", "w") as pf:
        r_getsv.getsv(*args, str(tmp_path / "r.sv"), str(tmp_path / "r.fq"),
                      filtered_out=rf, rescue=True)
        p_getsv.getsv(*args, str(tmp_path / "p.sv"), str(tmp_path / "p.fq"),
                      filtered_out=pf, rescue=True)
    assert _same_file(tmp_path / "p.sv", tmp_path / "r.sv") > 500
    _same_file(tmp_path / "p.sv", root / "jax.sv")
    _same_file(tmp_path / "p.fq", tmp_path / "r.fq")
    _same_file(tmp_path / "p.filtered", tmp_path / "r.filtered")


def test_somatic_and_filter(world, tmp_path):
    root, _paths, normal = world
    args = (normal, str(root / "jax.normal.clip.gz"), str(root / "jax.sv"))
    r_somatic.somatic(*args, str(tmp_path / "r.temp.sv"))
    p_somatic.somatic(*args, str(tmp_path / "p.temp.sv"))
    assert _same_file(tmp_path / "p.temp.sv", tmp_path / "r.temp.sv") > 500
    r_somatic.somatic_filter(str(tmp_path / "r.temp.sv"),
                             str(tmp_path / "r.somatic.sv"))
    p_somatic.somatic_filter(str(tmp_path / "p.temp.sv"),
                             str(tmp_path / "p.somatic.sv"))
    _same_file(tmp_path / "p.somatic.sv", tmp_path / "r.somatic.sv")
    _same_file(tmp_path / "p.somatic.sv", root / "jax.somatic.sv")


@pytest.mark.parametrize("chunk", [977, 50_000])
def test_scan_bam_getclip_stream_and_stats(world, tmp_path, chunk):
    root, paths, _normal = world
    out = {}
    for tag, stream, getclip in (("r", r_stream, r_getclip),
                                 ("p", p_stream, p_getclip)):
        gs = getclip.GetclipStream(str(tmp_path / tag))
        stats = stream.StreamStats(20, 5_000_000)
        stream.scan_bam(paths["bam"], chunk, [gs, stats])
        gs.close()
        out[tag] = stats
    for suffix in ("clip.gz", "clip.fq.gz"):
        _same_file(tmp_path / f"p.{suffix}", tmp_path / f"r.{suffix}", gz=True)
        _same_file(tmp_path / f"p.{suffix}", root / f"jax.{suffix}", gz=True)
    assert out["p"].n == out["r"].n > 0
    assert out["p"].insert_size() == out["r"].insert_size()
    r_cov, p_cov = out["r"].coverage(), out["p"].coverage()
    assert set(r_cov) == set(p_cov)
    for tid in r_cov:
        np.testing.assert_array_equal(p_cov[tid], r_cov[tid])
    r_light, p_light = out["r"].light(), out["p"].light()
    for col in ("pos", "mpos", "mtid", "l_qseq", "flag", "mapq", "isize",
                "tid", "end", "hard"):
        np.testing.assert_array_equal(getattr(p_light, col),
                                      getattr(r_light, col), err_msg=col)


def _random_jmap(junctions, rng, n_clusters=40, search_length=50):
    """tests/test_spmd_pipeline.py:53-89 with package `junctions`'
    classes: merge-adjacent clusters, microhomology-shifted views of one
    event plus decoys."""
    jmap = junctions.JunctionMap()
    chrs = ["chr1", "chr2"]
    strands = [("+", "+"), ("+", "-"), ("-", "+")]
    base = 1000
    for _ in range(n_clusters):
        uc, dc = chrs[rng.integers(2)], chrs[rng.integers(2)]
        us, ds = strands[rng.integers(3)]
        base += int(rng.integers(0, 3)) * int(rng.integers(20, 200))
        up0 = base
        dn0 = int(rng.integers(500, 5000))
        useq = bytes(rng.integers(65, 69, 40).astype(np.uint8))
        dseq = bytes(rng.integers(65, 69, 40).astype(np.uint8))
        for _e in range(int(rng.integers(1, 4))):
            mh = int(rng.integers(0, min(search_length + 10, 39)))
            if us == "+":
                u = useq + dseq[:mh]
                d = dseq[mh:]
            else:
                u = useq[mh:] if mh < len(useq) else b"A"
                d = useq[len(useq) - mh:] + dseq if mh else dseq
            if rng.random() < 0.2:
                u = bytes(rng.integers(65, 69, len(u)).astype(np.uint8))
            up = junctions.SeqInfo(
                u, [(len(u), "M")],
                int(rng.integers(0, 2)) * int(rng.integers(0, 5)), 0,
                int(rng.integers(0, 6)), int(rng.integers(0, 3)))
            down = junctions.SeqInfo(d, [(len(d), "M")], 0, 0,
                                     int(rng.integers(0, 6)),
                                     int(rng.integers(0, 3)))
            pre_mh = -1 if rng.random() < 0.6 else int(rng.integers(0, 10))
            jmap.insert((uc, up0 + mh, us, dc, dn0 + mh, ds),
                        junctions.OtherInfo(up, down, pre_mh, 0))
    return jmap


def _items(jmap):
    return [(j, dataclasses.asdict(o)) for j, o in jmap.items]


@pytest.mark.parametrize("seed", range(4))
def test_merge_junction_sharded_and_event_codec(seed):
    r_map = _random_jmap(r_junctions, np.random.default_rng(seed))
    p_map = _random_jmap(p_junctions, np.random.default_rng(seed))
    assert _items(p_map) == _items(r_map)
    # the event codec on the unmerged table
    names = {"chr1": 0, "chr2": 1}
    id2name = ["chr1", "chr2"]
    E = len(r_map.items) + 3
    r_enc = r_spmd._encode_events(
        [(j, o.up, o.down) for j, o in r_map.items], names, E, 96, 2)
    p_enc = p_spmd._encode_events(
        [(j, o.up, o.down) for j, o in p_map.items], names, E, 96, 2)
    for f in dataclasses.fields(r_enc):
        np.testing.assert_array_equal(getattr(p_enc, f.name),
                                      getattr(r_enc, f.name), err_msg=f.name)
    for i in range(len(r_map.items)):
        rj, ru, rd = r_spmd._decode_event(r_enc, i, id2name)
        pj, pu, pd = p_spmd._decode_event(p_enc, i, id2name)
        assert (pj, dataclasses.asdict(pu), dataclasses.asdict(pd)) == \
            (rj, dataclasses.asdict(ru), dataclasses.asdict(rd))
        assert pj == p_map.items[i][0]
        assert pu == p_map.items[i][1].up and pd == p_map.items[i][1].down
    # the partitioned merge against both sequential merges
    p_seq = copy.deepcopy(p_map)
    p_getsv.merge_junction(p_seq, 50)
    assert r_spmd.merge_junction_sharded(r_map, 50) == \
        p_spmd.merge_junction_sharded(p_map, 50) >= 1
    assert _items(p_map) == _items(r_map) == _items(p_seq)
    assert len(p_map.items) < E - 3


def _cli_cases(root, paths, normal, out):
    """argv of each host-only subcommand (the outputs land under `out`)
    and the files it writes, gz or not."""
    sv = str(root / "jax.sv")
    return {
        "getclip": (["getclip", "-o", f"{out}/c", "-q", "25", paths["bam"]],
                    [("c.clip.gz", True), ("c.clip.fq.gz", True)]),
        "getsv": (["getsv", "-l", "40", "-e", "1", "--rescue",
                   str(root / "jax.clip.sam"), paths["bam"],
                   str(root / "jax.clip.gz"), f"{out}/g.sv", f"{out}/g.fq"],
                  [("g.sv", False), ("g.fq", False)]),
        "somatic": (["somatic", "-l", "20", normal,
                     str(root / "jax.normal.clip.gz"), sv, f"{out}/s.sv"],
                    [("s.sv", False)]),
        "somatic-filter": (["somatic-filter",
                            str(root / "jax.somatic.temp.sv"), f"{out}/f.sv"],
                           [("f.sv", False)]),
        "vcf": (["vcf", sv, f"{out}/v.vcf"], [("v.vcf", False)]),
        "index": (["index", f"{out}/i.bam"], [("i.bam.bai", False)]),
    }


@pytest.mark.parametrize("cmd", ["getclip", "getsv", "somatic",
                                 "somatic-filter", "vcf", "index"])
def test_cli_subcommand_writes_the_reference_bytes(world, tmp_path, cmd):
    """`python -m seeksv_tpu_torch <cmd>` against `python -m seeksv_tpu
    <cmd>` with the same flags."""
    root, paths, normal = world
    sizes = {}
    for tag, cli in (("r", r_cli), ("p", p_cli)):
        out = tmp_path / tag
        out.mkdir()
        if cmd == "index":
            os.symlink(paths["bam"], out / "i.bam")
        argv, files = _cli_cases(root, paths, normal, str(out))[cmd]
        assert cli.main(argv) == 0
        sizes[tag] = files
    for name, gz in sizes["p"]:
        n = _same_file(tmp_path / "p" / name, tmp_path / "r" / name, gz=gz)
        assert n > 0 or name == "g.fq", name
