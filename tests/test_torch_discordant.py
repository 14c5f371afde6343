"""The port's discordant-pair count (K6's plain version and the wrapper on
the CPU) against the JAX package's discordant_count_batch on synthetic
windows (all three cases, the tandem-duplication branch with numerators
of both signs, window_cap below hi - lo, empty rows), and the port's
mesh forms on a one-rank gloo mesh against the host counter."""
import numpy as np
import pytest
import torch
import torch.distributed as dist

from seeksv_tpu.ops.jax_kernels import discordant_count_batch as jax_count
from seeksv_tpu_torch.ops import discordant as dc
from torch_inputs import discordant_args as _args
from torch_inputs import discordant_edge_cases, discordant_packed
from torch_inputs import discordant_windows as _synthetic

# several test workers share few cores: one intra-op thread each
torch.set_num_threads(1)


@pytest.mark.parametrize("window_cap", [64, 512])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_matches_jax(seed, window_cap):
    rec, jun = _synthetic(seed)
    ra, ja = _args(rec, jun)
    want = np.asarray(jax_count(*ra, *ja, window_cap=window_cap))
    got = dc.discordant_count_plain(*map(torch.from_numpy, ra),
                                    *map(torch.from_numpy, ja),
                                    window_cap=window_cap)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    # the data reach every case, the tandem branch and capped windows
    assert all(want[jun["case_code"] == c].sum() > 0 for c in range(3))
    assert ((jun["hi"] - jun["lo"]) > window_cap).any() == (window_cap == 64)
    assert (want[jun["hi"] <= jun["lo"]] == 0).all()


def test_tandem_ceil_with_numerators_of_both_signs():
    """One +/+ tandem junction (period 3) and records whose
    min_ins - ins is -7, -6, 0, 5, 6 and 7: the ceiling must floor-divide
    as JAX's // does, not truncate as C does."""
    up, dn, mini, maxi = 1000, 998, 300, 320        # period 3
    ins_want = mini - np.array([-7, -6, 0, 5, 6, 7])
    R = len(ins_want)
    lq = np.full(R, 100, np.int32)
    pos = np.full(R, 850, np.int64)
    # ins0 = up - p + mp + l - dn + 1  ->  mp from the wanted ins
    mpos = (ins_want - (up - pos + lq - dn + 1)).astype(np.int64)
    rec = {"pos": pos, "end": pos + lq, "lq": lq, "mpos": mpos,
           "mtid": np.zeros(R, np.int32), "fwd": np.ones(R, bool),
           "mfwd": np.zeros(R, bool), "base_ok": np.ones(R, bool)}
    one = lambda v, t=np.int64: np.asarray([v], t)
    jun = {"lo": one(0), "hi": one(R), "beg": one(0), "up_pos": one(up),
           "down_pos": one(dn), "down_tid": one(0, np.int32),
           "same_tid": one(True, bool), "case_code": one(0, np.int32),
           "min_ins": one(mini), "max_ins": one(maxi)}
    ra, ja = _args(rec, jun)
    want = int(np.asarray(jax_count(*ra, *ja, window_cap=64))[0])
    got = int(dc.discordant_count_plain(*map(torch.from_numpy, ra),
                                        *map(torch.from_numpy, ja),
                                        window_cap=64)[0])
    # k0 = max(0, ceil((mini - ins) / 3)): ins + 3 k0 <= 320 for all six
    assert got == want == 6
    jun["max_ins"] = one(mini + 1)
    ra, ja = _args(rec, jun)
    want = int(np.asarray(jax_count(*ra, *ja, window_cap=64))[0])
    got = int(dc.discordant_count_plain(*map(torch.from_numpy, ra),
                                        *map(torch.from_numpy, ja),
                                        window_cap=64)[0])
    assert got == want


def test_wrapper_on_cpu_runs_plain():
    rec, jun = _synthetic(3)
    ra, ja = (list(map(torch.from_numpy, a)) for a in _args(rec, jun))
    packed = discordant_packed(rec, jun)
    n0 = dc.PLAIN_CALLS["discordant_count"]
    got = dc.discordant_count_batch(*packed, window_cap=256)
    assert dc.PLAIN_CALLS["discordant_count"] == n0 + 1
    assert dc.LAUNCHES["discordant_count"] == 0
    assert torch.equal(got, dc.discordant_count_plain(*ra, *ja,
                                                      window_cap=256))
    with pytest.raises(TypeError):
        dc.discordant_count_batch(packed[0].int(), *packed[1:],
                                  window_cap=256)
    with pytest.raises(ValueError):
        dc.discordant_count_batch(*packed[:8], packed[8][:3].contiguous(),
                                  window_cap=256)


def test_pack_junctions_round_trip():
    """pack_junctions takes min_ins and max_ins as columns or scalars,
    writes every field at full width into its row of the [8, J] tensor,
    and unpack_junctions gives the columns back (a case code outside
    0..2 as -1)."""
    rec, jun = _synthetic(5)
    ja = _args(rec, jun)[1]
    ja[5][:3] = (np.iinfo(np.int32).min, -1, np.iinfo(np.int32).max)
    ja[7][:4] = (-5, 3, 7, 2)
    ja[8][:], ja[9][:] = 1500, 4200   # the pipeline's: one insert model
    rows = dc.pack_junctions(*ja)
    assert rows.dtype == np.int64 and rows.shape == (8, len(ja[0]))
    assert np.array_equal(rows, dc.pack_junctions(*ja[:8], 1500, 4200))
    back = dc.unpack_junctions(torch.from_numpy(rows))
    code = np.where((ja[7] >= 0) & (ja[7] <= 2), ja[7], -1)
    for (name, dtype), x, want in zip(dc.JUN_COLS, back,
                                      (*ja[:7], code, *ja[8:])):
        assert x.dtype == dtype, name
        assert np.array_equal(x.numpy(), want), name


EDGES = discordant_edge_cases()


@pytest.mark.parametrize("case", range(len(EDGES)),
                         ids=[c[0] for c in EDGES])
def test_packed_layout_matches_jax(case):
    """The packed junctions (pack_junctions), unpacked to columns, count
    what the plain version counts on the original columns and, exactly,
    what the JAX package counts there, on every edge case.  (A case code
    outside 0..2 counts nothing in the port; the JAX program's
    take_along_axis fills such rows, so those rows are held against the
    plain version alone.)"""
    _name, rec, jun, window_cap = EDGES[case]
    ra, ja = _args(rec, jun)
    want = dc.discordant_count_plain(*map(torch.from_numpy, ra),
                                     *map(torch.from_numpy, ja),
                                     window_cap=window_cap).numpy()
    packed = discordant_packed(rec, jun)
    juns = dc.unpack_junctions(packed[8])
    got = dc.discordant_count_batch(*packed, window_cap=window_cap)
    assert np.array_equal(got.numpy(), want)
    in_range = (ja[7] >= 0) & (ja[7] <= 2)
    assert (want[~in_range] == 0).all()
    if len(ra[0]) and "int32" not in _name:
        # the JAX gather needs a record; its sums are int32
        jx = np.asarray(jax_count(*ra, *ja, window_cap=window_cap))
        assert np.array_equal(jx[in_range], want[in_range])
        ux = np.asarray(jax_count(*ra, *(x.numpy() for x in juns),
                                  window_cap=window_cap))
        assert np.array_equal(ux[in_range], want[in_range])
    elif not len(ra[0]):
        assert (want == 0).all()


def test_distinct_records_counts_the_windows_union():
    """distinct_records, the bound's count of the records a call needs,
    against a set of every record index the windows visit (clamped)."""
    rec, jun = _synthetic(4)
    packed = discordant_packed(rec, jun)[8]
    R, cap = len(rec["pos"]), 128
    seen = set()
    for j in range(len(jun["lo"])):
        lo, hi = int(jun["lo"][j]), int(jun["hi"][j])
        seen.update(min(max(lo + w, 0), R - 1)
                    for w in range(min(hi - lo, cap)))
    assert dc.distinct_records(packed.numpy(), R, cap) == len(seen) > 0
    assert dc.distinct_records(packed.numpy()[:, :0], R, cap) == 0


@pytest.fixture(scope="module")
def mesh1():
    from seeksv_tpu_torch.parallel.mesh import make_mesh
    created = not dist.is_initialized()
    mesh = make_mesh("cpu")
    yield mesh
    if created:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def junctions(tmp_path_factory):
    """The merged junction map of the small simulated virus dataset (the
    JAX package's host run), plus junctions of every strand pair, on an
    unknown chromosome and past the chromosome's end."""
    from seeksv_tpu.io.bam import read_bam
    from seeksv_tpu.pipeline.driver import run_pipeline
    from seeksv_tpu.pipeline.getsv import (DiscordantCounter, JunctionMap,
                                           calculate_insert_size,
                                           input_soft_info, merge_junction)
    from seeksv_tpu_torch.utils.dataset import build_dataset
    root = tmp_path_factory.mktemp("dc")
    p = build_dataset(str(root / "ds"), 300_000, 10, 1000, 1, 2, False,
                      virus_kb=60, virus_events=20)
    prefix = str(root / "host")
    run_pipeline(p["ref_fa"], p["bam"], prefix)
    recs = read_bam(p["bam"])
    jmap = JunctionMap()
    input_soft_info(f"{prefix}.clip.gz", f"{prefix}.clip.sam", jmap, [])
    merge_junction(jmap, 50)
    mean, dev = calculate_insert_size(recs, 20, 5_000_000)
    counter = DiscordantCounter(recs, 20, mean, dev, 4)
    extra = [(c1, pos, s1, c2, pos - d, s2)
             for c1, c2 in (("chr17", "chr17"), ("chr17", "virus"))
             for pos in (5_000, 150_000, 299_990)
             for d in (-400, 300)
             for s1 in "+-" for s2 in "+-"]
    extra += [("chrX", 700, "+", "chr17", 600, "+"),
              ("chr17", 700, "+", "chrX", 600, "+")]
    return counter, [j for j, _ in jmap.items] + extra


def test_mesh_discordant_forms_equal_host_counter(mesh1, junctions):
    from seeksv_tpu_torch.parallel.spmd_pipeline import (
        spmd_discordant_counts, spmd_discordant_counts_sharded)
    counter, js = junctions
    host = np.asarray([counter.count(j) for j in js])
    assert host.sum() > 0
    n0 = dc.PLAIN_CALLS["discordant_count"]
    repl = spmd_discordant_counts(mesh1, counter, js)
    shrd = spmd_discordant_counts_sharded(mesh1, counter, js)
    assert dc.PLAIN_CALLS["discordant_count"] == n0 + 2
    assert np.array_equal(repl, host)
    assert np.array_equal(shrd, host)
    assert len(spmd_discordant_counts_sharded(mesh1, counter, [])) == 0
