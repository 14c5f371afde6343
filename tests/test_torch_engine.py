"""TorchBatchAligner (the port's engine) against the JAX package's
BatchAligner: the device branch on the CPU (the kernels' plain
versions) must give the alignments of the native host path and of the
JAX device-finalize path, field for field."""
import numpy as np
import pytest
import torch

from seeksv_tpu.align.engine import BatchAligner
from seeksv_tpu_torch.align.engine import TorchBatchAligner, packed_reference
from seeksv_tpu_torch.ops import extend as ext
from seeksv_tpu_torch.ops import global_device as tgd

# several test workers share few cores: one intra-op thread each keeps
# the plain versions' many small ops from oversubscribing them
torch.set_num_threads(1)

CODE2B = np.frombuffer(b"ACGT", np.uint8)


@pytest.fixture(scope="module")
def genome_fa(tmp_path_factory):
    """Two chromosomes (odd total length) from a seed."""
    rng = np.random.default_rng(5)
    chroms = {"chrX": rng.integers(0, 4, 120_001).astype(np.uint8),
              "chrV": rng.integers(0, 4, 40_000).astype(np.uint8)}
    fa = tmp_path_factory.mktemp("ref") / "g.fa"
    with open(fa, "w") as f:
        for name, g in chroms.items():
            f.write(f">{name}\n{CODE2B[g].tobytes().decode()}\n")
    return str(fa), chroms


def _reads(chroms, seed=6):
    """Long mutated fragments (the device finalize's regime), a few with
    a 20 bp deletion, chimeras across the two chromosomes, short clips,
    and reads starting at a chromosome's first base (left window of
    length 0)."""
    rng = np.random.default_rng(seed)
    gx, gv = chroms["chrX"], chroms["chrV"]
    reads = []
    for i in range(10):
        p = int(rng.integers(0, len(gx) - 1300))
        ln = int(rng.integers(600, 1200))
        q = gx[p:p + ln].copy()
        pos = rng.integers(0, len(q), int(ln * 0.02))
        q[pos] = (q[pos] + 1 + rng.integers(0, 3, len(pos))) % 4
        if i % 3 == 0:
            cut = int(rng.integers(100, ln - 100))
            q = np.concatenate([q[:cut], q[cut + 20:]])
        if i % 4 == 1:
            q = 3 - q[::-1]                      # reverse strand
        reads.append(q)
    for _ in range(3):
        a = int(rng.integers(0, len(gx) - 500))
        b = int(rng.integers(0, len(gv) - 500))
        reads.append(np.concatenate([gx[a:a + 400], gv[b:b + 350]]))
    for _ in range(4):
        p = int(rng.integers(0, len(gx) - 100))
        reads.append(gx[p:p + int(rng.integers(30, 90))].copy())
    reads.append(gx[:700].copy())
    reads.append(gv[:300].copy())
    return [CODE2B[r].tobytes() for r in reads]


def _key(a):
    if not a.mapped:
        return ("unmapped",)
    supp = tuple((s.tid, s.pos, s.strand, tuple(s.cigar), s.mapq, s.nm)
                 for s in (a.supp or []))
    return (a.tid, a.pos, a.strand, tuple(a.cigar), a.score, a.sub,
            a.sub_n, a.mapq, a.nm, a.qb, a.qe, supp)


def test_packed_reference_matches_jax_upload(genome_fa):
    fa, _ = genome_fa
    jal = BatchAligner.from_fasta(fa, cache=False)
    want, n_want = jal._device_ref_packed()
    got, n_got = packed_reference(jal.idx, "cpu")
    assert n_got == n_want == len(jal.idx.ref)
    assert len(jal.idx.ref) % 2 == 1
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert packed_reference(jal.idx, "cpu")[0] is got        # cached


def test_device_branch_matches_host_and_jax_finalize(genome_fa, monkeypatch):
    fa, chroms = genome_fa
    reads = _reads(chroms)
    host = BatchAligner.from_fasta(fa, cache=False).batch_align(
        reads, force_host=True)
    before = {**{f"x{k}": v for k, v in ext.PLAIN_CALLS.items()},
              **{f"g{k}": v for k, v in tgd.PLAIN_CALLS.items()}}
    tal = TorchBatchAligner.from_fasta(fa, cache=False, device="cpu")
    got = tal.batch_align(reads)
    assert tal.last_dispatch["chose_device"]
    assert tal.timings["device_extend_s"] > 0
    assert tal.timings["device_finalize_s"] > 0
    assert ext.PLAIN_CALLS["extend_left"] > before["xextend_left"]
    assert ext.PLAIN_CALLS["extend_right"] > before["xextend_right"]
    assert tgd.PLAIN_CALLS["banded_dir"] > before["gbanded_dir"]
    assert tgd.PLAIN_CALLS["traceback"] > before["gtraceback"]
    assert sum(a.mapped for a in got) >= len(reads) - 2
    for i, (h, d) in enumerate(zip(host, got)):
        assert _key(h) == _key(d), f"read {i}"
    # the JAX package's device finalize on the CPU backend
    monkeypatch.setenv("SEEKSV_TPU_DEVICE_FINALIZE_ON_CPU", "1")
    monkeypatch.setenv("SEEKSV_TPU_FINALIZE_CROSSOVER_CELLS", "1")
    jal = BatchAligner.from_fasta(fa, cache=False)
    jdev = jal.batch_align(reads)
    assert jal.timings["device_finalize_s"] > 0
    for i, (j, d) in enumerate(zip(jdev, got)):
        assert _key(j) == _key(d), f"read {i}"


def test_force_host_takes_the_native_path(genome_fa):
    fa, chroms = genome_fa
    reads = _reads(chroms, seed=8)[:8]
    before = dict(ext.PLAIN_CALLS)
    tal = TorchBatchAligner.from_fasta(fa, cache=False, device="cpu")
    got = tal.batch_align(reads, force_host=True)
    assert ext.PLAIN_CALLS == before
    assert tal.timings["device_extend_s"] == 0
    assert tal.timings["device_finalize_s"] == 0
    host = BatchAligner.from_fasta(fa, cache=False).batch_align(
        reads, force_host=True)
    assert [_key(a) for a in got] == [_key(a) for a in host]


def test_device_finalize_failure_raises(genome_fa, monkeypatch):
    fa, chroms = genome_fa
    reads = _reads(chroms)[:4]
    tal = TorchBatchAligner.from_fasta(fa, cache=False, device="cpu")

    def boom(*a, **k):
        raise ValueError("device gone")
    monkeypatch.setattr(tgd, "traceback_rle", boom)
    with pytest.raises(RuntimeError, match="device finalize failed"):
        tal.batch_align(reads)


def test_cuda_finalize_without_native_library_raises(genome_fa, monkeypatch):
    """Without the native host library a CUDA aligner raises instead of
    finalizing every read on the host; force_host and the CPU device keep
    the reference's per-read host finalize."""
    from seeksv_tpu_torch.io import native
    fa, _ = genome_fa
    idx = TorchBatchAligner.from_fasta(fa, cache=False, device="cpu").idx
    monkeypatch.setattr(native, "sw_global_batch_available", lambda: False)
    codes = np.array([0, 1, 2, 3], np.uint8)
    args = ([(codes, 3 - codes[::-1])], [b"ACGT"], {0: []})
    with pytest.raises(RuntimeError, match="native host library"):
        TorchBatchAligner(idx, device="cuda")._finalize_many(*args)
    for tal, force_host in ((TorchBatchAligner(idx, device="cuda"), True),
                            (TorchBatchAligner(idx, device="cpu"), False)):
        out = tal._finalize_many(*args, force_host=force_host)
        assert [a.mapped for a in out] == [False]
