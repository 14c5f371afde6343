"""The port's `aln` entry points against the JAX package's, byte for byte,
on simulator genomes: align_fastq_to_sam (single end, the host aligner)
and align_paired_fastq_to_sam on ``device="cpu"`` (both ends through
BatchAligner.batch_align with the kernels' plain versions: the extension,
and for reads past 256 bases the banded direction pass and the walk).

Pairs as tests/test_align.py:117 makes them (250 pairs, 100 bp, fragment
~N(400, 30)), plus pairs whose ends fall on other contigs, on the same
strand, in RF orientation, with a random (unmapped) end, and longer
pairs whose finalize jobs reach the device aligner."""
import gzip

import numpy as np
import pytest
import torch

from seeksv_tpu.align import engine as r_engine
from seeksv_tpu_torch.align import engine as p_engine
from seeksv_tpu_torch.ops import global_device as gd
from torch_inputs import _revcomp, paired_fastqs

# several test workers share few cores: one intra-op thread each
torch.set_num_threads(1)


@pytest.mark.parametrize("sub_rate", [0.0, 0.02])
def test_paired_end_sam_equals_the_reference(tmp_path, sub_rate):
    fa, (fq1, fq2) = paired_fastqs(tmp_path, 5, 60_000, 100, 250, 400, 30,
                                   odd=6, sub_rate=sub_rate)
    r_engine.align_paired_fastq_to_sam(fa, fq1, fq2, str(tmp_path / "r.sam"))
    res = p_engine.align_paired_fastq_to_sam(fa, fq1, fq2,
                                             str(tmp_path / "p.sam"),
                                             device="cpu")
    got = (tmp_path / "p.sam").read_bytes()
    assert got == (tmp_path / "r.sam").read_bytes()
    lines = [ln.split(b"\t") for ln in got.splitlines()
             if not ln.startswith(b"@")]
    flags = [int(f[1]) for f in lines]
    assert len(lines) == 2 * 274
    assert sum(f & 0x2 > 0 for f in flags) > 400      # proper pairs
    assert any(f & 0x4 for f in flags) and any(f & 0x8 for f in flags)
    assert any(f[6] not in (b"=", b"*") for f in lines)  # mate elsewhere
    # both ends went through the device aligner's CPU route
    assert [d["chose_device"] for d in res["dispatch"]] == [True, True]
    assert not any(d["crossover_applied"] for d in res["dispatch"])


def test_paired_end_with_finalize_on_the_device_route(tmp_path):
    """600 bp ends: their finalize jobs (m, n > 256) take the device
    aligner's plain versions (K2, K3) on the CPU; the SAM is the
    reference's."""
    fa, (fq1, fq2) = paired_fastqs(tmp_path, 9, 40_000, 600, 12, 1500, 60,
                                   odd=1)
    calls = []
    orig = gd.TorchDeviceGlobalAligner.align_batch

    def spy(self, qs, ts):
        out = orig(self, qs, ts)
        calls.append(len(out))
        return out
    gd.TorchDeviceGlobalAligner.align_batch = spy
    try:
        p_engine.align_paired_fastq_to_sam(fa, fq1, fq2,
                                           str(tmp_path / "p.sam"),
                                           device="cpu")
    finally:
        gd.TorchDeviceGlobalAligner.align_batch = orig
    r_engine.align_paired_fastq_to_sam(fa, fq1, fq2, str(tmp_path / "r.sam"))
    assert (tmp_path / "p.sam").read_bytes() == \
        (tmp_path / "r.sam").read_bytes()
    assert sum(calls) > 10


def test_paired_end_force_host_equals_the_device_route(tmp_path):
    fa, (fq1, fq2) = paired_fastqs(tmp_path, 6, 30_000, 100, 60, 400, 30,
                                   odd=2)
    for tag, kw in (("d", {}), ("h", {"force_host": True})):
        res = p_engine.align_paired_fastq_to_sam(
            fa, fq1, fq2, str(tmp_path / f"{tag}.sam"), device="cpu", **kw)
    assert res["dispatch"][0]["forced"] == "host"
    assert not res["dispatch"][0]["chose_device"]
    assert (tmp_path / "d.sam").read_bytes() == \
        (tmp_path / "h.sam").read_bytes()


def test_paired_fastqs_of_unequal_length_raise(tmp_path):
    fa, (fq1, fq2) = paired_fastqs(tmp_path, 7, 20_000, 100, 5, 400, 30)
    with gzip.open(fq2, "at") as f:
        f.write("@extra/2\nACGT\n+\nIIII\n")
    with pytest.raises(ValueError):
        p_engine.align_paired_fastq_to_sam(fa, fq1, fq2,
                                           str(tmp_path / "p.sam"),
                                           device="cpu")


@pytest.mark.parametrize("k", [19, 15])
def test_single_end_sam_equals_the_reference(tmp_path, k):
    """align_fastq_to_sam: one read a call of the host aligner, with
    chimeric reads (two contigs joined) that emit supplementary parts."""
    fa, (fq1, fq2) = paired_fastqs(tmp_path, 8, 50_000, 100, 150, 400, 30,
                                   odd=3)
    rng = np.random.default_rng(8)
    with gzip.open(fq1, "at") as f:
        g = open(fa).read().split(">")[1:]
        a = "".join(g[0].split("\n")[1:])
        b = "".join(g[1].split("\n")[1:])
        for i in range(20):
            s, t = (int(x) for x in rng.integers(0, 20_000, 2))
            seq = a[s:s + 60] + _revcomp(b[t:t + 60].encode()).decode()
            f.write(f"@chim{i}\n{seq}\n+\n{'I' * 120}\n")
    r_engine.align_fastq_to_sam(fa, fq1, str(tmp_path / "r.sam"),
                                min_seed_len=k)
    p_engine.align_fastq_to_sam(fa, fq1, str(tmp_path / "p.sam"),
                                min_seed_len=k)
    got = (tmp_path / "p.sam").read_bytes()
    assert got == (tmp_path / "r.sam").read_bytes()
    assert b"\t2048\t" in got or b"\t2064\t" in got
