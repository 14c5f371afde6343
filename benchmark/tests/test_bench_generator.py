"""The benchmark's frozen generator writes the BAM bytes of the port's
own (seeksv_tpu_torch/utils/dataset.py), compared decompressed: the
port may deflate with its native library, the copy with zlib."""
import gzip

import pytest

from bench_helpers import REPO  # noqa: F401  (puts the repo on sys.path)


def _same(a, b):
    with gzip.open(a, "rb") as fa, gzip.open(b, "rb") as fb:
        return fa.read() == fb.read()


def _text(p):
    with open(p) as f:
        return f.read()


@pytest.mark.parametrize("read_len,virus", [(100, False), (1000, True)])
def test_bench_generator_single_sample_bytes(tmp_path, read_len, virus):
    from sbench.gen import dataset as frozen
    from seeksv_tpu_torch.utils import dataset as port
    kw = dict(virus_kb=100, virus_events=10) if virus else {}
    a = port.build_dataset(str(tmp_path / "port"), 600_000, 8, read_len, 7,
                           12, False, **kw)
    b = frozen.build_dataset(str(tmp_path / "copy"), 600_000, 8, read_len, 7,
                             12, False, **kw)
    assert _same(a["bam"], b["bam"])
    assert _text(a["ref_fa"]) == _text(b["ref_fa"])
    assert _text(a["truth"]) == _text(b["truth"])
    assert b["n_records"][0] > 0


def test_bench_generator_pair_bytes(tmp_path):
    from sbench.gen import dataset as frozen
    from seeksv_tpu_torch.utils import dataset as port
    a = port.build_somatic_dataset(str(tmp_path / "port"), 500_000, 10, 100,
                                   2 ** 31 + 5, 10)
    b = frozen.build_somatic_dataset(str(tmp_path / "copy"), 500_000, 10, 100,
                                     2 ** 31 + 5, 10)
    for k in ("tumor", "normal"):
        assert _same(a[k], b[k])
    assert _text(a["truth"]) == _text(b["truth"])
