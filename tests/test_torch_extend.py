"""The port's extension (seeksv_tpu_torch.ops.extend) against the JAX
package's kernels and the native host kernel, exactly (integer outputs,
tolerance 0).  The Pallas kernels run in interpret mode on the CPU, as
tests/test_pallas.py runs them; the CUDA kernel is held against the
plain version on the card only."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from seeksv_tpu.io import native
from seeksv_tpu.ops.jax_kernels import sw_extend_batch
from seeksv_tpu.ops.pallas_sw import (pallas_extend_batch,
                                      pallas_extend_batch_resident)
from seeksv_tpu_torch.ops import extend as ext

# several test workers share few cores: one intra-op thread each keeps
# the plain versions' many small ops from oversubscribing them
torch.set_num_threads(1)

KEYS = ext.KEYS


def _jobs(seed, B, LQ, LT):
    """The tests/test_pallas.py job mix plus edge rows: tlen = 0, a
    z-drop (a perfect prefix then a long mismatching tail), argmax ties
    (a repeated query) and qlen = 0."""
    rng = np.random.default_rng(seed)
    q = np.full((B, LQ), 4, np.int32)
    t = np.full((B, LT), 4, np.int32)
    qlen = rng.integers(0, LQ + 1, B).astype(np.int32)
    tlen = rng.integers(1, LT + 1, B).astype(np.int32)
    h0 = rng.integers(10, 40, B).astype(np.int32)
    for b in range(B):
        qc = rng.integers(0, 4, qlen[b])
        tc = rng.integers(0, 4, tlen[b])
        if b % 2 == 0 and tlen[b] >= qlen[b] and qlen[b] > 0:
            tc[:qlen[b]] = qc
            mut = rng.random(qlen[b]) < 0.12
            tc[:qlen[b]][mut] = rng.integers(0, 4, int(mut.sum()))
        q[b, :qlen[b]] = qc
        t[b, :tlen[b]] = tc
    tlen[0:3] = 0                                   # anchor at a chrom start
    # z-drop: 12 matching cells, then a tail that only mismatches
    q[3, :] = 0
    qlen[3] = LQ
    t[3, :] = 1
    t[3, :12] = 0
    tlen[3] = LT
    h0[3] = 5
    # argmax ties: a period-4 query against a period-4 target
    q[4, :] = np.tile([0, 1, 2, 3], LQ // 4 + 1)[:LQ]
    t[4, :] = np.tile([0, 1, 2, 3], LT // 4 + 1)[:LT]
    qlen[4] = LQ
    tlen[4] = LT
    qlen[5] = 0
    return q, qlen, t, tlen, h0


def _plain(q, qlen, t, tlen, h0):
    got = ext.extend_batch_plain(*(torch.from_numpy(a) for a in
                                   (q, qlen, t, tlen, h0)))
    return {k: v.numpy() for k, v in got.items()}


def test_plain_matches_pallas_xla_and_native():
    q, qlen, t, tlen, h0 = _jobs(5, 128, 48, 96)
    got = _plain(q, qlen, t, tlen, h0)
    args = [jnp.asarray(a) for a in (q, qlen, t, tlen, h0)]
    refs = {"pallas": pallas_extend_batch(*args, interpret=True),
            "xla": sw_extend_batch(*args)}
    if native.sw_available():
        refs["native"] = native.sw_extend_batch_native(q, qlen, t, tlen, h0)
    # a job with tlen = 0 keeps gscore at its kernel's NEG_INF, and the
    # XLA and native kernels use another sentinel than the Pallas one
    scored = tlen > 0
    for name, ref in refs.items():
        for k in KEYS:
            rows = scored if (k == "gscore" and name != "pallas") \
                else slice(None)
            np.testing.assert_array_equal(got[k][rows],
                                          np.asarray(ref[k])[rows],
                                          err_msg=f"{name} {k}")
    assert (got["gscore"][:3] == ext.NEG_INF).all()      # tlen = 0
    assert got["tle"][3] < 20                            # z-dropped early


def _genome(seed, G):
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, G).astype(np.uint8)
    genome[rng.random(G) < 0.01] = 4
    gp = genome if G % 2 == 0 else np.concatenate(
        [genome, np.full(1, 4, np.uint8)])
    return genome, (gp[0::2] | (gp[1::2] << 4)).astype(np.uint8)


@pytest.mark.parametrize("reverse", [False, True])
def test_resident_plain_matches_pallas_resident(reverse):
    """Nibble-packed queries and genome windows (walking backwards for
    left extensions), including windows off either genome end."""
    G = 5_001
    genome, refp = _genome(11, G)
    rng = np.random.default_rng(12 + reverse)
    B, LQ, LT = 64, 40, 80
    q = np.full((B, LQ), 4, np.uint8)
    qlen = rng.integers(0, LQ + 1, B).astype(np.int32)
    tlen = rng.integers(1, LT + 1, B).astype(np.int32)
    tlen[-2:] = 0
    h0 = rng.integers(10, 40, B).astype(np.int32)
    start = rng.integers(0, G, B).astype(np.int32)
    start[:4] = [0, 1, G - 1, G - 2]
    for b in range(B):
        q[b, :qlen[b]] = rng.integers(0, 4, qlen[b])
    q4 = ext.pack_nibbles(q)
    ref = pallas_extend_batch_resident(
        jnp.asarray(q4), jnp.asarray(qlen), jnp.asarray(start),
        jnp.asarray(tlen), jnp.asarray(h0), jnp.asarray(refp), G, LQ, LT,
        reverse, interpret=True)
    before = dict(ext.PLAIN_CALLS)
    got = ext.extend_batch_resident(
        *(torch.from_numpy(a) for a in (q4, qlen, start, tlen, h0, refp)),
        G, LQ, LT, reverse)
    key = "extend_left" if reverse else "extend_right"
    assert ext.PLAIN_CALLS[key] == before[key] + 1
    for k in KEYS:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]),
                                      err_msg=f"{k} reverse={reverse}")


def test_gather_matches_host_windows():
    G = 301
    genome, refp = _genome(3, G)
    start = torch.tensor([0, 5, 300, 299, 150], dtype=torch.int32)
    tlen = torch.tensor([10, 10, 10, 3, 0], dtype=torch.int32)
    for reverse in (False, True):
        got = ext.gather_ref_windows(torch.from_numpy(refp), G, start, tlen,
                                     12, reverse).numpy()
        for b in range(len(start)):
            for k in range(12):
                p = int(start[b]) + (-k if reverse else k)
                want = genome[p] if (k < tlen[b] and 0 <= p < G) else 4
                assert got[b, k] == want, (reverse, b, k)


def test_wrapper_rejects_bad_inputs():
    q4 = torch.zeros((2, 4), dtype=torch.uint8)
    i32 = torch.zeros(2, dtype=torch.int32)
    refp = torch.zeros(5, dtype=torch.uint8)
    with pytest.raises(TypeError):
        ext.extend_batch_resident(q4, i32.long(), i32, i32, i32, refp, 10,
                                  8, 16, False)
    with pytest.raises(ValueError):
        ext.extend_batch_resident(q4, i32, i32, i32, i32, refp, 10, 16, 16,
                                  False)



def test_window_wrapper_matches_pallas_window_entry():
    """extend_batch on uint8 windows (the device front-end's entry; on the
    CPU its plain version) against pallas_extend_batch in interpret mode,
    at a batch that is no multiple of the Pallas kernel's 128 lanes, with
    the front-end's empty slots (qlen = tlen = h0 = 0) among the jobs."""
    q, qlen, t, tlen, h0 = _jobs(9, 200, 64, 192)
    empty = np.arange(200) % 3 == 0
    qlen[empty] = 0
    tlen[empty] = 0
    h0[empty] = 0
    q[empty] = 4
    t[empty] = 4
    ref = pallas_extend_batch(*(jnp.asarray(a) for a in
                                (q, qlen, t, tlen, h0)), interpret=True)
    before = dict(ext.PLAIN_CALLS)
    got = ext.extend_batch(torch.from_numpy(q.astype(np.uint8)),
                           torch.from_numpy(qlen),
                           torch.from_numpy(t.astype(np.uint8)),
                           torch.from_numpy(tlen), torch.from_numpy(h0))
    assert ext.PLAIN_CALLS["extend_windows"] == before["extend_windows"] + 1
    assert ext.PLAIN_CALLS["extend_left"] == before["extend_left"]
    for k in KEYS:
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    assert (got["gscore"][torch.from_numpy(empty)] == ext.NEG_INF).all()
    assert (got["max_score"][torch.from_numpy(empty)] == 0).all()


def test_window_wrapper_rejects_bad_inputs():
    q = torch.zeros((3, 32), dtype=torch.uint8)
    t = torch.zeros((3, 64), dtype=torch.uint8)
    i32 = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(TypeError):        # int32 windows
        ext.extend_batch(q.int(), i32, t, i32, i32)
    with pytest.raises(TypeError):
        ext.extend_batch(q, i32, t, i32, i32.long())
    with pytest.raises(ValueError):       # batch sizes differ
        ext.extend_batch(q, i32, t[:2], i32, i32)
    with pytest.raises(ValueError):
        ext.extend_batch(q, i32[:2], t, i32, i32)
    with pytest.raises(ValueError):       # not contiguous
        ext.extend_batch(q, i32, t[:, ::2], i32, i32)
    with pytest.raises(ValueError):
        ext.extend_batch(q[0], i32, t, i32, i32)


# ---- the CUDA kernel's dispatch (plan_bins), with the plain version in
# ---- the kernel's place

def _bin_jobs(seed, qlens, LQ, slack=24):
    """One job per entry of qlens: a target that holds the query with 8 %
    substitutions (so extensions run long), every fifth query random, two
    slots with tlen = 0."""
    rng = np.random.default_rng(seed)
    B = len(qlens)
    LT = LQ + slack
    qlen = np.asarray(qlens, np.int32)
    tlen = np.minimum(qlen + slack, LT).astype(np.int32)
    q = np.full((B, LQ), 4, np.uint8)
    t = np.full((B, LT), 4, np.uint8)
    for b in range(B):
        tc = rng.integers(0, 4, tlen[b]).astype(np.uint8)
        qc = tc[:qlen[b]].copy()
        mut = rng.random(qlen[b]) < 0.08
        qc[mut] = rng.integers(0, 4, int(mut.sum()))
        if b % 5 == 4:
            qc = rng.integers(0, 4, qlen[b]).astype(np.uint8)
        q[b, :qlen[b]] = qc
        t[b, :tlen[b]] = tc
    if B > 8:
        tlen[[2, B - 2]] = 0
    h0 = rng.integers(19, 50, B).astype(np.int32)
    return q, qlen, t, tlen, h0


def _edge_cases():
    cases = {"mixed": [0, 1, 5, 127, 128, 129, 200, 255, 256, 257, 400, 511,
                       512, 513, 700, 1023, 1024, 3, 64, 130, 300, 600, 1000]}
    for edge in ext.BIN_EDGES:
        for d in (-1, 0, 1):
            if edge + d <= 1024:
                cases[f"edge{edge}{d:+d}"] = [edge + d, 7, edge + d]
    cases["past_widest"] = [1025, 1100, 1536, 9, 1024, 130]
    return cases


@pytest.mark.parametrize("name", sorted(_edge_cases()))
def test_binned_dispatch_matches_host_and_jax(name):
    """Every qlen bin edge (edge - 1, edge, edge + 1), mixed bins in one
    batch and queries past the widest bin: the dispatch's results, at the
    jobs' own indices, equal extend_batch_np and the JAX sw_extend_batch;
    order and seg describe a partition of the jobs into their bins."""
    from seeksv_tpu.align.sw import extend_batch_np
    from torch_inputs import extend_batch_binned_plain
    qlens = _edge_cases()[name]
    LQ = 1536 if name == "past_widest" else 1024
    q, qlen, t, tlen, h0 = _bin_jobs(len(qlens) + len(name), qlens, LQ)
    tq, tql, tt, ttl, th = (torch.from_numpy(a) for a in
                            (q, qlen, t, tlen, h0))
    order, seg = ext.plan_bins(tql, ttl, LQ)
    order, seg = order.numpy(), seg.numpy()
    assert sorted(order.tolist()) == list(range(len(qlens)))
    assert seg[0] == 0 and seg[-1] == len(qlens) and (np.diff(seg) >= 0).all()
    widths = (1 << 30,) + tuple(reversed(ext.BIN_EDGES))
    for which in range(len(widths)):
        jobs = order[seg[which]:seg[which + 1]]
        live = (qlen[jobs] > 0) & (tlen[jobs] > 0)
        assert (qlen[jobs][live] <= widths[which]).all()
        if which + 1 < len(widths):     # a live job sits in its own bin
            assert (qlen[jobs][live] > widths[which + 1]).all()
        cost = qlen[jobs].astype(np.int64) * np.maximum(tlen[jobs], 0)
        assert (np.diff(cost) <= 0).all()           # longest first
    got = {k: v.numpy() for k, v in
           extend_batch_binned_plain(tq, tql, tt, ttl, th).items()}
    host = extend_batch_np(q.view(np.int8), qlen, t.view(np.int8), tlen, h0)
    xla = sw_extend_batch(*(jnp.asarray(a) for a in
                            (q.astype(np.int32), qlen, t.astype(np.int32),
                             tlen, h0)))
    whole = _plain(q.astype(np.int32), qlen, t.astype(np.int32), tlen, h0)
    scored = tlen > 0     # gscore's sentinel differs between the kernels
    for k in KEYS:
        rows = scored if k == "gscore" else slice(None)
        np.testing.assert_array_equal(got[k], whole[k], err_msg=k)
        np.testing.assert_array_equal(got[k][rows], np.asarray(host[k])[rows],
                                      err_msg=f"host {k}")
        np.testing.assert_array_equal(got[k][rows], np.asarray(xla[k])[rows],
                                      err_msg=f"xla {k}")
    assert (got["max_score"][qlen > 100] > 60).any() or max(qlens) <= 100


@pytest.mark.parametrize("LQ", [96, 512, 1024])
def test_qlen_past_the_bucket_is_binned_as_the_bucket(LQ):
    """A qlen past the bucket LQ has LQ cells: plan_bins puts the job in
    the bin of LQ (a bin the call launches, counted by bin_launches), and
    the dispatch's result is the plain version's: every cell of the row
    scored, gscore left at NEG_INF because no cell is cell qlen."""
    from torch_inputs import extend_batch_binned_plain
    qlens = [LQ, 5, LQ, 40, LQ]
    q, qlen, t, tlen, h0 = _bin_jobs(LQ, qlens, LQ)
    qlen[[0, 4]] = [LQ + 1, LQ + 700]
    tq, tql, tt, ttl, th = (torch.from_numpy(a) for a in
                            (q, qlen, t, tlen, h0))
    order, seg = ext.plan_bins(tql, ttl, LQ)
    order, seg = order.tolist(), seg.tolist()
    n_bins = len(ext.BIN_EDGES) + 1
    launched = range(n_bins - ext.bin_launches(LQ), n_bins)
    for which in range(n_bins):
        if which not in launched:
            assert seg[which] == seg[which + 1]
    bin_of = {b: w for w in range(n_bins) for b in order[seg[w]:seg[w + 1]]}
    assert bin_of[0] == bin_of[4] == bin_of[2]
    got = extend_batch_binned_plain(tq, tql, tt, ttl, th)
    whole = ext.extend_batch_plain(tq, tql, tt, ttl, th)
    for k in KEYS:
        assert torch.equal(got[k], whole[k]), k
    assert got["gscore"][0] == ext.NEG_INF and got["gtle"][0] == 0
    assert got["max_score"][0] > 60 or LQ < 100
