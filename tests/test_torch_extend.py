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
