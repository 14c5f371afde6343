"""The port's finalize kernels (seeksv_tpu_torch.ops.global_device)
against the JAX package's: the banded direction pass against the XLA
scan and the Pallas kernel (interpret mode), the walk against the XLA
walks and a scalar walker, and the whole finalize against the host
ladder.  All outputs are integers: every comparison is exact."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from seeksv_tpu.align.sw import global_align_np
from seeksv_tpu.ops import global_device as jgd
from seeksv_tpu_torch.ops import global_device as tgd

# several test workers share few cores: one intra-op thread each keeps
# the plain versions' many small ops from oversubscribing them
torch.set_num_threads(1)


def _pairs(rng, B, LQ, w, K):
    """B (q, t) code pairs with m <= LQ, |n - m| within the band."""
    q = np.full((B, LQ), 4, np.uint8)
    lim = K - 2 * w - 1
    ms = rng.integers(LQ // 2, LQ + 1, B).astype(np.int32)
    ns = np.clip(ms + rng.integers(-min(lim, 20), min(lim, 20) + 1, B),
                 1, LQ).astype(np.int32)
    LT = LQ
    t = np.full((B, LT), 4, np.uint8)
    for b in range(B):
        qc = rng.integers(0, 4, ms[b]).astype(np.uint8)
        tc = np.resize(qc, ns[b]).copy()
        mut = rng.random(ns[b]) < 0.08
        tc[mut] = rng.integers(0, 4, int(mut.sum()))
        if b % 2:
            cut = int(rng.integers(1, max(ns[b] - 8, 2)))
            tc = np.concatenate([tc[:cut], tc[cut + 5:],
                                 rng.integers(0, 4, 5).astype(np.uint8)])
        q[b, :ms[b]] = qc
        t[b, :ns[b]] = tc[:ns[b]]
    dlo = (np.minimum(0, ns - ms) - w).astype(np.int32)
    return q, t, ms, ns, dlo


@pytest.mark.parametrize("B,LQ,w,K", [(4, 64, 16, 128), (3, 64, 64, 256)])
def test_banded_plain_matches_xla_and_pallas(B, LQ, w, K):
    rng = np.random.default_rng(LQ + K)
    q, t, ms, ns, dlo = _pairs(rng, B, LQ, w, K)
    LT = t.shape[1]
    jt2 = jgd.build_t2(jnp.asarray(t), jnp.asarray(ns), jnp.asarray(dlo),
                       K=K, LQ=LQ, LT=LT)
    tq, tt, tm, tn, td = (torch.from_numpy(a) for a in (q, t, ms, ns, dlo))
    t2 = tgd.build_t2(tt, tn, td, K, LQ)
    np.testing.assert_array_equal(t2.numpy(), np.asarray(jt2))
    score, dirs = tgd.banded_direction(tq, tm, tt, td, tn, K)
    xs, xdirs = jgd.banded_direction(jnp.asarray(q), jnp.asarray(ms), jt2,
                                     jnp.asarray(dlo), jnp.asarray(ns),
                                     K=K, LQ=LQ)
    np.testing.assert_array_equal(score.numpy(), np.asarray(xs))
    np.testing.assert_array_equal(dirs.numpy(),
                                  np.asarray(xdirs).transpose(1, 0, 2))
    ps, pdirs, _bp = jgd.pallas_banded_direction(
        jnp.asarray(q), jnp.asarray(ms), jt2, jnp.asarray(dlo),
        jnp.asarray(ns), K=K, LQ=LQ, interpret=True)
    np.testing.assert_array_equal(score.numpy(), np.asarray(ps))
    np.testing.assert_array_equal(
        dirs.numpy(), tgd.unpack_reference_dirs(np.asarray(pdirs), B, LQ, K))
    # the walk: packed XLA walk with a budget long enough to finish
    rl, ro, nr = tgd.traceback_rle(dirs, tm, tn, td)
    jl, jo, jn = jgd.traceback_rle_packed(
        pdirs, jnp.asarray(q), jt2, jnp.asarray(ms), jnp.asarray(ns),
        jnp.asarray(dlo), K=K, LQ=LQ, T=2 * LQ + K)
    _assert_same_runs((rl, ro, nr), (jl, jo, jn))


def _assert_same_runs(got, ref):
    rl, ro, nr = (np.asarray(x) for x in got)
    jl, jo, jn = (np.asarray(x) for x in ref)
    np.testing.assert_array_equal(nr, jn)
    for b in range(len(nr)):
        k = int(nr[b])
        if k > tgd.RUNS_CAP:
            assert not rl[b].any() and not ro[b].any()
            continue
        np.testing.assert_array_equal(rl[b, :k], jl[b, :k], err_msg=str(b))
        np.testing.assert_array_equal(ro[b, :k], jo[b, :k], err_msg=str(b))
        assert not rl[b, k:].any() and not ro[b, k:].any()


def _random_dirs(rng, B, LQ, K):
    """Random direction bytes that keep the walk's invariants (ERUN only
    where j - 1 >= 1, FRUN only where i > 1) and random walk starts."""
    ms = rng.integers(0, LQ + 1, B).astype(np.int32)
    ns = np.clip(ms + rng.integers(-40, 41, B), 0, None).astype(np.int32)
    ms[:2] = 0
    ns[0] = 0                      # a declined job walks nothing
    dlo = (np.minimum(0, ns - ms) - 16).astype(np.int32)
    d = rng.integers(0, 32, (B, LQ, K)).astype(np.uint8)
    # sparse DM so walks take many turns (and some overflow RUNS_CAP)
    d &= np.where(rng.random((B, LQ, K)) < 0.5, 0xFE, 0xFF).astype(np.uint8)
    i = np.arange(1, LQ + 1)[None, :, None]
    j = i + dlo[:, None, None] + np.arange(K)[None, None, :]
    d[np.broadcast_to(j - 1 < 1, d.shape)] &= ~np.uint8(8)
    d[np.broadcast_to(i <= 1, d.shape)] &= ~np.uint8(16)
    return d, ms, ns, dlo


def _scalar_walk(d, m, n, dlo):
    """Independent one-job walker (the C++ traceback's order)."""
    B_, LQ, K = d.shape[0], d.shape[1], d.shape[2]
    i, j, mode, ops = m, n, 0, []
    while i > 0 or j > 0:
        c = j - i - dlo
        x = int(d[0, i - 1, c]) if (i >= 1 and 0 <= c < K) else 0
        if mode == 1:
            op = "D"
        elif mode == 2:
            op = "I"
        elif i > 0 and j > 0 and x & 1:
            op = "M"
        elif j > 0 and x & 2:
            op = "D"
        elif i > 0 and x & 4:
            op = "I"
        else:
            op = "M" if (i > 0 and j > 0) else ("D" if j > 0 else "I")
        if op == "D" and x & 8 and mode in (0, 1):
            mode = 1
        elif op == "I" and x & 16 and mode in (0, 2):
            mode = 2
        else:
            mode = 0
        i -= op != "D"
        j -= op != "I"
        if ops and ops[-1][1] == op:
            ops[-1][0] += 1
        else:
            ops.append([1, op])
    return ops[::-1]    # walk order -> forward order


def _walk_matches_xla_and_scalar(d, ms, ns, dlo):
    """The plain walk (the wrapper on CPU tensors) against the XLA walk
    over the [LQ, B, K] layout (budget m + n + 1 steps) and the scalar
    walker; returns its (runs_len, runs_op, n_runs) as numpy."""
    B, LQ, K = d.shape
    got = tgd.traceback_rle(*(torch.from_numpy(a) for a in (d, ms, ns, dlo)))
    dummy = jnp.zeros((B, LQ), jnp.int32)
    ref = jgd.traceback_rle(jnp.asarray(d.transpose(1, 0, 2)), dummy, dummy,
                            jnp.asarray(ms), jnp.asarray(ns),
                            jnp.asarray(dlo), K=K, LQ=LQ,
                            T=int((ms + ns).max()) + 1)
    _assert_same_runs(got, ref)
    rl, ro, nr = (x.numpy() for x in got)
    for b in range(B):
        ops = _scalar_walk(d[b:b + 1], int(ms[b]), int(ns[b]), int(dlo[b]))
        if len(ops) > tgd.RUNS_CAP:
            assert nr[b] == tgd.RUNS_CAP + 1
            continue
        assert [[int(rl[b, k]), "MID"[ro[b, k]]] for k in range(nr[b])] == ops
    return rl, ro, nr


def test_walk_plain_matches_xla_walk_and_scalar_walker():
    rng = np.random.default_rng(4)
    _rl, _ro, nr = _walk_matches_xla_and_scalar(*_random_dirs(rng, 24, 96,
                                                               128))
    assert (nr > tgd.RUNS_CAP).any() and (nr <= tgd.RUNS_CAP).any()


@pytest.mark.parametrize("K", [128, 256])
@pytest.mark.parametrize("case", ["long_gaps", "row0", "col0", "runs_cap",
                                  "idle"])
def test_walk_plain_matches_xla_walk_on_adversarial_blocks(case, K):
    """Direction blocks built to leave any window of the card's walk (128
    rows of one 32-byte sector; tests/torch_inputs.py:adversarial_walks):
    D and I runs past 32 and 64 steps, walks that end along row 0 or
    column 0, exactly RUNS_CAP runs and RUNS_CAP + 1, m = n = 0 jobs
    between live ones.  The plain walk against the XLA walk and the scalar
    walker, exactly."""
    from torch_inputs import adversarial_walks
    d, ms, ns, dlo = adversarial_walks(case, K)
    B = d.shape[0]
    rl, ro, nr = _walk_matches_xla_and_scalar(d, ms, ns, dlo)
    longest = {op: max([int(rl[b, k]) for b in range(B) for k in range(nr[b])
                        if nr[b] <= tgd.RUNS_CAP and "MID"[ro[b, k]] == op],
                       default=0) for op in "MID"}
    assert longest["M"] >= 600          # a walk through five windows
    # forward order: a walk's last steps are its first run
    first = [("MID"[ro[b, 0]], int(rl[b, 0]))
             for b in range(B) if 0 < nr[b] <= tgd.RUNS_CAP]
    if case == "long_gaps":
        assert longest["D"] > 64 and longest["I"] > 64
    elif case in ("row0", "col0"):      # the tail along row / column 0
        tail = "D" if case == "row0" else "I"
        assert {(tail, 40), (tail, 70), (tail, 1)} <= set(first)
    elif case == "runs_cap":
        assert {tgd.RUNS_CAP, tgd.RUNS_CAP + 1} <= set(nr.tolist())
    else:
        assert (nr == 0).sum() == 4 and (ms == 0).sum() == 4


def test_walk_has_no_step_budget():
    """A walk longer than the reference's budget LQ + K completes: row m
    says D down to band column 0, every other row says I, so the walk
    is 102 D, 64 I, then 48 D along row 0 (214 steps, 3 runs)."""
    LQ, K = 64, 128
    m, n = 64, 150
    dlo = min(0, n - m) - 16
    d = np.full((1, LQ, K), 4, np.uint8)     # DF
    d[0, m - 1, 1:] = 2                      # DE on row m
    ops = _scalar_walk(d, m, n, dlo)
    assert ops == [[48, "D"], [64, "I"], [102, "D"]]
    rl, ro, nr = tgd.traceback_rle(
        torch.from_numpy(d), torch.tensor([m], dtype=torch.int32),
        torch.tensor([n], dtype=torch.int32),
        torch.tensor([dlo], dtype=torch.int32))
    assert sum(ln for ln, _ in ops) > LQ + K
    assert [[int(rl[0, k]), "MID"[ro[0, k]]] for k in range(nr[0])] == ops


def _mutate(rng, q, sub_rate, indel_rate):
    t = []
    for b in q:
        r = rng.random()
        if r < indel_rate / 2:
            continue
        if r < indel_rate:
            t.append(int(rng.integers(0, 4)))
        if rng.random() < sub_rate:
            t.append(int((b + 1 + rng.integers(0, 3)) % 4))
        else:
            t.append(int(b))
    return np.asarray(t, np.uint8)


def _fuzz_cases(seed, n_cases):
    """The tests/test_global_device.py fuzz mix plus its boundary walks."""
    rng = np.random.default_rng(seed)
    cases = []
    for _ in range(n_cases):
        m = int(rng.integers(260, 1400))
        q = rng.integers(0, 4, m).astype(np.uint8)
        t = _mutate(rng, q, float(rng.choice([0.0, 0.005, 0.02, 0.05, 0.1])),
                    float(rng.choice([0.0, 0.002, 0.01, 0.03])))
        if len(t) <= 256:
            continue
        if rng.random() < 0.3:
            t = t.copy()
            t[rng.integers(0, len(t), 5)] = 4
        cases.append((q, t))
    q = rng.integers(0, 4, 512).astype(np.uint8)
    cases += [(q, q.copy()), (q, np.concatenate([q[:200], q[260:]])),
              (q, np.concatenate([q[:300], rng.integers(0, 4, 90).astype(
                  np.uint8), q[300:]]))]
    q = rng.integers(0, 4, 300).astype(np.uint8)
    r40 = rng.integers(0, 4, 40).astype(np.uint8)
    cases += [(q, np.concatenate([r40, q])), (q, np.concatenate([q, r40])),
              (np.concatenate([r40[:30], q]), q),
              (np.concatenate([q, r40[:30]]), q)]
    return cases


def test_finalize_matches_host_ladder_and_jax_finalize():
    cases = _fuzz_cases(7, 16)
    qs = [c[0] for c in cases]
    ts = [c[1] for c in cases]
    before = dict(tgd.PLAIN_CALLS)
    got = tgd.TorchDeviceGlobalAligner("cpu").align_batch(qs, ts)
    assert tgd.PLAIN_CALLS["banded_dir"] > before["banded_dir"]
    assert tgd.PLAIN_CALLS["traceback"] > before["traceback"]
    assert len(got) >= len(cases) // 2, "fuzz set is vacuous"
    for i, (sc, cig, nm) in got.items():
        ref_sc, ref_cig = global_align_np(qs[i], ts[i])
        assert (sc, cig) == (ref_sc, ref_cig), i
        qi = ti = mm = 0
        for ln, op in ref_cig:
            if op == "M":
                mm += int(np.sum(qs[i][qi:qi + ln] != ts[i][ti:ti + ln]))
            else:
                mm += ln
            qi += ln if op != "D" else 0
            ti += ln if op != "I" else 0
        assert nm == mm, i
    assert got == jgd.DeviceGlobalAligner().align_batch(qs, ts)


def test_unpack_reference_dirs_layout():
    B, LQ, K = 3, 8, 128
    rng = np.random.default_rng(1)
    want = rng.integers(0, 32, (B, LQ, K)).astype(np.uint8)
    words = np.zeros(((LQ // 4) * K, 128), np.uint32)
    for b in range(B):
        for i in range(1, LQ + 1):
            for c in range(K):
                words[((i - 1) // 4) * K + c, b] |= (
                    np.uint32(want[b, i - 1, c]) << np.uint32(8 * ((i - 1) % 4)))
    got = tgd.unpack_reference_dirs(words.view(np.int32), B, LQ, K)
    np.testing.assert_array_equal(got, want)



@pytest.mark.parametrize("w,K", tgd.TorchDeviceGlobalAligner.RUNGS)
def test_plan_band_bins_matches_numpy(w, K):
    """The direction kernel's dispatch against a numpy restatement: every
    job in exactly one bin, the bin the first whose edge holds the job's
    k_real (the edges and one past each among the jobs), bins widest
    first, a bin's jobs longest first."""
    from torch_inputs import band_edge_lengths
    rng = np.random.default_rng(K)
    LQ, LT = 1024, 1024 + 128
    ms, ns = band_edge_lengths(w, K, LQ, LT)
    extra = rng.integers(257, LQ + 1, 40).astype(np.int32)
    ms = np.concatenate([ms, extra])
    ns = np.concatenate([ns, np.clip(extra + rng.integers(-90, 91, 40), 257,
                                     LT).astype(np.int32)])
    perm = rng.permutation(len(ms))
    ms, ns = ms[perm], ns[perm]
    dlo = (np.minimum(0, ns - ms) - w).astype(np.int32)
    order, seg = tgd.plan_band_bins(*(torch.from_numpy(a)
                                      for a in (ms, dlo, ns)), K)
    order, seg = order.numpy(), seg.numpy()
    edges = tgd.BAND_EDGES[K]
    assert edges[-1] == K and all(e % 32 == 0 for e in edges)
    assert tgd.band_launches(K) == len(edges) == len(seg) - 1
    assert sorted(order.tolist()) == list(range(len(ms)))
    assert seg[0] == 0 and seg[-1] == len(ms) and (np.diff(seg) > 0).all()
    k_real = np.abs(ns - ms) + 2 * w + 1
    np.testing.assert_array_equal(
        tgd.band_columns(*(torch.from_numpy(a) for a in (ms, dlo, ns)),
                         K).numpy(), np.minimum(k_real, K))
    want_bin = np.searchsorted(edges, np.minimum(k_real, K))   # left
    for e in edges[:-1]:
        assert (k_real == e).any() and (k_real == e + 1).any()
    for which in range(len(edges)):
        jobs = order[seg[which]:seg[which + 1]]
        b = len(edges) - 1 - which                  # widest bin first
        assert (want_bin[jobs] == b).all()
        assert (np.diff(ms[jobs]) <= 0).all()


def test_binned_direction_lands_at_the_jobs_own_indices():
    """The dispatch with the plain version in the kernel's place gives
    the wrapper's result job for job."""
    from torch_inputs import banded_direction_binned_plain, finalize_pairs
    rng = np.random.default_rng(11)
    w, K, LQ = 16, 128, 64
    ms = rng.integers(20, LQ + 1, 12).astype(np.int32)
    ns = np.clip(ms + rng.integers(-40, 41, 12), 1, LQ).astype(np.int32)
    ms[:2], ns[:2] = (20, 60), (60, 20)        # bands of 73 columns
    q, t = finalize_pairs(rng, ms, ns, LQ, LQ)
    dlo = (np.minimum(0, ns - ms) - w).astype(np.int32)
    tq, tm, tt, td, tn = (torch.from_numpy(a) for a in (q, ms, t, dlo, ns))
    score, dirs = tgd.banded_direction(tq, tm, tt, td, tn, K)
    bs, bd = banded_direction_binned_plain(tq, tm, tt, td, tn, K)
    assert torch.equal(score, bs) and torch.equal(dirs, bd)
    _order, seg = tgd.plan_band_bins(tm, td, tn, K)
    assert (torch.diff(seg) > 0).all()


def _rung_cases(which):
    """Finalize jobs where no, some or all jobs need rung 64: an exact
    copy is sound at rung 16; 40 bases deleted at one place and 40 others
    inserted further on take the path 40 diagonals off, outside rung 16's
    band and inside rung 64's."""
    rng = np.random.default_rng(len(which))
    qs, ts = [], []
    for i in range(4):
        q = rng.integers(0, 4, 300 + 10 * i).astype(np.uint8)
        wide = {"none": False, "some": i % 2 == 1, "all": True}[which]
        t = np.concatenate([q[:120], q[160:240],
                            rng.integers(0, 4, 40).astype(np.uint8),
                            q[240:]]) if wide else q.copy()
        qs.append(q)
        ts.append(t)
    return qs, ts


@pytest.mark.parametrize("which", ["none", "some", "all"])
def test_align_batch_rung64_on_the_jobs_that_need_it(which, monkeypatch):
    """align_batch runs rung 64 on the compacted sub-batch of the jobs
    rung 16 did not accept, and gives the reference's dictionary."""
    qs, ts = _rung_cases(which)
    calls = []
    real = tgd.banded_direction

    def spy(q, qlen, t, dlo, n, K):
        calls.append((K, q.shape[0]))
        return real(q, qlen, t, dlo, n, K)
    monkeypatch.setattr(tgd, "banded_direction", spy)
    got = tgd.TorchDeviceGlobalAligner("cpu").align_batch(qs, ts)
    want64 = {"none": 0, "some": 2, "all": 4}[which]
    assert calls == [(128, 4)] + ([(256, want64)] if want64 else [])
    assert len(got) == 4
    assert got == jgd.DeviceGlobalAligner().align_batch(qs, ts)
