"""Device-resident seeding: the batched candidate finder on a torch device.

Counterpart of ``seeksv_tpu/ops/seed_device.py`` (``_seed_core``,
``pad_reads``, ``DeviceSeeder``), itself the static-shape form of
``seeksv_tpu/align/seed_batch.py:batch_candidates``:

- ``seed_lookup``: rolling 2k-bit hashes of every read k-mer and their
  ranges in the sorted k-mer table (prefix bucket, then two bounded binary
  searches).  On a CUDA tensor it launches csrc/seed_lookup.cu (K4, one
  thread per k-mer) and counts the launch; on a CPU tensor it runs
  ``seed_lookup_plain``.
- ``seed_core``: the rest of ``_seed_core`` in torch ops on the same
  device: capped hit expansion, the (job, diag, offset) grouping as one
  sort of a packed int64 key, runs / votes / longest anchor as segment
  reductions, the per-job (-votes, diag) ranking and the top-8 scatter.
  These are XLA ops in the reference, not Pallas.
- ``TorchDeviceSeeder``: the k-mer table as device tensors and ``seed``,
  which returns ``batch_candidates``' mapping, or None on hit_cap overflow.

Everything is int64, as the reference runs under ``jax.enable_x64``
(composite keys reach ~2^47 at 52 Mb).  Where JAX clamps an out-of-range
gather or drops an out-of-range segment id, torch raises and CUDA reads
garbage: each such place clamps or routes to a dump slot explicitly.
"""
from __future__ import annotations

import numpy as np
import torch

from .extend import _check

# seeksv_tpu/ops/seed_device.py:35-37 (restated: that module imports jax)
MAX_OCC = 500            # align/seed_batch.py semantics (bwa mem -c 500)
TOP_CANDIDATES = 8
OFF_BITS = 11            # read offsets < 2048

I64_MAX = torch.iinfo(torch.int64).max
I64_MIN = torch.iinfo(torch.int64).min

# K4 launches; plain-version calls made for CPU tensors are counted apart
LAUNCHES = {"seed_lookup": 0}
PLAIN_CALLS = {"seed_lookup": 0}
# the hit_cap ladder of the device front-end: retries at a larger cap, and
# chunks (device seeding) or batches (device alignment) that still
# overflowed at the largest cap and went to host seeding
OVERFLOW = {"hit_cap_retries": 0, "to_host": 0}


def pad_reads(reads, k: int):
    """seeksv_tpu/ops/seed_device.py:168-186, restated.  Pad a list of
    encoded uint8 code arrays into a [NP, LP] matrix of codes (fill 4 =
    ambiguous) plus int64 lengths; both batch dims padded to 64-multiples.
    Returns (mat, lens, NP, LP) or None when the batch has no read of at
    least k bases (no kmers)."""
    n = len(reads)
    lens = np.asarray([len(r) for r in reads], np.int64)
    L = int(lens.max(initial=0))
    if n == 0 or L < k:
        return None
    NP = -(-n // 64) * 64
    LP = min(-(-L // 64) * 64, 1 << OFF_BITS)
    if L > LP:
        raise ValueError(f"read length {L} exceeds device seeder cap {LP}")
    mat = np.full((NP, LP), 4, np.uint8)
    for i, r in enumerate(reads):
        mat[i, :len(r)] = r
    lens = np.concatenate([lens, np.zeros(NP - n, np.int64)])
    return mat, lens, NP, LP


def hit_cap_ladder(run, hit_cap: int, max_hit_cap: int):
    """run(cap) at hit_cap, then at 4x the cap per retry up to max_hit_cap,
    until it returns something other than None (align_device.py:202-209);
    None when the largest cap still overflows.  Counts the retries."""
    cap = hit_cap
    while True:
        res = run(cap)
        if res is not None or cap >= max_hit_cap:
            return res
        cap = min(cap * 4, max_hit_cap)
        OVERFLOW["hit_cap_retries"] += 1


def key_tensor(keys: np.ndarray, device) -> torch.Tensor:
    """The table's unsigned low-bit keys as a torch tensor of the same
    width and bits: uint16 -> int16, uint32 -> int32 (torch's unsigned
    types have few ops; the kernel reads them unsigned, the plain version
    widens them with a mask).  uint64 residuals are refused."""
    keys = np.array(keys)   # a copy: the index may map its cache read-only
    if keys.dtype == np.uint16:
        view = keys.view(np.int16)
    elif keys.dtype == np.uint32:
        view = keys.view(np.int32)
    else:
        raise TypeError(f"k-mer keys of dtype {keys.dtype}: the device "
                        "seeder takes uint16 or uint32 residuals")
    return torch.from_numpy(view).to(device)


def _widen(keys: torch.Tensor) -> torch.Tensor:
    """int16/int32 key bits -> their unsigned values as int64."""
    mask = 0xFFFF if keys.dtype == torch.int16 else 0xFFFFFFFF
    return keys.to(torch.int64) & mask


def search_iterations(prefix_tab: np.ndarray) -> int:
    """Binary-search steps that settle every bucket: the bit length of
    the widest one (a step at least halves a range, and once lo == hi a
    step changes nothing)."""
    tab = np.asarray(prefix_tab, np.int64)
    widest = int(np.diff(tab).max(initial=0))
    return max(widest, 0).bit_length()


def _hashes(mat: torch.Tensor, lens: torch.Tensor, k: int, nk: int):
    """[N * nk] int64 rolling hashes and their validity (all codes < 4 and
    the k-mer inside the read), seed_device.py:71-80."""
    m64 = mat.to(torch.int64)
    N = mat.shape[0]
    h = torch.zeros((N, nk), dtype=torch.int64, device=mat.device)
    ok = torch.ones((N, nk), dtype=torch.bool, device=mat.device)
    for j in range(k):
        col = m64[:, j:nk + j]
        h = (h << 2) | col
        ok &= col < 4
    off = torch.arange(nk, dtype=torch.int64, device=mat.device)
    ok &= (off[None, :] + k) <= lens[:, None]
    return h.reshape(-1), ok.reshape(-1)


def seed_lookup_plain(mat, lens, keys, prefix_tab, shift: int, k: int,
                      search_iters: int):
    """Plain version of K4: (lo, cnt) int64 [N * nk], nk = LP - k + 1.
    The bounded searches run a fixed search_iters steps (the reference
    loops while any range is open; the extra steps change nothing)."""
    nk = mat.shape[1] - k + 1
    hflat, okflat = _hashes(mat, lens, k, nk)
    T = prefix_tab.shape[0]
    # a hash holding a code 4 can exceed the table: clamp as JAX does
    # (such k-mers are masked by okflat)
    p = (hflat >> shift).clamp(max=T - 1)
    b_lo = prefix_tab[p]
    b_hi = prefix_tab[(p + 1).clamp(max=T - 1)]
    q_low = hflat & ((1 << shift) - 1)
    kv_all = _widen(keys)
    cap = max(kv_all.shape[0] - 1, 0)

    def search(lo, hi, right: bool):
        lo = lo.clone()
        hi = hi.clone()
        if kv_all.shape[0] == 0:
            return lo
        for _ in range(search_iters):
            active = lo < hi
            mid = (lo + hi) >> 1
            kv = kv_all[mid.clamp(max=cap)]    # mid can reach len(keys)
            go = (kv <= q_low) if right else (kv < q_low)
            lo = torch.where(active & go, mid + 1, lo)
            hi = torch.where(active & ~go, mid, hi)
        return lo

    lo = search(b_lo, b_hi, False)
    hi = search(lo, b_hi, True)
    cnt = hi - lo
    cnt = torch.where(okflat & (cnt > 0) & (cnt <= MAX_OCC), cnt,
                      torch.zeros_like(cnt))
    return lo, cnt


def seed_lookup(mat: torch.Tensor, lens: torch.Tensor, keys: torch.Tensor,
                prefix_tab: torch.Tensor, shift: int, k: int,
                search_iters: int):
    """K-mer lookup of a padded read matrix: mat [N, LP] uint8 codes,
    lens [N] int64, keys [n] int16/int32 (key_tensor), prefix_tab [T]
    int64.  Returns (lo, cnt) int64 [N * (LP - k + 1)].

    A CUDA tensor launches csrc/seed_lookup.cu (no fallback); a CPU
    tensor runs seed_lookup_plain."""
    dev = mat.device
    if mat.dim() != 2:
        raise ValueError("mat must be an [N, LP] code matrix")
    N, LP = mat.shape
    if LP < k:
        raise ValueError(f"read matrix width {LP} is below k={k}")
    _check("mat", mat, torch.uint8, (N, LP), dev)
    _check("lens", lens, torch.int64, (N,), dev)
    if keys.dtype not in (torch.int16, torch.int32):
        raise TypeError(f"keys has dtype {keys.dtype}, expected int16 or "
                        "int32 (the uint16 / uint32 residuals' bits)")
    _check("keys", keys, keys.dtype, (keys.shape[0],), dev)
    _check("prefix_tab", prefix_tab, torch.int64, (prefix_tab.shape[0],),
           dev)
    if prefix_tab.shape[0] < 1:
        raise ValueError("empty prefix table")
    if dev.type == "cpu":
        PLAIN_CALLS["seed_lookup"] += 1
        return seed_lookup_plain(mat, lens, keys, prefix_tab, shift, k,
                                 search_iters)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    from .. import _build
    lib = _build.lib()
    nk = LP - k + 1
    lo = torch.empty(N * nk, dtype=torch.int64, device=dev)
    cnt = torch.empty(N * nk, dtype=torch.int64, device=dev)
    if N == 0:
        return lo, cnt
    rc = lib.seeksv_seed_lookup(
        mat.data_ptr(), lens.data_ptr(), N, LP, k, keys.data_ptr(),
        keys.shape[0], 16 if keys.dtype == torch.int16 else 32,
        prefix_tab.data_ptr(), prefix_tab.shape[0], shift, MAX_OCC,
        lo.data_ptr(), cnt.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "seeksv_seed_lookup")
    LAUNCHES["seed_lookup"] += 1
    return lo, cnt


def _segment(n: int, ids, vals, reduce: str, identity: int):
    """JAX segment_{sum,min,max} over n segments: empty segments hold the
    reduction's identity; ids must lie in [0, n)."""
    out = torch.full((n,), identity, dtype=vals.dtype, device=vals.device)
    if reduce == "sum":
        return out.index_add_(0, ids, vals)
    return out.scatter_reduce_(0, ids, vals, reduce, include_self=True)


def _stable_order(key: torch.Tensor) -> torch.Tensor:
    return torch.sort(key, stable=True).indices


def seed_core(keys, prefix_tab, shift: int, positions, mat, lens,
              ref_span: int, k: int, hit_cap: int, n_jobs: int, nk: int,
              search_iters: int):
    """seeksv_tpu/ops/seed_device.py:_seed_core on torch tensors of one
    device.  Returns (diag, q_start, anchor_len, votes) int64 [N, 8],
    n_cand int32 [N] and the overflow flag (a bool tensor: reading it is
    the caller's sync)."""
    dev = mat.device
    i64 = torch.int64
    N = n_jobs
    H = hit_cap
    # ---- rolling hashes + two-level table lookup (K4) ----
    lo, cnt = seed_lookup(mat, lens, keys, prefix_tab, shift, k,
                          search_iters)
    # ---- capped ragged expansion ----
    csum = torch.cumsum(cnt, 0)
    total = csum[-1]
    overflow = total > hit_cap
    t = torch.arange(H, dtype=i64, device=dev)
    src = torch.searchsorted(csum, t, right=True)
    src = src.clamp(max=N * nk - 1)
    hit_valid = t < total
    intra = t - (csum[src] - cnt[src])
    pidx = (lo[src] + intra).clamp(0, max(positions.shape[0] - 1, 0))
    pos = positions[pidx]
    job = src // nk
    off = src % nk
    diag = pos - off
    # ---- group by (job, diag), runs of consecutive offsets: one sort ----
    zero = torch.zeros((), dtype=i64, device=dev)
    dshift = diag + (1 << OFF_BITS)            # >= 0 (diag >= -nk)
    dspan = ref_span + (2 << OFF_BITS)
    job_k = torch.where(hit_valid, job, N)     # padding sorts last
    ckey = (job_k * dspan + torch.where(hit_valid, dshift, zero)) << OFF_BITS
    ckey = ckey | torch.where(hit_valid, off, zero)
    order = _stable_order(ckey)                # jnp.argsort is stable
    jS = job_k[order]
    vS = hit_valid[order]
    dS = torch.where(vS, diag[order], torch.full_like(diag, 1 << 50))
    oS = off[order]
    first = torch.ones(1, dtype=torch.bool, device=dev)
    new_key = torch.cat([first, ~((jS[1:] == jS[:-1]) & (dS[1:] == dS[:-1]))])
    jump = torch.cat([first, oS[1:] != oS[:-1] + 1])
    new_run = new_key | jump
    run_id = torch.cumsum(new_run, 0) - 1
    key_id = torch.cumsum(new_key, 0) - 1
    idxs = torch.arange(H, dtype=i64, device=dev)
    run_len = _segment(H, run_id, torch.ones(H, dtype=i64, device=dev),
                       "sum", 0)
    run_first = _segment(H, run_id, idxs, "amin", I64_MAX)
    run_key = _segment(H, run_id, key_id, "amin", I64_MAX)
    # longest run per key, earliest start on ties (host uses strict >)
    score = run_len * H + (H - 1 - run_first)
    # an empty run's key is int64 max: JAX drops that id, torch would
    # raise, so it goes to a dump slot H
    run_key_c = torch.where(run_key < H, run_key, H)
    best = _segment(H + 1, run_key_c,
                    torch.where(run_len > 0, score, zero), "amax",
                    I64_MIN)[:H]
    best_len = torch.div(best, H, rounding_mode="floor")
    best_first = H - 1 - torch.remainder(best, H)
    anchor_start = oS[best_first.clamp(0, H - 1)]
    anchor_len = best_len + k - 1
    key_votes = _segment(H, key_id, vS.to(i64), "sum", 0)
    key_job = _segment(H, key_id, torch.where(vS, jS, N), "amin", I64_MAX)
    key_diag = _segment(H, key_id, dS, "amin", I64_MAX)
    # ---- rank per job: (-votes, diag), top 8 ----
    live = key_votes > 0
    key_job = torch.where(live, key_job, N)
    # jnp.lexsort((key_diag, -key_votes, key_job)): the last key is the
    # primary one; three stable sorts, the least significant first
    rank = _stable_order(key_diag)
    rank = rank[_stable_order(-key_votes[rank])]
    rank = rank[_stable_order(key_job[rank])]
    jR = key_job[rank]
    new_job = torch.cat([first, jR[1:] != jR[:-1]])
    job_start = torch.cummax(torch.where(new_job, idxs, zero), 0).values
    in_job = idxs - job_start
    keep = (jR < N) & (in_job < TOP_CANDIDATES) & (key_votes[rank] > 0)
    row = torch.where(keep, jR, N)
    col = torch.where(keep, in_job, zero)

    def scat(vals):
        # every dropped entry is parked at row N, then sliced off
        out = torch.zeros((N + 1, TOP_CANDIDATES), dtype=i64, device=dev)
        out.index_put_((row, col), torch.where(keep, vals, zero))
        return out[:N]
    out_diag = scat(key_diag[rank])
    out_qs = scat(anchor_start[rank])
    out_alen = scat(anchor_len[rank])
    out_votes = scat(key_votes[rank])
    n_cand = _segment(N + 1, row, keep.to(torch.int32), "sum", 0)[:N]
    return out_diag, out_qs, out_alen, out_votes, n_cand, overflow


class TorchDeviceSeeder:
    """The k-mer table as tensors on one torch device (counterpart of
    seeksv_tpu/ops/seed_device.py:DeviceSeeder), built from the same
    KmerIndex arrays that DeviceSeeder uploads."""

    def __init__(self, idx, device):
        """idx: the KmerIndex; device: where the table's tensors live."""
        self.device = torch.device(device)
        self.k = idx.k
        self.ref_span = int(idx.chrom_starts[-1])
        self.shift = idx._prefix_shift(idx.k)
        self.keys = key_tensor(idx.keys, self.device)
        ptab = np.array(idx.prefix_tab, np.int64)
        self.prefix_tab = torch.from_numpy(ptab).to(self.device)
        self.positions = torch.from_numpy(
            np.asarray(idx.positions).astype(np.int64)).to(self.device)
        self.search_iters = search_iterations(ptab)

    @classmethod
    def from_index(cls, idx, device) -> "TorchDeviceSeeder":
        return cls(idx, device)

    def upload(self, padded):
        """(mat, lens) of pad_reads' result on the device."""
        mat, lens, _NP, _LP = padded
        return (torch.from_numpy(mat).to(self.device),
                torch.from_numpy(lens).to(self.device))

    def core(self, mat, lens, hit_cap: int):
        """seed_core on this table for an uploaded padded batch."""
        NP, LP = mat.shape
        return seed_core(self.keys, self.prefix_tab, self.shift,
                         self.positions, mat, lens, self.ref_span, self.k,
                         hit_cap, NP, LP - self.k + 1, self.search_iters)

    def seed(self, reads, hit_cap: int = 1 << 18):
        """reads: list of encoded uint8 code arrays.  Returns the same
        {job: [(diag, q_start, anchor_len, votes), ...]} mapping as
        align.seed_batch.batch_candidates, or None on hit_cap overflow."""
        n = len(reads)
        padded = pad_reads(reads, self.k)
        if padded is None:
            return {i: [] for i in range(n)}
        d, qs, al, vo, nc, ovf = self.core(*self.upload(padded), hit_cap)
        if bool(ovf):
            return None
        # one download: the four [NP, 8] tables and the counts
        flat = torch.cat([torch.stack((d, qs, al, vo)).reshape(-1),
                          nc.to(torch.int64)]).cpu().numpy()
        NP = nc.shape[0]
        d, qs, al, vo = flat[:4 * NP * TOP_CANDIDATES].reshape(
            4, NP, TOP_CANDIDATES)
        nc = flat[4 * NP * TOP_CANDIDATES:]
        return {i: [(int(d[i, j]), int(qs[i, j]), int(al[i, j]),
                     int(vo[i, j])) for j in range(int(nc[i]))]
                for i in range(n)}
