"""Seed-and-extend alignment engine on a torch device (the in-framework
replacement for the external `bwa mem` realignment step, ref:
README.md:22-34, SURVEY.md §7 phase 3).

Counterpart of ``seeksv_tpu/align/engine.py``, one module for both halves.

Host half (``Alignment``, ``Aligner``): per read, exact k-mer seeds from
KmerIndex -> diagonal chains -> anchored left/right extension
(sw.extend_score, bwa-mem clip/extend decision with pen_clip=5) -> banded
global traceback on the chosen extents -> mapq via the bwa-mem
approximation.  Output filter: local score < T(30) -> unmapped, mirroring
`bwa mem` defaults so the downstream junction caller sees the same
mapped/unmapped/repeat classes.

Device half (``BatchAligner``, also named ``TorchBatchAligner``): the same
seeding, ranking, ``_select_parts`` and ``_mapq``, with the two device
steps on an explicit torch device:

- the left and right extension rounds go through
  ``ops.extend.extend_batch_resident`` against the nibble-packed genome
  kept on the device (``packed_reference``);
- the finalize stage's long-fragment tracebacks go through
  ``ops.global_device.TorchDeviceGlobalAligner``, in a thread that runs
  beside the native host ladder;
- ``device_seed`` seeds through ``ops.seed_device.TorchDeviceSeeder``
  (K4 lookup) before the resident extension; ``device_align`` runs the
  whole front-end through ``ops.align_device.TorchDeviceAligner`` (device
  seeding, window gather, both rounds on K1w), then the finalize.  A
  chunk whose hits overflow the largest hit_cap is seeded on the host, as
  the reference does, and counted in ``ops.seed_device.OVERFLOW``.
- with ``shard_mesh`` set (a ``parallel.mesh.make_mesh`` mesh, as the SPMD
  pipeline sets it) the two rounds run on the mesh instead: windows cut
  on the host, each rank extending its block of jobs through K1w
  (``ops.extend.extend_batch``), results all-gathered.  Every rank must
  call ``batch_align`` with the same reads.

Dispatch on a CUDA device, as the reference's (engine.py:420-543,
623-654, 827-871), from the port's own measurements on the H100: an
extension batch whose actual DP cells are under the crossover of
``align/dispatch_calibration.json`` (written by
``python -m seeksv_tpu_torch.scripts.calibrate_dispatch``; its
fingerprint is the card's name and the measured upload rate) runs on the
native host kernel; the finalize sends all its eligible long-fragment
jobs to the device when their banded cells pass the finalize crossover
(``MIN_DEVICE_FINALIZE_CELLS``; measured on the flagship by
``python -m seeksv_tpu_torch.scripts.calibrate_finalize``, which also
found the card fastest with every job: the reference's share of 0.55
has no counterpart).  Environment variables of the port's own names
(``SEEKSV_TPU_TORCH_DISPATCH_CALIB``, ``..._CALIBRATE_TIMEOUT_S``,
``..._FINALIZE_CROSSOVER_CELLS``) override them; the reference's files
and variables are never read.  ``last_dispatch`` records what the rule saw
and what it chose.  The one deliberate difference: on ``device="cpu"``
no crossover applies and every batch and eligible job takes
the kernels' plain versions, because that route exists for the tests,
which must reach the device code on the CPU (the reference routes a
CPU-only jax to its host kernels).  ``force_host=True`` keeps both steps
on the native host kernels, ``force_device=True`` sends both to the
device whatever the crossover, as in the reference.  A device failure
raises.

``align_fastq_to_sam`` (``aln``: one read a call of the host
``Aligner.align``) and ``align_paired_fastq_to_sam`` (``aln -2``: both
ends through ``BatchAligner.batch_align`` on a device, then the FR
proper-pair model) write the reference's SAM bytes.
"""
from __future__ import annotations

import functools
import gzip
import json
import math
import os
import subprocess
import sys
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..io.fasta import read_fasta
from ..ops.global_device import TorchDeviceGlobalAligner
from ..ops.seed_device import OVERFLOW, TorchDeviceSeeder, hit_cap_ladder
from ..utils import trace
from .index import ENCODE, KmerIndex
from .seed_batch import batch_candidates
from .sw import (MATCH, MISMATCH, PEN_CLIP, extend_batch_np, extend_score,
                 global_align)

MIN_SEED_LEN = 19
SCORE_T = 30
MAX_OCC = 500
MAPQ_COEF_LEN = 50
MAPQ_COEF_FAC = math.log(MAPQ_COEF_LEN)

_RC = np.arange(256, dtype=np.uint8)
for _a, _b in zip(b"ACGTacgt", b"TGCATGCA"):
    _RC[_a] = _b


@dataclass
class Alignment:
    mapped: bool
    tid: int = -1
    pos: int = 0          # 0-based leftmost ref position
    strand: int = 0       # 0 fwd, 1 rev
    cigar: List[Tuple[int, str]] = None
    score: int = 0
    sub: int = 0
    sub_n: int = 0
    mapq: int = 0
    nm: int = 0
    # strand-oriented query interval of this part (for SAM emission of
    # hard-clipped supplementary records)
    qb: int = 0
    qe: int = 0
    # chimeric split parts (bwa mem supplementary alignments, flag 0x800):
    # non-query-overlapping secondary parts with score >= SCORE_T, in
    # score order.  The reference pipeline's getsv consumes these as
    # additional realignment candidates per clip consensus (long clip
    # fragments crossing a second junction, e.g. a short viral insert's
    # far breakpoint), so they are part of the bwa-parity contract.
    supp: List["Alignment"] = None


class Aligner:
    def __init__(self, index: KmerIndex):
        self.idx = index

    @classmethod
    def from_fasta(cls, path: str, k: int = MIN_SEED_LEN,
                   cache: bool = True) -> "Aligner":
        """Build (or load a cached) k-mer index for a reference fasta.
        The cache lives under ~/.cache/seeksv_tpu_torch, the port's own
        directory (keyed by the fasta's absolute path, invalidated by
        its mtime) — never next to the fasta, which may live in a
        read-only tree.

        The on-disk format is raw .npy files in a per-index directory so
        the big arrays (keys+positions: 1.6 GB at 100 Mbp) are loaded
        with mmap_mode='r' — the load is lazy page-in instead of a
        decompress+copy (the page cache keeps repeat runs hot)."""
        import hashlib
        import json
        import os
        cdir = os.path.join(os.path.expanduser("~"), ".cache",
                            "seeksv_tpu_torch")
        key = hashlib.sha1(os.path.abspath(path).encode()).hexdigest()[:16]
        # ksi3 = the v2 packed layout (uint16 low keys + uint32
        # positions, 6 B/kmer); older ksi2 dirs are simply not matched
        cd = os.path.join(cdir, f"ksi3-{key}-k{k}")
        meta_p = os.path.join(cd, "meta.json")
        if cache and os.path.exists(meta_p) and \
                os.path.getmtime(meta_p) >= os.path.getmtime(path):
            try:
                with open(meta_p) as f:
                    meta = json.load(f)
                # async readahead hint: seeding does scattered bounded
                # probes over these mmaps; on a cold page cache that is
                # millions of 4K faults — WILLNEED streams them in
                # sequentially instead, and costs nothing when cached
                for name in ("keys.npy", "positions.npy", "ref.npy",
                             "prefix.npy"):
                    try:
                        fd = os.open(os.path.join(cd, name), os.O_RDONLY)
                        try:
                            os.posix_fadvise(fd, 0, 0,
                                             os.POSIX_FADV_WILLNEED)
                        finally:
                            os.close(fd)
                    except (OSError, AttributeError):
                        pass
                return cls(KmerIndex(
                    k,
                    np.load(os.path.join(cd, "ref.npy"), mmap_mode="r"),
                    list(meta["chrom_names"]),
                    np.asarray(meta["chrom_starts"], np.int64),
                    np.load(os.path.join(cd, "keys.npy"), mmap_mode="r"),
                    np.load(os.path.join(cd, "positions.npy"),
                            mmap_mode="r"),
                    np.load(os.path.join(cd, "prefix.npy"),
                            mmap_mode="r")))
            except Exception:
                pass
        idx = KmerIndex.build(read_fasta(path), k=k)
        if cache:
            try:
                os.makedirs(cd, exist_ok=True)
                # every file lands via tmp + atomic rename (concurrent
                # builds — e.g. every worker process on a cold
                # cache — must never expose a torn .npy to a loader
                # that already passed the meta.json commit point)
                tag = f".tmp{os.getpid()}"
                for name, arr in (("ref.npy", idx.ref),
                                  ("keys.npy", idx.keys),
                                  ("positions.npy", idx.positions),
                                  ("prefix.npy", idx.prefix_tab)):
                    p = os.path.join(cd, name)
                    tmp = p + tag + ".npy"  # np.save appends .npy itself
                    np.save(p + tag, arr)
                    os.replace(tmp, p)
                with open(meta_p + tag, "w") as f:
                    json.dump({"k": k, "chrom_names": list(idx.chrom_names),
                               "chrom_starts":
                                   [int(v) for v in idx.chrom_starts]}, f)
                os.replace(meta_p + tag, meta_p)  # meta last: commit point
            except OSError:
                pass
        return cls(idx)

    # ---- seeding ----
    def _candidates(self, codes: np.ndarray) -> List[Tuple[int, int, int, int]]:
        """Returns [(diag_ref_start, q_anchor_start, anchor_len, votes)]:
        diagonal clusters of exact k-mer hits."""
        offs, hashes = self.idx.hash_read(codes)
        if len(offs) == 0:
            return []
        lo, hi = self.idx.lookup(hashes)
        counts = hi - lo
        keep = (counts > 0) & (counts <= MAX_OCC)
        if not keep.any():
            return []
        diags: Dict[int, List[int]] = {}
        for o, l, h in zip(offs[keep], lo[keep], hi[keep]):
            for p in self.idx.positions[l:h]:
                diags.setdefault(int(p) - int(o), []).append(int(o))
        out = []
        for d, qoffs in diags.items():
            qoffs.sort()
            # longest run of consecutive offsets = maximal exact anchor
            best_start, best_len = qoffs[0], 1
            cur_start, cur_len = qoffs[0], 1
            for a, b in zip(qoffs, qoffs[1:]):
                if b == a + 1:
                    cur_len += 1
                else:
                    cur_start, cur_len = b, 1
                if cur_len > best_len:
                    best_start, best_len = cur_start, cur_len
            anchor_len = best_len + self.idx.k - 1
            out.append((d, best_start, anchor_len, len(qoffs)))
        out.sort(key=lambda t: (-t[3], t[0]))
        return out[:8]

    def _extend_candidate(self, codes, diag, q_start, anchor_len):
        """Anchored extension (ref role: bwa mem_chain2aln)."""
        idx = self.idx
        n = len(codes)
        ref_anchor = diag + q_start
        tid = idx.tid_of(ref_anchor)
        if tid < 0:
            return None
        c_lo = int(idx.chrom_starts[tid])
        c_hi = int(idx.chrom_starts[tid + 1])
        h0 = anchor_len * MATCH
        # left extension (reversed)
        lq = codes[:q_start][::-1]
        max_lt = q_start + 100
        t_lo = max(c_lo, ref_anchor - max_lt)
        lt = idx.ref[t_lo:ref_anchor][::-1]
        le = extend_score(lq, lt, h0)
        if le.gscore <= 0 or le.gscore <= le.max_score - PEN_CLIP:
            qb = q_start - le.qle
            rb = ref_anchor - le.tle
        else:
            qb = 0
            rb = ref_anchor - le.gtle
        # right extension seeded with the left local max (bwa's sc0 in
        # mem_chain2aln; NOT the gscore even when to-end was chosen)
        q_end0 = q_start + anchor_len
        rq = codes[q_end0:]
        ref_end0 = ref_anchor + anchor_len
        t_hi = min(c_hi, ref_end0 + len(rq) + 100)
        rt = idx.ref[ref_end0:t_hi]
        re_ = extend_score(rq, rt, le.max_score)
        if re_.gscore <= 0 or re_.gscore <= re_.max_score - PEN_CLIP:
            qe = q_end0 + re_.qle
            rend = ref_end0 + re_.tle
        else:
            qe = n
            rend = ref_end0 + re_.gtle
        # the reported score is the right extension's local max (bwa a->score)
        return (re_.max_score, re_.max_score, tid, qb, qe, rb, rend)

    @staticmethod
    def _fwd_iv(strand: int, qb: int, qe: int, n: int) -> Tuple[int, int]:
        """Query interval in forward-read coordinates (reverse-strand
        parts flip so intervals from both strands are comparable)."""
        return (qb, qe) if strand == 0 else (n - qe, n - qb)

    @classmethod
    def _select_parts(cls, results, n):
        """bwa mem_mark_primary_se reproduction (bwa-0.7.x mem.c):
        walking candidates in score order, one whose query interval
        overlaps every already-kept part by < 50% of the shorter
        interval (mask_level 0.50) becomes a new chimeric part — the
        best is the primary, the rest print as supplementary records
        when their score >= SCORE_T(30).  A candidate overlapping a
        kept part is secondary TO that part: it feeds that part's
        sub/sub_n for the mapq model and is not printed.  `results`
        must already be score-sorted.  Returns [[r, sub, sub_n], ...]
        in score order."""
        parts = []
        for r in results:
            strand, _final, score, tid, qb, qe, rb, rend = r
            ib, ie = cls._fwd_iv(strand, qb, qe, n)
            sec_of = None
            for p in parts:
                ps, _pf, _plm, ptid, pqb, pqe, prb, prend = p[0]
                if (ptid, prb, prend) == (tid, rb, rend) and ps == strand:
                    sec_of = ()   # exact duplicate interval: drop entirely
                    break
                pb, pe = cls._fwd_iv(ps, pqb, pqe, n)
                ov = min(ie, pe) - max(ib, pb)
                if ov > 0 and 2 * ov >= min(ie - ib, pe - pb):
                    sec_of = p
                    break
            if sec_of is None:
                parts.append([r, 0, 0])
            elif sec_of != ():
                if sec_of[1] == 0:
                    sec_of[1] = score   # best secondary = sub (score order)
                if score >= sec_of[0][2] - MIN_SEED_LEN:
                    sec_of[2] += 1
        return parts

    def _parts_to_alignments(self, codes_pair, n, parts) -> Alignment:
        """Traceback + mapq for the selected parts of one read (the
        per-read oracle; the batched native form is _finalize_many)."""
        if not parts or parts[0][0][2] < SCORE_T:
            return Alignment(False)
        out_parts = []
        mapq0 = 0
        for pi, (r, sub, sub_n) in enumerate(parts):
            strand, _final, local_max, tid, qb, qe, rb, rend = r
            if local_max < SCORE_T:
                break   # score order: nothing below emits
            codes = codes_pair[strand]
            gs, cigar = global_align(codes[qb:qe], self.idx.ref[rb:rend])
            nm = self._nm(codes[qb:qe], self.idx.ref[rb:rend], cigar)
            clip = "S" if pi == 0 else "H"   # supplementary hard-clips
            if qb > 0:
                cigar = [(qb, clip)] + cigar
            if qe < n:
                cigar = cigar + [(n - qe, clip)]
            mapq = self._mapq(local_max, sub, sub_n, qe - qb, rend - rb)
            if pi == 0:
                mapq0 = mapq
            else:
                mapq = min(mapq, mapq0)   # supplementary capped by primary
            out_parts.append(Alignment(
                True, tid, rb - int(self.idx.chrom_starts[tid]), strand,
                cigar, local_max, sub, sub_n, mapq, nm, qb, qe))
        pri = out_parts[0]
        pri.supp = out_parts[1:]
        return pri

    def align(self, seq: bytes) -> Alignment:
        fwd = ENCODE[np.frombuffer(seq, np.uint8)]
        rev = fwd[::-1].copy()
        rev = np.where(rev < 4, 3 - rev, 4).astype(np.uint8)
        n = len(fwd)
        results = []
        for strand, codes in ((0, fwd), (1, rev)):
            for diag, q_start, anchor_len, _votes in self._candidates(codes):
                r = self._extend_candidate(codes, diag, q_start, anchor_len)
                if r is not None:
                    results.append((strand,) + r)
        if not results:
            return Alignment(False)
        # rank by local-max score; deterministic tie-break: fwd strand,
        # then leftmost reference position
        results.sort(key=lambda t: (-t[2], t[0], t[6]))
        return self._parts_to_alignments((fwd, rev), n,
                                         self._select_parts(results, n))

    @staticmethod
    def _nm(q, t, cigar) -> int:
        qi = ti = nm = 0
        for ln, op in cigar:
            if op == "M":
                nm += int(np.count_nonzero(q[qi:qi + ln] != t[ti:ti + ln]))
                qi += ln
                ti += ln
            elif op == "I":
                nm += ln
                qi += ln
            elif op == "D":
                nm += ln
                ti += ln
        return nm

    @staticmethod
    def _mapq(score, sub, sub_n, qspan, rspan) -> int:
        """bwa mem_approx_mapq_se (bwa-0.7.x mem.c) reproduction."""
        sub = sub if sub else MIN_SEED_LEN * MATCH
        if sub >= score:
            return 0
        l = max(qspan, rspan)
        identity = 1.0 - (l * MATCH - score) / (MATCH + MISMATCH) / l
        if score == 0:
            return 0
        tmp = 1.0 if l < MAPQ_COEF_LEN else MAPQ_COEF_FAC / math.log(l)
        tmp *= identity * identity
        mapq = int(6.02 * (score - sub) / MATCH * tmp * tmp + 0.499)
        if sub_n > 0:
            mapq -= int(4.343 * math.log(sub_n + 1) + 0.499)
        return max(0, min(60, mapq))



# The finalize crossover in estimated banded cells (phase A's two rungs),
# measured on the flagship on an NVIDIA H100 80GB HBM3 at 700 W by
# scripts/calibrate_finalize.py (its record:
# align/finalize_calibration.json): the card beat the host ladder from 64
# reads' jobs on, and took all of them fastest (0.62 s against 0.92 with
# 0.65 of them, 1.14 with 0.55, 1.35 with 0.45, 1.58 on the host alone),
# so the card takes every eligible job.
MIN_DEVICE_FINALIZE_CELLS = 6_419_425
_HERE = os.path.dirname(os.path.abspath(__file__))

# one packed genome per (genome, device), shared by every aligner
_PACKED_CACHE: Dict = {}


def packed_reference(idx: KmerIndex,
                     device) -> Tuple[torch.Tensor, int]:
    """The genome nibble-packed (two codes per byte, low nibble first,
    odd length padded with code 4) on `device`, and its code count:
    byte for byte what BatchAligner._device_ref_packed uploads.  Cached
    per backing array and device; the entry holds the host array so its
    id cannot be reused while cached."""
    device = torch.device(device)
    ref = idx.ref
    key = (getattr(ref, "filename", None) or id(ref), len(ref), str(device))
    ent = _PACKED_CACHE.get(key)
    if ent is None:
        r = np.asarray(ref)
        if len(r) % 2:
            r = np.concatenate([r, np.full(1, 4, np.uint8)])
        packed = (r[0::2] | (r[1::2] << 4)).astype(np.uint8)
        ent = (torch.from_numpy(packed).to(device), len(ref), ref)
        _PACKED_CACHE.clear()
        _PACKED_CACHE[key] = ent
    return ent[0], ent[1]


class BatchAligner(Aligner):
    """Device-batched alignment: seeding (host or device) + two batched
    extension rounds on an explicit torch device (``cuda`` launches the
    CUDA kernels; ``cpu`` runs their plain versions, for tests), then
    tracebacks for the winning candidates only."""

    # pad buckets keep the set of kernel shapes small
    _BUCKETS = (32, 64, 128, 256, 512)

    def __init__(self, index: KmerIndex, device="cuda",
                 device_seed: bool = False, device_align: bool = False):
        super().__init__(index)
        self.device = torch.device(device)
        self.device_seed = device_seed
        self.device_align = device_align
        self.shard_mesh = None  # parallel.mesh mesh: shard extension over it
        self._seeder: Optional[TorchDeviceSeeder] = None
        self._device_al = None
        self._dga: Optional[TorchDeviceGlobalAligner] = None
        # wall-clock accounting per stage, accumulated across batch_align
        # calls by the seeksv.engine.* spans (utils/trace.py): the
        # extension rounds alone (device_ or host_extend_s), the per-job
        # host loop between them, the finalize and, on its own thread,
        # the device's share of it
        self.timings: Dict[str, float] = {
            "seed_s": 0.0, "device_extend_s": 0.0, "host_extend_s": 0.0,
            "between_rounds_s": 0.0, "finalize_s": 0.0,
            "device_finalize_s": 0.0}

    @classmethod
    def from_fasta(cls, path: str, k: int = MIN_SEED_LEN, cache: bool = True,
                   device="cuda", **flags) -> "BatchAligner":
        return cls(Aligner.from_fasta(path, k=k, cache=cache).idx,
                   device=device, **flags)

    @staticmethod
    def _bucket(n: int) -> int:
        for b in BatchAligner._BUCKETS:
            if n <= b:
                return b
        return ((n + 511) // 512) * 512

    # -- the dispatch calibration (seeksv_tpu/align/engine.py:420-543) --

    # the extension crossover in actual DP cells when no calibration file
    # exists (the committed align/dispatch_calibration.json holds the
    # measured value; this is the reference's fallback, engine.py:421)
    MIN_DEVICE_CELLS = 50_000_000

    @staticmethod
    def _calibration_path() -> str:
        return os.path.abspath(
            os.environ.get("SEEKSV_TPU_TORCH_DISPATCH_CALIB")
            or os.path.join(_HERE, "dispatch_calibration.json"))

    @staticmethod
    @functools.lru_cache(maxsize=4)
    def _load_calibration(path: str):
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    @classmethod
    def _calibrated_min_device_cells(cls) -> int:
        cal = cls._load_calibration(cls._calibration_path())
        v = cal.get("crossover_cells") if cal else None
        return int(v) if v is not None else cls.MIN_DEVICE_CELLS

    @classmethod
    def calibration_stale(cls) -> Optional[str]:
        """A reason when the dispatch calibration does not match the card
        in use (another card, or an upload rate off by more than 4x),
        else None; None without a CUDA device (the crossover gates the
        card only)."""
        cal = cls._load_calibration(cls._calibration_path())
        if cal is None:
            return "no calibration artifact"
        fp = cal.get("fingerprint")
        if not fp:
            return "calibration has no fingerprint"
        if not torch.cuda.is_available():
            return None
        dev = torch.cuda.get_device_name(torch.cuda.current_device())
        if fp.get("platform") != "cuda":
            return f"platform cuda != calibrated {fp.get('platform')}"
        if fp.get("device") != dev:
            return f"device {dev} != calibrated {fp.get('device')}"
        want = fp.get("upload_probe_mb_s")
        if want:
            got = cls._upload_probe_mb_s()
            if got > 4 * want or got < want / 4:
                return (f"upload bandwidth {got:.1f} MB/s vs calibrated "
                        f"{want:.1f} (>4x shift)")
        return None

    @staticmethod
    def _upload_probe_mb_s(size_mb: int = 4) -> float:
        """Host -> card upload rate of a pageable buffer, MB/s (best of
        two, after a warm-up)."""
        dev = torch.device("cuda", torch.cuda.current_device())
        buf = torch.empty(size_mb << 20, dtype=torch.uint8)
        buf[:1024].to(dev)
        torch.cuda.synchronize(dev)
        best = None
        for _ in range(2):
            t0 = time.perf_counter()
            buf.to(dev)
            torch.cuda.synchronize(dev)
            dt = time.perf_counter() - t0
            best = dt if best is None else min(best, dt)
        return size_mb / best

    @classmethod
    def ensure_calibration(cls, auto: bool = True, log=print) -> bool:
        """When the calibration is stale and auto is set, run the port's
        ``python -m seeksv_tpu_torch.scripts.calibrate_dispatch --out
        PATH`` in a subprocess (bounded by
        SEEKSV_TPU_TORCH_CALIBRATE_TIMEOUT_S, 600 s) and reload; a timeout
        or a failed run keeps the committed values.  True when a
        recalibration ran."""
        reason = cls.calibration_stale()
        if reason is None:
            return False
        log(f"# dispatch calibration stale: {reason}")
        if not auto:
            return False
        log("# re-running the dispatch calibration on this card...")
        timeout_s = float(os.environ.get(
            "SEEKSV_TPU_TORCH_CALIBRATE_TIMEOUT_S", "600"))
        root = os.path.dirname(os.path.dirname(_HERE))
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (root, env.get("PYTHONPATH")) if p)
        cmd = [sys.executable, "-m",
               "seeksv_tpu_torch.scripts.calibrate_dispatch", "--out",
               cls._calibration_path()]
        try:
            proc = subprocess.run(cmd, timeout=timeout_s, env=env)
        except subprocess.TimeoutExpired:
            log(f"# calibration timed out after {timeout_s:.0f}s; keeping "
                "the committed crossover values")
            return False
        if proc.returncode != 0:
            log(f"# calibration exited rc={proc.returncode}; keeping the "
                "committed crossover values")
            return False
        cls._load_calibration.cache_clear()
        log(f"# new crossover: {cls._calibrated_min_device_cells()} cells")
        return True

    def _device_seeder(self) -> TorchDeviceSeeder:
        if self._seeder is None:
            self._seeder = TorchDeviceSeeder.from_index(self.idx, self.device)
        return self._seeder

    def _device_aligner(self):
        if self._device_al is None:
            from ..ops.align_device import TorchDeviceAligner
            self._device_al = TorchDeviceAligner(
                self.idx, self.device, seeder=self._device_seeder())
        return self._device_al

    def _device_candidates(self, strand_reads, hit_cap: int = 1 << 18,
                           max_hit_cap: int = 1 << 22):
        """batch_candidates' mapping from the device seeder, in the device
        aligner's chunks and hit_cap ladder.  (The reference seeds the whole
        batch at one hit_cap, which overflows to the host at the flagship's
        size; per-read candidates do not depend on the batch, so the
        result is the same.)  A chunk that overflows the largest cap is
        seeded on the host and counted."""
        from ..ops.align_device import TorchDeviceAligner
        seeder = self._device_seeder()
        chunk = TorchDeviceAligner.CHUNK
        cands = {}
        for c0 in range(0, len(strand_reads), chunk):
            part = strand_reads[c0:c0 + chunk]
            sub = hit_cap_ladder(lambda cap: seeder.seed(part, cap),
                                 hit_cap, max_hit_cap)
            if sub is None:
                OVERFLOW["to_host"] += 1
                sub = batch_candidates(self.idx, part)
            for j, v in sub.items():
                cands[c0 + j] = v
        return cands

    def _device_ref_packed(self):
        return packed_reference(self.idx, self.device)

    def _put(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def batch_align(self, seqs: List[bytes],
                    force_device: bool = False,
                    force_host: bool = False) -> List[Alignment]:
        """Align every read.  force_host moves the extension and the
        finalize to the host, force_device sends them to the device past
        the crossovers (the device_seed and device_align front-ends run on
        the device all the same, as in the reference)."""
        per_read_codes: List[Tuple[np.ndarray, np.ndarray]] = []
        strand_reads: List[np.ndarray] = []
        for seq in seqs:
            fwd = ENCODE[np.frombuffer(seq, np.uint8)]
            rev = fwd[::-1].copy()
            rev = np.where(rev < 4, 3 - rev, 4).astype(np.uint8)
            per_read_codes.append((fwd, rev))
            strand_reads.extend((fwd, rev))
        results_by_read: Dict[int, list] = {i: [] for i in range(len(seqs))}
        dres = None
        if self.device_align:
            # the whole front-end on the device
            # (seeksv_tpu/align/engine.py:569-589)
            with trace.span("seeksv.engine.extend", self.timings,
                            "device_extend_s"):
                dres = self._device_aligner().align_jobs(strand_reads)
            if dres is None:
                OVERFLOW["to_host"] += 1   # a chunk beyond the largest cap
        if dres is not None:
            for job_i, lst in dres.items():
                ri, strand = divmod(job_i, 2)
                for final, tid, qb, qe, rb, rend in lst:
                    results_by_read[ri].append(
                        (strand, final, final, tid, qb, qe, rb, rend))
        else:
            self._seed_and_extend(strand_reads, per_read_codes,
                                  results_by_read, force_device, force_host)
        with trace.span("seeksv.engine.finalize", self.timings,
                        "finalize_s"):
            return self._finalize_many(per_read_codes, seqs,
                                       results_by_read,
                                       force_device=force_device,
                                       force_host=force_host)

    def _seed_and_extend(self, strand_reads, per_read_codes, results_by_read,
                         force_device: bool, force_host: bool) -> None:
        """Seeding (on the host, or on the device with device_seed), then
        both extension rounds (seeksv_tpu/align/engine.py:590-808)."""
        idx = self.idx
        with trace.span("seeksv.engine.seed", self.timings, "seed_s"):
            if self.device_seed:
                cands = self._device_candidates(strand_reads)
            else:
                cands = batch_candidates(idx, strand_reads)
        jobs = []  # (read_i, strand, diag, q_start, anchor_len, tid)
        for job_i, cand_list in cands.items():
            ri, strand = divmod(job_i, 2)
            for diag, q_start, anchor_len, _v in cand_list:
                tid = idx.tid_of(diag + q_start)
                if tid < 0:
                    continue
                jobs.append((ri, strand, diag, q_start, anchor_len, tid))
        if jobs:
            self._extend_jobs(jobs, per_read_codes, results_by_read,
                              force_device, force_host)

    def _extend_jobs(self, jobs, per_read_codes, results_by_read,
                     force_device: bool, force_host: bool) -> None:
        """Both extension rounds and the clip/extend decisions for every
        job (seeksv_tpu/align/engine.py:607-808 with the device branch on
        the resident torch path)."""
        idx = self.idx
        n_jobs = len(jobs)
        max_q = max(len(per_read_codes[j[0]][0]) for j in jobs)
        LQ = self._bucket(max_q)
        LT = self._bucket(max_q + 100)
        lq = np.full((n_jobs, LQ), 4, np.uint8)
        rq = np.full((n_jobs, LQ), 4, np.uint8)
        lqlen = np.zeros(n_jobs, np.int32)
        ltlen = np.zeros(n_jobs, np.int32)
        rqlen = np.zeros(n_jobs, np.int32)
        rtlen = np.zeros(n_jobs, np.int32)
        lstart = np.zeros(n_jobs, np.int32)
        rstart = np.zeros(n_jobs, np.int32)
        h0 = np.zeros(n_jobs, np.int32)
        meta = []
        est_cells = 0   # actual DP cells, as the reference's dispatch counts
        for k, (ri, strand, diag, q_start, anchor_len, tid) in \
                enumerate(jobs):
            codes = per_read_codes[ri][strand]
            ref_anchor = diag + q_start
            c_lo = int(idx.chrom_starts[tid])
            c_hi = int(idx.chrom_starts[tid + 1])
            h0[k] = anchor_len
            lq_arr = codes[:q_start][::-1]
            lq[k, :len(lq_arr)] = lq_arr
            lqlen[k] = len(lq_arr)
            ltlen[k] = ref_anchor - max(c_lo, ref_anchor - (q_start + 100))
            lstart[k] = ref_anchor - 1          # left windows walk back
            q_end0 = q_start + anchor_len
            rq_arr = codes[q_end0:]
            ref_end0 = ref_anchor + anchor_len
            rq[k, :len(rq_arr)] = rq_arr
            rqlen[k] = len(rq_arr)
            rtlen[k] = min(c_hi, ref_end0 + len(rq_arr) + 100) - ref_end0
            rstart[k] = ref_end0
            meta.append((ri, strand, len(codes), ref_anchor, q_start,
                         anchor_len, tid))
            est_cells += (q_start * (q_start + 100)
                          + len(rq_arr) * (len(rq_arr) + 100))
        # the crossover gates the card (seeksv_tpu/align/engine.py:
        # 623-654); the CPU route takes the plain versions for the tests
        crossover = self._calibrated_min_device_cells()
        on_card = self.device.type == "cuda"
        use_host = force_host or (on_card and not force_device
                                  and est_cells < crossover)
        self.last_dispatch = {
            "est_actual_cells": est_cells,
            "crossover_cells": crossover,
            "crossover_applied": on_card,
            "finalize_crossover_cells": self._min_device_finalize_cells(),
            "device": str(self.device),
            "forced": ("host" if force_host
                       else ("device" if force_device else None)),
            "chose_device": not use_host,
            "n_jobs": n_jobs, "LQ": LQ, "LT": LT,
        }
        if use_host:
            run = self._host_round(idx, LT)
        elif self.shard_mesh is not None:
            run = self._mesh_round(LQ, LT)
        else:
            run = self._device_round(LQ, LT)
        ext_key = "host_extend_s" if use_host else "device_extend_s"
        with trace.span("seeksv.engine.extend", self.timings, ext_key):
            left = run(lq, lqlen, lstart, ltlen, h0, True)
        with trace.span("seeksv.engine.between_rounds", self.timings,
                        "between_rounds_s"):
            qb = np.zeros(n_jobs, np.int64)
            rb = np.zeros(n_jobs, np.int64)
            h0r = np.zeros(n_jobs, np.int32)
            for k, (ri, strand, n, ref_anchor, q_start, anchor_len,
                    tid) in enumerate(meta):
                h0r[k] = left["max_score"][k]  # bwa sc0 semantics
                if (left["gscore"][k] <= 0
                        or left["gscore"][k]
                        <= left["max_score"][k] - PEN_CLIP):
                    qb[k] = q_start - left["qle"][k]
                    rb[k] = ref_anchor - left["tle"][k]
                else:
                    qb[k] = 0
                    rb[k] = ref_anchor - left["gtle"][k]
        with trace.span("seeksv.engine.extend", self.timings, ext_key):
            right = run(rq, rqlen, rstart, rtlen, h0r, False)
        for k, (ri, strand, n, ref_anchor, q_start, anchor_len, tid) in \
                enumerate(meta):
            q_end0 = q_start + anchor_len
            ref_end0 = ref_anchor + anchor_len
            if (right["gscore"][k] <= 0
                    or right["gscore"][k] <= right["max_score"][k] - PEN_CLIP):
                qe = q_end0 + int(right["qle"][k])
                rend = ref_end0 + int(right["tle"][k])
            else:
                qe = n
                rend = ref_end0 + int(right["gtle"][k])
            final = int(right["max_score"][k])
            results_by_read[ri].append(
                (strand, final, final, tid, int(qb[k]), qe, int(rb[k]),
                 rend))

    def _device_round(self, LQ: int, LT: int):
        from ..ops.extend import extend_batch_resident, pack_nibbles
        refp, n_codes = self._device_ref_packed()

        def run(q, qlen, tstart, tlen, h0, reverse):
            res = extend_batch_resident(
                self._put(pack_nibbles(q)), self._put(qlen),
                self._put(tstart), self._put(tlen), self._put(h0), refp,
                n_codes, LQ, LT, reverse)
            return {k: v.cpu().numpy() for k, v in res.items()}
        return run

    def _mesh_round(self, LQ: int, LT: int):
        """The extension on the shard mesh (seeksv_tpu/align/engine.py:
        690-702 and 710-751): no resident genome; target windows are cut on the
        host, the rows padded to a multiple of the mesh size, each rank
        extends its contiguous block with K1w (``ops.extend.
        extend_batch``) and the five result vectors are all-gathered, so
        every rank holds every job's result."""
        from ..ops.extend import KEYS, extend_batch
        from ..parallel.mesh import agree, all_gather, shard_index
        mesh = self.shard_mesh
        idx = self.idx
        ndev = mesh.size()
        me = shard_index(mesh)

        def run(q, qlen, tstart, tlen, h0, reverse):
            n_jobs = len(q)
            per = -(-agree(mesh, [n_jobs])[0] // ndev)
            a, b = min(me * per, n_jobs), min((me + 1) * per, n_jobs)

            def block(x, fill=0):
                # this rank's rows, padded with empty jobs (qlen = tlen = 0)
                out = np.full((per, *x.shape[1:]), fill, x.dtype)
                out[:b - a] = x[a:b]
                return self._put(out)

            t = np.full((per, LT), 4, np.uint8)
            t[:b - a] = self._cut_windows(idx, tstart[a:b], tlen[a:b], LT,
                                          reverse)
            res = extend_batch(block(q, 4), block(qlen), self._put(t),
                               block(tlen), block(h0))
            mine = torch.stack([res[k] for k in KEYS])[None]   # [1, 5, per]
            got = all_gather(mesh, mine).permute(1, 0, 2).reshape(5, -1)
            got = got[:, :n_jobs].cpu().numpy()
            return dict(zip(KEYS, got))
        return run

    @staticmethod
    def _cut_windows(idx, tstart, tlen, LT: int,
                     reverse: bool) -> np.ndarray:
        """[B, LT] uint8 target windows cut from the genome on the host:
        element k is genome position tstart -/+ k (left windows walk
        back), code 4 at k >= tlen."""
        t = np.full((len(tstart), LT), 4, np.uint8)
        for k in range(len(tstart)):
            s, ln = int(tstart[k]), int(tlen[k])
            if ln <= 0:
                continue
            if reverse:
                t[k, :ln] = idx.ref[s - ln + 1:s + 1][::-1]
            else:
                t[k, :ln] = idx.ref[s:s + ln]
        return t

    @classmethod
    def _host_round(cls, idx, LT: int):
        """The reference's host path: windows cut from the genome on the
        host, native C++ kernel when built, numpy mirror otherwise."""
        from ..io import native
        kernel = (native.sw_extend_batch_native if native.available()
                  else extend_batch_np)

        def run(q, qlen, tstart, tlen, h0, reverse):
            t = cls._cut_windows(idx, tstart, tlen, LT, reverse)
            return kernel(q.view(np.int8), qlen, t.view(np.int8), tlen, h0)
        return run

    def _finalize(self, codes_pair, n, results) -> Alignment:
        if not results:
            return Alignment(False)
        results.sort(key=lambda t: (-t[2], t[0], t[6]))
        return self._parts_to_alignments(codes_pair, n,
                                         self._select_parts(results, n))

    @staticmethod
    def _min_device_finalize_cells() -> int:
        v = os.environ.get("SEEKSV_TPU_TORCH_FINALIZE_CROSSOVER_CELLS")
        return int(v) if v else MIN_DEVICE_FINALIZE_CELLS

    def _device_finalize_plan(self, qs, ts, force_device: bool):
        """(device aligner, the job rows it takes) or (None, []): the
        eligible long-fragment jobs, on a CUDA device when their estimated
        banded cells (phase A's two rungs, K = 128 + 256) pass the
        finalize crossover (seeksv_tpu/align/engine.py:834-871), on the
        CPU always (the tests' route)."""
        if self._dga is None:
            self._dga = TorchDeviceGlobalAligner(self.device)
        dga = self._dga
        elig = [x for x in range(len(qs))
                if dga.eligible(len(qs[x]), len(ts[x]))]
        if not elig:
            return None, []
        if self.device.type == "cuda" and not force_device:
            est = sum(min(len(qs[x]), len(ts[x])) * 384 for x in elig)
            if est < self._min_device_finalize_cells():
                return None, []
        return dga, elig

    def _finalize_many(self, per_read_codes, seqs, results_by_read,
                       force_device: bool = False,
                       force_host: bool = False) -> List[Alignment]:
        """Per-read _finalize with the global-alignment tracebacks batched:
        long-fragment jobs on the device, in a thread that runs beside
        the native host ladder on the rest; an exception in it is raised
        here after the join (no silent host rerun).  Without the native
        host library the per-read host finalize runs, on the CPU device
        or with force_host only: a CUDA device raises rather than leave
        its kernels unused."""
        from ..io import native
        if not native.available():
            if self.device.type == "cuda" and not force_host:
                raise RuntimeError(
                    "device finalize needs the native host library, which "
                    f"did not build or load: {native.LOAD_ERROR}")
            return [self._finalize(per_read_codes[ri], len(seq),
                                   results_by_read[ri])
                    for ri, seq in enumerate(seqs)]
        out: List[Optional[Alignment]] = [None] * len(seqs)
        sel = []  # emitted parts needing a traceback
        for ri, seq in enumerate(seqs):
            results = results_by_read[ri]
            if not results:
                out[ri] = Alignment(False)
                continue
            results.sort(key=lambda t: (-t[2], t[0], t[6]))
            n = len(seq)
            parts = self._select_parts(results, n)
            if parts[0][0][2] < SCORE_T:
                out[ri] = Alignment(False)
                continue
            for pi, (r, sub, sub_n) in enumerate(parts):
                if r[2] < SCORE_T:
                    break   # score order: nothing below emits
                sel.append((ri, pi, r[0], r[2], r[3], r[4], r[5], r[6],
                            r[7], sub, sub_n))
        if not sel:
            return out
        qs = [per_read_codes[s[0]][s[2]][s[5]:s[6]] for s in sel]
        ts = [self.idx.ref[s[7]:s[8]] for s in sel]
        dga, dev_rows = ((None, []) if force_host else
                         self._device_finalize_plan(qs, ts, force_device))
        dev_res: Dict[int, tuple] = {}
        failure: List[Exception] = []
        th = None
        if dev_rows:
            token = trace.handoff()

            def _run_dev():
                with trace.adopt(token), \
                        trace.span("seeksv.engine.device_finalize",
                                   self.timings, "device_finalize_s"):
                    try:
                        r = dga.align_batch([qs[x] for x in dev_rows],
                                            [ts[x] for x in dev_rows])
                        dev_res.update((dev_rows[i], v)
                                       for i, v in r.items())
                    except Exception as exc:   # raised below, after join
                        failure.append(exc)
            th = threading.Thread(target=_run_dev)
            th.start()
        dev_set = set(dev_rows)
        host_rows = [x for x in range(len(sel)) if x not in dev_set]
        host_out = (native.sw_global_batch_native(
            [qs[x] for x in host_rows], [ts[x] for x in host_rows])
            if host_rows else [])
        if th is not None:
            th.join()
        if failure:
            raise RuntimeError("device finalize failed") from failure[0]
        for x, r in zip(host_rows, host_out):
            dev_res[x] = r
        # jobs the device declined (ladder past rung 64, run overflow)
        rest = [x for x in dev_rows if x not in dev_res]
        if rest:
            for x, r in zip(rest, native.sw_global_batch_native(
                    [qs[x] for x in rest], [ts[x] for x in rest])):
                dev_res[x] = r
        for x, s in enumerate(sel):
            gs, cigar, nm = dev_res[x]
            (ri, pi, strand, local_max, tid, qb, qe, rb, rend,
             sub, sub_n) = s
            n = len(seqs[ri])
            clip = "S" if pi == 0 else "H"
            if qb > 0:
                cigar = [(qb, clip)] + cigar
            if qe < n:
                cigar = cigar + [(n - qe, clip)]
            mapq = self._mapq(local_max, sub, sub_n, qe - qb, rend - rb)
            a = Alignment(
                True, tid, rb - int(self.idx.chrom_starts[tid]), strand,
                cigar, local_max, sub, sub_n, mapq, nm, qb, qe)
            if pi == 0:
                out[ri] = a
            else:
                a.mapq = min(a.mapq, out[ri].mapq)
                if out[ri].supp is None:
                    out[ri].supp = []
                out[ri].supp.append(a)
        return out


# the name the port had while it subclassed the reference's class
TorchBatchAligner = BatchAligner


def _cigar_str(cigar) -> str:
    return "".join(f"{l}{o}" for l, o in cigar) if cigar else "*"


def _read_named_fastq(path):
    names, seqs, quals = [], [], []
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        while True:
            h = f.readline()
            if not h:
                break
            names.append(h[1:].split()[0].rstrip("\n"))
            seqs.append(f.readline().strip().encode())
            f.readline()
            quals.append(f.readline().strip())
    return names, seqs, quals


def _ref_span_of(cigar) -> int:
    return sum(ln for ln, op in cigar if op in ("M", "D"))


def align_paired_fastq_to_sam(ref_fa: str, fq1: str, fq2: str, out_sam: str,
                              min_seed_len: int = MIN_SEED_LEN,
                              times: int = 4, device="cuda",
                              force_host: bool = False,
                              index: Optional[KmerIndex] = None) -> dict:
    """Paired-end-aware realignment (the bwa-sampe/mem-PE role the
    reference outsources for its unmapped_{1,2}.fq.gz virus-mode reads,
    ref: README.md:79-81, clip_reads.h:172 pair collection).

    Both ends are batch-aligned independently; an insert-size model is
    then fit from FR-oriented both-mapped pairs (same estimator as the
    reference's cluster.cpp:15: integer mean + truncated-int deviation)
    and pairs within mean±times·dev in FR orientation are flagged
    proper (0x2) — the concordance predicate of cluster.cpp:136-147.
    Mate fields (RNEXT/PNEXT/TLEN) and pair flags are filled so the
    output is a valid PE SAM consumable by getclip.

    Both ends run through ``BatchAligner.batch_align`` on `device` (the
    extension and finalize kernels on ``cuda``, their plain versions on
    ``cpu``); force_host keeps both steps on the native host kernels.  On
    a CUDA device the native host library must load (else this raises).
    index: a prebuilt k-mer index of ref_fa (its k must be min_seed_len).
    Returns {"stages_s": wall seconds per stage, "aligner": the
    BatchAligner, "dispatch": each end's last_dispatch}."""
    device = torch.device(device)
    stages = {}
    from ..io import native
    with trace.driver_pass(stages, "total"):
        with trace.span("seeksv.stage.native", stages, "native"):
            if device.type == "cuda" and not native.available():
                raise RuntimeError(
                    "the native host library did not build or load; the "
                    f"CUDA path needs it: {native.LOAD_ERROR}")
        with trace.span("seeksv.stage.index", stages, "index"):
            if index is None:
                index = Aligner.from_fasta(ref_fa, k=min_seed_len).idx
            aligner = BatchAligner(index, device=device)
        with trace.span("seeksv.stage.read_fq", stages, "read_fq"):
            names1, seqs1, quals1 = _read_named_fastq(fq1)
            names2, seqs2, quals2 = _read_named_fastq(fq2)
            if len(seqs1) != len(seqs2):
                raise ValueError(f"paired fastqs differ in length: "
                                 f"{len(seqs1)} vs {len(seqs2)}")
        dispatch = []   # each end's last_dispatch (None: no extension job)
        with trace.span("seeksv.stage.align", stages, "align"):
            ends = []
            for seqs in (seqs1, seqs2):
                aligner.last_dispatch = None
                ends.append(aligner.batch_align(seqs, force_host=force_host))
                dispatch.append(aligner.last_dispatch)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        with trace.span("seeksv.stage.write_sam", stages, "write_sam"):
            _write_paired_sam(aligner, out_sam, (names1, names2),
                              (seqs1, seqs2), (quals1, quals2), ends, times)
    return {"stages_s": stages, "aligner": aligner, "dispatch": dispatch}


def _pair_isize(x: Alignment, y: Alignment):
    """FR insert size (fragment length) or None if not FR/same-tid."""
    if not (x.mapped and y.mapped) or x.tid != y.tid:
        return None
    fwd, rev = (x, y) if x.strand == 0 else (y, x)
    if fwd.strand != 0 or rev.strand != 1:
        return None
    end = rev.pos + _ref_span_of(rev.cigar)
    isz = end - fwd.pos
    return isz if isz > 0 and fwd.pos <= rev.pos else None


def _write_paired_sam(aligner, out_sam: str, names, seqs, quals, ends,
                      times: int) -> None:
    """The paired SAM of align_paired_fastq_to_sam: the insert-size model
    from FR both-mapped pairs, then both ends' records with pair flags
    and mate fields."""
    names1, names2 = names
    seqs1, seqs2 = seqs
    quals1, quals2 = quals
    a1, a2 = ends
    ins = [v for v in (_pair_isize(x, y) for x, y in zip(a1, a2))
           if v is not None]
    if ins:
        mean = int(sum(ins) // len(ins))
        dev = int(math.sqrt(sum((v - mean) ** 2 for v in ins) / len(ins)))
    else:
        mean, dev = 0, 0
    lo, hi = max(0, mean - times * dev), mean + times * dev

    with open(out_sam, "w") as out:
        out.write("@HD\tVN:1.5\tSO:unsorted\n")
        for name, ln in zip(aligner.idx.chrom_names,
                            np.diff(aligner.idx.chrom_starts)):
            out.write(f"@SQ\tSN:{name}\tLN:{int(ln)}\n")
        out.write("@PG\tID:seeksv-tpu-aln\tPN:seeksv-tpu\n")
        for i in range(len(seqs1)):
            x, y = a1[i], a2[i]
            isz = _pair_isize(x, y)
            proper = isz is not None and lo <= isz <= hi and ins
            for (qn, seq, qual, a, mate, first) in (
                    (names1[i], seqs1[i], quals1[i], x, y, True),
                    (names2[i], seqs2[i], quals2[i], y, x, False)):
                flag = 0x1 | (0x40 if first else 0x80)
                if proper:
                    flag |= 0x2
                if not a.mapped:
                    flag |= 0x4
                if not mate.mapped:
                    flag |= 0x8
                if a.mapped and a.strand:
                    flag |= 0x10
                if mate.mapped and mate.strand:
                    flag |= 0x20
                seq_s = seq.decode()
                qual_s = qual
                if a.mapped and a.strand:
                    seq_s = bytes(
                        _RC[np.frombuffer(seq, np.uint8)][::-1]).decode()
                    qual_s = qual[::-1]
                rname = aligner.idx.chrom_names[a.tid] if a.mapped else "*"
                pos = a.pos + 1 if a.mapped else 0
                if mate.mapped:
                    rnext = ("=" if (a.mapped and mate.tid == a.tid)
                             else aligner.idx.chrom_names[mate.tid])
                    pnext = mate.pos + 1
                else:
                    rnext, pnext = "*", 0
                tlen = 0
                if isz is not None:
                    fwd_first = a.mapped and a.strand == 0
                    tlen = isz if fwd_first else -isz
                mapq = a.mapq if a.mapped else 0
                cig = _cigar_str(a.cigar) if a.mapped else "*"
                tags = (f"\tNM:i:{a.nm}\tAS:i:{a.score}" if a.mapped else "")
                out.write(f"{qn}\t{flag}\t{rname}\t{pos}\t{mapq}\t{cig}\t"
                          f"{rnext}\t{pnext}\t{tlen}\t{seq_s}\t{qual_s}"
                          f"{tags}\n")


def align_fastq_to_sam(ref_fa: str, reads_fq: str, out_sam: str,
                       min_seed_len: int = MIN_SEED_LEN) -> None:
    """CLI entry: align a fastq(.gz) of clipped sequences, emit SAM in
    input order (the order contract the getsv co-iteration relies on).
    One read a call of the host Aligner.align, as in the reference."""
    aligner = Aligner.from_fasta(ref_fa, k=min_seed_len)
    opener = gzip.open if reads_fq.endswith(".gz") else open
    with opener(reads_fq, "rt") as f, open(out_sam, "w") as out:
        out.write("@HD\tVN:1.5\tSO:unsorted\n")
        for name, ln in zip(aligner.idx.chrom_names,
                            np.diff(aligner.idx.chrom_starts)):
            out.write(f"@SQ\tSN:{name}\tLN:{int(ln)}\n")
        out.write("@PG\tID:seeksv-tpu-aln\tPN:seeksv-tpu\n")
        while True:
            h = f.readline()
            if not h:
                break
            seq = f.readline().strip()
            f.readline()
            qual = f.readline().strip()
            qname = h[1:].split()[0]
            a = aligner.align(seq.encode())
            if not a.mapped:
                out.write(f"{qname}\t4\t*\t0\t0\t*\t*\t0\t0\t{seq}\t{qual}\n")
                continue
            flag = 16 if a.strand else 0
            oseq, oqual = seq, qual
            if a.strand:
                oseq = bytes(_RC[np.frombuffer(seq.encode(), np.uint8)][::-1]).decode()
                oqual = qual[::-1]
            out.write(f"{qname}\t{flag}\t{aligner.idx.chrom_names[a.tid]}\t"
                      f"{a.pos + 1}\t{a.mapq}\t{_cigar_str(a.cigar)}\t*\t0\t0\t"
                      f"{oseq}\t{oqual}\tNM:i:{a.nm}\tAS:i:{a.score}\n")
            for s in (a.supp or []):
                sseq, sq = oseq, oqual
                if s.strand != a.strand:
                    sseq = bytes(_RC[np.frombuffer(
                        sseq.encode(), np.uint8)][::-1]).decode()
                    sq = sq[::-1]
                out.write(
                    f"{qname}\t{2048 | (16 if s.strand else 0)}\t"
                    f"{aligner.idx.chrom_names[s.tid]}\t{s.pos + 1}\t"
                    f"{s.mapq}\t{_cigar_str(s.cigar)}\t*\t0\t0\t"
                    f"{sseq[s.qb:s.qe]}\t{sq[s.qb:s.qe]}\t"
                    f"NM:i:{s.nm}\tAS:i:{s.score}\n")
