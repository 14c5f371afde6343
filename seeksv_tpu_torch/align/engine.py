"""The batched aligner on a torch device.

Counterpart of ``seeksv_tpu/align/engine.py:BatchAligner``.  Seeding,
host ranking, ``_select_parts``, ``_parts_to_alignments`` and ``_mapq``
are inherited unchanged; what differs is where the two device steps run:

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

Dispatch: no H100 crossover has been measured yet, so every extension
batch and every eligible finalize job goes to the device (crossover 0,
share 1.0).  ``force_host=True`` keeps both steps on the native host
kernels, as in the reference.  A device failure raises.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from seeksv_tpu.align.engine import (ENCODE, MIN_SEED_LEN, PEN_CLIP, SCORE_T,
                                     Aligner, Alignment, BatchAligner)
from seeksv_tpu.align.index import KmerIndex

from ..ops.global_device import TorchDeviceGlobalAligner
from ..ops.seed_device import OVERFLOW, TorchDeviceSeeder, hit_cap_ladder

# Dispatch constants until an H100 calibration exists: every batch and
# every eligible finalize job goes to the device.
MIN_DEVICE_CELLS = 0
MIN_DEVICE_FINALIZE_CELLS = 0
FINALIZE_DEVICE_SHARE = 1.0

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


class TorchBatchAligner(BatchAligner):
    """BatchAligner whose device steps run on an explicit torch device
    (``cuda`` launches the CUDA kernels; ``cpu`` runs their plain
    versions, for tests)."""

    def __init__(self, index: KmerIndex, device="cuda",
                 device_seed: bool = False, device_align: bool = False):
        super().__init__(index, device_seed=device_seed,
                         device_align=device_align)
        self.device = torch.device(device)
        self._dga: Optional[TorchDeviceGlobalAligner] = None

    @classmethod
    def from_fasta(cls, path: str, k: int = MIN_SEED_LEN, cache: bool = True,
                   device="cuda", **flags) -> "TorchBatchAligner":
        return cls(Aligner.from_fasta(path, k=k, cache=cache).idx,
                   device=device, **flags)

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
        from seeksv_tpu.align.seed_batch import batch_candidates
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
        """BatchAligner.batch_align with the device branch on torch.
        force_device is accepted for the shared driver's signature; the
        device is always chosen unless force_host is set (force_host moves
        the extension and the finalize to the host; the device_seed and
        device_align front-ends run on the device all the same, as in the
        reference)."""
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
            # the whole front-end on the device (engine.py:569-589)
            t0 = time.perf_counter()
            dres = self._device_aligner().align_jobs(strand_reads)
            self.timings["device_extend_s"] += time.perf_counter() - t0
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
                                  results_by_read, force_host)
        t0 = time.perf_counter()
        out = self._finalize_many(per_read_codes, seqs, results_by_read,
                                  force_device=force_device,
                                  force_host=force_host)
        self.timings["finalize_s"] += time.perf_counter() - t0
        return out

    def _seed_and_extend(self, strand_reads, per_read_codes, results_by_read,
                         force_host: bool) -> None:
        """Seeding (on the host, or on the device with device_seed), then
        both extension rounds (engine.py:590-808)."""
        from seeksv_tpu.align.seed_batch import batch_candidates
        idx = self.idx
        t0 = time.perf_counter()
        if self.device_seed:
            cands = self._device_candidates(strand_reads)
        else:
            cands = batch_candidates(idx, strand_reads)
        self.timings["seed_s"] += time.perf_counter() - t0
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
                              force_host)

    def _extend_jobs(self, jobs, per_read_codes, results_by_read,
                     force_host: bool) -> None:
        """Both extension rounds and the clip/extend decisions for every
        job (the reference's engine.py:607-808 with the device branch on
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
        use_host = force_host   # crossover 0: every batch on the device
        self.last_dispatch = {
            "est_actual_cells": est_cells,
            "crossover_cells": MIN_DEVICE_CELLS,
            "finalize_crossover_cells": MIN_DEVICE_FINALIZE_CELLS,
            "finalize_device_share": FINALIZE_DEVICE_SHARE,
            "device": str(self.device),
            "forced": "host" if force_host else None,
            "chose_device": not use_host,
            "n_jobs": n_jobs, "LQ": LQ, "LT": LT,
        }
        if use_host:
            run = self._host_round(idx, LT)
        else:
            run = self._device_round(LQ, LT)
        t_ext = time.perf_counter()
        left = run(lq, lqlen, lstart, ltlen, h0, True)
        qb = np.zeros(n_jobs, np.int64)
        rb = np.zeros(n_jobs, np.int64)
        h0r = np.zeros(n_jobs, np.int32)
        for k, (ri, strand, n, ref_anchor, q_start, anchor_len, tid) in \
                enumerate(meta):
            h0r[k] = left["max_score"][k]  # bwa sc0 semantics
            if (left["gscore"][k] <= 0
                    or left["gscore"][k] <= left["max_score"][k] - PEN_CLIP):
                qb[k] = q_start - left["qle"][k]
                rb[k] = ref_anchor - left["tle"][k]
            else:
                qb[k] = 0
                rb[k] = ref_anchor - left["gtle"][k]
        right = run(rq, rqlen, rstart, rtlen, h0r, False)
        self.timings["host_extend_s" if use_host else "device_extend_s"] += \
            time.perf_counter() - t_ext
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

    @staticmethod
    def _host_round(idx, LT: int):
        """The reference's host path: windows cut from the genome on the
        host, native C++ kernel when built, numpy mirror otherwise."""
        from seeksv_tpu.io import native
        if native.sw_available():
            kernel = native.sw_extend_batch_native
        else:
            from seeksv_tpu.align.sw import extend_batch_np as kernel

        def run(q, qlen, tstart, tlen, h0, reverse):
            t = np.full((len(q), LT), 4, np.int8)
            for k in range(len(q)):
                s, ln = int(tstart[k]), int(tlen[k])
                if ln <= 0:
                    continue
                if reverse:
                    t[k, :ln] = idx.ref[s - ln + 1:s + 1][::-1]
                else:
                    t[k, :ln] = idx.ref[s:s + ln]
            return kernel(q.view(np.int8), qlen, t, tlen, h0)
        return run

    def _device_finalize_plan(self, qs, ts, force_device: bool):
        """Every eligible long-fragment job goes to the device
        (finalize crossover 0, share 1.0)."""
        if self._dga is None:
            self._dga = TorchDeviceGlobalAligner(self.device)
        dga = self._dga
        elig = [x for x in range(len(qs))
                if dga.eligible(len(qs[x]), len(ts[x]))]
        return (dga, elig) if elig else (None, [])

    def _finalize_many(self, per_read_codes, seqs, results_by_read,
                       force_device: bool = False,
                       force_host: bool = False) -> List[Alignment]:
        """BatchAligner._finalize_many with the device jobs on torch: the
        device thread runs beside the native host ladder, and an
        exception in it is raised here after the join (no silent host
        rerun).  Without the native host library the reference's per-read
        host finalize runs, on the CPU device or with force_host only: a
        CUDA device raises rather than leave its kernels unused."""
        from seeksv_tpu.io import native
        if not native.sw_global_batch_available():
            if self.device.type == "cuda" and not force_host:
                raise RuntimeError(
                    "device finalize needs the native host library "
                    "(csrc/libseeksv_native.so), which did not load")
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
            def _run_dev():
                t0 = time.perf_counter()
                try:
                    r = dga.align_batch([qs[x] for x in dev_rows],
                                        [ts[x] for x in dev_rows])
                    dev_res.update((dev_rows[i], v) for i, v in r.items())
                except Exception as exc:   # raised below, after the join
                    failure.append(exc)
                finally:
                    self.timings["device_finalize_s"] += (
                        time.perf_counter() - t0)
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
