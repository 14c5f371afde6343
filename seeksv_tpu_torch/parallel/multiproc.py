"""The multi-process pipeline and tumor/normal subtraction on
torch.distributed: one process a rank, each decoding only its own part of
the BAM.

Counterpart of ``seeksv_tpu/parallel/multiproc.py`` (its docstring gives
the design), with ``process_allgather`` (``parallel/mesh.py``) in place of
``jax.experimental.multihost_utils.process_allgather`` and the rank of the
default process group in place of ``jax.process_index()``.  The chain:
host-sharded BAM ingest -> per-rank getclip segments -> boundary-group
exchange -> per-rank realignment on the rank's own device -> encoded
junction-event all-gather with global clip-order sort keys -> partitioned
merge -> multi-process coverage + insert size -> owner-local discordant
counting -> rank 0 writes the sv file, byte-equal to the sequential
pipeline's.

Sharding is by genome position range: the concatenated genome is cut into
one contiguous flat range a rank, so a single-chromosome input scales
too.  Sub-chromosome cuts stay exact because records are ingested with a
flat-position halo each side, clip events go to exactly one owner by
breakpoint position (``GetclipStream(own_range=...)``), equal adjacent
clip groups that straddle a seam move to the former's owner before
realignment (``_exchange_boundary_groups``), the gathered junction events
carry (tid, side, pos, rank, group, event) keys and are replayed in the
sequential order, and each discordant window is counted by the owner of
its junction's up position.  The somatic forms cut the normal BAM the
same way (by flat range with a clip-line halo round each cut, or by
chromosome) and sum each tumor row's (nleft, nright, nab) over the ranks.

Every rank calls each entry point with the same arguments and enters
every collective in the same order: each branch around one is decided on
a value every rank holds (a gathered size or count).  Each rank reads and
writes its own ``{prefix}.p{rank}`` working files beside the prefix, so
the ranks share one filesystem; rank 0 writes the outputs.  On a NCCL
mesh each rank needs a card of its own (NCCL refuses two ranks on one
device); gloo ranks run on the CPU.
"""
from __future__ import annotations

import gzip
import io
import pickle
import shutil
import time
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..align.engine import Aligner, BatchAligner
from ..align.index import KmerIndex
from ..io.bam import BamRecords, concat_records, read_bam_chunks, slice_records
from ..pipeline.driver import native_stage, realign_clips
from ..pipeline.getclip import GetclipStream
from ..pipeline.getsv import (DepthQuery, DiscordantCounter, JunctionMap,
                              SV_HEADER, insert_junction_event,
                              iter_soft_groups, junction_event,
                              output_breakpoints)
from ..pipeline.somatic import somatic, somatic_filter
from .mesh import (mesh_device, process_allgather,
                   process_allgather_ragged)
from .spmd_pipeline import (_EncodedEvents, _decode_event, _encode_events,
                            merge_junction_sharded,
                            multiprocess_coverage_insert)

_ENC_FIELDS = ("key", "useq", "dseq", "ulen", "dlen", "ucig", "dcig",
               "meta", "valid")


class _Stages:
    """Wall seconds per stage into a caller's dict: lap(name) closes the
    stage that began at the last lap."""

    def __init__(self, stages: Optional[dict]):
        self.stages = {} if stages is None else stages
        self.t0 = self.t = time.perf_counter()

    def lap(self, name: str) -> None:
        now = time.perf_counter()
        self.stages[name] = now - self.t
        self.t = now

    def total(self) -> None:
        self.stages["total"] = time.perf_counter() - self.t0


def _tid_bounds(n_ref: int, nproc: int, pid: int):
    lo = pid * n_ref // nproc
    hi = (pid + 1) * n_ref // nproc
    return lo, hi


def ingest_local(bam: str, pid: int, nproc: int,
                 chunk_records: int = 500_000) -> Optional[BamRecords]:
    """Streaming decode keeping only this rank's chromosome range
    (contiguous tids; unplaced tid=-1 records go to the last rank).
    Slabs outside the range are dropped at once: bounded memory, no
    global data visibility."""
    parts: List[BamRecords] = []
    n_ref = None
    for c in read_bam_chunks(bam, chunk_records):
        if n_ref is None:
            n_ref = len(c.ref_names)
            lo, hi = _tid_bounds(n_ref, nproc, pid)
        t = np.asarray(c.tid)
        own = (t >= lo) & (t < hi)
        if pid == nproc - 1:
            own |= t < 0
        # coordinate-sorted: the owned records form one contiguous run;
        # fail loudly (not silently double-count) on an unsorted BAM
        idx = np.nonzero(own)[0]
        if len(idx):
            if not own[int(idx[0]):int(idx[-1]) + 1].all():
                raise ValueError(
                    "BAM is not coordinate-grouped by tid: owned records "
                    "are non-contiguous; multiprocess chromosome sharding "
                    "requires a coordinate-sorted input")
            parts.append(slice_records(c, int(idx[0]), int(idx[-1]) + 1))
    if not parts:
        return None
    return concat_records(parts)


HALO_FLAT = 100_000   # flat-genome halo: >= any discordant window
BIGPOS = 1 << 62


def _flat_offsets(ref_lens) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(np.asarray(ref_lens, np.int64))])


def ingest_local_range(bam: str, pid: int, nproc: int,
                       chunk_records: int = 500_000, halo: int = HALO_FLAT):
    """Streaming decode keeping this rank's contiguous flat-genome range
    [lo, hi) PLUS a halo each side (discordant windows and boundary clip
    evidence reach across cuts); unplaced tid=-1 records go to the last
    rank.  Returns (local_records_with_halo, (own_a, own_b) owned-record
    index range within them, ref_names, ref_lens, flat_offsets, lo,
    hi)."""
    parts: List[BamRecords] = []
    offs = None
    ref_names = None
    ref_lens = None
    G = lo = hi = 0
    for c in read_bam_chunks(bam, chunk_records):
        if offs is None:
            ref_names, ref_lens = c.ref_names, list(c.ref_lens)
            offs = _flat_offsets(ref_lens)
            G = int(offs[-1])
            lo = pid * G // nproc
            hi = (pid + 1) * G // nproc
        t = np.asarray(c.tid)
        flat = np.where(t >= 0,
                        offs[np.clip(t, 0, len(ref_lens) - 1)]
                        + np.asarray(c.pos, np.int64), np.int64(G))
        keep = (flat >= lo - halo) & (flat < hi + halo) & (t >= 0)
        if pid == nproc - 1:
            keep |= t < 0
        idx = np.nonzero(keep)[0]
        if len(idx):
            if not keep[int(idx[0]):int(idx[-1]) + 1].all():
                raise ValueError(
                    "BAM is not coordinate-sorted: this rank's range "
                    "is non-contiguous in file order")
            parts.append(slice_records(c, int(idx[0]), int(idx[-1]) + 1))
    if offs is None:
        raise ValueError("empty BAM")
    local = concat_records(parts) if parts else None
    own_a = own_b = 0
    if local is not None:
        t = np.asarray(local.tid)
        flat = np.where(t >= 0,
                        offs[np.clip(t, 0, len(ref_lens) - 1)]
                        + np.asarray(local.pos, np.int64), np.int64(G))
        own = (flat >= lo) & (flat < hi) & (t >= 0)
        if pid == nproc - 1:
            own |= t < 0
        oi = np.nonzero(own)[0]
        if len(oi):
            own_a, own_b = int(oi[0]), int(oi[-1]) + 1
    return local, (own_a, own_b), ref_names, ref_lens, offs, lo, hi


def _bp_own_ranges(offs, ref_lens, lo, hi, pid, nproc):
    """Owned breakpoint-position intervals per tid, in the 1-based
    clip.gz coordinate; intervals touching a true chromosome edge are
    extended to infinity so edge-spilling breakpoints keep one owner."""
    out = []
    for t in range(len(ref_lens)):
        s = max(lo, int(offs[t]))
        e = min(hi, int(offs[t + 1]))
        if s >= e:
            continue
        lo_bp = (s - int(offs[t])) + 1 if s > int(offs[t]) else -BIGPOS
        hi_bp = (e - int(offs[t])) + 1 if e < int(offs[t + 1]) else BIGPOS
        out.append((t, lo_bp, hi_bp))
    if pid == nproc - 1:
        out.append((-1, -BIGPOS, BIGPOS))
    return out


def _parse_clip_fq(part):
    with gzip.open(f"{part}.clip.gz", "rb") as f:
        clip_lines = f.read().splitlines(keepends=True)
    with gzip.open(f"{part}.clip.fq.gz", "rb") as f:
        raw = f.read().splitlines(keepends=True)
    fq = [raw[i:i + 4] for i in range(0, len(raw), 4)]
    return clip_lines, fq


def _allgather_blobs(mesh, blob: bytes) -> List[bytes]:
    """Every rank's byte string, in rank order."""
    return [a.tobytes() for a in process_allgather_ragged(
        mesh, np.frombuffer(blob, np.uint8))]


def _exchange_boundary_groups(mesh, part, name2id, pid, log):
    """ADJACENT clip.gz groups with EQUAL clipped seqs merge in the
    sequential co-iteration (getsv.h:472-509: groups are maximal runs of
    equal adjacent seqs).  The sequential file orders each tid as [all 5'
    sections across owners, then all 3'], so a merged group can straddle
    a section seam between ranks; this step MOVES the latter group's
    clip.gz lines + clip.fq records to the former's owner (appended at
    its section end) before realignment, making the owner's local
    co-iteration see exactly the sequential merged group.  A section
    emptied by its move keeps the upstream section as the comparison
    target, so chains of equal single-group sections resolve to the first
    owner.  Returns (initial_last, seam_overrides) for
    iter_soft_groups."""
    clip_lines, fq = _parse_clip_fq(part)
    seqs = [ln.split(b"\t")[6] for ln in clip_lines]
    # greedy fq<->line pairing by clipped seq (lines may lack fq records)
    fq_of_line = [-1] * len(clip_lines)
    fi = 0
    for li in range(len(clip_lines)):
        if fi < len(fq) and fq[fi][1].rstrip(b"\n") == seqs[li]:
            fq_of_line[li] = fi
            fi += 1
    # sections in file order: one (tid, side) per flush side
    secs = []   # [tid, side, start, end)
    for i, ln in enumerate(clip_lines):
        f = ln.split(b"\t")
        m = (name2id[f[0].decode()], 0 if f[2] == b"5" else 1)
        if not secs or (secs[-1][0], secs[-1][1]) != m:
            secs.append([m[0], m[1], i, i + 1])
        else:
            secs[-1][3] = i + 1
    my = []
    for tid, side, a, b in secs:
        g_end = a
        while g_end < b and seqs[g_end] == seqs[a]:
            g_end += 1
        pay_lines = b"".join(clip_lines[a:g_end])
        pay_fq = b"".join(b"".join(fq[fq_of_line[i]])
                          for i in range(a, g_end) if fq_of_line[i] >= 0)
        my.append({"tid": tid, "side": side, "first_seq": seqs[a],
                   "last_seq": seqs[b - 1], "n_lines": b - a,
                   "g_lines": g_end - a, "pay_lines": pay_lines,
                   "pay_fq": pay_fq})
    allsecs = []
    # the blobs were pickled by this program's own ranks
    for p, blob in enumerate(_allgather_blobs(mesh, pickle.dumps(my))):
        for s in pickle.loads(blob):
            s["pid"] = p
            allsecs.append(s)
    # global sequential order of sections
    allsecs.sort(key=lambda s: (s["tid"], s["side"], s["pid"]))
    moves = []   # (src_pid, src_tid, src_side, dst_pid, dst_tid, dst_side)
    # predecessor seq per section (the seq of the nearest upstream
    # non-emptied section AFTER moves): seeds the co-iteration odd-key
    # quirk at segment/section seams (iter_soft_groups seam_overrides)
    pred_of = {}
    prev = None
    for s in allsecs:
        if s["n_lines"] == 0:
            continue
        pred_of[(s["pid"], s["tid"], s["side"])] = (
            prev["last_seq"] if prev is not None else None)
        if (prev is not None and prev["last_seq"] == s["first_seq"]
                and s["first_seq"]):
            moves.append((s["pid"], s["tid"], s["side"],
                          prev["pid"], prev["tid"], prev["side"],
                          s["pay_lines"], s["pay_fq"]))
            if s["g_lines"] == s["n_lines"]:
                continue   # emptied: upstream stays the merge target
        prev = s

    def _my_seams():
        """(initial_last, seam_overrides) from the CURRENT on-disk files
        (post-move when moves applied)."""
        lines2, _fq2 = _parse_clip_fq(part)
        # seam_overrides are consumed by iter_soft_groups keyed on ITS
        # data-line counter, which whitespace-splits and skips lines
        # with <9 fields: mirror that parse exactly here, or any
        # skipped/collapsed line desynchronizes the two indices and a
        # seam override lands on the wrong group (ADVICE r4).
        starts = []   # (iter_soft_groups li, tid, side)
        li2 = -1
        for ln in lines2:
            f = ln.split()
            if len(f) < 9:
                continue
            li2 += 1
            m = (name2id[f[0].decode()], 0 if f[2] == b"5" else 1)
            if not starts or (starts[-1][1], starts[-1][2]) != m:
                starts.append((li2, m[0], m[1]))
        initial_last = None
        overrides = {}
        for k, (i, tid, side) in enumerate(starts):
            p = pred_of.get((pid, tid, side))
            if p is None:
                continue
            if k == 0:
                initial_last = p
            else:
                overrides[i] = p
        return initial_last, overrides

    # every rank gathered every section, so every rank sees the same moves
    if not moves:
        return _my_seams()
    log(f"[p{pid}] boundary-group exchange: {len(moves)} group move(s)")
    # apply removals (src == me) then insertions (dst == me)
    drop_lines = set()
    drop_fq = set()
    for (sp, st_, ss, dp, dt, ds, _pl, _pf) in moves:
        if sp != pid:
            continue
        for tid, side, a, b in secs:
            if (tid, side) == (st_, ss):
                g_end = a
                while g_end < b and seqs[g_end] == seqs[a]:
                    g_end += 1
                for i in range(a, g_end):
                    drop_lines.add(i)
                    if fq_of_line[i] >= 0:
                        drop_fq.add(fq_of_line[i])
    ins_at_line: dict = {}
    ins_at_fq: dict = {}
    for (sp, st_, ss, dp, dt, ds, pl, pf) in moves:
        if dp != pid:
            continue
        for tid, side, a, b in secs:
            if (tid, side) == (dt, ds):
                ins_at_line.setdefault(b, []).append(pl)
                # fq insert after the last paired fq of the section
                last_fq = max((fq_of_line[i] for i in range(a, b)
                               if fq_of_line[i] >= 0), default=-1)
                ins_at_fq.setdefault(last_fq + 1, []).append(pf)
    out_lines = []
    for i, ln in enumerate(clip_lines):
        for pl in ins_at_line.get(i, ()):
            out_lines.append(pl)
        if i not in drop_lines:
            out_lines.append(ln)
    for pl in ins_at_line.get(len(clip_lines), ()):
        out_lines.append(pl)
    out_fq = []
    for i in range(len(fq) + 1):
        for pf in ins_at_fq.get(i, ()):
            out_fq.append(pf)
        if i < len(fq) and i not in drop_fq:
            out_fq.append(b"".join(fq[i]))
    with gzip.open(f"{part}.clip.gz", "wb", compresslevel=1) as f:
        f.write(b"".join(out_lines))
    with gzip.open(f"{part}.clip.fq.gz", "wb", compresslevel=1) as f:
        f.write(b"".join(out_fq))
    return _my_seams()


def multiprocess_run_pipeline(mesh, ref_fa: str, bam: str, prefix: str, *,
                              min_mapq: int = 20,
                              read_pair_used: int = 5_000_000,
                              chunk_records: int = 500_000,
                              log=lambda *a: None,
                              index: Optional[KmerIndex] = None,
                              stages: Optional[dict] = None
                              ) -> Optional[str]:
    """The full pipeline across the ranks of the default process group
    with genome-position-range sharding (module docstring).  Each rank
    realigns its own clips with ``realign_clips`` on its own device
    (``mesh_device(mesh)``: the card under NCCL, the CPU under gloo).
    index: a prebuilt k-mer index of ref_fa (else built or loaded from
    the cache).  stages: a dict that receives this rank's wall seconds
    per stage.  Writes ``{prefix}.sv`` and ``{prefix}.unmapped.clip.fq``
    on rank 0 and returns the sv path there, None on the other ranks."""
    pid = dist.get_rank()
    nproc = dist.get_world_size()
    dev = mesh_device(mesh)
    clock = _Stages(stages)
    native_stage(dev, clock.stages)
    clock.lap("native")

    # 1. host-sharded ingest: contiguous flat-genome range + halos
    (local, (own_a, own_b), ref_names, ref_lens, offs, lo,
     hi) = ingest_local_range(bam, pid, nproc, chunk_records)
    log(f"[p{pid}] local records: {local.n if local else 0} "
        f"(owned {own_b - own_a}), flat range [{lo}, {hi})")
    name2id = {n: i for i, n in enumerate(ref_names)}
    clock.lap("ingest")

    # 2. per-rank getclip over halo'd records, with clip EVENTS assigned
    # to exactly one owner by breakpoint position.  GetclipStream's
    # last_tid starts at 0, so a rank whose first seen tid is c>0
    # reproduces the sequential flush+drop quirk at the 0->c transition
    # exactly (clip_reads.h:423-438).
    part = f"{prefix}.p{pid}"
    gs = GetclipStream(part, own_range=_bp_own_ranges(
        offs, ref_lens, lo, hi, pid, nproc))
    if local is not None:
        gs.process(local)
    gs.close()
    clock.lap("getclip")

    # 3. boundary-group exchange BEFORE realignment, so merged groups
    # straddling a seam realign (and co-iterate) wholly at one owner;
    # also yields the seam predecessor seqs that seed the co-iteration
    # odd-key quirk at section starts
    initial_last, seam_overrides = _exchange_boundary_groups(
        mesh, part, name2id, pid, log)
    clock.lap("exchange")

    # 4. per-rank realignment of its own (possibly amended) segment
    if index is None:
        index = Aligner.from_fasta(ref_fa).idx
    aligner = BatchAligner(index, device=dev)
    realign_clips(ref_fa, f"{part}.clip.fq.gz", f"{part}.clip.sam",
                  aligner=aligner)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    log(f"[p{pid}] getclip+realign done")
    clock.lap("realign")

    # 5. local junction events, tagged with GLOBAL clip-order sort keys
    # (tid, side, pos, pid, group_ordinal, event_ordinal): the
    # sequential clip.gz interleaves ranks within a chromosome ([all 5'
    # by pos, then all 3']), so the gathered event stream is replayed in
    # that order, which only the keys can reconstruct
    events = []
    sort_keys = []
    rescue_events = []
    gidx = 0
    for ari, orient, cais in iter_soft_groups(
            f"{part}.clip.gz", f"{part}.clip.sam", 0,
            initial_last=initial_last, seam_overrides=seam_overrides):
        gkey = (name2id.get(ari.chr, len(ref_names)),
                0 if orient == "5" else 1, ari.pos, pid, gidx)
        gidx += 1
        for k, cai in enumerate(cais):
            ev = junction_event(ari, orient, cai, False)
            if ev is None:
                continue
            if ev[0] == "rescue":
                rescue_events.append((ev[1], ev[2]))
            else:
                events.append(ev[1:])
                sort_keys.append(gkey + (k,))
    log(f"[p{pid}] {len(events)} junction events")

    # 6. encoded junction-event all-gather across ranks (the
    # _EncodedEvents wire format + the sort-key table; chromosome ids
    # come from the BAM header so every rank encodes identically)
    name2id.setdefault("Exogenous", len(name2id))
    id2name = list(name2id)
    dims = np.asarray([
        max(len(events), 1),
        max((max(len(u.seq), len(d.seq)) for (_j, u, d) in events),
            default=1),
        max((max(len(u.cigar), len(d.cigar), 1) for (_j, u, d) in events),
            default=1)], np.int64)
    all_dims = process_allgather(mesh, dims)
    E, LS, C = (int(all_dims[:, k].max()) for k in range(3))
    enc = _encode_events(events, name2id, E, LS, C)
    keys_arr = np.full((E, 6), np.int64(1 << 60), np.int64)
    if sort_keys:
        keys_arr[:len(sort_keys)] = np.asarray(sort_keys, np.int64)
    gathered = {a: process_allgather(mesh, getattr(enc, a))
                for a in _ENC_FIELDS}
    gkeys = process_allgather(mesh, keys_arr)

    # 7. replay in GLOBAL sequential clip.gz order (sort-key order: per
    # tid all 5' groups position-ascending, then all 3') -> ordered
    # junction multimap; partitioned merge
    jmap = JunctionMap()
    gencs = [_EncodedEvents(**{a: gathered[a][p] for a in _ENC_FIELDS})
             for p in range(nproc)]
    flat_keys = gkeys.reshape(nproc * E, 6)
    order = np.lexsort(tuple(flat_keys[:, c]
                             for c in range(5, -1, -1)))
    for fi in order:
        p, i = divmod(int(fi), E)
        if gencs[p].valid[i]:
            j, up, down = _decode_event(gencs[p], i, id2name)
            insert_junction_event(jmap, j, up, down)
    merge_junction_sharded(jmap, 50)
    log(f"[p{pid}] merged junction table: {len(jmap.items)}")
    clock.lap("junctions")

    # 8. insert-size + coverage across ranks: OWNED records only (halo
    # records would double-count); first-N order = flat order
    if local is None or own_b <= own_a:
        # contribute empty shards (the collectives still need every
        # rank); the reference dictionary must match every other rank's
        # so the genome-flat offsets agree
        local_for_cov = _empty_records(ref_names, ref_lens)
    else:
        local_for_cov = slice_records(local, own_a, own_b)
    cov, mean, dev_ = multiprocess_coverage_insert(mesh, local_for_cov,
                                                   min_mapq, read_pair_used)
    log(f"[p{pid}] insert: mean={mean} dev={dev_}")
    clock.lap("coverage")

    # 9. discordant pairs: each junction's window lies inside its
    # up-chromosome upstream of up_pos (getsv.cpp:1032-1040), within the
    # ingest halo; the flat-position owner of up_pos counts it against
    # its halo'd local records; counts sum across ranks (each junction
    # counted exactly once)
    junctions = [j for j, _ in jmap.items]
    counts = np.zeros(max(len(junctions), 1), np.int64)
    if local is not None and junctions:
        counter = DiscordantCounter(local, min_mapq, mean, dev_, 4)
        for i, j in enumerate(junctions):
            t = name2id.get(j[0], None)
            if t is None or t >= len(ref_lens):
                flat = 1 << 61   # Exogenous: last rank owns
            else:
                flat = int(offs[t]) + int(j[1]) - 1
            owned = (lo <= flat < hi) or (pid == nproc - 1 and flat >= hi)
            if pid == 0:
                owned |= flat < lo
            if owned:
                counts[i] = counter.count(j)
    total_counts = process_allgather(mesh, counts).sum(axis=0)
    for (j, o), c in zip(jmap.items, total_counts):
        o.abnormal = int(c)
    log(f"[p{pid}] discordant done")

    # 10. gather the rescue fastq payloads (virus-mode re-alignment
    # input, ref OutputOneendUnmapBreakpoint getsv.cpp:1252-1288) to rank
    # 0 in rank order (= the sequential emission order)
    payload = []
    for _pos_key, cr in rescue_events:
        if cr.type == "n":
            payload.append(b"@" + cr.clipped_seq + b"\n" + cr.clipped_seq
                           + b"\n+\n" + cr.clipped_qual + b"\n")
    blobs = _allgather_blobs(mesh, b"".join(payload))
    clock.lap("discordant")

    if pid != 0:
        clock.total()
        return None
    # 11. output on rank 0 (global coverage is replicated)
    depth = DepthQuery(_RefView(ref_names, cov), min_mapq, cov=cov)
    with open(f"{prefix}.sv", "w") as fout:
        fout.write(SV_HEADER + "\n")
        output_breakpoints(jmap, depth, 200, 3, 0, 0.1, 50, 50, 30, 1,
                           fout, io.StringIO(), True, 5, 500)
    with open(f"{prefix}.unmapped.clip.fq", "wb") as fq:
        for blob in blobs:
            fq.write(blob)
    log(f"[p0] wrote {prefix}.sv")
    clock.lap("output")
    clock.total()
    return f"{prefix}.sv"


class _RefView:
    """Minimal recs-like view for DepthQuery when only the reference
    dictionary + coverage are needed."""

    def __init__(self, ref_names, cov):
        self.ref_names = ref_names
        self.ref_lens = [len(cov.get(t, ())) for t in range(len(ref_names))]


def _empty_records(ref_names, ref_lens) -> BamRecords:
    return BamRecords(
        ref_names=list(ref_names), ref_lens=list(ref_lens),
        n=0, flag=np.zeros(0, np.int32), tid=np.zeros(0, np.int32),
        pos=np.zeros(0, np.int32), mapq=np.zeros(0, np.int32),
        mtid=np.zeros(0, np.int32), mpos=np.zeros(0, np.int32),
        isize=np.zeros(0, np.int32), l_qseq=np.zeros(0, np.int32),
        qnames=[], cig=np.zeros(0, np.uint32),
        cig_off=np.zeros(1, np.int64), seq=np.zeros(0, np.uint8),
        qual=np.zeros(0, np.uint8), seq_off=np.zeros(1, np.int64),
        xc=np.zeros(0, np.int32))


SOMATIC_CLIP_HALO = 1024   # flat bp each side of a cut; >= the somatic
                           # probe reach (offset 30 + microhomology
                           # shifts <= 90, somatic.cpp:73-302)


def _somatic_clip_halo(mesh, part, name2id, offs, lo, hi, pid, W):
    """Exchange clip.gz lines near the range cuts: returns the FOREIGN
    lines whose map keys fall in [lo-W, lo) or [hi, hi+W), appended to
    this rank's somatic clip map so any probe anchored in [lo, hi) sees
    every entry its +-W window can reach (first-match semantics then
    equal the sequential global map's).  Keys are whole-owned by one rank
    (clip groups are per-position), so appending foreign lines never
    interleaves entries within a key."""
    with gzip.open(f"{part}.clip.gz", "rb") as f:
        lines = f.read().splitlines(keepends=True)
    send = []
    for ln in lines:
        fl = ln.split()
        if len(fl) < 9:
            continue
        tid = name2id.get(fl[0].decode())
        if tid is None:
            continue
        flat = int(offs[tid]) + int(fl[1])
        if flat < lo + W or flat >= hi - W:
            send.append((flat, ln))
    extras = []
    # the blobs were pickled by this program's own ranks
    for p, blob in enumerate(_allgather_blobs(mesh, pickle.dumps(send))):
        if p == pid:
            continue
        for flat, ln in pickle.loads(blob):
            if (lo - W <= flat < lo) or (hi <= flat < hi + W):
                extras.append((flat, ln))
    extras.sort(key=lambda t: t[0])
    return [ln for _f, ln in extras]


def _sum_triples(mesh, triples: list) -> np.ndarray:
    """The per-row (nleft, nright, nab) triples summed over the ranks."""
    arr = np.asarray(triples, np.int64).reshape(-1, 3) if triples \
        else np.zeros((0, 3), np.int64)
    return process_allgather(mesh, arr).sum(axis=0)


def multiprocess_somatic_range(mesh, normal_bam: str, tumor_sv: str,
                               out_temp: str, out_final: str, prefix: str,
                               *, min_mapq: int = 20,
                               read_pair_used: int = 5_000_000,
                               chunk_records: int = 500_000,
                               log=lambda *a: None,
                               stages: Optional[dict] = None
                               ) -> Optional[str]:
    """Sub-chromosome RANGE-sharded tumor/normal subtraction (the somatic
    analogue of multiprocess_run_pipeline's flat-genome cuts):

    - normal ingest = contiguous flat range + halos (ingest_local_range);
      per-rank getclip with clip events assigned to one owner by
      breakpoint position;
    - clip-line halo exchange (+-SOMATIC_CLIP_HALO around each cut) so a
      probe window straddling a cut still resolves its first match
      against every entry the sequential map holds;
    - each tumor row's LEFT clip probe belongs to the flat owner of
      (up_chr, up_pos), the RIGHT to the owner of (down_chr, down_pos)
      (every probe key lies within +-90+30 of its anchor,
      somatic.cpp:73-302): non-owners zero their side before the sum, so
      each side is counted exactly once and the triple sum stays exact;
    - discordant counts run over OWNED records only (per-record predicate,
      additive across disjoint shards).

    The tumor sv file must be readable by every rank.  stages: a dict
    that receives this rank's wall seconds per stage.  Returns the final
    path on rank 0, None elsewhere."""
    pid = dist.get_rank()
    nproc = dist.get_world_size()
    clock = _Stages(stages)

    (local, (own_a, own_b), ref_names, ref_lens, offs, lo,
     hi) = ingest_local_range(normal_bam, pid, nproc, chunk_records)
    clock.lap("ingest")
    name2id = {n: i for i, n in enumerate(ref_names)}
    part = f"{prefix}.normal.p{pid}"
    gs = GetclipStream(part, own_range=_bp_own_ranges(
        offs, ref_lens, lo, hi, pid, nproc))
    if local is not None:
        gs.process(local)
    gs.close()
    log(f"[p{pid}] normal getclip done "
        f"({local.n if local else 0} records, flat [{lo}, {hi}))")
    clock.lap("getclip")

    extras = _somatic_clip_halo(mesh, part, name2id, offs, lo, hi, pid,
                                SOMATIC_CLIP_HALO)
    # the rank's clip.gz as it is, the foreign lines as one more gzip
    # member: it reads back as the reference's recompressed copy does
    halo_clip = f"{part}.halo.clip.gz"
    shutil.copyfile(f"{part}.clip.gz", halo_clip)
    if extras:
        with gzip.open(halo_clip, "ab", compresslevel=1) as fout:
            fout.writelines(extras)
        log(f"[p{pid}] somatic clip halo: {len(extras)} foreign line(s)")
    clock.lap("halo")

    if local is None or own_b <= own_a:
        owned = _empty_records(ref_names, ref_lens)
    else:
        owned = slice_records(local, own_a, own_b)
    _cov, mean, dev = multiprocess_coverage_insert(mesh, owned, min_mapq,
                                                   read_pair_used)
    log(f"[p{pid}] normal insert: mean={mean} dev={dev}")
    clock.lap("coverage")

    triples: list = []
    somatic(normal_bam, halo_clip, tumor_sv, None,
            recs=owned, mean_dev=(mean, dev),
            read_pair_used=read_pair_used, collect_triples=triples)

    # per-side ownership mask (rows in somatic()'s collection order:
    # non-header lines with >= 23 fields)
    def _owns(chrom: str, pos: int) -> bool:
        tid = name2id.get(chrom)
        if tid is None or tid >= len(ref_lens):
            return pid == nproc - 1     # Exogenous/unknown: last owns
        flat = int(offs[tid]) + pos
        ok = lo <= flat < hi
        if pid == 0:
            ok |= flat < lo
        if pid == nproc - 1:
            ok |= flat >= hi
        return ok

    ri = 0
    opener = gzip.open if tumor_sv.endswith(".gz") else open
    with opener(tumor_sv, "rt") as f:
        for line in f:
            if line.startswith("@"):
                continue
            fl = line.split()
            if len(fl) < 23:
                continue
            nleft, nright, nab = triples[ri]
            if not _owns(fl[0], int(fl[1])):
                nleft = 0
            if not _owns(fl[4], int(fl[5])):
                nright = 0
            triples[ri] = (nleft, nright, nab)
            ri += 1
    if ri != len(triples):
        raise AssertionError("tumor row parse desynced from somatic()")

    total = _sum_triples(mesh, triples)
    log(f"[p{pid}] somatic triples combined ({len(triples)} rows)")
    clock.lap("somatic")

    if pid != 0:
        clock.total()
        return None
    somatic(normal_bam, None, tumor_sv, out_temp,
            use_triples=total, read_pair_used=read_pair_used)
    somatic_filter(out_temp, out_final)
    log(f"[p0] wrote {out_final}")
    clock.lap("output")
    clock.total()
    return out_final


def multiprocess_somatic(mesh, normal_bam: str, tumor_sv: str,
                         out_temp: str, out_final: str, prefix: str, *,
                         min_mapq: int = 20,
                         read_pair_used: int = 5_000_000,
                         chunk_records: int = 500_000,
                         log=lambda *a: None,
                         stages: Optional[dict] = None) -> Optional[str]:
    """Chromosome-sharded tumor/normal subtraction: the normal BAM is
    host-sharded by tid range (ingest_local), each rank runs getclip on
    its own normal range and evaluates every tumor sv row against its
    LOCAL clip maps + records, and the per-row (nleft, nright, nab)
    triples are summed across ranks: each lookup finds nonzero support
    only on the rank owning that normal-range position (clip-map probes
    are single-chromosome windows; the discordant window lies inside the
    up-chromosome, getsv.cpp:1032-1040), so the sum equals the
    sequential pass (ref: somatic.cpp:14-427).  The tumor sv file must be
    readable by every rank.  A rank whose tid range holds no record
    contributes empty shards under the BAM header's dictionary.

    stages: a dict that receives this rank's wall seconds per stage.
    Returns the final somatic path on rank 0, None elsewhere."""
    pid = dist.get_rank()
    nproc = dist.get_world_size()
    clock = _Stages(stages)

    local = ingest_local(normal_bam, pid, nproc, chunk_records)
    clock.lap("ingest")
    part = f"{prefix}.normal.p{pid}"
    gs = GetclipStream(part)
    if local is not None:
        gs.process(local)
    gs.close()
    log(f"[p{pid}] normal getclip done "
        f"({local.n if local else 0} records)")
    clock.lap("getclip")

    if local is None:
        # the reference raises here on the last process only, while the
        # others wait in the next collective; every rank that owns no
        # record reads the header instead (an empty BAM has none on any
        # rank, so every rank raises alike)
        header = next(iter(read_bam_chunks(normal_bam, 1)), None)
        if header is None:
            raise ValueError(f"{normal_bam}: no records")
        local = _empty_records(header.ref_names, list(header.ref_lens))
    # global first-N insert stats across ranks (file order)
    _cov, mean, dev = multiprocess_coverage_insert(mesh, local, min_mapq,
                                                   read_pair_used)
    log(f"[p{pid}] normal insert: mean={mean} dev={dev}")
    clock.lap("coverage")

    triples: list = []
    somatic(normal_bam, f"{part}.clip.gz", tumor_sv, None,
            recs=local, mean_dev=(mean, dev),
            read_pair_used=read_pair_used, collect_triples=triples)
    total = _sum_triples(mesh, triples)
    log(f"[p{pid}] somatic triples combined ({len(triples)} rows)")
    clock.lap("somatic")

    if pid != 0:
        clock.total()
        return None
    somatic(normal_bam, None, tumor_sv, out_temp,
            use_triples=total, read_pair_used=read_pair_used)
    somatic_filter(out_temp, out_final)
    log(f"[p0] wrote {out_final}")
    clock.lap("output")
    clock.total()
    return out_final
