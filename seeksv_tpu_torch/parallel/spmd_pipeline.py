"""The whole ``run`` pipeline SPMD on a torch.distributed mesh.

Counterpart of ``seeksv_tpu/parallel/spmd_pipeline.py``, with the same
decomposition (see that module's docstring), on a ``parallel.mesh``
DeviceMesh of one process per rank:

  * getclip consensus — breakpoint-key groups split contiguously over the
    ranks; each rank runs K5 (``ops.consensus_scan``) on its groups, in
    chunks under a byte budget, and the slot tables are all-gathered.
  * realignment — ``BatchAligner`` with ``shard_mesh``: each rank
    extends its block of jobs with K1w, results all-gathered.
  * junction tables — each rank generates the events of its block of
    clip groups, encodes them (``_encode_events``) into
    one int32 table, all-gathers it and replays the gathered stream in
    order; the chromosome names and sizes go round as one small object
    gather.
  * MergeJunction — ``merge_junction_sharded``, partitions of the sorted
    junction list on host threads.
  * coverage / insert size — segment diffs scatter-added per dp shard,
    summed over dp, genome blocks over gp; the first-N insert-size mask
    from an all-gathered prefix count, histogram summed over dp
    (``ops.coverage``).
  * discordant pairs — junction windows over the ranks, counted with K6
    (``ops.discordant``), counts all-gathered.

Every rank runs the same host code on the same input; only rank 0 writes
the user's output files (the other ranks write their working copies of
the getclip and realign outputs under a private directory, and skip the
getsv output).  The host helpers (event capture and encoding, the
partitioned MergeJunction, the insert-size columns) are this module's
own, numpy only.  A one-rank mesh runs the same device code as any
other: the reference's one-device host shortcuts are not ported.
"""
from __future__ import annotations

import contextlib
import gzip
import io
import os
import tempfile
import time
from collections import defaultdict
from fractions import Fraction
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..align.engine import Aligner, BatchAligner
from ..align.index import KmerIndex
from ..io.bam import (BamRecords, FDUP, FMREVERSE, FMUNMAP, FREVERSE,
                      FUNMAP, OP_H, OP_S, read_bam)
from ..ops import cigar as cg
from ..ops import coverage as cov_ops
from ..ops.consensus_scan import consensus_scan_groups
from ..ops.discordant import (JUN_COLS, REC_COLS, discordant_count_batch,
                             pack_junctions)
from ..pipeline.driver import native_stage, realign_clips
from ..pipeline.getclip import (_get_sclip_read, _map_len_no_x,
                                _store_unmapped)
from ..pipeline.getsv import (DepthQuery, DiscordantCounter, JunctionMap,
                              SV_HEADER, depth_segments,
                              insert_junction_event, iter_soft_groups,
                              junction_event, output_breakpoints)
from ..pipeline.junctions import SeqInfo
from .mesh import (agree, all_gather, all_reduce_sum, mesh_device,
                   process_allgather_ragged, shard_index)

_OPS = "MIDNSHP=X"
_OP_IDX = {c: i for i, c in enumerate(_OPS)}

# bytes of one K5 call's [groups, G, LL + LR] side matrices; a rank's
# groups go through in chunks under it (groups are independent)
CONSENSUS_BUDGET = 1 << 30


def is_writer(mesh) -> bool:
    """Rank 0 writes the user's output files."""
    return shard_index(mesh) == 0


@contextlib.contextmanager
def rank_prefix(mesh, prefix: str):
    """`prefix` on rank 0; on any other rank the same file name in a
    private directory beside it, removed on exit."""
    if is_writer(mesh):
        yield prefix
        return
    parent = os.path.dirname(os.path.abspath(prefix))
    with tempfile.TemporaryDirectory(
            prefix=f".rank{shard_index(mesh)}.", dir=parent) as d:
        yield os.path.join(d, os.path.basename(prefix))


def _block(n: int, ndev: int, me: int):
    """Rows [a, b) of rank `me` when n rows are padded to a multiple of
    ndev and cut into equal contiguous blocks of `per`."""
    per = -(-n // ndev)
    return per, min(me * per, n), min((me + 1) * per, n)


# --------------------------------------------------------------------------
# getclip on the mesh
# --------------------------------------------------------------------------

class _EventSink:
    """Stands in for BreakpointMap during stream extraction: records the
    ordered insert events instead of merging them."""

    def __init__(self):
        self.events: List[tuple] = []

    def insert(self, pos, s_l, q_l, s_r, q_r, cigar, limit, left_clipped):
        self.events.append((int(pos), s_l, q_l, s_r, q_r, list(cigar)))


def clip_insert_streams(recs: BamRecords, threshold: float, min_mapq: int,
                        save_low_quality: bool):
    """Replays getclip's streaming loop (incl. the flush/drop quirks,
    clip_reads.h:423-438) but captures the per-flush-segment ordered
    insert-event streams instead of merging.  Returns
    [(tid, left_events, right_events)] in flush order."""
    flag = recs.flag
    unmapped_any = (flag & (FUNMAP | FMUNMAP)) != 0
    mapped = ~unmapped_any
    first_op = recs.first_op()
    last_op = recs.last_op()
    has_hard = (first_op == OP_H) | (last_op == OP_H)
    clip_candidate = (mapped & ~has_hard
                      & ((first_op == OP_S) | (last_op == OP_S))
                      & (recs.mapq >= min_mapq) & ((flag & FDUP) == 0))
    first_len = recs.first_len()
    last_len = recs.last_len()
    map_len = _map_len_no_x(recs)

    segments: List[Tuple[int, list, list]] = []
    left_sink, right_sink = _EventSink(), _EventSink()

    def flush(tid):
        segments.append((tid, left_sink.events, right_sink.events))
        left_sink.events = []
        right_sink.events = []

    mapped_idx = np.nonzero(mapped)[0]
    last_tid = 0
    if len(mapped_idx):
        mtids = recs.tid[mapped_idx]
        run_starts = np.concatenate(
            [[0], np.nonzero(mtids[1:] != mtids[:-1])[0] + 1, [len(mtids)]])
        for r in range(len(run_starts) - 1):
            s, e = int(run_starts[r]), int(run_starts[r + 1])
            tid = int(mtids[s])
            if tid != last_tid:
                flush(last_tid)
                last_tid = tid
                s += 1  # quirk: flush-triggering record is dropped
            run = mapped_idx[s:e]
            for i in run[clip_candidate[run]]:
                _get_sclip_read(recs, int(i), left_sink, right_sink,
                                threshold, save_low_quality, first_op,
                                last_op, first_len, last_len, map_len)
    flush(last_tid)
    return segments


def consensus_inputs(group_events: List[list], G: int, LL: int, LR: int):
    """The n groups as K5's inputs (spmd_pipeline.py:162-173): seq_l
    [n, G, LL] right-aligned and seq_r [n, G, LR] left-aligned uint8,
    len_l/len_r [n, G] and n_reads [n] int32."""
    n = len(group_events)
    seq_l = np.zeros((n, G, LL), np.uint8)
    seq_r = np.zeros((n, G, LR), np.uint8)
    len_l = np.zeros((n, G), np.int32)
    len_r = np.zeros((n, G), np.int32)
    n_reads = np.zeros(n, np.int32)
    for k, evs in enumerate(group_events):
        n_reads[k] = len(evs)
        for ri, (_pos, s_l, _q_l, s_r, _q_r, _cig) in enumerate(evs):
            seq_l[k, ri, LL - len(s_l):] = s_l
            len_l[k, ri] = len(s_l)
            seq_r[k, ri, :len(s_r)] = s_r
            len_r[k, ri] = len(s_r)
    return seq_l, len_l, seq_r, len_r, n_reads


def mesh_consensus(mesh, group_keys: List[tuple], group_events: List[list],
                   threshold: float,
                   log=lambda *a: None) -> Dict[tuple, list]:
    """Consensus merge of breakpoint-key groups on the mesh
    (spmd_pipeline.py:138-205): the groups are padded to [G, L] and cut
    into one contiguous block per rank; each rank runs K5 on its block in
    chunks of at most CONSENSUS_BUDGET bytes and uploads no qualities
    (and asks K5 for no sides' rows: the host rebuilds them);
    (n_slots, overflow, support, src_l, src_r) of every group are
    all-gathered, so every rank decides the overflow retry (at
    max_slots = G) on the same values.  The host rebuilds sequences,
    qualities and CIGARs from the source indices (side replacement is
    wholesale)."""
    consensus: Dict[tuple, list] = {}
    frac = Fraction(threshold).limit_denominator(100000)
    NG, G, LL, LR = agree(mesh, [
        len(group_events), max((len(v) for v in group_events), default=0),
        max((len(ev[1]) for v in group_events for ev in v), default=1),
        max((len(ev[3]) for v in group_events for ev in v), default=1)])
    if NG == 0:
        return consensus
    LL, LR = max(LL, 1), max(LR, 1)
    ndev = mesh.size()
    per, a, b = _block(NG, ndev, shard_index(mesh))
    mine = group_events[a:b]
    chunk = max(1, CONSENSUS_BUDGET // (G * (LL + LR)))
    log(f"mesh consensus: NG={NG} G={G} LL={LL} LR={LR}, "
        f"{NG * G * (LL + LR):,} bytes of sides, {per} groups per rank in "
        f"chunks of <= {chunk}")
    dev = mesh_device(mesh)
    max_slots = 8
    while True:
        S = max_slots
        # per group: n_slots, overflow, support[S], src_l[S], src_r[S]
        table = torch.zeros((per, 2 + 3 * S), dtype=torch.int32, device=dev)
        for c0 in range(0, len(mine), chunk):
            part = mine[c0:c0 + chunk]
            args = [torch.from_numpy(x).to(dev)
                    for x in consensus_inputs(part, G, LL, LR)]
            out = consensus_scan_groups(*args, frac.numerator,
                                        frac.denominator, max_slots=S,
                                        with_sides=False)
            rows = table[c0:c0 + len(part)]
            rows[:, 0] = out["n_slots"]
            rows[:, 1] = out["overflow"].to(torch.int32)
            rows[:, 2:2 + S] = out["support"]
            rows[:, 2 + S:2 + 2 * S] = out["src_l"]
            rows[:, 2 + 2 * S:] = out["src_r"]
        table = all_gather(mesh, table)[:NG].cpu().numpy()
        if not table[:, 1].any() or max_slots >= G:
            break
        max_slots = G   # every read could be its own slot: cannot overflow
    n_slots = table[:, 0]
    support = table[:, 2:2 + S]
    src_l = table[:, 2 + S:2 + 2 * S]
    src_r = table[:, 2 + 2 * S:]
    for k, key in enumerate(group_keys):
        evs = group_events[k]
        entries = []
        for s in range(int(n_slots[k])):
            el = evs[int(src_l[k, s])]
            er = evs[int(src_r[k, s])]
            # CIGAR follows the aligned side (ref clip_reads.cpp:69-75):
            # side 5 (left-clipped) -> right part; side 3 -> left part
            cig = er[5] if key[1] == 0 else el[5]
            entries.append((el[1], el[2], er[3], er[4], cig,
                            int(support[k, s])))
        consensus[key] = entries
    return consensus


def write_segment(soft_out, fq_out, chrom: str, consensus: dict,
                  keys) -> None:
    """getclip's output for the consensus entries of one flush segment:
    side 5 (key[1] == 0) then side 3, positions (key[2]) ascending."""
    for side, orient in ((0, "5"), (1, "3")):
        for key in sorted(k for k in keys if k[1] == side):
            for (s_l, q_l, s_r, q_r, cig, sup) in consensus[key]:
                if orient == "5":
                    aligned, aligned_q = s_r, q_r
                    clipped, clipped_q = s_l, q_l
                else:
                    aligned, aligned_q = s_l, q_l
                    clipped, clipped_q = s_r, q_r
                soft_out.write(
                    f"{chrom}\t{key[2]}\t{orient}\t{cg.to_str(cig)}\t"
                    f"{aligned.tobytes().decode()}\t"
                    f"{aligned_q.tobytes().decode()}\t"
                    f"{clipped.tobytes().decode()}\t"
                    f"{clipped_q.tobytes().decode()}\t{sup}\n")
                cs = clipped.tobytes().decode()
                fq_out.write(f"@{cs}\n{cs}\n+\n"
                             f"{clipped_q.tobytes().decode()}\n")


def spmd_getclip(mesh, bam_path: str, prefix: str, threshold: float = 0.85,
                 min_mapq: int = 20, save_low_quality: bool = False,
                 recs: Optional[BamRecords] = None,
                 log=lambda *a: None) -> None:
    """getclip with the consensus merge on the mesh (mesh_consensus);
    writes ``{prefix}.clip.gz``, ``.clip.fq.gz`` and the unmapped fastqs,
    byte-identical to the host pass.  Every rank writes where it is told
    (``spmd_run_pipeline`` gives ranks other than 0 a private prefix)."""
    if recs is None:
        recs = read_bam(bam_path)
    with gzip.open(f"{prefix}.clip.gz", "wt", compresslevel=1) as soft_out, \
            gzip.open(f"{prefix}.clip.fq.gz", "wt",
                      compresslevel=1) as fq_out, \
            gzip.open(f"{prefix}.unmapped_1.fq.gz", "wb",
                      compresslevel=1) as un1, \
            gzip.open(f"{prefix}.unmapped_2.fq.gz", "wb",
                      compresslevel=1) as un2:
        id2seq_qual: Dict[bytes, tuple] = {}
        for i in np.nonzero((recs.flag & (FUNMAP | FMUNMAP)) != 0)[0]:
            _store_unmapped(recs, int(i), id2seq_qual, un1, un2)
        segments = clip_insert_streams(recs, threshold, min_mapq,
                                       save_low_quality)
        # group events by (segment, side, pos), preserving stream order
        group_keys: List[tuple] = []
        group_events: List[list] = []
        gidx: Dict[tuple, int] = {}
        for si, (_tid, lev, rev) in enumerate(segments):
            for side, events in ((0, lev), (1, rev)):
                for ev in events:
                    key = (si, side, ev[0])
                    k = gidx.get(key)
                    if k is None:
                        k = gidx[key] = len(group_keys)
                        group_keys.append(key)
                        group_events.append([])
                    group_events[k].append(ev)
        consensus = mesh_consensus(mesh, group_keys, group_events, threshold,
                                   log)
        by_segment = defaultdict(list)
        for key in consensus:
            by_segment[key[0]].append(key)
        # emit in flush order
        for si, (tid, _lev, _rev) in enumerate(segments):
            chrom = (recs.ref_names[tid] if 0 <= tid < len(recs.ref_names)
                     else str(tid))
            write_segment(soft_out, fq_out, chrom, consensus,
                          by_segment[si])


# --------------------------------------------------------------------------
# junction tables through the mesh
# --------------------------------------------------------------------------

@dataclass
class _EncodedEvents:
    """Fixed-shape encoding of junction events (key 6-tuple + SeqInfo
    payloads) for the mesh all-gather."""
    key: np.ndarray        # [E, 6] int32
    useq: np.ndarray       # [E, LS] uint8
    dseq: np.ndarray       # [E, LS] uint8
    ulen: np.ndarray       # [E] int32
    dlen: np.ndarray       # [E] int32
    ucig: np.ndarray       # [E, C] uint32 (len<<4 | op)
    dcig: np.ndarray       # [E, C] uint32
    meta: np.ndarray       # [E, 10] int32: n_ucig, n_dcig, up(lcl,rcl,support,uniq), down(lcl,rcl,support,uniq)
    valid: np.ndarray      # [E] bool


def _encode_events(events, name2id, E, LS, C):
    key = np.zeros((E, 6), np.int32)
    useq = np.zeros((E, LS), np.uint8)
    dseq = np.zeros((E, LS), np.uint8)
    ulen = np.zeros(E, np.int32)
    dlen = np.zeros(E, np.int32)
    ucig = np.zeros((E, C), np.uint32)
    dcig = np.zeros((E, C), np.uint32)
    meta = np.zeros((E, 10), np.int32)
    valid = np.zeros(E, bool)
    for i, (j, up, down) in enumerate(events):
        key[i] = (name2id[j[0]], j[1], 0 if j[2] == "+" else 1,
                  name2id[j[3]], j[4], 0 if j[5] == "+" else 1)
        ub = np.frombuffer(up.seq, np.uint8)
        db = np.frombuffer(down.seq, np.uint8)
        useq[i, :len(ub)] = ub
        dseq[i, :len(db)] = db
        ulen[i], dlen[i] = len(ub), len(db)
        for c, (ln, op) in enumerate(up.cigar):
            ucig[i, c] = (ln << 4) | _OP_IDX[op]
        for c, (ln, op) in enumerate(down.cigar):
            dcig[i, c] = (ln << 4) | _OP_IDX[op]
        meta[i, 0] = len(up.cigar)
        meta[i, 1] = len(down.cigar)
        meta[i, 2:6] = (up.lcl, up.rcl, up.support, up.uniq)
        meta[i, 6:10] = (down.lcl, down.rcl, down.support, down.uniq)
        valid[i] = True
    return _EncodedEvents(key, useq, dseq, ulen, dlen, ucig, dcig, meta,
                          valid)


def _decode_event(enc: _EncodedEvents, i: int, id2name):
    k = enc.key[i]
    j = (id2name[k[0]], int(k[1]), "+" if k[2] == 0 else "-",
         id2name[k[3]], int(k[4]), "+" if k[5] == 0 else "-")
    m = enc.meta[i]
    ucig = [((int(v) >> 4), _OPS[int(v) & 0xF])
            for v in enc.ucig[i, :m[0]]]
    dcig = [((int(v) >> 4), _OPS[int(v) & 0xF])
            for v in enc.dcig[i, :m[1]]]
    up = SeqInfo(enc.useq[i, :enc.ulen[i]].tobytes(), ucig,
                 int(m[2]), int(m[3]), int(m[4]), int(m[5]))
    down = SeqInfo(enc.dseq[i, :enc.dlen[i]].tobytes(), dcig,
                   int(m[6]), int(m[7]), int(m[8]), int(m[9]))
    return j, up, down


def _pow2(n: int) -> int:
    b = 8
    while b < n:
        b <<= 1
    return b


def _pack(enc: _EncodedEvents) -> np.ndarray:
    """One [E, 19 + 2 C + LS / 2] int32 row per event: key, ulen, dlen,
    meta, valid, ucig, dcig (uint32 bits), useq, dseq (bytes; LS is a
    multiple of 4)."""
    col = lambda a: a.reshape(len(a), -1)
    return np.concatenate(
        [enc.key, col(enc.ulen), col(enc.dlen), enc.meta,
         col(enc.valid.astype(np.int32)), enc.ucig.view(np.int32),
         enc.dcig.view(np.int32), enc.useq.view(np.int32),
         enc.dseq.view(np.int32)], axis=1)


def _unpack(t: np.ndarray, C: int, LS: int) -> _EncodedEvents:
    cuts = np.cumsum([6, 1, 1, 10, 1, C, C, LS // 4, LS // 4])
    key, ulen, dlen, meta, valid, ucig, dcig, useq, dseq = \
        np.split(t, cuts[:-1], axis=1)
    u8 = lambda a: np.ascontiguousarray(a).view(np.uint8)
    return _EncodedEvents(
        key, u8(useq), u8(dseq), ulen[:, 0].copy(), dlen[:, 0].copy(),
        np.ascontiguousarray(ucig).view(np.uint32),
        np.ascontiguousarray(dcig).view(np.uint32), meta,
        valid[:, 0].astype(bool))


def _gather_window(mesh, jmap: JunctionMap, groups, rescue: bool,
                   rescue_events: list) -> None:
    """One window of clip groups through the mesh (spmd_pipeline.py:341-
    419): each rank generates the events of its contiguous block, the
    ranks exchange their sizes, chromosome names and rescue events in one
    object gather, the encoded tables in one all-gather, and every rank
    replays the gathered stream in the original order."""
    ndev = mesh.size()
    me = shard_index(mesh)
    bounds = np.linspace(0, len(groups), ndev + 1).astype(int)
    mine: List[tuple] = []
    my_rescue: list = []
    for ari, orient, cais in groups[bounds[me]:bounds[me + 1]]:
        for cai in cais:
            ev = junction_event(ari, orient, cai, rescue)
            if ev is None:
                continue
            if ev[0] == "rescue":
                my_rescue.append((ev[1], ev[2]))
            else:
                mine.append(ev[1:])
    names: Dict[str, None] = {}
    for (j, _u, _d) in mine:
        names.setdefault(j[0])
        names.setdefault(j[3])
    meta = (len(mine),
            max((max(len(u.seq), len(d.seq)) for (_j, u, d) in mine),
                default=0),
            max((max(len(u.cigar), len(d.cigar), 1) for (_j, u, d) in mine),
                default=1),
            list(names), my_rescue)
    every: list = [None] * ndev
    dist.all_gather_object(every, meta)
    for m in every:
        rescue_events.extend(m[4])
    if sum(m[0] for m in every) == 0:
        return
    id2name = list(dict.fromkeys(nm for m in every for nm in m[3]))
    name2id = {n: i for i, n in enumerate(id2name)}
    # pow2 pads, as the reference's (there they bound the jit cache)
    E = _pow2(max(m[0] for m in every))
    LS = _pow2(max(m[1] for m in every))
    C = _pow2(max(m[2] for m in every))
    table = torch.from_numpy(_pack(_encode_events(mine, name2id, E, LS, C)))
    got = all_gather(mesh, table.to(mesh_device(mesh))).cpu().numpy()
    genc = _unpack(got, C, LS)
    for i in np.nonzero(genc.valid)[0]:
        j, up, down = _decode_event(genc, int(i), id2name)
        insert_junction_event(jmap, j, up, down)


def spmd_build_junctions(mesh, clipfile: str, samfile: str,
                         skip_min_mapq: int = 0, rescue: bool = False,
                         window_groups: int = 4096):
    """Junction-table construction with the event tables crossing the
    mesh, in windows of `window_groups` clip groups (spmd_pipeline.py:
    422-449); identical to the sequential input_soft_info."""
    jmap = JunctionMap()
    rescue_events: list = []
    window: list = []
    for g in iter_soft_groups(clipfile, samfile, skip_min_mapq):
        window.append(g)
        if len(window) >= window_groups:
            _gather_window(mesh, jmap, window, rescue, rescue_events)
            window = []
    if window:
        _gather_window(mesh, jmap, window, rescue, rescue_events)
    return jmap, rescue_events


# --------------------------------------------------------------------------
# MergeJunction, partitioned over the sorted junction list
# --------------------------------------------------------------------------

def _merge_pair_strings(ji, oi, jk, ok):
    """The four shifted sequences MergeJunction compares for a candidate
    pair (ref: getsv.cpp:1355-1410), or None when the pair can never
    merge (the `skip` / no-single-cigar branches).  Depends only on
    seq/cigar/positions — none of which the merge mutates — so the 0.85
    gate is precomputable for every pair before the stateful scan."""
    if len(oi.up.cigar) == 1 and len(ok.up.cigar) == 1:
        mh = jk[1] - ji[1]
        if ((ji[2] == "+" and len(ok.up.seq) < mh + 5)
                or (ji[2] == "-" and len(oi.up.seq) < mh + 5)):
            return None
        if ji[2] == "+":
            return (oi.up.seq, oi.down.seq,
                    ok.up.seq[: len(ok.up.seq) - mh],
                    ok.up.seq[len(ok.up.seq) - mh:] + ok.down.seq)
        return (oi.up.seq[: len(oi.up.seq) - mh],
                oi.up.seq[len(oi.up.seq) - mh:] + oi.down.seq,
                ok.up.seq, ok.down.seq)
    if len(oi.down.cigar) == 1 and len(ok.down.cigar) == 1:
        mh = abs(jk[4] - ji[4])
        if ((ji[2] == "+" and len(oi.down.seq) < mh + 5)
                or (ji[2] == "-" and len(ok.down.seq) < mh + 5)):
            return None
        if ji[2] == "+":
            return (oi.up.seq + oi.down.seq[:mh], oi.down.seq[mh:],
                    ok.up.seq, ok.down.seq)
        return (oi.up.seq, oi.down.seq,
                ok.up.seq + ok.down.seq[:mh], ok.down.seq[mh:])
    return None


def _enumerate_merge_pairs(items, lo: int, hi: int, search_length: int):
    """Candidate pairs (i, k) of one partition with their four shifted
    strings (state-independent — see _merge_pair_strings)."""
    pairs = []
    strs = []
    for i in range(lo, hi):
        ji, oi = items[i]
        if oi.up.rcl > 0 or oi.up.lcl > 0:
            continue
        for k in range(i + 1, hi):
            jk, ok = items[k]
            if jk[1] - ji[1] > search_length:
                break
            if abs(jk[4] - ji[4]) <= search_length and ok.down.lcl == 0:
                s = _merge_pair_strings(ji, oi, jk, ok)
                if s is not None:
                    pairs.append((i, k))
                    strs.append(s)
    return pairs, strs


def _batch_merge_gates(pairs, strs):
    """The 0.85 both-side match gate for EVERY candidate pair of every
    partition as one padded data-parallel comparison (the reference
    evaluates it pair-at-a-time, getsv.cpp:1411; this formulation is a
    single fused elementwise+reduce op — the device-native shape of the
    merge's compute)."""
    if not pairs:
        return {}
    LU = max(max(min(len(a), len(c)) for a, _b, c, _d in strs), 1)
    LD = max(max(min(len(b), len(d)) for _a, b, _c, d in strs), 1)
    P = len(pairs)
    # right-anchored (match_rate_end) for up, left-anchored for down
    u1 = np.zeros((P, LU), np.uint8)
    u2 = np.full((P, LU), 0xFF, np.uint8)
    d1 = np.zeros((P, LD), np.uint8)
    d2 = np.full((P, LD), 0xFF, np.uint8)
    nu = np.zeros(P, np.int32)
    nd = np.zeros(P, np.int32)
    for p, (a, b, c, d) in enumerate(strs):
        n1 = min(len(a), len(c))
        if n1:
            u1[p, :n1] = np.frombuffer(a[len(a) - n1:], np.uint8)
            u2[p, :n1] = np.frombuffer(c[len(c) - n1:], np.uint8)
        nu[p] = n1
        n2 = min(len(b), len(d))
        if n2:
            d1[p, :n2] = np.frombuffer(b[:n2], np.uint8)
            d2[p, :n2] = np.frombuffer(d[:n2], np.uint8)
        nd[p] = n2
    mu = (u1 == u2).sum(axis=1).astype(np.float64)
    md = (d1 == d2).sum(axis=1).astype(np.float64)
    # the same float64 division-then-compare as match_rate_end/begin (and
    # the C++, clip_reads.cpp:194-217); n == 0 reproduces the
    # NaN-compares-false semantics
    with np.errstate(invalid="ignore", divide="ignore"):
        gate = ((nu > 0) & (nd > 0)
                & (mu / nu >= 0.85) & (md / nd >= 0.85))
    return {pk: bool(g) for pk, g in zip(pairs, gate)}


def _merge_partition_gated(items, lo: int, hi: int, search_length: int,
                           gates) -> List[tuple]:
    """The sequential MergeJunction scan of one partition with the 0.85
    gate looked up from the precomputed table (state transitions —
    support/uniq/mh accumulation, survivor priority, deletions — are
    byte-identical to pipeline.getsv.merge_junction; gate keys are
    original item indices, which deletions never invalidate because the
    window conditions test values, not positions)."""
    sub = [list(t) + [idx] for idx, t in enumerate(items[lo:hi], start=lo)]
    i = 0
    while i < len(sub):
        ji, oi, id_i = sub[i]
        if oi.up.rcl > 0 or oi.up.lcl > 0:
            i += 1
            continue
        k = i + 1
        mark = False
        while (k < len(sub)
               and ji[0] == sub[k][0][0] and ji[3] == sub[k][0][3]
               and ji[2] == sub[k][0][2] and ji[5] == sub[k][0][5]
               and sub[k][0][1] - ji[1] <= search_length):
            jk, ok, id_k = sub[k]
            if abs(jk[4] - ji[4]) <= search_length and ok.down.lcl == 0:
                if gates.get((id_i, id_k), False):
                    oi.up.uniq = max(oi.up.uniq, ok.up.uniq)
                    oi.down.uniq = max(oi.down.uniq, ok.down.uniq)
                    if oi.mh == -1 and ok.mh == -1:
                        oi.up.support += ok.up.support
                        oi.down.support += ok.down.support
                        if ((oi.up.support != 0 and ok.down.support != 0)
                                or (oi.down.support != 0
                                    and ok.up.support != 0)):
                            oi.mh = jk[1] - ji[1]
                        del sub[k]
                    elif oi.mh != -1 and ok.mh == -1:
                        oi.up.support += ok.up.support
                        oi.down.support += ok.down.support
                        del sub[k]
                    elif oi.mh == -1 and ok.mh != -1:
                        ok.up.support += oi.up.support
                        ok.down.support += oi.down.support
                        mark = True
                    else:
                        if (oi.up.support > ok.up.support
                                or oi.down.support == ok.down.support):
                            oi.up.support += ok.up.support
                            del sub[k]
                        elif (oi.up.support == ok.up.support
                                or oi.down.support > ok.down.support):
                            oi.down.support += ok.down.support
                            del sub[k]
                        elif (ok.up.support > oi.up.support
                                and oi.down.support == ok.down.support):
                            ok.up.support += oi.up.support
                            mark = True
                        elif (ok.down.support > oi.down.support
                                and ok.up.support == oi.up.support):
                            ok.down.support += oi.down.support
                            mark = True
                        else:
                            k += 1
                    if mark:
                        break
                else:
                    k += 1
            else:
                k += 1
        if mark:
            del sub[i]
        else:
            i += 1
    return [(j, o) for j, o, _id in sub]


def merge_junction_sharded(jmap: JunctionMap, search_length: int,
                           max_workers: int = 0) -> int:
    """Partitioned MergeJunction (ref: getsv.cpp:1325-1482): the merge
    scan from item i only reaches items k with identical
    (up_chr, down_chr, up_strand, down_strand) and
    up_pos[k] - up_pos[i] <= search_length, so cutting the key-sorted
    table where the prefix changes or the up_pos gap exceeds
    search_length yields fully independent partitions.  The parallelism
    is realized in the GATE phase: every partition's 0.85 match
    comparisons (the merge's compute, >90% of its work) evaluate as ONE
    padded data-parallel batched op.  The cheap stateful replays then
    run per partition on a thread pool — independent and safe, though on
    CPython they interleave under the GIL rather than speed up
    (scripts/bench_merge.py reports the interleaving honestly; true
    replay parallelism needs free-threading or processes).  Exact vs the
    sequential pass — asserted by tests/test_spmd_pipeline.py.  Returns
    the number of partitions (the available parallelism)."""
    import concurrent.futures as cf
    import os

    items = jmap.items
    n = len(items)
    if n == 0:
        return 0
    cuts = [0]
    for idx in range(1, n):
        a = items[idx - 1][0]
        b = items[idx][0]
        if ((a[0], a[3], a[2], a[5]) != (b[0], b[3], b[2], b[5])
                or b[1] - a[1] > search_length):
            cuts.append(idx)
    cuts.append(n)
    spans = list(zip(cuts, cuts[1:]))

    # Phase 1 — the match-gate compute for every pair of every partition
    # as ONE data-parallel batched comparison (>90% of the merge's work).
    all_pairs: list = []
    all_strs: list = []
    for lo, hi in spans:
        p, s = _enumerate_merge_pairs(items, lo, hi, search_length)
        all_pairs.extend(p)
        all_strs.extend(s)
    gates = _batch_merge_gates(all_pairs, all_strs)

    # Phase 2 — the cheap stateful replays, independent per partition,
    # on a thread pool (chunked so each task is big enough to overlap).
    def run(span):
        lo, hi = span
        return _merge_partition_gated(items, lo, hi, search_length, gates)

    if max_workers <= 0:
        max_workers = min(8, os.cpu_count() or 1)
    if max_workers > 1 and len(spans) > 1:
        with cf.ThreadPoolExecutor(max_workers=max_workers) as ex:
            merged_parts = list(ex.map(run, spans))
    else:
        merged_parts = [run(s) for s in spans]
    new = JunctionMap()
    for part in merged_parts:
        for j, o in part:
            new.insert(j, o)
    jmap.keys = new.keys
    jmap.items = new.items
    jmap._seq = new._seq
    return len(spans)


# --------------------------------------------------------------------------
# insert-size + coverage (one shard_map step), discordant windows (second)
# --------------------------------------------------------------------------

HIST_SIZE = 1 << 16


# --------------------------------------------------------------------------
# coverage + insert size, discordant windows
# --------------------------------------------------------------------------

def _flat_segments(recs: BamRecords, min_mapq: int, offsets: np.ndarray,
                   g_pad: int):
    """Depth segments in genome-flat coordinates (host prep shared by the
    SPMD and multi-process steps).  Native single-pass when built (the
    numpy form below is the oracle — identical output asserted by the
    SPMD-vs-sequential coverage parity tests)."""
    from ..io import native
    if native.available():
        return native.depth_segments_flat(recs, min_mapq, offsets)
    seg_start, seg_end, seg_tid = depth_segments(recs, min_mapq)
    # clip per-tid (a segment overhanging its chromosome end must not
    # bleed into the next tid's block in the flat coordinate space)
    tid_lens = np.asarray(recs.ref_lens, np.int64)[seg_tid]
    seg_start = np.clip(seg_start, 0, tid_lens)
    seg_end = np.clip(seg_end, 0, tid_lens)
    flat_start = (seg_start + offsets[seg_tid]).astype(np.int64)
    flat_end = (seg_end + offsets[seg_tid]).astype(np.int64)
    return flat_start, flat_end


def _insert_columns(recs: BamRecords, min_mapq: int):
    """Per-record first-N qualification mask + clamped isize columns
    (ref cluster.cpp:25-56)."""
    first_op = recs.first_op()
    last_op = recs.last_op()
    has_cigar = recs.cig_off[1:] > recs.cig_off[:-1]
    hard = has_cigar & ((first_op == OP_H) | (last_op == OP_H))
    from ..io.bam import FPAIRED, FPROPER_PAIR
    ok = ((recs.mapq >= min_mapq)
          & ((recs.flag & FPAIRED) != 0) & ((recs.flag & FPROPER_PAIR) != 0)
          & ((recs.flag & FDUP) == 0) & (recs.isize > 0) & ~hard)
    isize = np.clip(recs.isize, 0, HIST_SIZE - 1).astype(np.int32)
    over = np.asarray(recs.isize >= HIST_SIZE)
    return ok, isize, over


def _insert_stats_from_hist(hist: np.ndarray, extra_vals=()):
    """Exact integer mean + truncated-int deviation (cluster.cpp:15-83)
    from the device histogram, plus any host-spilled overflow values
    (isize >= HIST_SIZE; rare but legal — the histogram rows for them
    are clamped on-device and replaced by their exact values here)."""
    extra = np.asarray(list(extra_vals), np.int64)
    n = int(hist.sum()) + len(extra)
    if n == 0:
        return 0, 0
    vals = np.arange(HIST_SIZE, dtype=np.int64)
    mean = int(((hist * vals).sum() + extra.sum()) // n)
    import math
    ss = float((hist * (vals - mean) ** 2).sum()) \
        + float(((extra - mean).astype(np.float64) ** 2).sum())
    dev = int(math.sqrt(ss / n))
    return mean, dev


def spmd_coverage_insert(mesh, recs: BamRecords, min_mapq: int,
                         read_pair_used: int):
    """Coverage and the insert-size model on the mesh (spmd_pipeline.py:
    696-730, 787-852): each dp shard scatter-adds its block of depth
    segments into a genome-flat int32 diff, the diffs are summed over
    dp, each gp rank prefix-sums and keeps its genome block, and the
    blocks are gathered over gp; the first-N proper-pair mask comes from
    the dp shards' gathered counts, the histogram is summed over dp.
    isize >= HIST_SIZE spills to exact host values.  Returns
    (cov {tid: int32 array}, mean, dev) with cluster.cpp:15-83 /
    bam2depth.cpp:75-129 semantics.  Flat coordinates are int64."""
    dp, gp = mesh.shape
    d, g = mesh.get_coordinate()
    dev = mesh_device(mesh)
    offsets = np.concatenate([[0], np.cumsum(recs.ref_lens)]).astype(np.int64)
    g_total = int(offsets[-1])
    block = -(-(g_total + 1) // gp)
    g_pad = block * gp

    flat_start, flat_end = _flat_segments(recs, min_mapq, offsets, g_pad)
    ok, isize_c, over_c = _insert_columns(recs, min_mapq)
    n_seg, n_rec = agree(mesh, [len(flat_start), recs.n])

    def mine(a, n, fill):
        # this dp shard's block of the n rows padded to a multiple of dp
        per = -(-max(n, 1) // dp)
        lo, hi = min(d * per, n), min((d + 1) * per, n)
        out = np.full(per, fill, a.dtype)
        out[:hi - lo] = a[lo:hi]
        return torch.from_numpy(out).to(dev)

    diff = cov_ops.segment_diff(mine(flat_start, n_seg, g_pad),
                                mine(flat_end, n_seg, g_pad), g_pad)
    all_reduce_sum(mesh, diff, "dp")
    cov_block = cov_ops.prefix_sum_i32(diff)[g * block:(g + 1) * block]
    cov = all_gather(mesh, cov_block, "gp")[:g_total].cpu().numpy()

    okm = mine(np.asarray(ok), n_rec, False)
    cnts = all_gather(mesh, okm.sum().reshape(1), "dp").cpu()
    take = cov_ops.first_n_take(okm, int(cnts[:d].sum()), read_pair_used)
    hist = cov_ops.insert_histogram(mine(isize_c, n_rec, 0), take, HIST_SIZE)
    all_reduce_sum(mesh, hist, "dp")
    n_over = (take & mine(np.asarray(over_c), n_rec, False)).sum()
    n_over = int(all_reduce_sum(mesh, n_over.reshape(1), "dp")[0])
    hist = hist.cpu().numpy().astype(np.int64)
    extra = ()
    if n_over:
        # the spilled records were clamped into the top bin; replace them
        # with their exact values under the same global first-N mask
        rank = np.cumsum(ok) - 1
        taken_over = ok & over_c & (rank < read_pair_used)
        extra = np.asarray(recs.isize)[taken_over].astype(np.int64)
        if len(extra) != n_over:
            raise AssertionError(f"{n_over} spilled insert sizes on the "
                                 f"mesh, {len(extra)} on the host")
        hist[HIST_SIZE - 1] -= len(extra)
    mean, dev_ = _insert_stats_from_hist(hist, extra)
    cov_by_tid = {t: cov[offsets[t]:offsets[t + 1]]
                  for t in range(len(recs.ref_names))}
    return cov_by_tid, mean, dev_


def multiprocess_coverage_insert(mesh, local_recs: BamRecords,
                                 min_mapq: int, read_pair_used: int):
    """The multi-process form of spmd_coverage_insert (spmd_pipeline.py:
    855-960): every rank holds only its own contiguous range of the BAM's
    records, rank r the r-th range in file order, and no rank sees the
    whole file.  Each rank is one data shard of the mesh (JAX's
    n_local_dev shards a process become one shard a rank): it
    scatter-adds its own depth segments, the diffs are summed over every
    rank, each gp rank prefix-sums and keeps its genome block and the
    blocks are gathered over gp; the first-N proper-pair mask takes its
    offset from the qualifying counts of the ranks before this one (an
    all-gather in rank order, which is file order) and the histogram is
    summed over every rank.  isize >= HIST_SIZE spills: each rank's
    first-N overflow values are gathered in rank order and
    replace the top bin's clamped entries.  Every rank passes the same
    reference dictionary (checked).  Returns (cov {tid: int32 array},
    mean, dev), identical to the one-process pass."""
    g = mesh.get_coordinate()[1]
    gp = mesh.shape[1]
    dev = mesh_device(mesh)
    offsets = np.concatenate(
        [[0], np.cumsum(local_recs.ref_lens)]).astype(np.int64)
    g_total = int(offsets[-1])
    hi, neg_lo = agree(mesh, [g_total, -g_total])
    if (hi, -neg_lo) != (g_total, g_total):
        raise ValueError("the ranks hold BAMs of different reference "
                         f"dictionaries ({-neg_lo} to {hi} bp)")
    block = -(-(g_total + 1) // gp)
    g_pad = block * gp

    flat_start, flat_end = _flat_segments(local_recs, min_mapq, offsets,
                                          g_pad)
    ok, isize_c, over_c = _insert_columns(local_recs, min_mapq)
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    diff = cov_ops.segment_diff(up(flat_start), up(flat_end), g_pad)
    all_reduce_sum(mesh, diff)
    cov_block = cov_ops.prefix_sum_i32(diff)[g * block:(g + 1) * block]
    cov = all_gather(mesh, cov_block, "gp")[:g_total].cpu().numpy()

    okm = up(np.asarray(ok, bool))
    cnts = all_gather(mesh, okm.sum().reshape(1)).cpu().numpy()
    offset = int(cnts[:dist.get_rank()].sum())
    take = cov_ops.first_n_take(okm, offset, read_pair_used)
    hist = cov_ops.insert_histogram(up(isize_c), take, HIST_SIZE)
    all_reduce_sum(mesh, hist)
    n_over = (take & up(np.asarray(over_c, bool))).sum()
    n_over = int(all_reduce_sum(mesh, n_over.reshape(1))[0])
    hist = hist.cpu().numpy().astype(np.int64)
    extra = np.zeros(0, np.int64)
    if n_over:
        # the spilled records were clamped into the top bin; gather their
        # exact values, in rank order, under the same global first-N mask
        mine = np.asarray(local_recs.isize, np.int64)[
            take.cpu().numpy() & np.asarray(over_c, bool)]
        extra = np.concatenate(process_allgather_ragged(mesh, mine))
        if len(extra) != n_over:
            raise AssertionError(f"{n_over} spilled insert sizes on the "
                                 f"mesh, {len(extra)} gathered")
        hist[HIST_SIZE - 1] -= len(extra)
    mean, dev_ = _insert_stats_from_hist(hist, extra)
    cov_by_tid = {t: cov[offsets[t]:offsets[t + 1]]
                  for t in range(len(local_recs.ref_names))}
    return cov_by_tid, mean, dev_


_CASES = {("+", "+"): 0, ("-", "+"): 1, ("+", "-"): 2}


def junction_windows(counter: DiscordantCounter, junctions) -> dict:
    """Per-junction window prep of both discordant forms
    (spmd_pipeline.py:979-1018 and :1084-1125): the record range [lo, hi)
    a junction's window reaches, beg, up/down position, the mate's tid,
    same-chromosome flag and case code (-1: a junction the host counter
    gives 0 without a window)."""
    K = 5
    J = len(junctions)
    w = {k: np.zeros(J, np.int64) for k in ("lo", "hi", "beg", "up_pos",
                                            "down_pos")}
    w["down_tid"] = np.full(J, -1, np.int32)
    w["same_tid"] = np.zeros(J, bool)
    w["case_code"] = np.full(J, -1, np.int32)
    for i, (up_chr, up_pos, us, down_chr, down_pos, ds) in \
            enumerate(junctions):
        tid = counter.name2tid.get(up_chr, -1)
        mtid = counter.name2tid.get(down_chr, -1)
        if tid == -1 or (us, ds) not in _CASES:
            continue
        chr_len = counter.ref_lens[tid]
        if us == "+":
            end_w = up_pos
            beg_w = end_w - counter.max_insert
        else:
            beg_w = up_pos - 1 - K
            end_w = up_pos - 1 + counter.max_insert
        beg_w = max(beg_w, 1)
        end_w = min(end_w, chr_len)
        rng = counter.tid_ranges.get(tid)
        if rng is None or end_w <= beg_w or mtid == -1:
            continue
        tlo, thi = rng
        posv = counter.pos64[tlo:thi]
        h2 = tlo + int(np.searchsorted(posv, end_w, "left"))
        l2 = tlo + int(np.searchsorted(
            posv, beg_w - counter.tid_max_span[tid], "right"))
        w["lo"][i], w["hi"][i] = min(l2, h2), h2
        w["beg"][i] = beg_w
        w["up_pos"][i], w["down_pos"][i] = up_pos, down_pos
        w["down_tid"][i] = mtid
        w["same_tid"][i] = tid == mtid
        w["case_code"][i] = _CASES[(us, ds)]
    return w


def record_columns(counter: DiscordantCounter) -> dict:
    """K6's record columns of the counter's records (ops.discordant
    dtypes)."""
    recs = counter.recs
    flag = np.asarray(recs.flag)
    return {"pos": np.asarray(recs.pos, np.int64),
            "end": np.asarray(counter.end, np.int64),
            "lq": np.asarray(recs.l_qseq, np.int32),
            "mpos": np.asarray(recs.mpos, np.int64),
            "mtid": np.asarray(recs.mtid, np.int32),
            "fwd": (flag & FREVERSE) == 0, "mfwd": (flag & FMREVERSE) == 0,
            "base_ok": np.asarray(counter.base_ok, bool)}


def _window_cap(span: np.ndarray) -> int:
    """The reference's window cap: the widest window as a power of two,
    at least 64."""
    wmax = int(span.max(initial=0))
    return 1 << max(int(np.ceil(np.log2(max(wmax, 1)))), 6)


def _count(dev, rec: dict, jun: dict, min_ins: int, max_ins: int,
           window_cap: int):
    """K6 on `dev` over host record and junction columns: the record
    columns uploaded, then _count_uploaded."""
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return _count_uploaded([put(rec[k]) for k, _ in REC_COLS], jun, min_ins,
                           max_ins, window_cap)


def _count_uploaded(rec_cols, jun: dict, min_ins: int, max_ins: int,
                    window_cap: int):
    """K6's work past the record uploads: the junction columns packed on
    the host into one row a junction and uploaded once, the count over
    the record columns where they lie."""
    packed = torch.from_numpy(pack_junctions(
        *(jun[k] for k, _ in JUN_COLS[:8]), min_ins, max_ins))
    return discordant_count_batch(*rec_cols, packed.to(rec_cols[0].device),
                                  window_cap=window_cap)


def spmd_discordant_counts(mesh, counter: DiscordantCounter, junctions,
                           log=lambda *a: None) -> np.ndarray:
    """Discordant-pair counts with the records replicated on every rank
    and the junctions cut into one block per rank (spmd_pipeline.py:
    963-1050); [J] int32, equal to counter.count per junction."""
    J = len(junctions)
    if J == 0:
        return np.zeros(0, np.int32)
    w = junction_windows(counter, junctions)
    J, window_cap = agree(mesh, [J, _window_cap(w["hi"] - w["lo"])])
    log(f"spmd discordant (replicated): J={J} window_cap={window_cap}")
    per, a, b = _block(J, mesh.size(), shard_index(mesh))
    jun = {}
    for k, v in w.items():
        jun[k] = np.zeros(per, v.dtype)   # empty windows count 0
        jun[k][:b - a] = v[a:b]
    out = _count(mesh_device(mesh), record_columns(counter), jun,
                 counter.min_insert, counter.max_insert, window_cap)
    return all_gather(mesh, out)[:J].cpu().numpy()


def spmd_discordant_counts_sharded(mesh, counter: DiscordantCounter,
                                   junctions,
                                   log=lambda *a: None) -> np.ndarray:
    """Coordinate-sharded discordant counting (spmd_pipeline.py:1053-
    1205): the junctions sort by window start and split contiguously over
    the ranks; a rank holds only the record slice its windows reach (its
    coordinate block plus the window halo).  [J] int32, equal to
    counter.count per junction and to spmd_discordant_counts."""
    J = len(junctions)
    counts = np.zeros(J, np.int32)
    if J == 0:
        return counts
    ndev = mesh.size()
    me = shard_index(mesh)
    w = junction_windows(counter, junctions)
    active = np.nonzero(w["case_code"] >= 0)[0]
    order = active[np.argsort(w["lo"][active], kind="stable")]
    bounds = np.linspace(0, len(order), ndev + 1).astype(int)
    s_lo = np.zeros(ndev, np.int64)
    s_hi = np.zeros(ndev, np.int64)
    for r in range(ndev):
        sel = order[bounds[r]:bounds[r + 1]]
        if len(sel):
            s_lo[r] = w["lo"][sel].min()
            s_hi[r] = w["hi"][sel].max()
    n_active, Jcap, Rcap, window_cap = agree(mesh, [
        len(active), max(int(np.max(bounds[1:] - bounds[:-1])), 1),
        max(int(np.max(s_hi - s_lo)), 1),
        _window_cap((w["hi"] - w["lo"])[active])])
    log(f"spmd discordant: J={J} ({n_active} with a window) "
        f"window_cap={window_cap}, per rank {Jcap} junctions over "
        f"<= {Rcap} records")
    if n_active == 0:
        return counts
    a, b = int(s_lo[me]), int(s_hi[me])
    rec = {}
    for k, v in record_columns(counter).items():
        rec[k] = np.zeros(Rcap, v.dtype)
        rec[k][:b - a] = v[a:b]
    sel = order[bounds[me]:bounds[me + 1]]
    jun = {}
    for k, v in w.items():
        jun[k] = np.zeros(Jcap, v.dtype)   # padding: lo == hi == 0
        jun[k][:len(sel)] = v[sel]
    # window indices rebased into this rank's record slice
    jun["lo"][:len(sel)] -= a
    jun["hi"][:len(sel)] -= a
    out = _count(mesh_device(mesh), rec, jun, counter.min_insert,
                 counter.max_insert, window_cap)
    out = all_gather(mesh, out).reshape(ndev, Jcap).cpu().numpy()
    for r in range(ndev):
        sel = order[bounds[r]:bounds[r + 1]]
        counts[sel] = out[r, :len(sel)]
    return counts


# --------------------------------------------------------------------------
# getsv and the whole pipeline
# --------------------------------------------------------------------------

def spmd_getsv(mesh, clip_sam: str, original_bam: str, clipfile: str,
               sv_out: str, rescue_fq_out: str, *, flank: int = 50,
               min_mapq: int = 20, read_pair_used: int = 5_000_000,
               sum_min_both_clip: int = 3, min_distance: int = 50,
               min_abnormal: int = 0, frequency: float = 0.1,
               max_microhomology: int = 50, min_seq_len: int = 30,
               max_seq_indel_no: int = 1, flank_length: int = 200,
               output_depth: bool = True, times: int = 4,
               filtered_out=None, recs: Optional[BamRecords] = None,
               rescue: bool = False, rescue_mode: bool = True,
               min_one_side_clip: int = 5, max_repeat_depth: int = 500,
               log=lambda *a: None) -> None:
    """getsv with every numeric stage on the mesh (spmd_pipeline.py:
    1212-1275); rank 0 writes sv_out, rescue_fq_out and filtered_out."""
    import sys
    jmap, rescue_events = spmd_build_junctions(mesh, clipfile, clip_sam,
                                               0, rescue)
    log("'spmd junction all-gather' finished")
    nparts = merge_junction_sharded(jmap, flank)
    log(f"'merge_junction_sharded' finished ({nparts} partitions)")
    if recs is None:
        recs = read_bam(original_bam)
    cov, mean, dev = spmd_coverage_insert(mesh, recs, min_mapq,
                                          read_pair_used)
    if read_pair_used >= 100_000:
        log(f"Mean insert size: {mean}; deviation: {dev}")
        counter = DiscordantCounter(recs, min_mapq, mean, dev, times)
        counts = spmd_discordant_counts_sharded(
            mesh, counter, [j for j, _ in jmap.items], log)
        for (_j, o), c in zip(jmap.items, counts):
            o.abnormal = int(c)
        log("'spmd discordant' finished")
    else:
        min_abnormal = 0  # ref: seeksv.cpp:284-286
    if not is_writer(mesh):
        return
    depth = None
    if output_depth:
        depth = DepthQuery(recs, min_mapq, cov=cov)
    else:
        frequency = 0.0  # ref: seeksv.cpp:298-301
    with open(sv_out, "w") as fout:
        fout.write(SV_HEADER + "\n")
        output_breakpoints(jmap, depth, flank_length, sum_min_both_clip,
                           min_abnormal, frequency, min_distance,
                           max_microhomology, min_seq_len, max_seq_indel_no,
                           fout, filtered_out if filtered_out is not None
                           else sys.stdout, rescue_mode,
                           min_one_side_clip, max_repeat_depth)
    write_rescue_fastq(rescue_fq_out, rescue_events)


def write_rescue_fastq(path: str, rescue_events) -> None:
    with open(path, "w") as fq:
        for _pos_key, cr in rescue_events:
            if cr.type == "n":
                fq.write(f"@{cr.clipped_seq.decode()}\n"
                         f"{cr.clipped_seq.decode()}\n+\n"
                         f"{cr.clipped_qual.decode()}\n")


def spmd_run_pipeline(mesh, ref_fa: str, bam: str, prefix: str,
                      log=lambda *a: None, force_device_extend: bool = False,
                      index: Optional[KmerIndex] = None) -> dict:
    """The whole pipeline (getclip -> realign -> getsv) SPMD on the mesh
    (spmd_pipeline.py:1278-1307): writes ``{prefix}.clip.gz``,
    ``.clip.fq.gz``, ``.clip.sam``, ``.sv`` and ``.unmapped.clip.fq`` on
    rank 0, byte-identical to ``run_pipeline``.  Every rank of the mesh
    calls it with the same arguments.

    The device is the mesh's (each rank's own); every extension batch
    goes to the mesh (no H100 crossover is measured), so
    force_device_extend only keeps the reference's signature.  index: a
    prebuilt k-mer index of ref_fa.  Returns {"stages_s", "aligner",
    "sv"}."""
    dev = mesh_device(mesh)
    stages: dict = {}
    t0 = time.perf_counter()
    native_stage(dev, stages)
    t = time.perf_counter()
    recs = read_bam(bam)
    stages["read_bam"] = time.perf_counter() - t
    with rank_prefix(mesh, prefix) as work:
        t = time.perf_counter()
        spmd_getclip(mesh, bam, work, recs=recs, log=log)
        stages["getclip"] = time.perf_counter() - t
        log(f"[{time.perf_counter() - t0:.2f}s] spmd getclip done")
        t = time.perf_counter()
        if index is None:
            index = Aligner.from_fasta(ref_fa).idx
        aligner = BatchAligner(index, device=dev)
        aligner.shard_mesh = mesh
        stages["index"] = time.perf_counter() - t
        t = time.perf_counter()
        realign_clips(ref_fa, f"{work}.clip.fq.gz", f"{work}.clip.sam",
                      aligner=aligner, force_device=force_device_extend)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        stages["realign"] = time.perf_counter() - t
        log(f"[{time.perf_counter() - t0:.2f}s] spmd realign done")
        t = time.perf_counter()
        spmd_getsv(mesh, f"{work}.clip.sam", bam, f"{work}.clip.gz",
                   f"{prefix}.sv", f"{prefix}.unmapped.clip.fq", recs=recs,
                   filtered_out=io.StringIO(), log=log)
        stages["getsv"] = time.perf_counter() - t
    stages["total"] = time.perf_counter() - t0
    log(f"[{stages['total']:.2f}s] spmd getsv done -> {prefix}.sv")
    return {"stages_s": stages, "aligner": aligner, "sv": f"{prefix}.sv"}
