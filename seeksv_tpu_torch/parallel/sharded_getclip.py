"""Coordinate-sharded getclip: the data-parallel decomposition of evidence
extraction, a host copy of ``seeksv_tpu/parallel/sharded_getclip.py``.
Per-read clip extraction is independent and the consensus merge is a
keyed reduction, so sharding by breakpoint key is exact: no halos are
needed, unlike the junction merge's +-50 bp.

Each shard owns a contiguous breakpoint-key range per chromosome and builds
its BreakpointMaps from only its candidate reads (BAM order preserved
within a shard, which preserves the insertion-order semantics of the
greedy merge).  Outputs concatenate in key order, reproducing the
single-shard stream byte for byte (tests/test_torch_sharded.py holds it
against the port's getclip and the reference's getclip_sharded).
"""
from __future__ import annotations

import gzip
from typing import Dict, List, Tuple

import numpy as np

from ..io.bam import BamRecords, FDUP, FMUNMAP, FUNMAP, OP_H, OP_S, read_bam
from ..pipeline.getclip import (BreakpointMap,
                                _get_sclip_read, _map_len_no_x,
                                _store_unmapped, _write_chrom)


def getclip_sharded(bam_path: str, prefix: str, n_shards: int = 4,
                    threshold: float = 0.85, min_mapq: int = 20,
                    save_low_quality: bool = False,
                    recs: BamRecords | None = None) -> None:
    if recs is None:
        recs = read_bam(bam_path)
    flag = recs.flag
    unmapped_any = (flag & (FUNMAP | FMUNMAP)) != 0
    mapped = ~unmapped_any
    first_op = recs.first_op()
    last_op = recs.last_op()
    first_len = recs.first_len()
    last_len = recs.last_len()
    map_len = _map_len_no_x(recs)
    has_hard = (first_op == OP_H) | (last_op == OP_H)
    soft_first = first_op == OP_S
    soft_last = last_op == OP_S
    clip_candidate = (mapped & ~has_hard & (soft_first | soft_last)
                      & (recs.mapq >= min_mapq) & ((flag & FDUP) == 0))

    soft_out = gzip.open(f"{prefix}.clip.gz", "wb", compresslevel=1)
    fq_out = gzip.open(f"{prefix}.clip.fq.gz", "wb", compresslevel=1)
    un1 = gzip.open(f"{prefix}.unmapped_1.fq.gz", "wb", compresslevel=1)
    un2 = gzip.open(f"{prefix}.unmapped_2.fq.gz", "wb", compresslevel=1)

    id2seq_qual: Dict[bytes, Tuple[Tuple[str, str], str]] = {}
    for i in np.nonzero(unmapped_any)[0]:
        _store_unmapped(recs, int(i), id2seq_qual, un1, un2)

    mapped_idx = np.nonzero(mapped)[0]
    last_tid = 0
    # tid runs + the reference's dropped-first-record quirk, computed
    # globally before sharding
    if len(mapped_idx):
        mtids = recs.tid[mapped_idx]
        run_starts = np.concatenate(
            [[0], np.nonzero(mtids[1:] != mtids[:-1])[0] + 1, [len(mtids)]])
        flush_order: List[int] = []
        per_tid_candidates: Dict[int, List[np.ndarray]] = {}
        for r in range(len(run_starts) - 1):
            s, e = int(run_starts[r]), int(run_starts[r + 1])
            tid = int(mtids[s])
            if tid != last_tid:
                flush_order.append(last_tid)
                last_tid = tid
                s += 1  # dropped record
            run = mapped_idx[s:e]
            per_tid_candidates.setdefault(tid, []).append(
                run[clip_candidate[run]])
        flush_order.append(last_tid)
        for tid in flush_order:
            cands = (np.concatenate(per_tid_candidates[tid])
                     if tid in per_tid_candidates else np.zeros(0, np.int64))
            chrom = recs.ref_names[tid] if 0 <= tid < len(recs.ref_names) \
                else str(tid)
            _process_tid_sharded(recs, chrom, cands, n_shards, threshold,
                                 save_low_quality, first_op, last_op,
                                 first_len, last_len, map_len,
                                 soft_out, fq_out)
    soft_out.close()
    fq_out.close()
    un1.close()
    un2.close()


def _process_tid_sharded(recs, chrom, cands, n_shards, threshold,
                         save_low_quality, first_op, last_op, first_len,
                         last_len, map_len, soft_out, fq_out):
    """Partition per SIDE by breakpoint key (left clips key at pos+1, right
    clips at pos+map_len, ref GetSClipReads) — a both-ends-clipped read has
    two keys and is processed by both owning shards with a side filter, so
    every key group lives wholly in one shard."""
    merged_left = BreakpointMap()
    merged_right = BreakpointMap()
    if len(cands):
        left_keys = recs.pos[cands] + 1
        right_keys = recs.pos[cands] + map_len[cands]
        has_left = first_op[cands] == OP_S
        has_right = last_op[cands] == OP_S
        all_keys = np.concatenate([left_keys[has_left],
                                   right_keys[has_right]])
        edges = (np.quantile(all_keys, np.linspace(0, 1, n_shards + 1))[1:-1]
                 if len(all_keys) else np.zeros(0))
        shard_l = np.searchsorted(edges, left_keys, "right")
        shard_r = np.searchsorted(edges, right_keys, "right")
        for s in range(n_shards):
            left_map = BreakpointMap()
            right_map = BreakpointMap()
            for i in cands[has_left & (shard_l == s)]:
                _get_sclip_read(recs, int(i), left_map, right_map, threshold,
                                save_low_quality, first_op, last_op,
                                first_len, last_len, map_len, only="L")
            for i in cands[has_right & (shard_r == s)]:
                _get_sclip_read(recs, int(i), left_map, right_map, threshold,
                                save_low_quality, first_op, last_op,
                                first_len, last_len, map_len, only="R")
            # shards partition breakpoint keys (quantile edges + side
            # filter), so merged maps must never see a key twice — a
            # violated invariant here would silently drop consensus groups
            overlap_l = merged_left.by_pos.keys() & left_map.by_pos.keys()
            overlap_r = merged_right.by_pos.keys() & right_map.by_pos.keys()
            assert not overlap_l and not overlap_r, (
                f"shard key ranges overlap: {sorted(overlap_l)[:3]} "
                f"{sorted(overlap_r)[:3]}")
            merged_left.by_pos.update(left_map.by_pos)
            merged_right.by_pos.update(right_map.by_pos)
    _write_chrom(chrom, merged_left, "5", soft_out, fq_out)
    _write_chrom(chrom, merged_right, "3", soft_out, fq_out)
