"""Junction data model + sorted multimap.

Replaces the reference's multimap<Junction, OtherInfo> (ref: getsv.h:149-227)
with a bisect-maintained sorted list.  The Junction total order is
(up_chr, down_chr, up_strand, down_strand, up_pos, down_pos)
(ref: getsv.h:187-225); equal keys keep insertion order (std::multimap
inserts at the end of the equal range).

Counterpart of seeksv_tpu/pipeline/junctions.py.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import List, Tuple

Cigar = List[Tuple[int, str]]


@dataclass
class SeqInfo:
    """ref: getsv.h:48-68."""
    seq: bytes = b""
    cigar: Cigar = field(default_factory=list)
    lcl: int = 0           # left_clipped_seq_length
    rcl: int = 0           # right_clipped_seq_length
    support: int = 0       # support_read_no
    uniq: int = 0          # is_clipped_seq_and_uniq_mapped: 0/1/2

    def copy(self) -> "SeqInfo":
        return SeqInfo(self.seq, list(self.cigar), self.lcl, self.rcl,
                       self.support, self.uniq)


@dataclass
class OtherInfo:
    """ref: getsv.h:89-107."""
    up: SeqInfo
    down: SeqInfo
    mh: int = -1           # microhomology_length
    abnormal: int = 0      # abnormal_read_pair_no


Junction = Tuple[str, int, str, str, int, str]  # up_chr,up_pos,up_strand,down_chr,down_pos,down_strand


def jorder(j: Junction):
    """ref: getsv.h:187-225 — the comparator nests chrs, strands, then pos."""
    return (j[0], j[3], j[2], j[5], j[1], j[4])


class JunctionMap:
    """Sorted multimap Junction -> OtherInfo with stable equal-key order."""

    def __init__(self):
        self.keys: List[tuple] = []      # (jorder(j), seqno)
        self.items: List[Tuple[Junction, OtherInfo]] = []
        self._seq = 0

    def __len__(self):
        return len(self.items)

    def insert(self, j: Junction, info: OtherInfo) -> None:
        k = (jorder(j), self._seq)
        self._seq += 1
        i = bisect.bisect_right(self.keys, (jorder(j), self._seq))
        self.keys.insert(i, k)
        self.items.insert(i, (j, info))

    def equal_range(self, j: Junction) -> range:
        ko = jorder(j)
        lo = bisect.bisect_left(self.keys, (ko, -1))
        hi = bisect.bisect_right(self.keys, (ko, self._seq + 1))
        return range(lo, hi)

    def delete(self, i: int) -> None:
        del self.keys[i]
        del self.items[i]
