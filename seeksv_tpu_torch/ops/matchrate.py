"""Positional match-rate comparators.

This is the alignment primitive of the whole evidence pipeline (the reference
has no Smith-Waterman; ref: clip_reads.cpp:194-217): two sequences are
anchored at one end and the fraction of equal bases over the shorter length
is the score.  Trivially vectorizable — numpy host versions here
(counterpart of seeksv_tpu/ops/matchrate.py).

Semantics notes (kept bit-exact):
- comparison over min(len) characters, rate = matches / min(len)
- empty input => C++ computes 0/0 = NaN, and `NaN >= limit` is false; we
  return NaN to preserve that.
"""
from __future__ import annotations

import math

import numpy as np


def _as_u8(s) -> np.ndarray:
    if isinstance(s, np.ndarray):
        return s
    return np.frombuffer(bytes(s), dtype=np.uint8)


def match_rate_end(a, b) -> float:
    """CompareStringEndFirst (ref: clip_reads.cpp:194-205): right-anchored."""
    x, y = _as_u8(a), _as_u8(b)
    n = min(len(x), len(y))
    if n == 0:
        return math.nan
    return float(int(np.count_nonzero(x[len(x) - n:] == y[len(y) - n:])) / n)


def match_rate_begin(a, b) -> float:
    """CompareStringBeginFirst (ref: clip_reads.cpp:207-217): left-anchored."""
    x, y = _as_u8(a), _as_u8(b)
    n = min(len(x), len(y))
    if n == 0:
        return math.nan
    return float(int(np.count_nonzero(x[:n] == y[:n])) / n)


def seed_containment(seq1, seq2, seq3, seq4, match_rate: float) -> int:
    """`Compare` (ref: clip_reads.cpp:333-372): 10bp-seed containment check.

    seq2 is a 3'-clipped sequence; seq4 a 3' aligned sequence.  Finds seq2's
    first 10bp inside seq4; on a hit, splits seq4 there and requires both
    sides to match at `match_rate`.  Returns the split offset or -1.
    """
    s2 = bytes(seq2) if not isinstance(seq2, bytes) else seq2
    s4 = bytes(seq4) if not isinstance(seq4, bytes) else seq4
    if len(s2) < 10:
        return -1
    pos = s4.find(s2[:10])
    if pos == -1:
        return -1
    seq5 = bytes(seq1) + s4[:pos]
    seq6 = s4[pos:]
    r1 = match_rate_end(seq1, seq5)
    r2 = match_rate_begin(s2, seq6)
    # NaN comparisons are False, matching C++
    if r1 >= match_rate and r2 >= match_rate:
        return pos
    return -1


REVCOMP_TABLE = np.arange(256, dtype=np.uint8)
for _a, _b in zip(b"AaTtCcGgNn", b"TTAAGGCCNN"):
    REVCOMP_TABLE[_a] = _b


def revcomp(s) -> bytes:
    """GetReverseComplementSeq (ref: clip_reads.cpp:414-466).  Note the
    reference maps lowercase onto uppercase complements and leaves any other
    byte unchanged; reproduced via the lookup table."""
    x = _as_u8(s)
    return REVCOMP_TABLE[x[::-1]].tobytes()


def largest_base_frequency(s) -> float:
    """CountLargestBaseFrequency (ref: getsv.cpp:1485-1511).  N-like bases
    (anything not ATCG in either case) pool into one bucket."""
    x = _as_u8(s)
    if len(x) == 0:
        return math.nan
    counts = []
    pooled = 0
    for pair in (b"Aa", b"Tt", b"Cc", b"Gg"):
        c = int(np.count_nonzero((x == pair[0]) | (x == pair[1])))
        counts.append(c)
        pooled += c
    counts.append(len(x) - pooled)
    return max(counts) / len(x)
