"""CIGAR arithmetic on (length, op-char) lists.

The evidence pipeline manipulates CIGARs of *consensus* sequences as small
editable lists, mirroring the reference's vector<pair<int,char>> codec:
- from_bam_ops / `GenerateCigar`  (ref: clip_reads.cpp:309-329)
- parse / `ChangeCigarType`       (ref: getsv.cpp:433-451)
- minus_left/right, add_left/right (ref: clip_reads.cpp:467-570)
- reverse                          (ref: getsv.cpp:453-463)

Counterpart of seeksv_tpu/ops/cigar.py.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

Cigar = List[Tuple[int, str]]

_OPS = "MIDNSHP=X"


def from_bam_ops(cig: np.ndarray) -> Tuple[Cigar, int]:
    """Strip S/H ops, return remaining (len, char) pairs and the reference
    span `l` counting M/D/=/N (note: X is *not* counted, matching
    GenerateCigar ref: clip_reads.cpp:322)."""
    out: Cigar = []
    l = 0
    for v in cig:
        v = int(v)
        op = v & 0xF
        ln = v >> 4
        if op == 5 or op == 4:  # H, S
            continue
        if op in (0, 2, 7, 3):  # M, D, =, N
            l += ln
        out.append((ln, _OPS[op]))
    return out, l


def parse(cigar: str) -> Cigar:
    out: Cigar = []
    num = 0
    for ch in cigar:
        if ch.isdigit():
            num = num * 10 + ord(ch) - 48
        else:
            out.append((num, ch))
            num = 0
    return out


def to_str(cig: Cigar, left_len: int = 0, right_len: int = 0) -> str:
    """DisplayCigarVector (ref: clip_reads.h:489-505): optional soft-clip
    decorations on either side."""
    parts = []
    if left_len > 0:
        parts.append(f"{left_len}S")
    parts.extend(f"{ln}{op}" for ln, op in cig)
    if right_len > 0:
        parts.append(f"{right_len}S")
    return "".join(parts)


def query_len(cig: Cigar) -> int:
    """Sum of M/I lengths (the length MinusCigar* operates against)."""
    return sum(ln for ln, op in cig if op in "MI")


def minus_left(cig: Cigar, length: int) -> bool:
    """Remove `length` query bases from the left (ref: clip_reads.cpp:467).
    Mutates in place; returns False (and leaves cig) when M+I total <= length.
    Non-M/I ops encountered while trimming are dropped."""
    if query_len(cig) <= length:
        return False
    rem = length
    i = 0
    while i < len(cig):
        ln, op = cig[i]
        if op in "MI":
            if ln > rem:
                cig[i] = (ln - rem, op)
                break
            rem -= ln
            del cig[i]
        else:
            del cig[i]
    return True


def minus_right(cig: Cigar, length: int) -> bool:
    """Keep only the first (M+I total - length) query bases (ref:
    clip_reads.cpp:507).  Mutates in place."""
    total = query_len(cig)
    if total <= length:
        return False
    keep = total - length
    i = 0
    while i < len(cig):
        ln, op = cig[i]
        if op in "MI":
            if ln >= keep:
                cig[i] = (keep, op)
                del cig[i + 1:]
                break
            keep -= ln
            i += 1
        else:
            i += 1
    return True


def add_left(cig: Cigar, length: int) -> None:
    if cig and cig[0][1] == "M":
        cig[0] = (cig[0][0] + length, "M")
    else:
        cig.insert(0, (length, "M"))


def add_right(cig: Cigar, length: int) -> None:
    if cig and cig[-1][1] == "M":
        cig[-1] = (cig[-1][0] + length, "M")
    else:
        cig.append((length, "M"))


def reverse(cig: Cigar) -> Cigar:
    return cig[::-1]


def change_start_end(cigar: str, add_len: int) -> str:
    """ChangeCigarStartEnd (ref: getsv.cpp:367): grow the first run length."""
    i = 0
    num = 0
    while i < len(cigar) and cigar[i].isdigit():
        num = num * 10 + ord(cigar[i]) - 48
        i += 1
    return f"{num + add_len}{cigar[i:]}"


def change_back_end(cigar: str, add_len: int) -> str:
    """ChangeCigarBackEnd (ref: getsv.cpp:389): grow the last run length."""
    m = cigar[-1]
    i = 2
    while i <= len(cigar) and cigar[-i].isdigit():
        i += 1
    num = int(cigar[len(cigar) - i + 1:-1])
    return f"{cigar[:len(cigar) - i + 1]}{num + add_len}{m}"


def number_cigar(cigar: str) -> int:
    """NumberCigar (ref: getsv.cpp:409): count of non-digit chars."""
    return sum(1 for ch in cigar if not ch.isdigit())
