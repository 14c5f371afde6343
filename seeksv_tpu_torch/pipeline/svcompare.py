"""SV result comparison / evaluation harness.

Reimplements svcompare (ref: svcompare/svcompare.cpp): compares a target
sv.txt against simulation truth (`simu`) or another result set
(`crest`/`seeksv`) with 50bp fuzzy junction matching, emitting tagged rows
(control_share / target_share / control_only / target_only /
{control,target}_repeat).

Counterpart of seeksv_tpu/pipeline/svcompare.py (host code, copied).
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from .junctions import Junction, jorder


@dataclass
class Info:
    up_no: int = 0
    down_no: int = 0
    sv_type: str = "INV"
    status: int = 0


class JMap:
    """Ordered map<Junction, Info> (unique keys, Junction total order)."""

    def __init__(self):
        self.d: Dict[tuple, Tuple[Junction, Info]] = {}
        self._keys: Optional[List[tuple]] = None

    def insert(self, j: Junction, info: Info) -> bool:
        k = jorder(j)
        if k in self.d:
            return False
        self.d[k] = (j, info)
        self._keys = None
        return True

    @property
    def keys(self) -> List[tuple]:
        if self._keys is None:
            self._keys = sorted(self.d)
        return self._keys

    def items(self):
        return [self.d[k] for k in self.keys]

    def find(self, j: Junction):
        return self.d.get(jorder(j))

    def delete(self, j: Junction):
        del self.d[jorder(j)]
        self._keys = None


def _out(fout, tag: str, j: Junction, info: Info):
    fout.write(f"{tag}\t{j[0]}\t{j[1]}\t{j[2]}\t{info.up_no}\t"
               f"{j[3]}\t{j[4]}\t{j[5]}\t{info.down_no}\t{info.sv_type}\n")


def read_sv_info(path: str, jmap: JMap, n_area: List[Tuple[str, int, int]],
                 chrom: str) -> None:
    """Simulation inversion truth (ref: svcompare.cpp:124-172)."""
    with open(path) as f:
        for line in f:
            fl = line.split()
            if not fl or fl[0].lower() != "inv":
                continue
            start = int(fl[1])
            length = int(fl[2])
            end = start + length - 1
            if _overlaps_n(n_area, chrom, start, end):
                continue
            jmap.insert((chrom, start - 1, "+", chrom, end, "-"), Info())
            jmap.insert((chrom, start, "-", chrom, end + 1, "+"), Info())


def read_cnv_info(path: str, jmap: JMap, n_area, chrom: str) -> None:
    """Simulation lins/ldel truth (ref: svcompare.cpp:174-273)."""
    with open(path) as f:
        for line in f:
            fl = line.split()
            if not fl:
                continue
            if fl[0] == "lins":
                start, end = int(fl[1]), int(fl[2])
                for part in fl[5].split(";"):
                    ins_pos = int(part[2:].split()[0]) if part[2:] else 0
                    if (_pos_in_n(n_area, chrom, ins_pos)
                            or _overlaps_n(n_area, chrom, start, end)):
                        continue
                    jmap.insert((chrom, ins_pos - 1, "+", chrom, start, "+"),
                                Info(sv_type="INS"))
                    jmap.insert((chrom, end, "+", chrom, ins_pos, "+"),
                                Info(sv_type="INS"))
            elif fl[0] == "ldel":
                start, end = int(fl[1]), int(fl[2])
                if _overlaps_n(n_area, chrom, start, end):
                    continue
                jmap.insert((chrom, start - 1, "+", chrom, end + 1, "+"),
                            Info(sv_type="DEL"))


def _overlaps_n(n_area, chrom, start, end) -> bool:
    return any(c == chrom and start <= e and end >= b
               for c, b, e in n_area)


def _pos_in_n(n_area, chrom, pos) -> bool:
    return any(c == chrom and b <= pos <= e for c, b, e in n_area)


def read_result(path: str, fout, jmap: JMap, tag: str,
                file_type: str) -> None:
    """ref ReadCrestOrSeeksvInfo (svcompare.cpp:275-327)."""
    with open(path) as f:
        for line in f:
            fl = line.split()
            if not fl or fl[0].startswith("@") or fl[0] == "left_chr":
                continue
            up_chr = fl[0]
            if file_type == "crest":
                up_pos, up_strand, up_no = int(fl[1]), fl[2], int(fl[3])
                down_chr, down_pos, down_strand, down_no = (
                    fl[4], int(fl[5]), fl[6], int(fl[7]))
                sv_type = fl[8]
                if (up_strand != down_strand
                        and (up_chr, up_pos) > (down_chr, down_pos)):
                    j = (down_chr, down_pos, up_strand,
                         up_chr, up_pos, down_strand)
                    info = Info(down_no, up_no, sv_type)
                else:
                    j = (up_chr, up_pos, up_strand,
                         down_chr, down_pos, down_strand)
                    info = Info(up_no, down_no, sv_type)
            else:
                up_pos, up_strand, up_no = int(fl[1]), fl[2], int(fl[3])
                down_chr, down_pos, down_strand, down_no = (
                    fl[4], int(fl[5]), fl[6], int(fl[7]))
                sv_type = fl[10]
                j = (up_chr, up_pos, up_strand, down_chr, down_pos, down_strand)
                info = Info(up_no, down_no, sv_type)
            if not jmap.insert(j, info):
                fout.write(f"{tag}\t{up_chr}\t{up_pos}\t{up_strand}\t{up_no}\t"
                           f"{down_chr}\t{down_pos}\t{down_strand}\t{down_no}"
                           f"\t{sv_type}\n")


def merge_near(fout, jmap: JMap, tag: str, search_length: int) -> None:
    """ref MergeNear (svcompare.cpp:330-349)."""
    items = jmap.items()
    i = 0
    while i < len(items):
        j_i, _ = items[i]
        k = i + 1
        while k < len(items):
            j_k, info_k = items[k]
            if not (j_i[0] == j_k[0] and j_i[3] == j_k[3]
                    and j_i[2] == j_k[2] and j_i[5] == j_k[5]
                    and abs(j_k[1] - j_i[1]) <= search_length):
                break
            if abs(j_k[4] - j_i[4]) <= search_length:
                _out(fout, tag, j_k, info_k)
                jmap.delete(j_k)
                items = jmap.items()
            else:
                k += 1
        i += 1
        items = jmap.items()


def compare_target_to_control(fout, control: JMap, target: JMap,
                              search_length: int) -> None:
    """ref CompareTargeToControl (svcompare.cpp:353-416): exact find, then
    fuzzy forward + backward scan within search_length."""
    for j_t, info_t in target.items():
        hit = control.find(j_t)
        if hit is not None:
            _out(fout, "control_share", hit[0], hit[1])
            _out(fout, "target_share", j_t, info_t)
            hit[1].status = 1
            info_t.status = 1
            continue
        keys = control.keys
        pos = bisect.bisect_left(keys, jorder(j_t))
        found = None
        for k in range(pos, len(keys)):
            j_c, info_c = control.d[keys[k]]
            if not (j_c[0] == j_t[0] and j_c[3] == j_t[3]
                    and j_c[2] == j_t[2] and j_c[5] == j_t[5]
                    and abs(j_c[1] - j_t[1]) <= search_length):
                break
            if abs(j_t[4] - j_c[4]) <= search_length:
                found = (j_c, info_c)
                break
        if found is None:
            for k in range(pos - 1, -1, -1):
                j_c, info_c = control.d[keys[k]]
                if not (j_c[0] == j_t[0] and j_c[3] == j_t[3]
                        and j_c[2] == j_t[2] and j_c[5] == j_t[5]
                        and abs(j_c[1] - j_t[1]) <= search_length):
                    break
                if abs(j_t[4] - j_c[4]) <= search_length:
                    found = (j_c, info_c)
                    break
        if found is not None:
            _out(fout, "control_share", found[0], found[1])
            _out(fout, "target_share", j_t, info_t)
            found[1].status = 1
            info_t.status = 1


def output_different(fout, jmap: JMap, tag: str) -> None:
    for j, info in jmap.items():
        if info.status == 0:
            _out(fout, tag, j, info)


def compare(mode: str, control: str, target: str, out_path: str, *,
            fuzz: int = 50, n_region_file: Optional[str] = None,
            target_is_crest: bool = False, chrom: str = "chr17",
            cnv_file: Optional[str] = None) -> None:
    n_area: List[Tuple[str, int, int]] = []
    if n_region_file:
        with open(n_region_file) as f:
            for line in f:
                fl = line.split()
                if len(fl) >= 3:
                    n_area.append((fl[0], int(fl[1]), int(fl[2])))
    ttype = "crest" if target_is_crest else "seeksv"
    with open(out_path, "w") as fout:
        cmap = JMap()
        tmap = JMap()
        if mode == "simu":
            read_sv_info(control, cmap, n_area, chrom)
            if cnv_file:
                read_cnv_info(cnv_file, cmap, n_area, chrom)
            read_result(target, fout, tmap, "target_repeat", ttype)
            merge_near(fout, tmap, "target_repeat", fuzz)
        else:
            read_result(control, fout, cmap, "control_repeat", mode)
            merge_near(fout, cmap, "control_repeat", fuzz)
            read_result(target, fout, tmap, "target_repeat", ttype)
            merge_near(fout, tmap, "target_repeat", fuzz)
        compare_target_to_control(fout, cmap, tmap, fuzz)
        output_different(fout, cmap, "control_only")
        output_different(fout, tmap, "target_only")
