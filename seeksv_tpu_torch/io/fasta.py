"""FASTA / FAI reading (replaces external reference handling; the aligner
keeps the full reference resident as one int8 array; counterpart of
seeksv_tpu/io/fasta.py)."""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def read_fai(path: str) -> List[Tuple[str, int]]:
    out = []
    with open(path) as f:
        for line in f:
            fld = line.split("\t")
            out.append((fld[0], int(fld[1])))
    return out


def read_fasta(path: str) -> Dict[str, np.ndarray]:
    """Returns {name: uint8 ASCII array (uppercased)}."""
    seqs: Dict[str, np.ndarray] = {}
    name = None
    parts: List[bytes] = []
    with open(path, "rb") as f:
        for line in f:
            line = line.rstrip()
            if line.startswith(b">"):
                if name is not None:
                    seqs[name] = np.frombuffer(b"".join(parts).upper(), np.uint8).copy()
                name = line[1:].split()[0].decode()
                parts = []
            else:
                parts.append(line)
    if name is not None:
        seqs[name] = np.frombuffer(b"".join(parts).upper(), np.uint8).copy()
    return seqs
