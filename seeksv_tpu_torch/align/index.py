"""Exact-seed reference index.

Replaces the external bwa index: the reference is held as one concatenated
int8 array (device-resident for the device front-end) plus a sorted k-mer table for exact seed
lookup.  Lookups are vectorized searchsorted calls over all read k-mers at
once — the structure maps directly to a device gather, no FM-index needed
at these reference scales (SURVEY.md §7 phase 3).  Counterpart of
seeksv_tpu/align/index.py.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

# 2-bit encode; anything not ACGT -> 4 (ambiguous)
ENCODE = np.full(256, 4, dtype=np.uint8)
for i, c in enumerate(b"ACGT"):
    ENCODE[c] = i
    ENCODE[c + 32] = i


PREFIX_BITS = 24


@dataclass
class KmerIndex:
    """v2 packed layout: the
    sorted 2k-bit hash table is split into a prefix-bucket table over
    the TOP bits plus per-entry LOW bits only — uint16 low keys + uint32
    positions = 6 B/kmer vs the v1 uint64+int64 16 B/kmer (8.5 GB ->
    3.2 GB at 500 Mbp), halving what a cold page-in reads and shrinking
    the device-residency footprint for the device front-end."""
    k: int
    ref: np.ndarray            # uint8 codes, concatenated chromosomes
    chrom_names: List[str]
    chrom_starts: np.ndarray   # int64 [n_chrom+1] offsets into ref
    keys: np.ndarray           # low bits of sorted kmer hashes (uint16
    #                            when the prefix covers all but <=16
    #                            bits — every k<=20 index; uint32 else)
    positions: np.ndarray      # uint32 positions (concatenated coords),
    #                            key-sorted
    prefix_tab: np.ndarray = None  # int64 [2^p+1] bucket starts into keys

    def __post_init__(self):
        if self.prefix_tab is None:
            raise ValueError("v2 KmerIndex requires the prefix table "
                             "built from the full sorted hashes "
                             "(KmerIndex.build)")

    def _prefix_shift(self, k: int) -> int:
        # derived from the table's actual size so differently-sized
        # cached tables stay valid
        bits = max(int(len(self.prefix_tab) - 1).bit_length() - 1, 0)
        return max(0, 2 * k - bits)

    @classmethod
    def _bits(cls, k: int, n_keys: int) -> int:
        """Prefix width: scales with index size (a tiny reference does
        not pay a fixed 134 MB bucket table), floored at 2k-32 so the
        residual always fits uint32.  Indexes with >=2^21 kmers (every
        production-scale reference, >=~2 Mbp) get bits >= 2k-16 and the
        uint16 residual layout."""
        return min(PREFIX_BITS, 2 * k,
                   max(int(n_keys).bit_length(), 1, 2 * k - 32))

    @classmethod
    def _low_dtype(cls, shift: int):
        return (np.uint16 if shift <= 16
                else (np.uint32 if shift <= 32 else np.uint64))

    @classmethod
    def build_prefix_tab(cls, keys_full: np.ndarray, k: int,
                         bits: int = None) -> np.ndarray:
        """Bucket-start table over the top bits of the 2k-bit hash:
        prefix_tab[p] = first index in keys whose prefix >= p.  Bounds
        every key lookup to one bucket (~1-8 entries) instead of a
        27-level binary search over the full table.  Takes the FULL
        sorted hashes (build-time only; the stored index keeps low bits)."""
        if bits is None:
            bits = cls._bits(k, len(keys_full))
        shift = max(0, 2 * k - bits)
        nb = 1 << bits
        prefixes = (np.arange(nb, dtype=np.uint64) << np.uint64(shift))
        tab = np.empty(nb + 1, np.int64)
        tab[:nb] = np.searchsorted(keys_full, prefixes, "left")
        tab[nb] = len(keys_full)
        return tab

    @classmethod
    def pack_keys(cls, keys_full: np.ndarray, k: int,
                  bits: int = None) -> np.ndarray:
        """Low-bit residuals of the full sorted hashes for the given
        prefix width."""
        if bits is None:
            bits = cls._bits(k, len(keys_full))
        shift = max(0, 2 * k - bits)
        if shift == 0:
            return np.zeros(len(keys_full), np.uint16)
        mask = np.uint64((1 << shift) - 1)
        return (keys_full & mask).astype(cls._low_dtype(shift))

    @classmethod
    def build(cls, seqs: Dict[str, np.ndarray], k: int = 19) -> "KmerIndex":
        names = list(seqs)
        starts = np.zeros(len(names) + 1, np.int64)
        parts = []
        for i, n in enumerate(names):
            codes = ENCODE[seqs[n]]
            parts.append(codes)
            starts[i + 1] = starts[i] + len(codes)
        ref = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
        if len(ref) >= (1 << 32):
            raise ValueError("v2 index positions are uint32; reference "
                             "over 4.29 Gbp is not supported")
        # native radix-bucketed build (csrc seeksv_index_build): ~2
        # streaming passes instead of an n-log-n mergesort over 8-byte
        # hashes; identical layout/order —
        # the numpy path below is the oracle (tests/test_align.py)
        cap = int(np.maximum(np.diff(starts) - k + 1, 0).sum())
        bits = cls._bits(k, cap)
        if 0 < 2 * k - bits <= 16 and len(ref):
            from ..io import native
            if native.index_build_available():
                keys_low, pos32, ptab = native.index_build_native(
                    ref, starts, k, bits)
                return cls(k, ref, names, starts, keys_low, pos32, ptab)
        keys, positions = cls._hash_all(ref, starts, k)
        order = np.argsort(keys, kind="stable")
        keys_full = keys[order]
        ptab = cls.build_prefix_tab(keys_full, k, bits)
        return cls(k, ref, names, starts,
                   cls.pack_keys(keys_full, k, bits),
                   positions[order].astype(np.uint32), ptab)

    @staticmethod
    def _hash_all(ref, starts, k):
        n = len(ref)
        if n < k:
            return np.zeros(0, np.uint64), np.zeros(0, np.int64)
        # rolling 2-bit pack: kmer[i] = ref[i..i+k) as base-4 integer
        valid = ref < 4
        h = np.zeros(n - k + 1, np.uint64)
        ok = np.ones(n - k + 1, bool)
        for j in range(k):
            h = (h << np.uint64(2)) | ref[j:n - k + 1 + j].astype(np.uint64)
            ok &= valid[j:n - k + 1 + j]
        # exclude kmers crossing chromosome boundaries
        pos = np.arange(n - k + 1, dtype=np.int64)
        for s in starts[1:-1]:
            ok &= (pos + k <= s) | (pos >= s)
        return h[ok], pos[ok]

    def _bounded_search(self, q: np.ndarray, side: str,
                        lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
        """Vectorized binary search of q within per-element [lo, hi)
        bounds (= np.searchsorted(keys, q, side) given correct bounds).
        Iteration count is log2 of the largest bucket, with each round one
        gather — cache-friendly on the big memmapped key table."""
        keys = self.keys
        lo = lo.astype(np.int64, copy=True)
        hi = hi.astype(np.int64, copy=True)
        cap = max(len(keys) - 1, 0)
        while True:
            active = lo < hi
            if not active.any():
                return lo
            mid = (lo + hi) >> 1
            kv = keys[np.minimum(mid, cap)]
            go_right = (kv < q) if side == "left" else (kv <= q)
            adv = active & go_right
            lo = np.where(adv, mid + 1, lo)
            hi = np.where(active & ~go_right, mid, hi)

    def lookup(self, kmers: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """For an array of (full 2k-bit) kmer hashes, return (lo, hi)
        ranges into self.positions (vectorized): prefix bits select the
        bucket, the uint16/uint32 residual is binary-searched within it."""
        if len(kmers) == 0 or len(self.keys) == 0:
            z = np.zeros(len(kmers), np.int64)
            return z, z
        shift = self._prefix_shift(self.k)
        km = np.asarray(kmers, np.uint64)
        p = (km >> np.uint64(shift)).astype(np.int64)
        b_lo = self.prefix_tab[p]
        b_hi = self.prefix_tab[p + 1]
        if shift == 0:
            return b_lo, b_hi
        q_low = (km & np.uint64((1 << shift) - 1)).astype(self.keys.dtype)
        lo = self._bounded_search(q_low, "left", b_lo, b_hi)
        hi = self._bounded_search(q_low, "right", lo, b_hi)
        return lo, hi

    def hash_read(self, codes: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """All k-mer hashes of an encoded read; returns (offsets, hashes)
        for offsets whose k-mer contains no ambiguous base."""
        n = len(codes)
        k = self.k
        if n < k:
            return np.zeros(0, np.int64), np.zeros(0, np.uint64)
        h = np.zeros(n - k + 1, np.uint64)
        ok = np.ones(n - k + 1, bool)
        valid = codes < 4
        for j in range(k):
            h = (h << np.uint64(2)) | codes[j:n - k + 1 + j].astype(np.uint64)
            ok &= valid[j:n - k + 1 + j]
        offs = np.nonzero(ok)[0].astype(np.int64)
        return offs, h[ok]

    def tid_of(self, pos: int) -> int:
        return int(np.searchsorted(self.chrom_starts, pos, "right")) - 1
