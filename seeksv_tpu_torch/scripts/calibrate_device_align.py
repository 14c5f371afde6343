"""Calibrate the device-resident front-end (``ops/align_device.py``,
``run --device-align``) against the host front-end, on the card.

Counterpart of scripts/calibrate_device_align.py, with its chunk sizes
(256, 1,024, 4,096 reads) and read length (60 bases).  The reference
reads the bundled example reference; this program makes its own genome
from a seed (1,000,000 random bases, one contig, written as a FASTA in
a temporary directory): a chunk's time does not depend on the genome's
size (seeding is a bounded search, extension windows are local).

Measured:
  1. the index's upload (k-mer keys, positions and the genome to the
     card, synchronised) and a bulk upload rate (64 MB);
  2. a chunk's wall time: ``TorchDeviceAligner.align_jobs`` (seed, window
     gather, both extension rounds on the card) against the host
     front-end (``BatchAligner.batch_align(..., force_host=True)``: host
     seeding, the native extension and the host finalize) on the same
     reads;
  3. the break-even chunk count, upload / (host - card) a chunk, when
     the card wins a chunk, else "never-at-measured-sizes".

    python -m seeksv_tpu_torch.scripts.calibrate_device_align [--out PATH]

Default output: seeksv_tpu_torch/align/device_align_calibration.json
(read by ``ops.align_device.device_align_auto_enabled``).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from ..align.engine import BatchAligner
from ..ops.align_device import TorchDeviceAligner
from ..utils.simulate import random_genome, write_fasta
from ._card import card

CHUNKS = [256, 1024, 4096]
READ_LEN = 60
GENOME = 1_000_000
OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "align", "device_align_calibration.json")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--bw-probe-mb", type=int, default=64)
    args = ap.parse_args(argv)
    info = card()
    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory() as tmp:
        fa = os.path.join(tmp, "genome.fa")
        write_fasta(fa, {"chrC": random_genome(rng, GENOME)})
        host_al = BatchAligner.from_fasta(fa, cache=False, device=dev)
    idx = host_al.idx

    # 1a. the index's upload, synchronised
    t0 = time.perf_counter()
    for a in (idx.keys, idx.positions, idx.ref):
        torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    torch.cuda.synchronize(dev)
    small_upload_s = time.perf_counter() - t0
    idx_bytes = int(idx.keys.nbytes + idx.positions.nbytes + idx.ref.nbytes)
    # 1b. a bulk upload of a pageable buffer
    blob = torch.ones((args.bw_probe_mb << 20) // 4, dtype=torch.float32)
    blob[:16].to(dev)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    blob.to(dev)
    torch.cuda.synchronize(dev)
    upload_mb_s = args.bw_probe_mb / (time.perf_counter() - t0)

    # 2. a chunk's wall time, card front-end against host front-end
    ref_codes = np.asarray(idx.ref)
    dev_al = TorchDeviceAligner(idx, dev)
    rows = []
    for B in CHUNKS:
        starts = rng.integers(0, len(ref_codes) - READ_LEN, B)
        reads = [np.asarray(ref_codes[s:s + READ_LEN], np.uint8).copy()
                 for s in starts]
        for r in reads:   # mismatches, so that the extension works
            m = rng.random(len(r)) < 0.02
            r[m] = (r[m] + 1) % 4
        seqs = [bytes(b"ACGT"[c] for c in r) for r in reads]
        t0 = time.perf_counter()
        dev_al.align_jobs([np.asarray(r) for r in reads])
        torch.cuda.synchronize(dev)
        warm = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = dev_al.align_jobs([np.asarray(r) for r in reads])
        torch.cuda.synchronize(dev)
        device_s = time.perf_counter() - t0
        host_al2 = BatchAligner(idx, device=dev)
        t0 = time.perf_counter()
        host_al2.batch_align(seqs, force_host=True)
        host_s = time.perf_counter() - t0
        rows.append({"chunk_reads": B, "device_s": round(device_s, 5),
                     "device_warmup_s": round(warm, 5),
                     "host_s": round(host_s, 5),
                     "device_wins_per_chunk": device_s < host_s,
                     "overflowed": out is None})
        print(json.dumps(rows[-1]), file=sys.stderr)

    # 3. break-even
    best = min(rows, key=lambda r: r["device_s"] / max(r["host_s"], 1e-9))
    if best["device_s"] < best["host_s"]:
        be_chunks = small_upload_s / (best["host_s"] - best["device_s"])
        break_even = {"chunks": round(be_chunks, 1),
                      "at_chunk_reads": best["chunk_reads"]}
    else:
        break_even = "never-at-measured-sizes"
    out = {
        "platform": "cuda", "device": info["device"],
        "card": info["nvidia_smi"], "torch": info["torch"],
        "cuda": info["cuda"], "genome_bases": GENOME,
        "index_bytes": idx_bytes,
        "index_upload_s": round(small_upload_s, 4),
        "bulk_upload_mb_s": round(upload_mb_s, 2),
        "upload_s_per_gb_extrapolated": round(1024 / upload_mb_s, 4),
        "rows": rows,
        "break_even": break_even,
        "note": ("a chunk's time does not depend on the genome's size; "
                 "host = host seeding + native extension + host finalize "
                 "(batch_align force_host), card = align_jobs"),
    }
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(json.dumps({"break_even": break_even,
                      "bulk_upload_mb_s": out["bulk_upload_mb_s"],
                      "out": args.out}))


if __name__ == "__main__":
    main()
